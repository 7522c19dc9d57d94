// The fused GEMM's split modes kmm2 (w 9..14) and mm2 (w 15..16) for NVIDIA
// Hopper (sm_90a), dense and grouped: C = A . B on int16 carrier codes,
// (M, K) x (K, N), both row-major, each operand split into two s8 digits at
// h = ceil(w/2) (high v >> h, low (v & (2^h - 1)) - z with z = 2^(h-1)),
//
//   kmm2: three digit products with the Fig. 8 pre-adders,
//         C1 = A1.B1, Cs = (A1+A0).(B1+B0), C0 = A0.B0, and the Fig. 9
//         post-adder;
//   mm2:  four products without pre-adders, C1 = A1.B1, C10 = A1.B0,
//         C01 = A0.B1, C0 = A0.B0, and the conventional combine;
//
// then the Section IV-D zero-point correction over the logical padded K
// `kp`, the optional dequant epilogue val * (sx[m] * sw[n]) (sx * sw
// rounded first) and an int32, fp32 or bf16 (round to nearest even) store.
//
// Replaces the TPU kernel `_fused_kernel` in src/repro/kernels/fused_gemm.py
// (line 119: the digit split at 183-196, `_combine_kmm2` at 257,
// `_combine_mm2` at 277; entry point `fused_gemm`, line 395) in modes kmm2
// and mm2, and its grouped entry `fused_gemm_grouped` (line 437 there): G
// independent GEMMs (G, M, K) x (G, K, N) -> (G, M, N), ragged with
// `counts` (G, S) and a static `seg`: row r of group g is live iff
// r / seg < S and r % seg < counts[g, r / seg].  It computes what they
// compute, bit for bit.  Mode mm1 is fused_mm1.cu's, kmm4 fused_gemm.cu's.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8): at the
// serve path's row counts (decode M = 1-4 live lanes, expert GEMMs of 8-32
// rows, prefill M <= 64) the product is bound by reading B once, in int16:
// llama's lm_head (2048 x 128512) is 526 MB, 0.157 ms at the memory rate;
// the three or four digit products take longer than that read only above a
// few hundred rows.  The design is fused_mm1.cu's (its header says why each
// piece is there), on the int16 carrier:
//
//   * Copies: the carrier tiles of A and B are copied as they lie with
//     16-byte `cp.async.cg` (8 values a copy) into a ring of STAGES = 4
//     shared-memory stages (9 KB a stage at the 16-row tile); the copies
//     of the next three stages are in flight while the block splits and
//     multiplies the current one.  Rows that are not 16-byte aligned (K or
//     N not a multiple of 8, or an unaligned base) take element loads into
//     the same ring; ragged edges are zero-filled.
//   * The digit split, from shared memory: once a stage, each landed
//     carrier value is split once, by one thread, into its s8 digit planes
//     (kmm2: high, pre-adder high + low, low; mm2: high, low), which have
//     fused_mm1.cu's swizzled layout, so its fragment path (A by `ldmatrix`,
//     B from 32-bit loads of 4 k-rows and a 4x4 `__byte_perm` transpose,
//     `mma.sync.m16n8k32.s8.s8.s32`) runs unchanged, one product per
//     accumulator.  Two int16 values split at once in a 32-bit word: for
//     h <= 8 the high digit's byte is bits [h, h + 8) of the value, the low
//     digit's byte (v & mask) + (256 - z) modulo 256, the pre-adder's byte
//     their sum modulo 256 (its value, in [-128, 126], fits s8).  The
//     thread that splits an A value adds it to its row's int32 sum; B's
//     column sums come from two more MMAs a plane pair, an A of ones
//     times the high and the low plane.  No digit plane goes to device
//     memory.
//   * The logical padded K: the stages cover [0, kp); positions in [K, kp)
//     are the zero-filled value 0, digits (0, -z), and A's digits at
//     k >= kp are forced to 0, so they add nothing (rows >= M and columns
//     >= N split to nonzero digits; they are never stored).
//   * Exact split-K in one launch, as in fused_mm1.cu: where the tile grid
//     cannot fill the card (the MoE routers, N = 40: one tile), the host
//     plan (kernels/mm1_plan.py, over [0, kp)) splits K across blocks in
//     whole stages.  Each split writes the int32 partials of every
//     accumulator and its partial row and column sums; the last block to
//     arrive adds the others' modulo 2^32 (arrival order changes no bit),
//     runs the epilogue and resets the tile's counter.
//   * Tiles: 16 x 128 through M = 64, four warps of 16 x 32 (48 int32
//     accumulators a thread for kmm2, 64 for mm2; 164-167 registers), 32
//     deep stages, three blocks an SM; 64 x 128 above, eight warps of
//     32 x 32 (96 and 128), 64 deep stages, one block an SM, so no tile
//     carries more than two m16 row blocks of three or four accumulators.
//
// Numerics the design must keep (fused_gemm.cu's header): row and column
// sums wrap modulo 2^32 as the reference's int32 scratch does; the fp32
// epilogue follows the reference's operation order with explicitly rounded
// intrinsics (the library is built with --fmad=false): kmm2
// mid = (Cs - C1) - C0, core = (C1 * 2^2h + mid * 2^h) + C0; mm2
// mid = C10 + C01 in fp32; corr = (z * row + z * col) + z^2 kp with
// row = rowsum(A) - kp z; val = core + corr; or the int32-ring combine.
// Ragged grouped launches: the liveness mask touches the store only; a
// block with no live row writes its zero tile without reading, and under
// split-K only split 0 writes it and no split touches the counter.
//
// Build: the whole file compiles into one library.  Built with
// -DFUSED_SPLIT_UNIT=u it compiles only unit u (0: the C entry points;
// 1: kmm2 16-row tile, 2: kmm2 64-row tile, 3: mm2 16-row, 4: mm2 64-row,
// each dense and grouped), so the units compile in parallel nvcc processes
// and link together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#ifdef FUSED_SPLIT_UNIT
#define SPLIT_UNIT(u) (FUSED_SPLIT_UNIT == (u))
#else
#define SPLIT_UNIT(u) 1
#endif

namespace fused_split_detail {

constexpr int BN = 128;              // output columns per block
constexpr int STAGES = 4;            // shared-memory ring depth
constexpr int CARRIER = 2;           // bytes of an int16 carrier value

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };
// Digit layouts; the values are the wrapper's mode ids.
enum Layout { KMM2 = 2, MM2 = 3 };

// A BM x BN tile of layout L: WARPS_M x 4 warps, each MT m16 row blocks of
// one 32-column span; NACC accumulators of MT x 16 int32 a thread.  The
// 16-row tile takes 32-deep stages, so a block holds 50 KB (kmm2; mm2
// 46 KB) and three fit an SM at <= 168 registers: at decode a block's
// stage is latency-bound, and three blocks an SM read B faster than two
// with deeper stages.  The 64-row tile takes 64-deep stages, one block an
// SM.
template <int L, int BM>
struct Tile {
  static constexpr int NPLANE = L == KMM2 ? 3 : 2;
  static constexpr int NACC = L == KMM2 ? 3 : 4;
  static constexpr int WARPS_M = BM >= 32 ? BM / 32 : 1;
  static constexpr int MT = BM / 16 / WARPS_M;
  static constexpr int NTHREADS = 32 * 4 * WARPS_M;
  static constexpr int REGS = NACC * MT * 16;    // accumulators a thread
  static constexpr int BK = BM == 16 ? 32 : 64;  // K depth of a stage
  static constexpr int A_PITCH = BK + 16;        // padded A plane row (bytes)
  // carrier stage: A (BM, BK) then B (BK, BN), int16, rows unpadded
  static constexpr int A_STAGE = BM * BK * CARRIER;
  static constexpr int STAGE = A_STAGE + BK * BN * CARRIER;
  // digit planes: NPLANE A planes (BM, A_PITCH), then NPLANE B planes
  static constexpr int A_PLANE = BM * A_PITCH;
  static constexpr int B_PLANE = BK * BN;
  static constexpr int PLANES = NPLANE * (A_PLANE + B_PLANE);
  static constexpr int SMEM = STAGES * STAGE + PLANES;
  // 16-byte carrier chunks (8 values) of a stage, and a thread's share
  static constexpr int A_CHUNKS = BM * BK / 8;
  static constexpr int A_ITERS = (A_CHUNKS + NTHREADS - 1) / NTHREADS;
  static constexpr int B_ITERS = BK * BN / 8 / NTHREADS;
  static_assert((A_CHUNKS % NTHREADS == 0 || A_CHUNKS < NTHREADS)
                && B_ITERS >= 1 && NTHREADS % 16 == 0,
                "every thread splits whole chunks of B, at most one of A");
};

struct Params {
  const int16_t* a;    // (G, M, K) row-major
  const int16_t* b;    // (G, K, N) row-major
  const float* sx;     // (G, M) row scales, or null (no dequant)
  const float* sw;     // (G, N) column scales, or null
  void* out;           // (G, M, N) row-major
  const int* counts;   // (G, n_seg) live rows per segment, or null
  int* ws;             // split-K partials and sums, or null without a split
  int* counters;       // arrival counter a tile, 0 between launches
  int M, K, N, kp, h, z, combine_int32, out_kind, seg, n_seg, split, k_split,
      vec_a, vec_b;
  float pow_h, pow_2h, zf, zzkp;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 values from `src` (the first `n` of them valid, the rest zero) into
// shared memory at `dst`, with plain loads: the path for unaligned rows.
__device__ __forceinline__ void copy_elems(int16_t* dst, const int16_t* src,
                                           int n) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (c < n) {
      w[c >> 1] |= static_cast<uint32_t>(static_cast<uint16_t>(src[c]))
                   << (16 * (c & 1));
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Issue the copies of one carrier stage: A rows [m0, m0 + BM) and B rows
// [k0, k0 + BK) of columns [n0, n0 + BN), zero beyond M, K and N.
template <int L, int BM>
__device__ __forceinline__ void load_stage(const Params& p, const int16_t* A,
                                           const int16_t* B, int8_t* stage,
                                           int m0, int n0, int k0, int tid) {
  using T = Tile<L, BM>;
  int16_t* a_s = reinterpret_cast<int16_t*>(stage);
  int16_t* b_s = reinterpret_cast<int16_t*>(stage + T::A_STAGE);
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int c = tid + i * T::NTHREADS;
    if (c >= T::A_CHUNKS) break;
    const int r = c / (T::BK / 8), kc = (c % (T::BK / 8)) * 8;
    const int m = m0 + r, k = k0 + kc;
    const int n_ok = (m < p.M && k < p.K) ? min(8, p.K - k) : 0;
    const int16_t* src = n_ok ? A + static_cast<size_t>(m) * p.K + k : A;
    int16_t* dst = a_s + r * T::BK + kc;
    if (p.vec_a) {
      cp_async16(dst, src, n_ok * CARRIER);
    } else {
      copy_elems(dst, src, n_ok);
    }
  }
#pragma unroll
  for (int i = 0; i < T::B_ITERS; ++i) {
    const int c = tid + i * T::NTHREADS;
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const int k = k0 + r, n = n0 + nc;
    const int n_ok = (k < p.K && n < p.N) ? min(8, p.N - n) : 0;
    const int16_t* src = n_ok ? B + static_cast<size_t>(k) * p.N + n : B;
    int16_t* dst = b_s + r * BN + nc;
    if (p.vec_b) {
      cp_async16(dst, src, n_ok * CARRIER);
    } else {
      copy_elems(dst, src, n_ok);
    }
  }
}

// The digits of 8 carrier values (4 words of two int16 each) as 8 bytes a
// plane, in value order: plane 0 the high digit, then (kmm2) the pre-adder
// sum, then the low digit.  `mask2` and `zc2` hold 2^h - 1 and 256 - z in
// both halves of a word.  Only bytes 0 and 2 of each word reach a plane:
// the high digit's are bits [h, h + 8) of each value (w >> h, masked only
// where the pre-adder adds it), the low digit's (v & mask) + 256 - z, whose
// byte 1 is 0 or 1, so the pre-adder sum of the two carries nothing into
// byte 2.
template <int L>
__device__ __forceinline__ void split8(const uint4 v, int h, uint32_t mask2,
                                       uint32_t zc2,
                                       uint32_t (&d)[Tile<L, 16>::NPLANE][2]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = w[i] >> h;
    if constexpr (L == KMM2) hi[i] &= 0x00FF00FFu;
    lo[i] = (w[i] & mask2) + zc2;
  }
  d[0][0] = __byte_perm(hi[0], hi[1], 0x6420);
  d[0][1] = __byte_perm(hi[2], hi[3], 0x6420);
  constexpr int LO = L == KMM2 ? 2 : 1;
  d[LO][0] = __byte_perm(lo[0], lo[1], 0x6420);
  d[LO][1] = __byte_perm(lo[2], lo[3], 0x6420);
  if constexpr (L == KMM2) {
    uint32_t s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = hi[i] + lo[i];
    d[1][0] = __byte_perm(s[0], s[1], 0x6420);
    d[1][1] = __byte_perm(s[2], s[3], 0x6420);
  }
}

// The sum of the 8 values of a chunk.
__device__ __forceinline__ uint32_t sum8(const uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += static_cast<uint32_t>(
        static_cast<int>(static_cast<int16_t>(w[i] & 0xFFFFu)));
    s += static_cast<uint32_t>(static_cast<int>(w[i]) >> 16);
  }
  return s;
}

// Split one landed carrier stage (K positions [k0, k0 + BK)) into the digit
// planes, adding each A value to this thread's row sums (B's column sums
// come from the MMAs, see mma_stage).  Thread tid splits A chunk
// c = tid + NTHREADS i (row c / (BK / 8), k-chunk c % (BK / 8)) and B chunks
// (row tid / 16 + NTHREADS / 16 * i, column chunk tid % 16), the same A
// rows at every stage.
template <int L, int BM>
__device__ __forceinline__ void split_stage(
    const Params& p, const int8_t* stage, int8_t* planes, int k0, int tid,
    uint32_t mask2, uint32_t zc2, uint32_t (&rows)[Tile<L, BM>::A_ITERS]) {
  using T = Tile<L, BM>;
  constexpr int NP = T::NPLANE;
  const uint4* a_c = reinterpret_cast<const uint4*>(stage);
  const uint4* b_c = reinterpret_cast<const uint4*>(stage + T::A_STAGE);
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int c = tid + i * T::NTHREADS;
    if (c >= T::A_CHUNKS) break;
    const int r = c / (T::BK / 8), kc = c % (T::BK / 8);
    const uint4 v = a_c[c];
    rows[i] += sum8(v);
    uint32_t d[NP][2];
    split8<L>(v, p.h, mask2, zc2, d);
    // digits at k >= kp are 0: no term
    const int keep = min(max(p.kp - (k0 + kc * 8), 0), 8);
    if (keep < 8) {
      const uint32_t m0 = keep >= 4 ? 0xFFFFFFFFu : (1u << (8 * keep)) - 1u;
      const uint32_t m1 = keep <= 4 ? 0u : (1u << (8 * (keep - 4))) - 1u;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        d[q][0] &= m0;
        d[q][1] &= m1;
      }
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      *reinterpret_cast<uint2*>(planes + q * T::A_PLANE + r * T::A_PITCH
                                + kc * 8) = make_uint2(d[q][0], d[q][1]);
    }
  }
  int8_t* b_planes = planes + NP * T::A_PLANE;
#pragma unroll
  for (int i = 0; i < T::B_ITERS; ++i) {
    const int c = tid + i * T::NTHREADS;
    const int r = c / (BN / 8), cc = c % (BN / 8);
    const uint4 v = b_c[c];
    uint32_t d[NP][2];
    split8<L>(v, p.h, mask2, zc2, d);
    // 16-column chunk cc / 2 of row r, stored at chunk ^ 2((r / 4) % 4)
    const int off = r * BN + (((cc >> 1) ^ (2 * ((r >> 2) & 3))) * 16)
                    + (cc & 1) * 8;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      *reinterpret_cast<uint2*>(b_planes + q * T::B_PLANE + off) =
          make_uint2(d[q][0], d[q][1]);
    }
  }
}

// The A fragments of one m16 x k32 block (fused_mm1.cu's ldmatrix_a).
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4],
                                           const int8_t* row_ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fused_mm1.cu's transpose4x4: out[j] holds column j's four k values.
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&out)[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(x0, y0, 0x5410);
  out[1] = __byte_perm(x0, y0, 0x7632);
  out[2] = __byte_perm(x1, y1, 0x5410);
  out[3] = __byte_perm(x1, y1, 0x7632);
}

// The B fragments of one k32 step of one plane for 32-column span `span`
// (fused_mm1.cu's mma_stage): bf[h][j] for k half h and MMA column block j.
__device__ __forceinline__ void b_fragments(const int8_t* b_s, int kk,
                                            int col, int t,
                                            uint32_t (&bf)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = ld32(b_s + (kk + 16 * h + 4 * t + i) * BN + col);
    }
    transpose4x4(w, bf[h]);
  }
}

// 0x01 in each byte i < n of a word: the ones of k positions below kp.
__device__ __forceinline__ uint32_t ones_below(int n) {
  return n >= 4 ? 0x01010101u
                : n <= 0 ? 0u : 0x01010101u & ((1u << (8 * n)) - 1u);
}

// The MMAs of one stage (K positions [k0, k0 + BK)) on the digit planes.
// Warp (wm, wn) owns rows [32 wm, 32 wm + 16 MT) (16-row tile: all 16) and
// the 32-column span wn; acc[q][mt][j] is accumulator q's m16n8 block of
// row block mt whose MMA column c is tile column 32 wn + 4c + j.  B's
// column sums come from the same fragments: an A of ones in rows 0-7
// (k < kp) times the high plane and in rows 8-15 times the low plane adds
// each column's sum of high digits to rows 0-7 of csum[j] and of low digits
// to rows 8-15, since a column's values sum to 2^h (sum of high digits) +
// (sum of low digits) + (positions) z.
template <int L, int BM>
__device__ __forceinline__ void mma_stage(
    const int8_t* planes, int wm, int wn, int lane, int k0, int kp,
    int (&acc)[Tile<L, BM>::NACC][Tile<L, BM>::MT][4][4],
    int (&csum)[4][4]) {
  using T = Tile<L, BM>;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* a_s = planes
      + (wm * T::MT * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * T::A_PITCH
      + 16 * (lane >> 4);
  const int8_t* b_s = planes + T::NPLANE * T::A_PLANE;
  const int col = (((2 * wn + (g >> 2)) ^ (2 * t)) * 16) + (g & 3) * 4;
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 32) {
    const uint32_t o0 = ones_below(kp - (k0 + kk + 4 * t));
    const uint32_t o1 = ones_below(kp - (k0 + kk + 16 + 4 * t));
    const uint32_t ones[2][4] = {{o0, 0u, o1, 0u}, {0u, o0, 0u, o1}};
    if constexpr (L == KMM2) {
      // product q pairs A plane q with B plane q
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        uint32_t bf[2][4];
        b_fragments(b_s + q * T::B_PLANE, kk, col, t, bf);
        if (q != 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(csum[j], ones[q / 2], bf[0][j],
                                             bf[1][j]);
        }
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          uint32_t af[4];
          ldmatrix_a(af, a_s + q * T::A_PLANE + mt * 16 * T::A_PITCH + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[q][mt][j], af, bf[0][j],
                                             bf[1][j]);
        }
      }
    } else {
      // accumulator 2 qa + qb pairs A plane qa with B plane qb
#pragma unroll
      for (int qb = 0; qb < 2; ++qb) {
        uint32_t bf[2][4];
        b_fragments(b_s + qb * T::B_PLANE, kk, col, t, bf);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(csum[j], ones[qb], bf[0][j],
                                           bf[1][j]);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
          for (int qa = 0; qa < 2; ++qa) {
            uint32_t af[4];
            ldmatrix_a(af, a_s + qa * T::A_PLANE + mt * 16 * T::A_PITCH + kk);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(acc[2 * qa + qb][mt][j], af,
                                               bf[0][j], bf[1][j]);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t wrap_add(uint32_t a, int v) {
  return a + static_cast<uint32_t>(v);
}

// The Fig. 9 post-adder on int32 digit products, in fp32 as the reference
// orders it (_combine_kmm2).
__device__ __forceinline__ float combine_kmm2_f(int c1, int cs, int c0,
                                                float pow_h, float pow_2h) {
  const float c1f = __int2float_rn(c1);
  const float c0f = __int2float_rn(c0);
  const float mid = __fsub_rn(__fsub_rn(__int2float_rn(cs), c1f), c0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(c1f, pow_2h), __fmul_rn(mid, pow_h)),
                   c0f);
}

__device__ __forceinline__ void store_zero(const Params& p, void* out, int m,
                                           int n) {
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.out_kind == OUT_BF16) {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(0.f);
  } else if (p.out_kind == OUT_F32) {
    static_cast<float*>(out)[o] = 0.f;
  } else {
    static_cast<int*>(out)[o] = 0;
  }
}

// The combine, the correction, the dequant and the store of one element
// (fused_gemm.cu's store_out, for the two layouts), from the raw row sum
// and cc = colsum(B) - kp z, modulo 2^32.
template <int L>
__device__ __forceinline__ void store_out(const Params& p, void* out,
                                          const float* sx, const float* sw,
                                          const int (&c)[Tile<L, 16>::NACC],
                                          uint32_t row, uint32_t cc, int m,
                                          int n) {
  bool is_int = true;
  int vi = 0;
  float vf = 0.f;
  const uint32_t zu = p.z;
  const uint32_t kpz = static_cast<uint32_t>(p.kp) * zu;
  const uint32_t r = row - kpz;      // rowsum(A) - kp z, modulo 2^32
  if (p.combine_int32) {
    uint32_t core;
    const int h = p.h;
    if constexpr (L == KMM2) {
      const uint32_t c1 = c[0], cs = c[1], c0 = c[2];
      core = (c1 << (2 * h)) + ((cs - c1 - c0) << h) + c0;
    } else {
      const uint32_t u1 = c[0], u10 = c[1], u01 = c[2], u0 = c[3];
      core = (u1 << (2 * h)) + ((u10 + u01) << h) + u0;
    }
    vi = static_cast<int>(core + (zu * r + zu * cc
                                  + zu * zu * static_cast<uint32_t>(p.kp)));
  } else {
    float core;
    if constexpr (L == KMM2) {
      core = combine_kmm2_f(c[0], c[1], c[2], p.pow_h, p.pow_2h);
    } else {
      const float mid = __fadd_rn(__int2float_rn(c[1]),
                                  __int2float_rn(c[2]));
      core = __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(c[0]), p.pow_2h),
                                 __fmul_rn(mid, p.pow_h)),
                       __int2float_rn(c[3]));
    }
    const float rf = __int2float_rn(static_cast<int>(r));
    const float cf = __int2float_rn(static_cast<int>(cc));
    const float corr = __fadd_rn(
        __fadd_rn(__fmul_rn(p.zf, rf), __fmul_rn(p.zf, cf)), p.zzkp);
    vf = __fadd_rn(core, corr);
    is_int = false;
  }
  if (sx != nullptr) {
    const float v = is_int ? __int2float_rn(vi) : vf;
    vf = __fmul_rn(v, __fmul_rn(sx[m], sw[n]));
    is_int = false;
  }
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.out_kind == OUT_I32) {       // the wrapper allows it for int values
    static_cast<int*>(out)[o] = vi;
    return;
  }
  const float v = is_int ? __int2float_rn(vi) : vf;
  if (p.out_kind == OUT_F32) {
    static_cast<float*>(out)[o] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  }
}

// Position of accumulator (q, mt, j, r) in a thread's partials: the
// workspace holds partial e of thread tid at e * NTHREADS + tid, so every
// block of a tile (same thread mapping) writes and reads it coalesced.
template <int L, int BM>
__device__ __forceinline__ int& acc_at(
    int (&acc)[Tile<L, BM>::NACC][Tile<L, BM>::MT][4][4], int e) {
  constexpr int MT = Tile<L, BM>::MT;
  return acc[e / (MT * 16)][(e / 16) % MT][(e / 4) % 4][e % 4];
}

// One block: output tile (blockIdx.y, blockIdx.x % tiles_n) of group
// blockIdx.z over K split blockIdx.x / tiles_n.  GROUPED instantiates the
// grouped entry (its own name in a profile; the dense instance compiles
// the liveness test out).
template <int L, int BM, bool GROUPED>
__device__ __forceinline__ void split_block(const Params& p) {
  using T = Tile<L, BM>;
  constexpr int NT = T::NTHREADS;
  // per split and tile: the accumulators, then BM row sums and BN column
  // sums less z a position (cc)
  constexpr int TILE_INTS = T::REGS * NT + BM + BN;
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ int row_live[BM];
  __shared__ uint32_t row_sum[BM];
  __shared__ uint32_t col_sum[BN];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tn = blockIdx.x % tiles_n;
  const int sidx = blockIdx.x / tiles_n;
  const int m0 = blockIdx.y * BM, n0 = tn * BN;
  const size_t grp = blockIdx.z;
  const int tile = (static_cast<int>(grp) * gridDim.y + blockIdx.y) * tiles_n
                   + tn;

  const int16_t* A = p.a + grp * p.M * static_cast<size_t>(p.K);
  const int16_t* B = p.b + grp * p.K * static_cast<size_t>(p.N);
  const float* sx = p.sx != nullptr ? p.sx + grp * p.M : nullptr;
  const float* sw = p.sw != nullptr ? p.sw + grp * p.N : nullptr;
  void* out = static_cast<char*>(p.out)
      + grp * p.M * static_cast<size_t>(p.N)
      * (p.out_kind == OUT_BF16 ? 2 : 4);

  // Ragged liveness of this tile's rows (every row below M when dense).
  if (tid < BM) {
    const int r = m0 + tid;
    bool live = r < p.M;
    if (GROUPED && live && p.counts != nullptr) {
      const int s = r / p.seg;
      live = s < p.n_seg && r - s * p.seg < p.counts[grp * p.n_seg + s];
    }
    row_live[tid] = live;
    row_sum[tid] = 0;
  }
  if (tid < BN) col_sum[tid] = 0;
  if (!__syncthreads_or(tid < BM && row_live[tid])) {
    // No live row: split 0 writes the tile's exact zeros, nothing is read,
    // and no split touches the tile's counter.
    if (sidx == 0) {
      for (int idx = tid; idx < BM * BN; idx += NT) {
        const int m = m0 + idx / BN, n = n0 + idx % BN;
        if (m < p.M && n < p.N) store_zero(p, out, m, n);
      }
    }
    return;
  }

  int acc[T::NACC][T::MT][4][4];
#pragma unroll
  for (int q = 0; q < T::NACC; ++q)
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[q][mt][j][r] = 0;
  int csum[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) csum[j][r] = 0;
  uint32_t rows[T::A_ITERS];
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) rows[i] = 0;
  const uint32_t mask2 = ((1u << p.h) - 1u) * 0x10001u;
  const uint32_t zc2 = static_cast<uint32_t>(256 - p.z) * 0x10001u;

  // This split's range of the logical padded K: whole stages, the last one
  // ending at kp.
  int8_t* planes = smem + STAGES * T::STAGE;
  const int kb = sidx * p.k_split;
  const int ke = min(p.kp, kb + p.k_split);
  const int n_st = ke > kb ? (ke - kb + T::BK - 1) / T::BK : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) {
      load_stage<L, BM>(p, A, B, smem + s * T::STAGE, m0, n0, kb + s * T::BK,
                        tid);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_st; ++it) {
    // stage `it` has landed once at most STAGES - 2 groups are pending; the
    // barrier also frees the planes (every warp finished its MMAs) and the
    // slot split in the previous iteration
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < n_st) {
      load_stage<L, BM>(p, A, B, smem + (nxt % STAGES) * T::STAGE, m0, n0,
                        kb + nxt * T::BK, tid);
    }
    cp_async_commit();
    split_stage<L, BM>(p, smem + (it % STAGES) * T::STAGE, planes,
                       kb + it * T::BK, tid, mask2, zc2, rows);
    __syncthreads();
    mma_stage<L, BM>(planes, wm, wn, lane, kb + it * T::BK, p.kp, acc, csum);
  }
  cp_async_wait<0>();

  // This block's row sums and cc (modulo 2^32) into shared memory: row
  // g of csum[j] holds the sums of high digits of MMA columns 2t and
  // 2t + 1, row g + 8 those of low digits; lanes g = 0 of the first warp
  // row hold each column once.
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    if (tid + i * NT < T::A_CHUNKS) {
      atomicAdd(&row_sum[(tid + i * NT) / (T::BK / 8)], rows[i]);
    }
  }
  if (wm == 0 && g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        col_sum[wn * 32 + 4 * (2 * t + e) + j] =
            (static_cast<uint32_t>(csum[j][e]) << p.h)
            + static_cast<uint32_t>(csum[j][2 + e]);
      }
  }
  __syncthreads();

  if (p.split > 1) {
    // Publish this split's partials and sums, then count arrivals.
    int* mine = p.ws + (static_cast<size_t>(tile) * p.split + sidx)
                * TILE_INTS;
#pragma unroll
    for (int e = 0; e < T::REGS; ++e) {
      mine[e * NT + tid] = acc_at<L, BM>(acc, e);
    }
    if (tid < BM) mine[T::REGS * NT + tid] = static_cast<int>(row_sum[tid]);
    if (tid < BN) {
      mine[T::REGS * NT + BM + tid] = static_cast<int>(col_sum[tid]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      is_last = atomicAdd(p.counters + tile, 1) == p.split - 1;
    }
    __syncthreads();
    if (!is_last) return;
    // The last block adds every other split's partials and sums, modulo
    // 2^32, one split at a time.
    __threadfence();
    const int* base = p.ws + static_cast<size_t>(tile) * p.split * TILE_INTS;
    for (int s = 0; s < p.split; ++s) {
      if (s == sidx) continue;
      const int* part = base + static_cast<size_t>(s) * TILE_INTS;
#pragma unroll
      for (int e = 0; e < T::REGS; ++e) {
        int& a = acc_at<L, BM>(acc, e);
        a = static_cast<int>(wrap_add(static_cast<uint32_t>(a),
                                      __ldcg(part + e * NT + tid)));
      }
      if (tid < BM) {
        row_sum[tid] = wrap_add(row_sum[tid],
                                __ldcg(part + T::REGS * NT + tid));
      }
      if (tid < BN) {
        col_sum[tid] = wrap_add(col_sum[tid],
                                __ldcg(part + T::REGS * NT + BM + tid));
      }
    }
    if (tid == 0) p.counters[tile] = 0;   // ready for the next launch
    __syncthreads();
  }

  // Epilogue: MMA column c of warp (wm, wn)'s n8 block j is tile column
  // 32 wn + 4c + j; register r holds row g + 8 (r / 2) of its row block,
  // column 2t + r % 2.
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = (wm * T::MT + mt) * 16 + g + 8 * (r >> 1);
        const int colt = wn * 32 + 4 * (2 * t + (r & 1)) + j;
        const int m = m0 + row, n = n0 + colt;
        if (m >= p.M || n >= p.N) continue;
        if (!row_live[row]) {
          store_zero(p, out, m, n);            // dead row: exact zero
          continue;
        }
        int c[T::NACC];
#pragma unroll
        for (int q = 0; q < T::NACC; ++q) c[q] = acc[q][mt][j][r];
        store_out<L>(p, out, sx, sw, c, row_sum[row], col_sum[colt], m, n);
      }
}

// The kernels: the 16-row tile three blocks an SM (<= 170 registers); the
// 64-row tile one (its 96 or 128 accumulators and 16 column sums a thread
// take 231-254 registers; capped at 168 they spill).
template <int L, bool GROUPED>
__global__ void __launch_bounds__(Tile<L, 16>::NTHREADS, 3)
fused_split_kernel16(const Params p) {
  split_block<L, 16, GROUPED>(p);
}

template <int L, bool GROUPED>
__global__ void __launch_bounds__(Tile<L, 64>::NTHREADS, 1)
fused_split_kernel64(const Params p) {
  split_block<L, 64, GROUPED>(p);
}

// Launches `kernel` on `stream` without synchronising; returns
// cudaGetLastError().
template <int BM, int NTHREADS, int SMEM>
int launch_kernel(void (*kernel)(Params), const Params& p, int groups,
                  cudaStream_t stream) {
  if (SMEM > 48 * 1024) {            // above the default: opt in per device
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_n = (p.N + BN - 1) / BN;
  const dim3 grid(tiles_n * p.split, (p.M + BM - 1) / BM, groups);
  kernel<<<grid, NTHREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int BM, bool GROUPED>
int launch_instance(const Params& p, int groups, cudaStream_t stream) {
  using T = Tile<L, BM>;
  if constexpr (BM == 16) {
    return launch_kernel<BM, T::NTHREADS, T::SMEM>(
        fused_split_kernel16<L, GROUPED>, p, groups, stream);
  } else {
    return launch_kernel<BM, T::NTHREADS, T::SMEM>(
        fused_split_kernel64<L, GROUPED>, p, groups, stream);
  }
}

template <int L, int BM>
int launch_tile(const Params& p, int groups, bool grouped, cudaStream_t s) {
  return grouped ? launch_instance<L, BM, true>(p, groups, s)
                 : launch_instance<L, BM, false>(p, groups, s);
}

// One function per layout and tile, each defined in its own build unit.
int launch_kmm2_bm16(const Params& p, int groups, bool grouped,
                     cudaStream_t s);
int launch_kmm2_bm64(const Params& p, int groups, bool grouped,
                     cudaStream_t s);
int launch_mm2_bm16(const Params& p, int groups, bool grouped,
                    cudaStream_t s);
int launch_mm2_bm64(const Params& p, int groups, bool grouped,
                    cudaStream_t s);

#if SPLIT_UNIT(1)
int launch_kmm2_bm16(const Params& p, int groups, bool grouped,
                     cudaStream_t s) {
  return launch_tile<KMM2, 16>(p, groups, grouped, s);
}
#endif
#if SPLIT_UNIT(2)
int launch_kmm2_bm64(const Params& p, int groups, bool grouped,
                     cudaStream_t s) {
  return launch_tile<KMM2, 64>(p, groups, grouped, s);
}
#endif
#if SPLIT_UNIT(3)
int launch_mm2_bm16(const Params& p, int groups, bool grouped,
                    cudaStream_t s) {
  return launch_tile<MM2, 16>(p, groups, grouped, s);
}
#endif
#if SPLIT_UNIT(4)
int launch_mm2_bm64(const Params& p, int groups, bool grouped,
                    cudaStream_t s) {
  return launch_tile<MM2, 64>(p, groups, grouped, s);
}
#endif

}  // namespace fused_split_detail

#if SPLIT_UNIT(0)
namespace {

using namespace fused_split_detail;

// Checks the plan (kernels/mm1_plan.py over [0, kp)) and the digit split,
// and launches.  vec_a / vec_b ask for 16-byte copies; they are honoured
// only where every row of the operand is 16-byte aligned.
int launch(Params p, int groups, bool grouped, int mode, int bm,
           void* stream) {
  const long long tiles_m = (p.M + bm - 1) / (bm > 0 ? bm : 1);
  const int bk = bm == 16 ? Tile<KMM2, 16>::BK : Tile<KMM2, 64>::BK;
  const long long tiles_n = (p.N + BN - 1) / BN;
  const bool split_ok = p.split == 1
      ? p.k_split >= p.kp
      : (p.ws != nullptr && p.counters != nullptr && p.k_split > 0
         && p.k_split % bk == 0
         && static_cast<long long>(p.split - 1) * p.k_split < p.kp
         && static_cast<long long>(p.split) * p.k_split >= p.kp);
  // the digits fit s8 for h <= 7 (kmm2's pre-adder) and h <= 8 (mm2)
  const bool digits_ok = (mode == KMM2 && p.h >= 1 && p.h <= 7)
                         || (mode == MM2 && p.h >= 1 && p.h <= 8);
  if (groups < 1 || groups > 65535 || p.M < 1 || p.N < 1 || p.K < 0
      || p.kp < p.K || (bm != 16 && bm != 64) || tiles_m > 65535
      || p.split < 1 || tiles_n * p.split > 0x7fffffffLL || !split_ok
      || !digits_ok || p.z != (1 << (p.h - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.vec_a = p.vec_a && p.K % 8 == 0
            && reinterpret_cast<uintptr_t>(p.a) % 16 == 0;
  p.vec_b = p.vec_b && p.N % 8 == 0
            && reinterpret_cast<uintptr_t>(p.b) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == KMM2) {
    return bm == 16 ? launch_kmm2_bm16(p, groups, grouped, s)
                    : launch_kmm2_bm64(p, groups, grouped, s);
  }
  return bm == 16 ? launch_mm2_bm16(p, groups, grouped, s)
                  : launch_mm2_bm64(p, groups, grouped, s);
}

Params make_params(const void* a, const void* b, const void* sx,
                   const void* sw, void* out, void* ws, void* counters,
                   int M, int K, int N, int kp, int h, int z,
                   int combine_int32, int out_kind, int split, int k_split,
                   int vec_a, int vec_b) {
  Params p;
  p.a = static_cast<const int16_t*>(a);
  p.b = static_cast<const int16_t*>(b);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.out = out;
  p.counts = nullptr;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = M;
  p.K = K;
  p.N = N;
  p.kp = kp;
  p.h = h;
  p.z = z;
  p.combine_int32 = combine_int32;
  p.out_kind = out_kind;
  p.seg = 1;
  p.n_seg = 0;
  p.split = split;
  p.k_split = k_split;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  p.pow_h = std::ldexp(1.0f, h);
  p.pow_2h = std::ldexp(1.0f, 2 * h);
  p.zf = static_cast<float>(z);
  p.zzkp = static_cast<float>(static_cast<double>(z) * z * kp);
  return p;
}

}  // namespace

// Dense C entry point: (M, K) x (K, N) int16 -> (M, N); mode 2 = kmm2,
// 3 = mm2, split at h with centering z; kp the logical padded K; sx (M,)
// and sw (N,) or both null for no dequant; out_kind 0 = int32,
// 1 = float32, 2 = bfloat16.  bm, split and k_split come from the plan;
// ws holds tiles * split * (accumulators * bm * 128 + bm + 128) int32 and
// counters one int32 a tile, zero on entry and on return (both may be
// null without a split).
extern "C" int fused_split_launch(const void* a, const void* b,
                                  const void* sx, const void* sw, void* out,
                                  void* ws, void* counters, int M, int K,
                                  int N, int kp, int mode, int h, int z,
                                  int combine_int32, int out_kind, int bm,
                                  int split, int k_split, int vec_a,
                                  int vec_b, void* stream) {
  const Params p = make_params(a, b, sx, sw, out, ws, counters, M, K, N, kp,
                               h, z, combine_int32, out_kind, split, k_split,
                               vec_a, vec_b);
  return launch(p, 1, false, mode, bm, stream);
}

// Grouped C entry point: (G, M, K) x (G, K, N) -> (G, M, N), contiguous;
// sx (G, M) and sw (G, N) or both null; counts (G, n_seg) int32 with a
// positive seg, or null for a dense grouped launch.
extern "C" int fused_split_grouped_launch(
    const void* a, const void* b, const void* sx, const void* sw,
    const void* counts, void* out, void* ws, void* counters, int G, int M,
    int K, int N, int kp, int seg, int n_seg, int mode, int h, int z,
    int combine_int32, int out_kind, int bm, int split, int k_split,
    int vec_a, int vec_b, void* stream) {
  Params p = make_params(a, b, sx, sw, out, ws, counters, M, K, N, kp, h, z,
                         combine_int32, out_kind, split, k_split, vec_a,
                         vec_b);
  if (counts != nullptr) {
    if (seg <= 0 || n_seg <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.counts = static_cast<const int*>(counts);
    p.seg = seg;
    p.n_seg = n_seg;
  }
  return launch(p, G, true, mode, bm, stream);
}
#endif
