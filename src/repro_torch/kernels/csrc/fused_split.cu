// The fused GEMM's split modes for NVIDIA Hopper (sm_90a), dense and
// grouped: kmm2 (w 9..14) and mm2 (w 15..16) on int16 carrier codes, kmm4
// (w 17..26; 9..16 for the tuner) on int32 ones.  C = A . B, (M, K) x
// (K, N), both row-major, each operand split at h = ceil(w/2) into a signed
// high digit v >> h and a low digit (v & (2^h - 1)) - z, z = 2^(h-1):
//
//   kmm2: three digit products with the Fig. 8 pre-adders,
//         C1 = A1.B1, Cs = (A1+A0).(B1+B0), C0 = A0.B0, and the Fig. 9
//         post-adder;
//   mm2:  four products without pre-adders, C1 = A1.B1, C10 = A1.B0,
//         C01 = A0.B1, C0 = A0.B0, and the conventional combine;
//   kmm4: depth-2 KMM: each level-1 branch x of {A1, A1+A0, A0} is
//         re-split plainly at h2 = ceil((h+1)/2) into the leaves
//         x1 = x >> h2 and x0 = x & (2^h2 - 1), and runs kmm2 at h2 of its
//         own; the level-2 combine at h2 per branch, then the level-1
//         combine at h on the three branch values;
//
// then the Section IV-D zero-point correction over the logical padded K
// `kp`, the optional dequant epilogue val * (sx[m] * sw[n]) (sx * sw
// rounded first) and an int32, fp32 or bf16 (round to nearest even) store.
//
// Replaces the TPU kernel `_fused_kernel` in src/repro/kernels/fused_gemm.py
// (line 119: the digit split at 183-207, the row and column sums at
// 209-210, `_combine_kmm2` at 257, `_combine_kmm2_wide` at 268,
// `_combine_mm2` at 277; entry point `fused_gemm`, line 395) in modes kmm2,
// mm2 and kmm4, and its grouped entry `fused_gemm_grouped` (line 437
// there): G independent GEMMs (G, M, K) x (G, K, N) -> (G, M, N), ragged
// with `counts` (G, S) and a static `seg`: row r of group g is live iff
// r / seg < S and r % seg < counts[g, r / seg].  It computes what they
// compute, bit for bit.  Mode mm1 is fused_mm1.cu's.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8): at the
// serve path's row counts (decode M = 1-4 live lanes, expert GEMMs of 8-32
// rows, prefill M <= 64) the product is bound by reading B once, in its
// carrier: llama's lm_head (2048 x 128512) is 526 MB in int16, 0.157 ms at
// the memory rate, and 1.05 GB in int32 (kmm4), 0.31 ms; the digit
// products take longer than that read only above a few hundred rows.  The
// design is fused_mm1.cu's (its header says why each piece is there):
//
//   * Copies: the carrier tiles of A and B are copied as they lie with
//     16-byte `cp.async.cg` (8 int16 or 4 int32 values a copy) into a ring
//     of STAGES = 4 shared-memory stages (9 KB a stage at kmm2's 16-row
//     tile, 18 KB at kmm4's); the copies of the next three stages are in
//     flight while the block splits and multiplies the current one.  Rows
//     that are not 16-byte aligned (K or N not a multiple of 8 values, 4
//     for int32, or an unaligned base) take element loads into the same
//     ring; ragged edges are zero-filled.
//   * The digit split, from shared memory: once a stage, each landed
//     carrier value is split once, by one thread, into its s8 digit planes
//     (kmm2: high, pre-adder high + low, low; mm2: high, low; kmm4: the six
//     leaves, high and low of each branch), which have fused_mm1.cu's
//     swizzled layout, so its fragment path (A by `ldmatrix`, B from
//     32-bit loads of 4 k-rows and a 4x4 `__byte_perm` transpose,
//     `mma.sync.m16n8k32.s8.s8.s32`) runs unchanged.  No digit plane goes
//     to device memory.
//       int16: two values split at once in a 32-bit word: for h <= 8 the
//     high digit's byte is bits [h, h + 8) of the value, the low digit's
//     byte (v & mask) + (256 - z) modulo 256, the pre-adder's byte their
//     sum modulo 256 (its value, in [-128, 126], fits s8).  B's column sums
//     come from two more MMAs a plane pair, an A of ones times the high and
//     the low plane.
//       int32 (kmm4): each value's three branches are formed in 32 bits,
//     then packed two values a word as 16-bit lanes (|x| <= 2^h <= 2^13
//     fits), and each leaf byte comes from a word at once: the high leaf
//     is bits [h2, h2 + 8) of its lane, the low leaf the lane and mask2.
//     Every leaf fits s8 through h = 13 (high [-64, 63], low [0, 127]; the
//     quantizer's +2^25 at w = 26 included), and so the nested pre-adder
//     x1 + x0 (up to 189 at h >= 12) never forms: each branch runs four
//     leaf products, its middle accumulator gathers both cross products
//     x1.y0 + x0.y1, and the epilogue forms Cs = C1 + cross + C0 modulo
//     2^32, the integer the reference's pre-adder pass computes.  Six
//     planes, twelve products for nine, at every width.  B's column sums
//     are the raw values' sums kept by the splitting threads (a thread
//     splits the same 4 columns at every stage, 4 uint32 a thread), since
//     ones-MMAs over four leaf planes would take 64 more registers beside
//     the nine accumulators.
//     The thread that splits an A value adds it to its row's int32 sum.
//   * The logical padded K: the stages cover [0, kp); positions in [K, kp)
//     are the zero-filled value 0, digits (0, -z) (re-split at level 2 for
//     kmm4), and A's digits at k >= kp are forced to 0, so they add nothing
//     (rows >= M and columns >= N split to nonzero digits; they are never
//     stored).
//   * Exact split-K in one launch, as in fused_mm1.cu: where the tile grid
//     cannot fill the card (the MoE routers, N = 40: one tile; kmm4 at
//     llama's 2048 x 2048, 16 tiles), the host plan (kernels/mm1_plan.py,
//     over [0, kp)) splits K across blocks in whole stages.  Each split
//     writes the int32 partials of every accumulator and its partial row
//     and column sums; the last block to arrive adds the others' modulo
//     2^32 (arrival order changes no bit), runs the epilogue and resets the
//     tile's counter.
//   * Tiles, BN = 128 columns: kmm2 and mm2 16 x 128 through M = 64, four
//     warps of 16 x 32 (48 int32 accumulators a thread for kmm2, 64 for
//     mm2), 32 deep stages, three blocks an SM; 64 x 128 above, eight warps
//     of 32 x 32 (96 and 128), 64 deep stages, one block an SM.  kmm4's
//     nine accumulators allow one m16 row block a warp (144 a thread): 16 x
//     128 through M = 64, four warps, 32 deep stages, 101 KB of shared
//     memory, two blocks an SM; 32 x 128 above, eight warps of 16 x 32,
//     113 KB, one block an SM.
//
// Numerics the design must keep: row and column sums wrap modulo 2^32 as
// the reference's int32 scratch does (at w = 24 a row of 2^22s wraps once K
// reaches 512); the fp32 epilogue follows the reference's operation order
// with explicitly rounded intrinsics (the library is built with
// --fmad=false): kmm2 mid = (Cs - C1) - C0, core = (C1 * 2^2h + mid * 2^h)
// + C0; mm2 mid = C10 + C01 in fp32; kmm4 the kmm2 sequence at h2 per
// branch, then the same sequence at h on the three fp32 branch values;
// corr = (z * row + z * col) + z^2 kp with row = rowsum(A) - kp z; val =
// core + corr; or the int32-ring combine.  Ragged grouped launches: the
// liveness mask touches the store only; a block with no live row writes
// its zero tile without reading, and under split-K only split 0 writes it
// and no split touches the counter.
//
// Build: the whole file compiles into one library.  Built with
// -DFUSED_SPLIT_UNIT=u it compiles only unit u (0: the C entry points;
// 1: kmm2 16-row tile, 2: kmm2 64-row tile, 3: mm2 16-row, 4: mm2 64-row,
// 5: kmm4 16-row, 6: kmm4 32-row, each dense and grouped), so the units
// compile in parallel nvcc processes and link together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#ifdef FUSED_SPLIT_UNIT
#define SPLIT_UNIT(u) (FUSED_SPLIT_UNIT == (u))
#else
#define SPLIT_UNIT(u) 1
#endif

namespace fused_split_detail {

constexpr int BN = 128;              // output columns per block
constexpr int STAGES = 4;            // shared-memory ring depth

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };
// Digit layouts; the values are the wrapper's mode ids.
enum Layout { KMM2 = 2, MM2 = 3, KMM4 = 4 };

// A BM x BN tile of layout L: WARPS_M x 4 warps, each MT m16 row blocks of
// one 32-column span; NACC accumulators of MT x 16 int32 a thread.  The
// 16-row tile takes 32-deep stages: kmm2 and mm2 hold 50 / 46 KB a block,
// three an SM at <= 168 registers (at decode a block's stage is
// latency-bound, and three blocks an SM read B faster than two with deeper
// stages); kmm4 holds 101 KB, two an SM.  kmm2's and mm2's 64-row tile
// takes 64-deep stages, kmm4's 32-row tile 32-deep ones, one block an SM.
template <int L, int BM>
struct Tile {
  using Carrier = std::conditional_t<L == KMM4, int32_t, int16_t>;
  static constexpr int CARRIER = sizeof(Carrier);
  static constexpr int VALS = 16 / CARRIER;      // values a 16-byte chunk
  static constexpr int NPLANE = L == KMM2 ? 3 : L == MM2 ? 2 : 6;
  static constexpr int NACC = L == KMM2 ? 3 : L == MM2 ? 4 : 9;
  static constexpr int WARPS_M = L == KMM4 ? BM / 16 : BM >= 32 ? BM / 32 : 1;
  static constexpr int MT = BM / 16 / WARPS_M;
  static constexpr int NTHREADS = 32 * 4 * WARPS_M;
  static constexpr int MIN_BLOCKS = BM > 16 ? 1 : L == KMM4 ? 2 : 3;
  static constexpr int REGS = NACC * MT * 16;    // accumulators a thread
  static constexpr int BK = BM == 64 ? 64 : 32;  // K depth of a stage
  static constexpr int A_PITCH = BK + 16;        // padded A plane row (bytes)
  // carrier stage: A (BM, BK) then B (BK, BN), rows unpadded
  static constexpr int A_STAGE = BM * BK * CARRIER;
  static constexpr int STAGE = A_STAGE + BK * BN * CARRIER;
  // digit planes: NPLANE A planes (BM, A_PITCH), then NPLANE B planes
  static constexpr int A_PLANE = BM * A_PITCH;
  static constexpr int B_PLANE = BK * BN;
  static constexpr int PLANES = NPLANE * (A_PLANE + B_PLANE);
  static constexpr int SMEM = STAGES * STAGE + PLANES;
  // 16-byte carrier chunks of a stage, and a thread's share
  static constexpr int A_CHUNKS = BM * BK / VALS;
  static constexpr int A_ITERS = (A_CHUNKS + NTHREADS - 1) / NTHREADS;
  static constexpr int B_ROW_CHUNKS = BN / VALS;
  static constexpr int B_ITERS = BK * BN / VALS / NTHREADS;
  static_assert((A_CHUNKS % NTHREADS == 0 || A_CHUNKS < NTHREADS)
                && B_ITERS >= 1 && NTHREADS % B_ROW_CHUNKS == 0,
                "every thread splits whole chunks of B, the same columns at "
                "every stage, and at most one of A");
};

struct Params {
  const void* a;       // (G, M, K) row-major, in the layout's carrier
  const void* b;       // (G, K, N) row-major
  const float* sx;     // (G, M) row scales, or null (no dequant)
  const float* sw;     // (G, N) column scales, or null
  void* out;           // (G, M, N) row-major
  const int* counts;   // (G, n_seg) live rows per segment, or null
  int* ws;             // split-K partials and sums, or null without a split
  int* counters;       // arrival counter a tile, 0 between launches
  int M, K, N, kp, h, h2, z, combine_int32, out_kind, seg, n_seg, split,
      k_split, vec_a, vec_b;
  float pow_h, pow_2h, pow_h2, pow_2h2, zf, zzkp;
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

// One 16-byte chunk from `src` (the first `n` of its values valid, the rest
// zero) into shared memory at `dst`, with plain loads: the path for
// unaligned rows.
template <typename T>
__device__ __forceinline__ void copy_elems(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  union {
    T v[V];
    uint4 u;
  } chunk;
#pragma unroll
  for (int c = 0; c < V; ++c) chunk.v[c] = c < n ? src[c] : T(0);
  *reinterpret_cast<uint4*>(dst) = chunk.u;
}

// Issue the copies of one carrier stage: A rows [m0, m0 + BM) and B rows
// [k0, k0 + BK) of columns [n0, n0 + BN), zero beyond M, K and N.
template <int L, int BM>
__device__ __forceinline__ void load_stage(
    const Params& p, const typename Tile<L, BM>::Carrier* A,
    const typename Tile<L, BM>::Carrier* B, int8_t* stage, int m0, int n0,
    int k0, int tid) {
  using T = Tile<L, BM>;
  using C = typename T::Carrier;
  constexpr int V = T::VALS;
  C* a_s = reinterpret_cast<C*>(stage);
  C* b_s = reinterpret_cast<C*>(stage + T::A_STAGE);
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int c = tid + i * T::NTHREADS;
    if (c >= T::A_CHUNKS) break;
    const int r = c / (T::BK / V), kc = (c % (T::BK / V)) * V;
    const int m = m0 + r, k = k0 + kc;
    const int n_ok = (m < p.M && k < p.K) ? min(V, p.K - k) : 0;
    const C* src = n_ok ? A + static_cast<size_t>(m) * p.K + k : A;
    C* dst = a_s + r * T::BK + kc;
    if (p.vec_a) {
      cp_async16(dst, src, n_ok * T::CARRIER);
    } else {
      copy_elems(dst, src, n_ok);
    }
  }
#pragma unroll
  for (int i = 0; i < T::B_ITERS; ++i) {
    const int c = tid + i * T::NTHREADS;
    const int r = c / T::B_ROW_CHUNKS, nc = (c % T::B_ROW_CHUNKS) * V;
    const int k = k0 + r, n = n0 + nc;
    const int n_ok = (k < p.K && n < p.N) ? min(V, p.N - n) : 0;
    const C* src = n_ok ? B + static_cast<size_t>(k) * p.N + n : B;
    C* dst = b_s + r * BN + nc;
    if (p.vec_b) {
      cp_async16(dst, src, n_ok * T::CARRIER);
    } else {
      copy_elems(dst, src, n_ok);
    }
  }
}

// The digits of 8 int16 carrier values (4 words of two each) as 8 bytes a
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

// The six leaf digits of 4 int32 carrier values, one byte a value in value
// order, a word a plane: branch q of (A1, A1 + A0bar, A0bar) gives plane 2q
// its high leaf x >> h2 and plane 2q + 1 its low leaf x & (2^h2 - 1).  Each
// branch value fits 16 bits, so two values share a word as 16-bit lanes
// (`__byte_perm` 0x5410); the high leaf's byte is then bits [h2, h2 + 8) of
// a lane (h2 + 8 <= 15) and the low leaf's its lane and `mask2x` (2^h2 - 1
// in both lanes), bytes 0 and 2 of each word (0x6420).
__device__ __forceinline__ void split4_kmm4(const uint4 v, int h, int h2,
                                            uint32_t mask, uint32_t z,
                                            uint32_t mask2x,
                                            uint32_t (&d)[6]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t br[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t hi = static_cast<uint32_t>(static_cast<int>(w[i]) >> h);
    const uint32_t lo = (w[i] & mask) - z;
    br[0][i] = hi;
    br[1][i] = hi + lo;
    br[2][i] = lo;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint32_t p0 = __byte_perm(br[q][0], br[q][1], 0x5410);
    const uint32_t p1 = __byte_perm(br[q][2], br[q][3], 0x5410);
    d[2 * q] = __byte_perm(p0 >> h2, p1 >> h2, 0x6420);
    d[2 * q + 1] = __byte_perm(p0 & mask2x, p1 & mask2x, 0x6420);
  }
}

// The sum of the 8 int16 values of a chunk.
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

// The split constants a thread keeps: int16 layouts mask2 = (2^h - 1) and
// zc2 = 256 - z in both halves of a word; kmm4 mask = 2^h - 1, z and
// mask2x = 2^h2 - 1 in both halves.
struct SplitConsts {
  uint32_t mask, z, mask2x;
};

// Split one landed carrier stage (K positions [k0, k0 + BK)) into the digit
// planes, adding each A value to this thread's row sums.  B's column sums
// come from the MMAs (kmm2, mm2; see mma_stage) or, for kmm4, from this
// thread's `cols`: the raw sums of its 4 columns.  Thread tid splits A
// chunk c = tid + NTHREADS i (row c / (BK / VALS)) and B chunks (row
// tid / B_ROW_CHUNKS + NTHREADS / B_ROW_CHUNKS * i, column chunk
// tid % B_ROW_CHUNKS), the same A rows and B columns at every stage.
template <int L, int BM>
__device__ __forceinline__ void split_stage(
    const Params& p, const int8_t* stage, int8_t* planes, int k0, int tid,
    const SplitConsts& sc, uint32_t (&rows)[Tile<L, BM>::A_ITERS],
    uint32_t (&cols)[4]) {
  using T = Tile<L, BM>;
  constexpr int NP = T::NPLANE;
  constexpr int V = T::VALS;
  const uint4* a_c = reinterpret_cast<const uint4*>(stage);
  const uint4* b_c = reinterpret_cast<const uint4*>(stage + T::A_STAGE);
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    const int c = tid + i * T::NTHREADS;
    if (c >= T::A_CHUNKS) break;
    const int r = c / (T::BK / V), kc = c % (T::BK / V);
    const uint4 v = a_c[c];
    // digits at k >= kp are 0: no term
    const int keep = min(max(p.kp - (k0 + kc * V), 0), V);
    int8_t* dst = planes + r * T::A_PITCH + kc * V;
    if constexpr (L == KMM4) {
      rows[i] += v.x + v.y + v.z + v.w;
      uint32_t d[6];
      split4_kmm4(v, p.h, p.h2, sc.mask, sc.z, sc.mask2x, d);
      const uint32_t m = keep >= 4 ? 0xFFFFFFFFu : (1u << (8 * keep)) - 1u;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        *reinterpret_cast<uint32_t*>(dst + q * T::A_PLANE) = d[q] & m;
      }
    } else {
      rows[i] += sum8(v);
      uint32_t d[NP][2];
      split8<L>(v, p.h, sc.mask, sc.z, d);
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
        *reinterpret_cast<uint2*>(dst + q * T::A_PLANE) =
            make_uint2(d[q][0], d[q][1]);
      }
    }
  }
  int8_t* b_planes = planes + NP * T::A_PLANE;
#pragma unroll
  for (int i = 0; i < T::B_ITERS; ++i) {
    const int c = tid + i * T::NTHREADS;
    const int r = c / T::B_ROW_CHUNKS, cc = c % T::B_ROW_CHUNKS;
    const uint4 v = b_c[c];
    // 16-column chunk of row r, stored at chunk ^ 2((r / 4) % 4); the
    // thread's bytes are its V columns' offset within it
    const int c16 = cc * V / 16;
    const int off = r * BN + ((c16 ^ (2 * ((r >> 2) & 3))) * 16)
                    + (cc * V) % 16;
    if constexpr (L == KMM4) {
      cols[0] += v.x;
      cols[1] += v.y;
      cols[2] += v.z;
      cols[3] += v.w;
      uint32_t d[6];
      split4_kmm4(v, p.h, p.h2, sc.mask, sc.z, sc.mask2x, d);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        *reinterpret_cast<uint32_t*>(b_planes + q * T::B_PLANE + off) = d[q];
      }
    } else {
      uint32_t d[NP][2];
      split8<L>(v, p.h, sc.mask, sc.z, d);
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        *reinterpret_cast<uint2*>(b_planes + q * T::B_PLANE + off) =
            make_uint2(d[q][0], d[q][1]);
      }
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
// Warp (wm, wn) owns rows [16 MT wm, 16 MT (wm + 1)) and the 32-column span
// wn; acc[q][mt][j] is accumulator q's m16n8 block of row block mt whose
// MMA column c is tile column 32 wn + 4c + j.  kmm2 and mm2 take B's column
// sums from the same fragments: an A of ones in rows 0-7 (k < kp) times
// the high plane and in rows 8-15 times the low plane adds each column's
// sum of high digits to rows 0-7 of csum[j] and of low digits to rows 8-15,
// since a column's values sum to 2^h (sum of high digits) + (sum of low
// digits) + (positions) z.
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
    if constexpr (L == KMM4) {
      // branch q: leaves 2q (high) and 2q + 1 (low) of A and B; its
      // accumulators 3q (high . high), 3q + 1 (both cross products) and
      // 3q + 2 (low . low)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        uint32_t bh[2][4], bl[2][4];
        b_fragments(b_s + 2 * q * T::B_PLANE, kk, col, t, bh);
        b_fragments(b_s + (2 * q + 1) * T::B_PLANE, kk, col, t, bl);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          uint32_t ah[4], al[4];
          const int8_t* a_q = a_s + mt * 16 * T::A_PITCH + kk;
          ldmatrix_a(ah, a_q + 2 * q * T::A_PLANE);
          ldmatrix_a(al, a_q + (2 * q + 1) * T::A_PLANE);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_s8(acc[3 * q][mt][j], ah, bh[0][j], bh[1][j]);
            mma_s8(acc[3 * q + 1][mt][j], ah, bl[0][j], bl[1][j]);
            mma_s8(acc[3 * q + 1][mt][j], al, bh[0][j], bh[1][j]);
            mma_s8(acc[3 * q + 2][mt][j], al, bl[0][j], bl[1][j]);
          }
        }
      }
    } else {
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
            for (int j = 0; j < 4; ++j) mma_s8(csum[j], ones[q / 2],
                                               bf[0][j], bf[1][j]);
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
              ldmatrix_a(af,
                         a_s + qa * T::A_PLANE + mt * 16 * T::A_PITCH + kk);
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_s8(acc[2 * qa + qb][mt][j], af,
                                                 bf[0][j], bf[1][j]);
            }
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

// The same on fp32 branch values (_combine_kmm2_wide).
__device__ __forceinline__ float combine_wide_f(float c1, float cs, float c0,
                                                float pow_h, float pow_2h) {
  const float mid = __fsub_rn(__fsub_rn(cs, c1), c0);
  return __fadd_rn(__fadd_rn(__fmul_rn(c1, pow_2h), __fmul_rn(mid, pow_h)),
                   c0);
}

// The int32-ring post-adder (combine_int32), modulo 2^32.
__device__ __forceinline__ uint32_t combine_kmm2_u(uint32_t c1, uint32_t cs,
                                                   uint32_t c0, int h) {
  return (c1 << (2 * h)) + ((cs - c1 - c0) << h) + c0;
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

// The combine, the correction, the dequant and the store of one element,
// from the raw row sum and cc = colsum(B) - kp z, modulo 2^32.
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
  uint32_t u[Tile<L, 16>::NACC];
#pragma unroll
  for (int q = 0; q < Tile<L, 16>::NACC; ++q) u[q] = c[q];
  if constexpr (L == KMM4) {
    // each branch's middle accumulator holds its cross products: Cs is
    // C1 + cross + C0, the pre-adder product, modulo 2^32
#pragma unroll
    for (int q = 0; q < 3; ++q) u[3 * q + 1] += u[3 * q] + u[3 * q + 2];
  }
  if (p.combine_int32) {
    uint32_t core;
    const int h = p.h;
    if constexpr (L == KMM2) {
      core = combine_kmm2_u(u[0], u[1], u[2], h);
    } else if constexpr (L == MM2) {
      core = (u[0] << (2 * h)) + ((u[1] + u[2]) << h) + u[3];
    } else {
      core = combine_kmm2_u(combine_kmm2_u(u[0], u[1], u[2], p.h2),
                            combine_kmm2_u(u[3], u[4], u[5], p.h2),
                            combine_kmm2_u(u[6], u[7], u[8], p.h2), h);
    }
    vi = static_cast<int>(core + (zu * r + zu * cc
                                  + zu * zu * static_cast<uint32_t>(p.kp)));
  } else {
    float core;
    if constexpr (L == KMM2) {
      core = combine_kmm2_f(c[0], c[1], c[2], p.pow_h, p.pow_2h);
    } else if constexpr (L == MM2) {
      const float mid = __fadd_rn(__int2float_rn(c[1]),
                                  __int2float_rn(c[2]));
      core = __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(c[0]), p.pow_2h),
                                 __fmul_rn(mid, p.pow_h)),
                       __int2float_rn(c[3]));
    } else {
      float br[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        br[q] = combine_kmm2_f(static_cast<int>(u[3 * q]),
                               static_cast<int>(u[3 * q + 1]),
                               static_cast<int>(u[3 * q + 2]), p.pow_h2,
                               p.pow_2h2);
      }
      core = combine_wide_f(br[0], br[1], br[2], p.pow_h, p.pow_2h);
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
  using C = typename T::Carrier;
  constexpr int NT = T::NTHREADS;
  // per split and tile: the accumulators, then BM row sums and BN column
  // sums (kmm2, mm2: less z a position; kmm4: raw)
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

  const C* A = static_cast<const C*>(p.a)
      + grp * p.M * static_cast<size_t>(p.K);
  const C* B = static_cast<const C*>(p.b)
      + grp * p.K * static_cast<size_t>(p.N);
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
  uint32_t cols[4] = {0, 0, 0, 0};
  SplitConsts sc;
  if constexpr (L == KMM4) {
    sc = {(1u << p.h) - 1u, static_cast<uint32_t>(p.z),
          ((1u << p.h2) - 1u) * 0x10001u};
  } else {
    sc = {((1u << p.h) - 1u) * 0x10001u,
          static_cast<uint32_t>(256 - p.z) * 0x10001u, 0u};
  }

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
                       kb + it * T::BK, tid, sc, rows, cols);
    __syncthreads();
    mma_stage<L, BM>(planes, wm, wn, lane, kb + it * T::BK, p.kp, acc, csum);
  }
  cp_async_wait<0>();

  // This block's row and column sums (modulo 2^32) into shared memory.
#pragma unroll
  for (int i = 0; i < T::A_ITERS; ++i) {
    if (tid + i * NT < T::A_CHUNKS) {
      atomicAdd(&row_sum[(tid + i * NT) / (T::BK / T::VALS)], rows[i]);
    }
  }
  if constexpr (L == KMM4) {
    // the raw sums of this thread's 4 columns, shared with the threads
    // that split the same columns in other rows of each stage
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      atomicAdd(&col_sum[(tid % T::B_ROW_CHUNKS) * 4 + j], cols[j]);
    }
  } else if (wm == 0 && g == 0) {
    // row g of csum[j] holds the sums of high digits of MMA columns 2t and
    // 2t + 1, row g + 8 those of low digits; lanes g = 0 of the first warp
    // row hold each column once: cc = colsum(B) - kp z
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
  const uint32_t col_less = L == KMM4
      ? static_cast<uint32_t>(p.kp) * static_cast<uint32_t>(p.z) : 0u;
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
        store_out<L>(p, out, sx, sw, c, row_sum[row],
                     col_sum[colt] - col_less, m, n);
      }
}

// The kernels, one per layout and tile: the 16-row tiles three (kmm2, mm2;
// <= 168 registers) or two (kmm4; <= 255) blocks an SM; the larger tiles
// one (kmm2's and mm2's 64-row tile holds 96 or 128 accumulators and 16
// column sums a thread, 231-254 registers; capped at 168 they spill).
template <int L, int BM, bool GROUPED>
__global__ void __launch_bounds__(Tile<L, BM>::NTHREADS,
                                  Tile<L, BM>::MIN_BLOCKS)
fused_split_kernel(const Params p) {
  split_block<L, BM, GROUPED>(p);
}

// Launches one instance on `stream` without synchronising; returns
// cudaGetLastError().
template <int L, int BM, bool GROUPED>
int launch_instance(const Params& p, int groups, cudaStream_t stream) {
  using T = Tile<L, BM>;
  auto kernel = fused_split_kernel<L, BM, GROUPED>;
  if (T::SMEM > 48 * 1024) {         // above the default: opt in per device
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_n = (p.N + BN - 1) / BN;
  const dim3 grid(tiles_n * p.split, (p.M + BM - 1) / BM, groups);
  kernel<<<grid, T::NTHREADS, T::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
int launch_kmm4_bm16(const Params& p, int groups, bool grouped,
                     cudaStream_t s);
int launch_kmm4_bm32(const Params& p, int groups, bool grouped,
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
#if SPLIT_UNIT(5)
int launch_kmm4_bm16(const Params& p, int groups, bool grouped,
                     cudaStream_t s) {
  return launch_tile<KMM4, 16>(p, groups, grouped, s);
}
#endif
#if SPLIT_UNIT(6)
int launch_kmm4_bm32(const Params& p, int groups, bool grouped,
                     cudaStream_t s) {
  return launch_tile<KMM4, 32>(p, groups, grouped, s);
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
  const bool kmm4 = mode == KMM4;
  const long long tiles_m = (p.M + bm - 1) / (bm > 0 ? bm : 1);
  const int bk = bm == 64 ? 64 : 32;           // Tile<L, bm>::BK
  const long long tiles_n = (p.N + BN - 1) / BN;
  const bool tile_ok = bm == 16 || bm == (kmm4 ? 32 : 64);
  const bool split_ok = p.split == 1
      ? p.k_split >= p.kp
      : (p.ws != nullptr && p.counters != nullptr && p.k_split > 0
         && p.k_split % bk == 0
         && static_cast<long long>(p.split - 1) * p.k_split < p.kp
         && static_cast<long long>(p.split) * p.k_split >= p.kp);
  // the digits fit s8 for h <= 7 (kmm2's pre-adder), h <= 8 (mm2) and
  // h <= 13 (kmm4's leaves)
  const bool digits_ok = (mode == KMM2 && p.h >= 1 && p.h <= 7)
                         || (mode == MM2 && p.h >= 1 && p.h <= 8)
                         || (kmm4 && p.h >= 5 && p.h <= 13);
  if (groups < 1 || groups > 65535 || p.M < 1 || p.N < 1 || p.K < 0
      || p.kp < p.K || !tile_ok || tiles_m > 65535 || p.split < 1
      || tiles_n * p.split > 0x7fffffffLL || !split_ok || !digits_ok
      || p.z != (1 << (p.h - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vals = kmm4 ? 4 : 8;               // carrier values in 16 bytes
  p.vec_a = p.vec_a && p.K % vals == 0
            && reinterpret_cast<uintptr_t>(p.a) % 16 == 0;
  p.vec_b = p.vec_b && p.N % vals == 0
            && reinterpret_cast<uintptr_t>(p.b) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kmm4) {
    return bm == 16 ? launch_kmm4_bm16(p, groups, grouped, s)
                    : launch_kmm4_bm32(p, groups, grouped, s);
  }
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
  p.a = a;
  p.b = b;
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
  p.h2 = (h + 2) / 2;                // ceil((h + 1) / 2), kmm4's level 2
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
  p.pow_h2 = std::ldexp(1.0f, p.h2);
  p.pow_2h2 = std::ldexp(1.0f, 2 * p.h2);
  p.zf = static_cast<float>(z);
  p.zzkp = static_cast<float>(static_cast<double>(z) * z * kp);
  return p;
}

}  // namespace

// Dense C entry point: (M, K) x (K, N) -> (M, N), int16 for mode 2 = kmm2
// and 3 = mm2, int32 for 4 = kmm4; split at h with centering z; kp the
// logical padded K; sx (M,) and sw (N,) or both null for no dequant;
// out_kind 0 = int32, 1 = float32, 2 = bfloat16.  bm, split and k_split
// come from the plan; ws holds tiles * split * (accumulators * bm * 128 +
// bm + 128) int32 and counters one int32 a tile, zero on entry and on
// return (both may be null without a split).
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
