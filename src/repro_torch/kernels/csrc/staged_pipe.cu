// The staged MM1, KMM2 and MM2 digit-plane kernels for NVIDIA Hopper
// (sm_90a): C = A . B on planes already in device memory, (M, K) x (K, N).
//
// Replaces three TPU kernels of src/repro/kernels/ and computes what each
// computes, bit for bit:
//
//   `_mm1_kernel`  (mm1_gemm.py:23; entry `mm1_gemm`, :40):
//       int8 (M, K) . (K, N) -> int32, one accumulator.
//   `_kmm2_kernel` (kmm_gemm.py:45; entry `kmm2_gemm_planes`, :89):
//       KMM2 on digit planes a1, a0 (M, K) and b1, b0 (K, N): the Fig. 8
//       pre-adders a1 + a0 and b1 + b0, three accumulators
//       C1 = A1.B1, Cs = (A1+A0).(B1+B0), C0 = A0.B0, and the Fig. 9
//       post-adder C1<<2h + (Cs-C1-C0)<<h + C0 in int32 or fp32.
//   `_mm2_kernel`  (mm2_gemm.py:24; entry `mm2_gemm_planes`, :65):
//       conventional MM2 on the same int8 planes: four accumulators
//       C1 = A1.B1, C10 = A1.B0, C01 = A0.B1, C0 = A0.B0 and the combine
//       C1<<2h + (C10+C01)<<h + C0 in int32 or fp32.
//
// The zero-point correction, the padding of K and the digit split stay in
// the caller (repro_torch/kernels/ops.py), as in the reference: K arrives
// padded and the planes hold the padding's digits.  Four layouts, one
// kernel template:
//
//   MM1         one int8 plane an operand, one accumulator;
//   KMM2        the s8 route: int8 planes (depth 1, w <= 14), or int16
//               planes split at h <= 6 (the depth-2 branches of
//               ops._kmm4_core through w = 22), whose pre-adder sums fit
//               s8; three products, the pre-adder operand of each formed
//               from the two digit fragments with `__vadd4` (per byte,
//               modulo 256: the true sum fits s8, so the byte is exact);
//               no third plane is stored anywhere;
//   KMM2_SPLIT  int16 planes split at h = 7 (w 23..26), where the
//               pre-adder reaches [-64, 189] and fits neither s8 nor u8:
//               the four leaf products, the two cross products a1.b0 and
//               a0.b1 into one accumulator, and Cs = C1 + cross + C0 formed
//               in uint32 in the epilogue, the same integer by
//               (a1 + a0)(b1 + b0) = a1.b1 + (a1.b0 + a0.b1) + a0.b0;
//   MM2         int8 planes split at h <= 8 (w <= 16): the same four
//               products as KMM2_SPLIT, but the two cross products in two
//               accumulators, C10 and C01, kept apart to the combine: the
//               reference's fp32 combine rounds f32(C10) + f32(C01), which
//               is not f32(C10 + C01).
//
// Hopper has no int16 MMA: int16 planes (every value fits s8, as the
// callers guarantee) are copied as they lie and narrowed to s8 in one
// shared-memory pass a stage (the low byte of each value, two
// `__byte_perm`s for 8 values), into the layout int8 planes have in the
// ring, so one fragment path serves both.
//
// B comes in either layout, told apart by its strides in the wrapper:
//   N-major  contiguous (K, N), the reference's contract.  Its rows are
//            copied as they lie into XOR-swizzled shared rows and each
//            thread builds its fragments from 32-bit loads of 4 k-rows,
//            transposed as 4x4 bytes with `__byte_perm` (fused_mm1.cu's
//            fragment path; MMA column c of n8 block j is tile column
//            4c + j of the warp's span);
//   K-major  B = t.t() of a contiguous (N, K) tensor, as the tied
//            lm_head's codes (embed.T) and the planes ops.py splits from
//            them arrive (ops.py keeps B's layout and never transposes
//            it: a transposing copy costs more than it gains).  Its
//            rows are copied like A's and its fragments come from
//            non-transposing `ldmatrix`, exactly like A, with no byte
//            permutes (MMA column c of block j is tile column 8j + c).
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8): at
// the serve path's rows (decode M = live slots, prefill M <= 64, the
// per-expert redirect's 8-32 rows) the kernel is bound by reading the B
// planes once (K N plane bytes each; one plane for MM1, two for the
// others); at M = 2048 by its 1, 3 or 4 s8 products.  The design:
//
//   * Copies: 16-byte `cp.async.cg` copies of the A and B planes into a
//     ring of STAGES = 4 shared-memory stages of 64 bytes of K a row (64
//     int8 or 32 int16 values); the copies of the next three stages are in
//     flight while the MMAs run on the current one.  Each copy asks L2 for
//     its whole 128-byte line (`.L2::128B`): a K-major row's stage is half
//     a line, and the hint lets DRAM serve whole lines.  Ragged edges are
//     zero-filled (a source size below 16); rows that are not 16-byte
//     aligned (a row length or a base not a multiple of 16 bytes) take
//     byte loads into the same ring.
//   * Products: s8 `mma.sync.m16n8k32.s8.s8.s32`, A fragments by
//     `ldmatrix`.  Four warps a 32-column span each of a BN = 128 tile.
//   * Exact split-K in one launch where the tile grid cannot fill the card
//     (the host plan, kernels/mm1_plan.py `plan_staged`, splits K in whole
//     stages): each split writes the int32 partials of every accumulator
//     to a workspace, and the last block to arrive on a tile adds the
//     others' modulo 2^32 (arrival order changes no bit), then runs the Cs
//     rebuild and the combine, and sets the tile's counter back to 0.  The
//     workspace and counters belong to the caller's stream.
//   * Tiles: 16 rows through M = 64 (one m16 row block; four warps), 64
//     rows above: MM1 four warps of 64 x 32 (64 accumulators a thread),
//     the KMM2 layouts eight warps of 32 x 32 (96), MM2 sixteen warps of
//     16 x 32 (its four accumulators of 32 x 32 spans would be 128 a
//     thread; at 16 rows a warp they are 64, as at the 16-row tile).  A
//     warp skips the MMAs of its m16 row blocks that lie wholly below M.
//
// Numerics the design must keep: accumulators wrap modulo 2^32 as the
// reference's int32 scratch does, so the int32 combine runs in uint32; the
// fp32 combine follows the reference's operation order with explicitly
// rounded intrinsics (the library is built with --fmad=false): KMM2
// mid = (Cs - C1) - C0, MM2 mid = C10 + C01, then out = (C1 * 2^2h +
// mid * 2^h) + C0.
//
// Build: the whole file compiles into one library.  Built with
// -DSTAGED_PIPE_UNIT=u it compiles only unit u (0: the C entry point;
// 1-2: MM1 at the 16- and 64-row tile; 3-4: KMM2 on int8 planes; 5-6:
// KMM2 on int16 planes; 7-8: KMM2_SPLIT; 9-10: MM2; each unit both B
// layouts), so parallel nvcc processes compile the units and link them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#ifdef STAGED_PIPE_UNIT
#define SP_UNIT(u) (STAGED_PIPE_UNIT == (u))
#else
#define SP_UNIT(u) 1
#endif

namespace staged_pipe_detail {

constexpr int BN = 128;              // output columns per block
constexpr int STAGES = 4;            // shared-memory ring depth
constexpr int ROW_BYTES = 64;        // bytes of K a stage holds of a row

// Layouts; the values are the wrapper's layout ids.
enum Layout { MM1 = 1, KMM2 = 2, KMM2_SPLIT = 3, MM2 = 4 };

// A BM x BN tile of layout L on planes of PB bytes a value, B K-major or
// N-major: WARPS_M x 4 warps, each MT m16 row blocks of one 32-column
// span; NACC accumulators of MT x 16 int32 a thread (MM2 one row block a
// warp, so its four accumulators take 64 registers at either tile).
//   Ring stage (planes as they lie): NP A planes of BM rows of RP bytes,
//   then NP B planes: K-major BN rows of RP bytes, N-major BK rows of
//   BN * PB bytes (swizzled for int8).
//   s8 planes the MMAs read: the ring stage itself for int8; for int16 one
//   narrowed set, the same layout at BK values a row.
template <int L, int BM, int PB, bool KMAJ>
struct Tile {
  static constexpr int NP = L == MM1 ? 1 : 2;    // planes an operand
  static constexpr int NACC = L == MM1 ? 1 : L == MM2 ? 4 : 3;
  static constexpr int WARPS_M =
      (L == MM1 || BM < 32) ? 1 : L == MM2 ? BM / 16 : BM / 32;
  static constexpr int MT = BM / 16 / WARPS_M;
  static constexpr int NT = 128 * WARPS_M;
  static constexpr int REGS = NACC * MT * 16;    // accumulators a thread
  static constexpr int BK = ROW_BYTES / PB;      // K depth of a stage
  static constexpr int RP = ROW_BYTES + 16;      // padded ring row (bytes)
  static constexpr int A_PLANE = BM * RP;
  static constexpr int B_PLANE = KMAJ ? BN * RP : BK * BN * PB;
  static constexpr int STAGE = NP * (A_PLANE + B_PLANE);
  static constexpr int P8 = BK + 16;             // padded s8 row (bytes)
  static constexpr int A8_PLANE = BM * P8;
  static constexpr int B8_PLANE = KMAJ ? BN * P8 : BK * BN;
  static constexpr int PLANES8 = PB == 1 ? 0 : NP * (A8_PLANE + B8_PLANE);
  static constexpr int SMEM = STAGES * STAGE + PLANES8;
  static_assert(PB == 1 || PB == 2, "int8 or int16 planes");
  static_assert(PB == 2 || (P8 == RP && A8_PLANE == A_PLANE
                            && B8_PLANE == B_PLANE),
                "int8 planes are read where they land");
  static_assert(MT * 16 * WARPS_M == BM && BK % 32 == 0, "warp grid");
  static_assert(L != MM2 || PB == 1, "MM2 takes int8 planes");
};

struct Params {
  const int8_t* a[2];  // (M, K) row-major planes (a[1] null for MM1)
  const int8_t* b[2];  // (K, N) planes: row-major, or K-major ((N, K) rows)
  void* out;           // (M, N) row-major: int32, or float32 (fp32 combine)
  int* ws;             // split-K partials, or null without a split
  int* counters;       // arrival counter a tile, 0 between launches
  int M, K, N, h, combine_int32, split, k_split, vec_a, vec_b;
  float pow_h, pow_2h;
};

// A 16-byte async copy that asks L2 to fetch the whole 128-byte line:
// a K-major row's stage is 64 bytes, so the next stage's half of the line
// is then in L2 when its copy is issued (without the hint K-major B read
// 1.4-1.6x slower than N-major at decode).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
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

// 16 bytes from `src` (the first `n` of them valid, the rest zero) into
// shared memory at `dst`: a 16-byte async copy, or plain byte loads for
// unaligned rows.
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src,
                                       int n, bool vec) {
  if (vec) {
    cp_async16(dst, src, n);
    return;
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (c < n) {
      w[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[c]))
                   << (8 * (c & 3));
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Copy `rows` rows of ROW_BYTES bytes each (the stage's K range, from byte
// `kb0` of each row) of a plane whose rows are `row_len` bytes long into
// shared rows `pitch` apart: row r is global row r0 + r, present if below
// `n_rows`; bytes past `row_len` or absent rows are zero.
template <int ROWS, int NT>
__device__ __forceinline__ void copy_rows(int8_t* dst, const int8_t* src,
                                          int r0, int n_rows, long long kb0,
                                          int row_len, int pitch, bool vec,
                                          int tid) {
  constexpr int CPR = ROW_BYTES / 16;
  constexpr int CHUNKS = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
    const int c = tid + i * NT;
    if (CHUNKS % NT != 0 && c >= CHUNKS) break;
    const int r = c / CPR, kc = c % CPR;
    const long long kb = kb0 + kc * 16;
    const int n_ok = (r0 + r < n_rows && kb < row_len)
        ? static_cast<int>(min(16LL, row_len - kb)) : 0;
    const int8_t* s = n_ok
        ? src + static_cast<size_t>(r0 + r) * row_len + kb : src;
    copy16(dst + r * pitch + kc * 16, s, n_ok, vec);
  }
}

// Issue the copies of one stage: A rows [m0, m0 + BM) and B's K range
// [k0, k0 + BK) of columns [n0, n0 + BN), zero beyond M, K and N.
template <int L, int BM, int PB, bool KMAJ>
__device__ __forceinline__ void load_stage(const Params& p, int8_t* st,
                                           int m0, int n0, int k0,
                                           int tid) {
  using T = Tile<L, BM, PB, KMAJ>;
  const long long kb0 = static_cast<long long>(k0) * PB;
  const int k_len = p.K * PB;                    // bytes of a K row
#pragma unroll
  for (int q = 0; q < T::NP; ++q) {
    copy_rows<BM, T::NT>(st + q * T::A_PLANE, p.a[q], m0, p.M, kb0, k_len,
                         T::RP, p.vec_a, tid);
  }
  int8_t* b_s = st + T::NP * T::A_PLANE;
#pragma unroll
  for (int q = 0; q < T::NP; ++q) {
    if constexpr (KMAJ) {
      copy_rows<BN, T::NT>(b_s + q * T::B_PLANE, p.b[q], n0, p.N, kb0,
                           k_len, T::RP, p.vec_b, tid);
    } else {
      // BK rows of BN * PB bytes; int8 16-byte chunk c of row r is stored
      // at chunk c ^ 2((r / 4) % 4) (fused_mm1.cu's swizzle), int16 rows
      // as they lie (the narrowing pass swizzles their s8 bytes)
      constexpr int CPR = BN * PB / 16;
      constexpr int CHUNKS = T::BK * CPR;
      static_assert(CHUNKS % T::NT == 0, "whole chunks a thread");
      const int n_len = p.N * PB;                // bytes of a B row
#pragma unroll
      for (int i = 0; i < CHUNKS / T::NT; ++i) {
        const int c = tid + i * T::NT;
        const int r = c / CPR, cc = c % CPR;
        const int k = k0 + r;
        const int nb = n0 * PB + cc * 16;
        const int n_ok = (k < p.K && nb < n_len) ? min(16, n_len - nb) : 0;
        const int8_t* s = n_ok
            ? p.b[q] + static_cast<size_t>(k) * n_len + nb : p.b[q];
        const int off = PB == 1 ? r * BN + ((cc ^ (2 * ((r >> 2) & 3))) * 16)
                                : r * BN * PB + cc * 16;
        copy16(b_s + q * T::B_PLANE + off, s, n_ok, p.vec_b);
      }
    }
  }
}

// The low bytes of 8 int16 values: their s8 digits.
__device__ __forceinline__ uint2 narrow8(const uint4 v) {
  return make_uint2(__byte_perm(v.x, v.y, 0x6420),
                    __byte_perm(v.z, v.w, 0x6420));
}

// Narrow `rows` padded int16 rows (ROW_BYTES a row, `pitch16` apart) to
// s8 rows `pitch8` apart.
template <int ROWS, int NT>
__device__ __forceinline__ void narrow_rows(int8_t* dst, const int8_t* src,
                                            int pitch16, int pitch8,
                                            int tid) {
  constexpr int CPR = ROW_BYTES / 16;
  constexpr int CHUNKS = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
    const int c = tid + i * NT;
    if (CHUNKS % NT != 0 && c >= CHUNKS) break;
    const int r = c / CPR, kc = c % CPR;
    *reinterpret_cast<uint2*>(dst + r * pitch8 + kc * 8) = narrow8(
        *reinterpret_cast<const uint4*>(src + r * pitch16 + kc * 16));
  }
}

// The int16 planes of one landed stage narrowed to the s8 planes the MMAs
// read (every value fits s8, so its low byte is its digit).
template <int L, int BM, bool KMAJ>
__device__ __forceinline__ void narrow_stage(const int8_t* st, int8_t* p8,
                                             int tid) {
  using T = Tile<L, BM, 2, KMAJ>;
#pragma unroll
  for (int q = 0; q < T::NP; ++q) {
    narrow_rows<BM, T::NT>(p8 + q * T::A8_PLANE, st + q * T::A_PLANE, T::RP,
                           T::P8, tid);
  }
  const int8_t* b16 = st + T::NP * T::A_PLANE;
  int8_t* b8 = p8 + T::NP * T::A8_PLANE;
#pragma unroll
  for (int q = 0; q < T::NP; ++q) {
    if constexpr (KMAJ) {
      narrow_rows<BN, T::NT>(b8 + q * T::B8_PLANE, b16 + q * T::B_PLANE,
                             T::RP, T::P8, tid);
    } else {
      // BK rows of BN int16 (16 chunks of 8 values) to BN swizzled bytes:
      // 8 values land in half of 16-byte chunk cc / 2
      constexpr int CHUNKS = T::BK * 16;
      static_assert(CHUNKS % T::NT == 0, "whole chunks a thread");
#pragma unroll
      for (int i = 0; i < CHUNKS / T::NT; ++i) {
        const int c = tid + i * T::NT;
        const int r = c / 16, cc = c % 16;
        const uint4 v = *reinterpret_cast<const uint4*>(
            b16 + q * T::B_PLANE + r * BN * 2 + cc * 16);
        *reinterpret_cast<uint2*>(
            b8 + q * T::B8_PLANE + r * BN
            + (((cc >> 1) ^ (2 * ((r >> 2) & 3))) * 16) + (cc & 1) * 8) =
            narrow8(v);
      }
    }
  }
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i holds this thread's word of matrix
// i (row lane / 4, bytes 4 (lane % 4) .. + 3).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const int8_t* row_ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
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

// The B fragments of one k32 step of one s8 plane for 32-column span
// `wn`: bf[h][j] for k half h and n8 block j.
//   K-major (rows of `pitch` bytes, one a column): `ldmatrix` like A; lane
//   l addresses column 16 jp + l % 8 + 8 (l / 16), bytes 16 ((l / 8) % 2),
//   so matrices 0-3 are (block 2 jp, k half 0), (2 jp, 1), (2 jp + 1, 0),
//   (2 jp + 1, 1); MMA column c of block j is span column 8j + c.
//   N-major (swizzled BN-byte rows, one a k): fused_mm1.cu's 32-bit loads
//   of 4 k-rows and 4x4 byte transposes; MMA column c of block j is span
//   column 4c + j.
template <bool KMAJ>
__device__ __forceinline__ void b_fragments(const int8_t* b_s, int kk,
                                            int wn, int lane, int pitch,
                                            uint32_t (&bf)[2][4]) {
  if constexpr (KMAJ) {
    const int8_t* row = b_s
        + (wn * 32 + (lane & 7) + 8 * (lane >> 4)) * pitch
        + 16 * ((lane >> 3) & 1) + kk;
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t r[4];
      ldmatrix_x4(r, row + jp * 16 * pitch);
      bf[0][2 * jp] = r[0];
      bf[1][2 * jp] = r[1];
      bf[0][2 * jp + 1] = r[2];
      bf[1][2 * jp + 1] = r[3];
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    // this thread's word of each k-row: logical chunk 2 wn + g / 4, stored
    // at chunk ^ 2t (rows kk + 16h + 4t + i have (row / 4) % 4 = t)
    const int col = (((2 * wn + (g >> 2)) ^ (2 * t)) * 16) + (g & 3) * 4;
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
}

// The MMAs of one stage on its s8 planes (A at a8, B at b8).  Warp
// (wm, wn) owns rows [16 MT wm, 16 MT (wm + 1)) of the tile and the
// 32-column span wn; acc[q][mt][j] is accumulator q's m16n8 block of row
// block mt and n8 block j.  `rows_live` counts the warp's rows below M;
// row blocks wholly past it are skipped (warp-uniform).  Plane 0 is the
// high digit, plane 1 the low one.
template <int L, int BM, int PB, bool KMAJ>
__device__ __forceinline__ void mma_stage(
    const int8_t* a8, const int8_t* b8, int wm, int wn, int lane,
    int rows_live,
    int (&acc)[Tile<L, BM, PB, KMAJ>::NACC][Tile<L, BM, PB, KMAJ>::MT][4][4]) {
  using T = Tile<L, BM, PB, KMAJ>;
  const int8_t* a_s = a8
      + (wm * T::MT * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * T::P8
      + 16 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 32) {
    uint32_t bf[T::NP][2][4];
#pragma unroll
    for (int q = 0; q < T::NP; ++q) {
      b_fragments<KMAJ>(b8 + q * T::B8_PLANE, kk, wn, lane, T::P8, bf[q]);
    }
    uint32_t bs[2][4];               // KMM2: the pre-adder b1 + b0
    if constexpr (L == KMM2) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) bs[h][j] = __vadd4(bf[0][h][j],
                                                       bf[1][h][j]);
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      if (mt * 16 >= rows_live) break;
      uint32_t af[T::NP][4];
#pragma unroll
      for (int q = 0; q < T::NP; ++q) {
        ldmatrix_x4(af[q], a_s + q * T::A8_PLANE + mt * 16 * T::P8 + kk);
      }
      uint32_t as[4];                // KMM2: the pre-adder a1 + a0
      if constexpr (L == KMM2) {
#pragma unroll
        for (int r = 0; r < 4; ++r) as[r] = __vadd4(af[0][r], af[1][r]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (L == MM1) {
          mma_s8(acc[0][mt][j], af[0], bf[0][0][j], bf[0][1][j]);
        } else if constexpr (L == KMM2) {
          mma_s8(acc[0][mt][j], af[0], bf[0][0][j], bf[0][1][j]);
          mma_s8(acc[1][mt][j], as, bs[0][j], bs[1][j]);
          mma_s8(acc[2][mt][j], af[1], bf[1][0][j], bf[1][1][j]);
        } else if constexpr (L == KMM2_SPLIT) {
          mma_s8(acc[0][mt][j], af[0], bf[0][0][j], bf[0][1][j]);
          mma_s8(acc[1][mt][j], af[0], bf[1][0][j], bf[1][1][j]);
          mma_s8(acc[1][mt][j], af[1], bf[0][0][j], bf[0][1][j]);
          mma_s8(acc[2][mt][j], af[1], bf[1][0][j], bf[1][1][j]);
        } else {                     // MM2: C1, C10, C01, C0
          mma_s8(acc[0][mt][j], af[0], bf[0][0][j], bf[0][1][j]);
          mma_s8(acc[1][mt][j], af[0], bf[1][0][j], bf[1][1][j]);
          mma_s8(acc[2][mt][j], af[1], bf[0][0][j], bf[0][1][j]);
          mma_s8(acc[3][mt][j], af[1], bf[1][0][j], bf[1][1][j]);
        }
      }
    }
  }
}

// The Cs rebuild (KMM2_SPLIT), the combine and the store of one element.
template <int L>
__device__ __forceinline__ void store_out(const Params& p, const int* c,
                                          int m, int n) {
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if constexpr (L == MM1) {
    static_cast<int*>(p.out)[o] = c[0];
  } else if constexpr (L == MM2) {
    const uint32_t u1 = c[0], u10 = c[1], u01 = c[2], u0 = c[3];
    if (p.combine_int32) {
      static_cast<int*>(p.out)[o] = static_cast<int>(
          (u1 << (2 * p.h)) + ((u10 + u01) << p.h) + u0);
      return;
    }
    const float mid = __fadd_rn(__int2float_rn(c[1]), __int2float_rn(c[2]));
    static_cast<float*>(p.out)[o] = __fadd_rn(
        __fadd_rn(__fmul_rn(__int2float_rn(c[0]), p.pow_2h),
                  __fmul_rn(mid, p.pow_h)),
        __int2float_rn(c[3]));
  } else {
    uint32_t u1 = c[0], us = c[1], u0 = c[2];
    // Cs = C1 + (A1.B0 + A0.B1) + C0, modulo 2^32
    if constexpr (L == KMM2_SPLIT) us += u1 + u0;
    if (p.combine_int32) {
      static_cast<int*>(p.out)[o] = static_cast<int>(
          (u1 << (2 * p.h)) + ((us - u1 - u0) << p.h) + u0);
      return;
    }
    const float c1f = __int2float_rn(static_cast<int>(u1));
    const float c0f = __int2float_rn(static_cast<int>(u0));
    const float mid = __fsub_rn(
        __fsub_rn(__int2float_rn(static_cast<int>(us)), c1f), c0f);
    static_cast<float*>(p.out)[o] = __fadd_rn(
        __fadd_rn(__fmul_rn(c1f, p.pow_2h), __fmul_rn(mid, p.pow_h)), c0f);
  }
}

// Accumulator e of a thread's partials, e = ((q MT + mt) 4 + j) 4 + r: the
// workspace holds partial e of thread tid at e * NT + tid, so every block
// of a tile (same thread mapping) writes and reads it coalesced.
template <class T>
__device__ __forceinline__ int& acc_at(int (&acc)[T::NACC][T::MT][4][4],
                                       int e) {
  return acc[e / (T::MT * 16)][(e / 16) % T::MT][(e / 4) % 4][e % 4];
}

// One block: output tile (blockIdx.y, blockIdx.x % tiles_n) over K split
// blockIdx.x / tiles_n.
template <int L, int BM, int PB, bool KMAJ>
__global__ void __launch_bounds__(Tile<L, BM, PB, KMAJ>::NT)
staged_pipe_kernel(const Params p) {
  using T = Tile<L, BM, PB, KMAJ>;
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tn = blockIdx.x % tiles_n;
  const int sidx = blockIdx.x / tiles_n;
  const int m0 = blockIdx.y * BM, n0 = tn * BN;
  const int tile = blockIdx.y * tiles_n + tn;
  const int rows_live = p.M - (m0 + wm * T::MT * 16);

  int acc[T::NACC][T::MT][4][4];
#pragma unroll
  for (int q = 0; q < T::NACC; ++q)
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[q][mt][j][r] = 0;

  // This split's K range: whole stages, the last one ending at K.
  int8_t* planes8 = smem + STAGES * T::STAGE;
  const int kb = sidx * p.k_split;
  const int ke = min(p.K, kb + p.k_split);
  const int n_st = ke > kb ? (ke - kb + T::BK - 1) / T::BK : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) {
      load_stage<L, BM, PB, KMAJ>(p, smem + s * T::STAGE, m0, n0,
                                  kb + s * T::BK, tid);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_st; ++it) {
    // stage `it` has landed once at most STAGES - 2 groups are pending; the
    // barrier also frees the slot (and for int16 the s8 planes) that every
    // warp finished with in the previous iteration
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < n_st) {
      load_stage<L, BM, PB, KMAJ>(p, smem + (nxt % STAGES) * T::STAGE, m0,
                                  n0, kb + nxt * T::BK, tid);
    }
    cp_async_commit();
    const int8_t* st = smem + (it % STAGES) * T::STAGE;
    if constexpr (PB == 1) {
      mma_stage<L, BM, PB, KMAJ>(st, st + T::NP * T::A_PLANE, wm, wn, lane,
                                 rows_live, acc);
    } else {
      narrow_stage<L, BM, KMAJ>(st, planes8, tid);
      __syncthreads();
      mma_stage<L, BM, PB, KMAJ>(planes8, planes8 + T::NP * T::A8_PLANE, wm,
                                 wn, lane, rows_live, acc);
    }
  }
  cp_async_wait<0>();

  if (p.split > 1) {
    // Publish this split's partials, then count arrivals on the tile.
    constexpr int TILE_INTS = T::REGS * T::NT;
    int* mine = p.ws + (static_cast<size_t>(tile) * p.split + sidx)
                * TILE_INTS + tid;
#pragma unroll
    for (int e = 0; e < T::REGS; ++e) mine[e * T::NT] = acc_at<T>(acc, e);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      is_last = atomicAdd(p.counters + tile, 1) == p.split - 1;
    }
    __syncthreads();
    if (!is_last) return;
    // The last block adds every other split's partials, modulo 2^32, one
    // split at a time.
    __threadfence();
    const int* base = p.ws + static_cast<size_t>(tile) * p.split * TILE_INTS
                      + tid;
    for (int s = 0; s < p.split; ++s) {
      if (s == sidx) continue;
      const int* part = base + static_cast<size_t>(s) * TILE_INTS;
#pragma unroll
      for (int e = 0; e < T::REGS; ++e) {
        int& a = acc_at<T>(acc, e);
        a = static_cast<int>(static_cast<uint32_t>(a)
                             + static_cast<uint32_t>(__ldcg(part + e * T::NT)));
      }
    }
    if (tid == 0) p.counters[tile] = 0;   // ready for the next launch
  }

  // Epilogue: register r of an m16n8 block holds row g + 8 (r / 2), MMA
  // column 2t + r % 2.
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + (wm * T::MT + mt) * 16 + g + 8 * (r >> 1);
        const int c = 2 * t + (r & 1);
        const int n = n0 + wn * 32 + (KMAJ ? 8 * j + c : 4 * c + j);
        if (m >= p.M || n >= p.N) continue;
        int cv[T::NACC];
#pragma unroll
        for (int q = 0; q < T::NACC; ++q) cv[q] = acc[q][mt][j][r];
        store_out<L>(p, cv, m, n);
      }
}

// Launches one instance on `stream` without synchronising; returns
// cudaGetLastError().
template <int L, int BM, int PB, bool KMAJ>
int launch_instance(const Params& p, cudaStream_t stream) {
  using T = Tile<L, BM, PB, KMAJ>;
  auto kernel = staged_pipe_kernel<L, BM, PB, KMAJ>;
  if (T::SMEM > 48 * 1024) {         // above the default: opt in per device
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_n = (p.N + BN - 1) / BN;
  const dim3 grid(tiles_n * p.split, (p.M + BM - 1) / BM);
  kernel<<<grid, T::NT, T::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int BM, int PB>
int launch_b(const Params& p, bool k_major, cudaStream_t s) {
  return k_major ? launch_instance<L, BM, PB, true>(p, s)
                 : launch_instance<L, BM, PB, false>(p, s);
}

// One function per layout, plane type and tile, each defined in its own
// build unit.
int launch_mm1_bm16(const Params& p, bool k_major, cudaStream_t s);
int launch_mm1_bm64(const Params& p, bool k_major, cudaStream_t s);
int launch_kmm2_i8_bm16(const Params& p, bool k_major, cudaStream_t s);
int launch_kmm2_i8_bm64(const Params& p, bool k_major, cudaStream_t s);
int launch_kmm2_i16_bm16(const Params& p, bool k_major, cudaStream_t s);
int launch_kmm2_i16_bm64(const Params& p, bool k_major, cudaStream_t s);
int launch_split_bm16(const Params& p, bool k_major, cudaStream_t s);
int launch_split_bm64(const Params& p, bool k_major, cudaStream_t s);
int launch_mm2_bm16(const Params& p, bool k_major, cudaStream_t s);
int launch_mm2_bm64(const Params& p, bool k_major, cudaStream_t s);

#if SP_UNIT(1)
int launch_mm1_bm16(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<MM1, 16, 1>(p, k_major, s);
}
#endif
#if SP_UNIT(2)
int launch_mm1_bm64(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<MM1, 64, 1>(p, k_major, s);
}
#endif
#if SP_UNIT(3)
int launch_kmm2_i8_bm16(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<KMM2, 16, 1>(p, k_major, s);
}
#endif
#if SP_UNIT(4)
int launch_kmm2_i8_bm64(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<KMM2, 64, 1>(p, k_major, s);
}
#endif
#if SP_UNIT(5)
int launch_kmm2_i16_bm16(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<KMM2, 16, 2>(p, k_major, s);
}
#endif
#if SP_UNIT(6)
int launch_kmm2_i16_bm64(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<KMM2, 64, 2>(p, k_major, s);
}
#endif
#if SP_UNIT(7)
int launch_split_bm16(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<KMM2_SPLIT, 16, 2>(p, k_major, s);
}
#endif
#if SP_UNIT(8)
int launch_split_bm64(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<KMM2_SPLIT, 64, 2>(p, k_major, s);
}
#endif
#if SP_UNIT(9)
int launch_mm2_bm16(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<MM2, 16, 1>(p, k_major, s);
}
#endif
#if SP_UNIT(10)
int launch_mm2_bm64(const Params& p, bool k_major, cudaStream_t s) {
  return launch_b<MM2, 64, 1>(p, k_major, s);
}
#endif

}  // namespace staged_pipe_detail

#if SP_UNIT(0)
// C entry point: layout 1 = mm1 (a1 (M, K), b1 (K, N) int8; a0, b0 null;
// int32 out), 2 = kmm2 on s8 pre-adders (int8 planes, or int16 at h <= 6),
// 3 = kmm2 split (int16 planes), 4 = mm2 (int8 planes, h <= 8): planes
// a1, a0 (M, K) row-major and b1, b0
// (K, N), row-major or, with b_kmajor, K-major (each the transpose of a
// contiguous (N, K) tensor), of plane_bytes 1 or 2; int32 out with
// combine_int32 (always for mm1), else float32; h the digit split point.
// bm, split and k_split come from the plan (kernels/mm1_plan.py
// `plan_staged`); ws holds tiles * split * accumulators * bm * 128 int32
// and counters one int32 a tile, zero on entry and on return (both may be
// null without a split).  vec_a / vec_b ask for 16-byte copies; they are
// honoured only where every row of every plane of the operand is 16-byte
// aligned.  Returns a CUDA error code, 0 on success.
extern "C" int staged_pipe_launch(const void* a1, const void* a0,
                                  const void* b1, const void* b0, void* out,
                                  void* ws, void* counters, int M, int K,
                                  int N, int layout, int plane_bytes,
                                  int b_kmajor, int h, int combine_int32,
                                  int bm, int split, int k_split, int vec_a,
                                  int vec_b, void* stream) {
  using namespace staged_pipe_detail;
  const int pb = plane_bytes;
  const int bk = ROW_BYTES / (pb == 2 ? 2 : 1);
  const long long tiles_m = (M + 15) / 16;
  const long long tiles_n = (N + BN - 1) / BN;
  // the digits and pre-adder sums fit s8: kmm2 int8 planes h <= 7, int16
  // h <= 6 (the depth-2 leaves); the split route's leaves at every h <= 7;
  // mm2's centered int8 digits at every h <= 8 (no pre-adder)
  const bool two_planes = a0 != nullptr && b0 != nullptr;
  const bool layout_ok =
      (layout == MM1 && pb == 1)
      || (layout == KMM2 && h >= 1 && h <= (pb == 1 ? 7 : 6) && two_planes)
      || (layout == KMM2_SPLIT && pb == 2 && h >= 1 && h <= 7 && two_planes)
      || (layout == MM2 && pb == 1 && h >= 1 && h <= 8 && two_planes);
  const bool split_ok = split == 1
      ? k_split >= K
      : (ws != nullptr && counters != nullptr && split > 1 && k_split > 0
         && k_split % bk == 0
         && static_cast<long long>(split - 1) * k_split < K
         && static_cast<long long>(split) * k_split >= K);
  if (M < 1 || K < 1 || N < 1 || (pb != 1 && pb != 2) || !layout_ok
      || (bm != 16 && bm != 64) || tiles_m > 65535 || split < 1
      || tiles_n * split > 0x7fffffffLL || !split_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool two = layout != MM1;
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  Params p;
  p.a[0] = static_cast<const int8_t*>(a1);
  p.a[1] = static_cast<const int8_t*>(a0);
  p.b[0] = static_cast<const int8_t*>(b1);
  p.b[1] = static_cast<const int8_t*>(b0);
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = M;
  p.K = K;
  p.N = N;
  p.h = h;
  p.combine_int32 = combine_int32;
  p.split = split;
  p.k_split = k_split;
  p.vec_a = vec_a && (static_cast<long long>(K) * pb) % 16 == 0
            && aligned(a1) && (!two || aligned(a0));
  p.vec_b = vec_b
            && (static_cast<long long>(b_kmajor ? K : N) * pb) % 16 == 0
            && aligned(b1) && (!two || aligned(b0));
  p.pow_h = std::ldexp(1.0f, h);
  p.pow_2h = std::ldexp(1.0f, 2 * h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool km = b_kmajor != 0;
  const bool big = bm == 64;
  switch (layout) {
    case MM1:
      return big ? launch_mm1_bm64(p, km, s) : launch_mm1_bm16(p, km, s);
    case KMM2:
      if (pb == 1) {
        return big ? launch_kmm2_i8_bm64(p, km, s)
                   : launch_kmm2_i8_bm16(p, km, s);
      }
      return big ? launch_kmm2_i16_bm64(p, km, s)
                 : launch_kmm2_i16_bm16(p, km, s);
    case KMM2_SPLIT:
      return big ? launch_split_bm64(p, km, s) : launch_split_bm16(p, km, s);
    default:
      return big ? launch_mm2_bm64(p, km, s) : launch_mm2_bm16(p, km, s);
  }
}
#endif
