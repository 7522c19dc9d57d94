// Fused single-pass integer GEMM for NVIDIA Hopper (sm_90a): the depth-2
// split mode kmm4 of the paper's precision-scalable KMM unit.
//
// Replaces the TPU kernel `_fused_kernel` in src/repro/kernels/fused_gemm.py
// (line 119; entry point `fused_gemm`, line 395) in mode kmm4, and computes
// what it computes, bit for bit (mode mm1, w <= 8, is its own kernel in
// fused_mm1.cu; kmm2 and mm2, w 9..16, in fused_split.cu):
//
//   kmm4 (17..26; 9..16 for the tuner):
//                    split every operand at h = ceil(w/2) into a signed high
//                    digit and a low digit centered by z = 2^(h-1); depth-2
//                    KMM: each level-1 branch {A1, A1+A0, A0} is
//                    re-split plainly (uncentered) at h2 = ceil((h+1)/2)
//                    and runs the three Fig. 8 passes of its own; nine
//                    accumulators, the level-2 combine at h2 per branch,
//                    then the level-1 combine at h;
//                    int32 row sums of A and column sums of B and the
//                    Section IV-D zero-point correction over the *logical*
//                    padded K `kp`;
//                    optional dequant epilogue val * (sx[m] * sw[n]) and an
//                    int32 / fp32 / bf16 store.
//
// The grouped entry (`fused_gemm_grouped_launch`) also replaces
// `fused_gemm_grouped` (line 437 there): G independent GEMMs
// (G, M, K) x (G, K, N) -> (G, M, N), the group index on grid z, each group
// bit-identical to a dense launch on its slices.  With `counts` (G, S) and a
// static `seg` it is ragged, as the MoE expert GEMMs are: row r of group g
// is live iff r / seg < S and r % seg < counts[g, r / seg].  Dead rows are
// written as exact zeros; live rows never see the mask (it touches the
// store only, never the digit accumulators or the zero-point sums), so
// they equal the dense launch bit for bit.  A block with no live row skips
// its K loop and writes its zero tile; a warp whose 16 rows are all dead
// skips its MMAs.  The skips change speed, never a value, so the 64-row
// tile need not match the reference's block_m.
//
// Every product is an exact s8 x s8 -> s32 tensor-core MMA.  The digits
// entering them fit s8 (checked for every value of every width): every
// leaf digit fits s8 at every width through w = 26, and so does the nested
// pre-adder through w = 22 (h <= 11; [-32, 93]).  For w = 23..26
// (h >= 12) the pre-adder reaches [-64, 189], which fits neither s8 nor
// u8.  That instance (KMM4_WIDE) keeps the two leaves of each branch as
// its planes and computes the pre-adder product through the integer
// identity
//   (a1 + a0)(b1 + b0) = a1.b1 + (a1.b0 + a0.b1) + a0.b0:
// its middle accumulator gathers the two cross products, and the epilogue
// adds C1 and C0 back in int32 before the combine.  The value is the same
// integer the reference's pass computes, so the result is bit-exact by
// construction, at 12 MMAs for 9.
//
// Numerics the design must keep:
//   * K positions in [K, kp) are the value 0 before the split, i.e. digits
//     (0, -z), re-split at level 2 for kmm4: the reference zero-pads K to
//     kp = ceil(K / block_k) * block_k and splits the padding too, so the
//     low-digit passes gain terms per padded position and kp enters the
//     correction.  The kernel's own K tile is free; positions at or beyond
//     kp contribute nothing.
//   * Row and column sums wrap modulo 2^32, as the reference's int32
//     scratch does (at w = 24 a row of 2^22s wraps once K reaches 512);
//     they are kept in uint32, where wrapping is defined.
//   * The fp32 epilogue follows the reference's operation order with
//     explicitly rounded intrinsics (and the library is built with
//     --fmad=false): the kmm2 combine mid = (Cs - C1) - C0,
//     (C1 * 2^2h + mid * 2^h) + C0 at h2 per branch, then the same sequence
//     at h on the three fp32 branch values; corr = (z * row + z * col) +
//     z^2 kp; val = core + corr; out = val * (sx * sw), with sx * sw
//     rounded first; bf16 rounds to nearest even.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8): for
// the serve path's row counts (decode M = live slots, prefill M <= 64) the
// GEMM is bound by reading B once.  At lm_head, B is (2048, 128512): 1.05 GB
// in int32, about 0.31 ms; the 9 digit passes take longer than the read
// only above a few hundred rows.  So the design reads each original
// operand once per output tile (no digit planes in device memory), splits
// digits in registers on the way into shared memory, keeps the
// accumulators on chip across the whole K loop, and writes the output
// once, dequantized.  The grouped MoE
// GEMMs at decode are bound the same way: each live expert's B is read once
// (at most 1 row in 8 is live there, so the MMAs are mostly idle), and an
// expert with no live row reads nothing.  At these shapes the K loop is
// bound by load latency, so each loader thread issues all of a pass's
// global loads (16 values of A and 16 of B) before it packs any digit.
// It is the simple first version: one 64x64 output tile per block, a
// synchronous K loop of 64-deep stages and 16x16x16 s8 WMMA products; the
// nine accumulators run 8 warps of 16 x 32 (144 registers) and keep their
// 72 KB of digit planes in dynamic shared memory.  fused_split.cu's
// pipeline (16-byte copies of the carrier, the digit split from shared
// memory, exact split-K) is the route for this mode too.
//
// Build: the whole file compiles into one library.  Built with
// -DFUSED_GEMM_UNIT=u it compiles only unit u (0: the C entry points;
// 1-2: the kernel instances of one digit layout: kmm4 on s8 pre-adders,
// kmm4 on split ones), so the instances can be compiled by parallel nvcc
// processes and linked together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

#ifdef FUSED_GEMM_UNIT
#define FG_UNIT(u) (FUSED_GEMM_UNIT == (u))
#else
#define FG_UNIT(u) 1
#endif

namespace fused_gemm_detail {

using namespace nvcuda;

constexpr int BM = 64;               // output rows per block (4 x 16)
constexpr int BN = 64;               // output columns per block
constexpr int BK = 64;               // K depth of one shared-memory stage

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

// Digit layouts, one kernel instance each; 4 is the wrapper's mode id
// (modes 1-3 are fused_mm1.cu's and fused_split.cu's), and mode 4 runs as
// KMM4_WIDE for h >= 12.
enum Layout { KMM4 = 4, KMM4_WIDE = 5 };

// Shape of each layout: digit planes per operand, int32 accumulators,
// tensor-core products per 16-deep step, threads, and warps side by side
// along N.
template <int L>
struct Shape {
  static constexpr int NPLANE = L == KMM4 ? 9 : 6;
  static constexpr int NACC = 9;
  static constexpr int NPROD = L == KMM4_WIDE ? 12 : NACC;
  static constexpr int NTHREADS = 256;
  static constexpr int WARPS_N = NTHREADS / 128;
  static constexpr int NWARPS = NTHREADS / 32;
  static constexpr int TILE_BYTES = NPLANE * (BM * BK + BK * BN);
  static constexpr int STAGE_BYTES = NWARPS * NACC * 256 * sizeof(int);
  static constexpr int SMEM_BYTES = TILE_BYTES > STAGE_BYTES ? TILE_BYTES
                                                             : STAGE_BYTES;
};

// Product p of layout L: A plane, B plane and accumulator.
struct Prod {
  int a, b, acc;
};

template <int L>
__host__ __device__ constexpr Prod product(int p) {
  if (L == KMM4_WIDE) {
    // branch v: planes 2v (high leaf) and 2v + 1 (low leaf); accumulator
    // 3v + 1 takes both cross products
    const int v = p / 4, r = p % 4;
    return Prod{2 * v + (r >> 1), 2 * v + (r & 1),
                3 * v + (r == 0 ? 0 : r == 3 ? 2 : 1)};
  }
  return Prod{p, p, p};
}

struct Params {
  const void* a;       // (M, K) row-major, int32
  const void* b;       // (K, N) row-major, same type
  const float* sx;     // (M,) row scales, or null (no dequant)
  const float* sw;     // (N,) column scales, or null
  void* out;           // (M, N) row-major
  const int* counts;   // (G, n_seg) live rows per segment, or null: all live
  int M, K, N, kp, h, h2, z, combine_int32, out_kind, seg, n_seg;
  float pow_h, pow_2h, pow_h2, pow_2h2, zf, zzkp;
};

__device__ __forceinline__ void put(uint32_t (&w)[4], int c, int v) {
  w[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(v))
               << (8 * (c & 3));
}

// Pack one operand value's digits into byte `c` of each plane's 16-byte
// row: per level-1 branch high, pre-adder, low leaf (kmm4) or high, low
// leaf (kmm4 wide).
template <int L>
__device__ __forceinline__ void put_digits(
    uint32_t (&w)[Shape<L>::NPLANE][4], int c, int v, bool in_kp,
    const Params& p, int mask, int mask2) {
  if (!in_kp) return;                // beyond the logical padded K: no term
  const int hi = v >> p.h;
  const int lo = (v & mask) - p.z;
  const int branch[3] = {hi, hi + lo, lo};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int v1 = branch[q] >> p.h2;
    const int v0 = branch[q] & mask2;
    if constexpr (L == KMM4) {
      put(w[3 * q], c, v1);
      put(w[3 * q + 1], c, v1 + v0);
      put(w[3 * q + 2], c, v0);
    } else {
      put(w[2 * q], c, v1);
      put(w[2 * q + 1], c, v0);
    }
  }
}

// Split 16 consecutive k values (from k = k0) of one A row or B column into
// the layout's digit planes and store each plane's 16 bytes at `dst`, the
// planes `plane_bytes` apart.
template <int L>
__device__ __forceinline__ void pack_store(const int (&v)[16], int k0,
                                           int k_end, const Params& p,
                                           int mask, int mask2, int8_t* dst,
                                           int plane_bytes) {
  uint32_t w[Shape<L>::NPLANE][4] = {};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    put_digits<L>(w, c, v[c], k0 + c < k_end, p, mask, mask2);
  }
#pragma unroll
  for (int q = 0; q < Shape<L>::NPLANE; ++q) {
    *reinterpret_cast<uint4*>(dst + q * plane_bytes) =
        make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
  }
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

template <int L>
__device__ __forceinline__ void store_out(const Params& p,
                                          int (&c)[Shape<L>::NACC],
                                          uint32_t row, uint32_t col, int m,
                                          int n) {
  bool is_int = true;
  int vi = c[0];
  float vf = 0.f;
  if constexpr (L == KMM4_WIDE) {
    // the middle accumulators hold the cross products only
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      c[3 * q + 1] = static_cast<int>(static_cast<uint32_t>(c[3 * q + 1])
                                      + static_cast<uint32_t>(c[3 * q])
                                      + static_cast<uint32_t>(c[3 * q + 2]));
    }
  }
  const uint32_t zu = p.z;
  const uint32_t kpz = static_cast<uint32_t>(p.kp) * zu;
  const uint32_t r = row - kpz;    // rowsum(A) - kp z, modulo 2^32
  const uint32_t cc = col - kpz;
  if (p.combine_int32) {
    const uint32_t core =
        combine_kmm2_u(combine_kmm2_u(c[0], c[1], c[2], p.h2),
                       combine_kmm2_u(c[3], c[4], c[5], p.h2),
                       combine_kmm2_u(c[6], c[7], c[8], p.h2), p.h);
    vi = static_cast<int>(core + (zu * r + zu * cc
                                  + zu * zu * static_cast<uint32_t>(p.kp)));
  } else {
    const float core = combine_wide_f(
        combine_kmm2_f(c[0], c[1], c[2], p.pow_h2, p.pow_2h2),
        combine_kmm2_f(c[3], c[4], c[5], p.pow_h2, p.pow_2h2),
        combine_kmm2_f(c[6], c[7], c[8], p.pow_h2, p.pow_2h2),
        p.pow_h, p.pow_2h);
    const float rf = __int2float_rn(static_cast<int>(r));
    const float cf = __int2float_rn(static_cast<int>(cc));
    const float corr = __fadd_rn(
        __fadd_rn(__fmul_rn(p.zf, rf), __fmul_rn(p.zf, cf)), p.zzkp);
    vf = __fadd_rn(core, corr);
    is_int = false;
  }
  if (p.sx != nullptr) {
    const float v = is_int ? __int2float_rn(vi) : vf;
    vf = __fmul_rn(v, __fmul_rn(p.sx[m], p.sw[n]));
    is_int = false;
  }
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.out_kind == OUT_I32) {       // the wrapper allows it for int values
    static_cast<int*>(p.out)[o] = vi;
    return;
  }
  const float v = is_int ? __int2float_rn(vi) : vf;
  if (p.out_kind == OUT_F32) {
    static_cast<float*>(p.out)[o] = v;
  } else {
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
  }
}

__device__ __forceinline__ void store_zero(const Params& p, int m, int n) {
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.out_kind == OUT_BF16) {
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(0.f);
  } else if (p.out_kind == OUT_F32) {
    static_cast<float*>(p.out)[o] = 0.f;
  } else {
    static_cast<int*>(p.out)[o] = 0;
  }
}

// One block computes one BM x BN output tile of group blockIdx.z over the
// whole K loop.  GROUPED instantiates the grouped entry (its own name in a
// profile; the dense instance compiles the liveness test out).
//
// Shared-memory layout (int8 digits), chosen so every loader thread writes
// 16 contiguous bytes and every WMMA fragment starts 256-bit aligned:
//   A plane q: [KSUB][BM][16]  (row-major 16-deep sub-tiles, ldm 16)
//   B plane q: [KSUB][BN][16]  (column-major 16-deep sub-tiles, ldm 16)
// Warp w owns output rows [16 wm, 16 wm + 16) with wm = w % 4, and the
// 64 / WARPS_N columns of column group w / 4.
template <int L, typename T, bool GROUPED>
__global__ void __launch_bounds__(Shape<L>::NTHREADS)
fused_gemm_kernel(const Params p0) {
  using S = Shape<L>;
  constexpr int NPLANE = S::NPLANE;
  constexpr int NACC = S::NACC;
  constexpr int NTHREADS = S::NTHREADS;
  constexpr int WN = BN / 16 / S::WARPS_N;       // 16-column fragments a warp
  constexpr int A_PLANE = BM * BK;
  constexpr int B_PLANE = BK * BN;
  constexpr int LPR = NTHREADS / BM;             // loaders per row (column)
  constexpr int KPT = BK / LPR;                  // k values per loader thread
  constexpr int KSUB = BK / 16;                  // 16-deep sub-tiles a stage
  static_assert(KPT % 16 == 0 && S::NWARPS / S::WARPS_N * 16 == BM,
                "tile and thread counts do not fit");
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ uint32_t row_part[LPR][BM];
  __shared__ uint32_t col_part[LPR][BN];
  __shared__ int row_live[BM];

  // This group's operands, scales and output (group 0 for a dense launch).
  Params p = p0;
  const size_t g = blockIdx.z;
  const size_t mk = static_cast<size_t>(p0.M) * p0.K;
  const size_t kn = static_cast<size_t>(p0.K) * p0.N;
  const size_t mn = static_cast<size_t>(p0.M) * p0.N;
  p.a = static_cast<const T*>(p0.a) + g * mk;
  p.b = static_cast<const T*>(p0.b) + g * kn;
  if (p0.sx != nullptr) {
    p.sx = p0.sx + g * p0.M;
    p.sw = p0.sw + g * p0.N;
  }
  p.out = static_cast<char*>(p0.out)
      + g * mn * (p0.out_kind == OUT_BF16 ? 2 : 4);

  const T* __restrict__ A = static_cast<const T*>(p.a);
  const T* __restrict__ B = static_cast<const T*>(p.b);
  int8_t* a_s = smem;
  int8_t* b_s = smem + NPLANE * A_PLANE;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp % (BM / 16);
  const int wn = warp / (BM / 16);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Ragged liveness of this block's rows (all rows below M when dense).
  if (tid < BM) {
    const int r = m0 + tid;
    bool live = r < p.M;
    if (GROUPED && live && p.counts != nullptr) {
      const int s = r / p.seg;
      live = s < p.n_seg && r - s * p.seg < p.counts[g * p.n_seg + s];
    }
    row_live[tid] = live;
  }
  if (!__syncthreads_or(tid < BM && row_live[tid])) {
    // No live row: skip the K loop, write the tile's exact zeros.
    for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
      const int m = m0 + idx / BN, n = n0 + idx % BN;
      if (m < p.M && n < p.N) store_zero(p, m, n);
    }
    return;
  }

  // Loader roles: thread t loads KPT consecutive k of A row t / LPR and of
  // B column t % 64, and keeps that row's (column's) partial raw sum.
  const int a_row = tid / LPR, a_part = tid % LPR;
  const int b_col = tid % BN, b_part = tid / BN;
  const int gm = m0 + a_row;
  const int gn = n0 + b_col;
  const bool a_ok = gm < p.M;
  const bool b_ok = gn < p.N;

  const bool warp_in = m0 + wm * 16 < p.M;
  // A warp whose 16 rows are all dead skips its MMAs (warp-uniform).
  const bool warp_mma = __any_sync(0xffffffffu,
                                   lane < 16 && row_live[wm * 16 + lane]);
  const int k_end = p.kp;                        // logical (padded) K
  const int mask = (1 << p.h) - 1;
  const int mask2 = (1 << p.h2) - 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NACC][WN];
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int j = 0; j < WN; ++j) wmma::fill_fragment(acc[q][j], 0);
  uint32_t row_sum = 0, col_sum = 0;             // modulo 2^32

  for (int k0 = 0; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int s = 0; s < KPT / 16; ++s) {
      // This pass's A and B sub-tiles: every global load is issued before
      // any digit is packed, so the loads are in flight together.
      const int sa = a_part * (KPT / 16) + s;
      const int sb = b_part * (KPT / 16) + s;
      const int ka = k0 + sa * 16, kb = k0 + sb * 16;
      int va[16], vb[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        va[c] = (a_ok && ka + c < p.K)
            ? static_cast<int>(A[static_cast<size_t>(gm) * p.K + ka + c]) : 0;
        vb[c] = (b_ok && kb + c < p.K)
            ? static_cast<int>(B[static_cast<size_t>(kb + c) * p.N + gn]) : 0;
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        row_sum += static_cast<uint32_t>(va[c]);
        col_sum += static_cast<uint32_t>(vb[c]);
      }
      pack_store<L>(va, ka, k_end, p, mask, mask2,
                    a_s + sa * BM * 16 + a_row * 16, A_PLANE);
      pack_store<L>(vb, kb, k_end, p, mask, mask2,
                    b_s + sb * BN * 16 + b_col * 16, B_PLANE);
    }
    __syncthreads();
    if (warp_mma) {
#pragma unroll
      for (int kk = 0; kk < KSUB; ++kk) {
#pragma unroll
        for (int pi = 0; pi < S::NPROD; ++pi) {
          const Prod pr = product<L>(pi);
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> af;
          wmma::load_matrix_sync(
              af, a_s + pr.a * A_PLANE + kk * BM * 16 + wm * 256, 16);
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                           wmma::col_major> bf;
            wmma::load_matrix_sync(
                bf, b_s + pr.b * B_PLANE + kk * BN * 16 + (wn * WN + j) * 256,
                16);
            wmma::mma_sync(acc[pr.acc][j], af, bf, acc[pr.acc][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Zero-point sums: LPR loader threads share each row (column).
  row_part[a_part][a_row] = row_sum;
  col_part[b_part][b_col] = col_sum;
  __syncthreads();
  if (!warp_in) return;
  if (!warp_mma) {
    for (int idx = lane; idx < 16 * WN * 16; idx += 32) {
      const int m = m0 + wm * 16 + idx / (WN * 16);
      const int n = n0 + wn * WN * 16 + idx % (WN * 16);
      if (m < p.M && n < p.N) store_zero(p, m, n);
    }
    return;
  }

  // Epilogue: each warp stages its 16x16 accumulator fragments in the
  // (now free) tile memory and its lanes combine and store 8 elements each.
  int* stage = reinterpret_cast<int*>(smem) + warp * NACC * 256;
#pragma unroll
  for (int j = 0; j < WN; ++j) {
#pragma unroll
    for (int q = 0; q < NACC; ++q)
      wmma::store_matrix_sync(stage + q * 256, acc[q][j], 16,
                              wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = e * 32 + lane;
      const int r = wm * 16 + (idx >> 4);
      const int c = (wn * WN + j) * 16 + (idx & 15);
      const int m = m0 + r, n = n0 + c;
      if (m >= p.M || n >= p.N) continue;
      if (!row_live[r]) {
        store_zero(p, m, n);                     // dead row: exact zero
        continue;
      }
      int cv[NACC];
#pragma unroll
      for (int q = 0; q < NACC; ++q) cv[q] = stage[q * 256 + idx];
      uint32_t row = 0, col = 0;
#pragma unroll
      for (int q = 0; q < LPR; ++q) {
        row += row_part[q][r];
        col += col_part[q][c];
      }
      store_out<L>(p, cv, row, col, m, n);
    }
    __syncwarp();
  }
}

// Launches one instance on `stream` without synchronising; returns
// cudaGetLastError().
template <int L, typename T, bool GROUPED>
int launch_instance(const Params& p, int groups, cudaStream_t stream) {
  constexpr int smem = Shape<L>::SMEM_BYTES;
  if (smem > 48 * 1024) {            // above the default: opt in per device
    const cudaError_t err = cudaFuncSetAttribute(
        fused_gemm_kernel<L, T, GROUPED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, groups);
  fused_gemm_kernel<L, T, GROUPED>
      <<<grid, Shape<L>::NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int L, typename T>
int launch_layout(const Params& p, int groups, bool grouped,
                  cudaStream_t stream) {
  return grouped ? launch_instance<L, T, true>(p, groups, stream)
                 : launch_instance<L, T, false>(p, groups, stream);
}

// One function per layout, each defined in its own build unit.
int launch_kmm4(const Params& p, int groups, bool grouped, cudaStream_t s);
int launch_kmm4_wide(const Params& p, int groups, bool grouped,
                     cudaStream_t s);

#if FG_UNIT(1)
int launch_kmm4(const Params& p, int groups, bool grouped, cudaStream_t s) {
  return launch_layout<KMM4, int32_t>(p, groups, grouped, s);
}
#endif
#if FG_UNIT(2)
int launch_kmm4_wide(const Params& p, int groups, bool grouped,
                     cudaStream_t s) {
  return launch_layout<KMM4_WIDE, int32_t>(p, groups, grouped, s);
}
#endif

}  // namespace fused_gemm_detail

#if FG_UNIT(0)
namespace {

using namespace fused_gemm_detail;

// Fill the fields both entry points share; mode 4 = kmm4 (int32
// operands); out_kind 0 = int32, 1 = float32, 2 = bfloat16.
Params make_params(const void* a, const void* b, const void* sx,
                   const void* sw, void* out, int M, int K, int N, int kp,
                   int h, int z, int combine_int32, int out_kind) {
  Params p;
  p.a = a;
  p.b = b;
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.out = out;
  p.counts = nullptr;
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
  p.pow_h = std::ldexp(1.0f, h);
  p.pow_2h = std::ldexp(1.0f, 2 * h);
  p.pow_h2 = std::ldexp(1.0f, p.h2);
  p.pow_2h2 = std::ldexp(1.0f, 2 * p.h2);
  p.zf = static_cast<float>(z);
  p.zzkp = static_cast<float>(static_cast<double>(z) * z * kp);
  return p;
}

// Refuses modes 1-3 (mm1 runs in fused_mm1.cu, kmm2 and mm2 in
// fused_split.cu) and digit splits whose digits would not fit s8 (see the
// header).
int launch(const Params& p, int groups, bool grouped, int mode,
           void* stream) {
  if (groups < 1 || groups > 65535 || (p.M + BM - 1) / BM > 65535
      || mode != KMM4 || p.h < 5 || p.h > 13) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.h <= 11 ? launch_kmm4(p, groups, grouped, s)
                   : launch_kmm4_wide(p, groups, grouped, s);
}

}  // namespace

// Dense C entry point: (M, K) x (K, N) -> (M, N); sx (M,) and sw (N,) or
// both null for no dequant.
extern "C" int fused_gemm_launch(const void* a, const void* b,
                                 const void* sx, const void* sw, void* out,
                                 int M, int K, int N, int kp, int mode, int h,
                                 int z, int combine_int32, int out_kind,
                                 void* stream) {
  const Params p = make_params(a, b, sx, sw, out, M, K, N, kp, h, z,
                               combine_int32, out_kind);
  return launch(p, 1, false, mode, stream);
}

// Grouped C entry point: (G, M, K) x (G, K, N) -> (G, M, N), contiguous;
// sx (G, M) and sw (G, N) or both null; counts (G, n_seg) int32 with a
// positive seg, or null for a dense grouped launch.
extern "C" int fused_gemm_grouped_launch(
    const void* a, const void* b, const void* sx, const void* sw,
    const void* counts, void* out, int G, int M, int K, int N, int kp,
    int seg, int n_seg, int mode, int h, int z, int combine_int32,
    int out_kind, void* stream) {
  Params p = make_params(a, b, sx, sw, out, M, K, N, kp, h, z,
                         combine_int32, out_kind);
  if (counts != nullptr) {
    if (seg <= 0 || n_seg <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.counts = static_cast<const int*>(counts);
    p.seg = seg;
    p.n_seg = n_seg;
  }
  return launch(p, G, true, mode, stream);
}
#endif
