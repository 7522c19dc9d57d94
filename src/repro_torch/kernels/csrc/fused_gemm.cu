// Fused single-pass integer GEMM for NVIDIA Hopper (sm_90a): modes mm1 and
// kmm2 of the paper's precision-scalable KMM unit.
//
// Replaces the TPU kernel `_fused_kernel` in src/repro/kernels/fused_gemm.py
// (line 119; entry point `fused_gemm`, line 395) in its `mm1` and `kmm2`
// modes, and computes what it computes, bit for bit:
//
//   mm1  (w <= 8):   C = A . B, one exact s8 x s8 -> s32 pass.
//   kmm2 (9..14):    split every operand at h = ceil(w/2) into a signed high
//                    digit and a low digit centered by z = 2^(h-1);
//                    three digit passes with the Fig. 8 pre-adders
//                    (C1 = A1.B1, Cs = (A1+A0).(B1+B0), C0 = A0.B0), int32
//                    row sums of A and column sums of B, the Fig. 9 post-adder
//                    in fp32 (or int32), and the Section IV-D zero-point
//                    correction over the *logical* padded K `kp`.
//   both:            optional dequant epilogue val * (sx[m] * sw[n]) and an
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
// Every digit entering a product fits s8 (at w = 14 the pre-adder spans
// [-128, 126]), so each pass is an exact tensor-core integer product.
//
// Numerics the design must keep:
//   * K positions in [K, kp) are the value 0 before the split, i.e. digits
//     (0, -z): the reference zero-pads K to kp = ceil(K / block_k) * block_k
//     and splits the padding too, so C0 and Cs each gain z^2 per padded
//     position and kp enters the correction.  The kernel's own K tile is free;
//     positions at or beyond kp contribute nothing.
//   * The fp32 epilogue follows the reference's operation order with
//     explicitly rounded intrinsics (and the library is built with
//     --fmad=false): mid = (Cs - C1) - C0; core = (C1 * 2^2h + mid * 2^h) + C0;
//     corr = (z * row + z * col) + z^2 * kp; val = core + corr;
//     out = val * (sx * sw), with sx * sw rounded first; bf16 rounds to
//     nearest even.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8): for
// the serve path's row counts (decode M = live slots, prefill M <= 64) the
// GEMM is bound by reading B once.  At lm_head, B is (2048, 128512) int16,
// 526 MB, about 0.16 ms; the 3 digit passes there are 2*3*M*K*N int8
// operations, which take longer than the read only above a few hundred rows.
// So the design reads each original operand once per output tile (no digit
// planes in device memory), splits digits in registers on the way into
// shared memory, keeps the accumulators on chip across the whole K loop,
// and writes the output once, dequantized.  The grouped MoE GEMMs at decode
// are bound the same way: each live expert's B is read once (at most 1 row
// in 8 is live there, so the MMAs are mostly idle), and an expert with no
// live row reads nothing.  It is the simple first version:
// one 64x64 output tile per 128-thread block, a synchronous K loop of
// 64-deep stages and 16x16x16 s8 WMMA products.  Asynchronous copies (TMA),
// wgmma, a persistent schedule and split-K for narrow N are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

namespace {

using namespace nvcuda;

constexpr int BM = 64;               // output rows per block (4 warps x 16)
constexpr int BN = 64;               // output columns per block
constexpr int BK = 64;               // K depth of one shared-memory stage
constexpr int KSUB = BK / 16;        // 16-deep sub-tiles per stage
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

struct Params {
  const void* a;       // (M, K) row-major: int8 (mm1) or int16 (kmm2)
  const void* b;       // (K, N) row-major, same type
  const float* sx;     // (M,) row scales, or null (no dequant)
  const float* sw;     // (N,) column scales, or null
  void* out;           // (M, N) row-major
  const int* counts;   // (G, n_seg) live rows per segment, or null: all live
  int M, K, N, kp, h, z, combine_int32, out_kind, seg, n_seg;
  float pow_h, pow_2h, zf, zzkp;
};

// Pack one operand value's digits into byte `c` of the 16-byte rows that go
// to shared memory.  Plane 0 = high digit, 1 = pre-adder sum, 2 = centered
// low digit (kmm2); plane 0 = the value itself (mm1).
template <int NPLANE>
__device__ __forceinline__ void put_digits(uint32_t (&w)[NPLANE][4], int c,
                                           int v, bool in_kp, int h,
                                           int mask, int z) {
  const int word = c >> 2, sh = 8 * (c & 3);
  if constexpr (NPLANE == 1) {
    w[0][word] |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << sh;
  } else {
    if (!in_kp) return;              // beyond the logical padded K: no term
    const int hi = v >> h;
    const int lo = (v & mask) - z;
    w[0][word] |= static_cast<uint32_t>(static_cast<uint8_t>(hi)) << sh;
    w[1][word] |= static_cast<uint32_t>(static_cast<uint8_t>(hi + lo)) << sh;
    w[2][word] |= static_cast<uint32_t>(static_cast<uint8_t>(lo)) << sh;
  }
}

template <int NACC>
__device__ __forceinline__ void store_out(const Params& p, int c1, int cs,
                                          int c0, int row, int col, int m,
                                          int n) {
  bool is_int = true;
  int vi = c1;
  float vf = 0.f;
  if constexpr (NACC == 3) {
    if (p.combine_int32) {
      // Ring arithmetic mod 2^32, as the reference's int32 combine.
      const uint32_t u1 = c1, us = cs, u0 = c0, zu = p.z;
      const uint32_t kpz = static_cast<uint32_t>(p.kp) * zu;
      const uint32_t core = (u1 << (2 * p.h)) + ((us - u1 - u0) << p.h) + u0;
      const uint32_t r = static_cast<uint32_t>(row) - kpz;
      const uint32_t cc = static_cast<uint32_t>(col) - kpz;
      vi = static_cast<int>(core + (zu * r + zu * cc
                                    + zu * zu * static_cast<uint32_t>(p.kp)));
    } else {
      const float c1f = __int2float_rn(c1);
      const float c0f = __int2float_rn(c0);
      const float mid = __fsub_rn(__fsub_rn(__int2float_rn(cs), c1f), c0f);
      const float core = __fadd_rn(
          __fadd_rn(__fmul_rn(c1f, p.pow_2h), __fmul_rn(mid, p.pow_h)), c0f);
      const int kpz = p.kp * p.z;
      const float rf = __int2float_rn(row - kpz);
      const float cf = __int2float_rn(col - kpz);
      const float corr = __fadd_rn(
          __fadd_rn(__fmul_rn(p.zf, rf), __fmul_rn(p.zf, cf)), p.zzkp);
      vf = __fadd_rn(core, corr);
      is_int = false;
    }
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
// Warp w owns output rows [16w, 16w + 16) and all BN columns.
template <int NACC, typename T, bool GROUPED>
__global__ void __launch_bounds__(NTHREADS)
fused_gemm_kernel(const Params p0) {
  constexpr int NPLANE = NACC;                   // digit planes per operand
  constexpr int A_PLANE = BM * BK;
  constexpr int B_PLANE = BK * BN;
  constexpr int TILE_BYTES = NPLANE * (A_PLANE + B_PLANE);
  constexpr int STAGE_BYTES = NWARPS * NACC * 256 * sizeof(int);
  constexpr int SMEM_BYTES = TILE_BYTES > STAGE_BYTES ? TILE_BYTES
                                                      : STAGE_BYTES;
  constexpr int KPT = BK / 2;                    // k values per loader thread
  __shared__ __align__(128) int8_t smem[SMEM_BYTES];
  __shared__ int row_part[2][BM];
  __shared__ int col_part[2][BN];
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

  // Loader roles: thread t loads KPT consecutive k of A row t/2 and of
  // B column t % 64, and keeps that row's (column's) partial raw sum.
  const int a_row = tid >> 1, a_half = tid & 1;
  const int b_col = tid & (BN - 1), b_half = tid >> 6;
  const int gm = m0 + a_row;
  const int gn = n0 + b_col;
  const bool a_ok = gm < p.M;
  const bool b_ok = gn < p.N;

  const bool warp_in = m0 + warp * 16 < p.M;
  // A warp whose 16 rows are all dead skips its MMAs (warp-uniform).
  const bool warp_mma = __any_sync(0xffffffffu,
                                   lane < 16 && row_live[warp * 16 + lane]);
  const int k_end = NACC == 1 ? p.K : p.kp;      // logical (padded) K
  const int mask = (1 << p.h) - 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NACC][BN / 16];
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[q][j], 0);
  int row_sum = 0, col_sum = 0;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int s = 0; s < KPT / 16; ++s) {
      const int sub = a_half * (KPT / 16) + s;   // A sub-tile of this pass
      const int kb = k0 + sub * 16;
      uint32_t wa[NPLANE][4] = {};
      uint32_t wb[NPLANE][4] = {};
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int k = kb + c;
        const bool in_k = k < p.K;
        const bool in_kp = k < k_end;
        const int va = (a_ok && in_k)
            ? static_cast<int>(A[static_cast<size_t>(gm) * p.K + k]) : 0;
        row_sum += va;
        put_digits<NPLANE>(wa, c, va, in_kp, p.h, mask, p.z);
      }
      const int kbb = k0 + (b_half * (KPT / 16) + s) * 16;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int k = kbb + c;
        const bool in_k = k < p.K;
        const bool in_kp = k < k_end;
        const int vb = (b_ok && in_k)
            ? static_cast<int>(B[static_cast<size_t>(k) * p.N + gn]) : 0;
        col_sum += vb;
        put_digits<NPLANE>(wb, c, vb, in_kp, p.h, mask, p.z);
      }
      const int bsub = b_half * (KPT / 16) + s;
#pragma unroll
      for (int q = 0; q < NPLANE; ++q) {
        *reinterpret_cast<uint4*>(a_s + q * A_PLANE + sub * BM * 16
                                  + a_row * 16) =
            make_uint4(wa[q][0], wa[q][1], wa[q][2], wa[q][3]);
        *reinterpret_cast<uint4*>(b_s + q * B_PLANE + bsub * BN * 16
                                  + b_col * 16) =
            make_uint4(wb[q][0], wb[q][1], wb[q][2], wb[q][3]);
      }
    }
    __syncthreads();
    if (warp_mma) {
#pragma unroll
      for (int kk = 0; kk < KSUB; ++kk) {
#pragma unroll
        for (int q = 0; q < NACC; ++q) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> af;
          wmma::load_matrix_sync(
              af, a_s + q * A_PLANE + kk * BM * 16 + warp * 256, 16);
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                           wmma::col_major> bf;
            wmma::load_matrix_sync(
                bf, b_s + q * B_PLANE + kk * BN * 16 + j * 256, 16);
            wmma::mma_sync(acc[q][j], af, bf, acc[q][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Zero-point sums: two loader threads share each row (column).
  row_part[a_half][a_row] = row_sum;
  col_part[b_half][b_col] = col_sum;
  __syncthreads();
  if (!warp_in) return;
  if (!warp_mma) {
    for (int idx = lane; idx < 16 * BN; idx += 32) {
      const int m = m0 + warp * 16 + idx / BN, n = n0 + idx % BN;
      if (m < p.M && n < p.N) store_zero(p, m, n);
    }
    return;
  }

  // Epilogue: each warp stages its 16x16 accumulator fragments in the
  // (now free) tile memory and its lanes combine and store 8 elements each.
  int* stage = reinterpret_cast<int*>(smem) + warp * NACC * 256;
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
    for (int q = 0; q < NACC; ++q)
      wmma::store_matrix_sync(stage + q * 256, acc[q][j], 16,
                              wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = e * 32 + lane;
      const int r = warp * 16 + (idx >> 4);
      const int c = j * 16 + (idx & 15);
      const int m = m0 + r, n = n0 + c;
      if (m >= p.M || n >= p.N) continue;
      if (!row_live[r]) {
        store_zero(p, m, n);                     // dead row: exact zero
      } else if constexpr (NACC == 3) {
        store_out<NACC>(p, stage[idx], stage[256 + idx], stage[512 + idx],
                        row_part[0][r] + row_part[1][r],
                        col_part[0][c] + col_part[1][c], m, n);
      } else {
        store_out<NACC>(p, stage[idx], 0, 0, 0, 0, m, n);
      }
    }
    __syncwarp();
  }
}

// Fill the fields both entry points share; mode 1 = mm1 (int8 operands),
// 2 = kmm2 (int16 operands); out_kind 0 = int32, 1 = float32, 2 = bfloat16.
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
  p.z = z;
  p.combine_int32 = combine_int32;
  p.out_kind = out_kind;
  p.seg = 1;
  p.n_seg = 0;
  p.pow_h = std::ldexp(1.0f, h);
  p.pow_2h = std::ldexp(1.0f, 2 * h);
  p.zf = static_cast<float>(z);
  p.zzkp = static_cast<float>(static_cast<double>(z) * z * kp);
  return p;
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
template <bool GROUPED>
int launch(const Params& p, int groups, int mode, void* stream) {
  if (groups < 1 || groups > 65535 || (p.M + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    fused_gemm_kernel<1, int8_t, GROUPED><<<grid, NTHREADS, 0, s>>>(p);
  } else if (mode == 2) {
    fused_gemm_kernel<3, int16_t, GROUPED><<<grid, NTHREADS, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch<false>(p, 1, mode, stream);
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
  return launch<true>(p, G, mode, stream);
}
