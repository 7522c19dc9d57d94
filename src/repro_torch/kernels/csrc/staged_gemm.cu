// Staged integer GEMM kernels for NVIDIA Hopper (sm_90a): MM1, and KMM2
// and MM2 on pre-split digit planes.
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
//       conventional MM2 on the same planes: four accumulators
//       C1 = A1.B1, C10 = A1.B0, C01 = A0.B1, C0 = A0.B0 and the combine
//       C1<<2h + (C10+C01)<<h + C0 in int32 or fp32.
//
// The zero-point correction, the padding of K and the digit split stay in
// the caller (repro_torch/kernels/ops.py), as in the reference: K arrives
// padded and the planes hold the padding's digits.
//
// Every product is an exact s8 x s8 -> s32 tensor-core MMA.  The planes
// come as int8 (depth 1: w <= 16, centered split, every digit and the
// KMM2 pre-adder in s8 through w = 14) or int16 (the depth-2 branches of
// ops._kmm4_core, whose leaves fit s8 at every w through 26).  Hopper has
// no int16 MMA, so int16 planes are narrowed to s8 as they are loaded.  Two
// routes for KMM2 (one instance each):
//   KMM2        three products on s8 pre-adder sums: int8 planes, and int16
//               planes split at h <= 6 (w <= 22), where the pre-adder spans
//               at most [-32, 93];
//   KMM2_SPLIT  int16 planes split at h = 7 (w = 23..26), where the
//               pre-adder reaches [-64, 189] and fits neither s8 nor u8:
//               the four leaf products, the two cross products a1.b0 and
//               a0.b1 into one accumulator, and Cs = C1 + C0 + cross in the
//               epilogue, in uint32.  That is the same integer, by
//               (a1 + a0)(b1 + b0) = a1.b1 + (a1.b0 + a0.b1) + a0.b0, so
//               both combines stay bit-exact, at 4 MMAs for 3.
//
// Numerics the design must keep: accumulators wrap modulo 2^32 as the
// reference's int32 scratch does, so the int32 combine runs in uint32
// (shifting a negative signed value is undefined); the fp32 combine
// follows the reference's operation order with explicitly rounded
// intrinsics (the library is built with --fmad=false): kmm2
// mid = (Cs - C1) - C0, out = (C1 * 2^2h + mid * 2^h) + C0; mm2
// mid = C10 + C01 in fp32, out = (C1 * 2^2h + mid * 2^h) + C0.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8): for
// the serve path's rows (decode M = live slots, prefill M <= 64) the
// kernel is bound by reading the B planes once (int8: K N bytes a plane;
// 2 planes for KMM2 and MM2), at a few hundred rows and more by the 1, 3
// or 4 digit products.  The staged path as a whole moves more than that:
// ops.py writes the padded int32 operands and the planes to device memory
// before the kernel reads them, which is what the fused kernel avoids.
// The kernel reads each plane once per output tile, forms the pre-adder
// sums in registers on the way into shared memory, keeps the accumulators
// on chip across the whole K loop and writes the combined output once.
// It is the simple first version: one 64x64 output tile per block, 8
// warps of 16x32 (the accumulators of MM2 need 64 registers a thread
// there), a synchronous K loop of 64-deep stages in which each loader
// thread issues all of its global loads before it packs any digit, and
// 16x16x16 s8 WMMA products.  TMA, wgmma and a pipelined K loop are later
// work.  M and N need not be multiples of the tile: edge loads read zeros
// and edge stores are masked.
//
// Build: the whole file compiles into one library.  Built with
// -DSTAGED_GEMM_UNIT=u it compiles only unit u (0: the C entry point;
// 1-4: the instances of one layout), so parallel nvcc processes can compile
// the units and link them.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

#ifdef STAGED_GEMM_UNIT
#define SG_UNIT(u) (STAGED_GEMM_UNIT == (u))
#else
#define SG_UNIT(u) 1
#endif

namespace staged_gemm_detail {

using namespace nvcuda;

constexpr int BM = 64;               // output rows per block (4 x 16)
constexpr int BN = 64;               // output columns per block (2 x 32)
constexpr int BK = 64;               // K depth of one shared-memory stage
constexpr int NTHREADS = 256;        // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int WN = 2;                // 16-column fragments a warp
constexpr int LPR = NTHREADS / BM;   // loader threads per row (column): 4
constexpr int KSUB = BK / 16;        // 16-deep sub-tiles a stage: 4
static_assert(BK / LPR == 16, "one 16-deep sub-tile per loader thread");
static_assert((BM / 16) * (BN / 16 / WN) == NWARPS, "warp grid");

// Layouts, one kernel instance each (per plane type); the values are the
// wrapper's layout ids.
enum Layout { MM1 = 1, KMM2 = 2, KMM2_SPLIT = 3, MM2 = 4 };

// Input planes per operand, s8 planes in shared memory, int32
// accumulators and tensor-core products per 16-deep step.
template <int L>
struct Shape {
  static constexpr int NIN = L == MM1 ? 1 : 2;
  static constexpr int NPLANE = L == KMM2 ? 3 : NIN;
  static constexpr int NACC = L == MM1 ? 1 : L == MM2 ? 4 : 3;
  static constexpr int NPROD = L == MM1 ? 1 : L == KMM2 ? 3 : 4;
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
  // MM2 and KMM2_SPLIT: (A1, B1), (A1, B0), (A0, B1), (A0, B0), plane 0
  // the high digit; KMM2_SPLIT gathers the two cross products in
  // accumulator 1.  MM1 and KMM2: plane p with plane p.
  if (L == MM2) return Prod{p >> 1, p & 1, p};
  if (L == KMM2_SPLIT) return Prod{p >> 1, p & 1, p == 0 ? 0 : p == 3 ? 2 : 1};
  return Prod{p, p, p};
}

struct Params {
  const void* a1;      // (M, K) row-major planes (a0 null for MM1)
  const void* a0;
  const void* b1;      // (K, N) row-major planes (b0 null for MM1)
  const void* b0;
  void* out;           // (M, N) row-major: int32, or float32 (fp32 combine)
  int M, K, N, h, combine_int32;
  float pow_h, pow_2h;
};

__device__ __forceinline__ void put(uint32_t (&w)[4], int c, int v) {
  w[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(v))
               << (8 * (c & 3));
}

// Narrow 16 consecutive k values of one A row or B column to the layout's
// s8 planes (KMM2 adds the pre-adder plane) and store each plane's 16 bytes
// at `dst`, the planes `plane_bytes` apart.
template <int L>
__device__ __forceinline__ void pack_store(const int (&v)[Shape<L>::NIN][16],
                                           int8_t* dst, int plane_bytes) {
  uint32_t w[Shape<L>::NPLANE][4] = {};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if constexpr (L == KMM2) {
      put(w[0], c, v[0][c]);
      put(w[1], c, v[0][c] + v[1][c]);
      put(w[2], c, v[1][c]);
    } else {
#pragma unroll
      for (int q = 0; q < Shape<L>::NIN; ++q) put(w[q], c, v[q][c]);
    }
  }
#pragma unroll
  for (int q = 0; q < Shape<L>::NPLANE; ++q) {
    *reinterpret_cast<uint4*>(dst + q * plane_bytes) =
        make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
  }
}

template <int L>
__device__ __forceinline__ void store_out(const Params& p,
                                          int (&c)[Shape<L>::NACC], int m,
                                          int n) {
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if constexpr (L == MM1) {
    static_cast<int*>(p.out)[o] = c[0];
    return;
  } else {
    if constexpr (L == KMM2_SPLIT) {
      // Cs = C1 + (A1.B0 + A0.B1) + C0, modulo 2^32
      c[1] = static_cast<int>(static_cast<uint32_t>(c[0])
                              + static_cast<uint32_t>(c[1])
                              + static_cast<uint32_t>(c[2]));
    }
    if (p.combine_int32) {
      uint32_t core;
      if constexpr (L == MM2) {
        const uint32_t u1 = c[0], u10 = c[1], u01 = c[2], u0 = c[3];
        core = (u1 << (2 * p.h)) + ((u10 + u01) << p.h) + u0;
      } else {
        const uint32_t u1 = c[0], us = c[1], u0 = c[2];
        core = (u1 << (2 * p.h)) + ((us - u1 - u0) << p.h) + u0;
      }
      static_cast<int*>(p.out)[o] = static_cast<int>(core);
      return;
    }
    float v;
    if constexpr (L == MM2) {
      const float mid = __fadd_rn(__int2float_rn(c[1]), __int2float_rn(c[2]));
      v = __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(c[0]), p.pow_2h),
                              __fmul_rn(mid, p.pow_h)),
                    __int2float_rn(c[3]));
    } else {
      const float c1f = __int2float_rn(c[0]);
      const float c0f = __int2float_rn(c[2]);
      const float mid = __fsub_rn(__fsub_rn(__int2float_rn(c[1]), c1f), c0f);
      v = __fadd_rn(__fadd_rn(__fmul_rn(c1f, p.pow_2h), __fmul_rn(mid, p.pow_h)),
                    c0f);
    }
    static_cast<float*>(p.out)[o] = v;
  }
}

// One block computes one BM x BN output tile over the whole K loop.
//
// Shared-memory layout (s8 planes), chosen so every loader thread writes
// 16 contiguous bytes and every WMMA fragment starts 256-bit aligned:
//   A plane q: [KSUB][BM][16]  (row-major 16-deep sub-tiles, ldm 16)
//   B plane q: [KSUB][BN][16]  (column-major 16-deep sub-tiles, ldm 16)
// Warp w owns output rows [16 wm, 16 wm + 16) with wm = w % 4 and the 32
// columns of column group w / 4.
template <int L, typename T>
__global__ void __launch_bounds__(NTHREADS)
staged_gemm_kernel(const Params p) {
  using S = Shape<L>;
  constexpr int NIN = S::NIN;
  constexpr int NACC = S::NACC;
  constexpr int A_PLANE = BM * BK;
  constexpr int B_PLANE = BK * BN;
  extern __shared__ __align__(128) int8_t smem[];

  const T* __restrict__ A[2] = {static_cast<const T*>(p.a1),
                                static_cast<const T*>(p.a0)};
  const T* __restrict__ B[2] = {static_cast<const T*>(p.b1),
                                static_cast<const T*>(p.b0)};
  int8_t* a_s = smem;
  int8_t* b_s = smem + S::NPLANE * A_PLANE;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp % (BM / 16);
  const int wn = warp / (BM / 16);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Loader roles: thread t loads 16 consecutive k of A row t / LPR (the
  // sub-tile t % LPR of each stage) and of B column t % BN (sub-tile
  // t / BN).
  const int a_row = tid / LPR, a_part = tid % LPR;
  const int b_col = tid % BN, b_part = tid / BN;
  const int gm = m0 + a_row;
  const int gn = n0 + b_col;
  const bool a_ok = gm < p.M;
  const bool b_ok = gn < p.N;
  // A warp whose 16 rows all lie below M skips its MMAs (warp-uniform).
  const bool warp_in = m0 + wm * 16 < p.M;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NACC][WN];
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int j = 0; j < WN; ++j) wmma::fill_fragment(acc[q][j], 0);

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // Every global load of the stage is issued before any digit is packed,
    // so the loads are in flight together.
    const int ka = k0 + a_part * 16, kb = k0 + b_part * 16;
    int va[NIN][16], vb[NIN][16];
#pragma unroll
    for (int q = 0; q < NIN; ++q) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        va[q][c] = (a_ok && ka + c < p.K)
            ? static_cast<int>(A[q][static_cast<size_t>(gm) * p.K + ka + c])
            : 0;
        vb[q][c] = (b_ok && kb + c < p.K)
            ? static_cast<int>(B[q][static_cast<size_t>(kb + c) * p.N + gn])
            : 0;
      }
    }
    pack_store<L>(va, a_s + a_part * BM * 16 + a_row * 16, A_PLANE);
    pack_store<L>(vb, b_s + b_part * BN * 16 + b_col * 16, B_PLANE);
    __syncthreads();
    if (warp_in) {
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
  if (!warp_in) return;

  // Epilogue: each warp stages its 16x16 accumulator fragments in the (now
  // free) tile memory and its lanes combine and store 8 elements each.
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
      const int m = m0 + wm * 16 + (idx >> 4);
      const int n = n0 + (wn * WN + j) * 16 + (idx & 15);
      if (m >= p.M || n >= p.N) continue;
      int cv[NACC];
#pragma unroll
      for (int q = 0; q < NACC; ++q) cv[q] = stage[q * 256 + idx];
      store_out<L>(p, cv, m, n);
    }
    __syncwarp();
  }
}

// Launches one instance on `stream` without synchronising; returns
// cudaGetLastError().
template <int L, typename T>
int launch_instance(const Params& p, cudaStream_t stream) {
  constexpr int smem = Shape<L>::SMEM_BYTES;
  static_assert(smem <= 48 * 1024, "needs no dynamic shared memory opt-in");
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  staged_gemm_kernel<L, T><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One function per layout, each defined in its own build unit; plane_bytes
// is 1 (int8 planes) or 2 (int16).
int launch_mm1(const Params& p, int plane_bytes, cudaStream_t s);
int launch_kmm2(const Params& p, int plane_bytes, cudaStream_t s);
int launch_kmm2_split(const Params& p, int plane_bytes, cudaStream_t s);
int launch_mm2(const Params& p, int plane_bytes, cudaStream_t s);

#if SG_UNIT(1)
int launch_mm1(const Params& p, int plane_bytes, cudaStream_t s) {
  if (plane_bytes != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_instance<MM1, int8_t>(p, s);
}
#endif
#if SG_UNIT(2)
int launch_kmm2(const Params& p, int plane_bytes, cudaStream_t s) {
  return plane_bytes == 1 ? launch_instance<KMM2, int8_t>(p, s)
                          : launch_instance<KMM2, int16_t>(p, s);
}
#endif
#if SG_UNIT(3)
int launch_kmm2_split(const Params& p, int plane_bytes, cudaStream_t s) {
  if (plane_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_instance<KMM2_SPLIT, int16_t>(p, s);
}
#endif
#if SG_UNIT(4)
int launch_mm2(const Params& p, int plane_bytes, cudaStream_t s) {
  if (plane_bytes != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_instance<MM2, int8_t>(p, s);
}
#endif

}  // namespace staged_gemm_detail

#if SG_UNIT(0)
// C entry point: layout 1 = mm1 (a1 (M, K), b1 (K, N) int8; a0, b0 null;
// int32 out), 2 = kmm2 on s8 pre-adders, 3 = kmm2 split, 4 = mm2 (planes
// a1, a0 (M, K) and b1, b0 (K, N) of plane_bytes 1 or 2; int32 out with
// combine_int32, else float32), all contiguous row-major; h is the digit
// split point.  Returns a CUDA error code, 0 on success.
extern "C" int staged_gemm_launch(const void* a1, const void* a0,
                                  const void* b1, const void* b0, void* out,
                                  int M, int K, int N, int layout,
                                  int plane_bytes, int h, int combine_int32,
                                  void* stream) {
  using namespace staged_gemm_detail;
  if (M < 1 || K < 1 || N < 1 || (M + BM - 1) / BM > 65535 || h < 0
      || h > 15 || (plane_bytes != 1 && plane_bytes != 2)
      || (layout != MM1 && (a0 == nullptr || b0 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.a1 = a1;
  p.a0 = a0;
  p.b1 = b1;
  p.b0 = b0;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.h = h;
  p.combine_int32 = combine_int32;
  p.pow_h = std::ldexp(1.0f, h);
  p.pow_2h = std::ldexp(1.0f, 2 * h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case MM1:
      return launch_mm1(p, plane_bytes, s);
    case KMM2:
      return launch_kmm2(p, plane_bytes, s);
    case KMM2_SPLIT:
      return launch_kmm2_split(p, plane_bytes, s);
    case MM2:
      return launch_mm2(p, plane_bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif
