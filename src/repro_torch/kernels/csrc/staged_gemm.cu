// The staged MM2 kernel for NVIDIA Hopper (sm_90a): conventional MM2 on
// pre-split digit planes.
//
// Replaces the TPU kernel `_mm2_kernel` (src/repro/kernels/mm2_gemm.py:24;
// entry `mm2_gemm_planes`, :65) and computes what it computes, bit for
// bit: on int8 digit planes a1, a0 (M, K) and b1, b0 (K, N), four
// accumulators C1 = A1.B1, C10 = A1.B0, C01 = A0.B1, C0 = A0.B0 and the
// combine C1<<2h + (C10+C01)<<h + C0 in int32 or fp32.  (The staged MM1 and
// KMM2 kernels are staged_pipe.cu's.)
//
// The zero-point correction, the padding of K and the digit split stay in
// the caller (repro_torch/kernels/ops.py), as in the reference: K arrives
// padded and the planes hold the padding's digits.  Every product is an
// exact s8 x s8 -> s32 tensor-core MMA on the centered int8 digits of
// w <= 16.
//
// Numerics the design must keep: accumulators wrap modulo 2^32 as the
// reference's int32 scratch does, so the int32 combine runs in uint32
// (shifting a negative signed value is undefined); the fp32 combine
// follows the reference's operation order with explicitly rounded
// intrinsics (the library is built with --fmad=false):
// mid = C10 + C01 in fp32, out = (C1 * 2^2h + mid * 2^h) + C0.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8): for
// the serve path's rows (decode M = live slots, prefill M <= 64) the
// kernel is bound by reading the two B planes once (K N bytes a plane), at
// a few hundred rows and more by the 4 digit products.  It is the simple
// first version: one 64x64 output tile per block, 8 warps of 16x32 (the
// four accumulators need 64 registers a thread there), a synchronous K
// loop of 64-deep stages in which each loader thread issues all of its
// global loads before it packs any digit, and 16x16x16 s8 WMMA products.
// TMA, wgmma and a pipelined K loop are later work.  M and N need not be
// multiples of the tile: edge loads read zeros and edge stores are masked.
//
// Build: the whole file compiles into one library.  Built with
// -DSTAGED_GEMM_UNIT=u it compiles only unit u (0: the C entry point;
// 1: the kernel), so parallel nvcc processes can compile the units and
// link them.

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

// The layout id of the wrapper's entry point.
constexpr int MM2 = 4;

// Planes per operand, int32 accumulators (one per product, accumulator
// 2 qa + qb pairs A plane qa with B plane qb, plane 0 the high digit) and
// shared memory: the planes of a stage, or the epilogue's staging.
constexpr int NPLANE = 2;
constexpr int NACC = 4;
constexpr int TILE_BYTES = NPLANE * (BM * BK + BK * BN);
constexpr int STAGE_BYTES = NWARPS * NACC * 256 * sizeof(int);
constexpr int SMEM_BYTES = TILE_BYTES > STAGE_BYTES ? TILE_BYTES
                                                    : STAGE_BYTES;

struct Params {
  const int8_t* a1;    // (M, K) row-major planes
  const int8_t* a0;
  const int8_t* b1;    // (K, N) row-major planes
  const int8_t* b0;
  void* out;           // (M, N) row-major: int32, or float32 (fp32 combine)
  int M, K, N, h, combine_int32;
  float pow_h, pow_2h;
};

__device__ __forceinline__ void put(uint32_t (&w)[4], int c, int v) {
  w[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(v))
               << (8 * (c & 3));
}

// 16 consecutive k values of one A row or B column, in both digit planes,
// stored as each plane's 16 bytes at `dst`, the planes `plane_bytes`
// apart.
__device__ __forceinline__ void pack_store(const int (&v)[NPLANE][16],
                                           int8_t* dst, int plane_bytes) {
  uint32_t w[NPLANE][4] = {};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int q = 0; q < NPLANE; ++q) put(w[q], c, v[q][c]);
  }
#pragma unroll
  for (int q = 0; q < NPLANE; ++q) {
    *reinterpret_cast<uint4*>(dst + q * plane_bytes) =
        make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
  }
}

__device__ __forceinline__ void store_out(const Params& p,
                                          const int (&c)[NACC], int m,
                                          int n) {
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.combine_int32) {
    const uint32_t u1 = c[0], u10 = c[1], u01 = c[2], u0 = c[3];
    static_cast<int*>(p.out)[o] = static_cast<int>(
        (u1 << (2 * p.h)) + ((u10 + u01) << p.h) + u0);
    return;
  }
  const float mid = __fadd_rn(__int2float_rn(c[1]), __int2float_rn(c[2]));
  static_cast<float*>(p.out)[o] =
      __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(c[0]), p.pow_2h),
                          __fmul_rn(mid, p.pow_h)),
                __int2float_rn(c[3]));
}

#if SG_UNIT(1)
// One block computes one BM x BN output tile over the whole K loop.
//
// Shared-memory layout (s8 planes), chosen so every loader thread writes
// 16 contiguous bytes and every WMMA fragment starts 256-bit aligned:
//   A plane q: [KSUB][BM][16]  (row-major 16-deep sub-tiles, ldm 16)
//   B plane q: [KSUB][BN][16]  (column-major 16-deep sub-tiles, ldm 16)
// Warp w owns output rows [16 wm, 16 wm + 16) with wm = w % 4 and the 32
// columns of column group w / 4.
__global__ void __launch_bounds__(NTHREADS)
staged_gemm_kernel(const Params p) {
  constexpr int A_PLANE = BM * BK;
  constexpr int B_PLANE = BK * BN;
  extern __shared__ __align__(128) int8_t smem[];

  const int8_t* __restrict__ A[2] = {p.a1, p.a0};
  const int8_t* __restrict__ B[2] = {p.b1, p.b0};
  int8_t* a_s = smem;
  int8_t* b_s = smem + NPLANE * A_PLANE;

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
    int va[NPLANE][16], vb[NPLANE][16];
#pragma unroll
    for (int q = 0; q < NPLANE; ++q) {
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
    pack_store(va, a_s + a_part * BM * 16 + a_row * 16, A_PLANE);
    pack_store(vb, b_s + b_part * BN * 16 + b_col * 16, B_PLANE);
    __syncthreads();
    if (warp_in) {
#pragma unroll
      for (int kk = 0; kk < KSUB; ++kk) {
#pragma unroll
        for (int q = 0; q < NACC; ++q) {
          const int qa = q >> 1, qb = q & 1;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> af;
          wmma::load_matrix_sync(
              af, a_s + qa * A_PLANE + kk * BM * 16 + wm * 256, 16);
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                           wmma::col_major> bf;
            wmma::load_matrix_sync(
                bf, b_s + qb * B_PLANE + kk * BN * 16 + (wn * WN + j) * 256,
                16);
            wmma::mma_sync(acc[q][j], af, bf, acc[q][j]);
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
      store_out(p, cv, m, n);
    }
    __syncwarp();
  }
}

// Launches the kernel on `stream` without synchronising; returns
// cudaGetLastError().
int launch_mm2(const Params& p, cudaStream_t stream) {
  static_assert(SMEM_BYTES <= 48 * 1024,
                "needs no dynamic shared memory opt-in");
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  staged_gemm_kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
#endif

int launch_mm2(const Params& p, cudaStream_t stream);

}  // namespace staged_gemm_detail

#if SG_UNIT(0)
// C entry point: layout 4 = mm2 on int8 planes a1, a0 (M, K) and b1, b0
// (K, N), all contiguous row-major, plane_bytes 1; int32 out with
// combine_int32, else float32; h is the digit split point.  Returns a CUDA
// error code, 0 on success.
extern "C" int staged_gemm_launch(const void* a1, const void* a0,
                                  const void* b1, const void* b0, void* out,
                                  int M, int K, int N, int layout,
                                  int plane_bytes, int h, int combine_int32,
                                  void* stream) {
  using namespace staged_gemm_detail;
  if (M < 1 || K < 1 || N < 1 || (M + BM - 1) / BM > 65535 || h < 0
      || h > 15 || layout != MM2 || plane_bytes != 1 || a0 == nullptr
      || b0 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.a1 = static_cast<const int8_t*>(a1);
  p.a0 = static_cast<const int8_t*>(a0);
  p.b1 = static_cast<const int8_t*>(b1);
  p.b0 = static_cast<const int8_t*>(b0);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.h = h;
  p.combine_int32 = combine_int32;
  p.pow_h = std::ldexp(1.0f, h);
  p.pow_2h = std::ldexp(1.0f, 2 * h);
  return launch_mm2(p, static_cast<cudaStream_t>(stream));
}
#endif
