// Row-invariant fp32 kernels for NVIDIA Hopper (sm_90a): a small matmul and
// the row norms.
//
// No TPU kernel of the reference corresponds to these: the reference runs
// the same functions as jnp ops, which XLA lowers for the TPU.  They exist
// for a contract the reference keeps: chunked prefill (and so every prefix
// cache hit) is bit-exact against a single-shot prefill (`start=` in
// models/lm.prefill).  That needs every op outside the integer GEMMs to
// compute a row the same way, bit for bit, whatever the number of rows.
// ATen's fp32 matmul and its row reductions pick their algorithm by the row
// count, so on the card the same row changes bits between a chunk of 32
// tokens and a prompt of 128.  Here each output's reduction has one order
// fixed by K (matmul) or d (norm), never by M or the grid:
//
//   * rowinv_matmul_kernel: fp32 (M, K) @ (K, N), RWKV-6's decay LoRA
//     products, (M, 2560) @ (2560, 64) and (M, 64) @ (64, 2560).  An
//     output's K sum is split across L lanes (L = 32, a warp; from K =
//     SPLIT_K, L = 128, the four warps of a block), lane l taking k = l,
//     l + L, l + 2 L, ... in ascending order as a chain of `__fmaf_rn` from
//     0; each warp's 32 partials are then summed by a butterfly of warp
//     shuffles (xor 16, 8, 4, 2, 1; a + b is commutative, so every lane
//     ends with the same bits), and with L = 128 the four warp sums in
//     order of the warp.  A warp (or block) computes a tile of TM rows x
//     TN columns (TM TN accumulators a lane); the tile never changes an
//     output's order.  At decode (M = 4) the K = 2560 product has 8 tiles,
//     so its K split over four warps is what spreads it over the card.
//     Bound at these shapes: bytes (the 0.65 MB weight
//     read once, x and y), about 0.2-0.3 us at 3.35 TB/s; the design reads
//     a weight row's TN columns as 32 contiguous bytes a lane, so a warp's
//     loads of one k-step fill whole sectors, and every tile of rows
//     re-reads the weight tile from L2.
//   * rowinv_norm_kernel<T>: LayerNorm with bias (`ln`) or RMSNorm over the
//     last axis, fp32 math, input and output in T (fp32 or bf16), d at
//     most 256 NORM_EPT.  One block a row, NT threads (fixed by d: the
//     wrapper's `norm_threads`); thread t holds x[t], x[t + NT], ... in
//     registers (its loads all in flight at once) and sums them in that
//     order, the warp's partials go
//     through the same butterfly, and thread 0's order of the warp sums
//     (warp 0, 1, 2, ... in sequence) is every thread's.  The operation
//     order is the plain version's: mean, then the mean of the squared
//     deviations (LayerNorm; RMSNorm: the mean of squares), then
//     `(x - mu) * rsqrt(var + eps) * scale + bias`, then the cast to T
//     (round to nearest even).  Bound: bytes, x read once and y written
//     once (the second pass reads the row again from L1/L2).
//
// Against the plain version (ATen) the sums run in another order, so the
// two agree to fp32 rounding, not bit for bit; against itself a row is the
// same at every M.  Built with --fmad=false (build.py): every add and
// multiply outside the explicit `__fmaf_rn` is separately rounded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// The matmul's warp tile and block.
constexpr int TM = 4;          // rows a warp
constexpr int TN = 8;          // columns a warp (32 bytes of a weight row)
constexpr int MM_WARPS = 4;    // warps a block
constexpr int SPLIT_K = 1024;  // from this K the block's warps split K
// The norm's elements a thread holds: rows of up to 256 NORM_EPT.
constexpr int NORM_EPT = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  }
  return v;
}

// KW warps share each output tile and split its K sums: lane l of warp v
// is lane v 32 + l of 32 KW lanes.  KW = 1: the block's warps take a tile
// each.
template <int KW>
__global__ void __launch_bounds__(32 * MM_WARPS)
rowinv_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int m, int k, int n,
                     long long sx, long long sw, long long sy, int vec_w) {
  __shared__ float part[KW > 1 ? KW : 1][TM * TN];
  const int lane = threadIdx.x % 32;
  const int wv = KW > 1 ? threadIdx.x / 32 : 0;       // warp of the K split
  const long long tile = KW > 1 ? (long long)blockIdx.x
                                : (long long)blockIdx.x * MM_WARPS
                                      + threadIdx.x / 32;
  const int n_tiles = (n + TN - 1) / TN;
  const long long m0 = tile / n_tiles * TM;
  const int n0 = (int)(tile % n_tiles) * TN;
  if (m0 >= m) return;            // a whole warp (KW = 1) or block leaves
  const bool full_n = n0 + TN <= n;
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
  }
#pragma unroll 4
  for (int kk = wv * 32 + lane; kk < k; kk += 32 * KW) {
    float xv[TM], wv4[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      xv[r] = m0 + r < m ? x[(m0 + r) * sx + kk] : 0.0f;
    }
    const float* wr = w + (long long)kk * sw + n0;
    if (vec_w && full_n) {
      const float4 a = *reinterpret_cast<const float4*>(wr);
      const float4 b = *reinterpret_cast<const float4*>(wr + 4);
      wv4[0] = a.x; wv4[1] = a.y; wv4[2] = a.z; wv4[3] = a.w;
      wv4[4] = b.x; wv4[5] = b.y; wv4[6] = b.z; wv4[7] = b.w;
    } else {
#pragma unroll
      for (int c = 0; c < TN; ++c) wv4[c] = n0 + c < n ? wr[c] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        acc[r][c] = __fmaf_rn(xv[r], wv4[c], acc[r][c]);
      }
    }
  }
  // Every lane of a warp ends with every warp sum; lane r TN + c keeps
  // (r, c).
  float mine = 0.0f;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const float s = warp_sum(acc[r][c]);
      if (lane == r * TN + c) mine = s;
    }
  }
  if constexpr (KW > 1) {         // the KW warp sums, in order of the warp
    part[wv][lane] = mine;
    __syncthreads();
    if (wv != 0) return;
    mine = part[0][lane];
#pragma unroll
    for (int v = 1; v < KW; ++v) mine = __fadd_rn(mine, part[v][lane]);
  }
  const int r = lane / TN, c = lane % TN;
  if (m0 + r < m && n0 + c < n) y[(m0 + r) * sy + n0 + c] = mine;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The sum of every thread's v, the same bits in every thread: each warp's
// butterfly, then the warp sums in order 0, 1, 2, ...  `part` holds one
// float a warp and is not read again before the next __syncthreads.
__device__ __forceinline__ float block_sum(float v, float* part) {
  v = warp_sum(v);
  const int warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  float s = part[0];
  for (int i = 1; i < warps; ++i) s = __fadd_rn(s, part[i]);
  return s;
}

// A thread keeps its elements of the row in registers: all its loads go
// out before the first add, and the later passes read no memory.
template <typename T>
__global__ void __launch_bounds__(256)
rowinv_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y, int d,
                   long long sx, long long sy, int ln, float eps) {
  __shared__ float part[2][8];
  const T* xr = x + (long long)blockIdx.x * sx;
  T* yr = y + (long long)blockIdx.x * sy;
  const int nt = blockDim.x, t = threadIdx.x;
  const float fd = (float)d;
  float v[NORM_EPT];
#pragma unroll
  for (int e = 0; e < NORM_EPT; ++e) {
    const int i = t + e * nt;
    v[e] = i < d ? load(xr + i) : 0.0f;
  }
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < NORM_EPT; ++e) {
    if (t + e * nt < d) s = __fadd_rn(s, ln ? v[e] : __fmul_rn(v[e], v[e]));
  }
  const float mean = __fdiv_rn(block_sum(s, part[0]), fd);
  float rs;
  if (ln) {
    float q = 0.0f;
#pragma unroll
    for (int e = 0; e < NORM_EPT; ++e) {
      v[e] = __fsub_rn(v[e], mean);
      if (t + e * nt < d) q = __fadd_rn(q, __fmul_rn(v[e], v[e]));
    }
    const float var = __fdiv_rn(block_sum(q, part[1]), fd);
    rs = rsqrtf(__fadd_rn(var, eps));
  } else {
    rs = rsqrtf(__fadd_rn(mean, eps));
  }
#pragma unroll
  for (int e = 0; e < NORM_EPT; ++e) {
    const int i = t + e * nt;
    if (i < d) {
      const float o = __fmul_rn(__fmul_rn(v[e], rs), scale[i]);
      store(yr + i, ln ? __fadd_rn(o, bias[i]) : o);
    }
  }
}

}  // namespace

// C entry points: 0 on success, else a CUDA error code (the wrapper
// raises).  Strides are in elements; a row of x, w and y is contiguous.

// y (m, n) = x (m, k) @ w (k, n), fp32.
extern "C" int rowinv_matmul_launch(const float* x, const float* w, float* y,
                                    int m, int k, int n, int sx, int sw,
                                    int sy, cudaStream_t stream) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((m + TM - 1) / TM) * ((n + TN - 1) / TN);
  const bool split = k >= SPLIT_K;
  const long long grid = split ? tiles : (tiles + MM_WARPS - 1) / MM_WARPS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && sw % 4 == 0;
  if (split) {
    rowinv_matmul_kernel<MM_WARPS><<<(unsigned)grid, 32 * MM_WARPS, 0,
                                     stream>>>(x, w, y, m, k, n, sx, sw, sy,
                                               vec_w);
  } else {
    rowinv_matmul_kernel<1><<<(unsigned)grid, 32 * MM_WARPS, 0, stream>>>(
        x, w, y, m, k, n, sx, sw, sy, vec_w);
  }
  return (int)cudaGetLastError();
}

// One row norm per row of x (rows, d); dtype 0 fp32, 1 bf16 (x and y);
// kind 0 RMSNorm, 1 LayerNorm (bias read); threads a multiple of 32 in
// [32, 256], at least d / NORM_EPT.
extern "C" int rowinv_norm_launch(const void* x, const float* scale,
                                  const float* bias, void* y, int rows, int d,
                                  int sx, int sy, int dtype, int kind,
                                  int threads, float eps,
                                  cudaStream_t stream) {
  if (rows < 1 || d < 1 || threads < 32 || threads > 256 || threads % 32
      || d > threads * NORM_EPT || (kind == 1 && bias == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    rowinv_norm_kernel<float><<<rows, threads, 0, stream>>>(
        static_cast<const float*>(x), scale, bias, static_cast<float*>(y), d,
        sx, sy, kind, eps);
  } else if (dtype == 1) {
    rowinv_norm_kernel<__nv_bfloat16><<<rows, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), scale, bias,
        static_cast<__nv_bfloat16*>(y), d, sx, sy, kind, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
