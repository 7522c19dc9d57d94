// RWKV6 WKV recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv_kernel` (src/repro/kernels/wkv_gemm.py:33;
// entry `wkv_apply`, :57) and computes what it computes.  For each (batch
// row b, head h) the state S is a D x D fp32 matrix, and for t = 0 .. S-1:
//
//     y_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])
//     S[i, j] <- w_t[i] S[i, j] + k_t[i] v_t[j]
//
// reading the old state before updating it, as the reference does
// (wkv_gemm.py:43-51).  Two things differ from the TPU kernel, by design:
// the state may start from `state0` instead of zero, and the final state is
// written to `state_out` (the TPU kernel keeps it in VMEM scratch and drops
// it; serving needs it for decode).  With both pointers null it is the
// reference's function.
//
// Layout: the streams r, k, v, w are fp32 (B, S, H, D) read through the
// element strides (sb, ss, sh) they share, with D contiguous, so the model's
// (B, S, H, D) projections need no transpose; the reference's (BH, S, D)
// layout is the case H = 1.  u is (H, D) read with a batch stride `ub` (0
// for the model's shared (H, D), D for `wkv_apply`'s (BH, D)) and head
// stride `uh`.  y is written contiguous (B, S, H, D).  state0 and state_out
// are contiguous (B, H, D, D); they may be the same buffer (each block reads
// its whole state before it writes any of it).
//
// Design: one block per (h, b), D threads.  Thread j keeps column j of the
// state, S[:, j], in D registers for the whole sequence, so the state never
// leaves the chip between steps (the TPU kernel's VMEM scratch) and device
// memory sees each stream element once, the state once in and once out.
// Each step the block stages r_t, k_t, w_t in shared memory (each thread
// its own element; double-buffered, so one barrier a step), and each thread
// holds its own v_t[j]; the next step's four elements are loaded before the
// current step's arithmetic, so their latency hides behind it.  The sum
// over i runs in order i = 0 .. D-1 in one accumulator (the plain version
// sums in its own order, so the two agree to fp32 rounding, not bit for
// bit).
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 outside
// the tensor cores): by bytes, B H (5 S D + 2 D^2) 4 bytes (a few µs at the
// serve shapes), by operations 7 B H S D^2 fp32 operations.  Neither is
// what limits it: the S steps are sequential, each a chain of D dependent
// adds, and at decode only B H blocks of D threads exist, so the kernel is
// bound by the latency of its step.  Splitting the sum over i across
// threads, or several heads per block, is later work.
//
// D is a template parameter (16 and 64, the configs' head sizes, and 4 and
// 8, the reference tests' smaller ones); other D are refused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int D>
__global__ void __launch_bounds__(D) wkv_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* state0,
    float* __restrict__ y, float* state_out, int seq, int n_heads,
    long long sb, long long ss, long long sh, long long ub, long long uh) {
  __shared__ float s_r[2][D], s_k[2][D], s_w[2][D];
  __shared__ float s_u[D];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;

  float st[D];                                  // S[:, j]
  const long long sbase = ((long long)b * n_heads + h) * D * D + j;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    st[i] = state0 != nullptr ? state0[sbase + (long long)i * D] : 0.0f;
  }
  s_u[j] = u[b * ub + h * uh + j];

  const long long base = b * sb + h * sh + j;
  const long long ybase = (long long)b * seq * n_heads * D
                          + (long long)h * D + j;
  float rn = r[base], kn = k[base], vn = v[base], wn = w[base];
  for (int t = 0; t < seq; ++t) {
    const int buf = t & 1;
    s_r[buf][j] = rn;
    s_k[buf][j] = kn;
    s_w[buf][j] = wn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < seq) {
      const long long off = base + (long long)(t + 1) * ss;
      rn = r[off];
      kn = k[off];
      vn = v[off];
      wn = w[off];
    }
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float kv = s_k[buf][i] * vj;
      acc += (st[i] + s_u[i] * kv) * s_r[buf][i];
      st[i] = s_w[buf][i] * st[i] + kv;
    }
    y[ybase + (long long)t * n_heads * D] = acc;
  }
  if (state_out != nullptr) {
#pragma unroll
    for (int i = 0; i < D; ++i) state_out[sbase + (long long)i * D] = st[i];
  }
}

template <int D>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* state0,
                   float* y, float* state_out, int batch, int seq, int heads,
                   int sb, int ss, int sh, int ub, int uh,
                   cudaStream_t stream) {
  dim3 grid(heads, batch);
  wkv_kernel<D><<<grid, D, 0, stream>>>(r, k, v, w, u, state0, y, state_out,
                                        seq, heads, sb, ss, sh, ub, uh);
  return cudaGetLastError();
}

}  // namespace

// The one C entry point: 0 on success, else a CUDA error code (the
// wrapper raises).  seq >= 1, batch and heads >= 1; state0 and state_out
// may be null (zero initial state; final state not written).
extern "C" int wkv_launch(const float* r, const float* k, const float* v,
                          const float* w, const float* u,
                          const float* state0, float* y, float* state_out,
                          int batch, int seq, int heads, int d, int sb,
                          int ss, int sh, int ub, int uh,
                          cudaStream_t stream) {
  if (batch < 1 || seq < 1 || heads < 1 || batch > 65535 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 4:
      return (int)launch<4>(r, k, v, w, u, state0, y, state_out, batch, seq,
                            heads, sb, ss, sh, ub, uh, stream);
    case 8:
      return (int)launch<8>(r, k, v, w, u, state0, y, state_out, batch, seq,
                            heads, sb, ss, sh, ub, uh, stream);
    case 16:
      return (int)launch<16>(r, k, v, w, u, state0, y, state_out, batch, seq,
                             heads, sb, ss, sh, ub, uh, stream);
    case 64:
      return (int)launch<64>(r, k, v, w, u, state0, y, state_out, batch, seq,
                             heads, sb, ss, sh, ub, uh, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
