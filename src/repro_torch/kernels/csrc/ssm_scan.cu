// Mamba selective scan for NVIDIA Hopper (sm_90a).
//
// Port-only: the reference computes this recurrence as jnp ops (an
// associative scan and an einsum over the state, src/repro/models/ssm.py:
// 139-158 for a sequence and :209-215 for a decode step), not as a Pallas
// kernel.  For each batch row b and channel d, with a state h[0 .. DS-1]
// in fp32 carried in from the cache, and for t = 0 .. S-1:
//
//     da[s] = exp(delta_t a[d, s])
//     h[s]  = da[s] h[s] + (delta_t x_t) b_t[s]
//     y_t   = sum_s h[s] c_t[s]          (s in order, from h[0] c_t[0])
//     y_t   = y_t + x_t d_skip[d]
//     y_t   = y_t silu(z_t)
//
// each fp32 operation separately rounded (the library is built with
// --fmad=false and the order is spelled out with __fmul_rn / __fadd_rn).
// Where mask[b, t] is false the step freezes the state (da = 1, no input
// term), as the reference's `where` does on pads; y_t is still written.
// The recurrence is sequential in t, so a row's result depends on its own
// inputs in one fixed order: prefill in chunks, a single-shot prefill and
// decode (S = 1) compute the same state bit for bit.
//
// Layout: x and delta (B, S, di) fp32, z (B, S, di) fp32 or bf16, b and c
// (B, S, DS) fp32, each read through its own (batch, step) element
// strides with the last axis contiguous, so the model's split views need
// no copy; a (di, DS) and d_skip (di,) contiguous fp32; h (B, di, DS)
// contiguous fp32, read at the start and written at the end, in place;
// mask (B, S) bytes or null; y (B, S, di) fp32, written contiguous.
//
// The design (a simple kernel that is right first): one thread a (row,
// channel), blocks of 128 channels of one row; the DS states and a's row
// in registers for the whole sequence; the b_t, c_t and mask of CHUNK steps
// staged in shared memory by the whole block, two barriers a chunk.  x,
// delta and z are read and y written coalesced across the block's
// channels.  DS is a template parameter (4, 8 and 16; the configs use 8
// and 16).
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32
// outside the tensor cores): by bytes, the state read and written once,
// the streams read once and y written once; by operations, about 6 DS + 8
// fp32 operations (DS exponentials among them) a (row, channel, step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;             // channels a block
constexpr int CHUNK = 32;                // steps staged a time

struct Args {
  const float* x;
  const float* delta;
  const float* b;
  const float* c;
  const void* z;
  const float* a;
  const float* d_skip;
  float* h;
  const uint8_t* mask;
  float* y;
  int batch, seq, di;
  long long x_sb, x_ss, dl_sb, dl_ss, z_sb, z_ss, b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ float load_z(const float* p) { return *p; }

__device__ __forceinline__ float load_z(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int DS, typename Z>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const Args args) {
  __shared__ float sb[CHUNK][DS];
  __shared__ float sc[CHUNK][DS];
  __shared__ uint8_t sm[CHUNK];

  const int row = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < args.di;

  float h[DS], a[DS];
  float dskip = 0.f;
  float* hp = args.h + ((long long)row * args.di + (live ? d : 0)) * DS;
  if (live) {
    const float* ap = args.a + (long long)d * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      h[s] = hp[s];
      a[s] = ap[s];
    }
    dskip = args.d_skip[d];
  }

  const float* xp = args.x + row * args.x_sb + d;
  const float* dp = args.delta + row * args.dl_sb + d;
  const Z* zp = static_cast<const Z*>(args.z) + row * args.z_sb + d;
  float* yp = args.y + (long long)row * args.seq * args.di + d;

  for (int t0 = 0; t0 < args.seq; t0 += CHUNK) {
    const int n = min(CHUNK, args.seq - t0);
    __syncthreads();                     // the last chunk's reads are done
    for (int i = threadIdx.x; i < n * DS; i += THREADS) {
      const int t = t0 + i / DS, s = i % DS;
      sb[i / DS][s] = args.b[row * args.b_sb + t * args.b_ss + s];
      sc[i / DS][s] = args.c[row * args.c_sb + t * args.c_ss + s];
    }
    for (int i = threadIdx.x; i < n; i += THREADS) {
      sm[i] = args.mask == nullptr
                  ? 1 : args.mask[(long long)row * args.seq + t0 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      const long long t = t0 + i;
      const float xt = xp[t * args.x_ss];
      const float dt = dp[t * args.dl_ss];
      const float zt = load_z(zp + t * args.z_ss);
      if (sm[i]) {
        const float dx = __fmul_rn(dt, xt);
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          const float da = expf(__fmul_rn(dt, a[s]));
          h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(dx, sb[i][s]));
        }
      }
      float y = __fmul_rn(h[0], sc[i][0]);
#pragma unroll
      for (int s = 1; s < DS; ++s) {
        y = __fadd_rn(y, __fmul_rn(h[s], sc[i][s]));
      }
      y = __fadd_rn(y, __fmul_rn(xt, dskip));
      const float silu = __fdiv_rn(zt, __fadd_rn(1.f, expf(-zt)));
      yp[t * args.di] = __fmul_rn(y, silu);
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) hp[s] = h[s];
  }
}

template <int DS>
cudaError_t launch(const Args& a, bool z_bf16, cudaStream_t stream) {
  const dim3 grid((a.di + THREADS - 1) / THREADS, a.batch);
  if (z_bf16) {
    ssm_scan_kernel<DS, __nv_bfloat16><<<grid, THREADS, 0, stream>>>(a);
  } else {
    ssm_scan_kernel<DS, float><<<grid, THREADS, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// The one C entry point: 0 on success, else a CUDA error code (the
// wrapper raises).  batch, seq, di >= 1, batch <= 65535, ds in {4, 8, 16};
// mask may be null (every step real).  h is updated in place.
extern "C" int ssm_scan_launch(const float* x, const float* delta,
                               const float* b, const float* c,
                               const void* z, const float* a,
                               const float* d_skip, float* h,
                               const uint8_t* mask, float* y, int batch,
                               int seq, int di, int ds, int z_bf16,
                               int x_sb, int x_ss, int dl_sb, int dl_ss,
                               int z_sb, int z_ss, int b_sb, int b_ss,
                               int c_sb, int c_ss, cudaStream_t stream) {
  if (batch < 1 || seq < 1 || di < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args args{x, delta, b, c, z, a, d_skip, h, mask, y, batch, seq, di,
            x_sb, x_ss, dl_sb, dl_ss, z_sb, z_ss, b_sb, b_ss, c_sb, c_ss};
  switch (ds) {
    case 4: return (int)launch<4>(args, z_bf16 != 0, stream);
    case 8: return (int)launch<8>(args, z_bf16 != 0, stream);
    case 16: return (int)launch<16>(args, z_bf16 != 0, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
