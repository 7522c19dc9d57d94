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
//
// The backward (`ssm_scan_bwd_launch`, training; port-only like the
// forward) takes dy and gives dx, d delta, db, dc, dz (in z's dtype), da
// and d d_skip, from a zero state and with no mask.  With y'_t = sum_s
// h_t[s] c_t[s] + x_t d_skip, g_t = dy_t silu(z_t) and G_t = dL/dh_t:
//
//     G_t[s] = gh[s] + g_t c_t[s];  gh[s] <- exp(delta_t a[s]) G_t[s]
//     dz_t = dy_t y'_t silu'(z_t),  silu' = sig (1 + z (1 - sig))
//     dx_t = sum_s G_t[s] delta_t b_t[s] + g_t d_skip
//     d delta_t = sum_s G_t[s] (a[s] exp(delta_t a[s]) h_{t-1}[s]
//                               + x_t b_t[s])
//     db_t[s] = sum_d G_t[s] delta_t x_t,  dc_t[s] = sum_d g_t h_t[s]
//     da[d, s] = sum_{b, t} G_t[s] exp(delta_t a[s]) h_{t-1}[s] delta_t
//     d d_skip[d] = sum_{b, t} g_t x_t
//
// The forward's layout, one thread a (row, channel): pass 1 re-runs the
// forward (its operations, so the same states) and writes each h_t to a
// scratch of B S DS di floats ([b][t][s][d]: a warp's stores of one s
// coalesced), pass 2 sweeps t backwards with gh, da's and d_skip's sums in
// registers.  db_t and dc_t sum over the block's channels each step: a
// warp's 2 DS values are summed across its lanes by a reduce-scatter of
// shuffles (each level halves the values a lane holds, 2 DS - 1 shuffles,
// then a butterfly over the lanes left), the four warps' sums through
// shared memory in warp order (double buffered: one barrier a step); each
// block writes a partial sum for its channels, and da and d_skip one a
// batch row, which the wrapper adds in a fixed order: no float atomics,
// so a run repeats itself bit for bit; `ssm_scan_bwd_parts` tells the
// wrapper how many planes.  The function's own bound: by bytes, x, delta,
// z, dy, b, c read once and dx, d delta, dz, db, dc, da, d d_skip written
// once.  This design adds the h scratch, written and read once (8 B S di
// DS bytes, five times the rest at jamba's shape).

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

// ---------------------------------------------------------------------------
// Backward.

constexpr int WARPS = THREADS / 32;

struct BwdArgs {
  const float* x;
  const float* delta;
  const float* b;
  const float* c;
  const void* z;
  const float* a;
  const float* d_skip;
  const float* dy;                       // (B, S, di) contiguous
  float* hs;                             // (B, S, DS, di) scratch
  float* dx;                             // (B, S, di)
  float* ddelta;                         // (B, S, di)
  float* db;                             // (di blocks, B, S, DS) partials
  float* dc;                             // (di blocks, B, S, DS) partials
  void* dz;                              // (B, S, di) in z's dtype
  float* da;                             // (B, di, DS) partials
  float* dd;                             // (B, di) partials
  int batch, seq, di;
  long long x_sb, x_ss, dl_sb, dl_ss, z_sb, z_ss, b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ void store_z(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_z(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The warp's sum of each of a lane's NV values (NV a power of two <= 32):
// lane l returns the sum of value l % NV over the 32 lanes.  Each level
// pairs lanes across bit `off`; the lower lane keeps the first half of its
// values and the upper the second, each adding its partner's copy; then a
// butterfly over the lane bits above NV.  A fixed order of additions.
template <int NV>
__device__ __forceinline__ float warp_sums(float (&v)[NV], int lane) {
#pragma unroll
  for (int off = NV / 2; off >= 1; off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int k = 0; k < off; ++k) {
      const float send = upper ? v[k] : v[k + off];
      const float keep = upper ? v[k + off] : v[k];
      v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, off));
    }
  }
  float s = v[0];
#pragma unroll
  for (int off = NV; off < 32; off <<= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  }
  return s;
}

template <int DS, typename Z>
__global__ void __launch_bounds__(THREADS)
ssm_scan_bwd_kernel(const BwdArgs args) {
  constexpr int NV = 2 * DS;             // db_t and dc_t a step
  __shared__ float red[2][WARPS][NV];

  const int row = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < args.di;
  const int dl = live ? d : 0;           // dead lanes read channel 0
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float a[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) a[s] = args.a[(long long)dl * DS + s];
  const float dskip = args.d_skip[dl];
  const float* xp = args.x + row * args.x_sb + dl;
  const float* dp = args.delta + row * args.dl_sb + dl;
  const Z* zp = static_cast<const Z*>(args.z) + row * args.z_sb + dl;
  const float* bp = args.b + row * args.b_sb;
  const float* cp = args.c + row * args.c_sb;
  const long long rs = (long long)row * args.seq;
  float* hp = args.hs + rs * DS * args.di + dl;

  // Pass 1: the forward from a zero state, h_t to scratch.
  float h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) h[s] = 0.f;
  for (int t = 0; t < args.seq; ++t) {
    const float xt = xp[t * args.x_ss];
    const float dt = dp[t * args.dl_ss];
    const float dx = __fmul_rn(dt, xt);
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      const float da = expf(__fmul_rn(dt, a[s]));
      h[s] = __fadd_rn(__fmul_rn(da, h[s]),
                       __fmul_rn(dx, bp[t * args.b_ss + s]));
      if (live) hp[((long long)t * DS + s) * args.di] = h[s];
    }
  }

  // Pass 2: backwards in t; h holds h_t, prev h_{t-1}.
  float gh[DS], dacc[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) gh[s] = dacc[s] = 0.f;
  float ddacc = 0.f;
  for (int t = args.seq - 1; t >= 0; --t) {
    const float xt = xp[t * args.x_ss];
    const float dt = dp[t * args.dl_ss];
    const float zt = load_z(zp + t * args.z_ss);
    const long long ot = (rs + t) * args.di + dl;
    const float dyt = args.dy[ot];
    float prev[DS], bt[DS], ct[DS];
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      prev[s] = t > 0 && live ? hp[((long long)(t - 1) * DS + s) * args.di]
                              : 0.f;
      bt[s] = bp[t * args.b_ss + s];
      ct[s] = cp[t * args.c_ss + s];
    }
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-zt)));
    float yp = __fmul_rn(h[0], ct[0]);
#pragma unroll
    for (int s = 1; s < DS; ++s) yp = __fadd_rn(yp, __fmul_rn(h[s], ct[s]));
    yp = __fadd_rn(yp, __fmul_rn(xt, dskip));
    const float g = __fmul_rn(dyt, __fmul_rn(zt, sig));
    const float dsilu = __fmul_rn(
        sig, __fadd_rn(1.f, __fmul_rn(zt, __fsub_rn(1.f, sig))));
    const float dtx = __fmul_rn(dt, xt);
    float dxv = __fmul_rn(g, dskip), ddt = 0.f;
    float vals[NV];
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      const float big = __fadd_rn(gh[s], __fmul_rn(g, ct[s]));
      const float decay = expf(__fmul_rn(dt, a[s]));
      const float q = __fmul_rn(__fmul_rn(big, prev[s]), decay);
      const float gb = __fmul_rn(big, bt[s]);
      ddt = __fadd_rn(ddt, __fadd_rn(__fmul_rn(q, a[s]),
                                     __fmul_rn(gb, xt)));
      dxv = __fadd_rn(dxv, __fmul_rn(gb, dt));
      dacc[s] = __fadd_rn(dacc[s], __fmul_rn(q, dt));
      vals[s] = live ? __fmul_rn(big, dtx) : 0.f;
      vals[DS + s] = live ? __fmul_rn(g, h[s]) : 0.f;
      gh[s] = __fmul_rn(decay, big);
      h[s] = prev[s];
    }
    ddacc = __fadd_rn(ddacc, __fmul_rn(g, xt));
    if (live) {
      args.dx[ot] = dxv;
      args.ddelta[ot] = ddt;
      store_z(static_cast<Z*>(args.dz) + ot,
              __fmul_rn(__fmul_rn(dyt, yp), dsilu));
    }
    const float sum = warp_sums<NV>(vals, lane);
    float (&rw)[WARPS][NV] = red[t & 1];
    if (lane < NV) rw[warp][lane] = sum;
    __syncthreads();
    if (threadIdx.x < NV) {
      float tot = rw[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) tot = __fadd_rn(tot, rw[w][threadIdx.x]);
      const int s = threadIdx.x % DS;
      float* out = threadIdx.x < DS ? args.db : args.dc;
      out[((blockIdx.x * (long long)args.batch + row) * args.seq + t) * DS
          + s] = tot;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      args.da[((long long)row * args.di + d) * DS + s] = dacc[s];
    }
    args.dd[(long long)row * args.di + d] = ddacc;
  }
}

template <int DS>
cudaError_t launch_bwd(const BwdArgs& a, bool z_bf16, cudaStream_t stream) {
  const dim3 grid((a.di + THREADS - 1) / THREADS, a.batch);
  if (z_bf16) {
    ssm_scan_bwd_kernel<DS, __nv_bfloat16><<<grid, THREADS, 0, stream>>>(a);
  } else {
    ssm_scan_bwd_kernel<DS, float><<<grid, THREADS, 0, stream>>>(a);
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

// The partial planes the backward writes for db and dc at d_inner di (its
// blocks of THREADS channels; 0 for di < 1): the wrapper sizes its buffers
// by this, so the layout is decided here alone.
extern "C" int ssm_scan_bwd_parts(int di) {
  return di < 1 ? 0 : (di + THREADS - 1) / THREADS;
}

// The backward's C entry point: 0 on success, else a CUDA error code.
// Operands and strides as ssm_scan_launch's (no mask, no state: the scan
// starts from zero); dy (B, S, di) contiguous fp32; hs a scratch of
// B S DS di floats; dx, ddelta (B, S, di) fp32 and dz (B, S, di) in z's
// dtype, written contiguous; db, dc as ssm_scan_bwd_parts(di) partial
// planes (B, S, DS), da (B, di, DS) and dd (B, di) one a batch row.
extern "C" int ssm_scan_bwd_launch(
    const float* x, const float* delta, const float* b, const float* c,
    const void* z, const float* a, const float* d_skip, const float* dy,
    float* hs, float* dx, float* ddelta, float* db, float* dc, void* dz,
    float* da, float* dd, int batch, int seq, int di, int ds, int z_bf16,
    int x_sb, int x_ss, int dl_sb, int dl_ss, int z_sb, int z_ss, int b_sb,
    int b_ss, int c_sb, int c_ss, cudaStream_t stream) {
  if (batch < 1 || seq < 1 || di < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  BwdArgs args{x, delta, b, c, z, a, d_skip, dy, hs, dx, ddelta, db, dc,
               dz, da, dd, batch, seq, di, x_sb, x_ss, dl_sb, dl_ss, z_sb,
               z_ss, b_sb, b_ss, c_sb, c_ss};
  switch (ds) {
    case 4: return (int)launch_bwd<4>(args, z_bf16 != 0, stream);
    case 8: return (int)launch_bwd<8>(args, z_bf16 != 0, stream);
    case 16: return (int)launch_bwd<16>(args, z_bf16 != 0, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
