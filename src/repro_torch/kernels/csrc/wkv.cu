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
// are contiguous (B, H, D, D); they may be the same buffer (every state
// element is read and written by one thread only, read first).
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 outside
// the tensor cores): by bytes, B H (5 S D + 2 D^2) 4 bytes; by operations,
// 7 B H S D^2 fp32 operations.  The steps of a head are sequential, but
// the columns of its state are independent (column j of S feeds y[j] and
// itself only), and the sum over i is a reduction.  The design:
//
//   * Split the sum over i across G = D / R lanes: a unit of G x QW lanes
//     owns 4 QW columns of one head, lane (g, q) the R x 4 state entries
//     S[g R .. g R + R - 1, 4 (cb QW + q) .. + 3] in registers for the
//     whole sequence.  Each step a lane forms four partial y[j] over its R
//     rows (a chain of R dependent fused multiply-adds, not D), and the G
//     partials of a column are summed by a butterfly of warp shuffles
//     (xor over the g bits of the lane: log2 G levels), which leaves the
//     sum in every lane of the column; lane g = 0 stores it.  D = 64: R =
//     4, G = 16, QW = 2, one unit a warp, eight warps a head (decode: R =
//     8, G = 8, four warps a head); the smaller D put several units in a
//     warp.
//   * Column blocks are independent, so a head's units spread over warps
//     and blocks: at prefill with few heads (rwkv: 40 a row) the card
//     gets eight warps a head instead of one block of D threads.
//   * Streams (S > 1): a block of four warps covers whole heads or part of
//     one (HB heads), and stages r, k, w, v of CH steps of its heads at a
//     time in shared memory with `cp.async` copies (16 bytes where every
//     stream row is 16-byte aligned, as the model's are; else 4), double
//     buffered: the copies of the next chunk are in flight while the
//     current one runs, two barriers a chunk, none a step.
//   * Decode (S = 1), where the time is loading and storing the 16 KB
//     state of each head: a kernel of its own with no shared memory and
//     no barrier, each lane issuing all its loads — the state as R 16-byte
//     loads (float4 across j), its R rows of r, k, w and u and its 4
//     columns of v — before any arithmetic; the state write is R 16-byte
//     stores.  A head's state is read by eight warps at once.
//
// Numerics: the sum over i runs in another order than the plain version's
// (within a lane in order of i, then the butterfly's pairwise tree over
// g), and uses fused multiply-adds (explicit `__fmaf_rn`; the library is
// built with --fmad=false); the two agree to fp32 rounding, not bit for
// bit.
//
// D is a template parameter (16 and 64, the configs' head sizes, and 4 and
// 8, the reference tests' smaller ones); other D are refused.
//
// The backward (`wkv_bwd_launch`, training) is port-only: the TPU kernel
// has none, and the reference's gradient is XLA's autodiff of its jnp scan
// (src/repro/models/rwkv.py:135-146).  From a zero state, with dS_t the
// gradient reaching S_t from later steps (zero after the last step):
//
//     dr_t[i] = sum_j dy_t[j] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
//     dk_t[i] = sum_j v_t[j] e_t[i, j],  dv_t[j] = sum_i k_t[i] e_t[i, j]
//         where e_t[i, j] = dS_t[i, j] + r_t[i] u[i] dy_t[j]
//     dw_t[i] = sum_j dS_t[i, j] S_{t-1}[i, j]
//     du[i]   = sum_{b, t} r_t[i] k_t[i] sum_j dy_t[j] v_t[j]
//     dS_{t-1}[i, j] = w_t[i] dS_t[i, j] + r_t[i] dy_t[j]
//
// A simple kernel that is right first.  A block owns CW columns of one
// head's state (CW = 16 at D = 64, four blocks a head; the whole state
// below), one thread a row i.  Pass 1 re-runs the forward over its columns
// (the forward kernel's state update, so the same bits) and writes each
// S_{t-1} to a scratch of B H S D^2 floats; pass 2 sweeps t backwards with
// the thread's CW entries of dS in registers, reading S_{t-1} back.  The
// sums over j (dr, dk, dw, and sum_j dy v for du) run in the thread in
// order of j; dv's sum over i goes through shared memory, thread j < CW
// adding the D rows in order (double buffered: one barrier a step).
// Column blocks write dr, dk, dw and du as partial sums the wrapper adds
// in a fixed order: no float atomics, so a run repeats itself bit for bit;
// `wkv_bwd_parts` tells the wrapper how many.  The function's own bound on
// this card is its ~20 fp32 operations a state element and step (the
// streams r, k, v, w, dy read once and dr, dk, dv, dw written once move
// 4 (9 B S H D + 2 H D) bytes, less time at D = 64).  This design adds the
// state scratch, written and read once: 8 B H S D^2 bytes, which chunk
// checkpoints would remove.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                 // warps a block
constexpr int NT = 32 * WARPS;
constexpr int CHUNK_FLOATS = 4096;       // stream floats a chunk buffer

// The lane layout for head size D_: R rows and 4 QW columns a unit of
// G x QW lanes (q fastest, then g, then the unit U within the warp).  The
// decode kernel (STEP) takes D = 64 as 8 rows of 4 columns a lane and 16
// columns a unit (G = 8, QW = 4, four warps a head): at one step there is
// no chain to shorten, and fewer, fuller lanes move the state in fewer
// load and store instructions; the chunked kernel's shorter chains and
// twice the warps a head win once there are many steps.
template <int D_, bool STEP>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int R = D == 64 ? (STEP ? 8 : 4) : D == 4 ? 1 : 2;
  static constexpr int QW = D == 64 && STEP ? 4 : D == 4 ? 1 : 2;
  static constexpr int G = D / R;
  static constexpr int LU = G * QW;            // lanes a unit
  static constexpr int U = 32 / LU;            // units a warp
  static constexpr int NCB = D / (4 * QW);     // column blocks a head
  static constexpr int UB = U * WARPS;         // units a block
  static constexpr int HB = UB > NCB ? UB / NCB : 1;   // heads a block
  static constexpr int CH = CHUNK_FLOATS / (4 * HB * D);  // steps a chunk
  static_assert(LU <= 32 && 32 % LU == 0 && (G & (G - 1)) == 0, "lanes");
  static_assert(NCB % UB == 0 || UB % NCB == 0, "blocks tile heads");
  static_assert(CH >= 1 && 4 * HB * CH * D == CHUNK_FLOATS, "chunk");
  static_assert(HB * CH * D % (4 * NT) == 0, "whole copies a thread");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// N consecutive floats from shared memory aligned to 4 min(N, 4) bytes.
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}

struct Args {
  const float* s[4];                     // r, k, w, v streams
  const float* u;
  const float* state0;
  float* y;
  float* state_out;
  int batch, seq, heads;
  long long sb, ss, sh, ub, uh;
  int vec_state;                         // state pointers 16-byte aligned
  int vec_streams;                       // stream rows 16-byte aligned
};

// A lane's place in layout C: head n (b * heads + h), its row group g;
// its rows i0 .. i0 + R - 1 and columns j0 .. j0 + 3.
template <class C>
struct Lane {
  int g, n, b, h, i0, j0;
  bool valid;
  __device__ __forceinline__ Lane(const Args& a, int tid) {
    const int lane = tid % 32;
    const int q = lane % C::QW;
    g = (lane / C::QW) % C::G;
    const int unit = blockIdx.x * C::UB + (tid / 32) * C::U + lane / C::LU;
    n = unit / C::NCB;
    valid = n < a.batch * a.heads;
    b = n / a.heads;
    h = n % a.heads;
    i0 = g * C::R;
    j0 = 4 * ((unit % C::NCB) * C::QW + q);
  }
};

// The state and bonus of a lane's R rows and 4 columns (zero where
// state0 is null or the lane is past the last head).
template <class C>
__device__ __forceinline__ void load_state(const Args& a, const Lane<C>& l,
                                           float (&st)[C::R][4],
                                           float (&u)[C::R]) {
  constexpr int R = C::R, D = C::D;
  const long long base = (long long)l.n * D * D + (long long)l.i0 * D + l.j0;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    u[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) st[rr][c] = 0.0f;
  }
  if (!l.valid) return;
  if (a.state0 != nullptr) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float* p = a.state0 + base + (long long)rr * D;
      if (a.vec_state) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        st[rr][0] = x.x; st[rr][1] = x.y; st[rr][2] = x.z; st[rr][3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) st[rr][c] = p[c];
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    u[rr] = a.u[l.b * a.ub + l.h * a.uh + l.i0 + rr];
  }
}

template <class C>
__device__ __forceinline__ void store_state(const Args& a, const Lane<C>& l,
                                            const float (&st)[C::R][4]) {
  constexpr int D = C::D;
  if (!l.valid || a.state_out == nullptr) return;
  const long long base = (long long)l.n * D * D + (long long)l.i0 * D + l.j0;
#pragma unroll
  for (int rr = 0; rr < C::R; ++rr) {
    float* p = a.state_out + base + (long long)rr * D;
    if (a.vec_state) {
      *reinterpret_cast<float4*>(p) =
          make_float4(st[rr][0], st[rr][1], st[rr][2], st[rr][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) p[c] = st[rr][c];
    }
  }
}

// One step on a lane's state: the partial y over its R rows from the old
// state, the state update, then the G partials of each column summed by
// the shuffle butterfly and stored by lane g = 0 at `yp`.
template <class C>
__device__ __forceinline__ void step(const Lane<C>& l, float (&st)[C::R][4],
                                     const float (&u)[C::R], const float* r,
                                     const float* k, const float* w,
                                     const float* v, float* yp) {
  float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int rr = 0; rr < C::R; ++rr) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float kv = __fmul_rn(k[rr], v[c]);
      y[c] = __fmaf_rn(__fmaf_rn(u[rr], kv, st[rr][c]), r[rr], y[c]);
      st[rr][c] = __fmaf_rn(w[rr], st[rr][c], kv);
    }
  }
#pragma unroll
  for (int off = C::QW; off < C::LU; off <<= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[c] = __fadd_rn(y[c], __shfl_xor_sync(0xffffffffu, y[c], off));
    }
  }
  if (l.valid && l.g == 0) {
    *reinterpret_cast<float4*>(yp) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

// Decode: one step from state0, every operand loaded into registers
// before any arithmetic.
template <int D>
__global__ void __launch_bounds__(NT) wkv_step_kernel(const Args a) {
  using C = Cfg<D, true>;
  constexpr int R = C::R;
  const Lane<C> l(a, threadIdx.x);
  float st[R][4], u[R], r[R], k[R], w[R], v[4];
  load_state<C>(a, l, st, u);
  const long long off = l.b * a.sb + l.h * a.sh;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    r[rr] = l.valid ? a.s[0][off + l.i0 + rr] : 0.0f;
    k[rr] = l.valid ? a.s[1][off + l.i0 + rr] : 0.0f;
    w[rr] = l.valid ? a.s[2][off + l.i0 + rr] : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = l.valid ? a.s[3][off + l.j0 + c] : 0.0f;
  step<C>(l, st, u, r, k, w, v,
          a.y + ((long long)l.b * a.heads + l.h) * D + l.j0);
  store_state<C>(a, l, st);
}

// Stage steps [t0, t0 + steps) of the four streams of the block's heads
// head0 .. head0 + HB - 1 into `buf` ([HB][4][CH][D] floats): 16-byte
// copies where the stream rows are aligned, else 4-byte ones.
template <int D>
__device__ __forceinline__ void stage(const Args& a, float* buf, int head0,
                                      int t0, int steps, int tid) {
  using C = Cfg<D, false>;
  const int heads = a.batch * a.heads;
  // head lh's element offset b sb + h sh, or -1 past the last head
  const auto head_off = [&](int lh) -> long long {
    const int n = head0 + lh;
    return n < heads ? (n / a.heads) * a.sb + (n % a.heads) * a.sh : -1;
  };
  const long long off0 = head_off(0);
  if (a.vec_streams) {
    constexpr int V = D / 4;                     // 16-byte copies a row
#pragma unroll
    for (int st = 0; st < 4; ++st) {
#pragma unroll
      for (int i = 0; i < C::HB * C::CH * V / NT; ++i) {
        const int e = tid + i * NT;
        const int tt = (e / V) % C::CH;
        const int lh = C::HB == 1 ? 0 : e / (V * C::CH);
        const long long off = C::HB == 1 ? off0 : head_off(lh);
        if (tt >= steps || off < 0) continue;
        cp_async16(buf + ((lh * 4 + st) * C::CH + tt) * D + 4 * (e % V),
                   a.s[st] + off + (long long)(t0 + tt) * a.ss + 4 * (e % V));
      }
    }
    return;
  }
#pragma unroll
  for (int st = 0; st < 4; ++st) {
#pragma unroll
    for (int i = 0; i < C::HB * C::CH * D / NT; ++i) {
      const int e = tid + i * NT;
      const int tt = (e / D) % C::CH;
      const int lh = C::HB == 1 ? 0 : e / (D * C::CH);
      const long long off = C::HB == 1 ? off0 : head_off(lh);
      if (tt >= steps || off < 0) continue;
      cp_async4(buf + ((lh * 4 + st) * C::CH + tt) * D + e % D,
                a.s[st] + off + (long long)(t0 + tt) * a.ss + e % D);
    }
  }
}

// Prefill and wkv_apply: the whole sequence, streams staged in chunks.
template <int D>
__global__ void __launch_bounds__(NT) wkv_kernel(const Args a) {
  using C = Cfg<D, false>;
  constexpr int R = C::R;
  __shared__ __align__(16) float sm[2][CHUNK_FLOATS];

  const int tid = threadIdx.x;
  const Lane<C> l(a, tid);
  const int head0 = blockIdx.x * C::UB / C::NCB;
  const int lh = l.n - head0;                    // head within the block

  // State and bonus first, beside the first two chunks' copies.
  float st[R][4], u[R];
  load_state<C>(a, l, st, u);
  const int nch = (a.seq + C::CH - 1) / C::CH;
  stage<D>(a, sm[0], head0, 0, min(C::CH, a.seq), tid);
  cp_async_commit();
  if (nch > 1) {
    stage<D>(a, sm[1], head0, C::CH, min(C::CH, a.seq - C::CH), tid);
  }
  cp_async_commit();

  float* yrow = a.y + ((long long)l.b * a.seq * a.heads + l.h) * D + l.j0;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait1();                  // chunk ch has landed
    __syncthreads();
    const float* buf = sm[ch & 1] + lh * 4 * C::CH * D;
    const int t0 = ch * C::CH;
    const int steps = min(C::CH, a.seq - t0);
#pragma unroll 2
    for (int tt = 0; tt < steps; ++tt) {
      float r[R], k[R], w[R], v[4];
      lds<R>(buf + (0 * C::CH + tt) * D + l.i0, r);
      lds<R>(buf + (1 * C::CH + tt) * D + l.i0, k);
      lds<R>(buf + (2 * C::CH + tt) * D + l.i0, w);
      lds<4>(buf + (3 * C::CH + tt) * D + l.j0, v);
      step<C>(l, st, u, r, k, w, v,
              yrow + (long long)(t0 + tt) * a.heads * D);
    }
    __syncthreads();                   // every warp is done with the buffer
    if (ch + 2 < nch) {
      stage<D>(a, sm[ch & 1], head0, (ch + 2) * C::CH,
               min(C::CH, a.seq - (ch + 2) * C::CH), tid);
    }
    cp_async_commit();
  }
  store_state<C>(a, l, st);
}

// Blocks of layout C for the launch's heads.
template <class C>
long long grid_of(const Args& a) {
  const long long units = (long long)a.batch * a.heads * C::NCB;
  return (units + C::UB - 1) / C::UB;
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long grid = a.seq == 1 ? grid_of<Cfg<D, true>>(a)
                                    : grid_of<Cfg<D, false>>(a);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.seq == 1) {
    wkv_step_kernel<D><<<static_cast<unsigned>(grid), NT, 0, stream>>>(a);
  } else {
    wkv_kernel<D><<<static_cast<unsigned>(grid), NT, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.

template <int D_>
struct BwdCfg {
  static constexpr int D = D_;
  static constexpr int CW = D < 16 ? D : 16;   // state columns a block
  static constexpr int NCB = D / CW;           // column blocks a head
  static_assert(CW % 4 == 0 && D % CW == 0, "columns");
};

struct BwdArgs {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;                        // (H, D) contiguous
  const float* dy;                       // (B, S, H, D) contiguous
  float* states;                         // (B, H, S, D, D) scratch
  float* dr;                             // (NCB, B, S, H, D) partials
  float* dk;
  float* dv;                             // (B, S, H, D)
  float* dw;                             // (NCB, B, S, H, D) partials
  float* du;                             // (NCB, B, H, D) partials
  int batch, seq, heads;
  long long sb, ss, sh;
};

template <int D>
__global__ void __launch_bounds__(D) wkv_bwd_kernel(const BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int CW = C::CW;
  __shared__ float red[2][D][CW + 1];

  const int i = threadIdx.x;                     // state row
  const int cb = blockIdx.x % C::NCB;
  const int n = blockIdx.x / C::NCB;             // b * heads + h
  const int b = n / a.heads, h = n % a.heads;
  const int j0 = cb * CW;
  const long long off = b * a.sb + h * a.sh;
  const float ui = a.u[h * D + i];
  float* sp = a.states + (long long)n * a.seq * D * D + (long long)i * D + j0;

  // Pass 1: the forward over this block's columns, S_{t-1} to scratch.
  float st[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) st[c] = 0.0f;
  for (int t = 0; t < a.seq; ++t) {
    const long long o = off + t * a.ss;
    const float kt = a.k[o + i], wt = a.w[o + i];
    float* p = sp + (long long)t * D * D;
#pragma unroll
    for (int c = 0; c < CW; c += 4) {
      *reinterpret_cast<float4*>(p + c) =
          make_float4(st[c], st[c + 1], st[c + 2], st[c + 3]);
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const float kv = __fmul_rn(kt, a.v[o + j0 + c]);
      st[c] = __fmaf_rn(wt, st[c], kv);
    }
  }

  // Pass 2: backwards in t with dS in registers.
  float ds[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) ds[c] = 0.0f;
  float du = 0.0f;
  const long long plane = (long long)a.batch * a.seq * a.heads * D;
  for (int t = a.seq - 1; t >= 0; --t) {
    const long long o = off + t * a.ss;
    const long long oy = (((long long)b * a.seq + t) * a.heads + h) * D;
    const float rt = a.r[o + i], kt = a.k[o + i], wt = a.w[o + i];
    const float* p = sp + (long long)t * D * D;
    float vv[CW], g[CW], prev[CW];
#pragma unroll
    for (int c = 0; c < CW; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      prev[c] = x.x; prev[c + 1] = x.y; prev[c + 2] = x.z; prev[c + 3] = x.w;
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      vv[c] = a.v[o + j0 + c];
      g[c] = a.dy[oy + j0 + c];
    }
    const float ukv = __fmul_rn(ui, kt), ru = __fmul_rn(rt, ui);
    float dr = 0.0f, dk = 0.0f, dw = 0.0f, gv = 0.0f;
    float (&rw)[D][CW + 1] = red[t & 1];
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      dr = __fmaf_rn(g[c], __fmaf_rn(ukv, vv[c], prev[c]), dr);
      const float e = __fmaf_rn(ru, g[c], ds[c]);
      dk = __fmaf_rn(vv[c], e, dk);
      dw = __fmaf_rn(ds[c], prev[c], dw);
      gv = __fmaf_rn(g[c], vv[c], gv);
      rw[i][c] = __fmul_rn(kt, e);
      ds[c] = __fmaf_rn(wt, ds[c], __fmul_rn(rt, g[c]));
    }
    du = __fmaf_rn(__fmul_rn(rt, kt), gv, du);
    const long long op = cb * plane + oy + i;
    a.dr[op] = dr;
    a.dk[op] = dk;
    a.dw[op] = dw;
    __syncthreads();
    if (i < CW) {
      float s = rw[0][i];
      for (int ii = 1; ii < D; ++ii) s = __fadd_rn(s, rw[ii][i]);
      a.dv[oy + j0 + i] = s;
    }
  }
  a.du[((long long)cb * a.batch * a.heads + n) * D + i] = du;
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const long long grid = (long long)a.batch * a.heads * BwdCfg<D>::NCB;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  wkv_bwd_kernel<D><<<static_cast<unsigned>(grid), D, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The one C entry point: 0 on success, else a CUDA error code (the
// wrapper raises).  seq >= 1, batch and heads >= 1; state0 and state_out
// may be null (zero initial state; final state not written).  y must be
// 16-byte aligned (the wrapper allocates it).
extern "C" int wkv_launch(const float* r, const float* k, const float* v,
                          const float* w, const float* u,
                          const float* state0, float* y, float* state_out,
                          int batch, int seq, int heads, int d, int sb,
                          int ss, int sh, int ub, int uh,
                          cudaStream_t stream) {
  if (batch < 1 || seq < 1 || heads < 1 || batch > 65535 || heads > 65535
      || reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  Args a;
  a.s[0] = r;
  a.s[1] = k;
  a.s[2] = w;
  a.s[3] = v;
  a.u = u;
  a.state0 = state0;
  a.y = y;
  a.state_out = state_out;
  a.batch = batch;
  a.seq = seq;
  a.heads = heads;
  a.sb = sb;
  a.ss = ss;
  a.sh = sh;
  a.ub = ub;
  a.uh = uh;
  a.vec_state = aligned(state0) && aligned(state_out);
  a.vec_streams = aligned(r) && aligned(k) && aligned(v) && aligned(w)
                  && sb % 4 == 0 && ss % 4 == 0 && sh % 4 == 0;
  switch (d) {
    case 4:
      return (int)launch<4>(a, stream);
    case 8:
      return (int)launch<8>(a, stream);
    case 16:
      return (int)launch<16>(a, stream);
    case 64:
      return (int)launch<64>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The partial sums the backward writes for dr, dk, dw and du at head size
// d (its column blocks a head, BwdCfg<D>::NCB; 0 for a d it refuses): the
// wrapper sizes its buffers by this, so the layout is decided here alone.
extern "C" int wkv_bwd_parts(int d) {
  switch (d) {
    case 4:
      return BwdCfg<4>::NCB;
    case 8:
      return BwdCfg<8>::NCB;
    case 16:
      return BwdCfg<16>::NCB;
    case 64:
      return BwdCfg<64>::NCB;
    default:
      return 0;
  }
}

// The backward's C entry point: 0 on success, else a CUDA error code.
// Streams as wkv_launch's (shared element strides sb, ss, sh, D
// contiguous); u (H, D) and dy (B, S, H, D) contiguous; `states` a scratch
// of B H S D^2 floats, 16-byte aligned; dr, dk, dw written as NCB partial
// planes (NCB, B, S, H, D), du as (NCB, B, H, D), dv whole (B, S, H, D)
// (NCB = wkv_bwd_parts(d)).
extern "C" int wkv_bwd_launch(const float* r, const float* k, const float* v,
                              const float* w, const float* u,
                              const float* dy, float* states, float* dr,
                              float* dk, float* dv, float* dw, float* du,
                              int batch, int seq, int heads, int d, int sb,
                              int ss, int sh, cudaStream_t stream) {
  if (batch < 1 || seq < 1 || heads < 1
      || reinterpret_cast<uintptr_t>(states) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  BwdArgs a{r, k, v, w, u, dy, states, dr, dk, dv, dw, du, batch, seq,
            heads, sb, ss, sh};
  switch (d) {
    case 4:
      return (int)launch_bwd<4>(a, stream);
    case 8:
      return (int)launch_bwd<8>(a, stream);
    case 16:
      return (int)launch_bwd<16>(a, stream);
    case 64:
      return (int)launch_bwd<64>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
