// The fused GEMM's mm1 mode (w <= 8) for NVIDIA Hopper (sm_90a), dense and
// grouped: C = A . B on int8 codes, (M, K) x (K, N), both row-major,
// accumulated exactly in int32, with the optional dequant epilogue
// out = float(acc) * (sx[m] * sw[n]) (sx * sw rounded first) and an int32,
// fp32 or bf16 (round to nearest even) store.
//
// Replaces the TPU kernel `_fused_kernel` in src/repro/kernels/fused_gemm.py
// (line 119; entry point `fused_gemm`, line 395) in mode mm1, and its
// grouped entry `fused_gemm_grouped` (line 437 there): G independent GEMMs
// (G, M, K) x (G, K, N) -> (G, M, N), ragged with `counts` (G, S) and a
// static `seg`: row r of group g is live iff r / seg < S and
// r % seg < counts[g, r / seg].  Dead rows are exact zeros, and a block with
// no live row writes its zero tile without reading A or B.  The other modes
// (kmm2, mm2, kmm4) are fused_split.cu's.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8): at
// the serve path's row counts (decode M = 1-4 live lanes, expert GEMMs of
// 8-32 rows, prefill M <= 64) the product is bound by reading B once; the
// MMAs are idle most of the time.  At llama's K=8192 projection B is 16 MB,
// 5 us at the memory rate.  Reading it that fast takes ~3.35 MB in flight
// (3.35 TB/s x ~1 us of latency), about 25 KB on each of 132 SMs, and every
// SM busy.  The design does three things about it:
//
//   * Copies: 16-byte `cp.async.cg` copies of A and B tiles into a ring of
//     STAGES = 4 shared-memory stages (9.3 KB a stage at the 16-row tile,
//     13 KB at the 64-row one); the copies of the next three stages are in
//     flight while the MMAs run on the current one.  Rows that are not
//     16-byte aligned (K or N not a multiple of 16, or an unaligned base)
//     take plain byte loads into the same ring; ragged edges are
//     zero-filled (`cp.async` with a source size below 16).
//   * Exact split-K: where the tile grid cannot fill the card (every dense
//     decode projection but lm_head), the host plan (kernels/mm1_plan.py)
//     splits K across blocks in whole stages.  Each split writes its int32
//     partials to a workspace, and the last block to arrive on a tile (an
//     atomic counter after a __threadfence) adds the others' partials to
//     its own in int32, modulo 2^32, runs the epilogue, and sets the
//     tile's counter back to 0.  int32 addition modulo 2^32 is associative,
//     so the sum is complete and exact before the float cast, in any order
//     of arrival: the result is bit-identical to one pass.  One launch per
//     GEMM: no reduce kernel, no memset.  The workspace and counters belong
//     to the caller's stream (fused_gemm.py keeps one pair per stream).
//   * Tiles: a 16 x 128 tile through M = 64 (decode: one m16 MMA row
//     block, so no MMA rows are wasted on M <= 16; at the serve prefill
//     buckets its larger grid wins), 64 x 128 above; four warps,
//     each all the tile's rows of one 32-column span, so every B fragment
//     is built once a block, on s8 tensor cores
//     (`mma.sync.m16n8k32.s8.s8.s32`; A fragments by `ldmatrix`).
//
// Where the layout fights the MMA: B is N-contiguous, and s8 MMAs want
// K-contiguous fragments (`ldmatrix.trans` moves 16-bit elements only, and
// `wgmma` takes 8-bit operands only K-major).  B tiles are copied as they
// lie, (BK, BN) rows of 128 bytes, and each thread builds its fragments
// from 32-bit shared loads of 4 k-rows, transposed as 4x4 bytes with
// `__byte_perm`.  A thread's word holds 4 adjacent columns, so the four
// n8 MMAs of a 32-column span take columns 4c + j (j = 0..3) as MMA column
// c; the epilogue maps them back.  The 16-byte chunks of B row k are stored
// at chunk c ^ 2((k / 4) % 4), which makes those loads free of bank
// conflicts; A rows are padded to BK + 16 bytes for the same reason.
//
// Build: the whole file compiles into one library.  Built with
// -DFUSED_MM1_UNIT=u it compiles only unit u (0: the C entry points; 1: the
// 16-row tile, 2: the 64-row tile, each dense and grouped), so the units
// compile in parallel nvcc processes and link together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef FUSED_MM1_UNIT
#define MM1_UNIT(u) (FUSED_MM1_UNIT == (u))
#else
#define MM1_UNIT(u) 1
#endif

namespace fused_mm1_detail {

constexpr int BN = 128;              // output columns per block
constexpr int BK = 64;               // K depth of one stage
constexpr int STAGES = 4;            // shared-memory ring depth
constexpr int NTHREADS = 128;        // four warps
constexpr int A_PITCH = BK + 16;     // padded A row in shared memory (bytes)

enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

// Warp layout of a BM-row tile: warp w owns all BM rows (MT m16 row
// blocks) of the tile's 32-column span w, so each B fragment is built once
// per block; NACC int32 accumulators a thread.
template <int BM>
struct Tile {
  static constexpr int MT = BM / 16;
  static constexpr int NACC = MT * 16;
  static constexpr int A_STAGE = BM * A_PITCH;
  static constexpr int STAGE = A_STAGE + BK * BN;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(NACC * NTHREADS == BM * BN && BN == 32 * (NTHREADS / 32),
                "four warps of 32 columns cover the tile");
};

struct Params {
  const int8_t* a;     // (G, M, K) row-major
  const int8_t* b;     // (G, K, N) row-major
  const float* sx;     // (G, M) row scales, or null (no dequant)
  const float* sw;     // (G, N) column scales, or null
  void* out;           // (G, M, N) row-major
  const int* counts;   // (G, n_seg) live rows per segment, or null
  int* ws;             // split-K partials, or null without a split
  int* counters;       // arrival counter a tile, 0 between launches
  int M, K, N, seg, n_seg, split, k_split, out_kind, vec_a, vec_b;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
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
// shared memory at `dst`, with plain loads: the path for unaligned rows.
__device__ __forceinline__ void copy_bytes(int8_t* dst, const int8_t* src,
                                           int n) {
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

// Issue the copies of one stage: A rows [m0, m0 + BM) and B rows
// [k0, k0 + BK) of columns [n0, n0 + BN), zero beyond M, K and N.
template <int BM>
__device__ __forceinline__ void load_stage(const Params& p, const int8_t* A,
                                           const int8_t* B, int8_t* stage,
                                           int m0, int n0, int k0, int tid) {
  int8_t* a_s = stage;
  int8_t* b_s = stage + Tile<BM>::A_STAGE;
  constexpr int A_CHUNKS = BM * BK / 16;
  constexpr int B_CHUNKS = BK * BN / 16;
  for (int c = tid; c < A_CHUNKS; c += NTHREADS) {
    const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
    const int m = m0 + r, k = k0 + kc;
    const int n_ok = (m < p.M && k < p.K) ? min(16, p.K - k) : 0;
    const int8_t* src = n_ok ? A + static_cast<size_t>(m) * p.K + k : A;
    int8_t* dst = a_s + r * A_PITCH + kc;
    if (p.vec_a) {
      cp_async16(dst, src, n_ok);
    } else {
      copy_bytes(dst, src, n_ok);
    }
  }
#pragma unroll
  for (int i = 0; i < B_CHUNKS / NTHREADS; ++i) {
    const int c = tid + i * NTHREADS;
    const int r = c / (BN / 16), nc = c % (BN / 16);
    const int k = k0 + r, n = n0 + nc * 16;
    const int n_ok = (k < p.K && n < p.N) ? min(16, p.N - n) : 0;
    const int8_t* src = n_ok ? B + static_cast<size_t>(k) * p.N + n : B;
    int8_t* dst = b_s + r * BN + ((nc ^ (2 * ((r >> 2) & 3))) * 16);
    if (p.vec_b) {
      cp_async16(dst, src, n_ok);
    } else {
      copy_bytes(dst, src, n_ok);
    }
  }
}

// The A fragments of one m16 x k32 block: lane l addresses row
// (l % 8) + 8 ((l / 8) % 2), bytes 16 (l / 16) of its 16-byte half, so
// register q holds rows 8 (q % 2) + g, bytes 16 (q / 2) + 4t..4t+3.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4],
                                           const int8_t* row_ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four words w[i] = bytes of k-row i at columns j = 0..3, transposed so that
// out[j] holds column j's four k values (byte i = row i).
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

// The MMAs of one stage.  Thread (g, t) = (lane / 4, lane % 4) of warp
// `span`; acc[mt][j] is the m16n8 accumulator of row block mt whose MMA
// column c is tile column 32 span + 4c + j.
template <int BM>
__device__ __forceinline__ void mma_stage(const int8_t* stage, int span,
                                          int lane,
                                          int (&acc)[Tile<BM>::MT][4][4]) {
  using T = Tile<BM>;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* a_s = stage + ((lane & 7) + 8 * ((lane >> 3) & 1)) * A_PITCH
                      + 16 * (lane >> 4);
  const int8_t* b_s = stage + T::A_STAGE;
  // this thread's word of each k-row: logical chunk 2 span + g / 4, stored
  // at chunk ^ 2t (rows kk + 16h + 4t + i have (row / 4) % 4 = t)
  const int col = (((2 * span + (g >> 2)) ^ (2 * t)) * 16) + (g & 3) * 4;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t bf[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = ld32(b_s + (kk + 16 * h + 4 * t + i) * BN + col);
      }
      transpose4x4(w, bf[h]);
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      uint32_t af[4];
      ldmatrix_a(af, a_s + mt * 16 * A_PITCH + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], af, bf[0][j], bf[1][j]);
    }
  }
}

// Position of accumulator (mt, j, r) in a thread's partials: the
// workspace holds partial e of thread tid at e * NTHREADS + tid, so every
// block of a tile (same thread mapping) writes and reads it coalesced.
__device__ __forceinline__ int acc_index(int mt, int j, int r) {
  return (mt * 4 + j) * 4 + r;
}

// acc[e] += v modulo 2^32, e in acc_index order.
template <int MT>
__device__ __forceinline__ void add_wrapped(int (&acc)[MT][4][4], int e,
                                            int v) {
  int& a = acc[e / 16][(e / 4) % 4][e % 4];
  a = static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(v));
}

__device__ __forceinline__ void store_zero(const Params& p, void* out, int m,
                                           int n) {
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.out_kind == OUT_BF16) {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(0.f);
  } else if (p.out_kind == OUT_F32) {
    static_cast<float*>(out)[o] = 0.f;
  } else {
    static_cast<int*>(out)[o] = 0;
  }
}

__device__ __forceinline__ void store_val(const Params& p, void* out,
                                          const float* sx, const float* sw,
                                          int m, int n, int v) {
  const size_t o = static_cast<size_t>(m) * p.N + n;
  if (p.out_kind == OUT_I32) {       // the wrapper allows it without dequant
    static_cast<int*>(out)[o] = v;
    return;
  }
  float f = __int2float_rn(v);
  if (sx != nullptr) f = __fmul_rn(f, __fmul_rn(sx[m], sw[n]));
  if (p.out_kind == OUT_F32) {
    static_cast<float*>(out)[o] = f;
  } else {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(f);
  }
}

// One block: output tile (blockIdx.y, blockIdx.x % tiles_n) of group
// blockIdx.z over K split blockIdx.x / tiles_n.  GROUPED instantiates the
// grouped entry (its own name in a profile; the dense instance compiles
// the liveness test out).
template <int BM, bool GROUPED>
__global__ void __launch_bounds__(NTHREADS)
fused_mm1_kernel(const Params p) {
  using T = Tile<BM>;
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ int row_live[BM];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tn = blockIdx.x % tiles_n;
  const int sidx = blockIdx.x / tiles_n;
  const int m0 = blockIdx.y * BM, n0 = tn * BN;
  const size_t grp = blockIdx.z;
  const int tile = (static_cast<int>(grp) * gridDim.y + blockIdx.y) * tiles_n
                   + tn;

  const int8_t* A = p.a + grp * p.M * static_cast<size_t>(p.K);
  const int8_t* B = p.b + grp * p.K * static_cast<size_t>(p.N);
  const float* sx = p.sx != nullptr ? p.sx + grp * p.M : nullptr;
  const float* sw = p.sw != nullptr ? p.sw + grp * p.N : nullptr;
  void* out = static_cast<char*>(p.out)
      + grp * p.M * static_cast<size_t>(p.N)
      * (p.out_kind == OUT_BF16 ? 2 : 4);

  // Ragged liveness of this tile's rows (every row below M when dense).
  if (tid < BM) {
    const int r = m0 + tid;
    bool live = r < p.M;
    if (GROUPED && live && p.counts != nullptr) {
      const int s = r / p.seg;
      live = s < p.n_seg && r - s * p.seg < p.counts[grp * p.n_seg + s];
    }
    row_live[tid] = live;
  }
  if (!__syncthreads_or(tid < BM && row_live[tid])) {
    // No live row: split 0 writes the tile's exact zeros, nothing is read,
    // and no split touches the tile's counter.
    if (sidx == 0) {
      for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
        const int m = m0 + idx / BN, n = n0 + idx % BN;
        if (m < p.M && n < p.N) store_zero(p, out, m, n);
      }
    }
    return;
  }

  int acc[T::MT][4][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0;

  // This split's K range: whole stages, the last one ending at K.
  const int kb = sidx * p.k_split;
  const int ke = min(p.K, kb + p.k_split);
  const int n_st = ke > kb ? (ke - kb + BK - 1) / BK : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) {
      load_stage<BM>(p, A, B, smem + s * T::STAGE, m0, n0, kb + s * BK, tid);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_st; ++it) {
    // stage `it` has landed once at most STAGES - 2 groups are pending
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the slot every warp finished with in the previous iteration
    const int nxt = it + STAGES - 1;
    if (nxt < n_st) {
      load_stage<BM>(p, A, B, smem + (nxt % STAGES) * T::STAGE, m0, n0,
                     kb + nxt * BK, tid);
    }
    cp_async_commit();
    mma_stage<BM>(smem + (it % STAGES) * T::STAGE, warp, lane, acc);
  }
  cp_async_wait<0>();

  if (p.split > 1) {
    // Publish this split's partials, then count arrivals on the tile.
    int* mine = p.ws + (static_cast<size_t>(tile) * p.split + sidx)
                * T::NACC * NTHREADS + tid;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          mine[acc_index(mt, j, r) * NTHREADS] = acc[mt][j][r];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      is_last = atomicAdd(p.counters + tile, 1) == p.split - 1;
    }
    __syncthreads();
    if (!is_last) return;
    // The last block adds every other split's partials, modulo 2^32.  At
    // the 16-row tile the loads of four splits are in flight together (16
    // partials a thread each); the 64-row tile adds its 64 a thread one
    // split at a time, as its registers have no room for more.
    __threadfence();
    const int* base = p.ws + static_cast<size_t>(tile) * p.split * T::NACC
                      * NTHREADS + tid;
    if constexpr (T::MT == 1) {
      constexpr int BATCH = 4;
      for (int s0 = 0; s0 < p.split; s0 += BATCH) {
        int v[BATCH][T::NACC];
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int s = s0 + q;
          const bool other = s < p.split && s != sidx;
          const int* part = base + static_cast<size_t>(s) * T::NACC
                            * NTHREADS;
#pragma unroll
          for (int e = 0; e < T::NACC; ++e) {
            v[q][e] = other ? __ldcg(part + e * NTHREADS) : 0;
          }
        }
#pragma unroll
        for (int q = 0; q < BATCH; ++q)
#pragma unroll
          for (int e = 0; e < T::NACC; ++e) add_wrapped(acc, e, v[q][e]);
      }
    } else {
      for (int s = 0; s < p.split; ++s) {
        if (s == sidx) continue;
        const int* part = base + static_cast<size_t>(s) * T::NACC * NTHREADS;
#pragma unroll
        for (int e = 0; e < T::NACC; ++e) {
          add_wrapped(acc, e, __ldcg(part + e * NTHREADS));
        }
      }
    }
    if (tid == 0) p.counters[tile] = 0;   // ready for the next launch
  }

  // Epilogue: MMA column c of warp w's n8 block j is tile column
  // 32 w + 4c + j; register r holds row g + 8 (r / 2), column 2t + r % 2.
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = mt * 16 + g + 8 * (r >> 1);
        const int m = m0 + row;
        const int n = n0 + warp * 32 + 4 * (2 * t + (r & 1)) + j;
        if (m >= p.M || n >= p.N) continue;
        if (!row_live[row]) {
          store_zero(p, out, m, n);            // dead row: exact zero
        } else {
          store_val(p, out, sx, sw, m, n, acc[mt][j][r]);
        }
      }
}

// Launches one instance on `stream` without synchronising; returns
// cudaGetLastError().
template <int BM, bool GROUPED>
int launch_instance(const Params& p, int groups, cudaStream_t stream) {
  constexpr int smem = Tile<BM>::SMEM;
  if (smem > 48 * 1024) {            // above the default: opt in per device
    const cudaError_t err = cudaFuncSetAttribute(
        fused_mm1_kernel<BM, GROUPED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_n = (p.N + BN - 1) / BN;
  const dim3 grid(tiles_n * p.split, (p.M + BM - 1) / BM, groups);
  fused_mm1_kernel<BM, GROUPED><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One function per tile, each defined in its own build unit.
int launch_bm16(const Params& p, int groups, bool grouped, cudaStream_t s);
int launch_bm64(const Params& p, int groups, bool grouped, cudaStream_t s);

#if MM1_UNIT(1)
int launch_bm16(const Params& p, int groups, bool grouped, cudaStream_t s) {
  return grouped ? launch_instance<16, true>(p, groups, s)
                 : launch_instance<16, false>(p, groups, s);
}
#endif
#if MM1_UNIT(2)
int launch_bm64(const Params& p, int groups, bool grouped, cudaStream_t s) {
  return grouped ? launch_instance<64, true>(p, groups, s)
                 : launch_instance<64, false>(p, groups, s);
}
#endif

}  // namespace fused_mm1_detail

#if MM1_UNIT(0)
namespace {

using namespace fused_mm1_detail;

// Checks the plan (kernels/mm1_plan.py) and launches.  vec_a / vec_b ask
// for 16-byte copies; they are honoured only where every row of the
// operand is 16-byte aligned.
int launch(Params p, int groups, bool grouped, int bm, void* stream) {
  const long long tiles_m = (p.M + bm - 1) / (bm > 0 ? bm : 1);
  const long long tiles_n = (p.N + BN - 1) / BN;
  const bool split_ok = p.split == 1
      ? p.k_split >= p.K
      : (p.ws != nullptr && p.counters != nullptr && p.k_split > 0
         && p.k_split % BK == 0
         && static_cast<long long>(p.split - 1) * p.k_split < p.K
         && static_cast<long long>(p.split) * p.k_split >= p.K);
  if (groups < 1 || groups > 65535 || p.M < 1 || p.N < 1 || p.K < 0
      || (bm != 16 && bm != 64) || tiles_m > 65535 || p.split < 1
      || tiles_n * p.split > 0x7fffffffLL || !split_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.vec_a = p.vec_a && p.K % 16 == 0
            && reinterpret_cast<uintptr_t>(p.a) % 16 == 0;
  p.vec_b = p.vec_b && p.N % 16 == 0
            && reinterpret_cast<uintptr_t>(p.b) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm == 16 ? launch_bm16(p, groups, grouped, s)
                  : launch_bm64(p, groups, grouped, s);
}

Params make_params(const void* a, const void* b, const void* sx,
                   const void* sw, void* out, void* ws, void* counters,
                   int M, int K, int N, int split, int k_split, int vec_a,
                   int vec_b, int out_kind) {
  Params p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.out = out;
  p.counts = nullptr;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = M;
  p.K = K;
  p.N = N;
  p.seg = 1;
  p.n_seg = 0;
  p.split = split;
  p.k_split = k_split;
  p.out_kind = out_kind;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  return p;
}

}  // namespace

// Dense C entry point: (M, K) x (K, N) int8 -> (M, N); sx (M,) and sw (N,)
// or both null for no dequant; out_kind 0 = int32, 1 = float32,
// 2 = bfloat16.  bm, split and k_split come from the plan; ws holds
// tiles * split * bm * 128 int32 partials and counters one int32 a tile,
// zero on entry and on return (both may be null without a split).
extern "C" int fused_mm1_launch(const void* a, const void* b, const void* sx,
                                const void* sw, void* out, void* ws,
                                void* counters, int M, int K, int N, int bm,
                                int split, int k_split, int vec_a, int vec_b,
                                int out_kind, void* stream) {
  const Params p = make_params(a, b, sx, sw, out, ws, counters, M, K, N,
                               split, k_split, vec_a, vec_b, out_kind);
  return launch(p, 1, false, bm, stream);
}

// Grouped C entry point: (G, M, K) x (G, K, N) -> (G, M, N), contiguous;
// sx (G, M) and sw (G, N) or both null; counts (G, n_seg) int32 with a
// positive seg, or null for a dense grouped launch.
extern "C" int fused_mm1_grouped_launch(
    const void* a, const void* b, const void* sx, const void* sw,
    const void* counts, void* out, void* ws, void* counters, int G, int M,
    int K, int N, int seg, int n_seg, int bm, int split, int k_split,
    int vec_a, int vec_b, int out_kind, void* stream) {
  Params p = make_params(a, b, sx, sw, out, ws, counters, M, K, N, split,
                         k_split, vec_a, vec_b, out_kind);
  if (counts != nullptr) {
    if (seg <= 0 || n_seg <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.counts = static_cast<const int*>(counts);
    p.seg = seg;
    p.n_seg = n_seg;
  }
  return launch(p, G, true, bm, stream);
}
#endif
