// Decode-mode attention against a KV cache, for Hopper (sm_90a): the
// kernels, templated on the query type QT (float, bf16, f16) and the cache
// type KV (f32, int8 with f32 row scales, bf16, f16).  Each of
// decode_attention.cu (f32 queries), decode_attention_bf16.cu and
// decode_attention_f16.cu instantiates its query type's four pairs behind
// C entries of its own, so the three build in parallel.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py `_decode_kernel`
// (launched by `_decode_forward_pallas`).  For each (b, h) and each query
// row i < Tq it attends the cache positions kpos <= cache_len[b] + i (and
// < C) with an online softmax (running max, sum and accumulator in f32),
// and optionally writes the f32 row log-sum-exp.  The TPU kernel's
// numerics in every type: q and k widened to f32, scores in f32; for a
// float cache P rounded to v's type before P V, for an int8 cache P kept
// in f32 and v dequantized; the products summed in f32, the sum l from the
// f32 P; the output written in q's type once.  The cache stays in its own
// type in device memory (int8 dequantized, 16-bit widened, in registers or
// shared memory only).  Cache rows past cache_len + Tq are never read (NaN
// there in the tests).
//
// Two paths, picked by the caller's split plan (ops/attention.py
// `split_plan`):
//
// Split-K (flash-decoding), for d <= 256: a decode step, one launch.
// Grid (B*H, S, G) in clusters of (1, S, 1), S <= 8 (a portable
// cluster): block s takes cache positions [s L, (s+1) L) up to min(C,
// cache_len + the last row of its query group + 1).  A block holds at
// most 8 query rows (G = 1 for Tq <= 8; a longer chunk of a mixed pair, q's
// type other than the cache's, runs G groups of 8 rows).  Each block reads
// cache_len and issues its first K and V copies before it stages q, so no
// device-memory round trip sits before the cache's bytes move.  Its warps
// take tiles in turn through warp-private `cp.async` rings of 16-byte
// copies (4-byte, or bytes where the width or a pointer does not allow
// them), each warp with its own masked online softmax and accumulator:
//  - q and the cache of one 16-bit type (bf16 over bf16, f16 over f16, the
//    16-bit serving path's pair): tensor cores.  64-position tiles a warp;
//    S = Q K^T and O += P V on mma.sync.m16n8k16 with the query rows as a
//    register A fragment held for the whole split, K and V by ldmatrix
//    from unpadded rows whose 16-byte chunks are XOR-swizzled, the
//    softmax on the accumulators and P rounded to the cache's type packed
//    from them as the A fragment of P V (split_tiles16).  At d <= 64
//    4 warps x 64 positions cover a split of 256 in one tile a warp, so the
//    whole split is in flight after one wait; a second stage only where L
//    is longer.
//  - every other pair: CUDA cores (split_tiles).  32-position tiles, one
//    position a lane, two stages a warp; each lane dots its key row
//    (shared, row stride = 4 mod 32 words or 16 x odd bytes,
//    conflict-free) with the query rows (f32, broadcast reads); int8 keys
//    dequantized in registers and scaled once per dot, 16-bit keys widened
//    8 a 16-byte read; a position's probability shuffled from its lane
//    into P V, a lane owning columns lane + 32 i; an int8 value row's scale
//    folded into the probability, a 16-bit cache's probability rounded to
//    its type.  Their products would not be exact in one 16-bit MMA type.
// The block merges its warps in a fixed order in shared memory, into its
// split's (max, sum, unnormalized output) a query row; every other split
// pushes that partial into rank 0's shared memory through distributed
// shared memory and arrives on rank 0's mbarrier, and rank 0 merges the S
// splits in rank order and writes the output and the lse (merge_splits),
// so the same inputs give the same bits (no atomics, no scratch in device
// memory, no second launch).  The clusters launch under the
// load-balancing scheduling policy: under the default placement the
// decode step's 96 clusters of 4 ran 1.4x (bf16) to 1.6x (f32) slower
// (PERF.md).
//
// Prefill chunks (Tq > 8, or d > 256) where q and the cache share a float
// type, or the cache is int8 under f32 queries: flash_fwd.cuh's forward
// core with the causal diagonal offset by cache_len[b] and kv_end =
// min(C, cache_len + Tq): the f32 (3xTF32) kernels through an f32 or an
// int8 tile loader (int8 dequantized when the tile is split), or the
// 16-bit kernels (`flash_fwd16_kernel` on `wgmma` at d <= 64, WIDE
// above), whose products of two 16-bit values are exact in f32 as the TPU
// kernel's upcast products are.  A mixed pair has no chunk path: its
// chunks run split-K in query groups, and it takes d <= 256.
//
// What bounds it on an H100.  At Tq = 1 the work is memory-bound: per (b,
// h) it must read (cache_len + 1) * d * 2 cache elements, 4 B each in f32,
// 2 B in bf16 / f16, or 1 B plus a 4 B scale per position in int8, for 4
// (cache_len + 1) d flops.  Split-K puts B*H*S blocks on the 132 SMs: one
// block per (b, h) would leave 36 idle at 8 slots x 12 heads and walk each
// cache alone (S = 1: 0.066 ms against 0.028 ms for S = 4 on an H100 in
// f32, measured by tools/torch_decode_splits.py).  What is left is
// latency: a split's copies, its tiles' dependent chain and the merge.
// Prefill chunks are bounded by arithmetic.
#pragma once

#include <cooperative_groups.h>

#include "flash_fwd.cuh"

namespace {

enum { KV_BF16 = 2, KV_F16 = 3 };  // beside flash_fwd.cuh's KV_F32, KV_I8

template <int KV>
constexpr bool kKv16 = KV == KV_BF16 || KV == KV_F16;

// q and the cache of one 16-bit type: split-K on tensor cores
template <int KV, typename QT>
constexpr bool kMma16 =
    (KV == KV_BF16 && std::is_same<QT, __nv_bfloat16>::value) ||
    (KV == KV_F16 && std::is_same<QT, __half>::value);

constexpr int TQ_SPLIT = 8;    // the most query rows a split-K block takes
constexpr int TILE = 32;       // positions a warp takes at once, CUDA cores
constexpr int TILE16 = 64;     // and on tensor cores
constexpr int MAX_SPLITS = 8;  // a portable cluster's blocks

struct DecArgs {
  const void* q;          // (B, H, Tq, d) in QT
  const void* k;          // (B, H, C, d) in the cache's type
  const void* v;
  const float* k_scale;   // (B, H, C) scales of an int8 cache
  const float* v_scale;
  const int* cache_len;   // (B,)
  void* out;              // (B, H, Tq, d) in QT
  float* lse;             // (B, H, Tq), or null
  int H, Tq, C, d, L, S;
  float scale;
  int kv_mode;            // bytes a copy moves: 16 or 4 (f32); 16, 4, 1
                          // (int8, bf16, f16)
  int bar;                // split-K: the byte offset in shared memory of
                          // rank 0's mbarrier (merge_splits)
};

// ------------------------------------------------------------ types
template <typename T>
__device__ __forceinline__ float f32_of(T x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else if constexpr (std::is_same<T, __half>::value)
    return __half2float(x);
  else
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T of_f32(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(x);
  else
    return __float2bfloat16_rn(x);
}

// A 16-bit cache value (its bits) as f32, exactly.
template <int KV>
__device__ __forceinline__ float kv_f32(uint16_t x) {
  if constexpr (KV == KV_F16)
    return __half2float(__ushort_as_half(x));
  else
    return __uint_as_float((uint32_t)x << 16);
}

// The probability P V multiplies: rounded to a 16-bit cache's type (the
// TPU kernel's `p.astype(v.dtype)`), f32 for an f32 cache.
template <int KV>
__device__ __forceinline__ float p_for_v(float p) {
  if constexpr (KV == KV_F16)
    return __half2float(__float2half_rn(p));
  else if constexpr (KV == KV_BF16)
    return __bfloat162float(__float2bfloat16_rn(p));
  else
    return p;
}

// Eight 16-bit values of one 16-byte read, widened to f32.
template <int KV>
__device__ __forceinline__ void widen8(const uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (KV == KV_F16) {
      const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[e]));
      f[2 * e] = h.x;
      f[2 * e + 1] = h.y;
    } else {
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

// ------------------------------------------------------------ tiles
// Widths of a row: d padded to dpk (8 in f32 and 16-bit; 16 in int8, one
// 16-byte read a step), and the shared row stride in bytes.
template <int KV>
__host__ __device__ inline int dec_dpk(int d) {
  return KV == KV_I8 ? (d + 15) & ~15 : (d + 7) & ~7;
}

template <int KV>
__host__ __device__ inline int dec_rs(int dpk) {
  return KV == KV_I8    ? 16 * ((dpk >> 4) | 1)
         : kKv16<KV> ? 16 * ((dpk >> 3) | 1)
                     : 4 * (dpk + 4);
}

template <int KV>
__host__ __device__ inline int dec_stage(int rs) {
  return 2 * TILE * rs + (KV == KV_I8 ? 2 * TILE * 4 : 0);
}

template <int KV>
__device__ __forceinline__ const void* dec_rows_at(const void* p,
                                                   size_t off) {
  if constexpr (kKv16<KV>)
    return static_cast<const uint16_t*>(p) + off;
  else
    return rows_at<KV>(p, off);
}

// TILE cache rows from row0 (zero at or past `valid`) into a warp's
// stage: f32 rows at stride rs bytes, int8 bytes with their scales, or a
// 16-bit row's 2 d bytes as bytes.
template <int KV>
__device__ __forceinline__ void dec_rows(char* dst, float* dsc,
                                         const void* src, const float* sc,
                                         int row0, int valid, int d, int dpk,
                                         int rs, int mode, int lane) {
  if constexpr (kKv16<KV>)
    load_tile_i8<TILE, 32>(reinterpret_cast<int8_t*>(dst),
                           static_cast<const int8_t*>(src), row0, valid,
                           2 * d, 0, 2 * d, 2 * dpk, rs, mode, lane);
  else
    stage_rows<TILE, 32, KV>(dst, dsc, src, sc, row0, valid, d, 0, d, dpk,
                             rs / 4, rs, mode, lane);
}

// ------------------------------------------------------------ merges
// The merge's scratch, in floats, in the ring's memory once the tiles are
// done.  The block's partial (pM, pL, pA) is one run of tq (d + 2) floats,
// as merge_splits moves it.
struct MergeArea {
  float *wm, *wl;  // [nw][tq]: each warp's max and sum
  float* wa;       // [nw][tq][wd]: each warp's unnormalized output
  float *pM, *pL;  // [tq]: the block's (the split's) max and sum
  float* pA;       // [tq][d]: its unnormalized output
};

__host__ __device__ inline size_t merge_floats(int nw, int tq, int wd,
                                               int d) {
  return (size_t)nw * tq * (wd + 2) + (size_t)tq * (d + 2);
}

__device__ __forceinline__ MergeArea merge_area(float* base, int nw, int tq,
                                                int wd) {
  MergeArea g;
  g.wm = base;
  g.wl = g.wm + nw * tq;
  g.wa = g.wl + nw * tq;
  g.pM = g.wa + nw * tq * wd;
  g.pL = g.pM + tq;
  g.pA = g.pL + tq;
  return g;
}

// The split's (max, sum, unnormalized output) a query row from its warps'
// (wm, wl, wa, written by the tile loops), merged in warp order: weights
// exp(m_w - M), 0 for a warp with max -inf (no position of the row).
// Each thread takes its (row, column)s whole, the row's weights included,
// so one barrier suffices.
__device__ __forceinline__ void merge_warps(const MergeArea& g, int nw, int tq,
                                            int wd, int d) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  for (int i = tid; i < tq * d; i += nt) {
    const int r = i / d, c = i - r * d;
    float M = -INFINITY;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, g.wm[w * tq + r]);
    float Ls = 0.f, A = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float mw = g.wm[w * tq + r];
      const float f = mw == -INFINITY ? 0.f : expf(mw - M);
      Ls = fmaf(g.wl[w * tq + r], f, Ls);
      A = fmaf(g.wa[(w * tq + r) * wd + c], f, A);
    }
    g.pA[i] = A;
    if (c == 0) {
      g.pM[r] = M;
      g.pL[r] = Ls;
    }
  }
}

// ------------------------------------------------- cluster primitives
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// An mbarrier in this block's shared memory that `count` arrivals from
// the cluster complete; its initialization released to the cluster.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, releasing this thread's earlier writes to the cluster, on
// the mbarrier at `bar`'s offset in the shared memory of block `rank`.
__device__ __forceinline__ void mbar_arrive_remote(const uint64_t* bar,
                                                   unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// Wait (acquire, cluster scope) for phase `parity` of a local mbarrier.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar,
                                          unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// The S splits of one (b, h, query group) are one cluster (1, S, 1), and
// rank 0 merges them.  Every block arrives on the cluster barrier once its
// tiles are read (rank 0's mailbox is its ring; rank 0 initialized its
// mbarrier before), merges its warps and waits on the barrier.  Then
// every other block pushes its split's partial
// (max, sum, unnormalized output: tq (d + 2) floats) into its slot of
// rank 0's mailbox through distributed shared memory, arrives on rank 0's
// mbarrier (each thread once, releasing its own stores) and exits.  Rank 0
// waits only for those pushes, takes its own partial in place and each
// thread its (row, column)'s values of every split, summed in rank order:
// weights exp(m_s - M), 0 for a split with max -inf (no position of the
// row in it), whose sum and output are not used.  The same inputs give
// the same bits, whatever the schedule.
template <typename QT>
__device__ __forceinline__ void merge_splits(const MergeArea& g,
                                             const DecArgs& a, float* box,
                                             uint64_t* bar, int bh, int r0,
                                             int tq) {
  namespace cg = cooperative_groups;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int S = a.S, d = a.d, part = tq * (d + 2);
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  __syncthreads();  // the block's partial is complete
  cluster_wait();   // every ring is read; rank 0's mbarrier initialized
  if (rank != 0) {
    float* slot = cl.map_shared_rank(box, 0) + (rank - 1) * part;
    for (int i = tid; i < part; i += nt) slot[i] = g.pM[i];
    mbar_arrive_remote(bar, 0);
    return;
  }
  if (S > 1) mbar_wait(bar, 0);
  QT* ob = static_cast<QT*>(a.out) + ((size_t)bh * a.Tq + r0) * d;
  for (int i = tid; i < tq * d; i += nt) {
    const int r = i / d;
    float ms[MAX_SPLITS], ls[MAX_SPLITS], x[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      const float* p = s == 0 ? g.pM : box + (s - 1) * part;
      const bool in = s < S;
      ms[s] = in ? p[r] : -INFINITY;
      ls[s] = in ? p[tq + r] : 0.f;
      x[s] = in ? p[2 * tq + i] : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) M = fmaxf(M, ms[s]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s >= S) break;
      const bool live = ms[s] != -INFINITY;
      const float w = live ? expf(ms[s] - M) : 0.f;
      Ls = fmaf(live ? ls[s] : 0.f, w, Ls);
      if (w != 0.f) A = fmaf(x[s], w, A);
    }
    ob[i] = of_f32<QT>(Ls == 0.f ? 0.f : A / Ls);
    if (a.lse != nullptr && i == r * d)
      a.lse[(size_t)bh * a.Tq + r0 + r] =
          Ls == 0.f ? -INFINITY : M + logf(Ls);
  }
}

// ------------------------------------------------- tiles on CUDA cores
// The split's positions [p0, p1) for every pair but the same-type 16-bit
// ones: 32-position tiles a warp, one position a lane; each warp's (max,
// sum, output) a query row into the merge area.
template <int NCOL, int KV, typename QT>
__device__ __forceinline__ void split_tiles(const DecArgs& a, float* smem,
                                            const MergeArea& g, int bh,
                                            int r0, int tq, int len, int p0,
                                            int p1) {
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int Tq = a.Tq, d = a.d;
  const int dpk = dec_dpk<KV>(d);
  const int rs = dec_rs<KV>(dpk);
  const int sb = dec_stage<KV>(rs);
  float* sq = smem;  // tq x dpk query rows in f32, zero past d
  char* ring = reinterpret_cast<char*>(sq + tq * dpk);
  char* mine = ring + (size_t)warp * 2 * sb;

  const size_t koff = (size_t)bh * a.C;
  const void* kb = dec_rows_at<KV>(a.k, koff * d);
  const void* vb = dec_rows_at<KV>(a.v, koff * d);
  const float* ksb = KV == KV_I8 ? a.k_scale + koff : nullptr;
  const float* vsb = KV == KV_I8 ? a.v_scale + koff : nullptr;
  const int ntile = (p1 - p0 + TILE - 1) / TILE;

  // tile tt of the split into stage `st`: K rows, V rows, their scales
  auto fetch = [&](int tt, int st) {
    char* s = mine + st * sb;
    float* sc = reinterpret_cast<float*>(s + 2 * TILE * rs);
    const int t0 = p0 + tt * TILE;
    dec_rows<KV>(s, sc, kb, ksb, t0, p1, d, dpk, rs, a.kv_mode, lane);
    dec_rows<KV>(s + TILE * rs, sc + TILE, vb, vsb, t0, p1, d, dpk, rs,
                 a.kv_mode, lane);
  };

  // the cache copies first, then the query rows behind them
  int tt = warp;
  if (tt < ntile) fetch(tt, 0);
  cp_commit();
  if (tt + nw < ntile) fetch(tt + nw, 1);
  cp_commit();
  const QT* qb = static_cast<const QT*>(a.q) + ((size_t)bh * Tq + r0) * d;
  for (int i = tid; i < tq * dpk; i += nt) {
    const int r = i / dpk, c = i - r * dpk;
    sq[i] = c < d ? f32_of(qb[(size_t)r * d + c]) : 0.f;
  }

  float m[TQ_SPLIT], l[TQ_SPLIT], acc[TQ_SPLIT][NCOL];
#pragma unroll
  for (int r = 0; r < TQ_SPLIT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) acc[r][i] = 0.f;
  }

  __syncthreads();  // the query rows are in place
  for (int st = 0; tt < ntile; tt += nw, st ^= 1) {
    cp_wait<1>();
    __syncwarp();  // every lane's copies (and byte stores) of the stage
    const char* s = mine + st * sb;
    const float* sc = reinterpret_cast<const float*>(s + 2 * TILE * rs);
    const int t0 = p0 + tt * TILE;
    const int key = t0 + lane;  // this lane's position

    // four partial dots a row (the columns' residues mod 4): a dependent
    // chain of d / 4 FMAs, not d
    float4 xp[TQ_SPLIT];
#pragma unroll
    for (int r = 0; r < TQ_SPLIT; ++r) xp[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (KV == KV_F32) {
      const float* kr = reinterpret_cast<const float*>(s) + lane * (rs / 4);
#pragma unroll 4
      for (int c = 0; c < dpk; c += 4) {
        const float4 kx = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int r = 0; r < TQ_SPLIT; ++r) {
          if (r >= tq) break;
          const float4 qx = *reinterpret_cast<const float4*>(sq + r * dpk + c);
          xp[r].x = fmaf(qx.x, kx.x, xp[r].x);
          xp[r].y = fmaf(qx.y, kx.y, xp[r].y);
          xp[r].z = fmaf(qx.z, kx.z, xp[r].z);
          xp[r].w = fmaf(qx.w, kx.w, xp[r].w);
        }
      }
    } else if (KV == KV_I8) {
      const int8_t* kr = reinterpret_cast<const int8_t*>(s) + lane * rs;
#pragma unroll 2
      for (int c = 0; c < dpk; c += 16) {
        const int4 raw = *reinterpret_cast<const int4*>(kr + c);
        const int w4[4] = {raw.x, raw.y, raw.z, raw.w};
        float kf[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          kf[e] = (float)(int8_t)((w4[e >> 2] >> (8 * (e & 3))) & 0xff);
#pragma unroll
        for (int r = 0; r < TQ_SPLIT; ++r) {
          if (r >= tq) break;
#pragma unroll
          for (int e = 0; e < 16; e += 4) {
            const float4 qx =
                *reinterpret_cast<const float4*>(sq + r * dpk + c + e);
            xp[r].x = fmaf(qx.x, kf[e], xp[r].x);
            xp[r].y = fmaf(qx.y, kf[e + 1], xp[r].y);
            xp[r].z = fmaf(qx.z, kf[e + 2], xp[r].z);
            xp[r].w = fmaf(qx.w, kf[e + 3], xp[r].w);
          }
        }
      }
    } else {
      const char* kr = s + lane * rs;
#pragma unroll 2
      for (int c = 0; c < dpk; c += 8) {
        float kf[8];
        widen8<KV>(*reinterpret_cast<const uint4*>(kr + 2 * c), kf);
#pragma unroll
        for (int r = 0; r < TQ_SPLIT; ++r) {
          if (r >= tq) break;
#pragma unroll
          for (int e = 0; e < 8; e += 4) {
            const float4 qx =
                *reinterpret_cast<const float4*>(sq + r * dpk + c + e);
            xp[r].x = fmaf(qx.x, kf[e], xp[r].x);
            xp[r].y = fmaf(qx.y, kf[e + 1], xp[r].y);
            xp[r].z = fmaf(qx.z, kf[e + 2], xp[r].z);
            xp[r].w = fmaf(qx.w, kf[e + 3], xp[r].w);
          }
        }
      }
    }
    float x[TQ_SPLIT];
#pragma unroll
    for (int r = 0; r < TQ_SPLIT; ++r)
      x[r] = (xp[r].x + xp[r].y) + (xp[r].z + xp[r].w);
    if (KV == KV_I8) {
      const float ks = sc[lane];
#pragma unroll
      for (int r = 0; r < TQ_SPLIT; ++r) x[r] *= ks;
    }
    const float vs = KV == KV_I8 ? sc[TILE + lane] : 1.f;

    // the masked online-softmax update, row by row across the warp
    float pw[TQ_SPLIT];  // p as P V takes it: times the value row's scale
                         // (int8), rounded to the cache's type (16-bit)
#pragma unroll
    for (int r = 0; r < TQ_SPLIT; ++r) {
      pw[r] = 0.f;
      if (r >= tq) break;
      const bool live = key < p1 && key <= len + r0 + r;
      const float xs = live ? x[r] * a.scale : -INFINITY;
      float mx = xs;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float z = mn == -INFINITY ? 0.f : mn;
      const float p = xs == -INFINITY ? 0.f : expf(xs - z);
      const float corr = m[r] == -INFINITY ? 0.f : expf(m[r] - z);
      m[r] = mn;
      l[r] = l[r] * corr + p;
#pragma unroll
      for (int i = 0; i < NCOL; ++i) acc[r][i] *= corr;
      pw[r] = KV == KV_I8 ? p * vs : p_for_v<KV>(p);
    }

    // acc += p V over the tile's positions in the split (unrolled, so
    // the reads and shuffles of later positions overlap the FMAs)
    const int jn = min(TILE, p1 - t0);
#pragma unroll 8
    for (int j = 0; j < jn; ++j) {
      const char* vrow = s + TILE * rs + j * rs;
      float vx[NCOL];
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        const int c = lane + 32 * i;
        if (KV == KV_F32)
          vx[i] = c < dpk ? reinterpret_cast<const float*>(vrow)[c] : 0.f;
        else if (KV == KV_I8)
          vx[i] = c < dpk ? (float)reinterpret_cast<const int8_t*>(vrow)[c]
                          : 0.f;
        else
          vx[i] = c < dpk ? kv_f32<KV>(
                                reinterpret_cast<const uint16_t*>(vrow)[c])
                          : 0.f;
      }
#pragma unroll
      for (int r = 0; r < TQ_SPLIT; ++r) {
        if (r >= tq) break;
        const float pj = __shfl_sync(0xffffffffu, pw[r], j);
#pragma unroll
        for (int i = 0; i < NCOL; ++i) acc[r][i] = fmaf(pj, vx[i], acc[r][i]);
      }
    }
    __syncwarp();  // every lane is done reading the stage
    if (tt + 2 * nw < ntile) fetch(tt + 2 * nw, st);
    cp_commit();
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < TQ_SPLIT; ++r) {
    if (r >= tq) break;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  }

  __syncthreads();  // the merge area is the ring's memory
  // (constant indices only: a runtime index would put m, l and acc in
  // local memory)
#pragma unroll
  for (int r = 0; r < TQ_SPLIT; ++r) {
    if (r >= tq) break;
    if (lane == 0) {
      g.wm[warp * tq + r] = m[r];
      g.wl[warp * tq + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NCOL; ++i) {
      const int c = lane + 32 * i;
      if (c < dpk) g.wa[(warp * tq + r) * dpk + c] = acc[r][i];
    }
  }
}

// ----------------------------------------------- tiles on tensor cores
// q and the cache of one 16-bit type T: 64-position tiles a warp, S = Q
// K^T and O += P V on mma.sync.m16n8k16 with f32 accumulators.  Rows of
// DK = max(64, 32 NCOL) columns (zero past d), 2 DK bytes with no
// padding: the 16-byte chunk c of row r is stored at chunk c ^ (r & 7), so
// ldmatrix's eight rows at one chunk fall on eight distinct 16-byte bank
// groups, in 1/9 less shared memory at d = 64 than rows padded to 16 x
// odd bytes.
template <int NCOL>
constexpr int kDk16 = 32 * NCOL < 64 ? 64 : 32 * NCOL;

__host__ __device__ inline int dec16_stage(int dk) {
  return 2 * TILE16 * 2 * dk;  // 64 K rows, then 64 V rows
}
// Stages of a warp's ring: one where the warps' first tiles cover a split
// (L <= 4 x 64 at d <= 64), two otherwise.
__host__ __device__ inline int dec16_stages(int L, int nw) {
  return L > nw * TILE16 ? 2 : 1;
}

// Rows [row0, row0 + 64) of a 16-bit matrix (2 d bytes a row) into a
// swizzled tile of DK columns, zero past d and at or past `valid`: `mode`
// bytes a copy (kv_mode: 16, 4, or 1, a plain load and store visible
// after the next __syncwarp).
template <int DK>
__device__ __forceinline__ void load_rows16(char* dst, const int8_t* src,
                                            int row0, int valid, int d,
                                            int mode, int lane) {
  constexpr int LRB = DK == 64 ? 7 : DK == 128 ? 8 : 9;  // log2(2 DK)
  const int lm = mode == 16 ? 4 : mode == 4 ? 2 : 0;     // log2(mode)
  const int lc = LRB - lm, nb = 2 * d;                  // log2(copies a row)
  for (int i = lane; i < TILE16 << lc; i += 32) {
    const int r = i >> lc, b = (i & ((1 << lc) - 1)) << lm;
    const bool ok = row0 + r < valid && b < nb;
    const int8_t* from = ok ? src + (size_t)(row0 + r) * nb + b : src;
    char* to = dst + (r << LRB) + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
    if (mode == 16)
      cp16(to, from, ok);
    else if (mode == 4)
      cp4(to, from, ok);
    else
      *to = ok ? *from : (int8_t)0;
  }
}

// The query rows (<= 8, zero-padded to the MMA's 16) are the A fragment,
// held in registers for the whole split: lane (g, t) holds row g's columns
// 16 ks + 2t.. and 16 ks + 8 + 2t.. (rows g + 8 are zero registers).  K
// comes by ldmatrix as B; the scores' accumulators (row g, keys 8j + 2t,
// 8j + 2t + 1) take the online softmax, each row's max and sum across the
// quad by two shuffles; P, rounded to T (the TPU kernel's
// `p.astype(v.dtype)`), is packed from them as the A fragment of O += P V
// (FlashAttention-2's reuse of registers) and V comes by transposed
// ldmatrix.  Products of two 16-bit values are exact in f32, as the TPU
// kernel's upcast products are; the sum l is taken from the f32 P.
template <int NCOL, typename T>
__device__ __forceinline__ void split_tiles16(const DecArgs& a, char* ring,
                                              const MergeArea& g, int bh,
                                              int r0, int tq, int len, int p0,
                                              int p1) {
  constexpr int DK = kDk16<NCOL>, NKS = DK / 16, NJ = DK / 8, RB = 2 * DK;
  const int tid = threadIdx.x, nw = blockDim.x >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int d = a.d, sb = dec16_stage(DK);
  char* mine = ring + (size_t)warp * dec16_stages(a.L, nw) * sb;
  const size_t koff = (size_t)bh * a.C * d;
  const int8_t* kb = reinterpret_cast<const int8_t*>(
      static_cast<const uint16_t*>(a.k) + koff);
  const int8_t* vb = reinterpret_cast<const int8_t*>(
      static_cast<const uint16_t*>(a.v) + koff);
  const int ntile = (p1 - p0 + TILE16 - 1) / TILE16;

  // tile tt of the split into stage `st`, 64 K rows and 64 V rows, each
  // its own commit group: S runs while V lands
  auto fetch = [&](int tt, int st) {
    char* s = mine + st * sb;
    const int t0 = p0 + tt * TILE16;
    if (tt < ntile) load_rows16<DK>(s, kb, t0, p1, d, a.kv_mode, lane);
    cp_commit();
    if (tt < ntile)
      load_rows16<DK>(s + TILE16 * RB, vb, t0, p1, d, a.kv_mode, lane);
    cp_commit();
  };

  // the cache copies first (four groups in flight: K, V of a warp's tile
  // and of its next), then the query fragment behind them
  int tt = warp;
  fetch(tt, 0);
  fetch(tt + nw, 1);
  uint32_t qa[NKS][2];
  {
    const bool row = gr < tq;
    const uint16_t* qr = static_cast<const uint16_t*>(a.q) +
                         ((size_t)bh * a.Tq + r0 + (row ? gr : 0)) * d;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 16 * ks + 8 * h + 2 * t;
        const uint32_t lo = row && c < d ? qr[c] : 0u;
        const uint32_t hi = row && c + 1 < d ? qr[c + 1] : 0u;
        qa[ks][h] = lo | hi << 16;
      }
  }

  float m = -INFINITY, l = 0.f, o[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int lim = gr < tq ? len + r0 + gr : -1;  // row gr's last position
  // this lane's ldmatrix row address in a tile: K rows (lane & 7) + 8
  // (lane >> 4) and chunk (lane >> 3) & 1 of a 16-deep step; V rows
  // (lane & 7) + (lane & 8) and chunk lane >> 4 of a 16-column pair; every
  // row the lane reads is lane & 7 mod 8, the chunk's swizzle
  const int sw = lane & 7;
  const int krow = ((lane & 7) + ((lane >> 4) << 3)) * RB, kc = (lane >> 3) & 1;
  const int vrow = ((lane & 7) + (lane & 8)) * RB, vc = lane >> 4;
  for (int st = 0; tt < ntile; tt += nw, st ^= 1) {
    cp_wait<3>();
    __syncwarp();  // every lane's K copies (and byte stores) of the stage
    const char* sk = mine + st * sb;
    const char* sv = sk + TILE16 * RB;
    const int t0 = p0 + tt * TILE16;

    // S = Q K^T: eight 8-key tiles, K fragments two tiles an ldmatrix
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const uint32_t af[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[4];
        ldsm_x4(bf, reinterpret_cast<const uint16_t*>(
                        sk + krow + j * 16 * RB + (((2 * ks + kc) ^ sw) << 4)));
        mma16<T>(s[2 * j], af, bf[0], bf[1]);
        mma16<T>(s[2 * j + 1], af, bf[2], bf[3]);
      }
    }

    // the masked online-softmax update of row gr on its accumulators
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t0 + 8 * j + 2 * t + e;
        s[j][e] = key < p1 && key <= lim ? s[j][e] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[j][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float z = mn == -INFINITY ? 0.f : mn;
    const float corr = m == -INFINITY ? 0.f : expf(m - z);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - z);
        ps += s[j][e];
      }
    m = mn;
    l = l * corr + ps;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      o[n][0] *= corr;
      o[n][1] *= corr;
    }

    // O += P V over four 16-key chunks, V fragments two column tiles an
    // ldmatrix
    cp_wait<2>();
    __syncwarp();  // and its V copies
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t pa[4] = {pack16<T>(s[2 * i][0], s[2 * i][1]), 0u,
                              pack16<T>(s[2 * i + 1][0], s[2 * i + 1][1]),
                              0u};
#pragma unroll
      for (int mm = 0; mm < NJ / 2; ++mm) {
        uint32_t r[4];
        ldsm_x4_t(r, reinterpret_cast<const uint16_t*>(
                         sv + vrow + 16 * i * RB + (((2 * mm + vc) ^ sw) << 4)));
        mma16<T>(o[2 * mm], pa, r[0], r[1]);
        mma16<T>(o[2 * mm + 1], pa, r[2], r[3]);
      }
    }
    __syncwarp();  // every lane is done reading the stage
    fetch(tt + 2 * nw, st);
  }
  cp_wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  __syncthreads();  // the merge area is the ring's memory
  if (gr < tq) {
    if (t == 0) {
      g.wm[warp * tq + gr] = m;
      g.wl[warp * tq + gr] = l;
    }
    float* wa = g.wa + (warp * tq + gr) * DK + 2 * t;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      wa[8 * n] = o[n][0];
      wa[8 * n + 1] = o[n][1];
    }
  }
}

// Grid (B*H, S, G), clusters (1, S, 1): block (bh, s, z) takes query rows
// [8z, 8z + 8) and cache positions [s L, (s+1) L) up to min(C, cache_len
// + its last row + 1).  A split wholly past that skips its tiles and
// still pushes its partial, with weight 0 (max -inf).
template <int NCOL, int KV, typename QT>
__global__ void __launch_bounds__(128) decode_split_kernel(const DecArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int nw = blockDim.x >> 5;
  const int bh = blockIdx.x, sp = blockIdx.y;
  const int d = a.d;
  const int r0 = TQ_SPLIT * blockIdx.z;       // this block's first query row
  const int tq = min(TQ_SPLIT, a.Tq - r0);    // and its rows
  const int len = max(0, a.cache_len[bh / a.H]);
  const int kv_end = min(a.C, len + r0 + tq);
  const int p0 = sp * a.L;
  const int p1 = min(p0 + a.L, kv_end);
  constexpr bool mma = kMma16<KV, QT>;
  // a warp's output row in the merge area; the ring (and the merge area
  // in its memory) after the f32 query rows on CUDA cores
  const int wd = mma ? kDk16<NCOL> : dec_dpk<KV>(d);
  float* work = mma ? smem : smem + tq * dec_dpk<KV>(d);
  const MergeArea g = merge_area(work, nw, tq, wd);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(smem) + a.bar);
  // rank 0's mailbox: its ring after its merge area, pushed into once every
  // ring of the cluster is read (a mailbox of its own would cost a block an
  // SM at longer chunks, and measured no faster at the decode shape)
  float* box = g.pA + tq * d;
  if (blockIdx.y == 0 && threadIdx.x == 0 && a.S > 1)
    mbar_init(bar, (unsigned)(a.S - 1) * blockDim.x);
  if (p0 < p1) {
    if constexpr (mma)
      split_tiles16<NCOL, QT>(a, reinterpret_cast<char*>(work), g, bh, r0,
                              tq, len, p0, p1);
    else
      split_tiles<NCOL, KV, QT>(a, smem, g, bh, r0, tq, len, p0, p1);
  }
  cluster_arrive();  // this block's ring is read
  if (p0 < p1)
    merge_warps(g, nw, tq, wd, d);
  else if (threadIdx.x < tq)
    g.pM[threadIdx.x] = -INFINITY;
  merge_splits<QT>(g, a, box, bar, bh, r0, tq);
}

template <int NCOL, int KV, typename QT>
int launch_split(DecArgs a, int B, cudaStream_t st) {
  const int tq = a.Tq < TQ_SPLIT ? a.Tq : TQ_SPLIT;
  int nw, wd;
  size_t lead, ring;
  if constexpr (kMma16<KV, QT>) {
    // 4 warps x one 64-row K and V tile each at d <= 64 (65,536 bytes a
    // block: three blocks an SM); fewer warps at wider rows
    constexpr int DK = kDk16<NCOL>;
    nw = DK <= 64 ? 4 : DK <= 128 ? 2 : 1;
    wd = DK;
    lead = 0;
    ring = (size_t)nw * dec16_stages(a.L, nw) * dec16_stage(DK);
  } else {
    // warps a block: f32 rings are large (two stages of 32 K and V rows
    // a warp), so fewer warps and more blocks an SM at wide rows; 16-bit
    // rings are half their size
    const int dpk = dec_dpk<KV>(a.d);
    nw = KV == KV_I8    ? 4
         : KV == KV_F32 ? (dpk <= 104 ? 2 : 1)
                        : (dpk <= 64 ? 4 : dpk <= 128 ? 2 : 1);
    wd = dpk;
    lead = 4 * (size_t)tq * dpk;
    ring = (size_t)nw * 2 * dec_stage<KV>(dec_rs<KV>(dpk));
  }
  // the merge area and rank 0's mailbox in the ring's memory, then the
  // mbarrier
  const size_t merge = 4 * (merge_floats(nw, tq, wd, a.d) +
                            (size_t)(a.S - 1) * tq * (a.d + 2));
  const size_t bar = (lead + (ring > merge ? ring : merge) + 15) & ~(size_t)15;
  const size_t smem = bar + 16;
  a.bar = (int)bar;
  auto kern = decode_split_kernel<NCOL, KV, QT>;
  static int done[64] = {};
  int e = set_smem(kern, smem, done);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * a.H), (unsigned)a.S,
                     (unsigned)((a.Tq + TQ_SPLIT - 1) / TQ_SPLIT));
  cfg.blockDim = dim3((unsigned)(32 * nw));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  // the splits of one (b, h, query group) one cluster, placed by the
  // load-balancing policy (the header note)
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = (unsigned)a.S;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  at[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  e = (int)cudaLaunchKernelEx(&cfg, kern, a);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// The chunk path of a pair that has one (header): f32 queries over an f32
// or int8 cache on the f32 core, 16-bit queries over a cache of their
// type on the 16-bit core; a mixed pair has none.
template <int KV, typename QT>
int launch_chunk(const DecArgs& a, int B, cudaStream_t st) {
  if constexpr (std::is_same<QT, float>::value &&
                (KV == KV_F32 || KV == KV_I8)) {
    FwdArgs f;
    f.q = static_cast<const float*>(a.q);
    f.k = a.k;
    f.v = a.v;
    f.k_scale = a.k_scale;
    f.v_scale = a.v_scale;
    f.kv_len = nullptr;
    f.q_off = a.cache_len;
    f.out = static_cast<float*>(a.out);
    f.lse = a.lse;
    f.H = a.H;
    f.Tq = a.Tq;
    f.Tk = a.C;
    f.d = a.d;
    f.causal = 1;
    f.scale = a.scale;
    f.vec_q = a.d % 4 == 0 && aligned16(a.q);
    f.kv_mode = a.kv_mode;
    return launch_fwd<KV>(f, B, st);
  } else if constexpr ((KV == KV_BF16 &&
                        std::is_same<QT, __nv_bfloat16>::value) ||
                       (KV == KV_F16 && std::is_same<QT, __half>::value)) {
    Fwd16Args f;
    f.q = static_cast<const uint16_t*>(a.q);
    f.k = static_cast<const uint16_t*>(a.k);
    f.v = static_cast<const uint16_t*>(a.v);
    f.kv_len = nullptr;
    f.q_off = a.cache_len;
    f.out = static_cast<uint16_t*>(a.out);
    f.lse = a.lse;
    f.H = a.H;
    f.Tq = a.Tq;
    f.Tk = a.C;
    f.d = a.d;
    f.causal = 1;
    f.scale = a.scale;
    f.mode = mode16(a.d, a.q, a.k, a.v);
    return launch_fwd16<QT>(f, B, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <int KV, typename QT>
int launch(const DecArgs& a, int B, cudaStream_t st) {
  if (B * a.H == 0 || a.Tq == 0) return 0;
  if (a.d < 1 || a.C < 1) return (int)cudaErrorInvalidValue;
  if (a.S == 0) return launch_chunk<KV, QT>(a, B, st);
  if (a.d > 256 || a.L < TILE || a.L % TILE != 0 || a.S > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int dpk = dec_dpk<KV>(a.d);
  if (dpk <= 32) return launch_split<1, KV, QT>(a, B, st);
  if (dpk <= 64) return launch_split<2, KV, QT>(a, B, st);
  if (dpk <= 128) return launch_split<4, KV, QT>(a, B, st);
  return launch_split<8, KV, QT>(a, B, st);
}

// Bytes a k / v copy moves for the cache type: 16 where the width and
// both pointers allow it, else 4 where they allow that, else 1 (int8 and
// 16-bit) or 4 (f32).
template <int KV>
int kv_mode(int d, const void* k, const void* v) {
  if (KV == KV_F32) return d % 4 == 0 && aligned16(k) && aligned16(v) ? 16 : 4;
  const int bytes = kKv16<KV> ? 2 * d : d;
  if (bytes % 16 == 0 && aligned16(k) && aligned16(v)) return 16;
  if (bytes % 4 == 0 && aligned_to(k, 4) && aligned_to(v, 4)) return 4;
  return 1;
}

// q (B,H,Tq,d) in QT, k/v (B,H,C,d) in the cache's type (k_scale /
// v_scale (B,H,C,1) f32 for int8, else null), cache_len (B,) int32, out
// (B,H,Tq,d) in QT, lse (B,H,Tq) f32 or null.  All contiguous, any
// alignment; any Tq, C >= 1 and d >= 1 (d <= 256 for a mixed pair).  S = 0
// runs the chunk path; S >= 1 the split-K kernel (d <= 256; query groups
// of 8 rows past Tq = 8) with S <= 8 splits of L positions (a multiple of
// 32), one launch.  Returns cudaGetLastError().
template <int KV, typename QT>
int decode_entry(const void* q, const void* k, const void* k_scale,
                 const void* v, const void* v_scale, const void* cache_len,
                 void* out, void* lse, int B, int H, int Tq, int C, int d,
                 int L, int S, float scale, void* stream) {
  DecArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.cache_len = static_cast<const int*>(cache_len);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.Tq = Tq;
  a.C = C;
  a.d = d;
  a.L = L;
  a.S = S;
  a.scale = scale;
  a.kv_mode = kv_mode<KV>(d, k, v);
  a.bar = 0;  // set by launch_split
  return launch<KV, QT>(a, B, static_cast<cudaStream_t>(stream));
}

}  // namespace

// One C entry: mx_decode_attention_<q>_<cache>(q, k, k_scale, v, v_scale,
// cache_len, out, lse, B, H, Tq, C, d, L, S, scale, stream).
#define MX_DECODE_ENTRY(NAME, KV, QT)                                        \
  int NAME(const void* q, const void* k, const void* k_scale,               \
           const void* v, const void* v_scale, const void* cache_len,       \
           void* out, void* lse, int B, int H, int Tq, int C, int d, int L, \
           int S, float scale, void* stream) {                              \
    return decode_entry<KV, QT>(q, k, k_scale, v, v_scale, cache_len, out,  \
                                lse, B, H, Tq, C, d, L, S, scale, stream);  \
  }
