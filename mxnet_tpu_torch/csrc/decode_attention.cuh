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
// them), each warp with its own masked online softmax and accumulator.
// Which pairs take which branch, and why:
//  - a 16-bit cache, under any query type (bf16 or f16 over its own type,
//    f32 over bf16 or f16, bf16 over f16, f16 over bf16): tensor cores
//    (split_tiles16).  64-position tiles a warp; S = Q K^T and O += P V
//    on mma.sync.m16n8k16 in the cache's type with the query rows as
//    register A fragments held for the whole split, K and V by ldmatrix
//    from unpadded rows whose 16-byte chunks are XOR-swizzled, the
//    softmax on the accumulators and P rounded to the cache's type packed
//    from them as the A fragment of P V.  Every product stays exact: q is
//    brought into the cache's type once a split, as terms that sum back
//    to it (kQTerms): f32 as three terms (8 + 8 + 8 bits in bf16; 11 + 11
//    + 11 in f16, after a power-of-two row scale that the scores take
//    back), bf16 into f16 as one term after that scale, f16 into bf16 as
//    two; in f16 only the subnormal floor rounds, within 2^-39 of the
//    row's largest |q|.  S is the sum of their MMAs against one K
//    fragment.  At d <= 64 4 warps x 64 positions cover a split of 256
//    in one tile a warp, so the whole split is in flight after one wait;
//    a second stage only where L is longer.
//  - an int8 cache under 16-bit queries: tensor cores (split_tiles_i8).
//    The same tiles and softmax; the int8 rows land as bytes and are
//    widened exactly in registers (|k| <= 127 is exact in bf16 and f16),
//    which a shared 16-bit tile would only add a pass of stores to: K
//    into q's type for S = Q K (each score then times its position's f32
//    k_scale, as on CUDA cores), V into bf16 for P V.  P stays f32 (the
//    TPU kernel's numerics for an int8 cache): w = p * v_scale in f32,
//    split into three bf16 terms that sum back to it, three MMAs against
//    V (as O^T = V^T W^T, the query rows the MMA's 8 columns), the
//    largest term's products summed apart from the others' so that a
//    row with one live position gets v_scale * v rounded once.
//  - f32 over f32 or int8, and bf16 or f16 over f32: CUDA cores
//    (split_tiles).  32-position tiles, one position a lane, two stages
//    a warp; each lane dots its key row (shared, row stride = 4 mod 32
//    words or 16 x odd bytes, conflict-free) with the query rows (f32,
//    broadcast reads); int8 keys dequantized in registers and scaled once
//    per dot; a position's probability shuffled from its lane into P V,
//    a lane owning columns lane + 32 i; an int8 value row's scale folded
//    into the probability.  An f32 cache value is exact in no 16-bit
//    type, and f32 queries over int8 keep the parent's bits.
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

// a 16-bit cache's element type
template <int KV>
using kv16_t =
    typename std::conditional<KV == KV_F16, __half, __nv_bfloat16>::type;

// an int8 cache under 16-bit queries
template <int KV, typename QT>
constexpr bool kI8Mma = KV == KV_I8 && !std::is_same<QT, float>::value;

// split-K on tensor cores: every 16-bit cache, and int8 under 16-bit
// queries (the header)
template <int KV, typename QT>
constexpr bool kMma16 = kKv16<KV> || kI8Mma<KV, QT>;

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

// Four int8 values (the bytes of w, byte 0 first) as two packed pairs of
// T, exactly: lo = (byte 0, byte 1), hi = (byte 2, byte 3).  Each byte
// goes in as u = k + 128 beside a constant exponent: in f16 0x6400 | u is
// 1024 + u, less 1152 is k; in bf16 through f32, 0x4B000000 | u is 2^23 +
// u, less 2^23 + 128 is k, whose f32 bits end in 16 zeros (|k| <= 128 has
// at most 8 significant bits), so its high half is k in bf16.
template <typename T>
__device__ __forceinline__ void i8x4_to16(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  if constexpr (kF16<T>) {
    const __half2 off = __float2half2_rn(1152.f);
    uint32_t a = __byte_perm(u, 0x64646464u, 0x5140);
    uint32_t b = __byte_perm(u, 0x64646464u, 0x7362);
    const __half2 ha = __hsub2(*reinterpret_cast<const __half2*>(&a), off);
    const __half2 hb = __hsub2(*reinterpret_cast<const __half2*>(&b), off);
    lo = *reinterpret_cast<const uint32_t*>(&ha);
    hi = *reinterpret_cast<const uint32_t*>(&hb);
  } else {
    const float m = 8388736.f;  // 2^23 + 128
    const uint32_t f0 = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - m);
    const uint32_t f1 = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - m);
    const uint32_t f2 = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - m);
    const uint32_t f3 = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - m);
    lo = __byte_perm(f0, f1, 0x7632);
    hi = __byte_perm(f2, f3, 0x7632);
  }
}

// Terms of T that q is brought into the cache's type T as (the header):
// one where q is T or bf16 into f16, two for f16 into bf16, three for f32.
template <typename T, typename QT>
constexpr int kQTerms =
    std::is_same<QT, T>::value      ? 1
    : std::is_same<QT, float>::value ? 3
    : kF16<QT>                       ? 2
                                     : 1;

// whether q is scaled by a power of two a row first (f16's range)
template <typename T, typename QT>
constexpr bool kQScale = kF16<T> && !kF16<QT>;

// (x, y) as N packed pairs of T that sum back to them, largest first:
// each term the rest rounded to T, the rest after it exact in f32.
template <typename T, int N>
__device__ __forceinline__ void split_terms(float x, float y,
                                            uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = pack16<T>(x, y);
    const float2 h = unpack_f2<T>(t[i]);
    x -= h.x;
    y -= h.y;
  }
}

// ------------------------------------------------------------ tiles
// Widths of a row: d padded to dpk (8 in f32 and 16-bit; 16 in int8, one
// 16-byte read a step), and on CUDA cores the shared row stride in bytes.
template <int KV>
__host__ __device__ inline int dec_dpk(int d) {
  return KV == KV_I8 ? (d + 15) & ~15 : (d + 7) & ~7;
}

template <int KV>
__host__ __device__ inline int dec_rs(int dpk) {
  return KV == KV_I8 ? 16 * ((dpk >> 4) | 1) : 4 * (dpk + 4);
}

template <int KV>
__host__ __device__ inline int dec_stage(int rs) {
  return 2 * TILE * rs + (KV == KV_I8 ? 2 * TILE * 4 : 0);
}

// TILE cache rows from row0 (zero at or past `valid`) into a warp's
// stage: f32 rows at stride rs bytes, or int8 bytes with their scales.
template <int KV>
__device__ __forceinline__ void dec_rows(char* dst, float* dsc,
                                         const void* src, const float* sc,
                                         int row0, int valid, int d, int dpk,
                                         int rs, int mode, int lane) {
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
// The split's positions [p0, p1) over an f32 cache, or an int8 one under
// f32 queries: 32-position tiles a warp, one position a lane; each warp's
// (max, sum, output) a query row into the merge area.
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
  const void* kb = rows_at<KV>(a.k, koff * d);
  const void* vb = rows_at<KV>(a.v, koff * d);
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
    } else {
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
                         // (int8)
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
      pw[r] = KV == KV_I8 ? p * vs : p;
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
        else
          vx[i] = c < dpk ? (float)reinterpret_cast<const int8_t*>(vrow)[c]
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
// A 16-bit cache of type T, under queries of any type: 64-position tiles a
// warp, S = Q K^T and O += P V on mma.sync.m16n8k16 in T with f32
// accumulators.  Rows of
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

// The query rows (<= 8, zero-padded to the MMA's 16) are the A fragments,
// held in registers for the whole split: lane (g, t) holds row g's columns
// 16 ks + 2t.. and 16 ks + 8 + 2t.. (rows g + 8 are zero registers), as
// the kQTerms terms of T that sum back to q (q's own bits where q is T;
// where kQScale, times a power of two a row from the quad's max |q|, which
// the scores take back).  K comes by ldmatrix as B, every term's MMA
// against the same fragment, the smallest term first; the scores'
// accumulators (row g, keys 8j + 2t, 8j + 2t + 1) take the online
// softmax, each row's max and sum across the quad by two shuffles; P,
// rounded to T (the TPU kernel's `p.astype(v.dtype)`), is packed from
// them as the A fragment of O += P V (FlashAttention-2's reuse of
// registers) and V comes by transposed ldmatrix.  Products of two 16-bit
// values are exact in f32, as the TPU kernel's upcast products are; the
// sum l is taken from the f32 P.
template <int NCOL, typename T, typename QT>
__device__ __forceinline__ void split_tiles16(const DecArgs& a, char* ring,
                                              const MergeArea& g, int bh,
                                              int r0, int tq, int len, int p0,
                                              int p1) {
  constexpr int DK = kDk16<NCOL>, NKS = DK / 16, NJ = DK / 8, RB = 2 * DK;
  constexpr int NQ = kQTerms<T, QT>;
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
  uint32_t qa[NQ][NKS][2];
  [[maybe_unused]] float qun = 1.f;  // undoes row gr's scale in its scores
  if constexpr (std::is_same<QT, T>::value) {
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
        qa[0][ks][h] = lo | hi << 16;
      }
  } else {
    const bool row = gr < tq;
    const QT* qr = static_cast<const QT*>(a.q) +
                   ((size_t)bh * a.Tq + r0 + (row ? gr : 0)) * d;
    float qf[NKS][4];
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * ks + 8 * (e >> 1) + 2 * t + (e & 1);
        qf[ks][e] = row && c < d ? f32_of(qr[c]) : 0.f;
      }
    if constexpr (kQScale<T, QT>) {
      float mx = 0.f;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx = fmaxf(mx, fabsf(qf[ks][e]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const int eb = ebits(mx);
      const float f = eb_scale(eb);
      qun = eb_unscale(eb);
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[ks][e] *= f;
    }
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t tm[NQ];
        split_terms<T, NQ>(qf[ks][2 * h], qf[ks][2 * h + 1], tm);
#pragma unroll
        for (int i = 0; i < NQ; ++i) qa[i][ks][h] = tm[i];
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[4];
        ldsm_x4(bf, reinterpret_cast<const uint16_t*>(
                        sk + krow + j * 16 * RB + (((2 * ks + kc) ^ sw) << 4)));
#pragma unroll
        for (int i = NQ - 1; i >= 0; --i) {
          const uint32_t af[4] = {qa[i][ks][0], 0u, qa[i][ks][1], 0u};
          mma16<T>(s[2 * j], af, bf[0], bf[1]);
          mma16<T>(s[2 * j + 1], af, bf[2], bf[3]);
        }
      }
    }

    // the masked online-softmax update of row gr on its accumulators
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t0 + 8 * j + 2 * t + e;
        if constexpr (kQScale<T, QT>) s[j][e] *= qun;  // exact
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

// ------------------------------------- int8 tiles on tensor cores
// An int8 cache under 16-bit queries.  A warp's stage holds 64 K rows of
// DK bytes (unpadded; at DK >= 128 an odd row's 16-byte chunk c at c ^ 4),
// 64 V rows at a stride of 16 x odd bytes, then the tile's 64 k_scale and
// 64 v_scale values.
__host__ __device__ inline int dec8_vrs(int dk) { return 16 * ((dk >> 4) | 1); }

__host__ __device__ inline int dec8_stage(int dk) {
  return TILE16 * (dk + dec8_vrs(dk)) + 2 * TILE16 * 4;
}

// Rows [row0, row0 + 64) of an int8 matrix (d bytes a row) into a tile of
// DK columns at row stride rs, zero past d and at or past `valid`: `mode`
// bytes a copy (kv_mode: 16, 4, or 1, a plain load and store visible
// after the next __syncwarp); with `swz` an odd row's chunk c at c ^ 4.
template <int DK>
__device__ __forceinline__ void load_rows8(char* dst, const int8_t* src,
                                           int row0, int valid, int d,
                                           int rs, bool swz, int mode,
                                           int lane) {
  constexpr int LRB = DK == 64 ? 6 : DK == 128 ? 7 : 8;  // log2(DK)
  const int lm = mode == 16 ? 4 : mode == 4 ? 2 : 0;     // log2(mode)
  const int lc = LRB - lm;                              // log2(copies a row)
  for (int i = lane; i < TILE16 << lc; i += 32) {
    const int r = i >> lc, b = (i & ((1 << lc) - 1)) << lm;
    const bool ok = row0 + r < valid && b < d;
    const int8_t* from = ok ? src + (size_t)(row0 + r) * d + b : src;
    char* to = dst + r * rs + (swz ? b ^ ((r & 1) << 6) : b);
    if (mode == 16)
      cp16(to, from, ok);
    else if (mode == 4)
      cp4(to, from, ok);
    else
      *to = ok ? *from : (int8_t)0;
  }
}

// The 64 f32 scales of rows [row0, row0 + 64), zero at or past `valid`.
__device__ __forceinline__ void load_scales(float* dst, const float* src,
                                            int row0, int valid, int lane) {
  for (int i = lane; i < TILE16; i += 32) {
    const bool ok = row0 + i < valid;
    cp4(dst + i, ok ? src + row0 + i : src, ok);
  }
}

// The tiles of split_tiles16 over int8 rows, widened in registers.
// S = Q K in q's type QT: the depth of both fragments is permuted so that
// lane (g, t) reads 16 bytes of its key row 8j + g at once (one LDS.128
// for four MMA steps; a quarter warp reads two whole rows, conflict-free):
// step u of the 64-column block jj takes columns 64 jj + 16 t + 4 u, +1 as
// depth 2t, 2t + 1 (a0, b0) and +2, +3 as depth 2t + 8, 2t + 9 (a2, b1).
// Each score is then times its position's k_scale and the scale, as on
// CUDA cores.  P V in bf16 as O^T = V^T W^T, w = p * v_scale (f32): the
// <= 8 query rows are the MMA's 8 columns (no zero half), W^T's fragment
// is the score accumulators as they stand, and V^T's is built by lane
// (g, t) from V rows 16 i + 2t, + 1 (a0, a1) and + 8, + 9 (a2, a3) of
// chunk i, W bytes of each at column W g of every 128-column block (W = 8
// at DK = 64, else 16; conflict-free at the odd row stride), two rows'
// bytes interleaved into pairs by byte_perm: m-tile mt of block bb takes
// columns 128 bb + W g + 2 mt (rows g) and + 1 (rows g + 8).  w is split
// into three bf16 terms that sum back to it; the largest multiplies into
// one accumulator, the other two into a second, and the two are added in
// f32 at the end.  So a row with one live position (p = 1: an inert row)
// gets v_scale * v rounded once, as the plain version's dequantized v:
// every partial sum before that addition is exact.
template <int NCOL, typename QT>
__device__ __forceinline__ void split_tiles_i8(const DecArgs& a, char* ring,
                                               const MergeArea& g, int bh,
                                               int r0, int tq, int len,
                                               int p0, int p1) {
  using BF = __nv_bfloat16;
  constexpr int DK = kDk16<NCOL>, NKS = DK / 16, NM = DK / 16;
  constexpr int W = DK == 64 ? 8 : 16, NB = DK / (8 * W);
  constexpr int VOFF = TILE16 * DK;  // the V rows in a stage
  const int tid = threadIdx.x, nw = blockDim.x >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int d = a.d, vrs = dec8_vrs(DK), sb = dec8_stage(DK);
  const int soff = VOFF + TILE16 * vrs;   // the scales in a stage
  char* mine = ring + (size_t)warp * dec16_stages(a.L, nw) * sb;
  const size_t koff = (size_t)bh * a.C;
  const int8_t* kb = static_cast<const int8_t*>(a.k) + koff * d;
  const int8_t* vb = static_cast<const int8_t*>(a.v) + koff * d;
  const float* ksb = a.k_scale + koff;
  const float* vsb = a.v_scale + koff;
  const int ntile = (p1 - p0 + TILE16 - 1) / TILE16;

  // tile tt of the split into stage `st`: K rows and their scales, then
  // V rows and theirs, each its own commit group
  auto fetch = [&](int tt, int st) {
    char* s = mine + st * sb;
    float* sc = reinterpret_cast<float*>(s + soff);
    const int t0 = p0 + tt * TILE16;
    if (tt < ntile) {
      load_rows8<DK>(s, kb, t0, p1, d, DK, DK >= 128, a.kv_mode, lane);
      load_scales(sc, ksb, t0, p1, lane);
    }
    cp_commit();
    if (tt < ntile) {
      load_rows8<DK>(s + VOFF, vb, t0, p1, d, vrs, false, a.kv_mode, lane);
      load_scales(sc + TILE16, vsb, t0, p1, lane);
    }
    cp_commit();
  };

  int tt = warp;
  fetch(tt, 0);
  fetch(tt + nw, 1);
  // q's bits in the permuted depth order: step ks = 4 jj + u takes columns
  // c = 64 jj + 16 t + 4 u .. c + 3
  uint32_t qa[NKS][2];
  {
    const bool row = gr < tq;
    const uint16_t* qr = static_cast<const uint16_t*>(a.q) +
                         ((size_t)bh * a.Tq + r0 + (row ? gr : 0)) * d;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 64 * (ks >> 2) + 16 * t + 4 * (ks & 3) + 2 * h;
        const uint32_t lo = row && c < d ? qr[c] : 0u;
        const uint32_t hi = row && c + 1 < d ? qr[c + 1] : 0u;
        qa[ks][h] = lo | hi << 16;
      }
  }

  // O^T a query row a column: lane (g, t) holds rows 2t, 2t + 1 of m-tile
  // mt's columns; oh takes w's largest term, ol the other two
  float m = -INFINITY, l = 0.f, oh[NM][4], ol[NM][4];
#pragma unroll
  for (int n = 0; n < NM; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oh[n][e] = ol[n][e] = 0.f;
  const int lim = gr < tq ? len + r0 + gr : -1;  // row gr's last position
  const int swk = DK >= 128 ? (gr & 1) << 6 : 0;  // its K rows' swizzle
  for (int st = 0; tt < ntile; tt += nw, st ^= 1) {
    cp_wait<3>();
    __syncwarp();  // every lane's K copies (and byte stores) of the stage
    const char* sk = mine + st * sb;
    const char* sv = sk + VOFF;
    const float* sc = reinterpret_cast<const float*>(sk + soff);
    const int t0 = p0 + tt * TILE16;

    // the scores of eight 8-key tiles, four MMA steps a 16-byte read
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DK / 64; ++jj) {
      uint4 kr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kr[j] = *reinterpret_cast<const uint4*>(
            sk + (8 * j + gr) * DK + ((64 * jj + 16 * t) ^ swk));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t af[4] = {qa[4 * jj + u][0], 0u, qa[4 * jj + u][1], 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t w = u == 0   ? kr[j].x
                             : u == 1 ? kr[j].y
                             : u == 2 ? kr[j].z
                                      : kr[j].w;
          uint32_t b0, b1;
          i8x4_to16<QT>(w, b0, b1);
          mma16<QT>(s[j], af, b0, b1);
        }
      }
    }

    // each score times its position's k_scale, then the masked
    // online-softmax update of row gr on its accumulators
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ks = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t0 + 8 * j + 2 * t + e;
        const float x = s[j][e] * (e ? ks.y : ks.x);
        s[j][e] = key < p1 && key <= lim ? x * a.scale : -INFINITY;
        mx = fmaxf(mx, s[j][e]);
      }
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
    // rows 2t and 2t + 1 of O^T take their own rows' corrections
    const float c0 = __shfl_sync(0xffffffffu, corr, 8 * t);
    const float c1 = __shfl_sync(0xffffffffu, corr, 8 * t + 4);
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      oh[n][0] *= c0, oh[n][2] *= c0, ol[n][0] *= c0, ol[n][2] *= c0;
      oh[n][1] *= c1, oh[n][3] *= c1, ol[n][1] *= c1, ol[n][3] *= c1;
    }

    // O^T += V^T W^T over four 16-key chunks
    cp_wait<2>();
    __syncwarp();  // and its V copies
    const float* vsc = sc + TILE16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v0 = *reinterpret_cast<const float2*>(vsc + 16 * i + 2 * t);
      const float2 v1 =
          *reinterpret_cast<const float2*>(vsc + 16 * i + 8 + 2 * t);
      uint32_t w0[3], w1[3];  // keys 16i + 2t.. and 16i + 8 + 2t..
      split_terms<BF, 3>(s[2 * i][0] * v0.x, s[2 * i][1] * v0.y, w0);
      split_terms<BF, 3>(s[2 * i + 1][0] * v1.x, s[2 * i + 1][1] * v1.y, w1);
      const char* vr = sv + (16 * i + 2 * t) * vrs + W * gr;
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        // m-tile mt's A fragment: rows + 0, 1 (a0 column 2 mt, a1 2 mt +
        // 1), rows + 8, 9 (a2, a3)
        uint32_t va[W / 2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const char* rp = vr + 8 * hh * vrs + 128 * bb;
          uint32_t x0[W / 4], x1[W / 4];
          if constexpr (W == 8) {
            const uint2 y0 = *reinterpret_cast<const uint2*>(rp);
            const uint2 y1 = *reinterpret_cast<const uint2*>(rp + vrs);
            x0[0] = y0.x, x0[1] = y0.y, x1[0] = y1.x, x1[1] = y1.y;
          } else {
            const uint4 y0 = *reinterpret_cast<const uint4*>(rp);
            const uint4 y1 = *reinterpret_cast<const uint4*>(rp + vrs);
            x0[0] = y0.x, x0[1] = y0.y, x0[2] = y0.z, x0[3] = y0.w;
            x1[0] = y1.x, x1[1] = y1.y, x1[2] = y1.z, x1[3] = y1.w;
          }
#pragma unroll
          for (int q = 0; q < W / 4; ++q) {
            i8x4_to16<BF>(__byte_perm(x0[q], x1[q], 0x5140),
                          va[2 * q][2 * hh], va[2 * q][2 * hh + 1]);
            i8x4_to16<BF>(__byte_perm(x0[q], x1[q], 0x7362),
                          va[2 * q + 1][2 * hh], va[2 * q + 1][2 * hh + 1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < W / 2; ++mt)
          mma16<BF>(ol[W / 2 * bb + mt], va[mt], w0[2], w1[2]);
#pragma unroll
        for (int mt = 0; mt < W / 2; ++mt)
          mma16<BF>(ol[W / 2 * bb + mt], va[mt], w0[1], w1[1]);
#pragma unroll
        for (int mt = 0; mt < W / 2; ++mt)
          mma16<BF>(oh[W / 2 * bb + mt], va[mt], w0[0], w1[0]);
      }
    }
    __syncwarp();  // every lane is done reading the stage
    fetch(tt + 2 * nw, st);
  }
  cp_wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  __syncthreads();  // the merge area is the ring's memory
  if (gr < tq && t == 0) {
    g.wm[warp * tq + gr] = m;
    g.wl[warp * tq + gr] = l;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 2 * t + e;
    if (r >= tq) break;
    float* wa = g.wa + (warp * tq + r) * DK + W * gr;
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int mt = 0; mt < W / 2; ++mt) {
        const int n = W / 2 * bb + mt;
        wa[128 * bb + 2 * mt] = ol[n][e] + oh[n][e];
        wa[128 * bb + 2 * mt + 1] = ol[n][2 + e] + oh[n][2 + e];
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
    if constexpr (kKv16<KV>)
      split_tiles16<NCOL, kv16_t<KV>, QT>(a, reinterpret_cast<char*>(work),
                                          g, bh, r0, tq, len, p0, p1);
    else if constexpr (mma)
      split_tiles_i8<NCOL, QT>(a, reinterpret_cast<char*>(work), g, bh, r0,
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
    // block in 16 bits: three blocks an SM; 38,912 in int8); fewer warps
    // at wider rows
    constexpr int DK = kDk16<NCOL>;
    nw = DK <= 64 ? 4 : DK <= 128 ? 2 : 1;
    wd = DK;
    lead = 0;
    ring = (size_t)nw * dec16_stages(a.L, nw) *
           (kKv16<KV> ? dec16_stage(DK) : dec8_stage(DK));
  } else {
    // warps a block: f32 rings are large (two stages of 32 K and V rows
    // a warp), so fewer warps and more blocks an SM at wide rows
    const int dpk = dec_dpk<KV>(a.d);
    nw = KV == KV_I8 ? 4 : (dpk <= 104 ? 2 : 1);
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
