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
// Split-K (flash-decoding), for d <= 256: a decode step.  Grid (B*H, S,
// G): block s takes cache positions [s L, (s+1) L) up to min(C, cache_len
// + the last row of its query group + 1); a split wholly past that does
// no work.  A block holds at most 8 query rows (G = 1 for Tq <= 8; a
// longer chunk of a mixed pair, q's type other than the cache's, runs G
// groups of 8 rows).  Its warps take 32-position tiles in turn, one
// position a lane, through a warp-private two-stage `cp.async` ring of
// 16-byte copies (4-byte, or bytes where the width or a pointer does not
// allow them).  Scores: each lane dots its key row (shared, row stride =
// 4 mod 32 words or 16 x odd bytes, conflict-free) with the query rows
// (f32, broadcast reads); int8 keys are dequantized in registers and
// scaled once per dot, 16-bit keys widened 8 a 16-byte read.  Each warp
// keeps its own masked online softmax (max and sum by shuffles, no P in
// shared memory: a position's probability is shuffled from its lane) and
// its own accumulator, a lane owning columns lane + 32 i; an int8 value
// row's scale is folded into the probability, a 16-bit cache's
// probability rounded to its type.  The block merges its warps in a fixed
// order in shared memory and writes (max, sum, unnormalized output) per
// query row to the caller's scratch; `decode_combine_kernel` merges the S
// splits in order, so the same inputs give the same bits (no atomics).
// With S = 1 the block writes the final output and no combine runs.
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
// f32, measured by tools/torch_decode_splits.py).  Prefill chunks are
// bounded by arithmetic.
#pragma once

#include "flash_fwd.cuh"

namespace {

enum { KV_BF16 = 2, KV_F16 = 3 };  // beside flash_fwd.cuh's KV_F32, KV_I8

template <int KV>
constexpr bool kKv16 = KV == KV_BF16 || KV == KV_F16;

constexpr int TQ_SPLIT = 8;   // the most query rows a split-K block takes
constexpr int TILE = 32;      // positions a warp takes at once

struct DecArgs {
  const void* q;          // (B, H, Tq, d) in QT
  const void* k;          // (B, H, C, d) in the cache's type
  const void* v;
  const float* k_scale;   // (B, H, C) scales of an int8 cache
  const float* v_scale;
  const int* cache_len;   // (B,)
  void* out;              // (B, H, Tq, d) in QT
  float* lse;             // (B, H, Tq), or null
  float* part;            // S > 1: (3 planes) max, sum (B*H*S*Tq) and the
                          // unnormalized output (B*H*S*Tq*d); else null
  int H, Tq, C, d, L, S;
  float scale;
  int kv_mode;            // bytes a copy moves: 16 or 4 (f32); 16, 4, 1
                          // (int8, bf16, f16)
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

template <int NCOL, int KV, typename QT>
__global__ void __launch_bounds__(128) decode_split_kernel(const DecArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, sp = blockIdx.y;
  const int Tq = a.Tq, d = a.d;
  const int r0 = TQ_SPLIT * blockIdx.z;       // this block's first query row
  const int tq = min(TQ_SPLIT, Tq - r0);      // and its rows
  const int len = max(0, a.cache_len[bh / a.H]);
  const int kv_end = min(a.C, len + r0 + tq);
  const int p0 = sp * a.L;
  const int p1 = min(p0 + a.L, kv_end);
  const size_t nbs = (size_t)gridDim.x * a.S * Tq;  // partial rows in all
  const size_t prow = ((size_t)bh * a.S + sp) * Tq + r0;  // this block's
  if (p0 >= p1) {  // wholly past the cache (S > 1 here): weight 0
    if (tid < tq) a.part[prow + tid] = -INFINITY;
    return;
  }

  const int dpk = dec_dpk<KV>(d);
  const int rs = dec_rs<KV>(dpk);
  const int sb = dec_stage<KV>(rs);
  const QT* qb = static_cast<const QT*>(a.q) + ((size_t)bh * Tq + r0) * d;
  float* sq = smem;  // tq x dpk query rows in f32, zero past d
  for (int i = tid; i < tq * dpk; i += nt) {
    const int r = i / dpk, c = i - r * dpk;
    sq[i] = c < d ? f32_of(qb[(size_t)r * d + c]) : 0.f;
  }
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

  float m[TQ_SPLIT], l[TQ_SPLIT], acc[TQ_SPLIT][NCOL];
#pragma unroll
  for (int r = 0; r < TQ_SPLIT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) acc[r][i] = 0.f;
  }

  __syncthreads();  // the query rows are in place
  int tt = warp;
  if (tt < ntile) fetch(tt, 0);
  cp_commit();
  if (tt + nw < ntile) fetch(tt + nw, 1);
  cp_commit();
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

  // merge the warps in a fixed order, in the ring's memory
  __syncthreads();
  float* wm = reinterpret_cast<float*>(ring);  // [nw][tq] maxima
  float* wl = wm + nw * tq;                    // [nw][tq] sums
  float* wf = wl + nw * tq;                    // [nw][tq] weights
  float* sM = wf + nw * tq;                    // [tq] block max
  float* sL = sM + tq;                         // [tq] block sum
  float* wa = sL + tq;                         // [nw][tq][dpk] outputs
  // (constant indices only: a runtime index would put m, l and acc in
  // local memory)
#pragma unroll
  for (int r = 0; r < TQ_SPLIT; ++r) {
    if (r >= tq) break;
    if (lane == 0) {
      wm[warp * tq + r] = m[r];
      wl[warp * tq + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NCOL; ++i) {
      const int c = lane + 32 * i;
      if (c < dpk) wa[(warp * tq + r) * dpk + c] = acc[r][i];
    }
  }
  __syncthreads();
  if (tid < tq) {
    float M = -INFINITY;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, wm[w * tq + tid]);
    float Ls = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float mw = wm[w * tq + tid];
      const float f = mw == -INFINITY ? 0.f : expf(mw - M);
      wf[w * tq + tid] = f;
      Ls = fmaf(wl[w * tq + tid], f, Ls);
    }
    sM[tid] = M;
    sL[tid] = Ls;
  }
  __syncthreads();
  QT* ob = static_cast<QT*>(a.out) + ((size_t)bh * Tq + r0) * d;
  for (int i = tid; i < tq * d; i += nt) {
    const int r = i / d, c = i - r * d;
    float A = 0.f;
    for (int w = 0; w < nw; ++w)
      A = fmaf(wa[(w * tq + r) * dpk + c], wf[w * tq + r], A);
    if (a.part == nullptr) {  // one split: the result
      const float Ls = sL[r];
      ob[(size_t)r * d + c] = of_f32<QT>(Ls == 0.f ? 0.f : A / Ls);
    } else {
      a.part[2 * nbs + (prow + r) * d + c] = A;
    }
  }
  if (tid < tq) {
    if (a.part == nullptr) {
      if (a.lse != nullptr)
        a.lse[(size_t)bh * Tq + r0 + tid] =
            sL[tid] == 0.f ? -INFINITY : sM[tid] + logf(sL[tid]);
    } else {
      a.part[prow + tid] = sM[tid];
      a.part[nbs + prow + tid] = sL[tid];
    }
  }
}

// One warp per (b, h, query row): merge the S <= 32 splits' partials,
// lane s holding split s's max, sum and weight; a split with max -inf (no
// position of the row in it) has weight 0 and its other planes are not
// read.  Every sum runs over s in order, so the bits do not depend on the
// schedule.  The output in q's type.
constexpr int MAX_SPLITS = 32;

template <typename QT>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part, QT* __restrict__ out,
                      float* __restrict__ lse, int rows, int S, int Tq,
                      int d) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);  // (b h) * Tq + r
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = row / Tq, r = row - bh * Tq;
  const size_t nbs = (size_t)rows * S;
  const size_t first = (size_t)bh * S * Tq + r;  // split s at first + s Tq
  const float ms = lane < S ? part[first + (size_t)lane * Tq] : -INFINITY;
  float M = ms;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  const bool live = ms != -INFINITY;
  const float w = live ? expf(ms - M) : 0.f;
  const float ls = live ? part[nbs + first + (size_t)lane * Tq] : 0.f;
  float Ls = 0.f;
  for (int s = 0; s < S; ++s)
    Ls = fmaf(__shfl_sync(0xffffffffu, ls, s),
              __shfl_sync(0xffffffffu, w, s), Ls);
  const float* pa = part + 2 * nbs + first * d;
  for (int c0 = 0; c0 < d; c0 += 32) {  // warp-uniform: shuffles inside
    const int c = c0 + lane;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float ws = __shfl_sync(0xffffffffu, w, s);
      if (ws != 0.f && c < d) A = fmaf(pa[(size_t)s * Tq * d + c], ws, A);
    }
    if (c < d) out[(size_t)row * d + c] = of_f32<QT>(Ls == 0.f ? 0.f : A / Ls);
  }
  if (lse != nullptr && lane == 0)
    lse[row] = Ls == 0.f ? -INFINITY : M + logf(Ls);
}

template <int NCOL, int KV, typename QT>
int launch_split(const DecArgs& a, int B, cudaStream_t st) {
  const int dpk = dec_dpk<KV>(a.d);
  const int rs = dec_rs<KV>(dpk);
  // warps a block: f32 rings are large (two stages of 32 K and V rows a
  // warp), so fewer warps and more blocks an SM at wide rows; 16-bit
  // rings are half their size
  const int nw = KV == KV_I8    ? 4
                 : KV == KV_F32 ? (dpk <= 104 ? 2 : 1)
                                : (dpk <= 64 ? 4 : dpk <= 128 ? 2 : 1);
  const int tq = a.Tq < TQ_SPLIT ? a.Tq : TQ_SPLIT;
  const size_t ring = (size_t)nw * 2 * dec_stage<KV>(rs);
  const size_t merge = 4 * ((size_t)nw * tq * (dpk + 3) + 2 * tq);
  const size_t smem = 4 * (size_t)tq * dpk + (ring > merge ? ring : merge);
  auto kern = decode_split_kernel<NCOL, KV, QT>;
  static int done[64] = {};
  int e = set_smem(kern, smem, done);
  if (e != 0) return e;
  const dim3 grid((unsigned)(B * a.H), (unsigned)a.S,
                  (unsigned)((a.Tq + TQ_SPLIT - 1) / TQ_SPLIT));
  kern<<<grid, 32 * nw, smem, st>>>(a);
  e = (int)cudaGetLastError();
  if (e != 0 || a.S == 1) return e;
  const int rows = B * a.H * a.Tq;
  decode_combine_kernel<QT><<<(rows + 3) / 4, 128, 0, st>>>(
      a.part, static_cast<QT*>(a.out), a.lse, rows, a.S, a.Tq, a.d);
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
  if (a.d > 256 || a.L < TILE || a.L % TILE != 0 || a.S > MAX_SPLITS ||
      (a.S > 1) != (a.part != nullptr))
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
// of 8 rows past Tq = 8) with S <= 32 splits of L positions (a multiple of
// 32), and with S > 1 the combine over `part`: planes of B*H*S*Tq,
// B*H*S*Tq and B*H*S*Tq*d f32 (null when S = 1).  Returns
// cudaGetLastError().
template <int KV, typename QT>
int decode_entry(const void* q, const void* k, const void* k_scale,
                 const void* v, const void* v_scale, const void* cache_len,
                 void* out, void* lse, void* part, int B, int H, int Tq,
                 int C, int d, int L, int S, float scale, void* stream) {
  DecArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.cache_len = static_cast<const int*>(cache_len);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.part = static_cast<float*>(part);
  a.H = H;
  a.Tq = Tq;
  a.C = C;
  a.d = d;
  a.L = L;
  a.S = S;
  a.scale = scale;
  a.kv_mode = kv_mode<KV>(d, k, v);
  return launch<KV, QT>(a, B, static_cast<cudaStream_t>(stream));
}

}  // namespace

// One C entry: mx_decode_attention_<q>_<cache>(q, k, k_scale, v, v_scale,
// cache_len, out, lse, part, B, H, Tq, C, d, L, S, scale, stream).
#define MX_DECODE_ENTRY(NAME, KV, QT)                                        \
  int NAME(const void* q, const void* k, const void* k_scale,               \
           const void* v, const void* v_scale, const void* cache_len,       \
           void* out, void* lse, void* part, int B, int H, int Tq, int C,   \
           int d, int L, int S, float scale, void* stream) {                \
    return decode_entry<KV, QT>(q, k, k_scale, v, v_scale, cache_len, out,  \
                                lse, part, B, H, Tq, C, d, L, S, scale,     \
                                stream);                                    \
  }
