// Decode-mode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py `_decode_kernel`
// (launched by `_decode_forward_pallas`).  For each (b, h) and each query
// row i < Tq it attends the cache positions kpos <= cache_len[b] + i with
// an online softmax (running max, sum and accumulator in f32), and
// optionally writes the f32 row log-sum-exp.  Two entry points: an f32
// cache, and an int8 cache with one f32 scale per (b, h, position) that
// is dequantized here, per loaded kv tile, so the cache stays int8 in
// device memory.
//
// Design.  Grid (B*H, ceil(Tq/BQ)), 128 threads.  A block loads its BQ
// query rows into shared memory, then walks kv tiles of BK positions up
// to min(C, cache_len + last row + 1): that loop takes the place of the
// TPU kernel's sequential kv grid axis and its block skip.  Scores and
// the softmax run on CUDA cores.  A masked position is skipped, never
// multiplied by p = 0: cache rows past a row's valid length hold garbage
// (NaN in the tests), and 0 * NaN = NaN.  Query rows past Tq are neither
// computed nor written.  The TPU layout choices (8-row sublane padding of
// the query chunk, 128-lane m/l scratch) are dropped.  The grid covers any
// Tq (a prefill chunk of a 1024-token prompt bucket included), and any
// C >= 1 and 1 <= d <= 256: cache tiles load as 4-element groups when
// d % 4 == 0 and the cache is aligned for them, element by element
// otherwise; the compute loops are scalar over d.
//
// What bounds it on an H100.  At Tq = 1 (a decode step) the work is
// memory-bound: per (b, h) it must read (cache_len + 1) * d * 2 cache
// elements, 4 B each in f32 or 1 B plus a 4 B scale per position in
// int8, for 2 * (cache_len + 1) * d multiply-adds.  Prefill chunks
// (Tq = prompt bucket) are bounded by arithmetic.  This first version
// gives one block per (b, h) at Tq = 1, so at 8 slots x 12 heads only 96
// of 132 SMs get work and each walks its whole cache alone; split-K
// (flash-decoding) over the cache axis, TMA tile loads and wgmma for the
// prefill products are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;    // query rows per block
constexpr int BK = 64;    // cache positions per kv tile
constexpr int NT = 128;   // threads per block
constexpr int DMAX = 256;
constexpr int ROWS_PER_THREAD = BQ * BK / NT;   // score rows per thread
constexpr int ACC_PER_THREAD = BQ * DMAX / NT;  // accumulator slots per thread

size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)BQ * d + 2 * (size_t)BK * (d + 1) + BQ * BK + 3 * BQ);
}

// Copy n cache rows (row0 .. row0+n-1 of the flattened (B*H*C, d) cache)
// into a shared tile with row stride ds = d + 1 (conflict-free column
// reads).  With VEC (d % 4 == 0 and the cache 16-byte aligned in f32,
// 4-byte aligned in int8) 4-element groups are loaded at once and never
// cross a row; otherwise element by element, for any d.  A template
// parameter, not a runtime flag: the branch cost the vector path 16%.
template <bool QUANT, bool VEC>
__device__ void load_tile(float* dst, const void* src, const float* scales,
                          size_t row0, int n, int d, int ds) {
  if (!VEC) {
    for (int e = threadIdx.x; e < n * d; e += NT) {
      const int j = e / d;
      const int c = e - j * d;
      const size_t at = (row0 + j) * d + c;
      dst[j * ds + c] =
          QUANT ? (float)static_cast<const int8_t*>(src)[at] * scales[row0 + j]
                : static_cast<const float*>(src)[at];
    }
    return;
  }
  const int nv = n * d / 4;
  for (int i = threadIdx.x; i < nv; i += NT) {
    const int e = i * 4;
    const int j = e / d;
    const int c = e - j * d;
    float* o = dst + j * ds + c;
    if (QUANT) {
      const char4 x =
          reinterpret_cast<const char4*>(static_cast<const int8_t*>(src) + row0 * d)[i];
      const float s = scales[row0 + j];
      o[0] = (float)x.x * s;
      o[1] = (float)x.y * s;
      o[2] = (float)x.z * s;
      o[3] = (float)x.w * s;
    } else {
      const float4 x =
          reinterpret_cast<const float4*>(static_cast<const float*>(src) + row0 * d)[i];
      o[0] = x.x;
      o[1] = x.y;
      o[2] = x.z;
      o[3] = x.w;
    }
  }
}

template <bool QUANT, bool VEC>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const float* __restrict__ q, const void* __restrict__ k,
                        const float* __restrict__ k_scale,
                        const void* __restrict__ v,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ cache_len,
                        float* __restrict__ out, float* __restrict__ lse,
                        int H, int Tq, int C, int d, float scale) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  float* sq = smem;              // BQ x d     query rows
  float* sk = sq + BQ * d;       // BK x ds    key tile
  float* sv = sk + BK * ds;      // BK x ds    value tile
  float* sp = sv + BK * ds;      // BQ x BK    scores, then probabilities
  float* sm = sp + BQ * BK;      // BQ         running max
  float* sl = sm + BQ;           // BQ         running sum
  float* sc = sl + BQ;           // BQ         this tile's rescale factor

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int nrows = min(BQ, Tq - q0);
  const int len = cache_len[bh / H];
  // one past the last cache position any row of this block attends
  const int kv_end = min(C, len + q0 + nrows);

  const float* qb = q + ((size_t)bh * Tq + q0) * d;
  for (int i = tid; i < nrows * d; i += NT) sq[i] = qb[i];
  if (tid < BQ) {
    sm[tid] = -INFINITY;
    sl[tid] = 0.f;
  }

  float acc[ACC_PER_THREAD];
#pragma unroll
  for (int a = 0; a < ACC_PER_THREAD; ++a) acc[a] = 0.f;
  const int nacc = nrows * d;

  const size_t row_base = (size_t)bh * C;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int n = min(BK, kv_end - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<QUANT, VEC>(sk, k, k_scale, row_base + k0, n, d, ds);
    load_tile<QUANT, VEC>(sv, v, v_scale, row_base + k0, n, d, ds);
    __syncthreads();

    // Scores.  A thread owns key j and rows r0, r0 + NT/BK, ...: the key
    // row is read once for all of them, the query rows are broadcasts.
    {
      constexpr int RSTEP = NT / BK;
      const int j = tid % BK;
      const int r0 = tid / BK;
      float s[ROWS_PER_THREAD];
#pragma unroll
      for (int a = 0; a < ROWS_PER_THREAD; ++a) s[a] = 0.f;
      if (j < n) {
        const float* kr = sk + j * ds;
        for (int c = 0; c < d; ++c) {
          const float kc = kr[c];
#pragma unroll
          for (int a = 0; a < ROWS_PER_THREAD; ++a) {
            const int r = r0 + a * RSTEP;
            if (r < nrows) s[a] = fmaf(sq[r * d + c], kc, s[a]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < ROWS_PER_THREAD; ++a) {
        const int r = r0 + a * RSTEP;
        if (r < nrows && j < n)
          sp[r * BK + j] = (k0 + j <= len + q0 + r) ? s[a] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax, one warp per row.
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int r = warp; r < nrows; r += NT / 32) {
        float* pr = sp + r * BK;
        float mx = -INFINITY;
        for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pr[j]);
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = sm[r];
        const float m_new = fmaxf(m_prev, mx);
        const float safe = (m_new == -INFINITY) ? 0.f : m_new;
        float sum = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float x = pr[j];
          const float p = (x == -INFINITY) ? 0.f : expf(x - safe);
          pr[j] = p;
          sum += p;
        }
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float corr = (m_prev == -INFINITY) ? 0.f : expf(m_prev - safe);
          sm[r] = m_new;
          sl[r] = sl[r] * corr + sum;
          sc[r] = corr;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over the row's live keys only.
#pragma unroll
    for (int a = 0; a < ACC_PER_THREAD; ++a) {
      const int e = tid + a * NT;
      if (e < nacc) {
        const int r = e / d;
        const int c = e - r * d;
        const int jmax = min(n, len + q0 + r - k0 + 1);
        const float* pr = sp + r * BK;
        float x = acc[a] * sc[r];
        for (int j = 0; j < jmax; ++j) x = fmaf(pr[j], sv[j * ds + c], x);
        acc[a] = x;
      }
    }
  }

  float* ob = out + ((size_t)bh * Tq + q0) * d;
#pragma unroll
  for (int a = 0; a < ACC_PER_THREAD; ++a) {
    const int e = tid + a * NT;
    if (e < nacc) {
      const float l = sl[e / d];
      ob[e] = acc[a] / (l == 0.f ? 1.f : l);
    }
  }
  if (lse != nullptr && tid < nrows) {
    const float l = sl[tid];
    lse[(size_t)bh * Tq + q0 + tid] = sm[tid] + logf(l == 0.f ? 1.f : l);
  }
}

template <bool QUANT>
int launch(const void* q, const void* k, const void* k_scale, const void* v,
           const void* v_scale, const void* cache_len, void* out, void* lse,
           int B, int H, int Tq, int C, int d, float scale, void* stream) {
  if (B * H == 0 || Tq == 0) return 0;
  if (d < 1 || d > DMAX || C < 1) return (int)cudaErrorInvalidValue;
  const size_t align = QUANT ? 4 : 16;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(k) % align == 0 &&
                  reinterpret_cast<uintptr_t>(v) % align == 0;
  const size_t smem = smem_bytes(d);
  auto kern = vec ? decode_attention_kernel<QUANT, true>
                  : decode_attention_kernel<QUANT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), k, static_cast<const float*>(k_scale), v,
      static_cast<const float*>(v_scale), static_cast<const int*>(cache_len),
      static_cast<float*>(out), static_cast<float*>(lse), H, Tq, C, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,H,Tq,d) f32, k/v (B,H,C,d) f32, cache_len (B,) int32, out (B,H,Tq,d)
// f32, lse (B,H,Tq) f32 or null.  All contiguous; any Tq, C >= 1 and
// 1 <= d <= 256.  Returns cudaGetLastError().
int mx_decode_attention_f32(const void* q, const void* k, const void* v,
                            const void* cache_len, void* out, void* lse, int B,
                            int H, int Tq, int C, int d, float scale,
                            void* stream) {
  return launch<false>(q, k, nullptr, v, nullptr, cache_len, out, lse, B, H,
                       Tq, C, d, scale, stream);
}

// As above with k/v int8 (B,H,C,d) and k_scale/v_scale (B,H,C,1) f32.
int mx_decode_attention_int8(const void* q, const void* k, const void* k_scale,
                             const void* v, const void* v_scale,
                             const void* cache_len, void* out, void* lse, int B,
                             int H, int Tq, int C, int d, float scale,
                             void* stream) {
  return launch<true>(q, k, k_scale, v, v_scale, cache_len, out, lse, B, H, Tq,
                      C, d, scale, stream);
}

}  // extern "C"
