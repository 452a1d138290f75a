// Flash-attention forward for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py `_flash_kernel`
// (launched by `_flash_forward_pallas`).  For each (b, h) and each query
// row it attends the key positions kpos < kv_end, where kv_end is Tk or,
// with a per-row length, min(Tk, kv_len[b]); with `causal` a query at
// position qpos also needs kpos <= qpos (no offset between the two axes,
// as the TPU kernel and `_merge_mask` define it).  Online softmax: running
// max, sum and accumulator in f32.  A row with no key to attend gives
// output 0 and lse -inf.  Optionally writes the f32 row log-sum-exp.
//
// Design.  Grid (B*H, ceil(Tq/64)), 256 threads.  A block stages its 64
// query rows in shared memory, then walks kv tiles of 64 positions up to
// kv_end (and, with `causal`, up to its last row's diagonal): that loop
// takes the place of the TPU kernel's sequential kv grid axis, and ending
// it early is the TPU kernel's block skip.  The threads form a 16 x 16
// grid (ty, tx); thread (ty, tx) owns query rows ty + 16 i (i < 4), score
// columns tx + 16 j (j < 4) and output columns 4 tx + 64 n .. +3
// (n < NCHUNK = ceil(d / 64)).  Scores are 4x4 register micro-tiles fed by
// 16-byte shared loads (row stride d + 4 keeps a quarter-warp's loads on
// distinct banks); the row max and sum are shuffles within a half-warp,
// since a row's 16 owners are lanes of one warp; P goes through shared
// memory to the P.V product.  Everything runs on CUDA cores in f32.
// Positions past kv_end are loaded as zeros, so garbage there (NaN in the
// tests) never meets a probability, and a masked score is set to -inf by
// selection, never by arithmetic.  Query rows past Tq are computed on
// zeros and not written; any Tq, Tk >= 1 works, so nothing needs the TPU
// kernel's "not tile-able" fallback.  Any 1 <= d <= 256: shared rows are
// zero-padded to dp = d rounded up to 8, so the float4 compute loops run
// over dp columns; tiles load as 16-byte vectors when d % 4 == 0 and the
// inputs are 16-byte aligned, element by element otherwise, and only the
// d real columns are stored.  The vector path is a template parameter
// and keeps its one float4 shared store per load: with the element path
// beside it in one statement, nvcc split that store into four (measured
// at d = 64: 3.5% slower, 32 scalar STS in place of 8 STS.128).
//
// What bounds it on an H100.  At the serving shapes (d = 64, T up to
// 512) the work is 4 d flops per attended (query, key) pair against
// 4 d bytes per row of q, k, v and out: about T flops per byte, so it is
// bound by arithmetic, at the f32 CUDA-core rate (67 TFLOP/s).  This
// first version keeps the products on CUDA cores and loads each tile
// with plain loads, no overlap of load and compute; TF32/bf16 tensor
// cores (wgmma), TMA or cp.async double buffering and a bf16 I/O variant
// are the later work.  Shared memory is (3 * 64 * (dp + 4) + 64 * 68) * 4
// bytes: 68 KB at d = 64, 212 KB at d = 256, above the 48 KB default, so
// the launch raises the kernel's dynamic shared-memory limit first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // key positions per kv tile
constexpr int NT = 256;    // threads per block: a 16 x 16 grid
constexpr int RPT = 4;     // query rows per thread (BQ / 16)
constexpr int CPT = 4;     // score columns per thread (BK / 16)
constexpr int PS = BK + 4; // row stride of the P tile
constexpr int DMAX = 256;

size_t smem_bytes(int dp) {
  return sizeof(float) * (3 * (size_t)BQ * (dp + 4) + (size_t)BQ * PS);
}

// Copy rows [row0, row0 + BQ) of a (rows, d) matrix into a shared tile
// with row stride ds, columns d..dp zero; rows at or past `valid` are
// written as zeros.  16-byte loads with VEC (d % 4 == 0, 16-byte
// aligned source), one element at a time otherwise.
template <bool VEC>
__device__ void load_rows(float* dst, const float* src, int row0, int valid,
                          int d, int dp, int ds) {
  const int n4 = BQ * dp / 4;
  for (int i = threadIdx.x; i < n4; i += NT) {
    const int e = i * 4;
    const int r = e / dp;
    const int c = e - r * dp;
    if (VEC) {  // one float4 store (see the header)
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < valid && c < d)
        x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * d +
                                             c);
      *reinterpret_cast<float4*>(dst + r * ds + c) = x;
    } else {
      const bool ok = row0 + r < valid;
      const float* sr = src + (size_t)(row0 + r) * d + c;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[r * ds + c + k] = ok && c + k < d ? sr[k] : 0.f;
    }
  }
}

template <int NCHUNK, bool VEC>
__global__ void __launch_bounds__(NT, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ kv_len,
                       float* __restrict__ out, float* __restrict__ lse, int H,
                       int Tq, int Tk, int d, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 7) & ~7;  // d padded to 8 with zero columns
  const int ds = dp + 4;
  float* sq = smem;             // BQ x ds   query rows
  float* sk = sq + BQ * ds;     // BK x ds   key tile
  float* sv = sk + BK * ds;     // BK x ds   value tile
  float* sp = sv + BK * ds;     // BQ x PS   probabilities

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int nrows = min(BQ, Tq - q0);

  int kv_end = Tk;
  if (kv_len != nullptr) kv_end = min(Tk, max(0, kv_len[bh / H]));
  if (causal) kv_end = min(kv_end, q0 + nrows);  // last row's diagonal + 1

  const float* qb = q + (size_t)bh * Tq * d;
  const float* kb = k + (size_t)bh * Tk * d;
  const float* vb = v + (size_t)bh * Tk * d;
  load_rows<VEC>(sq, qb, q0, Tq, d, dp, ds);

  float m[RPT], l[RPT], acc[RPT][NCHUNK][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<VEC>(sk, kb, k0, kv_end, d, dp, ds);
    load_rows<VEC>(sv, vb, k0, kv_end, d, dp, ds);
    __syncthreads();

    // s = q k^T on a 4x4 micro-tile: rows ty + 16 i, keys tx + 16 j.
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < dp; c += 4) {
      float4 qa[RPT], ka[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * ds + c);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        ka[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * ds + c);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // Mask, then the online-softmax update.  A row's 16 owners are the
    // lanes of one half-warp, so xor-shuffles over 8, 4, 2, 1 reduce it.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < kv_end && (!causal || qpos >= kpos);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row masked so far keeps exp() finite
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - safe);
        sp[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = (m[i] == -INFINITY) ? 0.f : expf(m[i] - safe);
      m[i] = m_new;
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int n = 0; n < NCHUNK; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][n][c] *= corr;
    }
    __syncthreads();

    // acc += P V over this tile's live positions (a multiple of 4; the
    // positions past kv_end hold p = 0 and zero values).
    const int jend = min(BK, ((kv_end - k0) + 3) & ~3);
    for (int j4 = 0; j4 < jend; j4 += 4) {
      float4 pa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sp + (ty + 16 * i) * PS + j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int n = 0; n < NCHUNK; ++n) {
          const int c = 4 * tx + 64 * n;
          if (c < dp) {
            const float4 x =
                *reinterpret_cast<const float4*>(sv + (j4 + jj) * ds + c);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float p = jj == 0 ? pa[i].x
                            : jj == 1 ? pa[i].y
                            : jj == 2 ? pa[i].z : pa[i].w;
              acc[i][n][0] = fmaf(p, x.x, acc[i][n][0]);
              acc[i][n][1] = fmaf(p, x.y, acc[i][n][1]);
              acc[i][n][2] = fmaf(p, x.z, acc[i][n][2]);
              acc[i][n][3] = fmaf(p, x.w, acc[i][n][3]);
            }
          }
        }
      }
    }
  }

  float* ob = out + (size_t)bh * Tq * d;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n) {
      const int c = 4 * tx + 64 * n;
      if (VEC) {
        if (c < d)
          *reinterpret_cast<float4*>(ob + (size_t)(q0 + r) * d + c) =
              make_float4(acc[i][n][0] * inv, acc[i][n][1] * inv,
                          acc[i][n][2] * inv, acc[i][n][3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) ob[(size_t)(q0 + r) * d + c + e] = acc[i][n][e] * inv;
      }
    }
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Tq + q0 + r] = m[i] + logf(l[i] == 0.f ? 1.f : l[i]);
  }
}

template <int NCHUNK>
int launch(const float* q, const float* k, const float* v, const int* kv_len,
           float* out, float* lse, int B, int H, int Tq, int Tk, int d,
           int causal, float scale, int vec, cudaStream_t stream) {
  const size_t smem = smem_bytes((d + 7) & ~7);
  auto kern = vec ? flash_attention_kernel<NCHUNK, true>
                  : flash_attention_kernel<NCHUNK, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(q, k, v, kv_len, out, lse, H, Tq, Tk, d,
                                   causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,H,Tq,d), k/v (B,H,Tk,d), out (B,H,Tq,d): f32, contiguous.  kv_len
// (B,) int32 or null (every row attends all Tk keys); lse (B,H,Tq) f32 or
// null.  causal: 0 or 1.  1 <= d <= 256.
// Returns cudaGetLastError() after the launch (0 on success).
int mx_flash_attention_f32(const void* q, const void* k, const void* v,
                           const void* kv_len, void* out, void* lse, int B,
                           int H, int Tq, int Tk, int d, int causal,
                           float scale, void* stream) {
  if (B * H == 0 || Tq == 0) return 0;
  if (d < 1 || d > DMAX || Tk < 1) return (int)cudaErrorInvalidValue;
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = d % 4 == 0 && a16(q) && a16(k) && a16(v) && a16(out);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* lens = static_cast<const int*>(kv_len);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1:
      return launch<1>(qf, kf, vf, lens, of, lf, B, H, Tq, Tk, d, causal,
                       scale, vec, st);
    case 2:
      return launch<2>(qf, kf, vf, lens, of, lf, B, H, Tq, Tk, d, causal,
                       scale, vec, st);
    case 3:
      return launch<3>(qf, kf, vf, lens, of, lf, B, H, Tq, Tk, d, causal,
                       scale, vec, st);
    default:
      return launch<4>(qf, kf, vf, lens, of, lf, B, H, Tq, Tk, d, causal,
                       scale, vec, st);
  }
}

}  // extern "C"
