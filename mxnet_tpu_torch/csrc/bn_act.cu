// Batch-norm statistics and scale/shift + activation for Hopper (sm_90a),
// channel-last (rows, C) with C the fastest axis; x in f32, bf16 or f16.
//
// Replaces the TPU kernels of mxnet_tpu/kernels/bn_act.py:
//   * `_bn_stats_kernel` (launched by `_stats_pallas`): the per-channel
//     sum and sum of squares in one read of x; here they are folded into
//     the batch statistics of the JAX package's formula,
//       mean = s / n,   var = max(ss / n - mean^2, 0)   (one-pass),
//   * `_bn_apply_kernel` (launched by `_apply_pallas`):
//       y = x * scale[c] + shift[c],   then relu when asked,
//     with the product and the sum rounded on their own (__fmul_rn,
//     __fadd_rn: never contracted into an FMA), as the plain version
//     computes them.
//
// 16-bit x (bf16, f16) follows the JAX package's rules: the statistics
// and the fold in f32 (mean and var written as f32), scale and shift
// rounded to x's type (gamma and beta come in x's type, the trainer's
// compute type), y in x's type with the rounding XLA on the CPU gives
// the TPU kernel's `x * scale + shift`: bf16 rounds the product to bf16
// and then the sum (two roundings), f16 rounds the f32 sum once.  The
// product of two 16-bit values is exact in f32, so __fmul_rn + a round
// is the bf16 product; the kernels match their plain versions bit for
// bit.  A 16-bit x streams 8 values (16 bytes) a load where C % 8 == 0
// and the pointers are 16-byte aligned, else one value a load (views at
// any 2-byte offset).
//
// Design.  The TPU kernel walks row blocks in order and carries the sums
// in its output block; here blocks run in parallel in no order, so the
// statistics are a two-level reduction with no float atomics, in one
// launch (`bn_stats_fold`):
//   1. a (column blocks, row splits) grid.  A block of 256 threads is TX
//      column groups (VEC = 4 floats each when C % 4 == 0, else 1) by
//      TY = 256 / TX rows; a thread keeps its column group fixed and
//      strides over the rows of its split, so a warp reads whole
//      contiguous row segments (16-byte loads) and the channel index
//      never has to be recomputed.  Each thread sums in float64 (the
//      stem's 1.6 M rows would lose digits in one f32 accumulator), the
//      block folds its TY rows in a fixed order (xor shuffles within a
//      warp, then the warps in order) and writes one partial (s, ss) per
//      split;
//   2. the last block of each column block to finish (an int ticket a
//      column block, taken after a __threadfence) adds the splits'
//      partials in float64 in a fixed order (its 256 threads split the
//      column block's 2 CB sums, two neighbouring sums a thread by
//      16-byte loads, G = 256 / CB threads a pair striding over the
//      splits with 16 loads in flight, then the G sums in order; the
//      wrapper plans column blocks of at most 16 columns, so that this
//      serial tail is short and many blocks share it), writes mean and
//      var and folds them with
//      gamma and beta into the apply pass's per-channel
//        scale = gamma * rsqrt(var + eps),
//        shift = beta - (mean * gamma) * rsqrt(var + eps),
//      each operation rounded on its own as the plain version computes it,
//      and resets the ticket.
// The partition depends only on (rows, C, the SM count) and the combine
// order not on which block arrives last, so the result is the same on
// every run on a card.  The tickets and partials are a workspace the
// wrapper keeps per device and stream (tickets zeroed once).  `bn_apply`
// plans the same kind of grid with wider column blocks (up to 32 column
// groups): a thread loads its channels' scale and shift once into
// registers and streams rows.
//
// What bounds it on an H100.  Bytes: stats reads x once (4 bytes an
// element in f32, 2 in 16 bits, for 2 f64 adds and 1 conversion, far
// below the FP64 and conversion rates at 3.35 TB/s; the partials are
// small beside x, and at the small row counts of ResNet-50's last stages
// the launch and the combine's serial tail are the time, which one
// launch and no separate fold keep short); apply reads x and writes y
// (8 bytes an element in f32, 4 in 16 bits, for 2 flops).  At
// ResNet-50's stem (128 x 112 x 112 x 64: 411 MB in f32) the bounds are
// 0.123 ms and 0.245 ms in f32, 0.061 ms and 0.123 ms in 16 bits.  The
// design's only job is to stream: 16-byte accesses, enough of them in
// flight, partials small beside x.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// f32 -> T, round to nearest even (inf past the type's range)
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(v);
  else
    return v;
}

// Two 16-bit values of a 32-bit word as floats (bf16 is the high half
// of an f32, so its conversion is a shift), and back.
template <typename T>
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xffff0000u);
  } else {
    lo = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    hi = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return (uint32_t)__bfloat16_as_ushort(lo) |
           ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  else
    return (uint32_t)__half_as_ushort(lo) |
           ((uint32_t)__half_as_ushort(hi) << 16);
}

// p[0 .. VEC) as floats: one 16-byte load at VEC = 4 (f32) or 8 (16-bit
// T), else one value at a time.
template <int VEC, typename T>
__device__ __forceinline__ void load_x(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 4 && std::is_same<T, float>::value) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (VEC == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    unpack2<T>(t.x, v[0], v[1]);
    unpack2<T>(t.y, v[2], v[3]);
    unpack2<T>(t.z, v[4], v[5]);
    unpack2<T>(t.w, v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_f(p[k]);
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_y(T* p, const T (&o)[VEC]) {
  if constexpr (VEC == 4 && std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2<T>(o[0], o[1]), pack2<T>(o[2], o[3]),
                   pack2<T>(o[4], o[5]), pack2<T>(o[6], o[7]));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = o[k];
  }
}

// x * scale + shift in T, rounded as the plain version (and XLA on the
// CPU) rounds it: f32 and f16 the f32 product and sum rounded once to T;
// bf16 the product rounded to bf16, then the sum.
template <typename T>
__device__ __forceinline__ T affine(float x, float s, float b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return from_f<T>(__fadd_rn(to_f(from_f<T>(__fmul_rn(x, s))), b));
  else
    return from_f<T>(__fadd_rn(__fmul_rn(x, s), b));
}

// One launch: a (column blocks, row splits) grid.  Every block sums its
// split's rows of its column groups (float64) and writes one partial
// (s, ss) to `part` ([splits][2][C]); then, after a fence, takes a
// ticket from its column block's counter.  The block that draws the last
// ticket adds that column block's partials in a fixed order (the same
// whichever block arrives last), writes mean and var and the fold, and
// sets the counter back to 0 for the next call.  stats: mean and var,
// f32 rows of stride `ldo`; fold: scale and shift in T, rows of stride
// `ldo`.
template <int VEC, typename T>
__global__ void __launch_bounds__(NT)
bn_stats_fold(const T* __restrict__ x, const T* __restrict__ gamma,
              const T* __restrict__ beta, float eps, long long rows,
              int c, long long rows_per_split, double* __restrict__ part,
              int* __restrict__ ticket, float* __restrict__ stats,
              T* __restrict__ fold, int ldo) {
  constexpr int NW = NT / 32;
  __shared__ double red[NW][2 * VEC][32];
  __shared__ double2 pairs[NT];
  __shared__ double fin[2][32 * VEC];
  __shared__ int last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx, lane = tid & 31, warp = tid >> 5;
  const int cv = blockIdx.x * blockDim.x + tx;  // column group
  const bool live = cv < c / VEC;
  const long long r0 = (long long)blockIdx.y * rows_per_split;
  const long long r1 = r0 + rows_per_split < rows ? r0 + rows_per_split
                                                  : rows;
  double sum[2 * VEC];  // s of the thread's columns, then ss
#pragma unroll
  for (int k = 0; k < 2 * VEC; ++k) sum[k] = 0.0;
  if (live) {
    const T* col = x + (long long)cv * VEC;
#pragma unroll 8
    for (long long r = r0 + ty; r < r1; r += blockDim.y) {
      float v[VEC];
      load_x<VEC, T>(col + r * c, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const double d = (double)v[k];
        sum[k] += d;
        sum[VEC + k] = fma(d, d, sum[VEC + k]);
      }
    }
  }
  // The block's rows folded in a fixed order: a warp's 32 / TX rows by
  // xor shuffles (every lane ends with the same bits), then the warps'
  // sums in warp order.
#pragma unroll
  for (int k = 0; k < 2 * VEC; ++k)
    for (int o = blockDim.x; o < 32; o <<= 1)
      sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], o);
  if (lane < (int)blockDim.x) {
#pragma unroll
    for (int k = 0; k < 2 * VEC; ++k) red[warp][k][lane] = sum[k];
  }
  __syncthreads();
  if (ty == 0 && live) {  // tid == tx: lane tx of every warp
    double* o = part + (long long)blockIdx.y * 2 * c + (long long)cv * VEC;
#pragma unroll
    for (int k = 0; k < 2 * VEC; ++k) {
      double acc = red[0][k][tx];
      for (int w = 1; w < NW; ++w) acc += red[w][k][tx];
      o[k < VEC ? k : c + k - VEC] = acc;
    }
    __threadfence();  // the partial is visible before the ticket is taken
  }
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(ticket + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;

  // The combine, in a fixed order: the column block's CB columns have 2 CB
  // sums (s, then ss); each pair of neighbouring sums (16-byte loads; one
  // sum a thread when C or CB is odd) has G threads, thread j adding
  // splits j, j + G, ... in turn, neighbouring threads on neighbouring
  // partials; thread 0 of each then adds the G sums in order.
  const int cb = blockDim.x * VEC, col0 = blockIdx.x * cb;
  const int splits = gridDim.y;
  if ((c & 1) == 0 && (cb & 1) == 0) {
    const int half = cb >> 1, G = NT / cb;
    const int q = tid % cb, j = tid / cb;
    const int k0 = 2 * (q < half ? q : q - half);  // the pair's first column
    double2 acc = make_double2(0.0, 0.0);
    if (col0 + k0 < c) {
      const double2* p = reinterpret_cast<const double2*>(
          part + (q < half ? 0 : c) + col0 + k0);
#pragma unroll 16
      for (int i = j; i < splits; i += G) {
        const double2 t = __ldcg(p + (long long)i * c);
        acc.x += t.x;
        acc.y += t.y;
      }
    }
    pairs[tid] = acc;
    __syncthreads();
    if (j == 0 && col0 + k0 < c) {
      for (int i = 1; i < G; ++i) {
        acc.x += pairs[q + i * cb].x;
        acc.y += pairs[q + i * cb].y;
      }
      fin[q < half ? 0 : 1][k0] = acc.x;
      fin[q < half ? 0 : 1][k0 + 1] = acc.y;
    }
  } else {
    const int nv = 2 * cb, G = NT / nv;
    const int v = tid % nv, j = tid / nv;
    const int k = v < cb ? v : v - cb;
    double acc = 0.0;
    if (col0 + k < c) {
      const double* p = part + (v < cb ? 0 : c) + col0 + k;
#pragma unroll 16
      for (int i = j; i < splits; i += G)
        acc += __ldcg(p + (long long)i * 2 * c);
    }
    pairs[tid].x = acc;
    __syncthreads();
    if (j == 0 && col0 + k < c) {
      for (int i = 1; i < G; ++i) acc += pairs[v + i * nv].x;
      fin[v < cb ? 0 : 1][k] = acc;
    }
  }
  __syncthreads();
  const int col = col0 + tid;
  if (tid < cb && col < c) {
    const double n = (double)rows;
    const double m = fin[0][tid] / n;
    double var = fin[1][tid] / n - m * m;
    var = var < 0.0 ? 0.0 : var;  // clamps last-bit negatives; NaN stays
    const float mf = (float)m, vf = (float)var;
    // the plain version's fold in f32, each operation rounded on its own,
    // then scale and shift rounded to x's type
    const float inv = __frsqrt_rn(__fadd_rn(vf, eps));
    const float g = to_f(gamma[col]);
    stats[col] = mf;
    stats[ldo + col] = vf;
    fold[col] = from_f<T>(__fmul_rn(g, inv));
    fold[ldo + col] = from_f<T>(
        __fsub_rn(to_f(beta[col]), __fmul_rn(__fmul_rn(mf, g), inv)));
  }
  if (tid == 0) ticket[blockIdx.x] = 0;  // ready for the next call
}

template <int VEC, bool RELU, typename T>
__global__ void __launch_bounds__(NT)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ shift, T* __restrict__ y,
                long long rows, int c, long long rows_per_split) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int cv = blockIdx.x * blockDim.x + tx;
  if (cv >= c / VEC) return;
  float sc[VEC], sh[VEC];
  load_x<VEC, T>(scale + (long long)cv * VEC, sc);
  load_x<VEC, T>(shift + (long long)cv * VEC, sh);
  const long long r0 = (long long)blockIdx.y * rows_per_split;
  const long long r1 = r0 + rows_per_split < rows ? r0 + rows_per_split
                                                  : rows;
  const long long off = (long long)cv * VEC;
#pragma unroll 4
  for (long long r = r0 + ty; r < r1; r += blockDim.y) {
    float v[VEC];
    load_x<VEC, T>(x + r * c + off, v);
    T o[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      T t = affine<T>(v[k], sc[k], sh[k]);
      // relu; NaN stays NaN, as in torch.relu
      if constexpr (RELU) t = to_f(t) < 0.f ? from_f<T>(0.f) : t;
      o[k] = t;
    }
    store_y<VEC, T>(y + r * c + off, o);
  }
}

// The grid the Python wrapper planned (kernels/bn_act.py `plan`): tx
// column groups by 256 / tx rows a block, col_blocks x splits blocks;
// vec is 1 or the values of one 16-byte access, `wide`.
bool bad_plan(long long rows, int c, int vec, int wide, int tx,
              int col_blocks, int splits, long long rows_per_split) {
  if (rows < 1 || c < 1 || (vec != 1 && vec != wide) || c % vec != 0)
    return true;
  if (tx < 1 || tx > NT || NT % tx != 0 || (tx & (tx - 1)) != 0) return true;
  if ((long long)col_blocks * tx < c / vec || splits < 1 || splits > 65535)
    return true;
  return rows_per_split < 1 || (long long)splits * rows_per_split < rows;
}

template <typename T>
int stats_launch(const void* x, const void* gamma, const void* beta,
                 float eps, long long rows, int c, int vec, int tx,
                 int col_blocks, int splits, long long rows_per_split,
                 void* part, void* ticket, void* out, int ldo,
                 void* stream) {
  constexpr int WIDE = 16 / sizeof(T);
  if (bad_plan(rows, c, vec, WIDE, tx, col_blocks, splits, rows_per_split) ||
      ldo < c || ldo % WIDE != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 block(tx, NT / tx), grid(col_blocks, splits);
  const auto* xt = static_cast<const T*>(x);
  const auto* g = static_cast<const T*>(gamma);
  const auto* bt = static_cast<const T*>(beta);
  auto* pd = static_cast<double*>(part);
  auto* tk = static_cast<int*>(ticket);
  auto* stats = static_cast<float*>(out);
  auto* fold = reinterpret_cast<T*>(stats + 2 * (long long)ldo);
  if (vec == WIDE)
    bn_stats_fold<WIDE, T><<<grid, block, 0, st>>>(
        xt, g, bt, eps, rows, c, rows_per_split, pd, tk, stats, fold, ldo);
  else
    bn_stats_fold<1, T><<<grid, block, 0, st>>>(
        xt, g, bt, eps, rows, c, rows_per_split, pd, tk, stats, fold, ldo);
  return (int)cudaGetLastError();
}

template <int VEC, typename T>
void apply_relu_or_not(const dim3& grid, const dim3& block, cudaStream_t st,
                       int relu, const T* x, const T* sc, const T* sh, T* y,
                       long long rows, int c, long long rows_per_split) {
  if (relu)
    bn_apply_kernel<VEC, true, T><<<grid, block, 0, st>>>(
        x, sc, sh, y, rows, c, rows_per_split);
  else
    bn_apply_kernel<VEC, false, T><<<grid, block, 0, st>>>(
        x, sc, sh, y, rows, c, rows_per_split);
}

template <typename T>
int apply_launch(const void* x, const void* scale, const void* shift,
                 void* y, long long rows, int c, int relu, int vec, int tx,
                 int col_blocks, int splits, long long rows_per_split,
                 void* stream) {
  constexpr int WIDE = 16 / sizeof(T);
  if (bad_plan(rows, c, vec, WIDE, tx, col_blocks, splits, rows_per_split))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 block(tx, NT / tx), grid(col_blocks, splits);
  const auto* xt = static_cast<const T*>(x);
  const auto* sc = static_cast<const T*>(scale);
  const auto* sh = static_cast<const T*>(shift);
  auto* yt = static_cast<T*>(y);
  if (vec == WIDE)
    apply_relu_or_not<WIDE, T>(grid, block, st, relu, xt, sc, sh, yt, rows,
                               c, rows_per_split);
  else
    apply_relu_or_not<1, T>(grid, block, st, relu, xt, sc, sh, yt, rows, c,
                            rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// The entries, one a type.  Each launches once and returns
// cudaGetLastError() after it (0 on success).
//
// stats: x (rows, c) row-major; gamma, beta: c values of x's type; vec 1
// or 16 bytes of values (x 16-byte aligned then); part: splits * 2 * c
// f64 scratch; ticket: col_blocks ints, 0 before the call and after it;
// out: f32 rows mean and var of stride ldo (ldo >= c, a multiple of 16
// bytes of x's type), then the rows scale and shift in x's type at the
// same stride.
//
// apply: x, y (rows, c) row-major; scale, shift: c values of x's type
// (all four 16-byte aligned when vec > 1); relu: 1 for relu, 0 for
// identity.
#define MX_BN_ENTRIES(SFX, T)                                                \
  int mx_bn_stats_##SFX(const void* x, const void* gamma, const void* beta, \
                        float eps, long long rows, int c, int vec, int tx,   \
                        int col_blocks, int splits,                          \
                        long long rows_per_split, void* part, void* ticket,  \
                        void* out, int ldo, void* stream) {                  \
    return stats_launch<T>(x, gamma, beta, eps, rows, c, vec, tx,            \
                           col_blocks, splits, rows_per_split, part, ticket, \
                           out, ldo, stream);                                \
  }                                                                          \
  int mx_bn_apply_##SFX(const void* x, const void* scale, const void* shift, \
                        void* y, long long rows, int c, int relu, int vec,   \
                        int tx, int col_blocks, int splits,                  \
                        long long rows_per_split, void* stream) {            \
    return apply_launch<T>(x, scale, shift, y, rows, c, relu, vec, tx,       \
                           col_blocks, splits, rows_per_split, stream);      \
  }

extern "C" {
MX_BN_ENTRIES(f32, float)
MX_BN_ENTRIES(bf16, __nv_bfloat16)
MX_BN_ENTRIES(f16, __half)
}  // extern "C"
