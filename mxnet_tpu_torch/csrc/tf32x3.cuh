// Shared building blocks of the port's attention kernels on Hopper tensor
// cores (sm_90a): `cp.async` copies into shared memory, the 3xTF32 split
// and `mma.sync.m16n8k8` products, and the fragment loaders around them.
// Included by flash_attention.cu, decode_attention.cu (through
// flash_fwd.cuh) and flash_attention_bwd.cu.
//
// 3xTF32.  TF32 keeps 10 mantissa bits, far from the f32 bar the port
// holds (atol = rtol = 1e-4 against the plain version with TF32 off), so
// every operand x is split as hi = tf32(x), lo = tf32(x - hi) and each
// product is three MMAs, lo*hi' + hi*lo' + hi*hi' (the split of CUTLASS's
// OpMultiplyAddFastF32; lo*lo' is below f32 rounding).  The split is
// integer adds and masks on the f32 bits, not `cvt`.  Nothing sets a
// global TF32 flag.
//
// `mma.sync` rather than `wgmma`: its accumulator fragment is an operand
// fragment after a fixed permutation of the depth axis (a thread holds
// columns 2t and 2t+1 of its rows; read as depth t and t+4, with the B rows
// read in the same order), so a probability tile goes from the score
// product into the next product in registers, with no shared-memory round
// trip and no transpose.
//
// Tiles.  A streamed tile lands raw (f32, or int8 bytes with one f32 scale
// a row), is split once for the whole block into hi and lo arrays (int8
// dequantized on the way), and the warps read their B fragments from the
// split arrays.  Row stride dp + 4 (= 4 mod 32 words, dp the width padded
// to 8) keeps every fragment load of a warp on 32 distinct banks, both for
// rows-as-columns and for the permuted reads of the second product.
// Columns past the real width and rows past the valid count are zero-filled
// by the copy itself (source size 0), so garbage there (NaN in the tests)
// never meets a probability.
//
// 16-bit operands (bf16, f16; the last section).  Tiles of 16-bit rows
// land in shared memory as raw bits at row stride DS16 = 72 elements (144
// bytes: 16-byte rows for `ldmatrix`, and 36 words, so the eight rows a
// fragment load touches start on eight distinct 4-bank groups).  Products
// of two 16-bit operands are exact in f32, so they run as one
// `mma.sync.m16n8k16` with f32 accumulators.  Products of an f32 operand
// (a probability or dS, from an accumulator) with a 16-bit one run either
// as two TF32 MMAs, a_hi b + a_lo b (`mma2_c16`: every bf16 and f16 value
// is exact in TF32, so the 16-bit side has no low part), or, at half the
// tensor-core time, as two m16n8k16 MMAs on a split in the operand's own
// type, a = hi + lo (`split16`, `mma_hl16`), f16 scaled by a power of two
// first to stay in its range.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ------------------------------------------------------------- copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + R) x columns [col0, col0 + n) of a row-major f32
// matrix of row stride ld into a shared tile of row stride ds: tile column
// c is source column col0 + c for c < n, zero for n <= c < np (np a
// multiple of 4); rows at or past `valid` zero.  16-byte copies with `vec`
// (n, col0 and ld multiples of 4, the base 16-byte aligned), 4-byte copies
// otherwise.  Thread `tid` of NT; a thread's chunks advance by a fixed
// (row, column) step: no division in the loop.
template <int R, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int valid, int ld,
                                          int col0, int n, int np, int ds,
                                          bool vec, int tid) {
  const int w = vec ? 4 : 1;     // floats a copy moves
  const int cpr = np / w;        // copies a row
  const int rstep = NT / cpr, cstep = NT - rstep * cpr;
  int r = tid / cpr, c = tid - r * cpr;
  while (r < R) {
    const int col = c * w;
    const bool ok = row0 + r < valid && col < n;
    const float* from =
        ok ? src + (size_t)(row0 + r) * ld + col0 + col : src;
    if (vec)
      cp16(dst + r * ds + col, from, ok);
    else
      cp4(dst + r * ds + col, from, ok);
    r += rstep;
    c += cstep;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// The same for int8 rows into a shared byte tile of row stride dsb (a
// multiple of 16): `mode` 16 copies 16 bytes (n, col0, ld multiples of 16,
// the base 16-byte aligned), 4 copies 4 bytes (multiples of 4), 1 loads
// and stores byte by byte (any width; visible after the next barrier).
// np is a multiple of 16 in mode 16, of 4 otherwise.
template <int R, int NT>
__device__ __forceinline__ void load_tile_i8(int8_t* dst, const int8_t* src,
                                             int row0, int valid, int ld,
                                             int col0, int n, int np,
                                             int dsb, int mode, int tid) {
  const int cpr = np / mode;
  const int rstep = NT / cpr, cstep = NT - rstep * cpr;
  int r = tid / cpr, c = tid - r * cpr;
  while (r < R) {
    const int col = c * mode;
    const bool ok = row0 + r < valid && col < n;
    const int8_t* from =
        ok ? src + (size_t)(row0 + r) * ld + col0 + col : src;
    if (mode == 16)
      cp16(dst + r * dsb + col, from, ok);
    else if (mode == 4)
      cp4(dst + r * dsb + col, from, ok);
    else
      dst[r * dsb + col] = ok ? *from : (int8_t)0;
    r += rstep;
    c += cstep;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// n values [row0, row0 + n) of an f32 vector, zero at or past `valid`.
template <int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int n, int valid,
                                         int tid) {
  for (int i = tid; i < n; i += NT) {
    const bool ok = row0 + i < valid;
    cp4(dst + i, ok ? src + row0 + i : src, ok);
  }
}

// ------------------------------------------------------- 3xTF32 MMA
// x = hi + lo with hi, lo TF32 values (low 13 bits zero): hi rounds x to
// nearest on its 10-bit mantissa (add half a TF32 ulp, then mask), lo is
// the exact rest x - hi truncated to TF32.  |x - hi - lo| <= 2^-21 |x|.
// Integer and f32 adds and masks, all at full rate; `cvt.rna.tf32.f32`
// would do the rounding on the conversion unit at a quarter of the rate,
// twice per split.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  // not volatile: the compiler may interleave independent MMAs
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[j] += a b[j] for every tile j < N, both operands split: the three
// products lo*hi', hi*lo', hi*hi' (lo*lo' is below f32 rounding) each in
// its own pass over j, so the MMAs into one accumulator are N issues apart
// and the tensor pipe never waits on the last one.  No tile is skipped
// here: an MMA under a condition the compiler cannot prove warp-uniform
// gets a WARPSYNC and a reconvergence branch of its own (one each, seen in
// the SASS), which cost more than the MMAs of a dead tile.
template <int N>
__device__ __forceinline__ void mma3_row(float (&c)[N][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[N][2],
                                         const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma(c[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(c[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(c[j], ah, bh[j]);
}

// Fragments, for lane (g, t) = (lane / 4, lane % 4).  A (16 x 8, rows by
// depth): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).  B (8 x 8,
// depth by columns): b0 (t, g), b1 (t+4, g).  C (16 x 8): c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).

// A from a row-major shared f32 tile, split here; `s` points at (row 0,
// depth 0).  Only a warp's own rows, so each value is split once.
__device__ __forceinline__ void frag_a(const float* s, int ds, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(s[g * ds + t], hi[0], lo[0]);
  split(s[(g + 8) * ds + t], hi[1], lo[1]);
  split(s[g * ds + t + 4], hi[2], lo[2]);
  split(s[(g + 8) * ds + t + 4], hi[3], lo[3]);
}

// An accumulator fragment (16 x 8) as an A fragment over its 8 columns,
// depth permuted: depth t = column 2t, depth t+4 = column 2t+1.
__device__ __forceinline__ void frag_c2a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// B fragments of the tiles j < N from a tile split in shared memory (hi
// part `h`, lo part `l`, same layout), either as the tile's rows read as
// columns, B(k, n) = tile[j * 8 + n][k] (`rows`), or as its columns
// col0 + j * 8.. in the permuted depth order of frag_c2a, B(k, n) =
// tile[perm(k)][col0 + j * 8 + n] with depth t at row 2t and t+4 at row
// 2t+1.  A column block at or past dp reads block dp - 8 instead (a
// select, not a branch): its products land in accumulators that are never
// stored.
template <int N, bool ROWS>
__device__ __forceinline__ void frags_b(const uint32_t* h, const uint32_t* l,
                                        int ds, int g, int t,
                                        uint32_t (&bh)[N][2],
                                        uint32_t (&bl)[N][2], int col0 = 0,
                                        int dp = 0) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int a0 = ROWS ? (j * 8 + g) * ds + t
                        : 2 * t * ds + min(col0 + j * 8, dp - 8) + g;
    const int a1 = ROWS ? a0 + 4 : a0 + ds;
    bh[j][0] = h[a0];
    bh[j][1] = h[a1];
    bl[j][0] = l[a0];
    bl[j][1] = l[a1];
  }
}

// hi and lo of rows [0, R) x columns [0, dp) of a shared f32 tile, once
// for the whole block (dp a multiple of 4).
template <int R, int NT>
__device__ __forceinline__ void split_tile(uint32_t* h, uint32_t* l,
                                           const float* raw, int dp,
                                           int ds) {
  const int cpr = dp >> 2;
  const int rstep = NT / cpr, cstep = NT - rstep * cpr;
  int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
  while (r < R) {
    const int at = r * ds + (c << 2);
    const float4 x = *reinterpret_cast<const float4*>(raw + at);
    uint4 xh, xl;
    split(x.x, xh.x, xl.x);
    split(x.y, xh.y, xl.y);
    split(x.z, xh.z, xl.z);
    split(x.w, xh.w, xl.w);
    *reinterpret_cast<uint4*>(h + at) = xh;
    *reinterpret_cast<uint4*>(l + at) = xl;
    r += rstep;
    c += cstep;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// The same from an int8 byte tile (row stride dsb) and its row scales:
// each value dequantized as (float)x * scale, the rounding of the plain
// version's `q.float() * scale`, then split.
template <int R, int NT>
__device__ __forceinline__ void split_tile_i8(uint32_t* h, uint32_t* l,
                                              const int8_t* raw,
                                              const float* sc, int dp,
                                              int dsb, int ds) {
  const int cpr = dp >> 2;
  const int rstep = NT / cpr, cstep = NT - rstep * cpr;
  int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
  while (r < R) {
    const char4 x =
        *reinterpret_cast<const char4*>(raw + r * dsb + (c << 2));
    const float s = sc[r];
    const int at = r * ds + (c << 2);
    uint4 xh, xl;
    split((float)x.x * s, xh.x, xl.x);
    split((float)x.y * s, xh.y, xl.y);
    split((float)x.z * s, xh.z, xl.z);
    split((float)x.w * s, xh.w, xl.w);
    *reinterpret_cast<uint4*>(h + at) = xh;
    *reinterpret_cast<uint4*>(l + at) = xl;
    r += rstep;
    c += cstep;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// ------------------------------------------------------------ stores
__device__ __forceinline__ void store_pair(float* p, float x, float y,
                                           int col, int d, bool vec2) {
  if (vec2 && col + 1 < d) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    if (col < d) p[0] = x;
    if (col + 1 < d) p[1] = y;
  }
}

// ------------------------------------------------------------ launches
// Raise a kernel's dynamic shared-memory limit to `smem` on the current
// device once: the attribute call costs host time on every launch
// otherwise.  `done` is per kernel (one static per instantiation of the
// caller) and per device.
template <typename K>
int set_smem(K kern, size_t smem, int (&done)[64]) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && done[dev] >= (int)smem) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < 64) done[dev] = (int)smem;
  return (int)e;
}

__host__ __device__ inline bool aligned_to(const void* p, size_t n) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % n == 0;
}

inline bool aligned16(const void* p) { return aligned_to(p, 16); }

// ---------------------------------------------------- 16-bit operands
constexpr int DS16 = 72;  // shared row stride of a 16-bit tile (elements)

__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// Elements a copy of 16-bit rows moves: 8 (16 bytes), 4 or 2 where the
// width and every pointer allow it, else 1 (a plain load and store).
inline int mode16(int d, const void* a, const void* b, const void* c,
                  const void* e = nullptr, const void* f = nullptr) {
  for (int m = 8; m > 1; m >>= 1) {
    const size_t n = 2 * (size_t)m;
    if (d % m == 0 && aligned_to(a, n) && aligned_to(b, n) &&
        aligned_to(c, n) && aligned_to(e, n) && aligned_to(f, n))
      return m;
  }
  return 1;
}

// Rows [row0, row0 + R) x columns [col0, col0 + n) of a row-major 16-bit
// matrix of row stride ld into a shared tile of stride DS16: tile column
// c is source column col0 + c for c < n, zero for n <= c < np (np a
// multiple of 8), rows at or past `valid` zero.  `mode` elements a copy
// (mode16; n, col0 and ld multiples of it); mode 1 stores synchronously,
// visible after the next barrier.
template <int R, int NT>
__device__ __forceinline__ void load_tile16(uint16_t* dst,
                                            const uint16_t* src, int row0,
                                            int valid, int ld, int col0,
                                            int n, int np, int mode,
                                            int tid) {
  const int cpr = np / mode;
  const int rstep = NT / cpr, cstep = NT - rstep * cpr;
  int r = tid / cpr, c = tid - r * cpr;
  while (r < R) {
    const int col = c * mode;
    const bool ok = row0 + r < valid && col < n;
    const uint16_t* from =
        ok ? src + (size_t)(row0 + r) * ld + col0 + col : src;
    uint16_t* to = dst + r * DS16 + col;
    if (mode == 8)
      cp16(to, from, ok);
    else if (mode == 4)
      cp8(to, from, ok);
    else if (mode == 2)
      cp4(to, from, ok);
    else
      *to = ok ? *from : (uint16_t)0;
    r += rstep;
    c += cstep;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

template <typename T>
constexpr bool kF16 = std::is_same<T, __half>::value;  // else bf16

// (x, y) rounded to T and packed, x in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack16(float x, float y) {
  if constexpr (kF16<T>) {
    const __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <typename T>
__device__ __forceinline__ uint16_t bits16(float x) {
  if constexpr (kF16<T>)
    return __half_as_ushort(__float2half_rn(x));
  else
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ float float16(uint16_t x) {
  if constexpr (kF16<T>)
    return __half2float(__ushort_as_half(x));
  else
    return __uint_as_float((uint32_t)x << 16);
}

// The two values of a packed pair as f32 bits (exact TF32 operands).
template <typename T>
__device__ __forceinline__ void unpack16(uint32_t r, uint32_t& lo,
                                         uint32_t& hi) {
  if constexpr (kF16<T>) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&r));
    lo = __float_as_uint(f.x);
    hi = __float_as_uint(f.y);
  } else {
    lo = r << 16;
    hi = r & 0xffff0000u;
  }
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 8 16-bit matrices, transposed: lanes 8e..8e+7 give the row
// addresses of matrix e (16 bytes each); register e of lane (g, t) holds
// (M_e[2t][g], M_e[2t + 1][g]).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b, m16n8k16, 16-bit operands, f32 accumulate.  Fragments for
// lane (g, t): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3
// (g+8, 2t+8..); b0 (2t..2t+1, g), b1 (2t+8..2t+9, g); c as m16n8k8's.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (kF16<T>)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s[j] += rows [0, 16) of the shared 16-bit tile `a` times rows
// [8j, 8j + 8) of the tile `b`, over depth [0, 64): S = A B^T, exact
// products.  Columns past a row's width are zeros in both tiles.
template <typename T, int NB>
__device__ __forceinline__ void scores16(float (&s)[NB][4],
                                         const uint16_t* a,
                                         const uint16_t* b, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    const uint16_t* ar = a + g * DS16 + kk + 2 * t;
    const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * DS16), ld32(ar + 8),
                            ld32(ar + 8 * DS16 + 8)};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint16_t* br = b + (j * 8 + g) * DS16 + kk + 2 * t;
      mma16<T>(s[j], af, ld32(br), ld32(br + 8));
    }
  }
}

// acc[n] += P V over NB / 2 chunks of 16 keys: P from the score
// accumulators rounded to T (tiles 2i and 2i+1 are the A fragment of
// chunk i as they stand), V rows 16i.. and columns 8n.. from the shared
// tile by transposed `ldmatrix`.
template <typename T, int NB, int NJ>
__device__ __forceinline__ void pv16(float (&acc)[NJ][4],
                                     const float (&p)[NB][4],
                                     const uint16_t* v, int lane) {
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) {
    const uint32_t a[4] = {pack16<T>(p[2 * i][0], p[2 * i][1]),
                           pack16<T>(p[2 * i][2], p[2 * i][3]),
                           pack16<T>(p[2 * i + 1][0], p[2 * i + 1][1]),
                           pack16<T>(p[2 * i + 1][2], p[2 * i + 1][3])};
    const uint16_t* vr =
        v + (16 * i + (lane & 7) + (lane & 8)) * DS16 + (lane >> 4) * 8;
#pragma unroll
    for (int m = 0; m < NJ / 2; ++m) {
      uint32_t r[4];
      ldsm_x4_t(r, vr + 16 * m);
      mma16<T>(acc[2 * m], a, r[0], r[1]);
      mma16<T>(acc[2 * m + 1], a, r[2], r[3]);
    }
  }
}

// acc[n] += X B: X the 16 x 8 accumulator fragment x (f32, split into
// TF32 hi and lo, depth permuted as frag_c2a), B rows [0, 8) of the
// shared 16-bit tile `b` (read in the same permuted order by transposed
// `ldmatrix`: depth t is row 2t, t + 4 row 2t + 1) at columns 8n..; two
// MMAs a product, lo first.
template <typename T, int NJ>
__device__ __forceinline__ void mma2_c16(float (&acc)[NJ][4],
                                         const float (&x)[4],
                                         const uint16_t* b, int lane) {
  uint32_t ah[4], al[4], bb[NJ][2];
  frag_c2a(x, ah, al);
  const uint16_t* br = b + (lane & 7) * DS16 + (lane >> 3) * 8;
#pragma unroll
  for (int m = 0; m < NJ / 4; ++m) {
    uint32_t r[4];
    ldsm_x4_t(r, br + 32 * m);
#pragma unroll
    for (int e = 0; e < 4; ++e) unpack16<T>(r[e], bb[4 * m + e][0],
                                            bb[4 * m + e][1]);
  }
#pragma unroll
  for (int n = 0; n < NJ; ++n) mma(acc[n], al, bb[n]);
#pragma unroll
  for (int n = 0; n < NJ; ++n) mma(acc[n], ah, bb[n]);
}

// Four 8 x 8 16-bit matrices: lanes 8e..8e+7 give the row addresses of
// matrix e (16 bytes each); register e of lane (g, t) holds
// (M_e[g][2t], M_e[g][2t + 1]).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// s[j] += A B^T over depth [0, 64), exact products: A rows [0, 16) of the
// shared 16-bit tile `a`, B^T rows [0, 8 NB) of the tile `b` (row n of b
// is column n of the product); both fragments by `ldmatrix`, one x4 for A
// and one for each pair of 8-column tiles a 16-deep step.
template <typename T, int NB>
__device__ __forceinline__ void scores16_ldsm(float (&s)[NB][4],
                                              const uint16_t* a,
                                              const uint16_t* b, int lane) {
  const uint16_t* ar = a + ((lane & 7) + (lane & 8)) * DS16 + (lane >> 4) * 8;
  const uint16_t* br =
      b + ((lane & 7) + ((lane >> 4) << 3)) * DS16 + (lane & 8);
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, ar + kk);
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      uint32_t bf[4];
      ldsm_x4(bf, br + j * 16 * DS16 + kk);
      mma16<T>(s[2 * j], af, bf[0], bf[1]);
      mma16<T>(s[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

// The two values of a packed T pair as floats.
template <typename T>
__device__ __forceinline__ float2 unpack_f2(uint32_t r) {
  if constexpr (kF16<T>)
    return __half22float2(*reinterpret_cast<const __half2*>(&r));
  else
    return make_float2(__uint_as_float(r << 16),
                       __uint_as_float(r & 0xffff0000u));
}

// (x, y) as two T pairs, hi = T(x, y) and lo = T((x, y) - hi): x - hi is
// exact in f32, so hi + lo keeps 16 (bf16) or 22 (f16) mantissa bits of
// x, where hi and lo stay in T's range.
template <typename T>
__device__ __forceinline__ void split16(float x, float y, uint32_t& hi,
                                        uint32_t& lo) {
  hi = pack16<T>(x, y);
  const float2 h = unpack_f2<T>(hi);
  lo = pack16<T>(x - h.x, y - h.y);
}

// The A fragments (hi, lo) of chunk i (columns 16i..16i+15) of a row of
// 16 x 8 accumulator tiles x, each value times `s0` (rows g) or `s1`
// (rows g + 8): tiles 2i and 2i+1 are an m16n8k16 A fragment as they
// stand.
template <typename T, int NB>
__device__ __forceinline__ void frag_split16(const float (&x)[NB][4], int i,
                                             float s0, float s1,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split16<T>(x[2 * i][0] * s0, x[2 * i][1] * s0, hi[0], lo[0]);
  split16<T>(x[2 * i][2] * s1, x[2 * i][3] * s1, hi[1], lo[1]);
  split16<T>(x[2 * i + 1][0] * s0, x[2 * i + 1][1] * s0, hi[2], lo[2]);
  split16<T>(x[2 * i + 1][2] * s1, x[2 * i + 1][3] * s1, hi[3], lo[3]);
}

// acc[n] += (ah + al) B: B rows [0, 16) of the shared 16-bit tile `b`
// (the depth) at columns 8n.. by transposed `ldmatrix`, not converted;
// two m16n8k16 MMAs a tile, every lo before any hi.
template <typename T, int NJ>
__device__ __forceinline__ void mma_hl16(float (&acc)[NJ][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint16_t* b, int lane) {
  const uint16_t* br =
      b + ((lane & 7) + (lane & 8)) * DS16 + (lane >> 4) * 8;
  uint32_t bb[NJ][2];
#pragma unroll
  for (int m = 0; m < NJ / 2; ++m) {
    uint32_t r[4];
    ldsm_x4_t(r, br + 16 * m);
    bb[2 * m][0] = r[0];
    bb[2 * m][1] = r[1];
    bb[2 * m + 1][0] = r[2];
    bb[2 * m + 1][1] = r[3];
  }
#pragma unroll
  for (int n = 0; n < NJ; ++n) mma16<T>(acc[n], al, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < NJ; ++n) mma16<T>(acc[n], ah, bb[n][0], bb[n][1]);
}

// f16's range in the split.  |x| above 65504 overflows hi, so f16
// operands are scaled by an exact power of two first: a row group that
// has seen values up to M (biased f32 exponent eb of M, at least
// kEbMin) multiplies by 2^(14 - e) (e = eb - 127), so |x| < 2^15, and its
// accumulators carry the factor 2^(e - 14) until they are stored.
constexpr int kEbMin = 15;  // 2^-126 <= every factor <= 2^126

__device__ __forceinline__ int ebits(float m) {
  return max(kEbMin, (int)(__float_as_uint(m) >> 23));
}
__device__ __forceinline__ float eb_scale(int eb) {  // 2^(14 - e)
  return __uint_as_float((uint32_t)(268 - eb) << 23);
}
__device__ __forceinline__ float eb_unscale(int eb) {  // 2^(e - 14)
  return __uint_as_float((uint32_t)(eb - 14) << 23);
}
// 2^(from - to) for to >= from: what accumulators at `from` are
// multiplied by when the group's exponent rises to `to` (0 below 2^-126).
__device__ __forceinline__ float eb_rescale(int from, int to) {
  const int b = 127 + from - to;
  return b > 0 ? __uint_as_float((uint32_t)b << 23) : 0.f;
}

// A warp's 16 x 8 NJ accumulator tiles (rows g and g + 8 of lane (g, t),
// columns 8n + 2t..) into a shared 16-bit tile at `s` (its row 0, column
// 0; stride DS16), rounded to T: rows g times f0, rows g + 8 times f1,
// each row written as 0 where its flag is false.
template <typename T, int NJ>
__device__ __forceinline__ void stage16(uint16_t* s, const float (&acc)[NJ][4],
                                        float f0, float f1, bool ok0,
                                        bool ok1, int lane) {
  uint32_t* r0 = reinterpret_cast<uint32_t*>(s + (lane >> 2) * DS16) +
                 (lane & 3);
  uint32_t* r1 = r0 + 4 * DS16;
#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    r0[4 * n] = ok0 ? pack16<T>(acc[n][0] * f0, acc[n][1] * f0) : 0u;
    r1[4 * n] = ok1 ? pack16<T>(acc[n][2] * f1, acc[n][3] * f1) : 0u;
  }
}

// Rows [0, nrows) x columns [0, d) of a shared 16-bit tile (stride DS16)
// to the rows of the row-major matrix `dst` (row stride d): 16-byte
// stores where d % 8 == 0 and dst is 16-byte aligned, neighbouring
// threads on neighbouring addresses; else one element a thread.
template <int NT>
__device__ __forceinline__ void store_tile16(uint16_t* dst, const uint16_t* s,
                                             int nrows, int d, int tid) {
  if (d % 8 == 0 && aligned_to(dst, 16)) {
    const int cpr = d >> 3;
    for (int c = tid; c < nrows * cpr; c += NT) {
      const int r = c / cpr, k = c - r * cpr;
      *reinterpret_cast<uint4*>(dst + (size_t)r * d + 8 * k) =
          *reinterpret_cast<const uint4*>(s + r * DS16 + 8 * k);
    }
  } else {
    for (int e = tid; e < nrows * d; e += NT) {
      const int r = e / d;
      dst[(size_t)r * d + (e - r * d)] = s[r * DS16 + (e - r * d)];
    }
  }
}

// (x, y) as T at p[0], p[1] (columns col, col + 1 of ncols): one 4-byte
// store with `vec2`, else each that lies below ncols.
template <typename T>
__device__ __forceinline__ void store_pair16(uint16_t* p, float x, float y,
                                             int col, int ncols, bool vec2) {
  if (vec2 && col + 1 < ncols) {
    *reinterpret_cast<uint32_t*>(p) = pack16<T>(x, y);
  } else {
    if (col < ncols) p[0] = bits16<T>(x);
    if (col + 1 < ncols) p[1] = bits16<T>(y);
  }
}

}  // namespace
