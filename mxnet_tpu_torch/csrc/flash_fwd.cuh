// The flash-attention forward core on Hopper tensor cores (sm_90a), f32
// queries against f32 keys and values or an int8 cache with one f32 scale
// a row, and its 16-bit form (bf16 or f16 queries, keys and values).
// Included by flash_attention.cu (the flash forward) and, through
// decode_attention.cuh, by the decode sources (their prefill-chunk path,
// the causal diagonal offset by each row's cache length: `q_off`).
//
// For each (b, h) and query row qpos < Tq it attends the key positions
// kpos < kv_end, kv_end = Tk or, with a per-row length, min(Tk, kv_len[b]);
// with `causal` also kpos <= off + qpos, where off = q_off[b] (the cache
// length in decode) or 0 (the flash forward, as the TPU kernel and
// `_merge_mask` define it).  Online softmax: running max, sum and
// accumulator in f32.  A row with no key to attend gives output 0 and lse
// -inf.  Masks are selections, never arithmetic.
//
// Design (d <= 256).  The backward pair's: a block owns BM = 16 WR query
// rows, one warp 16 of them, and streams key/value tiles of BN rows
// through a two-stage `cp.async` ring: the next tile's copies are in flight
// while the current one, split once per block into hi and lo (int8
// dequantized on the way), is multiplied.  S = Q K^T is 3xTF32
// `mma.sync.m16n8k8` with Q fragments split from shared memory; the
// masked online softmax runs on the accumulator fragments (a row's four
// owners are one quad: two xor-shuffles); P goes from the accumulator into
// the A fragments of O += P V in registers (the C-to-A permutation).  NS
// warps split the output columns; a warp of a column split recomputes its
// rows' scores.  A warp skips a tile that none of its rows may attend (past
// kv_end or above its last row's diagonal), and nothing finer.  d = 64
// runs an instantiation with the width a constant.
//
// Widths above 256 (`flash_fwd_wide_kernel`).  The contraction S = Q K^T
// streams through shared memory in slabs of 64 columns of Q and K summed
// in registers, and the output columns are split over the grid's second
// axis into groups of 64, each group recomputing its scores.  Loads there
// are synchronous (load, barrier, split, barrier, multiply).
//
// What bounds it on an H100.  4 d flops per attended (query, key) pair, on
// tensor cores as 3xTF32: 12 d TF32 flops against 495 TFLOP/s (165
// f32-equivalent TFLOP/s); the bytes are q, out, and k, v over the valid
// keys.  At the serving shape (B=16, H=12, T=512, d=64) the flops bound.
//
// 16-bit inputs (bf16 or f16 q, k, v and out, f32 lse).  The TPU
// kernel's semantics: S from upcast q and k in f32 (exact products), P =
// exp(S - m) rounded to v's type for P V, l summed from the f32 P, out =
// acc / l rounded once, lse a natural log.  d <= 64 (`flash_fwd16_kernel`,
// the main path) runs on `wgmma`: a warpgroup owns 64 query rows and a
// block F16_WG of them, sharing each streamed 64-key tile.  S = Q K^T is
// m64n64k16 with Q (loaded once, resident for every tile) and K read
// K-major from shared memory by descriptor, no load instruction of the
// threads' own; the online softmax runs in base 2 (scale * log2 e folded
// into the FMA that feeds `exp2f`); P, the S accumulator packed to 16
// bits, is the register A operand of O += P V, whose V is read MN-major
// through the descriptor's transpose bit (16-bit types allow it, TF32
// does not).  (Q's fragments as a register A operand of S as well gave
// wrong outputs from the second key tile on, on an H100, though each
// register-A product alone beside an `mma.sync` other was right.)
// Tiles lie in the 128-byte swizzle the descriptors name,
// filled by `cp.async` in a two-stage ring; Q and the first K tile are
// in flight before the key length is read; the output is staged in Q's
// tile and written by 16-byte stores.  d > 64 runs the WIDE kernel
// (`flash_fwd16_wide_kernel`, `mma.sync`): S streams through 64-column
// slabs and the output columns split over the grid's second axis in
// groups of 64, each group recomputing its scores.  The 4 d flops a pair
// bound it at 989 TFLOP/s dense bf16/f16 only at long rows; at the
// training shape the bytes do.
#pragma once

#include "tf32x3.cuh"

namespace {

enum { KV_F32 = 0, KV_I8 = 1 };

struct FwdArgs {
  const float* q;         // (B, H, Tq, d)
  const void* k;          // (B, H, Tk, d) f32 or int8
  const void* v;
  const float* k_scale;   // (B, H, Tk) row scales of an int8 cache
  const float* v_scale;
  const int* kv_len;      // (B,) key lengths, or null
  const int* q_off;       // (B,) key position of query 0, or null
  float* out;             // (B, H, Tq, d)
  float* lse;             // (B, H, Tq), or null
  int H, Tq, Tk, d, causal;
  float scale;
  int vec_q;              // q copies of 16 bytes (d % 4 == 0, aligned)
  int kv_mode;            // bytes a k/v copy moves: 16 or 4 (f32); 16, 4
                          // or 1 (int8)
};

template <int DP_, int WR_, int BN_, int NS_>
struct FwdCfg {
  static constexpr int DP = DP_;          // largest padded d it takes
  static constexpr int WR = WR_;          // warps along the block's rows
  static constexpr int BM = 16 * WR_;     // query rows a block owns
  static constexpr int BN = BN_;          // rows of a streamed k/v tile
  static constexpr int NS = NS_;          // warps splitting output columns
  static constexpr int NT = 32 * WR_ * NS_;
  static constexpr int CW = DP_ / NS_;    // output columns per warp
  static constexpr int NJ = CW / 8;       // their 8-column MMA tiles
  static constexpr int NB = BN_ / 8;      // 8-column score tiles
};

// d <= 64's tiles: 8 warps of 16 rows streaming 32-row tiles (87 KB, two
// blocks an SM) took 0.178 ms at B=16, T=512 against 0.211 ms for 4
// warps, and 0.0547 against 0.0528 ms at B=32, T=128 (on an H100;
// tools/torch_flash_fwd_tiles.py times a copy with other tiles).
using FW32 = FwdCfg<32, 4, 32, 1>;
using FW64 = FwdCfg<64, 8, 32, 1>;
using FW128 = FwdCfg<128, 4, 16, 2>;
using FW256 = FwdCfg<256, 2, 16, 2>;

constexpr int WSW = 64;           // wide kernel: slab and group width
constexpr int WDS = WSW + 4;      // its shared row stride
constexpr int WBM = 64, WBN = 32, WNT = 128;
using FWW = FwdCfg<64, 4, 32, 1>;

template <int KV>
__device__ __forceinline__ const void* rows_at(const void* p, size_t off) {
  if (KV == KV_F32) return static_cast<const float*>(p) + off;
  return static_cast<const int8_t*>(p) + off;
}

// Rows [row0, row0 + R) x columns [col0, col0 + n) of a key or value
// operand into the stage: f32 at row stride ds (floats), or int8 bytes at
// row stride dsb with the rows' scales into `dsc`.
template <int R, int NT, int KV>
__device__ __forceinline__ void stage_rows(void* dst, float* dsc,
                                           const void* src, const float* sc,
                                           int row0, int valid, int ld,
                                           int col0, int n, int np, int ds,
                                           int dsb, int mode, int tid) {
  if (KV == KV_F32) {
    load_tile<R, NT>(static_cast<float*>(dst), static_cast<const float*>(src),
                     row0, valid, ld, col0, n, np, ds, mode == 16, tid);
  } else {
    load_tile_i8<R, NT>(static_cast<int8_t*>(dst),
                        static_cast<const int8_t*>(src), row0, valid, ld,
                        col0, n, np, dsb, mode, tid);
    load_vec<NT>(dsc, sc, row0, R, valid, tid);
  }
}

template <int R, int NT, int KV>
__device__ __forceinline__ void split_stage(uint32_t* h, uint32_t* l,
                                            const void* raw, const float* sc,
                                            int np, int ds, int dsb) {
  if (KV == KV_F32)
    split_tile<R, NT>(h, l, static_cast<const float*>(raw), np, ds);
  else
    split_tile_i8<R, NT>(h, l, static_cast<const int8_t*>(raw), sc, np, dsb,
                         ds);
}

// s[j] += the warp's 16 query rows (shared, `sq` at row 0) times the
// split tile's rows, over depth [0, np).
template <int NB>
__device__ __forceinline__ void scores(float (&s)[NB][4], const float* sq,
                                       const uint32_t* kh, const uint32_t* kl,
                                       int np, int ds, int g, int t) {
  for (int kk = 0; kk < np; kk += 8) {
    uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
    frag_a(sq + kk, ds, g, t, ah, al);
    frags_b<NB, true>(kh + kk, kl + kk, ds, g, t, bh, bl);
    mma3_row<NB>(s, ah, al, bh, bl);
  }
}

// The masked online-softmax update of one key tile on the score fragments
// (rows qa and qa + 8; keys k0 + j * 8 + 2t + {0, 1}): s becomes P, the
// running max m and the thread's partial sums l move, acc is rescaled.
template <int NB, int NJ>
__device__ __forceinline__ void online_softmax(
    float (&s)[NB][4], float (&acc)[NJ][4], float& m0, float& m1, float& l0,
    float& l1, int qa, int k0, int kv_end, int causal, int off, float scale,
    int t) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qpos = qa + (e >> 1) * 8;
      const int kpos = k0 + j * 8 + 2 * t + (e & 1);
      const bool live = kpos < kv_end && (!causal || kpos <= off + qpos);
      const float x = live ? s[j][e] * scale : -INFINITY;
      s[j][e] = x;
      if (e >> 1)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
  // a row masked so far keeps exp() finite
  const float z0 = n0 == -INFINITY ? 0.f : n0;
  const float z1 = n1 == -INFINITY ? 0.f : n1;
  const float c0 = m0 == -INFINITY ? 0.f : expf(m0 - z0);
  const float c1 = m1 == -INFINITY ? 0.f : expf(m1 - z1);
  float p0 = 0.f, p1 = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[j][e];
      const float p = x == -INFINITY ? 0.f : expf(x - ((e >> 1) ? z1 : z0));
      s[j][e] = p;
      if (e >> 1)
        p1 += p;
      else
        p0 += p;
    }
  l0 = l0 * c0 + p0;
  l1 = l1 * c1 + p1;
  m0 = n0;
  m1 = n1;
#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    acc[n][0] *= c0;
    acc[n][1] *= c0;
    acc[n][2] *= c1;
    acc[n][3] *= c1;
  }
}

// acc += P V over the tile's keys, 8 at a time: P from the score
// accumulators, V's columns coff.. from the split tile.
template <int NB, int NJ>
__device__ __forceinline__ void pv(float (&acc)[NJ][4],
                                   const float (&p)[NB][4],
                                   const uint32_t* vh, const uint32_t* vl,
                                   int ds, int g, int t, int coff, int np) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    uint32_t ah[4], al[4], bh[NJ][2], bl[NJ][2];
    frag_c2a(p[j], ah, al);
    frags_b<NJ, false>(vh + j * 8 * ds, vl + j * 8 * ds, ds, g, t, bh, bl,
                       coff, np);
    mma3_row<NJ>(acc, ah, al, bh, bl);
  }
}

// out rows qa, qa + 8 (< Tq) at columns coff + n * 8 + 2t (< ncols) of
// `ob` (row stride ld), normalized; the row lse where `lb` is given.  Every
// lane of the warp calls it (quad shuffles).
template <int NJ>
__device__ __forceinline__ void fwd_store(const float (&acc)[NJ][4], float m0,
                                          float m1, float l0, float l1,
                                          float* ob, float* lb, int qa,
                                          int Tq, int ld, int ncols, int coff,
                                          bool vec2, int t) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float i0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float i1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    const int col = coff + n * 8 + 2 * t;
    if (col >= ncols) continue;
    if (qa < Tq)
      store_pair(ob + (size_t)qa * ld + col, acc[n][0] * i0, acc[n][1] * i0,
                 col, ncols, vec2);
    if (qa + 8 < Tq)
      store_pair(ob + (size_t)(qa + 8) * ld + col, acc[n][2] * i1,
                 acc[n][3] * i1, col, ncols, vec2);
  }
  if (lb != nullptr && t == 0) {
    if (qa < Tq) lb[qa] = m0 + logf(l0 == 0.f ? 1.f : l0);
    if (qa + 8 < Tq) lb[qa + 8] = m1 + logf(l1 == 0.f ? 1.f : l1);
  }
}

// Shared memory: Q rows (BM x ds f32), the current tile split (K hi, K lo,
// V hi, V lo: 4 BN x ds), the next tile as loaded (f32: 2 BN x ds; int8:
// 2 BN x dsb bytes and 2 BN scales).
template <class C, int KV>
size_t fwd_smem(int d) {
  const int dp = (d + 7) & ~7, ds = dp + 4, dsb = (dp + 15) & ~15;
  size_t bytes = 4 * ((size_t)C::BM * ds + 4 * (size_t)C::BN * ds);
  if (KV == KV_F32)
    bytes += 4 * 2 * (size_t)C::BN * ds;
  else
    bytes += 2 * (size_t)C::BN * dsb + 4 * 2 * C::BN;
  return bytes;
}

template <class C, int KV, bool FIXED>
__global__ void __launch_bounds__(C::NT) flash_fwd_kernel(const FwdArgs a) {
  constexpr int BM = C::BM, BN = C::BN, NT = C::NT;
  extern __shared__ __align__(16) float smem[];
  const int d = FIXED ? C::DP : a.d;  // a constant width folds the strides
  const int dp = (d + 7) & ~7;
  const int ds = dp + 4;
  const int dsb = (dp + 15) & ~15;
  float* sq = smem;
  uint32_t* kh = reinterpret_cast<uint32_t*>(sq + BM * ds);
  uint32_t* kl = kh + BN * ds;
  uint32_t* vh = kl + BN * ds;
  uint32_t* vl = vh + BN * ds;
  char* stage = reinterpret_cast<char*>(vl + BN * ds);
  // the K and V halves of the stage, and (int8) their scales
  const int half = KV == KV_F32 ? 4 * BN * ds : BN * dsb;
  char* stk = stage;
  char* stv = stage + half;
  float* sck = reinterpret_cast<float*>(stage + 2 * half);
  float* scv = sck + BN;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % C::WR, cw = warp / C::WR;
  const int r0 = 16 * rw;
  const int Tq = a.Tq;
  // one head's query tiles are neighbours in the grid, so they run
  // together and read its keys and values through L2
  const int ntq = (Tq + BM - 1) / BM;
  const int bhx = blockIdx.x / ntq;  // b * H + h
  const int q0 = (blockIdx.x - bhx * ntq) * BM;
  const int nrows = min(BM, Tq - q0);
  const int b = bhx / a.H;

  int kv_end = a.Tk;
  if (a.kv_len != nullptr) kv_end = min(kv_end, max(0, a.kv_len[b]));
  const int off = a.q_off != nullptr ? max(0, a.q_off[b]) : 0;
  if (a.causal) kv_end = min(kv_end, off + q0 + nrows);  // last diagonal + 1
  const int ntiles = (kv_end + BN - 1) / BN;

  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * a.Tk;
  const void* kb = rows_at<KV>(a.k, koff * d);
  const void* vb = rows_at<KV>(a.v, koff * d);
  const float* ksb = KV == KV_I8 ? a.k_scale + koff : nullptr;
  const float* vsb = KV == KV_I8 ? a.v_scale + koff : nullptr;
  load_tile<BM, NT>(sq, a.q + qoff * d, q0, Tq, d, 0, d, dp, ds, a.vec_q,
                    tid);
  cp_commit();
  if (ntiles > 0) {
    stage_rows<BN, NT, KV>(stk, sck, kb, ksb, 0, kv_end, d, 0, d, dp, ds,
                           dsb, a.kv_mode, tid);
    stage_rows<BN, NT, KV>(stv, scv, vb, vsb, 0, kv_end, d, 0, d, dp, ds,
                           dsb, a.kv_mode, (tid + BN) % NT);
  }
  cp_commit();

  const int qa = q0 + r0 + g;  // this thread's rows: qa and qa + 8
  const bool warp_live = q0 + r0 < Tq;
  // keys any row of this warp may attend
  const int w_end = a.causal ? min(kv_end, off + q0 + r0 + 16) : kv_end;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[C::NJ][4];
#pragma unroll
  for (int n = 0; n < C::NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int coff = cw * C::CW;  // this warp's first output column

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<0>();
    __syncthreads();  // tile `it` landed; the split tile's readers are done
    split_stage<BN, NT, KV>(kh, kl, stk, sck, dp, ds, dsb);
    split_stage<BN, NT, KV>(vh, vl, stv, scv, dp, ds, dsb);
    __syncthreads();
    if (it + 1 < ntiles) {  // the next tile streams in while this one runs
      const int k1 = (it + 1) * BN;
      stage_rows<BN, NT, KV>(stk, sck, kb, ksb, k1, kv_end, d, 0, d, dp, ds,
                             dsb, a.kv_mode, tid);
      stage_rows<BN, NT, KV>(stv, scv, vb, vsb, k1, kv_end, d, 0, d, dp, ds,
                             dsb, a.kv_mode, (tid + BN) % NT);
    }
    cp_commit();
    const int k0 = it * BN;
    if (!warp_live || k0 >= w_end) continue;

    float s[C::NB][4];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    scores<C::NB>(s, sq + r0 * ds, kh, kl, dp, ds, g, t);
    online_softmax<C::NB, C::NJ>(s, acc, m0, m1, l0, l1, qa, k0, kv_end,
                                 a.causal, off, a.scale, t);
    pv<C::NB, C::NJ>(acc, s, vh, vl, ds, g, t, coff, dp);
  }
  cp_wait<0>();

  const bool vec2 =
      (d % 2 == 0) && (reinterpret_cast<uintptr_t>(a.out) % 8 == 0);
  fwd_store<C::NJ>(acc, m0, m1, l0, l1, a.out + qoff * d,
                   (a.lse != nullptr && cw == 0) ? a.lse + qoff : nullptr,
                   qa, Tq, d, d, coff, vec2, t);
}

// d > 256: slabs of the contraction, groups of the output columns (header).
// Shared memory: a Q slab (WBM x WDS), one tile split (hi, lo: 2 WBN x
// WDS), one tile as loaded (f32 WBN x WDS, or int8 WBN x WSW bytes and
// WBN scales).
constexpr size_t WIDE_SMEM = 4 * ((size_t)WBM * WDS + 3 * (size_t)WBN * WDS);

template <int KV>
__global__ void __launch_bounds__(WNT) flash_fwd_wide_kernel(const FwdArgs a) {
  constexpr int NB = FWW::NB, NJ = FWW::NJ;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  uint32_t* h = reinterpret_cast<uint32_t*>(sq + WBM * WDS);
  uint32_t* l = h + WBN * WDS;
  char* stage = reinterpret_cast<char*>(l + WBN * WDS);
  float* ssc = reinterpret_cast<float*>(stage + WBN * WSW);  // int8 scales

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int Tq = a.Tq, d = a.d;
  const int ntq = (Tq + WBM - 1) / WBM;
  const int bhx = blockIdx.x / ntq;
  const int q0 = (blockIdx.x - bhx * ntq) * WBM;
  const int nrows = min(WBM, Tq - q0);
  const int b = bhx / a.H;
  const int c0 = blockIdx.y * WSW;  // this block's output column group
  const int nc = min(WSW, d - c0);
  const int npc = (nc + 7) & ~7;

  int kv_end = a.Tk;
  if (a.kv_len != nullptr) kv_end = min(kv_end, max(0, a.kv_len[b]));
  const int off = a.q_off != nullptr ? max(0, a.q_off[b]) : 0;
  if (a.causal) kv_end = min(kv_end, off + q0 + nrows);
  const int ntiles = (kv_end + WBN - 1) / WBN;

  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * a.Tk;
  const float* qb = a.q + qoff * d;
  const void* kb = rows_at<KV>(a.k, koff * d);
  const void* vb = rows_at<KV>(a.v, koff * d);
  const float* ksb = KV == KV_I8 ? a.k_scale + koff : nullptr;
  const float* vsb = KV == KV_I8 ? a.v_scale + koff : nullptr;

  const int qa = q0 + r0 + g;
  const bool warp_live = q0 + r0 < Tq;
  const int w_end = a.causal ? min(kv_end, off + q0 + r0 + 16) : kv_end;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * WBN;
    const bool live = warp_live && k0 < w_end;  // warp-uniform
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int cs = 0; cs < d; cs += WSW) {  // S over the slabs of d
      const int n = min(WSW, d - cs), np = (n + 7) & ~7;
      __syncthreads();  // the previous slab's readers are done
      load_tile<WBM, WNT>(sq, qb, q0, Tq, d, cs, n, np, WDS, a.vec_q, tid);
      stage_rows<WBN, WNT, KV>(stage, ssc, kb, ksb, k0, kv_end, d, cs, n, np,
                               WDS, WSW, a.kv_mode, tid);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      split_stage<WBN, WNT, KV>(h, l, stage, ssc, np, WDS, WSW);
      __syncthreads();
      if (live) scores<NB>(s, sq + r0 * WDS, h, l, np, WDS, g, t);
    }
    if (live)
      online_softmax<NB, NJ>(s, acc, m0, m1, l0, l1, qa, k0, kv_end,
                             a.causal, off, a.scale, t);
    __syncthreads();
    stage_rows<WBN, WNT, KV>(stage, ssc, vb, vsb, k0, kv_end, d, c0, nc, npc,
                             WDS, WSW, a.kv_mode, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    split_stage<WBN, WNT, KV>(h, l, stage, ssc, npc, WDS, WSW);
    __syncthreads();
    if (live) pv<NB, NJ>(acc, s, h, l, WDS, g, t, 0, npc);
  }
  cp_wait<0>();

  const bool vec2 =
      (d % 2 == 0) && (reinterpret_cast<uintptr_t>(a.out) % 8 == 0);
  fwd_store<NJ>(acc, m0, m1, l0, l1, a.out + qoff * d + c0,
                (a.lse != nullptr && blockIdx.y == 0) ? a.lse + qoff
                                                      : nullptr,
                qa, Tq, d, nc, 0, vec2, t);
}

// ------------------------------------------------------ 16-bit inputs
struct Fwd16Args {
  const uint16_t* q;      // (B, H, Tq, d) bf16 or f16 bits
  const uint16_t* k;      // (B, H, Tk, d)
  const uint16_t* v;
  const int* kv_len;      // (B,) key lengths, or null
  const int* q_off;       // (B,) key position of query 0, or null
  uint16_t* out;          // (B, H, Tq, d), q's type
  float* lse;             // (B, H, Tq), or null
  int H, Tq, Tk, d, causal;
  float scale;
  int mode;               // elements a copy moves (mode16)
};

// d <= 64: a block is F16_WG warpgroups of 64 query rows each, streaming
// 64-key tiles.
constexpr int F16_WG = 2;
constexpr int F16_BM = 64 * F16_WG;
constexpr int F16_NT = 128 * F16_WG;
// Q (a tile a warpgroup), K and V (two stages each), and 1 KB to align
// the tiles to 1024 bytes
constexpr size_t FWD16_SMEM = 2 * (size_t)SW64 * (F16_WG + 4) + 1024;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// s = Q K^T for one key tile, a warpgroup's 64 rows: Q and K from their
// swizzled tiles (both K-major), four m64n64k16 products.
template <typename T>
__device__ __forceinline__ void qk16(float (&s)[32], const uint16_t* qt,
                                     const uint16_t* kt) {
  const uint64_t dq = gmma_desc(qt), dk = gmma_desc(kt);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<T>(s, dq + 2 * kk, dk + 2 * kk, kk);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(s);
}

// o += P V for one key tile: P (f32, in s's layout) rounded to T and
// packed, the A fragments of 16-key chunks as they stand (s[8i..8i+7] is
// chunk i); V from its swizzled tile read MN-major (the transpose bit).
template <typename T>
__device__ __forceinline__ void pv16w(float (&o)[32], const float (&p)[32],
                                      const uint16_t* vt) {
  uint32_t pf[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pf[i][e] = pack16<T>(p[8 * i + 2 * e], p[8 * i + 2 * e + 1]);
  const uint64_t dv = gmma_desc(vt);
  wgmma_hold(o);  // the softmax's rescale lands before the fence
#pragma unroll
  for (int i = 0; i < 4; ++i) wgmma_hold(pf[i]);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i) wgmma_rs_mn<T>(o, pf[i], dv + 128 * i, 1);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(o);
}

// The masked online-softmax update of one key tile in base 2, on a warp's
// fragments (s[4 j + e]: row qa + 8 (e >> 1), key k0 + 8 j + 2 t + (e &
// 1)): scores negated first for a negative scale, so sl2 = |scale| log2 e
// > 0; masked keys (`mask`: the tile reaches past kv_end or above a row's
// diagonal) selected to -inf; m the running max of s sl2, p = 2^(s sl2 -
// m) by one FMA and `exp2f`, 0 by selection for a masked key; the
// thread's partial sums l and the accumulators o rescaled.
__device__ __forceinline__ void softmax16(float (&s)[32], float (&o)[32],
                                          float& m0, float& m1, float& l0,
                                          float& l1, int qa, int k0,
                                          int kv_end, bool causal,
                                          bool mask, bool neg, float sl2,
                                          int t) {
  if (neg) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = -s[i];
  }
  if (mask) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int qpos = qa + 4 * (i & 2);
      if (!(kpos < kv_end && (!causal || kpos <= qpos))) s[i] = -INFINITY;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
  }
  const float n0 = fmaxf(m0, mx0 * sl2), n1 = fmaxf(m1, mx1 * sl2);
  // a row masked so far keeps 2^x finite
  const float z0 = n0 == -INFINITY ? 0.f : n0;
  const float z1 = n1 == -INFINITY ? 0.f : n1;
  const float c0 = exp2f(m0 - z0), c1 = exp2f(m1 - z1);
  float p0 = 0.f, p1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = s[i];
    const float p =
        x == -INFINITY ? 0.f : exp2f(fmaf(x, sl2, (i & 2) ? -z1 : -z0));
    s[i] = p;
    if (i & 2)
      p1 += p;
    else
      p0 += p;
  }
  l0 = l0 * c0 + p0;
  l1 = l1 * c1 + p1;
  m0 = n0;
  m1 = n1;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? c1 : c0;
}

template <typename T>
__global__ void __launch_bounds__(F16_NT) flash_fwd16_kernel(
    const Fwd16Args a) {
  extern __shared__ __align__(16) uint8_t sm16a[];
  uint16_t* sq = reinterpret_cast<uint16_t*>(
      sm16a + ((1024 - (smem_u32(sm16a) & 1023)) & 1023));
  uint16_t* sk = sq + F16_WG * SW64;
  uint16_t* sv = sk + 2 * SW64;

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int Tq = a.Tq, d = a.d, mode = a.mode;
  const int ntq = (Tq + F16_BM - 1) / F16_BM;
  const int bhx = blockIdx.x / ntq;  // b * H + h
  const int q0 = (blockIdx.x - bhx * ntq) * F16_BM;
  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * a.Tk;
  const uint16_t* kb = a.k + koff * d;
  const uint16_t* vb = a.v + koff * d;
  // The first copies go out before the key length is read: Q and K's
  // first tile (its rows past the length are masked by selection).
  load_sw64<F16_BM, F16_NT>(sq, a.q + qoff * d, q0, Tq, d, d, mode, tid);
  load_sw64<64, F16_NT>(sk, kb, 0, a.Tk, d, d, mode, tid);
  int kv_end = a.Tk;
  if (a.kv_len != nullptr) kv_end = min(kv_end, max(0, a.kv_len[bhx / a.H]));
  const int off = a.q_off != nullptr ? max(0, a.q_off[bhx / a.H]) : 0;
  if (a.causal) kv_end = min(kv_end, off + min(Tq, q0 + F16_BM));  // diagonal
  const int ntiles = (kv_end + 63) / 64;
  // V's rows past the length are zeros: 0 x NaN would reach the output
  if (ntiles > 0) load_sw64<64, F16_NT>(sv, vb, 0, kv_end, d, d, mode, tid);
  cp_commit();

  const int w0 = q0 + 64 * wg;  // the warpgroup's first query row
  const bool wg_live = w0 < Tq;
  const int w_end = a.causal ? min(kv_end, off + w0 + 64) : kv_end;
  const int qa = w0 + 16 * warp + g;  // this thread's rows: qa and qa + 8
  const float sl = a.scale * kLog2e;
  const bool neg = sl < 0.f;
  const float sl2 = fabsf(sl);
  uint16_t* sqw = sq + wg * SW64;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    cp_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile `it` landed; stage it + 1's readers are done
    if (it + 1 < ntiles) {  // the next tile streams in while this one runs
      const int k1 = (it + 1) * 64;
      load_sw64<64, F16_NT>(sk + (st ^ 1) * SW64, kb, k1, kv_end, d, d, mode,
                            tid);
      load_sw64<64, F16_NT>(sv + (st ^ 1) * SW64, vb, k1, kv_end, d, d, mode,
                            tid);
    }
    cp_commit();
    const int k0 = it * 64;
    if (!wg_live || k0 >= w_end) continue;  // warpgroup-uniform
    float s[32];
    qk16<T>(s, sqw, sk + st * SW64);
    const bool mask = k0 + 64 > kv_end || (a.causal && k0 + 63 > off + w0);
    softmax16(s, o, m0, m1, l0, l1, qa + off, k0, kv_end, a.causal, mask,
              neg, sl2, t);
    pv16w<T>(o, s, sv + st * SW64);
  }
  cp_wait<0>();
  __syncthreads();  // every copy landed and Q was read: its tile is free

  // Normalized rows, rounded to T once, staged in the warpgroup's Q tile
  // (the swizzle keeps the fragment stores on distinct banks), then
  // written by 16-byte stores, neighbouring threads on neighbouring
  // addresses; the lse, a natural log, from the thread that owns a row.
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float i0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float i1 = 1.f / (l1 == 0.f ? 1.f : l1);
  const int r = 16 * warp + g;
  uint32_t* so = reinterpret_cast<uint32_t*>(sqw);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    so[sw64(r, 8 * j + 2 * t) >> 1] =
        pack16<T>(o[4 * j] * i0, o[4 * j + 1] * i0);
    so[sw64(r + 8, 8 * j + 2 * t) >> 1] =
        pack16<T>(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  if (a.lse != nullptr && t == 0) {
    float* lb = a.lse + qoff;
    if (qa < Tq) lb[qa] = m0 * kLn2 + logf(l0 == 0.f ? 1.f : l0);
    if (qa + 8 < Tq) lb[qa + 8] = m1 * kLn2 + logf(l1 == 0.f ? 1.f : l1);
  }
  __syncthreads();
  uint16_t* ob = a.out + (qoff + w0) * d;
  const int wt = tid & 127, nr = min(64, Tq - w0);
  if (d % 8 == 0 && aligned_to(a.out, 16)) {
    for (int i = wt; i < 64 * 8; i += 128) {
      const int rr = i >> 3, c = i & 7;
      if (rr < nr && 8 * c < d)
        *reinterpret_cast<uint4*>(ob + (size_t)rr * d + 8 * c) =
            *reinterpret_cast<const uint4*>(sqw + sw64(rr, 8 * c));
    }
  } else {
    for (int i = wt; i < 64 * 64; i += 128) {
      const int rr = i >> 6, c = i & 63;
      if (rr < nr && c < d) ob[(size_t)rr * d + c] = sqw[sw64(rr, c)];
    }
  }
}

// d > 64 (WIDE): a block owns 64 query rows (4 warps of 16) and streams
// 64-key tiles; S streams through 64-column slabs and the output columns
// split over the grid's second axis in groups of 64, each group
// recomputing its scores, with synchronous loads (stride-DS16 tiles,
// `mma.sync`, the f32 kernels' online softmax).
constexpr int W16_BM = 64, W16_BN = 64, W16_NT = 128;
constexpr size_t FWD16W_SMEM = 2 * (size_t)DS16 * (W16_BM + 2 * W16_BN);

template <typename T>
__global__ void __launch_bounds__(W16_NT) flash_fwd16_wide_kernel(
    const Fwd16Args a) {
  constexpr int BM = W16_BM, BN = W16_BN, NT = W16_NT, NB = BN / 8, NJ = 8;
  extern __shared__ __align__(16) uint16_t sm16[];
  uint16_t* sq = sm16;
  uint16_t* sk = sq + BM * DS16;
  uint16_t* sv = sk + BN * DS16;

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (tid >> 5);
  const int Tq = a.Tq, d = a.d, mode = a.mode;
  const int ntq = (Tq + BM - 1) / BM;
  const int bhx = blockIdx.x / ntq;  // b * H + h
  const int q0 = (blockIdx.x - bhx * ntq) * BM;
  const int nrows = min(BM, Tq - q0);
  const int c0 = blockIdx.y * 64;    // this block's output columns
  const int nc = min(64, d - c0);

  int kv_end = a.Tk;
  if (a.kv_len != nullptr) kv_end = min(kv_end, max(0, a.kv_len[bhx / a.H]));
  const int off = a.q_off != nullptr ? max(0, a.q_off[bhx / a.H]) : 0;
  if (a.causal) kv_end = min(kv_end, off + q0 + nrows);  // last diagonal + 1
  const int ntiles = (kv_end + BN - 1) / BN;

  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * a.Tk;
  const uint16_t* qb = a.q + qoff * d;
  const uint16_t* kb = a.k + koff * d;
  const uint16_t* vb = a.v + koff * d;

  const int qa = q0 + r0 + g;  // this thread's rows: qa and qa + 8
  const bool warp_live = q0 + r0 < Tq;
  const int w_end = a.causal ? min(kv_end, off + q0 + r0 + 16) : kv_end;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN;
    const bool live = warp_live && k0 < w_end;  // warp-uniform
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int cs = 0; cs < d; cs += 64) {  // S over the slabs of d
      const int n = min(64, d - cs);
      __syncthreads();  // the previous slab's readers are done
      load_tile16<BM, NT>(sq, qb, q0, Tq, d, cs, n, 64, mode, tid);
      load_tile16<BN, NT>(sk, kb, k0, kv_end, d, cs, n, 64, mode, tid);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (live) scores16<T, NB>(s, sq + r0 * DS16, sk, g, t);
    }
    if (live)
      online_softmax<NB, NJ>(s, acc, m0, m1, l0, l1, qa, k0, kv_end,
                             a.causal, off, a.scale, t);
    __syncthreads();  // this group's columns of the value tile
    load_tile16<BN, NT>(sv, vb, k0, kv_end, d, c0, nc, 64, mode, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (live) pv16<T, NB, NJ>(acc, s, sv, lane);
  }
  cp_wait<0>();

  // normalized rows, rounded to T once; the lse from the first group
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float i0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float i1 = 1.f / (l1 == 0.f ? 1.f : l1);
  const bool vec2 = d % 2 == 0 && aligned_to(a.out, 4);
  uint16_t* ob = a.out + qoff * d + c0;
#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= nc) continue;
    if (qa < Tq)
      store_pair16<T>(ob + (size_t)qa * d + col, acc[n][0] * i0,
                      acc[n][1] * i0, col, nc, vec2);
    if (qa + 8 < Tq)
      store_pair16<T>(ob + (size_t)(qa + 8) * d + col, acc[n][2] * i1,
                      acc[n][3] * i1, col, nc, vec2);
  }
  if (a.lse != nullptr && blockIdx.y == 0 && t == 0) {
    float* lb = a.lse + qoff;
    if (qa < Tq) lb[qa] = m0 + logf(l0 == 0.f ? 1.f : l0);
    if (qa + 8 < Tq) lb[qa + 8] = m1 + logf(l1 == 0.f ? 1.f : l1);
  }
}

// The 16-bit forward on checked arguments: d <= 64 on `wgmma`, else WIDE.
template <typename T>
int launch_fwd16(const Fwd16Args& a, int B, cudaStream_t st) {
  if (a.d > 64) {
    auto kern = flash_fwd16_wide_kernel<T>;
    static int done[64] = {};
    const int e = set_smem(kern, FWD16W_SMEM, done);
    if (e != 0) return e;
    const dim3 grid((unsigned)(B * a.H) * ((a.Tq + W16_BM - 1) / W16_BM),
                    (a.d + 63) / 64);
    kern<<<grid, W16_NT, FWD16W_SMEM, st>>>(a);
    return (int)cudaGetLastError();
  }
  auto kern = flash_fwd16_kernel<T>;
  static int done[64] = {};
  const int e = set_smem(kern, FWD16_SMEM, done);
  if (e != 0) return e;
  const unsigned grid = (unsigned)(B * a.H) * ((a.Tq + F16_BM - 1) / F16_BM);
  kern<<<grid, F16_NT, FWD16_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <class C, int KV, bool FIXED>
int launch_fwd_cfg(const FwdArgs& a, int B, cudaStream_t st) {
  const size_t smem = fwd_smem<C, KV>(a.d);
  auto kern = flash_fwd_kernel<C, KV, FIXED>;
  static int done[64] = {};
  const int e = set_smem(kern, smem, done);
  if (e != 0) return e;
  const unsigned grid = (unsigned)(B * a.H) * ((a.Tq + C::BM - 1) / C::BM);
  kern<<<grid, C::NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The forward on checked arguments: d = 64 with the width a constant,
// then by width class, then the wide kernel.
template <int KV>
int launch_fwd(const FwdArgs& a, int B, cudaStream_t st) {
  if (a.d == 64) return launch_fwd_cfg<FW64, KV, true>(a, B, st);
  if (a.d <= 32) return launch_fwd_cfg<FW32, KV, false>(a, B, st);
  if (a.d <= 64) return launch_fwd_cfg<FW64, KV, false>(a, B, st);
  if (a.d <= 128) return launch_fwd_cfg<FW128, KV, false>(a, B, st);
  if (a.d <= 256) return launch_fwd_cfg<FW256, KV, false>(a, B, st);
  auto kern = flash_fwd_wide_kernel<KV>;
  static int done[64] = {};
  const int e = set_smem(kern, WIDE_SMEM, done);
  if (e != 0) return e;
  const dim3 grid((unsigned)(B * a.H) * ((a.Tq + WBM - 1) / WBM),
                  (a.d + WSW - 1) / WSW);
  kern<<<grid, WNT, WIDE_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
