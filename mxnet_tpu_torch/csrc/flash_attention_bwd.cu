// Flash-attention backward for Hopper (sm_90a), f32 in and out: the dq
// kernel and the dk/dv kernel, their products on tensor cores.
//
// Replaces the TPU kernels mxnet_tpu/kernels/flash_bwd.py `_dq_kernel` and
// `_dkv_kernel` (launched by `flash_attention_bwd_pallas`).  From the
// forward's output `out` and row log-sum-exp `lse`:
//
//   delta_i = sum_c g_ic * out_ic                    (dq kernel, prologue)
//   p_ij  = exp(s_ij - lse_i),  s_ij = scale * q_i . k_j   (masked: 0)
//   ds_ij = p_ij * (g_i . v_j - delta_i)                   (masked: 0)
//   dq_i  = scale * sum_j ds_ij k_j          (dq kernel: over key tiles)
//   dk_j  = scale * sum_i ds_ij q_i          (dk/dv kernel: over query
//   dv_j  =         sum_i p_ij g_i            tiles)
//
// The masks are the forward's: key kpos is live for query qpos when
// kpos < kv_end (Tk, or min(Tk, kv_len[b])) and, with `causal`,
// kpos <= qpos.  Two kernels, launched in that order on one stream,
// because the two reductions run over different axes.  The dq kernel
// writes each row's delta to a (B, H, Tq) f32 buffer that the dk/dv
// kernel reads.  Every output element is summed by one thread in a fixed
// order (no float atomics), so the gradients are the same bits from run to
// run.
//
// Products.  All five (S = Q K^T, dP = G V^T and dQ += dS K in the dq
// kernel; S^T = K Q^T, dP^T = V G^T, dV += P^T G and dK += dS^T Q in the
// dk/dv kernel) run on tensor cores as `mma.sync.m16n8k8` with TF32
// operands and f32 accumulators, each warp owning 16 rows.  TF32 keeps 10
// mantissa bits, far from the f32 bar the port holds (atol = rtol = 1e-4
// against the plain version with TF32 off), so every operand x is split as
// hi = tf32(x), lo = tf32(x - hi) and each product is three MMAs,
// lo*hi' + hi*lo' + hi*hi' (the split of CUTLASS's OpMultiplyAddFastF32;
// lo*lo' is below f32 rounding).  The split is integer adds and masks on
// the f32 bits, not `cvt`.  Nothing here sets a global TF32 flag.
// `mma.sync` rather than `wgmma`: its accumulator fragment is an operand
// fragment after a fixed permutation of the depth axis (a thread holds
// columns 2t and 2t+1 of its rows; read as depth t and t+4, with the B
// rows read in the same order), so P and dS go from the score product
// into the next product in registers, with no shared-memory round trip
// and no transpose: the dk/dv kernel computes S^T and dP^T directly (keys
// as rows), so P^T and dS^T are born in the layout their products take.
// `wgmma` (the card's full rate) needs its B operand in shared memory in
// a swizzled layout and 64-row warpgroup tiles; it is the later step.
// The copies, the split, the MMA and the fragment loaders live in
// tf32x3.cuh, shared with the forward and the decode kernels.
//
// Loads.  Tiles stream through shared memory with `cp.async`: 16-byte
// `.cg` copies when d % 4 == 0 and every input pointer is 16-byte
// aligned, 4-byte `.ca` copies otherwise (any d).  Rows past kv_end (keys)
// or Tq (queries) and the columns from d up to the padded width dp (d
// rounded up to 8, the MMA depth) are zero-filled by the copy itself
// (source size 0), so garbage there (NaN in the tests) never meets a
// probability.  The streamed tile (K and V for dq; Q and G with their lse
// and delta for dk/dv) lands raw, is split once for the whole block into
// hi and lo arrays, and the copies of the next tile into the raw buffer
// are in flight while the split tile is multiplied: a two-stage ring
// (raw, split).  Splitting each B fragment in every warp instead cost
// more than the MMAs (measured).  A warp splits only its own A rows (the
// fixed Q/G or K/V rows, and P or dS from registers).  Row stride dp + 4
// (= 4 mod 32 words) keeps every fragment load of a warp on 32 distinct
// banks, both for rows-as-columns (K^T, Q^T) and for the permuted reads
// of the second product.
//
// Tiles (rows a block owns BM = 16 WR, streamed tile BN rows, NS warps
// splitting the output columns; a warp of a column split recomputes its
// rows' scores, so NS > 1 costs score work and buys registers):
//   d <= 64:  dq BM 64, BN 32, 128 threads, 87 KB at d = 64 (two blocks
//             an SM); dk/dv BM 128, BN 32, 256 threads, 122 KB.
//   d <= 128: BM 64, NS 2, 256 threads; dq BN 16 (118 KB), dk/dv BN 32
//             (169 KB).
//   d <= 256: BM 32, BN 16, NS 2 (dq) or 4 (dk/dv); 166 KB, one block.
//   d > 256:  the wide kernels below (slabs of d, groups of columns).
// d = 64 (BERT's width, the main path) runs an instantiation with d a
// constant, so strides and the depth loop fold; every other d runs the
// runtime-width one.  MX_FLASH_BWD_FIXED_D picks the widths compiled as
// constants, one bit each for d = 32, 64, 128, 256 (default 0x2: d = 64);
// tools/torch_flash_bwd_widths.py builds it with 0x0 and 0xF and times
// the two.
// The grid is one-dimensional with a head's tiles adjacent, so they run
// together and share that head's streamed rows through L2.  A warp skips
// a streamed tile that none of its rows may attend (past kv_end, past Tq,
// or above the causal diagonal), and nothing finer: inside a tile every
// score and output tile is multiplied, masked entries being zeros,
// because an MMA under a condition the compiler cannot prove uniform
// across the warp gets a WARPSYNC and a branch of its own.  A masked p or
// ds is 0 by selection, never by arithmetic (exp(s - lse) with lse = -inf
// would be NaN).  Outputs of skipped work are exact zeros: dk and dv rows
// at or past kv_end, every dq row of a row with nothing to attend.
//
// What bounds it on an H100.  Per attended (query, key) pair the two
// kernels do 14 d flops of f32 work; 3xTF32 makes it 42 d tensor-core
// flops, against 495 TFLOP/s dense TF32 (an f32-equivalent 165 TFLOP/s).
// At the training shape (B=32, H=12, T=128, d=64) that bound is below the
// bytes each kernel must move (q, g, out, k, v, lse, delta in; dq or dk
// and dv out) at 3.35 TB/s, so both kernels are bound by bytes, and they
// run at about four times that bound (PERF.md): loads, barriers and
// fragment reads with few warps resident (registers cap them) leave
// latency exposed.  wgmma with TMA and a deeper ring are the levers.
//
// 16-bit inputs (bf16 or f16 q, k, v, g, out; f32 lse and delta; dq, dk,
// dv in the inputs' type): the `*16` kernels below, entries of their own.
// The TPU kernels cast every operand to f32 and multiply in f32, so:
// S = Q K^T and dP = G V^T (dk/dv: K Q^T and V G^T), whose operands are
// all 16-bit, are one exact `mma.sync.m16n8k16` a product; dS K, dS^T Q
// and P^T G, where P and dS are f32, split P and dS in the inputs' own
// type, x = hi + lo (16 mantissa bits of x in bf16, 22 in f16), and run
// two m16n8k16 MMAs, lo b + hi b, the 16-bit b read by `ldmatrix` and not
// converted: half the tensor-core time of two TF32 MMAs.  f16 tops out at
// 65504, and dS under a loss scale does not, so in f16 dS is scaled by an
// exact power of two first (its largest |dS| below 2^15) and the
// accumulators unscaled at the end (tf32x3.cuh, "f16's range").  dq, dk
// and dv are rounded to 16 bits once, at the end; delta = rowsum(g * out)
// in f32.  For d <= 64 (BERT's 64):
//   Tk <= 128: one launch of the dk/dv kernel in its fused mode.  A block
//     owns every key of a head (8 warps of 16 keys) and walks its query
//     tiles (64): per tile it forms delta from g and out, S^T, dP^T, P
//     and dS once, dV and dK in registers, and writes dS^T (hi, lo) to
//     shared memory, from which the eight warps compute the tile's dQ =
//     dS K whole, one tile later (no dQ sum across blocks, no atomics,
//     no delta in memory: five products, each input read once).  The
//     grid is persistent: a block walks heads, and the next head's K, V
//     and first query tile load while its last tile computes.
//   Tk > 128: the dq kernel (128 query rows, 64-key tiles, delta in its
//     prologue), then the dk/dv kernel (128 keys, 64-query tiles), each
//     streaming through a two-stage `cp.async` ring.
// Every 16-bit operand is read by `ldmatrix`, and every output tile is
// staged in shared memory and stored by 16-byte rows.  d > 64 runs the
// WIDE forms (two-term TF32 products; slabs of 64 for the contractions
// over d, groups of 64 output columns over the grid's second axis,
// synchronous loads), as the f32 kernels' wide path does.

#include "tf32x3.cuh"

namespace {

#ifndef MX_FLASH_BWD_FIXED_D
#define MX_FLASH_BWD_FIXED_D 0x2
#endif

template <int DP_, int WR_, int BN_, int NS_>
struct Cfg {
  static constexpr int DP = DP_;          // largest padded d it takes
  static constexpr int WR = WR_;          // warps along the block's rows
  static constexpr int BM = 16 * WR_;     // rows a block owns
  static constexpr int BN = BN_;          // rows of the streamed tile
  static constexpr int NS = NS_;          // warps splitting output columns
  static constexpr int NT = 32 * WR_ * NS_;
  static constexpr int CW = DP_ / NS_;    // output columns per warp
  static constexpr int NJ = CW / 8;       // their 8-column MMA tiles
  static constexpr int NB = BN_ / 8;      // 8-column score tiles
  // d == DP runs the constant-width kernel (MX_FLASH_BWD_FIXED_D's bit)
  static constexpr bool FIXED =
      (MX_FLASH_BWD_FIXED_D >> (DP_ == 32 ? 0 : DP_ == 64 ? 1
                                : DP_ == 128 ? 2 : 3)) & 1;
};

// ------------------------------------------------------------ dq kernel
// Shared memory: Q and G rows as loaded (BM x ds each; the warps split
// their own A fragments), the next K and V tile as loaded (2 BN x ds),
// and the current K and V tile split (hi, lo: 4 BN x ds; it first holds
// the out rows, until delta is known).
template <class C, bool FIXED>
__global__ void __launch_bounds__(C::NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ out,
                    const float* __restrict__ lse,
                    const int* __restrict__ kv_len, float* __restrict__ dq,
                    float* __restrict__ delta, int H, int Tq, int Tk, int d,
                    int causal, float scale, int vec) {
  constexpr int BM = C::BM, BN = C::BN, NT = C::NT;
  extern __shared__ __align__(16) float smem[];
  if (FIXED) d = C::DP;  // the width is a constant: strides fold
  const int dp = (d + 7) & ~7;
  const int ds = dp + 4;
  float* sq = smem;
  float* sg = sq + BM * ds;
  float* raw = sg + BM * ds;
  uint32_t* kh = reinterpret_cast<uint32_t*>(raw + 2 * BN * ds);
  uint32_t* kl = kh + BN * ds;
  uint32_t* vh = kl + BN * ds;
  uint32_t* vl = vh + BN * ds;
  float* so = reinterpret_cast<float*>(kh);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rw = warp % C::WR, cw = warp / C::WR;
  const int r0 = 16 * rw;
  // one head's query tiles are neighbours in the grid, so they run
  // together and read its K and V through L2
  const int ntq = (Tq + BM - 1) / BM;
  const int bhx = blockIdx.x / ntq;  // b * H + h
  const int q0 = (blockIdx.x - bhx * ntq) * BM;
  const int nrows = min(BM, Tq - q0);

  int kv_end = Tk;
  if (kv_len != nullptr) kv_end = min(Tk, max(0, kv_len[bhx / H]));
  if (causal) kv_end = min(kv_end, q0 + nrows);  // last row's diagonal + 1
  const int ntiles = (kv_end + BN - 1) / BN;

  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * Tk;
  const float* kb = k + koff * d;
  const float* vb = v + koff * d;
  load_tile<BM, NT>(sq, q + qoff * d, q0, Tq, d, 0, d, dp, ds,
                    vec, threadIdx.x);
  load_tile<BM, NT>(sg, g + qoff * d, q0, Tq, d, 0, d, dp, ds,
                    vec, threadIdx.x);
  load_tile<BM, NT>(so, out + qoff * d, q0, Tq, d, 0, d, dp, ds,
                    vec, threadIdx.x);
  cp_commit();
  if (ntiles > 0) {
    load_tile<BN, NT>(raw, kb, 0, kv_end, d, 0, d, dp, ds, vec, threadIdx.x);
    load_tile<BN, NT>(raw + BN * ds, vb, 0, kv_end, d, 0, d, dp, ds,
                      vec, threadIdx.x);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  // delta of the warp's 16 rows: lane pair (2r, 2r+1) sums row r, each
  // half of the columns, in a fixed order; then rows g and g+8 of the
  // fragments are fetched from lanes 2g and 2g+16.
  float dl0, dl1, ls0, ls1;
  {
    const int rr = lane >> 1, h = lane & 1;
    const float* gr = sg + (r0 + rr) * ds + h * (dp >> 1);
    const float* orow = so + (r0 + rr) * ds + h * (dp >> 1);
    float s = 0.f;
    for (int c = 0; c < (dp >> 1); c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(gr + c);
      const float4 y = *reinterpret_cast<const float4*>(orow + c);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
      s = fmaf(x.z, y.z, s);
      s = fmaf(x.w, y.w, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    const int row = q0 + r0 + rr;
    if (cw == 0 && h == 0 && row < Tq) delta[qoff + row] = s;
    dl0 = __shfl_sync(0xffffffffu, s, 2 * gq);
    dl1 = __shfl_sync(0xffffffffu, s, 2 * gq + 16);
    const int ra = q0 + r0 + gq;
    ls0 = ra < Tq ? lse[qoff + ra] : 0.f;
    ls1 = ra + 8 < Tq ? lse[qoff + ra + 8] : 0.f;
  }

  const int qa = q0 + r0 + gq;  // this thread's rows: qa and qa + 8
  // keys any row of this warp may attend
  const int w_end = causal ? min(kv_end, q0 + r0 + 16) : kv_end;
  const bool warp_live = q0 + r0 < Tq;

  float acc[C::NJ][4];
#pragma unroll
  for (int n = 0; n < C::NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int coff = cw * C::CW;  // this warp's first output column

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<0>();
    __syncthreads();  // tile `it` landed; the split tile's readers are done
    split_tile<BN, NT>(kh, kl, raw, dp, ds);
    split_tile<BN, NT>(vh, vl, raw + BN * ds, dp, ds);
    __syncthreads();
    if (it + 1 < ntiles) {  // the next tile streams in while this one runs
      load_tile<BN, NT>(raw, kb, (it + 1) * BN, kv_end, d, 0, d, dp, ds,
                        vec, threadIdx.x);
      load_tile<BN, NT>(raw + BN * ds, vb, (it + 1) * BN, kv_end, d, 0, d,
                        dp, ds, vec, threadIdx.x);
    }
    cp_commit();
    const int k0 = it * BN;
    const int live = w_end - k0;  // live keys of this tile for the warp
    if (live <= 0 || !warp_live) continue;

    float s[C::NB][4], dpv[C::NB][4];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.f;
    for (int kk = 0; kk < dp; kk += 8) {
      uint32_t ah[4], al[4], bh[C::NB][2], bl[C::NB][2];
      frag_a(sq + r0 * ds + kk, ds, gq, tq, ah, al);
      frags_b<C::NB, true>(kh + kk, kl + kk, ds, gq, tq, bh, bl);
      mma3_row<C::NB>(s, ah, al, bh, bl);
      frag_a(sg + r0 * ds + kk, ds, gq, tq, ah, al);
      frags_b<C::NB, true>(vh + kk, vl + kk, ds, gq, tq, bh, bl);
      mma3_row<C::NB>(dpv, ah, al, bh, bl);
    }
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qa + (e >> 1) * 8;
        const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
        const bool ok =
            kpos < kv_end && qpos < Tq && (!causal || qpos >= kpos);
        const float p =
            ok ? expf(s[j][e] * scale - ((e >> 1) ? ls1 : ls0)) : 0.f;
        s[j][e] = ok ? p * (dpv[j][e] - ((e >> 1) ? dl1 : dl0)) : 0.f;
      }
    // acc += dS K over the tile's keys, 8 at a time (dS is 0 at every
    // masked key, and masked rows of K are zeros)
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      uint32_t ah[4], al[4], bh[C::NJ][2], bl[C::NJ][2];
      frag_c2a(s[j], ah, al);
      frags_b<C::NJ, false>(kh + j * 8 * ds, kl + j * 8 * ds, ds, gq, tq, bh,
                            bl, coff, dp);
      mma3_row<C::NJ>(acc, ah, al, bh, bl);
    }
  }
  cp_wait<0>();

  const bool vec2 = (d % 2 == 0) && (reinterpret_cast<uintptr_t>(dq) % 8 == 0);
  float* ob = dq + qoff * d;
#pragma unroll
  for (int n = 0; n < C::NJ; ++n) {
    const int col = coff + n * 8 + 2 * tq;
    if (col >= d) continue;
    if (qa < Tq)
      store_pair(ob + (size_t)qa * d + col, acc[n][0] * scale,
                 acc[n][1] * scale, col, d, vec2);
    if (qa + 8 < Tq)
      store_pair(ob + (size_t)(qa + 8) * d + col, acc[n][2] * scale,
                 acc[n][3] * scale, col, d, vec2);
  }
}

// --------------------------------------------------------- dk/dv kernel
// Shared memory: K and V rows as loaded (BM x ds each; A fragments), the
// next Q and G tile with its lse and delta as loaded (2 BN x ds + 2 BN),
// and the current one split (hi, lo: 4 BN x ds) with its lse and delta.
template <class C, bool FIXED>
__global__ void __launch_bounds__(C::NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_len, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Tq, int Tk, int d,
                     int causal, float scale, int vec) {
  constexpr int BM = C::BM, BN = C::BN, NT = C::NT;
  extern __shared__ __align__(16) float smem[];
  if (FIXED) d = C::DP;  // the width is a constant: strides fold
  const int dp = (d + 7) & ~7;
  const int ds = dp + 4;
  float* sk = smem;
  float* sv = sk + BM * ds;
  float* raw = sv + BM * ds;         // Q, G (BN x ds each), lse, delta
  uint32_t* qh = reinterpret_cast<uint32_t*>(raw + 2 * BN * ds + 2 * BN);
  uint32_t* ql = qh + BN * ds;
  uint32_t* gh = ql + BN * ds;
  uint32_t* gl = gh + BN * ds;
  float* sl = reinterpret_cast<float*>(gl + BN * ds);  // lse, delta
  float* sd = sl + BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rw = warp % C::WR, cw = warp / C::WR;
  const int r0 = 16 * rw;
  // one head's key tiles are neighbours in the grid (its Q and G through
  // L2)
  const int ntk = (Tk + BM - 1) / BM;
  const int bhx = blockIdx.x / ntk;  // b * H + h
  const int k0 = (blockIdx.x - bhx * ntk) * BM;
  const int nkeys = min(BM, Tk - k0);

  int kv_end = Tk;
  if (kv_len != nullptr) kv_end = min(Tk, max(0, kv_len[bhx / H]));
  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * Tk;
  float* dkb = dk + koff * d;
  float* dvb = dv + koff * d;

  if (k0 >= kv_end) {  // no live key: exact zeros, nothing loaded
    for (int i = threadIdx.x; i < nkeys * d; i += NT) {
      dkb[(size_t)k0 * d + i] = 0.f;
      dvb[(size_t)k0 * d + i] = 0.f;
    }
    return;
  }

  // with `causal` no query before the tile's first key attends it
  const int i_begin = causal ? (k0 / BN) * BN : 0;
  const int ntiles = Tq > i_begin ? (Tq - i_begin + BN - 1) / BN : 0;
  const float* qb = q + qoff * d;
  const float* gb = g + qoff * d;
  const float* lb = lse + qoff;
  const float* db = delta + qoff;
  float* rl = raw + 2 * BN * ds;     // lse and delta as loaded

  load_tile<BM, NT>(sk, k + koff * d, k0, kv_end, d, 0, d, dp, ds,
                    vec, threadIdx.x);
  load_tile<BM, NT>(sv, v + koff * d, k0, kv_end, d, 0, d, dp, ds,
                    vec, threadIdx.x);
  if (ntiles > 0) {
    load_tile<BN, NT>(raw, qb, i_begin, Tq, d, 0, d, dp, ds, vec, threadIdx.x);
    load_tile<BN, NT>(raw + BN * ds, gb, i_begin, Tq, d, 0, d, dp, ds,
                      vec, threadIdx.x);
    load_vec<NT>(rl, lb, i_begin, BN, Tq, threadIdx.x);
    load_vec<NT>(rl + BN, db, i_begin, BN, Tq, (threadIdx.x + BN) % NT);
  }
  cp_commit();

  const int ka = k0 + r0 + gq;  // this thread's key rows: ka and ka + 8
  const bool warp_live = k0 + r0 < kv_end;
  float acck[C::NJ][4], accv[C::NJ][4];
#pragma unroll
  for (int n = 0; n < C::NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[n][e] = accv[n][e] = 0.f;
  const int coff = cw * C::CW;  // this warp's first output column

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<0>();
    __syncthreads();  // tile `it` landed; the split tile's readers are done
    split_tile<BN, NT>(qh, ql, raw, dp, ds);
    split_tile<BN, NT>(gh, gl, raw + BN * ds, dp, ds);
    if (threadIdx.x < 2 * BN) sl[threadIdx.x] = rl[threadIdx.x];
    __syncthreads();
    const int i0 = i_begin + it * BN;
    if (it + 1 < ntiles) {  // the next tile streams in while this one runs
      const int i1 = i0 + BN;
      load_tile<BN, NT>(raw, qb, i1, Tq, d, 0, d, dp, ds, vec, threadIdx.x);
      load_tile<BN, NT>(raw + BN * ds, gb, i1, Tq, d, 0, d, dp, ds,
                        vec, threadIdx.x);
      load_vec<NT>(rl, lb, i1, BN, Tq, threadIdx.x);
      load_vec<NT>(rl + BN, db, i1, BN, Tq, (threadIdx.x + BN) % NT);
    }
    cp_commit();
    // a warp whose keys are all dead, or that no query of this tile may
    // attend (causal), has nothing to add
    if (!warp_live || (causal && i0 + BN <= k0 + r0)) continue;

    float s[C::NB][4], dpv[C::NB][4];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.f;
    for (int kk = 0; kk < dp; kk += 8) {
      uint32_t ah[4], al[4], bh[C::NB][2], bl[C::NB][2];
      frag_a(sk + r0 * ds + kk, ds, gq, tq, ah, al);
      frags_b<C::NB, true>(qh + kk, ql + kk, ds, gq, tq, bh, bl);
      mma3_row<C::NB>(s, ah, al, bh, bl);
      frag_a(sv + r0 * ds + kk, ds, gq, tq, ah, al);
      frags_b<C::NB, true>(gh + kk, gl + kk, ds, gq, tq, bh, bl);
      mma3_row<C::NB>(dpv, ah, al, bh, bl);
    }
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = ka + (e >> 1) * 8;
        const int col = j * 8 + 2 * tq + (e & 1);
        const int qpos = i0 + col;
        const bool ok =
            kpos < kv_end && qpos < Tq && (!causal || qpos >= kpos);
        const float p = ok ? expf(s[j][e] * scale - sl[col]) : 0.f;
        dpv[j][e] = ok ? p * (dpv[j][e] - sd[col]) : 0.f;
        s[j][e] = p;
      }
    // dV += P^T G and dK += dS^T Q over the tile's queries, 8 at a time
    // (P and dS are 0 at every masked query; rows past Tq are zeros)
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      uint32_t ah[4], al[4], bh[C::NJ][2], bl[C::NJ][2];
      const int at = j * 8 * ds;
      frag_c2a(s[j], ah, al);
      frags_b<C::NJ, false>(gh + at, gl + at, ds, gq, tq, bh, bl, coff, dp);
      mma3_row<C::NJ>(accv, ah, al, bh, bl);
      frag_c2a(dpv[j], ah, al);
      frags_b<C::NJ, false>(qh + at, ql + at, ds, gq, tq, bh, bl, coff, dp);
      mma3_row<C::NJ>(acck, ah, al, bh, bl);
    }
  }
  cp_wait<0>();

  // rows at or past kv_end get exact zeros, whatever was accumulated
  const bool vec2 = (d % 2 == 0) &&
                    (reinterpret_cast<uintptr_t>(dk) % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(dv) % 8 == 0);
#pragma unroll
  for (int n = 0; n < C::NJ; ++n) {
    const int col = coff + n * 8 + 2 * tq;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ka + 8 * h;
      if (row >= k0 + nkeys) continue;
      const bool ok = row < kv_end;
      const size_t at = (size_t)row * d + col;
      store_pair(dkb + at, ok ? acck[n][2 * h] * scale : 0.f,
                 ok ? acck[n][2 * h + 1] * scale : 0.f, col, d, vec2);
      store_pair(dvb + at, ok ? accv[n][2 * h] : 0.f,
                 ok ? accv[n][2 * h + 1] : 0.f, col, d, vec2);
    }
  }
}

// ------------------------------------------------- widths above 256
// d > 256: every contraction over d (S, dP, and delta in the dq kernel)
// streams through shared memory in slabs of WSW = 64 columns summed in
// registers, and the outputs (dq, or dk and dv) are split over the grid's
// second axis into groups of WSW columns, each group recomputing its
// scores.  Loads are synchronous: load, barrier, split, barrier, multiply.
// Block: WBM = 64 owned rows (4 warps of 16), streamed tiles of WBN = 32.
// Shared memory: two owned slabs (WBM x WDS each), two streamed slabs as
// loaded (2 WBN x WDS) and split (hi, lo: 4 WBN x WDS).
constexpr int WSW = 64, WDS = WSW + 4;
constexpr int WBM = 64, WBN = 32, WNT = 128;
constexpr int WNB = WBN / 8, WNJ = WSW / 8;
constexpr size_t WIDE_SMEM =
    sizeof(float) * (2 * (size_t)WBM * WDS + 6 * (size_t)WBN * WDS);

// s += A1 B1^T and s2 += A2 B2^T over every slab of d: A rows [a0, a0 +
// WBM) (valid below av), B rows [b0, b0 + WBN) (valid below bv); the warp
// multiplies only when `live` (warp-uniform), every thread loads.
__device__ __forceinline__ void wide_scores(
    float (&s)[WNB][4], float (&s2)[WNB][4], const float* a1, const float* a2,
    int a0, int av, const float* b1, const float* b2, int b0, int bv, int d,
    bool vec, bool live, float* sa, float* sb, float* raw, uint32_t* h1,
    uint32_t* l1, uint32_t* h2, uint32_t* l2, int r0, int g, int t) {
  const int tid = threadIdx.x;
  for (int cs = 0; cs < d; cs += WSW) {
    const int n = min(WSW, d - cs), np = (n + 7) & ~7;
    __syncthreads();  // the previous slab's readers are done
    load_tile<WBM, WNT>(sa, a1, a0, av, d, cs, n, np, WDS, vec, tid);
    load_tile<WBM, WNT>(sb, a2, a0, av, d, cs, n, np, WDS, vec, tid);
    load_tile<WBN, WNT>(raw, b1, b0, bv, d, cs, n, np, WDS, vec, tid);
    load_tile<WBN, WNT>(raw + WBN * WDS, b2, b0, bv, d, cs, n, np, WDS, vec,
                        tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    split_tile<WBN, WNT>(h1, l1, raw, np, WDS);
    split_tile<WBN, WNT>(h2, l2, raw + WBN * WDS, np, WDS);
    __syncthreads();
    if (!live) continue;
    for (int kk = 0; kk < np; kk += 8) {
      uint32_t ah[4], al[4], bh[WNB][2], bl[WNB][2];
      frag_a(sa + r0 * WDS + kk, WDS, g, t, ah, al);
      frags_b<WNB, true>(h1 + kk, l1 + kk, WDS, g, t, bh, bl);
      mma3_row<WNB>(s, ah, al, bh, bl);
      frag_a(sb + r0 * WDS + kk, WDS, g, t, ah, al);
      frags_b<WNB, true>(h2 + kk, l2 + kk, WDS, g, t, bh, bl);
      mma3_row<WNB>(s2, ah, al, bh, bl);
    }
  }
}

// Columns [c0, c0 + nc) of the streamed rows [b0, b0 + WBN) of b1 (and
// b2) loaded and split into (h1, l1) (and (h2, l2)).
__device__ __forceinline__ void wide_group(const float* b1, const float* b2,
                                           int b0, int bv, int d, int c0,
                                           int nc, bool vec, float* raw,
                                           uint32_t* h1, uint32_t* l1,
                                           uint32_t* h2, uint32_t* l2) {
  const int tid = threadIdx.x, npc = (nc + 7) & ~7;
  __syncthreads();
  load_tile<WBN, WNT>(raw, b1, b0, bv, d, c0, nc, npc, WDS, vec, tid);
  if (b2 != nullptr)
    load_tile<WBN, WNT>(raw + WBN * WDS, b2, b0, bv, d, c0, nc, npc, WDS, vec,
                        tid);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  split_tile<WBN, WNT>(h1, l1, raw, npc, WDS);
  if (b2 != nullptr) split_tile<WBN, WNT>(h2, l2, raw + WBN * WDS, npc, WDS);
  __syncthreads();
}

// acc += P (16 x WBN, from the score accumulators) times the split group.
__device__ __forceinline__ void wide_pv(float (&acc)[WNJ][4],
                                        const float (&p)[WNB][4],
                                        const uint32_t* h, const uint32_t* l,
                                        int npc, int g, int t) {
#pragma unroll
  for (int j = 0; j < WNB; ++j) {
    uint32_t ah[4], al[4], bh[WNJ][2], bl[WNJ][2];
    frag_c2a(p[j], ah, al);
    frags_b<WNJ, false>(h + j * 8 * WDS, l + j * 8 * WDS, WDS, g, t, bh, bl,
                        0, npc);
    mma3_row<WNJ>(acc, ah, al, bh, bl);
  }
}

__global__ void __launch_bounds__(WNT)
flash_bwd_dq_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ out,
                         const float* __restrict__ lse,
                         const int* __restrict__ kv_len,
                         float* __restrict__ dq, float* __restrict__ delta,
                         int H, int Tq, int Tk, int d, int causal,
                         float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = sa + WBM * WDS;
  float* raw = sb + WBM * WDS;
  uint32_t* kh = reinterpret_cast<uint32_t*>(raw + 2 * WBN * WDS);
  uint32_t* kl = kh + WBN * WDS;
  uint32_t* vh = kl + WBN * WDS;
  uint32_t* vl = vh + WBN * WDS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp;
  const int ntq = (Tq + WBM - 1) / WBM;
  const int bhx = blockIdx.x / ntq;
  const int q0 = (blockIdx.x - bhx * ntq) * WBM;
  const int nrows = min(WBM, Tq - q0);
  const int c0 = blockIdx.y * WSW, nc = min(WSW, d - c0);

  int kv_end = Tk;
  if (kv_len != nullptr) kv_end = min(Tk, max(0, kv_len[bhx / H]));
  if (causal) kv_end = min(kv_end, q0 + nrows);
  const int ntiles = (kv_end + WBN - 1) / WBN;
  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * Tk;
  const float* qb = q + qoff * d;
  const float* gb = g + qoff * d;
  const float* kb = k + koff * d;
  const float* vb = v + koff * d;

  // delta of rows qa and qa + 8: a quad's lanes over columns t, t + 4, ..
  const int qa = q0 + r0 + gq;
  float dl0 = 0.f, dl1 = 0.f;
  if (qa < Tq)
    for (int c = tq; c < d; c += 4)
      dl0 = fmaf(gb[(size_t)qa * d + c], out[(qoff + qa) * d + c], dl0);
  if (qa + 8 < Tq)
    for (int c = tq; c < d; c += 4)
      dl1 = fmaf(gb[(size_t)(qa + 8) * d + c], out[(qoff + qa + 8) * d + c],
                 dl1);
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, o);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, o);
  }
  if (blockIdx.y == 0 && tq == 0) {
    if (qa < Tq) delta[qoff + qa] = dl0;
    if (qa + 8 < Tq) delta[qoff + qa + 8] = dl1;
  }
  const float ls0 = qa < Tq ? lse[qoff + qa] : 0.f;
  const float ls1 = qa + 8 < Tq ? lse[qoff + qa + 8] : 0.f;
  const int w_end = causal ? min(kv_end, q0 + r0 + 16) : kv_end;
  const bool warp_live = q0 + r0 < Tq;

  float acc[WNJ][4];
#pragma unroll
  for (int n = 0; n < WNJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * WBN;
    const bool live = warp_live && k0 < w_end;
    float s[WNB][4], dpv[WNB][4];
#pragma unroll
    for (int j = 0; j < WNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.f;
    wide_scores(s, dpv, qb, gb, q0, Tq, kb, vb, k0, kv_end, d, vec, live, sa,
                sb, raw, kh, kl, vh, vl, r0, gq, tq);
    if (live) {
#pragma unroll
      for (int j = 0; j < WNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = qa + (e >> 1) * 8;
          const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
          const bool ok =
              kpos < kv_end && qpos < Tq && (!causal || qpos >= kpos);
          const float p =
              ok ? expf(s[j][e] * scale - ((e >> 1) ? ls1 : ls0)) : 0.f;
          s[j][e] = ok ? p * (dpv[j][e] - ((e >> 1) ? dl1 : dl0)) : 0.f;
        }
    }
    wide_group(kb, nullptr, k0, kv_end, d, c0, nc, vec, raw, kh, kl, nullptr,
               nullptr);
    if (live) wide_pv(acc, s, kh, kl, (nc + 7) & ~7, gq, tq);
  }

  const bool vec2 = (d % 2 == 0) && (reinterpret_cast<uintptr_t>(dq) % 8 == 0);
  float* ob = dq + qoff * d + c0;
#pragma unroll
  for (int n = 0; n < WNJ; ++n) {
    const int col = n * 8 + 2 * tq;
    if (col >= nc) continue;
    if (qa < Tq)
      store_pair(ob + (size_t)qa * d + col, acc[n][0] * scale,
                 acc[n][1] * scale, col, nc, vec2);
    if (qa + 8 < Tq)
      store_pair(ob + (size_t)(qa + 8) * d + col, acc[n][2] * scale,
                 acc[n][3] * scale, col, nc, vec2);
  }
}

__global__ void __launch_bounds__(WNT)
flash_bwd_dkv_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ kv_len,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int Tq, int Tk, int d, int causal,
                          float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = sa + WBM * WDS;
  float* raw = sb + WBM * WDS;
  uint32_t* qh = reinterpret_cast<uint32_t*>(raw + 2 * WBN * WDS);
  uint32_t* ql = qh + WBN * WDS;
  uint32_t* gh = ql + WBN * WDS;
  uint32_t* gl = gh + WBN * WDS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp;
  const int ntk = (Tk + WBM - 1) / WBM;
  const int bhx = blockIdx.x / ntk;
  const int k0 = (blockIdx.x - bhx * ntk) * WBM;
  const int nkeys = min(WBM, Tk - k0);
  const int c0 = blockIdx.y * WSW, nc = min(WSW, d - c0);

  int kv_end = Tk;
  if (kv_len != nullptr) kv_end = min(Tk, max(0, kv_len[bhx / H]));
  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * Tk;
  float* dkb = dk + koff * d + c0;
  float* dvb = dv + koff * d + c0;
  if (k0 >= kv_end) {  // no live key: exact zeros, nothing loaded
    for (int i = threadIdx.x; i < nkeys * nc; i += WNT) {
      const size_t at = (size_t)(k0 + i / nc) * d + i % nc;
      dkb[at] = 0.f;
      dvb[at] = 0.f;
    }
    return;
  }
  // with `causal` no query before the block's first key attends it
  const int i_begin = causal ? (k0 / WBN) * WBN : 0;
  const int ntiles = Tq > i_begin ? (Tq - i_begin + WBN - 1) / WBN : 0;
  const float* qb = q + qoff * d;
  const float* gb = g + qoff * d;
  const float* kb = k + koff * d;
  const float* vb = v + koff * d;

  const int ka = k0 + r0 + gq;  // this thread's key rows: ka and ka + 8
  const bool warp_live = k0 + r0 < kv_end;
  float acck[WNJ][4], accv[WNJ][4];
#pragma unroll
  for (int n = 0; n < WNJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[n][e] = accv[n][e] = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = i_begin + it * WBN;
    const bool live = warp_live && !(causal && i0 + WBN <= k0 + r0);
    float s[WNB][4], dpv[WNB][4];
#pragma unroll
    for (int j = 0; j < WNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.f;
    wide_scores(s, dpv, kb, vb, k0, kv_end, qb, gb, i0, Tq, d, vec, live, sa,
                sb, raw, qh, ql, gh, gl, r0, gq, tq);
    if (live) {
#pragma unroll
      for (int j = 0; j < WNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = ka + (e >> 1) * 8;
          const int qpos = i0 + j * 8 + 2 * tq + (e & 1);
          const bool ok =
              kpos < kv_end && qpos < Tq && (!causal || qpos >= kpos);
          const float p =
              ok ? expf(s[j][e] * scale - lse[qoff + qpos]) : 0.f;
          dpv[j][e] = ok ? p * (dpv[j][e] - delta[qoff + qpos]) : 0.f;
          s[j][e] = p;
        }
    }
    // dV += P^T G and dK += dS^T Q over the group's columns
    wide_group(gb, qb, i0, Tq, d, c0, nc, vec, raw, gh, gl, qh, ql);
    if (live) {
      wide_pv(accv, s, gh, gl, (nc + 7) & ~7, gq, tq);
      wide_pv(acck, dpv, qh, ql, (nc + 7) & ~7, gq, tq);
    }
  }

  // rows at or past kv_end get exact zeros, whatever was accumulated
  const bool vec2 = (d % 2 == 0) &&
                    (reinterpret_cast<uintptr_t>(dk) % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(dv) % 8 == 0);
#pragma unroll
  for (int n = 0; n < WNJ; ++n) {
    const int col = n * 8 + 2 * tq;
    if (col >= nc) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ka + 8 * h;
      if (row >= k0 + nkeys) continue;
      const bool ok = row < kv_end;
      const size_t at = (size_t)row * d + col;
      store_pair(dkb + at, ok ? acck[n][2 * h] * scale : 0.f,
                 ok ? acck[n][2 * h + 1] * scale : 0.f, col, nc, vec2);
      store_pair(dvb + at, ok ? accv[n][2 * h] : 0.f,
                 ok ? accv[n][2 * h + 1] : 0.f, col, nc, vec2);
    }
  }
}

// ------------------------------------------------------------ launches
// Measured at d = 64 (B=32, H=12, T=128 and B=16, T=512; device time of
// five shapes each): dq in 64-row blocks streaming 32-row K/V tiles (87 KB,
// two blocks an SM), dk/dv in 128-key blocks of 8 warps streaming 32-row
// Q/G tiles (122 KB, one block).
using DQ32 = Cfg<32, 4, 32, 1>;
using DQ64 = Cfg<64, 4, 32, 1>;
using DQ128 = Cfg<128, 4, 16, 2>;
using DQ256 = Cfg<256, 2, 16, 2>;
using DKV32 = Cfg<32, 8, 32, 1>;
using DKV64 = Cfg<64, 8, 32, 1>;
using DKV128 = Cfg<128, 4, 32, 2>;
using DKV256 = Cfg<256, 2, 16, 4>;

template <class C>
int launch_dq(const float* q, const float* k, const float* v, const float* g,
              const float* out, const float* lse, const int* kv_len,
              float* dq, float* delta, int B, int H, int Tq, int Tk, int d,
              int causal, float scale, int vec, cudaStream_t stream) {
  // the out rows borrow the split tile (4 BN rows) until delta is known
  static_assert(4 * C::BN >= C::BM, "the split tile must hold the out rows");
  const int ds = ((d + 7) & ~7) + 4;
  const size_t smem = sizeof(float) * (2 * (size_t)C::BM * ds +
                                       6 * (size_t)C::BN * ds);
  auto kern = flash_bwd_dq_kernel<C, false>;
  if constexpr (C::FIXED)
    if (d == C::DP) kern = flash_bwd_dq_kernel<C, true>;
  static int done[2][64] = {};  // per kernel: any width, constant width
  const int e = set_smem(kern, smem, done[C::FIXED && d == C::DP]);
  if (e != 0) return e;
  const unsigned grid = (unsigned)(B * H) * ((Tq + C::BM - 1) / C::BM);
  kern<<<grid, C::NT, smem, stream>>>(q, k, v, g, out, lse, kv_len, dq, delta,
                                      H, Tq, Tk, d, causal, scale, vec);
  return (int)cudaGetLastError();
}

template <class C>
int launch_dkv(const float* q, const float* k, const float* v, const float* g,
               const float* lse, const float* delta, const int* kv_len,
               float* dk, float* dv, int B, int H, int Tq, int Tk, int d,
               int causal, float scale, int vec, cudaStream_t stream) {
  static_assert(C::NT >= 2 * C::BN, "one copy per lse and delta value");
  const int ds = ((d + 7) & ~7) + 4;
  const size_t smem = sizeof(float) * (2 * (size_t)C::BM * ds +
                                       6 * (size_t)C::BN * ds + 4 * C::BN);
  auto kern = flash_bwd_dkv_kernel<C, false>;
  if constexpr (C::FIXED)
    if (d == C::DP) kern = flash_bwd_dkv_kernel<C, true>;
  static int done[2][64] = {};  // per kernel: any width, constant width
  const int e = set_smem(kern, smem, done[C::FIXED && d == C::DP]);
  if (e != 0) return e;
  const unsigned grid = (unsigned)(B * H) * ((Tk + C::BM - 1) / C::BM);
  kern<<<grid, C::NT, smem, stream>>>(q, k, v, g, lse, delta, kv_len, dk, dv,
                                      H, Tq, Tk, d, causal, scale, vec);
  return (int)cudaGetLastError();
}

// d > 256: the slab and group kernels (one launch each, 87 KB).
template <typename K, typename... A>
int launch_wide(K kern, int (&done)[64], int B, int H, int T, int d,
                cudaStream_t stream, A... args) {
  const int e = set_smem(kern, WIDE_SMEM, done);
  if (e != 0) return e;
  const dim3 grid((unsigned)(B * H) * ((T + WBM - 1) / WBM),
                  (d + WSW - 1) / WSW);
  kern<<<grid, WNT, WIDE_SMEM, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool bad_shape(int d, int Tk) { return d < 1 || Tk < 1; }

// ------------------------------------------------------ 16-bit inputs
struct Bwd16Args {
  const uint16_t *q, *k, *v, *g, *out;  // bf16 or f16 bits
  const float* lse;                      // (B, H, Tq)
  float* delta;                          // (B, H, Tq): dq writes, dk/dv reads
  const int* kv_len;                     // (B,), or null
  uint16_t *dq, *dk, *dv;
  int H, Tq, Tk, d, causal;
  float scale;
  int mode;                              // elements a copy moves (mode16)
  int BH;                                // B * H
};

constexpr float kLog2e = 1.4426950408889634f;

// ---- d > 64: the WIDE forms.  64 owned rows (4 warps of 16), 64-row
// streamed tiles, synchronous loads of 64-column slabs for the
// contractions over d, 64-column output groups over the grid's second
// axis (each group recomputes its scores), two-term TF32 products.
constexpr int W16_BM = 64, W16_BN = 64, W16_NT = 128;
constexpr size_t W16_SMEM = 2 * (size_t)DS16 * (2 * W16_BM + 2 * W16_BN);

template <typename T>
__global__ void __launch_bounds__(W16_NT)
flash_bwd16_dq_wide_kernel(const Bwd16Args a) {
  constexpr int BM = W16_BM, BN = W16_BN, NT = W16_NT, NB = BN / 8, NJ = 8;
  extern __shared__ __align__(16) uint16_t sm16[];
  uint16_t* sq = sm16;
  uint16_t* sg = sq + BM * DS16;
  uint16_t* sk = sg + BM * DS16;
  uint16_t* sv = sk + BN * DS16;

  const int tid = threadIdx.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (tid >> 5);
  const int Tq = a.Tq, d = a.d, mode = a.mode;
  const int ntq = (Tq + BM - 1) / BM;
  const int bhx = blockIdx.x / ntq;
  const int q0 = (blockIdx.x - bhx * ntq) * BM;
  const int nrows = min(BM, Tq - q0);
  const int c0 = blockIdx.y * 64, nc = min(64, d - c0);

  int kv_end = a.Tk;
  if (a.kv_len != nullptr) kv_end = min(kv_end, max(0, a.kv_len[bhx / a.H]));
  if (a.causal) kv_end = min(kv_end, q0 + nrows);
  const int ntiles = (kv_end + BN - 1) / BN;
  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * a.Tk;
  const uint16_t* qb = a.q + qoff * d;
  const uint16_t* gb = a.g + qoff * d;
  const uint16_t* kb = a.k + koff * d;
  const uint16_t* vb = a.v + koff * d;
  const int qa = q0 + r0 + gq;  // this thread's rows: qa and qa + 8

  // delta of rows qa, qa + 8 in f32, a quad's lanes over columns tq,
  // tq + 4, .., each sum in a fixed order
  float dl0 = 0.f, dl1 = 0.f;
  const uint16_t* ob = a.out + qoff * d;
  if (qa < Tq)
    for (int c = tq; c < d; c += 4)
      dl0 = fmaf(float16<T>(gb[(size_t)qa * d + c]),
                 float16<T>(ob[(size_t)qa * d + c]), dl0);
  if (qa + 8 < Tq)
    for (int c = tq; c < d; c += 4)
      dl1 = fmaf(float16<T>(gb[(size_t)(qa + 8) * d + c]),
                 float16<T>(ob[(size_t)(qa + 8) * d + c]), dl1);
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, o);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, o);
  }
  if (blockIdx.y == 0 && tq == 0) {
    if (qa < Tq) a.delta[qoff + qa] = dl0;
    if (qa + 8 < Tq) a.delta[qoff + qa + 8] = dl1;
  }
  const float ls0 = qa < Tq ? a.lse[qoff + qa] : 0.f;
  const float ls1 = qa + 8 < Tq ? a.lse[qoff + qa + 8] : 0.f;
  const int w_end = a.causal ? min(kv_end, q0 + r0 + 16) : kv_end;
  const bool warp_live = q0 + r0 < Tq;

  float acc[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN;
    const bool live = warp_live && k0 < w_end;
    float s[NB][4], dpv[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.f;
    for (int cs = 0; cs < d; cs += 64) {
      const int n = min(64, d - cs);
      __syncthreads();
      load_tile16<BM, NT>(sq, qb, q0, Tq, d, cs, n, 64, mode, tid);
      load_tile16<BM, NT>(sg, gb, q0, Tq, d, cs, n, 64, mode, tid);
      load_tile16<BN, NT>(sk, kb, k0, kv_end, d, cs, n, 64, mode, tid);
      load_tile16<BN, NT>(sv, vb, k0, kv_end, d, cs, n, 64, mode, tid);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (live) {
        scores16<T, NB>(s, sq + r0 * DS16, sk, gq, tq);
        scores16<T, NB>(dpv, sg + r0 * DS16, sv, gq, tq);
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = qa + (e >> 1) * 8;
          const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
          const bool ok =
              kpos < kv_end && qpos < Tq && (!a.causal || qpos >= kpos);
          const float p =
              ok ? expf(s[j][e] * a.scale - ((e >> 1) ? ls1 : ls0)) : 0.f;
          s[j][e] = ok ? p * (dpv[j][e] - ((e >> 1) ? dl1 : dl0)) : 0.f;
        }
    }
    __syncthreads();  // this group's columns of the key tile
    load_tile16<BN, NT>(sk, kb, k0, kv_end, d, c0, nc, 64, mode, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // acc += dS K, 8 keys at a time (dS is 0 at every masked key)
    if (live) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        mma2_c16<T, NJ>(acc, s[j], sk + j * 8 * DS16, lane);
    }
  }

  const bool vec2 = d % 2 == 0 && aligned_to(a.dq, 4);
  uint16_t* dqb = a.dq + qoff * d + c0;
#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    const int col = n * 8 + 2 * tq;
    if (col >= nc) continue;
    if (qa < Tq)
      store_pair16<T>(dqb + (size_t)qa * d + col, acc[n][0] * a.scale,
                      acc[n][1] * a.scale, col, nc, vec2);
    if (qa + 8 < Tq)
      store_pair16<T>(dqb + (size_t)(qa + 8) * d + col, acc[n][2] * a.scale,
                      acc[n][3] * a.scale, col, nc, vec2);
  }
}

template <typename T>
__global__ void __launch_bounds__(W16_NT)
flash_bwd16_dkv_wide_kernel(const Bwd16Args a) {
  constexpr int BM = W16_BM, BN = W16_BN, NT = W16_NT, NB = BN / 8, NJ = 8;
  extern __shared__ __align__(16) uint16_t sm16[];
  uint16_t* sk = sm16;
  uint16_t* sv = sk + BM * DS16;
  uint16_t* sq = sv + BM * DS16;
  uint16_t* sg = sq + BN * DS16;

  const int tid = threadIdx.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (tid >> 5);
  const int Tq = a.Tq, d = a.d, mode = a.mode;
  const int ntk = (a.Tk + BM - 1) / BM;
  const int bhx = blockIdx.x / ntk;
  const int k0 = (blockIdx.x - bhx * ntk) * BM;
  const int nkeys = min(BM, a.Tk - k0);
  const int c0 = blockIdx.y * 64, nc = min(64, d - c0);

  int kv_end = a.Tk;
  if (a.kv_len != nullptr) kv_end = min(kv_end, max(0, a.kv_len[bhx / a.H]));
  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * a.Tk;
  uint16_t* dkb = a.dk + koff * d + c0;
  uint16_t* dvb = a.dv + koff * d + c0;
  if (k0 >= kv_end) {  // no live key: exact zeros, nothing loaded
    for (int i = tid; i < nkeys * nc; i += NT) {
      const size_t at = (size_t)(k0 + i / nc) * d + i % nc;
      dkb[at] = 0;
      dvb[at] = 0;
    }
    return;
  }
  // with `causal` no query before the block's first key attends it
  const int i_begin = a.causal ? (k0 / BN) * BN : 0;
  const int ntiles = Tq > i_begin ? (Tq - i_begin + BN - 1) / BN : 0;
  const uint16_t* qb = a.q + qoff * d;
  const uint16_t* gb = a.g + qoff * d;
  const uint16_t* kb = a.k + koff * d;
  const uint16_t* vb = a.v + koff * d;
  const float* lb = a.lse + qoff;
  const float* db = a.delta + qoff;

  const int ka = k0 + r0 + gq;  // this thread's key rows: ka and ka + 8
  const bool warp_live = k0 + r0 < kv_end;
  float acck[NJ][4], accv[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[n][e] = accv[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int i0 = i_begin + it * BN;
    const bool live = warp_live && !(a.causal && i0 + BN <= k0 + r0);
    float s[NB][4], dpv[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.f;
    for (int cs = 0; cs < d; cs += 64) {
      const int n = min(64, d - cs);
      __syncthreads();
      load_tile16<BM, NT>(sk, kb, k0, kv_end, d, cs, n, 64, mode, tid);
      load_tile16<BM, NT>(sv, vb, k0, kv_end, d, cs, n, 64, mode, tid);
      load_tile16<BN, NT>(sq, qb, i0, Tq, d, cs, n, 64, mode, tid);
      load_tile16<BN, NT>(sg, gb, i0, Tq, d, cs, n, 64, mode, tid);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (live) {
        scores16<T, NB>(s, sk + r0 * DS16, sq, gq, tq);
        scores16<T, NB>(dpv, sv + r0 * DS16, sg, gq, tq);
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = ka + (e >> 1) * 8;
          const int qpos = i0 + j * 8 + 2 * tq + (e & 1);
          const bool ok =
              kpos < kv_end && qpos < Tq && (!a.causal || qpos >= kpos);
          float p = 0.f, ds = 0.f;
          if (ok) {
            p = expf(s[j][e] * a.scale - lb[qpos]);
            ds = p * (dpv[j][e] - db[qpos]);
          }
          s[j][e] = p;
          dpv[j][e] = ds;
        }
    }
    __syncthreads();  // this group's columns of the query tile
    load_tile16<BN, NT>(sq, qb, i0, Tq, d, c0, nc, 64, mode, tid);
    load_tile16<BN, NT>(sg, gb, i0, Tq, d, c0, nc, 64, mode, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // dV += P^T G and dK += dS^T Q, 8 queries at a time (P and dS are 0
    // at every masked query; rows past Tq are zeros)
    if (live) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mma2_c16<T, NJ>(accv, s[j], sg + j * 8 * DS16, lane);
        mma2_c16<T, NJ>(acck, dpv[j], sq + j * 8 * DS16, lane);
      }
    }
  }

  // rows at or past kv_end get exact zeros, whatever was accumulated
  const bool vec2 =
      d % 2 == 0 && aligned_to(a.dk, 4) && aligned_to(a.dv, 4);
#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    const int col = n * 8 + 2 * tq;
    if (col >= nc) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ka + 8 * h;
      if (row >= k0 + nkeys) continue;
      const bool ok = row < kv_end;
      const size_t at = (size_t)row * d + col;
      store_pair16<T>(dkb + at, ok ? acck[n][2 * h] * a.scale : 0.f,
                      ok ? acck[n][2 * h + 1] * a.scale : 0.f, col, nc,
                      vec2);
      store_pair16<T>(dvb + at, ok ? accv[n][2 * h] : 0.f,
                      ok ? accv[n][2 * h + 1] : 0.f, col, nc, vec2);
    }
  }
}

// ---- d <= 64: 8 warps own 128 rows (16 each), padded to 64 columns in
// shared memory; streamed tiles of 64 rows (both modes of dk/dv: 64
// queries) through a two-stage `cp.async` ring.
constexpr int R16_BM = 128, R16_BN = 64, R16_NT = 256;

// The largest |x| of each of a thread's two rows over its quad (the four
// lanes that hold a row), and the rows' exponents raised to it: every
// accumulator row rescaled to the new exponent.
template <int NJ>
__device__ __forceinline__ void raise_rows(float m0, float m1, int& eb0,
                                           int& eb1, float (&acc)[NJ][4]) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  const int n0 = max(eb0, ebits(m0)), n1 = max(eb1, ebits(m1));
  const float f0 = eb_rescale(eb0, n0), f1 = eb_rescale(eb1, n1);
#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    acc[n][0] *= f0;
    acc[n][1] *= f0;
    acc[n][2] *= f1;
    acc[n][3] *= f1;
  }
  eb0 = n0;
  eb1 = n1;
}

// dq (two-launch mode): a block owns 128 query rows and streams 64-key
// tiles.  S = Q K^T and dP = G V^T with fragments by `ldmatrix`, then
// dQ += dS K from the accumulators split in T (per-row scale under f16).
// delta in the prologue from the block's g and out rows, written for the
// dk/dv kernel.  Two blocks an SM (128 registers, a few spills): faster
// at T = 512 than one block without spills (PERF.md).
template <typename T>
__global__ void __launch_bounds__(R16_NT, 2)
flash_bwd16_dq_kernel(const Bwd16Args a) {
  constexpr int BM = R16_BM, BN = R16_BN, NT = R16_NT, NB = BN / 8, NJ = 8;
  constexpr bool SC = kF16<T>;
  extern __shared__ __align__(16) uint16_t sm16[];
  uint16_t* sq = sm16;
  uint16_t* sg = sq + BM * DS16;
  uint16_t* so = sg + BM * DS16;
  uint16_t* sk = so + BM * DS16;  // 2 stages
  uint16_t* sv = sk + 2 * BN * DS16;

  const int tid = threadIdx.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (tid >> 5);
  const int Tq = a.Tq, d = a.d, mode = a.mode;
  const int ntq = (Tq + BM - 1) / BM;
  const int bhx = blockIdx.x / ntq;
  const int q0 = (blockIdx.x - bhx * ntq) * BM;
  const int nrows = min(BM, Tq - q0);

  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * a.Tk;
  // the owned rows first: their copies need not wait for the key length
  load_tile16<BM, NT>(sq, a.q + qoff * d, q0, Tq, d, 0, d, 64, mode, tid);
  load_tile16<BM, NT>(sg, a.g + qoff * d, q0, Tq, d, 0, d, 64, mode, tid);
  load_tile16<BM, NT>(so, a.out + qoff * d, q0, Tq, d, 0, d, 64, mode, tid);
  cp_commit();
  int kv_end = a.Tk;
  if (a.kv_len != nullptr) kv_end = min(kv_end, max(0, a.kv_len[bhx / a.H]));
  if (a.causal) kv_end = min(kv_end, q0 + nrows);
  const int ntiles = (kv_end + BN - 1) / BN;
  const uint16_t* kb = a.k + koff * d;
  const uint16_t* vb = a.v + koff * d;
  const int qa = q0 + r0 + gq;  // this thread's rows: qa and qa + 8

  if (ntiles > 0) {
    load_tile16<BN, NT>(sk, kb, 0, kv_end, d, 0, d, 64, mode, tid);
    load_tile16<BN, NT>(sv, vb, 0, kv_end, d, 0, d, 64, mode, tid);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  // delta of rows qa, qa + 8 in f32: lane pair (2r, 2r+1) sums row r of
  // the warp, a half of the columns each, in a fixed order
  float dl0, dl1;
  {
    const int rr = lane >> 1, h = lane & 1;
    const uint16_t* gr = sg + (r0 + rr) * DS16 + 32 * h;
    const uint16_t* orow = so + (r0 + rr) * DS16 + 32 * h;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const float2 x = unpack_f2<T>(ld32(gr + c));
      const float2 y = unpack_f2<T>(ld32(orow + c));
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    dl0 = __shfl_sync(0xffffffffu, sum, 2 * gq);
    dl1 = __shfl_sync(0xffffffffu, sum, 2 * gq + 16);
  }
  if (tq == 0) {
    if (qa < Tq) a.delta[qoff + qa] = dl0;
    if (qa + 8 < Tq) a.delta[qoff + qa + 8] = dl1;
  }
  // lse in log2 units: p = 2^(s scale log2(e) - lse log2(e))
  const float ls0 = qa < Tq ? a.lse[qoff + qa] * kLog2e : 0.f;
  const float ls1 = qa + 8 < Tq ? a.lse[qoff + qa + 8] * kLog2e : 0.f;
  const float sl2 = a.scale * kLog2e;
  const int w_end = a.causal ? min(kv_end, q0 + r0 + 16) : kv_end;
  const bool warp_live = q0 + r0 < Tq;

  float acc[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  int eb0 = kEbMin, eb1 = kEbMin;  // f16: the rows' exponents

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN, st = it & 1;
    cp_wait<0>();
    __syncthreads();  // tile `it` landed; stage it + 1's readers are done
    if (it + 1 < ntiles) {
      const int nx = (st ^ 1) * BN * DS16;
      load_tile16<BN, NT>(sk + nx, kb, k0 + BN, kv_end, d, 0, d, 64, mode,
                          tid);
      load_tile16<BN, NT>(sv + nx, vb, k0 + BN, kv_end, d, 0, d, 64, mode,
                          tid);
    }
    cp_commit();
    if (!(warp_live && k0 < w_end)) continue;
    const uint16_t* kt = sk + st * BN * DS16;
    const uint16_t* vt = sv + st * BN * DS16;
    float s[NB][4], dpv[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.f;
    scores16_ldsm<T, NB>(s, sq + r0 * DS16, kt, lane);
    scores16_ldsm<T, NB>(dpv, sg + r0 * DS16, vt, lane);
    float m0 = 0.f, m1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qa + (e >> 1) * 8;
        const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
        const bool ok =
            kpos < kv_end && qpos < Tq && (!a.causal || qpos >= kpos);
        const float p = exp2f(fmaf(s[j][e], sl2, -((e >> 1) ? ls1 : ls0)));
        const float ds = ok ? p * (dpv[j][e] - ((e >> 1) ? dl1 : dl0)) : 0.f;
        s[j][e] = ds;
        if (e >> 1)
          m1 = fmaxf(m1, fabsf(ds));
        else
          m0 = fmaxf(m0, fabsf(ds));
      }
    // acc += dS K, 16 keys a step (dS is 0 at every masked key)
    if constexpr (SC) raise_rows<NJ>(m0, m1, eb0, eb1, acc);
    const float sc0 = SC ? eb_scale(eb0) : 1.f;
    const float sc1 = SC ? eb_scale(eb1) : 1.f;
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) {
      uint32_t h[4], l[4];
      frag_split16<T, NB>(s, i, sc0, sc1, h, l);
      mma_hl16<T, NJ>(acc, h, l, kt + 16 * i * DS16, lane);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the Q rows are free: dQ stages there
  stage16<T, NJ>(sq + r0 * DS16, acc, a.scale * (SC ? eb_unscale(eb0) : 1.f),
                 a.scale * (SC ? eb_unscale(eb1) : 1.f), true, true, lane);
  __syncthreads();
  store_tile16<NT>(a.dq + (qoff + q0) * d, sq, nrows, d, tid);
}

// dk/dv: a block owns 128 keys (a warp 16) and streams tiles of BQ
// queries.  S^T = K Q^T and dP^T = V G^T with fragments by `ldmatrix`;
// P^T and dS^T go from the accumulators, split in T, into
// dV += P^T G and dK += dS^T Q (B by transposed `ldmatrix`).
//
// FUSED (Tk <= 128): the block owns every key of its head, so it also
// forms delta (from each tile's g and out rows) and dQ: each warp writes
// its dS^T rows (hi and lo) to shared memory (two buffers), and in the
// next tile, before the barrier that tile needs for its delta anyway, the
// eight warps compute this tile's dQ = dS K (A by transposed `ldmatrix`
// from those rows, B = the block's K, the depth cut at kv_end) and stage
// it for one coalesced store.  No dQ sum crosses blocks: five products,
// every input read once, no delta in memory, no atomics.  Under f16 the
// split's scale is one for the block (dQ's rows are queries, dK's keys),
// raised tile by tile from the tile's largest |dS| (a shared-memory max
// and one more barrier).  The grid is persistent (one block an SM walks
// heads), and the next head's K, V (the other of two buffers) and first
// query tile load during the last tile: measured, that hid most of the
// fixed cost a block paid per head when each block had one.
template <bool FUSED>
constexpr size_t dkv16_smem() {
  // K and V (FUSED: two heads' buffers), Q and G (FUSED: and out) in two
  // stages, FUSED: dS^T hi and lo twice and a dQ tile; lse, delta, smax
  constexpr size_t BQ = R16_BN;
  return 2 * (size_t)DS16 * ((FUSED ? 4 : 2) * R16_BM + (FUSED ? 7 : 4) * BQ) +
         (FUSED ? 2 * 2 * 2 * (size_t)R16_BM * (BQ + 8) : 0) + 4 * 4 * BQ +
         16;
}

// One block an SM in both modes: the fused mode's registers allow no
// more; two-launch blocks at two an SM spilled 372-524 B for 1-4.5% at
// T = 512 (PERF.md).
template <typename T, bool FUSED>
__global__ void __launch_bounds__(R16_NT, 1)
flash_bwd16_dkv_kernel(const Bwd16Args a) {
  constexpr int BM = R16_BM, NT = R16_NT, NJ = 8;
  constexpr int BQ = R16_BN, NB = BQ / 8;
  constexpr int DSQ = BQ + 8;  // row stride of the dS^T tiles (elements)
  constexpr bool SC = kF16<T>;
  extern __shared__ __align__(16) uint16_t sm16[];
  constexpr int NKV = FUSED ? 2 : 1;  // K and V buffers
  uint16_t* skv = sm16;              // K, V of buffer j at skv + 2 j BM DS16
  uint16_t* sq = skv + 2 * NKV * BM * DS16;  // 2 stages
  uint16_t* sg = sq + 2 * BQ * DS16;
  uint16_t* so = sg + 2 * BQ * DS16;                 // FUSED: 2 stages
  uint16_t* sdh = so + (FUSED ? 2 * BQ * DS16 : 0);  // FUSED: dS^T hi
  uint16_t* sdl = sdh + (FUSED ? 2 * BM * DSQ : 0);  //        and lo, 2 each
  uint16_t* sdq = sdl + (FUSED ? 2 * BM * DSQ : 0);  // FUSED: a dQ tile
  float* sl = reinterpret_cast<float*>(sdq + (FUSED ? BQ * DS16 : 0));
  float* sd = sl + 2 * BQ;  // delta: 2 stages (FUSED: the tile's)
  unsigned* smax = reinterpret_cast<unsigned*>(sd + 2 * BQ);  // 2 slots

  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp;
  const int Tq = a.Tq, d = a.d, mode = a.mode;
  const int ntk = (a.Tk + BM - 1) / BM;  // FUSED: 1
  // A block's units of work: one (head, 128 keys) a block; FUSED, the
  // heads blockIdx.x, + gridDim.x, .. (a persistent grid), the next
  // head's K, V and first query tile prefetched during the last tile
  const int nunits = FUSED ? a.BH : (int)gridDim.x;
  auto unit_end = [&](int u) {  // kv_end of unit u's head
    int e = a.Tk;
    if (a.kv_len != nullptr) e = min(e, max(0, a.kv_len[u / ntk / a.H]));
    return e;
  };
  auto load_stage = [&](int st, int u, int i0) {
    const size_t qo = (size_t)(u / ntk) * Tq;
    load_tile16<BQ, NT>(sq + st * BQ * DS16, a.q + qo * d, i0, Tq, d, 0, d,
                        64, mode, tid);
    load_tile16<BQ, NT>(sg + st * BQ * DS16, a.g + qo * d, i0, Tq, d, 0, d,
                        64, mode, tid);
    load_vec<NT>(sl + st * BQ, a.lse + qo, i0, BQ, Tq, tid);
    if constexpr (FUSED)
      load_tile16<BQ, NT>(so + st * BQ * DS16, a.out + qo * d, i0, Tq, d,
                          0, d, 64, mode, tid);
    else
      load_vec<NT>(sd + st * BQ, a.delta + qo, i0, BQ, Tq, (tid + BQ) % NT);
  };
  auto load_kv = [&](int buf, int u, int kv_end) {
    const size_t ko = (size_t)(u / ntk) * a.Tk;
    const int k0 = (u % ntk) * BM;
    uint16_t* dst = skv + 2 * buf * BM * DS16;
    load_tile16<BM, NT>(dst, a.k + ko * d, k0, kv_end, d, 0, d, 64, mode,
                        tid);
    load_tile16<BM, NT>(dst + BM * DS16, a.v + ko * d, k0, kv_end, d, 0, d,
                        64, mode, tid);
  };
  if (FUSED && SC && tid < 2) smax[tid] = 0;
  int gs = 0;              // query tiles consumed: stage and dS^T buffer gs & 1
  int buf = 0;             // FUSED: the unit's K and V buffer
  int next_end = -1;       // FUSED: kv_end of a unit already issued, else -1

  for (int unit = blockIdx.x; unit < nunits; unit += gridDim.x) {
  const int bhx = unit / ntk;
  const int k0 = (unit - bhx * ntk) * BM;
  const int nkeys = min(BM, a.Tk - k0);
  const size_t qoff = (size_t)bhx * Tq, koff = (size_t)bhx * a.Tk;
  uint16_t* dkb = a.dk + koff * d;
  uint16_t* dvb = a.dv + koff * d;
  uint16_t* sk = skv + 2 * buf * BM * DS16;
  uint16_t* sv = sk + BM * DS16;
  // with `causal` no query before the block's first key attends it
  const int i_begin = a.causal ? (k0 / BQ) * BQ : 0;
  const int ntiles = Tq > i_begin ? (Tq - i_begin + BQ - 1) / BQ : 0;
  const int nx = unit + (int)gridDim.x;
  const int nx_end = FUSED && nx < nunits ? unit_end(nx) : 0;
  int kv_end = next_end;
  if (next_end < 0) {
    // FUSED: the first query tile's copies need not wait for the length
    if (FUSED) load_stage(gs & 1, unit, 0);
    kv_end = unit_end(unit);
    if (k0 >= kv_end) {  // no live key: exact zeros
      cp_wait<0>();
      for (int i = tid; i < nkeys * d; i += NT) {
        dkb[(size_t)k0 * d + i] = 0;
        dvb[(size_t)k0 * d + i] = 0;
      }
      if constexpr (FUSED)
        for (int i = tid; i < Tq * d; i += NT) a.dq[qoff * d + i] = 0;
      continue;
    }
    load_kv(buf, unit, kv_end);
    if (!FUSED && ntiles > 0) load_stage(0, unit, i_begin);
    cp_commit();
  }

  const int ka = k0 + r0 + gq;  // this thread's key rows: ka and ka + 8
  const bool warp_live = k0 + r0 < kv_end;
  const float sl2 = a.scale * kLog2e;
  float acck[NJ][4], accv[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[n][e] = accv[n][e] = 0.f;
  int eb0 = kEbMin, eb1 = kEbMin;  // f16: the key rows' (FUSED: block's)

  // FUSED: dQ = dS K of a tile from dS^T buffer `dsb` (exponent eb under
  // f16) into the shared dQ tile; warp w takes rows 16 (w % RG).. and CW
  // columns, A by transposed `ldmatrix` from the dS^T rows, B = K
  auto tile_dq = [&](int dsb, int eb) {
    constexpr int RG = BQ / 16, CW = 64 / (8 / RG), NJQ = CW / 8;
    const int qr0 = 16 * (warp % RG), cq0 = CW * (warp / RG);
    float accq[NJQ][4];
#pragma unroll
    for (int n = 0; n < NJQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) accq[n][e] = 0.f;
    const int at = dsb * BM * DSQ +
                   ((lane & 7) + ((lane >> 4) << 3)) * DSQ + qr0 + (lane & 8);
#pragma unroll
    for (int c = 0; c < BM / 16; ++c) {  // dS is 0 past kv_end
      if (16 * c >= kv_end) break;
      uint32_t h[4], l[4];
      ldsm_x4_t(h, sdh + at + 16 * c * DSQ);
      ldsm_x4_t(l, sdl + at + 16 * c * DSQ);
      mma_hl16<T, NJQ>(accq, h, l, sk + 16 * c * DS16 + cq0, lane);
    }
    const float f = a.scale * (SC ? eb_unscale(eb) : 1.f);
    stage16<T, NJQ>(sdq + qr0 * DS16 + cq0, accq, f, f, true, true, lane);
  };
  // the staged dQ tile of query i0 to memory (after a barrier)
  auto store_dq = [&](int i0) {
    store_tile16<NT>(a.dq + (qoff + i0) * d, sdq, min(BQ, Tq - i0), d, tid);
  };

  for (int it = 0; it < ntiles; ++it, ++gs) {
    const int i0 = i_begin + it * BQ, st = gs & 1;
    cp_wait<0>();
    // tile `it` landed; stage it + 1's readers (FUSED: also the last
    // tile's dS^T and smax slot's) are done
    __syncthreads();
    if (it + 1 < ntiles) {
      load_stage(st ^ 1, unit, i0 + BQ);
    } else if (nx_end > 0) {  // FUSED: the next head's first loads
      load_stage(st ^ 1, nx, 0);
      load_kv(buf ^ 1, nx, nx_end);
    }
    cp_commit();
    const bool live = warp_live && !(a.causal && i0 + BQ <= k0 + r0);
    if (!FUSED && !live) continue;
    const uint16_t* qt = sq + st * BQ * DS16;
    const uint16_t* gt = sg + st * BQ * DS16;
    const float* lt = sl + st * BQ;
    float* dt = sd + (FUSED ? 0 : st * BQ);
    if constexpr (FUSED) {
      if (SC && tid == 0) smax[st ^ 1] = 0;
      // the tile's delta: BQ rows, NT / BQ threads a row, in a fixed order
      constexpr int TPR = NT / BQ, CPT = 64 / TPR;
      const int row = tid / TPR, part = tid % TPR;
      const uint16_t* gr = gt + row * DS16 + part * CPT;
      const uint16_t* orow = so + st * BQ * DS16 + row * DS16 + part * CPT;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; c += 2) {
        const float2 x = unpack_f2<T>(ld32(gr + c));
        const float2 y = unpack_f2<T>(ld32(orow + c));
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (part == 0) dt[row] = sum;
    }
    float s[NB][4], dpv[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpv[j][e] = 0.f;
    if (live) {
      scores16_ldsm<T, NB>(s, sk + r0 * DS16, qt, lane);
      scores16_ldsm<T, NB>(dpv, sv + r0 * DS16, gt, lane);
    }
    if constexpr (FUSED) {
      // the last tile's dQ (its dS^T whole since the barrier above), to
      // memory once staged
      if (it > 0) tile_dq(st ^ 1, eb0);
      __syncthreads();  // the tile's delta (and the last dQ tile) whole
      if (it > 0) store_dq(i0 - BQ);
    }
    float m0 = 0.f, m1 = 0.f;
    if (live) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = ka + (e >> 1) * 8;
          const int col = j * 8 + 2 * tq + (e & 1);
          const int qpos = i0 + col;
          const bool ok =
              kpos < kv_end && qpos < Tq && (!a.causal || qpos >= kpos);
          const float p = exp2f(fmaf(s[j][e], sl2, -lt[col] * kLog2e));
          const float ds = p * (dpv[j][e] - dt[col]);
          s[j][e] = ok ? p : 0.f;
          dpv[j][e] = ok ? ds : 0.f;
          if (e >> 1)
            m1 = fmaxf(m1, fabsf(dpv[j][e]));
          else
            m0 = fmaxf(m0, fabsf(dpv[j][e]));
        }
    }
    if constexpr (SC) {
      if constexpr (FUSED) {
        const unsigned m =
            __reduce_max_sync(0xffffffffu, __float_as_uint(fmaxf(m0, m1)));
        if (lane == 0) atomicMax(&smax[st], m);
        __syncthreads();  // the tile's largest |dS|
        const int eb = max(eb0, ebits(__uint_as_float(smax[st])));
        if (eb != eb0) {
          const float f = eb_rescale(eb0, eb);
#pragma unroll
          for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acck[n][e] *= f;
          eb0 = eb1 = eb;
        }
      } else {
        raise_rows<NJ>(m0, m1, eb0, eb1, acck);
      }
    }
    // dV += P^T G and dK += dS^T Q, 16 queries a step (P and dS are 0 at
    // every masked query; rows past Tq are zeros)
    if (live) {
      const float sc0 = SC ? eb_scale(eb0) : 1.f;
      const float sc1 = SC ? eb_scale(eb1) : 1.f;
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {
        uint32_t h[4], l[4];
        frag_split16<T, NB>(s, i, 1.f, 1.f, h, l);
        mma_hl16<T, NJ>(accv, h, l, gt + 16 * i * DS16, lane);
        frag_split16<T, NB>(dpv, i, sc0, sc1, h, l);
        mma_hl16<T, NJ>(acck, h, l, qt + 16 * i * DS16, lane);
        if constexpr (FUSED) {  // dS^T rows r0.., columns 16i.. (A order)
          const int at = st * BM * DSQ + (r0 + gq) * DSQ + 16 * i + 2 * tq;
          uint32_t* ph = reinterpret_cast<uint32_t*>(sdh + at);
          uint32_t* pl = reinterpret_cast<uint32_t*>(sdl + at);
          ph[0] = h[0];
          ph[4 * DSQ] = h[1];
          ph[4] = h[2];
          ph[4 * DSQ + 4] = h[3];
          pl[0] = l[0];
          pl[4 * DSQ] = l[1];
          pl[4] = l[2];
          pl[4 * DSQ + 4] = l[3];
        }
      }
    } else if constexpr (FUSED) {  // a dead warp's dS^T rows are zeros
      for (int i = lane; i < 16 * BQ / 2; i += 32) {
        const int at =
            st * BM * DSQ + (r0 + i / (BQ / 2)) * DSQ + 2 * (i % (BQ / 2));
        *reinterpret_cast<uint32_t*>(sdh + at) = 0u;
        *reinterpret_cast<uint32_t*>(sdl + at) = 0u;
      }
    }
  }
  if constexpr (FUSED) {  // the last tile's dQ
    __syncthreads();      // its dS^T is whole
    tile_dq((gs - 1) & 1, eb0);
  }
  // K and V rows free: dK and dV stage there.  Two-launch mode: no copy
  // in flight (with no query tile, the K and V copies were still); FUSED:
  // the next head's, into the other buffer, stay in flight
  if constexpr (!FUSED) cp_wait<0>();
  __syncthreads();
  if constexpr (FUSED) store_dq(i_begin + (ntiles - 1) * BQ);
  // rows at or past kv_end get exact zeros, whatever was accumulated
  const float fk0 = a.scale * (SC ? eb_unscale(eb0) : 1.f);
  const float fk1 = a.scale * (SC ? eb_unscale(eb1) : 1.f);
  stage16<T, NJ>(sk + r0 * DS16, acck, fk0, fk1, ka < kv_end,
                 ka + 8 < kv_end, lane);
  stage16<T, NJ>(sv + r0 * DS16, accv, 1.f, 1.f, ka < kv_end,
                 ka + 8 < kv_end, lane);
  __syncthreads();
  store_tile16<NT>(dkb + (size_t)k0 * d, sk, nkeys, d, tid);
  store_tile16<NT>(dvb + (size_t)k0 * d, sv, nkeys, d, tid);
  next_end = nx_end > 0 ? nx_end : -1;
  buf ^= NKV - 1;
  }
  cp_wait<0>();
}

template <typename K>
int launch16(K kern, size_t smem, int (&done)[64], dim3 grid, int nt,
             const Bwd16Args& a, cudaStream_t st) {
  const int e = set_smem(kern, smem, done);
  if (e != 0) return e;
  kern<<<grid, nt, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// mode: 0 dq, 1 dk/dv, 2 the fused backward (Tk <= 128, d <= 64)
template <typename T>
int launch_bwd16(const Bwd16Args& a, int B, int mode, cudaStream_t st) {
  const unsigned bh = (unsigned)(B * a.H);
  if (a.d > 64) {  // the WIDE forms
    static int done[2][64] = {};
    const int rows = mode ? a.Tk : a.Tq;
    const dim3 grid(bh * ((rows + W16_BM - 1) / W16_BM), (a.d + 63) / 64);
    return mode ? launch16(flash_bwd16_dkv_wide_kernel<T>, W16_SMEM, done[1],
                           grid, W16_NT, a, st)
                : launch16(flash_bwd16_dq_wide_kernel<T>, W16_SMEM, done[0],
                           grid, W16_NT, a, st);
  }
  static int done[3][64] = {};
  if (mode == 0)
    return launch16(flash_bwd16_dq_kernel<T>,
                    2 * (size_t)DS16 * (3 * R16_BM + 4 * R16_BN), done[0],
                    dim3(bh * ((a.Tq + R16_BM - 1) / R16_BM)), R16_NT, a, st);
  if (mode == 1)
    return launch16(flash_bwd16_dkv_kernel<T, false>,
                    dkv16_smem<false>(), done[1],
                    dim3(bh * ((a.Tk + R16_BM - 1) / R16_BM)), R16_NT, a, st);
  // the fused mode's persistent grid: as many blocks as fit the card
  auto kern = flash_bwd16_dkv_kernel<T, true>;
  constexpr size_t smem = dkv16_smem<true>();
  int e = set_smem(kern, smem, done[2]);
  if (e != 0) return e;
  static int slots[64] = {};  // per device: SMs times blocks an SM
  int dev = 0, n = 0;
  if ((e = (int)cudaGetDevice(&dev)) != 0) return e;
  if (dev < 64) n = slots[dev];
  if (n == 0) {
    int sms = 0, per_sm = 0;
    if ((e = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != 0 ||
        (e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, R16_NT, smem)) != 0)
      return e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    n = sms * per_sm;
    if (dev < 64) slots[dev] = n;
  }
  return launch16(kern, smem, done[2], dim3(min(bh, (unsigned)n)), R16_NT,
                  a, st);
}

template <typename T>
int bwd16(const void* q, const void* k, const void* v, const void* g,
          const void* out, const void* lse, void* delta, const void* kv_len,
          void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, int d,
          int causal, float scale, int mode, void* stream) {
  if (B * H == 0 || (mode == 0 && Tq == 0)) return 0;
  if (bad_shape(d, Tk) || (mode != 0 && Tq < 1) ||
      (mode == 2 && (d > 64 || Tk > R16_BM)))
    return (int)cudaErrorInvalidValue;
  Bwd16Args a;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.g = static_cast<const uint16_t*>(g);
  a.out = static_cast<const uint16_t*>(out);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.kv_len = static_cast<const int*>(kv_len);
  a.dq = static_cast<uint16_t*>(dq);
  a.dk = static_cast<uint16_t*>(dk);
  a.dv = static_cast<uint16_t*>(dv);
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.d = d;
  a.causal = causal;
  a.scale = scale;
  a.mode = mode16(d, q, k, v, g, out);
  a.BH = B * H;
  return launch_bwd16<T>(a, B, mode, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// q, g, out (B,H,Tq,d); k, v (B,H,Tk,d); lse (B,H,Tq): f32, contiguous.
// kv_len (B,) int32 or null (every row attends all Tk keys).  causal: 0
// or 1.  Any d >= 1, any Tq, Tk >= 1.  Writes dq (B,H,Tq,d) and each
// row's delta = sum(g * out) to delta (B,H,Tq).  Returns
// cudaGetLastError() after the launch (0 on success).
int mx_flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                  const void* g, const void* out,
                                  const void* lse, const void* kv_len,
                                  void* dq, void* delta, int B, int H, int Tq,
                                  int Tk, int d, int causal, float scale,
                                  void* stream) {
  if (B * H == 0 || Tq == 0) return 0;
  if (bad_shape(d, Tk)) return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(g);
  const auto* of = static_cast<const float*>(out);
  const auto* lf = static_cast<const float*>(lse);
  const auto* lens = static_cast<const int*>(kv_len);
  auto* dqf = static_cast<float*>(dq);
  auto* df = static_cast<float*>(delta);
  auto st = static_cast<cudaStream_t>(stream);
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(g) && aligned16(out);
  if (d <= 32)
    return launch_dq<DQ32>(qf, kf, vf, gf, of, lf, lens, dqf, df, B, H, Tq,
                           Tk, d, causal, scale, vec, st);
  if (d <= 64)
    return launch_dq<DQ64>(qf, kf, vf, gf, of, lf, lens, dqf, df, B, H, Tq,
                           Tk, d, causal, scale, vec, st);
  if (d <= 128)
    return launch_dq<DQ128>(qf, kf, vf, gf, of, lf, lens, dqf, df, B, H, Tq,
                            Tk, d, causal, scale, vec, st);
  if (d > 256) {
    static int done[64] = {};
    return launch_wide(flash_bwd_dq_wide_kernel, done, B, H, Tq, d, st, qf,
                       kf, vf, gf, of, lf, lens, dqf, df, H, Tq, Tk, d,
                       causal, scale, vec);
  }
  return launch_dq<DQ256>(qf, kf, vf, gf, of, lf, lens, dqf, df, B, H, Tq,
                          Tk, d, causal, scale, vec, st);
}

// q, g (B,H,Tq,d); k, v (B,H,Tk,d); lse and the dq kernel's delta
// (B,H,Tq): as above.  Writes dk and dv (B,H,Tk,d), exact zeros at key
// rows >= the row's length.
int mx_flash_attention_bwd_dkv_f32(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse, const void* delta,
                                   const void* kv_len, void* dk, void* dv,
                                   int B, int H, int Tq, int Tk, int d,
                                   int causal, float scale, void* stream) {
  if (B * H == 0) return 0;
  if (bad_shape(d, Tk) || Tq < 1) return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(g);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  const auto* lens = static_cast<const int*>(kv_len);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(g);
  if (d <= 32)
    return launch_dkv<DKV32>(qf, kf, vf, gf, lf, df, lens, dkf, dvf, B, H, Tq,
                             Tk, d, causal, scale, vec, st);
  if (d <= 64)
    return launch_dkv<DKV64>(qf, kf, vf, gf, lf, df, lens, dkf, dvf, B, H, Tq,
                             Tk, d, causal, scale, vec, st);
  if (d <= 128)
    return launch_dkv<DKV128>(qf, kf, vf, gf, lf, df, lens, dkf, dvf, B, H,
                              Tq, Tk, d, causal, scale, vec, st);
  if (d > 256) {
    static int done[64] = {};
    return launch_wide(flash_bwd_dkv_wide_kernel, done, B, H, Tk, d, st, qf,
                       kf, vf, gf, lf, df, lens, dkf, dvf, H, Tq, Tk, d,
                       causal, scale, vec);
  }
  return launch_dkv<DKV256>(qf, kf, vf, gf, lf, df, lens, dkf, dvf, B, H, Tq,
                            Tk, d, causal, scale, vec, st);
}

// As the f32 entries with q, k, v, g, out, dq, dk and dv bf16 (f16),
// contiguous, any alignment; lse and delta stay f32.
#define MX_BWD16_ENTRIES(SFX, T)                                            \
  int mx_flash_attention_bwd_dq_##SFX(                                      \
      const void* q, const void* k, const void* v, const void* g,           \
      const void* out, const void* lse, const void* kv_len, void* dq,       \
      void* delta, int B, int H, int Tq, int Tk, int d, int causal,         \
      float scale, void* stream) {                                          \
    return bwd16<T>(q, k, v, g, out, lse, delta, kv_len, dq, nullptr,      \
                    nullptr, B, H, Tq, Tk, d, causal, scale, 0, stream);    \
  }                                                                         \
  int mx_flash_attention_bwd_dkv_##SFX(                                     \
      const void* q, const void* k, const void* v, const void* g,           \
      const void* lse, const void* delta, const void* kv_len, void* dk,     \
      void* dv, int B, int H, int Tq, int Tk, int d, int causal,            \
      float scale, void* stream) {                                          \
    return bwd16<T>(q, k, v, g, nullptr, lse, const_cast<void*>(delta),    \
                    kv_len, nullptr, dk, dv, B, H, Tq, Tk, d, causal,       \
                    scale, 1, stream);                                      \
  }                                                                         \
  /* one launch of the dk/dv kernel in its fused mode: dq, dk and dv of  */ \
  /* inputs with Tk <= 128 and d <= 64 (else cudaErrorInvalidValue)      */ \
  int mx_flash_attention_bwd_fused_##SFX(                                   \
      const void* q, const void* k, const void* v, const void* g,           \
      const void* out, const void* lse, const void* kv_len, void* dq,       \
      void* dk, void* dv, int B, int H, int Tq, int Tk, int d, int causal,  \
      float scale, void* stream) {                                          \
    return bwd16<T>(q, k, v, g, out, lse, nullptr, kv_len, dq, dk, dv, B,  \
                    H, Tq, Tk, d, causal, scale, 2, stream);                \
  }

MX_BWD16_ENTRIES(bf16, __nv_bfloat16)
MX_BWD16_ENTRIES(f16, __half)

}  // extern "C"
