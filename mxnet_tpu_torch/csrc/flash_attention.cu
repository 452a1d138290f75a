// Flash-attention forward for Hopper (sm_90a), f32, on tensor cores.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py `_flash_kernel`
// (launched by `_flash_forward_pallas`).  For each (b, h) and each query
// row it attends the key positions kpos < kv_end, where kv_end is Tk or,
// with a per-row length, min(Tk, kv_len[b]); with `causal` a query at
// position qpos also needs kpos <= qpos (no offset between the two axes,
// as the TPU kernel and `_merge_mask` define it).  Optionally writes the
// f32 row log-sum-exp.  Any Tq, Tk >= 1 and any d >= 1, so nothing needs
// the TPU kernel's "not tile-able" fallback.
//
// The kernels are flash_fwd.cuh's: 3xTF32 `mma.sync` products with S and
// P in registers, K/V tiles double-buffered by `cp.async` and split once
// per block, a wide variant for d > 256 (slabs of the contraction, groups
// of the output columns); that header says what bounds them on an H100.
// bf16 and f16 inputs take `flash_fwd16_kernel` there (16-bit MMAs for
// S and P V, the TPU kernel's roundings), through entries of their own.

#include "flash_fwd.cuh"

extern "C" {

// q (B,H,Tq,d), k/v (B,H,Tk,d), out (B,H,Tq,d): f32, contiguous.  kv_len
// (B,) int32 or null (every row attends all Tk keys); lse (B,H,Tq) f32 or
// null.  causal: 0 or 1.  d >= 1, Tk >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
int mx_flash_attention_f32(const void* q, const void* k, const void* v,
                           const void* kv_len, void* out, void* lse, int B,
                           int H, int Tq, int Tk, int d, int causal,
                           float scale, void* stream) {
  if (B * H == 0 || Tq == 0) return 0;
  if (d < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.k_scale = a.v_scale = nullptr;
  a.kv_len = static_cast<const int*>(kv_len);
  a.q_off = nullptr;
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.d = d;
  a.causal = causal;
  a.scale = scale;
  a.vec_q = d % 4 == 0 && aligned16(q);
  a.kv_mode = d % 4 == 0 && aligned16(k) && aligned16(v) ? 16 : 4;
  return launch_fwd<KV_F32>(a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

namespace {

template <typename T>
int flash16(const void* q, const void* k, const void* v, const void* kv_len,
            void* out, void* lse, int B, int H, int Tq, int Tk, int d,
            int causal, float scale, void* stream) {
  if (B * H == 0 || Tq == 0) return 0;
  if (d < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  Fwd16Args a;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.kv_len = static_cast<const int*>(kv_len);
  a.q_off = nullptr;
  a.out = static_cast<uint16_t*>(out);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.d = d;
  a.causal = causal;
  a.scale = scale;
  a.mode = mode16(d, q, k, v);
  return launch_fwd16<T>(a, B, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// As mx_flash_attention_f32 with q, k, v and out bf16 (f16), contiguous,
// any alignment; lse stays f32.
int mx_flash_attention_bf16(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* lse, int B,
                            int H, int Tq, int Tk, int d, int causal,
                            float scale, void* stream) {
  return flash16<__nv_bfloat16>(q, k, v, kv_len, out, lse, B, H, Tq, Tk, d,
                                causal, scale, stream);
}

int mx_flash_attention_f16(const void* q, const void* k, const void* v,
                           const void* kv_len, void* out, void* lse, int B,
                           int H, int Tq, int Tk, int d, int causal,
                           float scale, void* stream) {
  return flash16<__half>(q, k, v, kv_len, out, lse, B, H, Tq, Tk, d, causal,
                         scale, stream);
}

}  // extern "C"
