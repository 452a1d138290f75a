// Decode-mode attention for f32 queries, for Hopper (sm_90a): over an f32,
// int8, bf16 or f16 KV cache.  The kernels, what they compute and what
// bounds them are in decode_attention.cuh; this source instantiates the
// f32-query pairs behind their C entries (decode_attention_bf16.cu and
// decode_attention_f16.cu hold the 16-bit queries', built beside it).

#include "decode_attention.cuh"

extern "C" {

MX_DECODE_ENTRY(mx_decode_attention_f32_f32, KV_F32, float)
MX_DECODE_ENTRY(mx_decode_attention_f32_int8, KV_I8, float)
MX_DECODE_ENTRY(mx_decode_attention_f32_bf16, KV_BF16, float)
MX_DECODE_ENTRY(mx_decode_attention_f32_f16, KV_F16, float)

}  // extern "C"
