// Decode-mode attention for bf16 queries, for Hopper (sm_90a): over an f32,
// int8, bf16 or f16 KV cache, the output in bf16.  The kernels are
// decode_attention.cuh's; this source instantiates the bf16-query pairs
// behind their C entries, so they build beside the f32 ones.

#include "decode_attention.cuh"

extern "C" {

MX_DECODE_ENTRY(mx_decode_attention_bf16_f32, KV_F32, __nv_bfloat16)
MX_DECODE_ENTRY(mx_decode_attention_bf16_int8, KV_I8, __nv_bfloat16)
MX_DECODE_ENTRY(mx_decode_attention_bf16_bf16, KV_BF16, __nv_bfloat16)
MX_DECODE_ENTRY(mx_decode_attention_bf16_f16, KV_F16, __nv_bfloat16)

}  // extern "C"
