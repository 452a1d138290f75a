// Decode-mode attention for f16 queries, for Hopper (sm_90a): over an f32,
// int8, bf16 or f16 KV cache, the output in f16.  The kernels are
// decode_attention.cuh's; this source instantiates the f16-query pairs
// behind their C entries, so they build beside the f32 ones.

#include "decode_attention.cuh"

extern "C" {

MX_DECODE_ENTRY(mx_decode_attention_f16_f32, KV_F32, __half)
MX_DECODE_ENTRY(mx_decode_attention_f16_int8, KV_I8, __half)
MX_DECODE_ENTRY(mx_decode_attention_f16_bf16, KV_BF16, __half)
MX_DECODE_ENTRY(mx_decode_attention_f16_f16, KV_F16, __half)

}  // extern "C"
