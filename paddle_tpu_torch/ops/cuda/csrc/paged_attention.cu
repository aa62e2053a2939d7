// Kernel A5, fp pages: the page walk of `paged_attention.cuh` over a cache
// in q's type (bf16 or f32).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `paged_attention`
// (`_kernel`, pallas_call at :249) without `has_quant`. The design notes
// are in the header.
#include "paged_attention.cuh"

extern "C" int paged_attention_fwd(const void* q, const void* kc,
                                   const void* vc, const void* tables,
                                   const void* past, const void* this_lens,
                                   void* out, int B, int KV, int rows, int hd,
                                   int bs, int max_blocks, int group,
                                   float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, kc, vc, nullptr, nullptr, tables, past, this_lens, out, B, KV,
        rows, hd, bs, max_blocks, group, sm_scale, s);
  if (dtype == DTYPE_F32)
    return launch<float, float, false>(q, kc, vc, nullptr, nullptr, tables,
                                       past, this_lens, out, B, KV, rows, hd,
                                       bs, max_blocks, group, sm_scale, s);
  return cudaErrorInvalidValue;
}
