// Kernel A5, fp pages: `paged_attention.cuh` over a cache in q's type —
// bf16 on the tensor cores (`paged::`), f32 on the CUDA cores.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `paged_attention`
// (`_kernel`, pallas_call at :249) without `has_quant`. The design notes
// are in the header.
#include "paged_attention.cuh"

// part: the split rows' f32 partials (bf16 q; null when splits < 2);
// span, splits, part_rows: the wrapper's `paged_splits`.
extern "C" int paged_attention_fwd(const void* q, const void* kc,
                                   const void* vc, const void* tables,
                                   const void* past, const void* this_lens,
                                   void* out, void* part, int B, int KV,
                                   int rows, int hd, int bs, int max_blocks,
                                   int group, int span, int splits,
                                   int part_rows, float sm_scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    const paged::Args a{static_cast<const __nv_bfloat16*>(q), kc, vc,
                        nullptr, nullptr, static_cast<const int*>(tables),
                        static_cast<const int*>(past),
                        static_cast<const int*>(this_lens),
                        static_cast<__nv_bfloat16*>(out),
                        static_cast<float*>(part), B, KV, rows, hd, bs,
                        max_blocks, group, span, splits, part_rows,
                        sm_scale * paged::kLog2e};
    return paged::launch<__nv_bfloat16>(a, s);
  }
  if (dtype == DTYPE_F32)
    return launch<float, float, false>(q, kc, vc, nullptr, nullptr, tables,
                                       past, this_lens, out, B, KV, rows, hd,
                                       bs, max_blocks, group, sm_scale, s);
  return cudaErrorInvalidValue;
}

// dynamic shared memory of a bf16-q block for head_dim hd (dec: the
// decode kernel, at most 8 rows a sequence)
extern "C" int paged_attention_smem(int hd, int dec) {
  return paged::smem_bytes<__nv_bfloat16>(hd, dec);
}
