// Kernel A5, int8 pages: `paged_attention.cuh` over int8 caches with
// per-page dequant scales, q and output bf16 (tensor cores, `paged::`) or
// f32 (CUDA cores).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `paged_attention`
// (`_kernel`, pallas_call at :249) with `has_quant`: the serving path's
// attention when the engine keeps its KV pages in int8 (`quant_kv`).
//
// Bound on the H100: bytes. A decode launch reads each live token's int8
// K and V once, 8 KiB per token per layer at LLaMA-7B, half the bf16
// pages' 16 KiB, plus one f32 k and v scalar per (page, kv head). The
// scales fold into the scores (sm_scale * kdq[page]) and into the
// probabilities after the running sum (vdq[page]), as the reference
// folds them, so the pages stay int8 in shared memory and are widened
// only into the products' fragments. The design notes are in the header.
#include "paged_attention.cuh"

// kdq, vdq [num_blocks, KV] f32: each page's dequant multipliers; part,
// span, splits, part_rows as in `paged_attention_fwd`.
extern "C" int paged_attention_int8_fwd(
    const void* q, const void* kc, const void* vc, const void* kdq,
    const void* vdq, const void* tables, const void* past,
    const void* this_lens, void* out, void* part, int B, int KV, int rows,
    int hd, int bs, int max_blocks, int group, int span, int splits,
    int part_rows, float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    const paged::Args a{static_cast<const __nv_bfloat16*>(q), kc, vc,
                        static_cast<const float*>(kdq),
                        static_cast<const float*>(vdq),
                        static_cast<const int*>(tables),
                        static_cast<const int*>(past),
                        static_cast<const int*>(this_lens),
                        static_cast<__nv_bfloat16*>(out),
                        static_cast<float*>(part), B, KV, rows, hd, bs,
                        max_blocks, group, span, splits, part_rows,
                        sm_scale * paged::kLog2e};
    return paged::launch<int8_t>(a, s);
  }
  if (dtype == DTYPE_F32)
    return launch<float, int8_t, true>(q, kc, vc, kdq, vdq, tables, past,
                                       this_lens, out, B, KV, rows, hd, bs,
                                       max_blocks, group, sm_scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int paged_attention_int8_smem(int hd, int dec) {
  return paged::smem_bytes<int8_t>(hd, dec);
}
