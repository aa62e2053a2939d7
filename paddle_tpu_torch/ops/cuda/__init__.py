"""Hand-written CUDA C++ kernels for Hopper (`csrc/`), each with its
plain PyTorch version, its wrapper and its launch count.

| Kernel | Module | Replaces |
| --- | --- | --- |
| A5 paged attention | `paged_attention` | `paddle_tpu/ops/pallas/paged_attention.py` |
| A3 fused SwiGLU FFN forward | `fused_ffn` | `paddle_tpu/ops/pallas/fused_ffn.py` `_fwd` |
| A7 sampler prep | `fused_sample` | `paddle_tpu/ops/pallas/fused_sample.py` |
| A1 flash attention forward (and its segment-id mode) | `flash_attention` | `paddle_tpu/ops/pallas/flash_attention.py` `_fwd` |
| A2 flash attention backward (and its segment-id mode) | `flash_attention` | `paddle_tpu/ops/pallas/flash_attention.py` `_bwd` |
| A4 fused SwiGLU FFN backward | `fused_ffn` | `paddle_tpu/ops/pallas/fused_ffn.py` `_bwd` |
| A5 paged attention, int8 pages | `paged_attention` | `paddle_tpu/ops/pallas/paged_attention.py` (`has_quant`) |
| A6 int8-weight fused SwiGLU FFN | `fused_ffn` | `paddle_tpu/ops/pallas/fused_ffn.py` `fused_ffn_w8` |
| A8 GEMM with bias + activation epilogue | `fused_ffn` | `paddle_tpu/ops/pallas/fused_ffn.py` `fused_gemm_epilogue` |
| A9 gated activation (GLU) | `fused_ffn` | `paddle_tpu/ops/pallas/fused_ffn.py` `fused_glu` |
"""
from . import flash_attention, fused_ffn, fused_sample, paged_attention

KERNELS = (paged_attention.KERNEL, fused_ffn.KERNEL, fused_sample.KERNEL,
           flash_attention.KERNEL_FWD, flash_attention.KERNEL_BWD,
           fused_ffn.KERNEL_BWD, paged_attention.KERNEL_INT8,
           fused_ffn.KERNEL_W8, fused_ffn.KERNEL_EPILOGUE,
           fused_ffn.KERNEL_GLU)

__all__ = ["paged_attention", "fused_ffn", "fused_sample", "flash_attention",
           "KERNELS"]
