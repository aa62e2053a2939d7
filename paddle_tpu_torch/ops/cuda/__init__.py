"""Hand-written CUDA C++ kernels for Hopper (`csrc/`), each with its
plain PyTorch version, its wrapper and its launch count.

| Kernel | Module | Replaces |
| --- | --- | --- |
| A5 paged attention | `paged_attention` | `paddle_tpu/ops/pallas/paged_attention.py` |
| A3 fused SwiGLU FFN forward | `fused_ffn` | `paddle_tpu/ops/pallas/fused_ffn.py` `_fwd` |
| A7 sampler prep | `fused_sample` | `paddle_tpu/ops/pallas/fused_sample.py` |
| A1 flash attention forward | `flash_attention` | `paddle_tpu/ops/pallas/flash_attention.py` `_fwd` |
| A2 flash attention backward | `flash_attention` | `paddle_tpu/ops/pallas/flash_attention.py` `_bwd` |
| A4 fused SwiGLU FFN backward | `fused_ffn` | `paddle_tpu/ops/pallas/fused_ffn.py` `_bwd` |
"""
from . import flash_attention, fused_ffn, fused_sample, paged_attention

KERNELS = (paged_attention.KERNEL, fused_ffn.KERNEL, fused_sample.KERNEL,
           flash_attention.KERNEL_FWD, flash_attention.KERNEL_BWD,
           fused_ffn.KERNEL_BWD)

__all__ = ["paged_attention", "fused_ffn", "fused_sample", "flash_attention",
           "KERNELS"]
