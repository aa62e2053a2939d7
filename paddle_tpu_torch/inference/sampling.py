"""The noise of the categorical draw over masked logits, shared by the
predictor and the paged engine.

Counterpart of `jax.random.categorical`, which both reference call
sites use (`paddle_tpu/inference/llm.py:149`, `serving/engine.py:113`):
a Gumbel argmax, `argmax(l + G, -1)` with `G = -log(-log u)`. It reads
no device value, so a captured decode step can hold it, and over a row
that masking left all `-inf` (top_p <= 0) it gives token 0, as the
reference does. The numbers come from a torch.Generator (Philox), so
the tokens drawn differ from the reference's threefry draws; the
masked logits they are drawn from are what the tests compare.
"""
from __future__ import annotations

import torch

__all__ = ["gumbel"]


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, f32, drawn from `generator` on `device`.

    `torch.rand` gives u in [0, 1). u = 0 gives -log(0) = inf and
    G = -log(inf) = -inf, so that entry loses the draw (a finite logit
    plus -inf is -inf, and an all -inf row stays all -inf, whose argmax
    is 0). u never reaches 1, so G is never +inf and no -inf + inf (NaN)
    can arise from a masked entry."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u))
