"""Random sampling kernels: port of `paddle_tpu/ops/kernels/random.py`.

Draws come from `core/rng.py`'s generators (one a device, seeded by
`paddle_tpu_torch.seed`), or from a fixed generator when the op's own
`seed` is nonzero. The values differ from the reference's (jax threefry
against torch Philox); the distributions are the same.
"""
from __future__ import annotations

import torch

from ...core import rng
from ..dispatch import register_op
from ._util import device, td


def _shape(shape):
    if isinstance(shape, int):
        return [shape]
    return [int(s) for s in shape]


@register_op(nondiff=True)
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):
    dev = device()
    u = torch.rand(_shape(shape), generator=rng.seed_or_next(seed, dev),
                   dtype=td(dtype), device=dev)
    return min + (max - min) * u


@register_op(nondiff=True)
def gaussian(shape, mean=0.0, std=1.0, dtype=None, seed=0):
    dev = device()
    n = torch.randn(_shape(shape), generator=rng.seed_or_next(seed, dev),
                    dtype=td(dtype), device=dev)
    return mean + std * n


@register_op(nondiff=True)
def randint(low=0, high=None, shape=(1,), dtype=None, seed=0):
    if high is None:
        low, high = 0, low
    dev = device()
    return torch.randint(low, high, _shape(shape),
                         generator=rng.seed_or_next(seed, dev),
                         dtype=td(dtype, "int64"), device=dev)


@register_op(nondiff=True)
def randperm(n, dtype=None, seed=0):
    dev = device()
    return torch.randperm(n, generator=rng.seed_or_next(seed, dev),
                          device=dev).to(td(dtype, "int64"))


@register_op(nondiff=True)
def bernoulli(x, p=None, seed=0):
    probs = x if p is None else torch.as_tensor(p, dtype=x.dtype,
                                                device=x.device)
    u = torch.rand(x.shape, generator=rng.seed_or_next(seed, x.device),
                   device=x.device)
    return (u < probs).to(x.dtype)


@register_op(nondiff=True)
def multinomial(x, num_samples=1, replacement=False, seed=0):
    return torch.multinomial(x, num_samples, replacement,
                             generator=rng.seed_or_next(seed, x.device))


@register_op(nondiff=True)
def poisson(x, seed=0):
    return torch.poisson(x, generator=rng.seed_or_next(seed, x.device))


@register_op(nondiff=True)
def exponential_(x, lam=1.0, seed=0):
    out = torch.empty_like(x)
    return out.exponential_(lam, generator=rng.seed_or_next(seed, x.device))


@register_op(nondiff=True)
def normal_like(x, mean=0.0, std=1.0, seed=0):
    n = torch.randn(x.shape, generator=rng.seed_or_next(seed, x.device),
                    dtype=x.dtype, device=x.device)
    return mean + std * n


@register_op(nondiff=True)
def uniform_random_like(x, min=-1.0, max=1.0, seed=0):
    u = torch.rand(x.shape, generator=rng.seed_or_next(seed, x.device),
                   dtype=x.dtype, device=x.device)
    return min + (max - min) * u
