"""Gradient clipping (reference: python/paddle/nn/clip.py —
ClipGradByGlobalNorm et al., consumed by Optimizer): port of
`paddle_tpu/nn/clip.py`. A (param, grad) pair carries the grad as a
torch tensor; norms are summed in f32, as the reference's."""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, None if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g.float())))
            factor = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                 max=1.0)
            out.append((p, (g.float() * factor).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _global_norm(self, grads):
        sq = [torch.sum(torch.square(g.float())) for g in grads
              if g is not None]
        if not sq:
            return None
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        return torch.sqrt(total)

    def __call__(self, params_grads):
        gn = self._global_norm([g for p, g in params_grads if p_needs_clip(p)])
        if gn is None:
            return params_grads
        factor = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        out = []
        for p, g in params_grads:
            if g is None or not p_needs_clip(p):
                out.append((p, g))
            else:
                out.append((p, (g.float() * factor).to(g.dtype)))
        return out


def p_needs_clip(p):
    return getattr(p, "need_clip", True)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """torch-style utility also exposed by paddle.nn.utils."""
    grads = [p._data.grad for p in parameters if p._data.grad is not None]
    if not grads:
        return None
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(g)) for g in grads]))
    else:
        total = torch.pow(sum(torch.sum(torch.pow(torch.abs(g.float()),
                                                  norm_type))
                              for g in grads), 1.0 / norm_type)
    factor = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.copy_((g.float() * factor).to(g.dtype))
    return total
