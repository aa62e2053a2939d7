"""Low-level model-parallel ops: the port of
`paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py` (Paddle's mp_ops.py).

One process a rank, each holding its shard of a tensor-parallel layer:
the ops are the differentiable collectives of `distributed/mesh.py` over
the model-parallel group, with Megatron's transposes:
- `_c_identity`: forward identity, backward all-reduce (a column-parallel
  product's input);
- `_mp_allreduce`: forward all-reduce, backward identity (a row-parallel
  product's output);
- `_c_split`: this rank's block of the last dim, backward all-gather;
- `_c_concat`: the blocks of the last dim gathered, backward this rank's
  block;
- `_c_lookup_table`: a vocab shard's masked embedding lookup;
- `_c_softmax_with_cross_entropy`: the vocab-parallel softmax cross
  entropy (`distributed/hybrid.py`'s).
With no group, or a group of one rank, each is its single-device math and
issues no collective. Tensors are the port's Tensors or torch's; the
result is of the input's kind.
"""
from __future__ import annotations

from typing import Optional

import torch

from ....collective import Group, ReduceOp
from .... import mesh as M


def _unwrap(x) -> torch.Tensor:
    return getattr(x, "_data", x)


def _rewrap(data: torch.Tensor, like):
    if isinstance(like, torch.Tensor):
        return data
    from .....core.tensor import Tensor
    return Tensor._wrap(data)


def _mp_group(group: Optional[Group]) -> Optional[Group]:
    """`group`, else the fleet's model-parallel group; None when there is
    nothing to communicate with."""
    if group is None:
        from ...base.topology import get_hcg

        hcg = get_hcg()
        group = hcg.get_model_parallel_group() if hcg is not None else None
    if group is None or group.nranks <= 1:
        return None
    return group


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    g = _mp_group(group)
    if g is None:
        return tensor
    return _rewrap(M.c_identity(_unwrap(tensor), g), tensor)


def _mp_allreduce(tensor, op=ReduceOp.SUM, group=None,
                  use_calc_stream=True, use_model_parallel=True):
    if op != ReduceOp.SUM:
        raise ValueError(f"_mp_allreduce sums; got op {op!r}")
    g = _mp_group(group)
    if g is None:
        return tensor
    return _rewrap(M.mp_allreduce(_unwrap(tensor), g), tensor)


def _c_split(tensor, group=None):
    g = _mp_group(group)
    if g is None:
        return tensor
    return _rewrap(M.split(_unwrap(tensor), g, -1), tensor)


def _c_concat(tensor, group=None):
    g = _mp_group(group)
    if g is None:
        return tensor
    return _rewrap(M.gather_replicated(_unwrap(tensor), g, -1), tensor)


def _c_lookup_table(table, index, start_index=0, vocab_size=-1):
    """Rows `index - start_index` of this vocab shard, zero where an id
    falls outside it."""
    t = _unwrap(table)
    local = _unwrap(index).long() - start_index
    vloc = t.shape[0]
    ok = (local >= 0) & (local < vloc)
    emb = t[local.clamp(0, vloc - 1)]
    return _rewrap(torch.where(ok[..., None], emb, torch.zeros_like(emb)),
                   table)


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  return_softmax=False,
                                  ignore_index: int = -100):
    """Softmax cross entropy per row, [..., 1], from this rank's vocab
    block of the logits (the distributed max and sum run over the
    group); 0 where the label is `ignore_index`."""
    x = _unwrap(logits)
    y = _unwrap(label).long()
    if y.dim() == x.dim():
        y = y[..., 0]
    g = _mp_group(group)
    if g is not None:
        from ....hybrid import vp_cross_entropy

        loss = vp_cross_entropy(x, y, g, psum=M.mp_allreduce)
    else:
        shifted = x - x.detach().amax(dim=-1, keepdim=True)
        lse = shifted.exp().sum(dim=-1).log()
        true = shifted.gather(-1, y.clamp(min=0)[..., None])[..., 0]
        loss = lse - true
    loss = torch.where(y == ignore_index, torch.zeros_like(loss), loss)
    out = _rewrap(loss[..., None], logits)
    if return_softmax:
        if g is not None:
            gmax = M.all_gather(x.detach().amax(dim=-1)[None], g,
                                dim=0).amax(dim=0)[..., None]
            e = (x - gmax).exp()
            sm = e / M.psum(e.sum(dim=-1, keepdim=True), g)
        else:
            sm = torch.softmax(x, dim=-1)
        return out, _rewrap(sm, logits)
    return out
