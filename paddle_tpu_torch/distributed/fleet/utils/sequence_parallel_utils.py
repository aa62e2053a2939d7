"""Megatron sequence-parallel utilities: the port of
`paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py` (Paddle's
sequence_parallel_utils.py: `ScatterOp` :85, `GatherOp` :97,
`AllGatherOp` :111, `ReduceScatterOp` :127).

The sequence dim is dim 0 (Paddle's [s, b, h] convention). Each op is one
of `distributed/mesh.py`'s differentiable collectives over the
model-parallel group, with the reference's backward:
- `ScatterOp`: this rank's block of the sequence; backward all-gather;
- `GatherOp`: the blocks gathered; backward this rank's block;
- `AllGatherOp`: the blocks gathered; backward reduce-scatter (for a
  column-parallel product's input);
- `ReduceScatterOp`: summed over the group and scattered; backward
  all-gather (a row-parallel product's output).
With no model-parallel group, or a group of one rank, each is the
identity.
"""
from __future__ import annotations

from ... import mesh as M


def _group(group=None):
    if group is None:
        from ..base.topology import get_hcg

        hcg = get_hcg()
        group = hcg.get_model_parallel_group() if hcg is not None else None
    if group is None or group.nranks <= 1:
        return None
    return group


def _apply(fn, input, group):
    g = _group(group)
    if g is None:
        return input
    data = getattr(input, "_data", input)
    out = fn(data, g, 0)
    if input is data:
        return out
    from ....core.tensor import Tensor
    return Tensor._wrap(out)


def ScatterOp(input, group=None):  # noqa: N802 (reference API name)
    """seq full -> seq / mp."""
    return _apply(M.split, input, group)


def GatherOp(input, group=None):  # noqa: N802
    """seq / mp -> seq full."""
    return _apply(M.gather_replicated, input, group)


def AllGatherOp(input, group=None):  # noqa: N802
    """seq / mp -> seq full; backward reduce-scatter."""
    return _apply(M.all_gather, input, group)


def ReduceScatterOp(input, group=None):  # noqa: N802
    """partial sums of seq full -> summed seq / mp; backward
    all-gather."""
    return _apply(M.reduce_scatter, input, group)


def mark_as_sequence_parallel_parameter(parameter):
    """Tag a parameter (a LayerNorm's inside a sequence-parallel region)
    whose gradient needs a sum over the model-parallel group."""
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter) -> bool:
    return getattr(parameter, "sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False):
    """Reference :192: the marked parameters' gradients are summed over the
    model-parallel group (each rank saw its own block of the sequence),
    once every `accumulation_steps` backward passes, when the last one's
    gradient is final. Returns the marked parameters."""
    marked = [p for p in model.parameters()
              if is_sequence_parallel_parameter(p)]
    g = _group(None)
    if g is None:
        return marked
    from ... import collective as coll

    for p in marked:
        seen = [0]

        def hook(t, seen=seen):
            seen[0] += 1
            if seen[0] % max(1, accumulation_steps) == 0:
                coll.all_reduce(t._data.grad, group=g)

        p.register_grad_final_hook(hook)
    return marked
