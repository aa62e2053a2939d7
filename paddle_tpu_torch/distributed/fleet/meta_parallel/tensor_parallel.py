"""TensorParallel / SegmentParallel wrappers: the port of
`paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py` (Paddle's
tensor_parallel.py:28, segment_parallel.py:26).

One process a rank: the ranks of a model-parallel group must start from
the same replicated parameters, so `TensorParallel` broadcasts every
parameter that is not a shard (`is_distributed`) from the group's first
rank, once (`parallel.sync_params_buffers`'s broadcast); `SegmentParallel`
does the same over the sep group for every parameter.
"""
from __future__ import annotations

from ... import collective as coll
from ...parallel import sync_params_buffers
from .meta_parallel_base import MetaParallelBase


class TensorParallel(MetaParallelBase):
    """Reference: tensor_parallel.py:28."""

    def _prepare_for_model(self):
        hcg = self._hcg
        if hcg is None:
            return
        g = hcg.get_model_parallel_group()
        if g is not None and g.nranks > 1:
            for p in self._layers.parameters():
                if not getattr(p, "is_distributed", False):
                    coll.broadcast(p, src=g.ranks[0], group=g)


class SegmentParallel(MetaParallelBase):
    """Reference: segment_parallel.py:26: sep ranks hold the same
    parameters; the attention's all-to-all over sep is the model's."""

    def _prepare_for_model(self):
        hcg = self._hcg
        if hcg is None:
            return
        g = hcg.get_sep_parallel_group()
        if g is not None and g.nranks > 1:
            sync_params_buffers(self._layers, g, src_rank=g.ranks[0])
