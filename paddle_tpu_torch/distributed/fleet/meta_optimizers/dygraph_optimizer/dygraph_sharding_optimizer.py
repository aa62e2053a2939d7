"""Sharding (ZeRO stage-1) optimizer: the port of
`paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer/
dygraph_sharding_optimizer.py` (Paddle's :54).

The parameters are assigned to the sharding group's ranks greedily by
size, the largest first, each to the rank holding the fewest elements
(the reference's `_partition_parameters`, exactly). Each step averages
the gradients over the group, steps this rank's parameters only (so it
holds their optimizer state only), and broadcasts every parameter from
its owner.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .... import collective as coll
from ....parallel import sync_param_grads


class DygraphShardingOptimizer:
    """Reference: dygraph_sharding_optimizer.py:54."""

    def __init__(self, optimizer, hcg=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        group = (hcg.get_sharding_parallel_group() if hcg is not None
                 else None)
        self._group = group
        self._nranks = group.nranks if group else 1
        self._rank = max(group.rank, 0) if group else 0
        params = list(getattr(optimizer, "_parameter_list", None) or [])
        self._origin_parameter_list = params
        self._rank2params = self._partition_parameters(params)
        optimizer._parameter_list = self._rank2params[self._rank]

    def _partition_parameters(self, params) -> Dict[int, list]:
        """Greedy smallest-bucket assignment (the reference's size
        balancing)."""
        mapping: Dict[int, List] = {i: [] for i in range(self._nranks)}
        sizes = np.zeros(self._nranks)
        for p in sorted(params, key=lambda p: -int(
                np.prod(p.shape) if p.shape else 1)):
            i = int(np.argmin(sizes))
            mapping[i].append(p)
            sizes[i] += int(np.prod(p.shape) if p.shape else 1)
        return mapping

    def step(self):
        sync_param_grads(self._origin_parameter_list, self._group)
        self._inner_opt.step()
        self._broadcast_params()

    def _broadcast_params(self):
        """Each rank's updated parameters to the group (reference:
        `_sharding_sync_parameters`)."""
        g = self._group
        if g is None or g.nranks <= 1:
            return
        for rank, params in self._rank2params.items():
            for p in params:
                coll.broadcast(p, src=g.ranks[rank], group=g)

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self, *a, **k):
        # every original parameter's gradient, not just this rank's
        for p in self._origin_parameter_list:
            p.clear_grad()

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, s):
        return self._inner_opt.set_state_dict(s)

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)
