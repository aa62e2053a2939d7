"""HybridParallelOptimizer: the port of
`paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer/
hybrid_parallel_optimizer.py` (Paddle's :266).

Wraps the inner optimizer with (a) the gradient sync over the data
parallel group (and over the sharding group, unless the inner optimizer
is a `DygraphShardingOptimizer`, which syncs its own), bucketed as
`parallel.sync_param_grads`, and (b) a global-norm clip over the hybrid
topology: one process a rank holds shards, so a `ClipGradByGlobalNorm`
norm sums the squares of the model-parallel shards (`is_distributed`)
over the mp group, counts a replicated parameter once, and sums the
pipeline stages over the pp group; the inner optimizer then steps with
its own clip held off. With every such group of one rank the inner
optimizer's clip runs as it is.

In pure data parallelism (mp, pp and sep of one rank, Paddle's
`_use_dp_mode`) `fleet.distributed_model` wraps the model in
`DataParallel`, whose reducer already averages every gradient over the
dp group, overlapped with backward; the dp sync of (a) is then skipped,
as Paddle skips it, so each gradient crosses the wire once.
"""
from __future__ import annotations

import torch

from .....nn.clip import ClipGradByGlobalNorm, p_needs_clip
from .... import collective as coll
from ....parallel import sync_param_grads
from .dygraph_sharding_optimizer import DygraphShardingOptimizer


def _size(g) -> int:
    return g.nranks if g is not None else 1


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._dp_group = (hcg.get_data_parallel_group()
                          if hcg is not None else None)
        self._sharding_group = (hcg.get_sharding_parallel_group()
                                if hcg is not None else None)
        self._mp_group = (hcg.get_model_parallel_group()
                          if hcg is not None else None)
        self._pp_group = (hcg.get_pipe_parallel_group()
                          if hcg is not None else None)
        # the degrees at which fleet.distributed_model returns DataParallel
        self._use_dp_mode = hcg is not None and all(
            n == 1 for n in (hcg.get_model_parallel_world_size(),
                             hcg.get_pipe_parallel_world_size(),
                             hcg.get_sep_parallel_world_size()))

    @property
    def _parameter_list(self):
        inner = self._inner_opt
        if isinstance(inner, DygraphShardingOptimizer):
            return inner._origin_parameter_list
        return getattr(inner, "_parameter_list", None) or []

    def _sync_grads(self):
        params = list(self._parameter_list or [])
        if not self._use_dp_mode:
            sync_param_grads(params, self._dp_group)
        if not isinstance(self._inner_opt, DygraphShardingOptimizer):
            sync_param_grads(params, self._sharding_group)

    def _base_opt(self):
        return getattr(self._inner_opt, "_inner_opt", self._inner_opt)

    @torch.no_grad()
    def _hybrid_clip(self) -> bool:
        """Scale the gradients by the hybrid global norm's clip factor;
        False when the inner optimizer's own clip is already global."""
        clip = getattr(self._base_opt(), "_grad_clip", None)
        if not isinstance(clip, ClipGradByGlobalNorm) or (
                _size(self._mp_group) <= 1 and _size(self._pp_group) <= 1):
            return False
        grads = [(p, p._data.grad) for p in self._parameter_list
                 if p._data.grad is not None and p_needs_clip(p)]
        if not grads:
            return True
        dev = grads[0][1].device
        dist_sq = torch.zeros((), dtype=torch.float32, device=dev)
        repl_sq = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in grads:
            sq = g.float().square().sum()
            if getattr(p, "is_distributed", False):
                dist_sq += sq
            else:
                repl_sq += sq
        if _size(self._mp_group) > 1:
            coll.all_reduce(dist_sq, group=self._mp_group)
        total = dist_sq + repl_sq
        if _size(self._pp_group) > 1:
            coll.all_reduce(total, group=self._pp_group)
        factor = clip.clip_norm / torch.clamp(total.sqrt(),
                                              min=clip.clip_norm)
        for _, g in grads:
            g.copy_((g.float() * factor).to(g.dtype))
        return True

    def step(self):
        self._sync_grads()
        if not self._hybrid_clip():
            return self._inner_opt.step()
        base = self._base_opt()
        saved, base._grad_clip = base._grad_clip, None
        try:
            return self._inner_opt.step()
        finally:
            base._grad_clip = saved

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self, *a, **k):
        return self._inner_opt.clear_grad(*a, **k)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        return self._inner_opt.set_state_dict(state)

    def get_lr(self):
        return self._inner_opt.get_lr()

    def set_lr(self, v):
        return self._inner_opt.set_lr(v)

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)
