"""Group-sharded training (ZeRO stages 1-3): the port of
`paddle_tpu/distributed/sharding/group_sharded.py` (Paddle's
group_sharded_optimizer_stage2.py, group_sharded_stage2.py:46,
group_sharded_stage3.py:85).

One process a rank, each on its own batch, as in Paddle. The reference,
one controller over a mesh, lays the states, gradients and parameters out
over the group's axis and lets XLA move them; here each rank keeps only
what it owns and the collectives are explicit:
- **stage 1** (`'os'`): the parameters are assigned to the ranks (largest
  first, each to the rank holding the fewest elements); gradients are
  averaged over the group, each rank steps only its parameters, so it
  holds their optimizer state only, and broadcasts them;
- **stage 2** (`'os_g'`): the same, but each gradient is reduced to its
  owner only and dropped on the other ranks;
- **stage 3** (`'p_g_os'`): every parameter whose dim 0 divides by the
  group's size is stored as this rank's block of rows. The blocks are
  all-gathered before the forward (so the forward and the backward see
  the whole parameter), the whole gradient is reduce-scattered (an
  average) back onto the blocks, and the optimizer steps the blocks, so
  parameters, gradients and states are all 1/N. Other parameters stay
  whole, their gradients averaged.
`offload=True` keeps the optimizer states on the host between steps, in
pinned memory when the parameters are on the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...core.tensor import Parameter
from ...nn.layer.layers import Layer
from .. import collective as coll
from ..parallel import LayerWrapper


def _default(group: Optional[coll.Group]) -> coll.Group:
    return group or coll._default_group()


def _device(g: coll.Group) -> torch.device:
    if g.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _partition(params, nranks: int) -> Dict[int, List[Parameter]]:
    """Greedy smallest-rank assignment, the largest parameter first (the
    reference's `_partition_parameters`)."""
    mapping: Dict[int, List[Parameter]] = {i: [] for i in range(nranks)}
    sizes = np.zeros(nranks)
    for p in sorted(params, key=lambda p: -int(
            np.prod(p.shape) if p.shape else 1)):
        i = int(np.argmin(sizes))
        mapping[i].append(p)
        sizes[i] += int(np.prod(p.shape) if p.shape else 1)
    return mapping


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = t.to("cpu")
    return host.pin_memory() if t.is_cuda else host


class GroupShardedOptimizerStage2:
    """Optimizer wrapper sharding the optimizer states (stage 1), and the
    gradients (stage 2), over the group; under a `GroupShardedStage3`
    model it steps the parameter blocks (reference:
    group_sharded_optimizer_stage2.py)."""

    def __init__(self, params: List[Parameter], optim,
                 group: Optional[coll.Group] = None, offload: bool = False,
                 device: Optional[str] = None, shard_grads: bool = True,
                 **kw):
        self._optim = optim
        self._group = _default(group)
        self._offload = offload
        self._do_shard_grads = shard_grads
        self._params = list(params)
        self._stage3: Optional["GroupShardedStage3"] = None
        n = self._group.nranks
        self._rank2params = _partition(self._params, n)
        self._owner = {id(p): r for r, ps in self._rank2params.items()
                       for p in ps}

    def __getattr__(self, name):
        return getattr(self.__dict__["_optim"], name)

    def _local(self) -> List[Parameter]:
        return self._rank2params[max(self._group.rank, 0)]

    def _reduce_grads(self):
        """Average each gradient over the group: onto its owner (stage 2;
        the other ranks drop theirs) or onto every rank (stage 1)."""
        g = self._group
        for p in self._params:
            grad = p._data.grad
            if grad is None:
                continue
            if self._do_shard_grads:
                owner = g.ranks[self._owner[id(p)]]
                coll.reduce(grad, dst=owner, op=coll.ReduceOp.AVG, group=g)
                if owner != g.ranks[max(g.rank, 0)]:
                    p.clear_grad()
            else:
                coll.all_reduce(grad, op=coll.ReduceOp.AVG, group=g)

    def _restore_states(self):
        dev = next((p._data.device for p in self._params), None)
        for d in self._optim._accumulators.values():
            for k, a in d.items():
                if isinstance(a, torch.Tensor) and a.device != dev:
                    d[k] = a.to(dev, non_blocking=True)

    def _offload_states(self):
        for d in self._optim._accumulators.values():
            for k, a in d.items():
                if isinstance(a, torch.Tensor) and a.device.type != "cpu":
                    d[k] = _to_host(a)

    @torch.no_grad()
    def step(self):
        if self._offload:
            self._restore_states()
        g = self._group
        if self._stage3 is not None:
            self._stage3._reduce_scatter_grads()
            self._optim.step()
        elif g.nranks <= 1:
            self._optim.step()
        else:
            self._reduce_grads()
            saved = self._optim._parameter_list
            self._optim._parameter_list = self._local()
            try:
                self._optim.step()
            finally:
                self._optim._parameter_list = saved
            for r, ps in self._rank2params.items():
                for p in ps:
                    coll.broadcast(p, src=g.ranks[r], group=g)
        if self._offload:
            self._offload_states()

    def clear_grad(self, *a, **k):
        for p in self._params:
            p.clear_grad()

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()

    def state_dict(self):
        return self._optim.state_dict()

    def set_state_dict(self, state):
        return self._optim.set_state_dict(state)


class _Wrapper(LayerWrapper):
    """The Layer protocol passed through to the wrapped layer, with its
    sublayers, `to` and the buffers' broadcast."""

    def sublayers(self, include_self=False):
        return self._layers.sublayers(include_self)

    def to(self, *a, **k):
        self._layers.to(*a, **k)
        return self

    def _sync_buffers(self):
        g = self._group
        if g.nranks > 1:
            for b in self._layers.buffers():
                coll.broadcast(b, src=g.ranks[0], group=g)


class GroupShardedStage2(_Wrapper):
    """ZeRO-2 model wrapper (reference: group_sharded_stage2.py:46); the
    reduction onto the owners runs in the optimizer's step."""

    def __init__(self, layer: Layer, sharding_optimizer,
                 group: Optional[coll.Group] = None,
                 sync_buffers: bool = False, buffer_max_size: int = 2 ** 23,
                 auto_refresh_trainable: bool = True,
                 device: Optional[str] = None, dp_group=None, **kw):
        super().__init__()
        self._layers = layer
        self._group = _default(group)
        self._sharding_optimizers = (
            sharding_optimizer if isinstance(sharding_optimizer, (list, tuple))
            else [sharding_optimizer])
        if sync_buffers:
            self._sync_buffers()

    def grad_scale(self):
        """The reference scales gradients by 1/world here; the step's
        average already does."""
        return


class GroupShardedStage3(_Wrapper):
    """ZeRO-3 model wrapper (reference: group_sharded_stage3.py:85): the
    parameters' storage is sharded over the group, gathered for the
    forward and backward."""

    def __init__(self, layer: Layer, optimizer=None,
                 group: Optional[coll.Group] = None,
                 sync_buffers: bool = False, device: Optional[str] = None,
                 segment_size: int = 2 ** 20,
                 pretrain_sync_models: bool = True, offload: bool = False,
                 sync_comm: bool = False, dp_group=None, exclude_layer=None,
                 param2buffer_size=None, **kw):
        super().__init__()
        self._layers = layer
        self._group = _default(group)
        self._offload = offload
        self._optim = optimizer
        self._shards: Dict[int, torch.Tensor] = {}
        self._gathered = False
        g = self._group
        if pretrain_sync_models and g.nranks > 1:
            for p in layer.parameters():
                coll.broadcast(p, src=g.ranks[0], group=g)
        self._shard_parameters()
        if sync_buffers:
            self._sync_buffers()

    def _shardable(self, p) -> bool:
        n = self._group.nranks
        return n > 1 and p._data.dim() > 0 and p._data.shape[0] % n == 0

    @torch.no_grad()
    def _shard_parameters(self):
        """Keep this rank's block of rows of each shardable parameter
        (its whole value is what `_data` holds now)."""
        g = self._group
        r = max(g.rank, 0)
        self._shards.clear()
        for p in self._layers.parameters():
            if not self._shardable(p):
                continue
            k = p._data.shape[0] // g.nranks
            shard = p._data.detach()[r * k:(r + 1) * k].clone()
            shard.requires_grad_(not p.stop_gradient)
            p._data = shard
            self._shards[id(p)] = shard
        self._gathered = False

    @torch.no_grad()
    def _gather(self):
        """Every sharded parameter whole again (an all_gather of its
        blocks), as a fresh leaf for the forward and backward."""
        if self._gathered or not self._shards:
            return
        g = self._group
        for p in self._layers.parameters():
            shard = self._shards.get(id(p))
            if shard is None:
                continue
            full = shard.new_empty((g.nranks * shard.shape[0],)
                                   + tuple(shard.shape[1:]))
            coll.all_gather_into_tensor(full, shard.detach(), group=g)
            p._data = full.requires_grad_(shard.requires_grad)
        self._gathered = True

    @torch.no_grad()
    def _reduce_scatter_grads(self):
        """Each whole gradient averaged and scattered onto the blocks; the
        parameters back to their blocks. Unsharded parameters' gradients
        averaged in place."""
        g = self._group
        for p in self._layers.parameters():
            grad = p._data.grad
            shard = self._shards.get(id(p))
            if shard is None:
                if grad is not None and g.nranks > 1:
                    coll.all_reduce(grad, op=coll.ReduceOp.AVG, group=g)
                continue
            if grad is not None:
                out = shard.new_empty(shard.shape)
                coll.reduce_scatter(out, grad.contiguous(),
                                    op=coll.ReduceOp.AVG, group=g)
                shard.grad = out
            p._data = shard
        self._gathered = False

    def forward(self, *inputs, **kwargs):
        self._gather()
        return self._layers(*inputs, **kwargs)

    def get_all_parameters(self, convert2cpu: bool = False):
        """The whole parameters (the reference's pre-save gather)."""
        self._gather()
        return self._layers.parameters()

    def state_dict(self, *a, **k):
        self._gather()
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        self._gather()
        out = self._layers.set_state_dict(sd, *a, **k)
        self._shard_parameters()
        return out


class GroupShardedScaler:
    """AMP loss-scaler wrapper for group-sharded training (reference:
    group_sharded_utils.py GroupShardedScaler): a rank's gradients are its
    own batch's, so found_inf is taken over the whole group (a max) before
    the step is skipped or taken."""

    def __init__(self, scaler):
        self._scaler = scaler

    def __getattr__(self, name):
        return getattr(self.__dict__["_scaler"], name)

    def scale(self, loss):
        return self._scaler.scale(loss)

    @torch.no_grad()
    def step(self, optimizer):
        s = self._scaler
        if not s._active():
            optimizer.step()
            return
        s._unscale(optimizer)
        g = getattr(optimizer, "_group", None)
        if g is not None and g.nranks > 1:
            f = torch.tensor(float(s._found_inf), device=_device(g))
            coll.all_reduce(f, op=coll.ReduceOp.MAX, group=g)
            s._found_inf = bool(f.item())
        if not s._found_inf:
            optimizer.step()

    def unscale_(self, optimizer):
        return self._scaler.unscale_(optimizer)

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        if hasattr(self._scaler, "update"):
            self._scaler.update()
