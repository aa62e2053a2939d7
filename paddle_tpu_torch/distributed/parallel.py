"""DataParallel, its bucketed and overlapped gradient reducer, and the
ZeRO-1 sharded update — the port of `paddle_tpu/distributed/parallel.py`.

One process a rank (`torch.distributed`: NCCL on the card, gloo on the
CPU). Each rank runs the model on its own batch; the reducer averages
the gradients over the group, so every rank steps the same parameters.

- **Buckets** (`_bucket_params`, `_build_plan`): the reference's
  partition, exactly: parameters in reverse declaration order (the order
  their gradients become final), split by (dtype, lr multiplier) and by
  `comm_buffer_size_MB`, the last bucket tail-split to
  `last_comm_buffer_size_MB`. Each bucket is one flat torch buffer padded
  to a multiple of the group's size. A plan is built once per parameter
  signature and reused.
- **Overlap** (`FLAGS_dp_overlap`, default on): every trainable
  parameter has a grad-final hook (`Tensor.register_grad_final_hook`);
  when a bucket's last gradient is final the bucket is packed and its
  collective issued asynchronously while backward goes on.
  `sync_gradients()`, and a pre-step hook inside `Optimizer.step`, wait
  on the handles (`core/async_engine.wait_for`) and unpack. With the flag
  off every bucket is issued at that sync (barrier mode).
- **ZeRO-1** (`FLAGS_dp_shard_update` with an optimizer bound by
  `sharded_update`): a bucket is reduce-scattered instead, the optimizer
  steps this rank's contiguous shard of the flat buffer as one
  parameter (1/N of the optimizer state), and the updated shards are
  all-gathered back into the parameters.
- **Wire** (`FLAGS_dp_grad_comm_dtype`): '' keeps the parameter dtype;
  bf16 / fp16 cast the bucket; int8 is the block-scaled codec of
  `quant_comm` with an error-feedback residual per bucket, carried as
  an all_gather of every rank's int8 wire, then the mean of the
  dequantized rows.

A group of one rank reduces nothing, as in the reference: the hooks,
the drain and `sync_param_grads` return at once. The reference's
observability emits wait for ROADMAP item 8 and its collective watchdog
for item 7d.
"""
from __future__ import annotations

import contextlib
import warnings
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from ..core import async_engine, flags
from ..core.tensor import Parameter
from ..nn.layer.layers import Layer
from . import collective as coll
from . import quant_comm as _qc

__all__ = ["DataParallel", "ShardedUpdate", "sharded_update",
           "sync_param_grads", "sync_params_buffers", "init_parallel_env"]

flags.define_flag("dp_overlap", True,
                  "Issue each DP bucket's gradient collective from autograd "
                  "grad-final hooks, overlapped with backward; 0 restores "
                  "the post-backward barrier (all buckets issued at "
                  "sync_gradients)")
flags.define_flag("dp_shard_update", False,
                  "ZeRO-1 cross-replica sharded weight update: "
                  "reduce-scatter grads, run the optimizer on the owned "
                  "1/N flat shard, all-gather updated params (requires "
                  "binding the optimizer with "
                  "paddle.distributed.sharded_update)")
flags.define_flag("dp_grad_comm_dtype", "",
                  "Wire dtype for DP gradient collectives: '' keeps the "
                  "param dtype; 'bfloat16'/'bf16' or 'float16'/'fp16' "
                  "compress the reduce, unpacking casts back; 'int8' "
                  "selects the block-scaled codec with error feedback "
                  "(quant_comm.py, FLAGS_dp_comm_block_size)")

_COMM_DTYPES = {"bf16": "bfloat16", "bfloat16": "bfloat16",
                "fp16": "float16", "float16": "float16",
                "int8": "int8"}


def _comm_dtype_name() -> Optional[str]:
    raw = str(flags.flag_value("dp_grad_comm_dtype") or "").strip().lower()
    if not raw:
        return None
    if raw not in _COMM_DTYPES:
        raise ValueError(
            f"FLAGS_dp_grad_comm_dtype={raw!r}: want '', 'bfloat16', "
            "'float16' or 'int8'")
    return _COMM_DTYPES[raw]


def _arr(p) -> torch.Tensor:
    """A Parameter's torch tensor, or a torch tensor itself."""
    return getattr(p, "_data", p)


def _dtype_name(p) -> str:
    """The reference's dtype string ('float32', 'bfloat16', ...)."""
    return str(_arr(p).dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _grad(p) -> Optional[torch.Tensor]:
    return _arr(p).grad


def _lr_mult(p) -> float:
    return float(getattr(p, "optimize_attr", {}).get("learning_rate", 1.0))


def _bucket_params(params, bucket_mb: float = 32.0):
    """Group params into ~bucket_mb flat buckets, one dtype per bucket
    (reference :87). Takes Parameters or torch tensors."""
    by_dtype: Dict[str, list] = {}
    for p in params:
        by_dtype.setdefault(_dtype_name(p), []).append(p)
    buckets = []
    cap = int(bucket_mb * 1024 * 1024)
    for group in by_dtype.values():
        cur, cur_bytes = [], 0
        for p in group:
            nbytes = _arr(p).numel() * _arr(p).element_size()
            if cur and cur_bytes + nbytes > cap:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_bytes += nbytes
        if cur:
            buckets.append(cur)
    return buckets


def _flat(tensors, dtype: torch.dtype, padded: int = 0) -> torch.Tensor:
    """The tensors flattened into one buffer of `dtype`, zero-padded to
    `padded` elements."""
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    if padded > flat.numel():
        flat = torch.cat([flat, flat.new_zeros(padded - flat.numel())])
    return flat


@torch.no_grad()
def allreduce_buckets(tensors, groups, op=coll.ReduceOp.SUM,
                      bucket_mb: float = 32.0):
    """Reduce `tensors` in place over each of `groups` in turn, one
    all_reduce a bucket a group (`_bucket_params`' partition): a bucket
    of one contiguous tensor is reduced as it is, a larger one packed
    flat and copied back. The counterpart of XLA's all-reduce combiner,
    for `sync_param_grads` and the mesh step's `hybrid.sync_grads`."""
    for bucket in _bucket_params(tensors, bucket_mb):
        whole = len(bucket) == 1 and bucket[0].is_contiguous()
        flat = bucket[0] if whole else _flat(bucket, bucket[0].dtype)
        for g in groups:
            coll.all_reduce(flat, op=op, group=g)
        if whole:
            continue
        off = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[off:off + n].view(t.shape))
            off += n


def sync_param_grads(params, group: Optional[coll.Group],
                     bucket_mb: float = 32.0):
    """Average the gradients over `group`, one all_reduce a bucket,
    written back in place (reference :110). The fleet optimizer's sync
    and the reducer's path for partially-used buckets."""
    if group is None or group.nranks <= 1:
        return
    grads = [_grad(p) for p in params if _grad(p) is not None]
    allreduce_buckets(grads, [group], coll.ReduceOp.AVG, bucket_mb)


def sync_params_buffers(model: Layer, comm_group: Optional[coll.Group] = None,
                        src_rank: int = 0):
    """Broadcast the parameters from global rank `src_rank` (reference
    :131)."""
    for p in model.parameters():
        coll.broadcast(p, src=src_rank, group=comm_group)


# ---------------------------------------------------------------------------
# Bucket plan: a persistent layout keyed by the parameter signature
# ---------------------------------------------------------------------------

class _Bucket:
    __slots__ = ("index", "params", "shapes", "sizes", "offsets", "numel",
                 "padded", "dtype", "comm_dtype", "lr_mult", "nbytes",
                 # the block-scaled int8 wire: geometry, codec, the
                 # error-feedback carry
                 "qblock", "qblocks", "qpadded", "qpack", "qdecode",
                 "residual",
                 # per-step reducer state
                 "ready", "issued", "task", "buf", "op",
                 # sharded-update state
                 "flat_grad", "pseudo")

    def __init__(self, index, params, nranks, comm_dtype):
        self.index = index
        self.params = params
        self.shapes = [tuple(_arr(p).shape) for p in params]
        self.sizes = [_arr(p).numel() for p in params]
        self.offsets = []
        off = 0
        for n in self.sizes:
            self.offsets.append(off)
            off += n
        self.numel = off
        n = max(1, nranks)
        self.padded = -(-off // n) * n  # ceil to a multiple of nranks
        self.dtype = _dtype_name(params[0])
        self.comm_dtype = comm_dtype or self.dtype
        self.lr_mult = _lr_mult(params[0])
        if self.comm_dtype == "int8":
            # the nranks-aligned buffer quantized in whole blocks; nbytes
            # is the wire's size (payload + one f32 scale a block)
            self.qblock = _qc.block_size()
            self.qpadded, self.qblocks, qwire = _qc.wire_layout(
                self.padded, self.qblock)
            self.nbytes = qwire
        else:
            self.qblock = self.qblocks = self.qpadded = 0
            self.nbytes = self.padded * torch.empty(
                0, dtype=_torch_dtype(self.comm_dtype)).element_size()
        self.qpack = None
        self.qdecode = None
        self.residual = None
        self.ready = set()
        self.issued = False
        self.task = None
        self.buf = None
        self.op = ""
        self.flat_grad = None
        self.pseudo = None

    @property
    def ref_bytes(self) -> int:
        """The bucket's bytes on a wire of the parameter dtype."""
        return self.padded * torch.empty(
            0, dtype=_torch_dtype(self.dtype)).element_size()

    def unpack(self, flat: torch.Tensor):
        """flat -> one tensor a parameter (its dtype and shape)."""
        dt = _torch_dtype(self.dtype)
        return [flat[o:o + n].view(s).to(dt)
                for o, n, s in zip(self.offsets, self.sizes, self.shapes)]


class _Plan:
    __slots__ = ("signature", "buckets", "by_param")

    def __init__(self, signature, buckets):
        self.signature = signature
        self.buckets = buckets
        self.by_param: Dict[int, _Bucket] = {}
        for b in buckets:
            for p in b.params:
                self.by_param[id(p)] = b


_PLAN_CACHE_CAP = 8  # per reducer: signatures change only on flag flips


def _plan_signature(params, group, comm_mb, last_mb, comm_dtype):
    gid = getattr(group, "id", -1) if group is not None else -1
    nranks = getattr(group, "nranks", 1) if group is not None else 1
    # id(p) is part of the key: a plan holds its params, so a rebuild
    # after a param is replaced must not reuse the old plan
    return (tuple((id(p), getattr(p, "name", ""), tuple(_arr(p).shape),
                   _dtype_name(p), _lr_mult(p)) for p in params),
            gid, nranks, float(comm_mb), float(last_mb), comm_dtype or "",
            _qc.block_size() if comm_dtype == "int8" else 0)


def _build_plan(params, group, comm_mb, last_mb, comm_dtype,
                cache: "Optional[OrderedDict]" = None) -> _Plan:
    """The bucket layout (reference :231): params in REVERSE declaration
    order, split by (dtype, lr multiplier) and by `comm_mb`, the last
    bucket tail-split to `last_mb`. `cache` is the owning reducer's, so a
    dead model's params are not held for the process's life."""
    sig = _plan_signature(params, group, comm_mb, last_mb, comm_dtype)
    if cache is not None:
        plan = cache.get(sig)
        if plan is not None:
            cache.move_to_end(sig)
            return plan
    nranks = getattr(group, "nranks", 1) if group is not None else 1
    groups: "OrderedDict[tuple, list]" = OrderedDict()
    for p in reversed(params):
        groups.setdefault((_dtype_name(p), _lr_mult(p)), []).append(p)
    raw: List[list] = []
    for ps in groups.values():
        raw.extend(_bucket_params(ps, comm_mb))
    if raw:
        last_cap = int(float(last_mb) * 1024 * 1024)
        tail_bucket = raw[-1]
        if len(tail_bucket) > 1:
            tail, tail_bytes = [], 0
            while len(tail_bucket) > 1:
                last = _arr(tail_bucket[-1])
                nbytes = last.numel() * last.element_size()
                if tail and tail_bytes + nbytes > last_cap:
                    break
                tail.insert(0, tail_bucket.pop())
                tail_bytes += nbytes
            if tail and tail_bucket:
                raw.append(tail)
    plan = _Plan(sig, [_Bucket(i, ps, nranks, comm_dtype)
                       for i, ps in enumerate(raw)])
    if cache is not None:
        cache[sig] = plan
        while len(cache) > _PLAN_CACHE_CAP:
            cache.popitem(last=False)
    return plan


# ---------------------------------------------------------------------------
# The reducer
# ---------------------------------------------------------------------------

_LIVE_REDUCERS: list = []  # weakrefs; drained by the Optimizer pre-step hook
_hook_registered = [False]


def _drain_live_reducers():
    dead = []
    for ref in _LIVE_REDUCERS:
        r = ref()
        if r is None:
            dead.append(ref)
        else:
            # a full flush, not just a wait: in barrier mode nothing is
            # issued yet, and step() promises what sync_gradients() does
            r.flush_and_drain()
    for ref in dead:
        _LIVE_REDUCERS.remove(ref)


def _register_pre_step_hook():
    if _hook_registered[0]:
        return
    from ..optimizer import optimizer as _opt_mod

    _opt_mod.register_pre_step_hook(_drain_live_reducers)
    _hook_registered[0] = True


class _Reducer:
    """Hook-driven bucket reducer (reference :376; Paddle's EagerReducer).

    Owns the persistent plan and each step's issue / drain state.
    `shard_bound` is set by `sharded_update`; with `FLAGS_dp_shard_update`
    it turns the bucket collective from an all_reduce AVG (gradients
    written back) into a reduce_scatter AVG (this rank's flat shard kept
    for the sharded step)."""

    def __init__(self, dp: "DataParallel"):
        self._dp = weakref.ref(dp)
        self._group = dp._group
        self._comm_mb = float(dp._comm_buffer_mb)
        self._last_mb = float(dp._last_comm_buffer_mb)
        self._plan: Optional[_Plan] = None
        self._plan_cache: "OrderedDict[tuple, _Plan]" = OrderedDict()
        self._outstanding: List[_Bucket] = []
        # set by the hooks, cleared by flush_and_drain: the pre-step
        # drain issues only when fresh grads arrived, so an explicit
        # sync_gradients() followed by step() reduces once
        self._dirty = False
        self.shard_bound = False
        self._handles = [p.register_grad_final_hook(self._on_grad_final)
                         for p in dp._layers.parameters()
                         if not p.stop_gradient]
        _register_pre_step_hook()
        _LIVE_REDUCERS.append(weakref.ref(self))

    # -- plan ------------------------------------------------------------
    def _trainable(self):
        dp = self._dp()
        if dp is None:
            return []
        return [p for p in dp._layers.parameters() if not p.stop_gradient]

    def _ensure_plan(self) -> Optional[_Plan]:
        if self._plan is not None:
            return self._plan
        params = self._trainable()
        if not params:
            return None
        self._plan = _build_plan(params, self._group, self._comm_mb,
                                 self._last_mb, _comm_dtype_name(),
                                 cache=self._plan_cache)
        return self._plan

    def rebind_group(self, group: Optional[coll.Group]):
        """Point the reducer at a new group. In-flight bucket state
        belongs to the old world and is dropped; the plan rebuilds lazily
        (its signature holds the group's id and size)."""
        self._group = group
        self._dirty = False
        self._outstanding = []
        if self._plan is not None:
            for b in self._plan.buckets:
                b.ready.clear()
                b.issued = False
                b.task = None
                b.buf = None
                b.flat_grad = None
                b.residual = None
        self._plan = None

    def _active(self) -> bool:
        return self._group is not None and self._group.nranks > 1

    def shard_active(self) -> bool:
        return (self.shard_bound
                and bool(flags.flag_value("dp_shard_update"))
                and self._active())

    def _sync_enabled(self) -> bool:
        dp = self._dp()
        return dp is not None and dp._sync_enabled

    # -- hook-driven issue -------------------------------------------------
    def _on_grad_final(self, t):
        if not self._sync_enabled() or not self._active():
            return
        self._dirty = True
        if not flags.flag_value("dp_overlap"):
            return
        plan = self._ensure_plan()
        if plan is None:
            return
        b = plan.by_param.get(id(t))
        if b is None or id(t) in b.ready:
            return
        b.ready.add(id(t))
        if len(b.ready) == len(b.params) and all(
                _grad(p) is not None for p in b.params):
            self._issue(b)

    def _issue(self, b: _Bucket):
        """Pack the bucket and issue its collective asynchronously, from
        inside backward (overlap) or from the drain (barrier mode)."""
        g = self._group
        shard = self.shard_active()
        grads = [_grad(p) for p in b.params]
        if b.comm_dtype == "int8":
            if b.qpack is None:
                b.qpack = _qc.make_pack_q8(b)
                b.qdecode = _qc.make_decode_q8(b)
            if b.residual is None:
                b.residual = _qc.zeros_residual(b, grads[0].device)
            with torch.no_grad():
                wire, b.residual = b.qpack(grads, b.residual)
            b.buf = wire.new_empty((g.nranks, wire.numel()))
            b.op = "q8_gather"
            b.task = coll.all_gather_into_tensor(b.buf, wire, group=g,
                                                 sync_op=False, tiled=False)
        else:
            with torch.no_grad():
                flat = _flat(grads, _torch_dtype(b.comm_dtype), b.padded)
            if shard:
                b.buf = flat.new_empty(b.padded // g.nranks)
                b.op = "reduce_scatter_avg"
                b.task = coll.reduce_scatter(b.buf, flat,
                                             op=coll.ReduceOp.AVG, group=g,
                                             sync_op=False)
            else:
                b.buf = flat
                b.op = "all_reduce"
                b.task = coll.all_reduce(flat, op=coll.ReduceOp.AVG,
                                         group=g, sync_op=False)
        b.issued = True
        b.ready.clear()
        self._outstanding.append(b)

    def _land(self, b: _Bucket):
        """A finished bucket's result: this rank's flat shard kept for the
        sharded step, or every gradient written back."""
        flat = b.buf
        if b.comm_dtype == "int8":
            flat = b.qdecode(flat)
            if self.shard_active():
                k = b.padded // self._group.nranks
                r = self._group.rank
                flat = flat[r * k:(r + 1) * k]
        if self.shard_active():
            b.flat_grad = flat
            return
        for p, o in zip(b.params, b.unpack(flat)):
            _arr(p).grad = o

    # -- drain -----------------------------------------------------------
    def flush_and_drain(self, force: bool = False):
        """The sync point: issue what is not yet issued (barrier mode,
        partially-ready buckets), then wait on the outstanding handles.
        Without `force` the issue pass runs only when gradients arrived
        since the last flush; `force` (an explicit `sync_gradients()`)
        reduces on every call."""
        if not self._sync_enabled() or not self._active():
            return
        if not (force or self._dirty):
            self._wait_outstanding()
            return
        plan = self._ensure_plan()
        if plan is None:
            return
        self._dirty = False
        for b in plan.buckets:
            if b.issued:
                continue
            ps = [p for p in b.params if _grad(p) is not None]
            if not ps:
                b.ready.clear()
                continue
            if len(ps) == len(b.params):
                self._issue(b)
            else:
                # unused params this step: the flat layout does not
                # apply; reduce the present ones through the plain path
                sync_param_grads(ps, self._group, self._comm_mb)
                b.ready.clear()
        self._wait_outstanding()

    def _wait_outstanding(self):
        if not self._outstanding:
            return
        for b in self._outstanding:
            async_engine.wait_for([b.task])
            with torch.no_grad():
                self._land(b)
            b.task = None
            b.buf = None
            b.issued = False
            b.ready.clear()
        self._outstanding = []


class LayerWrapper(Layer):
    """A Layer that wraps another, `_layers`: calls and the Layer
    protocol pass through to it. The base of `DataParallel`, the
    group-sharded stages and the meta-parallel wrappers."""

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        return self._layers.set_state_dict(state_dict, *a, **k)

    def train(self):
        self._layers.train()
        return super().train()

    def eval(self):
        self._layers.eval()
        return super().eval()


class DataParallel(LayerWrapper):
    """Reference: parallel.py:665 (Paddle's parallel.py:219). Wraps a
    Layer: broadcasts its parameters from the group's first rank, and
    averages their gradients over the group through the reducer."""

    def __init__(self, layers: Layer, strategy=None,
                 comm_buffer_size_MB: int = 25,
                 last_comm_buffer_size_MB: int = 1,
                 find_unused_parameters: bool = False,
                 group: Optional[coll.Group] = None, **kw):
        super().__init__()
        self._layers = layers
        self._group = group or coll.get_group(0)
        self._comm_buffer_mb = comm_buffer_size_MB
        self._last_comm_buffer_mb = last_comm_buffer_size_MB
        self.find_unused_parameters = find_unused_parameters
        self._sync_enabled = True
        if self._group is not None and self._group.nranks > 1:
            sync_params_buffers(layers, self._group,
                                src_rank=self._group.ranks[0])
        self._reducer = _Reducer(self)

    # -- reducer ---------------------------------------------------------
    def sync_gradients(self):
        """Wait for the hook-issued bucket collectives (and, in barrier
        mode or for partially-ready buckets, issue them now).
        `Optimizer.step()` does the same drain through its pre-step hook,
        so an explicit call is optional."""
        self._reducer.flush_and_drain(force=True)

    def rebind_group(self, group: Optional[coll.Group]):
        """Rebind to a new group; the bucket plan for the old world is
        dropped and rebuilt on the next backward."""
        self._group = group
        self._reducer.rebind_group(group)

    def no_sync(self):
        """Context: skip the gradient sync (accumulation). The hooks issue
        nothing; the next synced backward reduces the k-step total (AVG
        is linear, so it equals reducing each step)."""
        @contextlib.contextmanager
        def ctx():
            self._sync_enabled = False
            try:
                yield
            finally:
                self._sync_enabled = True

        return ctx()


# ---------------------------------------------------------------------------
# ZeRO-1 sharded update (FLAGS_dp_shard_update)
# ---------------------------------------------------------------------------

class ShardedUpdate:
    """Optimizer wrapper running the cross-replica sharded update (Xu et
    al., arXiv:2004.13336; reference :764): this rank's reduce-scattered
    flat gradient shard of each bucket feeds the optimizer as one flat
    parameter (`_dp_flat_b<i>`, 1/N of the update and of the optimizer
    state), and the updated shards are all-gathered back.

    Falls back to the replicated update, with one warning, for an
    optimizer whose math is not elementwise over the flat buffer (Lamb's
    per-parameter trust ratio, LBFGS's line search), for AdamW with
    `apply_decay_param_fun`, and whenever a grad_clip is set."""

    def __init__(self, optimizer, model: DataParallel,
                 group: Optional[coll.Group] = None):
        if not isinstance(model, DataParallel):
            raise TypeError(
                "sharded_update needs a DataParallel-wrapped model "
                f"(got {type(model).__name__})")
        self._opt = optimizer
        self._model = model
        self._reducer = model._reducer
        self._group = group or model._group
        self._warned = False
        self._flat_ok = (
            getattr(optimizer, "_flat_shardable", False)
            and getattr(optimizer, "_grad_clip", None) is None
            and getattr(optimizer, "_apply_decay_param_fun", None) is None)
        self._reducer.shard_bound = self._flat_ok

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.__dict__["_opt"], name)

    @property
    def inner(self):
        return self._opt

    def _shard_on(self) -> bool:
        return (bool(flags.flag_value("dp_shard_update"))
                and self._group is not None and self._group.nranks > 1)

    def step(self):
        r = self._reducer
        if not self._shard_on():
            r.flush_and_drain()
            return self._opt.step()
        if not self._flat_ok:
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"{type(self._opt).__name__} cannot run the flat-shard "
                    "update (non-elementwise math or grad_clip/"
                    "apply_decay_param_fun configured); falling back to the "
                    "replicated update", stacklevel=2)
            r.flush_and_drain()
            return self._opt.step()
        r.flush_and_drain()
        return self._sharded_step()

    def _shard_span(self, b: _Bucket):
        n = max(1, self._group.nranks)
        k = b.padded // n
        lo = max(self._group.rank, 0) * k
        return lo, lo + k

    @torch.no_grad()
    def _sharded_step(self):
        """Step each bucket's flat shard, then all-gather the buckets."""
        plan = self._reducer._ensure_plan()
        if plan is None:
            return self._opt.step()
        pseudo, leftover = [], []
        for b in plan.buckets:
            lo, hi = self._shard_span(b)
            dt = _torch_dtype(b.dtype)
            if b.flat_grad is None:
                grads = [_grad(p) for p in b.params]
                if any(g is None for g in grads):
                    # a partially-used bucket: its present grads were
                    # reduced by the flush; step them replicated
                    leftover.extend(p for p in b.params
                                    if _grad(p) is not None)
                    continue
                # grads already reduced (the flag was off at sync): pack
                # in the param dtype, never through the wire's codec
                b.flat_grad = _flat(grads, dt, b.padded)[lo:hi]
            shard = _flat([_arr(p) for p in b.params], dt,
                          b.padded)[lo:hi].clone()
            if b.pseudo is None:
                b.pseudo = Parameter.from_tensor(shard,
                                                 name=f"_dp_flat_b{b.index}")
                b.pseudo.optimize_attr = {"learning_rate": b.lr_mult}
            else:
                b.pseudo._data = shard.requires_grad_()
            b.pseudo._data.grad = b.flat_grad.to(dt)
            pseudo.append(b)
        if not pseudo and not leftover:
            return self._opt.step()
        saved = self._opt._parameter_list
        self._opt._parameter_list = [b.pseudo for b in pseudo] + leftover
        try:
            self._opt.step()
        finally:
            self._opt._parameter_list = saved
        for b in pseudo:
            full = b.pseudo._data.new_empty(b.padded)
            coll.all_gather_into_tensor(full, b.pseudo._data.detach(),
                                        group=self._group)
            for p, o in zip(b.params, b.unpack(full)):
                _arr(p).copy_(o)
            b.flat_grad = None
            b.pseudo._data.grad = None
        return None

    def reshard(self, new_group: coll.Group):
        """Re-partition the flat optimizer-state shards for `new_group`
        (every rank of the old group calls it). Each flat accumulator is
        all-gathered over the old group, cut back to its bucket's true
        size, re-padded to the new group's multiple and sliced to this
        rank's new shard; a rank outside the new group drops it. Exact
        for the elementwise optimizers: the pad holds zero gradients and
        zero state."""
        r = self._reducer
        old_plan = r._ensure_plan()
        old = self._group
        self._group = new_group
        self._model.rebind_group(new_group)  # drops the reducer plan
        if old_plan is None:
            return
        new_n = max(1, new_group.nranks)
        me = new_group.rank
        accs = self._opt._accumulators
        for b in old_plan.buckets:
            store = accs.get(f"_dp_flat_b{b.index}")
            if store:
                k = b.padded // max(1, old.nranks)
                new_padded = -(-b.numel // new_n) * new_n
                nk = new_padded // new_n
                for name, a in list(store.items()):
                    if not isinstance(a, torch.Tensor) or \
                            tuple(a.shape) != (k,):
                        continue
                    full = a.new_empty(b.padded)
                    if old.nranks > 1:
                        coll.all_gather_into_tensor(full, a.contiguous(),
                                                    group=old)
                    else:
                        full = a.clone()
                    flat = torch.cat([full[:b.numel],
                                      a.new_zeros(new_padded - b.numel)])
                    if me >= 0:
                        store[name] = flat[me * nk:(me + 1) * nk].clone()
                    else:
                        del store[name]
            b.flat_grad = None
            b.pseudo = None

    def optimizer_state_bytes_per_device(self) -> int:
        """The optimizer-state bytes this rank holds (one process a
        device): the 1/N claim of the sharded update, measurable."""
        total = 0
        for store in self._opt._accumulators.values():
            for a in store.values():
                if isinstance(a, torch.Tensor):
                    total += a.numel() * a.element_size()
        return total

    def clear_grad(self, set_to_zero=True):
        self._opt.clear_grad(set_to_zero)
        plan = self._reducer._plan
        if plan is not None:
            for b in plan.buckets:
                b.flat_grad = None
                if b.pseudo is not None:
                    b.pseudo._data.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        return self._opt.state_dict()

    def set_state_dict(self, state):
        return self._opt.set_state_dict(state)

    load_state_dict = set_state_dict


def sharded_update(optimizer, model: DataParallel,
                   group: Optional[coll.Group] = None) -> ShardedUpdate:
    """Bind `optimizer` to `model`'s reducer for the ZeRO-1 sharded
    update (active while `FLAGS_dp_shard_update` is on)."""
    return ShardedUpdate(optimizer, model, group)


def init_parallel_env(device=None):
    """Reference: parallel.py:1010; the card unless `device` names the
    CPU."""
    return coll.init_parallel_env(device)
