"""Process groups and eager collectives over `torch.distributed` — the
port of `paddle_tpu/distributed/collective.py:50-930`.

The reference runs one controller over a device mesh: a `Group` names a
mesh axis and an eager collective compiles a one-op XLA program over it.
Here there is one process per rank, as in Paddle itself: a `Group` wraps a
torch `ProcessGroup` and every collective is that group's own call,
rank-local in and out (rank r holds its own tensor). The backend follows
the device: NCCL for CUDA tensors, gloo for CPU tensors. A tensor on the
other kind of device raises; nothing falls back from one to the other,
and a group that fails to form, or a collective that fails, raises.

- `init_parallel_env(device=None)` forms the default group: from a
  launcher's env (`PADDLE_TRAINER_ID` / `PADDLE_TRAINERS_NUM`, or torch's
  `RANK` / `WORLD_SIZE`, with `MASTER_ADDR` / `MASTER_PORT`: torch's
  TCPStore), from an explicit `init_method` (`file://...`: a FileStore),
  or, with no launcher, a world of one over an in-process HashStore on
  the caller's device (the card unless the caller names the CPU).
  Collectives over a group of one still go through the backend.
- Ranks are global ranks everywhere (src, dst, peer), as in the
  reference; `Group.rank` is this process's rank inside the group.
- Every collective issued is counted by kind and by the group's axis
  name (`issued()`, `reset_issued()`): "world" for the default group,
  the mesh axis for a mesh's groups (`distributed/mesh.py`), `_pg<id>`
  for another `new_group`.
- `ReduceOp.AVG` is a sum divided by the group's size on every backend
  (gloo has no AVG).

The reference's chaos, watchdog, epoch-fence and live-world hooks
(`:479-510`, `:752-805`) and its store-backed p2p come with ROADMAP item
7c; its traced mode is `distributed/mesh.py` (differentiable collectives
over a mesh axis).
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..device import resolve
from .env import get_rank, get_world_size

__all__ = [
    "ReduceOp", "Task", "Group", "P2POp", "init_parallel_env", "new_group",
    "get_group", "destroy_process_group", "is_initialized", "all_reduce",
    "all_gather", "all_gather_into_tensor", "reduce_scatter", "alltoall",
    "alltoall_single", "broadcast", "reduce", "scatter", "barrier", "send",
    "recv", "isend", "irecv", "batch_isend_irecv", "all_gather_object",
    "broadcast_object_list", "get_global_rank", "get_backend", "issued",
    "reset_issued"]

BACKEND = {"cuda": "nccl", "cpu": "gloo"}
DEVICE_OF = {"nccl": "cuda", "gloo": "cpu"}


class ReduceOp:
    """Reference: paddle.distributed.ReduceOp (communication/reduce.py)."""

    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}


def _torch_op(op) -> "dist.ReduceOp":
    try:
        return _TORCH_OP[op]
    except KeyError:
        raise ValueError(f"unknown reduce op {op!r}") from None


class Task:
    """A collective's handle (reference: ProcessGroup::Task). `wait`
    blocks until the collective is done (on the card: until the
    communication stream's work is ordered before the caller's stream)
    and then runs what the call left for its end (an AVG's division, a
    list's filling), once."""

    def __init__(self, work=None, after=None):
        self._work = work
        self._after = after

    def is_completed(self) -> bool:
        return self._work is None or self._work.is_completed()

    def wait(self, timeout=None):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._after is not None:
            after, self._after = self._after, None
            after()
        return True

    def synchronize(self):
        self.wait()


def _finish(work, after, sync_op) -> Task:
    task = Task(work, after)
    if sync_op:
        task.wait()
    return task


class Group:
    """A communication group: its global ranks, in order, and the torch
    ProcessGroup over them (reference: collective.py `Group`). A process
    outside the group holds one too, with `rank` -1 and no ProcessGroup
    it may call."""

    def __init__(self, ranks: List[int], gid: int, pg, backend: str,
                 axis_name: Optional[str] = None):
        self.ranks = list(ranks)
        self.id = gid
        self.pg = pg
        self.backend = backend
        self.axis_name = axis_name or f"_pg{gid}"
        # this process's rank in the group, read once (every collective
        # checks it)
        self._rank = self.get_group_rank(get_rank())

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    @property
    def world_size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def process_group(self):
        return self.pg

    @property
    def device_type(self) -> str:
        return DEVICE_OF[self.backend]

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self) -> bool:
        return self._rank >= 0

    def __repr__(self):
        return (f"Group(id={self.id}, nranks={self.nranks}, "
                f"axis={self.axis_name!r}, ranks={self.ranks}, "
                f"backend={self.backend!r})")


_lock = threading.RLock()
_groups: Dict[int, Group] = {}
_pgs: Dict[tuple, object] = {}       # (ranks, backend) -> ProcessGroup
_default: List[Optional[Group]] = [None]
_counts: collections.Counter = collections.Counter()


def issued() -> Dict[str, int]:
    """Collectives issued since the last `reset_issued`, by
    "kind/axis" (e.g. "all_gather/tp", "all_reduce/world")."""
    return {f"{k}/{a}": n for (k, a), n in sorted(_counts.items())}


def reset_issued() -> None:
    _counts.clear()


def count(kind: str, group: Group, n: int = 1) -> None:
    _counts[(kind, group.axis_name)] += n


def is_initialized() -> bool:
    return _default[0] is not None


def init_parallel_env(device=None, init_method: Optional[str] = None,
                      timeout=None) -> Group:
    """Form the default group (reference: parallel.py:978
    init_parallel_env) and return it; a second call returns it again.

    device: the card unless the caller names the CPU; the backend follows
    it (NCCL, gloo). On the card each rank takes card `LOCAL_RANK`.
    Rank and world come from the launcher's env (`env.get_rank` /
    `get_world_size`); `init_method` (e.g. "file:///path") rendezvouses
    through a FileStore, else a world above one needs `MASTER_ADDR` and
    `MASTER_PORT` (torch's TCPStore), and a world of one with neither
    forms over an in-process HashStore. A default process group formed
    elsewhere is adopted when its backend matches."""
    with _lock:
        if _default[0] is not None and device is None:
            return _default[0]
        dev = resolve(device)
        backend = BACKEND[dev.type]
        if _default[0] is not None:
            if _default[0].backend != backend:
                raise ValueError(
                    f"the default group runs {_default[0].backend}; a "
                    f"{dev.type} group needs {backend} (new_group(..., "
                    f"backend={backend!r}))")
            return _default[0]
        if dist.is_initialized():
            have = dist.get_backend()
            if have != backend:
                raise ValueError(f"the default process group runs {have}, "
                                 f"not {backend} for {dev.type}")
        else:
            import os
            world, rank = get_world_size(), get_rank()
            if dev.type == "cuda":
                from .env import ParallelEnv
                torch.cuda.set_device(ParallelEnv().local_rank
                                      % torch.cuda.device_count())
            kw = {} if timeout is None else {"timeout": timeout}
            if init_method is not None:
                dist.init_process_group(backend, init_method=init_method,
                                        rank=rank, world_size=world, **kw)
            elif "MASTER_ADDR" in os.environ:
                dist.init_process_group(backend, init_method="env://",
                                        rank=rank, world_size=world, **kw)
            elif world == 1:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1, **kw)
            else:
                raise RuntimeError(
                    f"a world of {world} ranks needs MASTER_ADDR and "
                    f"MASTER_PORT (the launcher sets them) or an "
                    f"init_method")
        world = dist.get_world_size()
        g = Group(list(range(world)), 0, dist.group.WORLD, backend, "world")
        _pgs[(tuple(g.ranks), backend)] = g.pg
        _groups.clear()
        _groups[0] = g
        _default[0] = g
        return g


def _default_group(device_type: Optional[str] = None) -> Group:
    """The default group, formed on `device_type` (the card when None)
    if there is none yet."""
    if _default[0] is None:
        init_parallel_env(device_type)
    return _default[0]


def new_group(ranks: Optional[List[int]] = None,
              backend: Optional[str] = None, timeout=None,
              axis_name: Optional[str] = None) -> Group:
    """A group over `ranks` (global, default every rank; reference:
    collective.py:194). Every rank of the world must call it, in the
    same order, members or not (torch's rule). backend: the default
    group's unless named ("gloo" for CPU tensors, "nccl" for the card's);
    a group over the same ranks and backend reuses one ProcessGroup."""
    with _lock:
        base = _default_group()
        ranks = sorted(range(base.nranks) if ranks is None else ranks)
        backend = backend or base.backend
        if backend not in DEVICE_OF:
            raise ValueError(f"unknown backend {backend!r}")
        key = (tuple(ranks), backend)
        pg = _pgs.get(key)
        if pg is None:
            kw = {} if timeout is None else {"timeout": timeout}
            pg = dist.new_group(ranks, backend=backend, **kw)
            _pgs[key] = pg
        gid = max(_groups) + 1
        g = Group(ranks, gid, pg, backend, axis_name)
        _groups[gid] = g
        return g


def get_group(gid: int = 0) -> Optional[Group]:
    _default_group()
    return _groups.get(gid)


def destroy_process_group(group: Optional[Group] = None):
    """None: tear the whole world down (every group); else forget
    `group`."""
    with _lock:
        if group is not None:
            _groups.pop(group.id, None)
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        _groups.clear()
        _pgs.clear()
        _default[0] = None


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------

def _data(t) -> torch.Tensor:
    """The torch tensor of a port Tensor, or the tensor itself."""
    d = getattr(t, "_data", t)
    if not isinstance(d, torch.Tensor):
        raise TypeError(f"a collective takes tensors, got {type(t).__name__}")
    return d


def _like(data: torch.Tensor, like):
    """`data` as the kind of tensor `like` is (a port Tensor or torch's)."""
    if isinstance(like, torch.Tensor):
        return data
    from ..core.tensor import Tensor
    return Tensor._from_data(data)


def _group(group: Optional[Group], t: torch.Tensor) -> Group:
    g = group if group is not None else _default_group(t.device.type)
    if t.device.type != g.device_type:
        raise ValueError(
            f"{g.backend} group {g.axis_name!r} takes {g.device_type} "
            f"tensors, got one on {t.device}")
    if g.rank < 0:
        raise ValueError(f"rank {get_rank()} is not a member of {g}")
    return g


def _avg(x, g, op):
    if op != ReduceOp.AVG:
        return None

    def after():
        with torch.no_grad():
            x.div_(g.nranks)
    return after


# ---------------------------------------------------------------------------
# collectives (reference: python/paddle/distributed/communication/*)
# ---------------------------------------------------------------------------

def all_reduce(tensor, op: str = ReduceOp.SUM, group: Optional[Group] = None,
               sync_op: bool = True) -> Task:
    """Reduce `tensor` over the group, in place on every rank."""
    x = _data(tensor)
    g = _group(group, x)
    count("all_reduce", g)
    with torch.no_grad():
        work = dist.all_reduce(x, _torch_op(op), group=g.pg, async_op=True)
    return _finish(work, _avg(x, g, op), sync_op)


def all_gather(tensor_list: list, tensor, group: Optional[Group] = None,
               sync_op: bool = True) -> Task:
    """Every rank's `tensor`, in rank order, into `tensor_list` (cleared
    first)."""
    x = _data(tensor)
    g = _group(group, x)
    outs = [torch.empty_like(x) for _ in range(g.nranks)]
    count("all_gather", g)
    work = dist.all_gather(outs, x.contiguous(), group=g.pg, async_op=True)
    del tensor_list[:]
    tensor_list.extend(_like(o, tensor) for o in outs)
    return _finish(work, None, sync_op)


def all_gather_into_tensor(out_tensor, tensor, group=None, sync_op=True,
                           tiled: bool = True) -> Task:
    """Every rank's `tensor` into `out_tensor`: concatenated on dim 0
    (tiled) or stacked on a new leading dim."""
    x = _data(tensor).contiguous()
    g = _group(group, x)
    out = _data(out_tensor)
    n = g.nranks
    x = x.reshape(1) if x.dim() == 0 else x
    if out.numel() != n * x.numel() or not out.is_contiguous():
        want = (n * x.shape[0],) + tuple(x.shape[1:]) if tiled else \
            (n,) + tuple(x.shape)
        raise ValueError(f"all_gather_into_tensor: out {tuple(out.shape)} "
                         f"cannot hold {want}")
    count("all_gather", g)
    with torch.no_grad():
        work = dist.all_gather_into_tensor(
            out.view((n * x.shape[0],) + tuple(x.shape[1:])), x,
            group=g.pg, async_op=True)
    return _finish(work, None, sync_op)


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True) -> Task:
    """Reduce over the group, then scatter along dim 0: `tensor`
    receives this rank's block (a list input is concatenated first)."""
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.cat([_data(t) for t in src], dim=0)
    src = _data(src).contiguous()
    out = _data(tensor)
    g = _group(group, src)
    count("reduce_scatter", g)
    with torch.no_grad():
        work = dist.reduce_scatter_tensor(out, src, _torch_op(op),
                                          group=g.pg, async_op=True)
    return _finish(work, _avg(out, g, op), sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None,
             sync_op=True) -> Task:
    """Rank r's i-th input goes to rank i, and arrives there as the r-th
    output. `in_tensor_list`: a list of one tensor a rank (their dim 0
    may differ; received blocks take the sender's sizes, so every rank
    sends rank i blocks of the size i expects), or one tensor cut into
    equal blocks on dim 0. `out_tensor_list` is cleared and filled."""
    if isinstance(in_tensor_list, (list, tuple)):
        parts = [_data(t) for t in in_tensor_list]
        like = in_tensor_list[0]
    else:
        x = _data(in_tensor_list)
        like = in_tensor_list
        parts = None
    first = parts[0] if parts is not None else x
    g = _group(group, first)
    n = g.nranks
    if parts is None:
        parts = list(torch.chunk(x, n, dim=0))
    if len(parts) != n:
        raise ValueError(f"alltoall: {len(parts)} inputs for {n} ranks")
    send = [p.shape[0] for p in parts]
    recv = _exchange_sizes(send, g)
    inp = torch.cat([p.reshape((p.shape[0],) + tuple(first.shape[1:]))
                     for p in parts], dim=0).contiguous()
    out = inp.new_empty((sum(recv),) + tuple(first.shape[1:]))
    count("all_to_all", g)
    work = dist.all_to_all_single(out, inp, recv, send, group=g.pg,
                                  async_op=True)
    if out_tensor_list is not None:
        del out_tensor_list[:]
        out_tensor_list.extend(_like(o, like)
                               for o in torch.split(out, recv, dim=0))
    return _finish(work, None, sync_op)


def _exchange_sizes(send: List[int], g: Group) -> List[int]:
    """The dim-0 sizes this rank receives from each rank, given the ones
    it sends: equal blocks need no exchange; unequal ones are traded by
    one all_to_all of the sizes."""
    if len(set(send)) <= 1:
        return list(send)
    dev = torch.device(g.device_type, torch.cuda.current_device()) \
        if g.device_type == "cuda" else torch.device("cpu")
    s = torch.tensor(send, dtype=torch.int64, device=dev)
    r = torch.empty_like(s)
    count("all_to_all", g)
    dist.all_to_all_single(r, s, group=g.pg)
    return [int(v) for v in r.tolist()]


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """all_to_all over dim 0 of one tensor: block i (equal blocks, or
    `in_split_sizes`) to rank i, received blocks concatenated in rank
    order (`out_split_sizes`). With `out_tensor` None the output is
    allocated and returned (equal blocks, or `out_split_sizes`); else
    it is written and the Task returned."""
    x = _data(in_tensor).contiguous()
    g = _group(group, x)
    if out_tensor is None:
        rows = x.shape[0] if out_split_sizes is None else sum(out_split_sizes)
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
    else:
        out = _data(out_tensor)
    count("all_to_all", g)
    with torch.no_grad():
        work = dist.all_to_all_single(
            out, x, None if out_split_sizes is None else list(out_split_sizes),
            None if in_split_sizes is None else list(in_split_sizes),
            group=g.pg, async_op=True)
    task = _finish(work, None, sync_op)
    return task if out_tensor is not None else _like(out, in_tensor)


def broadcast(tensor, src: int = 0, group: Optional[Group] = None,
              sync_op: bool = True) -> Task:
    """Global rank `src`'s tensor onto every rank's, in place."""
    x = _data(tensor)
    g = _group(group, x)
    count("broadcast", g)
    with torch.no_grad():
        work = dist.broadcast(x, src, group=g.pg, async_op=True)
    return _finish(work, None, sync_op)


def reduce(tensor, dst: int = 0, op: str = ReduceOp.SUM, group=None,
           sync_op=True) -> Task:
    """Reduce over the group into global rank `dst`'s tensor (the other
    ranks' tensors are the backend's to use)."""
    x = _data(tensor)
    g = _group(group, x)
    count("reduce", g)
    with torch.no_grad():
        work = dist.reduce(x, dst, _torch_op(op), group=g.pg, async_op=True)
    after = _avg(x, g, op) if get_rank() == dst else None
    return _finish(work, after, sync_op)


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op=True) -> Task:
    """Global rank `src`'s `tensor_list[i]` into group rank i's `tensor`
    (the list is read on `src` only)."""
    x = _data(tensor)
    g = _group(group, x)
    lst = ([_data(t).contiguous() for t in tensor_list]
           if get_rank() == src else None)
    count("scatter", g)
    with torch.no_grad():
        work = dist.scatter(x, lst, src, group=g.pg, async_op=True)
    return _finish(work, None, sync_op)


def barrier(group: Optional[Group] = None, device=None):
    """Every rank of the group arrives before any leaves. device: the
    backend's device when no group is given (default the card)."""
    g = group if group is not None else _default_group(
        None if device is None else resolve(device).type)
    count("barrier", g)
    if g.backend == "nccl":
        dist.barrier(group=g.pg, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=g.pg)


# -- p2p --------------------------------------------------------------------

def send(tensor, dst: int = 0, group=None, sync_op=True):
    """Point-to-point send to global rank `dst`."""
    x = _data(tensor).contiguous()
    g = _group(group, x)
    count("send", g)
    work = dist.isend(x, dst, group=g.pg)
    return _finish(work, None, sync_op)


def recv(tensor, src: int = 0, group=None, sync_op=True):
    """Point-to-point receive from global rank `src`, into `tensor`."""
    x = _data(tensor)
    g = _group(group, x)
    count("recv", g)
    with torch.no_grad():
        work = dist.irecv(x, src, group=g.pg)
    return _finish(work, None, sync_op)


def isend(tensor, dst=0, group=None) -> Task:
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None) -> Task:
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One send or receive of a `batch_isend_irecv` (reference:
    batch_isend_irecv.py P2POp): op is `isend` / `send` or `irecv` /
    `recv` of this module (or torch's), peer a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


_SENDS = (send, isend, dist.isend, dist.send)
_RECVS = (recv, irecv, dist.irecv, dist.recv)


def batch_isend_irecv(p2p_op_list: List[P2POp]) -> List[Task]:
    """Post every send and receive of the list together (the backend
    pairs them, so a ring of sends and receives cannot deadlock)."""
    ops = []
    for p in p2p_op_list:
        x = _data(p.tensor)
        g = _group(p.group, x)
        if p.op in _SENDS:
            kind, fn, x = "send", dist.isend, x.contiguous()
        elif p.op in _RECVS:
            kind, fn = "recv", dist.irecv
        else:
            raise ValueError(f"P2POp.op must be isend or irecv, got {p.op}")
        count(kind, g)
        ops.append(dist.P2POp(fn, x, p.peer, g.pg))
    if not ops:
        return []
    with torch.no_grad():
        works = dist.batch_isend_irecv(ops)
    return [Task(w) for w in works]


# -- object collectives -----------------------------------------------------

def all_gather_object(object_list: list, obj, group=None, device=None):
    """Every rank's picklable `obj`, in rank order, into `object_list`."""
    g = group if group is not None else _default_group(
        None if device is None else resolve(device).type)
    out = [None] * g.nranks
    count("all_gather_object", g)
    dist.all_gather_object(out, obj, group=g.pg)
    del object_list[:]
    object_list.extend(out)


def broadcast_object_list(object_list, src=0, group=None, device=None):
    """Global rank `src`'s objects into every rank's `object_list`, in
    place; returns the list."""
    g = group if group is not None else _default_group(
        None if device is None else resolve(device).type)
    count("broadcast_object_list", g)
    dist.broadcast_object_list(object_list, src, group=g.pg)
    return object_list


def get_global_rank(group: Group, group_rank: int) -> int:
    return group.ranks[group_rank]


def get_backend(group: Optional[Group] = None) -> str:
    return (group or _default_group()).backend
