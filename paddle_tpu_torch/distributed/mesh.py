"""A device mesh over processes, and its differentiable collectives — the
port's counterpart of `jax.sharding.Mesh` and of the `lax` collectives
the reference's hybrid engine and ring attention call inside
`shard_map` (`paddle_tpu/distributed/hybrid.py`,
`paddle_tpu/ops/ring_attention.py`).

A `Mesh` lays the first prod(sizes) global ranks out row-major over its
named axes (the reference's `np.asarray(devices).reshape(...)`), holds
this rank's coordinate on each axis and one `collective.Group` an axis:
the ranks that differ from this one on that axis only. Every rank of the
world builds every group, in the same order, members or not (torch's
rule for `new_group`); a rank past the mesh holds a mesh it is not a
member of. The backend follows the mesh's device (NCCL, gloo), whatever
the default group's is.

The collectives take an axis's `Group` (`mesh.axis("tp")`, or any
`collective.Group`); each is a `torch.autograd.Function` whose backward
is the transpose the reference relies on (a selective checkpoint sees
the backend's own ops inside and recomputes them):
- `all_gather(x, g, dim)` (tiled) <-> `reduce_scatter(x, g, dim)` (a
  sum): the dim is moved to the front and made contiguous around the
  backend's dim-0 call, so the blocks land in rank order along `dim`;
- `psum(x, g)`: all-reduce; its backward is psum again, as jax
  transposes `psum` under `shard_map(check_vma=False)`. A loss that a
  psum replicates over k ranks thus gives k times its gradient on each,
  as in the reference (AdamW's normalisation hides the factor);
- `all_to_all(x, g, split_axis, concat_axis)`: x cut into n blocks on
  split_axis, block j to rank j, the received blocks concatenated in
  rank order on concat_axis; backward swaps the two axes;
- `ppermute(x, g, perm)`: perm a list of (source, destination) group
  ranks, by batched sends and receives; a rank that receives nothing
  gets zeros; backward the inverse permutation. A rank that maps to
  itself (an axis of one) copies locally: there is no peer;
- `split(x, g, dim)` (a replicated tensor to this rank's block; backward
  all_gather) and `gather_replicated(x, g, dim)` (blocks to the whole
  tensor on every rank; backward this rank's block), for eager entry
  points whose every rank holds the whole tensors;
- Megatron's pair for the tensor-parallel layers
  (`fleet/layers/mpu/mp_ops.py`): `c_identity(x, g)` (forward identity,
  backward all-reduce) and `mp_allreduce(x, g)` (forward all-reduce,
  backward identity), the transposes the reference's
  `_identity_fwd_allreduce_bwd` and its row-parallel psum give.
Each call that reaches the backend is counted by kind and axis
(`collective.issued()`); under remat a recomputed block issues and
counts its collectives again, as the reference's `jax.checkpoint` does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve
from . import collective as C

__all__ = ["Mesh", "build", "all_gather", "reduce_scatter", "psum",
           "all_to_all", "ppermute", "shift", "split", "gather_replicated",
           "c_identity", "mp_allreduce", "axis_index"]


class Mesh:
    """Named axes over the first prod(sizes) ranks, row-major.
    `shape[name]` is an axis's size; `index(name)` this rank's
    coordinate on it; `axis(name)` this rank's group along it."""

    def __init__(self, shape: Dict[str, int], device: torch.device,
                 coords: Optional[Dict[str, int]],
                 groups: Dict[str, C.Group]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.device = device
        self.backend = C.BACKEND[device.type]
        self.coords = coords
        self._groups = groups

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    def index(self, name: str) -> int:
        return self.coords[name]

    def axis(self, name: str) -> C.Group:
        return self._groups[name]

    def __repr__(self):
        return (f"Mesh({self.shape}, device={self.device}, "
                f"coords={self.coords})")


def build(axes: Sequence[Tuple[str, int]], device=None) -> Mesh:
    """A mesh of the named axes [(name, size), ...] on `device` (the card
    unless the caller names the CPU), forming the default group first if
    there is none. Needs prod(sizes) <= the world's size."""
    dev = resolve(device)
    backend = C.BACKEND[dev.type]
    base = C._default_group(dev.type)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    names = [a for a, _ in axes]
    sizes = [int(s) for _, s in axes]
    n = math.prod(sizes)
    if n > base.nranks:
        raise ValueError(f"need {n} ranks, have {base.nranks}")
    me = C.get_rank()
    grid = np.arange(n).reshape(sizes)
    coords = (dict(zip(names, (int(c) for c in np.unravel_index(me, sizes))))
              if me < n else None)
    groups = {}
    for i, name in enumerate(names):
        rows = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for row in rows:
            g = C.new_group([int(r) for r in row], backend=backend,
                            axis_name=name)
            if me in g.ranks:
                groups[name] = g
    return Mesh(dict(zip(names, sizes)), dev, coords, groups)


def axis_index(mesh: Mesh, name: str) -> int:
    """This rank's coordinate on axis `name` (`lax.axis_index`)."""
    return mesh.index(name)


# ---------------------------------------------------------------------------
# the collectives and their transposes
# ---------------------------------------------------------------------------

def _lead(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


def _gather(x, g, dim):
    xl = _lead(x, dim)
    out = xl.new_empty((g.nranks * xl.shape[0],) + tuple(xl.shape[1:]))
    C.count("all_gather", g)
    dist.all_gather_into_tensor(out, xl, group=g.pg)
    return out.movedim(0, dim).contiguous()


def _scatter_sum(x, g, dim):
    xl = _lead(x, dim)
    if xl.shape[0] % g.nranks:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"is not divisible by {g.nranks} ranks")
    out = xl.new_empty((xl.shape[0] // g.nranks,) + tuple(xl.shape[1:]))
    C.count("reduce_scatter", g)
    dist.reduce_scatter_tensor(out, xl, dist.ReduceOp.SUM, group=g.pg)
    return out.movedim(0, dim).contiguous()


def _sum(x, g):
    out = x.contiguous().clone()
    C.count("all_reduce", g)
    dist.all_reduce(out, dist.ReduceOp.SUM, group=g.pg)
    return out


def _exchange(x, g, split_axis, concat_axis):
    n = g.nranks
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} is not divisible by {n} ranks")
    inp = torch.stack(torch.chunk(x, n, dim=split_axis), 0).contiguous()
    out = torch.empty_like(inp)
    C.count("all_to_all", g)
    dist.all_to_all_single(out, inp, group=g.pg)
    return torch.cat(out.unbind(0), dim=concat_axis)


def _permute(x, g, dst):
    me = g.rank
    to = dst[me]
    frm = [i for i, d in enumerate(dst) if d == me]
    if to == me:
        return x.clone()
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    ops = []
    if to >= 0:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), g.ranks[to], g.pg))
    if frm:
        ops.append(dist.P2POp(dist.irecv, out, g.ranks[frm[0]], g.pg))
    if ops:
        C.count("ppermute", g)
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


def _block(x, g, dim):
    return torch.chunk(x, g.nranks, dim=dim)[g.rank].contiguous().clone()


def _inverse(dst: List[int]) -> List[int]:
    inv = [-1] * len(dst)
    for i, d in enumerate(dst):
        if d >= 0:
            inv[d] = i
    return inv


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _scatter_sum(dy, ctx.g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _scatter_sum(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, ctx.g, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _sum(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.g), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split_axis, concat_axis):
        ctx.args = g, concat_axis, split_axis
        return _exchange(x, g, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, dy):
        return _exchange(dy, *ctx.args), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dst):
        ctx.g, ctx.dst = g, dst
        return _permute(x, g, dst)

    @staticmethod
    def backward(ctx, dy):
        return _permute(dy, ctx.g, _inverse(ctx.dst)), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _block(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, ctx.g, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _block(dy, ctx.g, ctx.dim), None, None


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.g), None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _sum(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def _dim(x, dim):
    return dim % x.dim()


def all_gather(x: torch.Tensor, group: C.Group, dim: int = 0):
    """Rank-order concatenation of every rank's x along `dim` (tiled)."""
    return _AllGather.apply(x, group, _dim(x, dim))


def reduce_scatter(x: torch.Tensor, group: C.Group, dim: int = 0):
    """The sum over the group of x, this rank's block along `dim`."""
    return _ReduceScatter.apply(x, group, _dim(x, dim))


def psum(x: torch.Tensor, group: C.Group):
    """The sum over the group of x, on every rank."""
    return _Psum.apply(x, group)


def all_to_all(x: torch.Tensor, group: C.Group, split_axis: int,
               concat_axis: int):
    """`lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`."""
    return _AllToAll.apply(x, group, _dim(x, split_axis),
                           _dim(x, concat_axis))


def ppermute(x: torch.Tensor, group: C.Group,
             perm: Sequence[Tuple[int, int]]):
    """`lax.ppermute`: for each (source, destination) pair of group
    ranks, the source's x arrives at the destination."""
    dst = [-1] * group.nranks
    for s, d in perm:
        dst[s] = d
    return _Ppermute.apply(x, group, dst)


def shift(x: torch.Tensor, group: C.Group, k: int = 1):
    """`ppermute` by k around the ring: rank i's x to rank (i + k) % n."""
    n = group.nranks
    return ppermute(x, group, [(i, (i + k) % n) for i in range(n)])


def split(x: torch.Tensor, group: C.Group, dim: int = 0):
    """This rank's block of a tensor every rank holds whole."""
    return _Split.apply(x, group, _dim(x, dim))


def gather_replicated(x: torch.Tensor, group: C.Group, dim: int = 0):
    """Every rank's block, concatenated, as a tensor every rank holds
    whole (its gradient is this rank's block of the output's)."""
    return _GatherReplicated.apply(x, group, _dim(x, dim))


def c_identity(x: torch.Tensor, group: C.Group):
    """x itself; its gradient summed over the group (the input of a
    column-parallel product)."""
    return _CIdentity.apply(x, group)


def mp_allreduce(x: torch.Tensor, group: C.Group):
    """The sum over the group of x; its gradient passed through (the
    output of a row-parallel product)."""
    return _MpAllreduce.apply(x, group)
