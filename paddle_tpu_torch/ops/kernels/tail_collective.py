"""Op tail 5 — port of `paddle_tpu/ops/kernels/tail_collective.py`: the
collective op names and the executor plumbing registered beside them.

The collective names run through `distributed.collective`, rank-local
as Paddle's own ops are: each rank passes its tensor and gets its
result (at world size one the identities and copies of the reference's
degenerate ring). `ring_id` 0 is the default group, on the tensor's
device (formed at first use: a world of one without a launcher); any
other id is a `new_group`'s id. The backend follows the device (NCCL,
gloo); a tensor on the other kind of device raises.

The plumbing (memcpy, share_data, depend, full_, shape, slice, ...) is
torch's own: a copy between host and card is `Tensor.to`, a stream sync
is the current stream's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dispatch import register_op
from ._util import device, td


def _coll():
    from ...distributed import collective as C

    return C


def ring_group(ring_id, device_type: str):
    """The group of `ring_id`: 0 the default group (formed on
    `device_type` if there is none), else that `new_group`."""
    C = _coll()
    if int(ring_id) == 0:
        return C._default_group(device_type)
    g = C.get_group(int(ring_id))
    if g is None:
        raise ValueError(f"no group with ring_id {ring_id}")
    return g


_REDUCE = {0: "sum", 1: "max", 2: "min", 3: "prod", 4: "avg"}


def _all_reduce(x, op, ring_id=0):
    out = x.clone()
    _coll().all_reduce(out, op=op, group=ring_group(ring_id, x.device.type))
    return out


def _gather(x, ring_id=0):
    """Every rank's x, in rank order (a list)."""
    outs: list = []
    _coll().all_gather(outs, x, group=ring_group(ring_id, x.device.type))
    return outs


# -- collective names ---------------------------------------------------------


@register_op(nondiff=True)
def all_reduce(x, reduce_type=0, ring_id=0):
    return _all_reduce(x, _REDUCE.get(int(reduce_type), "sum"), ring_id)


@register_op(name="c_allreduce_sum", nondiff=True)
def c_allreduce_sum(x, ring_id=0, use_calc_stream=True,
                    use_model_parallel=False):
    return _all_reduce(x, "sum", ring_id)


@register_op(name="c_allreduce_max", nondiff=True)
def c_allreduce_max(x, ring_id=0, use_calc_stream=True,
                    use_model_parallel=False):
    return _all_reduce(x, "max", ring_id)


@register_op(name="c_allreduce_min", nondiff=True)
def c_allreduce_min(x, ring_id=0, use_calc_stream=True,
                    use_model_parallel=False):
    return _all_reduce(x, "min", ring_id)


@register_op(name="c_allreduce_prod", nondiff=True)
def c_allreduce_prod(x, ring_id=0, use_calc_stream=True,
                     use_model_parallel=False):
    return _all_reduce(x, "prod", ring_id)


@register_op(name="mp_allreduce_sum", nondiff=True)
def mp_allreduce_sum(x, ring_id=0):
    return _all_reduce(x, "sum", ring_id)


@register_op(nondiff=True)
def all_gather(x, ring_id=0, nranks=1):
    """Every rank's x, concatenated on dim 0 in rank order."""
    return torch.cat(_gather(x, ring_id), dim=0)


@register_op(name="c_allgather", nondiff=True)
def c_allgather(x, ring_id=0, nranks=1, use_calc_stream=True):
    return torch.cat(_gather(x, ring_id), dim=0)


@register_op(name="c_concat", nondiff=True)
def c_concat(x, rank=0, nranks=1, ring_id=0, use_calc_stream=True,
             use_model_parallel=True):
    """Every rank's x concatenated on the LAST dim (the TP row-parallel
    output concat)."""
    return torch.cat(_gather(x, ring_id), dim=-1)


def _broadcast(x, root, ring_id):
    out = x.clone()
    g = ring_group(ring_id, x.device.type)
    _coll().broadcast(out, src=g.ranks[int(root)], group=g)
    return out


@register_op(nondiff=True)
def broadcast(x, root=0, ring_id=0):
    return _broadcast(x, root, ring_id)


@register_op(name="c_broadcast", nondiff=True)
def c_broadcast(x, root=0, ring_id=0, use_calc_stream=True):
    return _broadcast(x, root, ring_id)


def _reduce(x, root, op, ring_id):
    """The reduction on group rank `root`; the other ranks get x back."""
    out = x.clone()
    g = ring_group(ring_id, x.device.type)
    _coll().reduce(out, dst=g.ranks[int(root)], op=op, group=g)
    return out if g.rank == int(root) else x.clone()


@register_op(nondiff=True)
def reduce(x, root_id=0, reduce_type=0, ring_id=0):
    return _reduce(x, root_id, _REDUCE.get(int(reduce_type), "sum"), ring_id)


@register_op(name="c_reduce_sum", nondiff=True)
def c_reduce_sum(x, root_id=0, ring_id=0, use_calc_stream=True):
    return _reduce(x, root_id, "sum", ring_id)


@register_op(nondiff=True)
def reduce_scatter(x, ring_id=0, nranks=1):
    """The sum over the group of x, this rank's block of dim 0."""
    g = ring_group(ring_id, x.device.type)
    if x.shape[0] % g.nranks:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(x.shape)} is not "
                         f"divisible by {g.nranks} ranks")
    out = x.new_empty((x.shape[0] // g.nranks,) + tuple(x.shape[1:]))
    _coll().reduce_scatter(out, x, group=g)
    return out


@register_op(nondiff=True)
def all_to_all(x, ring_id=0):
    """x cut into one block a rank on dim 0, block i to rank i; the
    received blocks concatenated in rank order."""
    g = ring_group(ring_id, x.device.type)
    outs: list = []
    _coll().alltoall(outs, list(torch.chunk(x, g.nranks, dim=0)), group=g)
    return torch.cat(outs, dim=0)


@register_op(name="c_scatter", nondiff=True)
def c_scatter(x, root=0, ring_id=0, nranks=1, use_calc_stream=True):
    """Group rank `root`'s x cut into one block a rank on dim 0; this
    rank's block."""
    g = ring_group(ring_id, x.device.type)
    blocks = list(torch.chunk(x, g.nranks, dim=0))
    out = torch.empty_like(blocks[0])
    _coll().scatter(out, blocks, src=g.ranks[int(root)], group=g)
    return out


@register_op(name="c_identity", nondiff=True)
def c_identity(x, ring_id=0, use_calc_stream=True, use_model_parallel=True):
    """Identity forward (the reference's TP boundary marker)."""
    return x


@register_op(name="sync_calc_stream", nondiff=True)
def sync_calc_stream(x):
    """Wait for the work queued on x's device (the current stream)."""
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()
    return x


# -- memory movement / executor plumbing --------------------------------------


@register_op(nondiff=True)
def memcpy_d2h(x, dst_place_type=0):
    return x.to("cpu", copy=True)


@register_op(nondiff=True)
def memcpy_h2d(x, dst_place_type=1):
    return x.to(device(), copy=True)


@register_op(nondiff=True)
def copy_to(x, place=None, blocking=True):
    if place is None:
        return x.clone()
    from ...core.place import torch_device
    return x.to(torch_device(place), copy=True, non_blocking=not blocking)


@register_op(name="npu_identity", nondiff=True)
def npu_identity(x, format=-1):
    return x


@register_op(nondiff=True)
def share_data(x):
    return x


@register_op(nondiff=True)
def depend(x, dep=None):
    """Scheduling edge: x passes through, `dep` only orders."""
    return x


@register_op(nondiff=True)
def shape(input):
    return torch.tensor(list(input.shape), dtype=torch.int32,
                        device=input.device)


@register_op(name="full_", nondiff=True)
def full_(output, shape=None, value=0.0, dtype=None):
    s = tuple(shape) if shape is not None else tuple(output.shape)
    return torch.full(s, value, dtype=td(dtype) if dtype is not None
                      else output.dtype, device=output.device)


@register_op(nondiff=True)
def full_int_array(value, dtype="int64"):
    return torch.tensor(list(value), dtype=td(dtype), device=device())


@register_op(nondiff=True)
def full_with_tensor(value, shape, dtype=None):
    dt = td(dtype) if dtype is not None else value.dtype
    s = tuple(int(v) for v in np.asarray(shape.cpu()).reshape(-1))
    return torch.full(s, 0, dtype=dt, device=value.device) + value.to(dt)


@register_op(name="assign_value_", nondiff=True)
def assign_value_(output, shape=None, dtype=None, values=()):
    dt = td(dtype) if dtype is not None else output.dtype
    s = tuple(shape) if shape is not None else tuple(output.shape)
    return torch.tensor(list(values), dtype=dt,
                        device=output.device).reshape(s)


@register_op(name="assign_out_", nondiff=True)
def assign_out_(x, output):
    return x


@register_op(name="set", nondiff=True)
def set_(x, source):
    return source


@register_op
def set_value_with_tensor(x, values, starts, ends, steps, axes,
                          decrease_axes=(), none_axes=()):
    sl = [slice(None)] * x.dim()
    for ax, s, e, st in zip(axes, starts, ends, steps):
        sl[int(ax)] = slice(int(s), int(e), int(st))
    out = x.clone()
    out[tuple(sl)] = values.to(x.dtype)
    return out


@register_op(name="slice")
def slice_(input, axes, starts, ends, infer_flags=(), decrease_axis=()):
    sl = [slice(None)] * input.dim()
    for ax, s, e in zip(axes, starts, ends):
        sl[int(ax)] = slice(int(s), int(e))
    out = input[tuple(sl)]
    if decrease_axis:
        drop = {int(a) for a in decrease_axis}
        out = out.reshape([d for i, d in enumerate(out.shape)
                           if i not in drop])
    return out


@register_op
def trans_layout(x, perm):
    return x.permute(*[int(p) for p in perm])


@register_op(nondiff=True)
def coalesce_tensor(input, dtype=None, copy_data=True, set_constant=False,
                    constant=0.0, persist_output=False, align_size=-1):
    """A list of tensors fused into one flat buffer (in `dtype` when
    given) and their views into it (the bucketing under a fused gradient
    all-reduce). set_constant fills the buffer with `constant`;
    copy_data False leaves it zero."""
    dt = td(dtype) if dtype is not None else (
        input[0].dtype if input else torch.float32)
    dev = input[0].device if input else device()
    total = int(sum(t.numel() for t in input))
    if set_constant:
        fused = torch.full((total,), constant, dtype=dt, device=dev)
    elif not copy_data:
        fused = torch.zeros((total,), dtype=dt, device=dev)
    elif input:
        fused = torch.cat([t.reshape(-1).to(dt) for t in input])
    else:
        fused = torch.zeros((0,), dtype=dt, device=dev)
    outs, off = [], 0
    for t in input:
        outs.append(fused[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return outs, fused
