"""Shape and layout kernels: port of
`paddle_tpu/ops/kernels/manipulation.py` (views where torch gives one,
copies where paddle's functional semantics need one)."""
from __future__ import annotations

import numpy as np
import torch

from ..dispatch import register_op
from ._util import pair, tensors


def _ints(v):
    if isinstance(v, torch.Tensor):
        return [int(s) for s in v.tolist()]
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(s) for s in v]


@register_op
def reshape(x, shape):
    return torch.reshape(x, _ints(shape))


@register_op
def transpose(x, perm):
    return x.permute(*_ints(perm))


@register_op
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@register_op
def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


@register_op
def concat(xs, axis=0):
    return torch.cat(list(xs), dim=int(axis))


@register_op
def stack(xs, axis=0):
    return torch.stack(list(xs), dim=int(axis))


@register_op
def split(x, num_or_sections, axis=0):
    axis = int(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(
                f"split: axis {axis} of size {total} does not divide into "
                f"{num_or_sections} sections")
        return tuple(torch.split(x, total // num_or_sections, dim=axis))
    sections = [int(s) for s in num_or_sections]
    if -1 in sections:
        known = sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = total - known
    return tuple(torch.split(x, sections, dim=axis))


@register_op
def chunk(x, chunks, axis=0):
    return tuple(torch.tensor_split(x, chunks, dim=axis))


@register_op
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, int):
        axis = [axis]
    axis = tuple(a for a in axis if x.shape[a] == 1)
    return torch.squeeze(x, axis) if axis else x


@register_op
def unsqueeze(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    out = x
    for a in sorted(a if a >= 0 else a + out.dim() + 1 for a in axis):
        out = torch.unsqueeze(out, a)
    return out


@register_op
def flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape([1])
    return torch.flatten(x, start_axis, stop_axis)


@register_op
def tile(x, repeat_times):
    return torch.tile(x, _ints(repeat_times))


@register_op
def expand(x, shape):
    shape = _ints(shape)
    offset = len(shape) - x.dim()
    for i, s in enumerate(shape):
        if s == -1:
            shape[i] = x.shape[i - offset]
    return x.expand(shape)


@register_op
def broadcast_to(x, shape):
    return torch.broadcast_to(x, _ints(shape))


@register_op
def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


@register_op
def flip(x, axis):
    return torch.flip(x, _ints(axis))


@register_op
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@register_op
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


@register_op
def gather(x, index, axis=0):
    index = index.reshape(-1) if index.dim() > 1 else index
    return torch.index_select(x, int(axis), index.long())


@register_op
def gather_nd(x, index):
    idx = tuple(torch.movedim(index.long(), -1, 0))
    return x[idx]


@register_op
def scatter(x, index, updates, overwrite=True):
    index = index.long()
    if index.dim() == 2:
        index = index[:, 0]
    if overwrite:
        return x.index_put((index,), updates)
    zeroed = x.index_put((index,), torch.zeros_like(updates))
    return zeroed.index_put((index,), updates, accumulate=True)


@register_op
def scatter_nd_add(x, index, updates):
    idx = tuple(torch.movedim(index.long(), -1, 0))
    return x.index_put(idx, updates, accumulate=True)


@register_op
def index_select(x, index, axis=0):
    return torch.index_select(x, int(axis), index.long())


@register_op
def index_sample(x, index):
    return torch.gather(x, 1, index.long())


@register_op
def index_add(x, index, axis, value):
    return torch.index_add(x, int(axis), index.long(), value)


@register_op
def take_along_axis(x, indices, axis, broadcast=True):
    return torch.take_along_dim(x, indices.long(), dim=axis)


@register_op
def put_along_axis(x, indices, values, axis, reduce="assign"):
    indices = indices.long()
    values = torch.broadcast_to(tensors(values, x)[0].to(x.dtype),
                                indices.shape)
    if reduce == "assign":
        return torch.scatter(x, axis, indices, values)
    if reduce in ("add", "sum"):
        return torch.scatter_add(x, axis, indices, values)
    raise ValueError(f"Unsupported reduce mode {reduce}")


@register_op
def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register_op
def unbind(x, axis=0):
    return tuple(torch.unbind(x, axis))


@register_op
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    pad = _ints(pad)
    if len(pad) == 2 * x.dim():
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        # paddle's partial pad runs from the last spatial dim backwards
        widths = [(0, 0)] * x.dim()
        spatial = (list(range(1, x.dim() - 1)) if data_format.endswith("C")
                   else list(range(2, x.dim())))
        for i in range(len(pad) // 2):
            widths[spatial[len(spatial) - 1 - i]] = (pad[2 * i], pad[2 * i + 1])
    # torch's F.pad lists (left, right) from the last dim forwards
    flat = [w for lo_hi in reversed(widths) for w in lo_hi]
    if mode == "constant":
        return torch.nn.functional.pad(x, flat, mode="constant", value=value)
    mode = {"reflect": "reflect", "replicate": "replicate",
            "circular": "circular"}[mode]
    # torch pads up to three trailing dims of a [N, C, ...] input in
    # these modes: fold the unpadded leading dims into C
    n = next((i for i, w in enumerate(widths) if w != (0, 0)), x.dim())
    y = x.reshape((1, -1) + tuple(x.shape[n:]))
    y = torch.nn.functional.pad(y, flat[:2 * (x.dim() - n)], mode=mode)
    return y.reshape(tuple(x.shape[:n]) + tuple(y.shape[2:]))


@register_op
def where(condition, x, y):
    x, y = tensors(x, y)
    return torch.where(condition, x, y)


@register_op(nondiff=True)
def masked_select(x, mask):
    return torch.masked_select(x, mask)


@register_op
def masked_fill(x, mask, value):
    return torch.masked_fill(x, mask, value)


@register_op
def getitem(x, idx):
    return x[idx]


@register_op
def setitem(x, value, idx):
    if isinstance(value, torch.Tensor):
        value = value.to(x.dtype)
    out = x.clone()
    out[idx] = value
    return out


@register_op
def as_real(x):
    return torch.view_as_real(x).clone()


@register_op
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@register_op(nondiff=True)
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, x % shard_size,
                       torch.full_like(x, ignore_value))


@register_op(nondiff=True)
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    res = np.unique(x.cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(torch.as_tensor(r, device=x.device) for r in res)
    return torch.as_tensor(res, device=x.device)


@register_op(nondiff=True)
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights=weights, minlength=minlength)


@register_op
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    ks, st, dl = pair(kernel_sizes), pair(strides), pair(dilations)
    pd = pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    # paddings are (top, left, bottom, right); F.unfold pads symmetrically
    xp = torch.nn.functional.pad(x, [pd[1], pd[3], pd[0], pd[2]])
    return torch.nn.functional.unfold(xp, ks, dilation=dl, stride=st)
