"""paddle.amp.debugging: per-op statistics and the tensor checker —
port of `paddle_tpu/amp/debugging.py`.

Both wrap the port's `ops.dispatch.call_op` once (`_install`): every op
that goes through the port layer reports its name and the torch tensors
it returned. Operator statistics count calls by op and output dtype;
the tensor checker raises FloatingPointError on an op whose floating
output holds a NaN or Inf. `compare_accuracy` diffs two `.npz` dumps of
{op name: array} into a CSV, as the reference does.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "compare_accuracy"]

_DT = {torch.float32: "float32", torch.float16: "float16",
       torch.bfloat16: "bfloat16", torch.float64: "float64",
       torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}

_STATS: Dict[str, Dict[str, int]] = {}
_orig_call_op = None


def _outs(out):
    from ..core.tensor import Tensor

    if isinstance(out, Tensor):
        return [out._data]
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _outs(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _outs(o)]
    return []


def _stat_hook(name, outs):
    rec = _STATS.setdefault(name, {})
    for o in outs:
        dt = _DT.get(o.dtype, str(o.dtype).replace("torch.", ""))
        rec[dt] = rec.get(dt, 0) + 1


def _install(hook):
    """Wrap dispatch.call_op once; hook(name, output tensors) per op. The
    registered ops look `call_op` up in the module at every call, so the
    patch reaches all of them."""
    global _orig_call_op
    from ..ops import dispatch

    if _orig_call_op is not None:
        return
    _orig_call_op = dispatch.call_op

    def wrapped(name, kernel, args, kwargs, nondiff=False):
        out = _orig_call_op(name, kernel, args, kwargs, nondiff=nondiff)
        hook(name, _outs(out))
        return out

    dispatch.call_op = wrapped


def _uninstall():
    global _orig_call_op
    from ..ops import dispatch

    if _orig_call_op is not None:
        dispatch.call_op = _orig_call_op
        _orig_call_op = None


def enable_operator_stats_collection():
    _STATS.clear()
    _install(_stat_hook)


def disable_operator_stats_collection():
    _uninstall()
    _print_stats()


def _print_stats():
    if not _STATS:
        return
    print("<{:-^120}>".format(" op list "))
    print("{:<40}  {:<20}  {}".format("op", "dtype", "calls"))
    for name in sorted(_STATS):
        for dt, n in sorted(_STATS[name].items()):
            print(f"{name:<40}  {dt:<20}  {n}")
    print("<{:-^120}>".format(""))


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


class TensorCheckerConfig:
    """Which ops the checker watches: all, or `checked_op_list` less
    `skipped_op_list`."""

    def __init__(self, enable=True, debug_mode=None, checked_op_list=None,
                 skipped_op_list=None, **kwargs):
        self.enable = enable
        self.debug_mode = debug_mode
        self.checked = set(checked_op_list or [])
        self.skipped = set(skipped_op_list or [])


_checker_cfg: Optional[TensorCheckerConfig] = None


def enable_tensor_checker(config: TensorCheckerConfig):
    global _checker_cfg
    _checker_cfg = config
    if not config.enable:
        return

    def check_hook(name, outs):
        if config.checked and name not in config.checked:
            return
        if name in config.skipped:
            return
        for o in outs:
            if o.is_floating_point() and not bool(torch.isfinite(o).all()):
                raise FloatingPointError(
                    f"[tensor_checker] op {name!r} produced non-finite "
                    f"values (dtype {_DT.get(o.dtype, o.dtype)})")

    _install(check_hook)


def disable_tensor_checker():
    _uninstall()


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Diff two `.npz` dumps of {op name: array}; writes a CSV of each
    common op's largest absolute and relative error."""
    a = np.load(dump_path, allow_pickle=True)
    b = np.load(another_dump_path, allow_pickle=True)
    rows = ["op,max_abs_err,max_rel_err"]
    for k in sorted(set(a.files) & set(b.files)):
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if x.shape != y.shape:
            rows.append(f"{k},shape_mismatch,{x.shape}vs{y.shape}")
            continue
        err = np.abs(x - y)
        rel = err / np.maximum(np.abs(y), 1e-12)
        rows.append(f"{k},{err.max():.6e},{rel.max():.6e}")
    with open(output_filename, "w") as f:
        f.write("\n".join(rows) + "\n")
    return output_filename
