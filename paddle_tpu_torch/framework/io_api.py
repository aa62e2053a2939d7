"""`paddle.save` / `paddle.load`: port of `paddle_tpu/framework/io_api.py`.

The file format is the reference's, so a file that one package writes
loads in the other: a pickle (protocol 4 by default) of the object with
each Tensor replaced by a dict `{"__paddle_tpu_tensor__": True, "data":
numpy array, "name": ..., "stop_gradient": ...}`, then a footer of the
magic `PTCK1\\0` and the payload's CRC32 (little-endian uint32). `pickle`
ignores the trailing bytes, so plain pickle reads the files too.

`save` is atomic: it writes `<path>.tmp.<pid>`, fsyncs, and renames.
`load` checks the footer and raises `DataLossError` on a mismatch or an
unreadable payload; a file without the footer loads unchecked, as in
the reference. Tensors load onto the current place (`set_device`).

bfloat16 tensors are stored as numpy arrays of `ml_dtypes.bfloat16`,
the type the reference's arrays have; saving or loading one needs the
`ml_dtypes` package. The reference's chaos site `paddle_save` comes with
the rest of `distributed/fault_tolerance` (ROADMAP item 7c).
"""
from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Any

import numpy as np
import torch

from ..core.enforce import DataLossError
from ..core.tensor import Tensor

_SENTINEL = "__paddle_tpu_tensor__"

# footer: magic + <I crc32 of the payload>, after the pickle payload
_CRC_MAGIC = b"PTCK1\x00"
_CRC_FOOTER_LEN = len(_CRC_MAGIC) + 4


def _bfloat16():
    try:
        import ml_dtypes
    except ImportError as e:
        raise TypeError("a bfloat16 tensor is stored as an ml_dtypes "
                        "bfloat16 array, as the reference stores it; this "
                        "needs the ml_dtypes package") from e
    return ml_dtypes.bfloat16


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bfloat16())
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pack(obj: Any):
    if isinstance(obj, Tensor):
        return {_SENTINEL: True, "data": _to_numpy(obj._data),
                "name": obj.name, "stop_gradient": obj.stop_gradient}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj: Any, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get(_SENTINEL):
            if return_numpy:
                return obj["data"]
            t = Tensor(_from_numpy(obj["data"]),
                       stop_gradient=obj.get("stop_gradient", True))
            t.name = obj.get("name", t.name)
            return t
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Write `obj` (a state_dict, or any nest of dicts, lists and tuples
    holding Tensors) to `path`, atomically, with the CRC32 footer."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = pickle.dumps(_pack(obj), protocol=protocol)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.write(_CRC_MAGIC + struct.pack("<I", zlib.crc32(payload)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _verify_crc(path: str, raw: bytes) -> bytes:
    """The pickle payload of `raw`, its footer checked; a file without
    the footer passes unchecked."""
    if len(raw) >= _CRC_FOOTER_LEN and \
            raw[-_CRC_FOOTER_LEN:-4] == _CRC_MAGIC:
        payload = raw[:-_CRC_FOOTER_LEN]
        want = struct.unpack("<I", raw[-4:])[0]
        got = zlib.crc32(payload)
        if got != want:
            raise DataLossError(
                f"paddle.load({path!r}): CRC mismatch (stored "
                f"{want:#010x}, computed {got:#010x}): the file is "
                f"corrupted (truncated write, bit rot, or a concurrent "
                f"writer); restore from a good checkpoint")
        return payload
    return raw


def load(path, return_numpy=False, **configs):
    """Read what `save` (of either package) wrote; Tensors land on the
    current place, or stay numpy arrays with `return_numpy=True`."""
    with open(path, "rb") as f:
        raw = f.read()
    payload = _verify_crc(path, raw)
    try:
        obj = pickle.loads(payload)
    except Exception as e:
        raise DataLossError(
            f"paddle.load({path!r}): unreadable payload "
            f"({type(e).__name__}: {e}): the file is truncated or "
            f"corrupted; restore from a good checkpoint") from e
    return _unpack(obj, return_numpy=return_numpy)
