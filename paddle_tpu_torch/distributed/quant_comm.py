"""Block-scaled int8 wire codec: the port's copy of the two codec
functions of `paddle_tpu/distributed/quant_comm.py` (`encode_flat` :100,
`decode_flat` :118) and their layout helpers, in numpy.

A flat f32 payload is quantized per block of `block_size()` elements
with one f32 absmax scale a block; the wire is one int8 buffer, the
`nblocks * block` quantized elements followed by the scales' 4 bytes
each. The arithmetic is the reference's, step for step in f32 (absmax /
127, round half to even, clip to ±127), so a wire encoded by one package
decodes in the other and the bytes are equal. The port uses it for the
adapters' q8 wire (`inference/serving/adapters.py`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["SCALE_BYTES", "DEFAULT_BLOCK", "block_size", "wire_layout",
           "encode_flat", "decode_flat"]

#: Bytes of scale metadata per block: one float32 as 4 int8.
SCALE_BYTES = 4
#: Elements a scale covers: the reference's FLAGS_dp_comm_block_size
#: default.
DEFAULT_BLOCK = 256


def block_size() -> int:
    return DEFAULT_BLOCK


def wire_layout(numel: int, block: int) -> Tuple[int, int, int]:
    """``(qpadded, nblocks, wire_len)`` for a flat payload of ``numel``:
    ``numel`` rounded up to whole blocks, the blocks, and the int8 wire's
    length with its trailing scale bytes."""
    nblocks = max(1, -(-numel // block))
    qpadded = nblocks * block
    return qpadded, nblocks, qpadded + SCALE_BYTES * nblocks


def encode_flat(total: np.ndarray, block: int):
    """f32 ``[qpadded]`` -> (int8 wire ``[qpadded + 4 nblocks]``,
    residual ``total - dequant(q)``). All-zero blocks divide by 1, so they
    encode to exact zeros."""
    total = np.asarray(total, np.float32)
    nblocks = total.shape[0] // block
    blocks = total.reshape(nblocks, block)
    scale = (np.abs(blocks).max(axis=1) / np.float32(127.0)).astype(
        np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(blocks / safe[:, None]), -127, 127).astype(np.int8)
    residual = (blocks - q.astype(np.float32) * scale[:, None]).reshape(-1)
    wire = np.concatenate([q.reshape(-1), scale.view(np.int8).reshape(-1)])
    return wire, residual


def decode_flat(wire: np.ndarray, nblocks: int, block: int) -> np.ndarray:
    """int8 wire -> f32 ``[nblocks * block]`` (inverse of encode_flat)."""
    wire = np.ascontiguousarray(np.asarray(wire, np.int8))
    payload = wire[:nblocks * block].reshape(nblocks, block)
    scale = wire[nblocks * block:].view(np.float32).reshape(nblocks)
    return (payload.astype(np.float32) * scale[:, None]).reshape(-1)
