"""Block-scaled int8 wire codec: the port of
`paddle_tpu/distributed/quant_comm.py` (`encode_flat` :100,
`decode_flat` :118, the DP bucket codec :131-176, the pipeline P2P wire
:183-247) and its layout helpers.

A flat f32 payload is quantized per block of `block_size()` elements
with one f32 absmax scale a block; the wire is one int8 buffer, the
`nblocks * block` quantized elements followed by the scales' 4 bytes
each. The arithmetic is the reference's, step for step in f32 (absmax /
127, round half to even, clip to ±127), so a wire encoded by one package
decodes in the other and the bytes are equal. `encode_flat` takes numpy
arrays (the adapters' and the page migration's wire,
`inference/serving/`); `decode_flat` numpy arrays or torch tensors, on
the CPU or the card. The DataParallel reducer's gradient buckets
(`distributed/parallel.py`) and the P2P wire encode in torch with the
arithmetic of the reference's jitted codecs (`_encode_t`).

- DP buckets: `make_pack_q8(b)` packs a bucket's gradients plus its
  error-feedback residual (`zeros_residual(b)`) into one wire and the
  new residual; `make_decode_q8(b)` dequantizes the gathered wires of
  every rank and means them (the AVG half of the quantized all-reduce).
- P2P: `p2p_encode(x)` casts or block-quantizes a floating payload per
  `FLAGS_pp_p2p_comm_dtype` and returns its decoder (no error feedback:
  activations are not accumulated across steps).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core import flags

__all__ = ["SCALE_BYTES", "DEFAULT_BLOCK", "block_size", "wire_layout",
           "encode_flat", "decode_flat", "make_pack_q8", "make_decode_q8",
           "zeros_residual", "p2p_comm_dtype", "p2p_encode"]

#: Bytes of scale metadata per block: one float32 as 4 int8.
SCALE_BYTES = 4
#: Elements a scale covers: the reference's FLAGS_dp_comm_block_size
#: default.
DEFAULT_BLOCK = 256

flags.define_flag(
    "dp_comm_block_size", DEFAULT_BLOCK,
    "Quantization block size (elements per float32 absmax scale) for the "
    "block-scaled int8 wire codec used when FLAGS_dp_grad_comm_dtype or "
    "FLAGS_pp_p2p_comm_dtype is 'int8'; each block ships one float32 "
    "scale (4 bytes) alongside its int8 payload")
flags.define_flag(
    "pp_p2p_comm_dtype", "",
    "Wire dtype for pipeline-parallel P2P stage handoffs: '' keeps the "
    "activation dtype, 'bfloat16'/'float16' cast on the wire, 'int8' "
    "applies the block-scaled codec (FLAGS_dp_comm_block_size) to both "
    "activation and gradient handoffs")

_P2P_DTYPES = {"bf16": "bfloat16", "bfloat16": "bfloat16",
               "fp16": "float16", "float16": "float16", "int8": "int8"}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def block_size() -> int:
    """Current ``FLAGS_dp_comm_block_size`` (validated)."""
    b = int(flags.flag_value("dp_comm_block_size") or 0)
    if b <= 0:
        raise ValueError(
            f"FLAGS_dp_comm_block_size={b}: want a positive element count")
    return b


def wire_layout(numel: int, block: int) -> Tuple[int, int, int]:
    """``(qpadded, nblocks, wire_len)`` for a flat payload of ``numel``:
    ``numel`` rounded up to whole blocks, the blocks, and the int8 wire's
    length with its trailing scale bytes."""
    nblocks = max(1, -(-numel // block))
    qpadded = nblocks * block
    return qpadded, nblocks, qpadded + SCALE_BYTES * nblocks


def encode_flat(total, block: int):
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


def decode_flat(wire, nblocks: int, block: int):
    """int8 wire -> f32 ``[nblocks * block]`` (inverse of encode_flat)."""
    if isinstance(wire, torch.Tensor):
        payload = wire[:nblocks * block].reshape(nblocks, block)
        scale = wire[nblocks * block:].contiguous().view(torch.float32)
        return (payload.float() * scale[:, None]).reshape(-1)
    wire = np.ascontiguousarray(np.asarray(wire, np.int8))
    payload = wire[:nblocks * block].reshape(nblocks, block)
    scale = wire[nblocks * block:].view(np.float32).reshape(nblocks)
    return (payload.astype(np.float32) * scale[:, None]).reshape(-1)


def _encode_t(total: torch.Tensor, block: int):
    """`encode_flat`'s codec in torch, with the arithmetic of the
    reference's jitted bucket and P2P executables: XLA computes
    absmax / 127 as absmax * f32(1/127) and the residual as one fused
    multiply-add (emulated exactly here in f64: a product of two f32 is
    exact there), so the wires are byte-equal to those executables'.
    torch.round is half to even, as jnp's."""
    nblocks = total.shape[0] // block
    blocks = total.float().reshape(nblocks, block)
    scale = blocks.abs().amax(dim=1) * _INV127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(
        torch.int8)
    residual = (blocks.double() - q.double() * scale.double()[:, None]
                ).float().reshape(-1)
    wire = torch.cat([q.reshape(-1), scale.contiguous().view(torch.int8)])
    return wire, residual


_INV127 = float(np.float32(1.0) / np.float32(127.0))


# ---------------------------------------------------------------------------
# DP buckets (built once per bucket by distributed/parallel.py)
# ---------------------------------------------------------------------------

def zeros_residual(b, device=None) -> torch.Tensor:
    """Fresh all-zero error-feedback accumulator for bucket ``b``."""
    return torch.zeros((b.qpadded,), dtype=torch.float32, device=device)


def make_pack_q8(b) -> Callable:
    """``(grads, residual) -> (wire, new_residual)`` for bucket ``b``: the
    flat pack (concatenate, pad to whole blocks), the error-feedback add
    and the block codec; the new residual is the exact quantization error
    of that total."""
    pad = b.qpadded - b.numel
    block = b.qblock

    def pack(arrs, residual):
        flat = torch.cat([a.reshape(-1).float() for a in arrs])
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return _encode_t(flat + residual, block)

    return pack


def make_decode_q8(b) -> Callable:
    """``gathered int8 [nranks, wire] -> f32 [padded]`` for bucket ``b``:
    every rank's wire dequantized, then their mean, sliced to the
    bucket's nranks-aligned ``padded`` length."""
    nblocks, block, padded = b.qblocks, b.qblock, b.padded

    def decode(gathered):
        deq = torch.stack([decode_flat(w, nblocks, block)
                           for w in gathered.unbind(0)])
        return deq.mean(dim=0)[:padded]

    return decode


# ---------------------------------------------------------------------------
# Pipeline P2P wire (codecs cached by signature)
# ---------------------------------------------------------------------------

def p2p_comm_dtype() -> Optional[str]:
    """Canonical ``FLAGS_pp_p2p_comm_dtype`` value, or None when unset."""
    raw = str(flags.flag_value("pp_p2p_comm_dtype") or "")
    if not raw:
        return None
    name = _P2P_DTYPES.get(raw.lower())
    if name is None:
        raise ValueError(
            f"FLAGS_pp_p2p_comm_dtype={raw!r}: want '', 'bfloat16', "
            f"'float16' or 'int8'")
    return name


_P2P_CODECS: dict = {}


def _build_p2p_codec(shape, dtype, wire, block):
    numel = int(np.prod(shape)) if shape else 1
    if wire == "int8":
        qpadded, nblocks, _ = wire_layout(numel, block)

        def enc(x):
            flat = x.reshape(-1).float()
            if qpadded > numel:
                flat = torch.cat([flat, flat.new_zeros(qpadded - numel)])
            return _encode_t(flat, block)[0]

        def dec(w):
            return decode_flat(w, nblocks, block)[:numel].reshape(
                shape).to(dtype)
    else:
        wdt = _TORCH_DTYPES[wire]

        def enc(x):
            return x.to(wdt)

        def dec(w):
            return w.to(dtype)

    return enc, dec


def p2p_encode(arr):
    """Encode ``arr`` for the P2P wire per ``FLAGS_pp_p2p_comm_dtype``.
    Returns ``(wire_buffer, decode_fn, wire_dtype_name)``; ``decode_fn``
    is None when the flag is off or ``arr`` is not a floating payload
    (the buffer is then ``arr`` itself). A small payload is one exact
    block (the block is clamped to its size)."""
    name = p2p_comm_dtype()
    if (name is None or not isinstance(arr, torch.Tensor)
            or not arr.is_floating_point()
            or arr.dtype == _TORCH_DTYPES.get(name)):
        return arr, None, None
    block = block_size() if name == "int8" else 0
    if block:
        block = max(1, min(block, arr.numel() or 1))
    key = (tuple(arr.shape), arr.dtype, name, block)
    codec = _P2P_CODECS.get(key)
    if codec is None:
        codec = _P2P_CODECS[key] = _build_p2p_codec(
            tuple(arr.shape), arr.dtype, name, block)
    enc, dec = codec
    return enc(arr), dec, name
