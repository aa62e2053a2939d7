"""Paged-KV serving attention — the reference's
`block_multihead_attention_`, with fp and int8 cache pages.

Counterpart of `paddle_tpu/ops/kernels/serving_attention.py:374
block_multihead_attention_` (with `_rope_pairwise` :72 and
`_rotary_table` :90): rope on the packed q/k, the page append, and the
read through kernel A5 (`ops/cuda/paged_attention.py`), in its int8-page
mode when the four cache scale tensors are given.

PyTorch runs eagerly, so what the reference recomputes inside every
traced layer — which sequence each packed token belongs to, its
position, its page and slot, how q rows pack per sequence — is built
once per tick on the host by :func:`paged_metadata` and shared by all
layers.

The page append is an in-place scatter by (page, slot) into the cache;
the reference writes pages with a one-hot einsum over
`[num_blocks * block_size, tokens]` (a TPU idiom) into a donated cache.
Int8 pages are quantized on append with static per-head multipliers,
`clip(round(k_f32 * kq), -127, 127)`, value by value, so a preempted
sequence recomputed with other chunk boundaries writes the same pages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..cuda import paged_attention as PA

__all__ = ["PagedMeta", "paged_metadata", "rope_table",
           "block_multihead_attention_"]


def rope_table(cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The reference's stacked rope layout [2, 1, S, hd] from (cos, sin)
    [S, hd/2]; only the first hd/2 lanes of each half are read."""
    return torch.stack([torch.cat([cos, cos], -1)[None],
                        torch.cat([sin, sin], -1)[None]])


@dataclass
class PagedMeta:
    """One tick's packed-batch metadata, on the device.

    Packed token t belongs to sequence tok_b[t] at chunk offset
    tok_local[t] (clamped to max_q - 1); tok_valid marks the tokens that
    are not padding; cos/sin [token_num, hd/2] are their rope rows.
    write_idx lists the valid tokens and write_page/write_slot where
    they go in the pool; row_tok [B, max_q] gathers each sequence's q
    rows for the kernel."""
    max_q: int
    tok_b: torch.Tensor
    tok_local: torch.Tensor
    tok_valid: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    write_idx: torch.Tensor
    write_page: torch.Tensor
    write_slot: torch.Tensor
    row_tok: torch.Tensor
    block_tables: torch.Tensor
    seq_lens_decoder: torch.Tensor
    seq_lens_this_time: torch.Tensor


def paged_metadata(cu_seqlens_q, seq_lens_decoder, seq_lens_this_time,
                   block_tables, token_num: int, block_size: int,
                   rope_emb: torch.Tensor,
                   max_q: Optional[int] = None) -> PagedMeta:
    """Build a tick's metadata from the scheduler's host arrays (numpy):
    cu_seqlens_q [B+1], seq_lens_decoder / seq_lens_this_time [B] (past
    and this lengths), block_tables [B, max_blocks] (-1 = unused), and
    the rope table [2, 1, S, hd]; the tensors land on its device.
    `max_q` is how many q rows per sequence the attention launch packs:
    `token_num` for a mixed tick (the default), 1 for the decode launch."""
    cu = np.asarray(cu_seqlens_q, np.int64).reshape(-1)
    past = np.asarray(seq_lens_decoder, np.int64).reshape(-1)
    this = np.asarray(seq_lens_this_time, np.int64).reshape(-1)
    tables = np.asarray(block_tables, np.int32)
    B = tables.shape[0]
    max_q = token_num if max_q is None else int(max_q)
    if max_q < int(this.max(initial=0)):
        raise ValueError(f"max_q={max_q} is below the longest chunk "
                         f"{int(this.max())} of this tick")
    tok = np.arange(token_num)
    tok_b = np.clip(np.searchsorted(cu, tok, side="right") - 1, 0, B - 1)
    tok_local = tok - cu[tok_b]
    tok_valid = tok_local < this[tok_b]
    tok_pos = past[tok_b] + tok_local
    valid = np.nonzero(tok_valid)[0]
    vpos = tok_pos[valid]
    pages = tables[tok_b[valid], vpos // block_size]
    if (pages < 0).any():
        raise ValueError("a valid token's position has no page in its "
                         "block table")
    row_tok = np.clip(cu[:B, None] + np.arange(max_q)[None, :], 0,
                      token_num - 1)

    dev = rope_emb.device
    hd, S = rope_emb.shape[-1], rope_emb.shape[-2]

    def t(a, dtype=torch.long):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    pos = t(np.clip(tok_pos, 0, S - 1))        # pad tokens: any row will do
    return PagedMeta(
        max_q=max_q, tok_b=t(tok_b),
        tok_local=t(np.minimum(tok_local, max_q - 1)),
        tok_valid=t(tok_valid, torch.bool),
        cos=rope_emb[0, 0, :, :hd // 2].float()[pos],
        sin=rope_emb[1, 0, :, :hd // 2].float()[pos],
        write_idx=t(valid), write_page=t(pages),
        write_slot=t(vpos % block_size), row_tok=t(row_tok),
        block_tables=t(tables, torch.int32),
        seq_lens_decoder=t(past, torch.int32),
        seq_lens_this_time=t(this, torch.int32))


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half (neox) rope on x [tok, heads, hd], f32 math, as the
    reference's `_rope_pairwise(..., neox=True)`."""
    x32 = x.float()
    h = x.shape[-1] // 2
    x1, x2 = x32[..., :h], x32[..., h:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


_QMAX = 127.0       # the reference's quant_max_bound / -quant_min_bound


def block_multihead_attention_(qkv, key_cache, value_cache,
                               meta: PagedMeta,
                               cache_k_quant_scales=None,
                               cache_v_quant_scales=None,
                               cache_k_dequant_scales=None,
                               cache_v_dequant_scales=None,
                               dynamic_cachekv_quant: bool = False):
    """Paged-KV attention for a packed mixed prefill/decode batch.

    qkv [token_num, (H + 2·KV)·hd] packed by the tick's cu_seqlens_q;
    key_cache / value_cache [num_blocks, KV, block_size, hd] (one
    layer's pool). This tick's k/v are appended to the caches IN PLACE
    (the reference returns new caches from a donated carry), then the
    paged-attention kernel reads them. Returns fmha_out
    [token_num, H·hd] in qkv's type; padding tokens come back 0.

    Int8 caches take all four scale tensors: `cache_{k,v}_quant_scales`
    [KV], the per-head multipliers 127 / absmax applied on append, and
    `cache_{k,v}_dequant_scales` [num_blocks, KV], each page's
    multipliers absmax / 127 that the kernel applies to scores and
    probabilities. The scales are static (calibrated):
    `dynamic_cachekv_quant=True` raises, as in the reference."""
    quant_args = {"cache_k_quant_scales": cache_k_quant_scales,
                  "cache_v_quant_scales": cache_v_quant_scales,
                  "cache_k_dequant_scales": cache_k_dequant_scales,
                  "cache_v_dequant_scales": cache_v_dequant_scales}
    kv_quant = any(v is not None for v in quant_args.values())
    if kv_quant:
        missing = [k for k, v in quant_args.items() if v is None]
        if missing:
            raise ValueError(
                f"int8 KV cache needs all four cache scale tensors; "
                f"missing {missing}")
        if key_cache.dtype != torch.int8 or value_cache.dtype != torch.int8:
            raise ValueError(
                f"cache quant scales passed but caches are "
                f"{key_cache.dtype}/{value_cache.dtype}; allocate the "
                f"paged caches as int8 (PagedServingEngine does this "
                f"when quant_kv is enabled)")
        if dynamic_cachekv_quant:
            raise NotImplementedError(
                "dynamic_cachekv_quant: per-step cache scales would make "
                "page contents depend on write chunking and break "
                "preemption recompute bit-parity; use static calibrated "
                "scales (inference.quant.calibrate)")
    num_blocks, KV, bs, hd = key_cache.shape
    token_num = qkv.shape[0]
    H = qkv.shape[1] // hd - 2 * KV
    G = H // KV
    B = meta.row_tok.shape[0]
    qkv3 = qkv.view(token_num, H + 2 * KV, hd)
    q = _rope(qkv3[:, :H], meta.cos, meta.sin)
    k = _rope(qkv3[:, H:H + KV], meta.cos, meta.sin)
    v = qkv3[:, H + KV:]

    # page append: token -> (block_tables[b, pos // bs], pos % bs)
    idx = meta.write_idx
    k_new, v_new = k[idx], v[idx]
    if kv_quant:
        def quantize(x, qs):            # [n, KV, hd] -> int8, per-head qs
            x = x.float() * qs.float().reshape(1, KV, 1)
            return torch.clamp(torch.round(x), -_QMAX, _QMAX).to(torch.int8)
        k_new = quantize(k_new, cache_k_quant_scales)
        v_new = quantize(v_new, cache_v_quant_scales)
    key_cache[meta.write_page, :, meta.write_slot] = k_new.to(key_cache.dtype)
    value_cache[meta.write_page, :, meta.write_slot] = \
        v_new.to(value_cache.dtype)

    # pack q per sequence into [B, KV, max_q * G, hd] rows r = t*G + g
    # (head h = kv*G + g), read through the kernel, unpack per token
    maxq = meta.max_q
    q_pack = q.reshape(token_num, KV, G, hd)[meta.row_tok]
    q_pack = q_pack.permute(0, 2, 1, 3, 4).reshape(B, KV, maxq * G,
                                                   hd).contiguous()
    o_pack = PA.paged_attention(
        q_pack, key_cache, value_cache, meta.block_tables,
        meta.seq_lens_decoder, meta.seq_lens_this_time, G,
        1.0 / math.sqrt(hd), k_dequant=cache_k_dequant_scales,
        v_dequant=cache_v_dequant_scales)
    o = o_pack.view(B, KV, maxq, G, hd).permute(0, 2, 1, 3, 4)
    o = o[meta.tok_b, meta.tok_local]                   # [tok, KV, G, hd]
    o = torch.where(meta.tok_valid[:, None, None, None], o, 0.0)
    return o.reshape(token_num, H * hd).to(qkv.dtype)
