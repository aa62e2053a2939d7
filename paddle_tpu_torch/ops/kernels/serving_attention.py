"""Serving attention: the reference's paged-KV
`block_multihead_attention_`, with fp and int8 cache pages, and its
varlen half, `flash_attn_unpadded` over packed sequences.

Counterpart of `paddle_tpu/ops/kernels/serving_attention.py:374
block_multihead_attention_` (with `_rope_pairwise` :72 and
`_rotary_table` :90): rope on the packed q/k, the page append, and the
read through kernel A5 (`ops/cuda/paged_attention.py`), in its int8-page
mode when the four cache scale tensors are given. Two entries share
that body, :func:`paged_block_attention`: the engine calls it with a
:class:`PagedMeta`, and the registered paddle op
:func:`block_multihead_attention_` (ops.yaml's signature) builds the
PagedMeta from its sequence-length, cu_seqlens and block-table tensors.

What the reference recomputes inside every traced layer — which
sequence each packed token belongs to, its position, its page and slot,
how q rows pack per sequence — is built once per tick on the host by
:func:`paged_metadata` and shared by all layers; its two halves
(`paged_metadata_arrays` on the host, `metadata_from` on the device)
let the engine's captured decode tick stage the host arrays into static
buffers.

The page append is an in-place scatter by (page, slot) into the cache;
the reference writes pages with a one-hot einsum over
`[num_blocks * block_size, tokens]` (a TPU idiom) into a donated cache.
Int8 pages are quantized on append with static per-head multipliers,
`clip(round(k_f32 * kq), -127, 127)`, value by value, so a preempted
sequence recomputed with other chunk boundaries writes the same pages.

Varlen attention (`_unpack_cu` :189, `_xla_varlen_sdpa` :202,
`flash_attn_unpadded` :226, `flash_attn_varlen_qkvpacked` :294): when
the q and k packings are identical (the same cu_seqlens object, or equal
tensors) the packed tokens run kernel A1 (A2 under autograd) in its
segment-id mode (`ops/cuda/flash_attention.py`); other packings run the
masked composition with bottom-right causal alignment, as the reference
does.

The dense-cache serving ops (`masked_multihead_attention_` :123,
`variable_length_memory_efficient_attention` :317,
`fused_multi_transformer_` :632, with `_rope_pairwise` :72,
`_rotary_table` :90 and `_split_rotary` :110) are plain chains in the
reference and plain torch here, with the scores and softmax in f32 as
there; their caches are written in place, by index.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..cuda import flash_attention as FA
from ..cuda import paged_attention as PA
from ..dispatch import register_op

__all__ = ["PagedMeta", "paged_metadata", "paged_metadata_arrays",
           "metadata_from", "META_DTYPES", "rope_table",
           "paged_block_attention", "block_multihead_attention_",
           "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "masked_multihead_attention_",
           "variable_length_memory_efficient_attention",
           "fused_multi_transformer_"]


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
    are not padding; cos/sin [token_num, hd/2] are their rope rows (None:
    no rope).
    write_idx lists the valid tokens and write_page/write_slot where
    they go in the pool; row_tok [B, max_q] gathers each sequence's q
    rows for the kernel."""
    max_q: int
    tok_b: torch.Tensor
    tok_local: torch.Tensor
    tok_valid: torch.Tensor
    cos: Optional[torch.Tensor]
    sin: Optional[torch.Tensor]
    write_idx: torch.Tensor
    write_page: torch.Tensor
    write_slot: torch.Tensor
    row_tok: torch.Tensor
    block_tables: torch.Tensor
    seq_lens_decoder: torch.Tensor
    seq_lens_this_time: torch.Tensor


# the host arrays of a tick's metadata and their tensor types; "pos" is
# each packed token's rope row, from which `metadata_from` gathers cos/sin
META_DTYPES = {"tok_b": torch.long, "tok_local": torch.long,
               "tok_valid": torch.bool, "pos": torch.long,
               "write_idx": torch.long, "write_page": torch.long,
               "write_slot": torch.long, "row_tok": torch.long,
               "block_tables": torch.int32, "seq_lens_decoder": torch.int32,
               "seq_lens_this_time": torch.int32}


def paged_metadata_arrays(cu_seqlens_q, seq_lens_decoder, seq_lens_this_time,
                          block_tables, token_num: int, block_size: int,
                          rope_len: int, max_q: Optional[int] = None,
                          writes: Optional[int] = None) -> dict:
    """The host half of :func:`paged_metadata`: the tick's metadata as
    numpy arrays, keyed and typed as `META_DTYPES`. `rope_len` is the
    rope table's row count. `writes` pads the page-append lists to that
    many entries by repeating the first valid token's write: the same
    value to the same slot, so the pages do not change, and a decode
    tick's lists keep one length whatever the number of live sequences
    (the engine's captured tick needs fixed shapes)."""
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
    slots = vpos % block_size
    if writes is not None:
        if not 1 <= len(valid) <= writes:
            raise ValueError(f"{len(valid)} page writes do not pad to "
                             f"{writes}")
        pad = np.zeros(writes - len(valid), np.int64)   # entry 0, repeated
        valid, pages, slots = (np.concatenate([a, a[pad]])
                               for a in (valid, pages, slots))
    row_tok = np.clip(cu[:B, None] + np.arange(max_q)[None, :], 0,
                      token_num - 1)
    return {"tok_b": tok_b, "tok_local": np.minimum(tok_local, max_q - 1),
            "tok_valid": tok_valid,
            # pad tokens: any rope row will do
            "pos": np.clip(tok_pos, 0, rope_len - 1),
            "write_idx": valid, "write_page": pages, "write_slot": slots,
            "row_tok": row_tok, "block_tables": tables,
            "seq_lens_decoder": past, "seq_lens_this_time": this}


def metadata_from(t: dict, rope, max_q: int) -> PagedMeta:
    """The device half of :func:`paged_metadata`: a PagedMeta over the
    tensors `t` (keys and types of `META_DTYPES`), with each token's rope
    rows gathered from `rope`, the (cos, sin) tables [Br, S, hd/2] of
    :func:`_rotary_table` (Br 1: one table; Br B: a table a sequence),
    or None for no rope. It reads no device value, so a captured tick
    may run it over its static buffers."""
    cos = sin = None
    if rope is not None:
        cos_t, sin_t = rope
        if cos_t.shape[0] == 1:
            cos, sin = cos_t[0][t["pos"]], sin_t[0][t["pos"]]
        else:
            cos = cos_t[t["tok_b"], t["pos"]]
            sin = sin_t[t["tok_b"], t["pos"]]
    return PagedMeta(
        max_q=max_q, tok_b=t["tok_b"], tok_local=t["tok_local"],
        tok_valid=t["tok_valid"], cos=cos, sin=sin,
        write_idx=t["write_idx"], write_page=t["write_page"],
        write_slot=t["write_slot"], row_tok=t["row_tok"],
        block_tables=t["block_tables"],
        seq_lens_decoder=t["seq_lens_decoder"],
        seq_lens_this_time=t["seq_lens_this_time"])


def metadata_to(arrays: dict, device) -> dict:
    """The host arrays of :func:`paged_metadata_arrays` as tensors on
    `device`, keyed and typed as `META_DTYPES`, in one host-to-device
    copy: they travel packed in one int64 buffer and are cut and cast
    there."""
    flat = np.concatenate([np.asarray(arrays[k], np.int64).reshape(-1)
                           for k in META_DTYPES])
    buf = torch.from_numpy(flat).to(device)
    out, i = {}, 0
    for k, dtype in META_DTYPES.items():
        shape = np.shape(arrays[k])
        n = int(np.prod(shape))
        out[k] = buf[i:i + n].view(shape).to(dtype)
        i += n
    return out


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
    max_q = token_num if max_q is None else int(max_q)
    arrays = paged_metadata_arrays(
        cu_seqlens_q, seq_lens_decoder, seq_lens_this_time, block_tables,
        token_num, block_size, rope_emb.shape[-2], max_q)
    return metadata_from(metadata_to(arrays, rope_emb.device),
                         _rotary_table(rope_emb, rope_emb.shape[-1]), max_q)


_QMAX = 127.0       # the reference's quant_max_bound / -quant_min_bound


def paged_block_attention(qkv, key_cache, value_cache, meta: PagedMeta,
                          cache_k_quant_scales=None,
                          cache_v_quant_scales=None,
                          cache_k_dequant_scales=None,
                          cache_v_dequant_scales=None,
                          dynamic_cachekv_quant: bool = False,
                          use_neox_style: bool = True,
                          quant_max_bound: float = _QMAX,
                          quant_min_bound: float = -_QMAX):
    """Paged-KV attention for a packed mixed prefill/decode batch over a
    tick's metadata: the engine's form, and the body of the paddle op
    :func:`block_multihead_attention_`.

    qkv [token_num, (H + 2·KV)·hd] packed by the tick's cu_seqlens_q;
    key_cache / value_cache [num_blocks, KV, block_size, hd] (one
    layer's pool). Rope (rotate-half with `use_neox_style`, adjacent
    pairs without) rotates q and k by meta.cos / meta.sin. This tick's
    k/v are appended to the caches IN PLACE (the reference returns new
    caches from a donated carry), then kernel A5 reads them. Returns
    fmha_out [token_num, H·hd] in qkv's type; padding tokens come back 0.

    Int8 caches take all four scale tensors: `cache_{k,v}_quant_scales`
    [KV], the per-head multipliers 127 / absmax applied on append, and
    `cache_{k,v}_dequant_scales` [num_blocks, KV], each page's
    multipliers absmax / 127 that the kernel applies to scores and
    probabilities (A5's int8 mode). The scales are static (calibrated):
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
    q, k, v = qkv3[:, :H], qkv3[:, H:H + KV], qkv3[:, H + KV:]
    if meta.cos is not None:
        cos, sin = meta.cos[:, None], meta.sin[:, None]
        q = _rope_pairwise(q, cos, sin, use_neox_style)
        k = _rope_pairwise(k, cos, sin, use_neox_style)

    # page append: token -> (block_tables[b, pos // bs], pos % bs)
    idx = meta.write_idx
    k_new, v_new = k[idx], v[idx]
    if kv_quant:
        def quantize(x, qs):            # [n, KV, hd] -> int8, per-head qs
            x = x.float() * qs.float().reshape(1, KV, 1)
            return torch.clamp(torch.round(x), quant_min_bound,
                               quant_max_bound).to(torch.int8)
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


# the reference's `use_pallas` switches, which the port does not carry
# over (ROADMAP, PR 2): the kernel is the only path on the card
_NO_SWITCH = ("use_pallas=False asks for the reference's stock XLA path, "
              "which the port does not carry over (ROADMAP: the "
              "reference's kernel switches are not ported, PR 2); on a "
              "CUDA tensor the op runs kernel A5 or raises")


@register_op
def block_multihead_attention_(qkv, key_cache, value_cache, seq_lens_encoder,
                               seq_lens_decoder, seq_lens_this_time,
                               padding_offsets=None, cum_offsets=None,
                               cu_seqlens_q=None, cu_seqlens_k=None,
                               block_tables=None, pre_key_cache=None,
                               pre_value_cache=None, rope_emb=None, mask=None,
                               tgt_mask=None, cache_k_quant_scales=None,
                               cache_v_quant_scales=None,
                               cache_k_dequant_scales=None,
                               cache_v_dequant_scales=None,
                               qkv_out_scale=None, qkv_bias=None,
                               out_shift=None, out_smooth=None,
                               max_enc_len_this_time=None,
                               max_dec_len_this_time=None, max_seq_len=-1,
                               block_size=64, use_neox_style=False,
                               dynamic_cachekv_quant=False,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0, out_scale=-1.0,
                               compute_dtype="default", rope_theta=10000.0,
                               use_pallas=None):
    """The paddle op under ops.yaml's signature
    (`paddle_tpu/ops/kernels/serving_attention.py:374`): paged-KV
    attention for a mixed prefill/decode batch, as a PaddleNLP serving
    model calls it.

    qkv [token_num, (H + 2·KV)·hd] packed by cu_seqlens_q [B+1];
    key_cache / value_cache [num_blocks, KV, block_size, hd];
    block_tables [B, max_blocks] int32 (-1 = unassigned);
    seq_lens_decoder [B] the past length of each row, seq_lens_this_time
    [B] its tokens in this call (seq_lens_encoder is not read, as in the
    reference). rope_emb (either layout `_rotary_table` takes) rotates q
    and k at each token's position, rotate-half with use_neox_style,
    adjacent pairs without; qkv_bias [(H + 2·KV)·hd] is added first.
    Int8 pages take all four scale tensors (A5's int8 mode).

    The metadata is built on the host from cu_seqlens_q,
    seq_lens_decoder, seq_lens_this_time and block_tables (one copy to
    the host, one back), then :func:`paged_block_attention`, the
    engine's body, appends K/V and reads through A5 with max_q = the
    longest seq_lens_this_time q rows a sequence; use_pallas="decode"
    asserts that every seq_lens_this_time is <= 1.
    use_pallas None, True and "decode" take the kernel; False raises on a
    CUDA tensor (CPU tensors run the plain version whatever it says).
    Returns (fmha_out [token_num, H·hd], qkv_out (qkv with the bias),
    key_cache_out, value_cache_out): the caches are written in place and
    returned as they are."""
    _require_no_quant(qkv_out_scale=qkv_out_scale, out_shift=out_shift,
                      out_smooth=out_smooth)
    if pre_key_cache is not None or pre_value_cache is not None:
        raise NotImplementedError(
            "block_multihead_attention_: pre_key_cache/pre_value_cache "
            "(system-prompt pre-cache) is not wired. Shared prompt "
            "prefixes are served by the paged prefix cache instead: submit "
            "through paddle_tpu_torch.inference.PagedServingEngine and its "
            "BlockManager deduplicates the shared blocks (copy-on-write)")
    if mask is not None or tgt_mask is not None:
        raise NotImplementedError(
            "block_multihead_attention_ mask/tgt_mask: only right-padded "
            "causal batches are supported; custom masks not wired yet")
    if block_tables is None or cu_seqlens_q is None:
        missing = [n for n, v in (("block_tables", block_tables),
                                  ("cu_seqlens_q", cu_seqlens_q))
                   if v is None]
        raise ValueError(
            f"block_multihead_attention_ needs {' and '.join(missing)}: "
            "this is the paged-KV kernel and both come from the serving "
            "subsystem (paddle_tpu_torch.inference.PagedServingEngine packs "
            "them from its BlockManager block tables each step). For a "
            "dense per-slot cache without block tables use "
            "masked_multihead_attention_ or fused_multi_transformer_")
    if use_pallas not in (None, True, False, "decode"):
        raise ValueError(f"use_pallas={use_pallas!r}: None, True, False "
                         f"or 'decode'")
    if use_pallas is False and qkv.is_cuda:
        raise ValueError(_NO_SWITCH)
    num_blocks, KV, bs, hd = key_cache.shape
    token_num = qkv.shape[0]
    H = qkv.shape[1] // hd - 2 * KV
    if qkv.is_cuda and not PA.supported(H, KV, hd, bs):
        raise ValueError(
            f"block_multihead_attention_: geometry H={H} KV={KV} hd={hd} "
            f"block_size={bs} is not supported by kernel A5")
    if qkv_bias is not None:
        qkv = (qkv.view(token_num, H + 2 * KV, hd)
               + qkv_bias.reshape(1, H + 2 * KV, hd).to(qkv.dtype)
               ).reshape(token_num, -1)

    cu, past, this, tables = _ints_to_host(
        [cu_seqlens_q, seq_lens_decoder, seq_lens_this_time, block_tables])
    if use_pallas == "decode" and int(this.max(initial=0)) > 1:
        raise ValueError(
            f"use_pallas='decode' launches one q row a sequence: every "
            f"seq_lens_this_time must be <= 1, got {int(this.max())}")
    # the longest chunk of this call: the q rows a sequence packs
    max_q = max(int(this.max(initial=0)), 1)
    rope = None
    rope_len = max(int(max_seq_len), 1)
    if rope_emb is not None:
        rope = _rotary_table(rope_emb, hd)                # [Br, S, hd/2]
        rope_len = rope[0].shape[1]
    arrays = paged_metadata_arrays(cu, past, this, tables, token_num, bs,
                                   rope_len, max_q)
    meta = metadata_from(metadata_to(arrays, qkv.device), rope, max_q)
    fmha_out = paged_block_attention(
        qkv, key_cache, value_cache, meta,
        cache_k_quant_scales=cache_k_quant_scales,
        cache_v_quant_scales=cache_v_quant_scales,
        cache_k_dequant_scales=cache_k_dequant_scales,
        cache_v_dequant_scales=cache_v_dequant_scales,
        dynamic_cachekv_quant=dynamic_cachekv_quant,
        use_neox_style=bool(use_neox_style),
        quant_max_bound=float(quant_max_bound),
        quant_min_bound=float(quant_min_bound))
    return fmha_out, qkv, key_cache, value_cache


def _ints_to_host(ts):
    """The op's integer inputs as numpy arrays: tensors on one device
    come over in one device-to-host copy, packed as int64."""
    if all(isinstance(t, torch.Tensor) for t in ts) \
            and len({t.device for t in ts}) == 1:
        flat = torch.cat([t.detach().reshape(-1).to(torch.int64)
                          for t in ts]).cpu().numpy()
        out, i = [], 0
        for t in ts:
            out.append(flat[i:i + t.numel()].reshape(tuple(t.shape)))
            i += t.numel()
        return out
    return [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in ts]


# ---------------------------------------------------------------------------
# flash_attn_unpadded (varlen packed attention)
# ---------------------------------------------------------------------------

def _unpack_cu(cu_seqlens, total: int, device):
    """cu_seqlens [B+1] -> (segment id, local position, segment length)
    of each of `total` packed positions, on `device`. Ids run 1..B;
    positions past cu[-1] share id B+1, so they see only each other (and
    are discarded by the caller)."""
    cu = torch.as_tensor(cu_seqlens).to(device, torch.long).reshape(-1)
    nb = cu.shape[0] - 1
    idx = torch.arange(total, dtype=torch.long, device=device)
    seg = torch.searchsorted(cu, idx, right=True)
    start = cu[torch.clamp(seg - 1, 0, nb)]
    end = cu[torch.clamp(seg, 0, nb)]
    return (seg.to(torch.int32), idx - start,
            torch.clamp(end - start, min=0))


def _varlen_sdpa(q, k, v, qcu, kcu, scale: float, causal: bool):
    """Masked attention over packed [total, H, hd] q and k/v (H heads
    too), in f32: the reference's `_xla_varlen_sdpa`. Causal uses the
    flash-attention varlen convention, bottom-RIGHT alignment: q local
    position i sees k local positions <= i + (len_k - len_q)."""
    q_seg, q_loc, q_len = _unpack_cu(qcu, q.shape[0], q.device)
    k_seg, k_loc, k_len = _unpack_cu(kcu, k.shape[0], q.device)
    s = torch.einsum("thd,shd->hts", q.float(), k.float()) * scale
    mask = q_seg[:, None] == k_seg[None, :]
    if causal:
        mask = mask & (k_loc[None, :]
                       <= q_loc[:, None] + (k_len[None, :] - q_len[:, None]))
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    # a q row whose whole k side is masked (possible for degenerate cu
    # tables) would get a uniform softmax; zero it instead
    p = torch.where(mask.any(dim=1)[None, :, None], p, 0.0)
    return torch.einsum("hts,shd->thd", p, v.float()).to(q.dtype)


@register_op
def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                        fixed_seed_offset=None, attn_mask=None,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        is_test=False, rng_name=""):
    """Varlen attention over packed sequences: q [total_q, H, hd], k/v
    [total_k, KV, hd], cu_seqlens_* [B+1] int32. Identical packings run
    kernel A1 in segment-id mode (differentiable through A2); other
    packings the masked composition. Returns (out [total_q, H, hd],
    None, None, int64 zeros [2]), the phi signature with no softmax.

    Unsupported arguments are rejected here, before any compute:
    `return_softmax`, dropout outside `is_test`, and `attn_mask`."""
    if return_softmax:
        raise NotImplementedError("flash_attn_unpadded return_softmax=True: "
                                  "the softmax matrix is never materialized")
    if dropout > 0.0 and not is_test:
        raise NotImplementedError("flash_attn_unpadded dropout: the kernel "
                                  "has no in-kernel RNG; apply dropout "
                                  "outside or use is_test=True")
    if attn_mask is not None:
        raise NotImplementedError(
            "flash_attn_unpadded attn_mask: neither the segment-id kernel "
            "path nor the masked composition takes an additive mask over "
            "packed sequences; use dense flash attention")
    total_q, H, hd = q.shape
    total_k, KV = k.shape[0], k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    # the segment path needs q position t and k position t in the same
    # sequence: true only when the two packings are identical
    same_pack = total_q == total_k and (
        cu_seqlens_q is cu_seqlens_k
        or torch.equal(torch.as_tensor(cu_seqlens_q).cpu(),
                       torch.as_tensor(cu_seqlens_k).cpu()))
    if same_pack and FA.supported(H, KV, hd):
        seg = _unpack_cu(cu_seqlens_q, total_q, q.device)[0][None]
        o = FA.flash_attention(q[None], k[None], v[None], causal=causal,
                               sm_scale=float(scale), q_segment_ids=seg,
                               kv_segment_ids=seg)[0]
    else:
        if KV != H:                      # GQA on the composition
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
        o = _varlen_sdpa(q, k, v, cu_seqlens_q, cu_seqlens_k, float(scale),
                         causal)
    return o, None, None, torch.zeros(2, dtype=torch.int64, device=q.device)


@register_op
def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                fixed_seed_offset=None, attn_mask=None,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False,
                                return_softmax=False, is_test=False,
                                rng_name=""):
    """qkv [total, 2 + H/KV, KV, hd], paddle's packed-GQA layout: the
    first (H/KV)·KV rows are q heads, then k, then v."""
    total, g2, KV, hd = qkv.shape
    G = g2 - 2
    q = qkv[:, :G].reshape(total, G * KV, hd)
    k, v = qkv[:, G], qkv[:, G + 1]
    return flash_attn_unpadded(
        q, k, v, cu_seqlens_q, cu_seqlens_k, fixed_seed_offset, attn_mask,
        max_seqlen_q, max_seqlen_k, scale, dropout, causal, return_softmax,
        is_test, rng_name)


# ---------------------------------------------------------------------------
# rotary tables of the dense-cache serving ops
# ---------------------------------------------------------------------------

def _rope_pairwise(x, cos, sin, neox: bool):
    """Rotary embedding of x [..., hd] by cos/sin [..., hd/2], in f32:
    adjacent pairs (neox=False, paddle's default) or rotate-half."""
    x32 = x.float()
    hd = x.shape[-1]
    if neox:
        x1, x2 = x32[..., :hd // 2], x32[..., hd // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = x32[..., 0::2], x32[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x32.shape)
    return out.to(x.dtype)


def _rotary_table(rotary_t, hd):
    """(cos, sin) tables [Br, S, hd/2] f32 (Br 1 or B) from either layout
    the reference takes: a leading stack of 2 (cos over sin, the
    `rotary_embs` [2, B, 1, S, hd] form), or one tensor with cos in the
    even and sin in the odd lanes (the `rotary_tensor` [B, 1, 1, S, hd]
    form)."""
    rt = rotary_t.float()
    if rt.dim() >= 4 and rt.shape[0] == 2:
        cos_t = rt[0].reshape((-1,) + tuple(rt.shape[-2:]))
        sin_t = rt[1].reshape((-1,) + tuple(rt.shape[-2:]))
        return cos_t[..., :hd // 2], sin_t[..., :hd // 2]
    rt = rt.reshape((-1,) + tuple(rt.shape[-2:])) if rt.dim() > 2 \
        else rt[None]
    return rt[..., 0::2], rt[..., 1::2]


def _split_rotary(rotary_t, pos, hd):
    """(cos, sin) [B, hd/2] at one position a row, pos [B]."""
    cos_t, sin_t = _rotary_table(rotary_t, hd)
    if cos_t.shape[0] == 1:
        return cos_t[0][pos], sin_t[0][pos]
    b = torch.arange(pos.shape[0], device=pos.device)
    return cos_t[b, pos], sin_t[b, pos]


def _require_no_quant(**kwargs):
    set_args = [k for k, v in kwargs.items() if v is not None]
    if set_args:
        raise NotImplementedError(
            f"quantized-cache serving args not implemented: {set_args}; "
            "use the bf16 cache path")


# ---------------------------------------------------------------------------
# masked_multihead_attention_ (dense cache, one decode step)
# ---------------------------------------------------------------------------

@register_op
def masked_multihead_attention_(x, cache_kv=None, bias=None, src_mask=None,
                                cum_offsets=None, sequence_lengths=None,
                                rotary_tensor=None, beam_cache_offset=None,
                                qkv_out_scale=None, out_shift=None,
                                out_smooth=None, seq_len=1, rotary_emb_dims=0,
                                use_neox_rotary_style=False,
                                compute_dtype="default", out_scale=-1.0,
                                quant_round_type=1, quant_max_bound=127.0,
                                quant_min_bound=-127.0):
    """One decode step over a dense cache (`serving_attention.py:123` in
    the reference). x [B, 3·H·hd], the new token's fused qkv; cache_kv
    [2, B, H, max_seq, hd]; sequence_lengths [B(, 1)], the tokens already
    in the cache (the new one lands at that index). The new K/V rows are
    written into cache_kv in place, by index; the reference writes them
    with a one-hot product into a new cache. Returns (out [B, H·hd],
    cache_kv)."""
    _require_no_quant(qkv_out_scale=qkv_out_scale, out_shift=out_shift,
                      out_smooth=out_smooth)
    if beam_cache_offset is not None:
        raise NotImplementedError("beam search cache offsets: use the "
                                  "beam_search op family for decode beams")
    if cache_kv is None:
        raise ValueError("masked_multihead_attention_ requires cache_kv")
    _, B, H, S, hd = cache_kv.shape
    qkv = x.reshape(B, 3, H, hd)
    if bias is not None:
        qkv = qkv + bias.reshape(1, 3, H, hd).to(qkv.dtype)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]          # [B, H, hd]
    pos = (sequence_lengths.reshape(-1).long() if sequence_lengths is not None
           else torch.zeros(B, dtype=torch.long, device=x.device))
    if rotary_emb_dims and rotary_tensor is not None:
        cos, sin = _split_rotary(rotary_tensor, pos, hd)
        q = _rope_pairwise(q, cos[:, None], sin[:, None],
                           use_neox_rotary_style)
        k = _rope_pairwise(k, cos[:, None], sin[:, None],
                           use_neox_rotary_style)
    rows = torch.arange(B, device=x.device)
    with torch.no_grad():
        cache_kv[0, rows, :, pos] = k.to(cache_kv.dtype)
        cache_kv[1, rows, :, pos] = v.to(cache_kv.dtype)
    s = torch.einsum("bhd,bhsd->bhs", q.float(),
                     cache_kv[0].float()) * (1.0 / math.sqrt(hd))
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, :], s, -1e30)
    if src_mask is not None:
        s = s + src_mask.reshape(B, 1, -1)[..., :S].float()
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, cache_kv[1].float())
    return out.to(x.dtype).reshape(B, H * hd), cache_kv


# ---------------------------------------------------------------------------
# variable_length_memory_efficient_attention
# ---------------------------------------------------------------------------

@register_op
def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0):
    """Batched varlen attention (`serving_attention.py:317`): query [B, H,
    T, hd], key/value [B, KV, S, hd], seq_lens / kv_seq_lens [B(, 1)] the
    valid lengths; rows past a sequence's length come out 0. Bad
    arguments raise before any compute."""
    B, H, T, hd = query.shape
    KV, S = key.shape[1], key.shape[2]
    if KV <= 0 or H % KV != 0:
        raise ValueError(
            f"variable_length_memory_efficient_attention: {H} query heads "
            f"do not divide over {KV} kv heads; GQA needs H % KV == 0")
    pre_cache_length = int(pre_cache_length)
    if pre_cache_length < 0:
        raise ValueError(
            f"pre_cache_length must be >= 0, got {pre_cache_length}")
    if pre_cache_length and not causal:
        raise NotImplementedError(
            "variable_length_memory_efficient_attention pre_cache_length "
            "shifts the causal diagonal; without causal=True it would be "
            "ignored — pass causal=True or drop it")
    if KV != H:
        key = key.repeat_interleave(H // KV, dim=1)
        value = value.repeat_interleave(H // KV, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhtd,bhsd->bhts", query.float(), key.float()) * scale
    ql = seq_lens.reshape(B, 1, 1, 1).long()
    kl = kv_seq_lens.reshape(B, 1, 1, 1).long()
    rows = torch.arange(T, device=query.device).reshape(1, 1, T, 1)
    cols = torch.arange(S, device=query.device).reshape(1, 1, 1, S)
    valid = (rows < ql) & (cols < kl)
    if causal:
        valid = valid & (cols - pre_cache_length <= rows)
    s = torch.where(valid, s, -1e30)
    if mask is not None:
        s = s + mask.float()
    p = torch.where(rows < ql, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhts,bhsd->bhtd", p,
                        value.float()).to(query.dtype)


# ---------------------------------------------------------------------------
# fused_multi_transformer_ (the whole serving stack)
# ---------------------------------------------------------------------------

_MT_ACTS = {"gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
            "relu": torch.relu}


def _mt_norm(y, scale, bias, norm_type, epsilon):
    y32 = y.float()
    if norm_type == "rmsnorm":
        out = y32 * torch.rsqrt(y32.square().mean(-1, keepdim=True) + epsilon)
    else:
        mu = y32.mean(-1, keepdim=True)
        var = y32.var(-1, correction=0, keepdim=True)
        out = (y32 - mu) * torch.rsqrt(var + epsilon)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(y.dtype)


@register_op
def fused_multi_transformer_(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                             linear_weights, linear_biases, ffn_ln_scales,
                             ffn_ln_biases, ffn1_weights, ffn1_biases,
                             ffn2_weights, ffn2_biases, pre_layer_norm=True,
                             epsilon=1e-5, residual_alpha=1.0, cache_kvs=None,
                             beam_offset=None, pre_caches=None, seq_lens=None,
                             rotary_embs=None, time_step=None, attn_mask=None,
                             dropout_rate=0.0, rotary_emb_dims=0,
                             activation="gelu", training=False,
                             mode="upscale_in_train", trans_qkvw=True,
                             ring_id=-1, norm_type="layernorm",
                             use_neox_rotary_style=False, gqa_group_size=-1):
    """The serving transformer stack (`serving_attention.py:632`): each
    layer pre- or post-LN (layernorm or rmsnorm), qkv, cached attention,
    the out projection and residual, the FFN (gelu, relu or swiglu) and
    residual. time_step None is the prefill stage: causal attention over
    x [B, T, D], and cache positions 0..T-1 written (the rest zeroed);
    time_step set is one decode step through
    `masked_multihead_attention_` at that position. qkv_weights[i] is
    [3, H, hd, D], or [3·H·hd, D] with cache_kvs[i] [2, B, H, max_seq,
    hd] giving the heads. The caches are written in place. Returns (out,
    cache_kvs)."""
    if training or dropout_rate:
        raise NotImplementedError("fused_multi_transformer_ is the serving "
                                  "path; train with the regular layers")
    if beam_offset is not None or pre_caches is not None:
        raise NotImplementedError("beam/pre-cache serving not wired")
    if gqa_group_size and gqa_group_size > 0:
        raise NotImplementedError(
            "fused_multi_transformer_ gqa_group_size: the packed GQA weight "
            "layout is not wired; use the LLMPredictor path for GQA decode")
    if activation not in ("gelu", "relu", "swiglu"):
        raise ValueError(f"unknown activation {activation!r}")
    B, T, D = x.shape
    decode = time_step is not None

    def norm(y, scale, bias):
        return _mt_norm(y, scale, bias, norm_type, epsilon)

    new_caches = []
    h = x
    for i in range(len(qkv_weights)):
        w = qkv_weights[i]
        cache = cache_kvs[i] if cache_kvs is not None else None
        if w.dim() == 4:                       # [3, H, hd, D]
            _, H, hd, _ = w.shape
            qkvw = w.reshape(3 * H * hd, D)
        else:
            qkvw = w if trans_qkvw else w.t()  # [3·H·hd, D]
            if cache is None:
                raise ValueError("2-D qkv_weights need cache_kvs to carry "
                                 "the head layout; pass [3, H, hd, D] "
                                 "weights")
            H = cache.shape[2]
            hd = qkvw.shape[0] // 3 // H
        resid = h
        y = norm(h, ln_scales[i], ln_biases[i]) if pre_layer_norm else h
        qkv = y @ qkvw.t().to(y.dtype)         # [B, T, 3·H·hd]
        if decode:
            if cache is None:
                raise ValueError("decode stage needs cache_kvs")
            step_pos = torch.full((B,), int(time_step), dtype=torch.long,
                                  device=x.device)
            o, cache = masked_multihead_attention_._kernel(
                qkv.reshape(B, -1), cache,
                qkv_biases[i] if qkv_biases else None, attn_mask, None,
                step_pos, rotary_embs, None, rotary_emb_dims=rotary_emb_dims,
                use_neox_rotary_style=use_neox_rotary_style)
            attn_out = o.reshape(B, 1, H * hd)
        else:
            qkv5 = qkv.reshape(B, T, 3, H, hd)
            if qkv_biases:
                qkv5 = qkv5 + qkv_biases[i].reshape(1, 1, 3, H, hd).to(
                    qkv5.dtype)
            q, k, v = qkv5[:, :, 0], qkv5[:, :, 1], qkv5[:, :, 2]
            if rotary_emb_dims and rotary_embs is not None:
                cos_t, sin_t = _rotary_table(rotary_embs, hd)
                cos, sin = cos_t[:, :T, None], sin_t[:, :T, None]
                q = _rope_pairwise(q, cos, sin, use_neox_rotary_style)
                k = _rope_pairwise(k, cos, sin, use_neox_rotary_style)
            s = torch.einsum("bthd,bshd->bhts", q.float(),
                             k.float()) / math.sqrt(hd)
            causal = torch.ones((T, T), dtype=torch.bool,
                                device=x.device).tril()
            s = torch.where(causal[None, None], s, -1e30)
            if seq_lens is not None:
                sl = seq_lens.reshape(B, 1, 1, 1).long()
                s = torch.where(torch.arange(T, device=x.device).reshape(
                    1, 1, 1, T) < sl, s, -1e30)
            if attn_mask is not None:
                s = s + attn_mask.float()
            p = torch.softmax(s, dim=-1)
            attn_out = torch.einsum("bhts,bshd->bthd", p, v.float()).to(
                h.dtype).reshape(B, T, H * hd)
            if cache is not None:
                with torch.no_grad():
                    cache[0, :, :, :T] = k.transpose(1, 2).to(cache.dtype)
                    cache[1, :, :, :T] = v.transpose(1, 2).to(cache.dtype)
                    cache[:, :, :, T:] = 0
        new_caches.append(cache)
        attn_out = attn_out @ linear_weights[i].to(attn_out.dtype)
        if linear_biases and linear_biases[i] is not None:
            attn_out = attn_out + linear_biases[i].to(attn_out.dtype)
        h = resid * residual_alpha + attn_out
        if not pre_layer_norm:
            h = norm(h, ln_scales[i], ln_biases[i])
        resid = h
        y = norm(h, ffn_ln_scales[i], ffn_ln_biases[i]) if pre_layer_norm \
            else h
        f = y @ ffn1_weights[i].to(y.dtype)
        if ffn1_biases and ffn1_biases[i] is not None:
            f = f + ffn1_biases[i].to(f.dtype)
        if activation == "swiglu":
            g, u = f.chunk(2, dim=-1)
            f = torch.nn.functional.silu(g) * u
        else:
            f = _MT_ACTS[activation](f)
        f = f @ ffn2_weights[i].to(f.dtype)
        if ffn2_biases and ffn2_biases[i] is not None:
            f = f + ffn2_biases[i].to(f.dtype)
        h = resid * residual_alpha + f
        if not pre_layer_norm:
            h = norm(h, ffn_ln_scales[i], ffn_ln_biases[i])
    return h, new_caches
