"""Kernel A5: paged-KV attention over the block pool, fp and int8 pages.

Replaces `paddle_tpu/ops/pallas/paged_attention.py:162 paged_attention`
(`_kernel` :88, `pl.pallas_call` :249): fp pages (`KERNEL`,
`csrc/paged_attention.cu`) and, with `k_dequant`/`v_dequant`, the int8
pages of the reference's `has_quant` mode (`KERNEL_INT8`,
`csrc/paged_attention_int8.cu`). Both instantiate one page walk,
`csrc/paged_attention.cuh`, and each has its own launch count.

Bound on the H100: bytes. A decode launch (`max_q = 1`) reads every live
cached token's K and V once, 16 KiB per token per layer at LLaMA-7B in
bf16 (2 sides x 32 heads x 128 x 2 B), 8 KiB with int8 pages, against
4·hd FLOPs per (row, token) — two orders of magnitude below the card's
~295 FLOP/B ridge.

Design (`csrc/paged_attention.cuh`): one block per (sequence, kv head)
walks that sequence's block-table row itself and stops at the last page
its live rows can see, so table entries of -1 are never read. Keys are
staged 64 at a time in shared memory as f32; scores, a warp-per-row
online softmax and the P·V accumulate run in f32. Dead rows — pad rows
of a mixed launch, which pads every sequence to `token_num` rows, and
idle batch slots — are zeroed once and skip the page walk, so they cost
only their stores. The same kernel serves decode (`max_q = 1`) and mixed
launches. With int8 pages each page's k and v dequant scalars ([num_blocks,
KV] f32) fold into the score tile (`sm_scale * kdq`) and into the
probabilities after the running sum is updated (`vdq`), as the reference
folds them; no fp copy of the cache exists.
"""
from __future__ import annotations

import torch

from . import build
from .build import FLOAT, INT, PTR

__all__ = ["paged_attention", "paged_attention_plain", "supported", "KERNEL",
           "KERNEL_INT8"]

KERNEL = build.Kernel(
    "paged_attention",
    {"paged_attention_fwd": [PTR] * 7 + [INT] * 7 + [FLOAT, INT, PTR]},
    replaces="paddle_tpu/ops/pallas/paged_attention.py:162")
KERNEL_INT8 = build.Kernel(
    "paged_attention_int8",
    {"paged_attention_int8_fwd": [PTR] * 9 + [INT] * 7 + [FLOAT, INT, PTR]},
    replaces="paddle_tpu/ops/pallas/paged_attention.py:162")

_MAX_SMEM = 232448          # bytes of shared memory one H100 block may use
_ROW_CHUNK, _KEYS_PER_ITER = 32, 64   # mirrors csrc/paged_attention.cuh


def _smem_bytes(head_dim: int, block_size: int) -> int:
    kpi = (block_size if block_size >= _KEYS_PER_ITER
           else (_KEYS_PER_ITER // block_size) * block_size)
    rc = _ROW_CHUNK
    return 4 * (2 * kpi * (head_dim + 8) + 2 * rc * head_dim + rc * kpi
                + 3 * rc + 2 * (kpi // block_size))


def supported(num_heads: int, num_kv_heads: int, head_dim: int,
              block_size: int) -> bool:
    """Can the CUDA kernels serve this head/page geometry? (head_dim a
    multiple of 8 up to 256 for page loads of 8 elements, GQA groups
    whole, and the staged tile inside one block's shared memory; the
    same for fp and int8 pages.)"""
    return (num_kv_heads > 0 and num_heads % num_kv_heads == 0
            and head_dim % 8 == 0 and 8 <= head_dim <= 256
            and block_size >= 1
            and _smem_bytes(head_dim, block_size) <= _MAX_SMEM)


def paged_attention_plain(q_rows, key_cache, value_cache, block_tables,
                          seq_lens_decoder, seq_lens_this_time, group: int,
                          sm_scale: float, k_dequant=None, v_dequant=None):
    """Plain PyTorch version: gather each sequence's pages densely, mask
    `kv_pos <= past + t` per row r = t*G + g, softmax in f32. Rows with
    t >= this come back 0. With int8 pages, each key's page scale
    multiplies its scores (`sm_scale * kdq`) and its probabilities after
    the softmax (`vdq`). Same arguments and result as the kernel."""
    B, KV, rows, hd = q_rows.shape
    bs = key_cache.shape[2]
    mb = block_tables.shape[1]
    tables = block_tables.long().clamp(min=0)     # -1 entries: masked below
    k = key_cache[tables].permute(0, 2, 1, 3, 4).reshape(B, KV, mb * bs, hd)
    v = value_cache[tables].permute(0, 2, 1, 3, 4).reshape(B, KV, mb * bs,
                                                           hd)
    s = torch.einsum("bkrd,bksd->bkrs", q_rows.float(), k.float())
    quant = k_dequant is not None
    if quant:
        def per_key(dq):                            # [nb, KV] -> [B, KV, 1, S]
            return dq.float()[tables].repeat_interleave(bs, dim=1) \
                .permute(0, 2, 1)[:, :, None, :]
        s = s * (sm_scale * per_key(k_dequant))
    else:
        s = s * sm_scale
    dev = q_rows.device
    t = torch.arange(rows, device=dev) // group                     # [rows]
    past = seq_lens_decoder.reshape(-1).long()
    this = seq_lens_this_time.reshape(-1).long()
    kv_pos = torch.arange(mb * bs, device=dev)
    ok = kv_pos[None, None, :] <= (past[:, None, None] + t[None, :, None])
    live = t[None, :] < this[:, None]                               # [B, rows]
    s = s.masked_fill(~ok[:, None], float("-inf"))
    s = torch.where(live[:, None, :, None], s, 0.0)   # dead rows: no NaN
    p = torch.softmax(s, dim=-1)
    if quant:
        p = p * per_key(v_dequant)
    o = torch.einsum("bkrs,bksd->bkrd", p, v.float())
    return torch.where(live[:, None, :, None], o, 0.0).to(q_rows.dtype)


def paged_attention(q_rows, key_cache, value_cache, block_tables,
                    seq_lens_decoder, seq_lens_this_time, group: int,
                    sm_scale: float, k_dequant=None, v_dequant=None):
    """Attention over paged caches, block table walked in the kernel.

    q_rows [B, KV, max_q * G, hd] (row r = t * G + g); key_cache /
    value_cache [num_blocks, KV, block_size, hd] already holding this
    step's tokens; block_tables [B, max_blocks] int32 (-1 = unused);
    seq_lens_decoder / seq_lens_this_time [B] int32 past/this lengths.
    k_dequant / v_dequant [num_blocks, KV] f32 (both or neither) select
    the int8-page mode: caches int8, each page's scores and
    probabilities scaled by its page's scalars. Returns
    [B, KV, max_q * G, hd] in q_rows.dtype, dead rows 0.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if (k_dequant is None) != (v_dequant is None):
        raise ValueError("pass both k_dequant and v_dequant or neither")
    quant = k_dequant is not None
    if q_rows.device.type == "cpu":
        return paged_attention_plain(q_rows, key_cache, value_cache,
                                     block_tables, seq_lens_decoder,
                                     seq_lens_this_time, group, sm_scale,
                                     k_dequant, v_dequant)
    B, KV, rows, hd = q_rows.shape
    nb, KVc, bs, hdc = key_cache.shape
    if (KVc, hdc) != (KV, hd) or value_cache.shape != key_cache.shape:
        raise ValueError(f"cache {tuple(key_cache.shape)} does not match q "
                         f"rows {tuple(q_rows.shape)}")
    if rows % group or not supported(KV * group, KV, hd, bs):
        raise ValueError(f"unsupported paged-attention geometry rows={rows} "
                         f"G={group} hd={hd} block_size={bs}")
    dtype = build.DTYPE_CODE.get(q_rows.dtype)
    page_dtype = torch.int8 if quant else q_rows.dtype
    if dtype is None or key_cache.dtype != page_dtype \
            or value_cache.dtype != page_dtype:
        raise ValueError(f"paged attention takes float32 or bfloat16 q and "
                         f"caches of q's type, or int8 caches with both "
                         f"dequant arrays; got {q_rows.dtype}, "
                         f"{key_cache.dtype}, {value_cache.dtype}, "
                         f"dequant {'given' if quant else 'none'}")
    if quant:
        for name, t in (("k_dequant", k_dequant), ("v_dequant", v_dequant)):
            if t.dtype != torch.float32 or t.shape != (nb, KV):
                raise ValueError(f"{name} must be float32 [num_blocks, KV]="
                                 f"{(nb, KV)}; got {t.dtype} "
                                 f"{tuple(t.shape)}")
    for name, t in (("block_tables", block_tables),
                    ("seq_lens_decoder", seq_lens_decoder),
                    ("seq_lens_this_time", seq_lens_this_time)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if block_tables.shape[0] != B or seq_lens_decoder.numel() != B \
            or seq_lens_this_time.numel() != B:
        raise ValueError("block_tables and the length vectors need one row "
                         "per sequence of q_rows")
    kernel = KERNEL_INT8 if quant else KERNEL
    scales = (k_dequant, v_dequant) if quant else ()
    stream = build.launch_stream(kernel.name, q_rows, key_cache,
                                 value_cache, *scales, block_tables,
                                 seq_lens_decoder, seq_lens_this_time)
    out = torch.empty_like(q_rows)
    tail = (block_tables.data_ptr(), seq_lens_decoder.data_ptr(),
            seq_lens_this_time.data_ptr(), out.data_ptr(), B, KV, rows, hd,
            bs, block_tables.shape[1], group, float(sm_scale), dtype, stream)
    head = (q_rows.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            *(t.data_ptr() for t in scales))
    err = kernel.fn(f"{kernel.name}_fwd")(*head, *tail)
    kernel.check(err)
    kernel.launches += 1
    return out
