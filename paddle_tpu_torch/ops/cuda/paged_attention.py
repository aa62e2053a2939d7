"""Kernel A5: paged-KV attention over the block pool, fp and int8 pages.

Replaces `paddle_tpu/ops/pallas/paged_attention.py:162 paged_attention`
(`_kernel` :88, `pl.pallas_call` :249): fp pages (`KERNEL`,
`csrc/paged_attention.cu`) and, with `k_dequant`/`v_dequant`, the int8
pages of the reference's `has_quant` mode (`KERNEL_INT8`,
`csrc/paged_attention_int8.cu`). Both instantiate one template,
`csrc/paged_attention.cuh`, and each has its own launch count, by path:
"mma" (bf16 q, tensor cores) or "fma" (f32 q, CUDA cores).

Bound on the H100: bytes. A decode launch (`max_q = 1`) reads every live
cached token's K and V once, 16 KiB per token per layer at LLaMA-7B in
bf16 (2 sides x 32 heads x 128 x 2 B), 8 KiB with int8 pages, against
4·hd FLOPs per (row, token) — two orders of magnitude below the card's
~295 FLOP/B ridge.

Design of the bf16-q kernel (`csrc/paged_attention.cuh`, `paged::`):
- a row's bits depend only on its position and its sequence's pages:
  every unit of work is a group of at most 8 rows of one sequence, its
  positions cut at fixed absolute spans (`paged_splits(...).span`, whole
  pages, at least 256), each span's keys split across the four warps and
  folded in warp order, the spans merged in ascending order; so a token
  gets the same output as a decode row, in a speculative verify chunk,
  in any prefill chunk and on recompute;
- a chunk of at most `part_rows` live rows (decode rows, verify chunks)
  whose last row reaches a second span gives each span its own block and
  a second kernel of the library merges the f32 partials, planned from
  host-known shapes only (no device value is read, nothing synchronizes)
  so that they stay within a tenth of the K/V bytes they split; any other
  row group walks its spans in one block and merges them there, with the
  same steps;
- pages in their own type (bf16, or int8 widened at use) in a cp.async
  ring of 64-key stages, a span's table entries staged once; a launch of
  at most 8 rows a sequence takes the decode instantiation (three blocks
  an SM); a grid of at most four waves of resident blocks loops over the
  units of work, level by level, so its size does not follow max_len;
- S^T = K Q^T and O^T = V^T P^T on the tensor cores (mma.sync m16n8k16,
  rows as N in 8-row groups), P as a bf16 hi + lo pair, the softmax
  state in registers.
Dead rows — pad rows of a mixed launch, which pads every sequence to
`token_num` rows, and idle batch slots — are zeroed once and skip the
walk. With int8 pages each page's k
and v dequant scalars ([num_blocks, KV] f32) fold into the scores
(`sm_scale * kdq`) and into the probabilities after the running sum is
updated (`vdq`), as the reference folds them; no fp copy of the cache
exists. f32 q keeps the CUDA-core kernel (one block per sequence and kv
head, keys staged as f32).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import build
from .build import FLOAT, INT, PTR

__all__ = ["paged_attention", "paged_attention_plain", "supported",
           "PagedPlan", "paged_splits", "split_rows", "partial_bytes",
           "paged_attention_split_model", "KERNEL", "KERNEL_INT8"]

_ARGS = [INT] * 10 + [FLOAT, INT, PTR]     # B .. part_rows, sm_scale, dtype, stream
KERNEL = build.Kernel(
    "paged_attention",
    {"paged_attention_fwd": [PTR] * 8 + _ARGS,
     "paged_attention_smem": [INT, INT]},
    replaces="paddle_tpu/ops/pallas/paged_attention.py:162")
KERNEL_INT8 = build.Kernel(
    "paged_attention_int8",
    {"paged_attention_int8_fwd": [PTR] * 10 + _ARGS,
     "paged_attention_int8_smem": [INT, INT]},
    replaces="paddle_tpu/ops/pallas/paged_attention.py:162")

_MAX_SMEM = 232448          # bytes of shared memory one H100 block may use
_ROW_CHUNK, _KEYS_PER_ITER = 32, 64   # mirrors the f32 kernel's tiles
# the split policy: spans of at least 256 positions for G <= 8; chunks of
# at most _PART_ROWS rows may split across blocks, their partials at most
# 1/_TRAFFIC of the K/V bytes they split
_SPAN_MIN, _PART_ROWS, _TRAFFIC = 256, 8, 10


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
    whole, and the f32 kernel's staged tile inside one block's shared
    memory; the same for fp and int8 pages. The bf16 kernel's shared
    memory does not depend on the page size, so it takes every geometry
    this admits.)"""
    return (num_kv_heads > 0 and num_heads % num_kv_heads == 0
            and head_dim % 8 == 0 and 8 <= head_dim <= 256
            and block_size >= 1
            and _smem_bytes(head_dim, block_size) <= _MAX_SMEM)


class PagedPlan(NamedTuple):
    span: int            # positions a span: whole pages, at least 256
    splits: int          # spans of a table row (1: no spans)
    part_rows: int       # live rows a chunk may hold and split (0: none)
    scratch_floats: int  # f32 partials the wrapper allocates


def _tenth_rows(span: int, hd: int, elem: int) -> int:
    """The most rows whose partials stay within 1/_TRAFFIC of the K/V
    bytes of a chunk that splits at `span`: 80 rows (hd + 2) <= (span + 1)
    hd elem (see `paged_splits`)."""
    return (span + 1) * hd * elem // (_TRAFFIC * 8 * (hd + 2))


def paged_splits(group: int, hd: int, bs: int, max_blocks: int, B: int,
                 KV: int, elem: int) -> PagedPlan:
    """The bf16 kernel's spans and its split of them across blocks, from
    host-known shapes only (elem: bytes of a page element, 2 for bf16
    pages, 1 for int8).

    Spans sit at fixed absolute positions, multiples of `span`, and every
    row merges its own spans in ascending order, in whatever chunk it
    sits, so the spans decide a row's bits and the split only where the
    work runs. G <= 8 has spans; G > 8 one span, the whole table. A chunk
    of at most `part_rows` live rows (`split_rows`: once its last row
    reaches a second span) gives each span its own block; the scratch
    holds (m, l, acc[hd]) f32 for B x KV x splits x part_rows rows. A
    chunk of R rows reaching n = (past + this - 1) // span + 1 spans,
    n / (past + this) <= 2 / (span + 1), writes and reads R x n x (hd + 2)
    f32 of partials, within a tenth of its K/V bytes, (past + this) x 2 x
    hd x elem, when 80 R (hd + 2) <= (span + 1) hd elem. The span is the
    fewest whole pages, at least 256 positions, that meet this for R = G
    (a decode row), and part_rows the most whole tokens' rows, at most 8,
    that it meets; this function is where the policy lives: the kernel
    takes span, splits and part_rows and asks only past + this - 1 >=
    span."""
    need = -(-_TRAFFIC * 8 * group * (hd + 2) // (hd * elem)) - 1
    span = bs * -(-max(_SPAN_MIN, need) // bs)
    splits = -(-(max_blocks * bs) // span) if group <= _PART_ROWS else 1
    rows = min(_PART_ROWS, _tenth_rows(span, hd, elem)) // group * group
    part_rows = rows if splits > 1 else 0
    return PagedPlan(span, splits, part_rows,
                     B * KV * splits * part_rows * (hd + 2))


def split_rows(past: int, this: int, plan: PagedPlan,
               group: int = 1) -> bool:
    """Does a sequence's chunk split its spans across blocks? A chunk of
    at most part_rows live rows (this x group: decode rows, speculative
    verify chunks) under a plan with spans, whose last row reaches a
    second span: the test the kernel makes on the card (`split_seq` in
    the header)."""
    last = past + this - 1
    return (plan.splits > 1 and this >= 1 and this * group <= plan.part_rows
            and last >= plan.span and last // plan.span < plan.splits)


def partial_bytes(past, this, group: int, hd: int, KV: int,
                  plan: PagedPlan) -> int:
    """Bytes of partials a launch writes and reads, as planned: each split
    chunk writes (m, l, acc) f32 for its rows and each span its last row
    reaches once, and the merge reads them once."""
    return sum(2 * KV * int(t) * group
               * ((int(p) + int(t) - 1) // plan.span + 1) * (hd + 2) * 4
               for p, t in zip(past, this)
               if split_rows(int(p), int(t), plan, group))


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
    mma = q_rows.dtype == torch.bfloat16
    mb = block_tables.shape[1]
    plan = (paged_splits(group, hd, bs, mb, B, KV, key_cache.element_size())
            if mma else PagedPlan(0, 1, 0, 0))
    part = (torch.empty(plan.scratch_floats, dtype=torch.float32,
                        device=q_rows.device) if plan.scratch_floats
            else None)
    out = torch.empty_like(q_rows)
    tail = (block_tables.data_ptr(), seq_lens_decoder.data_ptr(),
            seq_lens_this_time.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), B, KV, rows, hd, bs,
            mb, group, plan.span, plan.splits, plan.part_rows,
            float(sm_scale), dtype, stream)
    head = (q_rows.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            *(t.data_ptr() for t in scales))
    err = kernel.fn(f"{kernel.name}_fwd")(*head, *tail)
    kernel.check(err)
    kernel.count("mma" if mma else "fma")
    return out


def paged_attention_split_model(q_rows, key_cache, value_cache, block_tables,
                                seq_lens_decoder, seq_lens_this_time,
                                group: int, sm_scale: float, k_dequant=None,
                                v_dequant=None, span=None,
                                split_all: bool = False):
    """A CPU model, in f32, of the bf16 kernel's span arithmetic; the
    tests hold it against the reference. Under a plan with spans
    (`paged_splits`; `span` overrides the plan's, `split_all` gives spans
    where the plan has none), every live row gets, for each span up to
    its own position, the span's m (its largest score), l (its sum of
    exp(score - m)) and acc (the sum of exp(score - m) v, the int8 pages'
    v multiplier applied after l), merged in ascending order: (M, L, O)
    starts from span 0 and takes span s by a = exp(M - max), f = exp(m_s -
    max), L = L a + l_s f, O = O a + acc_s f; out = O / L. Without spans a
    row has one span, the whole table. Same arguments and result (in
    f32) as `paged_attention`."""
    B, KV, rows, hd = q_rows.shape
    bs = key_cache.shape[2]
    mb = block_tables.shape[1]
    S = mb * bs
    plan = paged_splits(group, hd, bs, mb, B, KV, key_cache.element_size())
    if span is not None:
        plan = plan._replace(span=span, splits=-(-S // span))
    width = plan.span if (split_all or plan.splits > 1) else S
    tables = block_tables.long().clamp(min=0)
    k = key_cache[tables].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    v = value_cache[tables].permute(0, 2, 1, 3, 4).reshape(B, KV, S, hd)
    s = torch.einsum("bkrd,bksd->bkrs", q_rows.float(), k.float())
    vmul = torch.ones(B, KV, 1, S)
    if k_dequant is not None:
        def per_key(dq):                            # [nb, KV] -> [B, KV, 1, S]
            return dq.float()[tables].repeat_interleave(bs, dim=1) \
                .permute(0, 2, 1)[:, :, None, :]
        s = s * (sm_scale * per_key(k_dequant))
        vmul = per_key(v_dequant)
    else:
        s = s * sm_scale
    t = torch.arange(rows) // group
    past = [int(x) for x in seq_lens_decoder.reshape(-1)]
    this = [int(x) for x in seq_lens_this_time.reshape(-1)]
    n = -(-S // width)
    pad = n * width - S
    out = torch.zeros(B, KV, rows, hd)
    for b in range(B):
        ok = torch.arange(S)[None, :] <= past[b] + t[:, None]   # [rows, S]
        sb = torch.nn.functional.pad(s[b].masked_fill(~ok, float("-inf")),
                                     (0, pad), value=float("-inf"))
        sb = sb.reshape(KV, rows, n, width)
        m = sb.amax(-1)                                      # [KV, rows, n]
        p = torch.where(torch.isfinite(m)[..., None],
                        torch.exp(sb - m[..., None]), 0.0)
        l = p.sum(-1)
        pv = p * torch.nn.functional.pad(vmul[b], (0, pad)).reshape(
            KV, 1, n, width)
        vb = torch.nn.functional.pad(v[b].float(), (0, 0, 0, pad)).reshape(
            KV, n, width, hd)
        acc = torch.einsum("krnw,knwd->krnd", pv, vb)
        for r in range(rows):
            if t[r] >= this[b]:
                continue                                     # a dead row: 0
            M, L, O = m[:, r, 0], l[:, r, 0], acc[:, r, 0]
            for j in range(1, (past[b] + int(t[r])) // width + 1):
                Mn = torch.maximum(M, m[:, r, j])
                a, f = torch.exp(M - Mn), torch.exp(m[:, r, j] - Mn)
                L = L * a + l[:, r, j] * f
                O = O * a[:, None] + acc[:, r, j] * f[:, None]
                M = Mn
            out[b, :, r] = O / L[:, None]
    return out
