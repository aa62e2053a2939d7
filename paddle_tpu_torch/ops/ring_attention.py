"""Ring attention and Ulysses attention over a group of ranks — the port
of `paddle_tpu/ops/ring_attention.py`.

- `ring_attention_shard(q, k, v, group, causal)` (reference :59): this
  rank's sequence block q [B, Tl, H, D], k / v [B, Tl, KV, D]; K/V
  blocks rotate around the group's ring (`mesh.shift`: batched sends
  and receives, backward the inverse rotation), the softmax runs online
  in f32, GQA repeats K/V heads only after a block has arrived, so the
  wire carries KV heads, and the causal mask is by global position.
- `sep_attention_shard(q, k, v, group, causal)` (reference :122):
  Ulysses, an all_to_all from sequence blocks to head blocks around one
  dense attention over the whole sequence, and back.
- `ring_attention(q, k, v, group=None, causal=True, impl="ring")`
  (reference :160), the eager form: every rank passes the whole q / k /
  v; the sequence is cut over the group, each rank runs its block's
  schedule and every rank gets the whole output back (the reference's
  global array). Each rank's gradients are the whole tensors' too. A
  group of one runs the dense attention.

A group is a `distributed.collective.Group`: a mesh axis
(`mesh.axis("cp")`) or any other, where the reference takes an axis
name. The reference has no Pallas kernel here (`:42-57`): the blocks are
torch einsums in f32.
"""
from __future__ import annotations

import torch

from ..distributed import mesh as M

__all__ = ["ring_attention_shard", "sep_attention_shard", "ring_attention"]

_NEG_INF = -1e30


def _block_attend(q, k, v, scale, mask):
    """One [B,Tq,H,D] x [B,Tk,H,D] block -> (pv, row_max, row_sum), the
    running-softmax statistics, in f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1)                             # [B,H,Tq]
    p = torch.exp(s - m[..., None])
    if mask is not None:
        # a row with every key masked: exp(0) = 1 where it must be 0
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)                              # [B,H,Tq]
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return pv, m, l


def _rows(t):
    """[B, H, T] statistics as [B, T, H, 1], to scale [B, T, H, D]."""
    return t[..., None].permute(0, 2, 1, 3)


def ring_attention_shard(q, k, v, group, causal: bool = True, scale=None):
    """Blockwise ring attention on this rank's sequence block q
    [B, Tl, H, D] and k / v [B, Tl, KV, D] (GQA when KV < H, H % KV ==
    0); blocks are rank-ordered along the sequence. Returns [B, Tl, H, D]
    in q's type."""
    n, me = group.nranks, group.rank
    B, Tl, H, D = q.shape
    G = H // k.shape[2]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float()
    q_pos = me * Tl + torch.arange(Tl, device=q.device)
    kb, vb = k, v
    acc = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    m_run = torch.full((B, H, Tl), _NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    for s in range(n):
        mask = None
        if causal:
            k_pos = ((me - s) % n) * Tl + torch.arange(Tl, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        kf, vf = kb, vb
        if G > 1:      # local head expansion after the ring transfer
            kf = kb.repeat_interleave(G, dim=2)
            vf = vb.repeat_interleave(G, dim=2)
        pv, m_blk, l_blk = _block_attend(qf, kf.float(), vf, scale, mask)
        m_new = torch.maximum(m_run, m_blk)
        corr = torch.exp(m_run - m_new)
        blk = torch.exp(m_blk - m_new)
        acc = acc * _rows(corr) + pv * _rows(blk)
        l_run = l_run * corr + l_blk * blk
        m_run = m_new
        if s != n - 1:
            # the last block's rotation would only be discarded
            kb = M.shift(kb, group, 1)
            vb = M.shift(vb, group, 1)
    l_safe = torch.where(l_run == 0.0, 1.0, l_run)
    return (acc / _rows(l_safe)).to(q.dtype)


def _dense(q, k, v, causal, scale=None):
    """Whole-sequence attention in f32 (GQA heads repeated locally)."""
    T, H, D = q.shape[1], q.shape[2], q.shape[3]
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    mask = (torch.tril(torch.ones((T, T), dtype=torch.bool,
                                  device=q.device))[None, None]
            if causal else None)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    pv, _, l = _block_attend(q.float(), k.float(), v, scale, mask)
    return (pv / _rows(torch.where(l == 0, 1.0, l))).to(q.dtype)


def sep_attention_shard(q, k, v, group, causal: bool = True, scale=None):
    """Ulysses attention: all_to_all from sequence blocks [B, Tl, H, D]
    to head blocks [B, T, H/n, D], dense attention over the whole
    sequence, all_to_all back. H (and KV) divisible by the group's
    size."""
    def seq2head(x):
        return M.all_to_all(x, group, split_axis=2, concat_axis=1)

    out = _dense(seq2head(q), seq2head(k), seq2head(v), causal, scale)
    return M.all_to_all(out.to(q.dtype), group, split_axis=1, concat_axis=2)


def ring_attention(q, k, v, group=None, causal: bool = True,
                   impl: str = "ring"):
    """Context-parallel attention over `group` (default: the default
    group) from whole tensors: q / k / v [B, T, H, D] on every rank, T
    divisible by the group's size. impl "ring" or "sep". Port Tensors in,
    a port Tensor out; torch tensors in, a torch tensor out."""
    from ..distributed import collective as C
    from .dispatch import call_op

    if impl not in ("ring", "sep"):
        raise ValueError(f"impl must be 'ring' or 'sep', got {impl!r}")

    def kernel(qa, ka, va):
        g = group if group is not None else C._default_group(qa.device.type)
        if g.nranks <= 1:
            return _dense(qa, ka, va, causal)
        fn = ring_attention_shard if impl == "ring" else sep_attention_shard
        blocks = [M.split(t, g, dim=1) for t in (qa, ka, va)]
        return M.gather_replicated(fn(*blocks, g, causal=causal), g, dim=1)

    return call_op("ring_attention", kernel, (q, k, v), {})
