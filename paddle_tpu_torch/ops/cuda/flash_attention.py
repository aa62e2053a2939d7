"""Kernels A1 and A2: flash attention forward and backward.

Replaces `paddle_tpu/ops/pallas/flash_attention.py`: A1 is `_fwd` :216
(`_fwd_kernel` :153, `pl.pallas_call` :264), A2 is `_bwd` :381
(`_dq_kernel` :280 and `_dkv_kernel` :326, `pl.pallas_call` :414 and
:459). The training step reaches them through
`llama.attention`. `flash_attention_op` registers A1 as a torch op whose
backward is A2 (`flash_attention_bwd_op`), the counterpart of the
reference's `custom_vjp` (:483); being a dispatcher op, it is what the
train step's `remat="dots"` policy names to save A1's outputs. Segment mode
(int32 ids, packed variable-length sequences) serves
`flash_attn_unpadded` (`ops/kernels/serving_attention.py`).

Bound on the H100: operations. At B = 2, T = 2048, H = 32, hd = 128,
causal, A1 takes 68.7 GFLOP (0.070 ms at 989 TFLOP/s in bf16); A2 needs
five products per visible pair, 171.9 GFLOP (0.174 ms), and its kernels
do seven: each recomputes q·kᵀ and dO·vᵀ. In bf16, P and dS enter two
products each (hi and lo), so the forward does three product units a
tile pair and the backward ten.

Design (`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`,
`csrc/flash_sm90.cuh`): the TPU kernels carry the running softmax
statistics and the gradient sums across a sequential grid axis; GPU
blocks run in parallel, so each block walks its own loop instead. The
forward and dq: one block per (batch, head, 64-row q tile), looping over
64-key kv tiles up to the diagonal. dk/dv: one block per (batch, kv
head, 64-key kv tile), looping over the G q heads of its group and the q
tiles from the diagonal on. Nothing crosses blocks — no atomics, so a
recomputed forward (activation checkpointing) gives the same output and
the gradients repeat bit for bit.

bf16 runs on the tensor cores: each block is one consumer warpgroup,
whose products are `wgmma`s over bf16 tiles in shared memory (128-byte
swizzle), and one producer warp that fills a two-stage ring of tiles
with TMA loads counted on mbarriers, so the next tile's copy overlaps
this tile's products. Score tiles stay in registers and enter the next
product as its A operand; P and dS go in as bf16 pairs hi + lo, so the
products keep the f32 reference's precision. A head_dim that is
a multiple of 8 but not of 64 is zero-padded in shared memory. f32 keeps
the CUDA-core kernels (FMAs on f32 tiles), so the f32 agreement is not
in TF32 or bf16.

``delta = rowsum(dO * O)`` stays a plain torch op before the backward
launch, as the reference leaves it to XLA. `lse` is [B, H, T] f32; the
reference's 8-lane broadcast of it is a Mosaic tiling artifact. In
segment mode the kernels add `seg_q[row] == seg_k[col]` to the mask of
every loop (forward, dq, dk/dv) and skip the tiles whose ids' [min, max]
does not overlap the resident tile's (right for any ids; `tile_walk`
lists the pairs walked, and a caller's `walked` buffer reads each
block's count off the card); the ids are inputs of the op that take
no gradient.

`supported()` states this kernel's own limits; the reference's
`_pick_block` rule does not carry over, and any T runs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .build import FLOAT, INT, PTR

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "flash_attention_op", "flash_attention_bwd_op", "supported",
           "tile_walk", "walk_slots",
           "KERNEL_FWD", "KERNEL_BWD", "TILE"]

KERNEL_FWD = build.Kernel(
    "flash_attention",
    {"flash_attention_fwd": [PTR] * 7 + [INT] * 7 + [FLOAT, INT, PTR, PTR],
     "flash_attention_fwd_smem": [INT], "flash_attention_fwd_products": []},
    replaces="paddle_tpu/ops/pallas/flash_attention.py:216")
KERNEL_BWD = build.Kernel(
    "flash_attention_bwd",
    {"flash_attention_bwd": [PTR] * 11 + [INT] * 7 + [FLOAT, INT, PTR, PTR],
     "flash_attention_bwd_smem": [INT, INT],
     "flash_attention_bwd_products": [INT]},
    replaces="paddle_tpu/ops/pallas/flash_attention.py:381")

_MAX_HEAD_DIM = 128          # mirrors kMaxHD in csrc/flash_tiles.cuh
TILE = 64                    # q and kv tile rows of every kernel (kRows)


def supported(num_heads: int, num_kv_heads: int, head_dim: int) -> bool:
    """Can the CUDA kernels serve this head geometry? GQA groups whole,
    head_dim a multiple of 8 (16-byte loads) up to 128 (the shared
    tiles); any sequence length runs — the kernels mask ragged tiles."""
    return (num_kv_heads > 0 and num_heads % num_kv_heads == 0
            and head_dim % 8 == 0 and 8 <= head_dim <= _MAX_HEAD_DIM)


def tile_walk(T: int, S: Optional[int] = None, causal: bool = True,
              q_seg=None, kv_seg=None, q_tile: int = TILE,
              kv_tile: int = TILE):
    """(walked, triangle): the (q tile, kv tile) index pairs a kernel with
    these tile sizes walks for one batch row and one head, and how many
    pairs the causal triangle (or, non-causal, the whole grid) holds.
    With segment ids (int sequences or tensors of one batch row, T and S
    long) a pair is walked only when the two tiles' [min, max] of ids
    overlap, the kernels' skip test; without them every pair of the
    triangle is walked."""
    S = T if S is None else S
    nq, nk = -(-T // q_tile), -(-S // kv_tile)

    def ranges(ids, n, tile):
        ids = [int(i) for i in ids]
        return [(min(ids[a:a + tile]), max(ids[a:a + tile]))
                for a in range(0, n, tile)]

    qr = None if q_seg is None else ranges(q_seg, T, q_tile)
    kr = None if kv_seg is None else ranges(kv_seg, S, kv_tile)
    walked, triangle = [], 0
    for i in range(nq):
        # keys past the tile's last row are masked under the causal mask
        last = min(nk, (min((i + 1) * q_tile, T) - 1) // kv_tile + 1) \
            if causal else nk
        triangle += last
        walked += [(i, j) for j in range(last) if qr is None
                   or (kr[j][0] <= qr[i][1] and qr[i][0] <= kr[j][1])]
    return walked, triangle


def walk_slots(B: int, H: int, KV: int, T: int, S: Optional[int] = None):
    """(forward, backward): the int32 entries of a `walked` buffer, one a
    block, in which the kernels record how many tiles each block walked.
    The forward's blocks are (batch, head, q tile); the backward's dq
    blocks, alike, come first, then its dk/dv blocks (batch, kv head, kv
    tile), so each part sums to the tile pairs walked."""
    S = T if S is None else S
    nq, nk = -(-T // TILE), -(-S // TILE)
    return B * H * nq, B * H * nq + B * KV * nk


def _masked_scores(q, k, causal: bool, sm_scale: float, q_seg=None,
                   kv_seg=None):
    """f32 scores [B, KV, G, T, S] of q [B, H, T, hd] against k [B, KV,
    S, hd] (q head h reads kv head h // G), and the keep mask (None, or
    broadcastable to the scores): causal, and in segment mode only the
    pairs whose ids q_seg [B, T] and kv_seg [B, S] are equal."""
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, T, hd)
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * sm_scale
    keep = None
    if causal:
        keep = torch.ones((T, S), dtype=torch.bool,
                          device=q.device).tril()
    if q_seg is not None:
        same = (q_seg[:, :, None] == kv_seg[:, None, :])[:, None, None]
        keep = same if keep is None else keep & same
    return s, keep


def flash_attention_fwd_plain(q, k, v, causal: bool, sm_scale: float,
                              q_seg=None, kv_seg=None):
    """Plain PyTorch version of A1 in the kernels' layout: q [B, H, T,
    hd], k/v [B, KV, S, hd], optional int32 segment ids q_seg [B, T] and
    kv_seg [B, S] -> (o [B, H, T, hd] in q's type, lse [B, H, T] f32).
    Math in f32, as the TPU kernel upcasts its tiles."""
    B, H, T, hd = q.shape
    s, keep = _masked_scores(q, k, causal, sm_scale, q_seg, kv_seg)
    if keep is not None:
        s = torch.where(keep, s, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(s, dim=-1)                       # [B, KV, G, T]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return (o.reshape(B, H, T, hd).to(q.dtype),
            lse.reshape(B, H, T))


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool,
                              sm_scale: float, q_seg=None, kv_seg=None):
    """Plain PyTorch version of A2: the flash-attention-2 formulas from
    the saved lse (not autograd), in f32, with A1's mask. Returns (dq,
    dk, dv) in the types of q, k, v."""
    B, H, T, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    s, keep = _masked_scores(q, k, causal, sm_scale, q_seg, kv_seg)
    p = torch.exp(s - lse.reshape(B, KV, G, T)[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    do32 = do.float().reshape(B, KV, G, T, hd)
    delta = (do.float() * o.float()).sum(-1).reshape(B, KV, G, T)
    dp = torch.einsum("bkgtd,bksd->bkgts", do32, v.float())
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, k.float())
    dk = torch.einsum("bkgts,bkgtd->bksd", ds,
                      q.float().reshape(B, KV, G, T, hd))
    dv = torch.einsum("bkgts,bkgtd->bksd", p, do32)
    return (dq.reshape(B, H, T, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v, causal, q_seg=None, kv_seg=None):
    B, H, T, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"flash attention takes q [B, H, T, hd] and k/v "
                         f"[B, KV, S, hd]; got q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if not supported(H, k.shape[1], hd):
        raise ValueError(f"unsupported flash attention geometry H={H} "
                         f"KV={k.shape[1]} head_dim={hd}")
    if causal and k.shape[2] != T:
        raise ValueError(f"causal flash attention needs T == S, got {T} "
                         f"vs {k.shape[2]}")
    dtype = build.DTYPE_CODE.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q, k, "
                         f"v of one type; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both segment id tensors or neither")
    if q_seg is not None and (
            q_seg.shape != (B, T) or kv_seg.shape != (B, k.shape[2])
            or q_seg.dtype != torch.int32 or kv_seg.dtype != torch.int32):
        raise ValueError(f"segment ids are int32 [B, T] and [B, S]; got "
                         f"{tuple(q_seg.shape)} {q_seg.dtype} and "
                         f"{tuple(kv_seg.shape)} {kv_seg.dtype}")
    return dtype


def _ptr(t):
    """A tensor's address for a kernel argument, None (NULL) for none."""
    return None if t is None else t.data_ptr()


def _walked_ptr(walked, slots: int, q):
    """The address of a caller's `walked` buffer once it is checked:
    int32, contiguous, on q's device, one entry a block."""
    if walked is not None and (
            walked.dtype != torch.int32 or walked.device != q.device
            or walked.numel() != slots or not walked.is_contiguous()):
        raise ValueError(f"walked takes a contiguous int32 tensor of "
                         f"{slots} entries on {q.device}; got "
                         f"{walked.dtype} {tuple(walked.shape)} on "
                         f"{walked.device}")
    return _ptr(walked)


def _plain_walks_nothing(walked):
    if walked is not None:
        raise ValueError("the plain version walks no tiles: `walked` takes "
                         "the kernels' counts, on a CUDA tensor")


def flash_attention_fwd(q, k, v, causal: bool, sm_scale: float,
                        q_seg=None, kv_seg=None, walked=None):
    """A1 in the kernels' layout (see `flash_attention_fwd_plain`). CPU
    tensors run the plain version; CUDA tensors launch the kernel. walked:
    None, or an int32 tensor of `walk_slots(...)[0]` entries on the card,
    where each block writes the kv tiles it walked."""
    if q.device.type == "cpu":
        _plain_walks_nothing(walked)
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale, q_seg,
                                         kv_seg)
    dtype = _check(q, k, v, causal, q_seg, kv_seg)
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    walked_p = _walked_ptr(walked, walk_slots(B, H, KV, T, S)[0], q)
    segs = () if q_seg is None else (q_seg, kv_seg)
    stream = build.launch_stream("flash_attention", q, k, v, *segs)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = KERNEL_FWD.fn("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        o.data_ptr(), lse.data_ptr(), B, H, KV, T, S, hd, int(causal),
        float(sm_scale), dtype, stream, walked_p)
    KERNEL_FWD.check(err)
    KERNEL_FWD.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool,
                        sm_scale: float, q_seg=None, kv_seg=None,
                        walked=None):
    """A2 (see `flash_attention_bwd_plain`). CPU tensors run the plain
    version; CUDA tensors launch the kernels (dq, then dk/dv) after
    computing delta = rowsum(dO * O) in f32. walked: None, or an int32
    tensor of `walk_slots(...)[1]` entries on the card, where each block
    writes the tiles it walked."""
    if q.device.type == "cpu":
        _plain_walks_nothing(walked)
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         sm_scale, q_seg, kv_seg)
    dtype = _check(q, k, v, causal, q_seg, kv_seg)
    if do.shape != q.shape or do.dtype != q.dtype or lse.shape != q.shape[:3]:
        raise ValueError(f"flash attention backward: do {tuple(do.shape)} "
                         f"{do.dtype} and lse {tuple(lse.shape)} do not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    walked_p = _walked_ptr(walked, walk_slots(B, H, KV, T, S)[1], q)
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1)
    segs = () if q_seg is None else (q_seg, kv_seg)
    stream = build.launch_stream("flash_attention_bwd", q, k, v, do, lse,
                                 delta, *segs)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = KERNEL_BWD.fn("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, KV, T, S, hd,
        int(causal), float(sm_scale), dtype, stream, walked_p)
    KERNEL_BWD.check(err)
    KERNEL_BWD.launches += 1
    return dq, dk, dv


# A1 and A2 as registered ops: a selective-checkpoint policy (the train
# step's remat="dots") sees dispatcher ops only, so A1's outputs can be
# named and saved only once A1 is one. The ops take no `walked` buffer.
@torch.library.custom_op(
    "paddle_tpu_torch::flash_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? q_seg, Tensor? kv_seg, "
           "bool causal, float sm_scale) -> (Tensor, Tensor)")
def flash_attention_op(q, k, v, q_seg, kv_seg, causal, sm_scale):
    """A1 as the op `paddle_tpu_torch::flash_attention_fwd` (see
    `flash_attention_fwd`): (o, lse). Differentiable in q, k, v; its
    backward is A2 (`flash_attention_bwd_op`)."""
    return flash_attention_fwd(q, k, v, causal, sm_scale, q_seg, kv_seg)


@flash_attention_op.register_fake
def _(q, k, v, q_seg, kv_seg, causal, sm_scale):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op(
    "paddle_tpu_torch::flash_attention_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
           "Tensor? q_seg, Tensor? kv_seg, bool causal, float sm_scale) -> "
           "(Tensor, Tensor, Tensor)")
def flash_attention_bwd_op(q, k, v, o, lse, do, q_seg, kv_seg, causal,
                           sm_scale):
    """A2 as the op `paddle_tpu_torch::flash_attention_bwd` (see
    `flash_attention_bwd`): (dq, dk, dv)."""
    return flash_attention_bwd(q, k, v, o, lse, do, causal, sm_scale, q_seg,
                               kv_seg)


@flash_attention_bwd_op.register_fake
def _(q, k, v, o, lse, do, q_seg, kv_seg, causal, sm_scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_fwd(ctx, inputs, output):
    q, k, v, q_seg, kv_seg, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)


def _backward_fwd(ctx, do, _lse_grad):
    q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd_op(q, k, v, o, lse, do, q_seg, kv_seg,
                                        ctx.causal, ctx.sm_scale)
    return dq, dk, dv, None, None, None, None


flash_attention_op.register_autograd(_backward_fwd, setup_context=_setup_fwd)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None, q_segment_ids=None,
                    kv_segment_ids=None):
    """Fused attention, differentiable. q [B, T, H, hd], k/v [B, S, KV,
    hd] -> [B, T, H, hd], the reference's layout (:502); GQA when H > KV.
    q_segment_ids [B, T] and kv_segment_ids [B, S] (both or neither)
    restrict attention to pairs of one segment (packed variable-length
    sequences); as in the reference, every row must keep a key of its
    segment. CPU tensors run the plain versions (forward and FA-2
    backward); CUDA tensors launch A1 and, under autograd, A2 — an
    unsupported geometry raises."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids or "
                         "neither")
    hd = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    segs = (None, None) if q_segment_ids is None else (
        q_segment_ids.to(torch.int32).contiguous(),
        kv_segment_ids.to(torch.int32).contiguous())
    o, _ = flash_attention_op(qt, kt, vt, *segs, bool(causal),
                              float(sm_scale))
    return o.transpose(1, 2)
