"""Op tail 3: sequence losses and decoders, metric ops, the linalg
remainder — port of `paddle_tpu/ops/kernels/tail_seq.py`.

`warprnnt` is the RNN-T loss as a log-space lattice recursion (a cell at
a time, vectorised over the batch), `crf_decoding` a Viterbi decode,
`accuracy` / `auc` the metric ops (auc functional: it returns its
updated statistics), then eigvals, lu_unpack, the matrix_rank
tolerances, class_center_sample, im2sequence and the *_batch_size_like
creators. Random draws come from the port's generators.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core import rng
from ..dispatch import register_op
from ._util import td
from .tail_nn import _gamma

_NEG = -1e30


@register_op
def warprnnt(input, label, input_lengths, label_lengths, blank=0,
             fastemit_lambda=0.0):
    """RNN-T loss: input [B, T, U+1, V] logits -> -log P(labels) [B].
    alpha[t,u] = logaddexp(alpha[t-1,u] + blank(t-1,u),
    alpha[t,u-1] + emit(t,u-1)). With fastemit_lambda the value is
    unchanged and the label arcs' gradients scale by (1 + lambda)."""
    logp = torch.log_softmax(input.to(torch.float32), dim=-1)
    B, Tmax, U1, V = logp.shape
    lab = label.long()
    if fastemit_lambda:
        onehot = F.one_hot(lab[:, :U1 - 1], V).to(logp.dtype)
        emit_mask = torch.zeros(B, 1, U1, V, dtype=logp.dtype,
                                device=logp.device)
        emit_mask[:, 0, :U1 - 1] = onehot
        logp = logp + fastemit_lambda * emit_mask * (logp - logp.detach())
    blank_lp = logp[..., blank]                                # [B, T, U1]
    emit_lp = torch.gather(logp[:, :, :U1 - 1], 3,
                           lab[:, None, :U1 - 1, None].expand(
                               B, Tmax, U1 - 1, 1))[..., 0]    # [B, T, U]
    neg = torch.full((B,), _NEG, dtype=logp.dtype, device=logp.device)
    rows, prev = [], None
    for t in range(Tmax):
        row = []
        for u in range(U1):
            if t == 0 and u == 0:
                a = torch.zeros_like(neg)
            else:
                down = prev[u] + blank_lp[:, t - 1, u] if t > 0 else neg
                left = row[u - 1] + emit_lp[:, t, u - 1] if u > 0 else neg
                a = torch.logaddexp(down, left)
            row.append(a)
        rows.append(torch.stack(row, 1))
        prev = row
    alphas = torch.stack(rows, 1)                             # [B, T, U1]
    T = input_lengths.long().reshape(B) - 1
    U = label_lengths.long().reshape(B)
    b = torch.arange(B, device=logp.device)
    return -(alphas[b, T, U] + blank_lp[b, T, U])


@register_op(nondiff=True)
def crf_decoding(emission, transition, label=None, length=None):
    """Viterbi decode with start / stop rows (transition [N+2, N]).
    emission [B, L, N] padded -> best paths [B, L] (0 past a length); with
    label, 1 where the path matches it inside the length."""
    B, L, N = emission.shape
    dev = emission.device
    em = emission.to(torch.float32)
    start, stop, trans = transition[0], transition[1], transition[2:]
    lengths = (length.reshape(-1).long() if length is not None
               else torch.full((B,), L, dtype=torch.long, device=dev))
    alpha = em[:, 0] + start
    ident = torch.arange(N, device=dev).expand(B, N)
    hist = []
    for t in range(1, L):
        scores = alpha[:, :, None] + trans
        best = torch.argmax(scores, dim=1)
        a2 = scores.amax(dim=1) + em[:, t]
        active = (t < lengths)[:, None]
        alpha = torch.where(active, a2, alpha)
        hist.append(torch.where(active, best, ident))
    tag = torch.argmax(alpha + stop, dim=-1)
    path = [tag]
    for h in reversed(hist):
        tag = torch.gather(h, 1, tag[:, None])[:, 0]
        path.append(tag)
    paths = torch.stack(path[::-1], 1)
    inside = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    zero = torch.zeros((), dtype=torch.long, device=dev)
    if label is not None:
        match = (paths == label.reshape(B, L).long()).long()
        return torch.where(inside, match, zero)
    return torch.where(inside, paths, zero)


@register_op(nondiff=True)
def accuracy(x, indices, label, k: int = 1):
    """Share of samples whose top-k ids contain the label: (accuracy,
    correct, total)."""
    lab = label.reshape(-1, 1)
    correct = (indices == lab).any(dim=1).sum().to(torch.float32)
    total = torch.tensor(float(lab.shape[0]), device=x.device)
    return correct / total, correct, total


@register_op(nondiff=True)
def auc(predict, label, stat_pos=None, stat_neg=None,
        num_thresholds: int = 4095, curve="ROC", slide_steps=1,
        ins_tag_weight=None):
    """Streaming AUC over threshold buckets: (auc float64, stat_pos,
    stat_neg). PR: the exact right-step average precision."""
    score = predict[:, -1] if predict.ndim == 2 else predict
    buckets = torch.clamp((score * num_thresholds).to(torch.int32), 0,
                          num_thresholds).long()
    lab = label.reshape(-1).to(torch.bool)
    nbuck = num_thresholds + 1
    pos_h = torch.bincount(buckets[lab], minlength=nbuck)
    neg_h = torch.bincount(buckets[~lab], minlength=nbuck)
    sp = pos_h if stat_pos is None else stat_pos.long() + pos_h
    sn = neg_h if stat_neg is None else stat_neg.long() + neg_h
    tp = torch.cumsum(sp.flip(0), 0)
    fp = torch.cumsum(sn.flip(0), 0)
    tot_p = torch.clamp(tp[-1], min=1)
    tot_n = torch.clamp(fp[-1], min=1)
    if curve == "PR":
        precision = tp / torch.clamp(tp + fp, min=1)
        recall = tp / tot_p
        area = ((recall[1:] - recall[:-1]) * precision[1:]).sum() \
            + recall[0] * precision[0]
    else:
        tpr = tp / tot_p
        fpr = fp / tot_n
        area = ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0).sum() \
            + fpr[0] * tpr[0] / 2.0
    return area.to(torch.float64), sp, sn


@register_op(nondiff=True)
def eigvals(x):
    return torch.linalg.eigvals(x)


@register_op(nondiff=True)
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    """(LU compact, 1-based sequential pivots) -> (P, L, U)."""
    n, m = x.shape[-2], x.shape[-1]
    k = min(n, m)
    L = torch.tril(x, -1)[..., :, :k] + torch.eye(n, k, dtype=x.dtype,
                                                  device=x.device)
    U = torch.triu(x)[..., :k, :]
    piv = y.long() - 1
    batch = piv.shape[:-1]
    flat = piv.reshape(-1, piv.shape[-1]).cpu().numpy()
    perms = []
    for p in flat:
        order = np.arange(n)
        for i, j in enumerate(p):
            order[i], order[j] = order[j], order[i]
        perms.append(order)
    order = torch.as_tensor(np.stack(perms), device=x.device)
    P = F.one_hot(order, n).to(x.dtype).transpose(-1, -2)
    return P.reshape(tuple(batch) + (n, n)), L, U


def _singular(x, hermitian):
    return (torch.linalg.eigvalsh(x).abs() if hermitian
            else torch.linalg.svdvals(x))


@register_op(nondiff=True)
def matrix_rank_tol(x, tol=None, use_default_tol=True, hermitian=False):
    """Rank with an explicit tolerance tensor (it wins over the default)."""
    s = _singular(x, hermitian)
    if tol is not None:
        t = torch.as_tensor(tol, device=x.device)
    else:
        t = s.amax(-1) * max(x.shape[-2:]) * torch.finfo(x.dtype).eps
    return (s > t[..., None] if t.ndim else s > t).sum(-1).long()


@register_op(nondiff=True)
def matrix_rank_atol_rtol(x, atol=None, rtol=None, hermitian=False):
    """Rank with threshold max(atol, rtol * sigma_max); rtol defaults to 0
    when atol is given, else to max(m, n) * eps."""
    s = _singular(x, hermitian)
    smax = s.amax(-1)
    a = torch.as_tensor(0.0 if atol is None else atol, device=x.device)
    if rtol is None:
        r = torch.as_tensor(0.0 if atol is not None else
                            max(x.shape[-2:]) * torch.finfo(x.dtype).eps,
                            device=x.device)
    else:
        r = torch.as_tensor(rtol, device=x.device)
    t = torch.maximum(a, r * smax)
    return (s > t[..., None] if t.ndim else s > t).sum(-1).long()


@register_op(nondiff=True)
def dirichlet(alpha, seed=0):
    g = _gamma(alpha, rng.seed_or_next(seed, alpha.device))
    return g / g.sum(-1, keepdim=True)


@register_op(nondiff=True)
def class_center_sample(label, num_classes, num_samples, ring_id=0,
                        rank=0, nranks=1, fix_seed=False, seed=0):
    """Keep every positive class, fill up to num_samples with negatives
    sampled on the host as the reference samples them (numpy's
    RandomState: `seed` with fix_seed, else a seed drawn from the port's
    generator); labels remapped into the sampled set. -> (remapped
    labels, sampled classes)."""
    dev = label.device
    lab = label.reshape(-1).cpu().numpy()
    if not fix_seed:
        seed = int(torch.randint(2 ** 31 - 1, (), generator=rng.next_generator(
            "cpu")))
    rs = np.random.RandomState(seed)
    pos = np.unique(lab)
    if pos.size >= num_samples:
        sampled = pos
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos, assume_unique=True)
        sampled = np.concatenate([pos, rs.choice(rest, num_samples - pos.size,
                                                 replace=False)])
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(sampled.size)
    return (torch.as_tensor(remap[lab], device=dev),
            torch.as_tensor(sampled.astype(np.int64), device=dev))


@register_op
def im2sequence(x, kernels, strides=(1, 1), paddings=(0, 0, 0, 0),
                out_stride=(1, 1)):
    """Sliding blocks -> [N*outH*outW, C*kh*kw]; paddings (up, left, down,
    right)."""
    N, C, H, W = x.shape
    kh, kw = kernels
    xp = F.pad(x, (paddings[1], paddings[3], paddings[0], paddings[2]))
    cols = F.unfold(xp, (kh, kw), stride=tuple(strides))   # [N, CKK, L]
    return cols.transpose(1, 2).reshape(-1, C * kh * kw)


@register_op(nondiff=True)
def full_batch_size_like(input, shape, value=0.0, input_dim_idx=0,
                         output_dim_idx=0, dtype="float32"):
    out_shape = list(shape)
    out_shape[output_dim_idx] = input.shape[input_dim_idx]
    return torch.full(out_shape, value, dtype=td(dtype), device=input.device)


@register_op(nondiff=True)
def uniform_random_batch_size_like(input, shape, min=-1.0, max=1.0,
                                   input_dim_idx=0, output_dim_idx=0,
                                   seed=0, dtype="float32"):
    out_shape = list(shape)
    out_shape[output_dim_idx] = input.shape[input_dim_idx]
    u = torch.rand(out_shape, generator=rng.seed_or_next(seed, input.device),
                   dtype=td(dtype), device=input.device)
    return min + (max - min) * u
