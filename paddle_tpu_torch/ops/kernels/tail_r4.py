"""Op tail 6 — port of `paddle_tpu/ops/kernels/tail_r4.py`.

conv3d_transpose / depthwise_conv2d_transpose (torch's transposed
convolutions), beam search (`beam_search`, `beam_search_decode`: host
loops over the candidates, as in the reference), the LoD sequence ops
with their offsets passed explicitly (`lod` = [0, n1, n1+n2, ...]),
lrn, row_conv, the fluid `lstm` / `gru` names over the `rnn` op, the
string ops lower / upper (host, on string arrays) and the metric host
ops chunk_eval and detection_map.

`global_scatter` / `global_gather` (MoE's variable-count all-to-all)
run through `distributed.collective`. Waiting: the sparse names
`to_dense`, `to_sparse_coo`, `to_sparse_csr`, `coalesce`, `mask_as` and
`masked_matmul` for item 9 (sparse tensors). Each raises
NotImplementedError naming its item.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..dispatch import register_op
from ._util import pair, waiting

# ---------------------------------------------------------------------------
# transposed convolutions
# ---------------------------------------------------------------------------


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, nd, channel_last):
    """weight [in_c, out_c/groups, *k], as paddle and torch store it."""
    if channel_last:
        x = x.movedim(-1, 1)
    conv = F.conv_transpose3d if nd == 3 else F.conv_transpose2d
    out = conv(x, weight, bias, pair(stride, nd), pair(padding, nd),
               pair(output_padding, nd), groups, pair(dilation, nd))
    return out.movedim(1, -1) if channel_last else out


@register_op
def conv3d_transpose(x, filter, bias=None, strides=1, paddings=0,
                     output_padding=0, output_size=None,
                     padding_algorithm="EXPLICIT", groups=1, dilations=1,
                     data_format="NCDHW"):
    return _conv_transpose(x, filter, bias, strides, paddings,
                           output_padding, dilations, groups, 3,
                           data_format == "NDHWC")


@register_op
def depthwise_conv2d_transpose(x, filter, bias=None, strides=1, paddings=0,
                               output_padding=0, output_size=None,
                               padding_algorithm="EXPLICIT", groups=None,
                               dilations=1, data_format="NCHW"):
    """groups defaults to the input channels."""
    last = data_format == "NHWC"
    cin = x.shape[-1 if last else 1]
    return _conv_transpose(x, filter, bias, strides, paddings,
                           output_padding, dilations, groups or cin, 2,
                           last)


# ---------------------------------------------------------------------------
# beam search (host ops)
# ---------------------------------------------------------------------------


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@register_op(nondiff=True)
def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, return_parent_idx=True):
    """One beam-search step. pre_ids [batch*beam, 1], pre_scores
    [batch*beam, 1], scores [batch*beam, K] (log-probabilities, or
    probabilities when not is_accumulated). -> (selected_ids [batch*beam,
    1] int64, selected_scores f32, parent_idx int32): per batch group the
    best beam_size continuations; a finished beam (pre_id == end_id)
    keeps only itself with its score."""
    dev = scores.device
    pre_ids_h = _host(pre_ids).reshape(-1)
    pre_sc = _host(pre_scores).reshape(-1).astype(np.float64)
    cand_ids = _host(ids) if ids is not None else None
    sc = _host(scores).astype(np.float64)
    BB, K = sc.shape
    assert BB % beam_size == 0, (BB, beam_size)
    if not is_accumulated:
        sc = np.log(np.maximum(sc, 1e-20)) + pre_sc[:, None]
    sel_ids, sel_scores, parents = [], [], []
    for b in range(BB // beam_size):
        cands = []
        for r in range(b * beam_size, (b + 1) * beam_size):
            if pre_ids_h[r] == end_id:
                cands.append((pre_sc[r], end_id, r))
                continue
            for k in range(K):
                tok = int(cand_ids[r, k]) if cand_ids is not None else k
                cands.append((sc[r, k], tok, r))
        cands.sort(key=lambda c: -c[0])
        for s, tok, r in cands[:beam_size]:
            sel_scores.append(s)
            sel_ids.append(tok)
            parents.append(r)
    return (torch.as_tensor(np.asarray(sel_ids, np.int64).reshape(-1, 1),
                            device=dev),
            torch.as_tensor(np.asarray(sel_scores, np.float32).reshape(-1, 1),
                            device=dev),
            torch.as_tensor(np.asarray(parents, np.int32), device=dev))


@register_op(nondiff=True)
def beam_search_decode(step_ids, step_parents, step_scores=None,
                       beam_size=1, end_id=0):
    """Backtrack the beam pointers into sequences: -> (sequences
    [batch*beam, T] int64, final scores [batch*beam] f32)."""
    dev = step_ids[0].device
    ids = [_host(s).reshape(-1) for s in step_ids]
    parents = [_host(p).reshape(-1) for p in step_parents]
    T = len(ids)
    BB = ids[0].shape[0]
    seqs = np.zeros((BB, T), np.int64)
    for slot in range(BB):
        row = slot
        for t in range(T - 1, -1, -1):
            seqs[slot, t] = ids[t][row]
            row = int(parents[t][row])
    final = (_host(step_scores[-1]).reshape(-1).astype(np.float32)
             if step_scores is not None else np.zeros((BB,), np.float32))
    return torch.as_tensor(seqs, device=dev), torch.as_tensor(final,
                                                              device=dev)


# ---------------------------------------------------------------------------
# LoD sequence ops (explicit offsets)
# ---------------------------------------------------------------------------


def _lod_to_lens(lod):
    lod = _host(lod).astype(np.int64).reshape(-1)
    return lod, np.diff(lod)


@register_op
def sequence_softmax(x, lod):
    """Softmax within each [lod[i], lod[i+1]) segment of flat x [N]."""
    offs, lens = _lod_to_lens(lod)
    n = x.shape[0]
    seg = torch.as_tensor(np.repeat(np.arange(len(lens)), lens),
                          device=x.device)
    flat = x.reshape(n, -1).to(torch.float32)
    idx = seg[:, None].expand_as(flat)
    segmax = torch.full((len(lens), flat.shape[1]), float("-inf"),
                        device=x.device).scatter_reduce(0, idx, flat, "amax")
    shifted = torch.exp(flat - segmax[seg])
    segsum = torch.zeros_like(segmax).index_add(0, seg, shifted)
    return (shifted / segsum[seg]).reshape(x.shape).to(x.dtype)


@register_op
def sequence_expand(x, y_lod, ref_level=0, x_lod=None):
    """Repeat x's sequences y_lens[i] times each (x_lod default: a row a
    sequence)."""
    _, y_lens = _lod_to_lens(y_lod)
    x_off = (np.arange(len(y_lens) + 1, dtype=np.int64) if x_lod is None
             else _host(x_lod).astype(np.int64).reshape(-1))
    rows: List[int] = []
    for i, reps in enumerate(y_lens):
        rows.extend(list(range(int(x_off[i]), int(x_off[i + 1]))) * int(reps))
    return x[torch.as_tensor(rows, dtype=torch.long, device=x.device)]


@register_op
def sequence_conv(x, filter, lod, context_length=3, context_start=None,
                  context_stride=1, padding_data=None):
    """Context-window projection inside sequence bounds: each row's
    context rows [t+start, t+start+len) (0 outside its sequence),
    concatenated, times filter [context_length*D, M]."""
    if context_stride != 1:
        raise NotImplementedError("sequence_conv context_stride != 1")
    start = (-(context_length // 2) if context_start is None
             else int(context_start))
    offs, lens = _lod_to_lens(lod)
    N, D = x.shape
    ctx = []
    for i in range(len(lens)):
        lo, hi = int(offs[i]), int(offs[i + 1])
        for t in range(lo, hi):
            ctx.append([t + start + c if lo <= t + start + c < hi else -1
                        for c in range(context_length)])
    idx = torch.as_tensor(np.asarray(ctx, np.int64).reshape(-1,
                                                           context_length),
                          device=x.device)
    gathered = torch.where((idx >= 0)[..., None],
                           x[idx.clamp(0, N - 1)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return gathered.reshape(N, context_length * D) @ filter.to(x.dtype)


@register_op
def sequence_pad(x, pad_value, lod, padded_length=None):
    """flat [N, D] and offsets -> ([num_seq, P, D], lengths int64)."""
    offs, lens = _lod_to_lens(lod)
    P = int(padded_length) if padded_length and padded_length > 0 \
        else int(lens.max())
    pv = torch.as_tensor(pad_value, dtype=x.dtype,
                         device=x.device).reshape(-1)[0]
    pieces = []
    for i in range(len(lens)):
        seg = x[int(offs[i]):int(offs[i + 1])]
        fill = pv.expand((P - seg.shape[0],) + tuple(x.shape[1:]))
        pieces.append(torch.cat([seg, fill]))
    return torch.stack(pieces), torch.as_tensor(lens, dtype=torch.int64,
                                                device=x.device)


@register_op
def sequence_unpad(x, length):
    """[B, P, D] and lengths -> flat [sum(len), D]."""
    lens = _host(length).astype(np.int64).reshape(-1)
    return torch.cat([x[i, :int(n)] for i, n in enumerate(lens)])


# ---------------------------------------------------------------------------
# lrn / row_conv
# ---------------------------------------------------------------------------


@register_op
def lrn(x, n=5, k=2.0, alpha=1e-4, beta=0.75, data_format="NCHW"):
    """Across-channel local response normalization:
    x / (k + alpha * local_sum(x^2))^beta."""
    last = data_format not in ("NCHW", "AnyLayout")
    sq = x.to(torch.float32) ** 2
    if last:
        sq = sq.movedim(-1, 1)
    C = sq.shape[1]
    half = n // 2
    pad = [0, 0] * (sq.ndim - 2) + [half, n - 1 - half]
    padded = F.pad(sq, pad)
    window = sum(padded[:, i:i + C] for i in range(n))
    denom = (k + alpha * window) ** beta
    if last:
        denom = denom.movedim(1, -1)
    return (x.to(torch.float32) / denom).to(x.dtype)


@register_op
def row_conv(x, filter, lod=None):
    """Lookahead row convolution: out[t] = sum_i x[t+i] * filter[i], 0
    past each sequence's end. x [B, T, D], or flat [N, D] with lod."""
    fut = filter.shape[0]
    f = filter.to(torch.float32)
    if x.ndim == 3:
        T = x.shape[1]
        padded = F.pad(x.to(torch.float32), (0, 0, 0, fut - 1))
        return sum(padded[:, i:i + T] * f[i] for i in range(fut)).to(x.dtype)
    offs, lens = _lod_to_lens(lod)
    outs = []
    for i in range(len(lens)):
        seg = x[int(offs[i]):int(offs[i + 1])].to(torch.float32)
        T = seg.shape[0]
        padded = F.pad(seg, (0, 0, 0, fut - 1))
        outs.append(sum(padded[j:j + T] * f[j] for j in range(fut)))
    return torch.cat(outs).to(x.dtype)


# ---------------------------------------------------------------------------
# fluid lstm / gru names over the rnn op
# ---------------------------------------------------------------------------


@register_op(name="lstm")
def lstm_fused(x, init_h, init_c, w_ih, w_hh, b_ih=None, b_hh=None,
               is_bidirec=False, num_layers=1, time_major=False):
    """The fluid `lstm` name: one weight bundle over the `rnn` op."""
    from .rnn_ops import rnn as _rnn

    if num_layers != 1 or is_bidirec:
        raise NotImplementedError(
            "fused `lstm` op name takes one weight bundle; multi-layer/"
            "bidirectional recurrences go through the `rnn` op's "
            "weight_list form (ops/kernels/rnn_ops.py)")
    return _rnn._kernel(x, init_h, init_c, [[w_ih, w_hh, b_ih, b_hh]],
                        mode="LSTM", time_major=time_major)


@register_op(name="gru")
def gru_fused(x, init_h, w_ih, w_hh, b_ih=None, b_hh=None,
              is_bidirec=False, num_layers=1, time_major=False):
    """The fluid `gru` name over the `rnn` op."""
    from .rnn_ops import rnn as _rnn

    if num_layers != 1 or is_bidirec:
        raise NotImplementedError(
            "fused `gru` op name takes one weight bundle; multi-layer/"
            "bidirectional recurrences go through the `rnn` op's "
            "weight_list form (ops/kernels/rnn_ops.py)")
    return _rnn._kernel(x, init_h, None, [[w_ih, w_hh, b_ih, b_hh]],
                        mode="GRU", time_major=time_major)


# ---------------------------------------------------------------------------
# MoE collectives (moe_utils.py global_scatter / global_gather)
# ---------------------------------------------------------------------------

def _moe_alltoall(x, send_counts, recv_counts, group):
    """Rows of x to each rank by count: `send_counts` / `recv_counts`
    hold one count an (rank, local expert) pair, rank-major; rank w gets
    the next sum(send_counts[w]) rows and this rank receives
    sum(recv_counts[w]) from rank w, concatenated in rank order."""
    from .tail_collective import ring_group

    g = group if group is not None else ring_group(0, x.device.type)
    world = g.nranks
    if world <= 1:
        return x.clone()
    send = np.asarray(send_counts).reshape(world, -1).sum(axis=1)
    recv = np.asarray(recv_counts).reshape(world, -1).sum(axis=1)
    out = x.new_empty((int(recv.sum()),) + tuple(x.shape[1:]))
    from ...distributed import collective as C
    C.alltoall_single(out, x.contiguous(), [int(v) for v in send],
                      [int(v) for v in recv], group=g)
    return out


@register_op(nondiff=True)
def global_scatter(x, local_count, global_count, ring_id=0,
                   use_calc_stream=True, group=None):
    """moe_utils.global_scatter: local_count[i] rows to expert i % n_expert
    of rank i // n_expert; global_count[i] rows received from each. At
    world size one the rows come back as they are."""
    return _moe_alltoall(x, _counts(local_count), _counts(global_count),
                         group)


@register_op(nondiff=True)
def global_gather(x, local_count, global_count, ring_id=0,
                  use_calc_stream=True, group=None):
    """The inverse of global_scatter: results back to the tokens' ranks."""
    return _moe_alltoall(x, _counts(global_count), _counts(local_count),
                         group)


def _counts(c):
    return c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


# ---------------------------------------------------------------------------
# waiting: sparse names (item 9)
# ---------------------------------------------------------------------------
sparse_to_dense = waiting("to_dense", 9)
to_sparse_coo = waiting("to_sparse_coo", 9)
to_sparse_csr = waiting("to_sparse_csr", 9)
sparse_coalesce = waiting("coalesce", 9)
sparse_mask_as = waiting("mask_as", 9)
sparse_masked_matmul = waiting("masked_matmul", 9)


# ---------------------------------------------------------------------------
# strings (host ops on string arrays)
# ---------------------------------------------------------------------------


def _str_apply(x, fn):
    arr = np.asarray(x)
    if arr.dtype.kind in ("U", "S", "O"):
        return np.vectorize(fn, otypes=[object])(arr)
    raise TypeError("strings ops take string arrays")


@register_op(name="lower", nondiff=True)
def strings_lower(x, use_utf8_encoding=False):
    return _str_apply(x, lambda s: s.lower())


@register_op(name="upper", nondiff=True)
def strings_upper(x, use_utf8_encoding=False):
    return _str_apply(x, lambda s: s.upper())


# ---------------------------------------------------------------------------
# metric host ops
# ---------------------------------------------------------------------------


@register_op(nondiff=True)
def chunk_eval(inference, label, num_chunk_types, chunk_scheme="IOB",
               excluded_chunk_types=None, seq_length=None):
    """Chunking F1 over tags coded type * n_tags + tag. -> (precision,
    recall, f1, num_infer, num_label, num_correct)."""
    scheme_tags = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}
    n = scheme_tags.get(chunk_scheme)
    if n is None:
        raise ValueError(f"unknown chunk_scheme {chunk_scheme!r}")
    excluded = set(excluded_chunk_types or [])

    def decode(t):
        t = int(t)
        if chunk_scheme == "plain":
            return (t, "S") if 0 <= t < num_chunk_types else (None, None)
        if t < 0 or t >= num_chunk_types * n:
            return None, None
        ty, tag = divmod(t, n)
        return ty, {"IOB": "BI", "IOE": "IE", "IOBES": "BIES"}[
            chunk_scheme][tag]

    def chunks_of(seq):
        out, start, ctype = [], None, None
        for i, t in enumerate(list(seq) + [-1]):
            ty, mark = decode(t)
            if start is not None and (ty != ctype or mark in ("B", "S")):
                out.append((start, i, ctype))
                start = None
            if ty is not None and start is None:
                start, ctype = i, ty
            if mark in ("E", "S") and start is not None:
                out.append((start, i + 1, ctype))
                start = None
            if ty is None:
                start = None
        return {(s, e, c) for s, e, c in out if c not in excluded}

    dev = inference.device
    inf = _host(inference).reshape(-1)
    lab = _host(label).reshape(-1)
    if seq_length is not None:
        seqs, off = [], 0
        for L in _host(seq_length).reshape(-1):
            seqs.append((inf[off:off + int(L)], lab[off:off + int(L)]))
            off += int(L)
    else:
        seqs = [(inf, lab)]
    ni = nl = nc = 0
    for i_seq, l_seq in seqs:
        ci, cl = chunks_of(i_seq), chunks_of(l_seq)
        ni += len(ci)
        nl += len(cl)
        nc += len(ci & cl)
    prec = nc / ni if ni else 0.0
    rec = nc / nl if nl else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    return f32(prec), f32(rec), f32(f1), i64(ni), i64(nl), i64(nc)


@register_op(nondiff=True)
def detection_map(detect_res, label, num_classes, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  ap_type="integral"):
    """mAP of one image's detections ([label, score, x1, y1, x2, y2]) over
    its ground truth ([label, x1, y1, x2, y2(, difficult)])."""
    dev = detect_res.device
    det = _host(detect_res).astype(np.float64).reshape(-1, 6)
    gt = _host(label).astype(np.float64)
    gt = gt.reshape(-1, gt.shape[-1]) if gt.size else gt.reshape(0, 5)

    def iou(a, b):
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    aps = []
    for c in range(num_classes):
        if c == background_label:
            continue
        dets = det[det[:, 0] == c]
        gts = gt[gt[:, 0] == c]
        if not evaluate_difficult and gts.shape[1] > 5:
            gts = gts[gts[:, 5] == 0]
        if len(gts) == 0:
            continue
        order = np.argsort(-dets[:, 1])
        matched = np.zeros(len(gts), bool)
        tp = np.zeros(len(order))
        fp = np.zeros(len(order))
        for r, di in enumerate(order):
            best, bi = 0.0, -1
            for gi in range(len(gts)):
                ov = iou(dets[di, 2:6], gts[gi, 1:5])
                if ov > best:
                    best, bi = ov, gi
            if best >= overlap_threshold and not matched[bi]:
                tp[r] = 1
                matched[bi] = True
            else:
                fp[r] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        rec = ctp / len(gts)
        prec = ctp / np.maximum(ctp + cfp, 1e-12)
        if ap_type == "11point":
            ap = float(np.mean([prec[rec >= t].max() if (rec >= t).any()
                                else 0.0 for t in np.linspace(0, 1, 11)]))
        else:
            mrec = np.concatenate([[0.0], rec, [1.0]])
            mpre = np.concatenate([[0.0], prec, [0.0]])
            for i in range(len(mpre) - 2, -1, -1):
                mpre[i] = max(mpre[i], mpre[i + 1])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
        aps.append(ap)
    return torch.tensor(float(np.mean(aps)) if aps else 0.0,
                        dtype=torch.float32, device=dev)
