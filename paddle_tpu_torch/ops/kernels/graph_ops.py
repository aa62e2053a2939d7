"""Graph sampling ops (GNN input side) — port of
`paddle_tpu/ops/kernels/graph_ops.py`.

Host ops, as in the reference: neighbour sampling has data-dependent
output sizes, and the sampled subgraph then feeds the send_u_recv
message-passing ops on the device. The graph is CSC: colptr[v] ..
colptr[v+1] spans the row[] entries holding v's in-neighbours. Samples
are drawn from the port's generators (`core/rng.py`: a nonzero `seed`
gives a fixed stream, 0 the global one), so the sampled ids are not the
reference's; a node with no more neighbours than sample_size keeps all
of them in order, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ..dispatch import register_op


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _out(arrs, dev):
    return tuple(torch.as_tensor(a, device=dev) for a in arrs)


def _sample(idx, k, gen, p=None):
    """k of idx without replacement (uniform, or proportional to p)."""
    if p is None:
        pick = torch.randperm(idx.size, generator=gen)[:k]
    else:
        pick = torch.multinomial(torch.as_tensor(p), k, replacement=False,
                                 generator=gen)
    return idx[pick.numpy()]


def _gather(rowa, cp, xs, ea, pick):
    """Concatenate the picked neighbours of every node of xs:
    (neighbours, counts int32, eids or None)."""
    neigh, counts, out_eids = [], [], []
    for v in xs:
        idx = pick(int(cp[v]), int(cp[v + 1]))
        neigh.append(rowa[idx])
        counts.append(idx.size)
        if ea is not None:
            out_eids.append(ea[idx])
    nb = np.concatenate(neigh) if neigh else np.zeros(0, rowa.dtype)
    eids = None if ea is None else (np.concatenate(out_eids) if out_eids
                                    else np.zeros(0, np.int64))
    return nb, np.asarray(counts, np.int32), eids


@register_op(nondiff=True)
def graph_sample_neighbors(row, colptr, x, eids=None, perm_buffer=None,
                           sample_size=-1, return_eids=False,
                           flag_perm_buffer=False, seed=0):
    """-> (out_neighbors, out_count[, out_eids]): up to `sample_size`
    in-neighbours a node of x, concatenated in x's order."""
    if return_eids and eids is None:
        raise ValueError("return_eids=True requires the eids input")
    gen = rng.seed_or_next(seed, "cpu")

    def pick(s, e):
        idx = np.arange(s, e)
        return _sample(idx, sample_size, gen) if 0 < sample_size < idx.size \
            else idx

    nb, cnt, ee = _gather(_np(row), _np(colptr), _np(x).reshape(-1),
                          _np(eids) if return_eids else None, pick)
    return _out((nb, cnt) + ((ee,) if return_eids else ()), row.device)


@register_op(nondiff=True)
def weighted_sample_neighbors(row, colptr, edge_weight, x, eids=None,
                              sample_size=-1, return_eids=False, seed=0):
    """Sampling with probability proportional to the edge weight;
    zero-weight edges are never taken, and a node with no more
    positive-weight edges than sample_size gives just those."""
    if return_eids and eids is None:
        raise ValueError("return_eids=True requires the eids input")
    wa = _np(edge_weight).astype(np.float64)
    if (wa < 0).any():
        raise ValueError("edge_weight must be non-negative")
    gen = rng.seed_or_next(seed, "cpu")

    def pick(s, e):
        idx = np.arange(s, e)
        w = wa[s:e]
        pos = idx[w > 0]
        if sample_size <= 0:
            return idx
        if pos.size <= sample_size:
            return pos
        return _sample(pos, sample_size, gen, w[w > 0] / w[w > 0].sum())

    nb, cnt, ee = _gather(_np(row), _np(colptr), _np(x).reshape(-1),
                          _np(eids) if return_eids else None, pick)
    return _out((nb, cnt) + ((ee,) if return_eids else ()), row.device)


def _compact(first, rest):
    """Ids in first-seen order over first then rest: (order, mapping)."""
    mapping, order = {}, []
    for v in list(first) + list(rest):
        if v not in mapping:
            mapping[v] = len(order)
            order.append(v)
    return order, mapping


@register_op(nondiff=True)
def reindex_graph(x, neighbors, count, hashtable_value=None,
                  hashtable_index=None):
    """-> (reindex_src, reindex_dst, out_nodes): compact ids, x's nodes
    first, then new neighbours in first-seen order; dst repeats x's
    compact id count[i] times."""
    xs = _np(x).reshape(-1)
    nb = _np(neighbors).reshape(-1)
    cnt = _np(count).reshape(-1)
    order, mapping = _compact(xs.tolist(), nb.tolist())
    src = np.asarray([mapping[v] for v in nb.tolist()], np.int64)
    dst = np.repeat(np.arange(len(xs), dtype=np.int64)[:cnt.size], cnt)
    return _out((src, dst, np.asarray(order, xs.dtype)), x.device)


@register_op(nondiff=True)
def graph_khop_sampler(row, colptr, x, eids=None, sample_sizes=(),
                       return_eids=False, seed=0):
    """K hops of sampling and frontier merging, then one reindex over
    every gathered edge. -> (edge_src, edge_dst, sample_index,
    reindex_x[, edge_eids])."""
    if return_eids and eids is None:
        raise ValueError("return_eids=True requires the eids input")
    frontier = _np(x).reshape(-1)
    srcs, dsts, all_eids = [], [], []
    seen = list(frontier.tolist())
    seen_set = set(seen)
    cur = frontier
    for hop, size in enumerate(tuple(sample_sizes)):
        res = graph_sample_neighbors._kernel(
            row, colptr, torch.as_tensor(cur), eids=eids, sample_size=size,
            return_eids=return_eids, seed=(seed + hop) if seed else 0)
        nb, cnt = _np(res[0]), _np(res[1])
        if return_eids:
            all_eids.append(_np(res[2]))
        srcs.append(nb)
        dsts.append(np.repeat(cur, cnt))
        nxt = []
        for v in nb.tolist():
            if v not in seen_set:
                seen_set.add(v)
                seen.append(v)
                nxt.append(v)
        cur = np.asarray(nxt, frontier.dtype)
    mapping = {v: i for i, v in enumerate(seen)}

    def remap(parts):
        flat = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        return np.asarray([mapping[v] for v in flat.tolist()], np.int64)

    out = (remap(srcs), remap(dsts), np.asarray(seen, frontier.dtype),
           np.asarray([mapping[v] for v in frontier.tolist()], np.int64))
    if return_eids:
        out += (np.concatenate(all_eids) if all_eids
                else np.zeros(0, np.int64),)
    return _out(out, row.device)
