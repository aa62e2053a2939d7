"""The kernel tail's ops that have no case in the OpTest harness, held
against the reference on the CPU (the harness's cases are in
`test_torch_op_parity.py`).

The same numpy inputs, made from a seed, go through the reference's op
and the port's, each through its package's eager dispatch. Inputs follow
the reference's own suites (`test_vision_ops.py`, `test_tail_r4.py`,
`test_tail_r5*.py`, `test_graph_ops.py`, `test_yolo_hsigmoid_loss.py`,
`test_rnn.py`). Tolerances:
- host ops (`nms`, `multiclass_nms3`, `beam_search`, the metric and
  tree ops, ...) and every integer output: exactly equal;
- float outputs rtol 1e-5, atol 1e-6 (`EXACT` cases: bit for bit);
- gradients of the weighted sum of the float outputs: rtol 1e-5, atol
  1e-6 times the gradient's largest entry (`rnn` in every mode and
  direction, with `seq_lens`).
The ops whose draws the port makes with its own generators (`nce`'s
negatives, `tdm_sampler`, the graph samplers when they sample, `dpsgd`'s
noise) are held on what does not depend on the draw. Every op that waits
for another item raises NotImplementedError naming it.
"""
import jax
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.core.tensor import Tensor as RefTensor
from paddle_tpu.ops.dispatch import OPS as R
from paddle_tpu_torch import _C_ops
from paddle_tpu_torch.core import place
from paddle_tpu_torch.core.tensor import Tensor as PortTensor
from paddle_tpu_torch.ops.dispatch import OPS as P
from paddle_tpu_torch.ops.kernels._util import WAITING
from torch_threads import one_torch_thread

one_torch_thread()

RTOL, ATOL = 1e-5, 1e-6
RS = np.random.RandomState


@pytest.fixture(autouse=True)
def _cpu():
    place.set_device("cpu")
    yield
    place._current[0] = None


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    prev = ref.get_flags("FLAGS_eager_dispatch_cache")
    ref.set_flags({"FLAGS_eager_dispatch_cache": False})
    yield
    ref.set_flags(prev)


def _wrap(pd, a, grads, path=()):
    if isinstance(a, np.ndarray) and a.dtype.kind not in "OUS":
        t = pd.to_tensor(a)
        if path in grads:
            t.stop_gradient = False
            grads[path] = t
        return t
    if isinstance(a, (list, tuple)):
        return type(a)(_wrap(pd, v, grads, path + (i,))
                       for i, v in enumerate(a))
    return a


def _host(t):
    if isinstance(t, (RefTensor, PortTensor)):
        a = t.numpy()
    else:
        a = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                       else t)
    return np.asarray(a)


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [] if out is None else [out]


def run(pd, name, args, kwargs=None, grad=()):
    """(output leaves, {path: input Tensor}) of op `name` in package pd;
    `grad` names the argument paths that take a gradient."""
    grads = {tuple(g) if isinstance(g, tuple) else (g,): None for g in grad}
    ins = [_wrap(pd, a, grads, (i,)) for i, a in enumerate(args)]
    kw = {k: _wrap(pd, v, grads, (k,)) for k, v in (kwargs or {}).items()}
    ops = R if pd is ref else P
    return _leaves(ops[name](*ins, **kw)), grads


def _weights(outs):
    rs = RS(123)
    return [rs.uniform(0.5, 1.5, _host(o).shape).astype(np.float32)
            if _host(o).dtype.kind == "f" else None for o in outs]


def _ref_jitted(name, args, kwargs, grad):
    """The reference op's outputs, and the gradients of the weighted sum
    of its float outputs for the argument paths in `grad`, from one
    jitted function of its array inputs (the rest fixed): one compile in
    place of one an op of its eager dispatch."""
    slots = []

    def find(a, path):
        if isinstance(a, np.ndarray) and a.dtype.kind not in "OUS":
            slots.append(path)
        elif isinstance(a, (list, tuple)):
            for i, v in enumerate(a):
                find(v, path + (i,))

    tree = {"args": list(args), "kw": dict(kwargs or {})}
    for i, a in enumerate(tree["args"]):
        find(a, ("args", i))
    for k, v in tree["kw"].items():
        find(v, ("kw", k))

    def rebuild(a, path, vals):
        if path in vals:
            return vals[path]
        if isinstance(a, (list, tuple)):
            return type(a)(rebuild(v, path + (i,), vals)
                           for i, v in enumerate(a))
        return a

    def f(*arrs):
        vals = dict(zip(slots, arrs))
        args_ = [rebuild(a, ("args", i), vals)
                 for i, a in enumerate(tree["args"])]
        kw_ = {k: rebuild(v, ("kw", k), vals) for k, v in tree["kw"].items()}
        out = R[name]._kernel(*args_, **kw_)
        return [o for o in jax.tree.leaves(out) if o is not None]

    def get(path):
        t = tree[path[0]]
        for k in path[1:]:
            t = t[k]
        return t

    arrs = [get(pth) for pth in slots]
    paths = [((k,) if isinstance(k, int) else tuple(k)) for k in grad]
    gpaths = [("args",) + pth if isinstance(pth[0], int) else ("kw",) + pth
              for pth in paths]
    argnums = tuple(slots.index(g) for g in gpaths)
    outs = [np.asarray(o) for o in jax.jit(f)(*arrs)]
    if not grad:
        return outs, {}
    w = _weights(outs)

    def loss(*a):
        return sum((o * wk).sum() for o, wk in zip(f(*a), w)
                   if wk is not None)

    gs = jax.jit(jax.grad(loss, argnums))(*arrs)
    return outs, {pth: np.asarray(g) for pth, g in zip(paths, gs)}


# the reference's host ops (numpy on their inputs, side effects) run
# through its eager dispatch; the rest jitted
HOST_OPS = {
    "nms", "multiclass_nms3", "multiclass_nms", "bipartite_match",
    "distribute_fpn_proposals", "generate_proposals",
    "legacy_generate_proposals", "yolo_box_post", "beam_search",
    "beam_search_decode", "sequence_unpad", "chunk_eval", "detection_map",
    "collect_fpn_proposals", "merge_selected_rows",
    "enable_check_model_nan_inf", "disable_check_model_nan_inf", "data",
    "share_buffer", "dgc", "distributed_fused_lamb_init", "pyramid_hash",
    "graph_sample_neighbors", "weighted_sample_neighbors", "reindex_graph",
    "graph_khop_sampler"}


def check(name, args, kwargs=None, grad=(), exact=False):
    """The port's op against the reference's on the same inputs: the
    reference jitted (`_ref_jitted`), or a host op through its eager
    dispatch."""
    if name in HOST_OPS:
        r, rg = run(ref, name, args, kwargs, grad)
    else:
        r, rg = _ref_jitted(name, args, kwargs, grad)
    p, pg = run(port, name, args, kwargs, grad)
    assert len(p) == len(r), (len(p), len(r))
    for k, (ra, pa) in enumerate(zip(r, p)):
        ra, pa = _host(ra), _host(pa)
        assert pa.shape == ra.shape, (name, k, pa.shape, ra.shape)
        if ra.dtype.kind == "f" and not exact:
            assert pa.dtype.kind == "f", (name, k, pa.dtype)
            np.testing.assert_allclose(pa, ra, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} output {k}")
        else:
            assert pa.dtype.kind == ra.dtype.kind, (name, k, pa.dtype,
                                                    ra.dtype)
            np.testing.assert_array_equal(pa, ra, err_msg=f"{name} {k}")
    if not grad:
        return p
    w = _weights(p)
    loss = sum((o * port.to_tensor(wk)).sum() for o, wk in zip(p, w)
               if wk is not None)
    loss.backward()
    for path in pg:
        gr = np.asarray(rg[path], np.float64)
        gp = np.asarray(pg[path].grad.numpy(), np.float64)
        np.testing.assert_allclose(gp, gr, rtol=RTOL,
                                   atol=ATOL * max(np.abs(gr).max(), 1.0),
                                   err_msg=f"{name} grad of {path}")
    return p


# ---------------------------------------------------------------------------
# detection: boxes, selection, proposals
# ---------------------------------------------------------------------------


def _boxes(rs, n, size=32.0):
    xy = rs.uniform(0, size * 0.7, (n, 2))
    wh = rs.uniform(2, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _nms_inputs(seed, n=40):
    rs = RS(seed)
    b = _boxes(rs, n)
    b[5] = b[3]                       # an exact duplicate: IoU 1
    b[7] = b[6] + 0.5                 # a near duplicate
    sc = np.round(rs.rand(n), 1).astype(np.float32)   # ties of score
    return b, sc


@pytest.mark.parametrize("thr,top_k", [(0.3, -1), (0.5, 5), (0.0, -1)])
def test_nms_keeps_the_reference_indices(thr, top_k):
    b, sc = _nms_inputs(0)
    check("nms", [b, sc], {"iou_threshold": thr, "top_k": top_k})


@pytest.mark.parametrize("seed", range(20))
def test_nms_exact_on_seeded_ties(seed):
    """Random boxes with exact duplicates, rounded corners (IoUs on the
    threshold), zero-area boxes and tied scores: the kept indices are
    the reference's for each threshold and top_k."""
    rs = RS(100 + seed)
    n = rs.randint(1, 300)
    xy = rs.uniform(0, 50, (n, 2))
    wh = rs.uniform(0, 20, (n, 2))
    wh[rs.rand(n) < 0.1] = 0
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if seed % 2:
        b = np.round(b)
    if n > 3:
        b[1] = b[0]
    sc = np.round(rs.rand(n), 1 + seed % 2).astype(np.float32)
    check("nms", [b, sc], {"iou_threshold": (0.0, 0.3, 0.5, 1 / 3)[seed % 4],
                           "top_k": (-1, 1, 7, 50)[seed // 5 % 4]})


def test_nms_without_scores_walks_the_input_order():
    b, _ = _nms_inputs(1)
    check("nms", [b], {"iou_threshold": 0.4})


@pytest.mark.parametrize("background,keep", [(-1, 10), (0, 100)])
def test_multiclass_nms3_exact(background, keep):
    rs = RS(2)
    bb = np.stack([_boxes(rs, 30), _boxes(rs, 30)])
    sc = np.round(rs.rand(2, 3, 30), 2).astype(np.float32)
    check("multiclass_nms3", [bb, sc], {
        "score_threshold": 0.3, "nms_top_k": 12, "keep_top_k": keep,
        "nms_threshold": 0.45, "background_label": background}, exact=True)


def test_multiclass_nms_v1_exact():
    rs = RS(3)
    bb = _boxes(rs, 25)[None]
    sc = rs.rand(1, 4, 25).astype(np.float32)
    check("multiclass_nms", [bb, sc], {"score_threshold": 0.2,
                                       "nms_threshold": 0.5}, exact=True)


@pytest.mark.parametrize("order", [False, True])
def test_prior_box(order):
    inp = np.zeros((1, 3, 4, 5), np.float32)
    img = np.zeros((1, 3, 32, 40), np.float32)
    check("prior_box", [inp, img], {
        "min_sizes": (4.0, 8.0), "max_sizes": (8.0, 16.0),
        "aspect_ratios": (2.0, 3.0), "flip": True, "clip": True,
        "min_max_aspect_ratios_order": order})


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match(match_type):
    dist = RS(4).rand(5, 4).astype(np.float32)
    check("bipartite_match", [dist], {"match_type": match_type,
                                      "dist_threshold": 0.3}, exact=True)


def test_distribute_fpn_proposals():
    rs = RS(5)
    rois = np.concatenate([_boxes(rs, 6, 64.0), np.array(
        [[0, 0, 300, 300]], np.float32)])
    check("distribute_fpn_proposals", [rois, 2, 5, 4, 224], exact=True)


def _proposal_inputs():
    rs = RS(12)
    N, A, H, W = 2, 3, 4, 4
    scores = rs.rand(N, A, H, W).astype(np.float32)
    deltas = (rs.randn(N, A * 4, H, W) * 0.1).astype(np.float32)
    anchors = np.zeros((H, W, A, 4), np.float32)
    for i in range(H):
        for j in range(W):
            for a in range(A):
                cx, cy, sz = j * 8 + 4, i * 8 + 4, 8 * (a + 1)
                anchors[i, j, a] = [cx - sz / 2, cy - sz / 2,
                                    cx + sz / 2, cy + sz / 2]
    return scores, deltas, anchors, np.ones_like(anchors)


def test_generate_proposals():
    scores, deltas, anchors, var = _proposal_inputs()
    im = np.array([[32, 32], [30, 28]], np.float32)
    check("generate_proposals", [scores, deltas, im, anchors, var],
          {"pre_nms_top_n": 20, "post_nms_top_n": 5, "nms_thresh": 0.7})


def test_legacy_generate_proposals():
    scores, deltas, anchors, var = _proposal_inputs()
    im = np.array([[32, 32, 1.0], [30, 28, 1.0]], np.float32)
    check("legacy_generate_proposals", [scores, deltas, im, anchors, var],
          {"pre_nms_top_n": 20, "post_nms_top_n": 6, "nms_thresh": 0.6})


def test_yolo_box_post():
    """The same rows kept; the decoded boxes to the float tolerance."""
    rs = RS(6)
    heads = [rs.randn(2, 3 * 7, s, s).astype(np.float32) for s in (4, 2, 1)]
    check("yolo_box_post", heads + [np.array([[32, 32], [32, 32]], np.int32),
                                    np.array([[1.5], [2.0]], np.float32)],
          {"anchors0": [2, 3, 4, 5, 6, 7], "anchors1": [8, 9, 10, 11, 12, 13],
           "anchors2": [14, 15, 16, 17, 18, 19], "class_num": 2,
           "conf_thresh": 0.3, "nms_threshold": 0.45})


def _yolo_loss_inputs(seed):
    rs = RS(seed)
    cls, mask = 4, (0, 1, 2)
    x = (rs.randn(2, len(mask) * (5 + cls), 5, 5) * 0.5).astype(np.float32)
    gt = rs.uniform(0.1, 0.9, (2, 4, 4)).astype(np.float32)
    gt[..., 2:] = rs.uniform(0.05, 0.4, (2, 4, 2))
    gt[1, 3] = 0.0                                 # an empty slot
    lab = rs.randint(0, cls, (2, 4)).astype(np.int32)
    return x, gt, lab


@pytest.mark.parametrize("smooth,score", [(True, False), (False, True)])
def test_yolo_loss_and_its_gradient(smooth, score):
    x, gt, lab = _yolo_loss_inputs(7)
    kw = {"anchors": (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119),
          "anchor_mask": (0, 1, 2), "class_num": 4, "ignore_thresh": 0.5,
          "downsample_ratio": 32, "use_label_smooth": smooth}
    args = [x, gt, lab]
    if score:
        args.append(RS(8).uniform(0.5, 1.0, (2, 4)).astype(np.float32))
    check("yolo_loss", args, kw, grad=(0,))


def test_hsigmoid_loss_and_its_gradient():
    rs = RS(9)
    x = rs.randn(5, 6).astype(np.float32)
    lab = rs.randint(0, 7, (5,)).astype(np.int64)
    w = rs.randn(6, 6).astype(np.float32)
    b = rs.randn(6, 1).astype(np.float32)
    check("hsigmoid_loss", [x, lab, 7, w, b], grad=(0, 3))


# ---------------------------------------------------------------------------
# rnn: every mode and direction, with and without seq_lens
# ---------------------------------------------------------------------------

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _rnn_inputs(mode, bidir, lens, seed=10):
    rs = RS(seed)
    B, T, I, H, L = 3, 5, 4, 6, 2
    D = 2 if bidir else 1
    G = _GATES[mode]
    x = rs.randn(B, T, I).astype(np.float32)
    h0 = rs.randn(L * D, B, H).astype(np.float32)
    c0 = rs.randn(L * D, B, H).astype(np.float32) if mode == "LSTM" else None
    ws = []
    for layer in range(L):
        for d in range(D):
            n_in = I if layer == 0 else H * D
            ws.append([(rs.randn(G * H, n_in) * 0.3).astype(np.float32),
                       (rs.randn(G * H, H) * 0.3).astype(np.float32),
                       (rs.randn(G * H) * 0.1).astype(np.float32),
                       None if d else (rs.randn(G * H) * 0.1).astype(
                           np.float32)])
    sl = np.array([5, 3, 1], np.int64) if lens else None
    kw = {"mode": mode, "num_layers": L, "is_bidirec": bidir,
          "activation": "relu" if mode == "RNN_RELU" else "tanh"}
    return [x, h0, c0, ws, sl], kw


@pytest.mark.parametrize("lens", [False, True])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", list(_GATES))
def test_rnn_outputs_and_gradients(mode, bidir, lens):
    args, kw = _rnn_inputs(mode, bidir, lens)
    grad = [(0,), (1,), (3, 0, 0), (3, 0, 1), (3, 0, 2)]
    if mode == "LSTM":
        grad.append((2,))
    check("rnn", args, kw, grad=grad)


def test_rnn_dropout_mask_between_layers():
    args, kw = _rnn_inputs("GRU", True, False, seed=11)
    mask = (RS(12).rand(1, 3, 12) < 0.7).astype(np.float32) / 0.7
    check("rnn", args + [mask], kw, grad=[(0,)])


def test_rnn_time_major():
    args, kw = _rnn_inputs("LSTM", False, False, seed=13)
    args[0] = np.ascontiguousarray(args[0].transpose(1, 0, 2))
    check("rnn", args, dict(kw, time_major=True), grad=[(0,)])


@pytest.mark.parametrize("name", ["lstm", "gru"])
def test_fluid_lstm_gru_names(name):
    rs = RS(14)
    G = 4 if name == "lstm" else 3
    x = rs.randn(2, 4, 3).astype(np.float32)
    h0 = rs.randn(1, 2, 5).astype(np.float32)
    w = [(rs.randn(G * 5, 3) * 0.3).astype(np.float32),
         (rs.randn(G * 5, 5) * 0.3).astype(np.float32),
         (rs.randn(G * 5) * 0.1).astype(np.float32),
         (rs.randn(G * 5) * 0.1).astype(np.float32)]
    args = [x, h0] + ([rs.randn(1, 2, 5).astype(np.float32)]
                      if name == "lstm" else []) + w
    check(name, args, grad=(0,))


def test_cudnn_lstm_name():
    rs = RS(15)
    x = rs.randn(4, 2, 3).astype(np.float32)
    h0 = rs.randn(1, 2, 5).astype(np.float32)
    c0 = rs.randn(1, 2, 5).astype(np.float32)
    wl = [[(rs.randn(20, 3) * 0.3).astype(np.float32),
           (rs.randn(20, 5) * 0.3).astype(np.float32),
           (rs.randn(20) * 0.1).astype(np.float32),
           (rs.randn(20) * 0.1).astype(np.float32)]]
    check("cudnn_lstm", [x, h0, c0], {"weight_list": wl})


# ---------------------------------------------------------------------------
# beam search, LoD sequence ops, strings, metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accumulated", [True, False])
def test_beam_search_step(accumulated):
    rs = RS(16)
    pre_ids = np.array([[3], [0], [5], [7]], np.int64)   # row 1 finished
    pre_sc = np.round(rs.randn(4, 1), 2).astype(np.float32)
    ids = rs.randint(1, 20, (4, 3)).astype(np.int64)
    sc = np.round(rs.rand(4, 3), 1).astype(np.float32)   # ties
    if accumulated:
        sc = np.log(sc + 0.05).astype(np.float32)
    check("beam_search", [pre_ids, pre_sc, ids, sc, 2, 0],
          {"is_accumulated": accumulated}, exact=True)


def test_beam_search_decode():
    rs = RS(17)
    steps = [rs.randint(0, 9, (4,)).astype(np.int64) for _ in range(3)]
    parents = [rs.randint(0, 4, (4,)).astype(np.int32) for _ in range(3)]
    scores = [rs.rand(4).astype(np.float32) for _ in range(3)]
    check("beam_search_decode", [steps, parents, scores],
          {"beam_size": 2}, exact=True)


LOD = [0, 3, 7, 8]


def test_sequence_conv_and_its_gradient():
    rs = RS(18)
    x = rs.randn(8, 4).astype(np.float32)
    f = rs.randn(12, 5).astype(np.float32)
    check("sequence_conv", [x, f, LOD], {"context_length": 3},
          grad=(0, 1))


def test_sequence_softmax_and_its_gradient():
    x = RS(19).randn(8).astype(np.float32)
    check("sequence_softmax", [x, LOD], grad=(0,))


def test_sequence_expand_pad_unpad():
    rs = RS(20)
    x = rs.randn(8, 3).astype(np.float32)
    check("sequence_expand", [x[:3], [0, 2, 3, 6]])
    check("sequence_expand", [x, [0, 1, 3, 4]], {"x_lod": LOD})
    check("sequence_pad", [x, np.array([0.5], np.float32), LOD],
          {"padded_length": 5})
    padded = rs.randn(3, 5, 3).astype(np.float32)
    check("sequence_unpad", [padded, np.array([2, 5, 1], np.int64)])


@pytest.mark.parametrize("batched", [True, False])
def test_row_conv_and_its_gradient(batched):
    rs = RS(21)
    x = rs.randn(2, 5, 4).astype(np.float32) if batched \
        else rs.randn(8, 4).astype(np.float32)
    f = rs.randn(3, 4).astype(np.float32)
    check("row_conv", [x, f] + ([] if batched else [LOD]), grad=(0, 1))


def test_strings_lower_upper():
    s = np.array([["Hello", "WORLD"], ["MiXeD", "x"]], dtype=object)
    for name in ("lower", "upper"):
        r, _ = run(ref, name, [s])
        p, _ = run(port, name, [s])
        np.testing.assert_array_equal(np.asarray(p[0]), np.asarray(r[0]))


@pytest.mark.parametrize("scheme", ["IOB", "IOE", "IOBES", "plain"])
def test_chunk_eval(scheme):
    rs = RS(22)
    n = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme] * 3
    inf = rs.randint(0, n + 1, (14,)).astype(np.int64)
    lab = inf.copy()
    lab[rs.rand(14) < 0.3] = rs.randint(0, n + 1)
    check("chunk_eval", [inf, lab, 3],
          {"chunk_scheme": scheme, "seq_length": np.array([6, 8])},
          exact=True)


@pytest.mark.parametrize("ap_type", ["integral", "11point"])
def test_detection_map(ap_type):
    rs = RS(23)
    gt_boxes = _boxes(rs, 6)
    gt = np.concatenate([rs.randint(1, 3, (6, 1)), gt_boxes], 1).astype(
        np.float32)
    det_boxes = gt_boxes + rs.uniform(-2, 2, gt_boxes.shape)
    det = np.concatenate([gt[:, :1], np.round(rs.rand(6, 1), 2),
                          det_boxes], 1).astype(np.float32)
    check("detection_map", [det, gt, 3], {"ap_type": ap_type}, exact=True)


# ---------------------------------------------------------------------------
# tail_r5b / tail_r5c / tail_r5d
# ---------------------------------------------------------------------------


def test_anchor_generator():
    check("anchor_generator", [np.zeros((1, 8, 3, 4), np.float32)],
          {"anchor_sizes": (32.0, 64.0), "aspect_ratios": (0.5, 1.0, 2.0),
           "stride": (16.0, 16.0)})


def test_hash_bit_for_bit():
    ids = RS(24).randint(0, 10 ** 6, (6, 2)).astype(np.int64)
    check("hash", [ids], {"num_hash": 3, "mod_by": 1000}, exact=True)
    check("hash", [ids[:, :1]], {"num_hash": 2, "mod_by": 97}, exact=True)


def test_lookup_table_dequant():
    rs = RS(25)
    codes = rs.randint(0, 256, (5, 8)).astype(np.uint8)
    packed = codes.view(np.float32)                       # [5, 2]
    lo = rs.uniform(-1, 0, (5, 1)).astype(np.float32)
    w = np.concatenate([lo, lo + 2.0, packed], 1)
    ids = np.array([[0], [3], [4], [7]], np.int64)
    check("lookup_table_dequant", [w, ids], {"padding_idx": 3})


@pytest.mark.parametrize("sampler", [0, 1])
def test_nce_true_classes_and_its_cost(sampler):
    rs = RS(26)
    x = rs.randn(4, 5).astype(np.float32)
    lab = rs.randint(0, 12, (4, 2)).astype(np.int64)
    w = rs.randn(12, 5).astype(np.float32)
    b = rs.randn(12).astype(np.float32)
    kw = {"num_total_classes": 12, "num_neg_samples": 3, "sampler": sampler,
          "seed": 5}
    r, _ = run(ref, "nce", [x, lab, w, b], kw)
    p, _ = run(port, "nce", [x, lab, w, b], kw)
    cost, logits, samples = (_host(v) for v in p)
    assert cost.shape == (4, 1) and logits.shape == (4, 5)
    # the true classes' columns do not depend on the negatives
    np.testing.assert_array_equal(samples[:, :2], _host(r[2])[:, :2])
    np.testing.assert_allclose(logits[:, :2], _host(r[1])[:, :2],
                               rtol=RTOL, atol=ATOL)
    assert ((samples >= 0) & (samples < 12)).all()
    # the cost is the NCE formula on the port's own samples
    want = np.einsum("bd,bsd->bs", x, w[samples]) + b[samples]
    np.testing.assert_allclose(logits, want, rtol=RTOL, atol=ATOL)
    if sampler:
        p_s = np.log((samples + 2.0) / (samples + 1.0)) / np.log(13.0)
    else:
        p_s = np.full(samples.shape, 1.0 / 12)
    o, b1 = np.exp(want), 3 * p_s
    c = (-np.log(o[:, :2] / (o[:, :2] + b1[:, :2]) + 1e-20)).sum(1) \
        + (-np.log(b1[:, 2:] / (o[:, 2:] + b1[:, 2:]) + 1e-20)).sum(1)
    np.testing.assert_allclose(cost[:, 0], c, rtol=1e-5, atol=1e-6)


def test_average_accumulates_spill_and_flush():
    rs = RS(27)
    p = rs.randn(3, 2).astype(np.float32)
    sums = [rs.randn(3, 2).astype(np.float32) for _ in range(3)]
    for acc, upd in ((9999, 16383), (5, 7)):
        check("average_accumulates_",
              [p] + sums + [np.array([acc], np.int64), np.array([4], np.int64),
                            np.array([upd], np.int64)],
              {"average_window": 0.5, "min_average_window": 10000})


def test_collect_fpn_proposals():
    rs = RS(28)
    rois = [_boxes(rs, 5), _boxes(rs, 4)]
    scores = [np.round(rs.rand(5), 1).astype(np.float32),
              np.round(rs.rand(4), 1).astype(np.float32)]
    nums = [np.array([2, 3], np.int32), np.array([3, 1], np.int32)]
    check("collect_fpn_proposals", [rois, scores, nums], {"post_nms_topn": 6},
          exact=True)


def test_match_matrix_tensor():
    rs = RS(29)
    check("match_matrix_tensor", [rs.randn(5, 3).astype(np.float32),
                                  rs.randn(6, 3).astype(np.float32),
                                  rs.randn(3, 2, 3).astype(np.float32),
                                  [0, 2, 5], [0, 4, 6]], {"dim_t": 2},
          grad=(0, 2))


def test_merge_selected_rows():
    rs = RS(30)
    check("merge_selected_rows", [np.array([4, 1, 4, 0, 1], np.int64),
                                  rs.randn(5, 3).astype(np.float32)])


def _tree():
    # rows: [item, layer, ancestor, child0, child1]; node 0 is padding
    return np.array([[0, 0, 0, 0, 0], [1, 1, 0, 3, 4], [2, 1, 0, 5, 6],
                     [3, 2, 1, 0, 0], [4, 2, 1, 0, 0], [5, 2, 2, 0, 0],
                     [6, 2, 2, 0, 0]], np.int64)


def test_tdm_child():
    check("tdm_child", [np.array([[1], [2], [3], [0]], np.int64), _tree()],
          {"child_nums": 2}, exact=True)


def test_tdm_sampler_positives_and_layer_membership():
    travel = np.array([[1, 3], [2, 6], [1, 0]], np.int64)
    layer = np.array([1, 2, 3, 4, 5, 6], np.int64)
    x = np.array([0, 1, 2], np.int64)
    kw = {"neg_samples_num_list": (1, 2), "layer_offset_lod": (0, 2, 6),
          "seed": 3}
    r, _ = run(ref, "tdm_sampler", [x, travel, layer], kw)
    p, _ = run(port, "tdm_sampler", [x, travel, layer], kw)
    out, lab, mask = (_host(v) for v in p)
    rout, rlab, rmask = (_host(v) for v in r)
    assert out.dtype == rout.dtype and out.shape == rout.shape
    pos_cols = [0, 2]                          # a positive before each layer
    np.testing.assert_array_equal(out[:, pos_cols], rout[:, pos_cols])
    np.testing.assert_array_equal(lab, rlab)
    np.testing.assert_array_equal(mask, rmask)
    for col, (lo, hi) in ((1, (0, 2)), (3, (2, 6)), (4, (2, 6))):
        alive = mask[:, col] == 1
        pos = out[:, 2 if col > 1 else 0]
        assert np.isin(out[alive, col], layer[lo:hi]).all()
        assert (out[alive, col] != pos[alive]).all()
        assert (out[~alive, col] == 0).all()


def test_dpsgd_without_noise_is_exact():
    rs = RS(31)
    p, g = rs.randn(3, 4).astype(np.float32), rs.randn(3, 4).astype(
        np.float32) * 5
    check("dpsgd", [p, g, 0.1], {"clip": 1.0, "batch_size": 4.0,
                                 "sigma": 0.0})
    # with noise: one shared draw moves every element alike
    out = _host(run(port, "dpsgd", [p, g, 0.1], {
        "clip": 1.0, "batch_size": 4.0, "sigma": 1.0, "seed": 2})[0][0])
    base = _host(run(port, "dpsgd", [p, g, 0.1], {
        "clip": 1.0, "batch_size": 4.0, "sigma": 0.0})[0][0])
    shift = out - base
    np.testing.assert_allclose(shift, shift.flat[0], atol=1e-6)


def test_accuracy_check():
    rs = RS(32)
    x = rs.randn(4, 3).astype(np.float32)
    y = x + rs.choice([0.0, 1e-7, 1e-2], (4, 3)).astype(np.float32)
    y[0, 0] = x[0, 0] = np.nan
    check("accuracy_check", [x, y], {"equal_nan": True})


def test_check_model_nan_inf_flag_ops():
    x = RS(33).randn(3).astype(np.float32)
    check("enable_check_model_nan_inf", [x])
    assert port.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
    check("disable_check_model_nan_inf", [x])
    assert not port.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]


def test_calc_reduced_attn_scores():
    rs = RS(34)
    q = rs.randn(2, 4, 2, 8).astype(np.float32)
    k = rs.randn(2, 5, 2, 8).astype(np.float32)
    lse = rs.randn(2, 2, 4).astype(np.float32) + 3.0
    check("calc_reduced_attn_scores", [q, k, lse])


def test_data_and_share_buffer():
    check("data", [], {"shape": (2, -1, 3), "dtype": "float32"})
    rs = RS(35)
    check("share_buffer", [[rs.randn(2).astype(np.float32),
                            rs.randn(3).astype(np.float32)]])


@pytest.mark.parametrize("nesterov", [True, False])
def test_dgc(nesterov):
    rs = RS(36)
    u, v, g, p = (rs.randn(4, 5).astype(np.float32) for _ in range(4))
    check("dgc", [u, v, g, p, np.array([5.0], np.float32),
                  np.array([2.0], np.float32)],
          {"use_nesterov": nesterov, "sparsity": (0.5,),
           "rampup_begin_step": 0.0, "rampup_step": 1.0, "regular_type": 2,
           "regular_coeff": 0.01}, exact=True)


def test_distributed_fused_lamb_init():
    rs = RS(37)
    params = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(
        np.float32)]
    grads = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(
        np.float32)]
    check("distributed_fused_lamb_init", [params, grads], {"alignment": 8})


def test_fused_scale_bias_relu_conv_bn():
    rs = RS(38)
    check("fused_scale_bias_relu_conv_bn", [
        rs.randn(2, 4, 4, 3).astype(np.float32),
        rs.randn(5, 3, 3, 3).astype(np.float32),
        rs.rand(3).astype(np.float32), rs.randn(3).astype(np.float32),
        rs.rand(5).astype(np.float32), rs.randn(5).astype(np.float32),
        rs.randn(5).astype(np.float32), rs.rand(5).astype(np.float32)],
        {"paddings": (1, 1)})


@pytest.mark.parametrize("fuse_add", [False, True])
def test_fused_dconv_drelu_dbn(fuse_add):
    rs = RS(39)
    n, h, w, ci, co = 2, 4, 4, 3, 5

    def a(*s):
        return rs.randn(*s).astype(np.float32)

    check("fused_dconv_drelu_dbn", [
        a(n, h, w, co), a(co, ci, 3, 3), a(n, h, w, co), None, a(ci), a(ci),
        a(n, h, w, ci), a(ci), np.abs(a(ci)) + 0.5, a(ci), a(ci),
        a(n, h, w, ci)], {"paddings": (1, 1), "fuse_add": fuse_add})


@pytest.mark.parametrize("pooltype", ["SUM", "AVERAGE", "MAX"])
def test_sequence_pool_fusions(pooltype):
    rs = RS(40)
    xs = [rs.randn(8, 4).astype(np.float32), rs.randn(8, 4).astype(
        np.float32)]
    lod = [0, 3, 3, 8]                               # an empty sequence
    cvm = np.ones((3, 2), np.float32)
    check("fused_seqpool_cvm", [xs, cvm, lod], {"pooltype": pooltype,
                                                "use_cvm": False})
    check("fusion_seqpool_concat", [xs, lod], {"pooltype": pooltype})
    check("fusion_seqpool_cvm_concat", [xs, cvm, lod],
          {"pooltype": pooltype})


def test_fusion_seqconv_and_seqexpand():
    rs = RS(41)
    x = rs.randn(8, 4).astype(np.float32)
    check("fusion_seqconv_eltadd_relu", [x, rs.randn(12, 5).astype(
        np.float32), rs.randn(5).astype(np.float32), LOD],
        {"context_length": 3, "context_start": -1})
    check("fusion_seqexpand_concat_fc", [
        [x, rs.randn(3, 2).astype(np.float32)],
        rs.randn(6, 3).astype(np.float32), rs.randn(3).astype(np.float32),
        LOD], {"fc_activation": "tanh"})


def test_attention_lstm():
    rs = RS(42)
    M, D = 3, 4
    check("attention_lstm", [
        rs.randn(5, M).astype(np.float32), rs.randn(2, D).astype(np.float32),
        rs.randn(2, D).astype(np.float32),
        rs.randn(M + D, 1).astype(np.float32),
        rs.randn(1, 1).astype(np.float32), None, None,
        (rs.randn(D + M, 4 * D) * 0.3).astype(np.float32),
        rs.randn(1, 4 * D).astype(np.float32), [0, 2, 5]])


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_embedding_fc_lstm(reverse):
    rs = RS(43)
    D = 4
    check("fused_embedding_fc_lstm", [
        rs.randint(0, 8, (5, 1)).astype(np.int64),
        rs.randn(8, 4 * D).astype(np.float32),
        (rs.randn(D, 4 * D) * 0.3).astype(np.float32),
        rs.randn(1, 4 * D).astype(np.float32),
        rs.randn(2, D).astype(np.float32), rs.randn(2, D).astype(np.float32),
        [0, 2, 5]], {"is_reverse": reverse})


def test_pyramid_hash():
    rs = RS(44)
    check("pyramid_hash", [
        rs.randint(0, 50, (7, 1)).astype(np.int64),
        rs.randn(54, 1).astype(np.float32), np.zeros(0, np.int64),
        np.zeros(0, np.int64), [0, 3, 4, 7]],
        {"num_emb": 8, "space_len": 50, "pyramid_layer": 3, "rand_len": 4},
        exact=True)


# ---------------------------------------------------------------------------
# graph sampling
# ---------------------------------------------------------------------------

ROW = np.array([1, 2, 3, 0, 3, 4, 0, 1, 2, 4, 1, 2], np.int64)
COLPTR = np.array([0, 3, 6, 8, 10, 12], np.int64)
EIDS = np.arange(12, dtype=np.int64) * 10


def test_graph_sample_all_neighbors_exact():
    x = np.array([0, 2, 4], np.int64)
    check("graph_sample_neighbors", [ROW, COLPTR, x, EIDS],
          {"sample_size": -1, "return_eids": True}, exact=True)


def test_graph_sample_neighbors_draws_neighbors():
    x = np.array([0, 1, 4], np.int64)
    nb, cnt, eids = (_host(v) for v in run(
        port, "graph_sample_neighbors", [ROW, COLPTR, x, EIDS],
        {"sample_size": 2, "return_eids": True, "seed": 7})[0])
    assert cnt.tolist() == [2, 2, 2] and cnt.dtype == np.int32
    off = 0
    for v, c in zip(x, cnt):
        span = range(COLPTR[v], COLPTR[v + 1])
        picked = eids[off:off + c] // 10
        assert len(set(picked.tolist())) == c and set(picked) <= set(span)
        np.testing.assert_array_equal(nb[off:off + c], ROW[picked])
        off += c


def test_weighted_sample_neighbors():
    w = np.array([1, 0, 2, 1, 1, 0, 3, 1, 0, 2, 1, 1], np.float32)
    x = np.array([0, 1, 3], np.int64)
    # sample_size at least the positive-weight degree: the reference's
    # edges exactly
    check("weighted_sample_neighbors", [ROW, COLPTR, w, x, EIDS],
          {"sample_size": 3, "return_eids": True}, exact=True)
    nb, cnt = (_host(v) for v in run(
        port, "weighted_sample_neighbors", [ROW, COLPTR, w, x],
        {"sample_size": 1, "seed": 3})[0])
    assert cnt.tolist() == [1, 1, 1]
    for v, n in zip(x, nb):
        pos = [ROW[e] for e in range(COLPTR[v], COLPTR[v + 1]) if w[e] > 0]
        assert n in pos


def test_reindex_graph_exact():
    check("reindex_graph", [np.array([0, 2], np.int64),
                            np.array([1, 3, 4, 0, 5], np.int64),
                            np.array([3, 2], np.int32)], exact=True)


def test_graph_khop_sampler_full_neighborhoods_exact():
    check("graph_khop_sampler", [ROW, COLPTR, np.array([0, 3], np.int64),
                                 EIDS], {"sample_sizes": (5, 5),
                                         "return_eids": True}, exact=True)


# ---------------------------------------------------------------------------
# ops waiting for another item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(WAITING))
def test_waiting_op_raises_naming_its_item(name):
    op = WAITING[name]
    assert name not in P and not hasattr(_C_ops, name)
    item = op._waiting_item
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        op()
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        getattr(_C_ops, name)


def test_waiting_ops_are_the_collective_and_sparse_ones():
    """Since the collective layer (item 7a) only item 9's names wait; the
    collective ones are registered."""
    by_item = {7: set(), 9: set()}
    for name, op in WAITING.items():
        by_item[op._waiting_item].add(name)
    assert {"to_dense", "sparse_coo_tensor", "indices", "values"} \
        <= by_item[9]
    assert not by_item[7]
    assert {"p_send", "p_recv", "barrier", "global_scatter", "global_gather",
            "comm_init_all", "dist_concat", "fetch_barrier",
            "partial_allgather", "all_reduce", "c_allreduce_sum"} <= set(P)
    assert {"graph_send_recv", "segment_sum",
            "fake_quantize_dequantize_abs_max"} <= by_item[9]
    assert len(by_item[9]) == len(WAITING) == 17


# the ops this file holds (the OpTest twin's registry report reads it)
HELD_HERE = (
    "accuracy_check", "anchor_generator", "attention_lstm",
    "average_accumulates_", "beam_search", "beam_search_decode",
    "bipartite_match", "calc_reduced_attn_scores", "chunk_eval",
    "collect_fpn_proposals", "cudnn_lstm", "data", "detection_map", "dgc",
    "disable_check_model_nan_inf", "distribute_fpn_proposals",
    "distributed_fused_lamb_init", "enable_check_model_nan_inf",
    "fused_dconv_drelu_dbn", "fused_embedding_fc_lstm",
    "fused_scale_bias_relu_conv_bn", "fused_seqpool_cvm",
    "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc",
    "fusion_seqpool_concat", "fusion_seqpool_cvm_concat",
    "generate_proposals", "graph_khop_sampler", "graph_sample_neighbors",
    "gru", "hash", "hsigmoid_loss", "legacy_generate_proposals",
    "lookup_table_dequant", "lower", "lstm", "match_matrix_tensor",
    "merge_selected_rows", "multiclass_nms", "multiclass_nms3", "nce", "nms",
    "prior_box", "pyramid_hash", "reindex_graph", "rnn", "row_conv",
    "sequence_conv", "sequence_expand", "sequence_pad", "sequence_softmax",
    "sequence_unpad", "share_buffer", "tdm_child", "tdm_sampler", "upper",
    "weighted_sample_neighbors", "yolo_box_post", "yolo_loss",
)


def test_every_tail_op_without_a_harness_case_is_held_here():
    import test_op_generated as G

    tail_mods = ("vision_ops", "yolo_loss", "tail_math", "tail_nn",
                 "tail_seq", "rnn_ops", "tail_r4", "tail_r5", "tail_r5b",
                 "tail_r5c", "tail_r5d", "graph_ops")
    no_case = {n for n, f in P.items() if n not in G.SPECS
               and f._kernel.__module__.rsplit(".", 1)[-1] in tail_mods}
    # the collective names of these modules (item 7a) are held at world 1
    # by test_torch_op_parity.py and at world 4 by test_torch_collective.py
    collective = {"global_scatter", "global_gather", "p_send", "p_recv",
                  "p_send_array", "p_recv_array", "barrier",
                  "comm_init_all", "dist_concat", "fetch_barrier",
                  "partial_allgather"}
    assert collective <= no_case
    assert no_case - collective == set(HELD_HERE)
