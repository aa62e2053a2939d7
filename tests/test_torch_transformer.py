"""The norm and transformer layers, the port against the reference on
the CPU.

Each case builds one layer in both packages, carries the reference's
weights across (`state_dict()` as numpy arrays into `set_state_dict`;
random draws cannot match: jax threefry against torch Philox) and feeds
both the same seeded numpy inputs. Tolerances (f32; the packages sum in
different orders):
- outputs, input and parameter gradients (of sum(out * w), w seeded),
  and BatchNorm's running statistics: rtol 1e-5, atol 1e-5;
- the tiny BERT (2 layers, D 64, 4 heads, V 512, T 32, B 4, AdamW; the
  reference's model through its `jit.to_static`): the loss of each of 4
  steps within rtol 1e-5 of the reference's.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from torch_threads import one_torch_thread

one_torch_thread()

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    prev = ref.get_flags(["FLAGS_eager_dispatch_cache"])
    ref.set_flags({"FLAGS_eager_dispatch_cache": False})
    yield
    ref.set_flags(prev)


def _pair(build, seed=0):
    """(reference layer, port layer) from `build(pd)`, the port's weights
    the reference's; non-trivial affine weights from a seeded draw."""
    ref.seed(seed)
    rm, pm = build(ref), build(port)
    rs = np.random.RandomState(seed + 1)
    state = {}
    for k, v in rm.state_dict().items():
        a = np.asarray(v.numpy())
        if a.dtype.kind == "f" and k.split(".")[-1] in ("weight", "bias",
                                                        "scale"):
            a = a + rs.uniform(-0.5, 0.5, a.shape).astype(a.dtype)
        state[k] = a
    rm.set_state_dict(state)
    missing, unexpected = pm.set_state_dict(state)
    assert not missing and not unexpected
    return rm, pm


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _forward_backward(pd, m, xs, grads=True):
    ts = [pd.to_tensor(x) for x in xs]
    if grads:
        for t in ts:
            t.stop_gradient = False
    out = m(*ts)
    if grads:
        w = np.random.RandomState(7).uniform(0.5, 1.5, out.shape).astype(
            np.float32)
        (out * pd.to_tensor(w)).sum().backward()
    return out, ts


def _compare(rm, pm, xs, grads=True):
    ro, rts = _forward_backward(ref, rm, xs, grads)
    po, pts = _forward_backward(port, pm, xs, grads)
    _close(po.numpy(), ro.numpy(), "output")
    if not grads:
        return
    for i, (r, p) in enumerate(zip(rts, pts)):
        _close(p.grad.numpy(), r.grad.numpy(), f"input {i} gradient")
    rp = dict(rm.named_parameters())
    for name, p in pm.named_parameters():
        if rp[name].grad is None:
            assert p.grad is None, name
            continue
        _close(p.grad.numpy(), rp[name].grad.numpy(), f"{name} gradient")


def _x(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


NORMS = {
    "BatchNorm1D": (lambda pd: pd.nn.BatchNorm1D(6, momentum=0.8),
                    (4, 6, 5)),
    "BatchNorm2D": (lambda pd: pd.nn.BatchNorm2D(6), (4, 6, 5, 3)),
    "BatchNorm3D": (lambda pd: pd.nn.BatchNorm3D(3), (2, 3, 4, 3, 2)),
    "BatchNorm": (lambda pd: pd.nn.BatchNorm(6, epsilon=1e-3), (4, 6, 5, 3)),
    "SyncBatchNorm": (lambda pd: pd.nn.SyncBatchNorm(6), (4, 6, 5, 3)),
    "BatchNorm2D_NHWC": (lambda pd: pd.nn.BatchNorm2D(6, data_format="NHWC"),
                         (4, 5, 3, 6)),
    "LayerNorm": (lambda pd: pd.nn.LayerNorm(8), (3, 5, 8)),
    "LayerNorm_2d": (lambda pd: pd.nn.LayerNorm([5, 8]), (3, 5, 8)),
    "RMSNorm": (lambda pd: pd.nn.RMSNorm(8), (3, 5, 8)),
    "GroupNorm": (lambda pd: pd.nn.GroupNorm(3, 6), (4, 6, 5, 3)),
    "InstanceNorm2D": (lambda pd: pd.nn.InstanceNorm2D(6), (4, 6, 5, 3)),
    "LocalResponseNorm": (lambda pd: pd.nn.LocalResponseNorm(3),
                          (2, 6, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(NORMS))
def test_norm_layer_train_and_eval(name):
    build, shape = NORMS[name]
    rm, pm = _pair(build)
    xs = [_x(*shape)]
    _compare(rm, pm, xs)                 # train mode (BN: batch stats)
    if hasattr(rm, "_mean"):
        _close(pm._mean.numpy(), rm._mean.numpy(), "running mean")
        _close(pm._variance.numpy(), rm._variance.numpy(), "running var")
        _compare(rm, pm, [_x(*shape, seed=4)])   # a second update
        _close(pm._mean.numpy(), rm._mean.numpy(), "running mean, 2")
        _close(pm._variance.numpy(), rm._variance.numpy(), "running var, 2")
    rm.eval()
    pm.eval()
    _compare(rm, pm, [_x(*shape, seed=5)])


def test_sync_batch_norm_converts_and_keeps_statistics():
    def build(pd):
        return pd.nn.Sequential(pd.nn.Conv2D(3, 6, 3), pd.nn.BatchNorm2D(6))

    rm, pm = _pair(build)
    x = [_x(2, 3, 6, 6)]
    _compare(rm, pm, x)
    rm = ref.nn.SyncBatchNorm.convert_sync_batchnorm(rm)
    pm = port.nn.SyncBatchNorm.convert_sync_batchnorm(pm)
    assert isinstance(pm[1], port.nn.SyncBatchNorm)
    _close(pm[1]._mean.numpy(), rm[1]._mean.numpy(), "converted mean")
    _compare(rm, pm, [_x(2, 3, 6, 6, seed=9)])


D, H = 16, 4


def _mha(pd, **kw):
    return pd.nn.MultiHeadAttention(D, H, **kw)


MASKS = {
    "none": None,
    "bool": np.random.RandomState(11).rand(2, 1, 5, 7) > 0.3,
    "additive": np.random.RandomState(12).randn(2, H, 5, 7).astype(
        np.float32),
}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_multi_head_attention_masks(mask):
    rm, pm = _pair(lambda pd: _mha(pd, need_weights=True))
    q, kv = _x(2, 5, D), _x(2, 7, D, seed=4)
    m = MASKS[mask]

    def run(pd, mod):
        ts = [pd.to_tensor(a) for a in (q, kv)]
        for t in ts:
            t.stop_gradient = False
        mk = None if m is None else pd.to_tensor(m)
        out, weights = mod(ts[0], ts[1], ts[1], attn_mask=mk)
        (out.sum() + (weights * 2.0).sum()).backward()
        return out, weights, ts

    ro, rw, rts = run(ref, rm)
    po, pw, pts = run(port, pm)
    _close(po.numpy(), ro.numpy(), "output")
    _close(pw.numpy(), rw.numpy(), "weights")
    for r, p in zip(rts, pts):
        _close(p.grad.numpy(), r.grad.numpy(), "input gradient")


def test_multi_head_attention_incremental_cache():
    """Three decode steps through `Cache`, from an empty cache and from
    one seeded with a prefix."""
    rm, pm = _pair(_mha)
    steps = [_x(2, 1, D, seed=20 + i) for i in range(3)]
    prefix = _x(2, 3, D, seed=30)
    for start in ("empty", "prefix"):
        caches = {}
        for pd, m in ((ref, rm), (port, pm)):
            if start == "empty":
                c = m.gen_cache(pd.to_tensor(steps[0]))
            else:
                k, v = m.compute_kv(pd.to_tensor(prefix),
                                    pd.to_tensor(prefix))
                c = m.gen_cache(k, v)
            outs = []
            for s in steps:
                o, c = m(pd.to_tensor(s), cache=c)
                outs.append(o.numpy())
            caches[pd] = (outs, c.k.numpy(), c.v.numpy())
        for r, p in zip(caches[ref][0], caches[port][0]):
            _close(p, r, f"{start} step output")
        _close(caches[port][1], caches[ref][1], f"{start} cache k")
        _close(caches[port][2], caches[ref][2], f"{start} cache v")


def test_multi_head_attention_static_cache():
    rm, pm = _pair(_mha)
    mem, q = _x(2, 6, D, seed=40), _x(2, 2, D, seed=41)
    outs = []
    for pd, m in ((ref, rm), (port, pm)):
        sc = m.gen_cache(pd.to_tensor(mem), pd.to_tensor(mem),
                         type=pd.nn.MultiHeadAttention.StaticCache)
        out, sc2 = m(pd.to_tensor(q), pd.to_tensor(mem), pd.to_tensor(mem),
                     cache=sc)
        outs.append((out.numpy(), sc2.k.numpy()))
    _close(outs[1][0], outs[0][0], "output")
    _close(outs[1][1], outs[0][1], "static k")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder(normalize_before):
    def build(pd):
        layer = pd.nn.TransformerEncoderLayer(
            D, H, 32, dropout=0.0, activation="gelu",
            normalize_before=normalize_before)
        return pd.nn.TransformerEncoder(layer, 2, pd.nn.LayerNorm(D))

    rm, pm = _pair(build)
    x = _x(2, 6, D)
    mask = np.triu(np.full((6, 6), -1e4, np.float32), 1)[None, None]

    def run(pd, m):
        t = pd.to_tensor(x)
        t.stop_gradient = False
        out = m(t, src_mask=pd.to_tensor(mask))
        out.sum().backward()
        return out, t

    (ro, rt), (po, pt) = run(ref, rm), run(port, pm)
    _close(po.numpy(), ro.numpy(), "output")
    _close(pt.grad.numpy(), rt.grad.numpy(), "input gradient")


def test_encoder_incremental_cache():
    def build(pd):
        return pd.nn.TransformerEncoder(
            pd.nn.TransformerEncoderLayer(D, H, 32, dropout=0.0), 2)

    rm, pm = _pair(build)
    steps = [_x(2, 1, D, seed=50 + i) for i in range(3)]
    outs = {}
    for pd, m in ((ref, rm), (port, pm)):
        cache = m.gen_cache(pd.to_tensor(steps[0]))
        got = []
        for s in steps:
            o, cache = m(pd.to_tensor(s), cache=cache)
            got.append(o.numpy())
        outs[pd] = got
    for r, p in zip(outs[ref], outs[port]):
        _close(p, r, "step output")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder(normalize_before):
    def build(pd):
        layer = pd.nn.TransformerDecoderLayer(
            D, H, 32, dropout=0.0, normalize_before=normalize_before)
        return pd.nn.TransformerDecoder(layer, 2, pd.nn.LayerNorm(D))

    rm, pm = _pair(build)
    tgt, mem = _x(2, 5, D), _x(2, 7, D, seed=4)
    tmask = np.triu(np.full((5, 5), -1e4, np.float32), 1)[None, None]
    outs = []
    for pd, m in ((ref, rm), (port, pm)):
        ts = [pd.to_tensor(a) for a in (tgt, mem)]
        for t in ts:
            t.stop_gradient = False
        out = m(ts[0], ts[1], tgt_mask=pd.to_tensor(tmask))
        (out * out).sum().backward()
        outs.append((out.numpy(), ts[0].grad.numpy(), ts[1].grad.numpy()))
    for what, r, p in zip(("output", "tgt gradient", "memory gradient"),
                          outs[0], outs[1]):
        _close(p, r, what)


def test_decoder_caches():
    """Decoding step by step with the decoder's (incremental, static)
    caches."""
    def build(pd):
        return pd.nn.TransformerDecoder(
            pd.nn.TransformerDecoderLayer(D, H, 32, dropout=0.0), 2)

    rm, pm = _pair(build)
    mem = _x(2, 7, D, seed=4)
    steps = [_x(2, 1, D, seed=60 + i) for i in range(3)]
    outs = {}
    for pd, m in ((ref, rm), (port, pm)):
        memt = pd.to_tensor(mem)
        cache = m.gen_cache(memt)
        got = []
        for s in steps:
            o, cache = m(pd.to_tensor(s), memt, cache=cache)
            got.append(o.numpy())
        outs[pd] = got
    for r, p in zip(outs[ref], outs[port]):
        _close(p, r, "step output")


def test_transformer_encoder_decoder():
    def build(pd):
        return pd.nn.Transformer(D, H, 1, 1, 32, dropout=0.0)

    rm, pm = _pair(build)
    src, tgt = _x(2, 6, D), _x(2, 4, D, seed=4)
    mask = rm.generate_square_subsequent_mask(4).numpy()
    _close(pm.generate_square_subsequent_mask(4).numpy(), mask, "mask")
    outs = []
    for pd, m in ((ref, rm), (port, pm)):
        ts = [pd.to_tensor(a) for a in (src, tgt)]
        for t in ts:
            t.stop_gradient = False
        out = m(ts[0], ts[1], tgt_mask=pd.to_tensor(np.maximum(mask, -1e9)))
        out.sum().backward()
        outs.append((out.numpy(), ts[0].grad.numpy(), ts[1].grad.numpy()))
    for what, r, p in zip(("output", "src gradient", "tgt gradient"),
                          outs[0], outs[1]):
        _close(p, r, what)


V, T, BD, L, B, NH = 512, 32, 64, 2, 4, 4


def _bert(pd):
    class Bert(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.tok = pd.nn.Embedding(V, BD)
            self.pos = pd.nn.Embedding(T, BD)
            layer = pd.nn.TransformerEncoderLayer(BD, NH, 4 * BD,
                                                  dropout=0.0)
            self.encoder = pd.nn.TransformerEncoder(layer, L)
            self.head = pd.nn.Linear(BD, V)

        def forward(self, tokens, positions):
            x = self.tok(tokens) + self.pos(positions)
            return self.head(self.encoder(x))

    return Bert()


def _bert_losses(pd, model, steps=4):
    rs = np.random.RandomState(0)
    tokens = pd.to_tensor(rs.randint(0, V, (B, T)))
    positions = pd.to_tensor(np.arange(T))
    labels = pd.to_tensor(rs.randint(0, V, (B * T,)))
    opt = pd.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    losses = []
    for _ in range(steps):
        logits = model(tokens, positions)
        loss = pd.nn.functional.cross_entropy(logits.reshape([-1, V]),
                                              labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def test_tiny_bert_losses_match_the_reference():
    """The bench's BERT (`bench.py:317-330`) at 2 layers, D 64, 4 heads,
    V 512, T 32, B 4, trained eagerly with AdamW (1e-4) from the
    reference's weights."""
    ref.seed(0)
    rm = _bert(ref)
    pm = _bert(port)
    state = {k: np.asarray(v.numpy()) for k, v in rm.state_dict().items()}
    missing, unexpected = pm.set_state_dict(state)
    assert not missing and not unexpected
    # the reference's model through its jit.to_static (one program
    # forward, one backward, for the 4 steps) and its AdamW eagerly with
    # the dispatch cache on
    ref.set_flags({"FLAGS_eager_dispatch_cache": True})
    want = _bert_losses(ref, ref.jit.to_static(rm))
    got = _bert_losses(port, pm)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
