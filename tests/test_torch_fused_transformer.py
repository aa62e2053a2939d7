"""The fused transformer surface, the port against the reference on the
CPU: the dense-cache serving ops, the incubate fused functions and
layers, and the dense flash-attention entries on their plain path.

- `fused_multi_transformer_`: a 2-layer stack (D 16, 2 heads of 8, d_ff
  32, max_seq 8, B 2) prefilled over 5 tokens, then 2 decode steps, in
  four configurations that cover layernorm and rmsnorm, gelu, relu and
  swiglu, pre- and post-LN, adjacent-pair and rotate-half rope and none:
  each stage's output and the caches within rtol 1e-5, atol 1e-5; and
  each port decode step against the port's prefill over the same tokens
  (its last row), within the same tolerance.
- `masked_multihead_attention_` (per-row lengths, bias, src_mask, both
  rope styles) and `variable_length_memory_efficient_attention` (GQA,
  masks, causal with pre_cache_length): rtol 1e-5, atol 1e-5.
- The incubate functions and layers (`fused_attention`,
  `fused_feedforward`, `fused_bias_dropout_residual_layer_norm`,
  `fused_moe`, `fused_linear_activation`, the Fused* layers with the
  reference's weights carried across), dropout off: rtol 1e-5, atol
  1e-5.
- `flash_attn`, `flash_attn_qkvpacked`, `memory_efficient_attention`:
  the port's plain path (the kernels' plain versions, or the plain SDPA
  for a mask, a bias or a scale) against the reference's XLA path,
  outputs and the gradients of a weighted sum: rtol 1e-5, atol 1e-5.
  The other fused ops are held by the OpTest twin
  (`test_torch_op_parity.py`).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.ops.dispatch import OPS as REF_OPS
from paddle_tpu_torch import _C_ops  # noqa: F401  (registers the ops)
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.ops.dispatch import OPS as PORT_OPS
from torch_threads import one_torch_thread

one_torch_thread()

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _rs(seed):
    return np.random.RandomState(seed)


def _f(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _ref(name, *args, **kw):
    """The reference kernel on numpy inputs (lists kept), as numpy."""
    conv = [jnp.asarray(a) if isinstance(a, np.ndarray) else
            ([jnp.asarray(x) for x in a] if isinstance(a, list) else a)
            for a in args]
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    out = REF_OPS[name]._kernel(*conv, **kw)
    return jax.tree.map(np.asarray, out)


def _port(name, *args, **kw):
    conv = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else
            ([torch.from_numpy(x.copy()) for x in a]
             if isinstance(a, list) else a) for a in args]
    kw = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    out = PORT_OPS[name]._kernel(*conv, **kw)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# fused_multi_transformer_
# ---------------------------------------------------------------------------

B, T0, D, NH, HD, FF, S, LAYERS = 2, 5, 16, 2, 8, 32, 8, 2

MT_CASES = {
    "layernorm-gelu-pre-pairwise": dict(norm_type="layernorm",
                                        activation="gelu",
                                        pre_layer_norm=True, rope="pair"),
    "rmsnorm-swiglu-pre-neox": dict(norm_type="rmsnorm", activation="swiglu",
                                    pre_layer_norm=True, rope="neox"),
    "layernorm-relu-post-norope": dict(norm_type="layernorm",
                                       activation="relu",
                                       pre_layer_norm=False, rope=None),
    "rmsnorm-gelu-post-pairwise": dict(norm_type="rmsnorm",
                                       activation="gelu",
                                       pre_layer_norm=False, rope="pair"),
}


def _rope_stack(batch=B):
    """[2, B, 1, S, hd]: cos over sin, each half-table repeated."""
    inv = 1.0 / (10000.0 ** (np.arange(0, HD, 2) / HD))
    ang = np.arange(S)[:, None] * inv[None, :]
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32)
    st = np.stack([cos, sin])[:, None, None]                 # [2,1,1,S,hd]
    return np.ascontiguousarray(np.broadcast_to(st, (2, batch, 1, S, HD)))


def _mt_weights(activation, seed=0):
    rs = _rs(seed)
    f1 = 2 * FF if activation == "swiglu" else FF
    w = {"ln_scales": [], "ln_biases": [], "qkv_weights": [],
         "qkv_biases": [], "linear_weights": [], "linear_biases": [],
         "ffn_ln_scales": [], "ffn_ln_biases": [], "ffn1_weights": [],
         "ffn1_biases": [], "ffn2_weights": [], "ffn2_biases": []}
    for _ in range(LAYERS):
        w["ln_scales"].append(1 + _f(rs, D, scale=0.1))
        w["ln_biases"].append(_f(rs, D, scale=0.1))
        w["qkv_weights"].append(_f(rs, 3, NH, HD, D, scale=0.2))
        w["qkv_biases"].append(_f(rs, 3, NH, HD, scale=0.1))
        w["linear_weights"].append(_f(rs, D, D, scale=0.2))
        w["linear_biases"].append(_f(rs, D, scale=0.1))
        w["ffn_ln_scales"].append(1 + _f(rs, D, scale=0.1))
        w["ffn_ln_biases"].append(_f(rs, D, scale=0.1))
        w["ffn1_weights"].append(_f(rs, D, f1, scale=0.2))
        w["ffn1_biases"].append(_f(rs, f1, scale=0.1))
        w["ffn2_weights"].append(_f(rs, FF, D, scale=0.2))
        w["ffn2_biases"].append(_f(rs, D, scale=0.1))
    return w


def _mt_args(w):
    return [w[k] for k in ("ln_scales", "ln_biases", "qkv_weights",
                           "qkv_biases", "linear_weights", "linear_biases",
                           "ffn_ln_scales", "ffn_ln_biases", "ffn1_weights",
                           "ffn1_biases", "ffn2_weights", "ffn2_biases")]


@pytest.mark.parametrize("case", sorted(MT_CASES))
def test_fused_multi_transformer_prefill_and_decode(case):
    cfg = dict(MT_CASES[case])
    rope = cfg.pop("rope")
    w = _mt_weights(cfg["activation"])
    kw = dict(cfg, epsilon=1e-5)
    if rope:
        kw.update(rotary_embs=_rope_stack(), rotary_emb_dims=1,
                  use_neox_rotary_style=rope == "neox")
    rs = _rs(1)
    xs = _f(rs, B, T0 + 2, D)
    zero = [np.zeros((2, B, NH, S, HD), np.float32) for _ in range(LAYERS)]
    r_out, r_cache = _ref("fused_multi_transformer_", xs[:, :T0],
                          *_mt_args(w), cache_kvs=zero, **kw)
    p_cache = [torch.from_numpy(c.copy()) for c in zero]
    p_out, p_cache = _port("fused_multi_transformer_", xs[:, :T0],
                           *_mt_args(w), cache_kvs=p_cache, **kw)
    _close(_np(p_out), r_out, "prefill")
    for rc, pc in zip(r_cache, p_cache):
        _close(_np(pc), rc, "prefill cache")
    for t in range(T0, T0 + 2):
        r_out, r_cache = _ref("fused_multi_transformer_", xs[:, t:t + 1],
                              *_mt_args(w), cache_kvs=list(r_cache),
                              time_step=t, **kw)
        p_out, p_cache = _port("fused_multi_transformer_", xs[:, t:t + 1],
                               *_mt_args(w), cache_kvs=p_cache,
                               time_step=t, **kw)
        _close(_np(p_out), r_out, f"decode step {t}")
        for rc, pc in zip(r_cache, p_cache):
            _close(_np(pc), rc, f"decode cache {t}")
        fresh = [torch.zeros(2, B, NH, S, HD) for _ in range(LAYERS)]
        full, _ = _port("fused_multi_transformer_", xs[:, :t + 1],
                        *_mt_args(w), cache_kvs=fresh, **kw)
        _close(_np(p_out)[:, 0], _np(full)[:, -1], f"decode {t} vs prefill")


@pytest.mark.parametrize("neox", [False, True])
def test_masked_multihead_attention(neox):
    rs = _rs(2)
    x = _f(rs, B, 3 * NH * HD)
    cache = _f(rs, 2, B, NH, S, HD)
    bias = _f(rs, 3 * NH * HD, scale=0.1)
    lens = np.array([[2], [5]], np.int32)
    mask = _f(rs, B, 1, 1, S, scale=0.5)
    rot = _rope_stack()[0][:, :, None]            # [B, 1, 1, S, hd]
    rot = np.ascontiguousarray(rot)
    rot[..., 1::2] = _rope_stack()[1][:, :, None][..., 1::2]
    kw = dict(bias=bias, src_mask=mask, sequence_lengths=lens,
              rotary_tensor=rot, rotary_emb_dims=1,
              use_neox_rotary_style=neox)
    r_out, r_cache = _ref("masked_multihead_attention_", x, cache, **kw)
    p_cache = torch.from_numpy(cache.copy())
    p_out, p_cache2 = _port("masked_multihead_attention_", x, p_cache, **kw)
    assert p_cache2 is p_cache                    # written in place
    _close(_np(p_out), r_out, "output")
    _close(_np(p_cache), r_cache, "cache")


@pytest.mark.parametrize("causal,pre", [(False, 0), (True, 0), (True, 2)])
def test_variable_length_memory_efficient_attention(causal, pre):
    rs = _rs(3)
    q = _f(rs, B, 4, 6, HD)
    k, v = _f(rs, B, 2, 7, HD), _f(rs, B, 2, 7, HD)
    lens = np.array([6, 3], np.int32)
    kv_lens = np.array([7, 5], np.int32)
    mask = _f(rs, B, 1, 6, 7, scale=0.5)
    kw = dict(mask=mask, causal=causal, pre_cache_length=pre)
    want = _ref("variable_length_memory_efficient_attention", q, k, v, lens,
                kv_lens, **kw)
    got = _port("variable_length_memory_efficient_attention", q, k, v, lens,
                kv_lens, **kw)
    _close(_np(got), want)


def test_serving_ops_refuse_as_the_reference():
    w = _mt_weights("gelu")
    x = np.zeros((B, 2, D), np.float32)
    with pytest.raises(NotImplementedError):
        _port("fused_multi_transformer_", x, *_mt_args(w), training=True)
    with pytest.raises(ValueError):
        _port("fused_multi_transformer_", x, *_mt_args(w), time_step=2)
    with pytest.raises(NotImplementedError):
        _port("variable_length_memory_efficient_attention",
              np.zeros((1, 2, 3, 8), np.float32),
              np.zeros((1, 2, 3, 8), np.float32),
              np.zeros((1, 2, 3, 8), np.float32), np.array([3]),
              np.array([3]), pre_cache_length=1)


# ---------------------------------------------------------------------------
# incubate fused functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_fused_attention(pre_ln, mask):
    rs = _rs(4)
    x = _f(rs, B, 5, D)
    args = [x, _f(rs, 3, NH, HD, D, scale=0.3), _f(rs, D, D, scale=0.3)]
    kw = dict(qkv_bias=_f(rs, 3, NH, HD), linear_bias=_f(rs, D),
              pre_ln_scale=1 + _f(rs, D, scale=0.1), pre_ln_bias=_f(rs, D),
              ln_scale=1 + _f(rs, D, scale=0.1), ln_bias=_f(rs, D),
              num_heads=NH, pre_layer_norm=pre_ln)
    if mask == "bool":
        kw["attn_mask"] = rs.rand(B, 1, 5, 5) > 0.3
    elif mask == "additive":
        kw["attn_mask"] = _f(rs, B, NH, 5, 5)
    _close(_np(_port("fused_attention", *args, **kw)),
           _ref("fused_attention", *args, **kw))


@pytest.mark.parametrize("activation", ["relu", "gelu", "silu"])
@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_feedforward(activation, pre_ln):
    rs = _rs(5)
    args = [_f(rs, B, 5, D), _f(rs, D, FF, scale=0.3),
            _f(rs, FF, D, scale=0.3)]
    kw = dict(linear1_bias=_f(rs, FF), linear2_bias=_f(rs, D),
              ln1_scale=1 + _f(rs, D, scale=0.1), ln1_bias=_f(rs, D),
              ln2_scale=1 + _f(rs, D, scale=0.1), ln2_bias=_f(rs, D),
              dropout1_rate=0.0, dropout2_rate=0.0, activation=activation,
              pre_layer_norm=pre_ln)
    _close(_np(_port("fused_feedforward", *args, **kw)),
           _ref("fused_feedforward", *args, **kw))


def test_fused_bias_dropout_residual_layer_norm():
    rs = _rs(6)
    args = [_f(rs, B, 5, D), _f(rs, B, 5, D), _f(rs, D),
            1 + _f(rs, D, scale=0.1), _f(rs, D)]
    _close(_np(_port("fused_bias_dropout_residual_layer_norm", *args,
                     dropout_rate=0.5, training=False)),
           _ref("fused_bias_dropout_residual_layer_norm", *args,
                dropout_rate=0.5, training=False))


@pytest.mark.parametrize("packed", [False, True])
def test_fused_moe(packed):
    rs = _rs(7)
    E, F2 = 4, 2 * FF if packed else FF
    x = _f(rs, B, 6, D)
    args = (x, _f(rs, D, E), _f(rs, E, D, F2, scale=0.3),
            _f(rs, E, FF, D, scale=0.3), _f(rs, E, F2, scale=0.1),
            _f(rs, E, D, scale=0.1))
    from paddle_tpu.incubate.nn import functional as RIF
    from paddle_tpu_torch.incubate.nn import functional as PIF

    want = RIF.fused_moe(*[ref.to_tensor(a) for a in args], moe_topk=2)
    got = PIF.fused_moe(*[torch.from_numpy(a) for a in args], moe_topk=2)
    _close(_np(got), want.numpy())


@pytest.mark.parametrize("activation", ["gelu", "relu", "none"])
def test_fused_linear_activation(activation):
    from paddle_tpu.incubate.nn import functional as RIF
    from paddle_tpu_torch.incubate.nn import functional as PIF

    rs = _rs(8)
    x, y, b = _f(rs, 5, D), _f(rs, FF, D), _f(rs, FF)
    want = RIF.fused_linear_activation(
        ref.to_tensor(x), ref.to_tensor(y), ref.to_tensor(b), trans_y=True,
        activation=activation)
    got = PIF.fused_linear_activation(
        port.to_tensor(x), port.to_tensor(y), port.to_tensor(b),
        trans_y=True, activation=activation)
    _close(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# incubate fused layers
# ---------------------------------------------------------------------------

LAYER_CASES = {
    "FusedMultiHeadAttention": (
        lambda nn: nn.FusedMultiHeadAttention(D, NH, 0.0, 0.0,
                                              normalize_before=True),
        1),
    "FusedFeedForward": (
        lambda nn: nn.FusedFeedForward(D, FF, 0.0, activation="gelu"), 1),
    "FusedBiasDropoutResidualLayerNorm": (
        lambda nn: nn.FusedBiasDropoutResidualLayerNorm(D, 0.0), 2),
    "FusedLinear": (lambda nn: nn.FusedLinear(D, FF, transpose_weight=True),
                    1),
    "FusedTransformerEncoderLayer": (
        lambda nn: nn.FusedTransformerEncoderLayer(D, NH, FF, 0.0), 1),
    "FusedDropoutAdd": (lambda nn: nn.FusedDropoutAdd(0.3), 2),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_fused_layers(name):
    import paddle_tpu.incubate.nn as rnn
    import paddle_tpu_torch.incubate.nn as pnn

    build, n_in = LAYER_CASES[name]
    ref.seed(0)
    rm, pm = build(rnn), build(pnn)
    rs = _rs(9)
    state = {k: np.asarray(v.numpy()) + _f(rs, *v.shape, scale=0.1)
             for k, v in rm.state_dict().items()}
    rm.set_state_dict(state)
    missing, unexpected = pm.set_state_dict(state)
    assert not missing and not unexpected
    rm.eval()
    pm.eval()
    xs = [_f(rs, B, 5, D) for _ in range(n_in)]
    want = rm(*[ref.to_tensor(a) for a in xs]).numpy()
    got = pm(*[port.to_tensor(a) for a in xs]).numpy()
    _close(got, want)


def test_fused_multi_transformer_layer_form():
    import paddle_tpu_torch.incubate.nn as pnn

    w = _mt_weights("gelu")
    x = _f(_rs(10), B, 3, D)
    m = pnn.FusedMultiTransformer(D, NH, FF, num_layers=LAYERS)
    got, _ = m(torch.from_numpy(x), *[[torch.from_numpy(a) for a in ws]
                                      for ws in _mt_args(w)])
    want, _ = _ref("fused_multi_transformer_", x, *_mt_args(w))
    _close(_np(got), want)


# ---------------------------------------------------------------------------
# dense flash attention entries, plain path
# ---------------------------------------------------------------------------


def _attn_pair(name, arrays, grad_idx, **kw):
    """(reference outputs and gradients, port outputs and gradients) of
    sum(out * w) over the arrays at grad_idx."""
    w = _f(_rs(99), *_np(_port(name, *arrays, **kw)).shape)

    def rloss(*a):
        xs = list(arrays)
        for i, t in zip(grad_idx, a):
            xs[i] = t
        return (REF_OPS[name]._kernel(
            *[None if v is None else jnp.asarray(v) for v in xs], **kw)
            * w).sum()

    r_out = _ref(name, *arrays, **kw)
    r_grads = jax.grad(rloss, tuple(range(len(grad_idx))))(
        *[jnp.asarray(arrays[i]) for i in grad_idx])
    ts = [None if a is None else torch.from_numpy(a.copy()) for a in arrays]
    for i in grad_idx:
        ts[i].requires_grad_(True)
    p_out = PORT_OPS[name]._kernel(*ts, **kw)
    (p_out * torch.from_numpy(w)).sum().backward()
    return (r_out, [np.asarray(g) for g in r_grads],
            _np(p_out), [ts[i].grad.numpy() for i in grad_idx])


def _qkv(seed, T=9, H=2, hd=8):
    rs = _rs(seed)
    return [_f(rs, 2, T, H, hd) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_plain_path(causal):
    r_out, r_g, p_out, p_g = _attn_pair("flash_attn", _qkv(11), (0, 1, 2),
                                        causal=causal)
    _close(p_out, r_out, "output")
    for r, p in zip(r_g, p_g):
        _close(p, r, "gradient")


def test_flash_attn_with_a_mask_takes_the_plain_sdpa():
    q, k, v = _qkv(12)
    mask = _f(_rs(13), 2, 2, 9, 9, scale=0.5)
    r_out, r_g, p_out, p_g = _attn_pair("flash_attn", [q, k, v, None, mask],
                                        (0, 1, 2), causal=True)
    _close(p_out, r_out, "output")
    for r, p in zip(r_g, p_g):
        _close(p, r, "gradient")


def test_flash_attn_qkvpacked_plain_path():
    qkv = _f(_rs(14), 2, 9, 3, 2, 8)
    r_out, r_g, p_out, p_g = _attn_pair("flash_attn_qkvpacked", [qkv], (0,),
                                        causal=True)
    _close(p_out, r_out, "output")
    _close(p_g[0], r_g[0], "gradient")


@pytest.mark.parametrize("variant", ["plain", "bias", "scale"])
def test_memory_efficient_attention(variant):
    q, k, v = _qkv(15)
    args = [q, k, v]
    kw = {}
    if variant == "bias":
        args.append(_f(_rs(16), 2, 2, 9, 9, scale=0.5))
    elif variant == "scale":
        kw["scale"] = 0.2
    r_out, r_g, p_out, p_g = _attn_pair("memory_efficient_attention", args,
                                        (0, 1, 2), **kw)
    _close(p_out, r_out, "output")
    for r, p in zip(r_g, p_g):
        _close(p, r, "gradient")


def test_flash_attn_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 2, 12)                  # head_dim 12
    with pytest.raises(ValueError, match="head_dim"):
        PORT_OPS["flash_attn"]._kernel(q, q, q)
    h = torch.zeros(1, 4, 2, 8, dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        PORT_OPS["flash_attn"]._kernel(h, h, h)
    with pytest.raises(NotImplementedError):
        PORT_OPS["flash_attn"]._kernel(q, q, q, return_softmax=True)


def test_flash_attn_grouped_query_plain_path():
    """GQA on the port's plain path against the same heads repeated (the
    reference's XLA path takes no GQA here)."""
    rs = _rs(17)
    q = torch.from_numpy(_f(rs, 2, 9, 4, 8))
    k, v = (torch.from_numpy(_f(rs, 2, 9, 1, 8)) for _ in range(2))
    got = PORT_OPS["flash_attn"]._kernel(q, k, v, causal=True)
    want = PORT_OPS["flash_attn"]._kernel(q, k.repeat(1, 1, 4, 1),
                                          v.repeat(1, 1, 4, 1), causal=True)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert math.isfinite(float(got.abs().max()))
