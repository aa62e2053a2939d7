"""Varlen attention over packed sequences (`flash_attn_unpadded`, kernel
A1/A2's segment-id mode) and a small LLaMA layer stack of the fused-op
path, held against the reference.

Inputs are drawn with numpy from a seed and fed to both packages. The
reference runs as its tests run it: `OPS[name].__wrapped__` on jax
arrays, which over 256 packed tokens takes its Pallas segment path in
interpret mode (`tests/test_serving_attention.py:95`), and misaligned
packings its masked composition. The port's wrappers run their plain
versions for CPU tensors. Packed lengths put sequence boundaries off
multiples of 64, so rows whose first kv tiles hold no key of their
segment are exercised.

Tolerances: forward rtol 1e-5 with atol 1e-5 (f32 sums in another
order); gradients and the stack within 1e-4 of each leaf's largest entry
(the same sums fed through the backward's products and, for the stack,
two layers of norms, products and softmaxes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.incubate.nn.functional  # noqa: F401  (registers ops)
import paddle_tpu.ops.kernels.fused_ops  # noqa: F401
from paddle_tpu.ops.dispatch import OPS as REF_OPS
from paddle_tpu.ops.kernels import serving_attention as JSA
from paddle_tpu_torch import _C_ops
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.kernels import serving_attention as SA
from torch_threads import one_torch_thread

one_torch_thread()

LENS = [37, 100, 19, 100]          # 256 tokens; boundaries 37, 137, 156


def _ref(name):
    return REF_OPS[name].__wrapped__


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _close_to_max(got, want, rtol=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _qkv(total, H, KV, hd, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(total, H, hd).astype(np.float32),
            rs.randn(total, KV, hd).astype(np.float32),
            rs.randn(total, KV, hd).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
def test_unpadded_matches_reference(causal, H, KV):
    q, k, v = _qkv(256, H, KV, 32, seed=H + KV + int(causal))
    cu = _cu(LENS)
    ct = np.random.RandomState(9).randn(256, H, 32).astype(np.float32)

    def ref_loss(q_, k_, v_):
        o = _ref("flash_attn_unpadded")(q_, k_, v_, jnp.asarray(cu),
                                        jnp.asarray(cu), causal=causal)[0]
        return jnp.sum(o * ct), o

    (_, want), wgrads = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tl = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tcu = torch.from_numpy(cu)
    out, sm, lse, seed = _C_ops.flash_attn_unpadded(*tl, tcu, tcu,
                                                    causal=causal)
    assert sm is None and lse is None
    assert seed.dtype == torch.int64 and seed.tolist() == [0, 0]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), tl)
    for g, w in zip(got, wgrads):
        _close_to_max(g, w)


def test_identical_packing_takes_segment_mode():
    q, k, v = (torch.from_numpy(a) for a in _qkv(256, 4, 2, 16, seed=1))
    cu = torch.from_numpy(_cu(LENS))
    seen = []
    orig = FA.flash_attention_fwd
    try:
        FA.flash_attention_fwd = lambda *a: seen.append(a) or orig(*a)
        SA.flash_attn_unpadded(q, k, v, cu, cu.clone(), causal=True)
        SA.flash_attn_unpadded(q, k, v, cu, torch.from_numpy(_cu([100, 156])),
                               causal=True)                 # misaligned
    finally:
        FA.flash_attention_fwd = orig
    assert len(seen) == 1
    q_seg, kv_seg = seen[0][5], seen[0][6]
    assert q_seg.dtype == torch.int32 and q_seg.shape == (1, 256)
    assert q_seg[0].tolist() == sum(([i + 1] * n for i, n in
                                     enumerate(LENS)), [])
    assert torch.equal(q_seg, kv_seg)


@pytest.mark.parametrize("causal", [True, False])
def test_misaligned_packing_takes_composition(causal):
    """Equal totals, different boundaries: the masked composition with
    bottom-right causal alignment, on both sides (the reference's
    `test_misaligned_packing_falls_back`)."""
    q, k, v = _qkv(256, 4, 2, 16, seed=5)
    cu_q, cu_k = _cu([100, 156]), _cu([156, 100])
    want = _ref("flash_attn_unpadded")(*map(jnp.asarray, (q, k, v, cu_q,
                                                          cu_k)),
                                       causal=causal)[0]
    got = SA.flash_attn_unpadded(*map(torch.from_numpy, (q, k, v, cu_q,
                                                         cu_k)),
                                 causal=causal)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_qkvpacked_matches_reference():
    rs = np.random.RandomState(4)
    qkv = rs.randn(256, 4, 2, 16).astype(np.float32)     # G = 2, KV = 2
    cu = _cu(LENS)
    want = _ref("flash_attn_varlen_qkvpacked")(
        jnp.asarray(qkv), jnp.asarray(cu), jnp.asarray(cu), causal=True)[0]
    got = _C_ops.flash_attn_varlen_qkvpacked(
        torch.from_numpy(qkv), torch.from_numpy(cu), torch.from_numpy(cu),
        causal=True)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kwargs,match", [
    ({"return_softmax": True}, "return_softmax"),
    ({"dropout": 0.1}, "dropout"),
    ({"attn_mask": torch.zeros(1)}, "attn_mask")])
def test_entry_rejections(kwargs, match):
    q = torch.zeros(12, 2, 16)
    cu = torch.tensor([0, 5, 12], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=match):
        SA.flash_attn_unpadded(q, q, q, cu, cu, **kwargs)
    # dropout is allowed at inference, as in the reference
    SA.flash_attn_unpadded(q, q, q, cu, cu, dropout=0.1, is_test=True)


def test_unpack_cu_matches_reference():
    cu = _cu([3, 0, 5])
    want = JSA._unpack_cu(jnp.asarray(cu), 10)
    got = SA._unpack_cu(torch.from_numpy(cu), 10, torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()


# ---------------------------------------------------------------------------
# a two-layer LLaMA stack of the fused-op path, from each package's ops
# ---------------------------------------------------------------------------

D, HEADS, KV_HEADS = 64, 4, 2
HD = D // HEADS


def _stack_weights(layers=2, seed=0):
    rs = np.random.RandomState(seed)
    qkv_w = (HEADS + 2 * KV_HEADS) * HD
    return [{"ln1": (1 + 0.1 * rs.randn(D)).astype(np.float32),
             "w_qkv": (rs.randn(D, qkv_w) / 8).astype(np.float32),
             "wo": (rs.randn(D, D) / 8).astype(np.float32),
             "ln2": (1 + 0.1 * rs.randn(D)).astype(np.float32),
             "w_gate_up": (rs.randn(D, 4 * D) / 8).astype(np.float32),
             "w2": (rs.randn(2 * D, D) / 12).astype(np.float32)}
            for _ in range(layers)]


def _port_layer(h, lw, cu, pos):
    total = h.shape[0]
    x = IF.fused_rms_norm(h, lw["ln1"])
    qkv = _C_ops.gemm_epilogue(x, lw["w_qkv"])
    q = qkv[:, :HEADS * HD].reshape(1, total, HEADS, HD)
    k = qkv[:, HEADS * HD:(HEADS + KV_HEADS) * HD].reshape(1, total,
                                                          KV_HEADS, HD)
    v = qkv[:, (HEADS + KV_HEADS) * HD:].reshape(total, KV_HEADS, HD)
    q, k = IF.fused_rotary_position_embedding(q, k, position_ids=pos[None])
    o = IF.flash_attn_unpadded(q[0], k[0], v, cu, cu, causal=True)[0]
    h = h + _C_ops.gemm_epilogue(o.reshape(total, D), lw["wo"])
    x = IF.fused_rms_norm(h, lw["ln2"])
    g = _C_ops.fused_bias_act(_C_ops.gemm_epilogue(x, lw["w_gate_up"]), None,
                              "swiglu")
    return h + _C_ops.gemm_epilogue(g, lw["w2"])


def _ref_layer(h, lw, cu, pos):
    total = h.shape[0]
    x = _ref("fused_rms_norm")(h, lw["ln1"])
    qkv = _ref("gemm_epilogue")(x, lw["w_qkv"])
    q = qkv[:, :HEADS * HD].reshape(1, total, HEADS, HD)
    k = qkv[:, HEADS * HD:(HEADS + KV_HEADS) * HD].reshape(1, total,
                                                          KV_HEADS, HD)
    v = qkv[:, (HEADS + KV_HEADS) * HD:].reshape(total, KV_HEADS, HD)
    q, k = _ref("fused_rotary_position_embedding")(q, k,
                                                   position_ids=pos[None])
    o = _ref("flash_attn_unpadded")(q[0], k[0], v, cu, cu, causal=True)[0]
    h = h + _ref("gemm_epilogue")(o.reshape(total, D), lw["wo"])
    x = _ref("fused_rms_norm")(h, lw["ln2"])
    g = _ref("fused_bias_act")(_ref("gemm_epilogue")(x, lw["w_gate_up"]),
                               None, "swiglu")
    return h + _ref("gemm_epilogue")(g, lw["w2"])


def test_two_layer_stack_matches_reference():
    weights = _stack_weights()
    cu = _cu(LENS)
    pos = np.concatenate([np.arange(n) for n in LENS])
    rs = np.random.RandomState(7)
    h0 = rs.randn(256, D).astype(np.float32)
    ct = rs.randn(256, D).astype(np.float32)
    names = sorted(weights[0])

    def ref_loss(h, ws):
        for lw in ws:
            h = _ref_layer(h, lw, jnp.asarray(cu), jnp.asarray(pos))
        return jnp.sum(h * ct), h

    jws = [{n: jnp.asarray(lw[n]) for n in names} for lw in weights]
    (_, want), (wh, wws) = jax.value_and_grad(ref_loss, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(h0), jws)
    th = torch.from_numpy(h0).requires_grad_()
    tws = [{n: torch.from_numpy(lw[n]).requires_grad_() for n in names}
           for lw in weights]
    h = th
    for lw in tws:
        h = _port_layer(h, lw, torch.from_numpy(cu), torch.from_numpy(pos))
    _close_to_max(h, want)
    leaves = [th] + [lw[n] for lw in tws for n in names]
    got = torch.autograd.grad((h * torch.from_numpy(ct)).sum(), leaves)
    wanted = [wh] + [lw[n] for lw in wws for n in names]
    for g, w in zip(got, wanted):
        _close_to_max(g, w)
