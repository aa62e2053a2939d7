"""The port's fused ops (`ops/kernels/fused_ops.py`, `incubate.nn.functional`,
`_C_ops`) and kernels A8 / A9 held against the reference.

Inputs are drawn with numpy from a seed and fed to both packages; the
reference runs as its own tests run it: its kernels with
`interpret=True`, its ops through `OPS[name].__wrapped__` on jax arrays
(the stock composition on the CPU). Tolerances:
- f32 forward: rtol 1e-5 (A8's sums over k run in another order), atol
  1e-6 for values near 0;
- bf16 kernel outputs: both sides sum in f32 and round once to bf16, so
  they differ by at most one bf16 ulp, rtol 2^-7 of |ref|, with atol
  1e-3 x rms(ref) where a cancelling sum sits near 0;
- gradients: within 1e-4 of each leaf's largest entry (f32 sums in other
  orders through the products of the backward).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.incubate.nn.functional  # noqa: F401  (registers ops)
import paddle_tpu.ops.kernels.fused_ops  # noqa: F401
import paddle_tpu.ops.kernels.serving_attention  # noqa: F401
from paddle_tpu.ops.dispatch import OPS as REF_OPS
from paddle_tpu.ops.pallas import fused_ffn as JFF
from paddle_tpu_torch import _C_ops
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from paddle_tpu_torch.ops.dispatch import OPS

ACTS = ("none", "relu", "gelu", "silu", "sigmoid")
BF16_RTOL = 2 ** -7


def _ref(name):
    return REF_OPS[name].__wrapped__


def _np(t):
    return t.detach().float().numpy()


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    atol = 1e-3 * np.sqrt(np.mean(want ** 2))
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol)


def _grads_close(got, want, rtol=1e-4):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=rtol * np.abs(w).max())


# ---------------------------------------------------------------------------
# A8 and A9: plain versions against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_epilogue_plain_matches_reference_kernel(act, bias, dtype):
    rs = np.random.RandomState(ACTS.index(act) + 10 * bias)
    m, k, n = 40, 72, 48
    x, y = rs.randn(m, k), rs.randn(k, n) / np.sqrt(k)
    b = rs.randn(n) if bias else None
    jt = jnp.dtype(dtype)
    want = JFF.fused_gemm_epilogue(
        jnp.asarray(x, jt), jnp.asarray(y, jt),
        None if b is None else jnp.asarray(b, jt), activation=act,
        interpret=True)
    tt = getattr(torch, dtype)
    got = FF.fused_gemm_epilogue_plain(
        torch.tensor(x, dtype=tt), torch.tensor(y, dtype=tt),
        None if b is None else torch.tensor(b, dtype=tt), act)
    assert got.dtype == tt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)
    else:
        _bf16_close(_np(got), want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glu_plain_matches_reference_kernel(act, dtype):
    rs = np.random.RandomState(3)
    rows, f = 24, 40
    x = rs.randn(rows, 2 * f)
    jt = jnp.dtype(dtype)
    want = JFF.fused_glu(jnp.asarray(x[:, :f], jt), jnp.asarray(x[:, f:], jt),
                         act, interpret=True)
    xt = torch.tensor(x, dtype=getattr(torch, dtype))
    u, v = xt[:, :f], xt[:, f:]                # strided halves, no copy
    assert not u.is_contiguous() and u.stride() == v.stride() == (2 * f, 1)
    got = FF.fused_glu(u, v, act)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)
    else:
        _bf16_close(_np(got), want)


def test_kernel_gates_state_their_own_limits():
    assert FF.epilogue_supported(100, 72, 40, "silu", torch.float32)
    assert FF.epilogue_supported(1, 1, 1, "none")          # any m, k, n
    assert not FF.epilogue_supported(8, 8, 8, "tanh")      # not in A8's set
    assert not FF.epilogue_supported(8, 8, 8, "relu", torch.float16)
    assert FF.glu_supported(8, 11008, "gelu")
    assert not FF.glu_supported(0, 8, "silu")
    assert not FF.glu_supported(8, 8, "swish")
    assert FF.EPILOGUE_ACTS == ACTS


# ---------------------------------------------------------------------------
# the fused ops against the reference ops, every route
# ---------------------------------------------------------------------------

GEMM_CASES = [
    # (x shape, y shape, bias, trans_x, trans_y, activation)
    ((6, 16), (16, 24), True, False, False, "gelu"),        # A8, 2-D
    ((2, 5, 16), (16, 24), True, False, False, "silu"),     # A8, 3-D rows
    ((6, 16), (16, 24), False, False, False, "none"),       # A8, no bias
    ((16, 6), (16, 24), True, True, False, "relu"),         # stock, trans_x
    ((6, 16), (24, 16), False, False, True, "sigmoid"),     # stock, trans_y
    ((6, 16), (16, 24), True, False, False, "tanh"),        # stock, act
    ((3, 6, 16), (3, 16, 24), False, False, False, "none"),  # stock, 3-D y
]


@pytest.mark.parametrize("case", GEMM_CASES)
def test_gemm_epilogue_matches_reference(case):
    xs, ys, bias, tx, ty, act = case
    rs = np.random.RandomState(len(xs) + 3 * tx + 5 * ty)
    x, y = rs.randn(*xs).astype(np.float32), rs.randn(*ys).astype(np.float32)
    b = rs.randn(24).astype(np.float32) if bias else None
    want = _ref("gemm_epilogue")(
        jnp.asarray(x), jnp.asarray(y), None if b is None else jnp.asarray(b),
        tx, ty, act)
    got = _C_ops.gemm_epilogue(
        torch.from_numpy(x), torch.from_numpy(y),
        None if b is None else torch.from_numpy(b), tx, ty, act)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gemm_epilogue_routes_to_a8():
    x, y = torch.randn(4, 8), torch.randn(8, 8)
    calls = []
    orig = FF.fused_gemm_epilogue_fwd
    try:
        FF.fused_gemm_epilogue_fwd = lambda *a: calls.append(a) or orig(*a)
        _C_ops.gemm_epilogue(x, y, torch.randn(8), activation="relu")
        _C_ops.gemm_epilogue(x, y, activation="tanh")           # stock
        _C_ops.gemm_epilogue(x, y.t(), trans_y=True)            # stock
        _C_ops.gemm_epilogue(x, y, torch.randn(1))              # stock
    finally:
        FF.fused_gemm_epilogue_fwd = orig
    assert len(calls) == 1 and calls[0][3] == "relu"


@pytest.mark.parametrize("in_num_col_dims,act", [(1, ""), (2, "relu"),
                                                 (1, "gelu")])
def test_fc_matches_reference(in_num_col_dims, act):
    rs = np.random.RandomState(in_num_col_dims)
    x = rs.randn(2, 3, 4, 5).astype(np.float32)
    k = int(np.prod(x.shape[in_num_col_dims:]))
    w = rs.randn(k, 6).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    want = _ref("fc")(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      in_num_col_dims, act)
    got = _C_ops.fc(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), in_num_col_dims, act)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", ["swiglu", "geglu", "gelu", "relu", "silu",
                                  "tanh", "sigmoid", "identity", ""])
def test_fused_bias_act_matches_reference(mode, bias):
    rs = np.random.RandomState(len(mode) + bias)
    x = rs.randn(3, 5, 16).astype(np.float32)
    b = rs.randn(16).astype(np.float32) if bias else None
    want = _ref("fused_bias_act")(jnp.asarray(x),
                                  None if b is None else jnp.asarray(b), mode)
    got = _C_ops.fused_bias_act(torch.from_numpy(x),
                                None if b is None else torch.from_numpy(b),
                                mode)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_fused_bias_act_gated_reads_halves_in_place():
    x = torch.randn(4, 3, 10)
    seen = []
    orig = FF.fused_glu_fwd
    try:
        FF.fused_glu_fwd = lambda *a: seen.append(a) or orig(*a)
        _C_ops.fused_bias_act(x, None, "swiglu")
    finally:
        FF.fused_glu_fwd = orig
    (u, v, act), = seen
    assert act == "silu" and u.shape == (12, 5) and u.stride() == (10, 1)
    assert u.data_ptr() == x.data_ptr()
    assert v.data_ptr() == x.data_ptr() + 5 * x.element_size()


ELEMWISE = [
    # (op, x shape, y shape, axis, unary, alpha)
    ("fused_elementwise_add", (2, 3, 4), (3,), 1, "relu", None),
    ("fused_elementwise_add", (2, 3, 4), (2, 3, 4), -1, "leaky_relu", 0.2),
    ("fused_elementwise_sub", (2, 3, 4), (4,), -1, "identity", None),
    ("fused_elementwise_sub", (2, 3, 4), (2, 3), 0, "tanh", None),
    ("fused_elementwise_mul", (2, 3, 4), (3, 4), 1, "sigmoid", None),
    ("fused_elementwise_mul", (2, 3, 4), (), -1, "leaky_relu", None),
    ("fused_elementwise_div", (2, 3, 4), (2, 3, 4), -1, "gelu", None),
    ("fused_elementwise_div", (2, 3, 4), (3,), 1, "leaky_relu", 0.0),
]


@pytest.mark.parametrize("case", ELEMWISE)
def test_elementwise_family_matches_reference(case):
    name, xs, ys, axis, unary, alpha = case
    rs = np.random.RandomState(len(name) + len(ys))
    x = rs.randn(*xs).astype(np.float32)
    y = (np.asarray(rs.rand(*ys)) + 0.5).astype(np.float32)
    want = _ref(name)(jnp.asarray(x), jnp.asarray(y), axis, alpha,
                      fused_unary_fn=unary)
    got = getattr(_C_ops, name)(torch.from_numpy(x), torch.tensor(y),
                                axis, alpha, fused_unary_fn=unary)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("functors,save", [
    (("elementwise_add", "relu"), False), (("elementwise_add", "scale"), True),
    (("elementwise_add", "gelu", "scale"), False)])
def test_elemwise_add_activation_matches_reference(functors, save):
    rs = np.random.RandomState(len(functors))
    x, y = (rs.randn(3, 7).astype(np.float32) for _ in range(2))
    want = _ref("fused_elemwise_add_activation")(
        jnp.asarray(x), jnp.asarray(y), functors, -1, 0.5, save)
    got = _C_ops.fused_elemwise_add_activation(
        torch.from_numpy(x), torch.from_numpy(y), functors, -1, 0.5, save)
    for g, w in zip(got if save else (got,), want if save else (want,)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("has_bias,acc,multi", [
    (True, True, True), (True, False, True), (False, True, False),
    (False, False, True)])
def test_fused_linear_param_grad_add_matches_reference(has_bias, acc, multi):
    rs = np.random.RandomState(int(has_bias) + 2 * int(acc))
    x, d = rs.randn(2, 5, 6).astype(np.float32), rs.randn(2, 5, 4).astype(
        np.float32)
    dw = rs.randn(6, 4).astype(np.float32) if acc else None
    db = rs.randn(4).astype(np.float32) if acc else None
    j = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = _ref("fused_linear_param_grad_add")(j(x), j(d), j(dw), j(db),
                                               multi, has_bias)
    got = _C_ops.fused_linear_param_grad_add(t(x), t(d), t(dw), t(db), multi,
                                             has_bias)
    for g, w in zip(got if has_bias else (got,),
                    want if has_bias else (want,)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("bna", [-1, 1])
def test_fused_rms_norm_and_swiglu_match_reference(bna):
    rs = np.random.RandomState(bna + 2)
    x = rs.randn(3, 4, 8).astype(np.float32)
    shape = x.shape[bna:] if bna >= 0 else x.shape[bna:]
    w, b = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    want = _ref("fused_rms_norm")(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), 1e-5, bna)
    got = IF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), 1e-5, bna)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    y = rs.randn(3, 4, 8).astype(np.float32)
    np.testing.assert_allclose(
        _np(IF.swiglu(torch.from_numpy(x), torch.from_numpy(y))),
        np.asarray(_ref("swiglu")(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(IF.swiglu(torch.from_numpy(x))),
        np.asarray(_ref("swiglu")(jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("neox,with_k,tables", [
    (True, True, False), (False, False, False), (True, False, True),
    (False, True, True)])
def test_fused_rope_matches_reference(neox, with_k, tables):
    rs = np.random.RandomState(int(neox) + 2 * int(with_k))
    B, T, H, D = 2, 10, 3, 8
    q, k = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(2))
    pos = rs.randint(0, T, (B, T))
    kw = {}
    if tables:
        ang = rs.rand(T, D // 2).astype(np.float32) * 3
        kw = {"sin": np.sin(ang), "cos": np.cos(ang)}
    want = _ref("fused_rotary_position_embedding")(
        jnp.asarray(q), jnp.asarray(k) if with_k else None,
        position_ids=jnp.asarray(pos), use_neox_rotary_style=neox,
        **{n: jnp.asarray(a) for n, a in kw.items()})
    got = IF.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k) if with_k else None,
        position_ids=torch.from_numpy(pos), use_neox_rotary_style=neox,
        **{n: torch.from_numpy(a) for n, a in kw.items()})
    if not with_k:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_matches_reference(transpose):
    rs = np.random.RandomState(int(transpose))
    x = rs.randn(3, 6).astype(np.float32)
    w = rs.randn(*((4, 6) if transpose else (6, 4))).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    want = _ref("fused_linear")(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), transpose)
    got = IF.fused_matmul_bias(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), transpose)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# gradients against jax.grad of the reference ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,bias", [("none", True), ("gelu", True),
                                      ("silu", False), ("relu", True),
                                      ("sigmoid", True)])
def test_gemm_epilogue_grads_match_reference(act, bias):
    rs = np.random.RandomState(ACTS.index(act))
    x = rs.randn(2, 7, 16).astype(np.float32)
    y = (rs.randn(16, 24) / 4).astype(np.float32)
    b = rs.randn(24).astype(np.float32) if bias else None
    ct = rs.randn(2, 7, 24).astype(np.float32)
    leaves = [x, y] + ([b] if bias else [])

    def ref_loss(*ls):
        out = _ref("gemm_epilogue")(ls[0], ls[1], ls[2] if bias else None,
                                    False, False, act)
        return jnp.sum(out * ct)

    want = jax.grad(ref_loss, argnums=tuple(range(len(leaves))))(
        *map(jnp.asarray, leaves))
    tl = [torch.from_numpy(a).requires_grad_() for a in leaves]
    out = _C_ops.gemm_epilogue(tl[0], tl[1], tl[2] if bias else None,
                               activation=act)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), tl)
    _grads_close(got, want)


@pytest.mark.parametrize("mode,bias", [("swiglu", True), ("geglu", False),
                                       ("gelu", True), ("swiglu", False)])
def test_fused_bias_act_grads_match_reference(mode, bias):
    rs = np.random.RandomState(len(mode))
    x = rs.randn(6, 20).astype(np.float32)
    b = rs.randn(20).astype(np.float32) if bias else None
    ct = rs.randn(6, 10 if mode.endswith("glu") else 20).astype(np.float32)
    leaves = [x] + ([b] if bias else [])

    def ref_loss(*ls):
        out = _ref("fused_bias_act")(ls[0], ls[1] if bias else None, mode)
        return jnp.sum(out * ct)

    want = jax.grad(ref_loss, argnums=tuple(range(len(leaves))))(
        *map(jnp.asarray, leaves))
    tl = [torch.from_numpy(a).requires_grad_() for a in leaves]
    out = _C_ops.fused_bias_act(tl[0], tl[1] if bias else None, mode)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), tl)
    _grads_close(got, want)


# ---------------------------------------------------------------------------
# registry parity
# ---------------------------------------------------------------------------

def test_registry_matches_reference_signatures():
    assert len(OPS) >= 15
    for name, fn in OPS.items():
        assert name in REF_OPS, f"{name} is not a reference op"
        ref = inspect.signature(REF_OPS[name].__wrapped__)
        mine = inspect.signature(fn)
        assert [(p.name, p.default) for p in mine.parameters.values()] == \
            [(p.name, p.default) for p in ref.parameters.values()], name


def test_register_op_forms_and_grad_mode():
    from paddle_tpu_torch.ops import dispatch as D

    def double(x):
        return 2 * x

    names = ("double", "twice", "frozen")
    try:
        assert D.register_op(double) is double
        D.register_op("twice")(double)
        frozen = D.register_op(name="frozen", nondiff=True)(double)
        assert D.get_op("twice") is double and D.OPS["double"] is double
        x = torch.ones(2, requires_grad=True)
        assert double(x).requires_grad and not frozen(x).requires_grad
        assert torch.equal(frozen(x), 2 * x.detach())
    finally:
        for n in names:
            D.OPS.pop(n, None)
    with D.no_grad():
        assert not D.is_grad_enabled()
        with D.enable_grad():
            assert D.is_grad_enabled()
    D.set_grad_enabled(False)
    try:
        assert not torch.is_grad_enabled()
    finally:
        D.set_grad_enabled(True)


def test_c_ops_exposes_exactly_the_registry():
    assert set(dir(_C_ops)) == set(OPS)
    for name in OPS:
        assert getattr(_C_ops, name) is OPS[name]
    missing = next(n for n in sorted(REF_OPS) if n not in OPS)
    with pytest.raises(AttributeError, match="not ported"):
        getattr(_C_ops, missing)
