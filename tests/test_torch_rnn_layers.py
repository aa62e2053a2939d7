"""The port's recurrent layers and functional autograd against the
reference's.

- The cells (`SimpleRNNCell`, `LSTMCell` with and without `proj_size`,
  `GRUCell`), the `RNN` and `BiRNN` wrappers, and `SimpleRNN` (tanh,
  relu), `LSTM` and `GRU` (one and two layers, forward and
  bidirectional, time-major, with `sequence_length` and initial
  states), on `tests/test_rnn.py`'s inputs (its shapes and seeded
  generators). Each layer is built in the reference after `seed(0)` and
  its weights carried into the port's through `set_state_dict`; the
  reference runs the cases of a table through its `jit.to_static`, in
  one program (`torch_ref_chunks`); outputs,
  final states and the gradients of a weighted sum of them (inputs,
  initial states, every parameter) are held within rtol 1e-5 (atol 1e-6,
  gradients 1e-6 times their largest entry). `proj_size` on the fused
  path raises in both.
- `jacobian` (lazy rows, batched, tuple inputs), `hessian` (single,
  batched, tuple nesting), `vjp` and `jvp` on
  `tests/test_functional_autograd.py`'s cases, within the same rtol.
"""
import functools

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
import torch_ref_chunks as RC
from paddle_tpu_torch.core import place as port_place
from torch_threads import one_torch_thread

one_torch_thread()

RS = np.random.RandomState
RTOL, ATOL = 1e-5, 1e-6
B, T, IN, H = 3, 5, 4, 6


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    prev = ref.get_flags("FLAGS_eager_dispatch_cache")
    ref.set_flags({"FLAGS_eager_dispatch_cache": False})
    yield
    ref.set_flags(prev)


def _pair(build):
    """The reference's layer after seed(0), and the port's with its
    weights."""
    ref.seed(0)
    rl = build(ref.nn)
    pl = build(port.nn)
    state = {k: np.asarray(v.numpy()) for k, v in rl.state_dict().items()}
    missing, unexpected = pl.set_state_dict(state)
    assert not missing and not unexpected
    assert list(pl.state_dict()) == list(state)
    return rl, pl


def _port_run(layer, arrays, call):
    ts = []
    for a in arrays:
        t = port.to_tensor(a)
        if a.dtype.kind == "f":
            t.stop_gradient = False
        ts.append(t)
    outs = RC.leaves(call(layer, *ts), port.Tensor)
    RC.weighted_loss(port, outs, lambda t: True).backward()
    return ts, outs


@functools.lru_cache(maxsize=None)
def _reference(table):
    """The reference's results for every case of CELLS, WRAPPERS or
    FUSED (one chunk a table), through its jit.to_static: one program
    forward and one backward in place of an eager dispatch an op."""
    return RC.run({n: RC.Case(b, c, a, [i for i, x in enumerate(a)
                                        if x.dtype.kind == "f"])
                   for n, (b, a, c) in CASES[table].items()})


def _check(table, name):
    build, arrays, call = CASES[table][name]
    r = _reference(table)[name]
    pl = build(port.nn)
    missing, unexpected = pl.set_state_dict(r.state)
    assert not missing and not unexpected
    assert list(pl.state_dict()) == list(r.state)
    pt, po = _port_run(pl, arrays, call)
    assert len(po) == len(r.outs)
    for k, (ra, p) in enumerate(zip(r.outs, po)):
        np.testing.assert_allclose(p.numpy(), ra, rtol=RTOL, atol=ATOL,
                                   err_msg=f"output {k}")
    floats = [t for t, a in zip(pt, arrays) if a.dtype.kind == "f"]
    pairs = [(g, p) for g, p in zip(r.input_grads, floats) if g is not None]
    pp = dict(pl.named_parameters())
    assert list(pp) == list(r.param_grads)
    pairs += [(r.param_grads[k], pp[k]) for k in pp]
    for gr, p in pairs:
        gr = np.asarray(gr, np.float64)
        gp = np.asarray(p.grad.numpy(), np.float64)
        np.testing.assert_allclose(gp, gr, rtol=RTOL,
                                   atol=ATOL * max(np.abs(gr).max(), 1.0))


def x_in(seed=0, shape=(B, T, IN)):
    return RS(seed).randn(*shape).astype(np.float32)


def state(seed, *shape):
    return RS(seed).randn(*shape).astype(np.float32)


CELLS = {
    "SimpleRNNCell": (lambda nn: nn.SimpleRNNCell(IN, H), [state(11, B, H)]),
    "SimpleRNNCell_relu": (lambda nn: nn.SimpleRNNCell(IN, H, "relu"),
                           [state(11, B, H)]),
    "LSTMCell": (lambda nn: nn.LSTMCell(IN, H),
                 [state(12, B, H), state(13, B, H)]),
    "LSTMCell_proj": (lambda nn: nn.LSTMCell(IN, H, proj_size=3),
                      [state(12, B, 3), state(13, B, H)]),
    "GRUCell": (lambda nn: nn.GRUCell(IN, H), [state(14, B, H)]),
    "GRUCell_no_bias_ih": (lambda nn: nn.GRUCell(IN, H, bias_ih_attr=False),
                           [state(14, B, H)]),
}


def _cell_case(name):
    build, states = CELLS[name]

    def call(m, x, *st):
        return m(x, st[0] if len(st) == 1 else tuple(st))

    return build, [x_in(1, (B, IN))] + states, call


WRAPPERS = {
    "RNN_GRUCell_reverse": (lambda nn: nn.RNN(nn.GRUCell(IN, H),
                                              is_reverse=True), False),
    "RNN_SimpleRNNCell_time_major": (
        lambda nn: nn.RNN(nn.SimpleRNNCell(IN, H), time_major=True), False),
    "RNN_LSTMCell_sequence_length": (lambda nn: nn.RNN(nn.LSTMCell(IN, H)),
                                     True),
    "BiRNN_LSTMCell_sequence_length": (
        lambda nn: nn.BiRNN(nn.LSTMCell(IN, H), nn.LSTMCell(IN, H)), True),
}


def _wrapper_case(name):
    build, seq = WRAPPERS[name]
    shape = (T, B, IN) if "time_major" in name else (B, T, IN)
    arrays = [x_in(2, shape)]
    if seq:
        arrays.append(np.array([5, 2, 4], np.int64))

        def call(m, x, lens):
            return m(x, sequence_length=lens)
    else:
        def call(m, x):
            return m(x)
    return build, arrays, call


# each fused layer with the inputs it is held on: initial states
# ("states") and sequence lengths ("lengths") spread over the configs
FUSED = {
    "SimpleRNN": (lambda nn: nn.SimpleRNN(IN, H), 1, 1, False, ()),
    "SimpleRNN_relu_bidirect": (
        lambda nn: nn.SimpleRNN(IN, H, direction="bidirect",
                                activation="relu"), 1, 2, False,
        ("states",)),
    "LSTM": (lambda nn: nn.LSTM(IN, H), 1, 1, False, ("lengths",)),
    "LSTM_2_layers_bidirectional": (
        lambda nn: nn.LSTM(IN, H, num_layers=2,
                           direction="bidirectional"), 2, 2, False,
        ("states", "lengths")),
    "GRU": (lambda nn: nn.GRU(IN, H), 1, 1, False, ("states",)),
    "GRU_2_layers_bidirect_time_major": (
        lambda nn: nn.GRU(IN, H, num_layers=2, direction="bidirect",
                          time_major=True), 2, 2, True, ("lengths",)),
    "GRU_no_bias_hh": (lambda nn: nn.GRU(IN, H, bias_hh_attr=False), 1, 1,
                       False, ("states", "lengths")),
}


def _fused_case(name):
    build, layers, dirs, time_major, extra = FUSED[name]
    shape = (T, B, IN) if time_major else (B, T, IN)
    arrays = [x_in(3, shape)]
    lstm = name.startswith("LSTM")
    n_states = 0
    if "states" in extra:
        arrays.append(state(4, layers * dirs, B, H))
        if lstm:
            arrays.append(state(5, layers * dirs, B, H))
        n_states = len(arrays) - 1
    if "lengths" in extra:
        arrays.append(np.array([5, 2, 4], np.int64))

    def call(m, x, *rest):
        st = rest[:n_states]
        kw = {"sequence_length": rest[n_states]} if "lengths" in extra \
            else {}
        if not st:
            return m(x, **kw)
        return m(x, tuple(st) if lstm else st[0], **kw)

    return build, arrays, call


# (build, inputs, call) of every case, by table; the reference runs a
# table's cases in one program
CASES = {"cells": {n: _cell_case(n) for n in CELLS},
         "wrappers": {n: _wrapper_case(n) for n in WRAPPERS},
         "fused": {n: _fused_case(n) for n in FUSED}}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cells_match_the_reference(name):
    _check("cells", name)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_rnn_wrappers_match_the_reference(name):
    _check("wrappers", name)


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_layers_match_the_reference(name):
    _check("fused", name)


def test_proj_size_on_the_fused_path_raises_in_both():
    for pd in (ref, port):
        with pytest.raises(NotImplementedError, match="proj_size"):
            pd.nn.LSTM(IN, H, proj_size=2)


def test_rnn_base_exposes_the_flat_names():
    _, pl = _pair(lambda nn: nn.LSTM(IN, H, num_layers=2,
                                     direction="bidirect"))
    names = [k for k, _ in pl.named_parameters()]
    assert names[:4] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0"]
    assert "weight_hh_l1_reverse" in names and len(names) == 16
    assert pl.could_use_cudnn and pl.state_components == 2


# -- functional autograd ------------------------------------------------------

def _both(fn):
    """fn(pd) on both packages -> (reference result, port result), as
    numpy (nests of lists)."""
    def np_(o):
        if isinstance(o, (list, tuple)):
            return [np_(v) for v in o]
        return np.asarray(o.numpy() if hasattr(o, "numpy") else o)
    return np_(fn(ref)), np_(fn(port))


def _close(r, p):
    if isinstance(r, list):
        assert len(p) == len(r)
        for a, b in zip(r, p):
            _close(a, b)
        return
    assert p.shape == r.shape
    np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)


def _var(pd, a):
    t = pd.to_tensor(np.asarray(a, np.float32))
    t.stop_gradient = False
    return t


def _jac_vector(pd):
    x = _var(pd, [0.5, -1.2, 2.0])
    y = pd.tanh(x) * pd.sum(x * x)
    J = pd.autograd.jacobian(y, x)
    return [J[1], J[:], J[:, 2]]


def _jac_lazy(pd):
    x = _var(pd, [1.0, 2.0, 3.0])
    J = pd.autograd.jacobian(x * x, x)
    row = J[1]
    assert set(J._cache) == {1}
    return [row, J[:]]


def _jac_scalar(pd):
    x = _var(pd, [1.0, 2.0])
    return pd.autograd.jacobian(pd.sum(x * x), x)[:]


def _jac_tuple(pd):
    x1, x2 = _var(pd, [1.0, 2.0]), _var(pd, [3.0, -1.0, 0.5])
    y = pd.concat([x1 * 2.0, pd.sum(x2 * x2).reshape([1])])
    return [j[:] for j in pd.autograd.jacobian(y, (x1, x2))]


def _jac_batched(pd):
    x = _var(pd, RS(0).randn(4, 3))
    y = pd.tanh(x) * 2.0
    return pd.autograd.jacobian(y, x, batch_axis=0)[:]


def _hess_nonlinear(pd):
    x = _var(pd, [0.3, -0.7, 1.1])
    y = pd.sum(pd.sin(x) * x * x)
    return pd.autograd.hessian(y, x)[:]


def _hess_tuple(pd):
    x1, x2 = _var(pd, [0.5, 1.5]), _var(pd, [-1.0, 2.0])
    y = pd.sum(x1 * x1 * x2) + pd.sum(x2 * x2 * x2)
    return [[h[:] for h in row] for row in pd.autograd.hessian(y, (x1, x2))]


def _hess_batched(pd):
    x = _var(pd, RS(1).randn(3, 4))
    y = pd.sum(x * x * x, axis=1)
    return pd.autograd.hessian(y, x, batch_axis=0)[:]


def _vjp(pd):
    def func(x):
        return pd.matmul(x, x)
    x = pd.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    v = pd.to_tensor(np.array([[1.0, 0.0], [0.0, 0.5]], np.float32))
    ys, g = pd.autograd.vjp(func, x)
    _, g2 = pd.autograd.vjp(func, x, v)
    return [ys, g, g2]


def _vjp_tuple(pd):
    def func(a, b):
        return a * b + pd.sin(a)
    x1 = pd.to_tensor(RS(2).randn(3).astype(np.float32))
    x2 = pd.to_tensor(RS(3).randn(3).astype(np.float32))
    ys, gs = pd.autograd.vjp(func, (x1, x2))
    return [ys] + list(gs)


def _jvp(pd):
    def func(x):
        return pd.matmul(x, x)
    x = pd.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    v = pd.to_tensor(np.array([[1.0, 0.0], [0.0, 0.0]], np.float32))
    _, g = pd.autograd.jvp(func, x)
    _, g2 = pd.autograd.jvp(func, x, v)
    return [g, g2]


def _jvp_vjp_transpose(pd):
    rs = RS(3)
    W = pd.to_tensor(rs.randn(4, 3).astype(np.float32))
    x = pd.to_tensor(rs.randn(3).astype(np.float32))
    u = pd.to_tensor(rs.randn(3).astype(np.float32))
    w = pd.to_tensor(rs.randn(4).astype(np.float32))

    def func(t):
        return pd.tanh(pd.matmul(W, t))
    _, ju = pd.autograd.jvp(func, x, u)
    _, jtw = pd.autograd.vjp(func, x, w)
    return [ju, jtw, pd.sum(ju * w), pd.sum(jtw * u)]


FUNCTIONAL = {"jacobian_vector": _jac_vector, "jacobian_lazy": _jac_lazy,
              "jacobian_scalar": _jac_scalar, "jacobian_tuple": _jac_tuple,
              "jacobian_batched": _jac_batched,
              "hessian_nonlinear": _hess_nonlinear,
              "hessian_tuple": _hess_tuple, "hessian_batched": _hess_batched,
              "vjp": _vjp, "vjp_tuple": _vjp_tuple, "jvp": _jvp,
              "jvp_vjp_transpose": _jvp_vjp_transpose}


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_autograd_matches_the_reference(name):
    r, p = _both(FUNCTIONAL[name])
    _close(r, p)


def test_functional_autograd_errors_match():
    for pd in (ref, port):
        x = _var(pd, [[1.0, 2.0], [3.0, 4.0]])
        with pytest.raises(ValueError, match="batch_axis"):
            pd.autograd.jacobian(x * 2.0, x, batch_axis=1)
        with pytest.raises(ValueError, match="ndim"):
            pd.autograd.jacobian(x * 2.0, x)
        with pytest.raises(ValueError, match="numel"):
            pd.autograd.hessian(x * 2.0, x)
        with pytest.raises(RuntimeError, match="shape"):
            pd.autograd.vjp(lambda t: t * 2.0, x,
                            pd.to_tensor(np.ones(3, np.float32)))
