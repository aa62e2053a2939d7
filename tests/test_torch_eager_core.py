"""The port's eager core against the reference's on the CPU: `Tensor`
and `to_tensor`, `Place` and `set_device` (the card by default: with no
CUDA device and no CPU request it raises), dtypes, the rng's streams
and the flag registry. The same seeded numpy inputs go to both
packages; values must agree exactly (conversions and copies) or to f32
rounding (arithmetic).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import dtype as D
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.core import rng as port_rng
from paddle_tpu_torch.core.tensor import Parameter, Tensor
from torch_threads import one_torch_thread

one_torch_thread()


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


# -- Place -------------------------------------------------------------------

def test_default_place_is_the_card_and_raises_without_one(monkeypatch):
    port_place._current[0] = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port.get_device() == "gpu:0"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.zeros([2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.set_device("gpu:0")
    t = port.to_tensor([1.0], place="cpu")       # an explicit CPU request
    assert t.place == "cpu" and t.place.is_cpu_place()
    port.set_device("cpu")
    assert port.zeros([2]).place == port.CPUPlace()


def test_place_names():
    assert port.CUDAPlace(1) == "gpu:1" and port.CUDAPlace(1).is_gpu_place()
    assert port_place.Place("cuda:0") == port_place.Place("tpu", 0)
    assert port_place.CPUPlace().torch_device() == torch.device("cpu")
    with pytest.raises(ValueError):
        port_place.Place("xpu")


# -- Tensor ------------------------------------------------------------------

ARRAYS = {
    "f32": np.random.RandomState(0).randn(3, 4).astype(np.float32),
    "f64": np.random.RandomState(1).randn(2, 3),
    "i64": np.random.RandomState(2).randint(-5, 5, (4,)),
    "i32": np.random.RandomState(3).randint(0, 9, (2, 2)).astype(np.int32),
    "bool": np.random.RandomState(4).rand(5) < 0.5,
    "list": [[1.0, 2.0], [3.0, 4.0]],
    "scalar": 2.5,
    "int": 7,
}


@pytest.mark.parametrize("kind", sorted(ARRAYS))
def test_to_tensor_matches_the_reference(kind):
    a = ARRAYS[kind]
    r, p = ref.to_tensor(a), port.to_tensor(a)
    assert p.dtype == r.dtype.name, (p.dtype, r.dtype)
    assert p.shape == r.shape and p.ndim == r.ndim and p.size == r.size
    np.testing.assert_array_equal(p.numpy(), r.numpy())
    assert p.stop_gradient and r.stop_gradient


def test_tensor_surface():
    a = ARRAYS["f32"]
    r, p = ref.to_tensor(a), port.to_tensor(a)
    for fn in (lambda t: (t + 1.5) * t - t / 2.0, lambda t: -t, abs,
               lambda t: t.sum(axis=1), lambda t: t.T, lambda t: t[1:, ::2],
               lambda t: t.reshape([4, 3]), lambda t: t.astype("float64"),
               lambda t: t.mean(), lambda t: t.clone(), lambda t: 2.0 - t,
               lambda t: t ** 2, lambda t: t @ t.T):
        np.testing.assert_allclose(fn(p).numpy(), fn(r).numpy(), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal((p > 0).numpy(), (r > 0).numpy())
    assert float(p.sum()) == pytest.approx(float(r.sum()), rel=1e-6)
    assert p[0, 0].item() == r[0, 0].item()
    assert len(p) == 3 and p.tolist() == p.numpy().tolist()
    with pytest.raises(ValueError):
        bool(p)
    q = port.to_tensor(a)
    q[0] = 0.0                                  # functional setitem
    np.testing.assert_array_equal(q.numpy()[0], np.zeros(4, np.float32))
    q.add_(port.ones([3, 4]))                   # in-place rebinds
    np.testing.assert_allclose(q.numpy()[1], a[1] + 1)
    q.set_value(a)
    np.testing.assert_array_equal(q.numpy(), a)
    with pytest.raises(ValueError):
        q.set_value(np.zeros((2, 2), np.float32))


def test_stop_gradient_and_parameters():
    t = port.to_tensor([1.0, 2.0])
    assert t.stop_gradient and not t._data.requires_grad
    t.stop_gradient = False
    assert t._data.requires_grad and t.is_leaf
    y = t * 2
    assert not y.stop_gradient and not y.is_leaf
    y.stop_gradient = True                      # cuts the graph there
    assert not y._data.requires_grad
    i = port.to_tensor([1, 2])
    i.stop_gradient = False                     # kept on the wrapper
    assert not i.stop_gradient and not i._data.requires_grad
    w = Parameter(np.ones((2, 2), np.float32), name="w")
    assert w.is_parameter and w.persistable and not w.stop_gradient
    assert w._data.is_leaf and w._data.requires_grad
    frozen = Parameter.from_tensor(t, trainable=False)
    assert frozen.stop_gradient and not frozen.trainable
    assert isinstance(w.detach(), Tensor) and w.detach().stop_gradient


def test_bare_torch_calls_are_unchanged():
    """A registered op called with bare torch tensors returns what the
    function returns: a torch.Tensor, as the engine and the fused-op
    callers always had."""
    a, b = torch.ones(3), torch.full((3,), 2.0)
    out = port.add(a, b)
    assert type(out) is torch.Tensor
    assert torch.equal(out, a + b)
    from paddle_tpu_torch import _C_ops
    x = torch.randn(4, 8)
    y = _C_ops.swiglu(x)
    assert type(y) is torch.Tensor
    wrapped = _C_ops.swiglu(port.to_tensor(x.numpy()))
    assert isinstance(wrapped, Tensor)
    np.testing.assert_allclose(wrapped.numpy(), y.numpy(), rtol=1e-6)


# -- dtype -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bool", "uint8", "int8", "int16", "int32",
                                  "int64", "float16", "bfloat16", "float32",
                                  "float64", "complex64", "complex128"])
def test_dtype_names_match_the_reference(name):
    d, r = D.DType(name), ref.core.dtype.DType(name)
    assert d == name and d == r.name and str(d) == str(r)
    assert repr(d) == repr(r)
    assert d.is_floating_point == r.is_floating_point
    assert d.is_complex == r.is_complex and d.is_integer == r.is_integer
    assert d.itemsize == r.itemsize
    assert D.DType(d.torch_dtype) is d and d == d.torch_dtype
    if name != "bfloat16":
        assert d == np.dtype(name) and d.np_dtype == np.dtype(name)


def test_default_dtype():
    assert D.get_default_dtype() == ref.get_default_dtype() == "float32"
    try:
        D.set_default_dtype("float64")
        assert port.to_tensor([1.5]).dtype == "float64"
        with pytest.raises(TypeError):
            D.set_default_dtype("int32")
    finally:
        D.set_default_dtype("float32")
    with pytest.raises(TypeError):
        D.DType("float7")


# -- rng ---------------------------------------------------------------------

def test_rng_streams():
    port.seed(123)
    a = port.uniform([4, 4]).numpy()
    n0 = port_rng.consumption_count()
    b = port.gaussian([3]).numpy()
    assert port_rng.consumption_count() == n0 + 1
    port.seed(123)
    np.testing.assert_array_equal(port.uniform([4, 4]).numpy(), a)
    np.testing.assert_array_equal(port.gaussian([3]).numpy(), b)
    state = port.get_rng_state()
    c = port.randint(0, 10, [8]).numpy()
    port.set_rng_state(state)
    np.testing.assert_array_equal(port.randint(0, 10, [8]).numpy(), c)
    # a nonzero per-op seed is a fixed draw and leaves the stream alone
    n1 = port_rng.consumption_count()
    np.testing.assert_array_equal(port.uniform([5], seed=7).numpy(),
                                  port.uniform([5], seed=7).numpy())
    assert port_rng.consumption_count() == n1
    assert port_rng.default_generator.initial_seed() == 123
    u = port.uniform([2000], min=-2.0, max=3.0).numpy()
    assert u.min() >= -2.0 and u.max() < 3.0


# -- flags -------------------------------------------------------------------

def test_flags_match_the_reference():
    ref_flags = ref.core.flags
    for name in ("check_nan_inf", "benchmark", "eager_async_depth",
                 "eager_dispatch_cache", "fused_optimizer", "jit_cache_size"):
        assert port_flags.get_flags(name) == ref_flags.get_flags(name)
    with pytest.raises(ValueError, match="did you mean"):
        port_flags.set_flags({"FLAGS_eager_async_dept": 1})
    seen = []
    port_flags.on_change(lambda k, v: seen.append((k, v)))
    try:
        port.set_flags({"FLAGS_check_nan_inf": True})
        assert seen[-1] == ("check_nan_inf", True)
        with pytest.raises(FloatingPointError):
            port.log(port.to_tensor([-1.0]))
    finally:
        port.set_flags({"FLAGS_check_nan_inf": False})
        port_flags._WATCHERS.pop()
