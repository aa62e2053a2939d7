"""The port's autograd entry points against the reference's, case for
case (`tests/test_autograd.py`): `backward`, `paddle.grad`, hooks,
accumulation, `retain_graph`, `stop_gradient`, `detach` and `no_grad`.

Each case is one function written against the paddle API; it runs on
`paddle_tpu` (the reference, its own tape) and on `paddle_tpu_torch`
(torch's autograd under the same API) on the CPU, and the gradients it
returns must agree to f32 rounding (rtol 1e-6, atol 1e-7; DTYPE_THRESHOLDS'
f32 grad_rtol, 5e-3, is far looser). Error cases must raise the same
exception type in both.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from torch_threads import one_torch_thread

one_torch_thread()

PKGS = {"ref": ref, "port": port}


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


def _np(t):
    return None if t is None else np.asarray(t.numpy(), np.float64)


def case_simple(pd):
    x = pd.to_tensor([2.0, 3.0], stop_gradient=False)
    (x * x).sum().backward()
    return [x.grad]


def case_chain(pd):
    x = pd.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 3.0
    (y * y).sum().backward()
    return [x.grad]


def case_matmul(pd):
    rng = np.random.default_rng(0)
    a = pd.to_tensor(rng.standard_normal((3, 4)).astype(np.float32),
                     stop_gradient=False)
    b = pd.to_tensor(rng.standard_normal((4, 2)).astype(np.float32),
                     stop_gradient=False)
    pd.matmul(a, b).sum().backward()
    return [a.grad, b.grad]


def case_accumulation(pd):
    x = pd.to_tensor([1.0], stop_gradient=False)
    (x * 2 + x * 3).backward()
    (x * 4).sum().backward()          # a second pass adds into .grad
    return [x.grad]


def case_retain_graph(pd):
    x = pd.to_tensor([2.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    return [x.grad]


def case_stop_gradient(pd):
    x = pd.to_tensor([1.0], stop_gradient=False)
    y = pd.to_tensor([2.0], stop_gradient=True)
    (x * y).sum().backward()
    assert y.grad is None
    return [x.grad]


def case_detach(pd):
    x = pd.to_tensor([3.0], stop_gradient=False)
    d = (x * 2).detach()
    (d * x).sum().backward()
    return [x.grad]


def case_no_grad(pd):
    x = pd.to_tensor([1.0], stop_gradient=False)
    with pd.no_grad():
        y = x * 2
    assert y.stop_gradient
    return [y]


def case_grad_api(pd):
    x = pd.to_tensor([1.0, 2.0], stop_gradient=False)
    (gx,) = pd.grad([(x * x * x).sum()], [x])
    assert x.grad is None               # paddle.grad writes no .grad
    return [gx]


def case_grad_nonleaf(pd):
    x = pd.to_tensor([1.0], stop_gradient=False)
    y = x * 2
    (gy,) = pd.grad([(y * y).sum()], [y])
    return [gy]


def case_grad_allow_unused(pd):
    x = pd.to_tensor([1.0], stop_gradient=False)
    u = pd.to_tensor([1.0], stop_gradient=False)
    gx, gu = pd.grad([(x * x).sum()], [x, u], allow_unused=True)
    assert gu is None
    return [gx]


def case_hook_leaf(pd):
    x = pd.to_tensor([1.0], stop_gradient=False)
    seen = []

    def hook(g):
        seen.append(g.numpy().copy())
        return g * 2

    x.register_hook(hook)
    (x * 3).sum().backward()
    assert len(seen) == 1
    return [pd.to_tensor(seen[0]), x.grad]


def case_hook_intermediate(pd):
    x = pd.to_tensor([1.0], stop_gradient=False)
    y = x * 2
    seen = []
    y.register_hook(lambda g: seen.append(g.numpy().copy()))
    (y * 5).sum().backward()
    return [pd.to_tensor(seen[0]), x.grad]


def case_hook_remove(pd):
    x = pd.to_tensor([1.0, 2.0], stop_gradient=False)
    h = x.register_hook(lambda g: g * 10)
    h.remove()
    (x * x).sum().backward()
    return [x.grad]


def case_multi_output(pd):
    x = pd.to_tensor([[4.0, 1.0], [2.0, 3.0]], stop_gradient=False)
    vals, _ = pd.topk(x, 1, axis=1)
    vals.sum().backward()
    return [x.grad]


def case_broadcast(pd):
    x = pd.to_tensor([[1.0, 2.0], [3.0, 4.0]], stop_gradient=False)
    b = pd.to_tensor([1.0, 1.0], stop_gradient=False)
    ((x + b) * 2).sum().backward()
    return [x.grad, b.grad]


def case_softmax_ce(pd):
    logits = pd.to_tensor(np.random.default_rng(1).standard_normal(
        (4, 5)).astype(np.float32), stop_gradient=False)
    labels = pd.to_tensor([0, 1, 2, 3])
    pd.nn.functional.cross_entropy(logits, labels).backward()
    return [logits.grad]


def case_grad_tensor(pd):
    x = pd.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 3).backward(pd.to_tensor([1.0, 0.5]))
    return [x.grad]


def case_clear_grad(pd):
    x = pd.to_tensor([1.0], stop_gradient=False)
    (x * 2).sum().backward()
    assert x.grad is not None
    x.clear_grad()
    assert x.grad is None
    (x * 5).sum().backward()
    return [x.grad]


def case_autograd_backward(pd):
    x = pd.to_tensor([1.0, 2.0], stop_gradient=False)
    y1, y2 = (x * x).sum(), (x * 3).sum()
    pd.autograd.backward([y1, y2])
    return [x.grad]


def case_create_graph(pd):
    x = pd.to_tensor([1.5, -0.5], stop_gradient=False)
    (gx,) = pd.grad([(x * x * x).sum()], [x], create_graph=True)
    (ggx,) = pd.grad([gx.sum()], [x])
    return [gx, ggx]


CASES = {n[5:]: f for n, f in sorted(globals().items())
         if n.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_the_reference(name):
    got = {k: [_np(t) for t in CASES[name](pd)] for k, pd in PKGS.items()}
    assert len(got["ref"]) == len(got["port"])
    for r, p in zip(got["ref"], got["port"]):
        np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7, err_msg=name)


def err_backward_twice(pd):
    y = (pd.to_tensor([1.0], stop_gradient=False) ** 2).sum()
    y.backward()
    y.backward()


def err_unused_input(pd):
    x = pd.to_tensor([1.0], stop_gradient=False)
    u = pd.to_tensor([1.0], stop_gradient=False)
    pd.grad([(x * x).sum()], [u])


def err_nonscalar_seed(pd):
    (pd.to_tensor([1.0, 2.0], stop_gradient=False) * 2).backward()


ERRORS = {n[4:]: f for n, f in sorted(globals().items())
          if n.startswith("err_")}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_errors_match_the_reference(name):
    for pd in PKGS.values():
        with pytest.raises(RuntimeError):
            ERRORS[name](pd)
