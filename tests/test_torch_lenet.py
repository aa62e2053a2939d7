"""LeNet training, the port against the reference on the CPU: the
bench's `mnist_lenet_dygraph` loop (`bench.py:171`: LeNet, B = 64, the
4 seeded batches of `RandomState(0)`), 8 steps, with Momentum (lr 0.01,
0.9, the bench's), SGD, Adam and AdamW.

The port's LeNet starts from the reference's weights carried across:
the reference model's `state_dict()` as numpy arrays, loaded with
`set_state_dict` (random draws cannot match: jax threefry against torch
Philox). Paddle's names and shapes are kept, so the dict loads with no
missing or unexpected key (Linear weights [in, out]). Tolerance: every
step's loss within rtol 1e-5 of the reference's, and the final weights
within rtol 1e-4, atol 1e-6 (f32: the two packages sum convolutions
and products in different orders, and 8 steps compound it).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from torch_threads import one_torch_thread

one_torch_thread()

B, STEPS = 64, 8
OPTIMIZERS = {
    "Momentum": dict(learning_rate=0.01, momentum=0.9),
    "SGD": dict(learning_rate=0.01),
    "Adam": dict(learning_rate=0.001),
    "AdamW": dict(learning_rate=0.001),
}


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    """The reference on its plain eager path (no per-op or per-group jit
    compiles for 8 steps; the same update rules)."""
    names = ("FLAGS_eager_dispatch_cache",)
    prev = ref.get_flags(list(names))
    ref.set_flags({n: False for n in names})
    yield
    ref.set_flags(prev)


def _batches():
    rs = np.random.RandomState(0)
    return [(rs.randn(B, 1, 28, 28).astype(np.float32),
             rs.randint(0, 10, (B,))) for _ in range(4)]


def _train(pd, model, opt_name, batches):
    opt = getattr(pd.optimizer, opt_name)(parameters=model.parameters(),
                                          **OPTIMIZERS[opt_name])
    data = [(pd.to_tensor(x), pd.to_tensor(y)) for x, y in batches]
    losses = []
    for i in range(STEPS):
        x, y = data[i % len(data)]
        loss = pd.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, opt


def _models(seed=0):
    ref.seed(seed)
    rm = ref.vision.models.LeNet()
    pm = port.vision.models.LeNet()
    state = {k: np.asarray(v.numpy()) for k, v in rm.state_dict().items()}
    missing, unexpected = pm.set_state_dict(state)
    assert not missing and not unexpected
    return rm, pm


def test_state_dict_names_and_shapes_match():
    rm, pm = _models()
    rs, ps = rm.state_dict(), pm.state_dict()
    assert list(ps) == list(rs)
    for k in rs:
        assert ps[k].shape == rs[k].shape, k
        np.testing.assert_array_equal(ps[k].numpy(), rs[k].numpy())
    assert ps["fc.0.weight"].shape == [400, 120]     # paddle's [in, out]


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_losses_match_the_reference(opt_name):
    batches = _batches()
    rm, pm = _models()
    rl, _ = _train(ref, rm, opt_name, batches)
    pl, _ = _train(port, pm, opt_name, batches)
    np.testing.assert_allclose(pl, rl, rtol=1e-5, err_msg=opt_name)
    assert pl[-1] < pl[0]
    rs, ps = rm.state_dict(), pm.state_dict()
    for k in rs:
        np.testing.assert_allclose(ps[k].numpy(), rs[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
