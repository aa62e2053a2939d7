"""The eager core on the card: the default place, a real step's CUDA
event in `core/async_engine`, backpressure waiting on it, and LeNet's
step on `gpu:0` against the CPU's from the same weights.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture). The file imports neither jax nor the reference, so it runs on
the card machine with `--noconftest`:

    python -m pytest tests/test_torch_eager_cuda.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.core import async_engine as AE
from paddle_tpu_torch.core import place as port_place
from torch_threads import one_torch_thread

one_torch_thread()

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the eager core's steps on the card "
                    "record CUDA events")
    port_place._current[0] = None
    yield
    port_place._current[0] = None


def test_default_place_is_the_card():
    assert P.get_device() == "gpu:0"
    t = P.to_tensor([1.0, 2.0])
    assert t._data.is_cuda and t.place == "gpu:0"
    assert P.zeros([3])._data.is_cuda
    assert (t + 1.0)._data.is_cuda
    assert P.to_tensor([1.0], place="cpu")._data.device.type == "cpu"


def test_steps_in_flight_are_cuda_events():
    AE.drain()
    AE.reset_stats()
    x = P.to_tensor(np.ones((2048, 2048), np.float32))
    for _ in range(5):
        for _ in range(4):
            x = x @ x * 1e-3
        AE.mark_step([x])
        assert AE.in_flight() <= AE.depth()
    st = AE.stats()
    assert st["steps_marked"] == 5 and st["backpressure_waits"] == 3
    AE.synchronize()
    assert AE.in_flight() == 0


def test_lenet_step_on_the_card_matches_the_cpu():
    P.seed(0)
    model = P.vision.models.LeNet()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(0)
    x, y = rs.randn(64, 1, 28, 28).astype(np.float32), rs.randint(0, 10, 64)
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        losses = {}
        for place in ("gpu:0", "cpu"):
            P.set_device(place)
            m = P.vision.models.LeNet()
            m.set_state_dict(state)
            opt = P.optimizer.Momentum(0.01, 0.9, parameters=m.parameters())
            out = []
            for _ in range(3):
                loss = P.nn.functional.cross_entropy(
                    m(P.to_tensor(x)), P.to_tensor(y))
                loss.backward()
                opt.step()
                opt.clear_grad()
                out.append(float(loss))
            losses[place] = out
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    np.testing.assert_allclose(losses["gpu:0"], losses["cpu"], rtol=1e-4)


def test_bare_cuda_tensors_stay_bare():
    a = torch.ones(8, device="cuda")
    out = P.add(a, a)
    assert type(out) is torch.Tensor and out.is_cuda
