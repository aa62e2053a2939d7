"""The port's async eager steps and dispatch cache (`core/async_engine.py`,
`ops/dispatch.py`), the counterparts of the reference's
`tests/test_async_eager.py` checks: the depth bound, backpressure on the
oldest step, synchronous mode at depth 0, fetches retiring finished
steps, and the dispatch counters after warm-up (`traces` 0, as the
reference's; the port has no cache, so `hit_rate` is None and
`dispatches` counts the calls through the port layer). Bare torch calls
of a registered op are the function's own calls, whatever the flags.

On the CPU torch finishes every op before it returns, so a step has no
event; these tests stand in a recorded step with a fake event (the
same `query` / `synchronize` surface as `torch.cuda.Event`). The card's
own events are exercised by `chip_smoke.py` `LENET`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.ops import dispatch as ref_dispatch
from paddle_tpu_torch.core import async_engine as AE
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.ops import dispatch as D
from torch_threads import one_torch_thread

one_torch_thread()


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


class _Event:
    """A recorded step; `done` says whether the card has finished it."""

    log = []

    def __init__(self, n):
        self.n, self.done = n, False

    def query(self):
        return self.done

    def synchronize(self):
        _Event.log.append(self.n)
        self.done = True


@pytest.fixture
def fake_card(monkeypatch):
    events = []

    def record(dev):
        events.append(_Event(len(events)))
        return events[-1]

    monkeypatch.setattr(AE, "_device_of", lambda tensors: "card")
    monkeypatch.setattr(AE, "_record", record)
    _Event.log = []
    AE.drain()
    AE.reset_stats()
    yield events
    AE.drain()


def _set_depth(d):
    port.set_flags({"FLAGS_eager_async_depth": d})


def test_depth_bounds_steps_in_flight(fake_card):
    assert AE.depth() == 2 == ref.get_flags("FLAGS_eager_async_depth")[
        "FLAGS_eager_async_depth"]
    for _ in range(5):
        AE.mark_step([object()], tag="step")
        assert AE.in_flight() <= 2
    # steps 0, 1 and 2 were waited on, oldest first, as 3, 4 and 5 came
    assert _Event.log == [0, 1, 2]
    st = AE.stats()
    assert st["backpressure_waits"] == 3 and st["steps_marked"] == 5
    assert st["max_depth_seen"] == 2 and st["in_flight"] == 2


def test_depth_zero_is_synchronous(fake_card):
    _set_depth(0)
    try:
        for _ in range(3):
            AE.mark_step([object()])
            assert AE.in_flight() == 0
        assert _Event.log == [0, 1, 2]
        assert AE.stats()["backpressure_waits"] == 0
    finally:
        _set_depth(2)


def test_fetch_retires_finished_steps_and_drain_waits(fake_card):
    _set_depth(4)
    try:
        for _ in range(3):
            AE.mark_step([object()])
        fake_card[0].done = True          # the card finished the oldest
        AE.scalar_fetch(None)
        assert AE.in_flight() == 2 and _Event.log == []
        assert AE.stats()["sync_fetches"] == 1
        AE.drain()
        assert AE.in_flight() == 0 and _Event.log == [1, 2]
    finally:
        _set_depth(2)


def test_cpu_steps_are_complete_when_marked():
    AE.reset_stats()
    t = port.to_tensor([1.0, 2.0])
    AE.mark_step([t])
    assert AE.in_flight() == 0 and AE.stats()["steps_marked"] == 1
    AE.synchronize()


def test_optimizer_step_marks_a_step(fake_card):
    w = port.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    opt = port.optimizer.SGD(learning_rate=0.1, parameters=[w])
    (w * w).sum().backward()
    opt.step()
    assert len(fake_card) == 1 and AE.stats()["steps_marked"] == 1


def _warm_loop(pd, dispatch):
    a = pd.to_tensor(np.random.RandomState(0).rand(16, 16).astype(np.float32))
    b = pd.to_tensor(np.random.RandomState(1).rand(16, 16).astype(np.float32))
    for _ in range(8):
        c = a + b
    float(c.sum().numpy())
    dispatch.reset_dispatch_cache_stats()
    for _ in range(50):
        c = a + b
    return dispatch.dispatch_cache_stats()


def test_no_trace_after_warm_up_as_the_reference():
    got = _warm_loop(port, D)
    want = _warm_loop(ref, ref_dispatch)
    assert got["traces"] == want["traces"] == 0
    assert want["hit_rate"] == 1.0
    assert got["hit_rate"] is None and got["hits"] == got["misses"] == 0
    assert got["dispatches"] == 50


def test_dispatches_count_port_and_creation_calls_only():
    D.reset_dispatch_cache_stats()
    t = port.to_tensor(np.ones((3,), np.float32))
    t + t
    z = port.zeros([2])                   # no tensor at all: wrapped
    assert type(z) is port.Tensor
    D.get_op("add")(t._data, t._data)     # bare: not counted
    assert D.dispatch_cache_stats()["dispatches"] == 2


def _double(x, y=None):
    return 2 * x


@pytest.mark.parametrize("flag", ["FLAGS_check_nan_inf", "FLAGS_benchmark"])
@pytest.mark.parametrize("nondiff", [False, True])
def test_bare_call_is_the_functions_own_under_flags(flag, nondiff):
    """A registered op called on bare torch tensors returns exactly what
    the function returns, with no flag check and no counter, even with
    the per-op flags on (a NaN passes through unscanned)."""
    api = D.register_op(name="_bare_probe", nondiff=nondiff)(_double)
    port.set_flags({flag: True})
    try:
        D.reset_dispatch_cache_stats()
        x = torch.tensor([1.0, float("nan")], requires_grad=True)
        out = api(x, y=[x])
        assert type(out) is torch.Tensor
        assert torch.equal(out[:1], torch.tensor([2.0]))
        assert bool(torch.isnan(out[1]))
        assert out.requires_grad is not nondiff
        assert D.dispatch_cache_stats()["dispatches"] == 0
        if flag == "FLAGS_check_nan_inf":
            with pytest.raises(FloatingPointError):
                api(port.to_tensor([float("nan")]))
    finally:
        port.set_flags({flag: False})
        D.OPS.pop("_bare_probe")
