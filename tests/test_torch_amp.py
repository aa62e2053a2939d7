"""AMP, the port against the reference on the CPU: `auto_cast`'s per-op
dtype policy, the float16 `GradScaler`, the loss-scaling ops and
`amp.debugging`.

- Output types: a small net (Linear, LayerNorm, softmax, matmul, relu,
  exp, mean, ...) run under O1 and O2 in bfloat16 and float16 in both
  packages; `amp.debugging`'s operator statistics ({op: {output dtype:
  calls}}) equal, exactly. The reference's AMP hook dispatches its
  casts as ops (`cast`); the port casts inside the op's own call, so
  `cast` is left out of the comparison.
- The float16 scaler: the net's two Linear layers and the same
  gradients (non-finite on the steps where the input holds an inf), `incr_every_n_steps` 3,
  `decr_every_n_nan_or_inf` 2: the scale after every step and the
  skipped steps exactly; the weights after the run within rtol 1e-3
  (float16 products).
- `check_finite_and_unscale_` / `update_loss_scaling_`: exact.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.amp.debugging  # noqa: F401  (not loaded by paddle_tpu.amp)
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place


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


def _net(pd):
    class Net(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pd.nn.Linear(8, 16)
            self.norm = pd.nn.LayerNorm(16)
            self.fc2 = pd.nn.Linear(16, 4)

        def forward(self, x):
            h = pd.nn.functional.relu(self.fc1(x))
            h = self.norm(h)
            att = pd.nn.functional.softmax(pd.matmul(h, h, transpose_y=True),
                                           axis=-1)
            h = pd.matmul(att, h) + h
            return self.fc2(h).exp().mean(axis=-1) + h.sum(axis=-1) * 0.01

    return Net()


def _pair(seed=0):
    ref.seed(seed)
    rm, pm = _net(ref), _net(port)
    pm.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in rm.state_dict().items()})
    return rm, pm


def _x(seed=1):
    return np.random.RandomState(seed).randn(2, 5, 8).astype(np.float32)


def _stats(pd, model, x, level, dtype):
    dbg = pd.amp.debugging
    dbg.enable_operator_stats_collection()
    try:
        with pd.amp.auto_cast(level=level, dtype=dtype):
            out = model(pd.to_tensor(x))
    finally:
        dbg._uninstall()
    stats = {k: dict(v) for k, v in dbg._STATS.items() if k != "cast"}
    return stats, out


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_output_types_match_the_reference(level, dtype):
    rm, pm = _pair()
    x = _x()
    rs, ro = _stats(ref, rm, x, level, dtype)
    ps, po = _stats(port, pm, x, level, dtype)
    assert ps == rs
    assert str(po.dtype) == str(ro.dtype).replace("paddle.", "")
    np.testing.assert_allclose(
        np.asarray(po.numpy(), np.float32), np.asarray(ro.numpy(),
                                                       np.float32),
        rtol=2e-2, atol=2e-2)


def test_o2_decorate_keeps_norms_float32():
    rm, pm = _pair()
    ref.amp.decorate(rm, level="O2", dtype="bfloat16")
    port.amp.decorate(pm, level="O2", dtype="bfloat16")
    rtypes = {k: str(v.dtype) for k, v in rm.state_dict().items()}
    ptypes = {k: str(v.dtype) for k, v in pm.state_dict().items()}
    assert {k: v.replace("paddle.", "") for k, v in rtypes.items()} == ptypes
    assert ptypes["norm.weight"] == "float32"
    assert ptypes["fc1.weight"] == "bfloat16"


INF_STEPS = (2, 3, 9, 10)


def _scaler_run(pd, model, steps=12):
    opt = pd.optimizer.SGD(learning_rate=0.01,
                           parameters=model.parameters())
    scaler = pd.amp.GradScaler(init_loss_scaling=1024.0,
                               incr_every_n_steps=3,
                               decr_every_n_nan_or_inf=2)
    trace = []
    for i in range(steps):
        x = _x(seed=10 + i)
        if i in INF_STEPS:
            x[0, 0, 0] = np.inf
        with pd.amp.auto_cast(dtype="float16"):
            h = pd.nn.functional.relu(model.fc1(pd.to_tensor(x)))
            loss = model.fc2(h).astype("float32").mean()
        before = model.fc2.bias.numpy().copy()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        skipped = bool(np.array_equal(before, model.fc2.bias.numpy()))
        trace.append((scaler._scale, skipped))
    return trace, {k: np.asarray(v.numpy(), np.float32)
                   for k, v in model.state_dict().items()}


def test_float16_scaler_trajectory_matches_the_reference():
    rm, pm = _pair()
    want, rstate = _scaler_run(ref, rm)
    got, pstate = _scaler_run(port, pm)
    assert got == want
    assert [s for s, (_, skip) in enumerate(got) if skip] == list(INF_STEPS)
    for k in rstate:
        np.testing.assert_allclose(pstate[k], rstate[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)


def test_bfloat16_scaler_passes_through():
    _, pm = _pair()
    opt = port.optimizer.SGD(learning_rate=0.01,
                             parameters=pm.parameters())
    scaler = port.amp.GradScaler(init_loss_scaling=1024.0,
                                 incr_every_n_steps=1)
    with port.amp.auto_cast(dtype="bfloat16"):
        loss = pm(port.to_tensor(_x())).astype("float32").sum()
    assert scaler.scale(loss) is loss
    before = pm.fc2.bias.numpy().copy()
    loss.backward()
    scaler.minimize(opt, loss)
    assert scaler.get_init_loss_scaling() == 1024.0
    assert not np.array_equal(before, pm.fc2.bias.numpy())


@pytest.mark.parametrize("inject", [False, True])
def test_check_finite_and_unscale_matches_the_reference(inject):
    rs = np.random.RandomState(0)
    grads = [rs.randn(3, 4).astype(np.float32) * 512,
             rs.randn(5).astype(np.float32) * 512]
    if inject:
        grads[1][2] = np.nan
    scale = np.asarray(512.0, np.float32)
    outs = []
    for pd in (ref, port):
        op = pd._C_ops.check_finite_and_unscale_
        gs, found = op([pd.to_tensor(g) for g in grads], pd.to_tensor(scale))
        outs.append(([g.numpy() for g in gs], bool(found.numpy())))
    assert outs[1][1] == outs[0][1] == inject
    for r, p in zip(outs[0][0], outs[1][0]):
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("found,good,bad", [(False, 0, 0), (False, 2, 0),
                                            (True, 3, 0), (True, 0, 1)])
def test_update_loss_scaling_matches_the_reference(found, good, bad):
    g = np.random.RandomState(1).randn(4).astype(np.float32)
    outs = []
    for pd in (ref, port):
        op = pd._C_ops.update_loss_scaling_
        gs, scale, gd, bd = op(
            [pd.to_tensor(g)], pd.to_tensor(np.asarray(found)),
            pd.to_tensor(np.asarray(256.0, np.float32)),
            pd.to_tensor(np.asarray(good, np.int32)),
            pd.to_tensor(np.asarray(bad, np.int32)),
            incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
        outs.append((gs[0].numpy(), float(scale.numpy()),
                     int(gd.numpy()), int(bd.numpy())))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[1][1:] == outs[0][1:]


def test_tensor_checker_raises_on_a_non_finite_output():
    dbg = port.amp.debugging
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))
    try:
        with pytest.raises(FloatingPointError, match="log"):
            port.log(port.to_tensor(np.array([-1.0], np.float32)))
        port.exp(port.to_tensor(np.array([1.0], np.float32)))
    finally:
        dbg.disable_tensor_checker()
    port.log(port.to_tensor(np.array([-1.0], np.float32)))   # unhooked


def test_amp_hook_is_removed_outside_auto_cast():
    from paddle_tpu_torch.ops import dispatch

    assert dispatch._amp_hook is None
    with port.amp.auto_cast():
        assert dispatch._amp_hook is not None
        with port.amp.auto_cast(dtype="float16"):
            pass
        assert dispatch._amp_hook is not None
    assert dispatch._amp_hook is None
