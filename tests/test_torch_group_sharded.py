"""The port's group-sharded training (`paddle_tpu_torch.distributed
.sharding`: stages 1-3, the scaler, offload, the save) against the
reference's (`tests/test_group_sharded.py`).

The reference runs one controller whose sharding is a layout, so its
runs are the unsharded training on the whole batch. The port runs two
gloo ranks (spawned once for the module, through
`tests/torch_dist_workers.py`), rank r on its half of the batch:
- every level ('os', 'os_g', 'p_g_os'), and 'os_g' with offload and
  with a loss scaler: the mean of the ranks' losses and the whole
  parameters after 5 AdamW steps within 1e-6 of the reference's
  unsharded run's largest;
- each rank holds about half the optimizer state, and under stage 3
  half of each parameter's rows;
- the stage-3 model saved by `save_group_sharded_model` loads in the
  reference, its keys the reference model's and its values the port's.
"""
import os

import numpy as np
import pytest

import torch_dist_workers as W
from torch_threads import one_torch_thread

import paddle_tpu as rpaddle
import paddle_tpu.nn as rnn

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import place as pplace
from paddle_tpu_torch.distributed import sharding as S

one_torch_thread()

STEPS = 5
# Linear 16-32 and 32-16: 16 * 32 + 32 + 32 * 16 + 16 elements
NUMEL = 1072


def _payload(tmp):
    weights = [np.random.RandomState(i).normal(scale=0.1, size=s)
               .astype(np.float32)
               for i, s in enumerate([(16, 32), (32,), (32, 16), (16,)])]
    rng = np.random.RandomState(0)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    y = rng.normal(size=(8, 16)).astype(np.float32)
    return {"weights": weights, "x": x, "y": y, "steps": STEPS,
            "ckpt": str(tmp / "ckpt")}


def _ref_unsharded(payload):
    m = rnn.Sequential(rnn.Linear(16, 32), rnn.ReLU(), rnn.Linear(32, 16))
    for p, w in zip(m.parameters(), payload["weights"]):
        p.set_value(rpaddle.to_tensor(w))
    o = rpaddle.optimizer.AdamW(learning_rate=0.01,
                                parameters=m.parameters())
    x, y = rpaddle.to_tensor(payload["x"]), rpaddle.to_tensor(payload["y"])
    losses = []
    for _ in range(STEPS):
        loss = ((m(x) - y) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, [np.asarray(p._data) for p in m.parameters()], m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("group_sharded")
    payload = _payload(tmp)
    procs = W.start("group_sharded", 2, tmp / "w", payload)
    try:
        ref = _ref_unsharded(payload)
    finally:
        outs = W.finish(procs, tmp / "w")
    return {"ranks": outs, "ref": ref, "payload": payload}


def _close(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(np.asarray(g) - w).max() <= tol * np.abs(w).max()


@pytest.mark.parametrize("key", ["os", "os_g", "p_g_os", "os_g_offload",
                                 "os_g_scaler"])
def test_every_level_matches_the_unsharded_reference(runs, key):
    ref_losses, ref_params, _ = runs["ref"]
    outs = runs["ranks"]
    losses = np.mean([outs[r][key]["losses"] for r in range(2)], axis=0)
    _close([losses], [np.asarray(ref_losses)], 1e-6)
    for r in range(2):
        if "params" in outs[r][key]:
            _close(outs[r][key]["params"], ref_params, 1e-6)


def test_the_state_and_the_parameters_are_sharded(runs):
    for r in range(2):
        o = runs["ranks"][r]
        # AdamW's two f32 moments: each rank holds its share only
        for level in ("os", "os_g", "p_g_os"):
            assert 0 < o[level]["state_bytes"] < 2 * 4 * NUMEL
        # stage 3 stores half of every weight's rows (the biases'
        # dims 0 divide by 2 too)
        assert o["p_g_os"]["stored_shapes"] == [(8, 32), (16,), (16, 16),
                                                (8,)]
    assert sum(runs["ranks"][r]["p_g_os"]["state_bytes"]
               for r in range(2)) == 2 * 4 * NUMEL


def test_the_saved_model_loads_in_the_reference(runs):
    _, _, ref_model = runs["ref"]
    ckpt = runs["payload"]["ckpt"]
    assert os.path.exists(os.path.join(ckpt, "model.pdopt"))
    sd = rpaddle.load(os.path.join(ckpt, "model.pdparams"))
    assert set(sd) == set(ref_model.state_dict())
    port = runs["ranks"][0]["p_g_os"]["params"]
    for name, want in zip(["0.weight", "0.bias", "2.weight", "2.bias"], port):
        np.testing.assert_array_equal(np.asarray(sd[name]._data
                                                 if hasattr(sd[name], "_data")
                                                 else sd[name]), want)


def test_an_unknown_level_is_refused():
    pplace.set_device("cpu")
    m = pnn.Sequential(pnn.Linear(4, 4))
    o = popt.SGD(learning_rate=0.1, parameters=m.parameters())
    try:
        with pytest.raises(ValueError, match="level"):
            S.group_sharded_parallel(m, o, "bogus")
    finally:
        pplace._current[0] = None
