"""The port's DataParallel, its bucketed reducer, ZeRO-1 and the int8 wire
(`paddle_tpu_torch.distributed.parallel`, `.quant_comm`) against the
reference's (`tests/test_dp_overlap.py`, `tests/test_quant_comm.py`).

The reference runs one controller: its DataParallel averages gradients
that are the same on every device, so its run is the single-device
training on the whole batch. The port runs one process a rank (four gloo
ranks on the CPU, spawned once for the module, through
`tests/torch_dist_workers.py`), rank r training on its block of rows of
each global batch; the mean of the ranks' losses is the whole batch's.
- DataParallel at world 1 (this process) and over 2 and 4 ranks, Adam:
  losses and updated parameters within 1e-6 of the reference's largest;
  `no_sync` accumulation (Momentum, 2 micro-batches) the same;
- within the port: the overlapped reducer bit-equal to barrier mode;
  ZeRO-1 against unsharded within 1e-6 (2 and 4 ranks) with the
  optimizer state at most (1 + pad) / world of the unsharded; ZeRO-1
  bit-equal to unsharded under no_sync and on the int8 wire; the int8
  wire within 5e-3 and bf16 within 5e-2 of the f32 wire; Lamb's one
  warning; the reducer's issue, drain, partial-bucket and steady-plan
  behaviour, as the reference's tests hold it;
- the bucket partition equal to the reference's for the same parameter
  list and buffer sizes; the int8 codec's wire bytes equal across the
  packages, the error-feedback residual within 1e-6 over 3 steps, the
  decoded mean within 1e-6; the P2P codec the same.
"""
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from torch_threads import one_torch_thread

import paddle_tpu as rpaddle
import paddle_tpu.distributed as rdist
import paddle_tpu.optimizer as ropt
from paddle_tpu.core import flags as rflags
from paddle_tpu.distributed import parallel as rpar
from paddle_tpu.distributed import quant_comm as rqc

import paddle_tpu_torch as P
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import flags as pflags
from paddle_tpu_torch.core import place as pplace
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import parallel as D
from paddle_tpu_torch.distributed import quant_comm as QC

one_torch_thread()

STEPS = 3


@pytest.fixture(autouse=True)
def _cpu():
    pplace.set_device("cpu")
    yield
    pplace._current[0] = None


def _payload():
    rs = np.random.RandomState(0)
    weights = [rs.randn(8, 16).astype(np.float32) * 0.3,
               rs.randn(16).astype(np.float32) * 0.1,
               rs.randn(16, 4).astype(np.float32) * 0.3,
               rs.randn(4).astype(np.float32) * 0.1]
    x = rs.randn(STEPS, 8, 8).astype(np.float32)
    xa = rs.randn(STEPS, 2, 8, 8).astype(np.float32)
    return {"weights": weights, "x": x, "xa": xa}


def _ref_train(payload, opt_name, accumulate=0):
    """The reference's DataParallel run on the whole batches."""
    import paddle_tpu.nn as rnn
    import paddle_tpu.nn.functional as RF

    class MLP(rnn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = rnn.Linear(8, 16)
            self.l2 = rnn.Linear(16, 4)

        def forward(self, x):
            return self.l2(RF.relu(self.l1(x)))

    m = MLP()
    for p, w in zip(m.parameters(), payload["weights"]):
        p.set_value(rpaddle.to_tensor(w))
    d = rdist.DataParallel(m)
    o = getattr(ropt, opt_name)(learning_rate=0.05,
                                parameters=m.parameters())
    losses = []
    for i in range(STEPS):
        if accumulate:
            with d.no_sync():
                for j in range(accumulate):
                    d(rpaddle.to_tensor(payload["xa"][i, j])).mean() \
                        .backward()
        loss = d(rpaddle.to_tensor(payload["x"][i])).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, [np.asarray(p._data) for p in m.parameters()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    payload = _payload()
    tmp = tmp_path_factory.mktemp("dp")
    procs = W.start("dp", 4, tmp, payload)
    try:
        ref = {"Adam": _ref_train(payload, "Adam"),
               "Momentum_acc": _ref_train(payload, "Momentum", accumulate=2)}
    finally:
        outs = W.finish(procs, tmp)
    return {"ranks": outs, "ref": ref, "payload": payload}


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert np.abs(np.asarray(g) - w).max() <= tol * np.abs(w).max()


def _mean_losses(outs, key, n):
    return np.mean([outs[r][key]["losses"] for r in range(n)], axis=0)


@pytest.mark.parametrize("n", [2, 4])
def test_dataparallel_matches_the_references_run(runs, n):
    outs = runs["ranks"]
    losses, params = runs["ref"]["Adam"]
    _close(_mean_losses(outs, f"adam{n}", n), np.asarray(losses), 1e-6)
    for r in range(n):
        _close(outs[r][f"adam{n}"]["params"], params, 1e-6)


def test_dataparallel_at_world_one_matches_the_references_run(runs):
    C.init_parallel_env("cpu")
    payload = runs["payload"]
    m = W._mlp(payload["weights"])
    d = D.DataParallel(m)
    assert d._group.nranks == 1
    o = popt.Adam(learning_rate=0.05, parameters=m.parameters())
    losses = []
    for i in range(STEPS):
        loss = d(P.to_tensor(payload["x"][i])).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss))
    ref_losses, ref_params = runs["ref"]["Adam"]
    _close([losses], [np.asarray(ref_losses)], 1e-6)
    _close([p.numpy() for p in m.parameters()], ref_params, 1e-6)


def test_no_sync_accumulation_matches_the_reference(runs):
    outs = runs["ranks"]
    losses, params = runs["ref"]["Momentum_acc"]
    _close(_mean_losses(outs, "nosync2", 2), np.asarray(losses), 1e-6)
    _close(outs[0]["nosync2"]["params"], params, 1e-6)
    # and the sharded update over the same schedule, bit for bit
    for a, b in zip(outs[0]["nosync2"]["params"],
                    outs[0]["nosync_zero2"]["params"]):
        assert np.array_equal(a, b)


def test_overlap_is_bit_equal_to_barrier(runs):
    for r in range(2):
        for a, b in zip(runs["ranks"][r]["adam2"]["params"],
                        runs["ranks"][r]["barrier2"]["params"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_zero1_matches_unsharded_with_its_state_sharded(runs, n):
    outs = runs["ranks"]
    for r in range(n):
        _close(outs[r][f"zero{n}"]["params"], outs[r][f"adam{n}"]["params"],
               1e-6)
        full = outs[r][f"adam{n}"]["state_bytes"]
        sharded = outs[r][f"zero{n}"]["state_bytes"]
        # Adam's two f32 moments of 212 elements, padded to a multiple
        # of n and cut into n shards
        assert full == 2 * 4 * 212
        assert sharded == 2 * 4 * (-(-212 // n))


def test_int8_wire_tracks_f32_and_zero1_is_bit_equal(runs):
    o = runs["ranks"][0]
    _close(o["int8_2"]["params"], o["sgd2"]["params"], 5e-3)
    for a, b in zip(o["int8_2"]["params"], o["int8_zero2"]["params"]):
        assert np.array_equal(a, b)
    _close(o["bf16_2"]["params"], o["sgd2"]["params"], 5e-2)
    assert all(str(p.dtype) == "float32" for p in o["bf16_2"]["params"])


def test_lamb_falls_back_with_one_warning(runs):
    o = runs["ranks"][0]
    assert o["lamb_warnings"] == 1
    assert o["lamb_flat_ok"] is False


def test_reducer_issue_and_drain(runs):
    o = runs["ranks"][0]
    # hooks issued during backward; the sync drained them
    assert o["outstanding_after_backward"] > 0
    assert o["outstanding_after_sync"] == 0
    # barrier mode issues nothing in backward; step's pre-step hook does
    assert o["barrier_outstanding_after_backward"] == 0
    assert o["barrier_step_all_reduces"] > 0
    # an explicit sync, then step: the step reduces nothing again
    assert o["sync_then_step_issued"] == {}


def test_partial_buckets_and_the_steady_plan(runs):
    o = runs["ranks"][0]
    assert o["partial_clean"] and o["partial_then_full_grads"]
    assert o["partial_shard_l1_moved"] and o["partial_shard_l2_kept"]
    assert o["steady_plans"] == 1
    assert "dp_grad_comm_dtype" in o["int4_error"]


def test_the_sync_helpers(runs):
    for r in range(2):
        o = runs["ranks"][r]
        assert o["synced_grad"] == 1.5
        np.testing.assert_array_equal(o["broadcast_w"],
                                      runs["payload"]["weights"][2])


def test_reshard_recuts_the_flat_state(runs):
    outs = runs["ranks"]
    numel = outs[0]["reshard_numel"]
    for name in outs[0]["reshard_before"]:
        old = np.concatenate([outs[r]["reshard_before"][name]
                              for r in range(4)])[:numel]
        new = np.concatenate([outs[r]["reshard_after"][name]
                              for r in range(2)])[:numel]
        np.testing.assert_array_equal(old, new)
    assert all(outs[r]["reshard_after"] == {} for r in (2, 3))


# -- the bucket partition -------------------------------------------------------

def _models(layers, lr_mult):
    import paddle_tpu.nn as rnn

    rpaddle.seed(5)
    rm = rnn.Sequential(*[rnn.Linear(64, 64) for _ in range(layers)])
    pm = pnn.Sequential(*[pnn.Linear(64, 64) for _ in range(layers)])
    if lr_mult:
        for m in (rm, pm):
            m[0].weight.optimize_attr["learning_rate"] = 0.5
    return list(rm.parameters()), list(pm.parameters())


def _index(parts, params):
    pos = {id(p): i for i, p in enumerate(params)}
    return [[pos[id(p)] for p in b] for b in parts]


@pytest.mark.parametrize("comm_mb,last_mb,lr_mult", [
    (25, 1, False), (0.02, 0.001, False), (1, 0.02, False),
    (0.01, 0.005, True), (0.03, 0.02, True)])
def test_the_bucket_plan_is_the_references(comm_mb, last_mb, lr_mult):
    rps, pps = _models(4, lr_mult)
    for nranks in (1, 4):
        rg = type("G", (), {"id": 0, "nranks": nranks})()
        rplan = rpar._build_plan(rps, rg, comm_mb, last_mb, None)
        pplan = D._build_plan(pps, rg, comm_mb, last_mb, None)
        assert _index([b.params for b in pplan.buckets], pps) == \
            _index([b.params for b in rplan.buckets], rps)
        assert [(b.numel, b.padded, b.nbytes, b.lr_mult)
                for b in pplan.buckets] == \
            [(b.numel, b.padded, b.nbytes, b.lr_mult)
             for b in rplan.buckets]
    for mb in (32.0, 0.02, 0.05):
        assert _index(D._bucket_params(pps, mb), pps) == \
            _index(rpar._bucket_params(rps, mb), rps)


def test_a_plan_is_built_once_per_signature():
    _, pps = _models(2, False)
    from collections import OrderedDict
    cache = OrderedDict()
    a = D._build_plan(pps, None, 25, 1, "int8", cache=cache)
    assert D._build_plan(pps, None, 25, 1, "int8", cache=cache) is a
    pflags.set_flags({"dp_comm_block_size": 64})
    try:
        b = D._build_plan(pps, None, 25, 1, "int8", cache=cache)
        assert b is not a and b.buckets[0].qblock == 64
    finally:
        pflags.set_flags({"dp_comm_block_size": 256})
    assert D._build_plan(pps, None, 25, 1, "int8", cache=cache) is a


# -- the int8 codec ---------------------------------------------------------------

def _bucket_pair(shapes, nranks, block=256):
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Parameter as RParam

    rs = np.random.RandomState(7)
    arrs = [rs.randn(*s).astype(np.float32) for s in shapes]
    rps = [RParam(jnp.asarray(a)) for a in arrs]
    pps = [P.core.tensor.Parameter(torch.from_numpy(a)) for a in arrs]
    rflags.set_flags({"dp_comm_block_size": block})
    pflags.set_flags({"dp_comm_block_size": block})
    try:
        return (rpar._Bucket(0, rps, nranks, "int8"),
                D._Bucket(0, pps, nranks, "int8"))
    finally:
        rflags.set_flags({"dp_comm_block_size": 256})
        pflags.set_flags({"dp_comm_block_size": 256})


@pytest.mark.parametrize("shapes,nranks,block", [
    (((7, 3), (5,)), 1, 16), (((64, 64), (64,)), 2, 256),
    (((33, 17), (9,), (300,)), 4, 64)])
def test_int8_bucket_codec_is_the_references(shapes, nranks, block):
    """3 steps of error feedback: wire bytes equal, the residual within
    1e-6, and the decoded mean of every rank's wire within 1e-6."""
    import jax.numpy as jnp

    rb, pb = _bucket_pair(shapes, nranks, block)
    assert (pb.qblock, pb.qblocks, pb.qpadded, pb.nbytes) == \
        (rb.qblock, rb.qblocks, rb.qpadded, rb.nbytes)
    rpack, rdec = rqc.make_pack_q8(rb), rqc.make_decode_q8(rb)
    ppack, pdec = QC.make_pack_q8(pb), QC.make_decode_q8(pb)
    rres, pres = rqc.zeros_residual(rb), QC.zeros_residual(pb)
    rs = np.random.RandomState(11)
    for _ in range(3):
        wires_r, wires_p = [], []
        for _rank in range(nranks):
            grads = [(rs.randn(*s) * 3).astype(np.float32) for s in shapes]
            rw, rres2 = rpack([jnp.asarray(g) for g in grads], rres)
            pw, pres2 = ppack([torch.from_numpy(g) for g in grads], pres)
            np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
            wires_r.append(rw)
            wires_p.append(pw)
        # every rank's residual would differ; carry rank 0's, as rank 0
        rres, pres = rres2, pres2
        np.testing.assert_allclose(pres.numpy(), np.asarray(rres),
                                   atol=1e-6, rtol=0)
        got = pdec(torch.stack(wires_p)).numpy()
        want = np.asarray(rdec(jnp.stack(wires_r)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_encode_and_decode_are_the_references():
    """numpy `encode_flat` is the reference's eager arithmetic; the torch
    codec the buckets use is its jitted executables' (absmax * 1/127, the
    residual by one fused multiply-add): both byte-equal, residuals
    exact; `decode_flat` on torch the reference's."""
    import jax
    import jax.numpy as jnp

    flat = (np.random.RandomState(3).randn(40 * 64) * 5).astype(np.float32)
    flat[:64] = 0.0
    flat[100] = 1e4
    rw, rr = rqc.encode_flat(jnp.asarray(flat), 64)
    w, r = QC.encode_flat(flat, 64)
    np.testing.assert_array_equal(w, np.asarray(rw))
    np.testing.assert_array_equal(r, np.asarray(rr))
    jw, jr = jax.jit(lambda a: rqc.encode_flat(a, 64))(jnp.asarray(flat))
    tw, tr = QC._encode_t(torch.from_numpy(flat), 64)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    dec = QC.decode_flat(tw, 40, 64).numpy()
    np.testing.assert_array_equal(dec, np.asarray(rqc.decode_flat(jw, 40,
                                                                  64)))


@pytest.mark.parametrize("wire", ["int8", "bfloat16"])
def test_p2p_codec_is_the_references(wire):
    import jax.numpy as jnp

    x = (np.random.RandomState(4).randn(6, 50) * 2).astype(np.float32)
    rflags.set_flags({"pp_p2p_comm_dtype": wire})
    pflags.set_flags({"pp_p2p_comm_dtype": wire})
    try:
        rw, rdec, rname = rqc.p2p_encode(jnp.asarray(x))
        pw, pdec, pname = QC.p2p_encode(torch.from_numpy(x))
    finally:
        rflags.set_flags({"pp_p2p_comm_dtype": ""})
        pflags.set_flags({"pp_p2p_comm_dtype": ""})
    assert pname == rname == wire
    got = pdec(pw).numpy()
    want = np.asarray(rdec(rw))
    if wire == "int8":
        np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want.astype(np.float32))


def test_bad_block_size_and_wire_are_rejected():
    pflags.set_flags({"dp_comm_block_size": 0})
    try:
        with pytest.raises(ValueError, match="dp_comm_block_size"):
            QC.block_size()
    finally:
        pflags.set_flags({"dp_comm_block_size": 256})
    assert QC.wire_layout(257, 256) == rqc.wire_layout(257, 256)
    pflags.set_flags({"pp_p2p_comm_dtype": "int4"})
    try:
        with pytest.raises(ValueError, match="pp_p2p_comm_dtype"):
            QC.p2p_comm_dtype()
    finally:
        pflags.set_flags({"pp_p2p_comm_dtype": ""})
