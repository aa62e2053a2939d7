"""DataParallel's reducer, the int8 wire and ZeRO-1 on the card, at world
one over NCCL, held against the plain CPU run of the same step.

A group of one rank reduces nothing (as in the reference), so these tests
drive the reducer's parts themselves: each bucket of the plan packed,
all-reduced over the one-rank NCCL group and unpacked (the gradients come
back bit for bit); on the int8 wire, packed with its error-feedback
residual, gathered and decoded (equal to the CPU's codec on the same
gradients, within 1e-6); the ZeRO-1 flat-shard step and its all_gather
(within 1e-6 of the CPU's Adam step on the same gradients); the mesh
step's bucketed gradient sync (the gradients back bit for bit).

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture). It imports neither jax nor the reference:

    python -m pytest tests/test_torch_dp_cuda.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core import place
from paddle_tpu_torch.distributed import collective as CL
from paddle_tpu_torch.distributed import parallel as D
from paddle_tpu_torch.distributed import quant_comm as QC
from torch_threads import one_torch_thread

one_torch_thread()

pytestmark = pytest.mark.gpu


@pytest.fixture
def group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NCCL group lives on it")
    torch.backends.cuda.matmul.allow_tf32 = False
    P.set_device("gpu:0")
    g = CL.init_parallel_env("cuda")
    yield g
    CL.destroy_process_group()
    place._current[0] = None


def _model(seed=0):
    P.seed(seed)
    m = P.nn.Sequential(P.nn.Linear(64, 96), P.nn.ReLU(),
                        P.nn.Linear(96, 40))
    rs = np.random.RandomState(seed)
    for p in m.parameters():
        p.set_value(rs.randn(*p.shape).astype(np.float32) * 0.2)
    return m


def _backward(m, seed=1):
    x = np.random.RandomState(seed).randn(16, 64).astype(np.float32)
    (m(P.to_tensor(x)) ** 2).mean().backward()


def _grads(m):
    return [p.grad.numpy().copy() for p in m.parameters()]


def _through_buckets(d):
    r = d._reducer
    plan = r._ensure_plan()
    for b in plan.buckets:
        r._issue(b)
    r._wait_outstanding()
    return plan


def test_buckets_round_trip_over_nccl(group):
    m = _model()
    d = D.DataParallel(m, group=group, comm_buffer_size_MB=0.01,
                       last_comm_buffer_size_MB=0.005)
    _backward(m)
    before = _grads(m)
    CL.reset_issued()
    plan = _through_buckets(d)
    assert len(plan.buckets) >= 2
    assert CL.issued() == {"all_reduce/world": len(plan.buckets)}
    for a, b in zip(_grads(m), before):
        np.testing.assert_array_equal(a, b)


def test_int8_wire_is_the_cpu_codec(group):
    flags.set_flags({"dp_grad_comm_dtype": "int8"})
    try:
        m = _model()
        d = D.DataParallel(m, group=group)
        residuals = {}
        for step in range(3):
            for p in m.parameters():
                p.clear_grad()
            _backward(m, seed=step + 1)
            grads = {id(p): p.grad.numpy().copy() for p in m.parameters()}
            plan = _through_buckets(d)
            for b in plan.buckets:
                res = residuals.get(b.index)
                if res is None:
                    res = torch.zeros(b.qpadded)
                wire, residuals[b.index] = QC.make_pack_q8(b)(
                    [torch.from_numpy(grads[id(p)]) for p in b.params], res)
                want = QC.make_decode_q8(b)(wire[None])
                got = torch.cat([p._data.grad.detach().cpu().reshape(-1)
                                 for p in b.params])
                np.testing.assert_allclose(got.numpy(),
                                           want[:b.numel].numpy(),
                                           atol=1e-6, rtol=0)
                np.testing.assert_allclose(b.residual.cpu().numpy(),
                                           residuals[b.index].numpy(),
                                           atol=1e-6, rtol=0)
    finally:
        flags.set_flags({"dp_grad_comm_dtype": ""})


def test_zero1_flat_step_is_the_cpu_step(group):
    m = _model()
    d = D.DataParallel(m, group=group)
    o = P.optimizer.Adam(learning_rate=0.05, parameters=m.parameters())
    so = D.sharded_update(o, d)
    _backward(m)
    grads = _grads(m)
    start = [p.numpy().copy() for p in m.parameters()]
    so._sharded_step()
    got = [p.numpy() for p in m.parameters()]
    assert set(o._accumulators) == {f"_dp_flat_b{b.index}"
                                    for b in d._reducer._plan.buckets}
    place.set_device("cpu")
    try:
        ps = [P.create_parameter(list(w.shape), "float32") for w in start]
        for p, w, g in zip(ps, start, grads):
            p.set_value(w)
            p._data.grad = torch.from_numpy(g)
        P.optimizer.Adam(learning_rate=0.05, parameters=ps).step()
        want = [p.numpy() for p in ps]
    finally:
        place.set_device("gpu:0")
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def test_bucketed_sync_grads_over_nccl(group):
    from paddle_tpu_torch.distributed import hybrid as H
    from paddle_tpu_torch.models import llama as L

    cfg = L.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        max_seq_len=16, dtype=torch.float32)
    mesh = H.build_mesh(device="cuda")
    gen = torch.Generator().manual_seed(3)
    specs = H.param_specs(cfg)
    params = H.shard_params(L.init_params(cfg, torch.Generator(
        device="cuda").manual_seed(0), device="cuda"), mesh, cfg)
    leaves, rebuild = H._flatten(params)
    grads = [torch.randn(x.shape, generator=gen).cuda() for x in leaves]
    before = [g.clone() for g in grads]
    CL.reset_issued()
    H.sync_grads(rebuild(grads), specs, mesh)
    assert sum(v for k, v in CL.issued().items()
               if k.startswith("all_reduce")) > 0
    for a, b in zip(grads, before):
        assert torch.equal(a, b)
