"""The port's collective layer (`paddle_tpu_torch.distributed`) against
the reference's, four gloo ranks on the CPU, spawned once for the module.

- Every eager collective of `distributed/collective.py` (and the stream
  variants, a subgroup from `new_group`, P2P in a ring, port Tensors):
  rank r passes row r of a rank-major array, and its result is held
  against the reference's single-controller result on that array
  (`simulate_rank_major`: dim 0 the stacked ranks), exactly (f32 sums of
  small integers; PROD, which the reference takes through exp and log,
  within 1e-5), or, where the reference's single controller has no
  peers to run (scatter, P2P, objects), against what each rank must get.
- The op names that need a peer, at world 4: against the same
  expectations, `global_scatter` / `global_gather` against a numpy
  exchange by counts, `c_softmax_with_cross_entropy` over four
  vocabulary blocks against the reference's op on the whole vocabulary.
- The 47 op names at world 1 are in `tests/test_torch_op_parity.py`
  (`test_collective_op_at_world_1`); the four point-to-point names have
  no world-1 result (no peer) and are held here at world 4.
- `spawn` and `launch` at world 2: the env they set, and a failing
  worker's traceback raised (spawn) or its exit code returned with its
  log (launch).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_dist_workers as W
import paddle_tpu as ref
import paddle_tpu.distributed as rdist
from paddle_tpu.distributed.collective import simulate_rank_major
from paddle_tpu_torch.distributed import spawn
from torch_threads import one_torch_thread

one_torch_thread()

N = 4
RS = np.random.RandomState(0)
A = (np.arange(N * 6).reshape(N, 2, 3) % 7 + 1).astype(np.float32)
B = (np.arange(N * N * 6).reshape(N, N * 2, 3) % 5 + 1).astype(np.float32)
# global_scatter: rank r sends COUNTS[r][w * 2 + e] rows to expert e of
# rank w, and receives GCOUNTS[r][w * 2 + e] from rank w for its expert e
COUNTS = RS.randint(0, 3, size=(N, N * 2))
GCOUNTS = np.stack([[COUNTS[w][r * 2 + e] for w in range(N) for e in (0, 1)]
                    for r in range(N)])
ROWS = [np.arange(COUNTS[r].sum() * 3, dtype=np.float32).reshape(-1, 3)
        + 100 * r for r in range(N)]
LOGITS = RS.randn(3, 4 * N).astype(np.float32)
LABELS = np.array([5, -100, 13], np.int64)
REDUCE_OPS = ("sum", "max", "min", "prod", "avg")
EAGER = [f"all_reduce_{op}" for op in REDUCE_OPS] + [
    "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_avg", "alltoall", "alltoall_single", "broadcast",
    "reduce"]


def _reference():
    """The reference's single-controller results: entry [r] is rank r's."""
    g = rdist.new_group(list(range(N)))
    out = {}
    with simulate_rank_major():
        for op in REDUCE_OPS:
            t = ref.to_tensor(A.reshape(N * 2, 3))
            rdist.all_reduce(t, op=op, group=g)
            out[f"all_reduce_{op}"] = t.numpy().reshape(N, 2, 3)
        lst = []
        rdist.all_gather(lst, ref.to_tensor(A.reshape(N * 2, 3)), group=g)
        full = np.stack([t.numpy() for t in lst])
        out["all_gather"] = np.stack([full] * N)
        out["all_gather_into_tensor"] = np.stack(
            [full.reshape(N * 2, 3)] * N)
        t = ref.to_tensor(np.zeros((N * 2, 3), np.float32))
        rdist.reduce_scatter(t, ref.to_tensor(B.reshape(N * N * 2, 3)),
                             group=g)
        out["reduce_scatter"] = t.numpy().reshape(N, 2, 3)
        t = ref.to_tensor(np.zeros((N * 2, 3), np.float32))
        rdist.reduce_scatter(t, ref.to_tensor(B.reshape(N * N * 2, 3)),
                             op="avg", group=g)
        out["reduce_scatter_avg"] = t.numpy().reshape(N, 2, 3)
        lst = []
        rdist.alltoall(lst, ref.to_tensor(B.reshape(N * N * 2, 3)), group=g)
        a2a = np.concatenate([t.numpy() for t in lst]).reshape(N, N * 2, 3)
        out["alltoall"] = out["alltoall_single"] = a2a
        t = ref.to_tensor(A.reshape(N * 2, 3))
        rdist.broadcast(t, src=2, group=g)
        out["broadcast"] = t.numpy().reshape(N, 2, 3)
        t = ref.to_tensor(A.reshape(N * 2, 3))
        rdist.reduce(t, dst=1, group=g)
        out["reduce"] = t.numpy().reshape(N, 2, 3)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collective")
    payload = {"A": A, "B": B, "counts": COUNTS, "gcounts": GCOUNTS,
               "rows": ROWS, "logits": LOGITS, "labels": LABELS}
    procs = W.start("collective", N, tmp, payload)
    try:
        want = _reference()
    finally:
        outs = W.finish(procs, tmp)
    return outs, want


@pytest.mark.parametrize("name", EAGER)
def test_eager_collective_against_the_reference(runs, name):
    outs, want = runs
    for r in range(N):
        if name == "reduce" and r != 1:
            continue               # the result lands on dst only
        tol = 1e-5 if name == "all_reduce_prod" else 0
        np.testing.assert_allclose(outs[r][name], want[name][r], rtol=tol,
                                   atol=0, err_msg=f"rank {r}")


def test_scatter_p2p_objects_and_subgroups(runs):
    outs, _ = runs
    for r in range(N):
        o = outs[r]
        np.testing.assert_array_equal(o["scatter"], A[r] * 10)
        np.testing.assert_array_equal(o["ring"], A[(r - 1) % N])
        np.testing.assert_array_equal(o["send_recv"], A[(r - 1) % N])
        assert o["all_gather_object"] == [{"rank": q} for q in range(N)]
        assert o["broadcast_object_list"] == ["from1", 1]
        np.testing.assert_array_equal(o["stream_broadcast"], A[0])
        np.testing.assert_array_equal(o["port_tensor_all_reduce"],
                                      A.sum(0))
        assert o["backend"] == "gloo" and o["global_rank_of_1_in_sub"] == 2
        if r % 2 == 0:
            pair = A[0] + A[2]
            np.testing.assert_array_equal(o["subgroup_all_reduce"], pair)
            np.testing.assert_array_equal(o["stream_all_reduce"], pair)
            np.testing.assert_array_equal(o["stream_all_gather"],
                                          np.stack([A[0], A[2]]))
        else:
            assert "subgroup_all_reduce" not in o


OPS_AT_4 = {
    "all_reduce": lambda r: A.sum(0),
    "c_allreduce_sum": lambda r: A.sum(0),
    "c_allreduce_max": lambda r: A.max(0),
    "c_allreduce_min": lambda r: A.min(0),
    "c_allreduce_prod": lambda r: A.prod(0),
    "mp_allreduce_sum": lambda r: A.sum(0),
    "all_gather": lambda r: A.reshape(N * 2, 3),
    "c_allgather": lambda r: A.reshape(N * 2, 3),
    "c_concat": lambda r: np.concatenate(list(A), axis=-1),
    "dist_concat": lambda r: np.concatenate(list(A), axis=-1),
    "broadcast": lambda r: A[0],
    "c_broadcast": lambda r: A[0],
    "reduce": lambda r: A.sum(0) if r == 0 else A[r],
    "c_reduce_sum": lambda r: A.sum(0) if r == 0 else A[r],
    "all_to_all": lambda r: np.concatenate([B[q][r * 2:(r + 1) * 2]
                                            for q in range(N)]),
    "c_scatter": lambda r: B[0][r * 2:(r + 1) * 2],
    "reduce_scatter": lambda r: B.sum(0)[r * 2:(r + 1) * 2],
    "partial_allgather": lambda r: np.concatenate(
        [B[q][q * 2:(q + 1) * 2] for q in range(N)]),
    "p_send_recv": lambda r: A[(r - 1) % N],
    "p_send_recv_array": lambda r: A[(r - 1) % N],
    "barrier": lambda r: A[r],
}


def _exchange(r):
    """Rank r's rows after global_scatter: from each rank w, the rows w
    sent to r's two experts, in rank order."""
    got = []
    for w in range(N):
        off = COUNTS[w][:r * 2].sum()
        got.append(ROWS[w][off:off + COUNTS[w][r * 2:r * 2 + 2].sum()])
    return np.concatenate(got)


@pytest.mark.parametrize("name", sorted(OPS_AT_4) + [
    "global_scatter", "global_gather", "fetch_barrier", "comm_init_all",
    "c_softmax_with_cross_entropy"])
def test_op_names_at_world_4(runs, name):
    outs, _ = runs
    for r in range(N):
        o = outs[r]
        if name == "global_scatter":
            np.testing.assert_array_equal(o["op_global_scatter"],
                                          _exchange(r))
        elif name == "global_gather":
            np.testing.assert_array_equal(o["op_global_gather"], ROWS[r])
        elif name == "fetch_barrier":
            np.testing.assert_array_equal(o["op_fetch_barrier"][0], A[r])
        elif name == "comm_init_all":
            assert o["op_comm_init_all"] == 0
        elif name == "c_softmax_with_cross_entropy":
            continue
        else:
            tol = 1e-5 if name == "c_allreduce_prod" else 0
            np.testing.assert_allclose(o[f"op_{name}"], OPS_AT_4[name](r),
                                       rtol=tol, atol=0, err_msg=f"rank {r}")
    if name == "c_softmax_with_cross_entropy":
        lg = ref.to_tensor(LOGITS)
        lg.stop_gradient = False
        sm, loss = ref._C_ops.c_softmax_with_cross_entropy(
            lg, ref.to_tensor(LABELS))
        loss.sum().backward()
        for r in range(N):
            psm, ploss, pgrad = outs[r]["op_c_softmax"]
            block = slice(r * 4, (r + 1) * 4)
            np.testing.assert_allclose(ploss, loss.numpy(), rtol=1e-5)
            np.testing.assert_allclose(psm, sm.numpy()[:, block], rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(pgrad, lg.grad.numpy()[:, block],
                                       rtol=1e-5, atol=1e-7)


# -- spawn and launch ---------------------------------------------------------

def test_spawn_sets_the_env_and_raises_a_workers_traceback(tmp_path):
    with pytest.raises(Exception, match="rank one fails on purpose"):
        spawn(W.env_worker, (str(tmp_path / "env"),), nprocs=2)
    for r in range(2):
        assert (tmp_path / f"env.{r}").read_text() == \
            f"{r},2,{r},2,{r},127.0.0.1,3"


def test_launch_runs_one_worker_a_rank_and_returns_a_failure(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        if len(sys.argv) > 1 and os.environ["RANK"] == "1":
            sys.exit(3)     # before any rendezvous: rank 0 waits, is stopped
        import torch
        sys.path.insert(0, {os.getcwd()!r})
        from paddle_tpu_torch.distributed import collective as C
        g = C.init_parallel_env("cpu")
        t = torch.ones(1)
        C.all_reduce(t)
        print("rank", os.environ["PADDLE_TRAINER_ID"], "of",
              os.environ["WORLD_SIZE"], "sum", int(t),
              os.environ["LOCAL_RANK"], os.environ["MASTER_PORT"])
    """))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--log_dir", str(tmp_path / "log")]
    ok = subprocess.run(cmd + [str(script)], capture_output=True, text=True,
                        timeout=120, cwd=os.getcwd())
    assert ok.returncode == 0, ok.stderr
    for r in range(2):
        log = (tmp_path / "log" / f"workerlog.{r}").read_text()
        assert f"rank {r} of 2 sum 2 {r}" in log
    bad = subprocess.run(cmd + ["--log_dir", str(tmp_path / "log2"),
                                str(script), "fail"],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.getcwd())
    assert bad.returncode == 3
    with pytest.raises(NotImplementedError, match="7c"):
        from paddle_tpu_torch.distributed.launch import launch
        launch(["--max_restart", "1", str(script)])
