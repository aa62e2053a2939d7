"""Multi-rank runs of the port's distributed modules on the CPU, for the
port's tests: one spawned process a rank, a gloo group formed over a
FileStore under the test's temporary directory (no TCP port to race for
between pytest workers).

`start(name, world, tmp, payload, timeout)` spawns `world` processes
running the worker `name` of this module as `worker(rank, world,
payload, out)` (a rank that finishes waits for the others, then exits
without the interpreter's teardown), and returns at once, so the test's own process can
compute the reference's side meanwhile; `finish(procs, tmp, timeout)`
joins them, kills them all past `timeout` seconds (a hang fails the
test, it does not hold the run; a rank still running 10 s before leaves
its stack in `hang.<rank>`), raises a failing rank's traceback, and
returns each rank's `out` dict. This module imports no jax: the workers
run the port only.
"""
import faulthandler
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 120


def start(name, world, tmp, payload, timeout=JOIN_TIMEOUT_S):
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    # through a file, not the processes' arguments: a start writes its
    # arguments into a pipe the child reads while it imports torch, so
    # a large payload would start the ranks one after another
    (tmp / "payload").write_bytes(pickle.dumps(payload))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(name, r, world, str(tmp),
                                              timeout), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def finish(procs, tmp, timeout=JOIN_TIMEOUT_S):
    tmp = Path(tmp)
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    for p in alive:
        p.join(5)
    errs = sorted(tmp.glob("error.*")) + sorted(
        f for f in tmp.glob("hang.*") if f.stat().st_size)
    if errs:
        raise RuntimeError(f"{errs[0].name}:\n{errs[0].read_text()}")
    if alive:
        raise TimeoutError(f"{len(alive)} ranks still running after "
                           f"{timeout} s: killed")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return [pickle.loads((tmp / f"out.{r}").read_bytes())
            for r in range(len(procs))]


def _entry(name, rank, world, tmp, timeout):
    # a rank still running near the parent's deadline writes its stack
    hang = open(Path(tmp) / f"hang.{rank}", "w")
    faulthandler.dump_traceback_later(max(1, timeout - 10), exit=True,
                                      file=hang)
    os.environ.update({"PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_TRAINERS_NUM": str(world)})
    torch.set_num_threads(1)
    try:
        from paddle_tpu_torch.distributed import collective as C
        C.init_parallel_env("cpu", init_method=f"file://{tmp}/store")
        out = {}
        payload = pickle.loads((Path(tmp) / "payload").read_bytes())
        globals()[name](rank, world, payload, out)
        (Path(tmp) / f"out.{rank}").write_bytes(pickle.dumps(out))
        # every rank done before any tears its groups down, and no
        # interpreter teardown after: under a loaded host a gloo group's
        # destructors racing a peer's exit have aborted a finished rank
        C.barrier()
        C.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"error.{rank}").write_text(traceback.format_exc())
        raise
    faulthandler.cancel_dump_traceback_later()
    hang.close()
    os._exit(0)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the hybrid step (tests/test_torch_hybrid.py)
# ---------------------------------------------------------------------------

def hybrid(rank, world, payload, out):
    """Every case of `payload["cases"]`, in order, on every rank: a case
    is (key, kind, cfg kwargs, layout (dp, pp, tp, cp), microbatches,
    params key, batch key, extra). Rank 0 of the mesh writes the
    results."""
    from paddle_tpu_torch.distributed import hybrid as H
    from paddle_tpu_torch.models import llama as L

    for key, kind, cfg_kw, (dp, pp, tp, cp), mb, pkey, bkey, extra in \
            payload["cases"]:
        cfg = L.LlamaConfig(**cfg_kw, dtype=torch.float32)
        mesh = H.build_mesh(dp=dp, pp=pp, tp=tp, cp=cp, device="cpu")
        if not mesh.is_member:
            continue
        full = L.params_from_numpy(payload["params"][pkey], device="cpu")
        tokens, targets = (torch.from_numpy(a) for a in payload["data"][bkey])
        sp = H.shard_params(full, mesh, cfg)
        res = {}
        if kind == "sync":
            res["max_rel"] = _sync_vs_per_leaf(H, sp, cfg, mesh)
        elif kind == "eval":
            res["loss"] = float(H.make_eval_step(cfg, mesh, mb)(
                sp, tokens, targets))
        elif kind == "grads":
            loss, grads = H.loss_and_grads(sp, tokens, targets, cfg, mb,
                                           mesh=mesh)
            res["loss"] = float(loss)
            res["grads"] = _np(H.unstack_pipeline(
                H.unshard_params(grads, mesh, cfg)))
        else:                                   # "train": `steps` steps
            opt = H.init_opt_state(sp)
            step = H.make_train_step(cfg, mesh, mb, H.AdamWConfig(**extra))
            losses = []
            for _ in range(payload.get("steps", {}).get(key, 1)):
                sp, opt, loss = step(sp, opt, tokens, targets)
                losses.append(float(loss))
            res["losses"] = losses
            res["dropped"] = (None if step.last_dropped is None
                              else int(step.last_dropped))
            res["params"] = _np(H.unstack_pipeline(
                H.unshard_params(sp, mesh, cfg)))
        if rank == 0:
            out[key] = res


def _sync_vs_per_leaf(H, sp, cfg, mesh):
    """Seeded per-rank gradients shaped as this rank's shards, summed by
    the bucketed `sync_grads` and by one all_reduce a leaf an axis; the
    largest difference over each leaf's largest entry."""
    from paddle_tpu_torch.distributed import collective as C

    gen = torch.Generator().manual_seed(1000 + C.get_rank())
    leaves, rebuild = H._flatten(sp)
    grads = [torch.randn(x.shape, generator=gen) for x in leaves]
    per_leaf = [g.clone() for g in grads]
    for g, s in zip(per_leaf, H._flatten(H.param_specs(cfg))[0]):
        for a in H._sync_axes(s):
            C.all_reduce(g, group=mesh.axis(a))
    H.sync_grads(rebuild(grads), H.param_specs(cfg), mesh)
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(grads, per_leaf))


# ---------------------------------------------------------------------------
# the collective layer (tests/test_torch_collective.py)
# ---------------------------------------------------------------------------

def collective(rank, world, payload, out):
    """Every eager collective, the stream variants, a subgroup, P2P in a
    ring and the op names that need a peer, on rank r's row of the
    rank-major inputs."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.communication import stream
    from paddle_tpu_torch import _C_ops
    from paddle_tpu_torch.core import place
    import paddle_tpu_torch as P

    place.set_device("cpu")
    A = torch.from_numpy(payload["A"])          # [world, 2, 3]
    x = A[rank].clone()
    for op in ("sum", "max", "min", "prod", "avg"):
        t = x.clone()
        C.all_reduce(t, op=op)
        out[f"all_reduce_{op}"] = t.numpy()
    lst = []
    C.all_gather(lst, x)
    out["all_gather"] = np.stack([t.numpy() for t in lst])
    t = torch.empty((world * 2, 3))
    C.all_gather_into_tensor(t, x)
    out["all_gather_into_tensor"] = t.numpy()
    big = torch.from_numpy(payload["B"][rank])    # [world * 2, 3]
    t = torch.empty((2, 3))
    C.reduce_scatter(t, big)
    out["reduce_scatter"] = t.numpy()
    t = torch.empty((2, 3))
    C.reduce_scatter(t, list(torch.chunk(big, world)), op="avg")
    out["reduce_scatter_avg"] = t.numpy()
    outs = []
    C.alltoall(outs, list(torch.chunk(big, world)))
    out["alltoall"] = torch.cat(outs).numpy()
    out["alltoall_single"] = C.alltoall_single(None, big).numpy()
    t = x.clone()
    C.broadcast(t, src=2)
    out["broadcast"] = t.numpy()
    t = x.clone()
    C.reduce(t, dst=1)
    out["reduce"] = t.numpy() if rank == 1 else None
    t = torch.empty((2, 3))
    C.scatter(t, [A[r].clone() * 10 for r in range(world)], src=3)
    out["scatter"] = t.numpy()
    C.barrier()
    objs = []
    C.all_gather_object(objs, {"rank": rank})
    out["all_gather_object"] = objs
    lst2 = [f"from{rank}", rank]
    C.broadcast_object_list(lst2, src=1)
    out["broadcast_object_list"] = lst2
    # P2P in a ring: send to r + 1, receive from r - 1
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    got = torch.empty((2, 3))
    for task in C.batch_isend_irecv([C.P2POp(C.isend, x, nxt),
                                     C.P2POp(C.irecv, got, prv)]):
        task.wait()
    out["ring"] = got.numpy()
    got2 = torch.empty((2, 3))
    if rank % 2 == 0:
        C.send(x, dst=nxt)
        C.recv(got2, src=prv)
    else:
        C.recv(got2, src=prv)
        C.send(x, dst=nxt)
    out["send_recv"] = got2.numpy()
    # a subgroup of the even ranks, and the stream variants over it
    sub = C.new_group([0, 2])
    if sub.rank >= 0:
        t = x.clone()
        C.all_reduce(t, group=sub)
        out["subgroup_all_reduce"] = t.numpy()
        t = x.clone()
        assert stream.all_reduce(t, group=sub, use_calc_stream=True) is None
        out["stream_all_reduce"] = t.numpy()
        lst3 = []
        stream.all_gather(lst3, x, group=sub, sync_op=True)
        out["stream_all_gather"] = np.stack([v.numpy() for v in lst3])
    t = x.clone()
    task = stream.broadcast(t, src=0, sync_op=False)
    task.wait()
    out["stream_broadcast"] = t.numpy()
    out["backend"] = C.get_backend()
    out["global_rank_of_1_in_sub"] = C.get_global_rank(sub, 1)
    # port Tensors through the same calls
    pt = P.to_tensor(x.numpy())
    C.all_reduce(pt)
    out["port_tensor_all_reduce"] = pt.numpy()
    # the op names that need a peer
    X = P.to_tensor(x.numpy())
    for name in ("all_reduce", "c_allreduce_sum", "c_allreduce_max",
                 "c_allreduce_min", "c_allreduce_prod", "mp_allreduce_sum",
                 "all_gather", "c_allgather", "c_concat", "broadcast",
                 "c_broadcast", "reduce", "c_reduce_sum", "dist_concat"):
        out[f"op_{name}"] = getattr(_C_ops, name)(X).numpy()
    for name in ("reduce_scatter", "all_to_all", "c_scatter"):
        out[f"op_{name}"] = getattr(_C_ops, name)(
            P.to_tensor(big.numpy())).numpy()
    out["op_partial_allgather"] = _C_ops.partial_allgather(
        P.to_tensor(big.numpy()), nranks=world, rank=rank).numpy()
    counts = payload["counts"]                  # [world, world * 2]
    rows = payload["rows"][rank]
    sc = _C_ops.global_scatter(P.to_tensor(rows), counts[rank],
                               payload["gcounts"][rank])
    out["op_global_scatter"] = sc.numpy()
    out["op_global_gather"] = _C_ops.global_gather(
        sc, counts[rank], payload["gcounts"][rank]).numpy()
    _C_ops.p_send(X, peer=nxt) if rank % 2 == 0 else None
    r = _C_ops.p_recv(peer=prv, dtype="float32", out_shape=[2, 3])
    if rank % 2 == 1:
        _C_ops.p_send(X, peer=nxt)
    out["op_p_send_recv"] = r.numpy()
    if rank % 2 == 0:
        _C_ops.p_send_array(X, peer=nxt)
    r = _C_ops.p_recv_array(peer=prv, dtype="float32", out_shape=[2, 3])
    if rank % 2 == 1:
        _C_ops.p_send_array(X, peer=nxt)
    out["op_p_send_recv_array"] = r.numpy()
    out["op_barrier"] = _C_ops.barrier(X).numpy()
    out["op_fetch_barrier"] = [v.numpy() for v in _C_ops.fetch_barrier([X])]
    out["op_comm_init_all"] = int(_C_ops.comm_init_all())
    logits = P.to_tensor(payload["logits"][..., rank * 4:(rank + 1) * 4])
    logits.stop_gradient = False
    sm, loss = _C_ops.c_softmax_with_cross_entropy(
        logits, P.to_tensor(payload["labels"]), rank=rank, nranks=world)
    P.sum(loss).backward()
    out["op_c_softmax"] = (sm.numpy(), loss.numpy(), logits.grad.numpy())


# ---------------------------------------------------------------------------
# spawn's workers (tests/test_torch_collective.py)
# ---------------------------------------------------------------------------

def env_worker(path):
    """The env `distributed.spawn` set and a sum over the group, written
    to `path.<rank>`; then rank 1 raises."""
    from paddle_tpu_torch.distributed import collective as C
    g = C.init_parallel_env("cpu")
    t = torch.ones(1) * (g.rank + 1)
    C.all_reduce(t)
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "RANK",
            "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")
    with open(f"{path}.{g.rank}", "w") as f:
        f.write(",".join(os.environ[k] for k in keys) + f",{int(t)}")
    C.destroy_process_group()
    if g.rank == 1:
        raise ValueError("rank one fails on purpose")


# ---------------------------------------------------------------------------
# ring and Ulysses attention (tests/test_torch_ring_attention.py)
# ---------------------------------------------------------------------------

def ring(rank, world, payload, out):
    """Every case of `payload["cases"]`: (key, impl, n, causal, qkv key);
    the first n ranks form the group. The shard forms take each rank's
    sequence block and differentiate sum(out * w) over its block; the
    eager form takes the whole tensors on every rank."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.ops import ring_attention as RA

    groups = {n: C.new_group(list(range(n))) for n in (1, 2, 4)}
    for key, impl, n, causal, qkv in payload["cases"]:
        g = groups[n]
        if g.rank < 0:
            continue
        q, k, v, w = (torch.from_numpy(a) for a in payload["qkv"][qkv])
        if impl.startswith("eager"):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = RA.ring_attention(*leaves, group=g, causal=causal,
                                  impl="sep" if impl == "eager_sep"
                                  else "ring")
        else:
            T = q.shape[1] // n
            blk = slice(g.rank * T, (g.rank + 1) * T)
            leaves = [t[:, blk].clone().requires_grad_() for t in (q, k, v)]
            fn = (RA.ring_attention_shard if impl == "ring"
                  else RA.sep_attention_shard)
            o = fn(*leaves, g, causal=causal)
            w = w[:, blk]
        (o * w).sum().backward()
        out[key] = (o.detach().numpy(),
                    [t.grad.numpy() for t in leaves])


# ---------------------------------------------------------------------------
# DataParallel, ZeRO-1 and the int8 wire (tests/test_torch_dp.py)
# ---------------------------------------------------------------------------

def _mlp(weights):
    """The reference test's MLP (Linear 8-16, relu, Linear 16-4) with the
    payload's weights."""
    from paddle_tpu_torch import nn
    import paddle_tpu_torch.nn.functional as F

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(8, 16)
            self.l2 = nn.Linear(16, 4)

        def forward(self, x):
            return self.l2(F.relu(self.l1(x)))

    m = MLP()
    for p, w in zip(m.parameters(), weights):
        p.set_value(torch.from_numpy(w))
    return m


def dp(rank, world, payload, out):
    """DataParallel over groups of 2 and 4 gloo ranks, rank r training on
    its block of rows of every global batch; each run's losses, updated
    parameters and reducer facts, by case key."""
    import warnings

    import paddle_tpu_torch as P
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.core import flags, place
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import parallel as D

    place.set_device("cpu")
    groups = {n: C.new_group(list(range(n))) for n in (2, 4)}
    X, XA, W = payload["x"], payload["xa"], payload["weights"]

    def rows(n, a):
        k = a.shape[0] // n
        return P.to_tensor(a[rank * k:(rank + 1) * k])

    def run(n, opt="Adam", shard=False, overlap=True, wire="",
            accumulate=0, steps=3, find_unused=False, keep=False):
        flags.set_flags({"dp_overlap": overlap, "dp_shard_update": shard,
                         "dp_grad_comm_dtype": wire})
        try:
            m = _mlp(W)
            d = D.DataParallel(m, group=groups[n],
                               find_unused_parameters=find_unused)
            o = getattr(O, opt)(learning_rate=0.05,
                                parameters=m.parameters())
            so = D.sharded_update(o, d) if shard else o
            losses = []
            for i in range(steps):
                if accumulate:
                    with d.no_sync():
                        for j in range(accumulate):
                            d(rows(n, XA[i, j])).mean().backward()
                loss = d(rows(n, X[i])).mean()
                loss.backward()
                so.step()
                so.clear_grad()
                losses.append(float(loss))
        finally:
            flags.set_flags({"dp_overlap": True, "dp_shard_update": False,
                             "dp_grad_comm_dtype": ""})
        res = {"losses": losses,
               "params": [p.numpy() for p in m.parameters()],
               "state_bytes": (so.optimizer_state_bytes_per_device()
                               if shard else sum(
                                   a.numel() * a.element_size()
                                   for s in o._accumulators.values()
                                   for a in s.values()))}
        if keep:
            res["so"], res["d"] = so, d
        return res

    for n in (2, 4):
        if rank >= n:
            continue
        out[f"adam{n}"] = run(n)
        out[f"zero{n}"] = run(n, shard=True)
    if rank < 2:
        out["barrier2"] = run(2, overlap=False)
        out["nosync2"] = run(2, opt="Momentum", accumulate=2)
        out["nosync_zero2"] = run(2, opt="Momentum", shard=True,
                                  accumulate=2)
        out["sgd2"] = run(2, opt="SGD")
        out["int8_2"] = run(2, opt="SGD", wire="int8")
        out["int8_zero2"] = run(2, opt="SGD", shard=True, wire="int8")
        out["bf16_2"] = run(2, opt="SGD", wire="bf16")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r = run(2, opt="Lamb", shard=True, keep=True)
        out["lamb_warnings"] = sum("flat-shard" in str(w.message)
                                   for w in caught)
        out["lamb_flat_ok"] = r["so"]._flat_ok
        out.update(_reducer_facts(rank, groups[2], W, rows, D, O, flags, C))
    # reshard: ZeRO-1 over 4 ranks, then its state re-cut for ranks 0-1
    r = run(4, shard=True, steps=2, keep=True)
    so = r["so"]
    before = {k: v.clone() for k, v in
              so._opt._accumulators["_dp_flat_b0"].items()}
    plan = so._reducer._ensure_plan()
    out["reshard_numel"] = plan.buckets[0].numel
    so.reshard(groups[2])
    after = so._opt._accumulators.get("_dp_flat_b0", {})
    out["reshard_before"] = {k: v.numpy() for k, v in before.items()}
    out["reshard_after"] = {k: v.numpy() for k, v in after.items()}


def _reducer_facts(rank, g, W, rows, D, O, flags, C):
    """The reducer's behaviour at 2 ranks: hooks issue during backward,
    barrier mode at the sync, one reduction for sync-then-step, partial
    buckets, a steady plan, the wire dtype's check, and the two sync
    helpers."""
    x = np.ones((8, 8), np.float32)
    facts = {}
    d = D.DataParallel(_mlp(W), group=g)
    d(rows(2, x)).mean().backward()
    facts["outstanding_after_backward"] = len(d._reducer._outstanding)
    d.sync_gradients()
    facts["outstanding_after_sync"] = len(d._reducer._outstanding)
    flags.set_flags({"dp_overlap": False})
    try:
        m = _mlp(W)
        d = D.DataParallel(m, group=g)
        o = O.SGD(learning_rate=0.1, parameters=m.parameters())
        d(rows(2, x)).mean().backward()
        facts["barrier_outstanding_after_backward"] = len(
            d._reducer._outstanding)
        C.reset_issued()
        o.step()
        facts["barrier_step_all_reduces"] = sum(
            v for k, v in C.issued().items() if k.startswith("all_reduce"))
    finally:
        flags.set_flags({"dp_overlap": True})
    m = _mlp(W)
    d = D.DataParallel(m, group=g)
    o = O.SGD(learning_rate=0.1, parameters=m.parameters())
    d(rows(2, x)).mean().backward()
    d.sync_gradients()
    C.reset_issued()
    o.step()
    facts["sync_then_step_issued"] = C.issued()
    # partially-used buckets (only l1 runs backward)
    import paddle_tpu_torch.nn.functional as F
    m = _mlp(W)
    d = D.DataParallel(m, group=g, find_unused_parameters=True)
    F.relu(m.l1(rows(2, x))).mean().backward()
    d.sync_gradients()
    plan = d._reducer._ensure_plan()
    facts["partial_clean"] = all(not b.ready and not b.issued
                                 for b in plan.buckets)
    d(rows(2, x)).mean().backward()
    d.sync_gradients()
    facts["partial_then_full_grads"] = all(
        p.grad is not None for p in m.parameters())
    flags.set_flags({"dp_shard_update": True})
    try:
        m = _mlp(W)
        d = D.DataParallel(m, group=g, find_unused_parameters=True)
        so = D.sharded_update(O.SGD(learning_rate=0.1,
                                    parameters=m.parameters()), d)
        before = [p.numpy().copy() for p in m.parameters()]
        F.relu(m.l1(rows(2, x))).mean().backward()
        so.step()
        after = [p.numpy() for p in m.parameters()]
        facts["partial_shard_l1_moved"] = any(
            not np.array_equal(a, b) for a, b in zip(before[:2], after[:2]))
        facts["partial_shard_l2_kept"] = all(
            np.array_equal(a, b) for a, b in zip(before[2:], after[2:]))
        # the steady state: one plan, one flat parameter a bucket
        m = _mlp(W)
        d = D.DataParallel(m, group=g)
        so = D.sharded_update(O.Adam(learning_rate=0.05,
                                     parameters=m.parameters()), d)
        seen = []
        for i in range(5):
            d(rows(2, x * (i + 1))).mean().backward()
            so.step()
            so.clear_grad()
            plan = d._reducer._plan
            seen.append((id(plan), tuple(id(b.pseudo)
                                         for b in plan.buckets)))
        facts["steady_plans"] = len(set(seen[1:]))
    finally:
        flags.set_flags({"dp_shard_update": False})
    flags.set_flags({"dp_grad_comm_dtype": "int4"})
    try:
        d = D.DataParallel(_mlp(W), group=g)
        d(rows(2, x)).mean().backward()
        facts["int4_error"] = None
    except ValueError as e:
        facts["int4_error"] = str(e)
    finally:
        flags.set_flags({"dp_grad_comm_dtype": ""})
    # the two helpers: averaged gradients, parameters from rank 0
    m = _mlp([w * (rank + 1) for w in W])
    for p in m.parameters():
        p._data.grad = torch.full(p._data.shape, float(rank + 1))
    D.sync_param_grads(list(m.parameters()), g)
    facts["synced_grad"] = float(m.l1.weight.grad.numpy()[0, 0])
    D.sync_params_buffers(m, g, src_rank=0)
    facts["broadcast_w"] = m.l2.weight.numpy()
    return facts


# ---------------------------------------------------------------------------
# group-sharded stages 1-3 (tests/test_torch_group_sharded.py)
# ---------------------------------------------------------------------------

def group_sharded(rank, world, payload, out):
    """The reference test's model (Linear 16-32, relu, Linear 32-16) and
    AdamW lr 0.01 under each level, rank r on its rows of the batch; the
    losses, the whole parameters after the steps, the optimizer state's
    bytes, and a stage-3 model saved for the reference to load."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.distributed import sharding as S

    place.set_device("cpu")
    X, Y, Wt = payload["x"], payload["y"], payload["weights"]
    k = X.shape[0] // world
    x = P.to_tensor(X[rank * k:(rank + 1) * k])
    y = P.to_tensor(Y[rank * k:(rank + 1) * k])

    def model():
        m = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 16))
        for p, w in zip(m.parameters(), Wt):
            p.set_value(torch.from_numpy(w))
        return m

    def train(level, offload=False, scaler=None, steps=payload["steps"]):
        m = model()
        o = O.AdamW(learning_rate=0.01, parameters=m.parameters())
        m2, o2, sc = S.group_sharded_parallel(m, o, level, scaler=scaler,
                                              offload=offload)
        losses = []
        for _ in range(steps):
            loss = ((m2(x) - y) ** 2).mean()
            if sc is not None:
                sc.scale(loss).backward()
                sc.step(o2)
                sc.update()
            else:
                loss.backward()
                o2.step()
            o2.clear_grad()
            losses.append(float(loss))
        state = sum(a.numel() * a.element_size()
                    for s in o._accumulators.values() for a in s.values())
        return m2, o2, {"losses": losses, "state_bytes": state}

    for level in ("os", "os_g", "p_g_os"):
        m2, o2, res = train(level)
        if level == "p_g_os":
            res["stored_shapes"] = [tuple(p._data.shape)
                                    for p in m2.parameters()]
            S.save_group_sharded_model(m2, payload["ckpt"], optimizer=o2)
        res["params"] = [p.numpy() for p in
                         (m2.get_all_parameters() if level == "p_g_os"
                          else m2.parameters())]
        out[level] = res
    _, _, out["os_g_offload"] = train("os_g", offload=True)
    _, _, out["os_g_scaler"] = train(
        "os_g", scaler=amp.GradScaler(init_loss_scaling=1024.0))


# ---------------------------------------------------------------------------
# fleet: topology, mp layers, sequence parallel, routing
# (tests/test_torch_fleet.py)
# ---------------------------------------------------------------------------

def _hcg_facts(hcg):
    names = ("dp", "pp", "sharding", "sep", "mp")
    return {"coord": {n: hcg._coord()[n] for n in names},
            "groups": {n: list(hcg._groups[n].ranks) for n in names},
            "check": list(hcg.get_check_parallel_group().ranks),
            "first_stage": hcg.is_first_stage(),
            "last_stage": hcg.is_last_stage()}


def fleet(rank, world, payload, out):
    """Eight gloo ranks: the hybrid groups of dp2·pp2·mp2 and dp2·mp2, the
    tensor-parallel layers, sequence-parallel ops, the hybrid clip and
    the RNG tracker at mp 2 (every pair of ranks alike), and the wrapper
    `distributed_model` picks for each strategy."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import nn, optimizer as O
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.distributed import fleet as F
    from paddle_tpu_torch.distributed.fleet.base import topology as T
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.distributed.fleet.utils import (
        sequence_parallel_utils as SP)

    place.set_device("cpu")

    def strategy(**h):
        s = F.DistributedStrategy()
        s.hybrid_configs = h
        return s

    F.init(is_collective=True, strategy=strategy(dp_degree=2, pp_degree=2,
                                                 mp_degree=2))
    out["dp2pp2mp2"] = _hcg_facts(F.get_hybrid_communicate_group())
    hcg = T.HybridCommunicateGroup(T.CommunicateTopology(
        ["dp", "pp", "sharding", "sep", "mp"], [2, 1, 1, 1, 2]))
    if rank < 4:
        out["dp2mp2"] = _hcg_facts(hcg)

    # mp 2 (dp inferred 4): each pair of ranks holds one layer's shards
    F.init(is_collective=True, strategy=strategy(mp_degree=2))
    hcg = F.get_hybrid_communicate_group()
    out["inferred_dp"] = hcg.get_data_parallel_world_size()
    r = hcg.get_model_parallel_rank()
    pl = payload["mp"]

    def param(layer, name, value):
        getattr(layer, name).set_value(torch.from_numpy(
            np.ascontiguousarray(value)))

    col = ColumnParallelLinear(8, 16, gather_output=False, has_bias=True)
    row = RowParallelLinear(16, 8, input_is_parallel=True, has_bias=True)
    param(col, "weight", pl["wc"][:, r * 8:(r + 1) * 8])
    param(col, "bias", pl["bc"][r * 8:(r + 1) * 8])
    param(row, "weight", pl["wr"][r * 8:(r + 1) * 8])
    param(row, "bias", pl["br"])
    x = P.to_tensor(pl["x"], stop_gradient=False)
    y = row(col(x))
    (y * P.to_tensor(pl["gy"])).sum().backward()
    res = {"y": y.numpy(), "dx": x.grad.numpy(),
           "dwc": col.weight.grad.numpy(), "dbc": col.bias.grad.numpy(),
           "dwr": row.weight.grad.numpy(), "dbr": row.bias.grad.numpy(),
           "distributed": [col.weight.is_distributed,
                           row.bias.is_distributed]}
    # the gathering column and the splitting row
    col_g = ColumnParallelLinear(8, 16, gather_output=True)
    param(col_g, "weight", pl["wc"][:, r * 8:(r + 1) * 8])
    param(col_g, "bias", pl["bc"][r * 8:(r + 1) * 8])
    res["col_gathered"] = col_g(P.to_tensor(pl["x"])).numpy()
    row_s = RowParallelLinear(16, 8, input_is_parallel=False)
    param(row_s, "weight", pl["wr"][r * 8:(r + 1) * 8])
    param(row_s, "bias", pl["br"])
    res["row_split"] = row_s(P.to_tensor(pl["h"])).numpy()
    emb = VocabParallelEmbedding(32, 8)
    param(emb, "weight", pl["table"][r * 16:(r + 1) * 16])
    e = emb(P.to_tensor(pl["ids"]))
    (e * P.to_tensor(pl["ge"])).sum().backward()
    res["emb"], res["demb"] = e.numpy(), emb.weight.grad.numpy()
    logits = P.to_tensor(
        np.ascontiguousarray(pl["logits"][:, r * 16:(r + 1) * 16]),
        stop_gradient=False)
    loss = ParallelCrossEntropy()(logits, P.to_tensor(pl["labels"]))
    loss.sum().backward()
    res["ce"], res["dlogits"] = loss.numpy(), logits.grad.numpy()
    # sequence parallel: [s, b, h] with s cut over mp
    s = P.to_tensor(pl["seq"], stop_gradient=False)
    sc = SP.ScatterOp(s)
    ga = SP.GatherOp(sc)
    ag = SP.AllGatherOp(sc)
    rs_ = SP.ReduceScatterOp(ag)
    (ga.sum() + 2 * ag.sum() + 3 * rs_.sum()).backward()
    res["sp"] = {"scatter": sc.numpy(), "gather": ga.numpy(),
                 "all_gather": ag.numpy(), "reduce_scatter": rs_.numpy(),
                 "grad": s.grad.numpy()}
    # a sequence-parallel parameter's gradient, summed over the pair
    ln = nn.Linear(3, 3)
    SP.mark_as_sequence_parallel_parameter(ln.weight)
    res["sp_marked"] = len(SP.register_sequence_parallel_allreduce_hooks(ln))
    ln(P.to_tensor(np.full((2, 3), float(r + 1), np.float32))).sum() \
        .backward()
    res["sp_param_grad"] = ln.weight.grad.numpy()
    res["sp_bias_grad"] = ln.bias.grad.numpy()
    # the hybrid global-norm clip: the pair's SGD step, clipped over mp
    for p in (col.weight, col.bias, row.weight, row.bias):
        p.clear_grad()
    y = row(col(P.to_tensor(pl["x"])))
    (y * P.to_tensor(pl["gy"])).sum().backward()
    inner = O.SGD(learning_rate=1.0, parameters=[col.weight, col.bias,
                                                 row.weight, row.bias],
                  grad_clip=nn.ClipGradByGlobalNorm(pl["clip"]))
    F.distributed_optimizer(inner).step()
    res["clipped"] = [p.numpy() for p in (col.weight, col.bias, row.weight,
                                          row.bias)]
    # the tracker: the mp stream differs across the pair, the global one
    # does not
    from paddle_tpu_torch.distributed.fleet.layers.mpu import random as R
    R.model_parallel_random_seed(7)
    with R.get_rng_state_tracker().rng_state():
        res["rng_mp"] = P.rand([4]).numpy()
    res["rng_global"] = P.rand([4]).numpy()
    out["mp"] = res

    # the wrapper by strategy
    from paddle_tpu_torch.distributed.parallel import DataParallel
    kinds = {}
    for key, h in (("dp", {}), ("mp", {"mp_degree": 2}),
                   ("sep", {"sep_degree": 2})):
        F.init(is_collective=True, strategy=strategy(**h))
        m = nn.Linear(4, 4)
        kinds[key] = type(F.distributed_model(m)).__name__
        kinds[key + "_opt"] = type(F.distributed_optimizer(
            O.SGD(learning_rate=0.1, parameters=m.parameters()))).__name__
    out["wrappers"] = kinds
    out["dp_is_dataparallel"] = kinds["dp"] == DataParallel.__name__
    # pure dp (dp 8): the reducer averages the gradients; the optimizer
    # issues no second sync. Two SGD steps on rows of rank + 1.
    from paddle_tpu_torch.distributed import collective as C
    F.init(is_collective=True, strategy=strategy())
    m = F.distributed_model(nn.Linear(4, 4))
    opt = F.distributed_optimizer(
        O.SGD(learning_rate=0.1, parameters=m.parameters()))
    start = [p.numpy().copy() for p in m.parameters()]
    x = P.to_tensor(np.full((2, 4), float(rank + 1), np.float32))
    issued = []
    for _ in range(2):
        C.reset_issued()
        m(x).sum().backward()
        opt.step()
        opt.clear_grad()
        issued.append(C.issued())
    out["dp_step"] = {
        "issued": issued, "buckets": len(m._reducer._plan.buckets),
        "axis": F.get_hybrid_communicate_group().get_data_parallel_group()
        .axis_name,
        "start": start, "end": [p.numpy() for p in m.parameters()]}
    errors = {}
    for key, st in (("pp", strategy(pp_degree=2)),
                    ("compiled", strategy(compiled=True))):
        F.init(is_collective=True, strategy=st)
        try:
            F.distributed_model(nn.Linear(4, 4))
        except NotImplementedError as e:
            errors[key] = str(e)
    try:
        F.init(is_collective=False)
    except NotImplementedError as e:
        errors["ps"] = str(e)
    out["errors"] = errors
