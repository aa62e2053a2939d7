"""Multi-rank runs of the port's distributed modules on the CPU, for the
port's tests: one spawned process a rank, a gloo group formed over a
FileStore under the test's temporary directory (no TCP port to race for
between pytest workers).

`start(name, world, tmp, payload, timeout)` spawns `world` processes
running the worker `name` of this module as `worker(rank, world,
payload, out)`, and returns at once, so the test's own process can
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
        C.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"error.{rank}").write_text(traceback.format_exc())
        raise


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
        if kind == "eval":
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
