"""The port's replica handle and serving router held against the
reference's.

- The replica's breaker (strike ladder, recovery, lease, probation,
  drain) walks the same states with the same counts as the reference's
  handle, driven through the same steps over a stub engine.
- Streams served by a router over two port replicas equal the
  reference engine's on the same trace (a tiny f32 LLaMA, the
  reference's weights through numpy, the port on the CPU): with no
  fault; through a chaos kill of replica 0 mid-stream
  (``replica:kill@victim=0;call=3``), replayed and confirmed on the
  survivor; through a stall strike-out; and with speculative decoding
  on while the kill lands.
- Tenant queue caps and weighted round-robin, drain, cancel and
  failover exhaustion behave as the reference's router does, and a
  chaos spec naming a site the port does not have is refused.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import PagedServingEngine as JEngine
from paddle_tpu.inference.serving import replica as JR
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed.fault_tolerance import chaos
from paddle_tpu_torch.inference.serving import (DraftModel,
                                                PagedServingEngine,
                                                RejectedError, ServingRouter)
from paddle_tpu_torch.inference.serving import replica as R
from paddle_tpu_torch.models import llama as L

DIMS = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=96)
GEOM = dict(num_blocks=32, block_size=4, max_batch=2, token_budget=16)
LENS = (5, 9, 3, 7, 12, 4)
MAX_NEW = 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: torch's intra-op threads cost more than they do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.LlamaConfig(**DIMS, dtype=jnp.float32)
    cfg = L.LlamaConfig(**DIMS, dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(seed=21, lens=LENS):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 97, (n,)).tolist() for n in lens]


@pytest.fixture(scope="module")
def ref(tiny):
    """The reference engine's streams of the trace, one engine, no
    fault: what every router run must give."""
    jcfg, jparams, _, _ = tiny
    eng = JEngine(jcfg, jparams, max_len=96, **GEOM)
    rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
    done = {c.rid: c.output_tokens for c in eng.run()}
    return [done[r] for r in rids]


def _factory(tiny, spec=False, **over):
    _, _, cfg, params = tiny
    kw = dict(GEOM, **over)

    def build():
        extra = {}
        if spec:
            dcfg = L.LlamaConfig(**dict(DIMS, num_layers=1),
                                 dtype=torch.float32)
            extra = dict(draft=DraftModel(dcfg, {
                **params, "blocks": {k: v[:1] for k, v in
                                     params["blocks"].items()}}), spec_k=3)
        return PagedServingEngine(cfg, params, max_len=96, device="cpu",
                                  **kw, **extra)

    return build


def _serve(router, prompts=None, max_new=MAX_NEW):
    rids = [router.submit(p, max_new_tokens=max_new)
            for p in (prompts or _prompts())]
    done = {c.rid: c for c in router.run()}
    return [done[r].output_tokens for r in rids], [done[r] for r in rids]


# ---------------------------------------------------------------------------
# the replica's breaker against the reference's, over a stub engine
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self):
        self.work = True
        self.stats = {"step_builds": 1, "graph_captures": 0}

    def step(self):
        return []

    def has_work(self):
        return self.work


def _ladder(mod):
    """One script through every breaker transition; the trace of states,
    strikes and counters it leaves."""
    trace = []

    def note(h, what):
        trace.append((what, h.state, h.strikes, h.probation,
                      h.death_reason,
                      {k: h.stats[k] for k in ("strikes", "stalls",
                                               "kills", "readmits")}))

    built = []

    def factory():
        built.append(1)
        return _Stub()

    h = mod.ReplicaHandle(0, factory, ttl=60.0, stall_timeout_s=0.0,
                          dead_after=2, probation_s=0.0)
    h.guarded_step()                       # a stall strike: degraded
    note(h, "stall")
    h.stall_timeout_s = 60.0
    h.guarded_step()                       # a good step heals
    note(h, "heal")
    h.stall_timeout_s = 0.0
    h.guarded_step()
    with pytest.raises(mod.ReplicaKilledError):
        h.guarded_step()                   # the second strike kills
    note(h, "dead")
    with pytest.raises(mod.ReplicaDeadError):
        h.guarded_step()
    assert h.maybe_readmit() and not h.maybe_readmit()
    note(h, "probation")
    with pytest.raises(mod.ReplicaKilledError):
        h.guarded_step()                   # one strike on probation
    note(h, "rekilled")
    assert h.maybe_readmit()
    h.stall_timeout_s = 60.0
    h.guarded_step()
    note(h, "rejoined")
    h.ttl = 0.01
    time.sleep(0.03)
    h.engine.work = False
    h.check_lease()                        # idle: nothing owed
    note(h, "idle lease")
    h.engine.work = True
    with pytest.raises(mod.ReplicaKilledError):
        h.check_lease()
    note(h, "lease expired")
    d = mod.ReplicaHandle(1, _Stub, ttl=60.0, stall_timeout_s=60.0)
    d.start_drain()
    d.drain_tick()
    note(d, "draining")
    d.engine.work = False
    d.drain_tick()
    note(d, "drained")
    trace.append(("built", len(built)))
    return trace


def test_replica_ladder_and_lease_equal_reference():
    ours, theirs = _ladder(R), _ladder(JR)
    assert ours == theirs
    assert [t[1] for t in ours[:-1]] == [
        "degraded", "healthy", "dead", "degraded", "dead", "healthy",
        "healthy", "dead", "draining", "drained"]


# ---------------------------------------------------------------------------
# the router's streams against the reference engine's
# ---------------------------------------------------------------------------

def test_multi_replica_parity(tiny, ref):
    router = ServingRouter(_factory(tiny), num_replicas=2)
    got, done = _serve(router)
    assert got == ref
    assert {c.finish_reason for c in done} == {"length"}
    assert router.stats["assigned"] == len(LENS)
    assert {r.replica for r in router._reqs.values()} == {0, 1}


def test_chaos_kill_midstream_bit_exact(tiny, ref):
    chaos.reconfigure("replica:kill@victim=0;call=3")
    try:
        router = ServingRouter(_factory(tiny), num_replicas=2,
                               probation_s=60.0)     # stays dead
        got, _ = _serve(router)
        fired = [i.fired for i in chaos.injections()]
    finally:
        chaos.reconfigure("")
    assert got == ref
    assert fired == [1]
    dead = router.replicas[0]
    assert dead.state == R.DEAD and dead.death_reason == "chaos_kill"
    assert router.stats["failovers"] >= 1
    assert router.stats["mismatches"] == 0 and router.stats["shed"] == 0
    # a stream was mid-decode: its streamed prefix was replayed, confirmed
    assert any(r.failovers and r.confirm_target
               for r in router._reqs.values())
    snap = router.snapshot()
    assert snap["replicas"]["0"]["death_reason"] == "chaos_kill"
    assert snap["states"] == {"healthy": 1, "degraded": 0, "dead": 1,
                              "draining": 0, "drained": 0}
    assert router.router_stats == {k: snap[k] for k in router.stats}


def test_stall_strikeout_fails_over(tiny, ref):
    chaos.reconfigure("replica:stall@victim=0;count=2;delay=0")
    try:
        router = ServingRouter(_factory(tiny), num_replicas=2,
                               dead_after=2, probation_s=60.0)
        got, _ = _serve(router)
    finally:
        chaos.reconfigure("")
    assert got == ref
    assert router.replicas[0].state == R.DEAD
    assert router.replicas[0].stats["stalls"] == 2
    assert router.stats["failovers"] >= 1 and router.stats["mismatches"] == 0


def test_kill_during_spec_bit_exact(tiny, ref):
    """Speculation gives the plain greedy stream, so a replayed
    speculative stream confirms against it too."""
    chaos.reconfigure("replica:kill@victim=0;call=2")
    try:
        router = ServingRouter(_factory(tiny, spec=True), num_replicas=2,
                               probation_s=60.0)
        got, _ = _serve(router)
    finally:
        chaos.reconfigure("")
    assert got == ref
    assert router.stats["failovers"] >= 1 and router.stats["mismatches"] == 0
    assert router.replicas[1].engine.stats["spec_ticks"] > 0


def test_failover_exhaustion_sheds_typed(tiny):
    chaos.reconfigure("replica:kill@count=0")      # kill every step
    try:
        router = ServingRouter(_factory(tiny), num_replicas=2,
                               probation_s=0.0, max_failovers=2)
        rid = router.submit(_prompts(37, (4,))[0], max_new_tokens=6)
        with pytest.raises(RejectedError):
            list(router.stream(rid))
    finally:
        chaos.reconfigure("")
    assert router.stats["failover_exhausted"] == 1
    assert router._reqs[rid].finish_reason == "failover_exhausted"


def test_tenant_caps_and_weighted_round_robin(tiny):
    router = ServingRouter(_factory(tiny), num_replicas=1,
                           tenant_max_queue=2,
                           tenant_weights={"gold": 2})
    for _ in range(2):
        router.submit([1, 2, 3], max_new_tokens=2, tenant="storm")
    with pytest.raises(RejectedError):
        router.submit([1, 2, 3], max_new_tokens=2, tenant="storm")
    for _ in range(2):                   # another tenant is unaffected
        router.submit([4, 5, 6], max_new_tokens=2, tenant="gold")
    assert router.stats["shed"] == 1
    router._admit()                      # one pass: gold 2, storm 1
    placed = sorted(r.tenant for r in router._reqs.values()
                    if r.status == "assigned")
    assert placed == ["gold", "gold", "storm"]
    done = router.run()
    assert len(done) == 4 and {c.finish_reason for c in done} == {"length"}


def test_drain_and_cancel(tiny):
    _, _, cfg, params = tiny
    build = _factory(tiny, token_budget=8, num_blocks=48)
    router = ServingRouter(build, num_replicas=2)
    a = _prompts(41, (6,))[0]
    long_b = a + _prompts(42, (22,))[0]
    ra = router.submit(a, max_new_tokens=6)
    while not router._reqs[ra].emitted:
        router.step()
    assert router._reqs[ra].replica == 0
    rb = router.submit(long_b, max_new_tokens=5)
    router.step()          # b follows its prefix to replica 0, in prefill
    assert router._reqs[rb].replica == 0 and router._reqs[rb].emitted == []
    rc = router.submit(_prompts(43, (5,))[0], max_new_tokens=8)
    router.drain(0)
    assert router.stats["migrations"] == 1
    assert router.cancel(rc) and not router.cancel(rc)
    done = {c.rid: c for c in router.run()}
    assert done[rc].finish_reason == "cancelled"
    single = build()
    want = [single.submit(p, max_new_tokens=n) for p, n in
            ((a, 6), (long_b, 5))]
    solo = {c.rid: c.output_tokens for c in single.run()}
    assert done[ra].output_tokens == solo[want[0]]
    assert done[rb].output_tokens == solo[want[1]]
    assert router._reqs[rb].replica == 1
    router.step()
    assert router.replicas[0].state == R.DRAINED


def test_unported_chaos_site_refused():
    with pytest.raises(NotImplementedError, match="collective"):
        chaos.reconfigure("collective:timeout@op=all_reduce")
    with pytest.raises(ValueError):
        chaos.reconfigure("replica:explode")
    assert not chaos.active()
