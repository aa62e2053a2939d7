"""The port's disaggregated serving held against the reference's.

- Page blobs cross both packages both ways: the port's `pack_pages` of a
  payload gives the reference's bytes (raw and the int8 wire, f32, int8
  pages with their scale planes, and bf16 pages, which the port holds as
  16-bit patterns), and each package unpacks the other's blob to the
  same values. A CRC failure raises `PageCorruptError`; int8 pages are
  never requantized; `parse_pools` takes and refuses what the
  reference's does.
- A `DisaggRouter` over two port engines (a tiny f32 LLaMA, the
  reference's weights, on the CPU) serves the reference router's streams
  with the reference's `disagg_stats`, and the streams equal the
  monolithic engine's. The reference router runs once, in a module
  fixture, over the same trace.
- The chaos `migration` site: `rank_dead` on the offer (one recompute
  fallback, the sender dead with its incarnation bumped), `drop` on the
  pull (every retry, then a fallback), `delay` (the pull still lands),
  `corrupt` on the offer (the CRC rejects it, nothing adopted): each
  stream equal to the monolithic engine's, as the reference's tests
  hold its router. Sustained failure trips monolithic serving.
- The epoch fence's three cases, `ingest_pages` refusing another
  geometry or dtype, fleet prefix steering, a TCPStore-backed transport,
  and the autoscaler's grow, ceiling, shrink, floor, deadline, TPOT and
  cooldown decisions (with explicit `now=`, never the wall clock).
"""
import datetime

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import DisaggRouter as JDisagg
from paddle_tpu.inference.serving import PagedServingEngine as JEngine
from paddle_tpu.inference.serving import disagg as JD
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed.fault_tolerance import chaos
from paddle_tpu_torch.inference.serving import (BlockManager, DisaggRouter,
                                                MigrationTimeout,
                                                PageCorruptError,
                                                PagedServingEngine,
                                                StaleEpochError, parse_pools)
from paddle_tpu_torch.inference.serving import disagg as D
from paddle_tpu_torch.inference.serving.replica import (DEAD, DEGRADED,
                                                        DRAINED, DRAINING,
                                                        HEALTHY)
from paddle_tpu_torch.inference.serving.router import RouterRequest
from paddle_tpu_torch.models import llama as L

DIMS = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=96)
GEOM = dict(num_blocks=32, block_size=4, max_batch=2, token_budget=16)
POOLS = "prefill=1,decode=1"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: torch's intra-op threads cost more than they do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """The port's seeded weights, and the same values as the reference's
    pytree (the port's layout is the reference's)."""
    jcfg = JL.LlamaConfig(**DIMS, dtype=jnp.float32)
    cfg = L.LlamaConfig(**DIMS, dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    return jcfg, jparams, cfg, params


def _factory(tiny, **kw):
    _, _, cfg, params = tiny
    geom = dict(GEOM, **kw)
    return lambda: PagedServingEngine(cfg, params, device="cpu", **geom)


def _prompts(n, lens, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 97, (ln,)).tolist()
            for ln, _ in zip((list(lens) * n)[:n], range(n))]


def _mono(tiny, prompts, max_new=8):
    """The port's monolithic engine's streams (itself held to the
    reference engine's in tests/test_torch_router.py)."""
    eng = _factory(tiny)()
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = {c.rid: c.output_tokens for c in eng.run()}
    return [done[r] for r in rids]


def _serve(router, prompts, max_new=8):
    rids = [router.submit(p, max_new_tokens=max_new) for p in prompts]
    done = {c.rid: c.output_tokens for c in router.run()}
    return [done[r] for r in rids]


def _zeroing(router, pack, unpack, pull_once):
    """Replace the router's pull with one that zeroes the pages' K/V: a
    valid payload with wrong pages (the reference's lossy-wire test)."""
    def tamper(key, timeout_s, victim=None):
        blob = pull_once(router.transport, key, timeout_s, victim=victim)
        payload, epoch = unpack(blob)
        payload["k"] = np.zeros_like(payload["k"])
        payload["v"] = np.zeros_like(payload["v"])
        return pack(payload, epoch)
    router.transport.pull_once = tamper


HAPPY = _prompts(4, [9, 5, 13, 7], seed=11)
LOSSY = _prompts(1, [9], seed=15)


def _ref_router(tiny):
    jcfg, jparams, _, _ = tiny
    return JDisagg(lambda: JEngine(jcfg, jparams, **GEOM), pools=POOLS)


@pytest.fixture(scope="module")
def ref_happy(tiny):
    """The reference router's streams and disagg_stats of HAPPY."""
    router = _ref_router(tiny)
    return _serve(router, HAPPY), dict(router.disagg_stats)


@pytest.fixture(scope="module")
def ref_lossy(tiny):
    """The reference router's streams and counts of LOSSY with its pulled
    pages zeroed."""
    router = _ref_router(tiny)
    _zeroing(router, JD.pack_pages, JD.unpack_pages,
             JD.PageTransport.pull_once)
    return (_serve(router, LOSSY), dict(router.disagg_stats),
            dict(router.stats))


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _payloads(kind, nblk=16):
    """(the reference's payload, the port's) of one page set."""
    rs = np.random.RandomState(3)
    shape = (2, nblk, 2, 4, 4)
    base = {"chain": [(4 * (i + 1), 11 * (i + 1)) for i in range(nblk)],
            "tokens": list(range(4 * nblk))}
    if kind == "int8":
        k = rs.randint(-127, 128, shape).astype(np.int8)
        v = rs.randint(-127, 128, shape).astype(np.int8)
        scales = {n: rs.rand(2, nblk, 2).astype(np.float32)
                  for n in ("kdq", "vdq")}
        ref = dict(base, dtype="int8", k=k, v=v, **scales)
        return ref, dict(ref)
    if kind == "bfloat16":
        k = rs.randn(*shape).astype(ml_dtypes.bfloat16)
        v = rs.randn(*shape).astype(ml_dtypes.bfloat16)
        ref = dict(base, dtype="bfloat16", k=k, v=v)
        return ref, dict(ref, k=k.view(np.int16), v=v.view(np.int16))
    ref = dict(base, dtype="float32", k=rs.randn(*shape).astype(np.float32),
               v=rs.randn(*shape).astype(np.float32))
    return ref, dict(ref)


@pytest.mark.parametrize("wire", ["", "int8"])
@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
def test_blobs_cross_both_packages(kind, wire):
    jpages, pages = _payloads(kind)
    blob = D.pack_pages(pages, (3, 7), wire)
    assert blob == JD.pack_pages(jpages, (3, 7), wire)
    # the port unpacks the reference's blob, the reference the port's
    mine, epoch = D.unpack_pages(JD.pack_pages(jpages, (3, 7), wire))
    theirs, jepoch = JD.unpack_pages(blob)
    assert epoch == jepoch == (3, 7)
    assert (mine["chain"], mine["tokens"], mine["dtype"]) == (
        theirs["chain"], theirs["tokens"], theirs["dtype"])
    for name in ("k", "v", "kdq", "vdq"):
        if name not in pages:
            continue
        got, want = mine[name], theirs[name]
        if kind == "bfloat16":
            assert want.dtype == ml_dtypes.bfloat16
            want = want.view(np.int16)      # the port's 16-bit patterns
        assert got.dtype == want.dtype and np.array_equal(got, want)
    lossy = wire == "int8" and kind == "float32"
    assert (b'"wire": "int8"' in blob) == lossy
    if lossy:
        raw = D.pack_pages(pages, (3, 7))
        assert len(blob) < 0.5 * len(raw)
        assert np.abs(mine["k"] - pages["k"]).max() < 0.05
    else:       # int8 pages are never requantized, bf16 ships raw
        assert np.array_equal(mine["k"], pages["k"])


def test_corrupt_trips_crc_and_parse_pools():
    _, pages = _payloads("float32", nblk=2)
    blob = D.pack_pages(pages, (0, 0))
    with pytest.raises(PageCorruptError):
        D.unpack_pages(D._flip_tail(blob))
    with pytest.raises(PageCorruptError):
        D.unpack_pages(b"not a payload")
    assert parse_pools("") is None
    assert parse_pools("prefill=1,decode=2") == {"prefill": 1, "decode": 2}
    for bad in ("prefill=1", "prefill=0,decode=1", "a=1,b=2",
                "prefill,decode"):
        with pytest.raises(ValueError):
            parse_pools(bad)
        with pytest.raises(ValueError):
            JD.parse_pools(bad)


def test_transport_local_and_tcpstore():
    from torch.distributed import TCPStore
    store = TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False,
                     timeout=datetime.timedelta(seconds=10))
    for t in (D.PageTransport(), D.PageTransport(store)):
        t.offer("k1", b"pay\x00load")
        assert t.pull_once("k1", 0.01) == b"pay\x00load"
        t.forget("k1")
        with pytest.raises(MigrationTimeout):
            t.pull_once("k1", 0.01)
        assert t.stats["bytes_offered"] == 8
    for idx in (D.FleetPrefixIndex(), D.FleetPrefixIndex(store)):
        idx.publish(0, [(4, 100), (8, 200), (12, 300)])
        assert idx.depth(0, [(4, 100), (8, 200), (12, 300)]) == 12
        assert idx.depth(0, [(4, 100), (8, 999), (12, 300)]) == 4
        assert idx.depth(1, [(4, 100)]) == 0
        idx.drop(0)
        assert idx.depth(0, [(4, 100)]) == 0


# ---------------------------------------------------------------------------
# the handoff and its failure ladder
# ---------------------------------------------------------------------------

def test_happy_path_equals_reference(tiny, ref_happy):
    router = DisaggRouter(_factory(tiny), pools=POOLS)
    out = _serve(router, HAPPY)
    want, jstats = ref_happy
    assert out == want == _mono(tiny, HAPPY)
    assert router.disagg_stats == jstats
    assert jstats["handoffs"] == jstats["handoffs_ok"] == 4
    assert router.stats["mismatches"] == 0
    dec = router.pool("decode")[0]
    assert dec.engine.blocks.stats["adopted_pages"] > 0
    assert router.transport.stats["bytes_offered"] > 0
    snap = router.disagg_snapshot()
    assert snap["pools"] == {"prefill": [0], "decode": [1]}
    assert snap["decode_pool_accepting"] == 1
    assert router.snapshot()["replicas"]["1"]["role"] == "decode"


def test_lossy_wire_adopts_wrong_pages_as_the_reference(tiny, ref_lossy):
    """The reference's known fault, carried: zeroed pages whose first
    regenerated token happens to agree are adopted (the confirm covers
    only the tokens the client has seen), and the stream then diverges
    from the monolithic engine's. The port gives the reference's stream
    and counts, not the monolithic one."""
    want, jstats, jrouter = ref_lossy
    router = DisaggRouter(_factory(tiny), pools=POOLS)
    _zeroing(router, D.pack_pages, D.unpack_pages, D.PageTransport.pull_once)
    out = _serve(router, LOSSY)
    assert out == want
    assert out != _mono(tiny, LOSSY)
    assert router.disagg_stats == jstats
    assert router.stats["mismatches"] == jrouter["mismatches"] == 0


def test_monolithic_spec_and_single_token(tiny):
    prompts = _prompts(2, [6, 9], seed=4)
    router = DisaggRouter(_factory(tiny), pools="", num_replicas=2)
    assert _serve(router, prompts) == _mono(tiny, prompts)
    assert router.disagg_stats["handoffs"] == 0
    assert all(h.role == "any" for h in router.replicas)
    router = DisaggRouter(_factory(tiny), pools=POOLS)
    assert _serve(router, prompts, max_new=1) == _mono(tiny, prompts, 1)
    assert router.disagg_stats["handoffs"] == 0


def _drill(tiny, spec, prompts, **kw):
    try:
        chaos.reconfigure(spec)
        router = DisaggRouter(_factory(tiny), pools=POOLS, **kw)
        out = _serve(router, prompts)
        fired = [i.fired for i in chaos.injections()]
    finally:
        chaos.reconfigure("")
    assert out == _mono(tiny, prompts)
    return router, fired


def test_rank_dead_mid_handoff_recomputes(tiny):
    router, fired = _drill(
        tiny, "migration:rank_dead@op=offer;victim=0;count=1",
        _prompts(3, [9, 7, 11], seed=7), probation_s=60.0)
    assert fired == [1]
    assert router.disagg_stats["fallbacks"] == 1
    assert router.stats["mismatches"] == 0
    src = router.replicas[0]
    assert src.state == DEAD and src.incarnation == 1
    assert src.death_reason == "chaos_migration_rank_dead"
    dec = router.pool("decode")[0].engine
    assert dec.stats["graph_captures"] == 0     # eager on the CPU


def test_rank_kill_hook_keeps_no_router_alive(tiny):
    """One rank-kill hook serves every router: it holds the newest router
    weakly, so routers built one after another (and their engines) are
    freed; migration kills reach the newest router, other sites the hook
    installed before the first router."""
    import gc
    import weakref
    seen = []
    prev = chaos.set_rank_kill_hook(lambda victim, site: seen.append(
        (victim, site)))
    try:
        engines = []
        for _ in range(2):
            router = DisaggRouter(_factory(tiny), pools=POOLS)
            engines.append(weakref.ref(router.replicas[0].engine))
            del router
        gc.collect()
        assert all(ref() is None for ref in engines)
        old = DisaggRouter(_factory(tiny), pools=POOLS)
        new = DisaggRouter(_factory(tiny), pools=POOLS)
        D._rank_kill(0, "migration")
        assert new.replicas[0].state == DEAD
        assert old.replicas[0].state != DEAD
        D._rank_kill(3, "collective")
        assert seen == [(3, "collective")]
    finally:
        chaos.set_rank_kill_hook(prev)
        D._PREV_KILL_HOOK[0] = prev


def test_drop_delay_corrupt(tiny):
    router, _ = _drill(tiny, "migration:drop@op=pull;count=0",
                       _prompts(1, [9], seed=5), migration_retries=2,
                       migration_timeout_s=0.01, migration_backoff_s=0.0)
    assert router.disagg_stats["fallbacks"] == 1
    assert router.disagg_stats["retries"] == 2     # every configured one
    router, fired = _drill(tiny, "migration:delay@op=pull;delay=0.01",
                           _prompts(1, [9], seed=6))
    assert fired == [1] and router.disagg_stats["handoffs_ok"] == 1
    assert router.disagg_stats["fallbacks"] == 0
    router, _ = _drill(tiny, "migration:corrupt@op=offer",
                       _prompts(1, [9], seed=8))
    assert router.disagg_stats["fallbacks"] == 1
    assert router.transport.stats["corrupted"] == 1
    assert router.pool("decode")[0].engine.blocks.stats[
        "adopted_pages"] == 0


def test_sustained_failure_trips_monolithic(tiny):
    prompts = _prompts(4, [9, 7, 11, 5], seed=13)
    router, _ = _drill(tiny, "migration:drop@op=offer;count=0", prompts,
                       migration_monolithic_after=2,
                       migration_monolithic_cooldown_s=60.0,
                       migration_retries=0, migration_timeout_s=0.01,
                       migration_backoff_s=0.0)
    st = router.disagg_stats
    assert st["monolithic_trips"] == 1 and st["fallbacks"] == 2
    assert st["handoffs"] < len(prompts)      # later requests never split
    assert router._monolithic_active()
    assert router.disagg_snapshot()["monolithic_for_s"] > 0


# ---------------------------------------------------------------------------
# the fence, ingest, placement
# ---------------------------------------------------------------------------

def test_epoch_fence(tiny):
    router = DisaggRouter(_factory(tiny), pools=POOLS, probation_s=0.0)
    src = router.replicas[0]
    hs = {"epoch": (0, src.incarnation)}
    router._check_epoch(hs)                     # a live sender: fine
    src._kill("test")                           # lease revoked, bumped
    with pytest.raises(StaleEpochError):
        router._check_epoch(hs)
    assert src.maybe_readmit()                  # fresh engine, same id
    assert src.state == DEGRADED
    with pytest.raises(StaleEpochError):
        router._check_epoch(hs)                 # N + 1 != N
    _, pages = _payloads("float32", nblk=1)
    assert D.unpack_pages(D.pack_pages(pages, (0, 5)))[1] == (0, 5)


def test_ingest_rejects_geometry_and_dtype(tiny):
    eng = _factory(tiny)()
    toks = list(range(9))
    eng.submit(toks, max_new_tokens=1)
    eng.run()
    pages = eng.extract_pages(toks)
    assert pages is not None and pages["k"].shape == (2, 2, 2, 4, 8)
    assert eng.extract_pages(list(range(3))) is None    # no full block
    with pytest.raises(ValueError, match="geometry"):
        _factory(tiny, block_size=8)().ingest_pages(pages)
    with pytest.raises(ValueError, match="float32"):
        _factory(tiny)().ingest_pages(dict(pages, dtype="bfloat16"))
    other = _factory(tiny)()
    assert other.ingest_pages(pages) == 2
    assert other.ingest_pages(pages) == 0           # already present
    assert other.blocks.stats["adopted_pages"] == 2
    assert other.blocks.lookup_prefix(toks) == 8
    assert other.blocks.evict_hashes([h for _, h in pages["chain"]]) == 2
    assert other.blocks.lookup_prefix(toks) == 0


def test_ingest_longer_than_pool_keeps_one_page_a_block(tiny):
    """A chain of 6 pages into a 4-block pool that holds 2 cached pages:
    the 4 blocks free or parked on entry take the chain's first 4 pages,
    and no page adopted in the call is reclaimed for a later one (the
    same block twice in the write, one hash over the other's K/V)."""
    src = _factory(tiny)()
    toks = _prompts(1, [25], seed=23)[0]
    src.submit(toks, max_new_tokens=1)
    src.run()
    pages = src.extract_pages(toks)
    assert len(pages["chain"]) == 6
    dst = _factory(tiny, num_blocks=4)()
    dst.submit(_prompts(1, [9], seed=29)[0], max_new_tokens=1)
    dst.run()                                   # 2 pages parked
    assert dst.ingest_pages(pages) == 4
    blks = dst.blocks.chain_blocks(pages["chain"][:4])
    assert blks is not None and len(set(blks)) == 4
    assert dst.blocks.lookup_prefix(toks) == 16
    for i, b in enumerate(blks):
        assert np.array_equal(dst._key_cache[:, b].numpy(), pages["k"][:, i])
        assert np.array_equal(dst._value_cache[:, b].numpy(),
                              pages["v"][:, i])


def test_index_steers_placement_to_page_owner(tiny):
    router = DisaggRouter(_factory(tiny), pools="prefill=1,decode=2")
    prompt = _prompts(1, [12], seed=19)[0]
    _serve(router, [prompt], max_new=4)
    st = router.disagg_stats
    assert st["handoffs_ok"] + st["handoffs_local"] == 1
    owner = [h for h in router.pool("decode")
             if h.engine.blocks.stats["adopted_pages"] > 0]
    assert len(owner) == 1
    probe = RouterRequest(999, "default", prompt + [3, 4], 4)
    scores = {h.replica_id: router._prefix_signal(probe, h)
              for h in router.pool("decode")}
    others = [v for k, v in scores.items() if k != owner[0].replica_id]
    assert scores[owner[0].replica_id] > max(others)


def test_block_manager_chain_blocks():
    bm = BlockManager(num_blocks=16, block_size=4)
    toks = list(range(11))
    chain = bm.prefix_chain(toks)
    assert bm.chain_blocks(chain) is None        # nothing live yet
    blk = bm.adopt_page(chain[0][1], 0, toks[:4])
    assert bm.adopt_page(chain[0][1], 0, toks[:4]) is None
    assert bm.chain_blocks(chain[:1]) == [blk]
    assert bm.stats["adopted_pages"] == 1


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------

def _summary(ttft=0.0, tpot=0.0, shed=0.0, deadline=0):
    return {"ttft_p99_s": ttft, "tpot_p99_s": tpot,
            "shed_queue_rate": shed, "deadline_expired": deadline}


def _scaler(tiny, **kw):
    router = DisaggRouter(_factory(tiny), pools=POOLS)
    kw = dict(dict(ttft_p99_s=1.0, shed_rate=0.05, min_decode=1,
                   max_decode=3, cooldown_s=0.0), **kw)
    return router, D.PoolAutoscaler(router, **kw)


def test_autoscaler_grow_ceiling_shrink_floor(tiny):
    router, scaler = _scaler(tiny, ttft_p99_s=0.1)
    assert router.decode_pool_size() == 1
    assert scaler.tick(_summary(ttft=0.5), now=1.0) == "grow"
    new = router.replicas[-1]
    assert router.decode_pool_size() == 2
    assert new.role == "decode" and new.probation and new.state == DEGRADED
    assert new.replica_id in router._assigned
    assert scaler.tick(_summary(ttft=0.01), now=2.0) == "shrink"
    drained = [h for h in router.replicas if h.state in (DRAINING, DRAINED)]
    assert len(drained) == 1 and drained[0].role == "decode"
    assert scaler.tick(_summary(ttft=0.0), now=3.0) == "hold"     # floor
    assert router.decode_pool_size() == 1
    router, scaler = _scaler(tiny, ttft_p99_s=0.1, max_decode=1)
    assert scaler.tick(_summary(ttft=9.9), now=1.0) == "hold"     # ceiling
    with pytest.raises(NotImplementedError, match="observability"):
        scaler.tick(None, now=2.0)


def test_autoscaler_deadline_tpot_cooldown(tiny):
    router, scaler = _scaler(tiny)
    assert scaler.tick(_summary(ttft=0.9, deadline=500), now=1.0) == "hold"
    assert scaler.tick(_summary(ttft=0.9, shed=0.5, deadline=500),
                       now=2.0) == "grow"
    router, scaler = _scaler(tiny, tpot_p99_s=0.02)
    assert scaler.tick(_summary(ttft=0.01, tpot=0.2), now=1.0) == "grow"
    assert scaler.tick(_summary(ttft=0.01, tpot=0.015), now=2.0) == "hold"
    assert scaler.tick(_summary(ttft=0.01, tpot=0.001), now=3.0) == "shrink"
    router, scaler = _scaler(tiny)
    assert scaler.tpot_p99_s == 0.0             # off by default
    router.grow_decode()
    assert scaler.tick(_summary(ttft=0.01, tpot=99.0), now=1.0) == "shrink"
    router, scaler = _scaler(tiny, ttft_p99_s=0.1, max_decode=4,
                             cooldown_s=3600.0)
    assert scaler.tick(_summary(ttft=9.9), now=100.0) == "grow"
    assert scaler.tick(_summary(ttft=9.9), now=3699.0) is None
    assert scaler.tick(_summary(ttft=9.9), now=3700.0) == "grow"
    assert router.decode_pool_size() == 3


def test_grown_replica_serves(tiny):
    router = DisaggRouter(_factory(tiny), pools=POOLS)
    router.grow_decode()
    prompts = _prompts(2, [7, 9], seed=17)
    assert _serve(router, prompts) == _mono(tiny, prompts)
    assert router.replicas[-1].state == HEALTHY     # probation healed
