"""The port's LoRA adapter serving held against the reference's.

Both packages serve a tiny f32 LLaMA from the same weights (the
reference's pytree through numpy); the port runs on the CPU, where each
kernel wrapper takes its plain version, the reference on its stock path.
What must agree:

- `make_adapter` draws the same weights bit for bit;
- an adapter manifest saved by either package loads in the other, and a
  CRC, version or model-signature failure raises in both;
- wire blobs, raw and q8, unpack in the other package, and the q8 bytes
  are equal;
- a mixed-tenant trace (base, two adapters of rank 4 over 2 slots)
  gives the reference's streams row by row, and its base rows equal an
  adapter-free engine's, its adapter rows differ;
- one slot for three tenants (every request an LRU swap) and the chaos
  ``adapter:evict@op=use;call=3`` drill give the reference's streams
  and its load, swap and eviction counts;
- slots are written in place (a captured tick holds the packs'
  addresses), and the transport publishes and fetches through a
  ``torch.distributed.TCPStore`` on this host, a corrupted fetch
  rejected by the CRC.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.fault_tolerance import chaos as JC
from paddle_tpu.inference.serving import PagedServingEngine as JEngine
from paddle_tpu.inference.serving import adapters as JA
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed.fault_tolerance import chaos
from paddle_tpu_torch.inference.serving import PagedServingEngine
from paddle_tpu_torch.inference.serving import adapters as A
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

GEOM = dict(num_blocks=96, block_size=8, max_batch=8, token_budget=32)
DIMS = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=96)
TENANTS = [None, "t-a", "t-b", None, "t-a", "t-b"]


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.LlamaConfig(**DIMS, dtype=jnp.float32)
    cfg = L.LlamaConfig(**DIMS, dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(n, ln=8, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 97, (ln,)).tolist() for _ in range(n)]


def _run(eng, prompts, adapters=None, max_new=8):
    rids = [eng.submit(p, max_new_tokens=max_new,
                       **({} if adapters is None or adapters[i] is None
                          else {"adapter": adapters[i]}))
            for i, p in enumerate(prompts)]
    done = {c.rid: c.output_tokens for c in eng.run()}
    return [done.get(r) for r in rids]


def _engines(tiny, slots, names, **kw):
    jcfg, jparams, cfg, params = tiny
    jeng = JEngine(jcfg, jparams, max_len=96, adapter_slots=slots,
                   **GEOM, **kw)
    eng = PagedServingEngine(cfg, params, max_len=96, adapter_slots=slots,
                             device="cpu", **GEOM, **kw)
    for n, s in names:
        jeng.adapters.register(JA.make_adapter(jcfg, n, rank=4, alpha=8.0,
                                               seed=s, scale=0.3))
        eng.adapters.register(A.make_adapter(cfg, n, rank=4, alpha=8.0,
                                             seed=s, scale=0.3))
    return jeng, eng


def _stats(mgr):
    return {k: mgr.stats[k] for k in ("loads", "swaps", "evictions",
                                      "hits", "pins", "unpins")}


@pytest.mark.parametrize("rank,targets", [(4, A.ADAPTER_TARGETS),
                                          (3, ("wq", "wo"))])
def test_make_adapter_weights_equal(tiny, rank, targets):
    jcfg, _, cfg, _ = tiny
    ours = A.make_adapter(cfg, "billing", rank=rank, seed=7, targets=targets)
    ref = JA.make_adapter(jcfg, "billing", rank=rank, seed=7,
                          targets=targets)
    assert (ours.rank, ours.alpha, sorted(ours.weights)) == \
        (ref.rank, ref.alpha, sorted(ref.weights))
    for t in ref.weights:
        for a, b in zip(ours.weights[t], ref.weights[t]):
            assert a.dtype == np.float32 and np.array_equal(a, b)
    assert A.rank_class(3) == JA.rank_class(3) == 4
    assert A.target_dims(cfg) == JA.target_dims(jcfg)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_manifests_cross_both_ways(tiny, tmp_path, writer):
    jcfg, _, cfg, _ = tiny
    ad = A.make_adapter(cfg, "billing", rank=3, alpha=6.0, seed=7)
    path = str(tmp_path / "billing.json")
    if writer == "port":
        A.save_adapter(ad, cfg, path)
        back = JA.load_adapter(path, jcfg)
    else:
        JA.save_adapter(JA.make_adapter(jcfg, "billing", rank=3, alpha=6.0,
                                        seed=7), jcfg, path)
        back = A.load_adapter(path, cfg)
    assert (back.name, back.rank, back.alpha) == ("billing", 3, 6.0)
    for t, (a, b) in ad.weights.items():
        assert np.array_equal(back.weights[t][0], a)
        assert np.array_equal(back.weights[t][1], b)


@pytest.mark.parametrize("damage", ["crc", "version", "format",
                                    "signature"])
def test_manifest_failures_raise_in_both(tiny, tmp_path, damage):
    jcfg, _, cfg, _ = tiny
    path = str(tmp_path / "a.json")
    A.save_adapter(A.make_adapter(cfg, "a", rank=2, seed=1), cfg, path)
    doc = json.load(open(path))
    load_cfgs = (cfg, jcfg)
    if damage == "crc":
        doc["payload"]["alpha"] = 99.0
    elif damage == "version":
        doc["version"] = 2
    elif damage == "format":
        doc["format"] = "something-else"
    else:   # a model of another width
        other = dict(DIMS, hidden_size=64)
        load_cfgs = (L.LlamaConfig(**other, dtype=torch.float32),
                     JL.LlamaConfig(**other, dtype=jnp.float32))
    json.dump(doc, open(path, "w"))
    with pytest.raises(ValueError):
        A.load_adapter(path, load_cfgs[0])
    with pytest.raises(ValueError):
        JA.load_adapter(path, load_cfgs[1])


@pytest.mark.parametrize("wire", ["", "int8"])
def test_wire_blobs_cross_both_ways(tiny, wire):
    jcfg, _, cfg, _ = tiny
    ours = A.make_adapter(cfg, "t-a", rank=4, seed=3, scale=0.3)
    ref = JA.make_adapter(jcfg, "t-a", rank=4, seed=3, scale=0.3)
    blob, jblob = A.pack_adapter(ours, wire), JA.pack_adapter(ref, wire)
    # equal bytes: the same header, the raw arrays or the q8 codec's
    assert blob == jblob
    for got in (JA.unpack_adapter(blob), A.unpack_adapter(jblob)):
        for t, (a, b) in ours.weights.items():
            if wire == "int8":        # block-scaled: within half a step
                tol = np.abs(a).max() / 127 * 0.5 + 1e-7
                assert np.abs(got.weights[t][0] - a).max() <= tol
            else:
                assert np.array_equal(got.weights[t][0], a)
                assert np.array_equal(got.weights[t][1], b)
    with pytest.raises(A.AdapterCorruptError):
        A.unpack_adapter(blob[:-1] + bytes([blob[-1] ^ 0xFF]))


@pytest.fixture(scope="module")
def mixed(tiny):
    """The mixed-tenant trace on both packages, and the port's
    adapter-free run of the same prompts."""
    names = (("t-a", 3), ("t-b", 4))
    jeng, eng = _engines(tiny, 2, names)
    prompts = _prompts(len(TENANTS))
    ref = _run(jeng, prompts, TENANTS)
    ours = _run(eng, prompts, TENANTS)
    _, _, cfg, params = tiny
    base = _run(PagedServingEngine(cfg, params, max_len=96, device="cpu",
                                   **GEOM), prompts)
    return ref, ours, base, eng, jeng


def test_mixed_tenant_streams_equal_reference(mixed):
    ref, ours, _, eng, jeng = mixed
    assert ours == ref
    assert _stats(eng.adapters) == _stats(jeng.adapters)
    assert eng.adapters.ref_count("t-a") == eng.adapters.ref_count("t-b") \
        == 0


def test_base_rows_equal_adapter_free_engine(mixed):
    _, ours, base, _, _ = mixed
    for i, name in enumerate(TENANTS):
        if name is None:
            assert ours[i] == base[i]
        else:
            assert ours[i] != base[i]


def test_lru_swaps_equal_reference(tiny):
    """Three tenants over one slot, served one after another and then in
    reverse: every load after the first three is a swap."""
    names = (("t-a", 0), ("t-b", 1), ("t-c", 2))
    jeng, eng = _engines(tiny, 1, names)
    prompts = _prompts(1)
    order = ["t-a", "t-b", "t-c", "t-c", "t-b", "t-a"]
    ref = [_run(jeng, prompts, [n])[0] for n in order]
    ours = [_run(eng, prompts, [n])[0] for n in order]
    assert ours == ref
    assert _stats(eng.adapters) == _stats(jeng.adapters)
    assert eng.adapters.stats["swaps"] == 2
    with pytest.raises(A.AdapterMissingError):
        eng.submit([1, 2, 3], max_new_tokens=4, adapter="ghost")
    assert eng.adapters.stats["pins"] == eng.adapters.stats["unpins"]


def test_chaos_evict_drill_equal_reference(tiny):
    """adapter:evict fires at the third residency check: the slot is
    dropped mid-stream and reloaded the same tick (a swap); the streams
    do not notice, in either package."""
    spec = "adapter:evict@op=use;call=3"
    names = (("t-a", 3),)
    prompts = _prompts(2)
    jeng, eng = _engines(tiny, 2, names)
    clean = _run(eng, prompts, ["t-a", "t-a"])
    jeng, eng = _engines(tiny, 2, names)
    JC.reconfigure(spec)
    try:
        ref = _run(jeng, prompts, ["t-a", "t-a"])
    finally:
        JC.reconfigure("")
    chaos.reconfigure(spec)
    try:
        ours = _run(eng, prompts, ["t-a", "t-a"])
        fired = [i.fired for i in chaos.injections()]
    finally:
        chaos.reconfigure("")
    assert ours == ref == clean
    assert fired == [1]
    assert _stats(eng.adapters) == _stats(jeng.adapters)
    assert eng.adapters.stats["evictions"] == 1
    assert eng.adapters.stats["swaps"] == 1


def test_slots_are_written_in_place(tiny):
    """The packs keep their storage when slots are rewritten: a captured
    decode tick holds their addresses."""
    _, _, cfg, _ = tiny
    mgr = A.AdapterManager(cfg, slots=1, device="cpu")
    for i, n in enumerate(("x", "y")):
        mgr.register(A.make_adapter(cfg, n, rank=2, seed=i))
    mgr.ensure_loaded("x")
    ptrs = {t: (a.data_ptr(), b.data_ptr())
            for t, (a, b) in mgr.device_packs(2).items()}
    mgr.ensure_loaded("y")              # an LRU swap into slot 0
    assert {t: (a.data_ptr(), b.data_ptr())
            for t, (a, b) in mgr.device_packs(2).items()} == ptrs
    a_pack = mgr.device_packs(2)["wq"][0]
    want = A.make_adapter(cfg, "y", rank=2, seed=1).weights["wq"][0]
    assert np.array_equal(a_pack[:, 0].numpy(), want)
    with pytest.raises(A.NoAdapterSlotsError):
        mgr.pin("y")
        mgr.pin("x")
        mgr.ensure_loaded("x")


def test_transport_store_and_chaos_corrupt(tiny):
    """Publish and fetch through a torch.distributed.TCPStore on this
    host; chaos `adapter:corrupt@op=fetch` is rejected by the CRC and the
    prefetch reports it; an unpublished name is a miss, not a wait."""
    import datetime

    import torch.distributed as dist
    _, _, cfg, _ = tiny
    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=datetime.timedelta(seconds=30),
                          wait_for_workers=False)
    tr = A.AdapterTransport(store=store)
    ad = A.make_adapter(cfg, "t-a", rank=4, seed=3)
    tr.publish(ad, wire="int8")
    mgr = A.AdapterManager(cfg, device="cpu")
    assert mgr.prefetch("ghost", tr) == "miss"
    chaos.reconfigure("adapter:corrupt@op=fetch")
    try:
        assert mgr.prefetch("t-a", tr) == "corrupt"
    finally:
        chaos.reconfigure("")
    assert mgr.prefetch("t-a", tr) == "ok"
    assert mgr.prefetch("t-a", tr) == "registered"
