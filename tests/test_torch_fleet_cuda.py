"""The dense slot engine's captured chunk and page migration, on the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture). The file imports neither jax nor the reference:

    python -m pytest tests/test_torch_fleet_cuda.py --noconftest -q

- The slot engine's replayed chunk gives the tokens and last logits of
  the same steps run eagerly, bit for bit, and one graph serves every
  chunk.
- Pages ingested into an engine whose decode tick is already captured
  are read by the replay: the stream over adopted pages equals the
  sender's, with no new capture (the pages land in the pool in place).
- A bf16 page blob round-trips bit for bit: extract, pack, unpack,
  ingest into another engine, extract again.
- A capture holds while dead graphs in reference cycles wait for the
  cyclic collector (`CapturedGraph` keeps it out of the capture).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import (PagedServingEngine,
                                                ServingEngine)
from paddle_tpu_torch.inference.serving import disagg as D
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

pytestmark = pytest.mark.gpu

# head_dim 64, GQA G = 2, widths the kernels' 16-byte rules admit
DIMS = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256)
GEOM = dict(num_blocks=64, block_size=16, max_batch=4, token_budget=64,
            max_len=256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _model(dev):
    cfg = L.LlamaConfig(**DIMS, dtype=torch.bfloat16)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, L.params_to_device(params, dev, torch.bfloat16)


def _prompts(n, lo=20, hi=90, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, DIMS["vocab_size"], rs.randint(lo, hi)).tolist()
            for _ in range(n)]


def test_slot_chunk_replay_equals_eager(cuda):
    cfg, params = _model(cuda)
    eng = ServingEngine(cfg, params, num_slots=4, chunk=8, max_len=256,
                        device=cuda)
    for p in _prompts(4):
        eng.submit(p, max_new_tokens=24)
    eng.step()                       # admits, captures, replays a chunk
    assert eng.stats["graph_captures"] == 1
    bufs = (eng._last_logits, eng._pos)
    saved = [t.clone() for t in bufs]
    toks_e = eng.decode_chunk(eager=True).copy()
    logits_e = eng._last_logits.clone()
    for t, v in zip(bufs, saved):
        t.copy_(v)
    toks_g = eng.decode_chunk()
    assert np.array_equal(toks_g, toks_e)
    assert torch.equal(eng._last_logits, logits_e)
    assert eng.stats["graph_captures"] == 1


def test_ingest_after_capture_is_read_by_the_replay(cuda):
    cfg, params = _model(cuda)
    src = PagedServingEngine(cfg, params, device=cuda, **GEOM)
    dst = PagedServingEngine(cfg, params, device=cuda, **GEOM)
    first, migrated = _prompts(2, lo=70, hi=90, seed=1)
    want = {}
    for p in (first, migrated):
        rid = src.submit(p, max_new_tokens=12)
        want[tuple(p)] = {c.rid: c.output_tokens for c in src.run()}[rid]
    rid = dst.submit(first, max_new_tokens=12)          # dst captures here
    assert {c.rid: c.output_tokens
            for c in dst.run()}[rid] == want[tuple(first)]
    assert dst.stats["graph_captures"] == 1
    pages = src.extract_pages(migrated)
    assert dst.ingest_pages(pages) == len(pages["chain"])
    hits = dst.blocks.stats["prefix_hit_tokens"]
    rid = dst.submit(migrated, max_new_tokens=12)
    assert {c.rid: c.output_tokens
            for c in dst.run()}[rid] == want[tuple(migrated)]
    assert dst.blocks.stats["prefix_hit_tokens"] - hits \
        == min(pages["chain"][-1][0], len(migrated) - 1)
    assert dst.stats["graph_captures"] == 1                   # no recapture


def test_bf16_blob_round_trips_bit_for_bit(cuda):
    cfg, params = _model(cuda)
    src = PagedServingEngine(cfg, params, device=cuda, **GEOM)
    dst = PagedServingEngine(cfg, params, device=cuda, **GEOM)
    prompt = _prompts(1, lo=60, hi=61, seed=2)[0]
    src.submit(prompt, max_new_tokens=2)
    src.run()
    pages = src.extract_pages(prompt)
    assert pages["dtype"] == "bfloat16" and pages["k"].dtype == np.int16
    ids = torch.tensor(src.blocks.chain_blocks(pages["chain"]), device=cuda)
    want = src._key_cache.index_select(1, ids)
    blob = D.pack_pages(pages, (0, 0), "int8")     # bf16 ships raw
    assert b'"wire": "raw"' in blob
    back, epoch = D.unpack_pages(blob)
    assert epoch == (0, 0)
    assert dst.ingest_pages(back) == len(pages["chain"])
    got = dst.extract_pages(prompt)
    for name in ("k", "v"):
        assert np.array_equal(got[name], pages[name])
    dst_ids = torch.tensor(dst.blocks.chain_blocks(pages["chain"]),
                           device=cuda)
    assert torch.equal(dst._key_cache.index_select(1, dst_ids).view(
        torch.int16), want.view(torch.int16))


def test_capture_survives_a_dead_graph_in_a_cycle(cuda):
    """A dead engine's graph sits in a reference cycle until the cyclic
    collector runs; collected inside another capture, its destruction
    would invalidate that capture. With the collector at its most eager
    (a collection every allocation), captures after dead graphs hold."""
    import gc

    from paddle_tpu_torch.ops.cuda.graphs import CapturedGraph

    x = torch.zeros(8, device=cuda)
    stream = torch.cuda.Stream(cuda)

    def dead_graph():
        box = {"graph": CapturedGraph(lambda: x.add_(1), stream=stream)}
        box["self"] = box                 # a cycle: only gc frees it

    def busy():                           # allocates many Python objects
        return [x * float(i) for i in range(64)]

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for _ in range(3):
            dead_graph()
            g = CapturedGraph(busy, stream=stream)
            g.replay()
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*threshold)
    assert torch.equal(g.outputs[3], x * 3.0)
