"""The port's dense slot engine held against the reference's.

- Greedy streams of `ServingEngine` (a tiny f32 LLaMA, the reference's
  weights through numpy, the port on the CPU) equal the reference
  engine's on one trace with more requests than slots, an eos that
  stops a stream and budgets that end others: the completions' rids,
  tokens and finish reasons, in finish order. The reference engine runs
  once, in a module fixture.
- `max_new_tokens=0` completes at submit, and the submit errors are the
  reference's.
- Each stream equals the port's `LLMPredictor.generate` of its prompt.
- The bench's paged-against-dense sub-config (`bench.py:587-640`: vocab
  256, hidden 64, 24 requests on a 48-token shared prefix, 6 new
  tokens, both engines warmed): the paged engine's streams equal the
  dense engine's.
- The card's `SLOT` witness (`chip_smoke.plain_rows`, a plain f32
  forward) equals the port's `forward`, and `chip_smoke.slot_witness`
  holds the dense and paged engines' rows, read as the card's phase
  reads them, to it: f32 engines within 1e-5 of the largest |logit|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.inference.serving import ServingEngine as JSlot
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import LLMPredictor
from paddle_tpu_torch.inference.serving import (PagedServingEngine,
                                                ServingEngine)
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

DIMS = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=96)
SLOT = dict(num_slots=2, max_len=96, chunk=4)
LENS = (5, 9, 14, 3, 12)
MAX_NEW = (10, 7, 10, 4, 10)
EOS = 43       # a token request 1's greedy stream falls into


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


def _trace():
    """(prompt, max_new_tokens, eos) of each request: request 1 stops at
    EOS, request 3 has no eos, the others carry EOS and end on their
    budgets."""
    rs = np.random.RandomState(3)
    out = []
    for i, (n, new) in enumerate(zip(LENS, MAX_NEW)):
        out.append((rs.randint(0, 97, (n,)).tolist(), new,
                    None if i == 3 else EOS))
    return out


def _serve(eng, trace):
    rids = [eng.submit(p, max_new_tokens=n, eos_token_id=e)
            for p, n, e in trace]
    done = [(c.rid, c.output_tokens, c.finish_reason) for c in eng.run()]
    return rids, done


@pytest.fixture(scope="module")
def ref(tiny):
    """The reference slot engine's completions of the trace."""
    jcfg, jparams, _, _ = tiny
    return _serve(JSlot(jcfg, jparams, **SLOT), _trace())


def test_streams_equal_reference(tiny, ref):
    _, _, cfg, params = tiny
    eng = ServingEngine(cfg, params, device="cpu", **SLOT)
    rids, done = _serve(eng, _trace())
    assert (rids, done) == ref
    reasons = {r: why for r, _, why in done}
    assert reasons[rids[1]] == "stop" and "length" in reasons.values()
    assert eng.stats["admitted"] == eng.stats["completed"] == len(LENS)
    assert eng.stats["decode_steps"] == 4 * eng.stats["decode_chunks"]
    assert eng.stats["graph_captures"] == 0       # eager on the CPU


def test_zero_budget_and_submit_errors(tiny):
    jcfg, jparams, cfg, params = tiny
    eng = ServingEngine(cfg, params, device="cpu", **SLOT)
    rid = eng.submit([1, 2, 3], max_new_tokens=0)
    assert not eng.has_work()
    [c] = eng.run()
    assert (c.rid, c.output_tokens, c.finish_reason) == (rid, [], "length")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(list(range(90)), max_new_tokens=7)
    with pytest.raises(ValueError, match="num_slots"):
        ServingEngine(cfg, params, num_slots=0, device="cpu")
    # the reference refuses the same
    jeng = JSlot(jcfg, jparams, **SLOT)
    with pytest.raises(ValueError, match="exceeds max_len"):
        jeng.submit(list(range(90)), max_new_tokens=7)


def test_streams_equal_predictor(tiny, ref):
    """Every stream is the predictor's greedy output of its prompt: all
    of it on a length finish, up to the eos on a stop."""
    _, _, cfg, params = tiny
    pred = LLMPredictor(cfg, params, max_len=96, device="cpu")
    rids, done = ref
    by_rid = {r: (toks, why) for r, toks, why in done}
    for rid, (prompt, new, eos) in zip(rids, _trace()):
        toks, why = by_rid[rid]
        out = pred.generate(np.asarray([prompt]), max_new_tokens=new)
        want = out[0, len(prompt):].tolist()
        if why == "length":
            assert toks == want
        else:
            assert toks == want[:len(toks)] and want[len(toks)] == eos


def test_paged_equals_dense_on_bench_trace():
    """`bench.py:587-640`'s parity: the paged engine and the dense slot
    engine, both warmed on the trace, give the same greedy streams."""
    cfg = L.LlamaConfig(vocab_size=256, hidden_size=64,
                        intermediate_size=128, num_layers=2, num_heads=4,
                        num_kv_heads=4, max_seq_len=96, dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    n_req, new = 24, 6
    rs = np.random.RandomState(0)
    shared = rs.randint(1, cfg.vocab_size, size=48).tolist()
    prompts = [shared + rs.randint(1, cfg.vocab_size, size=4).tolist()
               for _ in range(n_req)]

    def twice(eng):
        outs = []
        for _ in range(2):                     # warm pass, then the run
            rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
            done = {c.rid: c.output_tokens for c in eng.run()}
            outs.append([done[r] for r in rids])
        assert outs[0] == outs[1]
        return outs[1]

    dense = twice(ServingEngine(cfg, params, num_slots=4, max_len=96,
                                chunk=new, device="cpu"))
    paged_eng = PagedServingEngine(cfg, params, num_blocks=224,
                                   block_size=8, max_batch=n_req,
                                   token_budget=32, max_len=96,
                                   device="cpu")
    paged = twice(paged_eng)
    assert paged == dense
    assert paged_eng.blocks.stats["prefix_hit_tokens"] > 0


def test_slot_witness_holds_both_engines(tiny):
    _, _, cfg, params = tiny
    trace = [(p, {}) for p, _, _ in _trace()[1:3]]
    got = chip_smoke.plain_rows(torch, L, cfg, params, [trace[0][0]], [0],
                                torch.float32)[0]
    want = L.forward(params, torch.tensor([trace[0][0]]), cfg)[0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    engines = {"dense": ServingEngine(cfg, params, device="cpu", **SLOT),
               "paged": PagedServingEngine(cfg, params, device="cpu",
                                           num_blocks=64, block_size=4,
                                           max_batch=2, token_budget=16)}
    streams = {}
    for name, eng in engines.items():
        rids = [eng.submit(p, max_new_tokens=32) for p, _ in trace]
        done = {c.rid: c.output_tokens for c in eng.run()}
        streams[name] = [done[r] for r in rids]
    assert streams["dense"] == streams["paged"]
    rows = {"dense": chip_smoke.slot_rows_dense(torch, engines["dense"],
                                                trace, 31),
            "paged": chip_smoke.slot_rows_paged(engines["paged"], trace, 31)}
    rec = chip_smoke.slot_witness(torch, L, cfg, params, trace, streams,
                                  rows, [None, None])
    for name in ("dense", "paged"):
        assert rec[name]["rows"] == 64
        assert rec[name]["max_relative"] < 1e-5
    assert rec["divergences"] == []
