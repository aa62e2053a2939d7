"""The port's speculative decoding held against the reference's.

Both packages serve a tiny f32 LLaMA from the same weights, with a
one-layer draft that shares the target's first layer, `spec_k` 3; the
port runs on the CPU (plain versions of its kernels), the reference on
its stock path. On one trace that holds an EOS stop, prompts sharing a
prefix (copy-on-write pages, mirrored into the draft's caches) and a
block pool small enough to preempt (the draft catches up on recompute):

- the port's speculative streams equal the reference's speculative
  streams and the port's plain greedy streams, token for token;
- the draft's proposed and accepted counts, and the speculative ticks,
  equal the reference's;
- sampled requests are not speculated; a draft that is the target is
  always accepted; a draft of another vocabulary or a shorter context
  is refused; speculation composes with an adapter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import DraftModel as JDraft
from paddle_tpu.inference.serving import PagedServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference.serving import (DraftModel,
                                                PagedServingEngine,
                                                make_adapter)
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

DIMS = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=96)
# 10 blocks of 8 for 6 sequences of up to 37 tokens: preemptions
GEOM = dict(num_blocks=10, block_size=8, max_batch=8, token_budget=32)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.LlamaConfig(**DIMS, dtype=jnp.float32)
    cfg = L.LlamaConfig(**DIMS, dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jcfg, jparams, cfg, params


def _draft_cfg(mod, dtype, **over):
    return mod.LlamaConfig(**dict(DIMS, num_layers=1, **over), dtype=dtype)


def _port_draft(cfg, params):
    return DraftModel(_draft_cfg(L, torch.float32),
                      {**params, "blocks": {k: v[:1] for k, v in
                                            params["blocks"].items()}})


def _trace():
    rs = np.random.RandomState(3)
    shared = rs.randint(1, 97, (20,)).tolist()   # 2.5 blocks: a COW copy
    return ([shared + rs.randint(1, 97, (3,)).tolist() for _ in range(3)]
            + [rs.randint(1, 97, (n,)).tolist() for n in (9, 14, 6)])


def _run(eng, prompts, max_new=14, eos=None, **kw):
    rids = [eng.submit(p, max_new_tokens=max_new,
                       eos_token_id=eos if i == 4 else None, **kw)
            for i, p in enumerate(prompts)]
    done = {c.rid: (c.output_tokens, c.finish_reason) for c in eng.run()}
    return [done.get(r) for r in rids]


@pytest.fixture(scope="module")
def runs(tiny):
    jcfg, jparams, cfg, params = tiny
    prompts = _trace()
    free = _run(PagedServingEngine(cfg, params, max_len=96, device="cpu",
                                   **GEOM), prompts)
    eos = free[4][0][5]                # a token request 4 really emits
    plain_eng = PagedServingEngine(cfg, params, max_len=96, device="cpu",
                                   **GEOM)
    plain = _run(plain_eng, prompts, eos=eos)
    spec_eng = PagedServingEngine(cfg, params, max_len=96, device="cpu",
                                  draft=_port_draft(cfg, params), spec_k=3,
                                  **GEOM)
    spec = _run(spec_eng, prompts, eos=eos)
    jd = JDraft(_draft_cfg(JL, jnp.float32),
                {**{k: v for k, v in jparams.items() if k != "blocks"},
                 "blocks": jax.tree.map(lambda a: a[:1],
                                        jparams["blocks"])})
    ref_eng = JEngine(jcfg, jparams, max_len=96, draft=jd, spec_k=3,
                      **GEOM)
    ref = _run(ref_eng, prompts, eos=eos)
    return dict(plain=plain, spec=spec, ref=ref, spec_eng=spec_eng,
                ref_eng=ref_eng, plain_eng=plain_eng)


def test_spec_streams_equal_reference_spec_engine(runs):
    assert runs["spec"] == runs["ref"]


def test_spec_streams_equal_plain_greedy(runs):
    assert runs["spec"] == runs["plain"]
    reasons = [r for _, r in runs["spec"]]
    assert reasons[4] == "stop" and reasons.count("length") == 5
    eng = runs["spec_eng"]
    assert eng.scheduler.stats["preemptions"] >= 1
    assert eng.scheduler.stats["prefix_hit_tokens"] > 0
    assert eng.stats["cow_block_copies"] > 0


def test_proposed_and_accepted_equal_reference(runs):
    ours, ref = runs["spec_eng"], runs["ref_eng"]
    keys = ("spec_ticks", "spec_proposed", "spec_accepted")
    assert {k: ours.stats[k] for k in keys} == \
        {k: ref.stats[k] for k in keys}
    assert ours.stats["spec_ticks"] > 0
    assert 0.0 < ours.spec.acceptance_rate < 1.0
    s = ours.spec.stats
    assert s["bonus"] == s["ticks"] == ours.stats["spec_ticks"]
    assert ours.engine_stats["spec_acceptance_rate"] == \
        ours.spec.acceptance_rate


def test_sampled_requests_not_speculated(tiny):
    _, _, cfg, params = tiny
    eng = PagedServingEngine(cfg, params, max_len=96, device="cpu",
                             draft=_port_draft(cfg, params), spec_k=3,
                             num_blocks=96, block_size=8, max_batch=8,
                             token_budget=32)
    out = _run(eng, _trace()[:2], max_new=6, temperature=0.8, seed=11)
    assert all(len(o) == 6 for o, _ in out)
    assert eng.stats["spec_ticks"] == 0


def test_target_as_draft_always_accepted(tiny):
    _, _, cfg, params = tiny
    geom = dict(num_blocks=96, block_size=8, max_batch=8, token_budget=32)
    prompts = _trace()[3:5]
    base = _run(PagedServingEngine(cfg, params, max_len=96, device="cpu",
                                   **geom), prompts, max_new=9)
    eng = PagedServingEngine(cfg, params, max_len=96, device="cpu",
                             draft=DraftModel(cfg, params), spec_k=3, **geom)
    assert _run(eng, prompts, max_new=9) == base
    assert eng.spec.acceptance_rate == 1.0


def test_draft_validation_fails_loud(tiny):
    _, _, cfg, params = tiny
    g = torch.Generator().manual_seed(1)
    for over, match in ((dict(vocab_size=101), "vocab"),
                        (dict(max_seq_len=32), "max_seq_len")):
        dcfg = _draft_cfg(L, torch.float32, **over)
        with pytest.raises(ValueError, match=match):
            PagedServingEngine(cfg, params, max_len=96, device="cpu",
                               draft=DraftModel(dcfg, L.init_params(
                                   dcfg, g, device="cpu")))


def test_spec_composes_with_adapters(tiny):
    _, _, cfg, params = tiny
    geom = dict(num_blocks=96, block_size=8, max_batch=8, token_budget=32)
    ad = make_adapter(cfg, "t-a", rank=4, seed=3, scale=0.3)
    prompts = _trace()[3:5]

    def serve(spec):
        kw = dict(draft=_port_draft(cfg, params), spec_k=3) if spec else {}
        eng = PagedServingEngine(cfg, params, max_len=96, device="cpu",
                                 adapter_slots=2, **geom, **kw)
        eng.adapters.register(ad)
        rids = [eng.submit(p, max_new_tokens=8,
                           **({"adapter": "t-a"} if i == 0 else {}))
                for i, p in enumerate(prompts)]
        done = {c.rid: c.output_tokens for c in eng.run()}
        return [done[r] for r in rids], eng

    ref, _ = serve(False)
    got, eng = serve(True)
    assert got == ref
    assert eng.stats["spec_ticks"] > 0
