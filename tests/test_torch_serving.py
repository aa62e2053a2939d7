"""The port's paged serving engine held against the reference engine.

Both engines serve the same requests from the same weights (the
reference's pytree through numpy) on a tiny f32 config. The reference
runs its fused-tick path (`pallas=True, pallas_ffn=True`, Pallas in
interpret mode); the port runs on the CPU, where each kernel wrapper
takes its plain version. Greedy token streams must be identical through
chunked prefill of a long prompt, a forced preemption (a small block
pool), a prefix-cache hit and an EOS stop.

Sampled tokens cannot match across packages (threefry against Philox);
within the port the same seed must give the same stream. The two
BlockManager copies must agree on tables and stats for one operation
sequence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import BlockManager as JBlockManager
from paddle_tpu.inference.serving import PagedServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference.serving import BlockManager, PagedServingEngine
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

GEOM = dict(num_blocks=11, block_size=8, max_batch=4, token_budget=16)


@pytest.fixture(scope="module")
def tiny():
    dims = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=96)
    jcfg = JL.LlamaConfig(**dims, dtype=jnp.float32)
    cfg = L.LlamaConfig(**dims, dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jcfg, jparams, cfg, params


def _prompts():
    rs = np.random.RandomState(5)
    long = rs.randint(1, 97, 40).tolist()          # > token_budget: chunked
    return [long, rs.randint(1, 97, 14).tolist(),
            rs.randint(1, 97, 9).tolist(),
            long[:24] + rs.randint(1, 97, 5).tolist()]   # prefix of `long`


def _drive(eng, prompts, eos=None, **kw):
    rids = [eng.submit(p, max_new_tokens=12, priority=i,
                       eos_token_id=eos if i == 2 else None, **kw)
            for i, p in enumerate(prompts)]
    done = {c.rid: (c.output_tokens, c.finish_reason) for c in eng.run()}
    return [done[r] for r in rids]


def test_greedy_streams_match_reference_engine(tiny):
    jcfg, jparams, cfg, params = tiny
    prompts = _prompts()
    # pick an EOS the third request really emits, from a port run
    free = _drive(PagedServingEngine(cfg, params, device="cpu", **GEOM),
                  prompts)
    eos = free[2][0][2]
    port = PagedServingEngine(cfg, params, device="cpu", **GEOM)
    ours = _drive(port, prompts, eos=eos)
    ref = _drive(JEngine(jcfg, jparams, pallas=True, pallas_ffn=True,
                         **GEOM), prompts, eos=eos)
    assert ours == ref
    stats = port.engine_stats
    assert ours[2] == (free[2][0][:2], "stop")
    assert stats["preemptions"] >= 1
    assert stats["prefix_hit_tokens"] > 0
    assert stats["mixed_steps"] > 0 and stats["decode_fast_steps"] > 0


def test_same_seed_same_sampled_stream(tiny):
    _, _, cfg, params = tiny
    prompts = _prompts()

    def sampled(seed):
        eng = PagedServingEngine(cfg, params, device="cpu", top_k=20,
                                 **GEOM)
        return _drive(eng, prompts, temperature=0.8, top_p=0.9, seed=seed)

    first = sampled(7)
    assert sampled(7) == first
    assert sampled(8) != first
    assert all(len(toks) == 12 for toks, _ in first)


def test_block_manager_copies_agree():
    def ops(bm):
        log = []
        log.append(bm.allocate_sequence(1, list(range(10))))
        bm.ensure_capacity(1, 13)
        bm.register_computed(1, list(range(13)), 13)
        log.append(bm.allocate_sequence(2, list(range(10)) + [60]))
        log.append(bm.allocate_sequence(3, list(range(16))))
        log.append(bm.take_copies())
        log.append([bm.block_table(s) for s in (1, 2, 3)])
        bm.free_sequence(1)
        log.append(bm.allocate_sequence(4, list(range(5)) + [9] * 5))
        bm.free_sequence(3)
        log.append(bm.allocate_sequence(5, [7] * 30))
        log.append([bm.block_table(s) for s in (2, 4, 5)])
        log.append((bm.num_free(), bm.utilization()))
        return log, bm.stats

    ours, our_stats = ops(BlockManager(num_blocks=16, block_size=4))
    ref, ref_stats = ops(JBlockManager(num_blocks=16, block_size=4))
    assert ours == ref
    assert our_stats == {k: v for k, v in ref_stats.items()
                         if k in our_stats}
    assert our_stats["prefix_hit_blocks"] > 0 and our_stats["cow_copies"] > 0


def test_stream_cancel_shed_and_weight_dtype(tiny):
    from paddle_tpu_torch.inference.serving import RejectedError

    _, _, cfg, params = tiny
    prompts = _prompts()
    eng = PagedServingEngine(cfg, params, device="cpu", max_queue=3, **GEOM)
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts[:3]]
    with pytest.raises(RejectedError):
        eng.submit(prompts[3], max_new_tokens=6)   # queue holds 3 already
    assert eng.cancel(rids[1])
    streamed = list(eng.stream(rids[0]))
    done = {c.rid: c for c in eng.run()}
    assert done[rids[1]].finish_reason == "cancelled"
    ref = PagedServingEngine(cfg, params, device="cpu", **GEOM)
    ref_rid = ref.submit(prompts[0], max_new_tokens=6)
    assert streamed == {c.rid: c for c in ref.run()}[ref_rid].output_tokens
    assert eng.engine_stats["shed"] == 1
    # weights may be stored narrower than the compute type
    half = PagedServingEngine(cfg, params, device="cpu",
                              weight_dtype=torch.bfloat16, **GEOM)
    assert half.params["blocks"]["w1"].dtype == torch.bfloat16
    rid = half.submit(prompts[2], max_new_tokens=4)
    assert len({c.rid: c for c in half.run()}[rid].output_tokens) == 4
