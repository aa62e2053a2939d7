"""The port's quantized serving (`quant_mode="w8"`, `quant_kv=True`) held
against the reference engine.

Both engines get the same weights (the reference's tiny f32 model
through numpy) and one calibration manifest, computed by the reference
and read by the port from the same file. The reference runs its kernel
path (`pallas=True, pallas_ffn=True`: paged attention on int8 pages and
the w8 fused FFN, Pallas in interpret mode); the port runs on the CPU,
where each kernel wrapper takes its plain version. Greedy token streams
must be identical through chunked prefill of a long prompt, a forced
preemption and a prefix hit; the int8 pages the two engines leave
behind must be equal entry for entry. Within the port, a preempted
sequence's recompute must reproduce an unpreempted run bit for bit, a
copy-on-write page must take its dequant-scale rows along, and the page
bytes must count the scale rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import quant as JQ
from paddle_tpu.inference.serving import PagedServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference.serving import PagedServingEngine
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

DIMS = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=96)
QUANT = dict(quant_mode="w8", quant_kv=True)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    jcfg = JL.LlamaConfig(**DIMS, dtype=jnp.float32)
    cfg = L.LlamaConfig(**DIMS, dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    rs = np.random.RandomState(7)
    batches = [rs.randint(1, DIMS["vocab_size"], (2, 12)) for _ in range(2)]
    path = str(tmp_path_factory.mktemp("quant") / "manifest.json")
    JQ.save_manifest(JQ.calibrate(jcfg, jparams, batches), path)
    return jcfg, jparams, cfg, params, path


def _prompts():
    rs = np.random.RandomState(5)
    long = rs.randint(1, 97, 40).tolist()          # > token_budget: chunked
    return [long, rs.randint(1, 97, 14).tolist(),
            rs.randint(1, 97, 9).tolist(),
            long[:24] + rs.randint(1, 97, 5).tolist()]   # prefix of `long`


def _drive(eng, prompts, new=12):
    rids = [eng.submit(p, max_new_tokens=new, priority=i)
            for i, p in enumerate(prompts)]
    done = {c.rid: c.output_tokens for c in eng.run()}
    return [done[r] for r in rids]


def test_quantized_streams_and_pages_match_reference(tiny):
    jcfg, jparams, cfg, params, path = tiny
    geom = dict(num_blocks=11, block_size=8, max_batch=4, token_budget=16)
    prompts = _prompts()
    port = PagedServingEngine(cfg, params, device="cpu", quant_manifest=path,
                              **QUANT, **geom)
    ref = JEngine(jcfg, jparams, quant_manifest=path, pallas=True,
                  pallas_ffn=True, **QUANT, **geom)
    assert _drive(port, prompts) == _drive(ref, prompts)
    assert np.array_equal(port._key_cache.numpy(), np.asarray(ref._key_cache))
    assert np.array_equal(port._value_cache.numpy(),
                          np.asarray(ref._value_cache))
    stats = port.engine_stats
    assert stats["preemptions"] >= 1
    assert stats["prefix_hit_tokens"] > 0
    assert stats["mixed_steps"] > 0 and stats["decode_fast_steps"] > 0
    assert port._key_cache.dtype == torch.int8
    assert port.params["blocks"]["w1_q"].dtype == torch.int8


def test_preemption_recompute_is_bit_exact(tiny):
    """A preempted sequence re-prefilled from its tokens writes the same
    int8 pages (static per-token quantization), so its tokens equal an
    ample pool's."""
    cfg, params, path = tiny[2:]
    prompts = _prompts()[:3]

    def run(num_blocks):
        eng = PagedServingEngine(cfg, params, device="cpu",
                                 quant_manifest=path, num_blocks=num_blocks,
                                 block_size=8, max_batch=4, token_budget=16,
                                 **QUANT)
        return _drive(eng, prompts), eng

    ample, eng_ample = run(40)
    tight, eng_tight = run(9)
    assert eng_ample.engine_stats["preemptions"] == 0
    assert eng_tight.engine_stats["preemptions"] >= 1
    assert tight == ample


def test_prefix_hit_with_cow_matches_reference(tiny):
    """A 10-token prompt is two full pages and a partial one: served
    again, it hits both full pages and copies the partial page on write,
    in both engines alike."""
    jcfg, jparams, cfg, params, path = tiny
    geom = dict(num_blocks=32, block_size=4, max_batch=2, token_budget=16)
    base = np.random.RandomState(51).randint(0, 97, 10).tolist()
    port = PagedServingEngine(cfg, params, device="cpu", quant_manifest=path,
                              **QUANT, **geom)
    ref = JEngine(jcfg, jparams, quant_manifest=path, pallas=True,
                  pallas_ffn=True, **QUANT, **geom)
    ours = [_drive(port, [base], new=4) for _ in range(2)]
    theirs = [_drive(ref, [base], new=4) for _ in range(2)]
    assert ours == theirs and ours[0] == ours[1]
    stats = port.engine_stats
    assert stats["blocks_prefix_hit_tokens"] > 0
    assert stats["blocks_cow_copies"] > 0 and stats["cow_block_copies"] > 0
    assert np.array_equal(port._key_cache.numpy(), np.asarray(ref._key_cache))


def test_cow_moves_scale_rows_and_page_bytes_count_them(tiny):
    cfg, params, path = tiny[2:]
    eng = PagedServingEngine(cfg, params, device="cpu", quant_manifest=path,
                             num_blocks=8, block_size=4, max_len=32,
                             **QUANT)
    L_, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    assert eng.kv_page_bytes == 2 * L_ * KV * 4 * hd + 2 * L_ * KV * 4
    assert eng.blocks.bytes_total() == 8 * eng.kv_page_bytes
    kdq, vdq = eng._kv_dequant
    assert kdq.shape == (L_, 8, KV) and kdq.dtype == torch.float32
    # give every page its own scale rows and contents, then copy 2 -> 5
    for t in (kdq, vdq):
        t.copy_(torch.arange(t.numel(), dtype=torch.float32).view(t.shape))
    eng._key_cache.copy_(torch.randint(-127, 128, eng._key_cache.shape,
                                       dtype=torch.int8))
    eng._copy_blocks([(2, 5)])
    for t in (kdq, vdq, eng._key_cache, eng._value_cache):
        assert torch.equal(t[:, 5], t[:, 2])
    assert not torch.equal(kdq[:, 4], kdq[:, 2])     # other rows untouched
