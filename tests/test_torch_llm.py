"""The port's `LLMPredictor` held against the reference's, on the CPU.

Both packages get the same weights (the reference's pytree through
numpy) at `"llama-test"` widths in f32 (GQA: 4 heads over 2 kv heads).
The reference runs with `pallas_ffn=True` (its fused FFN in interpret
mode) and its default `attn_impl`; the port runs with `device="cpu"`,
where every kernel wrapper takes its plain version and each decode
chunk runs eagerly (on the card it replays a CUDA graph:
`tests/test_torch_llm_graph.py`).

Tolerances: logits and scores within rtol 1e-4 of the largest entry
(f32 sums in another order); greedy tokens exactly; masked logits with
the same -inf pattern and kept values within rtol 1e-6. Sampled tokens
cannot match across packages (threefry against Philox), so the masked
logits are compared, captured from the reference by recording what its
`_sample_next` hands to `jax.random.categorical`; a row masked out
entirely (top_p <= 0) gives token 0 in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import llm as JLLM
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import LLMPredictor, init_cache
from paddle_tpu_torch.inference import llm as LLM
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

MAX_LEN = 64
T = 12


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JL.CONFIGS["llama-test"], dtype=jnp.float32)
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=torch.float32)
    assert cfg.num_kv_heads < cfg.num_heads            # GQA
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    ref = JLLM.LLMPredictor(jcfg, jparams, max_len=MAX_LEN, pallas_ffn=True,
                            quant_mode="")
    port = LLMPredictor(cfg, params, max_len=MAX_LEN, device="cpu")
    return jcfg, jparams, cfg, params, ref, port


def _prompt(B=2, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, T)).astype(
        np.int32)


def _close_to_largest(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_forward_cached_prefill_and_decode_step(models):
    jcfg, jparams, cfg, params, _, _ = models
    prompt = _prompt()
    jcache = JLLM.init_cache(jcfg, 2, MAX_LEN)
    jlog, jcache = JLLM._forward_cached(jparams, jnp.asarray(prompt), jcache,
                                        jnp.int32(0), jcfg, "auto", "pallas")
    cache = init_cache(cfg, 2, MAX_LEN, device="cpu")
    pos = torch.zeros((), dtype=torch.long)
    log, cache = LLM._forward_cached(params, torch.from_numpy(prompt).long(),
                                     cache, pos, cfg)
    _close_to_largest(log, jlog)
    _close_to_largest(cache["k"], jcache["k"])
    nxt = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    jlog2, jcache = JLLM._forward_cached(jparams, jnp.asarray(nxt), jcache,
                                         jnp.int32(T), jcfg, "xla", "pallas")
    log2, cache = LLM._forward_cached(params, torch.from_numpy(nxt).long(),
                                      cache, pos + T, cfg)
    _close_to_largest(log2, jlog2)
    _close_to_largest(cache["v"], jcache["v"])


def test_cached_attention_gqa_mask(models):
    rs = np.random.RandomState(1)
    q = rs.randn(2, 3, 4, 16).astype(np.float32)
    ck, cv = (rs.randn(2, 20, 2, 16).astype(np.float32) for _ in range(2))
    want = JLLM._cached_attention(*map(jnp.asarray, (q, ck, cv)),
                                  jnp.int32(7))
    got = LLM._cached_attention(*map(torch.from_numpy, (q, ck, cv)),
                                torch.tensor(7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("new", [1, 8, 32, 41])
def test_greedy_tokens_equal_reference(models, new):
    *_, ref, port = models
    prompt = _prompt()
    want = np.asarray(ref.generate(prompt, max_new_tokens=new))
    got = port.generate(prompt, max_new_tokens=new)
    assert got.dtype == torch.int32 and got.shape == (2, T + new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_one_batch_size_held_across_varying_batches(models):
    """The predictor holds the cache of one batch size: a generate at
    another B frees the last one's, and the tokens stay the reference's."""
    *_, ref, port = models
    for B in (1, 3, 2, 3):
        prompt = _prompt(B, seed=B)
        want = np.asarray(ref.generate(prompt, max_new_tokens=2))
        got = port.generate(prompt, max_new_tokens=2)
        np.testing.assert_array_equal(got.numpy(), want)
        assert list(port._slots) == [B]
        assert port._slots[B].cache["k"].shape[1] == B


def test_eos_early_stop_and_padding(models):
    *_, ref, port = models
    prompt = _prompt(B=1, seed=2)
    free = port.generate(prompt, max_new_tokens=41).numpy()
    eos = int(free[0, T + 3])              # emitted in the first chunk
    want = np.asarray(ref.generate(prompt, max_new_tokens=41,
                                   eos_token_id=eos))
    got = port.generate(prompt, max_new_tokens=41, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    stop = T + list(free[0, T:]).index(eos)
    assert (got[0, stop:] == eos).all() and got.shape == (1, T + 41)
    # two rows, one never emits the eos: no early stop, the other padded
    two = np.concatenate([prompt, _prompt(B=1, seed=5)])
    np.testing.assert_array_equal(
        port.generate(two, max_new_tokens=41, eos_token_id=eos).numpy(),
        np.asarray(ref.generate(two, max_new_tokens=41, eos_token_id=eos)))


def test_return_scores_match_reference(models):
    *_, ref, port = models
    prompt = _prompt()
    jt, js = ref.generate(prompt, max_new_tokens=6, return_scores=True)
    t, s = port.generate(prompt, max_new_tokens=6, return_scores=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert s.shape == (2, 6, 256)
    _close_to_largest(s, js)
    eos = int(t[0, T + 2])
    jt, js = ref.generate(prompt[:1], max_new_tokens=6, eos_token_id=eos,
                          return_scores=True)
    t, s = port.generate(prompt[:1], max_new_tokens=6, eos_token_id=eos,
                         return_scores=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert s.shape == js.shape == (1, 3, 256)
    _close_to_largest(s, js)


def test_w8_greedy_tokens_equal_reference(models):
    jcfg, jparams, cfg, params, _, _ = models
    ref = JLLM.LLMPredictor(jcfg, jparams, max_len=MAX_LEN, pallas_ffn=True,
                            quant_mode="w8")
    port = LLMPredictor(cfg, params, max_len=MAX_LEN, quant_mode="w8",
                        device="cpu")
    assert port.params["blocks"]["w1_q"].dtype == torch.int8
    prompt = _prompt()
    np.testing.assert_array_equal(
        port.generate(prompt, max_new_tokens=9).numpy(),
        np.asarray(ref.generate(prompt, max_new_tokens=9)))


@pytest.mark.parametrize("top_p", [None, 0.9, 0.0])
@pytest.mark.parametrize("top_k", [0, 5])
def test_masked_logits_equal_reference(monkeypatch, top_k, top_p):
    logits = np.random.RandomState(3).randn(4, 256).astype(np.float32) * 3
    seen = []

    def record(key, logits, axis=-1):
        seen.append(np.asarray(logits))
        return jnp.zeros(logits.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", record)
    tp = None if top_p is None else jnp.float32(top_p)
    JLLM._sample_next(jnp.asarray(logits), jax.random.PRNGKey(0),
                      jnp.float32(0.7), tp, top_k)
    want = seen[0]
    got = LLM._mask_logits(torch.from_numpy(logits), torch.tensor(0.7),
                           None if top_p is None else torch.tensor(top_p),
                           top_k).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    kept = np.isfinite(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6)
    if top_p == 0.0:
        assert not kept.any()
    elif top_k:
        assert (kept.sum(-1) <= top_k).all()


def test_top_p_zero_draws_token_zero_in_both(models):
    *_, ref, port = models
    prompt = _prompt()
    for top_p in (0.0, -1.0):
        want = np.asarray(ref.generate(prompt, max_new_tokens=9,
                                       temperature=1.0, top_p=top_p))
        got = port.generate(prompt, max_new_tokens=9, temperature=1.0,
                            top_p=top_p).numpy()
        assert (want[:, T:] == 0).all() and (got[:, T:] == 0).all()
    logits = torch.randn(3, 256)
    gen = torch.Generator().manual_seed(0)
    assert LLM._sample_next(logits, gen, 1.0, 0.0, 0).tolist() == [0, 0, 0]


def test_sampling_seeded_and_generate_conventions(models):
    *_, ref, port = models
    prompt = _prompt()
    kw = dict(max_new_tokens=10, temperature=0.8, top_k=20, top_p=0.9)
    first = port.generate(prompt, seed=7, **kw)
    assert torch.equal(port.generate(prompt, seed=7, **kw), first)
    assert not torch.equal(port.generate(prompt, seed=8, **kw), first)
    greedy = port.generate(prompt, max_new_tokens=10)
    # top_k / top_p without a temperature imply temperature 1.0 (sampling)
    assert (port.generate(prompt, max_new_tokens=10, top_p=0.0)[:, T:]
            == 0).all()
    # temperature <= 0 is greedy, whatever top_k / top_p say
    for t in (0.0, -1.0):
        assert torch.equal(port.generate(prompt, max_new_tokens=10,
                                         temperature=t, top_p=0.0,
                                         top_k=3), greedy)
    with pytest.raises(ValueError, match="exceeds max_len"):
        port.generate(prompt, max_new_tokens=MAX_LEN - T + 1)
    with pytest.raises(ValueError, match="exceeds max_len"):
        ref.generate(prompt, max_new_tokens=MAX_LEN - T + 1)
    with pytest.raises(NotImplementedError, match="return_scores"):
        port.generate(prompt, return_scores=True, temperature=0.8)


def test_constructor_quant_modes_weight_dtype_and_device(models, monkeypatch):
    _, _, cfg, params, _, _ = models
    with pytest.raises(ValueError, match="calibrate"):   # no manifest
        LLMPredictor(cfg, params, quant_mode="w8a8", device="cpu")
    f8 = LLMPredictor(cfg, params, weight_dtype=torch.bfloat16,
                      quant_mode="fp8", device="cpu")
    assert f8.params["blocks"]["wq_q"].dtype == torch.float8_e4m3fn
    assert f8.params["blocks"]["wq_s"].dtype == torch.float32
    with pytest.raises(ValueError, match="quant mode"):
        LLMPredictor(cfg, params, quant_mode="int4", device="cpu")
    half = LLMPredictor(cfg, params, weight_dtype=torch.bfloat16,
                        device="cpu")
    assert half.params["blocks"]["wq"].dtype == torch.bfloat16
    assert half.generate(_prompt(), max_new_tokens=3).shape == (2, T + 3)
    w8 = LLMPredictor(cfg, params, weight_dtype=torch.bfloat16,
                      quant_mode="w8", device="cpu")
    assert w8.params["blocks"]["wq_s"].dtype == torch.float32
    assert w8.params["embed"].dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMPredictor(cfg, params)
