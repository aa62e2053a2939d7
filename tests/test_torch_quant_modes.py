"""The port's `w8a8` and `fp8` quant modes held against the reference's.

Both packages get the same weights (`"llama-test"` in f32, seeded, the
reference's through numpy) and one calibration manifest, computed by
the port (`tests/test_torch_quant.py` holds its scales to the
reference's) and read by both from the same file. The reference runs
on the CPU as `tests/test_quant_inference.py` runs it: its engine and
predictor take their stock paths there, so the FFN of both modes is the
plain chain of `matmul_param` products, as in the port (no kernel
serves w8a8 or fp8 leaves; `params_kind` is None for them).

- the quantized leaves: int8 and float8_e4m3fn bytes, `_s` and `_a`
  scales exactly equal to the reference's, and kept through
  `params_from_numpy`;
- `matmul_param` per mode and weight name within rtol 1e-6 (the int8
  activations equal exactly: both divide, scale and round in f32);
- the predictor's greedy tokens equal, scores within 1e-4 of the
  largest;
- the paged engine's greedy streams equal through chunked prefill, a
  prefix hit and a starved pool (`w8a8` + int8 KV pages, `fp8` + fp
  pages), and, within the port, a preempted sequence's recompute equal
  to an ample pool's run bit for bit; a draft of the quantized target's
  leaves, a router through a replica kill and a disagg fleet keep the
  single engine's streams;
- on the card (`gpu`): `torch._int_mm`'s zero-padded rows give the
  unpadded rows' sums, and rows inside a larger call the same sums.

The reference is imported inside the fixtures, so the `gpu` case also
collects on a machine without jax.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import LLMPredictor
from paddle_tpu_torch.inference import quant as Q
from paddle_tpu_torch.inference.serving import PagedServingEngine
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from torch_threads import one_torch_thread

one_torch_thread()

MODES = ("w8a8", "fp8")
ENGINE_MODES = {"w8a8": dict(quant_mode="w8a8", quant_kv=True),
                "fp8": dict(quant_mode="fp8", quant_kv=False)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.inference import quant as JQ
    from paddle_tpu.models import llama as JL

    jcfg = dataclasses.replace(JL.CONFIGS["llama-test"], dtype=jnp.float32)
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    rs = np.random.RandomState(7)
    batches = [rs.randint(1, cfg.vocab_size, (2, 12)) for _ in range(2)]
    path = str(tmp_path_factory.mktemp("quant") / "manifest.json")
    Q.save_manifest(Q.calibrate(cfg, params, batches), path)
    JQ.load_manifest(path).validate_for(jcfg)
    return jcfg, jparams, cfg, params, path


@pytest.fixture(scope="module")
def quantized(models):
    """mode -> (the port's quantized params, the reference's)."""
    from paddle_tpu.inference import quant as JQ

    jcfg, jparams, cfg, params, path = models
    return {mode: (Q.quantize_llama_params(params, mode,
                                           Q.load_manifest(path)),
                   JQ.quantize_llama_params(jparams, mode,
                                            JQ.load_manifest(path)))
            for mode in MODES}


def _bytes(t):
    """A leaf's entries as numpy, float8 as its raw bytes."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
                else t).numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


@pytest.mark.parametrize("mode", MODES)
def test_leaves_equal_reference(models, quantized, mode):
    ours, ref = quantized[mode]
    assert set(ours) == set(ref)
    assert set(ours["blocks"]) == set(ref["blocks"])
    pairs = [(ours["blocks"][k], ref["blocks"][k], k) for k in ref["blocks"]]
    pairs += [(ours[k], ref[k], k) for k in ref if k.startswith("lm_head")]
    for got, want, name in pairs:
        got, want = _bytes(got), _bytes(want)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert np.array_equal(got, want), f"{name}: entries differ"
    qtype = torch.int8 if mode == "w8a8" else torch.float8_e4m3fn
    for n in Q.WEIGHT_NAMES:
        assert ours["blocks"][n + "_q"].dtype == qtype
        assert ours["blocks"][n + "_s"].dtype == torch.float32
        assert ((n + "_a") in ours["blocks"]) == (mode == "w8a8")
    if mode == "w8a8":
        assert ours["blocks"]["wq_a"].shape == (models[2].num_layers,)
        assert ours["lm_head_a"].shape == ()
    # the reference's quantized tree carried over keeps its leaves' types
    import jax
    moved = L.params_from_numpy(jax.tree.map(np.asarray, ref), device="cpu",
                                dtype=torch.bfloat16)
    for k, want in ref["blocks"].items():
        if k.endswith(("_q", "_s", "_a")):
            assert np.array_equal(_bytes(moved["blocks"][k]), _bytes(want))
    assert moved["blocks"]["attn_norm"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", Q.WEIGHT_NAMES + ("lm_head",))
@pytest.mark.parametrize("mode", MODES)
def test_matmul_param_matches_reference(quantized, mode, name):
    import jax.numpy as jnp

    from paddle_tpu.inference import quant as JQ

    ours, ref = quantized[mode]
    if name != "lm_head":      # one layer's slice, as the engines take it
        ours = L.layer(ours, 1)
        ref = {k: v[1] for k, v in ref["blocks"].items()}
    d_in = ours[name + "_q"].shape[0]
    h = (np.random.RandomState(3).randn(5, d_in) * 2.0).astype(np.float32)
    got = Q.matmul_param(torch.from_numpy(h), ours, name)
    want = JQ.matmul_param(jnp.asarray(h), ref, name)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if mode == "w8a8":         # the same int8 activations, entry for entry
        a = ours[name + "_a"]
        xq = torch.clamp(torch.round(torch.from_numpy(h) / a * Q.QMAX),
                         -Q.QMAX, Q.QMAX).to(torch.int8)
        jxq = jnp.clip(jnp.round(jnp.asarray(h) / ref[name + "_a"]
                                 * Q.QMAX), -Q.QMAX, Q.QMAX).astype(jnp.int8)
        assert np.array_equal(xq.numpy(), np.asarray(jxq))


@pytest.mark.parametrize("mode", MODES)
def test_ffn_takes_the_plain_chain(models, quantized, mode):
    """No kernel serves w8a8 or fp8 leaves: `params_kind` is None, and
    `ffn_param` is the reference's chain of `matmul_param` products."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.inference import quant as JQ

    from paddle_tpu.ops.pallas import fused_ffn as JFF

    ours, ref = quantized[mode]
    lp = L.layer(ours, 0)
    jlp = {k: v[0] for k, v in ref["blocks"].items()}
    assert FF.params_kind(lp) is None
    # the reference's gate checks the leaves' names only: its fp8 leaves
    # pass as "w8", so `pallas_ffn=True` would hand float8 weights to its
    # int8 kernel (ROADMAP Queue C); the port's requires int8
    assert JFF.params_kind(jlp) == ("w8" if mode == "fp8" else None)
    assert FF.params_kind(L.layer(Q.quantize_llama_params(models[3], "w8"),
                                  0)) == "w8"
    with pytest.raises(ValueError, match="fp or weight-only int8"):
        FF.apply_ffn(torch.zeros(2, models[2].hidden_size), lp)
    h = np.random.RandomState(4).randn(6, models[2].hidden_size).astype(
        np.float32)
    got = Q.ffn_param(torch.from_numpy(h), lp)
    jh = jnp.asarray(h)
    want = JQ.matmul_param(jax.nn.silu(JQ.matmul_param(jh, jlp, "w1"))
                           * JQ.matmul_param(jh, jlp, "w3"), jlp, "w2")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("mode", MODES)
def test_predictor_greedy_matches_reference(models, mode):
    import jax.numpy as jnp

    from paddle_tpu.inference.llm import LLMPredictor as JPredictor

    jcfg, jparams, cfg, params, path = models
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                            (2, 12)).astype(np.int32)
    ref = JPredictor(jcfg, jparams, max_len=64, quant_mode=mode,
                     quant_manifest=path)
    jseq, jsc = ref.generate(jnp.asarray(toks), max_new_tokens=6,
                             return_scores=True)
    port = LLMPredictor(cfg, params, max_len=64, quant_mode=mode,
                        quant_manifest=path, device="cpu")
    seq, sc = port.generate(toks, max_new_tokens=6, return_scores=True)
    assert np.array_equal(seq.numpy(), np.asarray(jseq))
    jsc = np.asarray(jsc)
    np.testing.assert_allclose(sc.numpy(), jsc, rtol=1e-4,
                               atol=1e-4 * np.abs(jsc).max())
    assert np.array_equal(port.generate(toks, max_new_tokens=6).numpy(),
                          np.asarray(jseq))


def _prompts(vocab):
    rs = np.random.RandomState(5)
    long = rs.randint(1, vocab, 40).tolist()       # > token_budget: chunked
    return [long, rs.randint(1, vocab, 14).tolist(),
            rs.randint(1, vocab, 9).tolist(),
            long[:24] + rs.randint(1, vocab, 5).tolist()]   # prefix of long


def _drive(eng, prompts, new=12):
    rids = [eng.submit(p, max_new_tokens=new, priority=i)
            for i, p in enumerate(prompts)]
    done = {c.rid: c.output_tokens for c in eng.run()}
    return [done[r] for r in rids]


@pytest.mark.parametrize("mode", MODES)
def test_engine_greedy_streams_match_reference(models, mode):
    from paddle_tpu.inference.serving import PagedServingEngine as JEngine

    jcfg, jparams, cfg, params, path = models
    geom = dict(num_blocks=11, block_size=8, max_batch=4, token_budget=16)
    prompts = _prompts(cfg.vocab_size)
    port = PagedServingEngine(cfg, params, device="cpu", quant_manifest=path,
                              **ENGINE_MODES[mode], **geom)
    ref = JEngine(jcfg, jparams, quant_manifest=path, **ENGINE_MODES[mode],
                  **geom)
    assert _drive(port, prompts) == _drive(ref, prompts)
    stats = port.engine_stats
    assert stats["preemptions"] >= 1
    assert stats["prefix_hit_tokens"] > 0
    assert stats["mixed_steps"] > 0 and stats["decode_fast_steps"] > 0
    want = torch.int8 if mode == "w8a8" else torch.float32
    assert port._key_cache.dtype == want
    if mode == "w8a8":         # int8 pages written from equal k and v
        assert np.array_equal(port._key_cache.numpy(),
                              np.asarray(ref._key_cache))
        assert np.array_equal(port._value_cache.numpy(),
                              np.asarray(ref._value_cache))


@pytest.mark.parametrize("mode", MODES)
def test_preemption_recompute_is_bit_exact(models, mode):
    cfg, params, path = models[2:]
    prompts = _prompts(cfg.vocab_size)[:3]

    def run(num_blocks):
        eng = PagedServingEngine(cfg, params, device="cpu",
                                 quant_manifest=path, num_blocks=num_blocks,
                                 block_size=8, max_batch=4, token_budget=16,
                                 **ENGINE_MODES[mode])
        return _drive(eng, prompts), eng.engine_stats["preemptions"]

    ample, n_ample = run(40)
    tight, n_tight = run(9)
    assert n_ample == 0 and n_tight >= 1
    assert tight == ample


@pytest.mark.parametrize("mode", MODES)
def test_draft_router_and_disagg_serve_the_mode(models, mode):
    """The fleet passes the mode through: a draft made of the quantized
    target's first layers (its leaves, shared) keeps the plain greedy
    streams; a router through a replica kill and a disagg fleet of
    quantized engines give one engine's streams."""
    from paddle_tpu_torch.distributed.fault_tolerance import chaos
    from paddle_tpu_torch.inference.serving import (DisaggRouter,
                                                    DraftModel,
                                                    ServingRouter)

    cfg, params, path = models[2:]
    geom = dict(num_blocks=40, block_size=8, max_batch=4, token_budget=16,
                device="cpu", quant_manifest=path, **ENGINE_MODES[mode])

    def factory():
        return PagedServingEngine(cfg, params, **geom)

    prompts = _prompts(cfg.vocab_size)[1:]
    plain = factory()
    want = _drive(plain, prompts)
    dcfg = dataclasses.replace(cfg, num_layers=2)
    q = plain.params
    dparams = {k: v for k, v in q.items() if k != "blocks"}
    dparams["blocks"] = {k: v[:2] for k, v in q["blocks"].items()}
    spec = PagedServingEngine(cfg, params, draft=DraftModel(dcfg, dparams),
                              spec_k=3, **geom)
    assert _drive(spec, prompts) == want
    assert spec.stats["spec_ticks"] > 0
    try:
        chaos.reconfigure("replica:kill@victim=0;call=3")
        router = ServingRouter(factory, num_replicas=2, probation_s=1e9)
        rids = [router.submit(p, max_new_tokens=12) for p in prompts]
        done = {c.rid: c.output_tokens for c in router.run()}
    finally:
        chaos.reconfigure("")
    assert [done[r] for r in rids] == want
    assert router.stats["failovers"] >= 1
    fleet = DisaggRouter(factory, pools="prefill=1,decode=1")
    rids = [fleet.submit(p, max_new_tokens=12) for p in prompts]
    done = {c.rid: c.output_tokens for c in fleet.run()}
    assert [done[r] for r in rids] == want
    assert fleet.disagg_stats["handoffs_ok"] >= 1


@pytest.mark.gpu
def test_int_mm_padded_rows_equal_unpadded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm's row limit is the "
                    "card's")
    g = torch.Generator().manual_seed(0)
    K, N = 4096, 11008
    x = torch.randint(-127, 128, (64, K), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (K, N), dtype=torch.int8, generator=g)
    wd = w.cuda().t().contiguous().t()          # the w8a8 leaves' layout
    full = Q.int8_matmul(x.cuda(), wd)
    assert torch.equal(full.cpu(), torch._int_mm(x, w))     # exact sums
    for R in (1, 8, 16, 17):                    # padded below 17 rows
        assert torch.equal(Q.int8_matmul(x[:R].cuda(), wd), full[:R])
    assert torch.equal(Q.int8_matmul(x[:8].reshape(2, 4, K).cuda(), wd),
                       full[:8].reshape(2, 4, N))
