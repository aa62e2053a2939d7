"""The port's quantization package (`paddle_tpu_torch.inference.quant`)
held against the reference's (`paddle_tpu.inference.quant`).

Both packages get the same weights (the reference's tiny f32 model
through numpy) and the same seeded token batches:

- the manifest file format is shared: a file saved by either package
  loads in the other with equal scales; a hand-edited file fails its
  CRC and a manifest of another model is refused;
- `quantize_llama_params("w8")`: int8 weights and f32 scales equal to
  the reference's, exactly (both round half to even in f32);
- `calibrate`: activation and KV scales within rtol 1e-5 (f32 forwards
  in another summation order);
- `matmul_param` on w8 leaves within rtol 1e-6 of the reference's;
- the error paths: unknown modes, `w8a8` without a manifest (the
  reference's ValueError), `quant_kv` without a manifest, a cache_dtype that conflicts with int8 pages, partial
  cache scales, dynamic cache scales, fp caches with scales.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import quant as JQ
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import quant as Q
from paddle_tpu_torch.inference.serving import PagedServingEngine
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops.kernels import serving_attention as SA
from torch_threads import one_torch_thread

one_torch_thread()

DIMS = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=96)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.LlamaConfig(**DIMS, dtype=jnp.float32)
    cfg = L.LlamaConfig(**DIMS, dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    rs = np.random.RandomState(7)
    batches = [rs.randint(1, DIMS["vocab_size"], (2, 12)) for _ in range(2)]
    return jcfg, jparams, cfg, params, batches


@pytest.fixture(scope="module")
def manifests(tiny):
    jcfg, jparams, cfg, params, batches = tiny
    return JQ.calibrate(jcfg, jparams, batches), Q.calibrate(cfg, params,
                                                              batches)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_manifest_file_round_trips_between_packages(tiny, manifests,
                                                    tmp_path, direction):
    cfg = tiny[2]
    jm, m = manifests
    path = str(tmp_path / "quant.json")
    if direction == "reference_to_port":
        JQ.save_manifest(jm, path)
        got, want = Q.load_manifest(path), jm
        got.validate_for(cfg)
    else:
        Q.save_manifest(m, path)
        got, want = JQ.load_manifest(path), m
        got.validate_for(tiny[0])
    assert got.model == want.model
    for field in ("weight_scales", "act_scales", "kv_scales"):
        assert getattr(got, field) == getattr(want, field)
    assert Q.resolve_manifest(path).kv_scales == want.kv_scales


def test_manifest_crc_version_and_model_checks(manifests, tmp_path):
    m = manifests[1]
    path = tmp_path / "quant.json"
    Q.save_manifest(m, str(path))
    doc = json.loads(path.read_text())
    doc["payload"]["kv_scales"]["k"][0][0] *= 2.0          # hand-edit
    path.write_text(json.dumps(doc))
    for load in (Q.load_manifest, JQ.load_manifest):
        with pytest.raises(ValueError, match="CRC"):
            load(str(path))
    doc = json.loads(path.read_text())
    doc["version"] = 99
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="version"):
        Q.load_manifest(str(path))
    path.write_text("{\"hello\": 1}")
    with pytest.raises(ValueError, match="not a"):
        Q.load_manifest(str(path))
    other = L.LlamaConfig(**{**DIMS, "num_layers": 3})
    with pytest.raises(ValueError, match="different model"):
        m.validate_for(other)
    with pytest.raises(ValueError, match="different model"):
        PagedServingEngine(other, L.init_params(other, torch.Generator(),
                                                device="cpu"),
                           quant_kv=True, quant_manifest=m, device="cpu")


def test_quantized_leaves_equal_reference(tiny):
    _, jparams, _, params, _ = tiny
    ours = Q.quantize_llama_params(params, "w8")
    ref = JQ.quantize_llama_params(jparams, "w8")
    assert set(ours) == set(ref)
    assert set(ours["blocks"]) == set(ref["blocks"])
    pairs = [(ours["blocks"][k], ref["blocks"][k]) for k in ref["blocks"]]
    pairs += [(ours[k], ref[k]) for k in ("lm_head_q", "lm_head_s")]
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert got.numpy().dtype == want.dtype
        n_diff = int((got.numpy() != want).sum())
        assert n_diff == 0, f"{n_diff} entries differ"
    for n in Q.WEIGHT_NAMES:
        assert ours["blocks"][n + "_q"].dtype == torch.int8
        assert ours["blocks"][n + "_s"].dtype == torch.float32
        assert n not in ours["blocks"]
    assert ours["embed"] is params["embed"]
    assert Q.quantize_llama_params(params, "") is params


def test_calibrated_scales_match_reference(tiny, manifests):
    cfg = tiny[2]
    jm, m = manifests
    assert m.model == jm.model == Q.model_signature(cfg)
    for n in Q.ACT_NAMES:
        np.testing.assert_allclose(m.act_scales[n], jm.act_scales[n],
                                   rtol=1e-5)
        np.testing.assert_allclose(m.weight_scales[n], jm.weight_scales[n],
                                   rtol=1e-5)
    for side in ("k", "v"):
        got = np.asarray(m.kv_scales[side])
        assert got.shape == (cfg.num_layers, cfg.num_kv_heads)
        np.testing.assert_allclose(got, jm.kv_scales[side], rtol=1e-5)
    with pytest.raises(ValueError, match="batch"):
        Q.calibrate(cfg, tiny[3], [])


@pytest.mark.parametrize("name", ["wq", "wo", "lm_head"])
def test_matmul_param_matches_reference(tiny, name):
    _, jparams, _, params, _ = tiny
    ours = Q.quantize_llama_params(params, "w8")
    ref = JQ.quantize_llama_params(jparams, "w8")
    if name != "lm_head":      # one layer's slice, as the engines take it
        ours = L.layer(ours, 1)
        ref = {k: v[1] for k, v in ref["blocks"].items()}
    d_in = ours[name + "_q"].shape[0]
    h = np.random.RandomState(3).randn(5, d_in).astype(np.float32)
    got = Q.matmul_param(torch.from_numpy(h), ours, name)
    want = JQ.matmul_param(jnp.asarray(h), ref, name)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_params_from_numpy_keeps_quantized_types(tiny):
    jparams = tiny[1]
    qtree = jax.tree.map(np.asarray, JQ.quantize_llama_params(jparams, "w8"))
    got = L.params_from_numpy(qtree, device="cpu", dtype=torch.bfloat16)
    assert got["blocks"]["w1_q"].dtype == torch.int8
    assert got["blocks"]["w1_s"].dtype == torch.float32
    assert got["lm_head_s"].dtype == torch.float32
    assert got["embed"].dtype == torch.bfloat16


def test_engine_stores_weights_then_quantizes(tiny):
    """Weights are cast to weight_dtype before quantization, and the
    scales stay f32: the int8 weights are those of the stored values."""
    cfg, params = tiny[2], tiny[3]
    eng = PagedServingEngine(cfg, params, device="cpu", max_len=64,
                             weight_dtype=torch.bfloat16, quant_mode="w8")
    want = Q.quantize_llama_params(
        {**params, "blocks": {k: v.to(torch.bfloat16)
                              for k, v in params["blocks"].items()},
         "lm_head": params["lm_head"].to(torch.bfloat16)}, "w8")
    for k in ("w1_q", "w1_s", "wq_q", "wq_s"):
        assert torch.equal(eng.params["blocks"][k], want["blocks"][k])
    assert eng.params["blocks"]["w2_s"].dtype == torch.float32
    assert eng.params["lm_head_s"].dtype == torch.float32
    assert eng.params["blocks"]["attn_norm"].dtype == torch.bfloat16


def test_error_paths(tiny, manifests):
    cfg, params = tiny[2], tiny[3]
    m = manifests[1]
    # w8a8 reads static activation scales: without a manifest it raises
    # the reference's ValueError, which names calibration
    with pytest.raises(ValueError, match="calibrate"):
        Q.quantize_llama_params(params, "w8a8")
    with pytest.raises(ValueError, match="calibrate"):
        JQ.quantize_llama_params(tiny[1], "w8a8")
    with pytest.raises(ValueError, match="calibrate"):
        PagedServingEngine(cfg, params, device="cpu", quant_mode="w8a8")
    PagedServingEngine(cfg, params, device="cpu", quant_mode="w8a8",
                       quant_manifest=m)
    with pytest.raises(ValueError, match="quant mode"):
        Q.quantize_llama_params(params, "int4")
    with pytest.raises(ValueError, match="quant mode"):
        PagedServingEngine(cfg, params, device="cpu", quant_mode="w16")
    with pytest.raises(ValueError, match="calibrate"):
        PagedServingEngine(cfg, params, device="cpu", quant_kv=True)
    with pytest.raises(ValueError, match="int8"):
        PagedServingEngine(cfg, params, device="cpu", quant_kv=True,
                           quant_manifest=m, cache_dtype=torch.float32)
    eng = PagedServingEngine(cfg, params, device="cpu", quant_kv=True,
                             quant_manifest=m, cache_dtype=torch.int8)
    assert eng._key_cache.dtype == torch.int8


def _attn_case(int8_caches=True):
    rs = np.random.RandomState(0)
    KV, H, hd, bs, nb = 2, 4, 8, 4, 6
    cu = np.array([0, 2, 4])
    past, this = np.zeros(2, np.int32), np.array([2, 2], np.int32)
    tables = np.array([[0, -1], [1, -1]], np.int32)
    cos, sin = L.rope_cos_sin(torch.arange(16), hd, 10000.0)
    meta = SA.paged_metadata(cu, past, this, tables, 4, bs,
                             SA.rope_table(cos, sin))
    dt = torch.int8 if int8_caches else torch.float32
    qkv = torch.from_numpy(rs.randn(4, (H + 2 * KV) * hd).astype(np.float32))
    caches = [torch.zeros(nb, KV, bs, hd, dtype=dt) for _ in range(2)]
    scales = dict(cache_k_quant_scales=torch.ones(KV),
                  cache_v_quant_scales=torch.ones(KV),
                  cache_k_dequant_scales=torch.ones(nb, KV),
                  cache_v_dequant_scales=torch.ones(nb, KV))
    return qkv, caches, meta, scales


def test_serving_attention_scale_checks():
    qkv, caches, meta, scales = _attn_case()
    for name in scales:          # every three-of-four subset is refused
        partial = {k: v for k, v in scales.items() if k != name}
        with pytest.raises(ValueError, match="missing"):
            SA.paged_block_attention(qkv, *caches, meta, **partial)
    with pytest.raises(NotImplementedError, match="dynamic"):
        SA.paged_block_attention(qkv, *caches, meta,
                                 dynamic_cachekv_quant=True, **scales)
    qkv, fp_caches, meta, scales = _attn_case(int8_caches=False)
    with pytest.raises(ValueError, match="int8"):
        SA.paged_block_attention(qkv, *fp_caches, meta, **scales)
