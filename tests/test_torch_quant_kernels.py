"""Port kernels A6 (int8-weight fused FFN) and A5's int8-page mode held
against the reference's Pallas kernels in interpret mode.

The port's plain versions — what its wrappers run for CPU tensors — and
the reference kernels get the same numpy inputs, f32 math on both sides
in another summation order:

- A6 (`fused_ffn_w8`) on weights quantized by the reference's
  `quantize_llama_params`, with one d_ff block and several (d_ff = 1024
  runs as two 512-wide blocks in the reference): rtol 1e-5, atol 1e-5
  for outputs near 0;
- A5 with int8 pages and per-page dequant scales, in decode, mixed and
  GQA launches where every sequence ends mid-page and pages past the
  live length hold garbage: atol and rtol 1e-5;
- the serving-attention layer around it (quantize-on-append, then the
  int8 read) against the reference's `block_multihead_attention_` on
  its Pallas path: the int8 pages equal, the output within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import quant as JQ
from paddle_tpu.models import llama as JL
from paddle_tpu.ops.kernels.serving_attention import \
    block_multihead_attention_ as jax_bmha
from paddle_tpu.ops.pallas import fused_ffn as JFF
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from paddle_tpu_torch.ops.cuda import paged_attention as PA
from paddle_tpu_torch.ops.kernels import serving_attention as SA
from torch_threads import one_torch_thread

one_torch_thread()

TOL = dict(atol=1e-5, rtol=1e-5)


def _w8_layer(rows, d, f, seed):
    """x and one layer's w8 FFN leaves, quantized by the reference."""
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, d).astype(np.float32)
    blocks = {n: (0.1 * rs.randn(1, *shape)).astype(np.float32)
              for n, shape in (("w1", (d, f)), ("w3", (d, f)),
                               ("w2", (f, d)))}
    blocks.update({n: np.zeros((1, d, d), np.float32)
                   for n in ("wq", "wk", "wv", "wo")})
    qp = JQ.quantize_llama_params(
        {"blocks": blocks, "lm_head": np.zeros((d, 8), np.float32)}, "w8")
    leaves = {k: np.array(v[0]) for k, v in qp["blocks"].items()
              if k[:2] in ("w1", "w3", "w2")}
    return x, leaves


ORDER = ("w1_q", "w1_s", "w3_q", "w3_s", "w2_q", "w2_s")


@pytest.mark.parametrize("rows,d,f", [(8, 64, 128), (24, 32, 1024)])
def test_w8_plain_matches_reference_kernel(rows, d, f):
    x, lp = _w8_layer(rows, d, f, seed=rows)
    ref = np.asarray(JFF.fused_ffn_w8(jnp.asarray(x),
                                      *(jnp.asarray(lp[k]) for k in ORDER),
                                      interpret=True))
    t = {k: torch.from_numpy(v) for k, v in lp.items()}
    out = FF.fused_ffn_w8(torch.from_numpy(x), *(t[k] for k in ORDER))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the dispatch the engine calls picks A6 for these leaves
    assert FF.params_kind(t) == "w8"
    assert torch.equal(FF.apply_ffn(torch.from_numpy(x), t), out)


def test_w8_dispatch_and_gate():
    assert FF.params_kind({"w1": 0, "w3": 0, "w2": 0}) == "fp"
    w8 = {f"{n}_{s}": torch.zeros(1, dtype=torch.int8 if s == "q" else
                                  torch.float32)
          for n in ("w1", "w3", "w2") for s in "qs"}
    assert FF.params_kind(w8) == "w8"
    assert FF.params_kind({**w8, "w1_a": 0}) is None      # w8a8 leaves
    fp8 = {**w8, "w2_q": w8["w2_q"].to(torch.float8_e4m3fn)}
    assert FF.params_kind(fp8) is None                     # fp8 leaves
    with pytest.raises(ValueError, match="fp or weight-only int8"):
        FF.apply_ffn(torch.zeros(2, 8), {"w1_q": 0})
    assert FF.supported(4096, 11008, w8=True)
    assert not FF.supported(4096, 11000, w8=True)   # 16 int8 to a load
    assert FF.supported(4096, 11000)


def _int8_case(max_q, past, this, group=2, kv=2, hd=16, bs=4, nb=24, mb=6,
               seed=0):
    rs = np.random.RandomState(seed)
    B = len(past)
    q = rs.randn(B, kv, max_q * group, hd).astype(np.float32)
    kc = rs.randint(-127, 128, (nb, kv, bs, hd)).astype(np.int8)
    vc = rs.randint(-127, 128, (nb, kv, bs, hd)).astype(np.int8)
    # per-page scales that differ page by page, so a wrong page's scale
    # shows
    kdq = rs.uniform(0.005, 0.05, (nb, kv)).astype(np.float32)
    vdq = rs.uniform(0.005, 0.05, (nb, kv)).astype(np.float32)
    tables = np.full((B, mb), -1, np.int32)
    free = list(rs.permutation(nb))
    for b in range(B):
        need = -(-(past[b] + this[b]) // bs)
        extra = 1 if b == 0 else 0    # a mapped page past the live length
        for p in range(need + extra):
            tables[b, p] = free.pop()
    return (q, kc, vc, tables, np.asarray(past, np.int32),
            np.asarray(this, np.int32), group, kdq, vdq)


@pytest.mark.parametrize("max_q,past,this,group", [
    (3, [5, 0, 9, 3], [3, 2, 1, 0], 2),      # ragged mixed, idle slot
    (1, [6, 0, 13, 2], [1, 1, 1, 0], 2),     # GQA decode launch
    (4, [0, 7, 2], [4, 1, 3], 1),            # MHA, pad rows
])
def test_int8_pages_plain_matches_reference_kernel(max_q, past, this,
                                                   group):
    q, kc, vc, tables, past_a, this_a, G, kdq, vdq = _int8_case(
        max_q, past, this, group=group)
    assert any((p + t) % 4 for p, t in zip(past, this))   # a partial page
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    ref = np.asarray(JPA.paged_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, tables, past_a, this_a)), G,
        scale, k_dequant=jnp.asarray(kdq), v_dequant=jnp.asarray(vdq),
        interpret=True))
    t = torch.from_numpy
    out = PA.paged_attention(t(q), t(kc), t(vc), t(tables), t(past_a),
                             t(this_a), G, scale, k_dequant=t(kdq),
                             v_dequant=t(vdq)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    for b, n in enumerate(this):
        assert np.all(out[b, :, n * G:] == 0.0)
    with pytest.raises(ValueError, match="both"):
        PA.paged_attention(t(q), t(kc), t(vc), t(tables), t(past_a),
                           t(this_a), G, scale, k_dequant=t(kdq))


@pytest.mark.parametrize("decode", [False, True])
def test_int8_serving_attention_matches_reference(decode):
    """Quantize-on-append into int8 pages, then the int8 read; every
    sequence ends mid-page (block_size 16)."""
    rs = np.random.RandomState(9)
    KV, G, hd, bs, nb, mb, S = 2, 2, 16, 16, 12, 3, 64
    H = KV * G
    if decode:
        past, this = [10, 5, 33], [1, 1, 1]
    else:
        past, this = [10, 0, 33], [1, 13, 1]
    tok = sum(this)
    cu = np.zeros(4, np.int32)
    cu[1:] = np.cumsum(this)
    tables = np.full((3, mb), -1, np.int32)
    free = list(rs.permutation(nb))
    for b in range(3):
        for p in range(-(-(past[b] + this[b]) // bs)):
            tables[b, p] = free.pop()
    qkv = rs.randn(tok, (H + 2 * KV) * hd).astype(np.float32)
    kc = rs.randint(-127, 128, (nb, KV, bs, hd)).astype(np.int8)
    vc = rs.randint(-127, 128, (nb, KV, bs, hd)).astype(np.int8)
    kq = rs.uniform(20, 60, (KV,)).astype(np.float32)
    vq = rs.uniform(20, 60, (KV,)).astype(np.float32)
    kdq = np.broadcast_to(1.0 / kq, (nb, KV)).astype(np.float32)
    vdq = np.broadcast_to(1.0 / vq, (nb, KV)).astype(np.float32)
    cos, sin = JL.rope_cos_sin(jnp.arange(S), hd, 10000.0)
    rope = np.array(jnp.stack([jnp.concatenate([cos, cos], -1)[None],
                               jnp.concatenate([sin, sin], -1)[None]]))
    past_a, this_a = np.asarray(past, np.int32), np.asarray(this, np.int32)
    o_ref, _, kc_ref, vc_ref = jax_bmha.__wrapped__(
        jnp.asarray(qkv), jnp.asarray(kc), jnp.asarray(vc),
        jnp.zeros((3,), jnp.int32), jnp.asarray(past_a),
        jnp.asarray(this_a), cu_seqlens_q=jnp.asarray(cu),
        block_tables=jnp.asarray(tables), rope_emb=jnp.asarray(rope),
        use_neox_style=True, block_size=bs,
        cache_k_quant_scales=jnp.asarray(kq),
        cache_v_quant_scales=jnp.asarray(vq),
        cache_k_dequant_scales=jnp.asarray(kdq),
        cache_v_dequant_scales=jnp.asarray(vdq),
        use_pallas="decode" if decode else True)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    meta = SA.paged_metadata(cu, past_a, this_a, tables, tok, bs,
                             torch.from_numpy(rope),
                             max_q=1 if decode else None)
    t = torch.from_numpy
    o = SA.paged_block_attention(
        t(qkv), k_t, v_t, meta, cache_k_quant_scales=t(kq),
        cache_v_quant_scales=t(vq), cache_k_dequant_scales=t(kdq),
        cache_v_dequant_scales=t(vdq))
    assert np.array_equal(k_t.numpy(), np.asarray(kc_ref))
    assert np.array_equal(v_t.numpy(), np.asarray(vc_ref))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
