"""The paddle op `block_multihead_attention_` under ops.yaml's signature
(`ops/kernels/serving_attention.py`) against the reference's op.

The reference runs its Pallas path in interpret mode (`use_pallas=True`,
or "decode" for the max_q = 1 launch), as `tests/test_serving_paged.py`
runs it; the port's op runs on CPU tensors (A5's plain version). Inputs
are `tests/test_serving_paged.py`'s `_mha_args` batches: ragged mixed
prefill and decode rows with chunked-prefill resumes, an idle slot, a
pure decode batch, grouped-query heads, rope in both styles with and
without a per-row table, `qkv_bias`, a copy-on-write page that every
sequence shares, and int8 pages with all four scale tensors; each case
covers several of them, so the interpret-mode kernel runs four times
(three geometries, each compiled once). fmha_out
and qkv_out are held within 1e-5 (atol and rtol: the sums run in
another order); the written pages bit for bit. The op's results equal
the engine's form (`paged_block_attention` over `paged_metadata` at the
op's max_q, its longest chunk) on the same inputs, bit for bit, and its
error paths raise the reference's errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels.serving_attention import \
    block_multihead_attention_ as jax_bmha
from paddle_tpu_torch import _C_ops
from paddle_tpu_torch.ops.kernels import serving_attention as SA
from torch_threads import one_torch_thread

one_torch_thread()

TOL = dict(atol=1e-5, rtol=1e-5)
S = 64                                  # rope table rows


def _args(past, this, KV=2, G=2, hd=8, bs=8, mb=4, nb=24, quant=False,
          seed=0, shared_first_page=False, rope="neox", per_row=False,
          bias=False):
    """numpy inputs of one call (`tests/test_serving_paged.py`'s
    `_mha_args`, with rope and bias options)."""
    rs = np.random.RandomState(seed)
    H = KV * G
    B = len(this)
    tok = sum(this)
    cu = np.zeros(B + 1, np.int32)
    cu[1:] = np.cumsum(this)
    tables = np.full((B, mb), -1, np.int32)
    used = 1 if shared_first_page else 0
    for b in range(B):
        for p in range(-(-max(past[b] + this[b], 0) // bs)):
            if shared_first_page and p == 0:
                tables[b, 0] = 0
                continue
            tables[b, p] = used
            used += 1
    assert used <= nb
    a = dict(qkv=rs.randn(max(tok, 1), (H + 2 * KV) * hd).astype(np.float32),
             seq_lens_encoder=np.zeros(B, np.int32),
             seq_lens_decoder=np.asarray(past, np.int32),
             seq_lens_this_time=np.asarray(this, np.int32),
             cu_seqlens_q=cu, block_tables=tables)
    if quant:
        a["key_cache"] = rs.randint(-127, 128, (nb, KV, bs, hd)).astype(
            np.int8)
        a["value_cache"] = rs.randint(-127, 128, (nb, KV, bs, hd)).astype(
            np.int8)
        kq = rs.uniform(20, 60, (KV,)).astype(np.float32)
        vq = rs.uniform(20, 60, (KV,)).astype(np.float32)
        a.update(cache_k_quant_scales=kq, cache_v_quant_scales=vq,
                 cache_k_dequant_scales=np.broadcast_to(
                     1.0 / kq, (nb, KV)).copy(),
                 cache_v_dequant_scales=np.broadcast_to(
                     1.0 / vq, (nb, KV)).copy())
    else:
        a["key_cache"] = rs.randn(nb, KV, bs, hd).astype(np.float32)
        a["value_cache"] = rs.randn(nb, KV, bs, hd).astype(np.float32)
    if rope:
        rows = B if per_row else 1
        ang = rs.uniform(0, 6.3, (rows, S, hd // 2)).astype(np.float32)
        c, s = np.cos(ang), np.sin(ang)
        a["rope_emb"] = np.stack([np.concatenate([c, c], -1)[:, None],
                                  np.concatenate([s, s], -1)[:, None]])
        a["use_neox_style"] = rope == "neox"
    if bias:
        a["qkv_bias"] = rs.randn((H + 2 * KV) * hd).astype(np.float32)
    a["block_size"] = bs
    return a


def _ref(a, mode=True):
    args = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in a.items()}
    return [np.asarray(o) for o in jax_bmha.__wrapped__(use_pallas=mode,
                                                        **args)]


def _port(a, mode=True):
    args = {k: (torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
                else v) for k, v in a.items()}
    out = _C_ops.block_multihead_attention_(use_pallas=mode, **args)
    return args, out


# each case covers several features, so the reference's interpret-mode
# kernel runs as few times as the coverage needs; the first two share
# one geometry (4 sequences, 15 tokens, grouped-query heads G = 3), so
# the reference compiles it once
CASES = {
    # ragged prefill with a chunked-prefill resume, a decode row and an
    # idle slot; rotate-half rope from a per-row table, qkv_bias
    "ragged_idle_neox_per_row_bias": dict(
        past=[8, 0, 15, 0], this=[5, 9, 1, 0], KV=2, G=3, hd=16, bs=8,
        per_row=True, bias=True, seed=1),
    # adjacent-pair rope, and a copy-on-write page that every sequence
    # reads
    "gqa_pairwise_cow_shared_page": dict(
        past=[8, 8, 8, 8], this=[1, 3, 1, 10], KV=2, G=3, hd=16, bs=8,
        rope="pairwise", shared_first_page=True, seed=4),
    # int8 pages with the four scale tensors, no rope
    "int8_pages_no_rope": dict(past=[10, 0, 33], this=[1, 13, 1], KV=2,
                               G=3, hd=16, bs=16, quant=True, rope=None,
                               seed=5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_the_reference(name):
    a = _args(**CASES[name])
    r = _ref(a)
    args, p = _port(a)
    assert len(p) == 4
    np.testing.assert_allclose(p[0].numpy(), r[0], **TOL)
    np.testing.assert_allclose(p[1].numpy(), r[1], **TOL)
    assert p[2] is args["key_cache"] and p[3] is args["value_cache"]
    if CASES[name].get("quant"):
        assert p[2].dtype == torch.int8
        np.testing.assert_array_equal(p[2].numpy(), r[2])
        np.testing.assert_array_equal(p[3].numpy(), r[3])
    else:
        np.testing.assert_allclose(p[2].numpy(), r[2], **TOL)
        np.testing.assert_allclose(p[3].numpy(), r[3], **TOL)


def test_decode_mode_matches_the_reference():
    a = _args(past=[7, 0, 30, 12], this=[1, 1, 1, 1], hd=16, bs=16, seed=3)
    r = _ref(a, "decode")
    _, p = _port(a, "decode")
    np.testing.assert_allclose(p[0].numpy(), r[0], **TOL)
    for k in (2, 3):
        np.testing.assert_allclose(p[k].numpy().astype(np.float32),
                                   r[k].astype(np.float32), **TOL)
    # the engine's form at max_q = token_num q rows a sequence: the same
    # rows
    o, _, _ = _engine(a, max_q=a["qkv"].shape[0])
    np.testing.assert_allclose(o.numpy(), p[0].numpy(), **TOL)


def _engine(a, max_q):
    """The engine's form, `paged_block_attention` over `paged_metadata`,
    on fresh copies of `a`'s caches: (fmha_out, key_cache, value_cache)."""
    kc, vc = (torch.from_numpy(a[k].copy()) for k in ("key_cache",
                                                      "value_cache"))
    meta = SA.paged_metadata(a["cu_seqlens_q"], a["seq_lens_decoder"],
                             a["seq_lens_this_time"], a["block_tables"],
                             a["qkv"].shape[0], a["block_size"],
                             torch.from_numpy(a["rope_emb"][:, 0]), max_q)
    scales = {k: torch.from_numpy(v) for k, v in a.items()
              if k.startswith("cache_")}
    o = SA.paged_block_attention(torch.from_numpy(a["qkv"]), kc, vc, meta,
                                 use_neox_style=a["use_neox_style"],
                                 **scales)
    return o, kc, vc


@pytest.mark.parametrize("quant", [False, True])
def test_op_equals_the_engine_form(quant):
    """The op packs its longest chunk of q rows a sequence (max_q 9
    here): bit for bit the engine's form at that max_q."""
    a = _args(past=[8, 0, 15], this=[5, 9, 1], quant=quant, hd=16, bs=16,
              seed=11)
    args, p = _port(a)
    o, kc, vc = _engine(a, max_q=9)
    assert torch.equal(p[0], o)
    assert torch.equal(p[2], kc) and torch.equal(p[3], vc)


def _raises(a, exc, match, **kw):
    args = {k: (torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
                else v) for k, v in a.items()}
    args.update(kw)
    with pytest.raises(exc, match=match):
        _C_ops.block_multihead_attention_(**args)
    jargs = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
             for k, v in a.items()}
    jargs.update({k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                      else v) for k, v in kw.items()})
    with pytest.raises(exc, match=match):
        jax_bmha.__wrapped__(use_pallas=True, **jargs)


def test_error_paths_match_the_reference():
    a = _args(past=[4, 0], this=[1, 3], seed=12)
    _raises(a, ValueError, "block_tables", block_tables=None)
    _raises(a, ValueError, "cu_seqlens_q", cu_seqlens_q=None)
    _raises(a, NotImplementedError, "pre_key_cache",
            pre_key_cache=torch.zeros(1))
    _raises(a, NotImplementedError, "mask", mask=torch.zeros(1))
    _raises(a, NotImplementedError, "mask", tgt_mask=torch.zeros(1))
    for name in ("qkv_out_scale", "out_shift", "out_smooth"):
        _raises(a, NotImplementedError, name, **{name: torch.zeros(1)})
    q = _args(past=[4, 0], this=[1, 3], quant=True, seed=13)
    for drop in [k for k in q if k.startswith("cache_")]:
        partial = dict(q)
        del partial[drop]
        _raises(partial, ValueError, "missing")
    _raises(q, NotImplementedError, "dynamic_cachekv_quant",
            dynamic_cachekv_quant=True)
    fp_with_scales = dict(q, key_cache=a["key_cache"],
                          value_cache=a["value_cache"])
    _raises(fp_with_scales, ValueError, "int8")


def test_use_pallas_switches():
    a = _args(past=[4, 0], this=[1, 3], seed=14)
    outs = [_port(a, mode)[1][0] for mode in (None, True, False)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="use_pallas"):
        _port(a, "pallas")
    with pytest.raises(ValueError, match="decode"):
        _port(a, "decode")             # a row of 3 tokens: max_q 1 is short
