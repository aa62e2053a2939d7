"""Kernel A5's split plan and split-and-merge arithmetic, on the CPU.

The bf16 kernel cuts every row's positions at fixed spans
(`paged_splits`) and merges the spans' f32 states in ascending order;
chunks of at most `part_rows` rows (decode rows, speculative verify
chunks) split their spans across blocks. What can be checked without a
card:

- the plan: the spans of a table row cover every position exactly once,
  are whole pages of at least 256 positions (more where a group's
  partials need it), and do not depend on the batch, the kv heads or
  the other sequences; the split rule (`split_rows`) takes only the
  sequence's own lengths and splits chunks of at most `part_rows` rows;
- the partials' traffic: written plus read, at most 10 % of the K/V
  bytes the launch reads, in every `chip_smoke.PAGED_CASES` case and at
  the engine's shapes (B 8, KV 32, block 16, max_len 2048, max_q 1 and
  64) for every pair of lengths;
- the arithmetic: `paged_attention_split_model`, a float32 model of the
  per-span partials and their ascending merge, against the reference
  `paddle_tpu.ops.pallas.paged_attention` in interpret mode (as
  `test_torch_paged_attention.py` runs it), fp and int8 pages, spans of
  2 pages of block 4 so that several spans are live, rows whose later
  spans are empty, a dead row and an idle slot: atol and rtol 1e-5 (the
  sums run in another order, so not bitwise).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu_torch.ops.cuda import paged_attention as PA

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bs,max_blocks", [
    (16, 128), (4, 512), (128, 16), (3, 700), (512, 4), (16, 1), (1, 2048),
    (16, 17)])
def test_spans_cover_every_position_once(bs, max_blocks):
    plan = PA.paged_splits(1, 128, bs, max_blocks, 8, 32, 2)
    assert plan.span % bs == 0 and plan.span >= 256
    total = max_blocks * bs
    assert plan.splits == -(-total // plan.span)
    owner = np.full(total, -1)
    for s in range(plan.splits):
        lo, hi = s * plan.span, min((s + 1) * plan.span, total)
        assert lo < hi and np.all(owner[lo:hi] == -1)
        owner[lo:hi] = s
    assert np.all(owner >= 0)


@pytest.mark.parametrize("group,hd", [(1, 128), (4, 128), (8, 64), (2, 256)])
def test_plan_depends_on_no_batch(group, hd):
    """Spans sit at fixed positions: the batch size and the kv heads
    change only the scratch, never a boundary."""
    ref = PA.paged_splits(group, hd, 16, 128, 1, 1, 2)
    for B, KV in ((8, 32), (3, 8), (64, 2)):
        plan = PA.paged_splits(group, hd, 16, 128, B, KV, 2)
        assert (plan.span, plan.splits, plan.part_rows) == \
            (ref.span, ref.splits, ref.part_rows)
        assert plan.scratch_floats == B * KV * ref.scratch_floats


def test_only_decode_rows_of_small_groups_split():
    plan = PA.paged_splits(1, 128, 16, 128, 8, 32, 2)
    assert plan.span == 256
    # 80 R (hd + 2) <= 257 hd elem holds up to R = 6 rows
    assert plan.part_rows == 6
    assert PA.split_rows(2047, 1, plan)
    assert PA.split_rows(2000, 2, plan)       # a verify chunk of 2
    assert PA.split_rows(2000, 6, plan)
    assert not PA.split_rows(2000, 7, plan)   # a prefill chunk
    assert not PA.split_rows(255, 1, plan)    # one span
    assert PA.split_rows(256, 1, plan)        # two spans
    assert not PA.split_rows(250, 6, plan)    # the last row at 255
    assert PA.split_rows(251, 6, plan)        # the last row at 256
    wide = PA.paged_splits(16, 128, 16, 128, 8, 2, 2)
    assert wide.splits == 1 and wide.scratch_floats == 0
    assert not PA.split_rows(2047, 1, wide)
    # int8 pages read half the bytes: 8 rows' partials need longer spans,
    # 80 G (hd + 2) <= (span + 1) hd elem gives 650 -> 41 pages of 16
    g8 = PA.paged_splits(8, 128, 16, 128, 8, 4, 1)
    assert g8.span == 656 and g8.splits == 4 and g8.part_rows == 8
    assert not PA.split_rows(655, 1, g8, 8)
    assert PA.split_rows(656, 1, g8, 8)
    assert not PA.split_rows(656, 2, g8, 8)   # 16 rows


def _kv_bytes(past, this, KV, hd, elem):
    return sum(p + t for p, t in zip(past, this)) * KV * hd * 2 * elem


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", sorted(chip_smoke.PAGED_CASES))
def test_partials_within_a_tenth_of_kv_bytes_in_paged_cases(name, int8):
    c = chip_smoke.PAGED_CASES[name]
    hd, bs, elem = 128, 16, 1 if int8 else 2
    plan = PA.paged_splits(c["G"], hd, bs, -(-c.get("max_len", 2048) // bs),
                           c["B"], c["KV"], elem)
    part = PA.partial_bytes(c["past"], c["this"], c["G"], hd, c["KV"], plan)
    kv = _kv_bytes(c["past"], c["this"], c["KV"], hd, elem)
    assert part <= kv / 10
    # the allocation holds every partial the launch can write
    assert part / 2 <= plan.scratch_floats * 4
    if c["max_q"] == 1 and c["G"] == 1 and min(c["past"]) >= 256:
        assert part > 0          # long decode rows do split


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("max_q", [1, 64])
def test_partials_within_a_tenth_of_kv_bytes_at_engine_shapes(max_q, int8):
    """B 8, KV 32, block 16, max_len 2048: for every sequence length
    pair a launch can hold, one sequence's partials stay within a tenth
    of its K/V bytes (the rule holds sequence by sequence, so any batch
    of them does too)."""
    KV, hd, bs, max_len, elem = 32, 128, 16, 2048, 1 if int8 else 2
    plan = PA.paged_splits(1, hd, bs, max_len // bs, 8, KV, elem)
    worst = 0.0
    for this in range(1, max_q + 1):
        for past in range(0, max_len - this + 1):
            part = PA.partial_bytes([past], [this], 1, hd, KV, plan)
            if part:
                worst = max(worst,
                            part / _kv_bytes([past], [this], KV, hd, elem))
    assert 0 < worst <= 0.1
    # scratch: part_rows f32 rows (m, l, acc) a split of a chunk
    assert plan.scratch_floats == \
        8 * KV * plan.splits * plan.part_rows * (hd + 2)


@pytest.mark.parametrize("group,hd,elem", [
    (1, 128, 2), (4, 128, 1), (8, 128, 1), (8, 128, 2), (8, 8, 1),
    (2, 256, 1), (8, 64, 2)])
def test_partials_within_a_tenth_for_every_group(group, hd, elem):
    """The span the plan picks keeps every split sequence's partials
    within a tenth of its K/V bytes, for each length of a 4,096 table;
    the worst case is a sequence just long enough to split."""
    plan = PA.paged_splits(group, hd, 16, 256, 1, 1, elem)
    worst = max(PA.partial_bytes([p], [1], group, hd, 1, plan)
                / ((p + 1) * 2 * hd * elem) for p in range(4096))
    assert 0 < worst <= 0.1
    assert PA.partial_bytes([plan.span - 1], [1], group, hd, 1, plan) == 0
    assert PA.partial_bytes([plan.span], [1], group, hd, 1, plan) > 0


def _case(max_q, past, this, group=2, kv=2, hd=16, bs=4, nb=48, mb=8,
          seed=0, int8=False):
    rs = np.random.RandomState(seed)
    B = len(past)
    q = rs.randn(B, kv, max_q * group, hd).astype(np.float32)
    if int8:
        kc = rs.randint(-127, 128, (nb, kv, bs, hd)).astype(np.int8)
        vc = rs.randint(-127, 128, (nb, kv, bs, hd)).astype(np.int8)
        scales = [rs.uniform(0.005, 0.05, (nb, kv)).astype(np.float32)
                  for _ in range(2)]
    else:
        kc = rs.randn(nb, kv, bs, hd).astype(np.float32)  # garbage beyond
        vc = rs.randn(nb, kv, bs, hd).astype(np.float32)
        scales = []
    tables = np.full((B, mb), -1, np.int32)
    free = list(rs.permutation(nb))
    for b in range(B):
        for p in range(-(-(past[b] + this[b]) // bs)):
            tables[b, p] = free.pop()
    return (q, kc, vc, tables, np.asarray(past, np.int32),
            np.asarray(this, np.int32), group, *scales)


def _model_and_reference(case, **kw):
    q, kc, vc, tables, past, this, group, *scales = case
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    dq = dict(zip(("k_dequant", "v_dequant"), scales))
    ref = np.asarray(JPA.paged_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, tables, past, this)), group,
        scale, interpret=True,
        **{k: jnp.asarray(v) for k, v in dq.items()}))
    t = torch.from_numpy
    out = PA.paged_attention_split_model(
        t(q), t(kc), t(vc), t(tables), t(past), t(this), group, scale,
        **{k: t(v) for k, v in dq.items()}, **kw).numpy()
    return out, ref


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("max_q,past,this,group", [
    # decode rows over 1 to 4 spans of 8, an idle slot; every row's
    # later spans of the 32-position table are empty
    (1, [5, 0, 29, 13, 2], [1, 1, 1, 1, 0], 2),
    # chunks: rows of one sequence see different numbers of spans, dead
    # pad rows beside them
    (3, [6, 0, 20, 3], [3, 2, 1, 0], 2),
    (4, [0, 9, 17], [4, 1, 3], 1),
])
def test_split_model_matches_reference(int8, max_q, past, this, group):
    case = _case(max_q, past, this, group=group, int8=int8)
    out, ref = _model_and_reference(case, span=8, split_all=True)
    np.testing.assert_allclose(out, ref, **TOL)
    for b, n in enumerate(this):
        assert np.all(out[b, :, n * group:] == 0.0)


@pytest.mark.parametrize("int8", [False, True])
def test_split_model_under_the_kernels_rule(int8):
    """The kernel's own plan and rule (256-position spans): the decode
    rows of 300 and 500 cached tokens split, the chunk and the short row
    walk one span."""
    past, this = [300, 500, 40, 10], [1, 1, 1, 3]
    case = _case(3, past, this, group=2, bs=16, nb=64, mb=40, seed=1,
                 int8=int8)
    plan = PA.paged_splits(2, 16, 16, 40, 4, 2, 1 if int8 else 4)
    assert plan.span == 256
    assert [PA.split_rows(p, t, plan)
            for p, t in zip(past, this)] == [True, True, False, False]
    out, ref = _model_and_reference(case)
    np.testing.assert_allclose(out, ref, **TOL)
