"""Kernel A7's plan and threshold arithmetic, on the CPU.

The kernel gives each row one thread-block cluster and finds the top-k
threshold and the top-p cutoff by radix selects over order-preserving
uint32 keys; none of it runs without a card. What can be checked here:

- the plan (`sample_plan`): a function of V alone, defined for every V
  from 1 to 2^20 with no cap; its cluster fits the card (at most 16
  blocks, every block holding part of the row); a resident slice leaves
  room for two blocks an SM, a longer one streams in fixed tiles; the
  fixed-point masses of V entries sum within 2^63;
- the arithmetic: `radix_model`, a numpy model of the kernel's two
  selects — the count select for the top-k threshold, the mass select
  (exp(l - max) as round(mass * 2^shift), exact integer sums, the cutoff
  the lowest bin holding mass whose mass above is below ceil(top_p *
  total)), each digit taken as the kernel takes it, by its 64 groups of
  bins first — against the reference's `fused_sample_prep` in
  interpret mode: on the crafted rows of `chip_smoke.sample_edge_cases`
  (ties at the k-th value and at the cutoff, +-0.0, all-equal rows, one
  finite entry among -inf, top_p 0, 1e-3 and 1.0, top_k 1 and = V,
  temperature 1e-9) the argmax, the -inf pattern and the kept values
  are exact; on random rows at V = 128,256 the -inf pattern may differ
  only where an entry's exclusive prefix mass lies within 1e-4 of
  top_p (the reference sums f32 probabilities in its own order).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.ops.pallas import fused_sample as JFS
from paddle_tpu_torch.ops.cuda import build
from paddle_tpu_torch.ops.cuda import fused_sample as FS

SMEM_BLOCK = 232448          # dynamic shared memory a block may take
SMEM_SM = 233472             # shared memory of an SM
STATIC_SMEM = 1024           # the kernel's static shared memory, at most


def _check_plan(V, p):
    assert 1 <= p.cluster <= FS.MAX_CLUSTER
    assert p.cluster * p.slice >= V > (p.cluster - 1) * p.slice
    assert sum(p.bits) == 32 and 9 <= min(p.bits) and max(p.bits) <= 11
    assert p.shift >= 0 and V * 2 ** p.shift <= 2 ** 63
    smem = FS.plan_smem(p.cluster, p.tile, p.bits)
    assert smem + STATIC_SMEM <= SMEM_BLOCK
    if p.resident:
        assert 2 * (smem + 1024 + STATIC_SMEM) <= SMEM_SM
    else:
        assert p.tile == 16384 < p.slice and p.cluster == FS.MAX_CLUSTER


def test_plan_covers_every_vocab_to_2_20():
    assert list(inspect.signature(FS.sample_plan).parameters) == ["vocab"]
    plan = FS.sample_plan.__wrapped__     # uncached: a million vocabularies
    for V in range(1, 2 ** 20 + 1):
        p = plan(V)
        assert p.cluster * p.slice >= V > (p.cluster - 1) * p.slice
    for V in [1, 2, 3, 97, 4095, 4096, 4097, 32000, 32768, 32769, 65536,
              65537, 128256, 152064, 290752, 290753, 2 ** 20, 1048583,
              2 ** 31 - 1]:
        _check_plan(V, plan(V))
        assert FS.supported(V)
    assert not FS.supported(0)
    with pytest.raises(ValueError):
        FS.sample_plan(0)


@pytest.mark.parametrize("V,cluster,resident", [
    (97, 1, True), (32000, 8, True), (128256, 16, True), (152064, 16, True),
    (1048583, 16, False)])
def test_plan_at_path_vocabularies(V, cluster, resident):
    p = FS.sample_plan(V)
    assert (p.cluster, p.resident) == (cluster, resident)
    assert FS.sample_plan(V) is p         # one plan a vocabulary
    _check_plan(V, p)


# -- the numpy model of the kernel's selects ---------------------------------

def _keys(l):
    """Order-preserving uint32 keys; -0.0 keys as +0.0."""
    u = np.where(l == 0, np.float32(0), l).astype(np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint32)


def _mass_target(top_p, total):
    """ceil(top_p * total), exactly, for a float32 top_p in (0, 1]."""
    b = int(np.float32(top_p).view(np.uint32))
    ex, m = (b >> 23) & 0xff, b & 0x7fffff
    if ex:
        m |= 0x800000
    else:
        ex = 1
    return -(-(m * total) // 2 ** (150 - ex))


def _select(keys, weights, bits, target, mass):
    """The kernel's radix select: per digit, bins over the entries that
    match the prefix, in 64 groups; the group, then the bin. Counting
    (mass=False) takes the bin holding the target-th entry from the top;
    weighing the lowest bin holding mass whose mass above is below the
    target (on the first digit, target = top_p and the target is
    ceil(top_p * total)). Returns the key, or None."""
    prefix, done, above = 0, 0, 0
    for w in bits:
        nb, low = 1 << w, 32 - done - w
        sel = (keys >> np.uint32(32 - done)) == prefix if done else \
            np.ones(len(keys), bool)
        hist = [0] * nb
        for k, wt in zip(keys[sel].tolist(), weights[sel].tolist()):
            hist[(k >> low) & (nb - 1)] += wt
        per = nb // 64
        ranges = [(g * per, (g + 1) * per) for g in range(64)]
        tots = [sum(hist[lo:hi]) for lo, hi in ranges]
        if mass and done == 0:
            target = _mass_target(target, sum(tots))
        a, pick = above, None
        for r in reversed(range(64)):                # groups from the top
            ok = (tots[r] > 0 and a < target) if mass else \
                (a < target <= a + tots[r])
            if ok:
                pick = (r, a)                        # mass: keep the lowest
                if not mass:
                    break
            a += tots[r]
        if pick is None:
            return None
        r, a = pick
        lo, hi = ranges[r]
        got = None
        for b in reversed(range(lo, hi)):
            if a >= target:
                break
            if (hist[b] != 0) if mass else (target <= a + hist[b]):
                got = (b, a)
                if not mass:
                    break
            a += hist[b]
        prefix, done, above = (prefix << w) | got[0], done + w, got[1]
    return prefix


def radix_model(logits, temps, top_ps, top_k):
    """(masked logits, argmax) as the kernel computes them, row by row."""
    B, V = logits.shape
    plan = FS.sample_plan(V)
    masked = np.empty_like(logits)
    for b in range(B):
        l = logits[b] / np.maximum(np.float32(temps[b]), np.float32(1e-6))
        keys = _keys(l)
        floor = 0
        if 0 < top_k < V:
            floor = _select(keys, np.ones(V, np.int64), plan.bits, top_k,
                            mass=False)
        p = np.float32(top_ps[b])
        cut = int(_keys(np.array([np.inf], np.float32))[0])
        if p > 1:
            cut = 0
        elif p > 0:
            surv = (keys >= floor) & (l > -np.inf)
            m = np.exp(l - l.max()).astype(np.float64) * 2.0 ** plan.shift
            fixed = np.where(surv, np.rint(m), 0).astype(np.uint64)
            got = _select(keys, fixed, plan.bits, p, mass=True)
            if got is not None:
                cut = got
        masked[b] = np.where(keys < max(floor, cut), np.float32(-np.inf), l)
    return masked, logits.argmax(-1)


def _reference(logits, temps, top_ps, top_k):
    m, a = JFS.fused_sample_prep(jnp.asarray(logits), jnp.asarray(temps),
                                 jnp.asarray(top_ps), top_k, interpret=True)
    return np.asarray(m), np.asarray(a)


@pytest.mark.parametrize("case", [c[0] for c in
                                  chip_smoke.sample_edge_cases(np)])
def test_radix_model_matches_reference_on_edge_rows(case):
    _, logits, temps, top_ps, top_k = next(
        c for c in chip_smoke.sample_edge_cases(np) if c[0] == case)
    m_ref, a_ref = _reference(logits, temps, top_ps, top_k)
    masked, amax = radix_model(logits, temps, top_ps, top_k)
    np.testing.assert_array_equal(amax, a_ref)
    np.testing.assert_array_equal(np.isneginf(masked), np.isneginf(m_ref))
    fin = np.isfinite(m_ref)
    np.testing.assert_array_equal(masked[fin].view(np.uint32),
                                  m_ref[fin].view(np.uint32))


def test_edge_rows_reach_every_corner():
    cases = {c[0]: c for c in chip_smoke.sample_edge_cases(np)}
    V = chip_smoke.SAMPLE_EDGE_V
    assert {c[4] for c in cases.values()} >= {0, 1, 3, 5, V}
    assert FS.sample_plan(V).cluster > 1        # rows span several blocks
    ps = np.concatenate([c[3] for c in cases.values()])
    assert {0.0, np.float32(1e-3), 1.0} <= set(ps.tolist())
    temps = np.concatenate([c[2] for c in cases.values()])
    assert np.float32(1e-9) in temps
    logits = np.concatenate([c[1] for c in cases.values()])
    assert np.any(np.signbit(logits) & (logits == 0))       # -0.0
    assert np.any(~np.signbit(logits) & (logits == 0))      # +0.0
    assert np.any(np.isfinite(logits).sum(-1) == 1)         # one finite
    assert np.any(np.all(logits == logits[:, :1], axis=-1))  # all equal


@pytest.mark.parametrize("top_k", [0, 50])
def test_radix_model_matches_reference_on_random_rows(top_k):
    rs = np.random.RandomState(5 + top_k)
    B, V = 3, 128256
    logits = (3 * rs.randn(B, V)).astype(np.float32)
    temps = np.array([1.0, 0.8, 0.7], np.float32)
    top_ps = np.array([1.0, 0.9, 0.5], np.float32)
    m_ref, a_ref = _reference(logits, temps, top_ps, top_k)
    masked, amax = radix_model(logits, temps, top_ps, top_k)
    np.testing.assert_array_equal(amax, a_ref)
    fin = np.isfinite(m_ref) & np.isfinite(masked)
    np.testing.assert_array_equal(masked[fin].view(np.uint32),
                                  m_ref[fin].view(np.uint32))
    def t(a):
        return torch.from_numpy(np.array(a))

    chip_smoke.sample_boundary(torch, f"radix model top_k={top_k}",
                               t(masked), t(m_ref), t(logits), t(temps),
                               t(top_ps), top_k)
    assert np.isneginf(masked).sum() > 0


def test_bindings_match_the_c_entries():
    """The ctypes argument kinds of each entry are the C signature's:
    pointers (and the stream) as void*, sizes as int."""
    import re

    src = FS.KERNEL.source.read_text()
    for name, kinds in FS.KERNEL._entries.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert params, name
        c_kinds = ["ptr" if "*" in a else "int"
                   for a in params.group(1).split(",")]
        assert c_kinds == ["ptr" if k is build.PTR else "int"
                           for k in kinds], name
