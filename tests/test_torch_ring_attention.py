"""The port's ring and Ulysses attention (`paddle_tpu_torch.ops
.ring_attention`) against the reference's dense attention, four gloo
ranks on the CPU, spawned once for the module.

The cases of `tests/test_ring_attention.py:43-60` (B 2, T 16, H 4, D 8):
ring attention on 2 and 4 ranks, Ulysses on 4, causal and not; GQA (KV
2) through the ring; the eager `ring_attention` (whole tensors on every
rank, ring and sep) and a group of one. Each output within the
reference tests' 2e-4, and the gradients of sum(out * w), each rank's
block (shard forms) or the whole tensors (eager form), within their
2e-3, against the reference's dense attention (its `_block_attend` over
the whole sequence) and `jax.vjp` on the same inputs. The reference's
own eager ring (60-155 s a test here) is not called.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_workers as W
from paddle_tpu.ops.ring_attention import _block_attend
from torch_threads import one_torch_thread

one_torch_thread()

WORLD = 4
CASES = [(f"ring_n{n}_{'causal' if c else 'full'}", "ring", n, c, "mha")
         for n in (2, 4) for c in (True, False)]
CASES += [(f"sep_n4_{'causal' if c else 'full'}", "sep", 4, c, "mha")
          for c in (True, False)]
CASES += [("ring_gqa_n4", "ring", 4, True, "gqa"),
          ("eager_ring_n4", "eager", 4, True, "mha"),
          ("eager_sep_n4", "eager_sep", 4, False, "mha"),
          ("eager_one_rank", "eager", 1, True, "mha")]


def _qkv(B=2, T=16, H=4, KV=4, D=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(B, T, H, D)).astype(np.float32),
            rs.normal(size=(B, T, KV, D)).astype(np.float32),
            rs.normal(size=(B, T, KV, D)).astype(np.float32),
            rs.normal(size=(B, T, H, D)).astype(np.float32))


QKV = {"mha": _qkv(), "gqa": _qkv(KV=2, seed=1)}


def _dense(q, k, v, causal):
    H, KV, T, D = q.shape[2], k.shape[2], q.shape[1], q.shape[3]
    if KV != H:
        k = jnp.repeat(k, H // KV, axis=2)
        v = jnp.repeat(v, H // KV, axis=2)
    mask = jnp.tril(jnp.ones((T, T), bool))[None, None] if causal else None
    pv, _, l = _block_attend(q, k, v, 1.0 / D ** 0.5, mask)
    return pv / l[..., None].transpose(0, 2, 1, 3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    procs = W.start("ring", WORLD, tmp, {"cases": CASES, "qkv": QKV})
    try:
        want = {}
        dense = jax.jit(_dense, static_argnums=3)
        for key, impl, n, causal, qkv in CASES:
            q, k, v, w = QKV[qkv]
            out, vjp = jax.vjp(lambda *a: dense(*a, causal), q, k, v)
            want[key] = (np.asarray(out),
                         [np.asarray(g) for g in vjp(jnp.asarray(w))])
    finally:
        outs = W.finish(procs, tmp)
    return outs, want


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_against_the_references_dense_attention(runs, case):
    outs, want = runs
    key, impl, n, _, _ = case
    ref_out, ref_grads = want[key]
    for r in range(n):
        out, grads = outs[r][key]
        if impl.startswith("eager"):
            blk = slice(None)
        else:
            T = ref_out.shape[1] // n
            blk = slice(r * T, (r + 1) * T)
        np.testing.assert_allclose(out, ref_out[:, blk], rtol=2e-4,
                                   atol=2e-4, err_msg=f"rank {r}")
        for name, g, rg in zip("qkv", grads, ref_grads):
            np.testing.assert_allclose(g, rg[:, blk], rtol=2e-3, atol=2e-3,
                                       err_msg=f"d{name} rank {r}")
