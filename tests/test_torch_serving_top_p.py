"""Sampled requests with top_p <= 0 in the paged engine, against the
reference engine.

With top_p <= 0 the sampler prep (A7, and its plain version) masks a
sampled row entirely to -inf, as the reference kernel does. The
reference draws with `jax.random.categorical`, a Gumbel argmax, which
over an all -inf row returns token 0, so it serves the request; the
port draws the same way (`inference/sampling.py`). The tokens are
deterministic in both packages, so the streams compare exactly despite
threefry against Philox: tokens 0, 0, 0, then "length". A greedy row in
the same tick keeps the reference's tokens, so the draw is per row.

The reference (`pallas=True, pallas_ffn=True`, Pallas in interpret mode)
is imported inside the tests; on the card (`gpu`) the engine's streams
equal the same engine's on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import PagedServingEngine
from paddle_tpu_torch.models import llama as L

GEOM = dict(num_blocks=16, block_size=8, max_batch=4, token_budget=16)
ZERO = dict(max_new_tokens=3, temperature=1.0, seed=1)


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.models import llama as JL

    jcfg = dataclasses.replace(JL.CONFIGS["llama-test"], dtype=jnp.float32)
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(2))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jcfg, jparams, cfg, params


def _ref_engine(jcfg, jparams):
    from paddle_tpu.inference.serving import PagedServingEngine as JEngine
    return JEngine(jcfg, jparams, pallas=True, pallas_ffn=True, **GEOM)


def _serve(eng, requests):
    rids = [eng.submit(toks, **kw) for toks, kw in requests]
    done = {c.rid: (list(c.output_tokens), c.finish_reason)
            for c in eng.run()}
    return [done[r] for r in rids]


@pytest.mark.parametrize("top_p", [0.0, -1.0])
def test_top_p_nonpositive_streams_token_zero_like_reference(models, top_p):
    jcfg, jparams, cfg, params = models
    req = [([1, 2, 3, 4], dict(ZERO, top_p=top_p))]
    ours = _serve(PagedServingEngine(cfg, params, device="cpu", **GEOM), req)
    ref = _serve(_ref_engine(jcfg, jparams), req)
    assert ours == ref == [([0, 0, 0], "length")]
    eng = PagedServingEngine(cfg, params, device="cpu", **GEOM)
    rid = eng.submit([1, 2, 3, 4], **dict(ZERO, top_p=top_p))
    assert list(eng.stream(rid)) == [0, 0, 0]


def test_masked_row_beside_greedy_row_in_one_tick(models):
    jcfg, jparams, cfg, params = models
    prompt = np.random.RandomState(7).randint(1, 256, 11).tolist()
    reqs = [(prompt, dict(max_new_tokens=6)),
            ([1, 2, 3, 4], dict(ZERO, max_new_tokens=6, top_p=0.0))]
    eng = PagedServingEngine(cfg, params, device="cpu", **GEOM)
    ours = _serve(eng, reqs)
    ref = _serve(_ref_engine(jcfg, jparams), reqs)
    assert ours == ref
    assert ours[1] == ([0] * 6, "length") and ours[0][0] != [0] * 6
    assert eng.stats["decode_fast_steps"] > 0     # rows shared decode ticks


@pytest.mark.gpu
def test_masked_row_beside_greedy_row_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    prompt = np.random.RandomState(7).randint(1, 256, 11).tolist()
    reqs = [(prompt, dict(max_new_tokens=6)),
            ([1, 2, 3, 4], dict(ZERO, max_new_tokens=6, top_p=0.0)),
            ([5, 6, 7], dict(ZERO, max_new_tokens=6, top_p=-1.0))]
    streams = [_serve(PagedServingEngine(cfg, params, device=dev, **GEOM),
                      reqs) for dev in ("cpu", "cuda")]
    assert streams[1][1:] == [([0] * 6, "length")] * 2
    assert streams[1] == streams[0]
