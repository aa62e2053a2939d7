"""The port's paged serving engine at vocabularies past the sampler
kernel's cap.

The sampler kernel (A7) takes at most 32,768 logits a row; the
reference engine serves any vocabulary, falling back from its kernel to
`_sample_rows` past the gate. The port's kernel limits bind on the card
only: on the CPU every wrapper runs its plain version, which serves any
vocabulary. Both engines serve the same requests from the same weights
(the reference's pytree through numpy) at `"llama-test"` widths in f32,
the reference on its fused-tick path (`pallas=True, pallas_ffn=True`,
Pallas in interpret mode); greedy token streams must be identical. On
the card a vocabulary past A7's cap still raises: the port does not fall
back from a kernel there.

The reference is imported inside the fixture, so the `gpu` case also
collects on a machine without jax.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import PagedServingEngine
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops.cuda import fused_sample as FS

GEOM = dict(num_blocks=24, block_size=8, max_batch=3, token_budget=16)


def _prompts(vocab):
    rs = np.random.RandomState(11)
    return [rs.randint(1, vocab, n).tolist() for n in (21, 9, 14)]


def _drive(eng, prompts):
    rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
    done = {c.rid: c.output_tokens for c in eng.run()}
    return [done[r] for r in rids]


@pytest.mark.parametrize("vocab", [40000, 32768])
def test_greedy_streams_match_reference_past_sampler_cap(vocab):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.inference.serving import PagedServingEngine as JEngine
    from paddle_tpu.models import llama as JL

    jcfg = dataclasses.replace(JL.CONFIGS["llama-test"], vocab_size=vocab,
                               dtype=jnp.float32)
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], vocab_size=vocab,
                              dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(3))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    prompts = _prompts(vocab)
    ours = _drive(PagedServingEngine(cfg, params, device="cpu", **GEOM),
                  prompts)
    ref = _drive(JEngine(jcfg, jparams, pallas=True, pallas_ffn=True,
                         **GEOM), prompts)
    assert ours == ref
    assert all(len(toks) == 8 for toks in ours)
    assert FS.supported(vocab) == (vocab <= 32768)


@pytest.mark.gpu
def test_card_refuses_vocab_past_sampler_cap():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gate binds on the card only")
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], vocab_size=40000,
                              dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(ValueError, match="sampler kernel does not support "
                                         "vocab 40000"):
        PagedServingEngine(cfg, params, device="cuda", **GEOM)
