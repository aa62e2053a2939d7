"""The port's paged serving engine at vocabularies past the reference
sampler kernel's gate and the port's former 32,768 cap.

The reference engine serves any vocabulary, falling back from its
sampler kernel to `_sample_rows` past the kernel's gate. The port's
sampler kernel (A7, one thread-block cluster a row) serves any
vocabulary on the card; on the CPU every wrapper runs its plain
version. Both engines serve the same requests from the same weights
(the reference's pytree through numpy) at `"llama-test"` widths in f32,
the reference on its fused-tick path (`pallas=True, pallas_ffn=True`,
Pallas in interpret mode); greedy token streams must be identical. On
the card (`gpu`), the engine's greedy streams at vocab 40,000 and
128,256 equal the same engine's on the CPU.

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
from torch_threads import one_torch_thread

one_torch_thread()

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
    assert FS.supported(vocab)


@pytest.mark.gpu
@pytest.mark.parametrize("vocab", [40000, 128256])
def test_card_greedy_streams_match_cpu_past_old_cap(vocab):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: A7 runs its kernel there")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], vocab_size=vocab,
                              dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompts = _prompts(vocab)
    FS.KERNEL.reset()
    card = _drive(PagedServingEngine(cfg, params, device="cuda", **GEOM),
                  prompts)
    assert FS.KERNEL.launches > 0
    cpu = _drive(PagedServingEngine(cfg, params, device="cpu", **GEOM),
                 prompts)
    assert card == cpu
    assert all(len(toks) == 8 for toks in card)
