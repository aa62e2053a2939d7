"""The port's loss-only step, `make_eval_step`, held against the
reference's (`paddle_tpu/distributed/hybrid.py:534`, LlamaConfig path,
on `build_mesh(1, 1, 1)`).

The tiny f32 GQA config and batch of `tests/test_torch_train.py`. The
reference's eval step runs its plain attention and FFN (`attn_impl`
"auto" on the CPU, `ffn_impl` "stock"); the port's runs the kernels'
plain versions: f32 sums in another order, loss rtol 1e-5. Inside the
port the eval loss is computed as the train step computes its loss, so
the two are held equal bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import hybrid as JH
from paddle_tpu_torch.distributed import hybrid as H
from paddle_tpu_torch.models import llama as L
from tests.test_torch_train import _DIMS, _batch, _params, _tiny


@pytest.mark.parametrize("microbatches", [1, 2])
def test_eval_step_matches_reference(microbatches):
    jcfg, jparams, cfg = _tiny()
    tokens, targets = _batch()
    params = _params(jparams)
    mesh = JH.build_mesh(1, 1, 1)
    want = JH.make_eval_step(jcfg, mesh, num_microbatches=microbatches)(
        JH.shard_params(jparams, mesh, jcfg), jnp.asarray(tokens),
        jnp.asarray(targets))
    step = H.make_eval_step(cfg, device="cpu",
                            num_microbatches=microbatches)
    loss = step(params, torch.from_numpy(tokens), torch.from_numpy(targets))
    assert loss.shape == () and loss.dtype == torch.float32
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)


@pytest.mark.parametrize("microbatches,remat", [(1, True), (2, "dots")])
def test_eval_loss_is_the_next_train_loss(microbatches, remat):
    _, jparams, cfg = _tiny()
    tokens, targets = (torch.from_numpy(a) for a in _batch())
    params = _params(jparams)
    opt = H.init_opt_state(params)
    evaluate = H.make_eval_step(cfg, device="cpu",
                                num_microbatches=microbatches)
    train = H.make_train_step(cfg, device="cpu", remat=remat,
                              num_microbatches=microbatches,
                              hp=H.AdamWConfig(lr=1e-3))
    for _ in range(2):
        before = evaluate(params, tokens, targets)
        params, opt, loss = train(params, opt, tokens, targets)
        assert torch.equal(before, loss)
    assert float(evaluate(params, tokens, targets)) < float(before)


def test_eval_step_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = L.LlamaConfig(**_DIMS, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.make_eval_step(cfg)
    with pytest.raises(ValueError, match="num_microbatches"):
        H.make_eval_step(cfg, device="cpu", num_microbatches=0)


@pytest.mark.parametrize("factory", [H.make_train_step, H.make_eval_step])
def test_factories_take_a_llama_config_only(factory):
    with pytest.raises(NotImplementedError, match="nn.Layer"):
        factory(torch.nn.Linear(4, 4), device="cpu")
