"""The port's single-device train step held against the reference.

Both packages start from the reference's `init_params` (through numpy),
on a tiny f32 GQA config (vocab 97, hidden 32, d_ff 64, 2 layers, 4
heads, 2 kv heads, T = 16), and run their kernel paths: the reference
with `attn_impl="flash"`, `ffn_impl="pallas"` (Pallas in interpret
mode) on `build_mesh(1, 1, 1)`, the port through its kernel wrappers
on the CPU, where the kernels' plain versions run (forward and FA-2 /
`_act_grads` backward).

Tolerances, f32 throughout, sums in another order: the AdamW update
rtol 1e-6 (the same elementwise formula); loss gradients rtol 1e-4
(atol 1e-7 for entries near 0: a few products and a softmax deep); the
losses of three AdamW steps rtol 1e-5 and the parameters after them
rtol 1e-4 with atol 1e-5, a hundredth of lr = 1e-3: Adam divides each
gradient entry by its own running RMS, so for an entry whose gradient
is near 0 an f32 rounding difference moves the update by a fraction of
lr (one entry in 4,096 differs by 3.7e-6 after three steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import hybrid as JH
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed import hybrid as H
from paddle_tpu_torch.models import llama as L

_DIMS = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
             num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64)


def _tiny():
    jcfg = JL.LlamaConfig(**_DIMS, dtype=jnp.float32)
    cfg = L.LlamaConfig(**_DIMS, dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg


def _params(jparams):
    return L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")


def _batch(B=4, T=16, seed=2):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, 97, (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _close_tree(got, want, rtol, atol):
    flat_w, _ = jax.tree.flatten(want)
    flat_g, _ = H._flatten(got)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


def test_adamw_update_matches_reference():
    rs = np.random.RandomState(0)

    def tree(scale=1.0):
        return {"a": (scale * rs.randn(3, 5)).astype(np.float32),
                "b": {"c": (scale * rs.randn(7)).astype(np.float32),
                      "d": (scale * rs.randn(2, 2, 3)).astype(np.float32)}}

    params, grads = tree(), tree(3.0)
    m, v = tree(0.1), jax.tree.map(np.abs, tree(0.2))
    hp = JH.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    sq = sum(float(np.sum(g.astype(np.float32) ** 2))
             for g in jax.tree.leaves(grads))
    jopt = {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
            "step": jnp.asarray(4, jnp.int32)}
    want_p, want_opt = JH._adamw_update(jax.tree.map(jnp.asarray, params),
                                        jax.tree.map(jnp.asarray, grads),
                                        jopt, hp, jnp.float32(sq))
    conv = lambda t: L.params_from_numpy(t, device="cpu")
    opt = {"m": conv(m), "v": conv(v), "step": torch.tensor(4)}
    got_p, got_opt = H._adamw_update(conv(params), conv(grads), opt,
                                     H.AdamWConfig(lr=1e-2), sq)
    _close_tree(got_p, want_p, rtol=1e-6, atol=1e-7)
    _close_tree(got_opt["m"], want_opt["m"], rtol=1e-6, atol=1e-7)
    _close_tree(got_opt["v"], want_opt["v"], rtol=1e-6, atol=1e-9)
    assert int(got_opt["step"]) == int(want_opt["step"]) == 5


def test_loss_grads_match_reference_kernel_path():
    jcfg, jparams, cfg = _tiny()
    tokens, targets = _batch(B=2)
    jloss, jgrads = jax.value_and_grad(JL.loss_fn)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg,
        attn_impl="flash", ffn_impl="pallas")
    loss, grads = H.loss_and_grads(_params(jparams), torch.from_numpy(tokens),
                                   torch.from_numpy(targets), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close_tree(grads, jgrads, rtol=1e-4, atol=1e-7)


def _reference_steps(jcfg, jparams, tokens, targets, n, microbatches,
                     remat=True):
    mesh = JH.build_mesh(1, 1, 1)
    sp = JH.shard_params(jparams, mesh, jcfg)
    opt = JH.init_opt_state(sp)
    step = JH.make_train_step(jcfg, mesh, num_microbatches=microbatches,
                              hp=JH.AdamWConfig(lr=1e-3), remat=remat,
                              attn_impl="flash", ffn_impl="pallas")
    losses = []
    for _ in range(n):
        sp, opt, loss = step(sp, opt, jnp.asarray(tokens), jnp.asarray(targets))
        losses.append(float(loss))
    return losses, JH.unstack_pipeline(jax.tree.map(np.asarray, sp))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(microbatches):
    jcfg, jparams, cfg = _tiny()
    tokens, targets = _batch()
    params = _params(jparams)      # first: the reference step donates
    want_losses, want_params = _reference_steps(jcfg, jparams, tokens,
                                                targets, 3, microbatches)
    opt = H.init_opt_state(params)
    step = H.make_train_step(cfg, device="cpu", hp=H.AdamWConfig(lr=1e-3),
                             num_microbatches=microbatches)
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, torch.from_numpy(tokens),
                                 torch.from_numpy(targets))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    _close_tree(params, want_params, rtol=1e-4, atol=1e-5)
    assert int(opt["step"]) == 3


def test_remat_matches_saving_every_activation():
    _, jparams, cfg = _tiny()
    tokens, targets = (torch.from_numpy(a) for a in _batch())
    runs = []
    for remat in (True, False):
        params = _params(jparams)
        opt = H.init_opt_state(params)
        step = H.make_train_step(cfg, device="cpu", remat=remat,
                                 hp=H.AdamWConfig(lr=1e-3))
        losses = [float(step(params, opt, tokens, targets)[2])
                  for _ in range(2)]
        runs.append((losses, params))
    (l_remat, p_remat), (l_save, p_save) = runs
    np.testing.assert_allclose(l_remat, l_save, rtol=1e-6)
    for a, b in zip(H._flatten(p_remat)[0], H._flatten(p_save)[0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_step_options_and_device():
    cfg = L.LlamaConfig(**_DIMS, dtype=torch.float32)
    assert callable(H.make_train_step(cfg, device="cpu", remat="dots"))
    with pytest.raises(ValueError, match="remat"):
        H.make_train_step(cfg, device="cpu", remat="some")
    assert cfg.flops_per_token() == JL.LlamaConfig(
        **_DIMS).flops_per_token()
    assert L.CONFIGS["llama-7b"].flops_per_token() == \
        JL.CONFIGS["llama-7b"].flops_per_token()


def test_train_step_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = L.LlamaConfig(**_DIMS, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.make_train_step(cfg)
