"""The train step's `remat="dots"` policy held against the reference's.

The reference wraps each block in `jax.checkpoint(...,
policy=dots_saveable)`: matmul outputs are kept and the rest is
recomputed in the backward. The port keeps the outputs of the matrix
products (`aten.mm`, `addmm`, `bmm`) and of A1 and A3, registered as
torch ops, under a selective checkpoint (`models.llama.DOTS_SAVED`).

Config, data and tolerances are `tests/test_torch_train.py`'s (tiny f32
GQA model, three AdamW steps: losses rtol 1e-5, parameters rtol 1e-4
and atol 1e-5). Inside the port the three policies compute the same
values, so `"dots"` and `True` are held equal bit for bit. A1's and
A3's plain forwards are counted: under `"dots"` each runs once a layer
a step, under `True` twice (the recompute). The matrix products are
counted below autograd: `"dots"` runs each block's four projections
once a step, `True` twice.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch.distributed import hybrid as H
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.cuda import fused_ffn as FF
from tests.test_torch_train import (_DIMS, _batch, _close_tree, _params,
                                    _reference_steps, _tiny)
from torch_threads import one_torch_thread

one_torch_thread()


def _port_steps(cfg, params, tokens, targets, n, microbatches, remat):
    opt = H.init_opt_state(params)
    step = H.make_train_step(cfg, device="cpu", hp=H.AdamWConfig(lr=1e-3),
                             num_microbatches=microbatches, remat=remat)
    losses = [float(step(params, opt, torch.from_numpy(tokens),
                         torch.from_numpy(targets))[2]) for _ in range(n)]
    return losses, params


@pytest.mark.parametrize("microbatches", [1, 2])
def test_dots_steps_match_reference(microbatches):
    jcfg, jparams, cfg = _tiny()
    tokens, targets = _batch()
    params = _params(jparams)      # first: the reference step donates
    want_losses, want_params = _reference_steps(
        jcfg, jparams, tokens, targets, 3, microbatches, remat="dots")
    losses, params = _port_steps(cfg, params, tokens, targets, 3,
                                 microbatches, "dots")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    _close_tree(params, want_params, rtol=1e-4, atol=1e-5)


class _CountMM(TorchDispatchMode):
    """Counts `aten.mm` calls that reach the kernels (a product a
    selective checkpoint serves from its cache never does)."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_dots_equals_full_remat_and_runs_each_kernel_once(monkeypatch):
    _, jparams, cfg = _tiny()
    tokens, targets = _batch()
    names = ("flash_attention_fwd_plain", "fused_ffn_plain",
             "flash_attention_bwd_plain", "fused_ffn_bwd_plain")
    calls = dict.fromkeys(names, 0)

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for mod, name in zip((FA, FF, FA, FF), names):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    runs = {}
    for remat in ("dots", True):
        calls.update(dict.fromkeys(names, 0))
        with _CountMM() as mode:
            runs[remat] = _port_steps(cfg, _params(jparams), tokens,
                                      targets, 2, 1, remat)
        runs[remat] += (dict(calls), mode.mm)
    layers, steps = cfg.num_layers, 2
    (l_dots, p_dots, c_dots, mm_dots), (l_full, p_full, c_full, mm_full) = \
        runs["dots"], runs[True]
    assert l_dots == l_full
    for a, b in zip(H._flatten(p_dots)[0], H._flatten(p_full)[0]):
        assert torch.equal(a, b)
    once = layers * steps
    assert c_dots == {"flash_attention_fwd_plain": once,
                      "fused_ffn_plain": once,
                      "flash_attention_bwd_plain": once,
                      "fused_ffn_bwd_plain": once}
    assert c_full == dict(c_dots, flash_attention_fwd_plain=2 * once,
                          fused_ffn_plain=2 * once)
    # the q, k, v, o projections: recomputed under True, kept under "dots"
    assert mm_full - mm_dots == 4 * layers * steps


def test_remat_contract_of_forward_and_loss():
    _, jparams, cfg = _tiny()
    params = _params(jparams)
    tokens, targets = (torch.from_numpy(a) for a in _batch(B=2))
    want = L.loss_fn(params, tokens, targets, cfg)
    for remat in ("dots", True):
        assert torch.equal(L.loss_fn(params, tokens, targets, cfg, remat),
                           want)
    for bad in ("some", "full", 2, None):
        with pytest.raises(ValueError, match="remat"):
            L.forward(params, tokens, cfg, remat=bad)
        with pytest.raises(ValueError, match="remat"):
            L.loss_fn(params, tokens, targets, cfg, remat=bad)
        with pytest.raises(ValueError, match="remat"):
            H.make_train_step(L.LlamaConfig(**_DIMS), device="cpu",
                              remat=bad)
