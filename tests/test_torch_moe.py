"""The port's MoE LLaMA (`paddle_tpu_torch.models.llama`, item 7a)
against the reference's, in this process: the config's counts, the
expert leaves of `init_params`, `params_from_numpy` carrying the
reference's MoE tree, `moe_mlp` and the MoE `loss_fn` on the reference's
weights (f32, rtol 1e-5), and the mesh step's capacity rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed import hybrid as H
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

DIMS = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=16,
            num_experts=4, top_k=2)
# Mixtral-8x7B's published widths (Jiang et al., 2024)
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_layers=32, num_heads=32, num_kv_heads=8,
               rope_theta=1e6, num_experts=8, top_k=2)


@pytest.mark.parametrize("dims", [DIMS, MIXTRAL, dict(DIMS, top_k=1),
                                  dict(DIMS, num_experts=0)],
                         ids=["tiny", "mixtral", "top1", "dense"])
def test_counts_are_the_references(dims):
    ours, theirs = L.LlamaConfig(**dims), JL.LlamaConfig(**dims)
    assert ours.num_params() == theirs.num_params()
    assert ours.flops_per_token() == theirs.flops_per_token()


@pytest.fixture(scope="module")
def ref_model():
    cfg = JL.LlamaConfig(**DIMS, dtype=jnp.float32)
    params = jax.jit(JL.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 64,
                                jnp.int32)
    return cfg, params, tokens


def test_init_params_has_the_references_leaves(ref_model):
    ours = L.init_params(L.LlamaConfig(**DIMS), torch.Generator()
                         .manual_seed(0), device="cpu")
    theirs = ref_model[1]
    shapes = lambda t: {k: (shapes(v) if isinstance(v, dict)  # noqa: E731
                            else tuple(v.shape)) for k, v in t.items()}
    assert shapes(ours) == shapes(theirs)
    assert ours["blocks"]["w1"].shape == (2, 4, 32, 64)
    assert ours["blocks"]["router"].shape == (2, 32, 4)


def test_params_from_numpy_and_moe_mlp_are_the_references(ref_model):
    cfg, params, _ = ref_model
    ours = L.params_from_numpy(jax.tree.map(np.asarray, params),
                               device="cpu")
    for k, v in params["blocks"].items():
        np.testing.assert_array_equal(ours["blocks"][k].numpy(),
                                      np.asarray(v))
    x = np.random.RandomState(2).randn(2, 16, 32).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], params["blocks"])
    want = jax.jit(lambda x, lp: JL.moe_mlp(x, lp, cfg))(x, lp)
    got = L.moe_mlp(torch.from_numpy(x), L.layer(ours, 0),
                    L.LlamaConfig(**DIMS, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_moe_loss_is_the_references(ref_model):
    cfg, params, tokens = ref_model
    targets = jnp.roll(tokens, -1, axis=1)
    want = jax.jit(lambda p, t, y: JL.loss_fn(p, t, y, cfg,
                                              attn_impl="xla"))(
        params, tokens, targets)
    ours = L.params_from_numpy(jax.tree.map(np.asarray, params),
                               device="cpu")
    pcfg = L.LlamaConfig(**DIMS, dtype=torch.float32)
    tok = torch.from_numpy(np.asarray(tokens))
    for remat in (False, True):
        got = L.loss_fn(ours, tok, torch.from_numpy(np.asarray(targets)),
                        pcfg, remat)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the single-device train step takes a MoE config
    step = H.make_train_step(pcfg, device="cpu",
                             hp=H.AdamWConfig(lr=1e-2))
    opt = H.init_opt_state(ours)
    losses = [float(step(ours, opt, tok, torch.roll(tok, -1, 1))[2])
              for _ in range(3)]
    assert losses[-1] < losses[0], losses


def test_the_capacity_rule_is_the_references():
    """`_moe_ffn`'s slots an expert: max(1, N·k // E) · 2, at most N
    (reference hybrid.py:253)."""
    cfg = L.LlamaConfig(**DIMS)
    for n in (1, 3, 32, 4096):
        assert H.moe_capacity(n, cfg) == min(max(1, n * 2 // 4) * 2, n)
    assert H.moe_capacity(2048, L.LlamaConfig(**MIXTRAL)) == 1024
