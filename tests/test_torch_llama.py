"""The port's LLaMA held against the reference on the same weights.

The reference's parameter pytree, through numpy and
`params_from_numpy`, goes through both packages' `forward` and
`loss_fn` on a tiny f32 config (vocab 97, hidden 32, 2 layers, 4 heads,
2 kv heads). Sums run in another order: rtol 1e-5 (atol 1e-6 for logits
near 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()


def _tiny():
    jcfg = JL.LlamaConfig(vocab_size=97, hidden_size=32,
                          intermediate_size=64, num_layers=2, num_heads=4,
                          num_kv_heads=2, max_seq_len=64, dtype=jnp.float32)
    cfg = L.LlamaConfig(vocab_size=97, hidden_size=32, intermediate_size=64,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        max_seq_len=64, dtype=torch.float32)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    params = L.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jcfg, jparams, cfg, params


def test_forward_and_loss_match_reference():
    jcfg, jparams, cfg, params = _tiny()
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 97, (2, 11)).astype(np.int32)
    targets = rs.randint(0, 97, (2, 11)).astype(np.int32)
    ref_logits = np.asarray(JL.forward(jparams, jnp.asarray(tokens), jcfg))
    logits = L.forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5,
                               atol=1e-6)
    ref_loss = float(JL.loss_fn(jparams, jnp.asarray(tokens),
                                jnp.asarray(targets), jcfg))
    loss = float(L.loss_fn(params, torch.from_numpy(tokens),
                           torch.from_numpy(targets), cfg))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)


def test_params_from_numpy_keeps_layout_and_casts():
    _, jparams, cfg, _ = _tiny()
    tree = jax.tree.map(np.asarray, jparams)
    params = L.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert params["blocks"]["wq"].shape == (2, 32, 32)      # [L, in, out]
    assert params["blocks"]["w2"].shape == (2, 64, 32)
    assert params["lm_head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["embed"].float().numpy(),
        torch.tensor(tree["embed"]).to(torch.bfloat16).float().numpy())


def test_init_params_is_seeded_and_shaped():
    cfg = L.CONFIGS["llama-test"]
    a = L.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = L.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["blocks"]["w1"], b["blocks"]["w1"])
    assert a["blocks"]["wk"].shape == (4, 64, 32)           # GQA: 2 kv heads
    assert a["embed"].dtype == torch.float32
    n = sum(t.numel() for t in [a["embed"], a["lm_head"], a["final_norm"],
                                *a["blocks"].values()])
    assert n == cfg.num_params()
