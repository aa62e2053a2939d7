"""The port's hybrid-parallel LLaMA step (`paddle_tpu_torch.distributed
.hybrid` over `distributed.mesh`) against the reference's, eight gloo
ranks on the CPU, spawned once for the module.

- dp2·pp2·tp2, dense and MoE (4 experts, top-2), the reference test's
  config (`tests/test_hybrid_parallel.py:48`): the port's mesh step
  against the reference's mesh step at the same layout on its 8-device
  CPU mesh, loss rtol 2e-5 and every updated parameter, unsharded, atol
  5e-5 (the reference test's tolerances); MoE in two halves, gradients
  and update (`test_dp2_pp2_tp2_moe_matches_the_references_mesh_step`);
- the same layout's gradients, unsharded, are tp·pp = 4 times the
  port's single-device gradients (the reference's psum transposes to
  psum; `distributed/mesh.py`), within 1e-5 of each leaf's largest;
- eval on (dp, pp, tp) = (1, 4, 2), (2, 1, 4), (1, 1, 8); cp layouts
  (dp, pp, tp, cp) = (1, 1, 1, 2), (1, 1, 2, 2), (2, 1, 2, 2),
  (1, 2, 2, 2) and cp with GQA (kv 2): the reference's single-device
  loss, rtol 3e-5, as its own tests hold its mesh;
- the loss falls over 6 steps at dp2·pp2·tp2 and over 5 at
  dp1·pp2·cp2·tp2; `dryrun_multichip`'s layout (`__graft_entry__.py:
  110-113`, MoE over dp) gives a finite loss;
- at world size 1 (this process, gloo) the mesh step's loss and
  gradients equal the single-device step's within 1e-6.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import torch_dist_workers as W
from paddle_tpu.distributed import hybrid as JH
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed import hybrid as H
from paddle_tpu_torch.models import llama as L
from torch_threads import one_torch_thread

one_torch_thread()

WORLD = 8
BASE = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_layers=4, num_heads=4, num_kv_heads=2, max_seq_len=16)
MOE = dict(BASE, num_experts=4, top_k=2)
WIDE = dict(BASE, num_heads=8, num_kv_heads=8)
GQA = dict(BASE, num_heads=8, num_kv_heads=2)
# __graft_entry__.py:110-113 at dp = pp = tp = 2
DRYRUN = dict(vocab_size=64, hidden_size=64, intermediate_size=64,
              num_layers=4, num_heads=8, num_kv_heads=8, max_seq_len=16,
              num_experts=4, top_k=2)
HP = dict(lr=1e-2, weight_decay=0.0, grad_clip=1.0)
EVAL_LAYOUTS = [(1, 4, 2, 1), (2, 1, 4, 1), (1, 1, 8, 1)]
CP_LAYOUTS = [(1, 1, 1, 2), (1, 1, 2, 2), (2, 1, 2, 2), (1, 2, 2, 2)]
CFGS = {"base": BASE, "moe": MOE, "wide": WIDE, "gqa": GQA,
        "dryrun": DRYRUN}


def _jcfg(kw):
    return JL.LlamaConfig(**kw, dtype=jnp.float32)


def _data(kw, B=4, T=16, seed=1):
    tokens = jax.random.randint(jax.random.PRNGKey(seed), (B, T), 0,
                                kw["vocab_size"], jnp.int32)
    return np.asarray(tokens), np.asarray(jnp.roll(tokens, -1, axis=1))


def _cases():
    c = [("dense", "train", BASE, (2, 2, 2, 1), 2, "base", "b", HP),
         ("moe", "train", MOE, (2, 2, 2, 1), 2, "moe", "b", HP),
         ("dense_grads", "grads", BASE, (2, 2, 2, 1), 2, "base", "b", None),
         ("moe_grads", "grads", MOE, (2, 2, 2, 1), 2, "moe", "b", None)]
    c += [(f"eval{lay}", "eval", WIDE, lay, 2, "wide", "b", None)
          for lay in EVAL_LAYOUTS]
    c += [(f"cp{lay}", "eval", WIDE, lay, 1, "wide", "b", None)
          for lay in CP_LAYOUTS]
    c += [("cp_gqa", "eval", GQA, (1, 1, 2, 2), 1, "gqa", "b", None),
          ("falls_pp", "train", BASE, (2, 2, 2, 1), 2, "base", "b",
           dict(lr=5e-3, weight_decay=0.0)),
          ("falls_cp", "train", WIDE, (1, 2, 2, 2), 2, "wide", "b",
           dict(lr=3e-3)),
          ("dryrun", "train", DRYRUN, (2, 2, 2, 1), 2, "dryrun", "d", {})]
    return c


def _ref_mesh_grads(kw, params, tokens, targets):
    """The reference's mesh loss and synced gradients at dp2·pp2·tp2
    (its per-shard step up to the optimizer, :502-505), unsharded."""
    cfg = _jcfg(kw)
    mesh = JH.build_mesh(dp=2, pp=2, tp=2)
    specs = JH.param_specs(cfg)
    shard_loss = JH._make_shard_loss(cfg, 2, 2, 2, 2)

    def per_shard(p, tok, tgt):
        loss, grads = jax.value_and_grad(shard_loss)(p, tok, tgt)
        return lax.psum(loss, "dp"), JH.sync_grads(grads, specs)

    f = jax.jit(jax.shard_map(
        per_shard, mesh=mesh, in_specs=(specs, P("dp", "cp"), P("dp", "cp")),
        out_specs=(P(), specs), check_vma=False))
    loss, grads = f(JH.shard_params(params, mesh, cfg), tokens, targets)
    grads = JH.unstack_pipeline(jax.device_get(grads))
    return float(loss), jax.tree.map(np.asarray, grads)


def _ref_mesh_step(kw, params, tokens, targets):
    cfg = _jcfg(kw)
    mesh = JH.build_mesh(dp=2, pp=2, tp=2)
    sp = JH.shard_params(params, mesh, cfg)
    step = JH.make_train_step(cfg, mesh, num_microbatches=2,
                              hp=JH.AdamWConfig(**HP))
    new_sp, _, loss = step(sp, JH.init_opt_state(sp), tokens, targets)
    got = JH.unstack_pipeline(jax.device_get(new_sp))
    return float(loss), jax.tree.map(np.asarray, got)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks run every case while this process computes the
    reference's side."""
    jparams = {k: JL.init_params(_jcfg(kw), jax.random.PRNGKey(0))
               for k, kw in CFGS.items()}
    params = {k: jax.tree.map(np.asarray, v) for k, v in jparams.items()}
    data = {"b": _data(BASE), "d": _data(DRYRUN, B=4, T=16, seed=1)}
    payload = {"cases": _cases(), "params": params, "data": data,
               "steps": {"falls_pp": 6, "falls_cp": 5}}
    tmp = tmp_path_factory.mktemp("hybrid")
    procs = W.start("hybrid", WORLD, tmp, payload)
    try:
        tokens, targets = data["b"]
        ref = {"dense": _ref_mesh_step(BASE, jparams["base"], tokens,
                                       targets),
               "moe": _ref_mesh_grads(MOE, jparams["moe"], tokens, targets)}
        loss = jax.jit(JL.loss_fn, static_argnums=3,
                       static_argnames="attn_impl")
        ref_loss = {k: float(loss(jparams[k], tokens, targets,
                                  _jcfg(CFGS[k]), attn_impl="xla"))
                    for k in ("wide", "gqa")}
    finally:
        outs = W.finish(procs, tmp)
    return {"port": outs[0], "ref": ref, "ref_loss": ref_loss,
            "params": params, "data": data}


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k2: v2 for k, v in tree.items()
            for k2, v2 in _flat(v, f"{prefix}/{k}" if prefix else k).items()}


def test_dp2_pp2_tp2_dense_matches_the_references_mesh_step(runs):
    port = runs["port"]["dense"]
    ref_loss, ref_params = runs["ref"]["dense"]
    np.testing.assert_allclose(port["losses"][0], ref_loss, rtol=2e-5)
    got, want = _flat(port["params"]), _flat(ref_params)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=5e-5,
                                   err_msg=name)


def test_dp2_pp2_tp2_moe_matches_the_references_mesh_step(runs):
    """The MoE step against the reference's, in its two halves: the
    synced gradients against the reference's mesh gradients (its
    `_make_shard_loss` and `sync_grads` under its shard_map) within 1e-5
    of each leaf's largest, and the updated parameters within 5e-5 of
    the reference's AdamW (`_adamw_update`) of the port's gradients.
    The parameters against the reference's step itself differ at one
    entry of 32,768 (w3, 7.8e-5): AdamW's first step divides a gradient
    by its magnitude plus eps (1e-8), and that entry's gradient is
    1.9e-8, where the two f32 sums differ by 4 % (the float64 value
    lies between them, nearer the port's)."""
    port = runs["port"]["moe"]
    ref_loss, ref_grads = runs["ref"]["moe"]
    np.testing.assert_allclose(port["losses"][0], ref_loss, rtol=2e-5)
    assert port["dropped"] == 0       # parity with moe_mlp needs none
    pgrads = runs["port"]["moe_grads"]["grads"]
    got, want = _flat(pgrads), _flat(ref_grads)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    params = jax.tree.map(jnp.asarray, runs["params"]["moe"])
    grads = jax.tree.map(jnp.asarray, pgrads)
    sq = sum(jnp.sum(g ** 2) for g in jax.tree.leaves(grads))
    upd, _ = jax.jit(JH._adamw_update, static_argnums=3)(
        params, grads, JH.init_opt_state(params), JH.AdamWConfig(**HP), sq)
    for name, w in _flat(jax.tree.map(np.asarray, upd)).items():
        np.testing.assert_allclose(_flat(port["params"])[name], w,
                                   atol=5e-5, err_msg=name)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_mesh_gradients_are_tp_pp_times_the_single_device_ones(runs, kind):
    kw = CFGS["base" if kind == "dense" else "moe"]
    cfg = L.LlamaConfig(**kw, dtype=torch.float32)
    full = L.params_from_numpy(runs["params"]["base" if kind == "dense"
                                              else "moe"], device="cpu")
    tokens, targets = (torch.from_numpy(a) for a in runs["data"]["b"])
    loss, grads = H.loss_and_grads(full, tokens, targets, cfg, 2)
    port = runs["port"][f"{kind}_grads"]
    np.testing.assert_allclose(port["loss"], float(loss), rtol=2e-5)
    got = _flat(port["grads"])
    for name, w in _flat(grads).items():
        w = 4.0 * w.numpy()
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("layout", EVAL_LAYOUTS + CP_LAYOUTS,
                         ids=lambda t: "x".join(map(str, t)))
def test_mesh_layouts_give_the_references_loss(runs, layout):
    key = f"{'cp' if layout[3] > 1 else 'eval'}{layout}"
    np.testing.assert_allclose(runs["port"][key]["loss"],
                               runs["ref_loss"]["wide"], rtol=3e-5,
                               err_msg=str(layout))


def test_cp_with_gqa_gives_the_references_loss(runs):
    np.testing.assert_allclose(runs["port"]["cp_gqa"]["loss"],
                               runs["ref_loss"]["gqa"], rtol=3e-5)


@pytest.mark.parametrize("key", ["falls_pp", "falls_cp"])
def test_the_loss_falls(runs, key):
    losses = runs["port"][key]["losses"]
    assert len(losses) == {"falls_pp": 6, "falls_cp": 5}[key]
    assert losses[-1] < losses[0], losses


def test_the_dryrun_layout_runs(runs):
    res = runs["port"]["dryrun"]
    assert np.isfinite(res["losses"][0])
    assert res["dropped"] is not None and res["dropped"] >= 0


@pytest.mark.parametrize("kw", [BASE, MOE], ids=["dense", "moe"])
def test_the_world1_mesh_step_is_the_single_device_step(kw):
    cfg = L.LlamaConfig(**kw, dtype=torch.float32)
    full = L.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    targets = torch.roll(tokens, -1, 1)
    mesh = H.build_mesh(device="cpu")
    loss1, g1 = H.loss_and_grads(full, tokens, targets, cfg, 2)
    loss2, g2 = H.loss_and_grads(H.shard_params(full, mesh, cfg), tokens,
                                 targets, cfg, 2, mesh=mesh)
    g2 = H.unstack_pipeline(g2)
    assert abs(float(loss2) - float(loss1)) <= 1e-6 * abs(float(loss1))
    for name in g1["blocks"]:
        w = g1["blocks"][name]
        assert (g2["blocks"][name] - w).abs().max() <= \
            1e-6 * w.abs().max(), name
    for name in ("embed", "lm_head", "final_norm"):
        assert (g2[name] - g1[name]).abs().max() <= \
            1e-6 * g1[name].abs().max(), name
    # the step itself: the same loss, before the same update
    hp = H.AdamWConfig(lr=1e-2, weight_decay=0.0)
    p1 = copy.deepcopy(full)
    _, _, l1 = H.make_train_step(cfg, device="cpu", hp=hp,
                                 num_microbatches=2)(
        p1, H.init_opt_state(p1), tokens, targets)
    sp = H.shard_params(full, mesh, cfg)
    _, _, l2 = H.make_train_step(cfg, mesh, 2, hp)(
        sp, H.init_opt_state(sp), tokens, targets)
    assert abs(float(l2) - float(l1)) <= 1e-6 * abs(float(l1))


def test_a_layer_model_waits_for_7b():
    with pytest.raises(NotImplementedError, match="7b"):
        H.make_train_step(torch.nn.Linear(2, 2), H.build_mesh(device="cpu"))
