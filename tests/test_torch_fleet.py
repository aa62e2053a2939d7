"""The port's fleet (`paddle_tpu_torch.distributed.fleet`) against the
reference's (`paddle_tpu.distributed.fleet`, `tests/test_distributed.py`
:100-209).

Eight gloo ranks (spawned once for the module, through
`tests/torch_dist_workers.py`):
- the hybrid topology: every rank's coordinates and groups for
  dp2·pp2·mp2 and dp2·mp2 exactly the reference topology's (its
  `get_coord`, `get_comm_list`), rank 0's also the reference
  `HybridCommunicateGroup`'s;
- at mp 2 (dp inferred 4), each rank holding its shard: the column / row
  pair, the gathering column, the splitting row, `VocabParallelEmbedding`
  and `ParallelCrossEntropy`, forward and gradients, within 1e-5 of the
  reference's dense math (its eager layers are dense); the
  sequence-parallel ops and their backward; the hybrid global-norm clip
  of `HybridParallelOptimizer` against the dense clip; the mp RNG stream
  differing across the pair while the global one does not;
- `distributed_model`'s wrapper for dp, mp and sep, and its
  `NotImplementedError`s naming ROADMAP items 7c (pp, compiled) and 7d
  (the parameter server);
- pure dp 8 through fleet: one all_reduce a reducer bucket a step, none
  from the optimizer, and the mean gradient's SGD step.
In this process: the topology maps against the reference's for more
layouts, the sharding optimizer's partition, and `bench.py`'s
`bert_dp_sharding` at a tiny size (1 layer, D 32) through fleet at world
1: 3 AdamW losses within 1e-5 of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from torch_threads import one_torch_thread

from paddle_tpu.distributed.fleet.base import topology as RT

from paddle_tpu_torch.core import place as pplace
from paddle_tpu_torch.distributed.fleet.base import topology as PT

one_torch_thread()

NAMES = ["dp", "pp", "sharding", "sep", "mp"]
CLIP = 0.1


def _payload():
    rs = np.random.RandomState(0)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return {"mp": {"wc": f(8, 16) * 0.3, "bc": f(16) * 0.1,
                   "wr": f(16, 8) * 0.3, "br": f(8) * 0.1, "x": f(4, 8),
                   "gy": f(4, 8), "h": f(4, 16), "table": f(32, 8),
                   "ids": np.array([[1, 2], [17, 31]]), "ge": f(2, 2, 8),
                   "logits": f(4, 32),
                   "labels": np.array([1, 2, 20, 31]), "seq": f(4, 2, 3),
                   "clip": CLIP}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    payload = _payload()
    tmp = tmp_path_factory.mktemp("fleet")
    procs = W.start("fleet", 8, tmp, payload)
    try:
        ref = _dense(payload["mp"])
    finally:
        outs = W.finish(procs, tmp)
    return {"ranks": outs, "ref": ref}


def _dense(pl):
    """The reference's eager mp layers are dense: the same math in jax."""
    def pair(x, wc, bc, wr, br):
        return ((x @ wc + bc) @ wr + br)

    def obj(x, wc, bc, wr, br):
        return jnp.sum(pair(x, wc, bc, wr, br) * pl["gy"])

    args = [jnp.asarray(pl[k]) for k in ("x", "wc", "bc", "wr", "br")]
    grads = jax.grad(obj, argnums=(0, 1, 2, 3, 4))(*args)
    out = {"y": np.asarray(pair(*args)),
           "grads": [np.asarray(g) for g in grads]}
    out["col_gathered"] = pl["x"] @ pl["wc"] + pl["bc"]
    out["row_split"] = pl["h"] @ pl["wr"] + pl["br"]
    t = jnp.asarray(pl["table"])
    out["emb"] = np.asarray(t[pl["ids"]])
    out["demb"] = np.asarray(jax.grad(
        lambda t: jnp.sum(t[pl["ids"]] * pl["ge"]))(t))
    logits = jnp.asarray(pl["logits"])

    def ce(lg):
        return jax.nn.logsumexp(lg, -1) - jnp.take_along_axis(
            lg, jnp.asarray(pl["labels"])[:, None], -1)[:, 0]

    out["ce"] = np.asarray(ce(logits))
    out["dlogits"] = np.asarray(jax.grad(lambda lg: ce(lg).sum())(logits))
    g = out["grads"][1:]
    norm = np.sqrt(sum(float(np.sum(np.square(x))) for x in g))
    factor = CLIP / max(norm, CLIP)
    out["clipped"] = [np.asarray(a) - gi * factor
                      for a, gi in zip(args[1:], g)]
    return out


def _ref_topology(dims):
    return RT.CommunicateTopology(NAMES, dims)


@pytest.mark.parametrize("key,dims,world", [
    ("dp2pp2mp2", [2, 2, 1, 1, 2], 8), ("dp2mp2", [2, 1, 1, 1, 2], 4)])
def test_hybrid_groups_are_the_references(runs, key, dims, world):
    topo = _ref_topology(dims)
    for r in range(world):
        got = runs["ranks"][r][key]
        assert got["coord"] == topo.get_coord(r)
        for n in NAMES:
            row = [g for g in topo.get_comm_list(n) if r in g]
            assert got["groups"][n] == row[0], (r, n)
        assert got["check"] == list(range(world))
        assert got["first_stage"] == (got["coord"]["pp"] == 0)
        assert got["last_stage"] == (got["coord"]["pp"] == dims[1] - 1)
    # the reference's HybridCommunicateGroup is rank 0's view
    hcg = RT.HybridCommunicateGroup(topo)
    got = runs["ranks"][0][key]
    for n in NAMES:
        assert got["groups"][n] == list(hcg._groups[n].ranks)


@pytest.mark.parametrize("dims", [[2, 2, 1, 1, 2], [1, 2, 2, 1, 2],
                                  [2, 1, 2, 2, 1], [4, 1, 1, 1, 2]])
def test_topology_maps_are_the_references(dims):
    ref, port = _ref_topology(dims), PT.CommunicateTopology(NAMES, dims)
    assert port.world_size() == ref.world_size()
    for r in range(ref.world_size()):
        assert port.get_coord(r) == ref.get_coord(r)
        assert port.get_rank(**ref.get_coord(r)) == r
    for n in NAMES:
        assert port.get_comm_list(n) == ref.get_comm_list(n)
        for i in range(ref.get_dim(n)):
            assert port.get_axis_list(n, i) == ref.get_axis_list(n, i)
    for fused in (["dp", "pp"], ["pp", "mp"], ["dp", "sharding", "mp"]):
        assert port.get_fused_ranks(fused) == ref.get_fused_ranks(fused)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert np.asarray(got).shape == want.shape
    assert np.abs(np.asarray(got) - want).max() <= tol * max(
        np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("r", [0, 1])
def test_mp_layers_match_the_dense_reference(runs, r):
    got, ref = runs["ranks"][r]["mp"], runs["ref"]
    blk = slice(r * 8, (r + 1) * 8)
    dx, dwc, dbc, dwr, dbr = ref["grads"]
    _close(got["y"], ref["y"])
    _close(got["dx"], dx)
    _close(got["dwc"], dwc[:, blk])
    _close(got["dbc"], dbc[blk])
    _close(got["dwr"], dwr[blk])
    _close(got["dbr"], dbr)
    assert got["distributed"] == [True, False]
    _close(got["col_gathered"], ref["col_gathered"])
    _close(got["row_split"], ref["row_split"])
    _close(got["emb"], ref["emb"])
    _close(got["demb"], ref["demb"][r * 16:(r + 1) * 16])
    _close(got["ce"][:, 0], ref["ce"])
    _close(got["dlogits"], ref["dlogits"][:, r * 16:(r + 1) * 16])


@pytest.mark.parametrize("r", [0, 1])
def test_the_hybrid_clip_is_the_dense_clip(runs, r):
    got, ref = runs["ranks"][r]["mp"]["clipped"], runs["ref"]["clipped"]
    blk = slice(r * 8, (r + 1) * 8)
    wc, bc, wr, br = ref
    for g, w in zip(got, (wc[:, blk], bc[blk], wr[blk], br)):
        _close(g, w)


def test_sequence_parallel_ops(runs):
    seq = _payload()["mp"]["seq"]
    for r in (0, 1):
        sp = runs["ranks"][r]["mp"]["sp"]
        blk = seq[r * 2:(r + 1) * 2]
        np.testing.assert_array_equal(sp["scatter"], blk)
        np.testing.assert_array_equal(sp["gather"], seq)
        np.testing.assert_array_equal(sp["all_gather"], seq)
        np.testing.assert_array_equal(sp["reduce_scatter"], 2 * blk)
        # 1 (gather) + 2 (all_gather) + 3 (reduce_scatter, back through
        # the all_gather), the all_gathers' backward summing the pair
        np.testing.assert_array_equal(sp["grad"], np.full_like(seq, 11.0))


def test_sequence_parallel_parameters_sum_over_mp(runs):
    """A marked parameter's gradient (2 rows of r + 1 on rank r) summed
    over the pair, 2 * 1 + 2 * 2; an unmarked one stays the rank's."""
    for r in (0, 1):
        mp = runs["ranks"][r]["mp"]
        assert mp["sp_marked"] == 1
        np.testing.assert_array_equal(mp["sp_param_grad"],
                                      np.full((3, 3), 6.0, np.float32))
        np.testing.assert_array_equal(mp["sp_bias_grad"],
                                      np.full(3, 2.0, np.float32))


def test_the_rng_tracker_decorrelates_mp_ranks(runs):
    a, b = (runs["ranks"][r]["mp"] for r in (0, 1))
    assert not np.array_equal(a["rng_mp"], b["rng_mp"])
    np.testing.assert_array_equal(a["rng_global"], b["rng_global"])


def test_distributed_model_routes_by_strategy(runs):
    o = runs["ranks"][0]
    assert o["inferred_dp"] == 4
    w = o["wrappers"]
    assert (w["dp"], w["mp"], w["sep"]) == ("DataParallel", "TensorParallel",
                                            "SegmentParallel")
    assert {w[k] for k in ("dp_opt", "mp_opt", "sep_opt")} == {
        "HybridParallelOptimizer"}
    e = o["errors"]
    assert "7c" in e["pp"] and "PipelineParallel" in e["pp"]
    assert "7c" in e["compiled"] and "7d" in e["ps"]


@pytest.mark.parametrize("r", range(8))
def test_pure_dp_reduces_each_gradient_once(runs, r):
    """dp 8 through fleet: DataParallel's reducer issues one all_reduce
    a bucket a step and `HybridParallelOptimizer` none of its own; the
    SGD step is the mean gradient's (rows of rank + 1: mean 4.5)."""
    o = runs["ranks"][r]["dp_step"]
    assert o["buckets"] == 2                  # weight, bias (last bucket)
    for issued in o["issued"]:
        assert issued == {f"all_reduce/{o['axis']}": o["buckets"]}
    (w0, b0), (w1, b1) = o["start"], o["end"]
    np.testing.assert_allclose(w1, w0 - 2 * 0.1 * 2 * 4.5, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(b1, b0 - 2 * 0.1 * 2, rtol=0, atol=1e-6)


def test_the_sharding_partition_is_the_references():
    from paddle_tpu.distributed.fleet.meta_optimizers.dygraph_optimizer \
        import dygraph_sharding_optimizer as RS
    from paddle_tpu_torch.distributed.fleet.meta_optimizers \
        .dygraph_optimizer import dygraph_sharding_optimizer as PS

    shapes = [[64, 64], [64], [128, 32], [7], [32, 32], [300], [16, 16]]
    params = [type("P", (), {"shape": s, "i": i})()
              for i, s in enumerate(shapes)]
    for n in (2, 3, 4):
        got = PS.DygraphShardingOptimizer._partition_parameters(
            type("S", (), {"_nranks": n})(), params)
        want = RS.DygraphShardingOptimizer._partition_parameters(
            type("S", (), {"_nranks": n})(), params)
        assert {k: [p.i for p in v] for k, v in got.items()} == \
            {k: [p.i for p in v] for k, v in want.items()}


# -- bench.py's bert_dp_sharding, tiny ------------------------------------------

B, T, V, D, L = 4, 16, 64, 32, 1


def _bert(nn):
    class Bert(nn.Layer):
        def __init__(self):
            super().__init__()
            self.tok = nn.Embedding(V, D)
            self.pos = nn.Embedding(T, D)
            layer = nn.TransformerEncoderLayer(D, 8, 4 * D, dropout=0.0)
            self.encoder = nn.TransformerEncoder(layer, L)
            self.head = nn.Linear(D, V)

        def forward(self, tokens, positions):
            x = self.tok(tokens) + self.pos(positions)
            return self.head(self.encoder(x))

    return Bert()


def _bert_losses(paddle, fleet, model, steps=3):
    strategy = fleet.DistributedStrategy()
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(paddle.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()))
    rs = np.random.RandomState(0)
    tokens = paddle.to_tensor(rs.randint(0, V, (B, T)))
    positions = paddle.to_tensor(np.arange(T))
    labels = paddle.to_tensor(rs.randint(0, V, (B * T,)))
    losses = []
    for _ in range(steps):
        logits = model(tokens, positions)
        loss = paddle.nn.functional.cross_entropy(
            logits.reshape([-1, V]), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, type(opt).__name__


def test_bert_dp_sharding_tiny_matches_the_reference():
    import paddle_tpu as rpaddle
    from paddle_tpu.distributed import fleet as rfleet
    import paddle_tpu_torch as ppaddle
    from paddle_tpu_torch.distributed import collective as pcoll
    from paddle_tpu_torch.distributed import fleet as pfleet

    rpaddle.seed(0)
    rmodel = _bert(rpaddle.nn)
    state = {k: np.asarray(v._data) for k, v in rmodel.state_dict().items()}
    want, rkind = _bert_losses(rpaddle, rfleet, rmodel)
    pplace.set_device("cpu")
    try:
        pmodel = _bert(ppaddle.nn)
        missing, unexpected = pmodel.set_state_dict(state)
        assert not missing and not unexpected
        pcoll.init_parallel_env("cpu")
        got, pkind = _bert_losses(ppaddle, pfleet, pmodel)
    finally:
        pplace._current[0] = None
    assert pkind == rkind == "HybridParallelOptimizer"
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# -- chip_smoke.py's phase 5c on the CPU -----------------------------------------

TINY_BERT = dict(V=64, T=16, D=32, heads=8, ffn=128, layers=1, B=4,
                 activation="relu")


def test_phase_5c_runs_on_the_cpu(capsys):
    """`BERT_DP` and `DP_OVERLAP` as the card runs them, on the CPU at a
    tiny size (the times are the card's to print): through fleet, its
    losses the CPU's own and the plain loop's; the six DataParallel
    times, the int8 wire ratio from the buckets, the overlapped run's
    parameters the barrier run's."""
    import chip_smoke

    cpu = torch.device("cpu")
    try:
        bert = chip_smoke.bert_dp_phase(torch, np, cpu, TINY_BERT)
        dp = chip_smoke.dp_overlap_phase(
            torch, np, cpu, dict(din=16, dhid=32, B=8, steps=3))
    finally:
        pplace._current[0] = None
    assert bert["mode"].startswith("fleet")
    assert bert["optimizer"] == "HybridParallelOptimizer"
    assert bert["collectives_per_step"] == {}     # a world of one
    assert bert["card_losses"] == bert["cpu_losses"]
    assert bert["max_rel_to_plain"] <= 1e-6
    for k in ("barrier", "overlap", "shard"):
        assert dp[k + "_ms"] > 0 and dp[k + "_int8_ms"] > 0
    assert dp["overlap_params_equal_barrier"]
    assert dp["int8_wire_ratio"] == dp["ref_bytes"] / dp["wire_bytes"]
    out = capsys.readouterr().out
    assert "BERT_DP {" in out and "DP_OVERLAP {" in out
