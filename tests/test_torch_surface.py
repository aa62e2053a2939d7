"""The port's generated op surface and the rest of item 6b-iii against
the reference.

- `ops/ops.yaml`: the port's copy is byte-equal to the reference's and
  `schema.load_manifest` parses it as the reference's does;
  `ops/generated_bindings.py` equals a fresh run of
  `tools/gen_op_bindings_torch.py`; every one of the 690 names has a
  def with the manifest's signature; 673 resolve to the registry and
  the other 17 raise `WaitingOp` naming ROADMAP item 9; unknown
  keywords and wrong arity raise a TypeError naming the op, as the
  reference's bindings do.
- The names: the top-level, `nn`, `nn.functional`, `autograd` and
  `distributed` namespaces hold the reference's, less `LATER` (each
  missing name with the item that brings it), and
  `distributed.collective` its functions and classes.
- `tensor/compat_ext.py`: its `__all__` is the reference's (192
  names), and its functions give the reference's values on the inputs
  of `tests/test_api_parity.py` (rtol 1e-5); the random helpers keep
  their laws.
- `save` / `load` across packages, both ways, for the state_dict of the
  LeNet and of an `nn.LSTM`; the CRC footer catches a flipped byte.
- `Layer.functional_state` / `load_functional_state`.
- The `FLAGS_quant_*` surface: `resolve_quant_mode`, `resolve_manifest`,
  and the engine and predictor reading the flags when their arguments
  are None, an explicit argument winning.
"""
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch import _C_ops
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.ops import generated_bindings as gen
from paddle_tpu_torch.ops import schema
from paddle_tpu_torch.ops.dispatch import OPS as PORT_OPS
from paddle_tpu_torch.ops.kernels._util import WAITING, WaitingOp
from paddle_tpu_torch.tensor.toplevel import __all__ as TOPLEVEL
from test_torch_op_parity import _sig_args
from torch_threads import one_torch_thread

one_torch_thread()

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


def _manifest():
    from paddle_tpu.ops.schema import load_manifest
    return load_manifest()


# -- the manifest and the bindings -------------------------------------------

def test_the_ports_manifest_is_the_references():
    assert schema.MANIFEST_PATH.read_bytes() == \
        (ROOT / "paddle_tpu" / "ops" / "ops.yaml").read_bytes()
    assert schema.load_manifest() == _manifest()
    assert len(schema.load_manifest()) == 690


def test_generated_bindings_equal_a_fresh_generation():
    spec = importlib.util.spec_from_file_location(
        "gen_op_bindings_torch", ROOT / "tools" / "gen_op_bindings_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert Path(tool.OUT_PATH).read_text() == tool.generate()
    assert tool.main(check=True) == 0


MANIFEST = schema.load_manifest()


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_every_binding_carries_the_manifest_signature(name):
    fn = getattr(gen, name)
    assert _sig_args(fn) == MANIFEST[name]["args"]
    if name in WAITING:
        item = WAITING[name]._waiting_item
        assert item == 9
        assert name in gen.WAITING and name not in PORT_OPS
        with pytest.raises(WaitingOp, match=f"ROADMAP item {item}"):
            fn(*[None] * _required(fn))
        assert not hasattr(_C_ops, name)
        # the top level's own wrappers (`shape`) stand in front of ops
        assert not hasattr(port, name) or name in TOPLEVEL
    else:
        assert name in PORT_OPS
        assert getattr(_C_ops, name) is fn
        assert _sig_args(PORT_OPS[name]) == MANIFEST[name]["args"]


def _required(fn):
    return sum(1 for p in inspect.signature(fn).parameters.values()
               if p.default is inspect.Parameter.empty
               and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))


def test_the_registry_holds_626_and_64_wait():
    names = set(MANIFEST)
    assert len(set(PORT_OPS) & names) == 673
    assert set(PORT_OPS) <= names
    assert set(WAITING) == names - set(PORT_OPS) == set(gen.WAITING)
    assert len(WAITING) == 17
    assert sorted(dir(_C_ops)) == sorted(set(PORT_OPS))


def test_bindings_reject_bad_calls_naming_the_op():
    x = port.to_tensor(np.ones(3, np.float32))
    for mod in (ref._C_ops, _C_ops):
        with pytest.raises(TypeError, match="abs"):
            mod.abs(x, bogus=1)
        with pytest.raises(TypeError, match="add"):
            mod.add(x)
        with pytest.raises(TypeError, match="scale"):
            mod.scale(x, 1.0, 0.0, True, 2.0, 3.0, 4.0)
    with pytest.raises(AttributeError, match="ops.yaml"):
        _C_ops.no_such_op


def test_the_bindings_are_the_public_surface():
    x = port.to_tensor(np.array([1.0, 4.0], np.float32))
    assert port.sqrt is gen.sqrt and port.add is gen.add
    np.testing.assert_allclose(x.sqrt().numpy(), [1.0, 2.0])
    assert port.yolo_box.__name__ == "yolo_box"
    assert port.Tensor.sqrt is gen.sqrt
    # the wrappers that override an op of the same name, as in the
    # reference's __init__
    assert port.shape(x).numpy().tolist() == [2]
    assert int(port.numel(x)) == 2


# -- the names ----------------------------------------------------------------

# the reference's names the port leaves to later items
LATER = {
    "item 7d (store, checkpoint, elastic, auto-parallel, the hooks)": {
        "distributed": {"TCPStore", "CheckpointManager", "Partial",
                        "Placement", "ProcessMesh", "Replicate", "Shard",
                        "ShardingStage1", "ShardingStage2",
                        "ShardingStage3", "dtensor_from_fn", "get_mesh",
                        "local_map", "reshard", "set_mesh", "shard_layer",
                        "shard_optimizer", "shard_tensor",
                        "unshard_dtensor"},
        # the collective layer's chaos, watchdog, epoch-fence and
        # live-world hooks (reference collective.py:479-510, :752-805)
        "distributed.collective": {
            "set_chaos_hook", "set_world_changed_hook", "set_live_world_fn",
            "current_world_size", "replace_default_group",
            "gang_restart_barrier", "EpochChangedError"}},
    "item 8 (observability, profiler)": {
        "top": {"observability", "profiler"}},
    "item 9 (the long tail)": {
        "top": {"Model", "audio", "disable_static", "distribution",
                "enable_static", "fft", "flops", "geometric", "hapi", "hub",
                "jit", "linalg", "metric", "pir", "quantization", "signal",
                "sparse", "static", "summary", "text", "utils", "version"}},
    # module attributes of the reference that are not API: its
    # `from __future__ import annotations`, and imports seen by dir()
    "not API": {"top": {"annotations"},
                "nn.functional": {"Tensor", "np"},
                # the single controller's test mode: every rank is a
                # process of its own in the port
                "distributed.collective": {"simulate_rank_major"}},
}


def _static_imports(path):
    """The names a package's __init__ binds by import (`from . import
    x`, `from .x import y`, `import x`): its modules that are API."""
    import ast
    out = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _names(mod):
    """The public names of `mod`, less the submodules that only another
    test's import put there (a package gains `x` once `pkg.x` is
    imported anywhere in the process)."""
    api = _static_imports(mod.__file__)
    return {n for n in dir(mod) if not n.startswith("_")
            and (not inspect.ismodule(getattr(mod, n)) or n in api)}


def _later(where):
    return set().union(*(v.get(where, set()) for v in LATER.values()))


@pytest.mark.parametrize("where", ["top", "nn", "nn.functional",
                                   "autograd", "distributed"])
def test_namespaces_hold_the_references_names(where):
    r = ref if where == "top" else __import__(
        f"paddle_tpu.{where}", fromlist=["x"])
    p = port if where == "top" else __import__(
        f"paddle_tpu_torch.{where}", fromlist=["x"])
    want = _names(r) - _later(where)
    missing = []
    for n in sorted(want):
        try:
            getattr(p, n)
        except NotImplementedError:
            assert n in WAITING       # an op of item 7 or 9, by name
        except AttributeError:
            missing.append(n)
    assert not missing, missing
    for n in _later(where):
        assert n in _names(r), n       # the list names real names only
        assert not hasattr(p, n), n
    if where != "top":
        assert _names(p) - _names(r) == set()


def test_the_collective_module_holds_the_references_functions():
    """Every function and class the reference's `distributed.collective`
    defines, less `LATER`, is the port's."""
    from paddle_tpu.distributed import collective as RC
    from paddle_tpu_torch.distributed import collective as PC
    own = {n for n, v in vars(RC).items() if not n.startswith("_")
           and (inspect.isfunction(v) or inspect.isclass(v))
           and v.__module__ == RC.__name__}
    later = _later("distributed.collective")
    assert not (own - later) - set(dir(PC)), sorted((own - later)
                                                    - set(dir(PC)))
    for n in later - {"EpochChangedError"}:
        assert n in own and not hasattr(PC, n), n


# -- compat_ext -----------------------------------------------------------------

X = np.random.RandomState(0).randn(3, 4).astype(np.float32)
A = np.random.RandomState(1).randn(4, 3).astype(np.float32)
B = np.random.RandomState(2).randn(5, 3).astype(np.float32)
Y = np.random.RandomState(3).randn(5, 7).astype(np.float32)


def test_compat_names_are_the_references():
    from paddle_tpu.tensor import compat_ext as RC
    from paddle_tpu_torch.tensor import compat_ext as PC
    assert sorted(PC.__all__) == sorted(RC.__all__)
    assert len(set(PC.__all__)) == 192


def _t(pd, a):
    return pd.to_tensor(np.asarray(a))


COMPAT = {
    "hstack": lambda pd: pd.hstack([_t(pd, X), _t(pd, X)]),
    "hstack_0d": lambda pd: pd.hstack([_t(pd, np.float32(1.0)),
                                       _t(pd, np.float32(2.0))]),
    "vstack": lambda pd: pd.vstack([_t(pd, X), _t(pd, X)]),
    "row_stack": lambda pd: pd.row_stack([_t(pd, X), _t(pd, X)]),
    "dstack": lambda pd: pd.dstack([_t(pd, X), _t(pd, X)]),
    "column_stack": lambda pd: pd.column_stack([_t(pd, X[:, 0]),
                                                _t(pd, X)]),
    "tensor_split": lambda pd: pd.tensor_split(_t(pd, np.arange(10.0)), 3),
    "tensor_split_indices": lambda pd: pd.tensor_split(_t(pd, X), [1, 3],
                                                       axis=1),
    "hsplit": lambda pd: pd.hsplit(_t(pd, X), 2),
    "vsplit": lambda pd: pd.vsplit(_t(pd, Y), [2]),
    "dsplit": lambda pd: pd.dsplit(_t(pd, X.reshape(1, 3, 4)), 2),
    "atleast": lambda pd: [pd.atleast_1d(_t(pd, np.float32(3.0))),
                           pd.atleast_2d(_t(pd, np.float32(3.0))),
                           pd.atleast_3d(_t(pd, np.arange(3.0)))],
    "unflatten": lambda pd: pd.unflatten(_t(pd, Y), 1, [1, 7]),
    "matrix_transpose": lambda pd: pd.matrix_transpose(_t(pd, X)),
    "t": lambda pd: pd.t(_t(pd, X)),
    "rank": lambda pd: pd.rank(_t(pd, X)),
    "diff": lambda pd: pd.diff(_t(pd, X)),
    "diff_prepend": lambda pd: pd.diff(_t(pd, X), n=2, axis=0,
                                       prepend=_t(pd, X[:1])),
    "cdist": lambda pd: pd.cdist(_t(pd, A), _t(pd, B)),
    "cdist_p1": lambda pd: pd.cdist(_t(pd, A), _t(pd, B), p=1.0),
    "cdist_naive": lambda pd: pd.cdist(
        _t(pd, A), _t(pd, B), compute_mode="donot_use_mm_for_euclid_dist"),
    "pdist": lambda pd: pd.pdist(_t(pd, A)),
    "pdist_inf": lambda pd: pd.pdist(_t(pd, A), p=float("inf")),
    "diagonal_scatter": lambda pd: pd.diagonal_scatter(
        _t(pd, Y), _t(pd, np.zeros(5, np.float32))),
    "diagonal_scatter_offset": lambda pd: pd.diagonal_scatter(
        _t(pd, Y), _t(pd, np.ones(5, np.float32)), offset=1),
    "masked_scatter": lambda pd: pd.masked_scatter(
        _t(pd, np.zeros((2, 2), np.float32)),
        _t(pd, np.array([[True, False], [False, True]])),
        _t(pd, np.array([[9.0, 8.0], [7.0, 6.0]], np.float32))),
    "select_scatter": lambda pd: pd.select_scatter(
        _t(pd, Y), _t(pd, np.ones(7, np.float32)), axis=0, index=2),
    "slice_scatter": lambda pd: pd.slice_scatter(
        _t(pd, Y), _t(pd, np.ones((5, 2), np.float32)), [1], [1], [5], [2]),
    "index_fill": lambda pd: pd.index_fill(
        _t(pd, Y), _t(pd, np.array([0, 3])), 1, 2.5),
    "scatter_nd": lambda pd: pd.scatter_nd(
        _t(pd, np.array([[1], [3]])), _t(pd, np.ones((2, 4), np.float32)),
        [5, 4]),
    "take_wrap": lambda pd: pd.take(_t(pd, X), _t(pd, np.array([13])),
                                    mode="wrap"),
    "take_clip": lambda pd: pd.take(_t(pd, X), _t(pd, np.array([-3, 40]))),
    "bucketize": lambda pd: pd.bucketize(
        _t(pd, np.array([1.5, 2.5, 2.0])), _t(pd, np.array([1.0, 2.0, 3.0]))),
    "bucketize_right_int32": lambda pd: pd.bucketize(
        _t(pd, np.array([1.5, 2.0])), _t(pd, np.array([1.0, 2.0, 3.0])),
        out_int32=True, right=True),
    "frexp": lambda pd: pd.frexp(_t(pd, np.array([8.0, 0.3, -5.0],
                                                 np.float32))),
    "trapezoid": lambda pd: pd.trapezoid(_t(pd, np.array([1.0, 2.0, 3.0]))),
    "trapezoid_x": lambda pd: pd.trapezoid(_t(pd, X), x=_t(pd, X[0]),
                                           axis=-1),
    "cumulative_trapezoid": lambda pd: pd.cumulative_trapezoid(
        _t(pd, np.arange(10.0, dtype=np.float32).reshape(2, 5)), axis=0),
    "cumulative_trapezoid_dx": lambda pd: pd.cumulative_trapezoid(
        _t(pd, X), dx=0.5),
    "polar": lambda pd: pd.polar(_t(pd, np.array([1.0, 2.0], np.float32)),
                                 _t(pd, np.array([np.pi / 2, 0.3],
                                                 np.float32))),
    "sgn_complex": lambda pd: pd.sgn(_t(pd, np.array([3 + 4j, 0j],
                                                     np.complex64))),
    "sgn": lambda pd: pd.sgn(_t(pd, X)),
    "sinc": lambda pd: pd.sinc(_t(pd, X)),
    "neg": lambda pd: pd.neg(_t(pd, X)),
    "signbit": lambda pd: pd.signbit(_t(pd, X)),
    "isin": lambda pd: pd.isin(_t(pd, np.array([1, 5, 7])),
                               _t(pd, np.array([5, 7]))),
    "isneginf_isposinf_isreal": lambda pd: [
        f(_t(pd, np.array([-np.inf, 1.0, np.inf], np.float32)))
        for f in (pd.isneginf, pd.isposinf, pd.isreal)],
    "gammainc": lambda pd: pd.gammainc(_t(pd, np.abs(X) + 0.5),
                                       _t(pd, np.abs(X.T.T) + 1.0)),
    "multigammaln": lambda pd: pd.multigammaln(_t(pd, np.abs(X) + 2.0), 2),
    "tensordot": lambda pd: pd.tensordot(_t(pd, X), _t(pd, X.T), axes=1),
    "cartesian_prod": lambda pd: pd.cartesian_prod(
        [_t(pd, np.array([1, 2])), _t(pd, np.array([3, 4]))]),
    "combinations": lambda pd: pd.combinations(_t(pd, np.array([10, 20, 30])),
                                               r=2),
    "combinations_replacement": lambda pd: pd.combinations(
        _t(pd, np.array([10, 20, 30])), r=2, with_replacement=True),
    "vander": lambda pd: pd.vander(_t(pd, np.array([1.0, 2.0, 3.0],
                                                   np.float32)), 4),
    "vander_increasing": lambda pd: pd.vander(
        _t(pd, np.array([1.0, 2.0, 3.0], np.float32)), increasing=True),
    "block_diag": lambda pd: pd.block_diag([_t(pd, X), _t(pd, A[:2])]),
    "histogram_bin_edges": lambda pd: pd.histogram_bin_edges(_t(pd, X),
                                                             bins=5),
    "histogram_bin_edges_range": lambda pd: pd.histogram_bin_edges(
        _t(pd, X), bins=4, min=-1.0, max=1.0),
    "histogramdd": lambda pd: pd.histogramdd(_t(pd, A), bins=3),
    "nanquantile": lambda pd: pd.nanquantile(
        _t(pd, np.where(X > 1, np.nan, X)), 0.3, axis=1),
    "cholesky_inverse": lambda pd: pd.cholesky_inverse(_t(pd, np.linalg.cholesky(
        A.T @ A + 3 * np.eye(3, dtype=np.float32)))),
    "cholesky_inverse_upper": lambda pd: pd.cholesky_inverse(_t(
        pd, np.linalg.cholesky(A.T @ A + 3 * np.eye(3, dtype=np.float32)).T),
        upper=True),
    "broadcast_shape": lambda pd: np.array(pd.broadcast_shape([2, 1, 3],
                                                              [4, 3])),
    "view_as": lambda pd: pd.view_as(_t(pd, X), _t(pd, A)),
    "view": lambda pd: pd.view(_t(pd, X), [2, 6]),
    "predicates": lambda pd: np.array([
        pd.is_floating_point(_t(pd, X)), pd.is_integer(_t(pd, X)),
        pd.is_complex(_t(pd, X)), pd.is_integer(_t(pd, np.arange(3)))]),
    "where_": lambda pd: pd.where_(_t(pd, X > 0), _t(pd, X),
                                   _t(pd, np.zeros_like(X))),
    "cos_": lambda pd: pd.cos_(_t(pd, X)),
    "multiply_": lambda pd: pd.multiply_(_t(pd, X), _t(pd, X)),
    "less": lambda pd: pd.less(_t(pd, X), _t(pd, X.T.T * 0.5)),
    "mod_": lambda pd: pd.mod_(_t(pd, np.abs(X) + 1), _t(pd, np.full_like(
        X, 0.7))),
    "bitwise_invert": lambda pd: pd.bitwise_invert(_t(pd, np.arange(4))),
}


def _np(o):
    if isinstance(o, (list, tuple)):
        return [_np(v) for v in o]
    return np.asarray(o.numpy() if hasattr(o, "numpy") else o)


def _close(r, p, what):
    if isinstance(r, list):
        assert len(p) == len(r), what
        for a, b in zip(r, p):
            _close(a, b, what)
        return
    assert p.shape == r.shape, (what, p.shape, r.shape)
    if r.dtype.kind in "fc":
        assert p.dtype.kind == r.dtype.kind, (what, p.dtype, r.dtype)
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(p, r, err_msg=what)


@pytest.mark.parametrize("name", sorted(COMPAT))
def test_compat_functions_match_the_reference(name):
    _close(_np(COMPAT[name](ref)), _np(COMPAT[name](port)), name)


def test_compat_inplace_spellings_rebind():
    z = port.to_tensor(np.array([0.5], np.float32))
    assert port.cos_(z) is z
    np.testing.assert_allclose(z.numpy(), np.cos(0.5), rtol=1e-6)
    w = port.to_tensor(np.array([1.0, 2.0], np.float32))
    port.multiply_(w, port.to_tensor(np.array([3.0, 3.0], np.float32)))
    np.testing.assert_allclose(w.numpy(), [3.0, 6.0])
    x = port.to_tensor(X)
    assert x.acosh_ is not None and x.put_along_axis_ is not None
    assert port.Tensor.tensor_split is port.tensor_split


def test_compat_sampling_and_utilities():
    port.seed(0)
    z = port.to_tensor(np.zeros((2000,), np.float32))
    port.bernoulli_(z, p=0.3)
    assert set(np.unique(z.numpy())) <= {0.0, 1.0}
    assert 0.25 < float(z.numpy().mean()) < 0.35
    g = port.to_tensor(np.zeros((500,), np.float32))
    port.geometric_(g, 0.5)
    assert (g.numpy() >= 1).all() and abs(g.numpy().mean() - 2.0) < 0.3
    assert (port.log_normal(shape=[200]).numpy() > 0).all()
    c = port.to_tensor(np.zeros((500,), np.float32))
    port.cauchy_(c)
    assert abs(np.median(c.numpy())) < 0.2
    r = port.randint_like(port.to_tensor(X), 0, 10)
    assert r.dtype == port.float32 and r.numpy().max() < 10
    assert port.standard_normal([3, 4]).shape == [3, 4]
    assert list(port.batch(lambda: iter(range(7)), 3)()) == \
        [[0, 1, 2], [3, 4, 5], [6]]
    with port.LazyGuard():
        layer = port.nn.Linear(3, 4)
    assert list(layer.weight.shape) == [3, 4]
    p = port.create_parameter([4, 5], "float32")
    assert list(p.shape) == [4, 5] and not p.stop_gradient
    with pytest.raises(ValueError):
        port.check_shape([-2, 3])
    with pytest.raises(TypeError):
        port.check_shape([2.5])
    assert port.finfo(port.bfloat16).bits == 16
    assert port.finfo("float32").eps == np.finfo(np.float32).eps
    assert port.iinfo("int32").max == 2 ** 31 - 1
    assert port.inf == float("inf") and port.newaxis is None
    assert port.pstring == "pstring"
    back = port.from_dlpack(port.to_dlpack(port.to_tensor(X)))
    np.testing.assert_allclose(back.numpy(), X)
    np.testing.assert_allclose(port.from_dlpack(torch.tensor(X)).numpy(), X)
    low = (np.random.RandomState(2).randn(12, 3)
           @ np.random.RandomState(3).randn(3, 9)).astype(np.float32)
    u, s, v = port.svd_lowrank(port.to_tensor(low), q=3)
    np.testing.assert_allclose(u.numpy() @ np.diag(s.numpy()) @ v.numpy().T,
                               low, atol=1e-3)
    with pytest.raises(NotImplementedError, match="item 9"):
        port.to_tensor(X).istft()


def test_ormqr_matches_the_reference():
    a = np.random.RandomState(7).randn(5, 3).astype(np.float32)
    y = np.random.RandomState(8).randn(5, 2).astype(np.float32)
    qr, tau = torch.geqrf(torch.tensor(a))
    r = ref.ormqr(ref.to_tensor(qr.numpy()), ref.to_tensor(tau.numpy()),
                  ref.to_tensor(y))
    p = port.ormqr(port.to_tensor(qr.numpy()), port.to_tensor(tau.numpy()),
                   port.to_tensor(y))
    np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=1e-4, atol=1e-5)


# -- save / load across the packages -------------------------------------------

def _lenet(pd):
    pd.seed(0)
    return pd.vision.models.LeNet()


def _lstm(pd):
    pd.seed(0)
    return pd.nn.LSTM(4, 6, num_layers=2, direction="bidirect")


@pytest.fixture(scope="module")
def models():
    """The LeNet and the LSTM of each package, built once for the file
    (the reference's initializers compile on first use), the port's on
    the CPU."""
    port_place.set_device("cpu")
    try:
        return {(name, pd.__name__): build(pd)
                for name, build in (("lenet", _lenet), ("lstm", _lstm))
                for pd in (ref, port)}
    finally:
        port_place._current[0] = None


@pytest.mark.parametrize("model", ["lenet", "lstm"])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_save_load_across_packages(tmp_path, models, model, direction):
    src_pd, dst_pd = (ref, port) if direction == "reference_to_port" \
        else (port, ref)
    sd = models[model, src_pd.__name__].state_dict()
    path = str(tmp_path / f"{model}.pdparams")
    src_pd.save(sd, path)
    back = dst_pd.load(path)
    assert list(back) == list(sd)
    for k in sd:
        assert isinstance(back[k], dst_pd.Tensor), k
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy())
    missing, unexpected = models[model, dst_pd.__name__].set_state_dict(
        back)
    assert not missing and not unexpected
    arrays = dst_pd.load(path, return_numpy=True)
    assert all(isinstance(v, np.ndarray) for v in arrays.values())


def test_load_checks_the_crc_footer(tmp_path):
    path = str(tmp_path / "w.pdparams")
    port.save({"w": port.to_tensor(X)}, path)
    raw = bytearray(Path(path).read_bytes())
    raw[10] ^= 0xFF
    Path(path).write_bytes(bytes(raw))
    from paddle_tpu_torch.core.enforce import DataLossError
    with pytest.raises(DataLossError, match="CRC"):
        port.load(path)
    with pytest.raises(Exception, match="CRC"):
        ref.load(path)


# -- functional_state -----------------------------------------------------------

def test_functional_state_round_trip():
    layer = _lstm(port)
    params, bufs = layer.functional_state()
    assert list(params) == [k for k, _ in layer.named_parameters()]
    assert all(isinstance(v, torch.Tensor) for v in params.values())
    assert params["weight_ih_l0"] is layer.weight_ih_l0._data
    x = torch.randn(2, 3, 4)
    want = layer(port.to_tensor(x))[0].numpy()
    doubled = {k: v * 2.0 for k, v in params.items()}
    layer.load_functional_state(doubled, bufs)
    assert layer.weight_ih_l0._data is doubled["weight_ih_l0"]
    assert not np.allclose(layer(port.to_tensor(x))[0].numpy(), want)
    layer.load_functional_state({k: v / 2.0 for k, v in doubled.items()})
    np.testing.assert_allclose(layer(port.to_tensor(x))[0].numpy(), want,
                               rtol=1e-6)
    rl = _lstm(ref)
    assert list(rl.functional_state()[0]) == list(params)


# -- FLAGS_quant_* ---------------------------------------------------------------

QUANT_FLAGS = ("FLAGS_quant_mode", "FLAGS_quant_kv_cache",
               "FLAGS_quant_manifest")


@pytest.fixture
def quant_flags():
    from paddle_tpu_torch.inference import quant as Q  # noqa: F401 (defines)
    prev = port.get_flags(list(QUANT_FLAGS))
    yield
    port.set_flags(prev)


def _tiny():
    from paddle_tpu_torch.models import llama as L
    import dataclasses
    cfg = dataclasses.replace(L.CONFIGS["llama-test"], dtype=torch.float32)
    params = L.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, params


def test_quant_flags_are_the_references(quant_flags):
    from paddle_tpu.inference import quant as JQ  # noqa: F401
    from paddle_tpu_torch.inference import quant as Q
    for name in QUANT_FLAGS:
        assert port.get_flags(name) == ref.get_flags(name), name
    assert Q.resolve_quant_mode() == ""
    port.set_flags({"FLAGS_quant_mode": "w8"})
    assert Q.resolve_quant_mode() == "w8"
    assert Q.resolve_quant_mode("fp8") == "fp8"     # an argument wins
    assert Q.resolve_quant_mode("") == ""
    with pytest.raises(ValueError, match="not in"):
        Q.resolve_quant_mode("int4")
    assert Q.resolve_manifest() is None


def test_engine_and_predictor_read_the_flags(quant_flags, tmp_path):
    from paddle_tpu_torch.inference import LLMPredictor
    from paddle_tpu_torch.inference import quant as Q
    from paddle_tpu_torch.inference.serving import PagedServingEngine
    cfg, params = _tiny()
    eng = PagedServingEngine(cfg, params, device="cpu", max_len=64)
    assert eng.quant_mode == "" and not eng.quant_kv     # default flags
    manifest = Q.calibrate(cfg, params,
                           [np.random.RandomState(0).randint(
                               0, cfg.vocab_size, (1, 16))])
    path = str(tmp_path / "m.json")
    Q.save_manifest(manifest, path)
    port.set_flags({"FLAGS_quant_mode": "w8", "FLAGS_quant_kv_cache": True,
                    "FLAGS_quant_manifest": path})
    eng = PagedServingEngine(cfg, params, device="cpu", max_len=64)
    assert eng.quant_mode == "w8" and eng.quant_kv
    assert eng._key_cache.dtype == torch.int8
    assert eng.params["blocks"]["w1_q"].dtype == torch.int8
    eng = PagedServingEngine(cfg, params, device="cpu", max_len=64,
                             quant_mode="", quant_kv=False)
    assert eng.quant_mode == "" and not eng.quant_kv     # arguments win
    pred = LLMPredictor(cfg, params, max_len=64, device="cpu")
    assert pred.quant_mode == "w8"
    assert LLMPredictor(cfg, params, max_len=64, device="cpu",
                        quant_mode="").quant_mode == ""
    port.set_flags({"FLAGS_quant_manifest": ""})
    with pytest.raises(ValueError, match="FLAGS_quant_manifest"):
        PagedServingEngine(cfg, params, device="cpu", max_len=64)
