"""OpTest twin: the port's nine base kernel modules, and the other ops
it registers that have a case in the harness (`tail_alias`, the fused
ops, the incubate functions, and the kernel tail: `vision_ops`,
`yolo_loss`, `tail_math`, `tail_nn`, `tail_seq`, `rnn_ops`, `tail_r4`,
`tail_r5`, `tail_r5b`, `tail_r5c`, `tail_r5d`, `graph_ops`), against the
reference's, op for op.

Inputs are the reference harness's own (`tests/test_op_generated.py`
`SPECS` and its seeded generators). The reference runs each op's kernel
jitted over those inputs, as its harness's eager-vs-jit check does, and
differentiates it with `jax.grad`: the compared ops in fixed chunks of
CHUNK, one jitted function a chunk, computed the first time a case of
the chunk runs and cached (under pytest-xdist the first worker to need
a chunk computes it for the others); ops the harness marks `no_jit` run
through the reference's eager dispatch and tape. Each op is one case:
- outputs held to `tests/op_test.py` `DTYPE_THRESHOLDS["float32"]`
  (rtol 1e-5, atol 1e-6; integer and bool outputs exactly);
- for the inputs the harness differentiates, the gradients of the same
  weighted sum of the outputs, held to the same table's f32 `grad_rtol`
  (5e-3; atol the f32 atol times the gradient's largest entry);
- the random ops (`spec.rand`, and `dpsgd`, whose reference draws its
  noise from a jax key the harness does not mark) compare shapes and
  dtype kinds only: jax threefry and torch Philox cannot draw the same
  values (`test_torch_tail_ops.py` holds dpsgd exactly without noise).
Every op of the nine modules has a spec (the name lists are checked);
none is skipped. The other registered ops are held the same way where
the harness has a case for them; the ones it has none for are
`test_torch_fused_transformer.py`'s, `test_torch_varlen_attention.py`'s
and `test_torch_tail_ops.py`'s; the collective names are held at world
1 here (`test_collective_op_at_world_1`) and at world 4 in
`test_torch_collective.py`. Each ported op's signature is held to
its `args:` line in `paddle_tpu/ops/ops.yaml`, and one case reports the
port's registered ops against the manifest's names: 673 registered,
every one held by a case (here or in the file named beside it), and the
17 others waiting for ROADMAP item 9.
"""
import functools
import inspect
import os
import pickle
import time

import jax
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
import test_op_generated as G
import test_torch_tail_ops as TAIL
from op_test import DTYPE_THRESHOLDS
from paddle_tpu.core.tensor import Tensor as RefTensor
from paddle_tpu.ops.dispatch import OPS as REF_OPS
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.core.tensor import Tensor as PortTensor
from paddle_tpu_torch.ops.dispatch import OPS as PORT_OPS
from paddle_tpu_torch.ops.kernels._util import WAITING
from paddle_tpu_torch import _C_ops  # noqa: F401  (registers the rest)
from paddle_tpu_torch.tensor import BASE_OPS
from torch_threads import one_torch_thread

one_torch_thread()

THR = DTYPE_THRESHOLDS["float32"]
MODULES = ("creation", "math", "manipulation", "reduce", "comparison",
           "nn_ops", "linalg", "search", "random")
BASE = sorted(n for names in BASE_OPS.values() for n in names)
# the other registered ops with a harness case (tail_alias, fused ops,
# incubate functions)
OTHER = sorted(n for n in PORT_OPS if n not in set(BASE) and n in G.SPECS)
PORTED = BASE + OTHER
# ops whose reference draws from a jax key though the harness's spec is
# not marked random
DRAWS = {"dpsgd"}
COMPARED = sorted(n for n in PORTED if not G.SPECS[n].rand
                  and n not in DRAWS)
RANDOM = sorted(n for n in PORTED if G.SPECS[n].rand or n in DRAWS)
GRADS = sorted(n for n in COMPARED if G.SPECS[n].grad)


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    """The reference's ops run on its plain eager path: each op here runs
    once or twice, so its dispatch cache would only add jit compiles."""
    prev = ref.get_flags("FLAGS_eager_dispatch_cache")
    ref.set_flags({"FLAGS_eager_dispatch_cache": False})
    yield
    ref.set_flags(prev)


def _inputs(pd, spec, grad=()):
    out = []
    for i, a in enumerate(spec.inputs):
        if isinstance(a, np.ndarray):
            t = pd.to_tensor(a)
            if i in grad:
                t.stop_gradient = False
            out.append(t)
        elif isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            out.append([pd.to_tensor(x) for x in a])
        else:
            out.append(a)
    return out


def _leaves(out, cls):
    if isinstance(out, cls):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o, cls)]
    return []


def _run(name, pd, grad=()):
    spec = G.SPECS[name]
    ops = REF_OPS if pd is ref else PORT_OPS
    ins = _inputs(pd, spec, grad)
    out = ops[name](*ins, **spec.kwargs)
    return ins, _leaves(out, RefTensor if pd is ref else PortTensor)


def _host(t):
    a = t.numpy()
    return np.asarray(a, np.float32) if a.dtype.name == "bfloat16" else a


def _weights(outs):
    """The harness's weights for the loss sum(out * w) over float outputs
    (arrays or jax shape structs)."""
    rs = np.random.RandomState(123)
    return [rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
            if np.dtype(a.dtype).kind == "f" else None for a in outs]


def _ref_jitted(name):
    """The reference kernel as a jax function of the spec's array inputs
    (arrays and lists of arrays), the rest fixed."""
    spec = G.SPECS[name]
    kernel = REF_OPS[name]._kernel
    slots = [i for i, a in enumerate(spec.inputs)
             if isinstance(a, np.ndarray)
             or (isinstance(a, list) and a and isinstance(a[0], np.ndarray))]

    def f(*arrs):
        ins = list(spec.inputs)
        for i, a in zip(slots, arrs):
            ins[i] = a
        return jax.tree.leaves(kernel(*ins, **spec.kwargs))

    return f, slots


def _ref_fn(name):
    """(fn, args): the reference's outputs, and for a differentiated op
    the gradients of the weighted sum, as one jax function of the spec's
    array inputs."""
    spec = G.SPECS[name]
    f, slots = _ref_jitted(name)
    args = [spec.inputs[i] for i in slots]
    if not spec.grad:
        return (lambda *a: (f(*a), None)), args
    w = _weights(jax.eval_shape(f, *args))

    def loss(*arrs):
        return sum((o * wk).sum() for o, wk in zip(f(*arrs), w)
                   if wk is not None)

    argnums = tuple(slots.index(i) for i in spec.grad)
    return (lambda *a: (f(*a), jax.grad(loss, argnums)(*a))), args


# The jittable compared ops, cut into fixed chunks of CHUNK: the reference
# results of a chunk come from one jitted function, computed the first
# time a case of that chunk runs and cached in the process. Under
# pytest-xdist the first worker to need a chunk computes it and leaves
# the results in the run's shared temporary directory; the other workers
# read them, so each chunk compiles once a run.
JITTED = [n for n in COMPARED if not G.SPECS[n].no_jit]
CHUNK = 16
_CHUNK_OF = {n: i // CHUNK for i, n in enumerate(JITTED)}
_STORE = [None]      # the run's shared directory under pytest-xdist


@pytest.fixture(autouse=True, scope="session")
def _shared_store(tmp_path_factory):
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid:
        _STORE[0] = tmp_path_factory.getbasetemp().parent / f"ref-{uid}"
        _STORE[0].mkdir(exist_ok=True)
    yield
    _STORE[0] = None


def _compute_chunk(k):
    names = JITTED[k * CHUNK:(k + 1) * CHUNK]
    fns = {n: _ref_fn(n) for n in names}
    out = jax.jit(lambda a: {n: fns[n][0](*a[n]) for n in names})(
        {n: fns[n][1] for n in names})
    return {n: ([np.asarray(a) for a in o],
                None if g is None else [np.asarray(x, np.float64) for x in g])
            for n, (o, g) in out.items()}


@functools.lru_cache(maxsize=None)
def _ref_chunk(k):
    """The reference results of chunk `k` of JITTED, from one jitted
    function of the chunk's ops (or from the worker that computed them)."""
    store = _STORE[0]
    if store is None:
        return _compute_chunk(k)
    done = store / f"chunk{CHUNK}-{k}.pkl"
    lock = store / f"chunk{CHUNK}-{k}.lock"
    try:
        os.close(os.open(lock, os.O_CREAT | os.O_EXCL))
    except FileExistsError:           # another worker computes it
        for _ in range(6000):
            if done.exists():
                return pickle.loads(done.read_bytes())
            time.sleep(0.05)
        return _compute_chunk(k)
    res = _compute_chunk(k)
    tmp = done.with_suffix(f".{os.getpid()}")
    tmp.write_bytes(pickle.dumps(res))
    os.replace(tmp, done)
    return res


def _ref_results(name):
    """(outputs, gradients or None) of the reference on the spec's inputs;
    `no_jit` ops through the reference's eager dispatch and tape."""
    spec = G.SPECS[name]
    if not spec.no_jit:
        return _ref_chunk(_CHUNK_OF[name])[name]
    with ref.no_grad():
        outs = [_host(t) for t in _run(name, ref)[1]]
    if not spec.grad:
        return outs, None
    ins, leaves = _run(name, ref, spec.grad)
    loss = sum((t * ref.to_tensor(wk)).sum()
               for t, wk in zip(leaves, _weights(outs)) if wk is not None)
    loss.backward()
    return outs, [np.asarray(ins[i].grad.numpy(), np.float64)
                  for i in spec.grad]


def test_the_nine_modules_are_ported_whole():
    for mod in MODULES:
        m = __import__(f"paddle_tpu.ops.kernels.{mod}", fromlist=["x"])
        ref_names = {getattr(m, n)._op_name for n in dir(m)
                     if getattr(getattr(m, n), "_op_name", None)
                     and getattr(m, n).__module__ == m.__name__}
        if mod == "nn_ops":
            ref_names.add("swiglu")     # the port's is incubate's op
        assert ref_names == set(BASE_OPS[mod]), mod
    assert len(BASE) == 293
    assert all(n in G.SPECS for n in BASE)     # none without a case


@pytest.mark.parametrize("name", COMPARED)
def test_outputs_match_the_reference(name):
    r = _ref_results(name)[0]
    p = [_host(t) for t in _run(name, port)[1]]
    assert len(p) == len(r), (len(p), len(r))
    for k, (ra, pa) in enumerate(zip(r, p)):
        assert pa.shape == ra.shape, (k, pa.shape, ra.shape)
        assert pa.dtype.kind == ra.dtype.kind, (k, pa.dtype, ra.dtype)
        if ra.dtype.kind in "fc":
            np.testing.assert_allclose(pa, ra, rtol=THR["rtol"],
                                       atol=THR["atol"],
                                       err_msg=f"{name} output {k}")
        else:
            np.testing.assert_array_equal(pa, ra, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", GRADS)
def test_gradients_match_the_reference(name):
    spec = G.SPECS[name]
    ins, leaves = _run(name, port, spec.grad)
    w = _weights([_host(t) for t in leaves])
    loss = sum((t * port.to_tensor(wk)).sum()
               for t, wk in zip(leaves, w) if wk is not None)
    loss.backward()
    for i, gr in zip(spec.grad, _ref_results(name)[1]):
        gp = np.asarray(ins[i].grad.numpy(), np.float64)
        scale = max(np.abs(gr).max(), 1.0)
        np.testing.assert_allclose(gp, gr, rtol=THR["grad_rtol"],
                                   atol=THR["atol"] * scale,
                                   err_msg=f"{name} grad of input {i}")


@pytest.mark.parametrize("name", RANDOM)
def test_random_ops_match_shapes_and_types(name):
    _, r = _run(name, ref)
    _, p = _run(name, port)
    assert [t.shape for t in p] == [t.shape for t in r]
    assert [_host(t).dtype.kind for t in p] == [_host(t).dtype.kind
                                                for t in r]


def _sig_args(fn):
    """`tools/gen_op_manifest.py` `sig_args`, the manifest's rendering."""
    args = []
    for prm in inspect.signature(fn).parameters.values():
        if prm.kind == prm.VAR_POSITIONAL:
            args.append("*" + prm.name)
        elif prm.kind == prm.VAR_KEYWORD:
            args.append("**" + prm.name)
        elif prm.default is inspect.Parameter.empty:
            args.append(prm.name)
        else:
            args.append(f"{prm.name}={prm.default!r}")
    return "(" + ", ".join(args) + ")"


@pytest.mark.parametrize("name", PORTED)
def test_signature_matches_ops_yaml(name):
    assert _sig_args(PORT_OPS[name]) == G.MANIFEST[name]["args"]


# ---------------------------------------------------------------------------
# the collective op names and their plumbing at world 1
# ---------------------------------------------------------------------------

# The harness opts them out (`test_op_generated.py`: a dedicated suite);
# here are `tests/test_collective_ops.py`'s cases, each against the
# reference's op on the same input, the port's ops over this process's
# gloo group of one (formed at first use). Their multi-rank behaviour,
# and the four point-to-point names, which have no world-1 result, are
# held at world 4 in `tests/test_torch_collective.py`.

XC = np.random.RandomState(0).randn(4, 3).astype(np.float32)
W1_IDENTITY = ["all_reduce", "c_allreduce_sum", "c_allreduce_max",
               "c_allreduce_min", "c_allreduce_prod", "mp_allreduce_sum",
               "broadcast", "c_broadcast", "c_identity", "npu_identity",
               "share_data", "depend", "copy_to", "sync_calc_stream",
               "memcpy_h2d", "memcpy_d2h", "all_gather", "c_allgather",
               "c_concat", "reduce_scatter", "all_to_all", "c_scatter",
               "reduce", "c_reduce_sum", "dist_concat"]


def _pair(fn):
    """fn run on the reference's and the port's module and Tensor type."""
    r = fn(ref._C_ops, ref.to_tensor)
    p = fn(port._C_ops, port.to_tensor)
    return r, p


def _np_of(v):
    if isinstance(v, (list, tuple)):
        return [_np_of(x) for x in v]
    return np.asarray(v.numpy())


W1_CASES = {name: (lambda name: lambda m, t: getattr(m, name)(t(XC)))(name)
            for name in W1_IDENTITY}
W1_CASES.update({
    "shape": lambda m, t: m.shape(t(XC)),
    "full_": lambda m, t: m.full_(t(np.zeros((2, 3), np.float32)),
                                  value=7.0),
    "full_int_array": lambda m, t: m.full_int_array([2, 5, 9]),
    "full_with_tensor": lambda m, t: m.full_with_tensor(
        t(np.float32(3.5)), t(np.array([2, 2], np.int64))),
    "assign_value_": lambda m, t: m.assign_value_(
        t(np.zeros((2, 2), np.float32)), shape=(2, 2),
        values=(1.0, 2.0, 3.0, 4.0)),
    "assign_out_": lambda m, t: m.assign_out_(t(XC), t(np.zeros_like(XC))),
    "set": lambda m, t: m.set(t(np.zeros_like(XC)), t(XC)),
    "slice": lambda m, t: m.slice(t(XC), axes=[0, 1], starts=[0, 1],
                                  ends=[1, 2], decrease_axis=[0]),
    "set_value_with_tensor": lambda m, t: m.set_value_with_tensor(
        t(XC), t(np.zeros((2, 3), np.float32)), starts=[1], ends=[3],
        steps=[1], axes=[0]),
    "trans_layout": lambda m, t: m.trans_layout(t(XC), perm=[1, 0]),
    "coalesce_tensor": lambda m, t: m.coalesce_tensor(
        [t(XC[:2]), t(XC[2:, :2])]),
    "global_scatter": lambda m, t: m.global_scatter(
        t(XC), np.asarray([3, 1]), np.asarray([3, 1])),
    "global_gather": lambda m, t: m.global_gather(
        t(XC), np.asarray([3, 1]), np.asarray([3, 1])),
    "partial_allgather": lambda m, t: m.partial_allgather(t(XC)),
    "barrier": lambda m, t: m.barrier(t(XC)),
    "fetch_barrier": lambda m, t: m.fetch_barrier([t(XC)]),
    "comm_init_all": lambda m, t: m.comm_init_all(),
    "c_softmax_with_cross_entropy": lambda m, t:
        m.c_softmax_with_cross_entropy(t(XC), t(np.array([0, 2, -100, 1]))),
})
COLLECTIVE_W1 = set(W1_CASES)
# no world-1 result (torch refuses a send to oneself)
COLLECTIVE_P2P = {"p_send", "p_recv", "p_send_array", "p_recv_array"}


@pytest.mark.parametrize("name", sorted(W1_CASES))
def test_collective_op_at_world_1(name):
    r, p = _pair(W1_CASES[name])
    r, p = _np_of(r), _np_of(p)
    if name == "comm_init_all":
        assert int(np.asarray(p)) == 0
        return
    if isinstance(r, list):
        assert len(r) == len(p)
        for a, b in zip(r, p):
            for a2, b2 in (zip(a, b) if isinstance(a, list) else [(a, b)]):
                np.testing.assert_allclose(b2, a2, rtol=1e-6, atol=1e-7)
        return
    np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7)


def test_registered_count_against_the_manifest():
    names = set(G.MANIFEST)
    ported = sorted(set(PORT_OPS) & names)
    extra = sorted(set(PORT_OPS) - names)
    missing = names - set(PORT_OPS)
    by_item = {f"item {i}": sorted(n for n, f in WAITING.items()
                                   if f._waiting_item == i)
               for i in (9,)}
    print(f"\nport registers {len(PORT_OPS)} ops; {len(ported)} of the "
          f"{len(names)} ops.yaml names; not in ops.yaml: {extra}; "
          f"missing {len(missing)}: " + "; ".join(
              f"{k} ({len(v)}): {', '.join(v)}" for k, v in by_item.items()))
    assert len(names) == 690
    assert len(ported) == 673 and len(missing) == 17 and not extra
    assert set(PORTED) <= set(ported)
    assert len(ported) >= len(PORTED)
    # every missing name waits for item 9, and none is registered
    assert missing == set(WAITING)
    assert not set(WAITING) & set(PORT_OPS)
    # the ops without a harness case are held by their own files
    assert set(PORT_OPS) - set(PORTED) - set(extra) <= {
        "block_multihead_attention_",      # test_torch_bmha_op.py
        "flash_attn_unpadded", "flash_attn_varlen_qkvpacked",
        "fused_multi_transformer_", "masked_multihead_attention_",
        "read_file", "variable_length_memory_efficient_attention",
    } | set(TAIL.HELD_HERE) | COLLECTIVE_W1 | COLLECTIVE_P2P
