"""The namespaces no other surface test walks: `device`, `incubate`,
`inference`, `inference.serving`, `vision` and `vision.models` of the
port against the reference's. Every public name of the reference's
namespace is the port's, less `LATER` (each missing name under the
ROADMAP item that brings it); a name the port holds beyond the
reference's is one of `PORT_ONLY`. Then the values: the device probes
and memory namespace on the CPU, `LookAhead` and `ModelAverage` against
their rules and the reference's, the incubate aliases against the
reference's ops, and `image_load` of a local PNG under each backend.
"""
import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread

import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as pplace

one_torch_thread()

_VISION_MODELS_9 = {
    "AlexNet", "BasicBlock", "BottleneckBlock", "DenseNet", "GoogLeNet",
    "InceptionV3", "MobileNetV1", "MobileNetV2", "MobileNetV3Large",
    "MobileNetV3Small", "ResNet", "ShuffleNetV2", "SqueezeNet", "VGG",
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "googlenet", "inception_v3", "mobilenet_v1",
    "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small",
    "resnet101", "resnet152", "resnet18", "resnet34", "resnet50",
    "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
    "resnext152_64x4d", "resnext50_32x4d", "resnext50_64x4d",
    "shufflenet_v2_swish", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "squeezenet1_0", "squeezenet1_1", "vgg11",
    "vgg13", "vgg16", "vgg19", "wide_resnet101_2", "wide_resnet50_2"}

LATER = {
    "item 9 (the long tail)": {
        # `Config`, `Predictor`, `create_predictor` load jit.save's
        # programs
        "inference": {"Config", "PlaceType", "PrecisionType", "Predictor",
                      "create_predictor"},
        "incubate": {"autograd", "distributed", "graph_send_recv",
                     "segment_max", "segment_mean", "segment_min",
                     "segment_sum"},
        "vision": {"ResNet", "datasets", "resnet18", "resnet50",
                   "transforms"},
        "vision.models": _VISION_MODELS_9},
    # the reference module's own imports, seen by dir(): not API
    "not API": {
        "inference": {"Dict", "List", "Optional", "Tensor", "annotations",
                      "jax", "jnp", "np", "os", "pickle"}},
}

# the port's own names: `device`'s entry-point resolution, the adapters'
# rank classes
PORT_ONLY = {"device": {"available", "resolve"},
             "inference.serving": {"rank_class"}}

WHERE = ["device", "incubate", "inference", "inference.serving", "vision",
         "vision.models"]


def _static_imports(path):
    out = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _names(mod):
    api = _static_imports(mod.__file__)
    return {n for n in dir(mod) if not n.startswith("_")
            and (not inspect.ismodule(getattr(mod, n)) or n in api)}


def _later(where):
    return set().union(*(v.get(where, set()) for v in LATER.values()))


@pytest.mark.parametrize("where", WHERE)
def test_the_namespace_holds_the_references_names(where):
    r = importlib.import_module(f"paddle_tpu.{where}")
    p = importlib.import_module(f"paddle_tpu_torch.{where}")
    missing = [n for n in sorted(_names(r) - _later(where))
               if not hasattr(p, n)]
    assert not missing, missing
    for n in _later(where):
        assert n in _names(r), n        # the map names real names only
        assert not hasattr(p, n), n     # and none the port has
    extra = {n for n in _names(p) - _names(r)
             if not inspect.ismodule(getattr(p, n))
             and getattr(getattr(p, n), "__module__", "") != "typing"}
    assert extra == PORT_ONLY.get(where, set())


def test_the_later_map_names_items_9_only():
    assert set(LATER) == {"item 9 (the long tail)", "not API"}


# -- values ---------------------------------------------------------------------

def test_device_probes_and_memory_on_the_cpu():
    import paddle_tpu.device as rd
    d = port.device
    assert d.device_count() == torch.cuda.device_count()
    assert d.get_cudnn_version() is None
    assert d.get_all_device_type() == ["cpu"]
    for name in ("is_compiled_with_ipu", "is_compiled_with_cinn",
                 "is_compiled_with_custom_device", "is_compiled_with_rocm",
                 "is_compiled_with_tpu", "is_compiled_with_xpu",
                 "is_compiled_with_cuda"):
        assert getattr(d, name)() is False, name
    assert d.is_compiled_with_distribute() is rd.is_compiled_with_distribute()
    assert d.get_available_custom_device() == \
        rd.get_available_custom_device() == []
    for ns in (d.cuda, d.tpu, d.xpu):
        assert ns.memory_allocated() == ns.max_memory_reserved() == 0
        ns.empty_cache()
    assert str(d.XPUPlace(1)) == "Place(gpu:1)"
    with pytest.raises(RuntimeError):
        d.IPUPlace()
    s, e = d.Stream(), d.Event()
    with d.stream_guard(s):
        e.record()
    assert e.query() and s.query() and d.current_stream().query()
    d.synchronize()
    pplace.set_device("cpu")
    try:
        assert d.get_device() == "cpu:0"
        assert d.CPUPlace() == pplace.CPUPlace()
    finally:
        pplace._current[0] = None


def _lookahead_rule(w0, grads, lr, alpha, k):
    fast, slow = w0.copy(), None
    for i, g in enumerate(grads, 1):
        fast = fast - lr * g
        if i % k == 0:
            slow = fast.copy() if slow is None else slow
            slow = slow + alpha * (fast - slow)
            fast = slow.copy()
    return fast


def test_lookahead_follows_its_rule():
    pplace.set_device("cpu")
    try:
        from paddle_tpu_torch.incubate import LookAhead
        w0 = np.random.RandomState(0).randn(3, 2).astype(np.float32)
        grads = [np.random.RandomState(i).randn(3, 2).astype(np.float32)
                 for i in range(1, 8)]
        p = port.create_parameter([3, 2], "float32")
        p.set_value(w0)
        inner = port.optimizer.SGD(learning_rate=0.1, parameters=[p])
        la = LookAhead(inner, alpha=0.5, k=3)
        for g in grads:
            p._data.grad = torch.from_numpy(g)
            la.step()
            la.clear_grad()
        np.testing.assert_allclose(
            p.numpy(), _lookahead_rule(w0, grads, 0.1, 0.5, 3),
            rtol=1e-6, atol=1e-6)
    finally:
        pplace._current[0] = None


def test_model_average_matches_the_reference():
    import paddle_tpu as ref
    from paddle_tpu.incubate import ModelAverage as RMA
    pplace.set_device("cpu")
    try:
        from paddle_tpu_torch.incubate import ModelAverage as PMA
        vals = [np.random.RandomState(i).randn(4).astype(np.float32)
                for i in range(5)]
        rp = ref.create_parameter([4], "float32")
        pp = port.create_parameter([4], "float32")
        ra, pa = RMA(0.5, [rp], 1, 3), PMA(0.5, [pp], 1, 3)
        for v in vals:
            rp.set_value(ref.to_tensor(v))
            pp.set_value(v)
            ra.step()
            pa.step()
        for avg in (ra, pa):
            avg.apply()
        np.testing.assert_allclose(pp.numpy(), np.asarray(rp._data),
                                   rtol=1e-6)
        ra.restore()
        pa.restore()
        np.testing.assert_array_equal(pp.numpy(), vals[-1])
    finally:
        pplace._current[0] = None


def test_the_incubate_aliases_are_the_references_ops():
    import paddle_tpu as ref
    import paddle_tpu.incubate as ri
    pplace.set_device("cpu")
    try:
        x = np.random.RandomState(0).randn(2, 3, 4, 4).astype(np.float32)
        m = np.zeros((2, 1, 4, 4), np.float32)
        m[..., 2:] = -1e4
        pi = port.incubate
        np.testing.assert_allclose(
            pi.softmax_mask_fuse(port.to_tensor(x),
                                 port.to_tensor(m)).numpy(),
            np.asarray(ri.softmax_mask_fuse(ref.to_tensor(x),
                                            ref.to_tensor(m))._data),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            pi.softmax_mask_fuse_upper_triangle(port.to_tensor(x)).numpy(),
            np.asarray(ri.softmax_mask_fuse_upper_triangle(
                ref.to_tensor(x))._data), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            float(pi.identity_loss(port.to_tensor(x), 1)),
            float(ri.identity_loss(ref.to_tensor(x), 1)), rtol=1e-6)
        assert pi.graph_reindex is port.reindex_graph
        assert pi.inference is port.inference
    finally:
        pplace._current[0] = None


@pytest.mark.parametrize("backend", ["pil", "cv2", "tensor"])
def test_image_load_reads_a_local_file(tmp_path, backend):
    from PIL import Image
    import paddle_tpu.vision as rv
    rgb = np.random.RandomState(0).randint(0, 255, (5, 7, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(rgb).save(path)
    pv = port.vision
    pplace.set_device("cpu")
    try:
        pv.set_image_backend(backend)
        rv.set_image_backend(backend)
        got, want = pv.image_load(path), rv.image_load(path)
        assert pv.get_image_backend() == rv.get_image_backend() == backend
    finally:
        pv.set_image_backend("pil")
        rv.set_image_backend("pil")
        pplace._current[0] = None
    to_np = {"pil": np.asarray, "cv2": np.asarray,
             "tensor": lambda t: np.asarray(getattr(t, "_data", t))}
    np.testing.assert_array_equal(
        to_np[backend](got) if backend != "tensor" else got.numpy(),
        to_np[backend](want))
    with pytest.raises(ValueError):
        pv.set_image_backend("bogus")
