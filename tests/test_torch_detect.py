"""The bench's detector (`bench.py:472` `bench_detection_infer`) through
the port's eager API at a small size, against the reference on the CPU.

The bench's model at B 2, 64 x 64 images, width 8, 4 classes, f32, in
eval mode: its CSP-style backbone of Conv2D / BatchNorm2D / Silu, three
1 x 1 heads, each decoded by `vision.ops.yolo_box` (strides 8 / 16 / 32,
anchors [8, 8], [16, 16], [32, 32], conf_thresh 0.005), then `nms` over
image 0's boxes (IoU 0.5, top_k 100) as the bench runs it; the
reference's model runs under `jit.to_static`, as in the bench. The
port's weights are the reference's, carried across with
`set_state_dict`.
Heads, boxes and scores are held within rtol 1e-5 (atol 1e-5 of the
largest |value|); `nms` keeps exactly the reference's indices, and on
the reference's own boxes and scores too. One bf16 `auto_cast` pass
checks that the heads come out bf16 and the decode f32, as the bench's
loop has them.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place
from torch_threads import one_torch_thread

one_torch_thread()

B, S, W, NC = 2, 64, 8, 4
HEADS = ((8, [8, 8]), (16, [16, 16]), (32, [32, 32]))


@pytest.fixture(autouse=True)
def _cpu():
    place.set_device("cpu")
    yield
    place._current[0] = None


def detector(pd, nc=NC, w=W):
    """The bench's Detector, built from package pd's layers."""
    nn = pd.nn

    class ConvBN(nn.Layer):
        def __init__(self, cin, cout, k=3, s=1):
            super().__init__()
            self.conv = nn.Conv2D(cin, cout, k, stride=s, padding=k // 2,
                                  bias_attr=False)
            self.bn = nn.BatchNorm2D(cout)
            self.act = nn.Silu()

        def forward(self, x):
            return self.act(self.bn(self.conv(x)))

    class Detector(nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = ConvBN(3, w, 3, 2)
            self.s1 = nn.Sequential(ConvBN(w, 2 * w, 3, 2),
                                    ConvBN(2 * w, 2 * w))
            self.s2 = nn.Sequential(ConvBN(2 * w, 4 * w, 3, 2),
                                    ConvBN(4 * w, 4 * w))
            self.s3 = nn.Sequential(ConvBN(4 * w, 8 * w, 3, 2),
                                    ConvBN(8 * w, 8 * w))
            self.s4 = nn.Sequential(ConvBN(8 * w, 16 * w, 3, 2),
                                    ConvBN(16 * w, 16 * w))
            self.h3 = nn.Conv2D(4 * w, 5 + nc, 1)
            self.h4 = nn.Conv2D(8 * w, 5 + nc, 1)
            self.h5 = nn.Conv2D(16 * w, 5 + nc, 1)

        def forward(self, x):
            p3 = self.s2(self.s1(self.stem(x)))
            p4 = self.s3(p3)
            return self.h3(p3), self.h4(p4), self.h5(self.s4(p4))

    return Detector()


def decode(pd, heads, img_shape):
    return [pd.vision.ops.yolo_box(h.astype("float32"), img_shape, anchor,
                                   NC, conf_thresh=0.005,
                                   downsample_ratio=stride)
            for h, (stride, anchor) in zip(heads, HEADS)]


def image0(outs):
    boxes = np.concatenate([b.numpy()[0] for b, _ in outs])
    scores = np.concatenate([s.numpy()[0].max(-1) for _, s in outs])
    return boxes, scores


@pytest.fixture(scope="module")
def both():
    place.set_device("cpu")
    ref.seed(0)
    rnet = detector(ref)
    rnet.eval()
    pnet = detector(port)
    pnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in rnet.state_dict().items()})
    pnet.eval()
    rs = np.random.RandomState(0)
    x = rs.rand(B, 3, S, S).astype(np.float32)
    shape = np.tile(np.asarray([[S, S]], np.int32), (B, 1))
    return rnet, pnet, x, shape


def _run(pd, net, x, shape):
    heads = net(pd.to_tensor(x))
    return heads, decode(pd, heads, pd.to_tensor(shape))


@pytest.fixture(scope="module")
def ref_static(both):
    """The reference model under `jit.to_static`, as the bench runs it."""
    return ref.jit.to_static(both[0])


def test_heads_boxes_and_scores_match_the_reference(both, ref_static):
    _, pnet, x, shape = both
    rh, rout = _run(ref, ref_static, x, shape)
    ph, pout = _run(port, pnet, x, shape)
    pairs = list(zip(rh, ph)) + [(r, p) for ro, po in zip(rout, pout)
                                 for r, p in zip(ro, po)]
    assert len(pairs) == 9
    for r, p in pairs:
        r, p = r.numpy(), p.numpy()
        assert p.shape == r.shape and p.dtype == r.dtype
        np.testing.assert_allclose(p, r, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(r).max(), 1e-30))


def test_nms_keeps_the_reference_indices(both, ref_static):
    _, pnet, x, shape = both
    rb, rsc = image0(_run(ref, ref_static, x, shape)[1])
    pb, psc = image0(_run(port, pnet, x, shape)[1])
    rkeep = ref.vision.ops.nms(ref.to_tensor(rb), iou_threshold=0.5,
                               scores=ref.to_tensor(rsc), top_k=100).numpy()
    pkeep = port.vision.ops.nms(port.to_tensor(pb), iou_threshold=0.5,
                                scores=port.to_tensor(psc), top_k=100)
    np.testing.assert_array_equal(pkeep.numpy(), rkeep)
    # and on the reference's own boxes and scores
    own = port.vision.ops.nms(port.to_tensor(rb), iou_threshold=0.5,
                              scores=port.to_tensor(rsc), top_k=100)
    np.testing.assert_array_equal(own.numpy(), rkeep)
    assert 0 < len(rkeep) <= 100


def test_bf16_auto_cast_pass_decodes_in_f32(both):
    _, pnet, x, shape = both
    with port.amp.auto_cast(enable=True, dtype="bfloat16"):
        heads = pnet(port.to_tensor(x))
    assert all(str(h.dtype).endswith("bfloat16") for h in heads)
    outs = decode(port, heads, port.to_tensor(shape))
    for b, s in outs:
        assert str(b.dtype).endswith("float32")
        assert np.isfinite(b.numpy()).all() and np.isfinite(s.numpy()).all()
    assert outs[0][0].shape == [B, (S // 8) ** 2, 4]
    assert outs[0][1].shape == [B, (S // 8) ** 2, NC]
