"""The port's layer tail against the reference's: every function of
`nn/functional/extra.py` and every layer of `nn/layer/extra.py`, on the
inputs of `tests/test_nn_extra.py` (the same seeded generators and
shapes).

Each case runs on both packages from the same numpy inputs; a layer is
built in the reference after `seed(0)` and its state_dict carried into
the port's (`set_state_dict`). The layers that only call one function
of the tail with their arguments (`DELEGATES`) are held to that
function in the port, exactly, and the function to the reference. The
reference runs the cases through its `jit.to_static` in fixed chunks of
CHUNK (`torch_ref_chunks`): one traced program forward and one for its
backward, the whole-program vjp, as its dy2static path runs a model,
for every case of a chunk. Outputs are held within rtol 1e-5 (atol
1e-6); where the case differentiates, the gradients of the same
weighted sum of the float outputs, with respect to the float inputs and
the parameters, within rtol 1e-5 (atol 1e-6 times the gradient's
largest entry). The random ones (the dropout variants in training,
RReLU in training) are held to their laws on the port alone; in eval
they are held to the reference like the rest. The op re-exports
resolve to the port's generated bindings.
"""
import functools

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
import torch_ref_chunks as RC
from paddle_tpu_torch.core import place as port_place
from torch_threads import one_torch_thread

one_torch_thread()

RS = np.random.RandomState
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


@pytest.fixture(autouse=True, scope="module")
def _reference_eager():
    prev = ref.get_flags("FLAGS_eager_dispatch_cache")
    ref.set_flags({"FLAGS_eager_dispatch_cache": False})
    yield
    ref.set_flags(prev)


def f32(seed, *shape):
    return RS(seed).randn(*shape).astype(np.float32)


def sign(seed, *shape):
    return np.where(RS(seed).rand(*shape) < 0.5, 1.0, -1.0).astype(np.float32)


def F(pd):
    return pd.nn.functional


# name -> (fn(pd, *tensors), numpy inputs, indices of differentiated inputs)
FUNCS = {
    "adaptive_avg_pool1d": (lambda pd, x: F(pd).adaptive_avg_pool1d(x, 4),
                            [f32(0, 2, 3, 11)], [0]),
    "adaptive_max_pool1d": (lambda pd, x: F(pd).adaptive_max_pool1d(x, 4),
                            [f32(1, 2, 3, 11)], [0]),
    "adaptive_avg_pool3d": (
        lambda pd, x: F(pd).adaptive_avg_pool3d(x, (2, 3, 4)),
        [f32(2, 1, 2, 5, 7, 6)], [0]),
    "adaptive_max_pool3d": (
        lambda pd, x: F(pd).adaptive_max_pool3d(x, (2, 3, 4)),
        [f32(3, 1, 2, 5, 7, 6)], [0]),
    "max_pool3d": (lambda pd, x: F(pd).max_pool3d(x, 2),
                   [f32(4, 1, 2, 6, 6, 6)], [0]),
    "avg_pool3d": (lambda pd, x: F(pd).avg_pool3d(x, 2),
                   [f32(4, 1, 2, 6, 6, 6)], [0]),
    "avg_pool3d_divisor": (
        lambda pd, x: F(pd).avg_pool3d(x, 2, divisor_override=3),
        [f32(4, 1, 2, 6, 6, 6)], [0]),
    "max_unpool2d": (
        lambda pd, x: F(pd).max_unpool2d(
            *F(pd).max_pool2d_with_index(x, 2), 2, output_size=[6, 6]),
        [f32(5, 1, 2, 6, 6)], [0]),
    "max_unpool1d": (
        lambda pd, x: F(pd).max_unpool1d(
            *[t.squeeze(2) for t in F(pd).max_pool2d_with_index(
                x.unsqueeze(2), [1, 2])], 2),
        [f32(5, 1, 2, 8)], [0]),
    "max_unpool3d": (
        lambda pd, x: F(pd).max_unpool3d(
            x, pd.to_tensor(np.array([[[[[0, 3], [9, 14]], [[48, 51],
                                                            [57, 62]]]]],
                                     np.int64).repeat(2, 1)), 2),
        [f32(5, 1, 2, 2, 2, 2)], [0]),
    "lp_pool1d": (lambda pd, x: F(pd).lp_pool1d(x, 2.0, 2),
                  [np.abs(f32(6, 2, 3, 8))], [0]),
    "lp_pool2d": (lambda pd, x: F(pd).lp_pool2d(x, 2.0, 2),
                  [np.abs(f32(6, 2, 3, 8, 8))], [0]),
    "conv1d_transpose": (
        lambda pd, x, w: F(pd).conv1d_transpose(x, w, stride=2, padding=1),
        [f32(9, 2, 3, 8), f32(10, 3, 4, 3)], [0, 1]),
    "conv1d_transpose_output_size": (
        lambda pd, x, w: F(pd).conv1d_transpose(x, w, stride=2,
                                                output_size=[16]),
        [f32(9, 2, 3, 8), f32(10, 3, 4, 3)], [0, 1]),
    "zeropad2d": (lambda pd, x: F(pd).zeropad2d(x, [1, 2, 3, 4]),
                  [f32(40, 1, 2, 3, 3)], [0]),
    "alpha_dropout_eval": (
        lambda pd, x: F(pd).alpha_dropout(x, p=0.3, training=False),
        [f32(13, 64)], [0]),
    "feature_alpha_dropout_eval": (
        lambda pd, x: F(pd).feature_alpha_dropout(x, p=0.3, training=False),
        [f32(13, 2, 4, 8)], [0]),
    "dropout3d_eval": (
        lambda pd, x: F(pd).dropout3d(x, p=0.5, training=False),
        [f32(13, 2, 4, 3, 3, 3)], [0]),
    "cosine_embedding_loss": (
        lambda pd, a, b, lab: F(pd).cosine_embedding_loss(a, b, lab,
                                                          margin=0.2),
        [f32(14, 4, 6), f32(15, 4, 6), np.array([1, -1, 1, -1], np.int64)],
        [0, 1]),
    "hinge_embedding_loss": (
        lambda pd, x, lab: F(pd).hinge_embedding_loss(x, lab),
        [f32(16, 4, 5), sign(17, 4, 5)], [0]),
    "soft_margin_loss": (lambda pd, x, lab: F(pd).soft_margin_loss(x, lab),
                         [f32(18, 6), sign(19, 6)], [0]),
    "multi_margin_loss": (
        lambda pd, x, lab: F(pd).multi_margin_loss(x, lab),
        [f32(20, 5, 7), RS(21).randint(0, 7, (5,))], [0]),
    "multi_margin_loss_p2_weight": (
        lambda pd, x, lab, w: F(pd).multi_margin_loss(x, lab, p=2, weight=w,
                                                      reduction="sum"),
        [f32(20, 5, 7), RS(21).randint(0, 7, (5,)),
         np.abs(f32(22, 7)) + 0.5], [0, 2]),
    "multi_label_soft_margin_loss": (
        lambda pd, x, lab: F(pd).multi_label_soft_margin_loss(x, lab),
        [f32(22, 4, 6), (RS(23).rand(4, 6) < 0.5).astype(np.float32)], [0]),
    "poisson_nll_loss": (lambda pd, x, lab: F(pd).poisson_nll_loss(x, lab),
                         [f32(24, 8), np.abs(f32(25, 8))], [0]),
    "poisson_nll_loss_full": (
        lambda pd, x, lab: F(pd).poisson_nll_loss(
            x, lab, log_input=False, full=True, reduction="none"),
        [np.abs(f32(24, 8)) + 0.1, np.abs(f32(25, 8)) * 3], [0]),
    "gaussian_nll_loss": (
        lambda pd, x, lab, var: F(pd).gaussian_nll_loss(x, lab, var,
                                                        full=True),
        [f32(26, 8), f32(27, 8), np.abs(f32(28, 8)) + 0.1], [0, 2]),
    "triplet_margin_loss": (
        lambda pd, a, p, n: F(pd).triplet_margin_loss(a, p, n),
        [f32(29, 4, 6), f32(30, 4, 6), f32(31, 4, 6)], [0, 1, 2]),
    "triplet_margin_loss_swap": (
        lambda pd, a, p, n: F(pd).triplet_margin_loss(a, p, n, swap=True),
        [f32(29, 4, 6), f32(30, 4, 6), f32(31, 4, 6)], [0, 1, 2]),
    "triplet_margin_with_distance_loss": (
        lambda pd, a, p, n: F(pd).triplet_margin_with_distance_loss(
            a, p, n, margin=0.5),
        [f32(29, 4, 6), f32(30, 4, 6), f32(31, 4, 6)], [0, 1, 2]),
    "pairwise_distance": (lambda pd, a, b: F(pd).pairwise_distance(a, b),
                          [f32(32, 4, 6), f32(33, 4, 6)], [0, 1]),
    "pairwise_distance_inf_keepdim": (
        lambda pd, a, b: F(pd).pairwise_distance(a, b, p=float("inf"),
                                                 keepdim=True),
        [f32(32, 4, 6), f32(33, 4, 6)], [0, 1]),
    "sigmoid_focal_loss": (
        lambda pd, x, lab: F(pd).sigmoid_focal_loss(x, lab),
        [f32(34, 4, 3), (RS(35).rand(4, 3) < 0.3).astype(np.float32)], [0]),
    "dice_loss": (
        lambda pd, x, lab: F(pd).dice_loss(F(pd).softmax(x, axis=-1), lab),
        [f32(36, 3, 5), RS(37).randint(0, 5, (3, 1))], [0]),
    "npair_loss": (lambda pd, a, p, lab: F(pd).npair_loss(a, p, lab),
                   [f32(38, 4, 6), f32(39, 4, 6),
                    np.array([0, 1, 0, 2], np.int64)], [0, 1]),
    "rnnt_loss": (
        lambda pd, acts, lab, il, ll: F(pd).rnnt_loss(acts, lab, il, ll),
        [f32(50, 2, 4, 3, 5), RS(51).randint(1, 5, (2, 2)).astype(np.int32),
         np.full((2,), 4, np.int32), np.full((2,), 2, np.int32)], [0]),
    "flash_attn_qkvpacked": (
        lambda pd, qkv: F(pd).flash_attn_qkvpacked(qkv, causal=True),
        [f32(60, 2, 16, 3, 2, 8)], [0]),
    "flash_attn_varlen_qkvpacked": (
        lambda pd, qkv, cu: F(pd).flash_attn_varlen_qkvpacked(
            qkv, cu, cu, 12, 12, causal=True),
        [f32(61, 20, 3, 2, 8), np.array([0, 8, 20], np.int32)], [0]),
}

# the in-place activation spellings: the input is rebound
INPLACE = {"relu_": (), "tanh_": (), "elu_": (), "hardtanh_": (),
           "leaky_relu_": (), "softmax_": (), "thresholded_relu_": ()}


# name -> (make(pd) -> layer, forward(pd, layer, *tensors), inputs, grads)
def _seeded(pd, build):
    pd.seed(0)
    return build(pd.nn)


LAYERS = {
    "FractionalMaxPool2D": (
        lambda nn: nn.FractionalMaxPool2D(3, random_u=0.3),
        [f32(9, 1, 2, 7, 7)], [0]),
    "FractionalMaxPool3D": (
        lambda nn: nn.FractionalMaxPool3D(3, random_u=0.3),
        [f32(9, 1, 2, 7, 7, 7)], [0]),
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(3, 6, 3, stride=2),
                        [f32(11, 1, 3, 5)], [0]),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(2, 4, 3),
                        [f32(12, 1, 2, 4, 4, 4)], [0]),
    "Bilinear": (lambda nn: nn.Bilinear(3, 4, 5),
                 [f32(45, 2, 3), f32(46, 2, 4)], [0, 1]),
    "ChannelShuffle": (lambda nn: nn.ChannelShuffle(2),
                       [f32(48, 1, 4, 3, 3)], [0]),
    "PixelShuffle": (lambda nn: nn.PixelShuffle(2), [f32(48, 1, 8, 3, 3)],
                     [0]),
    "PixelUnshuffle": (lambda nn: nn.PixelUnshuffle(2),
                       [f32(48, 1, 2, 4, 4)], [0]),
    "Fold": (lambda nn: nn.Fold([4, 5], 2), [f32(47, 2, 12, 12)], [0]),
    "Unfold": (lambda nn: nn.Unfold(2), [f32(47, 2, 3, 4, 5)], [0]),
    "Unflatten": (lambda nn: nn.Unflatten(1, [2, 3]), [f32(47, 2, 6, 4)],
                  [0]),
    "Softmax2D": (lambda nn: nn.Softmax2D(), [f32(48, 1, 4, 3, 3)], [0]),
    "RReLU_eval": (lambda nn: _eval(nn.RReLU()),
                   [f32(49, 100)], [0]),
    "SpectralNorm": (lambda nn: nn.SpectralNorm([4, 6], power_iters=2),
                     [f32(53, 4, 6)], [0]),
    "Pad1D": (lambda nn: nn.Pad1D([1, 2], mode="reflect"),
              [f32(41, 1, 2, 5)], [0]),
    "Pad3D": (lambda nn: nn.Pad3D(1, mode="replicate"),
              [f32(42, 1, 2, 3, 3, 3)], [0]),
    "ZeroPad1D": (lambda nn: nn.ZeroPad1D(2), [f32(41, 1, 2, 5)], [0]),
    "ZeroPad3D": (lambda nn: nn.ZeroPad3D(1), [f32(42, 1, 2, 3, 3, 3)], [0]),
    "UpsamplingNearest2D": (lambda nn: nn.UpsamplingNearest2D(
        scale_factor=2), [f32(43, 1, 2, 4, 4)], [0]),
    "UpsamplingBilinear2D": (lambda nn: nn.UpsamplingBilinear2D(
        size=[6, 6]), [f32(43, 1, 2, 4, 4)], [0]),
    "HSigmoidLoss": (lambda nn: nn.HSigmoidLoss(6, 5),
                     [f32(54, 4, 6), RS(55).randint(0, 5, (4,))], [0]),
    "AdaptiveLogSoftmaxWithLoss": (
        lambda nn: nn.AdaptiveLogSoftmaxWithLoss(8, 12, cutoffs=[4, 8],
                                                 div_value=2.0,
                                                 head_bias=True),
        [f32(38, 6, 8), RS(39).randint(0, 12, (6,))], [0]),
}


# the layers that call one function of the tail with their arguments:
# held to that function in the port, exactly (outputs and gradients);
# the function is held to the reference above (FUNCS)
DELEGATES = {
    "AdaptiveAvgPool1D": (
        lambda nn: nn.AdaptiveAvgPool1D(4),
        lambda pd, x: F(pd).adaptive_avg_pool1d(x, 4),
        [f32(8, 1, 2, 9)], [0]),
    "AdaptiveMaxPool1D": (
        lambda nn: nn.AdaptiveMaxPool1D(4),
        lambda pd, x: F(pd).adaptive_max_pool1d(x, 4),
        [f32(8, 1, 2, 9)], [0]),
    "AdaptiveAvgPool3D": (
        lambda nn: nn.AdaptiveAvgPool3D(1),
        lambda pd, x: F(pd).adaptive_avg_pool3d(x, 1),
        [f32(7, 1, 2, 6, 6, 6)], [0]),
    "AdaptiveMaxPool3D": (
        lambda nn: nn.AdaptiveMaxPool3D(2),
        lambda pd, x: F(pd).adaptive_max_pool3d(x, 2),
        [f32(7, 1, 2, 6, 6, 6)], [0]),
    "MaxPool3D": (
        lambda nn: nn.MaxPool3D(2),
        lambda pd, x: F(pd).max_pool3d(x, 2),
        [f32(7, 1, 2, 6, 6, 6)], [0]),
    "AvgPool3D": (
        lambda nn: nn.AvgPool3D(2),
        lambda pd, x: F(pd).avg_pool3d(x, 2),
        [f32(7, 1, 2, 6, 6, 6)], [0]),
    "LPPool1D": (
        lambda nn: nn.LPPool1D(2.0, 3),
        lambda pd, x: F(pd).lp_pool1d(x, 2.0, 3),
        [np.abs(f32(8, 1, 2, 9))], [0]),
    "LPPool2D": (
        lambda nn: nn.LPPool2D(2.0, 2),
        lambda pd, x: F(pd).lp_pool2d(x, 2.0, 2),
        [np.abs(f32(8, 1, 2, 6, 6))], [0]),
    "AlphaDropout_eval": (
        lambda nn: _eval(nn.AlphaDropout(0.3)),
        lambda pd, x: F(pd).alpha_dropout(x, 0.3, training=False),
        [f32(13, 64)], [0]),
    "FeatureAlphaDropout_eval": (
        lambda nn: _eval(nn.FeatureAlphaDropout(0.3)),
        lambda pd, x: F(pd).feature_alpha_dropout(
            x, 0.3, training=False),
        [f32(13, 2, 4, 8)], [0]),
    "Dropout3D_eval": (
        lambda nn: _eval(nn.Dropout3D(0.5)),
        lambda pd, x: F(pd).dropout3d(x, 0.5, training=False),
        [f32(13, 2, 4, 3, 3, 3)], [0]),
    "PairwiseDistance": (
        lambda nn: nn.PairwiseDistance(),
        lambda pd, a, b: F(pd).pairwise_distance(a, b),
        [f32(32, 4, 6), f32(33, 4, 6)], [0, 1]),
    "CosineEmbeddingLoss": (
        lambda nn: nn.CosineEmbeddingLoss(margin=0.2),
        lambda pd, a, b, lab: F(pd).cosine_embedding_loss(
            a, b, lab, margin=0.2),
        [f32(14, 4, 6), f32(15, 4, 6),
         np.array([1, -1, 1, -1], np.int64)], [0, 1]),
    "GaussianNLLLoss": (
        lambda nn: nn.GaussianNLLLoss(),
        lambda pd, x, lab, var: F(pd).gaussian_nll_loss(x, lab,
                                                            var),
        [f32(26, 8), f32(27, 8), np.abs(f32(28, 8)) + 0.1], [0, 2]),
    "HingeEmbeddingLoss": (
        lambda nn: nn.HingeEmbeddingLoss(),
        lambda pd, x, lab: F(pd).hinge_embedding_loss(x, lab),
        [f32(16, 4, 5), sign(17, 4, 5)], [0]),
    "MultiLabelSoftMarginLoss": (
        lambda nn: nn.MultiLabelSoftMarginLoss(),
        lambda pd, x, lab: F(pd).multi_label_soft_margin_loss(
            x, lab),
        [f32(22, 4, 6), (RS(23).rand(4, 6) < 0.5).astype(np.float32)], [0]),
    "MultiMarginLoss": (
        lambda nn: nn.MultiMarginLoss(margin=0.5),
        lambda pd, x, lab: F(pd).multi_margin_loss(x, lab,
                                                        margin=0.5),
        [f32(20, 5, 7), RS(21).randint(0, 7, (5,))], [0]),
    "PoissonNLLLoss": (
        lambda nn: nn.PoissonNLLLoss(),
        lambda pd, x, lab: F(pd).poisson_nll_loss(x, lab),
        [f32(24, 8), np.abs(f32(25, 8))], [0]),
    "SoftMarginLoss": (
        lambda nn: nn.SoftMarginLoss(),
        lambda pd, x, lab: F(pd).soft_margin_loss(x, lab),
        [f32(18, 6), sign(19, 6)], [0]),
    "TripletMarginLoss": (
        lambda nn: nn.TripletMarginLoss(swap=True),
        lambda pd, a, p, n: F(pd).triplet_margin_loss(a, p, n,
                                                         swap=True),
        [f32(29, 4, 6), f32(30, 4, 6), f32(31, 4, 6)], [0, 1, 2]),
    "TripletMarginWithDistanceLoss": (
        lambda nn: nn.TripletMarginWithDistanceLoss(margin=0.5),
        lambda pd, a, p, n: F(
            pd).triplet_margin_with_distance_loss(a, p, n, margin=0.5),
        [f32(29, 4, 6), f32(30, 4, 6), f32(31, 4, 6)], [0, 1, 2]),
    "RNNTLoss": (
        lambda nn: nn.RNNTLoss(),
        lambda pd, acts, lab, il, ll: F(pd).rnnt_loss(acts, lab, il,
                                                              ll),
        [f32(50, 2, 4, 3, 5), RS(51).randint(1, 5, (2, 2)).astype(np.int32),
         np.full((2,), 4, np.int32), np.full((2,), 2, np.int32)], [0]),
}


def _eval(layer):
    layer.eval()
    return layer


def _tensors(pd, arrays, grad):
    out = []
    for i, a in enumerate(arrays):
        t = pd.to_tensor(a)
        if i in grad:
            t.stop_gradient = False
        out.append(t)
    return out


def _float(t):
    return np.dtype(str(t.numpy().dtype)).kind == "f"


def _backward(pd, outs):
    """The harness's weighted sum of the float outputs, backward; whether
    it carried gradients."""
    loss = RC.weighted_loss(pd, outs, _float)
    if loss is None or loss.stop_gradient:
        return False
    loss.backward()
    return True


def _compare(r_outs, p_outs, what):
    assert len(p_outs) == len(r_outs), what
    for k, (ra, p) in enumerate(zip(r_outs, p_outs)):
        pa = np.asarray(p.numpy())
        assert pa.shape == ra.shape, (what, k, pa.shape, ra.shape)
        if ra.dtype.kind == "f":
            np.testing.assert_allclose(pa, ra, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} output {k}")
        else:
            np.testing.assert_array_equal(pa, ra, err_msg=f"{what} {k}")


def _compare_grads(r_grads, p_ts, what):
    for k, (gr, p) in enumerate(zip(r_grads, p_ts)):
        if gr is None:
            assert p.grad is None or not np.any(p.grad.numpy()), (what, k)
            continue
        gr = np.asarray(gr, np.float64)
        gp = np.asarray(p.grad.numpy(), np.float64)
        np.testing.assert_allclose(gp, gr, rtol=RTOL,
                                   atol=ATOL * max(np.abs(gr).max(), 1.0),
                                   err_msg=f"{what} grad {k}")


CHUNK = 12
FUNC_CHUNKS = RC.chunks(FUNCS, CHUNK)
LAYER_CHUNKS = RC.chunks(LAYERS, CHUNK)


@functools.lru_cache(maxsize=None)
def _reference(names, layers):
    """The reference's results for one chunk of FUNCS or LAYERS."""
    if layers:
        cases = {n: RC.Case(LAYERS[n][0], lambda m, *ts: m(*ts),
                            LAYERS[n][1], LAYERS[n][2]) for n in names}
    else:
        cases = {n: RC.Case(None, functools.partial(
            lambda fn, m, *ts: fn(ref, *ts), FUNCS[n][0]), FUNCS[n][1],
            FUNCS[n][2]) for n in names}
    return RC.run(cases)


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_functions_match_the_reference(name):
    fn, arrays, grad = FUNCS[name]
    r = _reference(FUNC_CHUNKS[name], False)[name]
    ts = _tensors(port, arrays, grad)
    outs = RC.leaves(fn(port, *ts), port.Tensor)
    pb = _backward(port, outs)
    _compare(r.outs, outs, name)
    assert r.has_grad == pb
    if pb:
        _compare_grads(r.input_grads, [ts[i] for i in grad], name)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_match_the_reference(name):
    build, arrays, grad = LAYERS[name]
    r = _reference(LAYER_CHUNKS[name], True)[name]
    pl = _seeded(port, build)
    missing, unexpected = pl.set_state_dict(r.state)
    assert not missing and not unexpected
    assert list(pl.state_dict()) == list(r.state)
    ts = _tensors(port, arrays, grad)
    outs = RC.leaves(pl(*ts), port.Tensor)
    pb = _backward(port, outs)
    _compare(r.outs, outs, name)
    assert r.has_grad == pb
    if pb:
        _compare_grads(r.input_grads, [ts[i] for i in grad], name)
        pp = dict(pl.named_parameters())
        assert list(pp) == list(r.param_grads)
        _compare_grads(list(r.param_grads.values()), list(pp.values()),
                       f"{name} parameters")


@pytest.mark.parametrize("name", sorted(DELEGATES))
def test_delegating_layers_are_their_functions(name):
    build, fn, arrays, grad = DELEGATES[name]
    port.seed(0)
    layer = build(port.nn)
    got = []
    for call in (layer, lambda *ts: fn(port, *ts)):
        ts = _tensors(port, arrays, grad)
        outs = RC.leaves(call(*ts), port.Tensor)
        assert _backward(port, outs)
        got.append(([o.numpy() for o in outs],
                    [ts[i].grad.numpy() for i in grad]))
    (lo, lg), (fo, fg) = got
    assert len(lo) == len(fo)
    for a, b in zip(lo + lg, fo + fg):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("name", sorted(INPLACE))
def test_inplace_activations_rebind_their_input(name):
    x = f32(70, 3, 4)
    r, p = ref.to_tensor(x), port.to_tensor(x)
    ro = getattr(F(ref), name)(r)
    po = getattr(F(port), name)(p)
    assert po is p
    np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(po.numpy(), ro.numpy(), rtol=RTOL, atol=ATOL)


def test_dropout_variants_keep_their_laws_in_training():
    port.seed(5)
    x = port.to_tensor(f32(13, 20000))
    y = F(port).alpha_dropout(x, p=0.3, training=True).numpy()
    assert abs(y.mean()) < 0.1 and abs(y.std() - 1.0) < 0.15
    y = F(port).feature_alpha_dropout(port.to_tensor(f32(13, 64, 32, 16)),
                                      p=0.3, training=True).numpy()
    assert abs(y.mean()) < 0.1 and abs(y.std() - 1.0) < 0.15
    ones = port.to_tensor(np.ones((2, 8, 3, 3, 3), np.float32))
    y = port.nn.Dropout3D(0.5)(ones).numpy().reshape(2, 8, -1)
    assert all(len(np.unique(y[b, c])) == 1 for b in range(2)
               for c in range(8))
    assert set(np.unique(y)) <= {0.0, 2.0}
    # rrelu takes its mean slope in training too, as the reference's op
    # (`tail_math.rrelu`)
    z = -np.abs(f32(49, 1000)) - 0.1
    np.testing.assert_allclose(port.nn.RReLU()(port.to_tensor(z)).numpy(),
                               z * (1 / 8 + 1 / 3) / 2, rtol=1e-6)


def test_op_reexports_are_the_generated_bindings():
    from paddle_tpu_torch.nn.functional import extra as PE
    from paddle_tpu_torch.ops import generated_bindings as gen
    ops = ("bilinear", "class_center_sample", "flashmask_attention", "fold",
           "fractional_max_pool2d", "fractional_max_pool3d", "gather_tree",
           "hsigmoid_loss", "label_smooth", "log_loss", "lp_pool2d",
           "margin_cross_entropy", "rrelu", "sequence_mask",
           "sparse_attention")
    for name in ops:
        assert getattr(PE, name) is getattr(gen, name), name
    import paddle_tpu.nn.functional.extra as RE
    assert sorted(PE.__all__) == sorted(RE.__all__)


def test_parameter_dict_and_dynamic_decode():
    nn = port.nn
    pd = nn.ParameterDict({"a": port.create_parameter([2, 2], "float32")})
    pd["b"] = port.create_parameter([3], "float32")
    assert set(pd.keys()) == {"a", "b"} and len(pd) == 2
    assert [k for k, _ in pd.named_parameters()] == ["a", "b"]

    V, H = 7, 5
    dec = {}
    for pd_ in (ref, port):
        class Cell(pd_.nn.Layer):
            def __init__(self):
                super().__init__()
                self.proj = pd_.nn.Linear(H, H)
                self.out = pd_.nn.Linear(H, V)

            def forward(self, tok, state):
                h = pd_.nn.functional.relu(self.proj(state))
                return self.out(h), h

        pd_.seed(0)
        cell = Cell()
        if pd_ is port:
            cell.set_state_dict({k: np.asarray(v.numpy()) for k, v in
                                 dec["cell"].state_dict().items()})
        else:
            dec["cell"] = cell
        d = pd_.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                     beam_size=2)
        init = pd_.to_tensor(f32(52, 3, H))
        ids, state = pd_.nn.dynamic_decode(d, init, max_step_num=5)
        dec[pd_.__name__] = (ids.numpy(), state.numpy())
    ri, rs_ = dec["paddle_tpu"]
    pi, ps = dec["paddle_tpu_torch"]
    assert pi.shape == ri.shape and pi.shape[0] == 3 and pi.shape[2] == 2
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ps, rs_, rtol=RTOL, atol=ATOL)
