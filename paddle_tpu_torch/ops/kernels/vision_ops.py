"""Detection and OCR ops — port of `paddle_tpu/ops/kernels/vision_ops.py`.

- **Sampling** (`grid_sample`, `affine_grid`, `roi_align`, `roi_pool`,
  `psroi_pool`, `deformable_conv`, the interpolations): gathers by index
  tensors and weighted sums in f32, as the reference composes them, so
  the backward is torch's autograd through the gathers.
- **Box math** (`yolo_box`, `prior_box`, `box_coder`, `iou_similarity`,
  `matrix_nms`): elementwise torch on the boxes' device.
- **Selection** (`nms`, `multiclass_nms3`, and `generate_proposals`
  through them): the reference runs a numpy loop on the host in float64.
  Here the IoU tests run on the boxes' device (`_greedy_nms`): each
  round takes every (image, class) problem's next 64 undecided
  candidates in score order against all its undecided ones, the 64 x 64
  bits among the rows go to the host, which resolves their greedy order
  for every problem at once, and the kept rows suppress the rest on the
  device. Each bit is the reference's float64 `iou > threshold`:
  float32 corners are tested in float32 and the pairs within 1e-5 of the
  threshold again in float64 in the reference's order of operations. The
  kept indices are exactly the reference's: the same stable score order
  (ties by index), the same `>` test, the same `top_k` cut.
- `bipartite_match`, `distribute_fpn_proposals` and the rest of
  `generate_proposals` stay host loops in numpy, as in the reference;
  their outputs go back to the input's device.
- `ctc_loss`: the log-space alpha recursion, one step a time index,
  vectorised over the batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..dispatch import register_op
from ._util import pair

_F32 = torch.float32

# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


@register_op
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """x [N,C,H,W], grid [N,Hg,Wg,2] in [-1,1] -> [N,C,Hg,Wg]."""
    N, C, H, W = x.shape
    gx = _unnormalize(grid[..., 0].to(_F32), W, align_corners)
    gy = _unnormalize(grid[..., 1].to(_F32), H, align_corners)
    if padding_mode == "border":
        gx = gx.clamp(0, W - 1)
        gy = gy.clamp(0, H - 1)
    elif padding_mode == "reflection":
        def reflect(v, size):
            if align_corners:
                span = 2 * (size - 1)
                v = torch.remainder(v.abs(), max(span, 1))
                return torch.where(v > size - 1, span - v, v)
            span = 2 * size
            v = torch.remainder(v + 0.5, span).abs()
            v = torch.where(v > size, span - v, v)
            return (v - 0.5).clamp(0, size - 1)
        gx = reflect(gx, W)
        gy = reflect(gy, H)
    n_idx = torch.arange(N, device=x.device)[:, None, None]

    def sample(ix, iy):
        ixc = ix.clamp(0, W - 1).long()
        iyc = iy.clamp(0, H - 1).long()
        g = x[n_idx, :, iyc, ixc].permute(0, 3, 1, 2)    # [N, C, Hg, Wg]
        if padding_mode == "zeros":
            ok = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
            g = g * ok[:, None]
        return g

    if mode == "nearest":
        return sample(torch.round(gx), torch.round(gy)).to(x.dtype)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wa = (x1 - gx) * (y1 - gy)
    wb = (gx - x0) * (y1 - gy)
    wc = (x1 - gx) * (gy - y0)
    wd = (gx - x0) * (gy - y0)
    out = (sample(x0, y0) * wa[:, None] + sample(x1, y0) * wb[:, None]
           + sample(x0, y1) * wc[:, None] + sample(x1, y1) * wd[:, None])
    return out.to(x.dtype)


@register_op
def affine_grid(theta, out_shape, align_corners=True):
    """theta [N,2,3] -> sampling grid [N,H,W,2] (for grid_sample)."""
    N, _, H, W = [int(v) for v in out_shape]
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, W, device=dev)
        ys = torch.linspace(-1.0, 1.0, H, device=dev)
    else:
        xs = (torch.arange(W, device=dev) * 2 + 1) / W - 1.0
        ys = (torch.arange(H, device=dev) * 2 + 1) / H - 1.0
    gy, gx = torch.meshgrid(ys.to(_F32), xs.to(_F32), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)      # [H, W, 3]
    out = torch.einsum("hwk,nck->nhwc", base, theta.to(_F32))
    return out.to(theta.dtype)


def _image_of(boxes_num, N, K, device):
    """The image index of each of the K rois ([N] counts, or all image 0)."""
    if boxes_num is None:
        return torch.zeros(K, dtype=torch.long, device=device)
    counts = torch.as_tensor(boxes_num, device=device).reshape(-1).long()
    img = torch.repeat_interleave(torch.arange(N, device=device), counts)
    if img.shape[0] < K:       # jnp.repeat's total_repeat_length pads
        pad = img[-1:] if img.numel() else torch.zeros(1, dtype=torch.long,
                                                       device=device)
        img = torch.cat([img, pad.expand(K - img.shape[0])])
    return img[:K]


@register_op
def roi_align(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, aligned=True):
    """x [N,C,H,W]; boxes [K,4] (x1,y1,x2,y2); boxes_num [N] rois an image.
    Each bin averages sr x sr bilinear samples (sampling_ratio <= 0: 2)."""
    N, C, H, W = x.shape
    K = boxes.shape[0]
    sr = int(sampling_ratio) if sampling_ratio > 0 else 2
    dev = x.device
    img_of = _image_of(boxes_num, N, K, dev)
    off = 0.5 if aligned else 0.0
    b = boxes.to(_F32) * spatial_scale - off
    w1, h1, w2, h2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    roi_w = w2 - w1 if aligned else torch.clamp(w2 - w1, min=1.0)
    roi_h = h2 - h1 if aligned else torch.clamp(h2 - h1, min=1.0)
    bin_w = roi_w / pooled_width
    bin_h = roi_h / pooled_height
    py = torch.arange(pooled_height, dtype=_F32, device=dev)
    px = torch.arange(pooled_width, dtype=_F32, device=dev)
    s = (torch.arange(sr, dtype=_F32, device=dev) + 0.5) / sr
    yy = h1[:, None, None] + (py[None, :, None] + s[None, None, :]) \
        * bin_h[:, None, None]                               # [K, ph, sr]
    xx = w1[:, None, None] + (px[None, :, None] + s[None, None, :]) \
        * bin_w[:, None, None]                               # [K, pw, sr]
    y = yy.clamp(0, H - 1)
    xq = xx.clamp(0, W - 1)
    y0, x0 = torch.floor(y), torch.floor(xq)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly, lx = y - y0, xq - x0
    n = img_of[:, None, None, None, None]

    def g(yi, xi):           # -> [K, C, ph, sr, pw, sr]
        v = x[n, :, yi.long()[:, :, :, None, None],
              xi.long()[:, None, None, :, :]]
        return v.permute(0, 5, 1, 2, 3, 4)

    ly_ = ly[:, None, :, :, None, None]
    lx_ = lx[:, None, None, None, :, :]
    v = (g(y0, x0) * ((1 - ly_) * (1 - lx_)) + g(y0, x1) * ((1 - ly_) * lx_)
         + g(y1, x0) * (ly_ * (1 - lx_)) + g(y1, x1) * (ly_ * lx_))
    return v.mean(dim=(3, 5)).to(x.dtype)


def _bin_masks(b, ph, pw, H, W, dev):
    """Quantized bins of rounded boxes: (x1, y1, bin_w, bin_h) and the
    [K, ph, pw, H, W] membership of each pixel in each bin."""
    x1, y1 = b[:, 0], b[:, 1]
    x2 = torch.maximum(b[:, 2], x1 + 1)
    y2 = torch.maximum(b[:, 3], y1 + 1)
    bin_h = (y2 - y1) / ph
    bin_w = (x2 - x1) / pw
    hs = torch.arange(H, dtype=_F32, device=dev)
    ws = torch.arange(W, dtype=_F32, device=dev)
    py = torch.arange(ph, dtype=_F32, device=dev)
    px = torch.arange(pw, dtype=_F32, device=dev)
    y_lo = torch.floor(y1[:, None] + py * bin_h[:, None])        # [K, ph]
    y_hi = torch.ceil(y1[:, None] + (py + 1) * bin_h[:, None])
    x_lo = torch.floor(x1[:, None] + px * bin_w[:, None])        # [K, pw]
    x_hi = torch.ceil(x1[:, None] + (px + 1) * bin_w[:, None])
    in_y = (hs >= y_lo[..., None]) & (hs < y_hi[..., None])      # [K,ph,H]
    in_x = (ws >= x_lo[..., None]) & (ws < x_hi[..., None])      # [K,pw,W]
    return in_y[:, :, None, :, None] & in_x[:, None, :, None, :]


@register_op
def roi_pool(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    """Quantized max pooling over rois (empty bins give 0)."""
    N, C, H, W = x.shape
    K = boxes.shape[0]
    img_of = _image_of(boxes_num, N, K, x.device)
    b = torch.round(boxes.to(_F32) * spatial_scale)
    m = _bin_masks(b, pooled_height, pooled_width, H, W, x.device)
    img = x[img_of][:, :, None, None]                       # [K,C,1,1,H,W]
    vals = torch.where(m[:, None], img, torch.tensor(float("-inf"),
                                                     dtype=x.dtype,
                                                     device=x.device))
    out = vals.amax(dim=(4, 5))
    return torch.where(torch.isfinite(out), out,
                       torch.zeros((), dtype=out.dtype, device=x.device))


@register_op
def psroi_pool(x, boxes, boxes_num=None, output_channels=1,
               spatial_scale=1.0, pooled_height=1, pooled_width=1):
    """Position-sensitive RoI average pooling: bin (i, j) pools its own
    channel group."""
    N, C, H, W = x.shape
    ph, pw = pooled_height, pooled_width
    assert C == output_channels * ph * pw
    K = boxes.shape[0]
    img_of = _image_of(boxes_num, N, K, x.device)
    b = torch.round(boxes.to(_F32) * spatial_scale)
    m = _bin_masks(b, ph, pw, H, W, x.device)                 # [K,ph,pw,H,W]
    cnt = torch.clamp(m.sum(dim=(3, 4)), min=1)
    img = x[img_of].reshape(K, output_channels, ph, pw, H, W)
    vals = (img * m[:, None]).sum(dim=(4, 5)) / cnt[:, None]
    return vals.to(x.dtype)


@register_op
def deformable_conv(x, offset, weight, mask=None, stride=1, padding=0,
                    dilation=1, deformable_groups=1, groups=1, im2col_step=1):
    """Deformable conv v1/v2 as offset-driven bilinear samples and one
    product. x [N,Cin,H,W]; offset [N, 2*dg*kh*kw, Ho, Wo]; mask (v2)
    [N, dg*kh*kw, Ho, Wo]; weight [Cout, Cin/groups, kh, kw]."""
    N, Cin, H, W = x.shape
    Cout, Cpg, kh, kw = weight.shape
    sh, sw = pair(stride)
    ph, pw_ = pair(padding)
    dh, dw = pair(dilation)
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw_ - dw * (kw - 1) - 1) // sw + 1
    dg = deformable_groups
    cpd = Cin // dg
    dev = x.device
    off = offset.to(_F32).reshape(N, dg, kh * kw, 2, Ho, Wo)
    oy = off[:, :, :, 0].reshape(N, dg, kh, kw, Ho, Wo)
    ox = off[:, :, :, 1].reshape(N, dg, kh, kw, Ho, Wo)
    gy = torch.arange(Ho, device=dev)[:, None] * sh - ph
    gx = torch.arange(Wo, device=dev)[None, :] * sw - pw_
    ky = torch.arange(kh, device=dev) * dh
    kx = torch.arange(kw, device=dev) * dw
    py = (ky[:, None, None, None] + gy[None, None]).to(_F32)  # [kh,1,Ho,1]
    px = (kx[None, :, None, None] + gx[None, None]).to(_F32)  # [1,kw,1,Wo]
    sy = py + oy                                          # [N,dg,kh,kw,Ho,Wo]
    sx = px + ox
    # bilinear samples with zeros outside the image, as the reference's
    # four masked corners: grid_sample's unnormalized coordinates
    # (align_corners=False) are the sample positions
    grid = torch.stack([(2 * sx + 1) / W - 1, (2 * sy + 1) / H - 1], -1)
    cols = F.grid_sample(x.to(_F32).reshape(N * dg, cpd, H, W),
                         grid.reshape(N * dg, kh * kw * Ho, Wo, 2),
                         mode="bilinear", padding_mode="zeros",
                         align_corners=False)
    cols = cols.reshape(N, dg, cpd, kh, kw, Ho, Wo)
    if mask is not None:
        cols = cols * mask.to(_F32).reshape(N, dg, 1, kh, kw, Ho, Wo)
    cols = cols.reshape(N, Cin, kh, kw, Ho, Wo)
    if groups > 1:
        cols_g = cols.reshape(N, groups, Cin // groups, kh, kw, Ho, Wo)
        w_g = weight.to(_F32).reshape(groups, Cout // groups, Cpg, kh, kw)
        out = torch.einsum("ngcklhw,gockl->ngohw", cols_g, w_g).reshape(
            N, Cout, Ho, Wo)
    else:
        out = torch.einsum("ncklhw,ockl->nohw", cols, weight.to(_F32))
    return out.to(x.dtype)


def _to_nchw(x, data_format):
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(x, data_format):
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


@register_op
def depthwise_conv2d(x, weight, stride=1, padding=0, dilation=1,
                     data_format="NCHW"):
    """One filter per input channel: x [N,C,H,W] (or NHWC); weight
    [C*m, 1, kh, kw]."""
    x = _to_nchw(x, data_format)
    out = F.conv2d(x.to(_F32), weight.to(_F32), None, pair(stride),
                   pair(padding), pair(dilation),
                   groups=x.shape[1])
    return _from_nchw(out.to(x.dtype), data_format)


# ---------------------------------------------------------------------------
# Box math
# ---------------------------------------------------------------------------


@register_op
def yolo_box(x, img_size, anchors=(), class_num=1, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLO head: x [N, an*(5+cls), H, W] -> (boxes
    [N, an*H*W, 4], scores [N, an*H*W, cls]). With iou_aware, channels
    [0, an) are the anchors' IoU predictions, the rest the usual entries."""
    anchors = list(anchors)
    an = len(anchors) // 2
    N, _, H, W = x.shape
    dev = x.device
    xf = x.to(_F32)
    if iou_aware:
        ioup = torch.sigmoid(xf[:, :an])
        xf = xf[:, an:]
    xr = xf.reshape(N, an, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=_F32, device=dev)
    gy = torch.arange(H, dtype=_F32, device=dev)[:, None]
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(xr[:, :, 0]) * alpha + beta + gx) / W
    cy = (torch.sigmoid(xr[:, :, 1]) * alpha + beta + gy) / H
    aw = torch.tensor(anchors[0::2], dtype=_F32, device=dev)[:, None, None]
    ah = torch.tensor(anchors[1::2], dtype=_F32, device=dev)[:, None, None]
    in_w, in_h = W * downsample_ratio, H * downsample_ratio
    bw = torch.exp(xr[:, :, 2]) * aw / in_w
    bh = torch.exp(xr[:, :, 3]) * ah / in_h
    obj = torch.sigmoid(xr[:, :, 4])
    if iou_aware:
        obj = (obj ** (1.0 - iou_aware_factor)) * (ioup ** iou_aware_factor)
    keep = obj >= conf_thresh
    obj = torch.where(keep, obj, torch.zeros((), dtype=_F32, device=dev))
    scores = obj[:, :, None] * torch.sigmoid(xr[:, :, 5:])
    img_h = img_size[:, 0].to(_F32)[:, None, None, None]
    img_w = img_size[:, 1].to(_F32)[:, None, None, None]
    x1 = (cx - bw / 2) * img_w
    y1 = (cy - bh / 2) * img_h
    x2 = (cx + bw / 2) * img_w
    y2 = (cy + bh / 2) * img_h
    if clip_bbox:
        zero = torch.zeros((), dtype=_F32, device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep[..., None]
    boxes = boxes.reshape(N, an * H * W, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(N, an * H * W, class_num)
    return boxes, scores


@register_op(nondiff=True)
def prior_box(input, image, min_sizes=(), max_sizes=(), aspect_ratios=(1.0,),
              variances=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False):
    """SSD prior anchors: (boxes [H,W,P,4], variances [H,W,P,4]),
    normalized to the image."""
    _, _, H, W = input.shape
    _, _, img_h, img_w = image.shape
    dev = input.device
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    step_w = steps[0] or img_w / W
    step_h = steps[1] or img_h / H
    whs = []
    for ms in min_sizes:
        mx = (max_sizes[list(min_sizes).index(ms)] if max_sizes else None)
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if mx is not None:
                whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
            whs += [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars
                    if abs(ar - 1.0) >= 1e-6]
        else:
            whs += [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars]
            if mx is not None:
                whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
    whs = torch.as_tensor(np.asarray(whs, np.float32), device=dev)
    P = whs.shape[0]
    cx = (torch.arange(W, dtype=_F32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=_F32, device=dev) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")          # [H, W]
    bw = whs[:, 0] / 2
    bh = whs[:, 1] / 2
    out = torch.stack([
        (cxg[..., None] - bw) / img_w, (cyg[..., None] - bh) / img_h,
        (cxg[..., None] + bw) / img_w, (cyg[..., None] + bh) / img_h,
    ], dim=-1)                                                # [H, W, P, 4]
    if clip:
        out = out.clamp(0.0, 1.0)
    var = torch.tensor(list(variances), dtype=_F32,
                       device=dev).expand(H, W, P, 4).contiguous()
    return out, var


@register_op
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0):
    """Encode or decode boxes against priors."""
    pb = prior_box.to(_F32)
    tb = target_box.to(_F32)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5 - (0.0 if box_normalized else 0.5)
    pcy = pb[:, 1] + ph * 0.5 - (0.0 if box_normalized else 0.5)
    if prior_box_var is not None:
        pv = torch.as_tensor(prior_box_var, dtype=_F32,
                             device=pb.device).expand(pb.shape)
    else:
        pv = torch.ones_like(pb)
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        ox = (tcx[:, None] - pcx[None]) / pw[None] / pv[None, :, 0]
        oy = (tcy[:, None] - pcy[None]) / ph[None] / pv[None, :, 1]
        ow = torch.log(torch.abs(tw[:, None] / pw[None])) / pv[None, :, 2]
        oh = torch.log(torch.abs(th[:, None] / ph[None])) / pv[None, :, 3]
        return torch.stack([ox, oy, ow, oh], dim=-1)
    # decode_center_size: target [R, C, 4]; `axis` picks the target dim
    # the priors pair with (axis 0: along dim 1; axis 1: along dim 0)
    if tb.ndim == 2:
        tb = tb[:, None, :]

    def along(v):
        return v[None, :] if axis == 0 else v[:, None]

    d = tb * along(pv) if prior_box_var is not None else tb
    dcx = d[..., 0] * along(pw) + along(pcx)
    dcy = d[..., 1] * along(ph) + along(pcy)
    dw = torch.exp(d[..., 2]) * along(pw)
    dh = torch.exp(d[..., 3]) * along(ph)
    return torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                        dcx + dw * 0.5 - norm, dcy + dh * 0.5 - norm], dim=-1)


def _iou_matrix(a, b, eps=1e-10, offset=0.0):
    """a [..., K, 4], b [..., P, 4] -> IoU [..., K, P] (corner boxes);
    offset 1 is the pixel convention (w = x2 - x1 + 1)."""
    area_a = (torch.clamp(a[..., 2] - a[..., 0] + offset, min=0)
              * torch.clamp(a[..., 3] - a[..., 1] + offset, min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0] + offset, min=0)
              * torch.clamp(b[..., 3] - b[..., 1] + offset, min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + offset, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=eps)


@register_op
def iou_similarity(x, y, box_normalized=True):
    return _iou_matrix(x.to(_F32), y.to(_F32),
                       offset=0.0 if box_normalized else 1.0)


def _argsort_desc(v, dim=-1):
    """Indices of v in descending order, ties by index (numpy's stable
    argsort of -v)."""
    return torch.argsort(-v, dim=dim, stable=True)


@register_op(nondiff=True)
def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True):
    """Matrix NMS (SOLOv2): every box's score decays by its overlap with
    the higher-scored boxes of its class; static shapes throughout.
    -> (out [B, keep, 6], index [B, keep])."""
    B, C, M = scores.shape
    k = min(nms_top_k if nms_top_k > 0 else M, M)
    offset = 0.0 if normalized else 1.0
    sc = scores.to(_F32)
    bx_all = bboxes.to(_F32)
    idx = _argsort_desc(sc)[..., :k]                            # [B, C, k]
    sc_s = torch.gather(sc, 2, idx)
    bx = torch.gather(bx_all[:, None].expand(B, C, M, 4), 2,
                      idx[..., None].expand(B, C, k, 4))        # [B,C,k,4]
    iou = torch.triu(_iou_matrix(bx, bx, offset=offset), diagonal=1)
    comp = iou.amax(dim=-2)                                     # [B, C, k]
    if use_gaussian:
        decay = torch.exp(-(iou ** 2 - comp[..., :, None] ** 2)
                          / gaussian_sigma).amin(dim=-2)
    else:
        decay = ((1 - iou) / torch.clamp(1 - comp[..., :, None], min=1e-10)
                 ).amin(dim=-2)
    zero = torch.zeros((), dtype=_F32, device=sc.device)
    decs = torch.where(sc_s > score_threshold, sc_s * decay, zero)
    if 0 <= background_label < C:
        decs[:, background_label] = 0.0
    labels = torch.arange(C, dtype=_F32, device=sc.device)[:, None].expand(
        C, k).reshape(-1)
    decs = decs.reshape(B, C * k)
    bxs = bx.reshape(B, C * k, 4)
    idxs = idx.reshape(B, C * k)
    if post_threshold > 0:
        decs = torch.where(decs >= post_threshold, decs, zero)
    keep = min(keep_top_k if keep_top_k > 0 else C * k, C * k)
    order = _argsort_desc(decs)[:, :keep]                       # [B, keep]
    out = torch.cat([labels[order][..., None],
                     torch.gather(decs, 1, order)[..., None],
                     torch.gather(bxs, 1, order[..., None].expand(
                         B, keep, 4))], dim=-1)
    return out, torch.gather(idxs, 1, order).long()


# -- hard NMS: IoU tests on the device, the greedy order resolved by block --

_NMS_BLOCK = 64


def _iou_parts(a, b):
    """(inter, union) of corner boxes a [..., 4] and b [..., 4] in the
    reference's order of operations and in their dtype."""
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    w = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                    - torch.maximum(a[..., 0], b[..., 0]), min=0)
    h = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                    - torch.maximum(a[..., 1], b[..., 1]), min=0)
    inter = w * h
    return inter, area_a + area_b - inter


# float32 IoUs of float32 corners are within ~1e-6 of the float64 ones
# (the corners are exact, each operation rounds once and the union
# cannot cancel: it is at least the larger area); a test that far from
# the threshold has the float64 answer
_IOU_MARGIN = 1e-5


def _suppress_bits(boxes, rows, cols, thr):
    """`iou > thr` of boxes[rows] against boxes[cols] (boxes [P, M, 4]
    float32 or float64, rows [P, r], cols [P, c] index tensors) ->
    [P, r, c] bool, each bit the reference's float64 test. float64 boxes
    are tested as they are; for float32 boxes the pairs whose float32 IoU
    lies within _IOU_MARGIN of thr are recomputed in float64 in the
    reference's order of operations. Runs over slices of the P problems
    to bound the temporaries."""
    P, r, c = rows.shape[0], rows.shape[1], cols.shape[1]
    # a slice's temporaries: cache-sized on the CPU, large on the card
    cap = 1 << (24 if boxes.is_cuda else 18)
    step = max(1, cap // max(r * c, 1))
    out = []
    for p0 in range(0, P, step):
        bx = boxes[p0:p0 + step]
        n = bx.shape[0]
        a = torch.gather(bx, 1, rows[p0:p0 + step, :, None].expand(n, r, 4))
        b = torch.gather(bx, 1, cols[p0:p0 + step, :, None].expand(n, c, 4))
        inter, union = _iou_parts(a[:, :, None], b[:, None])
        iou = inter / torch.clamp(union, min=1e-10)
        bits = iou > thr
        if bx.dtype == torch.float64:
            out.append(bits)
            continue
        near = torch.nonzero((iou - thr).abs() <= _IOU_MARGIN)
        if near.shape[0]:
            pi, ri, ci = near.unbind(1)
            i64, u64 = _iou_parts(a[pi, ri].double(), b[pi, ci].double())
            bits[pi, ri, ci] = i64 / torch.clamp(u64, min=1e-10) > thr
        out.append(bits)
    return torch.cat(out) if len(out) > 1 else out[0]


def _screened(boxes):
    """Boxes in the dtype their IoU tests run in: float64 stays, the
    narrower float types widen exactly to float32."""
    return boxes if boxes.dtype == torch.float64 else boxes.to(torch.float32)


def _greedy_nms(boxes, order, valid, thr, top_k=-1):
    """Hard NMS over P independent problems at once.

    boxes [P, M, 4] (`_screened`); order [P, M] the candidates in score
    order;
    valid [P, M] which entries of `order` take part. Returns kept [P, M]
    (host bool) over the positions of `order`: a candidate is kept when
    no earlier kept candidate's IoU with it exceeds thr, until top_k are
    kept (top_k <= 0: no cut).

    Each round takes every problem's next _NMS_BLOCK undecided
    candidates as rows and all its undecided candidates as columns (a
    stable sort of the `done` flags packs them in score order), tests
    them on the device, resolves the rows' greedy order on the host from
    their row-by-row bits, and marks the columns the kept rows suppress.
    A candidate is decided once every earlier one is, so the kept set is
    the sequential loop's."""
    P, M = order.shape
    dev = boxes.device
    done = ~valid
    kept = np.zeros((P, M), bool)
    count = np.zeros(P, np.int64)
    limit = top_k if top_k > 0 else M + 1
    boxes = torch.gather(boxes, 1, order[..., None].expand(P, M, 4))
    while True:
        left = (~done).sum(1).cpu().numpy()
        c_max = int(left.max()) if P else 0
        if c_max == 0:
            break
        r_max = min(_NMS_BLOCK, c_max)
        cols = torch.argsort(done.to(torch.int8), dim=1,
                             stable=True)[:, :c_max]
        bits = _suppress_bits(boxes, cols[:, :r_max], cols, thr)
        inner = bits[:, :, :r_max].cpu().numpy()
        rows_h = cols[:, :r_max].cpu().numpy()
        live = np.arange(r_max)[None, :] < np.minimum(left, r_max)[:, None]
        k_blk = np.zeros((P, r_max), bool)
        for j in range(r_max):
            ok = live[:, j] & (count < limit)
            if j:
                ok &= ~(k_blk[:, :j] & inner[:, :j, j]).any(axis=1)
            k_blk[:, j] = ok
            count += ok
        pi, ji = np.nonzero(k_blk)
        kept[pi, rows_h[pi, ji]] = True
        kb = torch.as_tensor(k_blk, device=dev)
        decided = (bits & kb[:, :, None]).any(dim=1)            # [P, c_max]
        decided[:, :r_max] |= torch.as_tensor(live, device=dev)
        decided |= torch.as_tensor(count >= limit, device=dev)[:, None]
        done.scatter_(1, cols, decided | done.gather(1, cols))
    return kept


def _nms_indices(boxes, scores, iou_threshold, top_k=-1):
    """The kept indices of one hard NMS (int64, score-descending) on the
    boxes' device."""
    b = _screened(boxes).reshape(1, -1, 4)
    n = b.shape[1]
    dev = boxes.device
    if scores is None:
        order = torch.arange(n, device=dev)[None]
    else:
        order = _argsort_desc(scores.to(torch.float64).reshape(-1))[None]
    if n == 0:
        return torch.zeros(0, dtype=torch.long, device=dev)
    kept = _greedy_nms(b, order, torch.ones(1, n, dtype=torch.bool,
                                            device=dev),
                       iou_threshold, top_k)
    return order[0][torch.as_tensor(kept[0], device=dev)]


@register_op(nondiff=True)
def nms(boxes, scores=None, iou_threshold=0.3, top_k=-1):
    """Hard NMS -> kept indices, score-descending (ties by index)."""
    return _nms_indices(boxes, scores, iou_threshold, top_k)


@register_op(nondiff=True)
def multiclass_nms3(bboxes, scores, rois_num=None, score_threshold=0.05,
                    nms_top_k=1000, keep_top_k=100, nms_threshold=0.3,
                    normalized=True, nms_eta=1.0, background_label=-1):
    """Per-class hard NMS and a cross-class top-k. bboxes [B,M,4], scores
    [B,C,M] -> (out [total,6] = [label, score, x1,y1,x2,y2], index [total]
    = b*M + box, nms_num [B] int32). Every (image, class) runs in one
    batched `_greedy_nms` on the device; the merge is on the host."""
    dev = scores.device
    B, C, M = scores.shape
    classes = [c for c in range(C) if c != background_label]
    sc = scores.to(torch.float64)[:, classes]                  # [B, C', M]
    Cn = len(classes)
    masked = torch.where(sc > score_threshold, sc,
                         torch.tensor(float("-inf"), dtype=sc.dtype,
                                      device=dev))
    K = min(nms_top_k, M) if nms_top_k > 0 else M
    order = _argsort_desc(masked)[..., :K]                     # [B, C', K]
    valid = torch.gather(masked, 2, order) > float("-inf")
    bb = bboxes.to(torch.float64)
    boxes = _screened(bboxes)[:, None].expand(B, Cn, M, 4).reshape(
        B * Cn, M, 4)
    kept = _greedy_nms(boxes, order.reshape(B * Cn, K),
                       valid.reshape(B * Cn, K), nms_threshold)
    kept = kept.reshape(B, Cn, K)
    order_h = order.cpu().numpy()
    sc_h = sc.cpu().numpy()
    bb_h = bb.cpu().numpy()
    outs, idxs, nums = [], [], []
    for b in range(B):
        ci, ki = np.nonzero(kept[b])          # class-major, keep order
        gi = order_h[b, ci, ki]
        s = sc_h[b, ci, gi]
        pick = np.argsort(-s, kind="stable")
        if keep_top_k > 0:
            pick = pick[:keep_top_k]
        nums.append(len(pick))
        lab = np.asarray(classes, np.float64)[ci[pick]]
        outs.append(np.concatenate([lab[:, None], s[pick, None],
                                    bb_h[b, gi[pick]]], axis=1))
        idxs.append(b * M + gi[pick])
    out = np.concatenate(outs).astype(np.float32) if outs else \
        np.zeros((0, 6), np.float32)
    index = np.concatenate(idxs).astype(np.int64) if idxs else \
        np.zeros((0,), np.int64)
    return (torch.as_tensor(out.reshape(-1, 6), device=dev),
            torch.as_tensor(index, device=dev),
            torch.as_tensor(np.asarray(nums, np.int32), device=dev))


def _host64(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t, np.float64)


@register_op(nondiff=True)
def bipartite_match(dist_mat, match_type="bipartite", dist_threshold=0.5):
    """Greedy bipartite matching (repeatedly the global max entry) on the
    host. dist [K, P] -> (match_idx [P] int64, match_dist [P] f32)."""
    full = _host64(dist_mat)
    d = full.copy()
    K, P = d.shape
    match_idx = np.full(P, -1, np.int64)
    match_dist = np.zeros(P, np.float64)
    while True:
        i, j = np.unravel_index(np.argmax(d), d.shape)
        if d[i, j] <= 0:
            break
        match_idx[j] = i
        match_dist[j] = d[i, j]
        d[i, :] = -1
        d[:, j] = -1
    if match_type == "per_prediction":
        for j in range(P):
            if match_idx[j] == -1:
                i = int(np.argmax(full[:, j]))
                if full[i, j] >= dist_threshold:
                    match_idx[j] = i
                    match_dist[j] = full[i, j]
    dev = dist_mat.device
    return (torch.as_tensor(match_idx, device=dev),
            torch.as_tensor(match_dist.astype(np.float32), device=dev))


@register_op(nondiff=True)
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, pixel_offset=False):
    """Assign each RoI to an FPN level by its scale (host op)."""
    rois = _host64(fpn_rois)
    dev = fpn_rois.device
    off = 1.0 if pixel_offset else 0.0
    w = np.maximum(rois[:, 2] - rois[:, 0] + off, 0)
    h = np.maximum(rois[:, 3] - rois[:, 1] + off, 0)
    lvl = np.floor(np.log2(np.sqrt(w * h) / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, restore = [], []
    for level in range(min_level, max_level + 1):
        sel = np.nonzero(lvl == level)[0]
        outs.append(torch.as_tensor(rois[sel].astype(np.float32),
                                    device=dev))
        restore.extend(sel.tolist())
    restore_ind = np.argsort(np.asarray(restore, np.int64))
    return outs, torch.as_tensor(restore_ind.astype(np.int64), device=dev)


@register_op(nondiff=True)
def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False):
    """RPN proposals: decode the deltas on the anchors, clip, drop the
    small ones, NMS. scores [N, A, H, W]; bbox_deltas [N, A*4, H, W];
    anchors [H, W, A, 4]. The decode is host numpy in float64, as the
    reference's; the NMS is `nms`'s."""
    N, A, H, W = scores.shape
    dev = scores.device
    anc = _host64(anchors).reshape(-1, 4)
    var = _host64(variances).reshape(-1, 4)
    sc_all = _host64(scores)
    dl_all = _host64(bbox_deltas)
    ims = _host64(im_shape)
    rois_all, num_all, scores_all = [], [], []
    off = 1.0 if pixel_offset else 0.0
    for n in range(N):
        sc = sc_all[n].transpose(1, 2, 0).reshape(-1)
        dl = dl_all[n].reshape(A, 4, H, W).transpose(2, 3, 0, 1).reshape(
            -1, 4)
        order = np.argsort(-sc, kind="stable")[:pre_nms_top_n]
        sc, dl, an, vr = sc[order], dl[order], anc[order], var[order]
        aw = an[:, 2] - an[:, 0] + off
        ah = an[:, 3] - an[:, 1] + off
        acx = an[:, 0] + aw / 2
        acy = an[:, 1] + ah / 2
        cx = vr[:, 0] * dl[:, 0] * aw + acx
        cy = vr[:, 1] * dl[:, 1] * ah + acy
        bw = np.exp(np.minimum(vr[:, 2] * dl[:, 2], 10.0)) * aw
        bh = np.exp(np.minimum(vr[:, 3] * dl[:, 3], 10.0)) * ah
        boxes = np.stack([cx - bw / 2, cy - bh / 2,
                          cx + bw / 2 - off, cy + bh / 2 - off], axis=1)
        hmax, wmax = ims[n][:2]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, wmax - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, hmax - off)
        ww = boxes[:, 2] - boxes[:, 0] + off
        hh = boxes[:, 3] - boxes[:, 1] + off
        keep = (ww >= min_size) & (hh >= min_size)
        boxes, sc = boxes[keep], sc[keep]
        k = _nms_indices(torch.as_tensor(boxes, device=dev),
                         torch.as_tensor(sc, device=dev),
                         nms_thresh).cpu().numpy()[:post_nms_top_n]
        rois_all.append(boxes[k])
        scores_all.append(sc[k])
        num_all.append(len(k))
    return (torch.as_tensor(np.concatenate(rois_all).astype(np.float32),
                            device=dev),
            torch.as_tensor(np.concatenate(scores_all).astype(np.float32),
                            device=dev),
            torch.as_tensor(np.asarray(num_all, np.int32), device=dev))


# ---------------------------------------------------------------------------
# Interpolation and layout
# ---------------------------------------------------------------------------


def _interp_positions(out_size, in_size, align_corners, align_mode, dev):
    o = torch.arange(out_size, dtype=_F32, device=dev)
    if align_corners:
        return o * (in_size - 1) / max(out_size - 1, 1)
    if align_mode == 0:                    # half-pixel
        return ((o + 0.5) * in_size / out_size - 0.5).clamp(0, in_size - 1)
    return (o * in_size / out_size).clamp(0, in_size - 1)


@register_op
def bilinear_interp(x, out_h, out_w, align_corners=True, align_mode=1):
    """x [N,C,H,W] -> [N,C,out_h,out_w]."""
    N, C, H, W = x.shape
    ys = _interp_positions(out_h, H, align_corners, align_mode, x.device)
    xs = _interp_positions(out_w, W, align_corners, align_mode, x.device)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (ys - y0)[:, None]
    wx = xs - x0
    xf = x.to(_F32)
    v = (xf[:, :, y0][:, :, :, x0] * (1 - wy) * (1 - wx)
         + xf[:, :, y0][:, :, :, x1] * (1 - wy) * wx
         + xf[:, :, y1][:, :, :, x0] * wy * (1 - wx)
         + xf[:, :, y1][:, :, :, x1] * wy * wx)
    return v.to(x.dtype)


@register_op
def nearest_interp(x, out_h, out_w, align_corners=False):
    N, C, H, W = x.shape
    dev = x.device
    if align_corners:
        ys = torch.round(torch.arange(out_h, device=dev) * (H - 1)
                         / max(out_h - 1, 1)).long()
        xs = torch.round(torch.arange(out_w, device=dev) * (W - 1)
                         / max(out_w - 1, 1)).long()
    else:
        ys = torch.floor(torch.arange(out_h, device=dev) * H / out_h).long()
        xs = torch.floor(torch.arange(out_w, device=dev) * W / out_w).long()
    return x[:, :, ys][:, :, :, xs]


@register_op
def linear_interp(x, out_w, align_corners=True, align_mode=1):
    """x [N,C,W] 1-D linear resize."""
    N, C, W = x.shape
    xs = _interp_positions(out_w, W, align_corners, align_mode, x.device)
    x0 = torch.floor(xs).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wx = xs - x0
    xf = x.to(_F32)
    return (xf[:, :, x0] * (1 - wx) + xf[:, :, x1] * wx).to(x.dtype)


@register_op
def pixel_unshuffle(x, downscale_factor=1, data_format="NCHW"):
    r = downscale_factor
    x = _to_nchw(x, data_format)
    N, C, H, W = x.shape
    x = x.reshape(N, C, H // r, r, W // r, r)
    out = x.permute(0, 1, 3, 5, 2, 4).reshape(N, C * r * r, H // r, W // r)
    return _from_nchw(out, data_format)


@register_op
def channel_shuffle(x, groups=1, data_format="NCHW"):
    x = _to_nchw(x, data_format)
    N, C, H, W = x.shape
    x = x.reshape(N, groups, C // groups, H, W)
    return _from_nchw(x.transpose(1, 2).reshape(N, C, H, W), data_format)


@register_op
def temporal_shift(x, seg_num=1, shift_ratio=0.25, data_format="NCHW"):
    """TSM shift: one channel slice one step along time within each
    segment group, a second slice the other way."""
    x = _to_nchw(x, data_format)
    NT, C, H, W = x.shape
    N = NT // seg_num
    c1 = int(C * shift_ratio)
    c2 = int(C * 2 * shift_ratio)
    xr = x.reshape(N, seg_num, C, H, W)
    fwd = torch.cat([xr[:, 1:, :c1], torch.zeros_like(xr[:, :1, :c1])], 1)
    bwd = torch.cat([torch.zeros_like(xr[:, :1, c1:c2]), xr[:, :-1, c1:c2]],
                    1)
    out = torch.cat([fwd, bwd, xr[:, :, c2:]], dim=2).reshape(NT, C, H, W)
    return _from_nchw(out, data_format)


@register_op
def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          global_pooling=False, adaptive=False):
    """Max pool returning (out, flat argmax indices into H*W)."""
    N, C, H, W = x.shape
    kh, kw = pair(kernel_size)
    sh, sw = pair(stride or kernel_size)
    ph, pw = pair(padding)
    if global_pooling:
        kh, kw, sh, sw, ph, pw = H, W, 1, 1, 0, 0
    # a large finite negative pad, as the reference's patch extraction
    neg = torch.finfo(_F32).min / 4
    xp = F.pad(x.to(_F32), (pw, pw, ph, ph), value=neg)
    patches = xp.unfold(2, kh, sh).unfold(3, kw, sw)      # [N,C,Ho,Wo,kh,kw]
    Ho, Wo = patches.shape[2], patches.shape[3]
    patches = patches.reshape(N, C, Ho, Wo, kh * kw)
    out, arg = patches.max(dim=-1)
    # the first maximum of the window, as jnp.argmax
    arg = (patches == out[..., None]).to(torch.uint8).argmax(dim=-1)
    wy = arg // kw
    wx = arg % kw
    oy = torch.arange(Ho, device=x.device)[:, None] * sh - ph
    ox = torch.arange(Wo, device=x.device)[None, :] * sw - pw
    flat = (oy + wy) * W + (ox + wx)
    return out.to(x.dtype), flat.to(torch.int32)


@register_op
def pool3d(x, kernel_size, stride=None, padding=0, pooling_type="max",
           ceil_mode=False, count_include_pad=True):
    """x [N,C,D,H,W] 3-D pooling."""
    k = [int(v) for v in (kernel_size if isinstance(kernel_size, (list,
                                                                  tuple))
                          else (kernel_size,) * 3)]
    s = stride or k
    s = [int(v) for v in (s if isinstance(s, (list, tuple)) else (s,) * 3)]
    p = [int(v) for v in (padding if isinstance(padding, (list, tuple))
                          else (padding,) * 3)]
    extra = [0, 0, 0]
    if ceil_mode:
        for i in range(3):
            span = x.shape[2 + i] + 2 * p[i] - k[i]
            floor_out = span // s[i] + 1
            ceil_out = -(-span // s[i]) + 1
            extra[i] = (ceil_out - 1) * s[i] - span if ceil_out > floor_out \
                else 0
    flat = []
    for i in (2, 1, 0):
        flat += [p[i], p[i] + extra[i]]
    xf = x.to(_F32)
    if pooling_type == "max":
        out = F.max_pool3d(F.pad(xf, flat, value=float("-inf")), k, s)
    else:
        total = F.avg_pool3d(F.pad(xf, flat), k, s, divisor_override=1)
        ones = torch.ones_like(xf)
        if count_include_pad:
            sym = []
            for i in (2, 1, 0):
                sym += [p[i], p[i]]
            ones = F.pad(ones, sym, value=1.0)
            tail = []
            for i in (2, 1, 0):
                tail += [0, extra[i]]
            ones = F.pad(ones, tail, value=0.0)
        else:
            ones = F.pad(ones, flat, value=0.0)
        cnt = F.avg_pool3d(ones, k, s, divisor_override=1)
        out = total / torch.clamp(cnt, min=1.0)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

_NEG = -1e30


def _lse(*xs):
    m = xs[0]
    for v in xs[1:]:
        m = torch.maximum(m, v)
    s = sum(torch.exp(v - m) for v in xs)
    return m + torch.log(torch.clamp(s, min=1e-38))


def _ctc_nll(lp, labels, input_len, label_len, blank):
    """Negative log likelihood per sample: lp [B, T, C] log-softmax,
    labels [B, L] padded; the log-space alpha recursion over the extended
    sequence blank,l1,blank,...,blank."""
    B, T, C = lp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = lp.device
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    skip = torch.zeros(B, S, dtype=torch.bool, device=dev)
    skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    neg = torch.full((), _NEG, dtype=_F32, device=dev)
    label_len = label_len.long().reshape(B)
    input_len = input_len.long().reshape(B)
    lp_ext = torch.gather(lp, 2, ext[:, None, :].expand(B, T, S))  # [B,T,S]
    alpha = torch.full((B, S), _NEG, dtype=_F32, device=dev)
    alpha[:, 0] = lp[:, 0, blank]
    alpha[:, 1] = torch.where(label_len > 0, lp_ext[:, 0, 1], alpha[:, 1])
    pad1 = neg.expand(B, 1)
    pad2 = neg.expand(B, 2)
    for t in range(1, T):
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        prev2 = torch.where(skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                            neg)
        a = _lse(alpha, prev1, prev2) + lp_ext[:, t]
        alpha = torch.where((t < input_len)[:, None], a, alpha)
    end = 2 * label_len
    last_blank = torch.gather(alpha, 1, end[:, None])[:, 0]
    last_label = torch.where(
        label_len > 0,
        torch.gather(alpha, 1, (end - 1).clamp(min=0)[:, None])[:, 0], neg)
    return -_lse(last_blank, last_label)


@register_op
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             norm_by_times=False):
    """CTC loss a sample. log_probs [T, B, C] (raw logits: a log_softmax
    is applied), labels [B, L] padded."""
    lp = torch.log_softmax(log_probs.to(_F32), dim=-1).transpose(0, 1)
    nll = _ctc_nll(lp, labels, input_lengths, label_lengths, blank)
    if norm_by_times:
        nll = nll / torch.clamp(input_lengths.to(_F32), min=1.0)
    return nll


@register_op
def warpctc(logits, label, logits_length, labels_length, blank=0,
            norm_by_times=False):
    """The reference op name of `ctc_loss`."""
    return ctc_loss._kernel(logits, label, logits_length, labels_length,
                            blank=blank, norm_by_times=norm_by_times)
