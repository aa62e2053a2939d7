"""paddle.vision.ops of the port: the detection op surface — port of
`paddle_tpu/vision/ops.py`.

yolo_box, prior_box, box_coder, nms (and its categorical form),
matrix_nms, multiclass_nms3, roi_align, roi_pool, psroi_pool,
deform_conv2d and `DeformConv2D`, distribute_fpn_proposals,
generate_proposals, yolo_loss, read_file, decode_jpeg and the RoI layer
forms, each over the ops of `ops/kernels/vision_ops.py` and
`yolo_loss.py`.
"""
from __future__ import annotations

import io as _io

import numpy as np
import torch

from .. import _C_ops
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer
from ..nn.param_attr import ParamAttr

__all__ = [
    "yolo_box", "prior_box", "box_coder", "nms", "matrix_nms",
    "multiclass_nms3", "roi_align", "roi_pool", "psroi_pool",
    "deform_conv2d", "DeformConv2D", "distribute_fpn_proposals",
    "generate_proposals",
]


def _data(t):
    return t._data if isinstance(t, Tensor) else torch.as_tensor(t)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    return _C_ops.yolo_box(x, img_size, anchors=tuple(anchors),
                           class_num=class_num, conf_thresh=conf_thresh,
                           downsample_ratio=downsample_ratio,
                           clip_bbox=clip_bbox, scale_x_y=scale_x_y,
                           iou_aware=iou_aware,
                           iou_aware_factor=iou_aware_factor)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    return _C_ops.prior_box(
        input, image, min_sizes=tuple(min_sizes),
        max_sizes=tuple(max_sizes or ()), aspect_ratios=tuple(aspect_ratios),
        variances=tuple(variance), flip=flip, clip=clip, steps=tuple(steps),
        offset=offset,
        min_max_aspect_ratios_order=min_max_aspect_ratios_order)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    return _C_ops.box_coder(prior_box, prior_box_var, target_box,
                            code_type=code_type,
                            box_normalized=box_normalized, axis=axis)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Hard NMS; with category_idxs, within each category, the kept boxes
    merged by score."""
    if category_idxs is None:
        return _C_ops.nms(boxes, scores, iou_threshold=iou_threshold,
                          top_k=top_k or -1)
    cat = _data(category_idxs).cpu().numpy()
    kept = []
    for c in categories:
        (sel,) = np.nonzero(cat == c)
        if sel.size == 0:
            continue
        k = _C_ops.nms(boxes[sel.tolist()],
                       None if scores is None else scores[sel.tolist()],
                       iou_threshold=iou_threshold)
        kept.extend(sel[_data(k).cpu().numpy()].tolist())
    if scores is not None:
        sc = _data(scores).cpu().numpy()
        kept.sort(key=lambda i: -sc[i])
    if top_k:
        kept = kept[:top_k]
    return Tensor._wrap(torch.as_tensor(np.asarray(kept, np.int64),
                                        device=_data(boxes).device))


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Out [total, 6] over the batch, RoisNum [B] (return_rois_num) and
    Index [total, 1] (return_index): the op's [B, keep, 6] grid without
    the rows whose score decayed to 0."""
    out, idx = _C_ops.matrix_nms(
        bboxes, scores, score_threshold=score_threshold,
        post_threshold=post_threshold, nms_top_k=nms_top_k,
        keep_top_k=keep_top_k, use_gaussian=use_gaussian,
        gaussian_sigma=gaussian_sigma, background_label=background_label,
        normalized=normalized)
    o, ix = _data(out), _data(idx)
    valid = o[:, :, 1] > 0.0
    result = [Tensor._wrap(o[valid])]
    if return_rois_num:
        result.append(Tensor._wrap(valid.sum(1).to(torch.int32)))
    if return_index:
        result.append(Tensor._wrap(ix[valid][:, None].long()))
    return result[0] if len(result) == 1 else tuple(result)


def multiclass_nms3(bboxes, scores, rois_num=None, score_threshold=0.05,
                    nms_top_k=1000, keep_top_k=100, nms_threshold=0.3,
                    normalized=True, nms_eta=1.0, background_label=-1,
                    return_index=True, name=None):
    return _C_ops.multiclass_nms3(
        bboxes, scores, rois_num, score_threshold=score_threshold,
        nms_top_k=nms_top_k, keep_top_k=keep_top_k,
        nms_threshold=nms_threshold, normalized=normalized,
        nms_eta=nms_eta, background_label=background_label)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def roi_align(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    ph, pw = _pair(output_size)
    return _C_ops.roi_align(x, boxes, boxes_num, pooled_height=ph,
                            pooled_width=pw, spatial_scale=spatial_scale,
                            sampling_ratio=sampling_ratio, aligned=aligned)


def roi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
             name=None):
    ph, pw = _pair(output_size)
    return _C_ops.roi_pool(x, boxes, boxes_num, pooled_height=ph,
                           pooled_width=pw, spatial_scale=spatial_scale)


def psroi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
               name=None):
    ph, pw = _pair(output_size)
    return _C_ops.psroi_pool(x, boxes, boxes_num,
                             output_channels=x.shape[1] // (ph * pw),
                             spatial_scale=spatial_scale,
                             pooled_height=ph, pooled_width=pw)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    out = _C_ops.deformable_conv(x, offset, weight, mask, stride=stride,
                                 padding=padding, dilation=dilation,
                                 deformable_groups=deformable_groups,
                                 groups=groups)
    if bias is not None:
        out = out + bias.reshape([1, -1, 1, 1])
    return out


class DeformConv2D(Layer):
    """Deformable convolution v1 (no mask) / v2 (with a mask)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        kernel_size = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *kernel_size],
            ParamAttr._to_attr(weight_attr))
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_channels], ParamAttr._to_attr(bias_attr), is_bias=True))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             stride=self._stride, padding=self._padding,
                             dilation=self._dilation,
                             deformable_groups=self._deformable_groups,
                             groups=self._groups, mask=mask)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    return _C_ops.distribute_fpn_proposals(
        fpn_rois, min_level, max_level, refer_level, refer_scale,
        rois_num, pixel_offset=pixel_offset)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=True, name=None):
    return _C_ops.generate_proposals(
        scores, bbox_deltas, img_size, anchors, variances,
        pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
        nms_thresh=nms_thresh, min_size=min_size, eta=eta,
        pixel_offset=pixel_offset)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    return _C_ops.yolo_loss(x, gt_box, gt_label, gt_score=gt_score,
                            anchors=anchors, anchor_mask=anchor_mask,
                            class_num=class_num,
                            ignore_thresh=ignore_thresh,
                            downsample_ratio=downsample_ratio,
                            use_label_smooth=use_label_smooth,
                            scale_x_y=scale_x_y)


def read_file(filename, name=None):
    """A file's bytes as a uint8 tensor."""
    from .. import to_tensor

    with open(filename, "rb") as f:
        return to_tensor(np.frombuffer(f.read(), dtype=np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """JPEG bytes -> a CHW uint8 image, decoded on the host by PIL."""
    from PIL import Image

    from .. import to_tensor

    raw = bytes(bytearray(np.asarray(x.numpy(), dtype=np.uint8)))
    img = Image.open(_io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode in ("rgb", "RGB"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None, :, :] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return to_tensor(np.ascontiguousarray(arr))


class RoIAlign:
    """The layer form of roi_align."""

    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num=None, aligned=True):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale, aligned=aligned)


class RoIPool:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num=None):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num=None):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)
