"""yolo_loss and hsigmoid_loss — port of
`paddle_tpu/ops/kernels/yolo_loss.py`.

yolo_loss, the YOLOv3 training objective, is dense masked math over the
batch: the ignore mask is a best-IoU reduction over the padded ground-
truth slots, each slot's anchor assignment gathers its cell's logits,
and the positive cells override the ignore mask by a scatter-max.
Invalid slots (w or h <= 1e-6) are masked as the reference masks them.

hsigmoid_loss: the hierarchical sigmoid over the default complete
binary tree (code = label + num_classes; a bit's weight row is the code
prefix - 1, its target the code's bit), one gather of weight rows and a
batched dot.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dispatch import register_op

_F32 = torch.float32


def _bce(x, label):
    """Sigmoid cross-entropy on logits."""
    return torch.clamp(x, min=0.0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))


def _xywh_iou(b1, b2):
    """IoU of center-format boxes [..., 4]."""
    lo = torch.maximum(b1[..., :2] - b1[..., 2:] / 2,
                       b2[..., :2] - b2[..., 2:] / 2)
    hi = torch.minimum(b1[..., :2] + b1[..., 2:] / 2,
                       b2[..., :2] + b2[..., 2:] / 2)
    wh = hi - lo
    inter = torch.where((wh > 0).all(-1), wh[..., 0] * wh[..., 1],
                        torch.zeros((), dtype=wh.dtype, device=wh.device))
    union = b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3] - inter
    return inter / torch.clamp(union, min=1e-10)


@register_op
def yolo_loss(x, gt_box, gt_label, gt_score=None, anchors=(),
              anchor_mask=(), class_num=1, ignore_thresh=0.7,
              downsample_ratio=32, use_label_smooth=True, scale_x_y=1.0):
    """-> (loss [N], objectness_mask [N, mask, H, W], gt_match_mask
    [N, B] int32)."""
    anchors = tuple(anchors)
    anchor_mask = tuple(anchor_mask)
    an_num = len(anchors) // 2
    mask_num = len(anchor_mask)
    N, _, H, W = x.shape
    B = gt_box.shape[1]
    dev = x.device
    input_size = downsample_ratio * H
    scale, bias = scale_x_y, -0.5 * (scale_x_y - 1.0)
    if use_label_smooth:
        sw = min(1.0 / class_num, 1.0 / 40)
        pos_l, neg_l = 1.0 - sw, sw
    else:
        pos_l, neg_l = 1.0, 0.0
    gtb = gt_box.to(_F32)
    gtl = gt_label.long()
    gts = (torch.ones(N, B, dtype=_F32, device=dev) if gt_score is None
           else gt_score.to(_F32))
    aw = torch.tensor(anchors[0::2], dtype=_F32, device=dev)
    ah = torch.tensor(anchors[1::2], dtype=_F32, device=dev)
    mask_arr = torch.tensor(anchor_mask, dtype=torch.long, device=dev)
    zero = torch.zeros((), dtype=_F32, device=dev)

    xr = x.to(_F32).reshape(N, mask_num, 5 + class_num, H, W)
    valid = (gtb[..., 2] > 1e-6) & (gtb[..., 3] > 1e-6)          # [N, B]

    # ignore mask: the best prediction-gt IoU of each cell
    gx = torch.arange(W, dtype=_F32, device=dev)
    gy = torch.arange(H, dtype=_F32, device=dev)[:, None]
    px = (gx + torch.sigmoid(xr[:, :, 0]) * scale + bias) / W
    py = (gy + torch.sigmoid(xr[:, :, 1]) * scale + bias) / H
    pw = torch.exp(xr[:, :, 2]) * aw[mask_arr][:, None, None] / input_size
    ph = torch.exp(xr[:, :, 3]) * ah[mask_arr][:, None, None] / input_size
    pred = torch.stack([px, py, pw, ph], dim=-1)           # [N,mask,H,W,4]
    ious = _xywh_iou(pred[..., None, :], gtb[:, None, None, None])
    ious = torch.where(valid[:, None, None, None], ious, zero)
    best_iou = ious.amax(-1)                                  # [N,mask,H,W]
    obj_mask = torch.where(best_iou > ignore_thresh,
                           torch.full((), -1.0, device=dev), zero)

    # each gt's anchor
    an_boxes = torch.stack([torch.zeros(an_num, device=dev),
                            torch.zeros(an_num, device=dev),
                            aw / input_size, ah / input_size], -1)
    gt_shift = torch.cat([torch.zeros_like(gtb[..., :2]), gtb[..., 2:]], -1)
    an_iou = _xywh_iou(gt_shift[..., None, :], an_boxes)       # [N, B, an]
    best_n = torch.argmax(an_iou, dim=-1)                       # [N, B]
    hit = mask_arr == best_n[..., None]                         # [N,B,mask]
    mask_idx = torch.argmax(hit.to(torch.int32), dim=-1)
    in_mask = hit.any(-1)
    neg1 = torch.full((), -1, dtype=torch.long, device=dev)
    match = torch.where(valid, torch.where(in_mask, mask_idx, neg1), neg1)

    gi = torch.clamp((gtb[..., 0] * W).to(torch.int32), 0, W - 1).long()
    gj = torch.clamp((gtb[..., 1] * H).to(torch.int32), 0, H - 1).long()
    active = valid & in_mask
    wgt = torch.where(active, gts, zero)

    n_idx = torch.arange(N, device=dev)[:, None]
    cell = xr[n_idx, mask_idx, :, gj, gi]                       # [N,B,5+cls]
    tx = gtb[..., 0] * W - gi
    ty = gtb[..., 1] * H - gj
    tw = torch.log(torch.clamp(gtb[..., 2] * input_size, min=1e-9)
                   / aw[best_n])
    th = torch.log(torch.clamp(gtb[..., 3] * input_size, min=1e-9)
                   / ah[best_n])
    loc_scale = (2.0 - gtb[..., 2] * gtb[..., 3]) * wgt
    loc = (_bce(cell[..., 0], tx) + _bce(cell[..., 1], ty)
           + torch.abs(tw - cell[..., 2]) + torch.abs(th - cell[..., 3]))
    loss = (loc * loc_scale).sum(-1)

    onehot = F.one_hot(gtl, class_num)
    targets = torch.where(onehot > 0, torch.full((), pos_l, device=dev),
                          torch.full((), neg_l, device=dev))
    cls = _bce(cell[..., 5:], targets).sum(-1)
    loss = loss + (cls * wgt).sum(-1)

    # positive cells take the gt score over the ignore mask; inactive
    # slots write nothing (a max-scatter of False / 0)
    flat = ((n_idx * mask_num + mask_idx) * H + gj) * W + gi    # [N, B]
    size = N * mask_num * H * W
    written = torch.zeros(size, dtype=_F32, device=dev).scatter_reduce(
        0, flat.reshape(-1), active.to(_F32).reshape(-1), "amax")
    score_map = torch.zeros(size, dtype=_F32, device=dev).scatter_reduce(
        0, flat.reshape(-1), wgt.reshape(-1), "amax")
    shape = obj_mask.shape
    obj_mask = torch.where(written.reshape(shape) > 0,
                           score_map.reshape(shape), obj_mask)

    obj_logit = xr[:, :, 4]
    pos_term = _bce(obj_logit, 1.0) * obj_mask
    neg_term = _bce(obj_logit, 0.0)
    obj = torch.where(obj_mask > 1e-5, pos_term,
                      torch.where(obj_mask > -0.5, neg_term, zero))
    loss = loss + obj.sum(dim=(1, 2, 3))
    return loss, obj_mask, match.to(torch.int32)


@register_op
def hsigmoid_loss(x, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False):
    """-> (loss [N, 1], pre_out [N, L]) over the default complete binary
    tree; a custom tree (path_table / path_code) raises, as in the
    reference."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "hsigmoid_loss custom tree (path_table/path_code) is not "
            "implemented; the default SimpleCode tree is")
    dev = x.device
    L = max(int(math.ceil(math.log2(max(num_classes, 2)))) + 1, 1)
    code = label.long().reshape(-1) + num_classes              # [N]
    bit_pos = torch.arange(L, device=dev)
    # floor(log2(code)) in integers: #{k >= 1 : 2^k <= code}
    powers = torch.ones((), dtype=torch.long, device=dev) << torch.arange(
        1, L + 2, device=dev)
    length = (code[:, None] >= powers).sum(-1)
    active = bit_pos < length[:, None]                          # [N, L]
    w_index = torch.clamp((code[:, None] >> (bit_pos + 1)) - 1, 0,
                          num_classes - 2)
    target = ((code[:, None] >> bit_pos) & 1).to(x.dtype)
    pre = torch.einsum("nld,nd->nl", weight[w_index], x)
    if bias is not None:
        pre = pre + bias.reshape(-1)[w_index]
    pre = torch.clamp(pre, -40.0, 40.0)
    zero = torch.zeros((), dtype=pre.dtype, device=dev)
    loss = torch.where(active, _bce(pre, target), zero).sum(-1,
                                                            keepdim=True)
    return loss, torch.where(active, pre, zero)
