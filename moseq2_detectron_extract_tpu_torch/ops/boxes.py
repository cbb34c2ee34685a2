'''Box arithmetic: decode deltas, IoU, clipping (xyxy boxes).

Port of ``moseq2_detectron_extract_tpu/ops/boxes.py`` (R-CNN
Box2BoxTransform semantics).
'''
import math

import torch

_SCALE_CLAMP = math.log(1000.0 / 16)


def box_area(boxes):
    '''Area of (..., 4) xyxy boxes.'''
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)


def pairwise_iou(boxes1, boxes2):
    '''IoU between (..., N, 4) and (..., M, 4) boxes -> (..., N, M).'''
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9),
                       torch.zeros_like(inter))


def decode_boxes(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    '''Apply (..., 4) deltas (dx, dy, dw, dh) to (..., 4) boxes.'''
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * widths
    cy = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=_SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=_SCALE_CLAMP)

    pred_cx = dx * widths + cx
    pred_cy = dy * heights + cy
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                        pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)


def clip_boxes(boxes, image_sizes):
    '''Clip (B, N, 4) boxes to [0, W] x [0, H]; ``image_sizes`` (B, 2 [h, w]).'''
    h = image_sizes[:, 0, None]
    w = image_sizes[:, 1, None]
    zero = torch.zeros_like(h)
    x1 = torch.clamp(boxes[..., 0], zero, w)
    y1 = torch.clamp(boxes[..., 1], zero, h)
    x2 = torch.clamp(boxes[..., 2], zero, w)
    y2 = torch.clamp(boxes[..., 3], zero, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty_boxes(boxes, threshold: float = 0.0):
    '''Mask of boxes with both sides > ``threshold``.'''
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & \
        ((boxes[..., 3] - boxes[..., 1]) > threshold)
