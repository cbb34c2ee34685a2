'''IoU matching and balanced fg/bg sampling with static shapes, batched.

Port of ``moseq2_detectron_extract_tpu/models/matcher.py``. Every function
takes leading batch axes. ``subsample_labels`` takes its random priorities
as arguments (two uniform vectors per image) instead of a PRNG key: the
training step draws them (``rcnn.draw_loss_uniforms``), the tests hand in
the JAX package's own draws.
'''
from typing import Tuple

import torch

from moseq2_detectron_extract_tpu_torch.ops.boxes import pairwise_iou
from moseq2_detectron_extract_tpu_torch.ops.nms import stable_topk


def match_anchors_to_gt(anchors, gt_boxes, gt_valid, high_thresh: float,
                        low_thresh: float, allow_low_quality: bool):
    '''Match (A, 4) anchors (or (..., A, 4)) against padded (..., G, 4) gt.

    Returns (matched_idx (..., A), labels (..., A)) with labels 1 = fg,
    0 = bg, -1 = ignore. Invalid gt rows never match. With
    ``allow_low_quality`` the anchors that equal a gt's best IoU exactly are
    forced positive (Detectron2's Matcher), so the IoU runs the JAX op order.
    '''
    iou = pairwise_iou(anchors, gt_boxes)                           # (..., A, G)
    iou = torch.where(gt_valid[..., None, :], iou, torch.full_like(iou, -1.0))

    matched_iou, matched_idx = torch.max(iou, dim=-1)
    labels = torch.full(matched_iou.shape, -1, dtype=torch.int32, device=iou.device)
    labels = torch.where(matched_iou < low_thresh, torch.zeros_like(labels), labels)
    labels = torch.where(matched_iou >= high_thresh, torch.ones_like(labels), labels)

    if allow_low_quality:
        per_gt_best = torch.amax(iou, dim=-2, keepdim=True)          # (..., 1, G)
        is_best = (iou == per_gt_best) & gt_valid[..., None, :] & (per_gt_best > 0)
        labels = torch.where(torch.any(is_best, dim=-1), torch.ones_like(labels), labels)

    any_gt = torch.any(gt_valid, dim=-1, keepdim=True)
    labels = torch.where(any_gt, labels, torch.zeros_like(labels))
    return matched_idx, labels


def subsample_labels(labels, num_samples: int, positive_fraction: float,
                     u_pos, u_neg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    '''A balanced fg/bg subset of exactly ``num_samples`` slots per image.

    ``labels`` (..., A); ``u_pos`` and ``u_neg`` (..., A) uniform priorities.
    Returns (idx, valid, is_pos), each (..., num_samples): positives capped
    at ``num_samples * positive_fraction``, negatives fill the rest; padding
    slots have valid False and idx 0.
    '''
    pos_cap = int(num_samples * positive_fraction)
    neg_inf = torch.full(u_pos.shape, -torch.inf, dtype=u_pos.dtype, device=u_pos.device)

    pos_scores, pos_idx = stable_topk(torch.where(labels == 1, u_pos, neg_inf), pos_cap)
    pos_valid = torch.isfinite(pos_scores)
    n_pos = torch.sum(pos_valid, dim=-1, keepdim=True)

    neg_scores, neg_idx = stable_topk(torch.where(labels == 0, u_neg, neg_inf),
                                      num_samples)
    slot = torch.arange(num_samples, device=labels.device)
    neg_valid = torch.isfinite(neg_scores) & (slot < (num_samples - n_pos))

    all_idx = torch.cat([pos_idx, neg_idx], dim=-1)
    all_valid = torch.cat([pos_valid, neg_valid], dim=-1)
    all_is_pos = torch.zeros(all_valid.shape, dtype=torch.bool, device=labels.device)
    all_is_pos[..., :pos_cap] = True

    # valid entries first, each group in its candidate order
    order_prio = all_valid.to(torch.float32) * 2.0 - \
        torch.arange(all_idx.shape[-1], dtype=torch.float32, device=labels.device) * 1e-6
    _, order = stable_topk(order_prio, num_samples)
    s_valid = torch.gather(all_valid, -1, order)
    s_idx = torch.gather(all_idx, -1, order)
    return (torch.where(s_valid, s_idx, torch.zeros_like(s_idx)), s_valid,
            torch.gather(all_is_pos, -1, order) & s_valid)
