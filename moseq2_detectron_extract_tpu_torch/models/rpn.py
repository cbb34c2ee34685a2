'''Region Proposal Network head and static top-k proposal selection.

Port of ``moseq2_detectron_extract_tpu/models/rpn.py:24-118``: per-level
pre-NMS top-k (clamped to the global cap), decode, clip, drop empties, the
global top-``cap`` candidate pool, level-aware fixpoint NMS and the final
top-``post_nms_topk``. Every top-k is the stable one, as ``lax.top_k`` is.
'''
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moseq2_detectron_extract_tpu_torch.models.layers import Conv2d
from moseq2_detectron_extract_tpu_torch.ops.boxes import (clip_boxes, decode_boxes,
                                                          nonempty_boxes)
from moseq2_detectron_extract_tpu_torch.ops.nms import (batched_nms_keep_mask,
                                                        stable_topk)


class RPNHead(nn.Module):
    '''Shared 3x3 conv (compute dtype) + 1x1 objectness / anchor-delta convs
    (f32). Returns per level logits (B, H*W*A) and deltas (B, H*W*A, 4) in
    the (y, x, anchor) order of the anchors.'''

    def __init__(self, num_anchors: int, conv_dim: int = 256, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(conv_dim, conv_dim, 3, padding=1, compute_dtype=dtype)
        self.objectness = Conv2d(conv_dim, num_anchors, 1)
        self.deltas = Conv2d(conv_dim, num_anchors * 4, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for feat in features:
            t = F.relu(self.conv(feat))
            b = t.shape[0]
            logits.append(self.objectness(t).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.deltas(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return logits, deltas


def select_proposals(anchors_per_level: Sequence[torch.Tensor],
                     logits_per_level: Sequence[torch.Tensor],
                     deltas_per_level: Sequence[torch.Tensor],
                     image_sizes: torch.Tensor,
                     pre_nms_topk: int, post_nms_topk: int,
                     nms_thresh: float, box_reg_weights,
                     global_cap: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    '''Batched proposal selection -> boxes (B, P, 4), scores (B, P), valid (B, P).

    ``image_sizes`` (B, 2 [h, w]) f32; P = ``post_nms_topk``. With a global
    cap the per-level k is clamped to it, as the reference does by default
    (``CLAMP_LEVEL_K``).
    '''
    level_k = pre_nms_topk if global_cap is None else min(pre_nms_topk, global_cap)
    b = image_sizes.shape[0]
    cand_boxes, cand_scores, cand_levels, cand_valid = [], [], [], []
    for level, (anchors, logits, deltas) in enumerate(
            zip(anchors_per_level, logits_per_level, deltas_per_level)):
        flat_logits = logits.float()
        flat_deltas = deltas.float()
        k = min(level_k, flat_logits.shape[1])
        top_scores, top_idx = stable_topk(flat_logits, k)          # (B, k)
        top_anchors = anchors[top_idx]                             # (B, k, 4)
        top_deltas = torch.gather(flat_deltas, 1,
                                  top_idx[..., None].expand(-1, -1, 4))
        boxes = decode_boxes(top_deltas, top_anchors, box_reg_weights)
        boxes = clip_boxes(boxes, image_sizes)
        cand_boxes.append(boxes)
        cand_scores.append(top_scores)
        cand_levels.append(torch.full((b, k), level, dtype=torch.int32,
                                      device=boxes.device))
        cand_valid.append(nonempty_boxes(boxes))

    boxes = torch.cat(cand_boxes, dim=1)
    scores = torch.cat(cand_scores, dim=1)
    levels = torch.cat(cand_levels, dim=1)
    valid = torch.cat(cand_valid, dim=1)

    if global_cap is not None and global_cap < scores.shape[1]:
        neg_inf = torch.full_like(scores, -torch.inf)
        cap_scores, cap_idx = stable_topk(torch.where(valid, scores, neg_inf),
                                          global_cap)
        boxes = torch.gather(boxes, 1, cap_idx[..., None].expand(-1, -1, 4))
        scores = torch.gather(scores, 1, cap_idx)
        levels = torch.gather(levels, 1, cap_idx)
        valid = torch.isfinite(cap_scores)

    keep = batched_nms_keep_mask(boxes, scores, levels, nms_thresh, valid=valid)
    masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    top_scores, top_idx = stable_topk(masked, post_nms_topk)
    top_valid = torch.isfinite(top_scores)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    return (torch.where(top_valid[..., None], top_boxes, torch.zeros_like(top_boxes)),
            torch.where(top_valid, top_scores, torch.zeros_like(top_scores)),
            top_valid)
