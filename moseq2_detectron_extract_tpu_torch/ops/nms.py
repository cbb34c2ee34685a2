'''Batched greedy NMS as a fixpoint of the suppression relation.

Port of ``moseq2_detectron_extract_tpu/ops/nms.py:20-67``: a box is kept iff
no higher-ranked kept box overlaps it above the threshold. Ranks order by
score, ties by index (the earlier index wins). The decided-state propagation
runs at most ``MAX_ITERS`` rounds, as the reference's bounded while loop.
'''
import torch

from moseq2_detectron_extract_tpu_torch.ops.boxes import pairwise_iou

MAX_ITERS = 32


def nms_keep_mask(boxes, scores, iou_threshold: float, valid=None):
    '''Keep mask over (B, K, 4) boxes with (B, K) scores -> bool (B, K).

    ``valid`` masks out padding boxes (treated as suppressed).
    '''
    k = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    iou = pairwise_iou(boxes, boxes)
    idx = torch.arange(k, device=boxes.device)
    s_i = scores[..., :, None]
    s_j = scores[..., None, :]
    rank_before = (s_j > s_i) | ((s_j == s_i) & (idx[None, :] < idx[:, None]))
    dominates = (iou > iou_threshold) & rank_before & valid[..., None, :]

    keep = torch.zeros_like(valid)
    supp = torch.zeros_like(valid)
    for _ in range(MAX_ITERS):
        if not bool(torch.any(valid & ~keep & ~supp)):
            break
        keep = keep | (valid & ~supp & ~torch.any(dominates & ~supp[..., None, :], dim=-1))
        supp = supp | torch.any(dominates & keep[..., None, :], dim=-1)
    return keep


def batched_nms_keep_mask(boxes, scores, idxs, iou_threshold: float, valid=None):
    '''Category-aware NMS over (B, K): boxes of different ``idxs`` never
    suppress each other (per-image coordinate offsets).'''
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    max_coord = finite.flatten(-2).amax(dim=-1) + 1.0             # (B,)
    offsets = idxs.to(boxes.dtype) * (max_coord[..., None] + 1.0)
    shifted = boxes + offsets[..., None]
    return nms_keep_mask(shifted, scores, iou_threshold, valid=valid)


def stable_topk(values, k: int):
    '''Top-``k`` along the last axis, ties in index order (``lax.top_k``).

    ``torch.topk`` does not promise an order for ties; a stable descending
    sort does.
    '''
    sorted_vals, order = torch.sort(values, dim=-1, descending=True, stable=True)
    return sorted_vals[..., :k], order[..., :k]
