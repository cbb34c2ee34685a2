'''Batched greedy NMS as a fixpoint of the suppression relation, and the
top-k of the kept boxes.

Port of ``moseq2_detectron_extract_tpu/ops/nms.py:20-81``: a box is kept iff
no higher-ranked kept box overlaps it above the threshold. Ranks order by
score, ties by index (the earlier index wins). The decided-state propagation
runs at most ``MAX_ITERS`` rounds, as the reference's bounded while loop.

Eagerly, each round first asks the host whether a box is still undecided
and stops when none is. While ``torch.export`` traces (``models/deploy.py``)
that test is a data-dependent branch the tracer cannot take, so the loop
runs exactly ``MAX_ITERS`` rounds with no test: once nothing is undecided a
round changes nothing, so the answer is the early-exit loop's, also where
the loop is cut at the cap.
'''
import threading

import torch

from moseq2_detectron_extract_tpu_torch.ops.boxes import pairwise_iou
from moseq2_detectron_extract_tpu_torch.utils.profiling import count

MAX_ITERS = 32

# host syncs of the fixpoint loop (one per round's convergence test) since
# the count was last set to 0; each is also the recorder's counter
# ``nms.sync``, credited to the open span (the proposal or the box NMS)
sync_count = 0
_count_lock = threading.Lock()


def _add_sync() -> None:
    '''Add one to ``sync_count`` under a lock: sessions on threads of one process
    count into it at once, and ``+=`` on a module global is not atomic.'''
    global sync_count
    with _count_lock:
        sync_count += 1
    count('nms.sync')


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

    exporting = torch.compiler.is_exporting()
    keep = torch.zeros_like(valid)
    supp = torch.zeros_like(valid)
    for _ in range(MAX_ITERS):
        if not exporting:
            _add_sync()
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


def topk_after_nms(boxes, scores, keep, k: int):
    '''The top-``k`` kept boxes of (K, 4) ``boxes`` by score, ties to the
    lower index, zero-padded where fewer than ``k`` are kept: (boxes (k, 4),
    scores (k,), valid (k,), idx (k,)).'''
    masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    top_scores, top_idx = stable_topk(masked, k)
    top_valid = torch.isfinite(top_scores)
    return (torch.where(top_valid[:, None], boxes[top_idx], torch.zeros_like(boxes[top_idx])),
            torch.where(top_valid, top_scores, torch.zeros_like(top_scores)),
            top_valid, top_idx)
