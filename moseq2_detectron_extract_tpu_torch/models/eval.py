'''COCO-style AP evaluation (bbox / segm / keypoints with custom OKS sigmas).

Port of ``moseq2_detectron_extract_tpu/models/eval.py``: COCOeval's
semantics for one class, written out in numpy (the JAX package's copy has
no JAX in it; the port keeps its own):

* greedy score-ordered matching at IoU/OKS thresholds 0.50:0.95:0.05,
  each detection taking the highest-similarity unmatched GT;
* per-image ``maxDets`` truncation before matching (100 for bbox/segm,
  20 for keypoints, as in pycocotools Params);
* area-range ignore semantics: GT outside the range are ignored (not counted
  in recall), detections matched to ignored GT are ignored, and *unmatched*
  detections whose own area falls outside the range are ignored too;
* 101-point AP with COCOeval's step lookup (precision at the smallest
  recall >= r via searchsorted), NOT linear interpolation;
* stable sorts everywhere scores can tie (pycocotools uses mergesort).

:func:`evaluate_model` runs the port's :class:`Predictor` (on the card
unless it is given ``device='cpu'``) over annotated items and moves its
outputs to numpy. ``tests/test_torch_eval.py`` holds both functions to the
JAX package's.
'''
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from moseq2_detectron_extract_tpu_torch.io.annot import DataItem, poly_to_mask

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
# pycocotools Params: areaRng 'all'/'small'/'medium'/'large'
AREA_RANGES = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}


def _box_iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    if len(pred) == 0 or len(gt) == 0:
        return np.zeros((len(pred), len(gt)))
    lt = np.maximum(pred[:, None, :2], gt[None, :, :2])
    rb = np.minimum(pred[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_p = np.prod(np.clip(pred[:, 2:] - pred[:, :2], 0, None), axis=1)
    area_g = np.prod(np.clip(gt[:, 2:] - gt[:, :2], 0, None), axis=1)
    union = area_p[:, None] + area_g[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def _mask_iou_matrix(pred: Sequence[np.ndarray], gt: Sequence[np.ndarray]) -> np.ndarray:
    out = np.zeros((len(pred), len(gt)))
    for i, pm in enumerate(pred):
        for j, gm in enumerate(gt):
            inter = np.logical_and(pm, gm).sum()
            union = np.logical_or(pm, gm).sum()
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def _oks_matrix(pred_kpts: np.ndarray, gt_kpts: np.ndarray, gt_areas: np.ndarray,
                sigmas: np.ndarray,
                gt_boxes: Optional[np.ndarray] = None) -> np.ndarray:
    '''Object keypoint similarity (COCO formula) with per-keypoint sigmas.

    For GT with zero visible keypoints pycocotools computeOks falls back to
    a box-distance measure (distance outside a 3x-expanded gt box); those GT
    are ignored by the matcher, and the fallback lets detections match (and
    thus be ignored with) them instead of scoring as false positives.
    ``gt_boxes`` is (G, 4) xyxy for that fallback.
    '''
    n_pred, n_gt = len(pred_kpts), len(gt_kpts)
    out = np.zeros((n_pred, n_gt))
    vars_ = (2 * sigmas) ** 2
    for j in range(n_gt):
        vis = gt_kpts[j, :, 2] > 0
        scale = (gt_areas[j] + np.spacing(1)) * 2
        if vis.any():
            for i in range(n_pred):
                dx = pred_kpts[i, :, 0] - gt_kpts[j, :, 0]
                dy = pred_kpts[i, :, 1] - gt_kpts[j, :, 1]
                e = (dx ** 2 + dy ** 2) / (vars_ * scale)
                out[i, j] = np.mean(np.exp(-e[vis]))
        elif gt_boxes is not None:
            bx0, by0, bx1, by1 = gt_boxes[j]
            bw, bh = bx1 - bx0, by1 - by0
            x0, x1 = bx0 - bw, bx0 + 2 * bw
            y0, y1 = by0 - bh, by0 + 2 * bh
            for i in range(n_pred):
                xd = pred_kpts[i, :, 0]
                yd = pred_kpts[i, :, 1]
                dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
                e = (dx ** 2 + dy ** 2) / (vars_ * scale)
                out[i, j] = np.mean(np.exp(-e))
    return out


def _average_precision(matched: np.ndarray, ignored: np.ndarray,
                       scores: np.ndarray, n_gt: int) -> float:
    '''101-point AP with COCOeval accumulate() semantics.

    ``matched``/``ignored`` are per-detection flags; ignored detections are
    excluded from both TP and FP. Precision at each of the 101 recall points
    is the precision at the smallest achieved recall >= that point (step
    lookup via searchsorted, pycocotools cocoeval.py accumulate), with the
    monotone non-increasing envelope applied first.
    '''
    if n_gt == 0:
        return float('nan')
    order = np.argsort(-scores, kind='stable')
    keep = ~ignored[order]
    tp = matched[order][keep].astype(float)
    if tp.size == 0:
        return 0.0
    fp = 1.0 - tp
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(fp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, np.spacing(1))
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    idx = np.searchsorted(recall, RECALL_POINTS, side='left')
    q = np.zeros(len(RECALL_POINTS))
    valid = idx < len(precision)
    q[valid] = precision[idx[valid]]
    return float(np.mean(q))


def _match_image(sim: np.ndarray, scores: np.ndarray, gt_ignore: np.ndarray,
                 det_in_range: np.ndarray, thresh: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    '''COCOeval evaluateImg greedy matching for one image at one threshold.

    Detections (already maxDets-truncated, score-sorted on entry order) each
    take the highest-similarity available GT; non-ignored GT are preferred
    over ignored GT (pycocotools iterates GT sorted by ignore flag and keeps
    upgrading while the candidate is non-ignored). Returns (matched,
    det_ignored) flags aligned with the input detection order.
    '''
    n_det, n_gt = sim.shape
    matched = np.zeros(n_det, bool)
    det_ig = np.zeros(n_det, bool)
    gt_used = np.zeros(n_gt, bool)
    # pycocotools iterates GT non-ignored first (argsort on the ignore flag)
    gt_order = np.argsort(gt_ignore.astype(int), kind='stable')
    det_order = np.argsort(-scores, kind='stable')
    for i in det_order:
        best_j = -1
        best_sim = min(thresh, 1 - 1e-10)
        for j in gt_order:
            if gt_used[j]:
                continue
            # already matched to a non-ignored GT and now entering the
            # ignored section: stop (cocoeval.py evaluateImg break rule)
            if best_j > -1 and not gt_ignore[best_j] and gt_ignore[j]:
                break
            if sim[i, j] < best_sim:
                continue
            best_sim = sim[i, j]
            best_j = j
        if best_j >= 0:
            gt_used[best_j] = True
            if gt_ignore[best_j]:
                det_ig[i] = True       # matched an ignored GT -> ignore det
            else:
                matched[i] = True
    # unmatched detections whose own area is outside the range are ignored
    det_ig |= (~matched) & (~det_in_range)
    return matched, det_ig


def _evaluate_task(sim_matrices: List[np.ndarray],
                   scores_per_image: List[np.ndarray],
                   gt_areas_per_image: List[np.ndarray],
                   det_areas_per_image: List[np.ndarray],
                   max_dets: int,
                   area_labels: Sequence[str],
                   gt_ignore_per_image: Optional[List[np.ndarray]] = None
                   ) -> Dict[str, float]:
    '''AP over IoU thresholds x area ranges given per-image similarity
    matrices (P_i, G_i), with COCOeval maxDets + ignore semantics.
    ``gt_ignore_per_image`` adds task-level base ignore flags (e.g. the
    keypoint task's zero-visible-keypoint GT) on top of the area ranges.'''
    results: Dict[str, float] = {}
    if gt_ignore_per_image is None:
        gt_ignore_per_image = [np.zeros(len(a), bool)
                               for a in gt_areas_per_image]

    # maxDets truncation: keep the top-scoring max_dets detections per image
    trunc = []
    for sim, scores, dareas in zip(sim_matrices, scores_per_image,
                                   det_areas_per_image):
        if len(scores) > max_dets:
            keep = np.argsort(-scores, kind='stable')[:max_dets]
            keep.sort()
            sim, scores, dareas = sim[keep], scores[keep], dareas[keep]
        trunc.append((sim, scores, dareas))

    for label in area_labels:
        lo, hi = AREA_RANGES[label]
        aps = []
        for thresh in IOU_THRESHOLDS:
            flags, igs, all_scores = [], [], []
            n_gt = 0
            for (sim, scores, dareas), gareas, g_base in zip(
                    trunc, gt_areas_per_image, gt_ignore_per_image):
                gt_ignore = (gareas < lo) | (gareas > hi) | g_base
                n_gt += int((~gt_ignore).sum())
                det_in = (dareas >= lo) & (dareas <= hi)
                m, ig = _match_image(sim, scores, gt_ignore, det_in, thresh)
                flags.append(m)
                igs.append(ig)
                all_scores.append(scores)
            ap = _average_precision(
                np.concatenate(flags) if flags else np.zeros(0, bool),
                np.concatenate(igs) if igs else np.zeros(0, bool),
                np.concatenate(all_scores) if all_scores else np.zeros(0),
                n_gt)
            aps.append(ap)
            if label == 'all':
                if abs(thresh - 0.5) < 1e-9:
                    results['AP50'] = ap * 100
                if abs(thresh - 0.75) < 1e-9:
                    results['AP75'] = ap * 100
        finite = [a for a in aps if not np.isnan(a)]
        # pycocotools summarize(): -1 when no GT falls in the area range
        mean_ap = float(np.mean(finite)) * 100 if finite else -1.0
        if label == 'all':
            results['AP'] = mean_ap
            if np.isnan(results.get('AP50', 0.0)):
                results['AP50'] = results['AP75'] = -1.0
        else:
            results['AP' + label[0]] = mean_ap  # APs / APm / APl
    return results


def _gt_from_item(item: DataItem):
    boxes, masks, kpts = [], [], []
    h, w = item['height'], item['width']
    for annot in item['annotations']:
        boxes.append(np.asarray(annot['bbox'], float))
        seg = annot['segmentation']
        if isinstance(seg, np.ndarray):
            masks.append(seg.astype(bool))
        else:
            poly = np.reshape(np.asarray(seg[0], float), (-1, 2))
            masks.append(poly_to_mask(poly, (h, w))[..., 0].astype(bool))
        kp = np.asarray(annot.get('keypoints', []), float).reshape(-1, 3)
        kpts.append(kp)
    return (np.asarray(boxes).reshape(-1, 4), masks,
            np.asarray(kpts) if kpts and all(k.size for k in kpts) else np.zeros((0, 0, 3)))


def evaluate_predictions(items: Sequence[DataItem],
                         predictions: Sequence[Dict[str, np.ndarray]],
                         oks_sigmas: Sequence[float],
                         max_dets: int = 100,
                         kp_max_dets: int = 20) -> Dict[str, Dict[str, float]]:
    '''Compute bbox/segm/keypoints AP for per-image prediction dicts
    (boxes (D, 4), scores (D,), valid (D,), masks (D, H, W),
    keypoints (D, K, 3)).

    Output keys per task: AP, AP50, AP75, APs, APm, APl (keypoints: APm/APl
    only, like pycocotools' keypoint Params). maxDets defaults match
    pycocotools (100 for bbox/segm, 20 for keypoints).
    '''
    sigmas = np.asarray(oks_sigmas, float)
    box_sims, mask_sims, kp_sims, scores_list = [], [], [], []
    gt_box_areas, gt_mask_areas, det_box_areas, det_mask_areas = [], [], [], []
    kp_gt_areas, det_kp_areas, kp_gt_ignore = [], [], []
    for item, pred in zip(items, predictions):
        gt_boxes, gt_masks, gt_kpts = _gt_from_item(item)
        valid = np.asarray(pred['valid'], bool)
        p_boxes = np.asarray(pred['boxes'])[valid]
        p_scores = np.asarray(pred['scores'])[valid]
        scores_list.append(p_scores)

        box_sims.append(_box_iou_matrix(p_boxes, gt_boxes))
        p_masks = [np.asarray(m, bool) for m in np.asarray(pred['masks'])[valid]]
        mask_sims.append(_mask_iou_matrix(p_masks, gt_masks))
        # COCO gt 'area' is the segmentation area; use it for every task's
        # area-range bucketing (cocoeval uses g['area'] regardless of iouType)
        g_area = np.asarray([m.sum() for m in gt_masks], float)
        gt_box_areas.append(g_area)
        gt_mask_areas.append(g_area)
        det_box_areas.append(
            np.prod(np.clip(p_boxes[:, 2:] - p_boxes[:, :2], 0, None), axis=1)
            if len(p_boxes) else np.zeros(0))
        det_mask_areas.append(np.asarray([m.sum() for m in p_masks], float))
        # pycocotools computeOks scales by gt['area'] — the SEGMENTATION
        # area, not the box area (cocoeval.py computeOks: gt['area'])
        if gt_kpts.size:
            kp_sims.append(_oks_matrix(np.asarray(pred['keypoints'])[valid],
                                       gt_kpts, g_area, sigmas,
                                       gt_boxes=gt_boxes))
            kp_gt_areas.append(g_area)
            # pycocotools _prepare: keypoint-task GT with zero visible
            # keypoints are ignored (num_keypoints == 0)
            kp_gt_ignore.append((gt_kpts[:, :, 2] > 0).sum(axis=1) == 0)
        else:
            kp_sims.append(np.zeros((len(p_scores), 0)))
            kp_gt_areas.append(np.zeros(0))
            kp_gt_ignore.append(np.zeros(0, bool))
        # keypoint-task detection areas: pycocotools loadRes derives them
        # from the keypoint-extent bbox, not the predicted box
        pk = np.asarray(pred['keypoints'])[valid]
        if pk.size:
            kx, ky = pk[:, :, 0], pk[:, :, 1]
            det_kp_areas.append((kx.max(1) - kx.min(1)) * (ky.max(1) - ky.min(1)))
        else:
            det_kp_areas.append(np.zeros(0))

    return {
        'bbox': _evaluate_task(box_sims, scores_list, gt_box_areas,
                               det_box_areas, max_dets,
                               ('all', 'small', 'medium', 'large')),
        'segm': _evaluate_task(mask_sims, scores_list, gt_mask_areas,
                               det_mask_areas, max_dets,
                               ('all', 'small', 'medium', 'large')),
        'keypoints': _evaluate_task(kp_sims, scores_list, kp_gt_areas,
                                    det_kp_areas, kp_max_dets,
                                    ('all', 'medium', 'large'),
                                    gt_ignore_per_image=kp_gt_ignore),
    }


def evaluate_model(model_dir: str, items: Sequence[DataItem],
                   checkpoint: str = 'last', batch_size: int = 8,
                   predictor=None, device='cuda') -> Dict[str, Dict[str, float]]:
    '''Load a model and evaluate it over annotated items, logging the data
    and compute seconds per iteration (``m2de/model/eval.py:125-155``).

    An already-built ``predictor`` (an exported model from
    ``deploy.load_exported_model``: the post-export evaluation) takes
    precedence over loading ``model_dir``.
    '''
    import torch

    from moseq2_detectron_extract_tpu_torch.io.image import read_image
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor

    if predictor is None:
        predictor = Predictor.from_model_dir(model_dir, checkpoint=checkpoint,
                                             batch_size=batch_size, device=device)
    if predictor.cfg.rpn_post_nms_topk_test < 1000:
        logging.info(
            'eval config uses rpn_post_nms_topk_test=%d (a speed default; '
            'Detectron2/reference uses 1000) — dense multi-instance scenes '
            'may lose proposal recall vs reference AP; set 1000 in the model '
            'config for strict parity numbers',
            predictor.cfg.rpn_post_nms_topk_test)

    predictions = []
    data_time = compute_time = 0.0
    for item in items:
        t0 = time.perf_counter()
        image = np.atleast_3d(read_image(item['file_name']))[:, :, 0]
        t1 = time.perf_counter()
        out = predictor(torch.from_numpy(image[None].astype('uint8')))
        pred = {k: v[0].cpu().numpy() for k, v in out.items()}
        t2 = time.perf_counter()
        data_time += t1 - t0
        compute_time += t2 - t1
        predictions.append(pred)
    n = max(len(items), 1)
    logging.info('eval timing: %.4f s/iter data, %.4f s/iter compute',
                 data_time / n, compute_time / n)
    return evaluate_predictions(items, predictions, predictor.cfg.oks_sigmas)
