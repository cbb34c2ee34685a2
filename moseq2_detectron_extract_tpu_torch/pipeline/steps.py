'''Per-chunk device steps of extraction: inference, then instance selection.

Port of ``moseq2_detectron_extract_tpu/pipeline/steps.py``:
``InferenceStep.process`` (lines 112-155, the ``device_input='full'``
branch) and ``SelectInstancesStep._select_instances`` (lines 200-310, the
branch with the depth chunk on the device), as functions of one chunk. The
pipeline threads, the instance log and the host-side sentinel zeroing for
the preview are not part of this slice.
'''
from typing import Dict

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.ops.instances import (gather_selected_windows,
                                                              window_origins)
from moseq2_detectron_extract_tpu_torch.ops.preprocess import (decode_prepped_frames,
                                                               scale_raw_frames)
from moseq2_detectron_extract_tpu_torch.proc.tracker import CentroidTracker


def run_inference(chunk: torch.Tensor, predictor, config: Dict) -> Dict:
    '''Decode the sentinel-encoded uint8 chunk on the device, scale it, and
    run the predictor with the fused selection.

    Returns ``chunk_dev`` (the decoded (N, H, W) depth) and ``inference``.
    '''
    chunk_dev = decode_prepped_frames(chunk.to(predictor.device))
    frames = scale_raw_frames(chunk_dev, config['min_height'], config['max_height'])
    return {'chunk_dev': chunk_dev, 'inference': predictor(frames)}


def select_instances(data: Dict, config: Dict, tracker: CentroidTracker) -> Dict:
    '''Pick one instance per frame (host tracker over the small (N, D)
    arrays), then gather its mask, keypoints and depth window on the device.

    Adds ``chosen_idx``, ``num_instances``, ``kept_boxes``, ``win_origins``
    (N, 2 [y0, x0]), ``sel_masks`` (N, c, c) uint8, ``sel_keypoints``
    (N, K, 3) and ``raw_windows`` (N, c, c).
    '''
    inference = data['inference']
    expected = config.get('expected_instances', 1)
    keep = inference['keep'].cpu().numpy()
    centers = inference['centers'].cpu().numpy()
    scores = inference['scores'].cpu().numpy()
    raw_boxes = inference['boxes'].cpu().numpy().astype('float64')
    boxes = raw_boxes.copy()
    boxes[~keep] = np.nan
    n = keep.shape[0]

    chosen_idx = np.zeros(n, dtype='int32')
    num_instances = np.zeros(n, dtype=int)
    for i in range(n):
        keep_idx = np.flatnonzero(keep[i])
        keep_idx = keep_idx[np.argsort(-scores[i][keep_idx])]
        tracked = tracker.update(centers[i], keep[i])
        if len(tracked) > 1:
            tracked.sort(key=lambda o: o.age, reverse=True)
            chosen = [o.last_detection_index for o in tracked[:expected]
                      if o.last_detection_index is not None]
        else:
            chosen = list(keep_idx[:expected])
        num_instances[i] = len(chosen)
        if chosen:
            chosen_idx[i] = chosen[0]

    # window seeds: the chosen detection's box centre [x, y] (NaN if none)
    chosen_boxes = raw_boxes[np.arange(n), chosen_idx]
    sel_centers = np.stack([(chosen_boxes[:, 0] + chosen_boxes[:, 2]) / 2,
                            (chosen_boxes[:, 1] + chosen_boxes[:, 3]) / 2], axis=1)
    sel_centers[num_instances <= 0] = np.nan
    chunk_dev = data['chunk_dev']
    h, w = chunk_dev.shape[1], chunk_dev.shape[2]
    crop = min(int(config.get('feature_window', 160)), h, w)
    origins = window_origins(sel_centers, (h, w), crop)
    dev = chunk_dev.device
    mask_wins, sel_kpts, raw_wins = gather_selected_windows(
        inference['masks'], inference['keypoints'],
        torch.as_tensor(chosen_idx, dtype=torch.long, device=dev),
        torch.as_tensor(num_instances > 0, device=dev),
        torch.as_tensor(origins, device=dev), chunk_dev, crop=crop)
    data.update(kept_boxes=boxes, chosen_idx=chosen_idx,
                num_instances=num_instances, win_origins=origins,
                sel_masks=mask_wins, sel_keypoints=sel_kpts,
                raw_windows=raw_wins)
    return data
