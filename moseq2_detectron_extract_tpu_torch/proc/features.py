'''Feature stage of the selected detection windows (clean, then moments)
and the host brain that follows it.

Port of ``moseq2_detectron_extract_tpu/proc/features.py`` (``clean_frames``,
lines 46-80; ``_frame_features_impl``, ``_frame_features_nocc`` and
``get_frame_features``, 84-140; the flip votes and keypoint helpers,
143-221; ``dispatch_instance_features``, 224-257;
``finish_instance_features``, 260-403; ``instances_to_features``, 406-440;
``_dump_debug_rows``, 443). ``clean_frames`` with extract's parameters
(median 3, 9x9-ellipse open x3, uint8) is the fused clean: the CUDA kernel
on the card, its bit-exact plain version on the CPU. Both follow the TPU
kernel's zero halo, which equals the cv2-border ops path on zero-bordered
frames; other parameters take that ops path.

The brain is host work in f64: the Kalman trackers of ``proc.kalman``, the
keypoint flip votes and the angle filter (``kalman.angle_intervention_filter``,
or with ``debug`` the per-frame loop that writes ``flip_info.tsv``); without
trackers, the flip votes and ``angles.iterative_filter_angles``.
'''
import functools
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.io.util import find_unused_file_path
from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.ops.cc import largest_cc
from moseq2_detectron_extract_tpu_torch.ops.clean_kernel import fused_clean_frames
from moseq2_detectron_extract_tpu_torch.ops.moments import mask_moment_features
from moseq2_detectron_extract_tpu_torch.ops.morphology import (ELLIPSE_9X9, erode,
                                                               make_rect_strel, median_blur,
                                                               morph_open, temporal_median)
from moseq2_detectron_extract_tpu_torch.proc.angles import (angle_difference, clamp_angles_deg,
                                                            iterative_filter_angles)
from moseq2_detectron_extract_tpu_torch.proc.kalman import (KalmanTracker,
                                                            angle_intervention_filter)
from moseq2_detectron_extract_tpu_torch.proc.keypoints import rotate_points_batch
from moseq2_detectron_extract_tpu_torch.utils.profiling import StageTimer


def clean_frames(frames: torch.Tensor, prefilter_space=(3,), prefilter_time=None,
                 strel_tail=None, iters_tail: Optional[int] = 3, frame_dtype='uint8',
                 strel_min=None, iters_min: Optional[int] = None) -> torch.Tensor:
    '''Median filter and morphological opening of (N, H, W) frames.

    Extract's parameters (the defaults here: ``prefilter_space=(3,)``,
    ``iters_tail=3``, uint8; the reference's signature defaults
    ``iters_tail`` to None and extract passes 3) are the fused clean: the
    CUDA kernel on the card, its bit-exact plain version on the CPU, with
    the TPU kernel's zero halo. Any other parameters run the reference's
    ops path with cv2's borders, in its order: ``iters_min`` erosions by
    ``strel_min`` (5x5 rectangle), a median of each ``prefilter_space``
    size (all must be > 0), ``iters_tail`` openings by ``strel_tail`` (the
    9x9 ellipse), then a temporal median of each ``prefilter_time`` size
    when all are in ``(0, N]``.
    '''
    dtype = torch.from_numpy(np.empty(0, np.dtype(frame_dtype))).dtype
    default_params = (tuple(prefilter_space or ()) == (3,) and prefilter_time is None
                      and strel_tail is None and iters_tail == 3 and strel_min is None
                      and not iters_min and dtype == torch.uint8)
    x = frames.to(dtype)
    if default_params:
        return fused_clean_frames(x)
    if dtype == torch.uint16:
        x = x.float()         # torch has no uint16 min/max; f32 holds every value exactly
    strel_tail = ELLIPSE_9X9 if strel_tail is None else np.asarray(strel_tail)
    strel_min = make_rect_strel((5, 5)) if strel_min is None else np.asarray(strel_min)
    if iters_min is not None and iters_min > 0:
        x = erode(x, strel_min, iters_min)
    if prefilter_space is not None and np.all(np.array(prefilter_space) > 0):
        for size in prefilter_space:
            x = median_blur(x, int(size))
    if iters_tail is not None and iters_tail > 0:
        x = morph_open(x, strel_tail, iters_tail)
    if (prefilter_time is not None and np.all(np.array(prefilter_time) > 0)
            and np.all(np.array(prefilter_time) <= x.shape[0])):
        for size in prefilter_time:
            x = temporal_median(x, int(size))
    return x.to(dtype)


def frame_features_nocc(cleaned: torch.Tensor, model_masks: torch.Tensor,
                        frame_threshold: float):
    '''threshold AND model mask -> moments (the largest-CC term, statically
    all-true for uint8 frames and a negative CC threshold, is skipped).'''
    frame_mask = (cleaned > frame_threshold) & (model_masks > 0)
    return mask_moment_features(frame_mask), frame_mask


def frame_features_cc(cleaned: torch.Tensor, model_masks: torch.Tensor,
                      frame_threshold: float, mask_threshold: float):
    '''threshold AND the largest component of ``cleaned > mask_threshold``
    AND model mask -> moments.'''
    frame_mask = (cleaned > frame_threshold) & largest_cc(cleaned > mask_threshold) & \
        (model_masks > 0)
    return mask_moment_features(frame_mask), frame_mask


def get_frame_features(frames, frame_threshold: float = 10, mask=None,
                       mask_threshold: float = -30, use_cc: bool = False, device=None):
    '''Image-moment features of each frame's blob: the pixels above
    ``frame_threshold`` inside ``mask`` (N, H, W; none or empty: every
    pixel), with ``use_cc`` also inside the largest 4-connected component of
    ``frames > mask_threshold``. For unsigned frames and a negative
    ``mask_threshold`` that component is the whole frame, and it is not
    computed (the reference skips it too).

    ``frames`` is a tensor, or an array put on ``device`` (default: CUDA).
    Returns (features, masks): ``centroid`` (N, 2), ``orientation`` (N,) and
    ``axis_length`` (N, 2) as f64 numpy, and the (N, H, W) bool mask on the
    frames' device.
    '''
    if not torch.is_tensor(frames):
        frames = torch.as_tensor(np.asarray(frames), device=resolve_device(
            'cuda' if device is None else device))
    if mask is None or (isinstance(mask, np.ndarray) and mask.size == 0):
        model_masks = torch.ones(frames.shape, dtype=torch.uint8, device=frames.device)
    else:
        model_masks = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask) else mask,
                                      device=frames.device).to(torch.uint8)
    unsigned = frames.dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64,
                                torch.bool)
    cc_trivially_true = use_cc and mask_threshold < 0 and unsigned
    if use_cc and not cc_trivially_true:
        feats, frame_mask = frame_features_cc(frames, model_masks, float(frame_threshold),
                                              float(mask_threshold))
    else:
        feats, frame_mask = frame_features_nocc(frames, model_masks, float(frame_threshold))
    features = {key: feats[key].cpu().numpy().astype(float)
                for key in ('centroid', 'orientation', 'axis_length')}
    return features, frame_mask


def dispatch_instance_features(masks: torch.Tensor, raw_frames: torch.Tensor,
                               window_origins=None) -> Dict:
    '''Clean the windows and take their moments, without a host sync.

    ``window_origins`` (N, 2 [y0, x0]) shifts the centroids back into
    frame coordinates.
    '''
    cleaned = clean_frames(raw_frames)
    if window_origins is not None:
        feats, feat_masks = frame_features_nocc(cleaned, masks, 3.0)
        origins = torch.as_tensor(np.asarray(window_origins), device=cleaned.device)
        offset = origins.flip(-1).to(feats['centroid'].dtype)       # x, y
        feats = dict(feats, centroid=feats['centroid'] + offset)
    else:
        if masks is None:
            model_masks = torch.ones(cleaned.shape, dtype=torch.uint8,
                                     device=cleaned.device)
        else:
            model_masks = masks.to(torch.uint8)
        feats, feat_masks = frame_features_nocc(cleaned, model_masks, 3.0)
    return {'cleaned_frames': cleaned, 'feat_masks': feat_masks,
            'feats_dev': feats, 'window_origins': window_origins}


def flips_from_keypoints(keypoints: np.ndarray, centroids: np.ndarray,
                         angles: np.ndarray, length=80):
    '''Front/rear keypoint-group vote on whether angles are flipped.
    Returns (flips bool (N,), confidence (N,)).'''
    front_keypoints = [0, 1, 2, 3]
    rear_keypoints = [4, 5, 6]

    rotated = rotate_points_batch(np.copy(keypoints), centroids, angles)
    extent_x_min = centroids[:, 0] - (np.asarray(length) / 2)
    extent_x_max = centroids[:, 0] + (np.asarray(length) / 2)
    left_dist = np.abs(extent_x_min[:, None] - rotated[:, :, 0])
    right_dist = np.abs(extent_x_max[:, None] - rotated[:, :, 0])
    scores = np.where(left_dist < right_dist, -1, 1)
    front_votes = np.mean(scores[:, front_keypoints], axis=1)
    rear_votes = np.mean(scores[:, rear_keypoints], axis=1)
    flips = front_votes < rear_votes

    expected = np.where(flips[:, None], np.array([-1, 1]), np.array([1, -1]))
    agree = (np.count_nonzero(scores[:, front_keypoints] == expected[:, 0, None], axis=1)
             + np.count_nonzero(scores[:, rear_keypoints] == expected[:, 1, None], axis=1))
    conf = agree / (len(front_keypoints) + len(rear_keypoints))
    return flips, conf


def calc_keypoint_keypoint_distance(keypoints: np.ndarray, metric: str = 'x') -> np.ndarray:
    '''Pairwise keypoint distance matrix (..., K, K).'''
    keypoints = np.asarray(keypoints, dtype=float)
    x = keypoints[..., 0]
    y = keypoints[..., 1]
    if metric == 'euclidean':
        dx = x[..., :, None] - x[..., None, :]
        dy = y[..., :, None] - y[..., None, :]
        return np.sqrt(dx ** 2 + dy ** 2)
    if metric == 'x':
        return x[..., :, None] - x[..., None, :]
    if metric == 'y':
        return y[..., :, None] - y[..., None, :]
    raise ValueError(f'unknown metric {metric}')


def get_expected_keypoint_alignment() -> np.ndarray:
    '''Expected east-west sign matrix of the 7 keypoints before the tail tip.'''
    return np.array([
        [0, 1, 1, 1, 1, 1, 1],
        [-1, 0, 0, 1, 1, 1, 1],
        [-1, 0, 0, 1, 1, 1, 1],
        [-1, -1, -1, 0, 1, 1, 1],
        [-1, -1, -1, -1, 0, 0, 1],
        [-1, -1, -1, -1, 0, 0, 1],
        [-1, -1, -1, -1, -1, -1, 0],
    ])


def compute_keypoint_alignment_scores(keypoints: np.ndarray,
                                      expected_alignment: Optional[np.ndarray] = None):
    '''Fraction of the pairwise x-order expectations met.'''
    if expected_alignment is None:
        expected_alignment = get_expected_keypoint_alignment()
    distances = calc_keypoint_keypoint_distance(keypoints)
    signs = np.sign(distances)
    masked = np.where(expected_alignment == 0, 0, signs)
    axis = (1, 2) if keypoints.ndim == 3 else None
    met = (np.count_nonzero(masked == expected_alignment, axis=axis)
           - np.count_nonzero(expected_alignment == 0))
    return met / np.count_nonzero(expected_alignment)


def estimate_keypoint_rotation(keypoints: np.ndarray) -> np.ndarray:
    '''Median frame-to-frame angular change of the keypoints.'''
    angles = np.arctan2(keypoints[..., 1], keypoints[..., 0])
    angles = np.asarray(clamp_angles_deg(np.rad2deg(angles)))
    angles = np.diff(angles, axis=0, prepend=angles[0, None, ...])
    angles = angles % 360
    to_min = angles > 180
    angles[to_min] = -(360 - angles[to_min])
    return np.median(angles, axis=1)


def _pull_features(feats_dev: Dict, keypoints):
    '''The moments (N,) and (N, 2) and the (N, K, 3) keypoints, in one copy
    to the host (in their widest dtype, so no value rounds), as f64 numpy.'''
    parts = [torch.as_tensor(feats_dev['centroid']), torch.as_tensor(feats_dev['orientation']),
             torch.as_tensor(feats_dev['axis_length']), torch.as_tensor(keypoints)]
    n = parts[0].shape[0]
    dev = parts[0].device
    dtype = functools.reduce(torch.promote_types, [p.dtype for p in parts])
    host = torch.cat([p.to(dev, dtype).reshape(n, -1) for p in parts], dim=1) \
        .cpu().numpy().astype(float)
    features = {'centroid': host[:, 0:2], 'orientation': host[:, 2],
                'axis_length': host[:, 3:5]}
    return features, host[:, 5:].reshape(tuple(parts[3].shape))


def finish_instance_features(dispatched: Dict, keypoints, num_instances: np.ndarray,
                             point_tracker: Optional[KalmanTracker],
                             angle_tracker: Optional[KalmanTracker],
                             debug: bool = False, debug_dir: str = '.',
                             timers: Optional[StageTimer] = None) -> Dict:
    '''Pull the dispatched moments and run the host brain.

    ``dispatched`` is ``dispatch_instance_features``' result; ``keypoints``
    (N, K, 3 [x, y, score]) the selected keypoints (tensor or array). With
    both trackers: Kalman smoothing of the centroid and keypoints (the
    trackers initialise by EM on their first chunk), flip votes, then the
    angle filter, which carries the angle tracker's state. Without: flip
    votes and the iterative 180-degree filter.

    ``timers`` times the host stages ``itf_moments``, ``itf_em_init``,
    ``itf_kalman_smooth``, ``itf_flip_votes`` and ``itf_angle_filter``
    (:meth:`StageTimer.lap`).
    Returns ``cleaned_frames``, ``masks``, ``mask_origins``, ``features``
    (f64 ``centroid`` and ``axis_length``, ``orientation`` in degrees),
    ``flips``, ``keypoints`` and ``num_instances``.
    '''
    if timers is not None:
        timers.start()

    def _mark(name):
        if timers is not None:
            timers.lap(name)

    features, keypoints = _pull_features(dispatched['feats_dev'], keypoints)
    _mark('itf_moments')

    with np.errstate(invalid='ignore'):
        lengths = np.max(features['axis_length'], axis=1)
        aspects = np.min(features['axis_length'], axis=1) / np.max(features['axis_length'], axis=1)
    angles = np.array(clamp_angles_deg(-np.rad2deg(features['orientation'])))

    if point_tracker is not None and angle_tracker is not None:
        if not point_tracker.is_initialized:
            point_tracker.initialize([features['centroid'], keypoints[:, :, :2]])
            _mark('itf_em_init')
        s_centroids, s_kpts = point_tracker.smooth_update(
            [features['centroid'], keypoints[:, :, :2]])
        features['centroid'] = np.asarray(s_centroids)
        # keep the inferred tail tip: tracking lags the fast-moving tail
        keypoints[:, :7, :2] = np.asarray(s_kpts)[:, :7, :]
        _mark('itf_kalman_smooth')

        orig_angles = np.copy(angles)
        flips, flip_confs = flips_from_keypoints(keypoints, features['centroid'],
                                                 angles, lengths)
        angles[flips] = np.asarray(clamp_angles_deg(angles[flips] + 180))
        post_kp_flip_angles = angles.copy()
        rot_kpts = rotate_points_batch(np.copy(keypoints[:, :7, :2]),
                                       features['centroid'], angles)
        kpt_alignment_scores = compute_keypoint_alignment_scores(rot_kpts)
        _mark('itf_flip_votes')

        if not angle_tracker.is_initialized:
            angle_tracker.initialize([angles])
            _mark('itf_em_init')

        if not debug:
            out_angles, flip_deltas, last_mean, last_cov = angle_intervention_filter(
                angle_tracker.params, angle_tracker.last_mean, angle_tracker.last_covar,
                angles, kpt_alignment_scores, order=angle_tracker.items[0].order)
            angle_tracker.last_mean = last_mean
            angle_tracker.last_covar = last_cov
            angles = out_angles
            flips = np.logical_xor(flips, flip_deltas)
        else:
            kpt_rotations = estimate_keypoint_rotation(rot_kpts)
            debug_rows = []
            for i in range(angles.shape[0]):
                p_next_angle, = angle_tracker.sample(1)
                rel_angle_dist = float(np.asarray(
                    angle_difference(p_next_angle, angles[[i]]))[0])

                if kpt_alignment_scores[i] < 0.4:
                    angles[i] = p_next_angle[0]
                    intervention = 'low kp algn score, defer to sample'
                elif np.abs(rel_angle_dist) > 140:
                    angles[i] = float(np.asarray(clamp_angles_deg(angles[i] + 180)))
                    flips[i] = ~flips[i]
                    intervention = 'flip 180'
                else:
                    intervention = None

                rel_angle_dist2 = float(np.asarray(
                    angle_difference(p_next_angle, angles[[i]]))[0])
                t_angle, = angle_tracker.filter_update([angles[[i]]])
                debug_rows.append({
                    'i': i, 'aspect': aspects[i],
                    'kpt_flip_opinion': flips[i], 'kpt_flip_conf': flip_confs[i],
                    'kpt_align_score': kpt_alignment_scores[i],
                    'kpt_rotation': kpt_rotations[i],
                    'angle_in': orig_angles[i],
                    'post_kp_flip_angle': post_kp_flip_angles[i],
                    'sample_angle': p_next_angle[0], 'filt_angle': t_angle[0],
                    'rel_angle_dist': rel_angle_dist,
                    'rel_angle_dist2': rel_angle_dist2,
                    'intervention': intervention, 'angle_out': angles[i],
                })
            _dump_debug_rows(debug_rows, os.path.join(debug_dir, 'flip_info.tsv'))
        features['orientation'] = np.array(angles)
        _mark('itf_angle_filter')
    else:
        flips, _ = flips_from_keypoints(keypoints, features['centroid'], angles, lengths)
        angles[flips] += 180
        _mark('itf_flip_votes')
        angles_f32, filter_flips = iterative_filter_angles(angles)
        features['orientation'] = angles_f32
        flips = np.logical_xor(flips, filter_flips)
        _mark('itf_angle_filter')

    return {
        'cleaned_frames': dispatched['cleaned_frames'],
        'masks': dispatched['feat_masks'],
        'mask_origins': dispatched['window_origins'],
        'features': features,
        'flips': flips,
        'keypoints': keypoints,
        'num_instances': np.asarray(num_instances),
    }


def instances_to_features(masks, keypoints, num_instances: np.ndarray, raw_frames,
                          point_tracker: Optional[KalmanTracker],
                          angle_tracker: Optional[KalmanTracker], debug: bool = False,
                          debug_dir: str = '.', timers: Optional[StageTimer] = None,
                          window_origins=None) -> Dict:
    '''The feature stage and the brain in one call:
    :func:`dispatch_instance_features`, then :func:`finish_instance_features`.

    ``masks`` (N, H, W) the selected instance's model mask and
    ``raw_frames`` (N, H, W) the prepped depth, both tensors on one device,
    or with ``window_origins`` (N, 2 [y0, x0]) their windows around each
    detection (centroids then come back in frame coordinates);
    ``keypoints`` (N, K, 3 [x, y, score]). Returns what
    :func:`finish_instance_features` returns.
    '''
    dispatched = dispatch_instance_features(masks, raw_frames, window_origins=window_origins)
    return finish_instance_features(dispatched, keypoints, num_instances, point_tracker,
                                    angle_tracker, debug=debug, debug_dir=debug_dir,
                                    timers=timers)


def _dump_debug_rows(rows, path):
    if not rows:
        return
    path = find_unused_file_path(path)
    try:
        keys = list(rows[0].keys())
        with open(path, 'w', encoding='utf-8') as fh:
            fh.write('\t'.join(keys) + '\n')
            for row in rows:
                fh.write('\t'.join(str(row[k]) for k in keys) + '\n')
    except OSError:
        logging.warning('could not write debug flip info to %s', path)
