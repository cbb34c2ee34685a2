'''The 17 per-frame scalars of the writers.

Port of ``moseq2_detectron_extract_tpu/proc/scalars.py``:
``scalar_attributes`` (lines 15-37, the results file's descriptions),
``dispatch_scalar_stats`` (the area and average height, a reduction on the
frames' device) and ``compute_scalars`` (lines 39-112, host numpy). Fields
are f32, except ``area_px``, ``area_mm`` and ``velocity_theta`` (f64), as
in the reference.
'''
from typing import Dict, Tuple

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.proc.util import convert_pxs_to_mm


def scalar_attributes() -> Dict[str, str]:
    '''Scalar name -> its description in the results file.'''
    return {
        'centroid_x_px': 'X centroid (pixels)',
        'centroid_y_px': 'Y centroid (pixels)',
        'velocity_2d_px': '2D velocity (pixels / frame), note that missing frames are not accounted for',
        'velocity_3d_px': '3D velocity (pixels / frame), note that missing frames are not accounted for, also height is in mm, not pixels for calculation',
        'width_px': 'Mouse width (pixels)',
        'length_px': 'Mouse length (pixels)',
        'area_px': 'Mouse area (pixels)',
        'centroid_x_mm': 'X centroid (mm)',
        'centroid_y_mm': 'Y centroid (mm)',
        'velocity_2d_mm': '2D velocity (mm / frame), note that missing frames are not accounted for',
        'velocity_3d_mm': '3D velocity (mm / frame), note that missing frames are not accounted for',
        'width_mm': 'Mouse width (mm)',
        'length_mm': 'Mouse length (mm)',
        'area_mm': 'Mouse area (mm)',
        'height_ave_mm': 'Mouse average height (mm)',
        'angle': 'Angle (radians, unwrapped)',
        'velocity_theta': 'Angular component of velocity (arctan(vel_x, vel_y))',
    }


def dispatch_scalar_stats(frames: torch.Tensor, min_height: float = 10,
                          max_height: float = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    '''(N,) pixel counts strictly between ``min_height`` and ``max_height``,
    and the f32 mean of their heights (0 where there are none), on the
    frames' device without a host sync.'''
    masked = (frames > min_height) & (frames < max_height)
    nmask = masked.sum(dim=(1, 2))
    total = torch.where(masked, frames.float(), torch.zeros((), device=frames.device)) \
        .sum(dim=(1, 2))
    height_ave = torch.where(nmask > 0, total / torch.clamp(nmask, min=1),
                             torch.zeros((), device=frames.device))
    return nmask, height_ave


def compute_scalars(frames, track_features: dict, min_height: float = 10,
                    max_height: float = 100, true_depth: float = 673.1,
                    height_stats=None) -> Dict[str, np.ndarray]:
    '''The 17 per-frame scalars.

    frames: (N, H, W) depth in mm (a tensor), or None when ``height_stats``
    holds ``dispatch_scalar_stats``'s result; ``track_features`` holds
    'centroid' (N, 2), 'orientation' (N,) degrees and 'axis_length' (N, 2).
    '''
    centroid = np.asarray(track_features['centroid'], dtype=float)
    axis_length = np.asarray(track_features['axis_length'], dtype=float)
    orientation = np.asarray(track_features['orientation'], dtype=float)

    features: Dict[str, np.ndarray] = {}

    centroid_mm = convert_pxs_to_mm(centroid, true_depth=true_depth)
    centroid_mm_shift = convert_pxs_to_mm(centroid + 1, true_depth=true_depth)
    px_to_mm = np.abs(centroid_mm_shift - centroid_mm)

    features['centroid_x_px'] = centroid[:, 0].astype('float32')
    features['centroid_y_px'] = centroid[:, 1].astype('float32')
    features['centroid_x_mm'] = centroid_mm[:, 0].astype('float32')
    features['centroid_y_mm'] = centroid_mm[:, 1].astype('float32')

    with np.errstate(invalid='ignore'):
        features['width_px'] = np.min(axis_length, axis=1).astype('float32')
        features['length_px'] = np.max(axis_length, axis=1).astype('float32')

    if height_stats is None:
        height_stats = dispatch_scalar_stats(frames, min_height, max_height)
    nmask, height_ave = (t.cpu().numpy() for t in height_stats)
    features['area_px'] = np.asarray(nmask, dtype='float64')
    features['height_ave_mm'] = np.asarray(height_ave, dtype='float32')

    features['width_mm'] = (features['width_px'] * px_to_mm[:, 1]).astype('float32')
    features['length_mm'] = (features['length_px'] * px_to_mm[:, 0]).astype('float32')
    features['area_mm'] = features['area_px'] * px_to_mm.mean(axis=1)

    features['angle'] = np.deg2rad(orientation).astype('float32')

    def _vel(series):
        return np.diff(np.concatenate((series[:1], series)))

    vel_x = _vel(features['centroid_x_px'])
    vel_y = _vel(features['centroid_y_px'])
    vel_z = _vel(features['height_ave_mm'])
    features['velocity_2d_px'] = np.hypot(vel_x, vel_y).astype('float32')
    features['velocity_3d_px'] = np.sqrt(vel_x ** 2 + vel_y ** 2 + vel_z ** 2).astype('float32')

    vel_x_mm = _vel(features['centroid_x_mm'])
    vel_y_mm = _vel(features['centroid_y_mm'])
    features['velocity_2d_mm'] = np.hypot(vel_x_mm, vel_y_mm).astype('float32')
    features['velocity_3d_mm'] = np.sqrt(vel_x_mm ** 2 + vel_y_mm ** 2 + vel_z ** 2).astype('float32')
    features['velocity_theta'] = np.arctan2(vel_y_mm, vel_x_mm)

    return features
