'''Keypoint rotation, z heights and the writers' keypoint dict.

Port of ``moseq2_detectron_extract_tpu/proc/keypoints.py``:
``default_keypoint_names``, ``default_keypoint_colors`` and
``default_keypoint_connection_rules`` (the annotation metadata),
``rotate_points`` (line 49), ``rotate_points_batch`` (71),
``keypoint_attributes`` (87), ``dispatch_z_lookup`` (103) and
``keypoints_to_dict`` (123); the outlier search's ``load_keypoint_data_from_h5``,
``load_keypoint_data_from_dict``, ``_move_median_axis0``,
``find_outliers_jumping`` and ``find_nan_keypoints`` (179-245). The z lookup
gathers from the cleaned windows on their device; only the (N, K) values
cross to the host.
'''
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.proc.util import convert_pxs_to_mm
from moseq2_detectron_extract_tpu_torch.stats import is_outlier

default_keypoint_names = [
    'Nose',
    'Left Ear',
    'Right Ear',
    'Neck',
    'Left Hip',
    'Right Hip',
    'TailBase',
    'TailTip',
]

default_keypoint_colors = [
    (255, 255, 153),  # Nose
    (166, 206, 227),  # Left Ear
    (31, 120, 180),   # Right Ear
    (255, 255, 153),  # Neck
    (178, 223, 138),  # Left Hip
    (51, 160, 44),    # Right Hip
    (227, 26, 28),    # TailBase
    (251, 154, 153),  # TailTip
]

default_keypoint_connection_rules = [
    ('Nose', 'Left Ear', (166, 206, 227)),
    ('Nose', 'Right Ear', (31, 120, 180)),
    ('Neck', 'Left Ear', (166, 206, 227)),
    ('Neck', 'Right Ear', (31, 120, 180)),
    ('Neck', 'Left Hip', (178, 223, 138)),
    ('Neck', 'Right Hip', (51, 160, 44)),
    ('TailBase', 'Left Hip', (178, 223, 138)),
    ('TailBase', 'Right Hip', (51, 160, 44)),
    ('TailBase', 'TailTip', (251, 154, 153)),
]


def rotate_points(points: np.ndarray, center: Tuple[float, float] = (0, 0),
                  angle: float = 0) -> np.ndarray:
    '''Rotate (nkp, 2|3) points about ``center`` by ``angle`` degrees (f64);
    a third column (scores) is carried through.'''
    points = np.asarray(points, dtype=float)
    weights = None
    if points.shape[1] == 3:
        weights = points[:, 2]
        points = points[:, :2]
    elif points.shape[1] != 2:
        raise ValueError(f'expected 2 or 3 columns, got {points.shape[1]}')

    theta = np.deg2rad(-angle)
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]])
    origin = np.atleast_2d(center)
    rotated = np.squeeze((rot @ (points.T - origin.T) + origin.T).T)
    if weights is not None:
        rotated = np.append(np.atleast_2d(rotated), weights[..., None], 1)
    return rotated


def rotate_points_batch(points: np.ndarray, centers: np.ndarray, angles) -> np.ndarray:
    '''Rotate (N, K, 2|3) points about (N, 2) ``centers`` by ``angles``
    degrees (scalar or (N,)); a third column (scores) is carried through.'''
    points = np.asarray(points, dtype=float).copy()
    centers = np.asarray(centers, dtype=float)
    angles_arr = np.broadcast_to(np.asarray(angles, dtype=float), (points.shape[0],))

    theta = np.deg2rad(-angles_arr)
    cos, sin = np.cos(theta), np.sin(theta)
    rel_x = points[:, :, 0] - centers[:, None, 0]
    rel_y = points[:, :, 1] - centers[:, None, 1]
    points[:, :, 0] = cos[:, None] * rel_x - sin[:, None] * rel_y + centers[:, None, 0]
    points[:, :, 1] = sin[:, None] * rel_x + cos[:, None] * rel_y + centers[:, None, 1]
    return points


def keypoint_attributes(keypoint_names: Optional[List[str]] = None) -> Dict[str, str]:
    '''The results file's keypoint datasets (``reference/`` and ``rotated/``
    x, y and z in pixels and mm, and the score) and their descriptions.'''
    if keypoint_names is None:
        keypoint_names = default_keypoint_names
    attributes = {}
    for kpn in keypoint_names:
        for cs in ['reference', 'rotated']:
            attributes[f'{cs}/{kpn}_x_px'] = f'X position of {kpn} (pixels) in {cs} coordinate system.'
            attributes[f'{cs}/{kpn}_y_px'] = f'Y position of {kpn} (pixels) in {cs} coordinate system.'
            attributes[f'{cs}/{kpn}_x_mm'] = f'X position of {kpn} (mm) in {cs} coordinate system.'
            attributes[f'{cs}/{kpn}_y_mm'] = f'Y position of {kpn} (mm) in {cs} coordinate system.'
            attributes[f'{cs}/{kpn}_z_mm'] = f'Z position of {kpn} (mm) in {cs} coordinate system.'
            attributes[f'{cs}/{kpn}_score'] = f'Inference score of {kpn}.'
    return attributes


def dispatch_z_lookup(keypoints: np.ndarray, frames: torch.Tensor,
                      frame_origins=None) -> torch.Tensor:
    '''The (N, K) depth of ``frames`` (N, H, W) under each keypoint, gathered
    on the frames' device (the pixel at the keypoint's floor, clamped into
    the frame). With ``frame_origins`` (N, 2 [y0, x0]) the frames are
    windows and the keypoints are shifted into them.'''
    keypoints = np.asarray(keypoints, dtype=float)
    nframes = keypoints.shape[0]
    with np.errstate(invalid='ignore'):
        kp_x = np.nan_to_num(keypoints[:, :, 0])
        kp_y = np.nan_to_num(keypoints[:, :, 1])
        if frame_origins is not None:
            origins = np.asarray(frame_origins)
            kp_x = kp_x - origins[:, 1:2]
            kp_y = kp_y - origins[:, 0:1]
        x_idx = np.clip(np.floor(kp_x).astype(int), 0, frames.shape[2] - 1)
        y_idx = np.clip(np.floor(kp_y).astype(int), 0, frames.shape[1] - 1)
    dev = frames.device
    rows = torch.arange(nframes, device=dev)[:, None]
    return frames[rows, torch.as_tensor(y_idx, device=dev), torch.as_tensor(x_idx, device=dev)]


def keypoints_to_dict(keypoints: np.ndarray, frames: Optional[torch.Tensor],
                      centers: np.ndarray, angles: np.ndarray, true_depth: float = 673.1,
                      keypoint_names: Optional[List[str]] = None,
                      frame_origins=None, z_data=None) -> Dict[str, np.ndarray]:
    '''Keypoints in 4 coordinate systems (reference and rotated, px and mm)
    with z heights.

    keypoints: (N, K, 3 [x, y, score]); centers: (N, 2); angles: (N,)
    degrees. ``z_data`` takes a ``dispatch_z_lookup`` result (``frames``
    may then be None); without it the lookup runs on ``frames`` here.
    '''
    if keypoint_names is None:
        keypoint_names = default_keypoint_names

    keypoints = np.asarray(keypoints, dtype=float)
    nframes, nkp = keypoints.shape[0], keypoints.shape[1]

    if z_data is None:
        z_data = dispatch_z_lookup(keypoints, frames, frame_origins)
    if torch.is_tensor(z_data):
        z_data = z_data.cpu().numpy()
    z_data = np.asarray(z_data, dtype=float)

    with np.errstate(invalid='ignore'):
        ref_kpts_px = keypoints.copy()
        ref_kpts_mm = np.zeros_like(keypoints)
        ref_kpts_mm[:, :, 2] = keypoints[:, :, 2]
        ref_kpts_mm[:, :, :2] = convert_pxs_to_mm(
            keypoints[:, :, :2].reshape(-1, 2), true_depth=true_depth).reshape(nframes, nkp, 2)

        rot_kpts_px = rotate_points_batch(keypoints.copy(), centers, angles)
        rot_kpts_px[:, :, :2] -= np.expand_dims(centers, axis=1)

        centroid_mm = convert_pxs_to_mm(centers, true_depth=true_depth)
        rot_kpts_mm = rotate_points_batch(ref_kpts_mm.copy(), centroid_mm, angles)
        rot_kpts_mm[:, :, :2] -= np.expand_dims(centroid_mm, axis=1)

    out = {}
    for kpi, kpn in enumerate(keypoint_names):
        out[f'reference/{kpn}_x_px'] = ref_kpts_px[:, kpi, 0]
        out[f'reference/{kpn}_y_px'] = ref_kpts_px[:, kpi, 1]
        out[f'reference/{kpn}_score'] = ref_kpts_px[:, kpi, 2]
        out[f'reference/{kpn}_x_mm'] = ref_kpts_mm[:, kpi, 0]
        out[f'reference/{kpn}_y_mm'] = ref_kpts_mm[:, kpi, 1]
        out[f'reference/{kpn}_z_mm'] = z_data[:, kpi]
        out[f'rotated/{kpn}_x_px'] = rot_kpts_px[:, kpi, 0]
        out[f'rotated/{kpn}_y_px'] = rot_kpts_px[:, kpi, 1]
        out[f'rotated/{kpn}_score'] = rot_kpts_px[:, kpi, 2]
        out[f'rotated/{kpn}_x_mm'] = rot_kpts_mm[:, kpi, 0]
        out[f'rotated/{kpn}_y_mm'] = rot_kpts_mm[:, kpi, 1]
        out[f'rotated/{kpn}_z_mm'] = z_data[:, kpi]
    return out


def load_keypoint_data_from_h5(h5_file, keypoints: Optional[List[str]] = None,
                               coord_system: str = 'reference', units: str = 'px',
                               root: str = '/keypoints') -> np.ndarray:
    '''The (N, K, 3 [x, y, score]) keypoints of a results file opened with
    ``io.hdf5.File(path, 'r')``, in ``coord_system`` (reference or rotated)
    and ``units`` (px or mm).'''
    if keypoints is None:
        keypoints = default_keypoint_names
    root = '' if not root else (root if root.endswith('/') else root + '/')
    keys = [f'{root}{coord_system}/{kp}' for kp in keypoints]
    data = np.empty((h5_file['frames'].shape[0], len(keys), 3), dtype=float)
    for kpi, kp in enumerate(keys):
        data[:, kpi, 0] = h5_file[f'{kp}_x_{units}'][()]
        data[:, kpi, 1] = h5_file[f'{kp}_y_{units}'][()]
        data[:, kpi, 2] = h5_file[f'{kp}_score'][()]
    return data


def load_keypoint_data_from_dict(data: Dict[str, np.ndarray],
                                 keypoints: Optional[List[str]] = None,
                                 coord_system: str = 'reference', units: str = 'px',
                                 root: str = '/keypoints') -> np.ndarray:
    '''``load_keypoint_data_from_h5`` on a dict of arrays keyed as the
    results file's datasets.'''
    if keypoints is None:
        keypoints = default_keypoint_names
    root = '' if not root else (root if root.endswith('/') else root + '/')
    keys = [f'{root}{coord_system}/{kp}' for kp in keypoints]
    nframes = data[f'{keys[0]}_x_{units}'].shape[0]
    out = np.empty((nframes, len(keys), 3), dtype=float)
    for kpi, kp in enumerate(keys):
        out[:, kpi, 0] = data[f'{kp}_x_{units}']
        out[:, kpi, 1] = data[f'{kp}_y_{units}']
        out[:, kpi, 2] = data[f'{kp}_score']
    return out


def _move_median_axis0(data: np.ndarray, window: int) -> np.ndarray:
    '''Trailing moving median along axis 0, at least one value a window
    (bottleneck's ``move_median`` with ``min_count=1``).'''
    out = np.empty_like(data, dtype=float)
    for i in range(data.shape[0]):
        out[i] = np.median(data[max(0, i - window + 1):i + 1], axis=0)
    return out


def find_outliers_jumping(data: np.ndarray, window: int = 4,
                          thresh: float = 10) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    '''Frames where a keypoint jumps: each keypoint's distance from its
    trailing moving median, tested by the modified z-score (``stats``).
    Scores and the last keypoint (the tail tip) are left out. Returns the
    frames, the (N, K-1) distances and the (N, K-1) outlier mask.'''
    data = np.copy(np.asarray(data)[:, :data.shape[1] - 1, :2])
    window = min(window, data.shape[0])
    windows = _move_median_axis0(data, window)
    dist = np.sqrt(np.sum((data - windows) ** 2, axis=2))
    outliers = np.zeros(dist.shape[:2], dtype=bool)
    for i in range(dist.shape[1]):
        outliers[:, i] = is_outlier(dist[:, i], thresh=thresh)
    return np.where(outliers.any(axis=1))[0], dist, outliers


def find_nan_keypoints(data: np.ndarray) -> np.ndarray:
    '''Frames with any NaN in their keypoints.'''
    return np.isnan(np.asarray(data)).any(axis=(1, 2)).nonzero()[0]
