'''Pixel to millimetre conversion of the Kinect v2's field of view, a
session's completion status, and indexing a dict of arrays.

Port of ``moseq2_detectron_extract_tpu/proc/util.py``: ``convert_pxs_to_mm``
(lines 11-26), ``check_completion_status`` (29-37, through the port's YAML
reader) and ``slice_dict`` (40-42).
'''
import os
from typing import Tuple

import numpy as np

from moseq2_detectron_extract_tpu_torch.io.util import read_yaml


def convert_pxs_to_mm(coords: np.ndarray, resolution: Tuple[int, int] = (512, 424),
                      field_of_view: Tuple[float, float] = (70.6, 60),
                      true_depth: float = 673.1) -> np.ndarray:
    '''(..., 2 [x, y]) pixel coordinates -> millimetres at ``true_depth``.'''
    coords = np.asarray(coords)
    cx = resolution[0] // 2
    cy = resolution[1] // 2
    xhat = coords[..., 0] - cx
    yhat = coords[..., 1] - cy
    f_w = resolution[0] / (2 * np.deg2rad(field_of_view[0] / 2))
    f_h = resolution[1] / (2 * np.deg2rad(field_of_view[1] / 2))
    out = np.zeros_like(coords, dtype=coords.dtype)
    out[..., 0] = true_depth * xhat / f_w
    out[..., 1] = true_depth * yhat / f_h
    return out


def check_completion_status(status_filename: str) -> bool:
    '''True when the status YAML exists and says ``complete: true``.'''
    if os.path.exists(status_filename):
        try:
            return bool(read_yaml(status_filename).get('complete', False))
        except Exception:  # noqa: BLE001 - an unreadable status is not complete
            return False
    return False


def slice_dict(data: dict, index: int) -> dict:
    '''Index every array in a dict along axis 0.'''
    return {key: value[index] for key, value in data.items()}
