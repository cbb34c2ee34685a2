'''Static multi-level anchors (Detectron2 DefaultAnchorGenerator, offset 0).

Port of ``moseq2_detectron_extract_tpu/models/anchors.py`` (numpy; the
caller moves the result to its device). Level l gives (H_l * W_l * A, 4)
xyxy boxes in (y, x, anchor) order.
'''
import functools
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=32)
def _cell_anchors(sizes: Tuple[float, ...], aspect_ratios: Tuple[float, ...]) -> np.ndarray:
    anchors = []
    for size in sizes:
        area = size ** 2
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.array(anchors, dtype=np.float32)


@functools.lru_cache(maxsize=32)
def generate_anchors(feature_shapes: Tuple[Tuple[int, int], ...],
                     strides: Tuple[int, ...],
                     sizes: Tuple[Tuple[float, ...], ...],
                     aspect_ratios: Tuple[float, ...]) -> Tuple[np.ndarray, ...]:
    '''Anchor boxes per level, (H_l * W_l * A, 4) float32 each.'''
    out = []
    for (h, w), stride, level_sizes in zip(feature_shapes, strides, sizes):
        cell = _cell_anchors(tuple(level_sizes), tuple(aspect_ratios))
        shift_x = np.arange(w, dtype=np.float32) * stride
        shift_y = np.arange(h, dtype=np.float32) * stride
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
        anchors = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
        out.append(anchors.astype(np.float32))
    return tuple(out)
