'''Median and morphology on (N, H, W) frames in plain PyTorch.

Port of ``moseq2_detectron_extract_tpu/ops/morphology.py``: cv2 border
semantics (the border never wins a min/max; the median replicates edges),
and ``temporal_median`` (lines 132-138), the median along time.

The elliptical structuring elements of the clean (9x9, 57 taps) and of the
ROI dilation (10x10, 83 taps) are cv2's ``getStructuringElement(
MORPH_ELLIPSE, size)`` written out. The JAX package computes them with cv2
when cv2 is importable and otherwise with a formula that gives different
elements (49 and 60 taps); the port needs neither. ``select_strel`` makes
every elliptical element by cv2's own rule (``make_ellipse_strel``), which
gives these two.
'''
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (9, 9))
ELLIPSE_9X9 = np.array([
    [0, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 1, 1, 1, 1, 1, 1, 1, 0],
    [0, 1, 1, 1, 1, 1, 1, 1, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 1, 1, 1, 1, 1, 1, 1, 0],
    [0, 1, 1, 1, 1, 1, 1, 1, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 0],
], dtype=np.uint8)

# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (10, 10)): the ROI dilation's default
ELLIPSE_10X10 = np.array([
    [0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 1, 1, 1, 1, 1, 1, 1, 0],
    [0, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 1, 1, 1, 1, 1, 1, 1, 0],
], dtype=np.uint8)


def make_rect_strel(size: Tuple[int, int]) -> np.ndarray:
    '''Rectangular structuring element of size (w, h).'''
    return np.ones((size[1], size[0]), dtype=np.uint8)


def make_ellipse_strel(size: Tuple[int, int]) -> np.ndarray:
    '''Elliptical structuring element of size (w, h), by cv2's rule: row i
    spans c +- round(c * sqrt(1 - (i - r)**2 / r**2)) with r = h // 2 and
    c = w // 2 (round half to even).'''
    w, h = size
    out = np.zeros((h, w), np.uint8)
    r, c = h // 2, w // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(h):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0):min(c + dx + 1, w)] = 1
    return out


def select_strel(shape: str = 'e', size: Tuple[int, int] = (10, 10)) -> np.ndarray:
    '''Structuring element by shape code ('e'llipse or 'r'ect) and (w, h).'''
    size = (int(size[0]), int(size[1]))
    if shape and shape[0].lower() == 'r':
        return make_rect_strel(size)
    return make_ellipse_strel(size)


def strel_offsets(strel: np.ndarray):
    '''(dy, dx) offsets of a structuring element's taps about its centre.'''
    kh, kw = strel.shape
    ys, xs = np.nonzero(np.asarray(strel) > 0)
    return list(zip((ys - kh // 2).tolist(), (xs - kw // 2).tolist()))


def _neutral(dtype: torch.dtype, op: str):
    if dtype.is_floating_point:
        return float('inf') if op == 'min' else float('-inf')
    info = torch.iinfo(dtype)
    return info.max if op == 'min' else info.min


def _morph(frames: torch.Tensor, strel: np.ndarray, iterations: int, op: str):
    offsets = strel_offsets(strel)
    pad = max(strel.shape) - 1
    h, w = frames.shape[1], frames.shape[2]
    x = frames
    for _ in range(iterations):
        padded = F.pad(x, (pad, pad, pad, pad), value=_neutral(x.dtype, op))
        out = None
        for dy, dx in offsets:
            if op == 'max':          # dilation reflects the element
                dy, dx = -dy, -dx
            tap = padded[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            if out is None:
                out = tap
            else:
                out = torch.minimum(out, tap) if op == 'min' else torch.maximum(out, tap)
        x = out
    return x


def erode(frames: torch.Tensor, strel: np.ndarray, iterations: int = 1) -> torch.Tensor:
    '''Grayscale erosion of (N, H, W) frames; the border never wins.'''
    return _morph(frames, strel, iterations, 'min')


def dilate(frames: torch.Tensor, strel: np.ndarray, iterations: int = 1) -> torch.Tensor:
    '''Grayscale dilation of (N, H, W) frames; the border never wins.'''
    return _morph(frames, strel, iterations, 'max')


def morph_open(frames: torch.Tensor, strel: np.ndarray, iterations: int = 1) -> torch.Tensor:
    '''``iterations`` erosions then ``iterations`` dilations (cv2 MORPH_OPEN).'''
    return dilate(erode(frames, strel, iterations), strel, iterations)


def median_blur_3x3(frames: torch.Tensor) -> torch.Tensor:
    '''3x3 median over (N, H, W) frames with replicated edges (cv2.medianBlur).'''
    return median_blur(frames, 3)


def median_blur(frames: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    '''k x k median (odd k) over (N, H, W) frames with replicated edges.

    Integer frames are padded and sorted in f32, exact for integers up to
    2**24 (depth and uint8 frames; CUDA's sort takes no uint16).
    '''
    if ksize <= 1:
        return frames
    r = ksize // 2
    h, w = frames.shape[1], frames.shape[2]
    x = frames[:, None].float() if not frames.dtype.is_floating_point else frames[:, None]
    padded = F.pad(x, (r, r, r, r), mode='replicate')[:, 0]
    windows = torch.stack([padded[:, dy:dy + h, dx:dx + w]
                           for dy in range(ksize) for dx in range(ksize)])
    return torch.sort(windows, dim=0).values[(ksize * ksize) // 2].to(frames.dtype)


def temporal_median(frames: torch.Tensor, window: int = 3) -> torch.Tensor:
    '''Median over ``window`` consecutive frames of (N, H, W) frames, the
    window zero-padded at the ends (``scipy.signal.medfilt`` with a
    ``[window, 1, 1]`` kernel). Integer frames are sorted in f32 as in
    :func:`median_blur`.'''
    r = window // 2
    n = frames.shape[0]
    x = frames.float() if not frames.dtype.is_floating_point else frames
    padded = F.pad(x, (0, 0, 0, 0, r, r))
    windows = torch.stack([padded[i:i + n] for i in range(window)])
    return torch.sort(windows, dim=0).values[window // 2].to(frames.dtype)
