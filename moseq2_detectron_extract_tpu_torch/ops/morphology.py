'''Median and morphology on (N, H, W) frames in plain PyTorch.

Port of ``moseq2_detectron_extract_tpu/ops/morphology.py``: cv2 border
semantics (the border never wins a min/max; the median replicates edges).

The 9x9 elliptical structuring element is cv2's
``getStructuringElement(MORPH_ELLIPSE, (9, 9))`` written out (57 taps). The
JAX package computes it with cv2 when cv2 is importable and otherwise with
a formula that gives a different, 49-tap element; the port needs neither.
'''
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
    h, w = frames.shape[1], frames.shape[2]
    x = frames[:, None].float() if not frames.dtype.is_floating_point else frames[:, None]
    padded = F.pad(x, (1, 1, 1, 1), mode='replicate')[:, 0].to(frames.dtype)
    windows = torch.stack([padded[:, dy:dy + h, dx:dx + w]
                           for dy in range(3) for dx in range(3)])
    return torch.sort(windows, dim=0).values[4]
