'''Plain versions of what ``extract`` does to a prepped chunk around the
detector: the decode of sentinel pixels, the height scaling, the feature
window, its clean (3x3 median, then 3 erosions and 3 dilations by the 9x9
ellipse, over the window embedded in a zero halo) and the moments of the
cleaned mouse.

Written from the semantics that the extractor (moseq2-extract and the
Detectron2 extractor built on it) states; imports nothing of the program.
'''
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (9, 9))
ELLIPSE_9 = np.array([[0, 0, 0, 0, 1, 0, 0, 0, 0],
                      [0, 1, 1, 1, 1, 1, 1, 1, 0],
                      [0, 1, 1, 1, 1, 1, 1, 1, 0],
                      [1, 1, 1, 1, 1, 1, 1, 1, 1],
                      [1, 1, 1, 1, 1, 1, 1, 1, 1],
                      [1, 1, 1, 1, 1, 1, 1, 1, 1],
                      [0, 1, 1, 1, 1, 1, 1, 1, 0],
                      [0, 1, 1, 1, 1, 1, 1, 1, 0],
                      [0, 0, 0, 0, 1, 0, 0, 0, 0]], dtype=bool)
FEATURE_THRESHOLD = 3.0


def _four_neighbours(x):
    '''Sum of the up, down, left and right neighbours, zero outside.'''
    return (F.pad(x, (0, 0, 1, 0))[:, :-1] + F.pad(x, (0, 0, 0, 1))[:, 1:]
            + F.pad(x, (1, 0, 0, 0))[:, :, :-1] + F.pad(x, (0, 1, 0, 0))[:, :, 1:])


def decode(chunk_u8: torch.Tensor, sweeps: int = 16) -> torch.Tensor:
    '''Sentinel (255) pixels of (N, H, W) uint8 are dropouts: seeded with
    the frame's mean valid height, grown inward from the valid pixels over
    8 sweeps, relaxed by ``sweeps`` Jacobi sweeps, rounded and clipped.'''
    bad = chunk_u8 == 255
    x = torch.where(bad, torch.zeros_like(chunk_u8), chunk_u8).float()
    good = ~bad
    mean = torch.where(good, x, torch.zeros_like(x)).sum((1, 2), keepdim=True) / \
        good.sum((1, 2), keepdim=True).clamp(min=1)
    x = torch.where(bad, mean, x)
    known = good
    for _ in range(8):
        kn = known.float()
        num = _four_neighbours(x * kn)
        den = _four_neighbours(kn)
        grown = den > 0
        x = torch.where(~known & grown, num / den.clamp(min=1.0), x)
        known = known | grown
    ones = torch.ones_like(x)
    den = _four_neighbours(ones).clamp(min=1.0)
    for _ in range(sweeps):
        x = torch.where(bad, _four_neighbours(x * ones) / den, x)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def scale_heights(decoded: torch.Tensor, vmin: float, vmax: float) -> torch.Tensor:
    '''[vmin, vmax] mm onto uint8's 0-255, saturating.'''
    y = (decoded.float() - vmin) * (255.0 / (vmax - vmin))
    return torch.clamp(torch.nan_to_num(y, nan=0.0), 0, 255).to(torch.uint8)


def origins(boxes: np.ndarray, valid: np.ndarray, shape, crop: int) -> np.ndarray:
    '''(N, 2 [y0, x0]) origins of ``crop`` windows at the boxes' centres
    (truncated; no detection: 0), kept inside the frame.'''
    h, w = shape
    cx = np.where(valid, (boxes[:, 0] + boxes[:, 2]) / 2, 0.0)
    cy = np.where(valid, (boxes[:, 1] + boxes[:, 3]) / 2, 0.0)
    x0 = np.clip(cx.astype(np.int32) - crop // 2, 0, max(w - crop, 0))
    y0 = np.clip(cy.astype(np.int32) - crop // 2, 0, max(h - crop, 0))
    return np.stack([y0, x0], -1)


def crop(frames: torch.Tensor, org: np.ndarray, size: int) -> torch.Tensor:
    '''(N, size, size) windows of (N, H, W) at (N, 2 [y0, x0]).'''
    return torch.stack([frames[i, y:y + size, x:x + size] for i, (y, x) in enumerate(org)])


def _stencil(x, taps, op):
    '''``op`` over the shifted copies of zero-padded ``x`` (N, H, W).'''
    r = max(max(abs(dy), abs(dx)) for dy, dx in taps)
    p = F.pad(x, (r, r, r, r))
    h, w = x.shape[1:]
    out = None
    for dy, dx in taps:
        v = p[:, r + dy:r + dy + h, r + dx:r + dx + w]
        out = v if out is None else op(out, v)
    return out


def clean(windows: torch.Tensor) -> torch.Tensor:
    '''(N, h, w) uint8: the 3x3 median, 3 erosions, 3 dilations by the 9x9
    ellipse, over the window embedded in a zero halo wider than the stack's
    reach (the halo's own values evolve with each pass).'''
    x = windows
    h, w = x.shape[1:]
    p = F.pad(x, (1, 1, 1, 1))
    stack = torch.stack([p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    x = stack.sort(0).values[4]
    ys, xs = np.nonzero(ELLIPSE_9)
    taps = list(zip((ys - 4).tolist(), (xs - 4).tolist()))
    big = F.pad(x, (25, 25, 25, 25))
    for _ in range(3):
        big = _stencil(big, taps, torch.minimum)
    for _ in range(3):
        big = _stencil(big, [(-dy, -dx) for dy, dx in taps], torch.maximum)
    return big[:, 25:25 + h, 25:25 + w]


def moments(mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    '''Centroid (N, 2 [x, y]), orientation (N,) and axis lengths (N, 2
    [major, minor]) of (N, h, w) boolean masks; NaN where empty.'''
    m = mask.double()
    h, w = mask.shape[1:]
    yy = torch.arange(h, dtype=torch.float64, device=mask.device)[:, None]
    xx = torch.arange(w, dtype=torch.float64, device=mask.device)[None, :]
    m00 = m.sum((1, 2))
    safe = m00.clamp(min=1e-12)
    cx = (m * xx).sum((1, 2)) / safe
    cy = (m * yy).sum((1, 2)) / safe
    dx = xx[None] - cx[:, None, None]
    dy = yy[None] - cy[:, None, None]
    mu20 = (m * dx * dx).sum((1, 2))
    mu11 = (m * dx * dy).sum((1, 2))
    mu02 = (m * dy * dy).sum((1, 2))
    common = torch.sqrt(4 * mu11 ** 2 + (mu20 - mu02) ** 2)
    k = 2 * math.sqrt(2)
    major = k * torch.sqrt(((mu20 + mu02 + common) / safe).clamp(min=0))
    minor = k * torch.sqrt(((mu20 + mu02 - common) / safe).clamp(min=0))
    empty = m00 <= 0
    nan = torch.tensor(float('nan'), dtype=torch.float64, device=mask.device)
    return {'centroid': torch.where(empty[:, None], nan, torch.stack([cx, cy], -1)),
            'orientation': torch.where(empty, nan, -0.5 * torch.atan2(2 * mu11, mu20 - mu02)),
            'axis_length': torch.where(empty[:, None], nan, torch.stack([major, minor], -1))}


def window_features(cleaned: torch.Tensor, mask_windows: torch.Tensor, org: np.ndarray):
    '''Moments of (cleaned > 3) & mask in each window, the centroid moved
    back to frame coordinates.'''
    feats = moments((cleaned.float() > FEATURE_THRESHOLD) & mask_windows)
    shift = torch.as_tensor(org[:, ::-1].copy(), dtype=torch.float64, device=cleaned.device)
    feats['centroid'] = feats['centroid'] + shift
    return feats
