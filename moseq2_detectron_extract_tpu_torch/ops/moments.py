'''Image-moment features of binary masks (centroid, orientation, axes).

Port of ``moseq2_detectron_extract_tpu/ops/moments.py``: raw and central
moments of the mask pixels, in f32.
'''
import math
from typing import Dict

import torch


def mask_moments(masks: torch.Tensor) -> Dict[str, torch.Tensor]:
    '''m00, m10, m01, mu20, mu11, mu02 (N,) f32 of (N, H, W) masks.'''
    m = masks.float()
    h, w = masks.shape[1], masks.shape[2]
    ygrid = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None].expand(h, w)
    xgrid = torch.arange(w, dtype=torch.float32, device=masks.device)[None, :].expand(h, w)
    m00 = m.sum(dim=(1, 2))
    m10 = (m * xgrid).sum(dim=(1, 2))
    m01 = (m * ygrid).sum(dim=(1, 2))
    safe = torch.clamp(m00, min=1e-12)
    cx = m10 / safe
    cy = m01 / safe
    dx = xgrid[None] - cx[:, None, None]
    dy = ygrid[None] - cy[:, None, None]
    return {'m00': m00, 'm10': m10, 'm01': m01,
            'mu20': (m * dx * dx).sum(dim=(1, 2)),
            'mu11': (m * dx * dy).sum(dim=(1, 2)),
            'mu02': (m * dy * dy).sum(dim=(1, 2))}


def mask_moment_features(masks: torch.Tensor) -> Dict[str, torch.Tensor]:
    '''centroid (N, 2 [x, y]), orientation (N,) radians, axis_length (N, 2
    [major, minor]); NaN for empty masks.'''
    mom = mask_moments(masks)
    m00 = mom['m00']
    safe = torch.clamp(m00, min=1e-12)
    num = 2.0 * mom['mu11']
    den = mom['mu20'] - mom['mu02']
    common = torch.sqrt(4.0 * torch.square(mom['mu11']) + torch.square(den))
    orientation = -0.5 * torch.atan2(num, den)
    centroid = torch.stack([mom['m10'] / safe, mom['m01'] / safe], dim=-1)
    k = 2.0 * math.sqrt(2.0)
    major = k * torch.sqrt(torch.clamp((mom['mu20'] + mom['mu02'] + common) / safe, min=0.0))
    minor = k * torch.sqrt(torch.clamp((mom['mu20'] + mom['mu02'] - common) / safe, min=0.0))
    axis_length = torch.stack([major, minor], dim=-1)
    empty = m00 <= 0
    nan = torch.tensor(torch.nan, device=masks.device)
    return {'centroid': torch.where(empty[:, None], nan, centroid),
            'orientation': torch.where(empty, nan, orientation),
            'axis_length': torch.where(empty[:, None], nan, axis_length)}
