'''Feature Pyramid Network with GroupNorm and avg fusion, P2..P6.

Port of ``moseq2_detectron_extract_tpu/models/fpn.py``. ``nearest-exact``
upsampling is ``jax.image.resize(..., 'nearest')``: both sample input
floor((i + 0.5) * in / out).
'''
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moseq2_detectron_extract_tpu_torch.models.layers import Conv2d, GroupNorm


class FPN(nn.Module):
    '''Builds P2..P6 (strides 4..64) from C2..C5.'''

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 norm: str = 'gn', fuse_type: str = 'avg', dtype=torch.float32):
        super().__init__()
        self.norm = norm
        self.fuse_type = fuse_type
        use_bias = norm != 'gn'
        for i, c in enumerate(in_channels):
            level = i + 2
            self.add_module(f'lateral{level}', Conv2d(
                c, out_channels, 1, bias=use_bias, compute_dtype=dtype))
            self.add_module(f'output{level}', Conv2d(
                out_channels, out_channels, 3, padding=1, bias=use_bias,
                compute_dtype=dtype))
            if norm == 'gn':
                self.add_module(f'lateral_norm{level}', GroupNorm(
                    32, out_channels, compute_dtype=dtype))
                self.add_module(f'output_norm{level}', GroupNorm(
                    32, out_channels, compute_dtype=dtype))
        self.n_levels = len(in_channels)

    def _maybe_norm(self, x, name):
        return getattr(self, name)(x) if self.norm == 'gn' else x

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = []
        for i in range(self.n_levels):
            level = i + 2
            lat = getattr(self, f'lateral{level}')(bottom_up[f'res{level}'])
            laterals.append(self._maybe_norm(lat, f'lateral_norm{level}'))

        results = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = F.interpolate(results[0], size=lat.shape[-2:], mode='nearest-exact')
            fused = lat + up
            if self.fuse_type == 'avg':
                fused = fused / 2.0
            results.insert(0, fused)

        outputs = []
        for i, feat in enumerate(results):
            level = i + 2
            out = getattr(self, f'output{level}')(feat)
            outputs.append(self._maybe_norm(out, f'output_norm{level}'))
        outputs.append(F.max_pool2d(outputs[-1], 1, stride=2))   # P6
        return tuple(outputs)
