'''ResNet backbone (C2..C5) with FrozenBN, NCHW.

Port of ``moseq2_detectron_extract_tpu/models/resnet.py``. The stride sits
on the first 1x1 conv of a block (Detectron2's ``stride_in_1x1``).
``FrozenBatchNorm`` is the JAX package's name for ``layers.FrozenBatchNorm2d``.
'''
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moseq2_detectron_extract_tpu_torch.models.layers import (Conv2d,
                                                              FrozenBatchNorm2d,
                                                              GroupNorm)

FrozenBatchNorm = FrozenBatchNorm2d


def _norm(norm: str, channels: int, dtype):
    if norm == 'frozen_bn':
        return FrozenBatchNorm2d(channels)
    if norm == 'gn':
        return GroupNorm(32, channels, compute_dtype=dtype)
    raise ValueError(f'unknown norm {norm}')


class Bottleneck(nn.Module):
    '''1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut on a stride or
    channel change.'''

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int = 1,
                 norm: str = 'frozen_bn', dtype=torch.float32):
        super().__init__()
        if in_channels != out_channels or stride != 1:
            self.shortcut = Conv2d(in_channels, out_channels, 1, stride=stride,
                                   bias=False, compute_dtype=dtype)
            self.shortcut_norm = _norm(norm, out_channels, dtype)
        else:
            self.shortcut = None
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride=stride,
                            bias=False, compute_dtype=dtype)
        self.conv1_norm = _norm(norm, bottleneck_channels, dtype)
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3,
                            padding=1, bias=False, compute_dtype=dtype)
        self.conv2_norm = _norm(norm, bottleneck_channels, dtype)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False,
                            compute_dtype=dtype)
        self.conv3_norm = _norm(norm, out_channels, dtype)

    def forward(self, x):
        shortcut = x
        if self.shortcut is not None:
            shortcut = self.shortcut_norm(self.shortcut(x))
        y = F.relu(self.conv1_norm(self.conv1(x)))
        y = F.relu(self.conv2_norm(self.conv2(y)))
        y = self.conv3_norm(self.conv3(y))
        return F.relu(y + shortcut)


def stage_blocks_of(depth: int, stage_blocks: Optional[Sequence[int]]) -> Tuple[int, ...]:
    '''Blocks per stage for ``depth`` unless given explicitly.'''
    if stage_blocks is not None:
        return tuple(stage_blocks)
    if depth == 50:
        return (3, 4, 6, 3)
    if depth == 101:
        return (3, 4, 23, 3)
    raise ValueError(f'unsupported resnet depth {depth}')


class ResNet(nn.Module):
    '''ResNet with C2..C5 outputs (strides 4, 8, 16, 32), keyed ``res2``..``res5``.'''

    def __init__(self, depth: int = 50, norm: str = 'frozen_bn',
                 stage_blocks: Optional[Sequence[int]] = None, width: int = 64,
                 dtype=torch.float32):
        super().__init__()
        blocks = stage_blocks_of(depth, stage_blocks)
        w = width
        self.stem_conv = Conv2d(3, w, 7, stride=2, padding=3, bias=False,
                                compute_dtype=dtype)
        self.stem_norm = _norm(norm, w, dtype)
        channels = (w * 4, w * 8, w * 16, w * 32)
        bottleneck = (w, w * 2, w * 4, w * 8)
        in_c = w
        self.stage_names = []
        for stage, (nblocks, out_c, mid_c) in enumerate(zip(blocks, channels,
                                                            bottleneck)):
            names = []
            for block in range(nblocks):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f'res{stage + 2}_{block}'
                self.add_module(name, Bottleneck(in_c, out_c, mid_c, stride=stride,
                                                 norm=norm, dtype=dtype))
                names.append(name)
                in_c = out_c
            self.stage_names.append(names)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        y = F.relu(self.stem_norm(self.stem_conv(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outputs = {}
        for stage, names in enumerate(self.stage_names):
            for name in names:
                y = getattr(self, name)(y)
            outputs[f'res{stage + 2}'] = y
        return outputs
