'''Layers that compute in a fixed dtype, as flax layers with ``dtype=`` do.

A flax ``nn.Conv``/``nn.Dense`` with ``dtype=bf16`` casts its input and its
kernel to bf16 and returns bf16; one without ``dtype`` promotes a bf16 input
to its f32 kernel and returns f32. ``compute_dtype`` states which of the two
a layer is. Weights may be stored in the compute dtype once
(:func:`cast_to_compute_dtype`); the forward casts what is not.
'''
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    '''``nn.Conv2d`` that computes in ``compute_dtype``.'''

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    '''``nn.ConvTranspose2d`` that computes in ``compute_dtype``.'''

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    '''``nn.Linear`` that computes in ``compute_dtype``.'''

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class FrozenBatchNorm2d(nn.Module):
    '''y = (x - mean) / sqrt(var + eps) * weight + bias with frozen buffers.

    The affine constants fold in f32 and are cast to the input's dtype, so a
    bf16 stream stays bf16 (``models/resnet.py:FrozenBatchNorm``).
    '''

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer('weight', torch.ones(channels))
        self.register_buffer('bias', torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x):
        inv = self.weight.float() / torch.sqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * inv
        return x * inv.to(x.dtype)[None, :, None, None] + \
            shift.to(x.dtype)[None, :, None, None]


class GroupNorm(nn.GroupNorm):
    '''GroupNorm whose statistics are taken in f32 and whose output is cast
    to ``compute_dtype`` (flax ``nn.GroupNorm(dtype=...)``).'''

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 compute_dtype=torch.float32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def cast_to_compute_dtype(module: nn.Module) -> nn.Module:
    '''Store each dtype-fixed conv/linear layer's parameters in its compute
    dtype, so the forward casts nothing.'''
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.to(m.compute_dtype)
    return module


def compute_dtype_of(amp_dtype: Optional[str]) -> torch.dtype:
    '''The model's compute dtype from ``ModelConfig.amp_dtype``.'''
    return torch.bfloat16 if amp_dtype == 'bfloat16' else torch.float32
