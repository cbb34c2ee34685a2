'''ROI heads (box, mask, keypoint), keypoint decoding and mask pasting.

Port of ``moseq2_detectron_extract_tpu/models/heads.py``. The heads take
pooled features NHWC (N, S, S, C), the layout of the pooled ROI tensor, and
run their convolutions NCHW. As in the JAX package, the hidden layers
compute in the model's compute dtype and the output projections in f32.
'''
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moseq2_detectron_extract_tpu_torch.models.layers import (Conv2d,
                                                              ConvTranspose2d,
                                                              Linear)


class BoxHead(nn.Module):
    '''Flatten (NCHW order) -> 2x FC -> class logits (C+1) and box deltas (C*4).'''

    def __init__(self, in_channels: int, pooler_resolution: int,
                 num_classes: int = 1, fc_dim: int = 1024, dtype=torch.float32):
        super().__init__()
        in_dim = in_channels * pooler_resolution * pooler_resolution
        self.fc1 = Linear(in_dim, fc_dim, compute_dtype=dtype)
        self.fc2 = Linear(fc_dim, fc_dim, compute_dtype=dtype)
        self.cls_score = Linear(fc_dim, num_classes + 1)
        self.bbox_pred = Linear(fc_dim, num_classes * 4)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    '''4x conv -> 2x deconv -> 1x1 conv -> (N, 2S, 2S, classes) f32 logits.'''

    def __init__(self, in_channels: int, num_classes: int = 1,
                 conv_dims: Sequence[int] = (256,) * 4, dtype=torch.float32):
        super().__init__()
        c = in_channels
        for i, dim in enumerate(conv_dims):
            self.add_module(f'mask_fcn{i + 1}', Conv2d(c, dim, 3, padding=1,
                                                       compute_dtype=dtype))
            c = dim
        self.n_convs = len(conv_dims)
        self.deconv = ConvTranspose2d(c, conv_dims[-1], 2, stride=2,
                                      compute_dtype=dtype)
        self.predictor = Conv2d(conv_dims[-1], num_classes, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f'mask_fcn{i + 1}')(x))
        x = F.relu(self.deconv(x))
        return self.predictor(x).permute(0, 2, 3, 1)


class KeypointHead(nn.Module):
    '''8x conv -> deconv 2x (f32) -> bilinear 2x -> (N, 4S, 4S, K) f32 logits.'''

    def __init__(self, in_channels: int, num_keypoints: int = 8,
                 conv_dims: Sequence[int] = (512,) * 8, dtype=torch.float32):
        super().__init__()
        c = in_channels
        for i, dim in enumerate(conv_dims):
            self.add_module(f'conv_fcn{i + 1}', Conv2d(c, dim, 3, padding=1,
                                                       compute_dtype=dtype))
            c = dim
        self.n_convs = len(conv_dims)
        self.score_lowres = ConvTranspose2d(c, num_keypoints, 4, stride=2, padding=1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f'conv_fcn{i + 1}')(x))
        x = self.score_lowres(x)
        # upsampling: align_corners=False equals jax.image.resize's bilinear
        x = F.interpolate(x, scale_factor=2, mode='bilinear', align_corners=False)
        return x.permute(0, 2, 3, 1)


def heatmaps_to_keypoints(heatmaps: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    '''(D, S, S, K) heatmap logits at (D, 4) boxes -> (D, K, 3 [x, y, score]).

    The argmax bin maps to its centre within the box; the score is the
    softmax probability there (``heads.py:73-92``).
    '''
    d, s, _, k = heatmaps.shape
    hm = heatmaps.permute(0, 3, 1, 2).reshape(d, k, s * s)
    probs = torch.softmax(hm.float(), dim=-1)
    flat_idx = torch.argmax(hm, dim=-1)
    score = torch.gather(probs, -1, flat_idx[..., None])[..., 0]
    yi = torch.div(flat_idx, s, rounding_mode='floor').float()
    xi = (flat_idx % s).float()
    x1, y1 = boxes[:, 0], boxes[:, 1]
    w = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-3)
    h = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-3)
    xs = x1[:, None] + (xi + 0.5) * (w[:, None] / s)
    ys = y1[:, None] + (yi + 0.5) * (h[:, None] / s)
    return torch.stack([xs, ys, score], dim=-1)


def paste_masks(mask_logits: torch.Tensor, boxes: torch.Tensor,
                image_size: Tuple[int, int], threshold: float = 0.5) -> torch.Tensor:
    '''Paste (D, s, s) mask logits into (D, H, W) bool masks at (D, 4) boxes.

    The bilinear inverse of ROI cropping, written separably as
    Wy (H, s) @ sigmoid(mask) @ Wx (W, s)^T with triangle weights
    relu(1 - |m - i|) (``heads.py:118-156``).
    '''
    d, s = mask_logits.shape[:2]
    h, w = image_size
    dev = mask_logits.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    idx = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
    probs = torch.sigmoid(mask_logits.float())
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    bw = torch.clamp(x2 - x1, min=1e-3)
    bh = torch.clamp(y2 - y1, min=1e-3)
    my = (ys[None] - y1) / bh * s - 0.5                     # (D, H, 1)
    mx = (xs[None] - x1) / bw * s - 0.5                     # (D, 1, W)
    wy = torch.clamp(1.0 - torch.abs(my - idx[None]), min=0.0)              # (D, H, s)
    wx = torch.clamp(1.0 - torch.abs(mx.transpose(1, 2) - idx[None]), min=0.0)  # (D, W, s)
    v = wy @ probs @ wx.transpose(1, 2)                      # (D, H, W)
    yin = (ys[None] >= y1) & (ys[None] <= y2 + 1)            # (D, H, 1)
    xin = (xs[None] >= x1) & (xs[None] <= x2 + 1)            # (D, 1, W)
    return (v >= threshold) & yin & xin
