'''Multilevel ROIAlignV2 (aligned, sampling ratio 2): the plain PyTorch version.

Port of ``moseq2_detectron_extract_tpu/ops/roi_align.py:21-390``
(``assign_fpn_levels``, ``_roi_sample_coords``, ``_fold_interp_weights``,
``_separable_inputs``, ``separable_batched_roi_align``). Each ROI takes the
level clamp(floor(4 + log2(sqrt(area) / 224)), 2, 5), is sampled at
2*out x 2*out half-pixel points clamped into the level (not zeroed),
interpolated bilinearly, and each 2x2 group of samples is averaged.

The separable form writes the interpolation as two folded weight matrices,
Wy (out, sum_l H_l) over the H-stacked pyramid and Wx (out, Wmax), so
pooling is Wy @ F @ Wx^T. This is the plain version of the CUDA kernel in
``roi_align_kernel.py``: it serves CPU tensors and the tests, and is what
the kernel is held against on the card. It computes in f32 whatever the
feature dtype, as the kernel does, and casts the result to ``out_dtype``.
'''
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def assign_fpn_levels(boxes, min_level: int = 2, max_level: int = 5,
                      canonical_size: float = 224.0, canonical_level: int = 4):
    '''FPN level per (N, 4) ROI: floor(canonical + log2(sqrt(area)/224)) clamped.'''
    area = torch.clamp(boxes[:, 2] - boxes[:, 0], min=0) * \
        torch.clamp(boxes[:, 3] - boxes[:, 1], min=0)
    sqrt_area = torch.sqrt(torch.clamp(area, min=1e-6))
    lvl = torch.floor(canonical_level + torch.log2(sqrt_area / canonical_size + 1e-8))
    return torch.clamp(lvl, min_level, max_level).to(torch.int32)


def _roi_sample_coords(boxes, output_size: int, strides):
    '''Half-pixel sample coords at 2x resolution in each ROI's level units:
    (ys, xs) of shape (N, 2*out).'''
    s = output_size * 2
    frac = (torch.arange(s, dtype=torch.float32, device=boxes.device) + 0.5) / s
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    xs_img = x1[:, None] + (x2 - x1)[:, None] * frac[None, :]
    ys_img = y1[:, None] + (y2 - y1)[:, None] * frac[None, :]
    xs = xs_img / strides[:, None] - 0.5
    ys = ys_img / strides[:, None] - 0.5
    return ys, xs


def _fold_interp_weights(coords, sizes, max_size: int,
                         offsets: Optional[torch.Tensor] = None):
    '''Per-ROI folded interpolation weights (N, out, max_size) f32.

    Two-tap bilinear rows for all 2*out samples (clamped into [0, size-1]),
    averaged pairwise: ``W @ f`` is the 2-sample average of the bilinear
    samples of f along this axis. ``offsets`` shifts the taps into a
    level's band of a stacked buffer.
    '''
    cs = torch.minimum(torch.clamp(coords, min=0.0),
                       (sizes - 1).to(torch.float32)[:, None])
    c0 = torch.floor(cs)
    frac = cs - c0
    c0i = c0.to(torch.int64)
    c1i = torch.minimum(c0i + 1, (sizes - 1).to(torch.int64)[:, None])
    if offsets is not None:
        c0i = c0i + offsets.to(torch.int64)[:, None]
        c1i = c1i + offsets.to(torch.int64)[:, None]
    iota = torch.arange(max_size, device=coords.device)
    w2 = ((c0i[..., None] == iota) * (1.0 - frac)[..., None]
          + (c1i[..., None] == iota) * frac[..., None])
    return 0.5 * (w2[:, 0::2] + w2[:, 1::2])


def _separable_inputs(features: Sequence[torch.Tensor], boxes, output_size: int,
                      min_level: int):
    '''The H-stacked, W-padded pyramid (B, sum_l H_l, Wmax, C) f32 and the
    folded weights Wy (B, K, out, sum_l H_l), Wx (B, K, out, Wmax) f32.'''
    b, k = boxes.shape[:2]
    n_levels = len(features)
    heights = [f.shape[1] for f in features]
    widths = [f.shape[2] for f in features]
    wmax = max(widths)
    h_total = sum(heights)
    dev = boxes.device

    f_stack = torch.cat([F.pad(f.float(), (0, 0, 0, wmax - f.shape[2]))
                         for f in features], dim=1)

    flat_boxes = boxes.reshape(b * k, 4).float()
    levels = assign_fpn_levels(flat_boxes, min_level=min_level,
                               max_level=min_level + n_levels - 1)
    level_idx = (levels - min_level).long()
    stride_table = torch.tensor([2.0 ** (min_level + i) for i in range(n_levels)],
                                dtype=torch.float32, device=dev)
    ys, xs = _roi_sample_coords(flat_boxes, output_size, stride_table[level_idx])

    h_arr = torch.tensor(heights, dtype=torch.int64, device=dev)
    w_arr = torch.tensor(widths, dtype=torch.int64, device=dev)
    h_off = torch.cumsum(h_arr, 0) - h_arr
    wy = _fold_interp_weights(ys, h_arr[level_idx], h_total,
                              offsets=h_off[level_idx])
    wx = _fold_interp_weights(xs, w_arr[level_idx], wmax)
    return (f_stack,
            wy.reshape(b, k, output_size, h_total),
            wx.reshape(b, k, output_size, wmax))


def separable_batched_roi_align(features: Sequence[torch.Tensor], boxes,
                                output_size: int, min_level: int = 2,
                                out_dtype: Optional[torch.dtype] = None):
    '''Pool (B, K, 4) boxes over batched NHWC levels (B, H_l, W_l, C) ->
    (B, K, out, out, C) in ``out_dtype`` (default: the features' dtype).'''
    if out_dtype is None:
        out_dtype = features[0].dtype
    f_stack, wy, wx = _separable_inputs(features, boxes, output_size, min_level)
    t = torch.einsum('bkyh,bhwc->bkywc', wy, f_stack)
    out = torch.einsum('bkxw,bkywc->bkyxc', wx, t)
    return out.to(out_dtype)
