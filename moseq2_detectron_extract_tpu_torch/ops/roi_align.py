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
the kernel is held against on the card.

Rounding. On bf16 features it rounds as the JAX package's inference pooling
does (``separable_batched_roi_align`` on bf16 levels, and the Pallas kernel):
the weights are folded in f32 and rounded to bf16, stage 1 sums in f32 and
rounds T to bf16, stage 2 sums in f32 and the output is rounded once to
``out_dtype``. Every product of two bf16 values is exact in f32, so only the
order of the f32 sums differs from XLA's. On f32 features everything stays
f32 (the stage-2 experiment).

Training pools in f32 through the gather form instead
(``roi_align.py:63-241``, :func:`batched_multilevel_roi_align`): the levels
flattened into one (sum of B*H_l*W_l, C) buffer, four bilinear taps
gathered per sample, in chunks of 128 ROIs. It is differentiable with
respect to the features; its backward scatters the taps' weighted
gradients back with ``index_add_``, chunk by chunk, so it stores no
chunk's taps (the JAX package remats each chunk for the same reason). On
CUDA ``index_add_`` accumulates with atomics, so the card's feature
gradients are not bitwise repeatable. ``roi_align_level`` (``roi_align.py:392``)
pools one level through it.
'''
import math
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


def _separable_weights(heights: Sequence[int], widths: Sequence[int], boxes,
                       output_size: int, min_level: int, h_size: Optional[int] = None,
                       w_size: Optional[int] = None):
    '''The folded weights Wy (B, K, out, h_size) over the H-stacked levels
    (taps offset into the ROI's level band) and Wx (B, K, out, w_size), f32.
    ``h_size`` and ``w_size`` default to sum_l H_l and max_l W_l; larger
    sizes add zero columns.'''
    b, k = boxes.shape[:2]
    n_levels = len(heights)
    h_size = h_size or sum(heights)
    w_size = w_size or max(widths)
    dev = boxes.device
    flat_boxes = boxes.reshape(b * k, 4).float()
    levels = assign_fpn_levels(flat_boxes, min_level=min_level,
                               max_level=min_level + n_levels - 1)
    level_idx = (levels - min_level).long()
    stride_table = torch.tensor([2.0 ** (min_level + i) for i in range(n_levels)],
                                dtype=torch.float32, device=dev)
    ys, xs = _roi_sample_coords(flat_boxes, output_size, stride_table[level_idx])

    h_arr = torch.tensor(list(heights), dtype=torch.int64, device=dev)
    w_arr = torch.tensor(list(widths), dtype=torch.int64, device=dev)
    h_off = torch.cumsum(h_arr, 0) - h_arr
    wy = _fold_interp_weights(ys, h_arr[level_idx], h_size,
                              offsets=h_off[level_idx])
    wx = _fold_interp_weights(xs, w_arr[level_idx], w_size)
    return (wy.reshape(b, k, output_size, h_size),
            wx.reshape(b, k, output_size, w_size))


def _separable_inputs(features: Sequence[torch.Tensor], boxes, output_size: int,
                      min_level: int, as_dtype: Optional[torch.dtype] = None):
    '''The H-stacked, W-padded pyramid (B, sum_l H_l, Wmax, C) and the
    folded weights Wy (B, K, out, sum_l H_l), Wx (B, K, out, Wmax).

    All three are f32 by default. With ``as_dtype`` the pyramid stays in
    that dtype and the weights are computed in f32 and rounded to it, as the
    JAX package's ``_separable_inputs`` returns them in the feature dtype.'''
    heights = [f.shape[1] for f in features]
    widths = [f.shape[2] for f in features]
    wmax = max(widths)
    f_stack = torch.cat([F.pad(f.to(as_dtype or torch.float32), (0, 0, 0, wmax - f.shape[2]))
                         for f in features], dim=1)
    wy, wx = _separable_weights(heights, widths, boxes, output_size, min_level)
    if as_dtype is not None:
        wy, wx = wy.to(as_dtype), wx.to(as_dtype)
    return f_stack, wy, wx


def separable_batched_roi_align(features: Sequence[torch.Tensor], boxes,
                                output_size: int, min_level: int = 2,
                                out_dtype: Optional[torch.dtype] = None):
    '''Pool (B, K, 4) boxes over batched NHWC levels (B, H_l, W_l, C) ->
    (B, K, out, out, C) in ``out_dtype`` (default: the features' dtype),
    with bf16 weights and a bf16 T when the levels are bf16.'''
    if out_dtype is None:
        out_dtype = features[0].dtype
    if features[0].dtype == torch.bfloat16:
        f_stack, wy, wx = (x.float() for x in _separable_inputs(
            features, boxes, output_size, min_level, as_dtype=torch.bfloat16))
        t = torch.einsum('bkyh,bhwc->bkywc', wy, f_stack).to(torch.bfloat16).float()
    else:
        f_stack, wy, wx = _separable_inputs(features, boxes, output_size, min_level)
        t = torch.einsum('bkyh,bhwc->bkywc', wy, f_stack)
    out = torch.einsum('bkxw,bkywc->bkyxc', wx, t)
    return out.to(out_dtype)


# -- the gather form (training) ------------------------------------------------

def _gather_taps(boxes, image_offsets, level_offsets, heights, widths,
                 output_size: int, min_level: int, n_levels: int):
    '''Per ROI: the flat row offsets of its level, the clamped tap rows and
    columns (y0, y1, x0, x1) and the fractions (fy, fx), each (K, 2*out).'''
    dev = boxes.device
    levels = assign_fpn_levels(boxes, min_level=min_level,
                               max_level=min_level + n_levels - 1)
    level_idx = (levels - min_level).long()
    stride_table = torch.tensor([2.0 ** (min_level + i) for i in range(n_levels)],
                                dtype=torch.float32, device=dev)
    ys, xs = _roi_sample_coords(boxes, output_size, stride_table[level_idx])
    roi_off = image_offsets + level_offsets[level_idx]
    roi_h = heights[level_idx]
    roi_w = widths[level_idx]
    ys = torch.minimum(torch.clamp(ys, min=0.0), (roi_h - 1).to(torch.float32)[:, None])
    xs = torch.minimum(torch.clamp(xs, min=0.0), (roi_w - 1).to(torch.float32)[:, None])
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0 = y0.long()
    x0 = x0.long()
    y1 = torch.minimum(y0 + 1, (roi_h - 1)[:, None])
    x1 = torch.minimum(x0 + 1, (roi_w - 1)[:, None])
    return roi_off, roi_w, y0, y1, x0, x1, fy, fx


def _chunk_index(taps, lo: int, hi: int):
    '''The flat rows of the four taps of ROIs [lo, hi): each (n, S, S).'''
    roi_off, roi_w, y0, y1, x0, x1, _, _ = taps
    off = roi_off[lo:hi, None, None]
    w = roi_w[lo:hi, None, None]
    return [off + yy[lo:hi, :, None] * w + xx[lo:hi, None, :]
            for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]


class _GatherPool(torch.autograd.Function):
    '''Chunked bilinear gather-and-average over the flat pyramid.'''

    @staticmethod
    def forward(ctx, flat, taps, output_size: int, chunk: int):
        fy, fx = taps[6], taps[7]
        k = fy.shape[0]
        c = flat.shape[1]
        out = flat.new_empty((k, output_size, output_size, c))
        for lo in range(0, k, chunk):
            hi = min(lo + chunk, k)
            i00, i01, i10, i11 = _chunk_index(taps, lo, hi)
            wy = fy[lo:hi, :, None, None]
            wx = fx[lo:hi, None, :, None]
            vals = ((flat[i00] * (1 - wx) + flat[i01] * wx) * (1 - wy)
                    + (flat[i10] * (1 - wx) + flat[i11] * wx) * wy)
            out[lo:hi] = vals.reshape(hi - lo, output_size, 2, output_size, 2, c) \
                .mean(dim=(2, 4))
        ctx.taps = taps
        ctx.flat_shape = flat.shape
        ctx.output_size = output_size
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, grad_out):
        taps, out, chunk = ctx.taps, ctx.output_size, ctx.chunk
        fy, fx = taps[6], taps[7]
        k = fy.shape[0]
        c = ctx.flat_shape[1]
        grad_flat = grad_out.new_zeros(ctx.flat_shape)
        for lo in range(0, k, chunk):
            hi = min(lo + chunk, k)
            g = grad_out[lo:hi]
            # the mean's gradient on each of the 2x2 samples of an output bin
            g = (g[:, :, None, :, None, :] * 0.25).expand(
                -1, -1, 2, -1, 2, -1).reshape(hi - lo, 2 * out, 2 * out, c)
            wy = fy[lo:hi, :, None, None]
            wx = fx[lo:hi, None, :, None]
            gy0 = g * (1 - wy)
            gy1 = g * wy
            for idx, gt in zip(_chunk_index(taps, lo, hi),
                               (gy0 * (1 - wx), gy0 * wx, gy1 * (1 - wx), gy1 * wx)):
                grad_flat.index_add_(0, idx.reshape(-1), gt.reshape(-1, c))
        return grad_flat, None, None, None


def _pool_from_flat(flat, boxes, image_offsets, level_offsets, heights, widths,
                    output_size: int, min_level: int, n_levels: int, chunk: int):
    '''Pool (K, 4) boxes from the flat (rows, C) pyramid -> (K, out, out, C).'''
    taps = _gather_taps(boxes, image_offsets, level_offsets, heights, widths,
                        output_size, min_level, n_levels)
    return _GatherPool.apply(flat, taps, output_size, chunk)


def _level_tables(features, dev):
    sizes = [f.shape[-3] * f.shape[-2] for f in features]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                           dtype=torch.int64, device=dev)
    heights = torch.tensor([f.shape[-3] for f in features], dtype=torch.int64, device=dev)
    widths = torch.tensor([f.shape[-2] for f in features], dtype=torch.int64, device=dev)
    return sum(sizes), offsets, heights, widths


def multilevel_roi_align(features: Sequence[torch.Tensor], boxes, output_size: int,
                         min_level: int = 2, chunk: int = 128):
    '''Pool (K, 4) boxes from one image's NHWC levels (H_l, W_l, C) ->
    (K, out, out, C), f32, differentiable in the features.'''
    return batched_multilevel_roi_align([f[None] for f in features], boxes[None],
                                        output_size, min_level, chunk)[0]


def batched_multilevel_roi_align(features: Sequence[torch.Tensor], boxes,
                                 output_size: int, min_level: int = 2,
                                 chunk: int = 128):
    '''Pool (B, K, 4) boxes from batched NHWC levels (B, H_l, W_l, C) ->
    (B, K, out, out, C) in the features' dtype, differentiable in the
    features (not in the boxes). The batch folds into the flat buffer
    (image-major, level-minor), so memory is bounded by ``chunk`` ROIs.'''
    b, k = boxes.shape[:2]
    c = features[0].shape[-1]
    dev = boxes.device
    per_image, offsets, heights, widths = _level_tables(features, dev)
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1).reshape(-1, c)
    image_offsets = torch.arange(b, dtype=torch.int64, device=dev).repeat_interleave(k) \
        * per_image
    pooled = _pool_from_flat(flat, boxes.reshape(b * k, 4).detach().float(), image_offsets,
                             offsets, heights, widths, output_size, min_level,
                             len(features), chunk)
    return pooled.reshape(b, k, output_size, output_size, c)


def roi_align_level(feat, boxes, output_size: int, stride: float):
    '''ROIAlign of (K, 4) boxes (image coordinates) on one (H, W, C) level
    of ``stride`` -> (K, out, out, C) in ``feat``'s dtype.'''
    min_level = int(round(math.log2(stride))) if stride >= 1 else 0
    return multilevel_roi_align((feat,), boxes, output_size, min_level=min_level,
                                chunk=min(128, max(boxes.shape[0], 1)))


def crop_resize_masks(masks, gt_idx, boxes, output_size: int):
    '''Bilinear crops of gt masks at boxes, ROIAlignV2's grid with one
    sample per bin: masks (B, G, H, W), gt_idx (B, R) the mask of each box,
    boxes (B, R, 4) -> (B, R, out, out) f32 (the mask-loss targets).'''
    b, _, h, w = masks.shape
    frac = (torch.arange(output_size, dtype=torch.float32, device=boxes.device) + 0.5) \
        / output_size
    xs = boxes[..., 0, None] + (boxes[..., 2] - boxes[..., 0])[..., None] * frac - 0.5
    ys = boxes[..., 1, None] + (boxes[..., 3] - boxes[..., 1])[..., None] * frac - 0.5
    xs = torch.clamp(xs, 0.0, w - 1.0)
    ys = torch.clamp(ys, 0.0, h - 1.0)
    x0 = torch.floor(xs).long()
    y0 = torch.floor(ys).long()
    fx = xs - x0
    fy = ys - y0
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    bi = torch.arange(b, device=boxes.device)[:, None, None, None]
    gi = gt_idx[..., None, None]
    m = masks.to(torch.float32)

    def tap(yy, xx):
        return m[bi, gi, yy[..., :, None], xx[..., None, :]]

    top = tap(y0, x0) * (1 - fx)[..., None, :] + tap(y0, x1) * fx[..., None, :]
    bot = tap(y1, x0) * (1 - fx)[..., None, :] + tap(y1, x1) * fx[..., None, :]
    return top * (1 - fy)[..., :, None] + bot * fy[..., :, None]


def crop_resize_mask(mask, box, output_size: int):
    '''One (H, W) mask cropped at one (4,) box -> (out, out) f32.'''
    return crop_resize_masks(mask[None, None], torch.zeros((1, 1), dtype=torch.int64,
                                                           device=box.device),
                             box[None, None], output_size)[0, 0]
