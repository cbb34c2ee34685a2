'''Operations and bytes from shapes: the model's FLOPs, and the bytes that
the ROIAlign and clean kernels need to move.

FLOPs count the multiply-adds of convolutions and dense layers, two
operations each, at the shapes the configuration gives; normalisation,
activations, pooling and the box arithmetic are left out (they are under
1% of the convolutions here). The count is the model's work, whatever
implements it.
'''
import math
from typing import Dict, Sequence

import torch


def _half(side: int) -> int:
    return math.ceil(side / 2)


def conv_macs(side_out: int, k: int, c_in: int, c_out: int) -> int:
    '''Multiply-adds of a k x k convolution with a square output.'''
    return side_out * side_out * k * k * c_in * c_out


def backbone_fpn_rpn_flops(cfg: Dict) -> int:
    '''FLOPs of one image through ResNet, the FPN and the RPN head on the
    square canvas (the whole canvas is computed, padding included).'''
    s = cfg['image_size']
    w = cfg['resnet_width']
    blocks = cfg.get('resnet_stage_blocks') or {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[
        cfg['resnet_depth']]
    side = _half(s)
    macs = conv_macs(side, 7, 3, w)
    side = _half(side)                                   # max pool
    c_in = w
    sides, chans = [], []
    for stage, n in enumerate(blocks):
        mid, out = w * 2 ** stage, w * 4 * 2 ** stage
        for block in range(n):
            if block == 0 and stage > 0:
                side = _half(side)
            if c_in != out or (block == 0 and stage > 0):
                macs += conv_macs(side, 1, c_in, out)
            macs += conv_macs(side, 1, c_in, mid) + conv_macs(side, 3, mid, mid) + \
                conv_macs(side, 1, mid, out)
            c_in = out
        sides.append(side)
        chans.append(out)
    f = cfg['fpn_channels']
    for side, c in zip(sides, chans):
        macs += conv_macs(side, 1, c, f) + conv_macs(side, 3, f, f)
    a = len(cfg['anchor_sizes'][0]) * len(cfg['anchor_aspect_ratios'])
    for side in sides + [_half(sides[-1])]:
        macs += conv_macs(side, 3, f, f) + conv_macs(side, 1, f, a) + conv_macs(side, 1, f, 4 * a)
    return 2 * macs


def head_flops(cfg: Dict, box_rois: int, mask_rois: int, keypoint_rois: int) -> int:
    '''FLOPs of the box, mask and keypoint heads on that many ROIs.'''
    f = cfg['fpn_channels']
    r = cfg['box_pooler_resolution']
    fc = cfg['box_fc_dim']
    box = r * r * f * fc + fc * fc + fc * (cfg['num_classes'] + 1) + fc * 4 * cfg['num_classes']
    m = cfg['mask_pooler_resolution']
    mask, c = 0, f
    for dim in cfg['mask_conv_dims']:
        mask += conv_macs(m, 3, c, dim)
        c = dim
    mask += m * m * 4 * c * c + conv_macs(2 * m, 1, c, cfg['num_classes'])
    k = cfg['keypoint_pooler_resolution']
    kp, c = 0, f
    for dim in cfg['keypoint_conv_dims']:
        kp += conv_macs(k, 3, c, dim)
        c = dim
    kp += k * k * 16 * c * cfg['num_keypoints']
    return 2 * (box * box_rois + mask * mask_rois + kp * keypoint_rois)


def inference_flops_per_image(cfg: Dict) -> int:
    '''One frame through detection: the box head on every post-NMS
    proposal slot, the mask and keypoint heads on every detection slot.'''
    d = cfg['test_detections_per_image']
    return backbone_fpn_rpn_flops(cfg) + head_flops(cfg, cfg['rpn_post_nms_topk_test'], d, d)


def train_flops_per_image(cfg: Dict) -> int:
    '''One image of a training step: forward and backward (3x the forward),
    the box head on the sampled ROIs of the image, the mask and keypoint
    heads on its foreground share of them (Detectron2 runs them on the
    positive ROIs only; the share is the sampler's cap, which a scene with
    a mouse in view fills).'''
    r = cfg['roi_batch_size_per_image']
    fg = int(r * cfg['roi_positive_fraction'])
    return 3 * (backbone_fpn_rpn_flops(cfg) + head_flops(cfg, r, fg, fg))


def roi_align_bytes(level_shapes: Sequence[Sequence[int]], boxes: torch.Tensor, out: int,
                    elem_bytes: int = 2) -> int:
    '''Least bytes one ROIAlign call moves: each level pixel (all C
    channels) that some sample of some box reads, once; the boxes; the
    output. ``level_shapes`` (B, C, H, W) per level P2..P5; ``boxes``
    (B, K, 4) f32 in canvas pixels. The taps follow ROIAlignV2 with 2x2
    samples a bin clamped into the level.'''
    b, k = boxes.shape[:2]
    c = level_shapes[0][1]
    flat = boxes.reshape(-1, 4).float()
    area = (flat[:, 2] - flat[:, 0]).clamp(min=0) * (flat[:, 3] - flat[:, 1]).clamp(min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area.clamp(min=1e-6)) / 224.0 + 1e-8))
    lvl = lvl.clamp(2, 5).long() - 2
    img = torch.arange(b, device=boxes.device).repeat_interleave(k)
    frac = (torch.arange(2 * out, dtype=torch.float32, device=boxes.device) + 0.5) / (2 * out)
    touched = 0
    for li, shape in enumerate(level_shapes):
        sel = lvl == li
        if not bool(sel.any()):
            continue
        h, w = shape[2], shape[3]
        bx = flat[sel]
        stride = 2.0 ** (li + 2)
        xs = ((bx[:, 0:1] + (bx[:, 2:3] - bx[:, 0:1]) * frac) / stride - 0.5).clamp(0, w - 1)
        ys = ((bx[:, 1:2] + (bx[:, 3:4] - bx[:, 1:2]) * frac) / stride - 0.5).clamp(0, h - 1)
        cols = torch.cat([xs.floor(), (xs.floor() + 1).clamp(max=w - 1)], 1).long()
        rows = torch.cat([ys.floor(), (ys.floor() + 1).clamp(max=h - 1)], 1).long()
        grid = torch.zeros((b, h, w), dtype=torch.bool, device=boxes.device)
        n = bx.shape[0]
        ii = img[sel][:, None, None].expand(n, rows.shape[1], cols.shape[1])
        grid[ii, rows[:, :, None].expand_as(ii), cols[:, None, :].expand_as(ii)] = True
        touched += int(grid.sum())
    return touched * c * elem_bytes + b * k * 4 * 4 + b * k * out * out * c * elem_bytes


def clean_bytes(frames: int, side: int) -> int:
    '''Least bytes one clean call moves: each uint8 window pixel read once
    and written once.'''
    return 2 * frames * side * side
