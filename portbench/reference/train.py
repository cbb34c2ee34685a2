'''Plain float32 training steps of the Keypoint + Mask R-CNN: Detectron2's
losses (RPN objectness and boxes over 256 sampled anchors an image, the box
head's classification and smooth-L1 regression over 256 sampled ROIs an
image, the mask head's per-pixel BCE and the keypoint head's softmax
cross-entropy over the positive ROIs), backward, then the solver: non-finite
gradient values set to 0, clipping by the global norm, SGD with momentum
and weight decay under warm-up and multi-step decay.

A step takes its batch as the training step receives it (the augmented,
normalised images and their ground truth) and the step's random
priorities for the two samplers (uniforms, one pair per image and
candidate: the higher wins). Imports nothing of the program.
'''
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.detector import (Detector, anchors_for, encode, iou, ranked_desc,
                                          roi_align)

FROZEN = ('FrozenBatchNorm',)


def trainable(key: str) -> bool:
    '''Whether a flax-layout parameter is trained (FrozenBN statistics are not).'''
    return not any(f in key for f in FROZEN)


def sample(labels, n: int, fraction: float, u_pos, u_neg) -> Tuple[torch.Tensor, torch.Tensor]:
    '''Balanced sampling of (B, A) labels (1 fg, 0 bg, -1 ignore): up to
    n * fraction foreground by ``u_pos``, background by ``u_neg`` filling
    to n. Returns (positive mask, negative mask), each (B, A).'''
    cap = int(n * fraction)
    inf = torch.full_like(u_pos, -float('inf'))
    pv, pi = ranked_desc(torch.where(labels == 1, u_pos, inf))
    pos_ok = torch.isfinite(pv[:, :cap])
    n_pos = pos_ok.sum(1, keepdim=True)
    nv, ni = ranked_desc(torch.where(labels == 0, u_neg, inf))
    slot = torch.arange(n, device=labels.device)
    neg_ok = torch.isfinite(nv[:, :n]) & (slot < n - n_pos)
    pos = torch.zeros_like(labels, dtype=torch.bool).scatter(1, pi[:, :cap], pos_ok)
    neg = torch.zeros_like(labels, dtype=torch.bool).scatter(1, ni[:, :n], neg_ok)
    return pos, neg


def bce(logits, target):
    return logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def smooth_l1(d, beta):
    a = d.abs()
    return a if beta <= 0 else torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def mask_targets(masks, gt_idx, boxes, m: int):
    '''(B, R, m, m) bilinear crops of the gt masks at the ROIs, one sample a
    bin at half-pixel positions, clamped into the image.'''
    b, _, h, w = masks.shape
    frac = (torch.arange(m, dtype=torch.float32, device=boxes.device) + 0.5) / m
    xs = (boxes[..., 0:1] + (boxes[..., 2:3] - boxes[..., 0:1]) * frac - 0.5).clamp(0, w - 1)
    ys = (boxes[..., 1:2] + (boxes[..., 3:4] - boxes[..., 1:2]) * frac - 0.5).clamp(0, h - 1)
    x0, y0 = xs.floor().long(), ys.floor().long()
    fx, fy = xs - x0, ys - y0
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    bi = torch.arange(b, device=boxes.device)[:, None, None, None]
    gi = gt_idx[..., None, None]
    mk = masks.float()

    def at(yy, xx):
        return mk[bi, gi, yy[..., :, None], xx[..., None, :]]

    top = at(y0, x0) * (1 - fx)[..., None, :] + at(y0, x1) * fx[..., None, :]
    bot = at(y1, x0) * (1 - fx)[..., None, :] + at(y1, x1) * fx[..., None, :]
    return top * (1 - fy)[..., :, None] + bot * fy[..., :, None]


def train_proposals(det: Detector, sides, logits, deltas, canvas: int):
    '''The training proposals (no cap) of the RPN's outputs on the canvas.'''
    b = logits[0].shape[0]
    hw = torch.tensor([[canvas, canvas]], dtype=torch.float32,
                      device=logits[0].device).repeat(b, 1)
    with torch.no_grad():
        return det.proposals(sides, [x.detach().float() for x in logits],
                             [x.detach().float() for x in deltas], hw, train=True)


def step_losses(det: Detector, images, gt: Dict, draws: Dict,
                proposals=None) -> Dict[str, torch.Tensor]:
    '''The five losses of one training batch. ``proposals`` (boxes,
    valid), when given, stand in for the step's own: the ROI heads then
    sample the same candidates as the run they follow.'''
    cfg = det.cfg
    b, _, s, _ = images.shape
    levels = det.fpn(det.backbone(images))
    logits, deltas = det.rpn(levels)
    if proposals is None:
        proposals = train_proposals(det, [f.shape[-1] for f in levels], logits, deltas, s)
    props, pvalid = proposals
    out = {}

    # RPN: anchors matched to the gt, sampled, scored
    anchors = torch.cat(anchors_for([f.shape[-1] for f in levels], cfg, images.device))
    lg, dl = torch.cat(logits, 1).float(), torch.cat(deltas, 1).float()
    gb, gv = gt['boxes'], gt['valid']
    ov = torch.where(gv[:, None, :], iou(anchors[None].expand(b, -1, -1), gb),
                     torch.full((b, anchors.shape[0], gb.shape[1]), -1.0, device=gb.device))
    best, midx = ov.max(-1)
    labels = torch.full_like(midx, -1)
    labels = torch.where(best < cfg['rpn_bg_iou_thresh'], torch.zeros_like(labels), labels)
    labels = torch.where(best >= cfg['rpn_fg_iou_thresh'], torch.ones_like(labels), labels)
    per_gt = ov.amax(1, keepdim=True)
    low_quality = ((ov == per_gt) & gv[:, None, :] & (per_gt > 0)).any(-1)
    labels = torch.where(low_quality, torch.ones_like(labels), labels)
    labels = torch.where(gv.any(-1, keepdim=True), labels, torch.zeros_like(labels))
    pos, neg = sample(labels, cfg['rpn_batch_size_per_image'], cfg['rpn_positive_fraction'],
                      *draws['rpn'])
    obj = bce(lg, pos.float())
    matched = torch.gather(gb, 1, midx[..., None].expand(-1, -1, 4))
    reg = smooth_l1(dl - encode(anchors[None].expand(b, -1, -1), matched,
                                cfg['rpn_box_reg_weights']), cfg['rpn_smooth_l1_beta'])
    norm = cfg['rpn_batch_size_per_image'] * b
    out['loss_rpn_cls'] = torch.where(pos | neg, obj, torch.zeros_like(obj)).sum() / norm
    out['loss_rpn_loc'] = torch.where(pos[..., None], reg, torch.zeros_like(reg)).sum() / norm

    # ROI sampling: proposals with the gt appended
    cand = torch.cat([props, gb], 1)
    cvalid = torch.cat([pvalid, gv], 1)
    ov = iou(cand, gb)
    ov = torch.where(gv[:, None, :] & cvalid[:, :, None], ov, torch.full_like(ov, -1.0))
    best, midx = ov.max(-1)
    labels = torch.where(cvalid, (best >= cfg['roi_fg_iou_thresh']).long(),
                         torch.full_like(midx, -1))
    pos, neg = sample(labels, cfg['roi_batch_size_per_image'], cfg['roi_positive_fraction'],
                      *draws['roi'])
    keep = pos | neg
    bi, ri = torch.nonzero(keep, as_tuple=True)
    rois = cand[bi, ri]
    is_pos = pos[bi, ri]
    gidx = midx[bi, ri]
    gbox = gb[bi, gidx]
    n_sampled = max(int(keep.sum()), 1)
    n_pos = max(int(pos.sum()), 1)
    lv = [f for f in levels[:4]]

    def pool(res, which):
        # the ROIs of image i pooled on its own levels, in ROI order
        out_rois = []
        for i in range(b):
            sel = (bi == i) & which
            if bool(sel.any()):
                out_rois.append(roi_align([f[i:i + 1] for f in lv], rois[sel][None], res)[0])
        return torch.cat(out_rois)

    everyone = torch.ones_like(is_pos)
    pooled = pool(cfg['box_pooler_resolution'], everyone)
    cls, breg = (x.float() for x in det.box_head(pooled))
    target = torch.where(is_pos, 0, cfg['num_classes'])
    out['loss_cls'] = F.cross_entropy(cls, target, reduction='sum') / n_sampled
    d = smooth_l1(breg - encode(rois, gbox, cfg['box_reg_weights']), cfg['box_smooth_l1_beta'])
    out['loss_box_reg'] = d[is_pos].sum() / n_sampled

    # the mask and keypoint heads see the positive ROIs only
    m = cfg['mask_resolution']
    mlog = det.mask_head(pool(cfg['mask_pooler_resolution'], is_pos)).float()
    mt = mask_targets(gt['masks'], midx, cand, m)[bi[is_pos], ri[is_pos]] >= 0.5
    out['loss_mask'] = bce(mlog, mt.float()).sum() / (n_pos * m * m)

    heat = det.keypoint_head(pool(cfg['keypoint_pooler_resolution'], is_pos)).float()  # (N, K, hs, hs)
    n, k, hs, _ = heat.shape
    proi = rois[is_pos]
    kp = gt['keypoints'][bi[is_pos], gidx[is_pos]]                         # (N, K, 3)
    w = (proi[:, 2:3] - proi[:, 0:1]).clamp(min=1e-3)
    h = (proi[:, 3:4] - proi[:, 1:2]).clamp(min=1e-3)
    x = (kp[..., 0] - proi[:, 0:1]) * (hs / w)
    y = (kp[..., 1] - proi[:, 1:2]) * (hs / h)
    inside = (x >= 0) & (x < hs) & (y >= 0) & (y < hs) & (kp[..., 2] > 0)
    bins = y.floor().long().clamp(0, hs - 1) * hs + x.floor().long().clamp(0, hs - 1)
    logp = torch.log_softmax(heat.reshape(n, k, hs * hs), -1)
    ce = -torch.gather(logp, -1, bins[..., None])[..., 0]
    out['loss_keypoint'] = ce[inside].sum() / max(int(inside.sum()), 1)
    out['total_loss'] = sum(out.values())
    return out


def lr_at(cfg: Dict, step: int) -> float:
    '''Warm-up then multi-step decay, in float32.'''
    f = np.float32
    lr = f(cfg['base_lr'])
    for boundary in cfg['lr_steps']:
        if step >= boundary:
            lr = f(lr * f(cfg['lr_gamma']))
    warm = min(f(step) / f(max(cfg['warmup_iters'], 1)), f(1.0))
    return float(f(lr * (f(cfg['warmup_factor']) + f(1.0 - cfg['warmup_factor']) * warm)))


class Solver:
    '''The reference's own parameters, momentum and step count.'''

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict):
        self.cfg = cfg
        self.params = {k: v.clone().requires_grad_(trainable(k)) for k, v in params.items()}
        self.momentum = {}
        self.step = 0

    def run(self, batch: Dict, quant=None) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
        '''One step on ``batch``; returns its losses and the clipped
        gradients the update used.'''
        det = Detector(self.params, self.cfg, quant=quant)
        images = batch['images']
        # quant 'bf16': convolutions and matmuls under bfloat16 autocast, as
        # mixed-precision training runs them; the losses stay in float32
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=quant == 'bf16'):
            losses = step_losses(det, images, batch['gt'], batch['draws'],
                                 batch.get('proposals'))
        keys = [k for k, v in self.params.items() if v.requires_grad]
        grads = torch.autograd.grad(losses['total_loss'], [self.params[k] for k in keys],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(self.params[k]) if g is None else
                     torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0))
                 for k, g in zip(keys, grads)}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = self.cfg['grad_clip_norm']
        if clip and float(norm) >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        lr = lr_at(self.cfg, self.step)
        with torch.no_grad():
            for k, g in grads.items():
                p = self.params[k]
                d = g + self.cfg['weight_decay'] * p
                buf = self.momentum.get(k)
                buf = d.clone() if buf is None else buf * self.cfg['momentum'] + d
                self.momentum[k] = buf
                p -= lr * buf
        self.step += 1
        return {k: float(v.detach()) for k, v in losses.items()}, grads
