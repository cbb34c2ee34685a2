'''Plain float32 R50-FPN Keypoint + Mask R-CNN, read straight from a
``params_f16.npz`` (flax layout: conv kernels HWIO, dense kernels (in, out),
FrozenBN scale/bias/mean/var, GroupNorm scale/bias).

This is the benchmark's yardstick for detection and training. It imports
nothing of the program: every step is written out here in plain PyTorch,
after the published Detectron2 model (``keypoint_rcnn_R_50_FPN_3x`` with
GroupNorm in the FPN and a mask head) and the conventions the port states
for it:

* the frame is resized by ResizeShortestEdge with a triangle (linear,
  antialiased on a downscale) filter and padded at the bottom and right to
  the square canvas;
* the FPN fuses by averaging, upsamples nearest, and P6 is P5 subsampled;
* proposals: per level the top-k logits, decoded, clipped, non-empty, the
  global top ``cap`` of them, greedy NMS within each level, the top
  ``post_k`` survivors; training takes no cap;
* ROIAlignV2 (aligned, 2x2 samples a bin, samples clamped into the level)
  with the FPN level floor(4 + log2(sqrt(area) / 224)) in [2, 5];
* test-time: softmax scores over 0.5, NMS at 0.5, the best detection;
  masks pasted by triangle weights and thresholded at 0.5; keypoints at
  the centre of each heatmap's argmax bin.

``quant='fp8'`` rounds the input and the weight of every convolution and
dense layer to float8 e4m3 with a per-tensor scale, and the gradients
that flow back through them to e5m2: the control that a check must
reject. TF32 stays off while the reference runs.
'''
import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STRIDES = (4, 8, 16, 32, 64)
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


@contextmanager
def full_float32():
    '''TF32 off for matmuls and convolutions while the block runs.'''
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def load_npz(path: str, device) -> Dict[str, torch.Tensor]:
    '''The npz's arrays as float32 tensors on ``device``, keys without the
    leading ``params/``.'''
    with np.load(path) as flat:
        return {k.split('/', 1)[1] if k.startswith('params/') else k:
                torch.from_numpy(flat[k].astype(np.float32)).to(device) for k in flat.files}


def _fp8_round(x: torch.Tensor, kind, largest: float) -> torch.Tensor:
    '''``x`` through the float8 ``kind`` and back, scaled so that its largest
    magnitude maps to the format's largest value.'''
    scale = x.abs().amax().clamp(min=1e-12) / largest
    return (x / scale).to(kind).to(x.dtype) * scale


class _FakeFP8(torch.autograd.Function):
    '''Float8 training's rounding: e4m3 on the way forward, e5m2 on the
    gradient on the way back.'''

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _fp8_round(grad, torch.float8_e5m2, FP8_E5M2_MAX)


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    '''``x`` rounded to float8 e4m3 with a per-tensor scale; its gradient
    rounded to float8 e5m2 the same way, so that a training step's
    backward pass runs one precision down too.'''
    return _FakeFP8.apply(x)


class Weights:
    '''Named access to the flax-layout parameters, optionally through fp8.'''

    def __init__(self, params: Dict[str, torch.Tensor], quant: Optional[str] = None):
        self.p = params
        self.quant = quant

    def q(self, x):
        return fake_fp8(x) if self.quant == 'fp8' else x

    def conv(self, x, name, stride=1, padding=0, bias=True):
        k = self.p[f'{name}/kernel'].permute(3, 2, 0, 1)             # HWIO -> OIHW
        b = self.p.get(f'{name}/bias') if bias else None
        return F.conv2d(self.q(x), self.q(k), b, stride, padding)

    def deconv(self, x, name, stride, padding):
        '''flax ConvTranspose (kernel (kh, kw, in, out), not flipped) as a
        transposed convolution with the taps flipped.'''
        k = self.p[f'{name}/kernel'].permute(2, 3, 0, 1).flip(-1, -2)
        return F.conv_transpose2d(self.q(x), self.q(k), self.p[f'{name}/bias'], stride, padding)

    def dense(self, x, name):
        return self.q(x) @ self.q(self.p[f'{name}/kernel']) + self.p[f'{name}/bias']

    def frozen_bn(self, x, name, eps=1e-5):
        inv = self.p[f'{name}/scale'] / torch.sqrt(self.p[f'{name}/var'] + eps)
        shift = self.p[f'{name}/bias'] - self.p[f'{name}/mean'] * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]

    def group_norm(self, x, name, groups=32, eps=1e-5):
        return F.group_norm(x, groups, self.p[f'{name}/scale'], self.p[f'{name}/bias'], eps)


# -- geometry ---------------------------------------------------------------------

def test_scale(h: int, w: int, min_size: int, max_size: int) -> float:
    '''ResizeShortestEdge's scale.'''
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return scale


def content_size(h: int, w: int, cfg: Dict, train: bool = False) -> Tuple[float, int, int]:
    '''(scale, new_h, new_w) of a frame on the canvas.'''
    lo, hi = (cfg['min_size_train'], cfg['max_size_train']) if train else \
        (cfg['min_size_test'], cfg['max_size_test'])
    s = test_scale(h, w, lo, hi)
    canvas = cfg['image_size']
    return s, min(int(h * s + 0.5), canvas), min(int(w * s + 0.5), canvas)


def triangle_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    '''(n_in, n_out) weights of a linear resize: a triangle filter at
    half-pixel centres, widened by the factor on a downscale, each output
    normalised to sum 1, zero for centres outside the input.'''
    inv = n_in / n_out
    width = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    taps = np.maximum(0.0, 1.0 - np.abs(centre[None, :] - np.arange(n_in)[:, None]) / width)
    total = taps.sum(axis=0)
    taps = np.where(total > 0, taps / np.where(total > 0, total, 1.0), 0.0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], taps, 0.0).astype(np.float32)).to(device)


def resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    '''Linear resize of the last two axes of a float tensor.'''
    (h, w), (oh, ow) = x.shape[-2:], size
    if (h, w) == (oh, ow):
        return x
    wy = triangle_weights(h, oh, x.device)
    wx = triangle_weights(w, ow, x.device)
    return torch.matmul(torch.matmul(wy.T, x), wx)


def anchors_for(sides: Sequence[int], cfg: Dict, device) -> List[torch.Tensor]:
    '''(H*W*A, 4) anchors per level, in (y, x, anchor) order.'''
    out = []
    for side, stride, sizes in zip(sides, STRIDES, cfg['anchor_sizes']):
        cell = []
        for size in sizes:
            for ar in cfg['anchor_aspect_ratios']:
                w = math.sqrt(size * size / ar)
                h = ar * w
                cell.append([-w / 2, -h / 2, w / 2, h / 2])
        cell = torch.tensor(cell, dtype=torch.float32, device=device)
        shift = torch.arange(side, dtype=torch.float32, device=device) * stride
        sy, sx = torch.meshgrid(shift, shift, indexing='ij')
        shifts = torch.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
        out.append((shifts + cell[None]).reshape(-1, 4))
    return out


def decode(deltas, boxes, weights):
    '''Box2BoxTransform.apply_deltas with the scale clamp log(1000 / 16).'''
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * widths
    cy = boxes[..., 1] + 0.5 * heights
    clamp = math.log(1000.0 / 16)
    dw = torch.clamp(deltas[..., 2] / ww, max=clamp)
    dh = torch.clamp(deltas[..., 3] / wh, max=clamp)
    pcx = deltas[..., 0] / wx * widths + cx
    pcy = deltas[..., 1] / wy * heights + cy
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - pw / 2, pcy - ph / 2, pcx + pw / 2, pcy + ph / 2], -1)


def encode(src, tgt, weights):
    '''The deltas that take ``src`` boxes to ``tgt``.'''
    wx, wy, ww, wh = weights
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    tw = tgt[..., 2] - tgt[..., 0]
    th = tgt[..., 3] - tgt[..., 1]
    eps = 1e-6
    dx = wx * ((tgt[..., 0] + 0.5 * tw) - (src[..., 0] + 0.5 * sw)) / sw.clamp(min=eps)
    dy = wy * ((tgt[..., 1] + 0.5 * th) - (src[..., 1] + 0.5 * sh)) / sh.clamp(min=eps)
    dw = ww * torch.log(tw.clamp(min=eps) / sw.clamp(min=eps))
    dh = wh * torch.log(th.clamp(min=eps) / sh.clamp(min=eps))
    return torch.stack([dx, dy, dw, dh], -1)


def clip(boxes, h, w):
    '''Clip (B, N, 4) boxes to [0, w] x [0, h]; h, w (B,) tensors.'''
    hh, ww = h[:, None], w[:, None]
    zero = torch.zeros_like(hh)
    return torch.stack([torch.minimum(torch.maximum(boxes[..., 0], zero), ww),
                        torch.minimum(torch.maximum(boxes[..., 1], zero), hh),
                        torch.minimum(torch.maximum(boxes[..., 2], zero), ww),
                        torch.minimum(torch.maximum(boxes[..., 3], zero), hh)], -1)


def iou(a, b):
    '''(..., N, 4) x (..., M, 4) -> (..., N, M).'''
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-9), torch.zeros_like(inter))


def ranked_desc(scores):
    '''Descending order, ties to the lower index.'''
    return torch.sort(scores, dim=-1, descending=True, stable=True)


def greedy_nms(boxes, scores, valid, thresh, groups=None):
    '''Greedy NMS over (B, K): a box is kept unless a kept box of higher
    rank (score, then lower index) in its group overlaps it above
    ``thresh``. Solved exactly by iterating the keep/suppress relation to
    its fixpoint. Returns keep (B, K).'''
    k = boxes.shape[1]
    ov = iou(boxes, boxes) > thresh
    if groups is not None:
        ov &= groups[:, :, None] == groups[:, None, :]
    idx = torch.arange(k, device=boxes.device)
    si, sj = scores[:, :, None], scores[:, None, :]
    before = (sj > si) | ((sj == si) & (idx[None, :] < idx[:, None]))
    dom = ov & before & valid[:, None, :]
    keep = torch.zeros_like(valid)
    supp = torch.zeros_like(valid)
    for _ in range(k + 1):
        if not bool(torch.any(valid & ~keep & ~supp)):
            break
        keep = keep | (valid & ~supp & ~torch.any(dom & ~supp[:, None, :], -1))
        supp = supp | torch.any(dom & keep[:, None, :], -1)
    return keep


def topk_where(scores, mask, k):
    '''Top ``k`` of ``scores`` where ``mask``: (values with -inf where
    fewer, indices).'''
    masked = torch.where(mask, scores, torch.full_like(scores, -math.inf))
    vals, order = ranked_desc(masked)
    return vals[:, :k], order[:, :k]


# -- ROIAlignV2 ---------------------------------------------------------------------

def fpn_levels(boxes):
    '''FPN level 2-5 of each (..., 4) box.'''
    area = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * \
        (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area.clamp(min=1e-6)) / 224.0 + 1e-8))
    return lvl.clamp(2, 5).long()


def roi_align(levels: Sequence[torch.Tensor], boxes, out: int):
    '''ROIAlignV2 of (B, R, 4) boxes on P2..P5 (B, C, H, W) ->
    (B, R, C, out, out): 2x2 bilinear samples a bin at half-pixel
    positions, clamped into the level, averaged. Differentiable.'''
    b, r = boxes.shape[:2]
    c = levels[0].shape[1]
    lvl = fpn_levels(boxes)
    result = boxes.new_zeros((b, r, c, out, out))
    frac = (torch.arange(2 * out, dtype=torch.float32, device=boxes.device) + 0.5) / (2 * out)
    for li, feat in enumerate(levels):
        sel = lvl == li + 2
        if not bool(sel.any()):
            continue
        bi, ri = torch.nonzero(sel, as_tuple=True)
        bx = boxes[bi, ri]
        stride = float(STRIDES[li])
        h, w = feat.shape[2], feat.shape[3]
        xs = (bx[:, 0:1] + (bx[:, 2:3] - bx[:, 0:1]) * frac) / stride - 0.5
        ys = (bx[:, 1:2] + (bx[:, 3:4] - bx[:, 1:2]) * frac) / stride - 0.5
        xs = xs.clamp(0, w - 1)
        ys = ys.clamp(0, h - 1)
        x0 = xs.floor().long()
        y0 = ys.floor().long()
        fx = xs - x0
        fy = ys - y0
        x1 = (x0 + 1).clamp(max=w - 1)
        y1 = (y0 + 1).clamp(max=h - 1)
        fm = feat[bi]                                               # (n, C, H, W)
        n = fm.shape[0]
        ar = torch.arange(n, device=boxes.device)[:, None, None]

        def tap(yy, xx):
            return fm[ar, :, yy[:, :, None], xx[:, None, :]]        # (n, S, S, C)

        top = tap(y0, x0) * (1 - fx)[:, None, :, None] + tap(y0, x1) * fx[:, None, :, None]
        bot = tap(y1, x0) * (1 - fx)[:, None, :, None] + tap(y1, x1) * fx[:, None, :, None]
        samples = top * (1 - fy)[:, :, None, None] + bot * fy[:, :, None, None]
        pooled = samples.reshape(n, out, 2, out, 2, c).mean(dim=(2, 4))
        result = result.index_put((bi, ri), pooled.permute(0, 3, 1, 2))
    return result


# -- the network --------------------------------------------------------------------

class Detector:
    '''The model's forward passes over one set of float32 weights.'''

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict, quant: Optional[str] = None):
        self.w = Weights(params, quant)
        self.cfg = cfg
        blocks = {}
        for key in params:
            parts = key.split('/')
            if parts[0] == 'backbone' and parts[1].startswith('res') and len(parts) == 4:
                blocks.setdefault(parts[1], set()).add(parts[2])
        self.blocks = sorted(blocks, key=lambda n: (int(n[3]), int(n.split('_')[1])))
        self.has_shortcut = {n: 'shortcut' in parts for n, parts in blocks.items()}

    def backbone(self, x):
        w = self.w
        y = F.relu(w.frozen_bn(w.conv(x, 'backbone/stem_conv', 2, 3, bias=False),
                               'backbone/FrozenBatchNorm_0'))
        y = F.max_pool2d(y, 3, 2, 1)
        feats = {}
        for name in self.blocks:
            stage = int(name[3])
            first = name.endswith('_0')
            stride = 2 if first and stage > 2 else 1
            p = f'backbone/{name}'
            norms = iter(range(4))
            short = y
            if self.has_shortcut[name]:
                short = w.frozen_bn(w.conv(y, f'{p}/shortcut', stride, bias=False),
                                    f'{p}/FrozenBatchNorm_{next(norms)}')
            z = F.relu(w.frozen_bn(w.conv(y, f'{p}/conv1', stride, bias=False),
                                   f'{p}/FrozenBatchNorm_{next(norms)}'))
            z = F.relu(w.frozen_bn(w.conv(z, f'{p}/conv2', 1, 1, bias=False),
                                   f'{p}/FrozenBatchNorm_{next(norms)}'))
            z = w.frozen_bn(w.conv(z, f'{p}/conv3', bias=False),
                            f'{p}/FrozenBatchNorm_{next(norms)}')
            y = F.relu(z + short)
            feats[stage] = y
        return feats

    def fpn(self, feats):
        w = self.w
        lat = {s: w.group_norm(w.conv(feats[s], f'fpn/lateral{s}', bias=False),
                               f'fpn/lateral_norm{s}') for s in (2, 3, 4, 5)}
        top = {5: lat[5]}
        for s in (4, 3, 2):
            prev = top[s + 1]
            h, wd = lat[s].shape[-2:]
            ph, pw = prev.shape[-2:]
            ri = torch.div((torch.arange(h, device=prev.device) * 2 + 1) * ph, 2 * h,
                           rounding_mode='floor')
            ci = torch.div((torch.arange(wd, device=prev.device) * 2 + 1) * pw, 2 * wd,
                           rounding_mode='floor')
            up = prev[:, :, ri][:, :, :, ci]
            top[s] = (lat[s] + up) / 2.0
        outs = [w.group_norm(w.conv(top[s], f'fpn/output{s}', 1, 1, bias=False),
                             f'fpn/output_norm{s}') for s in (2, 3, 4, 5)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs

    def rpn(self, levels):
        w = self.w
        logits, deltas = [], []
        for f in levels:
            t = F.relu(w.conv(f, 'rpn_head/conv', 1, 1))
            b = t.shape[0]
            logits.append(w.conv(t, 'rpn_head/objectness').permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(w.conv(t, 'rpn_head/deltas').permute(0, 2, 3, 1).reshape(b, -1, 4))
        return logits, deltas

    def proposals(self, sides, logits, deltas, hw, train: bool):
        '''(boxes (B, P, 4), valid (B, P)) from the RPN's outputs on levels
        of the given ``sides``.'''
        cfg = self.cfg
        if train:
            pre_k, post_k, cap = cfg['rpn_pre_nms_topk_train'], cfg['rpn_post_nms_topk_train'], None
        else:
            pre_k, post_k = cfg['rpn_pre_nms_topk_test'], cfg['rpn_post_nms_topk_test']
            cap = cfg.get('rpn_nms_global_cap') or None
        level_k = pre_k if cap is None else min(pre_k, cap)
        anchors = anchors_for(sides, cfg, logits[0].device)
        h, w = hw[:, 0], hw[:, 1]
        cb, cs, cl, cv = [], [], [], []
        for li, (anc, lg, dl) in enumerate(zip(anchors, logits, deltas)):
            k = min(level_k, lg.shape[1])
            vals, idx = ranked_desc(lg)
            vals, idx = vals[:, :k], idx[:, :k]
            boxes = decode(torch.gather(dl, 1, idx[..., None].expand(-1, -1, 4)), anc[idx],
                           cfg['rpn_box_reg_weights'])
            boxes = clip(boxes, h, w)
            cb.append(boxes)
            cs.append(vals)
            cl.append(torch.full_like(idx, li))
            cv.append(((boxes[..., 2] - boxes[..., 0]) > 0) & ((boxes[..., 3] - boxes[..., 1]) > 0))
        boxes, scores = torch.cat(cb, 1), torch.cat(cs, 1)
        lvls, valid = torch.cat(cl, 1), torch.cat(cv, 1)
        if cap is not None and cap < scores.shape[1]:
            vals, idx = topk_where(scores, valid, cap)
            boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
            scores = torch.gather(scores, 1, idx)
            lvls = torch.gather(lvls, 1, idx)
            valid = torch.isfinite(vals)
        keep = greedy_nms(boxes, scores, valid, cfg['rpn_nms_thresh'], groups=lvls)
        vals, idx = topk_where(scores, keep, post_k)
        ok = torch.isfinite(vals)
        out = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        return torch.where(ok[..., None], out, torch.zeros_like(out)), ok

    def box_head(self, pooled):
        n = pooled.shape[0]
        x = pooled.permute(0, 2, 3, 1).reshape(n, -1)              # flatten HWC (flax order)
        x = F.relu(self.w.dense(x, 'box_head/fc1'))
        x = F.relu(self.w.dense(x, 'box_head/fc2'))
        return self.w.dense(x, 'box_head/cls_score'), self.w.dense(x, 'box_head/bbox_pred')

    def mask_head(self, pooled):
        x = pooled
        for i in range(len(self.cfg['mask_conv_dims'])):
            x = F.relu(self.w.conv(x, f'mask_head/mask_fcn{i + 1}', 1, 1))
        x = F.relu(self.w.deconv(x, 'mask_head/deconv', 2, 0))
        return self.w.conv(x, 'mask_head/predictor')[:, 0]          # (N, 28, 28)

    def keypoint_head(self, pooled):
        x = pooled
        for i in range(len(self.cfg['keypoint_conv_dims'])):
            x = F.relu(self.w.conv(x, f'keypoint_head/conv_fcn{i + 1}', 1, 1))
        x = self.w.deconv(x, 'keypoint_head/score_lowres', 2, 1)
        return F.interpolate(x, scale_factor=2, mode='bilinear', align_corners=False)

    def images(self, canvas_frames):
        '''(B, S, S) float frames -> normalised (B, 3, S, S).'''
        mean = torch.tensor(self.cfg['pixel_mean'], device=canvas_frames.device)
        std = torch.tensor(self.cfg['pixel_std'], device=canvas_frames.device)
        return (canvas_frames[:, None] - mean[None, :, None, None]) / std[None, :, None, None]

    @torch.no_grad()
    def detect(self, frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        '''(B, H, W) uint8 frames -> the best detection of each, at frame
        resolution: boxes (B, 4), scores (B,), valid (B,), masks (B, H, W)
        bool, keypoints (B, K, 3 [x, y, score]).'''
        cfg = self.cfg
        b, h, w = frames_u8.shape
        canvas = cfg['image_size']
        scale, nh, nw = content_size(h, w, cfg)
        x = resize(frames_u8.float(), (nh, nw))
        x = F.pad(x, (0, canvas - nw, 0, canvas - nh))
        levels = self.fpn(self.backbone(self.images(x)))
        logits, deltas = self.rpn(levels)
        hw = torch.tensor([[nh, nw]], dtype=torch.float32, device=x.device).repeat(b, 1)
        props, pvalid = self.proposals([f.shape[-1] for f in levels], logits, deltas, hw,
                                       train=False)
        p = props.shape[1]
        pooled = roi_align(levels[:4], props, cfg['box_pooler_resolution'])
        cls, reg = self.box_head(pooled.reshape(b * p, *pooled.shape[2:]))
        score = torch.softmax(cls.reshape(b, p, -1), -1)[..., 0]
        boxes = clip(decode(reg.reshape(b, p, 4), props, cfg['box_reg_weights']),
                     hw[:, 0], hw[:, 1])
        ok = pvalid & (score > cfg['test_score_thresh'])
        keep = greedy_nms(boxes, score, ok, cfg['test_nms_thresh'])
        vals, idx = topk_where(score, keep, 1)
        valid = torch.isfinite(vals[:, 0])
        det = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))      # (B, 1, 4)
        det = torch.where(valid[:, None, None], det, torch.zeros_like(det))
        scores = torch.where(valid, vals[:, 0], torch.zeros_like(vals[:, 0]))

        mask_logits = self.mask_head(roi_align(levels[:4], det, cfg['mask_pooler_resolution'])
                                     .reshape(b, -1, *([cfg['mask_pooler_resolution']] * 2)))
        masks = paste(mask_logits, det[:, 0], canvas) & valid[:, None, None]
        masks = resize(masks[:, :nh, :nw].float(), (h, w)) > 0.5
        masks &= valid[:, None, None]

        heat = self.keypoint_head(roi_align(levels[:4], det, cfg['keypoint_pooler_resolution'])
                                  .reshape(b, -1, *([cfg['keypoint_pooler_resolution']] * 2)))
        kpts = heatmap_points(heat, det[:, 0])
        inv = 1.0 / scale
        kpts = torch.cat([kpts[..., :2] * inv, kpts[..., 2:]], -1)
        return {'boxes': det[:, 0] * inv, 'scores': scores, 'valid': valid,
                'masks': masks, 'keypoints': kpts}


def paste(mask_logits, boxes, canvas: int, threshold: float = 0.5):
    '''(N, s, s) mask logits into (N, S, S) bool masks at (N, 4) boxes:
    each canvas pixel centre mapped into the box's s x s grid, the
    probabilities interpolated with triangle weights, within the box (and
    one pixel past its far edges).'''
    n, s = mask_logits.shape[:2]
    dev = mask_logits.device
    cent = torch.arange(canvas, dtype=torch.float32, device=dev) + 0.5
    cells = torch.arange(s, dtype=torch.float32, device=dev)
    probs = torch.sigmoid(mask_logits)
    x1, y1, x2, y2 = (boxes[:, i, None] for i in range(4))
    my = (cent[None] - y1) / (y2 - y1).clamp(min=1e-3) * s - 0.5     # (N, S)
    mx = (cent[None] - x1) / (x2 - x1).clamp(min=1e-3) * s - 0.5
    wy = (1 - (my[..., None] - cells).abs()).clamp(min=0)           # (N, S, s)
    wx = (1 - (mx[..., None] - cells).abs()).clamp(min=0)
    v = wy @ probs @ wx.transpose(1, 2)
    yin = (cent[None] >= y1) & (cent[None] <= y2 + 1)
    xin = (cent[None] >= x1) & (cent[None] <= x2 + 1)
    return (v >= threshold) & yin[:, :, None] & xin[:, None, :]


def heatmap_points(heat, boxes):
    '''(N, K, s, s) heatmap logits at (N, 4) boxes -> (N, K, 3): the
    centre of each argmax bin in the box, and its softmax probability.'''
    n, k, s, _ = heat.shape
    flat = heat.reshape(n, k, s * s)
    probs = torch.softmax(flat, -1)
    arg = flat.argmax(-1)
    score = torch.gather(probs, -1, arg[..., None])[..., 0]
    yi = torch.div(arg, s, rounding_mode='floor').float()
    xi = (arg % s).float()
    bw = (boxes[:, 2] - boxes[:, 0]).clamp(min=1e-3)[:, None]
    bh = (boxes[:, 3] - boxes[:, 1]).clamp(min=1e-3)[:, None]
    xs = boxes[:, 0:1] + (xi + 0.5) * bw / s
    ys = boxes[:, 1:2] + (yi + 0.5) * bh / s
    return torch.stack([xs, ys, score], -1)
