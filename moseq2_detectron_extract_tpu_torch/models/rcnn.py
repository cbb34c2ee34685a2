'''Mask+Keypoint R-CNN: inference with fixed-size, validity-masked outputs,
and the training losses.

Port of ``moseq2_detectron_extract_tpu/models/rcnn.py`` (``inference``,
lines 137-213, ``_pool``, lines 215-233, as ``pool_levels`` and
``roi_align``, and ``losses``, lines 236-370). Pooling is always bf16 in
and out at inference, whatever ``amp_dtype`` says; on the card each of its
three calls (box, mask, keypoint stage) launches the ROIAlign kernel.
Training pools in f32 through the differentiable gather form
(``ops.roi_align.batched_multilevel_roi_align``), as the JAX package does.

The losses take their random draws as arguments (:func:`draw_loss_uniforms`
makes them): the uniform priorities of the RPN's anchor sampling and of
the ROI sampling, per image.
'''
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from moseq2_detectron_extract_tpu_torch.models.anchors import generate_anchors
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.fpn import FPN
from moseq2_detectron_extract_tpu_torch.models.heads import (BoxHead, KeypointHead,
                                                             MaskHead,
                                                             heatmaps_to_keypoints,
                                                             keypoint_targets,
                                                             paste_masks)
from moseq2_detectron_extract_tpu_torch.models.layers import compute_dtype_of
from moseq2_detectron_extract_tpu_torch.models.matcher import subsample_labels
from moseq2_detectron_extract_tpu_torch.models.resnet import ResNet
from moseq2_detectron_extract_tpu_torch.models.rpn import (RPNHead, _bce_with_logits,
                                                           _smooth_l1, rpn_losses,
                                                           select_proposals)
from moseq2_detectron_extract_tpu_torch.ops.boxes import (clip_boxes, decode_boxes,
                                                          encode_boxes, pairwise_iou)
from moseq2_detectron_extract_tpu_torch.ops.nms import (batched_nms_keep_mask,
                                                        stable_topk)
from moseq2_detectron_extract_tpu_torch.ops.roi_align import (batched_multilevel_roi_align,
                                                              crop_resize_masks)
from moseq2_detectron_extract_tpu_torch.ops.roi_align_kernel import roi_align
from moseq2_detectron_extract_tpu_torch.utils.profiling import span

FPN_STRIDES = (4, 8, 16, 32, 64)

# sums a count over the ranks of data-parallel training (see MaskKeypointRCNN.losses)
CountReducer = Callable[[torch.Tensor], torch.Tensor]


class MaskKeypointRCNN(nn.Module):
    '''R50-FPN Mask+Keypoint R-CNN (inference).'''

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype_of(cfg.amp_dtype)
        self.compute_dtype = dt
        w = cfg.resnet_width
        self.backbone = ResNet(depth=cfg.resnet_depth, norm=cfg.backbone_norm,
                               stage_blocks=cfg.resnet_stage_blocks, width=w,
                               dtype=dt)
        c = cfg.fpn_channels
        self.fpn = FPN((w * 4, w * 8, w * 16, w * 32), out_channels=c,
                       norm=cfg.fpn_norm, fuse_type=cfg.fpn_fuse_type, dtype=dt)
        num_anchors = len(cfg.anchor_sizes[0]) * len(cfg.anchor_aspect_ratios)
        self.rpn_head = RPNHead(num_anchors, conv_dim=c, dtype=dt)
        self.box_head = BoxHead(c, cfg.box_pooler_resolution,
                                num_classes=cfg.num_classes,
                                fc_dim=cfg.box_fc_dim, dtype=dt)
        if cfg.mask_on:
            self.mask_head = MaskHead(c, num_classes=cfg.num_classes,
                                      conv_dims=cfg.mask_conv_dims, dtype=dt)
        if cfg.keypoint_on:
            self.keypoint_head = KeypointHead(c, num_keypoints=cfg.num_keypoints,
                                              conv_dims=cfg.keypoint_conv_dims,
                                              dtype=dt)

    def features(self, images: torch.Tensor):
        '''images (B, 3, S, S) normalized f32 -> P2..P6 (NCHW).'''
        with span('detector.backbone'):
            x = images.to(self.compute_dtype)
            if x.is_cuda:
                x = x.contiguous(memory_format=torch.channels_last)
            return self.fpn(self.backbone(x))

    def _anchors(self, fpn_feats):
        shapes = tuple((f.shape[2], f.shape[3]) for f in fpn_feats)
        dev = fpn_feats[0].device
        return [torch.from_numpy(a).to(dev) for a in generate_anchors(
            shapes, FPN_STRIDES, self.cfg.anchor_sizes, self.cfg.anchor_aspect_ratios)]

    @staticmethod
    def pool_levels(fpn_feats):
        '''P2..P5 as the NHWC bf16 views the three pool calls share. A
        channels_last level is NHWC in memory, and ``contiguous`` then
        copies nothing; any other level is copied once here, not per call.'''
        return [f.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
                for f in fpn_feats[:4]]

    @torch.no_grad()
    def inference(self, images: torch.Tensor,
                  image_sizes: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        '''Full detection forward. images (B, 3, S, S) normalized f32;
        image_sizes (B, 2 [h, w]) f32 content sizes (default: the canvas).

        Returns per-image padded detections: boxes (B, D, 4), scores (B, D),
        classes (B, D), valid (B, D), masks (B, D, S, S) bool, mask_probs
        (B, D, 28, 28), keypoints (B, D, K, 3), keypoint_heatmaps
        (B, D, S', S', K).
        '''
        cfg = self.cfg
        b = images.shape[0]
        canvas = (images.shape[2], images.shape[3])
        dev = images.device
        if image_sizes is None:
            image_sizes = torch.tensor([canvas], dtype=torch.float32,
                                       device=dev).repeat(b, 1)

        fpn_feats = self.features(images)
        proposals, prop_valid, _ = self.proposals(fpn_feats, image_sizes, train=False)

        p = proposals.shape[1]
        with span('detector.box_head'):
            levels = self.pool_levels(fpn_feats)
            pooled = roi_align(levels, proposals, cfg.box_pooler_resolution)
            cls_logits, box_deltas = self.box_head(pooled.reshape(b * p, *pooled.shape[2:]))
            cls_logits = cls_logits.reshape(b, p, -1).float()
            box_deltas = box_deltas.reshape(b, p, 4).float()
            fg_scores = torch.softmax(cls_logits, dim=-1)[..., 0]
            boxes = decode_boxes(box_deltas, proposals, cfg.box_reg_weights)

            # per-image test-time select (rcnn.py:167-183), batched
            boxes = clip_boxes(boxes, image_sizes)
            valid = prop_valid & (fg_scores > cfg.test_score_thresh)
        with span('detector.box_nms'):
            keep = batched_nms_keep_mask(boxes, fg_scores,
                                         torch.zeros(fg_scores.shape, dtype=torch.int32,
                                                     device=dev),
                                         cfg.test_nms_thresh, valid=valid)
            masked = torch.where(keep, fg_scores, torch.full_like(fg_scores, -torch.inf))
            top_scores, top_idx = stable_topk(masked, cfg.test_detections_per_image)
            det_valid = torch.isfinite(top_scores)
            det_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
            det_boxes = torch.where(det_valid[..., None], det_boxes,
                                    torch.zeros_like(det_boxes))
            det_scores = torch.where(det_valid, top_scores, torch.zeros_like(top_scores))

        out = {'boxes': det_boxes, 'scores': det_scores,
               'classes': torch.zeros(det_scores.shape, dtype=torch.int32, device=dev),
               'valid': det_valid}
        d = det_boxes.shape[1]

        if cfg.mask_on:
            with span('detector.mask_head'):
                mask_pooled = roi_align(levels, det_boxes, cfg.mask_pooler_resolution)
                mask_logits = self.mask_head(mask_pooled.reshape(b * d,
                                                                 *mask_pooled.shape[2:]))
                mask_logits = mask_logits[..., 0].reshape(b, d, cfg.mask_resolution,
                                                          cfg.mask_resolution)
                out['mask_probs'] = torch.sigmoid(mask_logits.float())
                masks = paste_masks(mask_logits.reshape(b * d, *mask_logits.shape[2:]),
                                    det_boxes.reshape(b * d, 4), canvas)
                out['masks'] = masks.reshape(b, d, *canvas) & det_valid[..., None, None]

        if cfg.keypoint_on:
            with span('detector.keypoint_head'):
                kp_pooled = roi_align(levels, det_boxes, cfg.keypoint_pooler_resolution)
                kp_logits = self.keypoint_head(kp_pooled.reshape(b * d, *kp_pooled.shape[2:]))
                s = kp_logits.shape[1]
                out['keypoint_heatmaps'] = kp_logits.reshape(
                    b, d, s, s, cfg.num_keypoints).float()
                out['keypoints'] = heatmaps_to_keypoints(
                    kp_logits, det_boxes.reshape(b * d, 4)).reshape(
                        b, d, cfg.num_keypoints, 3)
        return out

    # ---------------------------------------------------------------- training
    def proposals(self, fpn_feats, image_sizes: torch.Tensor, train: bool):
        '''RPN head and proposal selection (``rcnn.py:83-112``) -> boxes
        (B, P, 4), valid (B, P), and the RPN's (logits, deltas, anchors) per
        level. Training takes the train top-k with no global cap.'''
        cfg = self.cfg
        with span('detector.rpn_head'):
            logits, deltas = self.rpn_head(fpn_feats)
            anchors = self._anchors(fpn_feats)
        if train:
            pre_k, post_k, cap = (cfg.rpn_pre_nms_topk_train,
                                  cfg.rpn_post_nms_topk_train, None)
        else:
            pre_k, post_k, cap = (cfg.rpn_pre_nms_topk_test, cfg.rpn_post_nms_topk_test,
                                  cfg.rpn_nms_global_cap or None)
        with span('detector.proposal_nms'):
            boxes, _, valid = select_proposals(anchors, logits, deltas, image_sizes, pre_k,
                                               post_k, cfg.rpn_nms_thresh,
                                               cfg.rpn_box_reg_weights, global_cap=cap)
        return boxes, valid, (logits, deltas, anchors)

    @staticmethod
    def train_pool(fpn_feats, boxes, resolution: int):
        '''f32 gather ROIAlign of (B, R, 4) boxes over P2-P5 ->
        (B, R, r, r, C) f32 (``_pool(train=True)``).'''
        levels = [f.float().permute(0, 2, 3, 1) for f in fpn_feats[:4]]
        return batched_multilevel_roi_align(levels, boxes, resolution, chunk=128)

    def rpn_part(self, rpn_out, gt: Dict[str, torch.Tensor], draws,
                 global_count: Optional[CountReducer] = None) -> Dict[str, torch.Tensor]:
        '''The RPN's two losses from ``proposals``' RPN outputs, each over
        ``rpn_batch_size_per_image`` anchors an image of the whole batch
        (``global_count`` sums the image count over the ranks).'''
        cfg = self.cfg
        logits, deltas, anchors = rpn_out
        b = logits[0].shape[0]
        obj, reg = rpn_losses(torch.cat(anchors), torch.cat(logits, dim=1).float(),
                              torch.cat(deltas, dim=1).float(), gt['boxes'], gt['valid'],
                              draws, cfg.rpn_batch_size_per_image,
                              cfg.rpn_positive_fraction, cfg.rpn_fg_iou_thresh,
                              cfg.rpn_bg_iou_thresh, cfg.rpn_box_reg_weights,
                              cfg.rpn_smooth_l1_beta)
        if global_count is not None:
            b = int(global_count(torch.tensor(b, device=logits[0].device)))
        normalizer = cfg.rpn_batch_size_per_image * b
        return {'loss_rpn_cls': torch.sum(obj) / normalizer,
                'loss_rpn_loc': torch.sum(reg) / normalizer}

    def sample_rois(self, proposals, prop_valid, gt: Dict[str, torch.Tensor], draws):
        '''Match the proposals (gt boxes appended, as Detectron2 does) and
        sample R per image -> (boxes (B, R, 4), valid, is_pos, gt index).'''
        cfg = self.cfg
        all_props = torch.cat([proposals, gt['boxes']], dim=1)
        all_valid = torch.cat([prop_valid, gt['valid']], dim=1)
        iou = pairwise_iou(all_props, gt['boxes'])                    # (B, P+G, G)
        iou = torch.where(gt['valid'][:, None, :], iou, torch.full_like(iou, -1.0))
        iou = torch.where(all_valid[:, :, None], iou, torch.full_like(iou, -1.0))
        matched_iou, matched_idx = torch.max(iou, dim=-1)
        labels = (matched_iou >= cfg.roi_fg_iou_thresh).to(torch.int32)
        labels = torch.where(all_valid, labels, torch.full_like(labels, -1))
        idx, valid, is_pos = subsample_labels(labels, cfg.roi_batch_size_per_image,
                                              cfg.roi_positive_fraction, *draws)
        boxes = torch.gather(all_props, 1, idx[..., None].expand(-1, -1, 4))
        return boxes, valid, is_pos, torch.gather(matched_idx, 1, idx)

    def roi_head_part(self, fpn_feats, proposals, prop_valid, gt: Dict[str, torch.Tensor],
                      draws, global_count: Optional[CountReducer] = None
                      ) -> Dict[str, torch.Tensor]:
        '''The box, mask and keypoint losses on ``proposals`` (B, P, 4),
        which carry no gradient. The heads run on all R sampled ROIs of each
        image; each loss is masked to the ROIs it counts and divided by
        their count (sampled, positive, visible keypoints), which
        ``global_count`` sums over the ranks.'''
        cfg = self.cfg
        count = (lambda c: c) if global_count is None else global_count
        s_boxes, s_valid, s_pos, s_gt_idx = self.sample_rois(proposals, prop_valid, gt,
                                                             draws)
        b, r = s_boxes.shape[:2]
        losses = {}

        pooled = self.train_pool(fpn_feats, s_boxes, cfg.box_pooler_resolution)
        cls_logits, box_deltas = self.box_head(pooled.reshape(b * r, *pooled.shape[2:]))
        cls_logits = cls_logits.reshape(b, r, -1).float()
        box_deltas = box_deltas.reshape(b, r, 4).float()
        cls_targets = torch.where(s_pos, 0, cfg.num_classes)
        ce = -torch.log_softmax(cls_logits, dim=-1)
        cls_loss = torch.gather(ce, -1, cls_targets[..., None])[..., 0]
        cls_loss = torch.sum(torch.where(s_valid, cls_loss, torch.zeros_like(cls_loss)))
        s_gt_boxes = torch.gather(gt['boxes'], 1, s_gt_idx[..., None].expand(-1, -1, 4))
        target = encode_boxes(s_boxes, s_gt_boxes, cfg.box_reg_weights)
        reg = _smooth_l1(box_deltas - target, cfg.box_smooth_l1_beta)
        reg_loss = torch.sum(torch.where(s_pos[..., None], reg, torch.zeros_like(reg)))
        num_sampled = torch.clamp(count(torch.sum(s_valid)), min=1)
        losses['loss_cls'] = cls_loss / num_sampled
        losses['loss_box_reg'] = reg_loss / num_sampled

        num_pos = torch.clamp(count(torch.sum(s_pos)), min=1)
        if cfg.mask_on:
            m = cfg.mask_resolution
            pooled = self.train_pool(fpn_feats, s_boxes, cfg.mask_pooler_resolution)
            mask_logits = self.mask_head(pooled.reshape(b * r, *pooled.shape[2:]))[..., 0]
            mask_logits = mask_logits.reshape(b, r, m, m).float()
            targets = crop_resize_masks(gt['masks'], s_gt_idx, s_boxes, m) >= 0.5
            mloss = _bce_with_logits(mask_logits, targets.to(torch.float32))
            mloss = torch.where(s_pos[..., None, None], mloss, torch.zeros_like(mloss))
            losses['loss_mask'] = torch.sum(mloss) / (num_pos * m ** 2)

        if cfg.keypoint_on:
            k = cfg.num_keypoints
            pooled = self.train_pool(fpn_feats, s_boxes, cfg.keypoint_pooler_resolution)
            kp_logits = self.keypoint_head(pooled.reshape(b * r, *pooled.shape[2:]))
            hs = kp_logits.shape[1]
            kp_logits = kp_logits.reshape(b, r, hs, hs, k).permute(0, 1, 4, 2, 3) \
                .reshape(b, r, k, hs * hs).float()
            gt_kpts = torch.gather(gt['keypoints'], 1,
                                   s_gt_idx[..., None, None].expand(-1, -1, k, 3))
            tgt_idx, tgt_valid = keypoint_targets(gt_kpts, s_boxes, hs)
            tgt_valid = tgt_valid & s_pos[..., None]
            logp = torch.log_softmax(kp_logits, dim=-1)
            kp_ce = -torch.gather(logp, -1, tgt_idx[..., None])[..., 0]
            num_visible = torch.clamp(count(torch.sum(tgt_valid)), min=1)
            losses['loss_keypoint'] = torch.sum(
                torch.where(tgt_valid, kp_ce, torch.zeros_like(kp_ce))) / num_visible
        return losses

    def losses(self, images: torch.Tensor, gt: Dict[str, torch.Tensor], draws,
               image_sizes: Optional[torch.Tensor] = None,
               global_count: Optional[CountReducer] = None) -> Dict[str, torch.Tensor]:
        '''Training losses. images (B, 3, S, S) normalized f32; gt holds
        boxes (B, G, 4), valid (B, G), masks (B, G, S, S) bool and keypoints
        (B, G, K, 3 [x, y, vis]); ``draws`` from :func:`draw_loss_uniforms`.

        Each loss divides a sum over the batch by a count over the batch.
        With ``global_count`` (data-parallel training: a sum over the ranks,
        ``parallel.data_parallel``) the counts are the global batch's, so
        each rank's loss is its share of the global batch's loss; without
        it the batch is the whole batch, and nothing else changes.'''
        b = images.shape[0]
        if image_sizes is None:
            image_sizes = torch.tensor([images.shape[2:]], dtype=torch.float32,
                                       device=images.device).repeat(b, 1)
        fpn_feats = self.features(images)
        proposals, prop_valid, rpn_out = self.proposals(fpn_feats, image_sizes, train=True)
        losses = self.rpn_part(rpn_out, gt, draws['rpn'], global_count)
        # no gradient through the proposals (Detectron2 decodes them under
        # no_grad; the JAX package's stop_gradient)
        losses.update(self.roi_head_part(fpn_feats, proposals.detach(), prop_valid, gt,
                                         draws['roi'], global_count))
        losses['total_loss'] = sum(losses.values())
        return losses


def level_shapes(canvas: int) -> Tuple[int, ...]:
    '''Side of P2..P6 for a square canvas: each stride-2 step rounds up.'''
    sides, side = [], canvas
    for level in range(1, 7):
        side = math.ceil(side / 2)
        if level >= 2:
            sides.append(side)
    return tuple(sides)


def draw_loss_uniforms(generator: torch.Generator, cfg: ModelConfig, batch: int,
                       device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    '''The losses' random draws: the (u_pos, u_neg) priorities of the RPN's
    anchor sampling (B, A) and of the ROI sampling (B, P + G).'''
    per_cell = len(cfg.anchor_sizes[0]) * len(cfg.anchor_aspect_ratios)
    n_anchors = sum(side * side * per_cell for side in level_shapes(cfg.image_size))
    n_rois = cfg.rpn_post_nms_topk_train + cfg.max_gt_instances

    def pair(n):
        return tuple(torch.rand((batch, n), generator=generator, device=device)
                     for _ in range(2))
    return {'rpn': pair(n_anchors), 'roi': pair(n_rois)}
