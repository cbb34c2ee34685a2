'''Mask+Keypoint R-CNN inference with fixed-size, validity-masked outputs.

Port of ``moseq2_detectron_extract_tpu/models/rcnn.py`` (``inference``,
lines 137-213, and ``_pool``, lines 215-233, as ``pool_levels`` and
``roi_align``). Pooling is always bf16 in and out at inference, whatever
``amp_dtype`` says; on the card each of its three calls (box, mask,
keypoint stage) launches the ROIAlign kernel.
'''
from typing import Dict, Optional

import torch
from torch import nn

from moseq2_detectron_extract_tpu_torch.models.anchors import generate_anchors
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.fpn import FPN
from moseq2_detectron_extract_tpu_torch.models.heads import (BoxHead, KeypointHead,
                                                             MaskHead,
                                                             heatmaps_to_keypoints,
                                                             paste_masks)
from moseq2_detectron_extract_tpu_torch.models.layers import compute_dtype_of
from moseq2_detectron_extract_tpu_torch.models.resnet import ResNet
from moseq2_detectron_extract_tpu_torch.models.rpn import RPNHead, select_proposals
from moseq2_detectron_extract_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from moseq2_detectron_extract_tpu_torch.ops.nms import (batched_nms_keep_mask,
                                                        stable_topk)
from moseq2_detectron_extract_tpu_torch.ops.roi_align_kernel import roi_align

FPN_STRIDES = (4, 8, 16, 32, 64)


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
        logits, deltas = self.rpn_head(fpn_feats)
        proposals, _, prop_valid = select_proposals(
            self._anchors(fpn_feats), logits, deltas, image_sizes,
            cfg.rpn_pre_nms_topk_test, cfg.rpn_post_nms_topk_test,
            cfg.rpn_nms_thresh, cfg.rpn_box_reg_weights,
            global_cap=cfg.rpn_nms_global_cap or None)

        p = proposals.shape[1]
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
            mask_pooled = roi_align(levels, det_boxes, cfg.mask_pooler_resolution)
            mask_logits = self.mask_head(mask_pooled.reshape(b * d, *mask_pooled.shape[2:]))
            mask_logits = mask_logits[..., 0].reshape(b, d, cfg.mask_resolution,
                                                      cfg.mask_resolution)
            out['mask_probs'] = torch.sigmoid(mask_logits.float())
            masks = paste_masks(mask_logits.reshape(b * d, *mask_logits.shape[2:]),
                                det_boxes.reshape(b * d, 4), canvas)
            out['masks'] = masks.reshape(b, d, *canvas) & det_valid[..., None, None]

        if cfg.keypoint_on:
            kp_pooled = roi_align(levels, det_boxes, cfg.keypoint_pooler_resolution)
            kp_logits = self.keypoint_head(kp_pooled.reshape(b * d, *kp_pooled.shape[2:]))
            s = kp_logits.shape[1]
            out['keypoint_heatmaps'] = kp_logits.reshape(
                b, d, s, s, cfg.num_keypoints).float()
            out['keypoints'] = heatmaps_to_keypoints(
                kp_logits, det_boxes.reshape(b * d, 4)).reshape(
                    b, d, cfg.num_keypoints, 3)
        return out
