'''Inference wrapper: resize, normalize, detect, detector postprocess.

Port of ``moseq2_detectron_extract_tpu/models/predictor.py`` (``_step_impl``
and ``_detect_impl``, lines 80-148, and the chunk batching of ``__call__``)
with the fused selection of ``ops/instances.py:nms_and_centers``. uint8
depth frames go in, full-resolution masks and keypoints come out, all on
the predictor's device.
'''
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.layers import cast_to_compute_dtype
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
from moseq2_detectron_extract_tpu_torch.models.weights import (load_params_npz,
                                                               params_from_jax)
from moseq2_detectron_extract_tpu_torch.ops.instances import nms_and_centers
from moseq2_detectron_extract_tpu_torch.ops.preprocess import compute_test_scale


def _resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    '''Bilinear resize of the last two axes with half-pixel centres; it
    anti-aliases on a downscale, as ``jax.image.resize(..., 'bilinear')``
    does (without it a 404 -> 150 px resize is 139.7 grey levels off).'''
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=size, mode='bilinear',
                      align_corners=False, antialias=True)
    return y.reshape(*lead, *size)


class Predictor:
    '''Runs the Mask+Keypoint R-CNN on (N, H, W) uint8 depth frames in
    fixed-size batches.'''

    def __init__(self, cfg: ModelConfig, state_dict: Dict[str, torch.Tensor],
                 batch_size: int = 10, score_threshold: Optional[float] = None,
                 device='cuda'):
        self.device = resolve_device(device)
        self.cfg = cfg if score_threshold is None else \
            cfg.replace(test_score_thresh=float(score_threshold))
        self.model = MaskKeypointRCNN(self.cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()
        cast_to_compute_dtype(self.model)
        self.model.to(self.device)
        self.batch_size = int(batch_size)

    @classmethod
    def from_model_dir(cls, model_dir: str, batch_size: int = 10,
                       score_threshold: Optional[float] = None,
                       device='cuda') -> 'Predictor':
        '''Load ``config.yaml`` and ``params_f16.npz`` from a model dir.'''
        cfg_path = os.path.join(model_dir, 'config.yaml')
        cfg = ModelConfig.from_yaml(cfg_path) if os.path.exists(cfg_path) \
            else ModelConfig()
        npz_path = os.path.join(model_dir, 'params_f16.npz')
        if not os.path.exists(npz_path):
            raise FileNotFoundError(f'no params_f16.npz in {model_dir}')
        state = params_from_jax(load_params_npz(npz_path),
                                box_pooler_resolution=cfg.box_pooler_resolution)
        return cls(cfg, state, batch_size=batch_size,
                   score_threshold=score_threshold, device=device)

    def test_geometry(self, frame_shape: Tuple[int, int]):
        '''(scale, new_h, new_w) of ResizeShortestEdge for ``frame_shape``.'''
        cfg = self.cfg
        h, w = frame_shape
        scale = compute_test_scale(h, w, cfg.min_size_test, cfg.max_size_test)
        new_h, new_w = int(h * scale + 0.5), int(w * scale + 0.5)
        return scale, min(new_h, cfg.image_size), min(new_w, cfg.image_size)

    @torch.no_grad()
    def step(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        '''One batch: frames (B, H, W) uint8 -> detections at frame resolution,
        with the extraction's selection fused in (``keep``, ``centers``,
        ``mask_iou``).'''
        cfg = self.cfg
        canvas = cfg.image_size
        h, w = frames.shape[1], frames.shape[2]
        scale, new_h, new_w = self.test_geometry((h, w))
        x = _resize_bilinear(frames.float(), (new_h, new_w))
        x = F.pad(x, (0, canvas - new_w, 0, canvas - new_h))
        x = x[:, None].expand(-1, 3, -1, -1)
        mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=x.device)
        x = (x - mean[None, :, None, None]) / std[None, :, None, None]

        b = x.shape[0]
        image_sizes = torch.tensor([[new_h, new_w]], dtype=torch.float32,
                                   device=x.device).repeat(b, 1)
        out = self.model.inference(x, image_sizes)

        inv = 1.0 / scale
        keypoints = out['keypoints'].clone()
        keypoints[..., :2] = keypoints[..., :2] * inv
        mask_canvas = out['masks'][:, :, :new_h, :new_w].float()
        masks = _resize_bilinear(mask_canvas, (h, w)) > 0.5
        masks = masks & out['valid'][:, :, None, None]
        keep, centers, iou = nms_and_centers(masks, out['scores'], out['valid'])
        return {'boxes': out['boxes'] * inv, 'scores': out['scores'],
                'classes': out['classes'], 'valid': out['valid'],
                'masks': masks, 'keypoints': keypoints,
                'mask_probs': out['mask_probs'],
                'keep': keep, 'centers': centers, 'mask_iou': iou}

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        '''Run (N, H, W) uint8 frames in batches of ``batch_size``, the last
        padded with zero frames; outputs stay on the device.'''
        frames = torch.as_tensor(frames).to(self.device)
        n, h, w = frames.shape
        pad = (-n) % self.batch_size
        if pad:
            frames = torch.cat([frames, frames.new_zeros((pad, h, w))])
        outs = [self.step(frames[i:i + self.batch_size])
                for i in range(0, frames.shape[0], self.batch_size)]
        return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}
