'''Inference wrapper: resize, normalize, detect, detector postprocess.

Port of ``moseq2_detectron_extract_tpu/models/predictor.py`` (``to_device``,
lines 44-59; ``_step_impl``, ``_prescaled_impl`` and ``_detect_impl``,
lines 80-148; ``predict_prescaled``, 178-200; and the chunk batching of
``__call__``) with the fused selection of
``ops/instances.py:nms_and_centers``. uint8 depth frames go in,
full-resolution masks and keypoints come out, all on the predictor's
device.
'''
import copy
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.checkpoint import load_model_dir
from moseq2_detectron_extract_tpu_torch.models.layers import cast_to_compute_dtype
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
from moseq2_detectron_extract_tpu_torch.ops.instances import nms_and_centers
from moseq2_detectron_extract_tpu_torch.ops.preprocess import compute_test_scale
from moseq2_detectron_extract_tpu_torch.utils.profiling import span


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    '''(in_size, out_size) f32 weights of ``jax.image.resize(..., 'bilinear')``
    along one axis, computed as its ``compute_weight_mat`` does: the triangle
    kernel at ``(o + 0.5) * inv_scale - 0.5``, widened by ``inv_scale`` on a
    downscale, each column divided by its sum (taken in row order), and
    zero for samples outside ``[-0.5, in_size - 0.5]``; every step in f32.'''
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    # XLA fuses the multiply and the subtraction (one rounding): the f64
    # product of two f32 values is exact, so f64 then one cast to f32 is it
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)).astype(np.float64)
              * np.float64(inv_scale) - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = np.zeros(out_size, np.float32)
    for row in weights:
        total += row
    weights = np.where(np.abs(total) > np.float32(1000 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample >= -0.5) & (sample <= np.float32(in_size - 0.5))
    return np.where(inside[None, :], weights, np.float32(0)).astype(np.float32)


def _resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    '''Bilinear resize of the last two axes of an f32 tensor, as
    ``jax.image.resize(..., 'bilinear')`` computes it: the weight matrices
    of ``_resize_weights`` (anti-aliased on a downscale), contracted one
    axis at a time in the order XLA's einsum picks, the one with fewer
    multiplications (rows first on a tie). An axis whose size does not
    change is left as it is.'''
    (in_h, in_w), (out_h, out_w) = x.shape[-2:], size
    if (in_h, in_w) == (out_h, out_w):
        return x
    lead = x.shape[:-2]
    y = x.reshape(-1, in_h, in_w)
    b = y.shape[0]

    def weights(m, n):
        return torch.from_numpy(_resize_weights(m, n)).to(x.device)

    rows_first = b * in_h * out_h * in_w + b * out_h * in_w * out_w
    cols_first = b * in_h * in_w * out_w + b * in_h * out_w * out_h
    steps = ['h', 'w'] if rows_first <= cols_first else ['w', 'h']
    for axis in steps:
        if axis == 'h' and in_h != out_h:
            y = torch.matmul(weights(in_h, out_h).T, y)
        elif axis == 'w' and in_w != out_w:
            y = torch.matmul(y, weights(in_w, out_w))
    return y.reshape(*lead, out_h, out_w)


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
        # deploy.load_exported_model puts the loaded torch.export program's
        # module here; step then runs it in place of the live model at the
        # program's batch size
        self._exported_forward = None

    @classmethod
    def from_model_dir(cls, model_dir: str, batch_size: int = 10,
                       score_threshold: Optional[float] = None,
                       device='cuda', checkpoint: str = 'last') -> 'Predictor':
        '''Load ``config.yaml`` and the weights of a model dir: its
        checkpoint, else its ``params_f16.npz`` (``load_model_dir``).'''
        cfg, state, _ = load_model_dir(model_dir, checkpoint)
        return cls(cfg, state, batch_size=batch_size,
                   score_threshold=score_threshold, device=device)

    def test_geometry(self, frame_shape: Tuple[int, int]):
        '''(scale, new_h, new_w) of ResizeShortestEdge for ``frame_shape``.'''
        cfg = self.cfg
        h, w = frame_shape
        scale = compute_test_scale(h, w, cfg.min_size_test, cfg.max_size_test)
        new_h, new_w = int(h * scale + 0.5), int(w * scale + 0.5)
        return scale, min(new_h, cfg.image_size), min(new_w, cfg.image_size)

    def to_device(self, device) -> 'Predictor':
        '''A Predictor like this one whose model lives on ``device``; this
        one stays where it is. The weights are copied once; an exported
        program is not carried over (it holds the device it was exported
        on).'''
        clone = Predictor.__new__(Predictor)
        clone.device = resolve_device(device)
        clone.cfg = self.cfg
        clone.model = copy.deepcopy(self.model).to(clone.device)
        clone.batch_size = self.batch_size
        clone._exported_forward = None
        return clone

    @torch.no_grad()
    def step(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        '''One batch: frames (B, H, W) uint8 -> detections at frame resolution,
        with the extraction's selection fused in (``keep``, ``centers``,
        ``mask_iou``). Recorded as the span ``predictor.batch``, numbered
        among the batches of its parent span.'''
        canvas = self.cfg.image_size
        h, w = frames.shape[1], frames.shape[2]
        _, new_h, new_w = self.test_geometry((h, w))
        with span('predictor.batch', indexed=True):
            with span('predictor.resize_in'):
                x = _resize_bilinear(frames.float(), (new_h, new_w))
                x = self._normalize(F.pad(x, (0, canvas - new_w, 0, canvas - new_h)))
            return self._detect(x, (h, w))

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        '''(B, canvas, canvas) f32 depth -> (B, 3, canvas, canvas), each
        channel less the model's pixel mean over its std.'''
        cfg = self.cfg
        x = x[:, None].expand(-1, 3, -1, -1)
        mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=x.device)
        return (x - mean[None, :, None, None]) / std[None, :, None, None]

    def _detect(self, x: torch.Tensor, frame_shape: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        '''The shared tail: x (B, 3, canvas, canvas), the normalized frames
        resized into the top-left corner -> detections at ``frame_shape``.'''
        h, w = frame_shape
        scale, new_h, new_w = self.test_geometry((h, w))
        b = x.shape[0]
        image_sizes = torch.tensor([[new_h, new_w]], dtype=torch.float32,
                                   device=x.device).repeat(b, 1)
        if self._exported_forward is not None and b == self.batch_size:
            out = self._exported_forward(x, image_sizes)
        else:
            out = self.model.inference(x, image_sizes)

        with span('predictor.to_frame'):
            inv = 1.0 / scale
            boxes = out['boxes'] * inv
            keypoints = out['keypoints'].clone()
            keypoints[..., :2] = keypoints[..., :2] * inv
            mask_canvas = out['masks'][:, :, :new_h, :new_w].float()
            masks = _resize_bilinear(mask_canvas, (h, w)) > 0.5
            masks = masks & out['valid'][:, :, None, None]
            keep, centers, iou = nms_and_centers(masks, out['scores'], out['valid'])
        return {'boxes': boxes, 'scores': out['scores'],
                'classes': out['classes'], 'valid': out['valid'],
                'masks': masks, 'keypoints': keypoints,
                'mask_probs': out['mask_probs'],
                'keep': keep, 'centers': centers, 'mask_iou': iou}

    @torch.no_grad()
    def predict_prescaled(self, canvas_frames, frame_shape: Tuple[int, int],
                          select: bool = True) -> Dict[str, torch.Tensor]:
        '''Detect on host-prescaled frames: ``canvas_frames`` (N, canvas,
        canvas) uint8 hold each frame already resized to its
        ResizeShortestEdge size in the top-left corner
        (``ops.preprocess.prescale_frames_host``), so neither the
        full-resolution frames nor the resize reach the device.
        ``frame_shape`` is the frames' own (H, W), at which the outputs come
        out, as :meth:`__call__`'s do. Batches as :meth:`__call__`; without
        ``select``, the selection's keys are left out.'''
        frames = torch.as_tensor(canvas_frames).to(self.device)
        n = frames.shape[0]
        pad = (-n) % self.batch_size
        if pad:
            frames = torch.cat([frames, frames.new_zeros((pad,) + tuple(frames.shape[1:]))])
        outs = []
        for i in range(0, frames.shape[0], self.batch_size):
            with span('predictor.batch', indexed=True):
                with span('predictor.resize_in'):
                    x = self._normalize(frames[i:i + self.batch_size].float())
                outs.append(self._detect(x, tuple(frame_shape)))
        out = {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}
        if not select:
            for key in ('keep', 'centers', 'mask_iou'):
                out.pop(key)
        return out

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
