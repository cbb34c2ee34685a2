'''Feature stage of the selected detection windows: clean, then moments.

Port of ``moseq2_detectron_extract_tpu/proc/features.py`` (``clean_frames``,
lines 46-80; ``_frame_features_nocc``; ``dispatch_instance_features``,
lines 224-257). ``clean_frames`` takes the extract defaults (median 3,
9x9-ellipse open x3, uint8) only, which is the fused clean: the CUDA kernel
on the card, its bit-exact plain version on the CPU. Both follow the TPU
kernel's zero halo, which equals the cv2-border ops path on zero-bordered
frames.
'''
from typing import Dict

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.ops.clean_kernel import fused_clean_frames
from moseq2_detectron_extract_tpu_torch.ops.moments import mask_moment_features


def clean_frames(frames: torch.Tensor) -> torch.Tensor:
    '''3x3 median + three openings with the 9x9 ellipse of (N, H, W) frames,
    as uint8: the extract defaults (``prefilter_space=(3,)``,
    ``iters_tail=3``), the only parameters ported.'''
    return fused_clean_frames(frames.to(torch.uint8))


def frame_features_nocc(cleaned: torch.Tensor, model_masks: torch.Tensor,
                        frame_threshold: float):
    '''threshold AND model mask -> moments (the largest-CC term, statically
    all-true for uint8 frames and a negative CC threshold, is skipped).'''
    frame_mask = (cleaned > frame_threshold) & (model_masks > 0)
    return mask_moment_features(frame_mask), frame_mask


def dispatch_instance_features(masks: torch.Tensor, raw_frames: torch.Tensor,
                               window_origins=None) -> Dict:
    '''Clean the windows and take their moments, without a host sync.

    ``window_origins`` (N, 2 [y0, x0]) shifts the centroids back into
    frame coordinates.
    '''
    cleaned = clean_frames(raw_frames)
    if window_origins is not None:
        feats, feat_masks = frame_features_nocc(cleaned, masks, 3.0)
        origins = torch.as_tensor(np.asarray(window_origins), device=cleaned.device)
        offset = origins.flip(-1).to(feats['centroid'].dtype)       # x, y
        feats = dict(feats, centroid=feats['centroid'] + offset)
    else:
        if masks is None:
            model_masks = torch.ones(cleaned.shape, dtype=torch.uint8,
                                     device=cleaned.device)
        else:
            model_masks = masks.to(torch.uint8)
        feats, feat_masks = frame_features_nocc(cleaned, model_masks, 3.0)
    return {'cleaned_frames': cleaned, 'feat_masks': feat_masks,
            'feats_dev': feats, 'window_origins': window_origins}
