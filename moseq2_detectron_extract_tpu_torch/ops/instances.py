'''Per-frame instance selection on device: mask-IoU NMS, centres, and the
gather of the chosen instance's window.

Port of ``moseq2_detectron_extract_tpu/ops/instances.py``
(``nms_and_centers``, lines 16-51; ``window_origins``, ``gather_selected``
and ``gather_selected_windows``, lines 117-193).
'''
import numpy as np
import torch


def nms_and_centers(masks: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, iou_threshold: float = 0.5):
    '''masks (N, D, H, W) bool; scores, valid (N, D).

    Returns keep (N, D) after the empty-mask filter and greedy mask-IoU NMS
    in score order (stable), centres (N, D, 2 [row, col]) with NaN for
    empty masks, and the mask IoU (N, D, D).
    '''
    n, d, h, w = masks.shape
    m = masks.reshape(n, d, h * w).float()
    area = m.sum(dim=2)
    valid = valid & (area > 0)

    inter = torch.einsum('ndp,nep->nde', m, m)
    union = area[:, :, None] + area[:, None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-9),
                      torch.zeros_like(inter))

    ranked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-ranked, dim=1, stable=True)
    keep = torch.zeros((n, d), dtype=torch.bool, device=masks.device)
    rows = torch.arange(n, device=masks.device)
    for r in range(d):
        i = order[:, r]
        frame_iou = iou[rows, i]                                  # (N, D)
        suppressed = torch.any(keep & (frame_iou > iou_threshold), dim=1)
        keep[rows, i] = valid[rows, i] & ~suppressed

    ygrid = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None] \
        .expand(h, w).reshape(h * w)
    xgrid = torch.arange(w, dtype=torch.float32, device=masks.device)[None, :] \
        .expand(h, w).reshape(h * w)
    safe_area = torch.clamp(area, min=1.0)
    cy = torch.einsum('ndp,p->nd', m, ygrid) / safe_area
    cx = torch.einsum('ndp,p->nd', m, xgrid) / safe_area
    centers = torch.stack([cy, cx], dim=-1)
    centers = torch.where((area > 0)[..., None], centers,
                          torch.full_like(centers, torch.nan))
    return keep, centers, iou


def window_origins(centers_xy, frame_shape, crop: int) -> np.ndarray:
    '''(N, 2 [y0, x0]) int32 origins of ``crop`` windows centred at
    ``centers_xy`` (x, y; NaN -> 0), clipped into ``frame_shape`` (numpy).'''
    h, w = frame_shape
    centers = np.nan_to_num(np.asarray(centers_xy, dtype='float64'))
    x0 = np.clip(centers[:, 0].astype('int32') - crop // 2, 0, max(w - crop, 0))
    y0 = np.clip(centers[:, 1].astype('int32') - crop // 2, 0, max(h - crop, 0))
    return np.stack([y0, x0], axis=-1).astype('int32')


def gather_selected(masks: torch.Tensor, keypoints: torch.Tensor,
                    chosen_idx: torch.Tensor, has_instance: torch.Tensor):
    '''One instance per frame: masks (N, D, H, W), keypoints (N, D, K, 3),
    chosen_idx (N,), has_instance (N,) -> (sel_masks (N, H, W) uint8,
    sel_keypoints (N, K, 3) f32, NaN where there is no instance).'''
    rows = torch.arange(masks.shape[0], device=masks.device)
    sel_masks = masks[rows, chosen_idx].to(torch.uint8) * \
        has_instance[:, None, None].to(torch.uint8)
    sel_kpts = keypoints[rows, chosen_idx].float()
    sel_kpts = torch.where(has_instance[:, None, None], sel_kpts,
                           torch.full_like(sel_kpts, torch.nan))
    return sel_masks, sel_kpts


def crop_windows(frames: torch.Tensor, origins: torch.Tensor, crop: int) -> torch.Tensor:
    '''(N, crop, crop) windows of (N, H, W) frames at (N, 2 [y0, x0]) origins
    (which lie inside the frame).'''
    n = frames.shape[0]
    ar = torch.arange(crop, device=frames.device)
    rr = origins[:, 0, None].long() + ar[None, :]
    cc = origins[:, 1, None].long() + ar[None, :]
    rows = torch.arange(n, device=frames.device)[:, None, None]
    return frames[rows, rr[:, :, None], cc[:, None, :]]


def gather_selected_windows(masks, keypoints, chosen_idx, has_instance,
                            origins, chunk, crop: int = 160):
    '''Gather the chosen instance per frame and slice ``crop`` windows at
    ``origins`` from its mask and from the depth chunk.

    Returns (mask_wins (N, crop, crop) uint8, sel_keypoints (N, K, 3),
    chunk_wins (N, crop, crop)).
    '''
    sel_masks, sel_kpts = gather_selected(masks, keypoints, chosen_idx, has_instance)
    return (crop_windows(sel_masks, origins, crop), sel_kpts,
            crop_windows(chunk, origins, crop))
