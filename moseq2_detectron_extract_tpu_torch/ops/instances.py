'''Per-frame instance selection on device: mask-IoU NMS, centres, and the
gather of the chosen instance's window.

Port of ``moseq2_detectron_extract_tpu/ops/instances.py``
(``nms_and_centers``, lines 16-51; ``packbits_device`` and
``unpackbits_host``, lines 55-75; ``pack_masks_cropped`` and
``unpack_masks_cropped``, lines 78-116; ``window_origins``,
``gather_selected``, ``gather_selected_windows`` and
``gather_selected_mask_windows``, lines 117-193).
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


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits_device(mask: torch.Tensor) -> torch.Tensor:
    '''Pack a boolean (..., W) mask into (..., ceil(W/8)) uint8 on its
    device, most significant bit first (``np.unpackbits``' order).'''
    w = mask.shape[-1]
    m = mask.to(torch.uint8)
    pad = (-w) % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.reshape(m.shape[:-1] + (-1, 8))
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=mask.device)
    return (m * weights).sum(dim=-1, dtype=torch.uint8)


def unpackbits_host(packed, width: int) -> np.ndarray:
    '''Inverse of :func:`packbits_device`: (..., width) uint8 0/1 numpy.'''
    arr = packed.cpu().numpy() if torch.is_tensor(packed) else np.asarray(packed)
    return np.unpackbits(arr, axis=-1)[..., :width]


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


def gather_selected_mask_windows(masks, keypoints, chosen_idx, has_instance, origins,
                                 crop: int = 160):
    ''':func:`gather_selected_windows` without the depth windows: (mask_wins
    (N, crop, crop) uint8, sel_keypoints (N, K, 3)). The prescaled input
    keeps no full-resolution depth on the device; its depth windows are cut
    on the host.'''
    sel_masks, sel_kpts = gather_selected(masks, keypoints, chosen_idx, has_instance)
    return crop_windows(sel_masks, origins, crop), sel_kpts


def pack_masks_cropped(masks: torch.Tensor, centers: torch.Tensor, crop: int = 128):
    '''Bit-pack a ``crop`` x ``crop`` window of each (N, H, W) mask around its
    centre (N, 2 [x, y], NaN for an empty frame, taken as 0), the window's
    origin clamped into the frame (the frame must be at least ``crop`` on
    each side). Returns (packed (N, crop, crop / 8) uint8, origins (N, 2
    [y0, x0]) int32).'''
    n, h, w = masks.shape
    cx = torch.nan_to_num(centers[:, 0]).to(torch.int32)
    cy = torch.nan_to_num(centers[:, 1]).to(torch.int32)
    x0 = torch.clamp(cx - crop // 2, 0, max(w - crop, 0))
    y0 = torch.clamp(cy - crop // 2, 0, max(h - crop, 0))
    origins = torch.stack([y0, x0], dim=-1)
    crops = crop_windows(masks.to(torch.uint8), origins, crop)
    return packbits_device(crops > 0), origins


def unpack_masks_cropped(packed, origins, frame_shape, crop: int = 128) -> np.ndarray:
    '''Inverse of :func:`pack_masks_cropped` on the host: (N, H, W) uint8.'''
    crops = unpackbits_host(packed, crop)
    origins = origins.cpu().numpy() if torch.is_tensor(origins) else np.asarray(origins)
    h, w = frame_shape
    out = np.zeros((crops.shape[0], h, w), np.uint8)
    for i, (y0, x0) in enumerate(origins):
        out[i, y0:y0 + crop, x0:x0 + crop] = crops[i]
    return out
