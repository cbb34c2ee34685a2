'''Prep of depth frames: on the host, raw frames to the sentinel-encoded
chunk; on the device, decode, dropout fill and scale.

Port of ``moseq2_detectron_extract_tpu/ops/preprocess.py``
(``prep_raw_frames_host`` and its C++ core, lines 140-237;
``fill_invalid_pixels`` and ``decode_prepped_frames``, lines 26-79 and
240-246; ``prep_raw_frames``, lines 108-137; ``bbox_from_roi`` and
``apply_roi``, lines 326-350; ``scale_raw_frames``, lines 353-366;
``compute_test_scale``).
'''
import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.device import resolve_device


def bbox_from_roi(roi: np.ndarray):
    '''((y0, x0), (y1, x1)) of the mask's positive pixels, or None when it
    is empty. (y1, x1) is the inclusive max, which the callers slice with as
    an exclusive end, dropping the last row and column: the reference does
    so, and the port keeps it for parity.'''
    ys, xs = np.nonzero(np.asarray(roi) > 0)
    if len(ys) == 0:
        return None
    return (int(ys.min()), int(xs.min())), (int(ys.max()), int(xs.max()))


def apply_roi(frames: np.ndarray, roi: np.ndarray) -> np.ndarray:
    '''Frames (N, H, W) masked by ``roi`` and cropped to its bbox; a single
    (H, W) frame is cropped only.'''
    frames = np.asarray(frames)
    roi = np.asarray(roi)
    if frames.ndim == 3:
        frames = frames * roi
    bbox = bbox_from_roi(roi)
    if bbox is not None:
        (y0, x0), (y1, x1) = bbox
        frames = frames[:, y0:y1, x0:x1] if frames.ndim == 3 else frames[y0:y1, x0:x1]
    return frames


def _crop_to_roi(frames, bground_im, roi):
    '''Frames, background and ROI cropped to the ROI's bbox.'''
    if roi is None:
        return frames, bground_im, None
    roi = np.asarray(roi)
    bbox = bbox_from_roi(roi)
    if bbox is None:
        return frames, bground_im, roi
    (y0, x0), (y1, x1) = bbox
    if bground_im is not None:
        bground_im = np.asarray(bground_im)[y0:y1, x0:x1]
    return frames[:, y0:y1, x0:x1], bground_im, roi[y0:y1, x0:x1]


def prep_raw_frames_host(frames: np.ndarray, bground_im=None, roi=None, vmin=None, vmax=None,
                         dtype='uint8') -> np.ndarray:
    '''Raw (N, H, W) depth to the chunk the device path takes: cropped to
    the ROI's bbox, height above the background (``bground_im - raw``, the
    background truncated to int32), masked by the ROI, zero below
    ``ceil(vmin)``, clipped at ``min(vmax, max - 1)``, and the Kinect
    dropouts (raw 0) set to ``dtype``'s max as a sentinel that the device
    decodes and fills.

    uint16 frames, or int16 frames with no negative value (the on-disk
    ``'<i2'`` read, viewed as uint16), go to uint8 through the C++ core
    (``csrc/prep_host.cpp``), which is built on first use; a failed build
    raises. Other dtypes take the plain numpy version.
    '''
    frames, bground_im, roi_crop = _crop_to_roi(np.asarray(frames), bground_im, roi)
    if frames.ndim == 3 and frames.dtype == np.int16 and frames.size and frames.min() >= 0:
        frames = frames.view(np.uint16)
    if frames.ndim == 3 and frames.dtype == np.uint16 and np.dtype(dtype) == np.uint8:
        return _prep_frames_cxx(frames, bground_im, roi_crop, vmin, vmax)
    return _prep_frames_plain(frames, bground_im, roi_crop, vmin, vmax, dtype)


def prep_raw_frames_plain(frames: np.ndarray, bground_im=None, roi=None, vmin=None, vmax=None,
                          dtype='uint8') -> np.ndarray:
    ''':func:`prep_raw_frames_host` in plain numpy for every dtype (the
    reference the C++ core is held to).'''
    frames, bground_im, roi_crop = _crop_to_roi(np.asarray(frames), bground_im, roi)
    return _prep_frames_plain(frames, bground_im, roi_crop, vmin, vmax, dtype)


def _prep_frames_plain(frames, bground_im, roi_crop, vmin, vmax, dtype) -> np.ndarray:
    invalid = frames == 0
    x = frames.astype('int32', copy=True)
    if bground_im is not None:
        np.subtract(np.asarray(bground_im, dtype='int32')[None], x, out=x)
    if roi_crop is not None:
        x *= roi_crop.astype('int32')
    if vmin is not None:
        x[x < int(np.ceil(vmin))] = 0
    info = np.iinfo(np.dtype(dtype))
    hi = int(vmax) if vmax is not None else info.max - 1
    np.clip(x, 0 if vmin is not None else info.min, min(hi, info.max - 1), out=x)
    out = x.astype(dtype)
    out[invalid] = info.max
    return out


def _prep_frames_cxx(frames: np.ndarray, bground_im, roi_crop, vmin: Optional[float],
                     vmax: Optional[float]) -> np.ndarray:
    '''The C++ core on uint16 (N, h, w) frames, uint8 out.'''
    if frames.strides[2] != 2 or frames.strides[1] < 0 or frames.strides[0] < 0:
        frames = np.ascontiguousarray(frames)
    t, h, w = frames.shape
    bg = None if bground_im is None else np.ascontiguousarray(bground_im, dtype=np.int32)
    roi32 = None if roi_crop is None else np.ascontiguousarray(roi_crop, dtype=np.int32)
    for name, arr in (('bground_im', bg), ('roi', roi32)):
        if arr is not None and arr.shape != (h, w):
            raise ValueError(f'{name} of shape {arr.shape} for frames of {(h, w)}')
    hi = min(int(vmax) if vmax is not None else 254, 254)
    out = np.empty((t, h, w), np.uint8)
    if out.size == 0:
        return out
    u8p, i32p = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int32)
    rc = native.load_host_library().prep_frames_native(
        frames.ctypes.data_as(u8p), frames.strides[0], frames.strides[1],
        None if bg is None else bg.ctypes.data_as(i32p),
        None if roi32 is None else roi32.ctypes.data_as(i32p),
        t, h, w, int(vmin is not None), 0 if vmin is None else int(np.ceil(vmin)),
        0, hi, 255, out.ctypes.data_as(u8p))
    if rc != 0:
        raise RuntimeError(f'prep_frames_native returned {rc}')
    return out


def _neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    '''Sum of the 4 neighbours with zeros outside, in the reference's order
    (above + below + left + right).'''
    return (F.pad(x, (0, 0, 1, 0))[:, :-1, :] + F.pad(x, (0, 0, 0, 1))[:, 1:, :]
            + F.pad(x, (1, 0, 0, 0))[:, :, :-1] + F.pad(x, (0, 1, 0, 0))[:, :, 1:])


def fill_invalid_pixels(frames: torch.Tensor, invalid_mask: torch.Tensor,
                        iterations: int = 32) -> torch.Tensor:
    '''Fill masked pixels of (N, H, W) frames with a smooth membrane.

    Holes are seeded with the frame's valid mean, grown from the valid
    boundary for 8 sweeps, then relaxed with ``iterations`` Jacobi sweeps;
    integer frames are rounded half to even and clipped.
    '''
    dtype = frames.dtype
    x = frames.float()
    invalid = invalid_mask.bool()
    valid = ~invalid

    count_valid = torch.clamp(valid.sum(dim=(1, 2), keepdim=True), min=1)
    mean_valid = torch.where(valid, x, torch.zeros_like(x)).sum(
        dim=(1, 2), keepdim=True) / count_valid
    x = torch.where(invalid, mean_valid, x)

    known = valid
    for _ in range(8):
        kn = known.float()
        num = _neighbor_sum(x * kn)
        den = _neighbor_sum(kn)
        grown = den > 0
        fill = num / torch.clamp(den, min=1.0)
        x = torch.where(~known & grown, fill, x)
        known = known | grown

    ones = torch.ones_like(x)
    den = torch.clamp(_neighbor_sum(ones), min=1.0)
    for _ in range(iterations):
        smoothed = _neighbor_sum(x * ones) / den
        x = torch.where(invalid, smoothed, x)

    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        x = torch.clamp(torch.round(x), info.min, info.max)
    return x.to(dtype)


def decode_prepped_frames(frames: torch.Tensor, fill_iterations: int = 16) -> torch.Tensor:
    '''Sentinel (dtype max) pixels are dropouts: zero them and fill them.'''
    sentinel = torch.iinfo(frames.dtype).max
    invalid = frames == sentinel
    cleared = torch.where(invalid, torch.zeros_like(frames), frames)
    return fill_invalid_pixels(cleared, invalid, iterations=fill_iterations)


def prep_raw_frames(frames: np.ndarray, bground_im=None, roi=None, vmin=None, vmax=None,
                    dtype='uint8', fill_iterations: int = 16, device='cuda') -> torch.Tensor:
    '''Raw (N, H, W) depth to ``dtype`` heights on ``device``, dropouts
    filled: the JAX package's device prep. Frames, background and ROI are
    cropped to the ROI's bbox on the host; on the device, in f32, the
    height is ``bground_im - raw``, masked by the ROI, zero below ``vmin``
    and clipped at ``vmax`` and at ``dtype``'s range; after the cast the
    pixels that were raw 0 are filled (:func:`fill_invalid_pixels`). Unlike
    the host prep, no height is taken for a dropout sentinel.'''
    device = resolve_device(device)
    frames, bground_im, roi_crop = _crop_to_roi(np.asarray(frames), bground_im, roi)
    if frames.dtype == np.uint16:
        raw = torch.from_numpy(np.ascontiguousarray(frames).view(np.int16)).to(device)
        raw = raw.to(torch.int32) & 0xFFFF
    else:
        raw = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    out_dtype = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
    invalid = raw == 0
    x = raw.float()
    if bground_im is not None:
        x = torch.from_numpy(np.asarray(bground_im, np.float32)).to(device)[None] - x
    if roi_crop is not None:
        x = x * torch.from_numpy(np.asarray(roi_crop, np.float32)).to(device)[None]
    if vmin is not None:
        x = torch.where(x < float(vmin), torch.zeros_like(x), x)
    if vmax is not None:
        x = torch.clamp(x, max=float(vmax))
    if not out_dtype.is_floating_point:
        info = torch.iinfo(out_dtype)
        x = torch.clamp(x, info.min, info.max)
    return fill_invalid_pixels(x.to(out_dtype), invalid, iterations=fill_iterations)


def scale_raw_frames(frames: torch.Tensor, vmin: float, vmax: float,
                     dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    '''Rescale [vmin, vmax] linearly onto ``dtype``'s range.

    The float -> integer cast saturates and maps NaN to 0, as XLA's does;
    a plain torch cast would wrap.
    '''
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
    else:
        info = torch.iinfo(dtype)
    dmin, dmax = float(info.min), float(info.max)
    x = frames.float()
    y = (x - float(vmin)) * ((dmax - dmin) / (float(vmax) - float(vmin))) + dmin
    if not dtype.is_floating_point:
        y = torch.clamp(torch.nan_to_num(y, nan=0.0), dmin, dmax)
    return y.to(dtype)


def compute_test_scale(height: int, width: int, min_size: int, max_size: int) -> float:
    '''ResizeShortestEdge scale.'''
    scale = min_size / min(height, width)
    if max(height, width) * scale > max_size:
        scale = max_size / max(height, width)
    return scale
