'''Prep of depth frames: on the host, raw frames to the sentinel-encoded
chunk; on the device, decode, dropout fill and scale.

Port of ``moseq2_detectron_extract_tpu/ops/preprocess.py``
(``prep_raw_frames_host`` and its C++ core, lines 140-237;
``find_invalid_pixels``, line 20;
``fill_invalid_pixels`` and ``decode_prepped_frames``, lines 26-79 and
240-246; ``prep_raw_frames``, lines 108-137; ``bbox_from_roi`` and
``apply_roi``, lines 326-350; ``scale_raw_frames``, lines 353-366;
``compute_test_scale``; and the prescaled input's host side,
``fill_sentinels_host`` and ``prescale_frames_host``, lines 249-320, with
cv2's INTER_LINEAR resize of uint8 written out, since the card's machine
has no cv2).
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


def find_invalid_pixels(frames: torch.Tensor) -> torch.Tensor:
    '''Mask of invalid (Kinect dropout) pixels: raw value == 0, on the
    frames' device.'''
    return frames == 0


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


def fill_sentinels_host(frames: np.ndarray, sentinel: int) -> np.ndarray:
    '''Fill the sentinel (dropout) pixels of C-contiguous (N, H, W) frames
    in place: each takes the last valid value before it on its row, a
    leading run the first valid value of the row, a row with none 0. The
    host stand-in for the device fill, used only before the host resize of
    the prescaled input. Each run of sentinels along a row takes one source
    pixel, so the work is in the sentinels, not in the frame.'''
    if not frames.flags.c_contiguous:
        raise ValueError('fill_sentinels_host fills C-contiguous frames in place')
    w = frames.shape[-1]
    flat = frames.reshape(-1)
    pos = np.flatnonzero(flat == sentinel)
    if not len(pos):
        return frames
    col = pos % w
    start = np.ones(len(pos), bool)          # a run starts where the pixel before is valid
    start[1:] = (pos[1:] != pos[:-1] + 1) | (col[1:] == 0)
    first = np.flatnonzero(start)
    starts = pos[first]
    ends = pos[np.append(first[1:] - 1, len(pos) - 1)]
    src = np.where(starts % w > 0, starts - 1, np.where(ends % w < w - 1, ends + 1, -1))
    values = np.where(src >= 0, flat[np.maximum(src, 0)], 0).astype(frames.dtype)
    flat[pos] = values[np.cumsum(start) - 1]
    return frames


_COEF_BITS = 11                      # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_RESIZE_BLOCK = 16                   # frames resized at once (int32 working set ~10 MB)


def _linear_taps(src: int, dst: int, clamp: bool):
    '''cv2's bilinear taps along one axis: the first source index and the
    two 11-bit weights of each output index. The position is
    ``(d + 0.5) * scale - 0.5`` in f64 with ``scale = 1 / (dst / src)``, cast
    to f32; its floor is the index and the rest the fraction, both weights
    rounded half to even. Along x an index outside ``[0, src - 1)`` is
    clamped with fraction 0; along y the index stays, and each row read is
    clamped instead.'''
    scale = 1.0 / (dst / src)
    pos = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    first = np.floor(pos).astype(np.int64)
    frac = (pos - first.astype(np.float32)).astype(np.float32)
    if clamp:
        low = first < 0
        frac[low], first[low] = 0, 0
        high = first >= src - 1
        frac[high], first[high] = 0, src - 1
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(frac * np.float32(_COEF_SCALE)).astype(np.int64)
    return first, w0, w1


def resize_linear_u8(images: np.ndarray, width: int, height: int) -> np.ndarray:
    '''``cv2.resize(image, (width, height), interpolation=INTER_LINEAR)`` of
    each uint8 image of (..., H, W) ``images``, as OpenCV 5.0 computes it: the
    horizontal pass in exact integers, then the vertical pass as its vector
    code rounds, each 22-bit fixed-point sum taken as ``((s0 >> 4) * b0 >>
    16) + ((s1 >> 4) * b1 >> 16)``, then ``+ 2 >> 2`` and saturated to
    uint8. Every step fits int32.'''
    h, w = images.shape[-2:]
    sx, a0, a1 = _linear_taps(w, width, clamp=True)
    sy, b0, b1 = _linear_taps(h, height, clamp=False)
    x = images.astype(np.int32)
    rows = x[..., sx] * a0.astype(np.int32) + \
        x[..., np.minimum(sx + 1, w - 1)] * a1.astype(np.int32)
    s0 = rows[..., np.clip(sy, 0, h - 1), :]
    s1 = rows[..., np.clip(sy + 1, 0, h - 1), :]
    out = (((s0 >> 4) * b0.astype(np.int32)[:, None]) >> 16) + \
        (((s1 >> 4) * b1.astype(np.int32)[:, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def prescale_frames_host(frames: np.ndarray, cfg, vmin: float, vmax: float,
                         fill_sentinel=None) -> np.ndarray:
    '''The model's input on the host: (N, H, W) sentinel-encoded frames to
    (N, canvas, canvas) uint8 with the resized frame in the top-left corner
    (``Predictor.predict_prescaled``'s input). The sentinels are filled along
    the rows (:func:`fill_sentinels_host`), ``[vmin, vmax]`` is scaled onto
    0-255 in f32 and cast by numpy's ``astype('uint8')`` (out-of-range
    heights come out as numpy casts them, not saturated), then each frame is
    resized as cv2's INTER_LINEAR resizes it (:func:`resize_linear_u8`) to
    the ResizeShortestEdge size. ``frames`` is not modified.'''
    n, h, w = frames.shape
    canvas = cfg.image_size
    scale = compute_test_scale(h, w, cfg.min_size_test, cfg.max_size_test)
    new_h = min(int(h * scale + 0.5), canvas)
    new_w = min(int(w * scale + 0.5), canvas)
    out = np.zeros((n, canvas, canvas), np.uint8)
    # a block of frames at a time, each step's working set in the cache
    for i in range(0, n, _RESIZE_BLOCK):
        work = frames[i:i + _RESIZE_BLOCK].copy()
        if fill_sentinel is not None:
            work = fill_sentinels_host(work, int(fill_sentinel))
        scaled = ((work.astype('float32') - float(vmin))
                  * (255.0 / (float(vmax) - float(vmin)))).astype('uint8')
        out[i:i + _RESIZE_BLOCK, :new_h, :new_w] = scaled if (new_h, new_w) == (h, w) \
            else resize_linear_u8(scaled, new_w, new_h)
    return out
