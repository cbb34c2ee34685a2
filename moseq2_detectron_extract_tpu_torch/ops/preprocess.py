'''Device prep of sentinel-encoded depth frames: decode, dropout fill, scale.

Port of ``moseq2_detectron_extract_tpu/ops/preprocess.py``
(``fill_invalid_pixels`` and ``decode_prepped_frames``, lines 26-79 and
240-246; ``scale_raw_frames``, lines 353-366; ``compute_test_scale``).
'''
import torch
import torch.nn.functional as F


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
