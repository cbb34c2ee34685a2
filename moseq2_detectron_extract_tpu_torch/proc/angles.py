'''Angle helpers and the moving-median flip filter of the untracked path.

Port of ``moseq2_detectron_extract_tpu/proc/angles.py``:
``clamp_angles_deg``, ``clamp_angles_rad``, ``angle_difference``, ``_move_median3``,
``_move_median``, ``filter_angles`` and ``iterative_filter_angles`` (lines
16-95), and the host feature smoothing ``hampel_filter``,
``feature_hampel_filter`` and ``interpolate_nan_values`` (98-144). The
reference jits the flip filter in f32 (no x64) and iterates it in a
``while_loop`` to a fixpoint under ``jnp.allclose``'s defaults; here it is
f32 numpy with the same operations, the same fixpoint test and the same
``max_iters``, so it gives its numbers bit for bit. The smoothing is f64
numpy in both packages, the same operations in the same order.
'''
import warnings

import numpy as np

_F32 = np.float32


def clamp_angles_deg(angles):
    '''Clamp angles into [0, 360).'''
    angles = np.asarray(angles)
    return np.where(angles < 0, 360 + angles, angles) % 360


def clamp_angles_rad(angles):
    '''Clamp angles into [0, 2*pi), in f32 as the reference computes it
    (JAX without x64).'''
    angles = np.asarray(angles, dtype=_F32)
    two_pi = _F32(2 * np.pi)
    return np.where(angles < 0, two_pi + angles, angles) % two_pi


def angle_difference(angles1, angles2):
    '''Smallest signed difference angles2 - angles1 in degrees, in (-180, 180].'''
    diff = (np.asarray(angles2) - np.asarray(angles1)) % 360
    return np.where(diff > 180, -(360 - diff), diff)


def _move_median3(a):
    '''Trailing moving median, window 3, min_count 1 (bottleneck.move_median):
    index 0 -> a[0]; index 1 -> mean(a[0], a[1]); index >= 2 -> median of 3.'''
    n = a.shape[0]
    prev1 = np.concatenate([a[:1], a[:-1]])
    prev2 = np.concatenate([a[:1], a[:1], a[:-2]])
    med3 = np.sort(np.stack([a, prev1, prev2]), axis=0)[1]
    idx = np.arange(n)
    out = np.where(idx >= 2, med3, a)
    out = np.where(idx == 1, (a + prev1) / _F32(2.0), out)
    return out


def _move_median(a, window: int):
    '''Trailing moving median with partial windows averaged like bottleneck
    (min_count=1): NaN-padded history and a NaN-median.'''
    if window == 3:
        return _move_median3(a)
    hist = [a]
    for k in range(1, window):
        hist.append(np.concatenate([np.full((k,), np.nan, a.dtype), a[:-k]]))
    with np.errstate(invalid='ignore'):
        return np.nanmedian(np.stack(hist), axis=0).astype(a.dtype)


def filter_angles(angles, window: int = 3, tolerance: float = 60.0):
    '''One pass of ~180-degree flip correction against a trailing moving
    median (f32).'''
    angles = np.asarray(angles, _F32)
    eff_window = min(window, int(angles.shape[0]))
    windows = _move_median(angles, eff_window)
    diff = angles - windows
    absdiff = np.abs(diff)
    flips = (absdiff > _F32(180 - tolerance)) & (absdiff < _F32(180 + tolerance))
    return np.where(flips, angles - _F32(180) * np.sign(diff), angles)


def _isclose(a, b, rtol: float = 1e-5, atol: float = 1e-8):
    '''``jnp.isclose`` in f32: |a - b| <= atol + rtol |b|, False where either
    side is NaN or infinite, True where both are the same infinity.'''
    with np.errstate(invalid='ignore'):
        out = np.abs(a - b) <= _F32(atol) + _F32(rtol) * np.abs(b)
        a_inf, b_inf = np.isinf(a), np.isinf(b)
        out &= ~(a_inf | b_inf)
        out |= a_inf & b_inf & (a == b)
    return out


def iterative_filter_angles(angles, window: int = 3, tolerance: float = 60.0,
                            max_iters: int = 1000):
    '''Iterate :func:`filter_angles` to a fixpoint (at most ``max_iters``
    more passes). Returns (filtered_angles f32, flips), flips marking the
    angles that ended up ~180 degrees from their input.'''
    angles = np.asarray(angles, _F32)
    last, curr, it = angles, filter_angles(angles, window, tolerance), 1
    while it <= max_iters and not _isclose(curr, last).all():
        last, curr, it = curr, filter_angles(curr, window, tolerance), it + 1
    flips = _isclose(np.abs(curr - angles), _F32(180.0))
    return curr, flips


def hampel_filter(data: np.ndarray, span: int, sigma: float = 3) -> np.ndarray:
    '''Hampel (median/MAD) outlier replacement over a sliding window of
    ``span`` samples, NaN-padded by ``span // 2`` at both ends: a value
    further than ``sigma`` MADs from its window's median becomes the median.
    1-D data, or 2-D data column by column; a copy in f64.'''
    data = np.asarray(data, dtype=float).copy()

    def _filter_1d(col):
        padded = np.pad(col, (span // 2, span // 2), 'constant', constant_values=np.nan)
        windows = np.lib.stride_tricks.sliding_window_view(padded, span)
        with warnings.catch_warnings():     # an all-NaN window's median is NaN
            warnings.simplefilter('ignore', RuntimeWarning)
            med = np.nanmedian(windows, axis=1)
            mad = np.nanmedian(np.abs(windows - med[:, None]), axis=1)
        vals = np.abs(col - med[:len(col)])
        fill = vals > med[:len(col)] + sigma * mad[:len(col)]
        col[fill] = med[:len(col)][fill]
        return col

    if data.ndim == 1:
        return _filter_1d(data)
    if data.ndim == 2:
        for i in range(data.shape[1]):
            data[:, i] = _filter_1d(data[:, i])
        return data
    raise ValueError(f'cannot accept data with {data.ndim} dimentions!')


def feature_hampel_filter(features: dict, centroid_hampel_span=None, centroid_hampel_sig=3,
                          angle_hampel_span=None, angle_hampel_sig=3) -> dict:
    '''Hampel-filter the centroid's x column and the orientation of a
    features dict in place (a span of None or 0 leaves that feature);
    returns the dict.'''
    if centroid_hampel_span is not None and centroid_hampel_span > 0:
        features['centroid'][:, 0] = hampel_filter(
            features['centroid'][:, 0], centroid_hampel_span, centroid_hampel_sig)
    if angle_hampel_span is not None and angle_hampel_span > 0:
        features['orientation'] = hampel_filter(
            features['orientation'], angle_hampel_span, angle_hampel_sig)
    return features


def interpolate_nan_values(data: np.ndarray) -> np.ndarray:
    '''Linear interpolation over the NaN entries of 1-D data (held at the
    first and last finite values beyond them); all-NaN data comes back as
    it is. A copy in f64.'''
    data = np.asarray(data, dtype=float).copy()
    nans = np.isnan(data)
    if nans.all():
        return data
    idx = np.arange(len(data))
    data[nans] = np.interp(idx[nans], idx[~nans], data[~nans])
    return data
