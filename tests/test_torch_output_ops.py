'''The port's output ops (``ops/warp.py``, ``ops/instances.py``'s bit packing,
``proc/keypoints.py``, ``proc/scalars.py``, ``proc/util.py``) against the
JAX package's, on the CPU.

Tolerances: crop-and-rotate is f32 on both sides, but XLA and torch differ
in the last ulp of ``cos``/``sin`` and in contracting multiply-adds (XLA
fuses the affine's ``a * x + b`` terms), so a source coordinate moves by up
to about 2.4e-6 px and a crop value by that times the step between
neighbouring pixels. The frames here hold heights of at most 110, as the
extract path's do (``min_height`` 0 and ``max_height`` 100 clip them), so
the f32 crops agree to 1e-3 (a step of 250 would take 1.5e-3); after
``clip(round(x))`` to uint8 they are equal except where a value sits within
that of a .5 edge (counted); the masks, thresholded at 0.5, likewise. Bit
packing, z lookup, the pixel counts and the height sums (integers summed in
f32, exact below 2**24) are equal, and so are the scalars and the keypoint
dict on the same host inputs, with the reference's keys and dtypes.
'''
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moseq2_detectron_extract_tpu.ops import instances as jinstances
from moseq2_detectron_extract_tpu.ops import warp as jwarp
from moseq2_detectron_extract_tpu.proc import keypoints as jkeypoints
from moseq2_detectron_extract_tpu.proc import scalars as jscalars
from moseq2_detectron_extract_tpu.proc import util as jutil
from moseq2_detectron_extract_tpu_torch.ops import instances as pinstances
from moseq2_detectron_extract_tpu_torch.ops import warp as pwarp
from moseq2_detectron_extract_tpu_torch.proc import keypoints as pkeypoints
from moseq2_detectron_extract_tpu_torch.proc import scalars as pscalars
from moseq2_detectron_extract_tpu_torch.proc import util as putil

CROP_TOL = 1e-3
H, W = 60, 72

# (centre x, y, angle): the interior, the frame's edges and beyond, fractional
# centres (the origin truncates), and the invalid ones (NaN, negative)
CASES = [(36.0, 30.0, 0.0), (36.7, 30.2, 33.3), (2.0, 3.0, 90.0), (71.0, 59.0, 45.0),
         (0.0, 0.0, -30.0), (80.0, 66.0, 180.0), (36.0, 30.0, 359.9), (10.4, 50.6, 271.0),
         (36.0, 30.0, np.nan), (np.nan, 30.0, 10.0), (-1.0, 30.0, 10.0), (36.0, -0.5, 10.0)]


def smooth_frames(n, seed=0, h=H, w=W):
    '''(n, h, w) uint8 heights like the extract path's: gradients (so that
    the bilinear weights matter) and a sharp block on a zero floor (so that
    edges do), at most 110.'''
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((n, h, w), np.uint8)
    for i in range(n):
        a, b = rng.uniform(0.5, 3, 2)
        img = 40 + 30 * np.sin(xx / (4 * a)) * np.cos(yy / (5 * b)) + rng.normal(0, 3, (h, w))
        img[:, :w // 6] = 0
        y0, x0 = rng.integers(0, h - 10), rng.integers(0, w - 10)
        img[y0:y0 + 10, x0:x0 + 10] = 100
        out[i] = np.clip(img, 0, 110).astype(np.uint8)
    return out


def _near_half(values, tol=CROP_TOL):
    return np.abs(values - np.floor(values) - 0.5) <= tol


@pytest.mark.parametrize('crop_size', [(80, 80), (40, 30)], ids=['80x80', '40x30'])
def test_crop_and_rotate_frames_matches_jax(crop_size):
    frames = smooth_frames(len(CASES))
    centers = np.array([c[:2] for c in CASES], np.float64)
    angles = np.array([c[2] for c in CASES], np.float64)
    ours = pwarp.crop_and_rotate_frames(torch.from_numpy(frames), centers, angles, crop_size)
    ref = np.asarray(jwarp.crop_and_rotate_frames(jnp.asarray(frames), jnp.asarray(centers),
                                                  jnp.asarray(angles), crop_size))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape == \
        (len(CASES), crop_size[1], crop_size[0])
    ours = ours.numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=CROP_TOL)
    for i in (8, 9, 10, 11):                          # NaN angle, NaN centre, negative centre
        assert not ours[i].any()
    assert ours[0].any() and ours[5].any()
    # the uint8 crops: equal but where a value sits on a .5 edge
    u8 = np.clip(np.round(ours), 0, 255).astype(np.uint8)
    u8_ref = np.clip(np.round(ref), 0, 255).astype(np.uint8)
    differ = u8 != u8_ref
    assert (~differ | _near_half(ref)).all()
    print(f'uint8 crops at .5 edges that differ: {int(differ.sum())} of {differ.size}')


def test_crop_and_rotate_masks_matches_jax():
    rng = np.random.default_rng(3)
    masks = np.zeros((len(CASES), H, W), np.uint8)
    for i in range(len(CASES)):
        y, x = rng.integers(10, H - 10), rng.integers(10, W - 10)
        masks[i, y - 8:y + 8, x - 12:x + 12] = 1
    centers = np.array([c[:2] for c in CASES])
    angles = np.array([c[2] for c in CASES])
    ours = pwarp.crop_and_rotate_frames(torch.from_numpy(masks), centers, angles).numpy()
    ref = np.asarray(jwarp.crop_and_rotate_frames(jnp.asarray(masks), jnp.asarray(centers),
                                                  jnp.asarray(angles), (80, 80)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=CROP_TOL)
    differ = (ours > 0.5) != (ref > 0.5)
    assert (~differ | (np.abs(ref - 0.5) <= CROP_TOL)).all()
    # packed, they are equal in every byte that holds no 0.5 edge
    packed = pinstances.packbits_device(torch.from_numpy(ours) > 0.5).numpy()
    ref_packed = np.asarray(jinstances.packbits_device(ref > 0.5))
    edges = np.packbits(np.abs(ref - 0.5) <= CROP_TOL, axis=-1) > 0
    np.testing.assert_array_equal(packed[~edges], ref_packed[~edges])
    print(f'mask pixels at 0.5 edges that differ: {int(differ.sum())} of {differ.size}')


@pytest.mark.parametrize('shape', [(3, 80, 80), (2, 5, 13), (4, 160), (1, 7)])
def test_packbits_matches_jax_and_numpy(shape):
    mask = np.random.default_rng(len(shape)).random(shape) > 0.5
    ours = pinstances.packbits_device(torch.from_numpy(mask))
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jinstances.packbits_device(mask)))
    np.testing.assert_array_equal(ours.numpy(), np.packbits(mask, axis=-1))
    np.testing.assert_array_equal(pinstances.unpackbits_host(ours, shape[-1]),
                                  jinstances.unpackbits_host(jinstances.packbits_device(mask),
                                                             shape[-1]))
    np.testing.assert_array_equal(pinstances.unpackbits_host(ours, shape[-1]), mask)


def _keypoints(n, k=8, seed=0, window=64):
    rng = np.random.default_rng(seed)
    kpts = np.stack([rng.uniform(-5, window + 5, (n, k)) + 100,
                     rng.uniform(-5, window + 5, (n, k)) + 40,
                     rng.uniform(0, 1, (n, k))], axis=-1)
    kpts[1, 3] = np.nan
    kpts[2] = np.nan
    return kpts


@pytest.mark.parametrize('windowed', [True, False], ids=['windows', 'frames'])
def test_z_lookup_matches_jax(windowed):
    n = 5
    kpts = _keypoints(n)
    origins = np.tile(np.array([[40, 100]], np.int32), (n, 1)) if windowed else None
    frames = smooth_frames(n, seed=2, h=64 if windowed else 120, w=64 if windowed else 180)
    ours = pkeypoints.dispatch_z_lookup(kpts, torch.from_numpy(frames), frame_origins=origins)
    ref = np.asarray(jkeypoints.dispatch_z_lookup(kpts, jnp.asarray(frames),
                                                  frame_origins=origins))
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == ref.shape == (n, 8)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_scalar_stats_match_jax():
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 120, (6, 40, 40)).astype(np.uint8) * (rng.random((6, 40, 40)) < 0.5)
    frames[2] = 0                                    # no pixel in range: height 0
    for lo, hi in ((0.0, 100.0), (10, 100)):
        n_ours, h_ours = pscalars.dispatch_scalar_stats(torch.from_numpy(frames), lo, hi)
        n_ref, h_ref = jscalars.dispatch_scalar_stats(frames, lo, hi)
        np.testing.assert_array_equal(n_ours.numpy(), np.asarray(n_ref))
        assert h_ours.dtype == torch.float32
        np.testing.assert_array_equal(h_ours.numpy(), np.asarray(h_ref))


def _track_features(n, seed=0):
    rng = np.random.default_rng(seed)
    feats = {'centroid': 200 + np.cumsum(rng.normal(0, 2, (n, 2)), axis=0),
             'orientation': rng.uniform(0, 360, n),
             'axis_length': rng.uniform(10, 60, (n, 2))}
    feats['centroid'][3] = np.nan
    feats['axis_length'][4] = np.nan
    return feats


def test_compute_scalars_matches_jax():
    n = 12
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 100, (n, 32, 32)).astype(np.uint8)
    feats = _track_features(n)
    ours = pscalars.compute_scalars(None, feats, 0.0, 100.0, 680.0,
                                    height_stats=pscalars.dispatch_scalar_stats(
                                        torch.from_numpy(frames), 0.0, 100.0))
    ref = jscalars.compute_scalars(None, feats, 0.0, 100.0, 680.0,
                                   height_stats=jscalars.dispatch_scalar_stats(frames, 0.0, 100.0))
    assert list(ours) == list(ref) and len(ours) == 17
    for key in ref:
        assert ours[key].dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    direct = pscalars.compute_scalars(torch.from_numpy(frames), feats, 0.0, 100.0, 680.0)
    for key in ref:
        np.testing.assert_array_equal(direct[key], ref[key], err_msg=key)


@pytest.mark.parametrize('windowed', [True, False], ids=['windows', 'frames'])
def test_keypoints_to_dict_matches_jax(windowed):
    n = 6
    kpts = _keypoints(n, seed=3)
    feats = _track_features(n, seed=4)
    origins = np.tile(np.array([[40, 100]], np.int32), (n, 1)) if windowed else None
    frames = smooth_frames(n, seed=4, h=64 if windowed else 120, w=64 if windowed else 180)
    ours = pkeypoints.keypoints_to_dict(
        kpts, None, feats['centroid'], feats['orientation'], true_depth=690.0,
        frame_origins=origins,
        z_data=pkeypoints.dispatch_z_lookup(kpts, torch.from_numpy(frames), origins))
    ref = jkeypoints.keypoints_to_dict(kpts, frames, feats['centroid'], feats['orientation'],
                                       true_depth=690.0, frame_origins=origins)
    assert list(ours) == list(ref) and len(ours) == 8 * 12
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    np.testing.assert_array_equal(pkeypoints.rotate_points_batch(kpts, feats['centroid'], 30.0),
                                  jkeypoints.rotate_points_batch(kpts, feats['centroid'], 30.0))
    assert pkeypoints.default_keypoint_names == jkeypoints.default_keypoint_names


def test_convert_pxs_to_mm_matches_jax():
    coords = np.random.default_rng(7).uniform(0, 512, (9, 4, 2))
    for depth in (673.1, 700.0):
        np.testing.assert_array_equal(putil.convert_pxs_to_mm(coords, true_depth=depth),
                                      jutil.convert_pxs_to_mm(coords, true_depth=depth))
    np.testing.assert_array_equal(putil.convert_pxs_to_mm(coords.astype(np.float32)),
                                  jutil.convert_pxs_to_mm(coords.astype(np.float32)))
