'''ROI discovery of the port against the JAX package's: the structuring
elements, the background median, the plane RANSAC and its draws, the ROI
masks, and ``Session.find_roi`` with and without its TIFF caches.

Held exactly: the elements (to cv2's), the median blur, the background,
the RANSAC draws (the port writes JAX's threefry and XLA's CPU cumsum order
in numpy), the ROI masks and the true depth. The plane is held to 1e-5 on
the unit normal and 1e-3 mm on d: both sides compute it in f32 from the same
three points, in another order of operations.
'''
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu.io.session import Session as JaxSession
from moseq2_detectron_extract_tpu.ops.morphology import median_blur as jax_median_blur
from moseq2_detectron_extract_tpu.ops.ransac import plane_ransac as jax_plane_ransac
from moseq2_detectron_extract_tpu.proc.roi import get_bground_im as jax_bground
from moseq2_detectron_extract_tpu.proc.roi import get_roi as jax_get_roi
from moseq2_detectron_extract_tpu_torch.io.session import Session
from moseq2_detectron_extract_tpu_torch.ops.morphology import (ELLIPSE_9X9, ELLIPSE_10X10,
                                                               make_ellipse_strel, median_blur,
                                                               select_strel)
from moseq2_detectron_extract_tpu_torch.ops.ransac import (plane_ransac, uniform,
                                                           weighted_choice, xla_cumsum)
from moseq2_detectron_extract_tpu_torch.proc.roi import get_bground_im, get_roi, rank_max
from moseq2_detectron_extract_tpu_torch.synthetic import rough_arena

from tests.synthetic import make_background, write_synthetic_session

NORMAL_TOL, D_TOL = 1e-5, 1e-3


def arena_image(seed=0, tilt=0.04):
    '''A 128 x 192 background: a tilted noisy floor near 700 in the arena,
    walls at 500, a 600-mm box on the floor (a hole in the floor's region)
    and a disconnected 690-mm ledge in a corner (a second region).'''
    rng = np.random.default_rng(seed)
    image = make_background()
    yy, xx = np.mgrid[0:128, 0:192]
    floor = image == 700.0
    image[floor] += tilt * (xx[floor] - 96) + rng.normal(0, 1.5, floor.sum())
    image[50:60, 90:104] = 600.0
    image[0:14, 0:22] = 690.0 + rng.normal(0, 1.0, (14, 22))
    return image


def test_ellipses_are_cv2s():
    assert ELLIPSE_10X10.sum() == 83 and ELLIPSE_9X9.sum() == 57
    np.testing.assert_array_equal(ELLIPSE_10X10,
                                  cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (10, 10)))
    for w in range(1, 16):
        for h in range(1, 16):
            np.testing.assert_array_equal(
                make_ellipse_strel((w, h)), cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (w, h)))
    np.testing.assert_array_equal(select_strel('ellipse', (10, 10)), ELLIPSE_10X10)
    np.testing.assert_array_equal(select_strel('rect', (5, 3)), np.ones((3, 5), np.uint8))
    np.testing.assert_array_equal(select_strel('e', (7, 4)),
                                  cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (7, 4)))


@pytest.mark.parametrize('ksize', [3, 5, 7])
def test_median_blur_matches_jax_on_int16(ksize):
    frames = np.random.default_rng(ksize).integers(-3000, 3000, (3, 37, 53)).astype('int16')
    ours = median_blur(torch.from_numpy(frames), ksize).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_median_blur(jnp.asarray(frames), ksize)))


@pytest.mark.parametrize('count', [1, 2, 3, 4])
def test_bground_im_bit_exact(count):
    '''Odd counts take the middle value; even ones the mean of the two middle
    values, as jnp.median does.'''
    rng = np.random.default_rng(count)
    frames = rng.integers(400, 900, (count, 40, 56)).astype('int16')
    ours = get_bground_im(frames, device='cpu')
    ref = jax_bground(frames)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    if count % 2 == 0:
        assert (ours != np.round(ours)).any()          # halves: the mean was taken


@pytest.mark.parametrize('seed', [0, 1, 42, 2 ** 31 + 3])
def test_uniform_draws_are_jaxs(seed):
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (1000, 3)))
    np.testing.assert_array_equal(uniform(seed, (1000, 3)), ref)


@pytest.mark.parametrize('size', [17, 24576, 217088])
def test_cumsum_in_xlas_order(size):
    x = np.random.default_rng(size).random(size).astype('float32')
    np.testing.assert_array_equal(xla_cumsum(x), np.asarray(jax.jit(jnp.cumsum)(x)))


@pytest.mark.parametrize('seed', [0, 5])
@pytest.mark.parametrize('shape', [(128, 192), (424, 512)])
def test_weighted_choice_is_jaxs(seed, shape):
    '''All 3000 indices agree with jax.random.choice on an arena-like mask.'''
    rng = np.random.default_rng(seed)
    valid = (rng.random(shape) < 0.7).astype('float32').ravel()
    probs = valid / np.float32(valid.sum())
    ref = np.asarray(jax.jit(lambda key, p: jax.random.choice(
        key, p.shape[0], shape=(1000, 3), replace=True, p=p))(jax.random.PRNGKey(seed), probs))
    ours = weighted_choice(seed, probs, (1000, 3))
    assert (ours == ref).mean() == 1.0
    assert valid[ours].all()


def test_rank_max_is_scipys():
    import scipy.stats
    values = np.array([3.0, 1.0, 3.0, 2.0, -1.0, 3.0])
    np.testing.assert_array_equal(rank_max(values), scipy.stats.rankdata(values, method='max'))


@pytest.mark.parametrize('with_mask', [False, True])
def test_plane_ransac_matches_jax(with_mask):
    image = arena_image(seed=1)
    mask = None
    if with_mask:
        mask = np.ones(image.shape, bool)
        mask[:, :40] = False
    plane, dists = plane_ransac(image, mask=mask, device='cpu')
    ref_plane, ref_dists = (np.asarray(v) for v in jax_plane_ransac(image, mask=mask))
    np.testing.assert_allclose(plane[:3], ref_plane[:3], atol=NORMAL_TOL)
    np.testing.assert_allclose(plane[3], ref_plane[3], atol=D_TOL)
    np.testing.assert_allclose(dists, ref_dists, atol=D_TOL + 200 * NORMAL_TOL)
    centre_depth = -(plane[0] * 96 + plane[1] * 64 + plane[3]) / plane[2]
    assert abs(plane[2]) > 0.95 and abs(centre_depth - 700) < 10


@pytest.fixture
def writable_jax_dists(monkeypatch):
    '''The JAX package's get_roi writes into the distances that its
    plane_ransac returns as a read-only view of a device array, and raises
    with ``gradient_filter`` on: hand it a writable copy.'''
    import moseq2_detectron_extract_tpu.proc.roi as jax_roi
    ransac = jax_roi.plane_ransac

    def copied(*args, **kwargs):
        plane, dists = ransac(*args, **kwargs)
        return plane, np.array(dists)

    monkeypatch.setattr(jax_roi, 'plane_ransac', copied)


@pytest.mark.parametrize('kwargs', [
    {},
    {'dilate_shape': 'rect', 'dilate_size': (5, 3)},
    {'fill_holes': False},
    {'gradient_filter': True},
    {'erode_size': (4, 4), 'dilate_size': (7, 7)},
    {'weights': (0.1, 1.0, 0.1)},
], ids=['defaults', 'rect', 'no-fill', 'gradient', 'erode', 'weights'])
def test_get_roi_masks_match_jax(kwargs, writable_jax_dists):
    image = arena_image(seed=2)
    rois, plane = get_roi(image, device='cpu', **kwargs)
    ref_rois, ref_plane = jax_get_roi(image, **kwargs)
    assert len(rois) == len(ref_rois) >= 2                 # the arena and the ledge
    for ours, ref in zip(rois, ref_rois):
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(plane[:3], np.asarray(ref_plane)[:3], atol=NORMAL_TOL)
    np.testing.assert_allclose(plane[3], np.asarray(ref_plane)[3], atol=D_TOL)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_get_roi_matches_jax_where_planes_compete(seed, writable_jax_dists):
    '''``rough_arena``: a floor rough by 8 mm, where the accept rule takes
    several hypotheses in turn before it settles; the same ROIs and plane.'''
    image = rough_arena(128, 192, seed)
    rois, plane = get_roi(image, device='cpu')
    ref_rois, ref_plane = jax_get_roi(image)
    assert len(rois) == len(ref_rois) >= 2                 # the arena and the ledge
    for ours, ref in zip(rois, ref_rois):
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(plane[:3], np.asarray(ref_plane)[:3], atol=NORMAL_TOL)
    np.testing.assert_allclose(plane[3], np.asarray(ref_plane)[3], atol=D_TOL)


@pytest.fixture(scope='module')
def long_session(tmp_path_factory):
    '''501 frames: the background is the median of frames 0 and 500.'''
    path = str(tmp_path_factory.mktemp('long'))
    return write_synthetic_session(path, nframes=501, seed=6)


def find_both(dat, cache_dirs=(None, None), frame_trim=(0, 0), **kwargs):
    ours = Session(dat, frame_trim=frame_trim).find_roi(cache_dir=cache_dirs[0], device='cpu',
                                                        **kwargs)
    ref = JaxSession(dat, frame_trim=frame_trim).find_roi(cache_dir=cache_dirs[1], **kwargs)
    return ours, ref


def assert_found_equal(ours, ref):
    for name, a, b in zip(('first_frame', 'bground_im', 'roi'), ours[:3], ref[:3]):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours[3] == ref[3]


@pytest.mark.parametrize('frame_trim', [(0, 0), (1, 0)], ids=['two-frames', 'trimmed'])
def test_find_roi_matches_jax(long_session, frame_trim):
    ours, ref = find_both(long_session, frame_trim=frame_trim)
    assert_found_equal(ours, ref)
    assert ours[2].sum() > 0.5 * ours[2].size


def test_find_roi_caches_match_jax(long_session, tmp_path):
    '''Cold caches, then warm ones; then each package reads the other's.'''
    dirs = (str(tmp_path / 'port'), str(tmp_path / 'jax'))
    for d in dirs:
        os.makedirs(d)
    cold = find_both(long_session, dirs)
    assert_found_equal(*cold)
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) == sorted(
        ['first_frame.tiff', 'bground.tiff', 'roi_00.tiff'] +
        [n + '.scale.json' for n in ('first_frame.tiff', 'bground.tiff', 'roi_00.tiff')])
    warm = find_both(long_session, dirs)
    assert_found_equal(*warm)
    np.testing.assert_array_equal(warm[0][2], cold[0][2])
    crossed = find_both(long_session, dirs[::-1])
    assert_found_equal(*crossed)
    assert_found_equal(crossed[0], warm[1])


def test_find_roi_plane_background_matches_jax(long_session):
    '''The background is the plane's depth at each pixel (f64); on this
    session the two planes come out bit for bit the same.'''
    ours, ref = find_both(long_session, use_plane_bground=True)
    assert_found_equal(ours, ref)
    assert ours[1].dtype == np.float64
