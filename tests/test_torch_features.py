'''Device prep, instance selection ops, moments, tracker and the window
feature stage: the port against the JAX package on the CPU.

Tolerances. Dropout fill: the seed mean is an f32 sum over the frame taken
in another order, so a filled pixel may round to the neighbouring integer:
|diff| <= 1 on filled pixels, exact elsewhere. Scale, gathers, keep masks
and the tracker: exact. Moments and centres: f32 sums over up to 10^4
pixels in another order, 1e-4 relative.
'''
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moseq2_detectron_extract_tpu.ops import instances as jinst
from moseq2_detectron_extract_tpu.ops.moments import mask_moment_features as jax_moments
from moseq2_detectron_extract_tpu.ops.preprocess import (decode_prepped_frames as jax_decode,
                                                         scale_raw_frames as jax_scale)
from moseq2_detectron_extract_tpu.proc.features import \
    dispatch_instance_features as jax_dispatch
from moseq2_detectron_extract_tpu.proc.tracker import CentroidTracker as JaxTracker
from moseq2_detectron_extract_tpu_torch.ops import instances as tinst
from moseq2_detectron_extract_tpu_torch.ops.moments import mask_moment_features
from moseq2_detectron_extract_tpu_torch.ops.preprocess import (decode_prepped_frames,
                                                               scale_raw_frames)
from moseq2_detectron_extract_tpu_torch.proc.features import dispatch_instance_features
from moseq2_detectron_extract_tpu_torch.proc.tracker import CentroidTracker
from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk


def test_decode_prepped_frames():
    chunk = make_sentinel_chunk(3, 64, 80, seed=1, dropout_rate=0.02)
    chunk[0, 10:14, 10:16] = 255                 # a larger hole
    ours = decode_prepped_frames(torch.from_numpy(chunk)).numpy().astype(int)
    ref = np.asarray(jax_decode(jnp.asarray(chunk))).astype(int)
    filled = chunk == 255
    np.testing.assert_array_equal(ours[~filled], ref[~filled])
    assert np.abs(ours - ref).max() <= 1
    assert (ours[filled] == ref[filled]).mean() > 0.95


@pytest.mark.parametrize('vmin,vmax', [(0, 100), (10, 60), (0, 255)])
def test_scale_raw_frames_saturates_like_xla(vmin, vmax):
    frames = np.arange(256, dtype='uint8').reshape(16, 16)[None]
    ours = scale_raw_frames(torch.from_numpy(frames), vmin, vmax)
    ref = jax_scale(jnp.asarray(frames), vmin, vmax)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _random_masks(rng, n=4, d=3, h=24, w=30):
    masks = np.zeros((n, d, h, w), bool)
    for i in range(n):
        for j in range(d):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            masks[i, j, y0:y0 + rng.integers(3, 8), x0:x0 + rng.integers(3, 8)] = True
    masks[0, 1] = masks[0, 0]                    # duplicate: suppressed
    masks[1, 2] = False                          # empty: dropped, NaN centre
    return masks


def test_nms_and_centers():
    rng = np.random.default_rng(2)
    masks = _random_masks(rng)
    scores = np.round(rng.uniform(0, 1, (4, 3)), 1).astype('float32')
    scores[2] = 0.5                              # tied scores: index order
    valid = rng.random((4, 3)) > 0.2
    keep, centers, iou = tinst.nms_and_centers(torch.from_numpy(masks),
                                               torch.from_numpy(scores),
                                               torch.from_numpy(valid))
    rk, rc, ri = jinst.nms_and_centers(jnp.asarray(masks), jnp.asarray(scores),
                                       jnp.asarray(valid))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rk))
    np.testing.assert_allclose(centers.numpy(), np.asarray(rc), rtol=1e-6)
    np.testing.assert_allclose(iou.numpy(), np.asarray(ri), rtol=1e-6)


def test_window_gather():
    rng = np.random.default_rng(3)
    n, d, h, w, crop = 5, 2, 40, 50, 24
    masks = rng.random((n, d, h, w)) > 0.5
    kpts = rng.normal(0, 10, (n, d, 8, 3)).astype('float32')
    chunk = rng.integers(0, 255, (n, h, w)).astype('uint8')
    chosen = rng.integers(0, d, n).astype('int32')
    has = np.array([True, False, True, True, True])
    centers = np.array([[5, 5], [np.nan, np.nan], [25, 20], [49, 39], [30, 1]], float)
    origins = tinst.window_origins(centers, (h, w), crop)
    np.testing.assert_array_equal(origins, jinst.window_origins(centers, (h, w), crop))
    ours = tinst.gather_selected_windows(
        torch.from_numpy(masks), torch.from_numpy(kpts), torch.from_numpy(chosen).long(),
        torch.from_numpy(has), torch.from_numpy(origins), torch.from_numpy(chunk), crop=crop)
    ref = jinst.gather_selected_windows(
        jnp.asarray(masks), jnp.asarray(kpts), jnp.asarray(chosen), jnp.asarray(has),
        jnp.asarray(origins), jnp.asarray(chunk), crop=crop)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_moment_features():
    rng = np.random.default_rng(4)
    masks = rng.random((4, 60, 70)) > 0.7
    masks[1] = False                              # empty: NaN features
    ours = mask_moment_features(torch.from_numpy(masks))
    ref = jax_moments(jnp.asarray(masks))
    for key in ('centroid', 'orientation', 'axis_length'):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4)


def test_tracker_sequences_match():
    rng = np.random.default_rng(5)
    ours, ref = CentroidTracker(50, 3), JaxTracker(50, 3)
    pos = rng.uniform(50, 150, (3, 2))
    for _ in range(40):
        pos += rng.normal(0, 8, pos.shape)
        centers = pos + rng.normal(0, 2, pos.shape)
        valid = rng.random(3) > 0.3
        centers[rng.random(3) > 0.9] = np.nan
        a = ours.update(centers, valid)
        b = ref.update(centers, valid)
        assert [(o.age, o.hit_counter, o.last_detection_index) for o in a] == \
            [(o.age, o.hit_counter, o.last_detection_index) for o in b]


def test_dispatch_instance_features_on_zero_bordered_windows():
    '''The window stage with the extract defaults: clean (the fused clean's
    plain version here, the ops path in the JAX package off-TPU; equal on
    zero-bordered windows) and moments.'''
    rng = np.random.default_rng(6)
    windows = decode_prepped_frames(torch.from_numpy(
        make_sentinel_chunk(4, 96, 96, seed=6, axes=(18, 9)))).numpy()
    masks = (windows > 0).astype('uint8')
    masks[:, rng.integers(0, 96, 40), rng.integers(0, 96, 40)] = 0
    origins = rng.integers(0, 300, (4, 2)).astype('int32')
    ours = dispatch_instance_features(torch.from_numpy(masks), torch.from_numpy(windows),
                                      window_origins=origins)
    ref = jax_dispatch(jnp.asarray(masks), jnp.asarray(windows), window_origins=origins)
    np.testing.assert_array_equal(ours['cleaned_frames'].numpy(),
                                  np.asarray(ref['cleaned_frames']))
    np.testing.assert_array_equal(ours['feat_masks'].numpy(), np.asarray(ref['feat_masks']))
    for key in ('centroid', 'orientation', 'axis_length'):
        np.testing.assert_allclose(ours['feats_dev'][key].numpy(),
                                   np.asarray(ref['feats_dev'][key]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('src,dst', [((424, 512), (129, 156)), ((40, 52), (64, 83)),
                                     ((64, 64), (64, 64))])
def test_predictor_resize_matches_jax_image_resize(src, dst):
    '''The predictor's input resize (and its mask upscale): bilinear with
    half-pixel centres, anti-aliased on a downscale like
    ``jax.image.resize``. 1e-3 absolute on 0..255 values (f32 weights summed
    in another order).'''
    import jax
    from moseq2_detectron_extract_tpu_torch.models.predictor import _resize_bilinear
    frames = np.random.default_rng(7).integers(0, 256, (2,) + src).astype('float32')
    ours = _resize_bilinear(torch.from_numpy(frames), dst)
    ref = jax.image.resize(jnp.asarray(frames), (2,) + dst, method='bilinear')
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3)


def test_predictor_geometry_matches_jax():
    from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
    from moseq2_detectron_extract_tpu.ops.preprocess import compute_test_scale as jax_scale
    from moseq2_detectron_extract_tpu_torch.ops.preprocess import compute_test_scale
    cfg = JaxModelConfig(image_size=160, min_size_test=150, max_size_test=156)
    for h, w in ((424, 512), (512, 424), (100, 100), (150, 400)):
        assert compute_test_scale(h, w, cfg.min_size_test, cfg.max_size_test) == \
            jax_scale(h, w, cfg.min_size_test, cfg.max_size_test)
