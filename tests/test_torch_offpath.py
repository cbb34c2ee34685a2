'''The port's off-path ops against the JAX package, on the CPU.

* ``ops/cc.py``: ``connected_components`` and ``largest_cc`` bit for bit
  (labels, and the winner on a tie), on seeded random masks, two equal
  blobs, an empty frame and a spiral that 8 sweeps leave unconverged.
* ``ops/morphology.py:temporal_median`` bit for bit, and equal to
  ``scipy.signal.medfilt``.
* ``proc/features.py``: the general ``clean_frames`` bit for bit (every
  parameter other than extract's, which stays the fused clean, held to the
  JAX ops path on zero-bordered frames); ``get_frame_features`` with and
  without the largest component: masks equal, moments to 1e-5 (f32 sums
  in another order: 2.6e-6 measured); ``instances_to_features`` without
  trackers: centroids and axes to 1e-5, orientations to 1e-3 degrees on the
  circle (one within f32 rounding of 0 comes out near 0 on one side and
  near 360 on the other), flips equal.
* ``ops/instances.py``: ``pack_masks_cropped``/``unpack_masks_cropped``
  and ``gather_selected_mask_windows`` equal.
* ``utils/profiling.py``: ``enable_profiling`` writes both files at exit.
* The helpers without a JAX kernel: ``ops/preprocess.py:find_invalid_pixels``
  and ``ops/nms.py:topk_after_nms`` (ties to the lower index, fewer kept
  boxes than ``k``) equal; ``ops/roi_align.py:roi_align_level`` (the gather
  form on both sides, one level) to 1e-5 on unit-scale features (the f32
  tap weights and their sums in another order: 3.1e-6 measured);
  ``proc/keypoints.py:rotate_points`` and ``proc/util.py:slice_dict``
  (host numpy) bit for bit.

About 10 s on the CPU.
'''
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.signal
import torch

import jax.numpy as jnp

from moseq2_detectron_extract_tpu.ops import cc as jcc
from moseq2_detectron_extract_tpu.ops import instances as jinst
from moseq2_detectron_extract_tpu.ops import morphology as jmorph
from moseq2_detectron_extract_tpu.ops import nms as jnms
from moseq2_detectron_extract_tpu.ops import preprocess as jprep
from moseq2_detectron_extract_tpu.ops import roi_align as jroi
from moseq2_detectron_extract_tpu.proc import features as jfeatures
from moseq2_detectron_extract_tpu.proc import keypoints as jkeypoints
from moseq2_detectron_extract_tpu.proc import util as jutil
from moseq2_detectron_extract_tpu_torch.ops import cc, instances, morphology, nms, preprocess, \
    roi_align
from moseq2_detectron_extract_tpu_torch.proc import features, keypoints, util
from moseq2_detectron_extract_tpu_torch.utils.profiling import StageTimer

from tests.test_torch_brain import recipe_chunk

KEYS = ('centroid', 'orientation', 'axis_length')


def spiral(size: int = 41) -> np.ndarray:
    '''A one-pixel-wide square spiral: its label has to travel along ~20
    bends, far more than 8 row-and-column sweeps carry it.'''
    m = np.zeros((size, size), bool)
    y, x, dy, dx = 0, 0, 0, 1
    lo, hi = 0, size - 1
    top = 0
    while lo <= hi:
        m[y, x] = True
        ny, nx = y + dy, x + dx
        if not (top <= ny <= hi and lo <= nx <= hi):
            if (dy, dx) == (0, 1):
                dy, dx = 1, 0
            elif (dy, dx) == (1, 0):
                dy, dx = 0, -1
            elif (dy, dx) == (0, -1):
                dy, dx = -1, 0
                top += 2
            else:
                dy, dx = 0, 1
                lo, hi = lo + 2, hi - 2
            ny, nx = y + dy, x + dx
            if not (top <= ny <= hi + 2 and lo - 2 <= nx <= hi + 2) or m[ny, nx]:
                break
        y, x = ny, nx
    return m


def cc_masks() -> np.ndarray:
    rng = np.random.default_rng(0)
    blobs = rng.random((4, 41, 41)) < 0.45                 # many small components
    tie = np.zeros((41, 41), bool)
    tie[5:10, 5:10] = True
    tie[20:25, 30:35] = True                               # two blobs of 25 pixels
    empty = np.zeros((41, 41), bool)
    return np.concatenate([blobs, tie[None], empty[None], spiral()[None]])


def test_spiral_is_unconverged_after_8_sweeps():
    labels = np.asarray(jcc.connected_components(jnp.asarray(spiral()[None])))
    assert len(np.unique(labels[labels > 0])) > 1          # one component, several labels
    assert len(np.unique(np.asarray(jcc.connected_components(
        jnp.asarray(spiral()[None]), num_sweeps=64)))) == 2


@pytest.mark.parametrize('num_sweeps', [1, 8])
def test_connected_components_and_largest_cc_bit_for_bit(num_sweeps):
    masks = cc_masks()
    ours = cc.connected_components(torch.from_numpy(masks), num_sweeps=num_sweeps)
    ref = np.asarray(jcc.connected_components(jnp.asarray(masks), num_sweeps=num_sweeps))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    big = cc.largest_cc(torch.from_numpy(masks), num_sweeps=num_sweeps).numpy()
    np.testing.assert_array_equal(big, np.asarray(jcc.largest_cc(jnp.asarray(masks),
                                                                 num_sweeps=num_sweeps)))
    assert big[4].sum() == 25 and big[4, 5:10, 5:10].all()   # the smaller label wins the tie
    assert not big[5].any()


@pytest.mark.parametrize('window', [3, 5])
def test_temporal_median_bit_for_bit(window):
    frames = np.random.default_rng(window).integers(0, 256, (9, 12, 10)).astype('uint8')
    ours = morphology.temporal_median(torch.from_numpy(frames), window).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jmorph.temporal_median(
        jnp.asarray(frames), window)))
    np.testing.assert_array_equal(ours, scipy.signal.medfilt(frames, [window, 1, 1]))


@pytest.mark.parametrize('kwargs', [
    dict(prefilter_time=(3,), iters_tail=3), dict(prefilter_space=(3, 5), iters_tail=1),
    dict(iters_tail=2, iters_min=1, strel_min=np.ones((3, 3), np.uint8)),
    dict(prefilter_space=(0,), iters_tail=None, prefilter_time=(3, 5)),
    dict(iters_tail=3, frame_dtype='uint16'),
])
def test_general_clean_frames_bit_for_bit(kwargs):
    frames = np.random.default_rng(7).integers(0, 256, (6, 30, 34)).astype('uint8')
    ours = features.clean_frames(torch.from_numpy(frames), **kwargs)
    ref = np.asarray(jfeatures.clean_frames(frames, **kwargs))
    assert ours.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_extract_parameters_stay_the_fused_clean():
    raw, _, _ = recipe_chunk(n=4)
    ours = features.clean_frames(torch.from_numpy(raw), prefilter_space=(3,), iters_tail=3)
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jfeatures.clean_frames(raw, iters_tail=3)))


def _frames_for_features():
    raw, masks, _ = recipe_chunk(n=8)
    frames = raw.copy()
    frames[:, 5:9, 5:40] = 30                  # a second, smaller blob
    frames[2] = 0                              # an empty frame
    return frames, masks


@pytest.mark.parametrize('use_cc,mask_threshold,with_mask', [
    (False, -30, True), (True, -30, True), (True, 5, True), (True, 5, False)])
def test_get_frame_features(use_cc, mask_threshold, with_mask):
    frames, masks = _frames_for_features()
    mask = masks if with_mask else None
    ours, ours_mask = features.get_frame_features(
        torch.from_numpy(frames), frame_threshold=10, mask=mask,
        mask_threshold=mask_threshold, use_cc=use_cc)
    ref, ref_mask = jfeatures.get_frame_features(frames, frame_threshold=10, mask=mask,
                                                 mask_threshold=mask_threshold,
                                                 use_cc=use_cc)
    np.testing.assert_array_equal(ours_mask.numpy(), np.asarray(ref_mask))
    for key in KEYS:
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5, atol=1e-5, equal_nan=True)
    if use_cc and mask_threshold > 0 and not with_mask:
        assert not ours_mask.numpy()[:, 5:9, 5:40].any()   # the smaller blob left out
    # numpy frames go to the device asked for
    again, _ = features.get_frame_features(frames, mask=mask, use_cc=use_cc,
                                           mask_threshold=mask_threshold, device='cpu')
    np.testing.assert_array_equal(again['centroid'], ours['centroid'])


def test_instances_to_features_without_trackers():
    raw, masks, kpts = recipe_chunk(n=24)
    num = np.ones(len(raw), int)
    ours = features.instances_to_features(torch.from_numpy(masks), kpts, num,
                                          torch.from_numpy(raw), None, None)
    ref = jfeatures.instances_to_features(masks, kpts, num, raw, None, None)
    for key in ('centroid', 'axis_length'):
        np.testing.assert_allclose(ours['features'][key], ref['features'][key],
                                   rtol=1e-5, atol=1e-5)
    # an orientation within f32 rounding of 0 may come out near 0 or near
    # 360 degrees, then shifted by the 180-degree flips: compare on the circle
    turn = (ours['features']['orientation'] - ref['features']['orientation'] + 180) % 360 - 180
    assert np.abs(turn).max() < 1e-3, turn
    np.testing.assert_array_equal(ours['flips'], ref['flips'])
    np.testing.assert_array_equal(ours['masks'].numpy(), np.asarray(ref['masks']))


def test_pack_and_unpack_masks_cropped():
    rng = np.random.default_rng(3)
    masks = rng.random((5, 150, 170)) < 0.3
    centers = np.array([[20, 30], [160, 140], [85, 75], [np.nan, np.nan], [3.7, 149.9]],
                       np.float32)
    packed, origins = instances.pack_masks_cropped(torch.from_numpy(masks),
                                                   torch.from_numpy(centers), crop=64)
    ref_packed, ref_origins = jinst.pack_masks_cropped(jnp.asarray(masks),
                                                       jnp.asarray(centers), crop=64)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref_packed))
    np.testing.assert_array_equal(origins.numpy(), np.asarray(ref_origins))
    full = instances.unpack_masks_cropped(packed, origins, (150, 170), crop=64)
    np.testing.assert_array_equal(full, jinst.unpack_masks_cropped(
        ref_packed, ref_origins, (150, 170), crop=64))
    assert full.sum() > 0


def test_gather_selected_mask_windows():
    rng = np.random.default_rng(4)
    masks = rng.random((3, 2, 40, 50)) < 0.5
    kpts = rng.normal(size=(3, 2, 8, 3)).astype('float32')
    chosen = np.array([1, 0, 1], np.int32)
    has = np.array([True, False, True])
    origins = np.array([[0, 0], [8, 10], [8, 18]], np.int32)
    ours = instances.gather_selected_mask_windows(
        torch.from_numpy(masks), torch.from_numpy(kpts), torch.from_numpy(chosen).long(),
        torch.from_numpy(has), torch.from_numpy(origins), crop=32)
    ref = jinst.gather_selected_mask_windows(jnp.asarray(masks), jnp.asarray(kpts),
                                             jnp.asarray(chosen), jnp.asarray(has),
                                             jnp.asarray(origins), crop=32)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


def test_enable_profiling_writes_both_files(tmp_path):
    prefix = str(tmp_path / 'prof')
    script = ('from moseq2_detectron_extract_tpu_torch.utils.profiling import enable_profiling\n'
              f'enable_profiling({prefix!r})\nenable_profiling({prefix!r})\n'
              'sum(i * i for i in range(10000))\n')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    subprocess.run([sys.executable, '-c', script], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert os.path.getsize(prefix + '.prof_stats') > 0
    with open(prefix + '.txt', encoding='utf-8') as fh:
        assert 'cumulative' in fh.read()
    timer = StageTimer()
    with timer.time('a'):
        pass
    with timer.time('a'):
        pass
    assert timer.counts == {'a': 2} and set(timer.summary()) == {'a'}


def test_find_invalid_pixels_equal():
    frames = np.random.default_rng(5).integers(0, 4, (3, 20, 24)).astype(np.uint16)
    ours = preprocess.find_invalid_pixels(torch.from_numpy(frames.astype(np.int32)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jprep.find_invalid_pixels(frames)))
    assert ours.dtype == torch.bool and ours.any()


@pytest.mark.parametrize('k,kept', [(4, 10), (6, 3)], ids=['enough', 'padded'])
def test_topk_after_nms_equal(k, kept):
    rng = np.random.default_rng(k)
    boxes = rng.uniform(0, 50, (12, 4)).astype('float32')
    scores = np.round(rng.uniform(0, 1, 12), 1).astype('float32')    # ties
    keep = np.zeros(12, bool)
    keep[rng.permutation(12)[:kept]] = True
    ours = nms.topk_after_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                              torch.from_numpy(keep), k)
    ref = jnms.topk_after_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(keep), k)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ours[2].sum()) == min(k, kept)


@pytest.mark.parametrize('stride,k', [(4, 9), (8, 1), (16, 0)])
def test_roi_align_level_matches_jax(stride, k):
    rng = np.random.default_rng(stride)
    feat = rng.normal(size=(24, 30, 8)).astype('float32')
    xy = rng.uniform(-10, 30 * stride, (k, 2))
    wh = rng.uniform(4, 12 * stride, (k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype('float32')
    ours = roi_align.roi_align_level(torch.from_numpy(feat), torch.from_numpy(boxes), 7, stride)
    ref = jroi.roi_align_level(jnp.asarray(feat), jnp.asarray(boxes), 7, stride)
    assert tuple(ours.shape) == (k, 7, 7, 8) == tuple(ref.shape)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize('cols', [2, 3])
def test_rotate_points_bit_for_bit(cols):
    points = np.random.default_rng(cols).normal(20, 8, (8, cols))
    for center, angle in (((0, 0), 0), ((12.5, -3.0), 37.0), ((40, 40), -190.0)):
        np.testing.assert_array_equal(keypoints.rotate_points(points, center, angle),
                                      jkeypoints.rotate_points(points, center, angle))
    one = keypoints.rotate_points(points[:1], (1.0, 2.0), 90.0)
    np.testing.assert_array_equal(one, jkeypoints.rotate_points(points[:1], (1.0, 2.0), 90.0))
    with pytest.raises(ValueError, match='2 or 3 columns'):
        keypoints.rotate_points(np.zeros((4, 4)), (0, 0), 10)


def test_slice_dict_bit_for_bit():
    rng = np.random.default_rng(9)
    data = {'a': rng.normal(size=(5, 3)), 'b': np.arange(5), 'c': rng.normal(size=(5, 2, 2))}
    for index in (0, 3, slice(1, 4), np.array([4, 0])):
        ours, ref = util.slice_dict(data, index), jutil.slice_dict(data, index)
        assert list(ours) == list(ref)
        for key in ref:
            np.testing.assert_array_equal(ours[key], ref[key])
