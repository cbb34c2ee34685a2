'''The prescaled input (``--device-input prescaled``) against the JAX
package, on the CPU.

* ``fill_sentinels_host`` bit for bit, on frames with leading, trailing and
  whole-row dropout runs.
* ``prescale_frames_host`` bit for bit against the JAX function (which
  resizes with cv2 5.0) over seeded frames of several sizes: ROI-cropped
  sizes, odd widths, downscales and upscales, and heights below
  ``min_height`` and above ``max_height``; ``resize_linear_u8`` against
  ``cv2.resize`` on 300 random sizes.
* The chain: the seed-9 session of ``test_torch_extract_session`` through
  the port's ``extract_chunks`` and the JAX package's ``InferenceStep`` ->
  ``SelectInstancesStep`` -> ``ProcessFeaturesStep`` ->
  ``FetchResultsStep``, both with ``device_input='prescaled'``: detections
  at the slice test's tolerances (``SCORE_TOL``, ``FLIPS``, boxes 0.5 px,
  keypoints one heatmap bin), window origins, instance counts and the
  filled depth windows equal; then the port's back end fed the reference's
  selection, every fetched key at ``assert_back_end_matches``'s tolerances,
  the crops cut from the filled windows.

About 25 s on the CPU.
'''
import cv2
import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu.ops import preprocess as jprep
from moseq2_detectron_extract_tpu_torch.extract import extract_chunks, prepare_session
from moseq2_detectron_extract_tpu_torch.io.session import Session
from moseq2_detectron_extract_tpu_torch.ops import preprocess
from moseq2_detectron_extract_tpu_torch.ops.warp import crop_and_rotate_frames
from moseq2_detectron_extract_tpu_torch.pipeline.steps import (InferenceStep, fetch_results,
                                                               make_feature_trackers,
                                                               process_features)

from tests.synthetic import make_background, write_synthetic_session
from tests.test_torch_common import tiny_jax_config
from tests.test_torch_extract_session import (CONFIG, F64_TOL, FLIPS, SCORE_TOL,
                                              assert_back_end_matches, jax_chunks,
                                              make_predictors)
from tests.test_torch_slice import _assert_keypoints_close, _np

PRESCALED = dict(CONFIG, device_input='prescaled')


def dropout_frames(rng, n, h, w):
    frames = rng.integers(0, 255, (n, h, w)).astype('uint8')
    frames[rng.random((n, h, w)) < 0.05] = 255
    frames[0, 3, :4] = 255                     # a leading run
    frames[0, 4, -3:] = 255                    # a trailing run
    frames[-1, 5] = 255                        # a whole row
    return frames


def test_fill_sentinels_host_bit_for_bit():
    frames = dropout_frames(np.random.default_rng(0), 3, 20, 30)
    ours = preprocess.fill_sentinels_host(frames.copy(), 255)
    ref = jprep.fill_sentinels_host(frames.copy(), 255)
    np.testing.assert_array_equal(ours, ref)
    assert not (ours == 255).any() and (ours[-1, 5] == 0).all()
    clean = np.zeros((1, 4, 4), np.uint8)
    assert preprocess.fill_sentinels_host(clean, 255) is clean


# (height, width): the ROI crops of the synthetic sessions, odd widths,
# upscales to a 64 px canvas, downscales, and a frame at the canvas's size
SIZES = [(96, 128), (101, 77), (37, 129), (211, 255), (64, 64), (423, 511), (19, 33)]


@pytest.mark.parametrize('size', SIZES)
def test_prescale_frames_host_bit_for_bit(size):
    rng = np.random.default_rng(sum(size))
    frames = dropout_frames(rng, 3, *size)
    frames[1, :2] = 254                        # above max_height once scaled
    cfg = tiny_jax_config(min_size_test=60, max_size_test=64)
    for vmin, vmax in ((0, 100), (10, 80), (0, 254)):
        ours = preprocess.prescale_frames_host(frames, cfg, vmin, vmax, fill_sentinel=255)
        ref = jprep.prescale_frames_host(frames, cfg, vmin, vmax, fill_sentinel=255)
        assert ours.dtype == np.uint8 and ours.shape == (3, 64, 64)
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        preprocess.prescale_frames_host(frames, cfg, 0, 100),
        jprep.prescale_frames_host(frames, cfg, 0, 100))            # no fill


def test_resize_linear_u8_is_cv2s():
    rng = np.random.default_rng(5)
    for _ in range(300):
        h, w = rng.integers(1, 140, 2)
        new_h, new_w = (int(v) for v in rng.integers(1, 200, 2))
        image = rng.integers(0, 256, (h, w)).astype('uint8')
        np.testing.assert_array_equal(
            preprocess.resize_linear_u8(image, new_w, new_h),
            cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_LINEAR),
            err_msg=str((h, w, new_h, new_w)))


@pytest.fixture(scope='module')
def prescaled(tmp_path_factory):
    '''The seed-9 session through both packages with the prescaled input.'''
    predictors = make_predictors()
    path = write_synthetic_session(str(tmp_path_factory.mktemp('raw')), nframes=40, seed=9)
    session = Session(path)
    session._bground_im = make_background()
    prepared = prepare_session(session, PRESCALED, device='cpu')
    ours = list(extract_chunks(session, predictors[0], prepared))
    _, ref = jax_chunks(path, predictors[1], PRESCALED, str(tmp_path_factory.mktemp('jax')),
                        read_only=False)
    return ours, ref, prepared


def test_prescaled_detections_and_windows(prescaled):
    ours, ref, _ = prescaled
    assert len(ours) == len(ref) == 2
    found = 0
    for a, b in zip(ours, ref):
        assert 'chunk_dev' not in a
        # the reference zeroes its chunk's sentinels in place; extract_chunks
        # yields the chunk as read
        np.testing.assert_array_equal(np.where(a['chunk'] == 255, 0, a['chunk']), b['chunk'])
        ia, ib = a['inference'], b['inference']
        for key in ('valid', 'keep'):
            np.testing.assert_array_equal(_np(ia[key]), _np(ib[key]))
        gaps = np.abs(_np(ia['scores']) - _np(ib['scores']))
        assert (gaps <= SCORE_TOL).all(), gaps.max()
        np.testing.assert_allclose(_np(ia['boxes']), _np(ib['boxes']), atol=0.5)
        _assert_keypoints_close(_np(ia['keypoints'])[:, 0, :, :2],
                                _np(ib['keypoints'])[:, 0, :, :2], _np(ib['boxes'])[:, 0])
        flips = (_np(ia['masks']) != _np(ib['masks'])).sum(axis=(2, 3))
        assert (flips <= FLIPS * _np(ib['masks']).sum(axis=(2, 3))).all()
        for key in ('num_instances', 'win_origins'):
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(_np(a['raw_windows']), _np(b['raw_windows']))
        found += int((a['num_instances'][:a['nframes']] > 0).sum())
    assert found >= 20


def _to_port_prescaled(sel):
    def t(x):
        return torch.from_numpy(np.array(x))
    dispatch = sel['feat_dispatch']
    return {'feat_dispatch': {'cleaned_frames': t(dispatch['cleaned_frames']),
                              'feat_masks': t(dispatch['feat_masks']),
                              'feats_dev': {k: t(v) for k, v in dispatch['feats_dev'].items()},
                              'window_origins': np.asarray(dispatch['window_origins'])},
            'sel_keypoints': t(sel['sel_keypoints']), 'num_instances': sel['num_instances'],
            'frame_idxs': sel['frame_idxs'], 'win_origins': np.asarray(sel['win_origins']),
            'raw_windows': t(sel['raw_windows']),
            'height_stats': tuple(t(x) for x in sel['height_stats'])}


def test_prescaled_back_end_matches_jax(prescaled):
    '''The port's back end on the reference's prescaled selection: the depth
    crops come from the filled windows at window-local centroids.'''
    _, ref, prepared = prescaled
    trackers = make_feature_trackers(prepared)
    for b in ref:
        ours = fetch_results(process_features(_to_port_prescaled(b), prepared, trackers),
                             prepared)
        centroid = ours['features']['features']['centroid']
        local = centroid - np.asarray(b['win_origins'])[:, ::-1]
        # assert_back_end_matches finds the crops' rounding edges on
        # ``chunk_dev``: with the prescaled input the crops come from the
        # windows, so hand it a chunk whose crops at the frame's centroids
        # are the windows' at the local ones
        windows = np.array(b['raw_windows'])
        depth = crop_and_rotate_frames(torch.from_numpy(windows), local,
                                       ours['features']['features']['orientation'],
                                       prepared['crop_size']).numpy()
        assert ours['depth_frames'].shape == depth.shape
        sel = dict(b, chunk_dev=_shifted(windows, np.asarray(b['win_origins']),
                                         np.asarray(b['chunk']).shape[1:]))
        assert_back_end_matches(ours, b['fetched'], sel, prepared)
        np.testing.assert_allclose(ours['features']['features']['centroid'],
                                   b['fetched']['features']['features']['centroid'],
                                   **F64_TOL)


def _shifted(windows, origins, frame_shape):
    '''Frames holding each window at its origin and 0 elsewhere: their crops
    at frame centroids are the windows' crops at local centroids.'''
    out = np.zeros((len(windows),) + tuple(frame_shape), windows.dtype)
    c = windows.shape[1]
    for i, (y0, x0) in enumerate(origins):
        out[i, y0:y0 + c, x0:x0 + c] = windows[i]
    return out


def test_inference_step_goes_back_to_full_for_uint16(caplog):
    step = InferenceStep(step_name='inference',
                         config={'device_input': 'prescaled', 'predictor': object()})
    step.initialize()
    assert step.device_input == 'prescaled'
    with pytest.raises(Exception):
        step.process({'chunk': np.zeros((1, 4, 4), np.uint16), 'frame_idxs': [0]})
    assert step.device_input == 'full'
    assert 'falling back to full-resolution' in caplog.text
