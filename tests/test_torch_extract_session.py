'''The slice as a whole: a raw session on disk through the port's
``prepare_session`` + ``extract_chunks`` against the JAX package's
``Session.find_roi`` + ``ProduceFramesStep`` + ``InferenceStep`` +
``SelectInstancesStep``, chunk by chunk, with the committed tiny trained
model on the CPU (both sides computing the model in f32).

Held exactly: the ROI, the true depth, the prepped chunks, ``frame_idxs``,
offsets, window origins, the number of instances and the raw windows; and,
as a second witness, ``extract_chunks``'s output is bit for bit
``process_chunk``'s on the reference's own chunks, so that every difference
from JAX below is ``process_chunk``'s and none the session path's.

Detections are held to ``SCORE_TOL`` and ``FLIPS`` (mask pixels that
differ, over the mask's area). Both sides pool with bf16 weights and a bf16
intermediate (test_torch_roi_align); over six sessions (seeds 9 and 1-5, 174
detections; run this file as a module with the seeds to print them) the
largest gaps were scores 3.06e-4 and no mask pixel. (When the port pooled in
f32 and rounded once, they were 7.03e-3 and 1.63% of a weak detection's mask,
and the tolerances went by reference score.) The sessions here are seed 9
and the two seeds with the largest gaps then (1 for the score, 4 for the
flips).

The back end (the host brain and the output ops; 40 frames in chunks of 32,
so the trackers cross a chunk boundary and the tail is padded, or not):

- Chained: the port's ``process_features`` + ``fetch_results`` fed the
  reference's own selection outputs, against JAX's ``ProcessFeaturesStep``
  + ``FetchResultsStep`` on the same data, with ``pad_chunks`` on and off on
  both sides. Every output key with the reference's dtype; the brain's f64
  values to 1e-8 (the smoothers and the angle filter meet the reference's
  scans to that, ``test_torch_brain.py``), f32 scalars to their rounding
  (1e-4 absolute: two values that agree to 1e-8 may round to neighbouring
  f32 near 200 px, 1.5e-5 apart, and the velocities are their differences),
  the pixel counts, heights, z and arena masks equal, and the uint8 crops
  and masks equal except where the port's f32 value sits within 1e-3 of a
  .5 edge (``test_torch_output_ops.py``).
- End to end: the port on its own detections against the reference on its
  own. At least 99% of all true frames agree in their flip and in their
  orientation (mod 360) to the slice's moments tolerance, 0.02 rad (all 204
  do; 189 did while the pooling rounded otherwise), no frame's window
  moments differ beyond that tolerance, and in the agreeing frames the
  smoothed centroid agrees to 0.5 px. A frame that differs must be one where
  the reference's flip vote or alignment score is within one keypoint's
  tolerance (one heatmap bin and 0.5 px) of its threshold.

The slice written: the port's ``extract_session`` (its pipeline threads, on
the CPU) and its CLI (a model directory written from the tiny params) on the
seed-9 session. The status says ``complete: true``; every per-frame dataset
of the results file equals the port's own ``extract_chunks`` bit for bit;
the metadata (ROI, background, true depth, first frame, timestamps,
parameters, acquisition metadata) equals the file that the JAX package's
``extract_session`` writes for the same session and config; an extracted
session is skipped.
'''
import os

import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu.io.session import Session as JaxSession
from moseq2_detectron_extract_tpu.models.checkpoint import load_params_npz
from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
from moseq2_detectron_extract_tpu.models.predictor import Predictor as JaxPredictor
from moseq2_detectron_extract_tpu.pipeline.steps import (FetchResultsStep, InferenceStep,
                                                         ProcessFeaturesStep, ProduceFramesStep,
                                                         SelectInstancesStep)
from moseq2_detectron_extract_tpu.proc import features as jfeatures
from moseq2_detectron_extract_tpu.proc.keypoints import rotate_points_batch
from moseq2_detectron_extract_tpu_torch.extract import (DEFAULT_CONFIG, extract_chunks,
                                                        make_tracker, prepare_session,
                                                        process_chunk)
from moseq2_detectron_extract_tpu_torch.ops.warp import crop_and_rotate_frames
from moseq2_detectron_extract_tpu_torch.pipeline.steps import (fetch_results,
                                                               make_feature_trackers,
                                                               process_features)
from moseq2_detectron_extract_tpu_torch.io.session import Session
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
from moseq2_detectron_extract_tpu_torch.models.weights import load_params_npz as port_load_npz
from moseq2_detectron_extract_tpu_torch.models.weights import params_from_jax

from tests.synthetic import make_background, write_synthetic_session
from tests.test_torch_common import port_config
from tests.test_torch_slice import _assert_keypoints_close, _np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
NFRAMES = 40
SEEDS = (9, 1, 4)
STRONG = 0.8                          # the readings' bands (run as a module)
SCORE_TOL, FLIPS = 1e-3, 0.005
CONFIG = {'chunk_size': 32, 'min_height': 0, 'max_height': 100, 'feature_window': 96,
          'expected_instances': 1}


def make_predictors():
    '''The port's and the JAX package's predictors of the tiny trained model.'''
    cfg = JaxModelConfig.from_yaml(os.path.join(DATA, 'tiny_overfit_config.yaml')) \
        .replace(amp_dtype='float32')
    npz = os.path.join(DATA, 'tiny_overfit_params.npz')
    ours = Predictor(port_config(cfg), params_from_jax(port_load_npz(npz)), batch_size=8,
                     device='cpu')
    return ours, JaxPredictor(cfg, load_params_npz(npz), batch_size=8)


@pytest.fixture(scope='module')
def predictors():
    return make_predictors()


@pytest.fixture(scope='module')
def session_paths(tmp_path_factory):
    return {seed: write_synthetic_session(str(tmp_path_factory.mktemp(f'raw{seed}')),
                                          nframes=NFRAMES, seed=seed) for seed in SEEDS}


def jax_chunks(path, predictor, config, tmp_dir, read_only=True):
    '''The reference: find_roi, then the pipeline's steps in turn. Each
    chunk's selection output (which the back end reads but does not change)
    carries the back end's output as ``fetched``. ``read_only=False`` leaves
    the chunks writable, as the prescaled input needs (its selection zeroes
    the host chunk's sentinels in place, after the decode has read copies).'''
    session = JaxSession(path)
    session._bground_im = make_background()       # as the JAX integration tests do
    session.find_roi()
    jcfg = dict(DEFAULT_CONFIG, **config, predictor=predictor, output_dir=tmp_dir,
                true_depth=session.true_depth)
    produce = ProduceFramesStep(session, step_name='produce', config=jcfg)
    produce.initialize()
    steps = [InferenceStep('inference', config=jcfg), SelectInstancesStep('select', config=jcfg),
             ProcessFeaturesStep('features', config=jcfg), FetchResultsStep('fetch', config=jcfg)]
    for step in steps:
        step.initialize()
    inference, select, features, fetch = steps
    out = []
    for item in produce.generate():
        # InferenceStep zeroes the host chunk's sentinels in place right after
        # it dispatches the device decode; on the CPU backend jnp.asarray may
        # alias that buffer, so the decode could read the zeroed chunk. A
        # read-only chunk makes the step zero a copy instead.
        chunk = item['chunk']
        chunk.flags.writeable = not read_only
        data = select.process(inference.process(dict(item)))
        fetched = fetch.process(features.process(dict(data)))
        out.append(dict(data, chunk=chunk, fetched=fetched))
    select.finalize()
    return session, out


def run_both(path, predictors, overlap, tmp_dir, pad=True):
    '''The session at ``path`` through the port and through the reference.'''
    config = dict(CONFIG, chunk_overlap=overlap, pad_chunks=pad)
    session = Session(path)
    session._bground_im = make_background()
    prepared = prepare_session(session, config, device='cpu')
    ours = list(extract_chunks(session, predictors[0], prepared))
    ref_session, ref = jax_chunks(path, predictors[1], config, tmp_dir)
    return session, ours, ref_session, ref, prepared


@pytest.fixture(scope='module', params=[(9, 0), (9, 4), (1, 0), (4, 0)],
                ids=['seed9-overlap0', 'seed9-overlap4', 'seed1-overlap0', 'seed4-overlap0'])
def both(request, predictors, session_paths, tmp_path_factory):
    seed, overlap = request.param
    return run_both(session_paths[seed], predictors, overlap,
                    str(tmp_path_factory.mktemp('jax')))


@pytest.fixture(scope='module')
def unpadded(predictors, session_paths, tmp_path_factory):
    '''Seed 9 with ``pad_chunks`` False on both sides: the tail chunk holds
    its 8 true frames only.'''
    return run_both(session_paths[9], predictors, 0, str(tmp_path_factory.mktemp('jax')),
                    pad=False)


def detection_gaps(ours, ref):
    '''(reference score, score gap, mask flips over the mask's area) of each
    valid detection in the chunks' true frames.'''
    rows = []
    for a, b in zip(ours, ref):
        ia, ib = a['inference'], b['inference']
        valid = _np(ib['valid'])[:a['nframes'], 0]
        ref_scores = _np(ib['scores'])[:a['nframes'], 0]
        gaps = np.abs(_np(ia['scores'])[:a['nframes'], 0] - ref_scores)
        flips = (_np(ia['masks']) != _np(ib['masks'])).sum(axis=(2, 3))[:a['nframes'], 0]
        area = np.maximum(_np(ib['masks']).sum(axis=(2, 3))[:a['nframes'], 0], 1)
        rows += list(zip(ref_scores[valid], gaps[valid], (flips / area)[valid]))
    return np.array(rows).reshape(-1, 3)


def test_session_prepared_as_jax(both):
    session, _, ref_session, _, _ = both
    np.testing.assert_array_equal(session.roi, ref_session.roi)
    assert session.true_depth == ref_session.true_depth
    np.testing.assert_array_equal(session.first_frame, ref_session.first_frame)
    np.testing.assert_array_equal(session.bground_im, ref_session.bground_im)


def test_chunks_equal(both):
    _, ours, _, ref, _ = both
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a['frame_idxs'], b['frame_idxs'])
        assert a['offset'] == b['offset']
        assert a['chunk'].dtype == b['chunk'].dtype == np.uint8
        assert a['chunk'].shape[0] == CONFIG['chunk_size']
        np.testing.assert_array_equal(a['chunk'], b['chunk'])
    assert ours[-1]['nframes'] == len(ours[-1]['frame_idxs']) < CONFIG['chunk_size']
    tail = ours[-1]['chunk'][ours[-1]['nframes']:]
    assert (tail == ours[-1]['chunk'][ours[-1]['nframes'] - 1]).all()   # padded by repeats


def test_session_path_is_process_chunk(both, predictors):
    '''The second witness: the reference's chunks through ``process_chunk``
    with a fresh tracker give ``extract_chunks``'s output bit for bit.'''
    _, ours, _, ref, prepared = both
    tracker = make_tracker()
    for a, b in zip(ours, ref):
        witness = process_chunk(np.array(b['chunk']), predictors[0], prepared, tracker=tracker)
        torch.testing.assert_close({key: a[key] for key in witness}, witness, rtol=0, atol=0,
                                   equal_nan=True)


def test_detections_and_windows(both):
    _, ours, _, ref, _ = both
    found = 0
    for a, b in zip(ours, ref):
        ia, ib = a['inference'], b['inference']
        for key in ('valid', 'keep'):
            np.testing.assert_array_equal(_np(ia[key]), _np(ib[key]))
        ref_scores = _np(ib['scores'])
        gaps = np.abs(_np(ia['scores']) - ref_scores)
        assert (gaps <= SCORE_TOL).all(), (ref_scores[gaps > SCORE_TOL], gaps[gaps > SCORE_TOL])
        np.testing.assert_allclose(_np(ia['boxes']), _np(ib['boxes']), atol=0.5)
        boxes = _np(ib['boxes'])[:, 0]
        _assert_keypoints_close(_np(ia['keypoints'])[:, 0, :, :2],
                                _np(ib['keypoints'])[:, 0, :, :2], boxes)
        flips = (_np(ia['masks']) != _np(ib['masks'])).sum(axis=(2, 3))
        allowed = FLIPS * _np(ib['masks']).sum(axis=(2, 3))
        assert (flips <= allowed).all(), (ref_scores[flips > allowed], flips[flips > allowed])
        for key in ('num_instances', 'win_origins'):
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(_np(a['raw_windows']), _np(b['raw_windows']))
        found += int((a['num_instances'][:a['nframes']] > 0).sum())
    assert found >= NFRAMES // 2


def _to_port(sel):
    '''The reference's selection output as the port's back end takes it:
    tensors on the CPU.'''
    def t(x):
        return torch.from_numpy(np.array(x))
    dispatch = sel['feat_dispatch']
    return {'feat_dispatch': {'cleaned_frames': t(dispatch['cleaned_frames']),
                              'feat_masks': t(dispatch['feat_masks']),
                              'feats_dev': {k: t(v) for k, v in dispatch['feats_dev'].items()},
                              'window_origins': np.asarray(dispatch['window_origins'])},
            'sel_keypoints': t(sel['sel_keypoints']), 'num_instances': sel['num_instances'],
            'frame_idxs': sel['frame_idxs'], 'win_origins': np.asarray(sel['win_origins']),
            'chunk_dev': t(sel['chunk_dev']),
            'height_stats': tuple(t(x) for x in sel['height_stats'])}


F64_TOL = dict(rtol=0, atol=1e-8)
F32_TOL = dict(rtol=1e-6, atol=1e-4)


def assert_back_end_matches(ours, ref, sel, config):
    '''Every key of the fetched results: ``ours`` (the port, fed ``sel``)
    against ``ref`` (the reference's steps on ``sel``).'''
    np.testing.assert_array_equal(ours['frame_idxs'], ref['frame_idxs'])
    fo, fr = ours['features'], ref['features']
    assert set(fo) == set(fr) == {'features', 'flips', 'keypoints', 'num_instances',
                                  'mask_origins'}
    for key in ('centroid', 'orientation', 'axis_length'):
        assert fo['features'][key].dtype == np.asarray(fr['features'][key]).dtype, key
        np.testing.assert_allclose(fo['features'][key], fr['features'][key], err_msg=key,
                                   **F64_TOL)
    np.testing.assert_array_equal(fo['flips'], fr['flips'])
    np.testing.assert_allclose(fo['keypoints'], fr['keypoints'], **F64_TOL)
    np.testing.assert_array_equal(fo['num_instances'], fr['num_instances'])
    np.testing.assert_array_equal(fo['mask_origins'], fr['mask_origins'])

    assert list(ours['scalars']) == list(ref['scalars'])
    for key, value in ref['scalars'].items():
        assert ours['scalars'][key].dtype == value.dtype, key
        tol = {'area_px': dict(rtol=0, atol=0), 'height_ave_mm': dict(rtol=1e-5, atol=0)}.get(
            key, F64_TOL if value.dtype == np.float64 else F32_TOL)
        if key == 'area_mm':
            tol = dict(rtol=1e-9, atol=0)
        np.testing.assert_allclose(ours['scalars'][key], value, err_msg=key, **tol)
    assert list(ours['keypoints']) == list(ref['keypoints'])
    for key, value in ref['keypoints'].items():
        assert ours['keypoints'][key].dtype == value.dtype, key
        tol = dict(rtol=0, atol=0) if key.endswith('_z_mm') else dict(rtol=0, atol=1e-7)
        np.testing.assert_allclose(ours['keypoints'][key], value, err_msg=key, **tol)

    # the crops: equal but where the port's f32 value sits on a rounding edge
    centroid = fo['features']['centroid']
    angles = fo['features']['orientation']
    depth = crop_and_rotate_frames(torch.from_numpy(np.array(sel['chunk_dev'])), centroid,
                                   angles, config['crop_size']).numpy()
    local = centroid - np.asarray(sel['win_origins'])[:, ::-1]
    masks = crop_and_rotate_frames(torch.from_numpy(np.array(
        sel['feat_dispatch']['feat_masks'])).to(torch.uint8), local, angles,
        config['crop_size']).numpy()
    edges = {'depth_frames': np.abs(depth - np.floor(depth) - 0.5) <= 1e-3,   # rounding
             'mask_frames': np.abs(masks - 0.5) <= 1e-3}                     # threshold
    for key, edge in edges.items():
        assert ours[key].dtype == ref[key].dtype and ours[key].shape == ref[key].shape, key
        differ = ours[key] != ref[key]
        assert (~differ | edge).all(), (key, int(differ.sum()), int((differ & ~edge).sum()))
    for key in ('arena_mask_crops', 'arena_mask_origins'):
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def _chained(run):
    '''The port's back end on each of the reference's chunks, with feature
    trackers carried across them, beside the reference's fetched results.'''
    _, _, _, ref, prepared = run
    trackers = make_feature_trackers(prepared)
    for b in ref:
        ours = fetch_results(process_features(_to_port(b), prepared, trackers), prepared)
        yield ours, b['fetched'], b


def test_back_end_chained_matches_jax(both):
    for ours, ref, sel in _chained(both):
        assert_back_end_matches(ours, ref, sel, both[4])


def test_back_end_chained_matches_jax_unpadded(unpadded):
    chunks = list(_chained(unpadded))
    assert [len(ours['frame_idxs']) for ours, _, _ in chunks] == [32, 8]
    assert chunks[-1][0]['depth_frames'].shape == (8, 80, 80)
    for ours, ref, sel in chunks:
        assert_back_end_matches(ours, ref, sel, unpadded[4])


def _near_thresholds(kpts, centroid, angles, tol):
    '''Per frame: whether a keypoint of the vote sits within ``tol`` px of
    the centroid's x once rotated (its vote could go either way), or whether
    the alignment score could cross 0.4 by the pairs within ``tol``.'''
    rotated = rotate_points_batch(kpts[:, :7, :2], centroid, angles)
    vote = (np.abs(rotated[:, :, 0] - centroid[:, None, 0]) <= tol[:, None]).any(axis=1)
    score = jfeatures.compute_keypoint_alignment_scores(rotated)
    dx = np.abs(rotated[:, :, None, 0] - rotated[:, None, :, 0])
    close_pairs = (dx <= tol[:, None, None]).sum(axis=(1, 2)) // 2
    step = 1 / np.count_nonzero(jfeatures.get_expected_keypoint_alignment())
    return vote | (np.abs(score - 0.4) <= (2 * close_pairs + 1) * step)


def _angle_gap(a, b):
    d = np.abs(a - b) % 360
    return np.deg2rad(np.minimum(d, 360 - d))


def end_to_end_agreement(run, heatmap_size=28):
    '''The port's own chunks against the reference's, over the true frames.

    Returns the counts of frames, of frames that agree (flip, orientation to
    0.02 rad), of frames whose flips agree, and of the differing frames by
    cause: ``moments``: the frame's own window moments already differ beyond
    the slice's tolerance (a weak detection's mask); ``predicted``: the
    frame's angle is the angle tracker's prediction (no detection, or an
    alignment score under 0.4), which carries an earlier frame's difference;
    ``near``: a threshold of the flip vote or alignment score. A differing
    frame with none of these causes fails, and so does a flip that differs
    away from a threshold or a smoothed centroid more than 0.5 px off in an
    agreeing frame. ``held`` counts the frames of neither of the first two
    kinds, whose inputs agree, and ``held_agree`` those of them that agree.
    '''
    _, ours, _, ref, _ = run
    counts = dict(frames=0, agree=0, flips_agree=0, near=0, moments=0, predicted=0, held=0,
                  held_agree=0, weak_mask_px=0, weak_window_px=0)
    for a, b in zip(ours, ref):
        n = a['nframes']
        ia, ib = a['inference'], b['inference']
        weak = _np(ib['valid'])[:n, 0] & (_np(ib['scores'])[:n, 0] < STRONG)
        counts['weak_mask_px'] += int((_np(ia['masks']) != _np(ib['masks']))[:n, 0][weak].sum())
        counts['weak_window_px'] += int(
            (_np(a['feat_dispatch']['feat_masks'])[:n]
             != np.asarray(b['feat_dispatch']['feat_masks'])[:n])[weak].sum())
        fa, fb = a['features'], b['fetched']['features']
        flips_same = fa['flips'][:n] == fb['flips'][:n]
        same = flips_same & (_angle_gap(fa['features']['orientation'][:n],
                                        fb['features']['orientation'][:n]) <= 0.02)
        has = b['num_instances'][:n] > 0
        cdiff = np.abs(fa['features']['centroid'][:n] - fb['features']['centroid'][:n])
        assert (cdiff[same & has] <= 0.5).all(), cdiff[same & has].max()

        boxes = _np(b['inference']['boxes'])[:n, 0]
        tol = ((boxes[:, 2:4] - boxes[:, 0:2]) / heatmap_size).max(axis=1) + 0.5
        near = _near_thresholds(fb['keypoints'][:n], fb['features']['centroid'][:n],
                                fb['features']['orientation'][:n], tol)
        raw_a = _np(a['feat_dispatch']['feats_dev']['orientation'])[:n]
        raw_b = np.asarray(b['feat_dispatch']['feats_dev']['orientation'])[:n]
        moments = has & (_angle_gap(np.rad2deg(raw_a), np.rad2deg(raw_b)) > 0.02)
        rotated = rotate_points_batch(fb['keypoints'][:n, :7, :2], fb['features']['centroid'][:n],
                                      fb['features']['orientation'][:n])
        predicted = ~has | (jfeatures.compute_keypoint_alignment_scores(rotated) < 0.4)
        differ = ~same
        assert (flips_same | near).all(), np.flatnonzero(~flips_same & ~near)
        unexplained = differ & ~near & ~moments & ~predicted
        assert not unexplained.any(), np.flatnonzero(unexplained)
        held = ~moments & ~predicted
        counts['frames'] += n
        counts['agree'] += int(same.sum())
        counts['flips_agree'] += int(flips_same.sum())
        counts['moments'] += int((differ & moments).sum())
        counts['predicted'] += int((differ & ~moments & predicted).sum())
        counts['near'] += int((differ & ~moments & ~predicted & near).sum())
        counts['held'] += int(held.sum())
        counts['held_agree'] += int((held & same).sum())
    return counts


def _assert_agreement(run):
    '''Reports the agreement over all true frames, and holds it to 99%; no
    frame's own moments may differ beyond the slice's tolerance; the frames
    whose inputs agree (their angle their own) and the flips everywhere are
    held to 99% too.'''
    c = end_to_end_agreement(run)
    print(f"end to end: {c['agree']} of {c['frames']} true frames agree in flip and "
          f"orientation, {c['flips_agree']} in flip; of the {c['frames'] - c['agree']} that "
          f"differ, {c['moments']} have window moments already beyond the slice's tolerance, "
          f"{c['predicted']} take the tracker's prediction, {c['near']} sit near a threshold; "
          f"{c['held_agree']} of {c['held']} frames with agreeing inputs agree; weak "
          f"detections (reference score under {STRONG}): {c['weak_mask_px']} mask and "
          f"{c['weak_window_px']} window-mask pixels differ (over this file's five runs, "
          f"106 and 49 when the port pooled in f32 and rounded once; 0 and 0 since)")
    assert c['held_agree'] >= 0.99 * c['held']
    assert c['flips_agree'] >= 0.99 * c['frames']
    assert c['agree'] >= 0.99 * c['frames']
    assert c['moments'] == 0


def test_back_end_end_to_end_agrees(both):
    _assert_agreement(both)


def test_back_end_end_to_end_agrees_unpadded(unpadded):
    _assert_agreement(unpadded)


# -- the slice written: extract_session and the CLI ------------------------------

EXTRACT_CONFIG = {
    'checkpoint': 'last', 'batch_size': 8, 'instance_threshold': 0.5, 'expected_instances': 1,
    'allowed_detections': 4, 'bg_roi_dilate': (10, 10), 'bg_roi_shape': 'ellipse',
    'bg_roi_index': 0, 'bg_roi_weights': (1, .1, 1), 'bg_roi_depth_range': (650, 750),
    'bg_roi_gradient_filter': False, 'bg_roi_gradient_threshold': 3000,
    'bg_roi_gradient_kernel': 7, 'bg_roi_fill_holes': True, 'use_plane_bground': False,
    'frame_dtype': 'uint8', 'min_height': 0, 'max_height': 100, 'crop_size': (80, 80),
    'frame_trim': (0, 0), 'chunk_size': 32, 'chunk_overlap': 4, 'fps': 30,
    'use_tracking': True, 'debug_feature_processing': False, 'feature_window': 96,
    'use_tracking_model': False, 'flip_classifier': 'tiny', 'dataset_name': 'moseq',
    'show_progress': False, 'device': 'cpu', 'model': None,
    'param_annotations': {'chunk_size': 'Number of frames for each processing iteration',
                          'model': 'Path to the model for inference.', 'config_file': None}}


def _extract_config(out_dir, predictor):
    return dict(EXTRACT_CONFIG, output_dir=out_dir, predictor=predictor,
                param_annotations=dict(EXTRACT_CONFIG['param_annotations']))


@pytest.fixture(scope='module')
def extracted(predictors, session_paths, tmp_path_factory):
    '''The seed-9 session through the port's and the JAX package's
    ``extract_session`` (the background injected, as the JAX integration
    tests do), and through the port's ``extract_chunks`` with the same
    config.'''
    from moseq2_detectron_extract_tpu.extract import extract_session as jax_extract_session
    from moseq2_detectron_extract_tpu_torch.extract import extract_session
    path = session_paths[9]
    ours_dir = str(tmp_path_factory.mktemp('extract_ours'))
    jax_dir = str(tmp_path_factory.mktemp('extract_jax'))
    session = Session(path)
    session._bground_im = make_background()
    status = extract_session(session, _extract_config(ours_dir, predictors[0]))
    ref_session = JaxSession(path)
    ref_session._bground_im = make_background()
    ref_status = jax_extract_session(ref_session, _extract_config(jax_dir, predictors[1]))
    serial = Session(path)
    serial._bground_im = make_background()
    prepared = prepare_session(serial, _extract_config(None, None), device='cpu')
    chunks = list(extract_chunks(serial, predictors[0], prepared))
    return status, ref_status, chunks


def _read_status(path):
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml
    status = read_yaml(path)
    assert status['complete'] is True, status
    return status


def assert_file_equals_chunks(h5_path, chunks):
    '''Every per-frame dataset equals the serial run's values, bit for bit,
    at the rows of the chunks' true frames past their offsets.'''
    from moseq2_detectron_extract_tpu_torch.io import hdf5
    with hdf5.File(h5_path, 'r') as r:
        written = np.zeros(r['frames'].shape[0], bool)
        for c in chunks:
            n, off = c['nframes'], c['offset']
            rows = c['frame_idxs'][off:]
            sl = slice(int(rows[0]), int(rows[-1]) + 1)
            assert (np.diff(rows) == 1).all()
            written[sl] = True
            for key, values in c['scalars'].items():
                np.testing.assert_array_equal(r[f'scalars/{key}'][sl],
                                              values[off:n].astype('float32'), err_msg=key)
            for key, values in c['keypoints'].items():
                np.testing.assert_array_equal(r[f'keypoints/{key}'][sl],
                                              values[off:n].astype('float32'), err_msg=key)
            np.testing.assert_array_equal(r['frames'][sl], c['depth_frames'][off:n])
            np.testing.assert_array_equal(r['frames_mask'][sl],
                                          c['mask_frames'][off:n].astype(bool))
            np.testing.assert_array_equal(r['metadata/extraction/flips'][sl],
                                          c['features']['flips'][off:n])
        assert written.all()


def test_extract_session_writes_what_extract_chunks_computes(extracted):
    status_path, _, chunks = extracted
    status = _read_status(status_path)
    out_dir = os.path.dirname(status_path)
    assert_file_equals_chunks(os.path.join(out_dir, 'results_00.h5'), chunks)
    stats = status['stage_stats']
    assert sorted(stats) == ['Fetch Results', 'Instance Select', 'Model Inference',
                             'Preview Encode', 'Preview Video', 'Process Features',
                             'Read Depth Data', 'Write Reults']
    assert all(stage['chunks'] == 2 and stage['busy_s'] >= 0 and stage['cpu_s'] >= 0
               for stage in stats.values())
    with open(os.path.join(out_dir, 'keypoints_00.tsv'), encoding='utf-8') as fh:
        rows = fh.read().splitlines()
    assert len(rows) == NFRAMES + 1 and [int(r.split('\t')[0]) for r in rows[1:]] == \
        list(range(NFRAMES))
    with open(os.path.join(out_dir, 'instance_log.tsv'), encoding='utf-8') as fh:
        frames = [line.split('\t') for line in fh.read().splitlines()[1:]]
    assert sorted({int(f[0]) for f in frames}) == list(range(NFRAMES))
    kept = {int(f[0]): int(f[1]) for f in frames}
    for c in chunks:
        n = c['nframes']
        keep = _np(c['inference']['keep'])[:n].sum(axis=1)
        assert [kept[int(i)] for i in c['frame_idxs']] == keep.tolist()
    for name in ('results_00.log', 'roi_00.tiff', 'bground.tiff'):
        assert os.path.exists(os.path.join(out_dir, name)), name


def _h5_tree(path):
    import h5py
    out = {}
    with h5py.File(path, 'r') as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], obj.dtype, dict(obj.attrs))
        f.visititems(visit)
    return out


def test_extract_session_metadata_equals_jax(extracted):
    status_path, ref_status_path, _ = extracted
    ours = _h5_tree(os.path.join(os.path.dirname(status_path), 'results_00.h5'))
    ref = _h5_tree(os.path.join(os.path.dirname(ref_status_path), 'results_00.h5'))
    assert sorted(ours) == sorted(ref)
    # every parameter but the output directory, which differs by design
    keys = [k for k in ref if k.startswith(('metadata/extraction/parameters',
                                            'metadata/acquisition'))
            and k != 'metadata/extraction/parameters/output_dir']
    keys += ['metadata/extraction/roi', 'metadata/extraction/background',
             'metadata/extraction/true_depth', 'metadata/extraction/first_frame', 'timestamps']
    assert len(keys) > 30
    for key in keys:
        (va, ta, aa), (vb, tb, ab) = ours[key], ref[key]
        assert ta == tb and aa == ab, key
        if isinstance(vb, np.ndarray) or not hasattr(vb, 'dtype'):
            assert np.array_equal(va, vb), key
        else:
            assert type(va) is type(vb) and va == vb, key


def test_status_files_agree_with_jax(extracted):
    '''The port reads the JAX package's status file as PyYAML does, and the
    two status files hold the same parameters and metadata.'''
    import yaml
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml
    status_path, ref_status_path, _ = extracted
    with open(ref_status_path, encoding='utf-8') as fh:
        ref = yaml.safe_load(fh)
    assert read_yaml(ref_status_path) == ref
    ours = _read_status(status_path)
    assert ours['parameters'].pop('output_dir') != ref['parameters'].pop('output_dir')
    assert ours['parameters'] == ref['parameters'] and ours['metadata'] == ref['metadata']
    assert set(ours['stage_stats']) == set(ref['stage_stats'])


def test_extract_session_skips_a_complete_session(extracted, predictors, session_paths):
    from moseq2_detectron_extract_tpu_torch.extract import extract_session
    status_path, _, _ = extracted
    out_dir = os.path.dirname(status_path)
    h5_path = os.path.join(out_dir, 'results_00.h5')
    mtime = os.path.getmtime(h5_path)
    again = extract_session(Session(session_paths[9]), _extract_config(out_dir, predictors[0]))
    assert again == status_path and os.path.getmtime(h5_path) == mtime
    with open(os.path.join(out_dir, 'results_00.log'), encoding='utf-8') as fh:
        assert 'already be extracted' in fh.read()


def test_extract_session_records_a_failure_as_incomplete(session_paths, tmp_path):
    '''A step that fails leaves ``complete: false`` and its traceback in the
    log; the call itself returns the status path.'''
    from moseq2_detectron_extract_tpu_torch.extract import extract_session
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml

    class Broken:
        device = torch.device('cpu')

        def __call__(self, frames):
            raise RuntimeError('the model is broken')

    session = Session(session_paths[9])
    session._bground_im = make_background()
    status = extract_session(session, _extract_config(str(tmp_path), Broken()))
    assert read_yaml(status)['complete'] is False
    with open(os.path.join(str(tmp_path), 'results_00.log'), encoding='utf-8') as fh:
        assert 'the model is broken' in fh.read()


def test_cli_extract_on_a_model_directory(predictors, session_paths, tmp_path):
    '''``cli.main(['extract', ...])`` on the CPU with a model directory
    (``config.yaml`` and ``params_f16.npz`` of the tiny model); the file's
    per-frame datasets equal ``extract_chunks`` with the CLI's defaults, and
    its metadata equals the JAX package's ``extract`` command's file.'''
    import shutil
    from moseq2_detectron_extract_tpu_torch import cli
    cfg = JaxModelConfig.from_yaml(os.path.join(DATA, 'tiny_overfit_config.yaml')) \
        .replace(amp_dtype='float32')
    model_dir = tmp_path / 'model'
    model_dir.mkdir()
    cfg.to_yaml(str(model_dir / 'config.yaml'))
    shutil.copy(os.path.join(DATA, 'tiny_overfit_params.npz'), str(model_dir / 'params_f16.npz'))
    out_dir = str(tmp_path / 'out')
    assert cli.main(['extract', session_paths[9], '--model', str(model_dir), '--device', 'cpu',
                     '--chunk-size', '32', '--output-dir', out_dir]) == 0
    status = _read_status(os.path.join(out_dir, 'results_00.yaml'))
    params = status['parameters']
    assert params['device'] == 'cpu' and params['batch_size'] == 10
    assert params['allowed_detections'] == 4 and params['flip_classifier'] == str(model_dir)
    assert params['param_annotations']['chunk_size'] == \
        'Number of frames for each processing iteration'
    predictor = Predictor.from_model_dir(str(model_dir), batch_size=10, score_threshold=0.5,
                                         device='cpu')
    session = Session(session_paths[9])
    prepared = prepare_session(session, {'chunk_size': 32}, device='cpu')
    assert_file_equals_chunks(os.path.join(out_dir, 'results_00.h5'),
                              list(extract_chunks(session, predictor, prepared)))

    # the JAX package's extract command on the same session and model dir:
    # the same metadata; the same parameters but the output directory, and
    # the port's --device
    from click.testing import CliRunner
    from moseq2_detectron_extract_tpu.cli import cli as jax_cli
    jax_out = str(tmp_path / 'jax_out')
    result = CliRunner().invoke(jax_cli, ['extract', session_paths[9], '--model', str(model_dir),
                                          '--chunk-size', '32', '--output-dir', jax_out])
    assert result.exit_code == 0, result.output
    ours = _h5_tree(os.path.join(out_dir, 'results_00.h5'))
    ref = _h5_tree(os.path.join(jax_out, 'results_00.h5'))
    params = 'metadata/extraction/parameters/'
    assert sorted(set(ours) - set(ref)) == [params + 'device',
                                            params + 'param_annotations/device']
    assert set(ref) <= set(ours)
    keys = [k for k in ref if k.startswith((params, 'metadata/acquisition'))
            and k != params + 'output_dir']
    keys += ['metadata/extraction/roi', 'metadata/extraction/background',
             'metadata/extraction/true_depth', 'metadata/extraction/first_frame', 'timestamps']
    for key in keys:
        (va, ta, aa), (vb, tb, ab) = ours[key], ref[key]
        assert ta == tb and aa == ab and np.array_equal(va, vb), key


def test_cli_config_file_precedence(tmp_path):
    '''The command line's own values, then the config file's, then the
    defaults; tuples stay tuples.'''
    import yaml
    from moseq2_detectron_extract_tpu_torch.cli import extract_parser
    from moseq2_detectron_extract_tpu_torch.io.options import apply_config_file
    path = str(tmp_path / 'config.yaml')
    with open(path, 'w', encoding='utf-8') as fh:
        yaml.safe_dump({'chunk_size': 200, 'batch-size': 4, 'crop_size': [64, 64],
                        'fps': 60, 'use_tracking': False}, fh)
    dat = str(tmp_path / 'depth.dat')
    open(dat, 'wb').close()
    argv = [dat, '--config-file', path, '--fps', '90']
    parser = extract_parser()
    args = parser.parse_args(argv)
    apply_config_file(parser, args, argv)
    assert (args.chunk_size, args.batch_size, args.crop_size) == (200, 4, (64, 64))
    assert args.fps == 90 and args.use_tracking is False and args.max_height == 100
    with pytest.raises(SystemExit):
        parser.parse_args([dat, '--instance-threshold', '1.5'])


@pytest.mark.parametrize('flag', [['--device-input', 'prescaled']])
def test_cli_options_not_ported_raise(flag, session_paths, tmp_path, monkeypatch):
    '''``--device-input prescaled`` raised while it was not ported; it now
    reaches the session's config (``test_torch_prescaled.py`` runs it).'''
    from moseq2_detectron_extract_tpu_torch import cli, extract
    seen = {}

    def fake_extract_session(session, config):
        seen.update(config)
        return os.path.join(str(tmp_path), 'results_00.yaml')

    monkeypatch.setattr(extract, 'extract_session', fake_extract_session)
    assert cli.main(['extract', session_paths[9], '--device', 'cpu',
                     '--output-dir', str(tmp_path)] + flag) == 0
    assert seen['device_input'] == flag[1]
    assert not os.path.exists(os.path.join(str(tmp_path), 'results_00.yaml'))


def test_inference_step_refuses_prescaled_input():
    '''The step takes ``prescaled`` now (it refused it while it was not
    ported), and refuses an input mode that does not exist.'''
    from moseq2_detectron_extract_tpu_torch.pipeline.steps import InferenceStep
    step = InferenceStep(step_name='inference',
                         config={'device_input': 'prescaled', 'predictor': object()})
    step.initialize()
    assert step.device_input == 'prescaled'
    step = InferenceStep(step_name='inference', config={'device_input': 'halfway'})
    with pytest.raises(ValueError, match='halfway'):
        step.initialize()


def test_zero_host_sentinels_copies_a_read_only_chunk():
    from moseq2_detectron_extract_tpu_torch.pipeline.steps import zero_host_sentinels
    chunk = np.array([[[1, 255], [255, 7]]], np.uint8)
    chunk.flags.writeable = False
    zeroed = zero_host_sentinels(chunk)
    assert zeroed is not chunk and zeroed.tolist() == [[[1, 0], [0, 7]]]
    assert chunk.tolist() == [[[1, 255], [255, 7]]]
    writable = chunk.copy()
    assert zero_host_sentinels(writable) is writable and writable.tolist() == zeroed.tolist()


def test_extract_session_defaults_to_cuda(session_paths, predictors, tmp_path):
    '''Without ``device`` in the config, ``extract_session`` runs on CUDA:
    here, without a card, the run fails and the status says so.'''
    from moseq2_detectron_extract_tpu_torch.extract import extract_session
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    config = _extract_config(str(tmp_path), predictors[0])
    del config['device']
    status = extract_session(Session(session_paths[9]), config)
    assert read_yaml(status)['complete'] is False
    assert read_yaml(status)['parameters']['device'] == 'cuda'


def test_prepare_session_defaults_to_cuda(session_paths):
    '''No quiet fall back to the CPU: without a card the default raises.
    (``extract_chunks`` runs on its predictor's device, which defaults to
    CUDA in the same way.)'''
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    with pytest.raises(RuntimeError, match='cuda'):
        prepare_session(Session(session_paths[SEEDS[0]]))


if __name__ == '__main__':
    # JAX_PLATFORMS=cpu python -m tests.test_torch_extract_session 9 1 2 3 4 5
    # prints the largest gaps by band of reference score over the sessions of
    # those seeds (overlap 0), the readings the tolerances above rest on.
    import sys
    import tempfile
    pair = make_predictors()
    readings = np.concatenate([detection_gaps(*run_both(
        write_synthetic_session(tempfile.mkdtemp(), nframes=NFRAMES, seed=int(seed)), pair, 0,
        tempfile.mkdtemp())[1:4:2]) for seed in sys.argv[1:]])
    print(f'{len(readings)} detections')
    for lo, hi in ((0.0, 0.6), (0.6, 0.7), (0.7, 0.8), (0.8, 0.9), (0.9, 1.01)):
        band = readings[(readings[:, 0] >= lo) & (readings[:, 0] < hi)]
        if len(band):
            print(f'reference score [{lo}, {hi}): {len(band)} detections, largest score gap '
                  f'{band[:, 1].max():.2e}, largest mask flips {100 * band[:, 2].max():.2f}%')
