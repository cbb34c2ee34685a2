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

Detections whose reference score is at least ``STRONG`` are held to
``test_torch_slice.py``'s tolerances (scores 2e-3, mask flips 1%; the two
sides pool with another rounding, see there). Weaker ones, where the
sigmoid is steeper and the mask fuzzier, are held to ``WEAK_SCORE_TOL`` and
``WEAK_FLIPS``. Over six sessions (seeds 9 and 1-5, 174 detections; run
this file as a module with the seeds to print them) the largest gaps were: scores 1.26e-3 and flips 0.53% at reference scores of
0.9 and over; 1.56e-3 and 0.46% in [0.8, 0.9); 2.32e-3 and 1.08% in [0.7,
0.8); 3.31e-3 and 1.63% in [0.6, 0.7); 7.03e-3 and 0.37% below 0.6. No
detection scored 0.8 or more lay outside the slice's tolerances. The
sessions here are seed 9 and the two seeds with the largest weak gaps (1
for the score, 4 for the flips).
'''
import os

import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu.io.session import Session as JaxSession
from moseq2_detectron_extract_tpu.models.checkpoint import load_params_npz
from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
from moseq2_detectron_extract_tpu.models.predictor import Predictor as JaxPredictor
from moseq2_detectron_extract_tpu.pipeline.steps import (InferenceStep, ProduceFramesStep,
                                                         SelectInstancesStep)
from moseq2_detectron_extract_tpu_torch.extract import (DEFAULT_CONFIG, extract_chunks,
                                                        make_tracker, prepare_session,
                                                        process_chunk)
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
STRONG = 0.8                          # reference scores held to the slice's tolerances
WEAK_SCORE_TOL, WEAK_FLIPS = 1e-2, 0.02
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


def jax_chunks(path, predictor, config, tmp_dir):
    '''The reference: find_roi, then the pipeline's steps in turn.'''
    session = JaxSession(path)
    session._bground_im = make_background()       # as the JAX integration tests do
    session.find_roi()
    jcfg = dict(DEFAULT_CONFIG, **config, predictor=predictor, output_dir=tmp_dir)
    produce = ProduceFramesStep(session, step_name='produce', config=jcfg)
    produce.initialize()
    inference = InferenceStep('inference', config=jcfg)
    inference.initialize()
    select = SelectInstancesStep('select', config=jcfg)
    select.initialize()
    out = []
    for item in produce.generate():
        # InferenceStep zeroes the host chunk's sentinels in place right after
        # it dispatches the device decode; on the CPU backend jnp.asarray may
        # alias that buffer, so the decode could read the zeroed chunk. A
        # read-only chunk makes the step zero a copy instead.
        chunk = item['chunk']
        chunk.flags.writeable = False
        data = select.process(inference.process(dict(item)))
        out.append(dict(data, chunk=chunk))
    select.finalize()
    return session, out


def run_both(path, predictors, overlap, tmp_dir):
    '''The session at ``path`` through the port and through the reference.'''
    config = dict(CONFIG, chunk_overlap=overlap)
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
        strong = ref_scores >= STRONG
        score_tol = np.where(strong, 2e-3, WEAK_SCORE_TOL)
        gaps = np.abs(_np(ia['scores']) - ref_scores)
        assert (gaps <= score_tol).all(), (ref_scores[gaps > score_tol], gaps[gaps > score_tol])
        np.testing.assert_allclose(_np(ia['boxes']), _np(ib['boxes']), atol=0.5)
        boxes = _np(ib['boxes'])[:, 0]
        _assert_keypoints_close(_np(ia['keypoints'])[:, 0, :, :2],
                                _np(ib['keypoints'])[:, 0, :, :2], boxes)
        flips = (_np(ia['masks']) != _np(ib['masks'])).sum(axis=(2, 3))
        allowed = np.where(strong, 0.01, WEAK_FLIPS) * _np(ib['masks']).sum(axis=(2, 3))
        assert (flips <= allowed).all(), (ref_scores[flips > allowed], flips[flips > allowed])
        for key in ('num_instances', 'win_origins'):
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(_np(a['raw_windows']), _np(b['raw_windows']))
        found += int((a['num_instances'][:a['nframes']] > 0).sum())
    assert found >= NFRAMES // 2


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
