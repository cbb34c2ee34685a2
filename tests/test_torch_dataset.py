'''Dataset generation on the CPU against the JAX package.

* ``generate-dataset`` in both packages on one synthetic session, for
  ``random`` (``np.random.seed`` set before each), ``uniform``, ``list`` and
  ``kmeans``: ``tasks.json`` and ``info.json`` equal with the output
  directories replaced, and the PNGs' pixels equal;
* the ``kmeans`` picks on three seeded sessions: equal to the JAX
  package's (sklearn's ``MiniBatchKMeans``), or, where float order alone
  moves a pick, the cost of the port's picks (the sum over the frames of
  the squared distance to the nearest pick) within 1% of sklearn's;
* ``proc/kmeans.py`` against sklearn on data larger than its ``init_size``
  (the k-means++ subsample and the early stop both run);
* ``ops/preprocess.py:prep_raw_frames`` equals the JAX package's device
  prep on frames with dropouts, with ``vmax`` above 255 too, and so does
  ``generate-dataset --max-height 300``.
'''
import json
import os

import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu import dataset as jdataset
from moseq2_detectron_extract_tpu.io.image import read_image as jax_read_image
from moseq2_detectron_extract_tpu.io.session import Session as JaxSession, Stream as JaxStream
from moseq2_detectron_extract_tpu.ops.preprocess import prep_raw_frames as jax_prep
from moseq2_detectron_extract_tpu_torch import cli
from moseq2_detectron_extract_tpu_torch.io.image import read_image
from moseq2_detectron_extract_tpu_torch.ops.preprocess import prep_raw_frames
from moseq2_detectron_extract_tpu_torch.proc.kmeans import minibatch_kmeans, nearest_members
from tests.synthetic import write_synthetic_session


@pytest.fixture(scope='module')
def session_path(tmp_path_factory):
    return write_synthetic_session(str(tmp_path_factory.mktemp('gen')), nframes=60, seed=4)


def _run_both(session_path, tmp_path, method, extra=(), max_height=100):
    ours, ref = str(tmp_path / 'ours'), str(tmp_path / 'ref')
    kwargs = dict(num_samples=8, sample_method=method, min_height=0, max_height=max_height,
                  bg_roi_depth_range=(650, 750))
    if method == 'list':
        kwargs['frame_indices'] = [int(i) for i in extra[1].split(',')]
    np.random.seed(5)
    assert cli.main(['generate-dataset', session_path, '--output-dir', ours, '--num-samples',
                     '8', '--sample-method', method, '--device', 'cpu', *extra]) == 0
    np.random.seed(5)
    jdataset.write_label_studio_tasks(
        jdataset.generate_dataset_for_sessions([session_path], ref, **kwargs), ref)
    return ours, ref


def _read_json(path, out_dir, placeholder='OUT'):
    with open(path, encoding='utf-8') as fh:
        return json.loads(fh.read().replace(out_dir, placeholder))


@pytest.mark.parametrize('method', ['random', 'uniform', 'list', 'kmeans'])
def test_generate_dataset_equals_jax(session_path, tmp_path, method):
    extra = ('--frame-indices', '3,59,17,0,17') if method == 'list' else ()
    ours, ref = _run_both(session_path, tmp_path, method, extra)
    tasks = _read_json(os.path.join(ours, 'tasks.json'), ours)
    assert tasks == _read_json(os.path.join(ref, 'tasks.json'), ref)
    assert len(tasks) == (5 if method == 'list' else 8)
    session_id = tasks[0]['data']['session_id']
    assert _read_json(os.path.join(ours, session_id, 'info.json'), ours) == \
        _read_json(os.path.join(ref, session_id, 'info.json'), ref)
    for task in tasks:
        name = os.path.basename(task['data']['depth_image'])
        got = read_image(os.path.join(ours, session_id, name), scale=False)
        expect = jax_read_image(os.path.join(ref, session_id, name), scale=False)
        assert got.dtype == expect.dtype == np.uint8
        np.testing.assert_array_equal(got, expect, err_msg=name)


def test_generate_dataset_max_height_300_equals_jax(tmp_path):
    '''A ``--max-height`` above 254 keeps heights of 255 and above: no
    height is taken for a dropout.'''
    path = write_synthetic_session(str(tmp_path / 's'), nframes=60, seed=6)
    frames = np.fromfile(path, '<u2').reshape(60, 128, 192)
    frames[1:, 30:34, 76:116] = 700 - np.arange(240, 280)  # not in frame 0, the background
    frames.tofile(path)
    ours, ref = _run_both(path, tmp_path, 'uniform', ('--max-height', '300'), max_height=300)
    tasks = _read_json(os.path.join(ours, 'tasks.json'), ours)
    assert tasks == _read_json(os.path.join(ref, 'tasks.json'), ref)
    session_id = tasks[0]['data']['session_id']
    tall = 0
    for task in tasks:
        name = os.path.basename(task['data']['depth_image'])
        got = read_image(os.path.join(ours, session_id, name), scale=False)
        expect = jax_read_image(os.path.join(ref, session_id, name), scale=False)
        np.testing.assert_array_equal(got, expect, err_msg=name)
        tall += int((expect >= 200).sum())
    assert tall > 0


def _jax_features(path):
    '''The JAX package's k-means data of a session (``select_frames_kmeans``).'''
    session = JaxSession(path)
    session.find_roi()
    iterator = session.iterate(chunk_size=1000)
    iterator.attach_filter(JaxStream.DEPTH, lambda f: np.asarray(jax_prep(
        f, bground_im=session.bground_im, roi=session.roi, vmin=0, vmax=100, dtype='uint8')))
    feats = [np.asarray(c)[:, ::4, ::4].reshape(len(c), -1).astype('float32')
             for _, c in iterator]
    return session, np.concatenate(feats)


def _pick_cost(data, picks):
    '''Sum over the frames of the squared distance to the nearest pick.'''
    centres = data[picks].astype(np.float64)
    d = ((data.astype(np.float64)[:, None, :] - centres[None]) ** 2).sum(-1)
    return float(d.min(axis=1).sum())


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_kmeans_picks_equal_sklearn_or_cost_within_one_percent(tmp_path, seed):
    from moseq2_detectron_extract_tpu_torch.dataset import select_frames_kmeans
    from moseq2_detectron_extract_tpu_torch.io.session import Session
    path = write_synthetic_session(str(tmp_path / 's'), nframes=90, seed=seed)
    jsession, data = _jax_features(path)
    ref = jdataset.select_frames_kmeans(jsession, 12, 0, 100)
    session = Session(path)
    session.find_roi(device='cpu')
    ours = select_frames_kmeans(session, 12, 0, 100, device='cpu')
    if ours == ref:
        print(f'seed {seed}: the picks equal sklearn\'s')
        return
    cost, ref_cost = _pick_cost(data, ours), _pick_cost(data, ref)
    print(f'seed {seed}: the picks differ by float order ({sorted(set(ours) ^ set(ref))}); '
          f'cost {cost:.6g} against sklearn\'s {ref_cost:.6g}')
    assert abs(cost / ref_cost - 1) < 0.01


@pytest.mark.parametrize('n, d, k', [(4000, 48, 20), (1500, 120, 40)])
def test_minibatch_kmeans_equals_sklearn(n, d, k):
    from sklearn.cluster import MiniBatchKMeans
    rng = np.random.default_rng(n)
    centres = rng.integers(0, 100, (k // 2, d))
    data = (centres[rng.integers(0, k // 2, n)] + rng.integers(0, 25, (n, d))).astype(np.float32)
    km = MiniBatchKMeans(n_clusters=k, n_init=3, random_state=0)
    labels = km.fit_predict(data)
    got_centres, got_labels, inertia = minibatch_kmeans(torch.from_numpy(data), k)
    assert (got_labels.numpy() == labels).mean() > 0.99
    assert abs(inertia / km.inertia_ - 1) < 1e-3
    np.testing.assert_allclose(got_centres.numpy(), km.cluster_centers_, atol=0.5)
    members = nearest_members(torch.from_numpy(data), got_centres, got_labels)
    ref = [np.flatnonzero(labels == c)[np.argmin(np.linalg.norm(
        data[labels == c] - km.cluster_centers_[c], axis=1))] for c in range(k)]
    assert (members == np.array(ref)).mean() > 0.9


def test_prep_raw_frames_equals_jax():
    from tests.synthetic import make_background, make_depth_frame
    rng = np.random.default_rng(0)
    frames = np.stack([make_depth_frame(i, 6, rng)[0] for i in range(6)]).astype('<i2')
    frames[rng.random(frames.shape) < 0.02] = 0
    frames[2, 40:48, 60:70] = 0
    frames[1:, 30:34, 76:116] = 700 - np.arange(240, 280)  # heights of 255 and above
    bground = make_background()
    roi = np.zeros(bground.shape, bool)
    roi[10:-10, 20:-20] = True
    for vmin, vmax in ((0, 100), (5, 80), (0, 300)):
        got = prep_raw_frames(frames, bground_im=bground, roi=roi, vmin=vmin, vmax=vmax,
                              device='cpu')
        expect = np.asarray(jax_prep(frames, bground_im=bground, roi=roi, vmin=vmin,
                                     vmax=vmax, dtype='uint8'))
        np.testing.assert_array_equal(got.numpy(), expect)
