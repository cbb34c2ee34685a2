'''Pre-annotation and ``find-roi``: ``io/annot.py:mask_to_poly`` against
``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` (cv2 5.0 here) on
3,000 random masks, ``read_tasks`` and ``write_label_studio_tasks``
against the JAX package's, the ``infer-dataset`` command's JSON against the
JAX package's ``write_predictions_as_annotations`` on the tiny f32 model
(the same polygons, their points to 1e-4 percent: both trace the same mask
pixels; the keypoints' x and y in percent to rtol 1e-3 and atol 1e-3, as
``tests/test_torch_model.py`` holds the forward's keypoints, and their
scores to 2e-3, as ``tests/test_torch_slice.py`` holds scores: both pool in
bf16, and a last-bit difference of the f32 features before the pool can
round a pooled value to the next bf16 step), and the ``find-roi`` command's
caches against the JAX command's.
'''
import json
import os

import cv2
import numpy as np
import pytest
from click.testing import CliRunner

from moseq2_detectron_extract_tpu import dataset as jax_dataset
from moseq2_detectron_extract_tpu.cli import cli as jax_cli
from moseq2_detectron_extract_tpu.io.annot import read_tasks as jax_read_tasks
from moseq2_detectron_extract_tpu.io.image import read_tiff_image as jax_read_tiff
from moseq2_detectron_extract_tpu_torch import cli, dataset
from moseq2_detectron_extract_tpu_torch.io.annot import mask_to_poly, read_tasks
from moseq2_detectron_extract_tpu_torch.io.image import read_tiff_image
from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views

from tests.synthetic import write_synthetic_session
from tests.test_torch_eval import tiny_model_dir

MASKS_PER_KIND = 600


def _random_mask(rng, kind: str) -> np.ndarray:
    h, w = (int(v) for v in rng.integers(1, 40, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == 'noise':                       # holes, many components, single pixels
        return rng.random((h, w)) < rng.uniform(0.1, 0.9)
    if kind == 'rings':                       # holes with islands inside them
        m = np.zeros((h, w), bool)
        for _ in range(int(rng.integers(1, 4))):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 20)
            d = np.hypot(yy - cy, xx - cx)
            m |= ((d < r) & (d > r * rng.uniform(0.3, 0.8))) | (d < r * rng.uniform(0, 0.25))
        return m ^ (rng.random((h, w)) < 0.03)
    if kind == 'lines':                       # 1-px lines and their crossings
        m = np.zeros((h, w), bool)
        for _ in range(int(rng.integers(1, 4))):
            if rng.random() < 0.5:
                m[int(rng.integers(0, h)), int(rng.integers(0, w)):] = True
            else:
                m[int(rng.integers(0, h)):, int(rng.integers(0, w))] = True
        idx = np.arange(min(h, w))
        if rng.random() < 0.5:
            m[idx, idx] = True                # a diagonal
        return m
    if kind == 'border':                      # blobs cut by the image's edges
        m = np.zeros((h, w), bool)
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.choice([0, h - 1]), rng.uniform(-5, w + 5)
            m |= (yy - cy) ** 2 / rng.uniform(1, 100) + (xx - cx) ** 2 / rng.uniform(1, 100) < 1
        return m | (rng.random((h, w)) < 0.02)
    # 'rects': overlapping rectangles with bites taken out
    m = np.zeros((h, w), bool)
    for _ in range(int(rng.integers(1, 5))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        m[y0:y0 + int(rng.integers(1, 15)), x0:x0 + int(rng.integers(1, 15))] = True
    return m & ~(rng.random((h, w)) < 0.08)


@pytest.mark.parametrize('kind', ['noise', 'rings', 'lines', 'border', 'rects'])
def test_mask_to_poly_matches_cv2(kind):
    rng = np.random.default_rng(['noise', 'rings', 'lines', 'border', 'rects'].index(kind))
    for i in range(MASKS_PER_KIND):
        mask = _random_mask(rng, kind).astype(np.uint8) * (1 if i % 2 else 255)
        ref, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        got = mask_to_poly(mask)
        assert len(got) == len(ref), (kind, i)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, (kind, i)
            np.testing.assert_array_equal(a, b, err_msg=f'{kind} {i}')


def test_mask_to_poly_edge_cases():
    assert mask_to_poly(np.zeros((5, 6), np.uint8)) == []
    one = np.zeros((4, 4), bool)
    one[2, 3] = True
    assert [c.tolist() for c in mask_to_poly(one)] == [[[[3, 2]]]]
    full = np.ones((3, 4), np.uint8)
    assert mask_to_poly(full)[0].reshape(-1, 2).tolist() == [[0, 0], [0, 2], [3, 2], [3, 0]]


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    work = tmp_path_factory.mktemp('lifecycle')
    model_dir = tiny_model_dir(str(work / 'model'))
    export = write_annotated_views(str(work / 'views'), 8, size=150, seed=2)
    return model_dir, export, work


def test_read_tasks_and_write_tasks_match_jax(tiny, tmp_path):
    _, export, _ = tiny
    ours, ref = read_tasks(export, rescale=2.0), jax_read_tasks(export, rescale=2.0)
    assert ours == ref and len(ours) == 8
    paths = [dataset.write_label_studio_tasks(ours, str(tmp_path / 'port')),
             jax_dataset.write_label_studio_tasks(ref, str(tmp_path / 'jax'))]
    texts = [open(p, encoding='utf-8').read() for p in paths]
    assert texts[0] == texts[1] and paths[0].endswith('tasks.json')


def test_infer_dataset_matches_jax(tiny):
    model_dir, export, work = tiny
    out = str(work / 'port.predictions.json')
    assert cli.main(['infer-dataset', export, '--model-dir', model_dir, '--output', out,
                     '--instance-threshold', '0.3', '--device', 'cpu']) == 0
    ref = jax_dataset.write_predictions_as_annotations(export, model_dir,
                                                       output=str(work / 'jax.json'),
                                                       instance_threshold=0.3)
    with open(out, encoding='utf-8') as fh:
        ours = json.load(fh)
    with open(ref, encoding='utf-8') as fh:
        theirs = json.load(fh)
    assert len(ours) == len(theirs) == 8
    polygons = keypoints = 0
    for task, ref_task in zip(ours, theirs):
        assert {k: v for k, v in task.items() if k != 'predictions'} == \
            {k: v for k, v in ref_task.items() if k != 'predictions'}
        results, ref_results = (t['predictions'][0]['result'] for t in (task, ref_task))
        assert len(results) == len(ref_results)
        for r, q in zip(results, ref_results):
            assert {k: v for k, v in r.items() if k != 'value'} == \
                {k: v for k, v in q.items() if k != 'value'}
            if r['type'] == 'polygonlabels':
                polygons += 1
                assert r['value']['polygonlabels'] == q['value']['polygonlabels']
                np.testing.assert_allclose(r['value']['points'], q['value']['points'],
                                           atol=1e-4)
            else:
                keypoints += 1
                assert r['value']['keypointlabels'] == q['value']['keypointlabels']
                for key in ('x', 'y'):
                    assert r['value'][key] == pytest.approx(q['value'][key], rel=1e-3,
                                                            abs=1e-3), key
                assert r['value']['score'] == pytest.approx(q['value']['score'], abs=2e-3)
    assert polygons >= 4 and keypoints == 8 * polygons


def test_find_roi_caches_match_jax(tmp_path):
    '''The command's three TIFF caches and the logged true depth: the
    port's (on the CPU) against the JAX command's, read back by both
    readers.'''
    dat = write_synthetic_session(str(tmp_path / 'session'), nframes=20, seed=3)
    dirs = [str(tmp_path / 'port'), str(tmp_path / 'jax')]
    session = cli.find_roi([dat, '--output-dir', dirs[0], '--device', 'cpu',
                            '--bg-roi-depth-range', '650', '750'])
    result = CliRunner().invoke(jax_cli, ['find-roi', dat, '--output-dir', dirs[1]])
    assert result.exit_code == 0, result.output
    names = ['bground.tiff', 'first_frame.tiff', 'roi_00.tiff']
    assert sorted(n for n in os.listdir(dirs[0]) if n.endswith('.tiff')) == names
    for name in names:
        ours = read_tiff_image(os.path.join(dirs[0], name))
        ref = jax_read_tiff(os.path.join(dirs[1], name))
        assert ours.dtype == ref.dtype, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
        np.testing.assert_array_equal(jax_read_tiff(os.path.join(dirs[0], name)), ref)
    assert session.roi.any() and 650 < session.true_depth < 750
    assert cli.main(['find-roi', dat, '--device', 'cpu']) == 0
    assert os.path.exists(os.path.join(os.path.dirname(dat), 'proc', 'roi_00.tiff'))
