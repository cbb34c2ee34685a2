'''The port's COCO evaluation (``models/eval.py``) against the JAX package's:
``evaluate_predictions`` on the random scenarios of
``tests/test_eval_vs_cocoeval.py`` and the hand-derived cases of
``tests/test_eval_golden.py`` (the same numbers, exactly: both run the same
float64 numpy on the same arrays), and ``evaluate_model`` on the tiny f32
model over synthetic annotated views (the same AP numbers: the two
forwards differ by float32 rounding, which moves no match here), and the
``evaluate`` command.
'''
import contextlib
import os
import random
import shutil

import numpy as np
import pytest

from moseq2_detectron_extract_tpu.io.annot import read_annotations as jax_read_annotations
from moseq2_detectron_extract_tpu.models import eval as jax_eval
from moseq2_detectron_extract_tpu_torch import cli
from moseq2_detectron_extract_tpu_torch.io.annot import read_annotations
from moseq2_detectron_extract_tpu_torch.models import eval as port_eval
from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names
from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views

from tests import test_eval_golden as golden
from tests.test_eval_vs_cocoeval import SCENARIOS, SIGMAS, _random_scenario

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')


@contextlib.contextmanager
def seeded_split(seed: int = 0):
    '''Seed the stdlib ``random`` that the commands' train/test split
    shuffles with, and give its state back afterwards, so that no other
    test's draws depend on this one.'''
    state = random.getstate()
    random.seed(seed)
    try:
        yield
    finally:
        random.setstate(state)


def assert_same_results(ours, ref):
    assert list(ours) == list(ref)
    for task in ref:
        assert list(ours[task]) == list(ref[task]), task
        for key, value in ref[task].items():
            assert ours[task][key] == value or (np.isnan(value) and np.isnan(ours[task][key])), \
                (task, key, ours[task][key], value)


@pytest.mark.parametrize('kwargs', SCENARIOS, ids=[f"scenario{d['seed']}" for d in SCENARIOS])
def test_evaluate_predictions_random_scenarios(kwargs):
    items, preds, _ = _random_scenario(**kwargs)
    assert_same_results(port_eval.evaluate_predictions(items, preds, SIGMAS),
                        jax_eval.evaluate_predictions(items, preds, SIGMAS))


def _perfect():
    boxes = [(8, 8, 48, 48), (70, 70, 110, 110)]
    return ([golden.make_item(boxes, golden.gt_kpts_for(boxes))],
            [golden.make_pred(boxes, [0.9, 0.8])], golden.SIGMAS4, {})


def _tp_fp_tp():
    boxes = [(0, 0, 10, 10), (20, 20, 30, 30)]
    kpts = np.stack([golden._center_kpts(b, 4) for b in (boxes[0], (40, 40, 50, 50), boxes[1])])
    return ([golden.make_item(boxes, golden.gt_kpts_for(boxes))],
            [golden.make_pred([boxes[0], (40, 40, 50, 50), boxes[1]], [0.9, 0.8, 0.7],
                              kpts=kpts)], golden.SIGMAS4, {})


def _max_dets():
    items, preds, sigmas, _ = _perfect()
    return items, preds, sigmas, {'max_dets': 1, 'kp_max_dets': 1}


def _iou_064():
    return ([golden.make_item([(0, 0, 10, 10)])],
            [golden.make_pred([(0, 0, 10, 6.4)], [0.9],
                              masks=golden.rect_mask(0, 0, 10, 6.4)[None])],
            golden.SIGMAS4, {})


def _area_ignore():
    small, large = (0, 0, 10, 10), (20, 20, 120, 120)
    return ([golden.make_item([small, large])], [golden.make_pred([large, small], [0.9, 0.8])],
            golden.SIGMAS4, {})


def _oks_sweep():
    box = (8, 8, 48, 48)
    d = np.sqrt(-800.0 * np.log(0.72))
    return ([golden.make_item([box], kpts=np.array([[[28.0, 28.0, 2.0]]]))],
            [golden.make_pred([box], [0.9], kpts=np.array([[[28.0 + d, 28.0, 2.0]]]), nkp=1)],
            [0.25], {})


def _missed_gt():
    box = (8, 8, 48, 48)
    far = np.tile([120.0, 120.0, 2.0], (4, 1))[None]
    items = [golden.make_item([box], golden.gt_kpts_for([box])) for _ in range(2)]
    return (items, [golden.make_pred([box], [0.9]), golden.make_pred([box], [0.8], kpts=far)],
            golden.SIGMAS4, {})


GOLDEN = {'perfect': _perfect, 'tp_fp_tp': _tp_fp_tp, 'max_dets': _max_dets,
          'iou_064': _iou_064, 'area_ignore': _area_ignore, 'oks_sweep': _oks_sweep,
          'missed_gt': _missed_gt}


@pytest.mark.parametrize('case', list(GOLDEN))
def test_evaluate_predictions_golden_cases(case):
    items, preds, sigmas, kwargs = GOLDEN[case]()
    assert_same_results(port_eval.evaluate_predictions(items, preds, sigmas, **kwargs),
                        jax_eval.evaluate_predictions(items, preds, sigmas, **kwargs))


def test_evaluation_constants():
    np.testing.assert_array_equal(port_eval.IOU_THRESHOLDS, jax_eval.IOU_THRESHOLDS)
    np.testing.assert_array_equal(port_eval.RECALL_POINTS, jax_eval.RECALL_POINTS)
    assert port_eval.AREA_RANGES == jax_eval.AREA_RANGES


def tiny_model_dir(dirname: str) -> str:
    '''The committed tiny model (trained on the overfit set) as a model
    dir computing in f32.'''
    os.makedirs(dirname)
    with open(os.path.join(DATA, 'tiny_overfit_config.yaml'), encoding='utf-8') as fh:
        text = fh.read().replace('amp_dtype: bfloat16', 'amp_dtype: float32')
    with open(os.path.join(dirname, 'config.yaml'), 'w', encoding='utf-8') as fh:
        fh.write(text)
    shutil.copy(os.path.join(DATA, 'tiny_overfit_params.npz'),
                os.path.join(dirname, 'params_f16.npz'))
    return dirname


@pytest.fixture(scope='module')
def views(tmp_path_factory):
    work = tmp_path_factory.mktemp('eval')
    model_dir = tiny_model_dir(str(work / 'model'))
    export = write_annotated_views(str(work / 'views'), 12, size=150, seed=0)
    return model_dir, export


def test_evaluate_model_matches_jax(views):
    '''The Predictor over 12 annotated 150x150 views (resized to the 64-px
    canvas), then the AP: the JAX package's numbers for the same weights.'''
    model_dir, export = views
    ours = port_eval.evaluate_model(model_dir, read_annotations(export, default_keypoint_names),
                                    device='cpu')
    ref = jax_eval.evaluate_model(model_dir,
                                  jax_read_annotations(export, default_keypoint_names))
    assert_same_results(ours, ref)
    assert ours['segm']['AP50'] > 10 and ours['bbox']['AP50'] > 10


def test_evaluate_command(views):
    '''The ``evaluate`` command scores the test split of the export (the
    stdlib shuffle, seeded here) and logs each task.'''
    model_dir, export = views
    with seeded_split():
        results = cli.evaluate([export, '--model-dir', model_dir, '--device', 'cpu'])
    items = read_annotations(export, default_keypoint_names)
    with seeded_split():
        random.shuffle(items)
    ref = port_eval.evaluate_model(model_dir, items[int(len(items) * 0.9):], device='cpu')
    assert_same_results(results, ref)
    assert cli.main(['evaluate', export, '--model-dir', model_dir, '--device', 'cpu']) == 0
