'''Model export (``models/deploy.py``) and the export-safe NMS fixpoint.

The ``compile-model`` command exports the tiny f32 model on the CPU once
(``torch.export``, about 15 s) and evaluates the held-out views through the
loaded program. The program must equal the live model bit for bit, the
post-export AP must equal the live AP, and ``load_exported_model`` must run
the program only at the batch it was exported at. The fixed-round NMS that
export traces must equal the early-exit loop and the JAX package's bounded
``while_loop`` on random boxes, exact score ties and suppression chains,
one of them cut at the round cap.
'''
import logging
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moseq2_detectron_extract_tpu.ops.nms import nms_keep_mask as jax_nms_keep_mask
from moseq2_detectron_extract_tpu_torch import cli
from moseq2_detectron_extract_tpu_torch.io.annot import read_annotations
from moseq2_detectron_extract_tpu_torch.io.image import read_image
from moseq2_detectron_extract_tpu_torch.models import deploy
from moseq2_detectron_extract_tpu_torch.models.eval import evaluate_model
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
from moseq2_detectron_extract_tpu_torch.ops import nms
from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names
from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views

from tests.test_torch_eval import seeded_split, tiny_model_dir

BATCH = 4


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    '''``compile-model`` at batch 4 with the post-export evaluation of the
    export's test split (the stdlib shuffle seeded).'''
    work = tmp_path_factory.mktemp('deploy')
    model_dir = tiny_model_dir(str(work / 'model'))
    export = write_annotated_views(str(work / 'views'), 12, size=150, seed=1)
    with seeded_split():
        out, results = cli.compile_model([export, '--model-dir', model_dir, '--batch-size',
                                          str(BATCH), '--output', str(work / 'export'),
                                          '--device', 'cpu'])
    return model_dir, export, out, results


def _frames(export, n):
    items = read_annotations(export, default_keypoint_names)
    return torch.from_numpy(np.stack([read_image(it['file_name']) for it in items[:n]])
                            .astype(np.uint8))


def _assert_equal_outputs(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(torch.nan_to_num(a[key], nan=-7.0),
                           torch.nan_to_num(b[key], nan=-7.0)), key


def test_export_dir_layout(exported):
    _, _, out, _ = exported
    assert sorted(os.listdir(out)) == ['checkpoints', 'config.yaml', 'last_checkpoint',
                                       'model.pt2']
    program = torch.export.load(os.path.join(out, 'model.pt2'))
    assert deploy.program_batch(program) == BATCH
    # the three pool calls are the registered op, inside the no_grad region
    calls = [str(n.target) for m in program.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
             if n.op == 'call_function']
    assert calls.count('m2de.roi_align_bf16.default') == 3


def test_program_equals_live_model_bit_for_bit(exported):
    '''The loaded program against the live model's inference, on the
    Predictor's own input (4 views resized to the canvas): every output.'''
    model_dir, export, out, _ = exported
    from_program = deploy.load_exported_model(out, device='cpu')
    assert from_program._exported_forward is not None
    live = Predictor.from_model_dir(model_dir, batch_size=BATCH, device='cpu')
    frames = _frames(export, BATCH)
    got, ref = from_program(frames), live(frames)
    assert bool(got['valid'].any())
    _assert_equal_outputs(got, ref)
    s = live.cfg.image_size
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (BATCH, 3, s, s))
                         .astype('float32'))
    sizes = torch.full((BATCH, 2), float(s))
    _assert_equal_outputs(from_program._exported_forward(x, sizes),
                          live.model.inference(x, sizes))


def test_batch_mismatch_warns_and_runs_the_live_model(exported, caplog):
    _, export, out, _ = exported
    with caplog.at_level(logging.WARNING):
        predictor = deploy.load_exported_model(out, batch_size=2, device='cpu')
    assert predictor._exported_forward is None
    assert 'exported program has batch 4 but predictor batch is 2' in caplog.text
    frames = _frames(export, 2)
    _assert_equal_outputs(predictor(frames),
                          deploy.load_exported_model(out, device='cpu')(frames))


def test_post_export_evaluation_equals_live(exported):
    model_dir, export, _, results = exported
    items = read_annotations(export, default_keypoint_names)
    with seeded_split():
        random.shuffle(items)
    live = evaluate_model(model_dir, items[int(len(items) * 0.9):], batch_size=BATCH,
                          device='cpu')
    assert results == live


def _jax_keep(boxes, scores, thresh, valid):
    return np.stack([np.asarray(jax_nms_keep_mask(jnp.asarray(b), jnp.asarray(s), thresh,
                                                  valid=jnp.asarray(v)))
                     for b, s, v in zip(boxes, scores, valid)])


def _chain(n, step=6.0):
    '''Boxes each overlapping only the next (IoU 0.5), scores falling:
    greedy NMS keeps every other one, deciding two boxes a round.'''
    x0 = np.arange(n) * step
    boxes = np.stack([x0, np.zeros(n), x0 + 3 * step, np.full(n, 10.0)], axis=-1)
    return boxes[None].astype('float32'), np.linspace(1.0, 0.1, n)[None].astype('float32')


def _random_boxes(seed, b=3, k=40, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (b, k, 2))
    wh = rng.uniform(4, 30, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype('float32')
    scores = rng.uniform(0, 1, (b, k))
    if ties:
        scores = np.round(scores * 4) / 4
    return boxes, scores.astype('float32')


NMS_CASES = {'random': _random_boxes(0), 'ties': _random_boxes(1, ties=True),
             'chain_40': _chain(40), 'chain_80_cut_at_cap': _chain(80)}


@pytest.mark.parametrize('case', list(NMS_CASES))
def test_fixed_round_nms_equals_the_synced_loop(case, monkeypatch):
    boxes, scores = NMS_CASES[case]
    valid = np.ones(scores.shape, bool)
    if not case.startswith('chain'):
        valid[..., ::7] = False                 # padding boxes
    tb, ts, tv = map(torch.from_numpy, (boxes, scores, valid))
    nms.sync_count = 0
    eager = nms.nms_keep_mask(tb, ts, 0.4, valid=tv)
    syncs = nms.sync_count
    monkeypatch.setattr(torch.compiler, 'is_exporting', lambda: True)
    fixed = nms.nms_keep_mask(tb, ts, 0.4, valid=tv)
    assert nms.sync_count == syncs              # no host sync while exporting
    assert torch.equal(fixed, eager)
    np.testing.assert_array_equal(fixed.numpy(), _jax_keep(boxes, scores, 0.4, valid))
    if case == 'chain_40':
        assert syncs == 21                      # 20 rounds, then the test that ends it
        np.testing.assert_array_equal(fixed[0].numpy(), np.arange(40) % 2 == 0)
    if case == 'chain_80_cut_at_cap':
        assert syncs == nms.MAX_ITERS
        assert not bool(fixed[0, 2 * nms.MAX_ITERS:].any())   # undecided at the cap


def test_nms_exports_without_a_host_sync():
    '''``torch.export`` of the NMS alone: the program gives the eager keep
    mask on other boxes of the same shape.'''
    class Keep(torch.nn.Module):
        def forward(self, boxes, scores):
            return nms.nms_keep_mask(boxes, scores, 0.4)

    boxes, scores = _random_boxes(2)
    program = torch.export.export(Keep(), (torch.from_numpy(boxes), torch.from_numpy(scores)))
    boxes, scores = map(torch.from_numpy, _random_boxes(3))
    assert torch.equal(program.module()(boxes, scores), nms.nms_keep_mask(boxes, scores, 0.4))
