'''Model export (``models/deploy.py``) and the export-safe NMS fixpoint.

The ``compile-model`` command exports the tiny f32 model on the CPU once
(``torch.export``, about 15 s) and evaluates the held-out views through the
loaded program. The program must equal the live model bit for bit, the
post-export AP must equal the live AP, and ``load_exported_model`` must run
the program only at the batch it was exported at. The NMS is the
registered op ``m2de::nms_keep_mask``: the program records it, its CPU
implementation is the plain fixpoint and its fake implementation gives the
(B, K) bool shape. The CUDA kernel's rounds (``csrc/nms.cu``) stop each
image at its own convergence, where the plain version's loop tests the
whole batch; a round after an image has converged changes nothing of its
keep mask, so both give the same answer: here the kernel's rounds, written
out in numpy, must equal the plain loop and the JAX package's bounded
``while_loop`` on random boxes, exact score ties and suppression chains,
one of them cut at the round cap. ``tests/test_torch_cuda.py`` holds the
kernel itself to the plain version on the card.
'''
import logging
import os
import random
from collections import Counter

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


def kernel_rounds(dominates, valid):
    '''The rounds of ``csrc/nms.cu`` over one image's (K, K) dominance: its
    own convergence test before each round, at most ``MAX_ITERS`` rounds,
    and a row already decided (kept, or suppressed) not scanned again.'''
    keep = np.zeros_like(valid)
    supp = np.zeros_like(valid)
    for _ in range(nms.MAX_ITERS):
        if not (valid & ~keep & ~supp).any():
            break
        new_keep = keep.copy()
        for i in np.flatnonzero(valid & ~keep & ~supp):
            new_keep[i] = not (dominates[i] & ~supp).any()
        keep = new_keep
        new_supp = supp.copy()
        for i in np.flatnonzero(~supp):
            new_supp[i] = (dominates[i] & keep).any()
        supp = new_supp
    return keep


@pytest.mark.parametrize('case', list(NMS_CASES))
def test_fixed_round_nms_equals_the_synced_loop(case):
    '''The kernel's rounds, each image stopped at its own convergence or
    cut at the cap, equal the plain version's batch-wide synced loop.'''
    boxes, scores = NMS_CASES[case]
    valid = np.ones(scores.shape, bool)
    if not case.startswith('chain'):
        valid[..., ::7] = False                 # padding boxes
    tb, ts, tv = map(torch.from_numpy, (boxes, scores, valid))
    nms.sync_count = 0
    eager = nms.nms_keep_mask(tb, ts, 0.4, valid=tv)
    syncs = nms.sync_count
    dominates = nms.dominance(tb, ts, 0.4, tv).numpy()
    fixed = np.stack([kernel_rounds(d, v) for d, v in zip(dominates, valid)])
    np.testing.assert_array_equal(fixed, eager.numpy())
    np.testing.assert_array_equal(fixed, _jax_keep(boxes, scores, 0.4, valid))
    if case == 'chain_40':
        assert syncs == 21                      # 20 rounds, then the test that ends it
        np.testing.assert_array_equal(fixed[0], np.arange(40) % 2 == 0)
    if case == 'chain_80_cut_at_cap':
        assert syncs == nms.MAX_ITERS
        assert not fixed[0, 2 * nms.MAX_ITERS:].any()   # undecided at the cap


def test_nms_exports_without_a_host_sync():
    '''``torch.export`` of the NMS alone records the op, with no host sync:
    the program gives the eager keep mask on other boxes of the same shape.'''
    class Keep(torch.nn.Module):
        def forward(self, boxes, scores):
            return nms.nms_keep_mask(boxes, scores, 0.4)

    boxes, scores = _random_boxes(2)
    nms.sync_count = 0
    program = torch.export.export(Keep(), (torch.from_numpy(boxes), torch.from_numpy(scores)))
    assert nms.sync_count == 0
    assert [str(n.target) for n in program.graph.nodes if n.op == 'call_function'
            and 'm2de' in str(n.target)] == ['m2de.nms_keep_mask.default']
    boxes, scores = map(torch.from_numpy, _random_boxes(3))
    assert torch.equal(program.module()(boxes, scores), nms.nms_keep_mask(boxes, scores, 0.4))


@pytest.mark.parametrize('case', list(NMS_CASES))
def test_nms_op_on_the_cpu_is_the_plain_version(case):
    boxes, scores = map(torch.from_numpy, NMS_CASES[case])
    valid = torch.rand(scores.shape, generator=torch.Generator().manual_seed(0)) > 0.1
    plain = nms.nms_keep_mask_plain(boxes, scores, 0.4, valid)
    assert torch.equal(nms.keep_mask_op(boxes, scores, valid, 0.4), plain)
    assert torch.equal(nms.nms_keep_mask(boxes, scores, 0.4, valid=valid), plain)


def test_nms_op_fake_gives_the_bool_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        boxes, scores = torch.empty((5, 300, 4)), torch.empty((5, 300))
        keep = nms.keep_mask_op(boxes, scores, torch.ones((5, 300), dtype=torch.bool), 0.7)
    assert keep.shape == (5, 300) and keep.dtype == torch.bool


def test_nms_takes_any_leading_shape_and_grad_inputs():
    boxes, scores = map(torch.from_numpy, _random_boxes(4, b=6))
    boxes.requires_grad_(True)
    flat = nms.nms_keep_mask(boxes, scores, 0.4)
    keep = nms.nms_keep_mask(boxes.reshape(2, 3, -1, 4), scores.reshape(2, 3, -1), 0.4)
    assert keep.shape == (2, 3, scores.shape[-1]) and not keep.requires_grad
    assert torch.equal(keep.reshape(flat.shape), flat)


def test_export_records_the_nms_op(exported):
    '''The exported inference forward holds the proposal NMS and the box
    head's NMS as the op, not as unrolled rounds.'''
    _, _, out, _ = exported
    program = torch.export.load(os.path.join(out, 'model.pt2'))
    calls = [str(n.target) for m in program.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
             if n.op == 'call_function']
    assert calls.count('m2de.nms_keep_mask.default') == 2
    assert not any('any' in c for c in calls)


@pytest.mark.parametrize('k', [1, 63, 64, 65, 1000, 1024, 3008, 5008, 5056, 5057, 20000,
                               nms.MAX_K])
def test_nms_launch_plan(k):
    '''Every 64-box word owned by one CTA, no CTA empty, at most 16 a
    cluster, the shared memory within the card's limit, the bits in it
    where the slice fits (the main path's K = 1,000, 3,008 and 5,008 all
    do).'''
    plan = nms.launch_plan(k)
    assert plan.words == -(-k // 64) and plan.row_words % 2 == 1
    assert plan.row_words in (plan.words, plan.words + 1)
    assert 1 <= plan.cluster <= nms.MAX_CLUSTER
    assert plan.cluster * plan.words_per_cta >= plan.words
    assert (plan.cluster - 1) * plan.words_per_cta < plan.words
    bits = 8 * 64 * plan.words_per_cta * plan.row_words
    vectors = 48 * plan.row_words + nms.STAGE_BYTES
    assert plan.bits_in_smem == (vectors + bits <= nms.MAX_SMEM)
    assert plan.smem_bytes == vectors + bits * plan.bits_in_smem <= nms.MAX_SMEM
    assert plan.bits_in_smem == (k <= 5056)


@pytest.mark.parametrize('words', [1, 2, 3, 4, 5, 16, 47, 79, 80, 81])
def test_nms_kernel_tiles_cover_each_pair_of_blocks_once(words):
    '''``csrc/nms.cu``'s tiles: block I takes J = I + d (mod W) for d = 0 ..
    (W - 1) / 2, and d = W / 2 when W is even and I < W / 2, and writes its
    rows' word J and, off the diagonal, block J's rows' word I: each word of
    each row once, so each pair's IoU is computed once.'''
    d_max = 1 + (words - 1) // 2 + (words % 2 == 0)
    written = Counter()
    for block in range(words):
        for d in range(d_max):
            if 2 * d == words and 2 * block >= words:
                continue
            other = (block + d) % words
            written[block, other] += 1
            if d:
                written[other, block] += 1
    assert written == Counter({(i, j): 1 for i in range(words) for j in range(words)})


def test_nms_launch_plan_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match='no boxes'):
        nms.launch_plan(0)
    with pytest.raises(ValueError, match='at most'):
        nms.launch_plan(nms.MAX_K + 1)
    with pytest.raises(ValueError, match='CUDA'):
        nms.nms_keep_mask_cuda(torch.zeros((1, 3, 4)), torch.zeros((1, 3)),
                               torch.ones((1, 3), dtype=torch.bool), 0.5)
