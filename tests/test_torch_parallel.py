'''Scale-out (``parallel/``) against the JAX package, on the CPU.

* Data parallel, world 2 over gloo (two processes spawned under a
  ``FileStore`` in ``tmp_path``, ``test_torch_parallel_worker.py``), on a
  batch of 4 with the global batch's draws (the JAX package's, for its step
  ``PRNGKey(5)``):
  (a) the parameters after one DP step equal the single-process step's on
  the same 4 images to 2e-7 (f32 sums in another order), the losses to
  1e-6 relative, and both ranks hold the same parameters bit for bit
  (rank 1 started from other weights: ``replicate_state``);
  (b) they equal the JAX package's ``make_dp_train_step`` on a 2-device
  virtual mesh to 1e-5 (``test_torch_train_losses``' tolerance for
  optimizer steps), the losses to 1e-3 relative (the augmentations match
  to a few pixels of the elastic sampling, ``test_torch_augment``);
  (c) the ranks' counts of positive ROIs and visible keypoints differ, and
  a plain DDP step (each rank's own mean, gradients averaged) misses the
  global step by far more than the DP step does.
* (d) ``Predictor.to_device`` and ``_build_device_predictors`` copy the
  model and leave the original alone; without CUDA, the defaults raise.
* (e) Two synthetic sessions through ``extract_sessions_sharded`` with
  ``devices=['cpu', 'cpu']`` at once: each session's datasets equal that
  session extracted alone, bit for bit; the JAX package's sharded run on
  two virtual devices writes the same datasets, frames and metadata, as
  the session test holds the JAX ``extract_session``'s file.
* The launch and sync counters count exactly from two threads.

About 60 s on the CPU (the JAX step's and Predictor's compiles).
'''
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

import jax

from moseq2_detectron_extract_tpu.models import train as jtrain
from moseq2_detectron_extract_tpu.parallel import (make_dp_train_step as jax_dp_step,
                                                   make_mesh as jax_mesh,
                                                   replicate_state as jax_replicate,
                                                   shard_batch as jax_shard)
from moseq2_detectron_extract_tpu_torch.models.augment import augment_batch
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN, level_shapes
from moseq2_detectron_extract_tpu_torch.models.train import (TrainState, make_optimizer,
                                                             make_train_step)
from moseq2_detectron_extract_tpu_torch.models.weights import params_from_jax
from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, nms, roi_align_kernel
from moseq2_detectron_extract_tpu_torch.parallel import make_mesh
from moseq2_detectron_extract_tpu_torch.parallel.sessions import (_build_device_predictors,
                                                                  extract_sessions_sharded)

from tests.jax_draws import augment_batch_draws, loss_draws
from tests.test_torch_common import jax_init_params, port_config, tiny_jax_config

S = 64


def dp_config():
    return tiny_jax_config(rpn_pre_nms_topk_train=200, rpn_post_nms_topk_train=64,
                           roi_batch_size_per_image=32, max_gt_instances=2, base_lr=0.02,
                           warmup_iters=2, warmup_factor=0.5, grad_clip_norm=1.0)


def dp_batch(cfg, b: int = 4):
    '''Images 0-1 hold two mice with every keypoint visible, images 2-3 one
    mouse with half its keypoints hidden: the two ranks' counts differ.'''
    rng = np.random.default_rng(0)
    g, k = cfg.max_gt_instances, cfg.num_keypoints
    batch = {'image': rng.uniform(0, 20, (b, S, S)).astype('float32'),
             'masks': np.zeros((b, g, S, S), bool),
             'keypoints': np.zeros((b, g, k, 3), 'float32'),
             'valid': np.zeros((b, g), bool)}
    for i in range(b):
        for j in range(2 if i < 2 else 1):
            y, x = 8 + 28 * j + i, 10 + 3 * i
            batch['masks'][i, j, y:y + 14, x:x + 30] = True
            batch['image'][i, y:y + 14, x:x + 30] = 55.0 + 5 * j
            batch['keypoints'][i, j, :, 0] = np.linspace(x + 2, x + 28, k)
            batch['keypoints'][i, j, :, 1] = y + 7
            batch['keypoints'][i, j, :, 2] = 2.0
            if i >= 2:
                batch['keypoints'][i, j, ::2, 2] = 0.0
            batch['valid'][i, j] = True
    return batch


def _single_step(pcfg, state_dict, batch, aug, draws):
    model = MaskKeypointRCNN(pcfg)
    model.load_state_dict(state_dict, strict=True)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(pcfg, model))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    images, gt = augment_batch(aug, t['image'], t['masks'], t['keypoints'], t['valid'], pcfg)
    state, metrics = make_train_step(pcfg)(state, {'images': images, 'gt': gt}, draws)
    return {k: v.detach().clone() for k, v in model.named_parameters()}, metrics


@pytest.fixture(scope='module')
def dp(tmp_path_factory):
    '''The JAX mesh step, the port's single-process step, and the port's
    world-2 DP and plain-DDP steps, from one set of weights and draws.'''
    tmp = tmp_path_factory.mktemp('dp')
    jcfg = dp_config()
    pcfg = port_config(jcfg)
    params, flat = jax_init_params(jcfg, seed=0)
    batch = dp_batch(jcfg)
    rng = jax.random.PRNGKey(5)

    mesh = jax_mesh(2)
    tx = jtrain.make_optimizer(jcfg, params)
    jstate = jax_replicate(mesh, jtrain.TrainState(step=0, params=params,
                                                   opt_state=tx.init(params)))
    with mesh:
        jstate, jmetrics = jax_dp_step(jcfg, mesh)(jstate, jax_shard(mesh, batch), rng)
    from tests.test_torch_common import flatten_params
    jax_params = params_from_jax(flatten_params(jax.tree_util.tree_map(np.asarray,
                                                                       jstate.params)))

    aug_rng, loss_rng = jax.random.split(rng)
    aug = augment_batch_draws(aug_rng, len(batch['image']), S)
    per_cell = len(jcfg.anchor_sizes[0]) * len(jcfg.anchor_aspect_ratios)
    n_anchors = sum(s * s * per_cell for s in level_shapes(S))
    draws = loss_draws(loss_rng, len(batch['image']), n_anchors,
                       jcfg.rpn_post_nms_topk_train + jcfg.max_gt_instances)
    state_dict = params_from_jax(flat)
    single, single_metrics = _single_step(pcfg, state_dict, batch, aug, draws)

    inputs = str(tmp / 'inputs.pt')
    torch.save({'cfg': pcfg, 'state_dict': state_dict, 'batch': batch, 'aug': aug,
                'loss': draws}, inputs)
    outputs = str(tmp / 'rank{}.pt')
    import torch.multiprocessing as mp
    from tests.test_torch_parallel_worker import run
    mp.start_processes(run, args=(2, str(tmp / 'store'), inputs, outputs), nprocs=2,
                       join=True, start_method='spawn')
    ranks = [torch.load(outputs.format(r), weights_only=False) for r in range(2)]
    return {'jax_params': jax_params, 'jax_metrics': {k: float(v) for k, v in jmetrics.items()},
            'single': single, 'single_metrics': single_metrics, 'ranks': ranks,
            'batch': batch, 'draws': draws, 'aug': aug, 'pcfg': pcfg}


def _max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in b)


def test_dp_world2_equals_single_process_step(dp):
    r0, r1 = dp['ranks']
    assert r0['step'] == r1['step'] == 1
    for key in r0['params']:
        assert torch.equal(r0['params'][key], r1['params'][key]), key
    moved = _max_diff(r0['params'], {k: v for k, v in dp['single'].items()})
    assert moved <= 2e-7, moved
    for key, value in dp['single_metrics'].items():
        np.testing.assert_allclose(float(r0['metrics'][key]), float(value), rtol=1e-6,
                                   err_msg=key)


def test_dp_world2_equals_jax_mesh_step(dp):
    r0 = dp['ranks'][0]
    ref = dp['jax_params']
    for name, value in r0['params'].items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(), atol=1e-5, err_msg=name)
    for key, value in dp['jax_metrics'].items():
        np.testing.assert_allclose(float(r0['metrics'][key]), value, rtol=1e-3, err_msg=key)


def test_plain_ddp_average_misses_the_global_step(dp):
    '''The two halves' normalisers differ, so the average of the ranks'
    mean losses is not the global batch's loss.'''
    pcfg = dp['pcfg']
    model = MaskKeypointRCNN(pcfg)
    counts = []
    for lo in (0, 2):
        images, gt = augment_batch({k: _half(v, lo) for k, v in dp['aug'].items()},
                                   *[torch.from_numpy(dp['batch'][k][lo:lo + 2])
                                     for k in ('image', 'masks', 'keypoints', 'valid')], pcfg)
        seen = []
        with torch.no_grad():
            model.losses(images, gt, {k: tuple(x[lo:lo + 2] for x in v)
                                      for k, v in dp['draws'].items()},
                         global_count=lambda c: seen.append(int(c)) or c)
        counts.append(seen)
    assert counts[0][1:] != counts[1][1:], counts           # positives, visible keypoints
    r0 = dp['ranks'][0]
    dp_err = _max_diff(r0['params'], dp['single'])
    plain_err = _max_diff(r0['plain_params'], dp['single'])
    assert plain_err > 100 * max(dp_err, 1e-9), (plain_err, dp_err)
    gap = abs(float(r0['plain_metrics']['loss_keypoint']) -
              float(dp['single_metrics']['loss_keypoint']))
    assert gap > 1e-4, gap


def _half(tree, lo):
    if isinstance(tree, dict):
        return {k: _half(v, lo) for k, v in tree.items()}
    return tree[lo:lo + 2]


def test_make_mesh_needs_its_device_and_one_address(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            make_mesh(0, 1, 'cuda', store_path=str(tmp_path / 's'))
    with pytest.raises(ValueError, match='exactly one'):
        make_mesh(0, 1, 'cpu')


# -- sessions -------------------------------------------------------------------

def test_to_device_and_build_device_predictors_leave_the_original():
    from tests.test_torch_extract_session import make_predictors
    base = make_predictors()[0]
    before = {k: v.clone() for k, v in base.model.state_dict().items()}
    first = next(base.model.parameters())
    copies = _build_device_predictors({'predictor': base}, ['cpu', 'cpu'])
    assert len(copies) == 2 and copies[0] is not copies[1]
    for copy in copies + [base.to_device('cpu')]:
        assert copy is not base and copy.model is not base.model
        assert copy.device == torch.device('cpu') and copy.batch_size == base.batch_size
        for key, value in copy.model.state_dict().items():
            assert torch.equal(value, before[key]), key
    with torch.no_grad():
        next(copies[0].model.parameters()).add_(1.0)
    assert next(base.model.parameters()) is first
    for key, value in base.model.state_dict().items():
        assert torch.equal(value, before[key]), key
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            extract_sessions_sharded(['x'], {'predictor': base})
        with pytest.raises(RuntimeError, match='cuda'):
            base.to_device('cuda')


SESSION_FRAMES = 40


def _session(dirname, seed):
    from moseq2_detectron_extract_tpu.io.image import write_image
    from tests.synthetic import make_background, write_synthetic_session
    path = write_synthetic_session(dirname, nframes=SESSION_FRAMES, seed=seed)
    proc = os.path.join(dirname, 'proc')
    os.makedirs(proc, exist_ok=True)
    write_image(os.path.join(proc, 'bground.tiff'), make_background().astype('uint16'),
                scale=True)
    return path


def _copy_session(path, dest):
    shutil.copytree(os.path.dirname(path), dest)
    return os.path.join(dest, os.path.basename(path))


def _config(predictor):
    from tests.test_torch_extract_session import EXTRACT_CONFIG
    return dict(EXTRACT_CONFIG, output_dir=None, predictor=predictor,
                param_annotations=dict(EXTRACT_CONFIG['param_annotations']))


def _datasets(h5_path):
    '''Every dataset but the run's uuid and the parameters (which hold the
    session's device).'''
    from moseq2_detectron_extract_tpu_torch.io import hdf5
    with hdf5.File(h5_path, 'r') as r:
        out = {name.lstrip('/'): np.asarray(ds[()]) for name, ds in r.visit_datasets()}
    return {k: v for k, v in out.items()
            if k != 'metadata/uuid' and not k.startswith('metadata/extraction/parameters')}


@pytest.fixture(scope='module')
def sharded(tmp_path_factory):
    from moseq2_detectron_extract_tpu.parallel.sessions import \
        extract_sessions_sharded as jax_sharded
    from moseq2_detectron_extract_tpu_torch.extract import extract_session
    from moseq2_detectron_extract_tpu_torch.io.session import Session
    from tests.test_torch_extract_session import make_predictors
    root = tmp_path_factory.mktemp('sessions')
    paths = [_session(str(root / f'sess{i}'), seed) for i, seed in enumerate((9, 1))]
    ours, ref = make_predictors()
    alone = {}
    for i, path in enumerate(paths):
        copy = _copy_session(path, str(root / f'alone{i}'))
        alone[path] = extract_session(Session(copy), _config(ours))
    jax_paths = [_copy_session(p, str(root / f'jax{i}')) for i, p in enumerate(paths)]
    results = extract_sessions_sharded(paths, _config(ours), devices=['cpu', 'cpu'])
    jconfig = dict(_config(ref), device=None)
    jax_results = jax_sharded(jax_paths, jconfig, devices=jax.devices()[:2])
    return paths, results, alone, dict(zip(paths, (jax_results.get(p) for p in jax_paths)))


def test_two_sessions_at_once_equal_each_alone(sharded):
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml
    paths, results, alone, _ = sharded
    assert set(results) == set(paths)
    for path in paths:
        status = read_yaml(results[path])
        assert status['complete'] is True
        assert os.path.dirname(results[path]) == os.path.join(os.path.dirname(path), 'proc')
        ours = _datasets(os.path.splitext(results[path])[0] + '.h5')
        solo = _datasets(os.path.splitext(alone[path])[0] + '.h5')
        assert sorted(ours) == sorted(solo)
        assert ours['frames'].shape[0] == SESSION_FRAMES
        for key, value in solo.items():
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        with open(os.path.join(os.path.dirname(results[path]), 'results_00.log'),
                  encoding='utf-8') as fh:
            log = fh.read()
        other = [p for p in paths if p != path][0]
        assert os.path.dirname(other) not in log          # each session logs alone


def test_two_sessions_agree_with_the_jax_sharded_run(sharded):
    '''The JAX package's sharded run of the same two sessions writes the
    same datasets, frames and metadata (ROI, background, true depth, first
    frame, timestamps, acquisition). The per-frame values are held to the
    JAX package's steps in ``test_torch_extract_session.py``, not here: the
    JAX ``InferenceStep`` zeroes its host chunk while the CPU backend may
    still read it (ROADMAP §3), which its threaded pipeline cannot avoid.'''
    paths, results, _, jax_results = sharded
    for path in paths:
        assert jax_results[path] is not None
        ours = _datasets(os.path.splitext(results[path])[0] + '.h5')
        ref = _datasets(os.path.splitext(jax_results[path])[0] + '.h5')
        assert sorted(ours) == sorted(ref)
        assert ours['frames'].shape == ref['frames'].shape == (SESSION_FRAMES, 80, 80)
        keys = [k for k in ref if k.startswith('metadata/acquisition')]
        keys += ['metadata/extraction/roi', 'metadata/extraction/background',
                 'metadata/extraction/true_depth', 'metadata/extraction/first_frame',
                 'timestamps']
        for key in keys:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


# -- counters -------------------------------------------------------------------

@pytest.mark.parametrize('module,name,add', [
    (clean_kernel, 'launch_count', '_add_launch'),
    (roi_align_kernel, 'launch_count', '_add_launch'),
    (nms, 'sync_count', '_add_sync'),
    (nms, 'launch_count', '_add_launch')])
def test_counters_are_exact_from_two_threads(module, name, add):
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        setattr(module, name, 0)
        step = getattr(module, add)

        def count():
            for _ in range(20000):
                step()
        threads = [threading.Thread(target=count) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert getattr(module, name) == 40000
    finally:
        sys.setswitchinterval(switch)
        setattr(module, name, 0)


def test_nms_counts_its_syncs_from_two_threads():
    rng = np.random.default_rng(0)
    boxes = torch.from_numpy(np.sort(rng.uniform(0, 50, (2, 30, 4)), axis=-1)
                             .astype('float32')[..., [0, 1, 2, 3]])
    scores = torch.from_numpy(rng.random((2, 30)).astype('float32'))
    nms.sync_count = 0
    nms.nms_keep_mask(boxes, scores, 0.5)
    once = nms.sync_count
    nms.sync_count = 0
    threads = [threading.Thread(target=lambda: [nms.nms_keep_mask(boxes, scores, 0.5)
                                                for _ in range(20)]) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert once > 0 and nms.sync_count == 40 * once
