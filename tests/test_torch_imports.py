'''The port imports neither JAX nor cv2/h5py/yaml/click/PIL/tqdm nor the JAX
package, and runs ``process_chunk``, the session path (a raw session
written, ``prepare_session``, one prepped chunk, then ``extract_chunks``
through the host brain and the output ops, with the mouse away for a few
frames), the ``extract`` command on a model directory (its pipeline threads,
results file and status YAML, read back), the ``train`` command (a
synthetic Label Studio export of PNG views, two steps, a checkpoint, then
``Predictor`` on the trained dir), the model lifecycle's commands
(``convert-weights``, ``train --init-weights``, ``evaluate``,
``compile-model``, ``infer-dataset``, ``find-roi``), the result upkeep
(``extract --report-outliers``, ``find-outliers``, ``verify-flips``,
``manual-flip``, ``trim-result``, ``generate-extract-config``,
``dataset-info``, ``system-info``), compressed depth and dataset generation
(``convert-raw-to-avi``, an FFV1 read, ``generate-dataset`` with its
k-means, without sklearn), the last slice (``extract --device-input
prescaled``, ``extract-batch`` printing and in process, the largest
component, the temporal median, the CC features, one data-parallel step),
the C++ Kalman core, the functions ported last (the Hampel filter and NaN
fill, the scan smoother, the tensor helpers, ``augment_sample``, the
inference drawing, ``visualize_annotations`` without matplotlib, as on the
card's machine) and the stage-2 experiment's check on the CPU with all of
them blocked.'''
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'moseq2_detectron_extract_tpu_torch')
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cv2', 'h5py', 'yaml',
           'click', 'PIL', 'tqdm', 'sklearn', 'moseq2_detectron_extract_tpu')

_SCRIPT = r'''
import importlib, importlib.machinery, pkgutil, sys
BLOCKED = %r

# Loads nothing: importing a blocked module raises. Its spec is found
# (without an origin), so that importlib.util.find_spec probes, which
# torch.optim's import of torch._dynamo makes, still get an answer.
class Refuse:
    def create_module(self, spec):
        raise ImportError(f'blocked import of {spec.name}')

    def exec_module(self, module):
        raise ImportError(f'blocked import of {module.__name__}')

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, Refuse())
        return None

sys.meta_path.insert(0, Blocker())
for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]

REPO = %r
import moseq2_detectron_extract_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
    importlib.import_module(info.name)

import torch
from moseq2_detectron_extract_tpu_torch.extract import process_chunk
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk

torch.manual_seed(0)
cfg = ModelConfig(image_size=64, min_size_test=64, max_size_test=64,
                  resnet_stage_blocks=(1, 1, 1, 1), resnet_width=16,
                  fpn_channels=32, box_fc_dim=32, mask_conv_dims=(32,),
                  keypoint_conv_dims=(32,), rpn_pre_nms_topk_test=32,
                  rpn_post_nms_topk_test=8, test_detections_per_image=1,
                  amp_dtype='float32')
state = MaskKeypointRCNN(cfg).state_dict()
pred = Predictor(cfg, state, batch_size=2, score_threshold=0.0, device='cpu')
out = process_chunk(make_sentinel_chunk(3, 96, 128, seed=0), pred,
                    {'min_height': 0, 'max_height': 100, 'feature_window': 64})
assert out['feat_dispatch']['cleaned_frames'].shape == (3, 64, 64)
assert out['inference']['masks'].shape == (3, 1, 96, 128)
import tempfile
from moseq2_detectron_extract_tpu_torch.extract import prepare_session
from moseq2_detectron_extract_tpu_torch.io.session import Session
from moseq2_detectron_extract_tpu_torch.pipeline.steps import produce_chunks
from moseq2_detectron_extract_tpu_torch.synthetic import write_raw_session
with tempfile.TemporaryDirectory() as tmp:
    session = Session(write_raw_session(tmp, 12, height=96, width=128, seed=1))
    config = prepare_session(session, {'chunk_size': 8, 'output_dir': tmp}, device='cpu')
    assert config['roi'].any() and abs(config['true_depth'] - 700) < 5, config['true_depth']
    chunk = next(produce_chunks(session, config))['chunk']
    assert chunk.shape[0] == 8 and str(chunk.dtype) == 'uint8', (chunk.shape, chunk.dtype)
    from moseq2_detectron_extract_tpu_torch.extract import extract_chunks
    session = Session(write_raw_session(tmp, 12, height=96, width=128, seed=1, absent=(0, 3)))
    config = prepare_session(session, {'chunk_size': 8, 'output_dir': tmp,
                                       'feature_window': 64}, device='cpu')
    outs = list(extract_chunks(session, pred, config))
    assert [o['depth_frames'].shape for o in outs] == [(8, 80, 80)] * 2
    assert len(outs[0]['scalars']) == 17 and outs[1]['mask_frames'].dtype.name == 'uint8'
    # the extract command on a model directory of the tiny model: the
    # pipeline's threads, the HDF5 and YAML writers, read back by the port
    import os, shutil
    from moseq2_detectron_extract_tpu_torch import cli
    from moseq2_detectron_extract_tpu_torch.io import hdf5
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml
    data = os.path.join(REPO, 'tests', 'data')
    mdir = os.path.join(tmp, 'model')
    os.makedirs(mdir)
    with open(os.path.join(data, 'tiny_overfit_config.yaml'), encoding='utf-8') as fh:
        text = fh.read().replace('amp_dtype: bfloat16', 'amp_dtype: float32')
    with open(os.path.join(mdir, 'config.yaml'), 'w', encoding='utf-8') as fh:
        fh.write(text)
    shutil.copy(os.path.join(data, 'tiny_overfit_params.npz'), os.path.join(mdir, 'params_f16.npz'))
    out = os.path.join(tmp, 'out')
    assert cli.main(['extract', os.path.join(tmp, 'depth.dat'), '--model', mdir,
                     '--device', 'cpu', '--chunk-size', '8', '--output-dir', out,
                     '--report-outliers']) == 0
    assert read_yaml(os.path.join(out, 'results_00.yaml'))['complete'] is True
    assert os.path.exists(os.path.join(out, 'results_00.jumping_keypoints.txt'))
    with hdf5.File(os.path.join(out, 'results_00.h5'), 'r') as r:
        assert r['frames'].shape == (12, 80, 80) and len(r['keypoints/reference'].keys()) == 48
        assert r['scalars/area_px'][0:12].shape == (12,)
    # the preview: extract's AVI, and the two preview commands (drawing and
    # JPEG encoding in the C++ cores, without cv2)
    from moseq2_detectron_extract_tpu_torch.io.mjpeg import read_avi_index
    index = read_avi_index(os.path.join(out, 'results_00.avi'))
    assert len(index['frames']) == 12 and index['jpeg_ok'], index
    raw = cli.visualize_raw([os.path.join(tmp, 'depth.dat'), '-o', os.path.join(tmp, 'raw.avi'),
                             '--device', 'cpu'])
    assert len(read_avi_index(raw)['frames']) == 12
    res = cli.visualize_result([os.path.join(out, 'results_00.h5'), '--device', 'cpu'])
    assert len(read_avi_index(res)['frames']) == 12
    # the train command on a synthetic export: PNG views, two steps
    from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views
    export = write_annotated_views(os.path.join(tmp, 'views'), 6, size=64, seed=0)
    tcfg = cfg.replace(min_size_train=60, max_size_train=64, rpn_pre_nms_topk_train=64,
                       rpn_post_nms_topk_train=32, roi_batch_size_per_image=16,
                       ims_per_batch=2, max_gt_instances=1, warmup_iters=1)
    tcfg.to_yaml(os.path.join(tmp, 'train.yaml'))
    tdir = os.path.join(tmp, 'trained')
    assert cli.main(['train', export, '--model-dir', tdir, '--config',
                     os.path.join(tmp, 'train.yaml'), '--max-iter', '2',
                     '--device', 'cpu']) == 0
    assert os.listdir(os.path.join(tdir, 'checkpoints')) == ['model_0000002.pt']
    trained = Predictor.from_model_dir(tdir, batch_size=2, device='cpu')
    assert trained.cfg.max_iter == 2
    # the model lifecycle: convert-weights on a Detectron2 pickle of the tiny
    # model's weights, train --init-weights, evaluate, compile-model (export
    # and the post-export evaluation), infer-dataset and find-roi
    import json, pickle
    from moseq2_detectron_extract_tpu_torch.models.convert import detectron2_name_map
    tiny_state = MaskKeypointRCNN(tcfg).state_dict()
    d2 = {src: tiny_state[name].numpy() for src, name in detectron2_name_map()
          if name in tiny_state}
    with open(os.path.join(tmp, 'zoo.pkl'), 'wb') as fh:
        pickle.dump({'model': d2}, fh)
    cdir = os.path.join(tmp, 'converted')
    assert cli.main(['convert-weights', os.path.join(tmp, 'zoo.pkl'), '--model-dir', cdir,
                     '--config', os.path.join(tmp, 'train.yaml')]) == 0
    assert Predictor.from_model_dir(cdir, batch_size=2, device='cpu').cfg == tcfg
    assert cli.main(['train', export, '--model-dir', os.path.join(tmp, 'init'), '--config',
                     os.path.join(tmp, 'train.yaml'), '--max-iter', '1', '--device', 'cpu',
                     '--init-weights', os.path.join(tmp, 'zoo.pkl')]) == 0
    results = cli.evaluate([export, '--model-dir', mdir, '--device', 'cpu'])
    assert set(results) == {'bbox', 'segm', 'keypoints'}
    edir, post = cli.compile_model([export, '--model-dir', mdir, '--batch-size', '2',
                                    '--output', os.path.join(tmp, 'export'), '--device', 'cpu'])
    assert os.path.exists(os.path.join(edir, 'model.pt2')) and set(post) == set(results)
    pre = cli.infer_dataset([export, '--model-dir', mdir, '--instance-threshold', '0.0',
                             '--device', 'cpu'])
    with open(pre, encoding='utf-8') as fh:
        assert len(json.load(fh)) == 6
    found = cli.find_roi([os.path.join(tmp, 'depth.dat'), '--output-dir',
                          os.path.join(tmp, 'roi'), '--device', 'cpu'])
    assert found.roi.any()
    # the result upkeep: the outlier search, the flips, the trim (each edit
    # written anew and renamed) and the small commands
    res = os.path.join(out, 'results_00.h5')
    assert cli.main(['find-outliers', res]) == 0
    assert os.path.exists(os.path.join(out, 'results_00.flips.1.txt'))
    flips = os.path.join(tmp, 'flips.txt')
    with open(flips, 'w', encoding='utf-8') as fh:
        fh.write('0-4\n')
    assert cli.main(['verify-flips', flips]) == 0
    assert cli.main(['manual-flip', res, flips]) == 0
    assert cli.main(['trim-result', res, '--start', '1', '--stop', '11']) == 0
    with hdf5.File(res, 'r') as r:
        assert r['frames'].shape == (10, 80, 80) and 'metadata/extraction/flips_1' in r
    assert cli.main(['generate-extract-config', '-o', os.path.join(tmp, 'cfg.yaml')]) == 0
    assert cli.main(['dataset-info', export]) == 0
    assert cli.main(['system-info']) == 0
    # compressed depth: convert-raw-to-avi (Kinect frames) with its verify
    # pass, a read of the AVI; generate-dataset with the k-means
    import numpy as np
    from moseq2_detectron_extract_tpu_torch.io.video import load_movie_data
    kinect = os.path.join(tmp, 'kinect', 'depth.dat')
    os.makedirs(os.path.dirname(kinect))
    np.random.default_rng(0).integers(600, 720, (3, 424, 512), dtype='<u2').tofile(kinect)
    assert cli.main(['convert-raw-to-avi', kinect, '-b', '2', '--delete']) == 0
    assert not os.path.exists(kinect)
    frames = load_movie_data(os.path.join(tmp, 'kinect', 'depth.avi'), [2, 0])
    assert frames.shape == (2, 424, 512) and frames.dtype == np.uint16
    gen = os.path.join(tmp, 'dataset')
    assert cli.main(['generate-dataset', os.path.join(tmp, 'depth.dat'), '--output-dir', gen,
                     '--sample-method', 'kmeans', '--num-samples', '4', '--device', 'cpu']) == 0
    with open(os.path.join(gen, 'tasks.json'), encoding='utf-8') as fh:
        assert len(json.load(fh)) == 4
    # the last slice: extract with the prescaled input (the host resize
    # without cv2), extract-batch (emit, then in process on the CPU), the
    # off-path ops, and one data-parallel step at world 1 over gloo
    pout = os.path.join(tmp, 'prescaled')
    assert cli.main(['extract', os.path.join(tmp, 'depth.dat'), '--model', mdir,
                     '--device', 'cpu', '--chunk-size', '8', '--output-dir', pout,
                     '--device-input', 'prescaled']) == 0
    assert read_yaml(os.path.join(pout, 'results_00.yaml'))['complete'] is True
    batch_dir = os.path.join(tmp, 'batch')
    os.makedirs(batch_dir)
    shutil.copy(os.path.join(tmp, 'depth.dat'), os.path.join(batch_dir, 'depth.dat'))
    for name in ('metadata.json', 'depth_ts.txt'):
        if os.path.exists(os.path.join(tmp, name)):
            shutil.copy(os.path.join(tmp, name), os.path.join(batch_dir, name))
    assert cli.main(['extract-batch', batch_dir, '--model', mdir]) == 0
    bcfg = os.path.join(tmp, 'batch.yaml')
    with open(bcfg, 'w', encoding='utf-8') as fh:
        fh.write('chunk_size: 8\nshow_progress: false\n')
    assert cli.main(['extract-batch', batch_dir, '--model', mdir, '--config-file', bcfg,
                     '--in-process', '--device', 'cpu']) == 0
    assert read_yaml(os.path.join(batch_dir, 'proc', 'results_00.yaml'))['complete'] is True
    from moseq2_detectron_extract_tpu_torch.ops.cc import largest_cc
    from moseq2_detectron_extract_tpu_torch.ops.morphology import temporal_median
    from moseq2_detectron_extract_tpu_torch.proc.features import get_frame_features
    blobs = torch.zeros((2, 20, 20), dtype=torch.uint8)
    blobs[:, 2:6, 2:6] = 40
    blobs[:, 10:18, 9:19] = 50
    assert int(largest_cc(blobs > 0).sum()) == 160
    assert temporal_median(blobs, 3).shape == blobs.shape
    feats, _ = get_frame_features(blobs, mask_threshold=5, use_cc=True)
    assert abs(feats['centroid'][0, 0] - 13.5) < 1e-4, feats['centroid']
    from moseq2_detectron_extract_tpu_torch.models.train import create_train_state
    from moseq2_detectron_extract_tpu_torch.parallel import (make_dp_train_step, make_mesh,
                                                            replicate_state, shard_batch)
    import torch.distributed as dist
    mesh = make_mesh(0, 1, 'cpu', store_path=os.path.join(tmp, 'store'))
    dstate = replicate_state(mesh, create_train_state(tcfg, device='cpu'))
    rng = np.random.default_rng(0)
    hb = {'image': rng.uniform(0, 60, (2, 64, 64)).astype('float32'),
          'masks': np.zeros((2, 1, 64, 64), bool), 'keypoints': np.zeros((2, 1, 8, 3), 'float32'),
          'valid': np.ones((2, 1), bool)}
    hb['masks'][:, 0, 20:40, 16:48] = True
    hb['keypoints'][:, 0, :, :2] = 30.0
    hb['keypoints'][:, 0, :, 2] = 2.0
    dstate, dmetrics = make_dp_train_step(tcfg, mesh)(
        dstate, {k: torch.from_numpy(v) for k, v in shard_batch(mesh, hb).items()},
        torch.Generator().manual_seed(1))
    assert dstate.step == 1 and torch.isfinite(dmetrics['total_loss'])
    dist.destroy_process_group()
from moseq2_detectron_extract_tpu_torch.proc import kalman
params = kalman.KalmanParams(np.eye(3), np.eye(3)[:1], np.eye(3), np.eye(1), np.zeros(3),
                             np.eye(3))
smoothed = kalman.kalman_smooth(params, np.ones((5, 1)), np.array([0, 1, 0, 0, 0], bool),
                                backend='native')
assert np.isfinite(smoothed['means']).all()
scanned = kalman.kalman_smooth(params, np.ones((5, 1)), np.array([0, 1, 0, 0, 0], bool),
                               backend='scan')
assert np.allclose(scanned['means'], smoothed['means'], rtol=0, atol=1e-9)
from moseq2_detectron_extract_tpu_torch.proc import angles
assert angles.hampel_filter(np.r_[np.zeros(9), 50.0, np.zeros(9)], 5)[9] == 0
assert angles.interpolate_nan_values(np.array([0.0, np.nan, 2.0]))[1] == 1.0
from moseq2_detectron_extract_tpu_torch.ops import find_invalid_pixels, nms, roi_align
assert int(find_invalid_pixels(torch.tensor([[0, 3], [0, 0]])).sum()) == 3
top = nms.topk_after_nms(torch.rand(6, 4), torch.rand(6), torch.ones(6, dtype=torch.bool), 3)
assert len(top) == 4 and bool(top[2].all())
assert roi_align.roi_align_level(torch.rand(16, 16, 4), torch.tensor([[2.0, 2.0, 30.0, 40.0]]),
                                 7, 4).shape == (1, 7, 7, 4)
from moseq2_detectron_extract_tpu_torch.models import augment
draws = augment.draw_augment(torch.Generator().manual_seed(0), 1, 32, 'cpu')
sample = augment.augment_sample(augment.take_draw(draws, 0), torch.rand(32, 32) * 50,
                                torch.ones(1, 32, 32, dtype=torch.bool), torch.zeros(1, 8, 3),
                                torch.ones(1, dtype=torch.bool), None)
assert sample['image'].shape == (32, 32) and bool(sample['valid'][0])
from moseq2_detectron_extract_tpu_torch import viz
masks = np.zeros((1, 24, 30), bool)
masks[0, 5:15, 6:20] = True
drawn = viz.visualize_inference(np.full((24, 30), 50.0), {
    'masks': masks, 'keypoints': np.full((1, 8, 3), 10.0), 'scores': np.array([0.93]),
    'valid': np.ones(1, bool)}, 0, 100)
assert drawn.shape == (48, 60, 3) and drawn.std() > 0
from moseq2_detectron_extract_tpu_torch.io.annot import read_annotations
from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views
sys.modules['matplotlib.pyplot'] = None        # absent on the card's machine
with tempfile.TemporaryDirectory() as tmp:
    items = read_annotations(write_annotated_views(tmp, 3, size=40, seed=0),
                             list(viz.default_keypoint_names))
    stacked = viz.visualize_annotations(items, num=2, seed=1)
    assert stacked.shape == (40, 80, 3), stacked.shape
from moseq2_detectron_extract_tpu_torch.benchmarks import roi_stage2_exp
errors = roi_stage2_exp.main(device='cpu', check_shape=(1, 8, 16, 64))['errors']
assert len(errors) == 5 and max(errors.values()) < 0.05, errors
leaked = sorted(n for n in sys.modules if n.split('.')[0] in BLOCKED)
assert not leaked, leaked
print('OK')
'''


def test_port_imports_and_runs_with_blocked_modules():
    # one intra-op thread: beside the other test workers, torch's OpenMP
    # pool of one thread per core waits at each op's barrier for threads the
    # scheduler has taken away (six such processes on 8 cores ran this
    # script in ~460 s instead of ~30 s)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    result = subprocess.run([sys.executable, '-c', _SCRIPT % (BLOCKED, REPO)],
                            capture_output=True, text=True, env=env, cwd=REPO,
                            timeout=300, check=False)
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.strip().endswith('OK')


def _sources():
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith('.py'):
                yield os.path.join(root, name)
    yield os.path.join(REPO, 'chip_smoke.py')


@pytest.mark.parametrize('path', sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports_in_source(path):
    with open(path, encoding='utf-8') as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in BLOCKED, f'{path}: imports {name}'


def test_no_torch_extension_builder():
    for path in _sources():
        with open(path, encoding='utf-8') as fh:
            text = fh.read()
        assert 'cpp_extension' not in text, path
    for name in os.listdir(os.path.join(PKG, 'csrc')):
        with open(os.path.join(PKG, 'csrc', name), encoding='utf-8') as fh:
            assert 'torch/extension.h' not in fh.read(), name
