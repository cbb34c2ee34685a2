'''The port imports neither JAX nor cv2/h5py/yaml/click nor the JAX package,
and runs ``process_chunk`` on the CPU with all of them blocked.'''
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'moseq2_detectron_extract_tpu_torch')
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cv2', 'h5py', 'yaml',
           'click', 'moseq2_detectron_extract_tpu')

_SCRIPT = r'''
import importlib, pkgutil, sys
BLOCKED = %r

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'blocked import of {name}')
        return None

sys.meta_path.insert(0, Blocker())
for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]

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
leaked = sorted(n for n in sys.modules if n.split('.')[0] in BLOCKED)
assert not leaked, leaked
print('OK')
'''


def test_port_imports_and_runs_with_blocked_modules():
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, '-c', _SCRIPT % (BLOCKED,)],
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
