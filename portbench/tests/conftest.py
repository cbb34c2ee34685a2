'''Fixtures of the benchmark's own tests: a throwaway checkout root that
holds the benchmark's files plus test cells on a tiny random model.

Run from the repository's root: ``python -m pytest portbench/tests``.
'''
import dataclasses
import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    '''The card, decided when the test runs; skips without one.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run on the GPU machine)')
    return torch.device('cuda', 0)


def tiny_model(folder: str, seed: int = 0) -> dict:
    '''A random Keypoint + Mask R-CNN of tiny widths written as a model
    folder (config.yaml and params_f16.npz); returns its configuration.'''
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
    from moseq2_detectron_extract_tpu_torch.models.train import init_flax_defaults
    from moseq2_detectron_extract_tpu_torch.models.weights import save_params_npz
    cfg = ModelConfig().replace(
        image_size=64, min_size_test=60, max_size_test=64, min_size_train=60,
        max_size_train=64, resnet_width=16, resnet_stage_blocks=(1, 1, 1, 1), fpn_channels=64,
        box_fc_dim=128, mask_conv_dims=(64, 64), keypoint_conv_dims=(64, 64),
        anchor_sizes=((8,), (16,), (32,), (64,), (128,)), roi_batch_size_per_image=32,
        rpn_pre_nms_topk_train=128, rpn_post_nms_topk_train=64, rpn_pre_nms_topk_test=64,
        rpn_post_nms_topk_test=16, rpn_nms_global_cap=64, test_score_thresh=0.0,
        ims_per_batch=4)
    model = MaskKeypointRCNN(cfg)
    init_flax_defaults(model, torch.Generator().manual_seed(seed))
    os.makedirs(folder, exist_ok=True)
    cfg.to_yaml(os.path.join(folder, 'config.yaml'))
    save_params_npz(os.path.join(folder, 'params_f16.npz'), model.state_dict())
    return json.loads(json.dumps({f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))


@pytest.fixture(scope='session')
def tiny_root(tmp_path_factory):
    '''A checkout root with the benchmark's files, a tiny model and two
    test cells on it: ``tiny-infer`` (chunks of 6 frames) and
    ``tiny-train`` (batch 4).'''
    root = str(tmp_path_factory.mktemp('checkout'))
    shutil.copytree(os.path.join(ROOT, 'portbench'), os.path.join(root, 'portbench'),
                    ignore=shutil.ignore_patterns('data', '__pycache__', 'tests'))
    config = tiny_model(os.path.join(root, 'tinymodel'))
    config['model_dir'] = 'tinymodel'
    bench = os.path.join(root, 'portbench')
    with open(os.path.join(bench, 'configs', 'tiny.json'), 'w', encoding='utf-8') as fh:
        json.dump(config, fh)
    traffic = {
        'tiny-chunks': {'driver': 'infer_chunks', 'chunk_frames': 6, 'ring': 2,
                        'batch_size': 3, 'frame_height': 424, 'frame_width': 512,
                        'warmup_chunks': 1, 'samples_per_chunk': 3, 'reference_batch': 3,
                        'extract_config': {'min_height': 0.0, 'max_height': 100.0,
                                           'feature_window': 160}},
        'tiny-views': {'driver': 'train_steps', 'views': 8, 'view_size': 64,
                       'warmup_steps': 4, 'checked_steps': 3, 'log_period': 20,
                       'traced_steps': 1}}
    for name, body in traffic.items():
        with open(os.path.join(bench, 'traffic', name + '.json'), 'w', encoding='utf-8') as fh:
            json.dump(body, fh)
    manifest = json.load(open(os.path.join(ROOT, 'BENCHMARK.json'), encoding='utf-8'))
    manifest['configs'].append({'name': 'tiny', 'source': 'test', 'reduced': [], 'why': 'test',
                                'file': 'portbench/configs/tiny.json'})
    for cell, traffic_name, metric in (('tiny-infer', 'tiny-chunks', 'infer_fps'),
                                       ('tiny-train', 'tiny-views', 'train_img_s')):
        manifest['workloads'].append({'name': cell, 'config': 'tiny', 'traffic': traffic_name,
                                      'chips': 1, 'why': 'test'})
        for m in manifest['end_to_end'] + manifest['per_layer']:
            if metric in (m['name'], m.get('moves')) and 'workloads' in m:
                m['workloads'].append(cell)
        shutil.copy(os.path.join(bench, 'workloads', {
            'infer_fps': 'infer-faithful-b50', 'train_img_s': 'train-faithful-b8'}[metric]
            + '.json'), os.path.join(bench, 'workloads', cell + '.json'))
    with open(os.path.join(root, 'BENCHMARK.json'), 'w', encoding='utf-8') as fh:
        json.dump(manifest, fh)
    return root
