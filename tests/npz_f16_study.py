'''Does the f16 npz move a barely trained model's top detection in the JAX
package as it does in the port? (the question of ``ROADMAP.md`` §3: on the
card the 70-step model's top detection from ``params_f16.npz`` differs from
the f32 checkpoint's in 3-4 of 16 views).

    JAX_PLATFORMS=cpu python -m tests.npz_f16_study train --work DIR [--steps 20]
    JAX_PLATFORMS=cpu python -m tests.npz_f16_study compare --work DIR \
        [--checkpoint STEP] [--amp float32|bfloat16]

``train`` trains the full-width fast160 model with the port on the CPU
(``cli.main(['train', ...])``, f32) on ``chip_smoke.py`` phase 4d's 48
synthetic views and changes (warmup 10, checkpoints every 10 steps here):
about 75 s a step on 6 cores. ``compare`` feeds the first 16 views to both
packages' Predictors (score threshold 0, batch 8, in ``--amp``) with the
checkpoint's f32 weights and with the same weights rounded to f16 with
numpy, and prints each package's per-view top-box IoU and score gap
between the two weight sets, and the port against the JAX package for
each set, as one JSON line (also written to ``DIR/report_<step>_<amp>.json``).
A study script, not a test: it runs full width on the CPU.
'''
import argparse
import json
import os
import sys

import numpy as np

VIEWS, VIEW_SIZE, COMPARED = 48, 150, 16
CHANGES = {'warmup_iters': 10, 'eval_period': 30, 'checkpoint_period': 10}
FAST160 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       'benchmarks', 'bench_model_fast160', 'config.yaml')


def train(work: str, steps: int) -> None:
    from moseq2_detectron_extract_tpu_torch import cli
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views
    export = write_annotated_views(os.path.join(work, 'data'), VIEWS, size=VIEW_SIZE, seed=0)
    cfg = ModelConfig.from_yaml(FAST160).replace(amp_dtype='float32', **CHANGES)
    cfg.to_yaml(os.path.join(work, 'config.yaml'))
    cli.main(['train', export, '--model-dir', os.path.join(work, 'model'), '--config',
              os.path.join(work, 'config.yaml'), '--max-iter', str(steps), '--log-period', '1',
              '--device', 'cpu'])


def _tree(flat):
    out = {}
    for key, value in flat.items():
        node = out
        parts = key.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def _iou(a, b):
    w = np.clip(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]), 0, None)
    h = np.clip(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]), 0, None)
    inter = w * h
    area = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]) + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area - inter, 1e-12)


def compare(work: str, checkpoint: str, amp: str) -> dict:
    import torch
    from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
    from moseq2_detectron_extract_tpu.models.predictor import Predictor as JaxPredictor
    from moseq2_detectron_extract_tpu_torch.io.annot import read_annotations
    from moseq2_detectron_extract_tpu_torch.io.image import read_image
    from moseq2_detectron_extract_tpu_torch.models.checkpoint import load_model_dir
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.models.weights import params_from_jax, params_to_jax
    from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names
    from tests.test_torch_common import port_config

    _, state, step = load_model_dir(os.path.join(work, 'model'), checkpoint=checkpoint)
    jcfg = JaxModelConfig.from_yaml(os.path.join(work, 'config.yaml')).replace(amp_dtype=amp)
    flat32 = params_to_jax(state, jcfg.box_pooler_resolution)
    weights = {'f32': flat32,
               'f16': {k: v.astype(np.float16).astype(np.float32) for k, v in flat32.items()}}
    items = read_annotations(os.path.join(work, 'data', 'export.json'), default_keypoint_names)
    frames = np.stack([read_image(it['file_name']) for it in items[:COMPARED]]).astype(np.uint8)
    top = {}
    for name, flat in weights.items():
        port = Predictor(port_config(jcfg), params_from_jax(flat), batch_size=8,
                         score_threshold=0.0, device='cpu')
        with torch.no_grad():
            det = port(torch.from_numpy(frames))
        top['port', name] = (det['boxes'][:, 0].float().numpy(),
                             det['scores'][:, 0].float().numpy())
        det = JaxPredictor(jcfg, _tree(flat), batch_size=8, score_threshold=0.0)(frames)
        top['jax', name] = (np.asarray(det['boxes'])[:, 0].astype(np.float32),
                            np.asarray(det['scores'])[:, 0].astype(np.float32))
    report = {'step': step, 'amp': amp}
    for pkg in ('port', 'jax'):
        (b32, s32), (b16, s16) = top[pkg, 'f32'], top[pkg, 'f16']
        iou, gap = _iou(b32, b16), np.abs(s32 - s16)
        report[pkg] = {'iou': iou.round(4).tolist(), 'gap': gap.round(4).tolist(),
                       'same_0.9': int((iou >= 0.9).sum()), 'min_iou': float(iou.min()),
                       'max_gap': float(gap.max())}
    for name in weights:
        iou = _iou(top['port', name][0], top['jax', name][0])
        report[f'port_vs_jax_{name}'] = {
            'min_iou': float(iou.min()),
            'max_gap': float(np.abs(top['port', name][1] - top['jax', name][1]).max())}
    with open(os.path.join(work, f'report_{step}_{amp}.json'), 'w', encoding='utf-8') as fh:
        json.dump(report, fh, indent=1)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('mode', choices=['train', 'compare'])
    p.add_argument('--work', required=True)
    p.add_argument('--steps', type=int, default=20)
    p.add_argument('--checkpoint', default='last')
    p.add_argument('--amp', default='float32', choices=['float32', 'bfloat16'])
    p.add_argument('--threads', type=int, default=6)
    args = p.parse_args(argv)
    import torch
    torch.set_num_threads(args.threads)
    os.makedirs(args.work, exist_ok=True)
    if args.mode == 'train':
        train(args.work, args.steps)
    else:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        print(json.dumps(compare(args.work, args.checkpoint, args.amp)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
