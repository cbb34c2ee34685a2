'''The training loop: the JAX package's ``Trainer`` on the port's train step.

Port of ``moseq2_detectron_extract_tpu/models/trainer.py``: periodic
checkpoints (every ``checkpoint_period`` and at ``max_iter``), the
validation loss every ``eval_period`` (LossEvalHook), device memory stats
(MemoryUsageHook, from ``torch.cuda``) and scalar metrics appended to
``metrics.jsonl`` every ``log_period`` steps, with the JAX writer's row
keys.

Each step draws its augmentations and its losses' sampling from one
``torch.Generator`` on the device, seeded with ``step + 1`` when
:meth:`Trainer.train` starts (the JAX trainer's ``PRNGKey(step + 1)``).
'''
import json
import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.io.annot import DataItem, dataset_catalog_get
from moseq2_detectron_extract_tpu_torch.io.util import ensure_dir
from moseq2_detectron_extract_tpu_torch.models.augment import augment_batch, draw_augment
from moseq2_detectron_extract_tpu_torch.models.checkpoint import (get_last_checkpoint,
                                                                  load_checkpoint,
                                                                  save_checkpoint)
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.data import TrainLoader, eval_batches
from moseq2_detectron_extract_tpu_torch.models.rcnn import draw_loss_uniforms
from moseq2_detectron_extract_tpu_torch.models.train import (TrainState, create_train_state,
                                                             make_eval_loss_step,
                                                             make_train_step)
from moseq2_detectron_extract_tpu_torch.utils.profiling import span


class MetricsWriter:
    '''Append-only jsonl of scalar metrics, one row per write.'''

    def __init__(self, path: str):
        self.path = path

    def write(self, step: int, metrics: dict) -> None:
        '''Append one row: ``step`` and every value that converts to float.'''
        row = {'step': int(step)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, 'a', encoding='utf-8') as fh:
            fh.write(json.dumps(row) + '\n')


def device_memory_stats() -> dict:
    '''Bytes in use on each CUDA device (none without CUDA).'''
    if not torch.cuda.is_available():
        return {}
    return {f'device{i}_bytes_in_use': torch.cuda.memory_allocated(i)
            for i in range(torch.cuda.device_count())}


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    '''A loader batch's four fields as tensors on ``device``.'''
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in ('image', 'masks', 'keypoints', 'valid')}


def augment_and_draw(batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                     generator: torch.Generator):
    '''One step's device input: the augmented, normalized images, their gt
    and the losses' draws, all drawn from ``generator``.'''
    b, s = batch['image'].shape[:2]
    device = batch['image'].device
    draws = draw_augment(generator, b, s, device)
    images, gt = augment_batch(draws, batch['image'], batch['masks'], batch['keypoints'],
                               batch['valid'], cfg)
    return images, gt, draw_loss_uniforms(generator, cfg, b, device)


class Trainer:
    '''Single-device training loop.'''

    def __init__(self, cfg: ModelConfig, model_dir: str,
                 train_items: Optional[Sequence[DataItem]] = None,
                 test_items: Optional[Sequence[DataItem]] = None,
                 log_period: int = 20, device='cuda'):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model_dir = ensure_dir(model_dir)
        self.train_items = list(train_items) if train_items is not None \
            else dataset_catalog_get('moseq_train')
        self.test_items = list(test_items) if test_items is not None \
            else dataset_catalog_get('moseq_test')
        self.metrics = MetricsWriter(os.path.join(model_dir, 'metrics.jsonl'))
        self.log_period = log_period
        self.state: Optional[TrainState] = None
        self._train_step = make_train_step(cfg)
        self._eval_step = make_eval_loss_step(cfg)

    def resume_or_load(self, resume: bool = False) -> None:
        '''Initialise the model and optimizer, restoring the latest
        checkpoint (step, weights, momentum) when resuming. A checkpoint
        without momentum (``convert-weights`` writes one) restores the step
        and the weights.'''
        self.state = create_train_state(self.cfg, seed=0, device=self.device)
        if resume:
            ckpt = get_last_checkpoint(self.model_dir)
            if ckpt is not None:
                logging.info('Resuming from %s', ckpt)
                restored = load_checkpoint(ckpt)
                self.state.model.load_state_dict(restored['model'])
                if 'optimizer' in restored:
                    self.state.optimizer.load_state_dict(restored['optimizer'])
                self.state.step = int(restored['step'])

    def checkpoint(self) -> str:
        '''Save the state as the checkpoint of its step.'''
        st = self.state
        return save_checkpoint(self.model_dir, st.step,
                               {'step': st.step, 'model': st.model.state_dict(),
                                'optimizer': st.optimizer.state_dict()})

    def train(self) -> TrainState:
        '''Run the solver schedule from the state's step to ``max_iter``.
        Each step is the root span ``train.step`` (with the thread's CPU
        time), and inside it ``train.wait_batch`` (the loader's next batch),
        ``train.to_device``, ``train.augment`` and the step's own spans.'''
        if self.state is None:
            raise RuntimeError('call resume_or_load() first')
        cfg = self.cfg
        loader = TrainLoader(self.train_items, cfg)
        generator = torch.Generator(self.device).manual_seed(self.state.step + 1)
        start_step = self.state.step
        logging.info('Starting training at iteration %d / %d', start_step, cfg.max_iter)
        t_last = time.time()
        try:
            for step in range(start_step, cfg.max_iter):
                with span('train.step', cpu=True):
                    with span('train.wait_batch'):
                        host_batch = next(loader)
                    with span('train.to_device'):
                        batch = batch_to_device(host_batch, self.device)
                    with span('train.augment'):
                        images, gt, draws = augment_and_draw(batch, cfg, generator)
                    self.state, metrics = self._train_step(
                        self.state, {'images': images, 'gt': gt}, draws)

                    if (step + 1) % self.log_period == 0:
                        metrics = {k: float(v) for k, v in metrics.items()}
                        elapsed = time.time() - t_last
                        t_last = time.time()
                        metrics['iters_per_sec'] = self.log_period / max(elapsed, 1e-9)
                        metrics.update(device_memory_stats())
                        self.metrics.write(step + 1, metrics)
                        logging.info('iter %d: total_loss=%.4f lr=%.5f (%.2f it/s)',
                                     step + 1, metrics['total_loss'], metrics['lr'],
                                     metrics['iters_per_sec'])

                    if (step + 1) % cfg.eval_period == 0 and self.test_items:
                        self._run_validation(step + 1, generator)

                    if (step + 1) % cfg.checkpoint_period == 0 or (step + 1) == cfg.max_iter:
                        logging.info('Saved checkpoint %s', self.checkpoint())
        finally:
            loader.close()
        return self.state

    def _run_validation(self, step: int, generator: torch.Generator) -> None:
        '''Mean validation loss over the test split.'''
        losses = []
        for batch in eval_batches(self.test_items, self.cfg):
            images, gt, draws = augment_and_draw(batch_to_device(batch, self.device),
                                                 self.cfg, generator)
            out = self._eval_step(self.state.model,
                                  {'images': images, 'gt': gt}, draws)
            losses.append(float(out['total_loss']))
        mean_loss = float(np.mean(losses)) if losses else float('nan')
        self.metrics.write(step, {'validation_loss': mean_loss})
        logging.info('iter %d: validation_loss=%.4f', step, mean_loss)
