'''Data-parallel training: one process per device, the batch split over the
ranks, the model and its optimizer the same on every rank.

Port of ``moseq2_detectron_extract_tpu/parallel/data_parallel.py``
(``shard_batch``, ``replicate_state`` and ``make_dp_train_step``, lines
1-78). The JAX step is one program over the whole sharded batch, so its
losses are the global batch's. Each loss divides a sum by a count over the
batch: sampled ROIs, positive ROIs, visible keypoints, and images for the
RPN (``models/rcnn.py``). A plain average of per-rank mean losses is not
that loss when the ranks' counts differ. So each rank sums each count over
the ranks first (``MaskKeypointRCNN.losses(global_count=...)``); its loss
is then its own sum over the global count, and the sum over the ranks of
the ranks' gradients is the global batch's gradient. The gradients are
summed in one all-reduce; the non-finite cleaning, the global-norm clip and
SGD (``models/train.apply_gradients``) then run on every rank alike.

The random draws are the global batch's too: every rank draws the
augmentations and the losses' sampling for all ``world * b`` images from
one generator seeded alike on every rank, and takes its own rows, so that
world W trains the model world 1 trains on the same batch.
'''
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from moseq2_detectron_extract_tpu_torch.models.augment import augment_batch, draw_augment
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.rcnn import draw_loss_uniforms
from moseq2_detectron_extract_tpu_torch.models.train import TrainState, apply_gradients
from moseq2_detectron_extract_tpu_torch.parallel.mesh import Mesh

# a generator (the step draws for the global batch) or the global batch's
# (augmentation draws, loss draws)
Draws = Union[torch.Generator, Tuple[Dict, Dict]]


def shard_batch(mesh: Mesh, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    '''This rank's rows of a host batch (a dict of arrays with one leading
    batch axis, divisible by the world).'''
    b = len(next(iter(batch.values())))
    if b % mesh.world:
        raise ValueError(f'batch of {b} does not split over {mesh.world} ranks')
    per = b // mesh.world
    return {k: v[mesh.rank * per:(mesh.rank + 1) * per] for k, v in batch.items()}


def _tensors(state: TrainState):
    '''The parameters, the buffers and the momentum buffers, in one order on
    every rank.'''
    out = list(state.model.parameters()) + list(state.model.buffers())
    for group in state.optimizer.param_groups:
        for p in group['params']:
            buf = state.optimizer.state.get(p, {}).get('momentum_buffer')
            if buf is not None:
                out.append(buf)
    return out


def replicate_state(mesh: Mesh, state: TrainState) -> TrainState:
    '''Make every rank's model, momentum and step rank 0's (a broadcast of
    each). The ranks must hold the same kind of state: the same model and
    momentum buffers on all ranks or on none.'''
    with torch.no_grad():
        for t in _tensors(state):
            dist.broadcast(t, src=0)
    step = torch.tensor([state.step], dtype=torch.int64, device=mesh.device)
    dist.broadcast(step, src=0)
    state.step = int(step.item())
    return state


def _rows(tree, lo: int, hi: int):
    '''Rows ``lo:hi`` of every tensor of a nested dict / tuple of draws.'''
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rows(v, lo, hi) for v in tree)
    return tree[lo:hi]


def _sum_over_ranks(value: torch.Tensor) -> torch.Tensor:
    '''A detached copy of ``value`` summed over the ranks.'''
    out = value.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def _sum_gradients(params) -> None:
    '''Sum every parameter's gradient over the ranks, in one flat
    all-reduce.'''
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_dp_train_step(cfg: ModelConfig, mesh: Mesh):
    '''``(state, batch, draws) -> (state, metrics)``: one data-parallel step.

    ``batch`` holds this rank's rows (:func:`shard_batch`) of the loader's
    four fields (``image``, ``masks``, ``keypoints``, ``valid``) as tensors
    on ``mesh.device``; every rank has the same number of rows. ``draws`` is
    a ``torch.Generator`` on that device, seeded alike on every rank (the
    global batch's augmentation draws, then its loss draws, are drawn from
    it as the single-device ``Trainer`` draws them), or the global batch's
    (augmentation draws, loss draws). The step augments its rows, takes the
    losses with the counts summed over the ranks, sums the gradients over
    the ranks and updates the model with the port's clip and SGD. The
    metrics, each loss summed over the ranks (the global batch's) and
    ``lr``, are the same on every rank.
    '''
    def dp_step(state: TrainState, batch: Dict[str, torch.Tensor], draws: Draws):
        b, s = batch['image'].shape[:2]
        total = b * mesh.world
        if isinstance(draws, torch.Generator):
            aug = draw_augment(draws, total, s, batch['image'].device)
            loss_draws = draw_loss_uniforms(draws, cfg, total, batch['image'].device)
        else:
            aug, loss_draws = draws
        lo, hi = mesh.rank * b, (mesh.rank + 1) * b
        images, gt = augment_batch(_rows(aug, lo, hi), batch['image'], batch['masks'],
                                   batch['keypoints'], batch['valid'], cfg)
        losses = state.model.losses(images, gt, _rows(loss_draws, lo, hi),
                                    global_count=_sum_over_ranks)
        losses['total_loss'].backward()
        params = [p for group in state.optimizer.param_groups for p in group['params']]
        _sum_gradients(params)
        metrics = {k: _sum_over_ranks(v) for k, v in losses.items()}
        metrics['lr'] = apply_gradients(state, cfg)
        return state, metrics

    return dp_step
