'''Fine-tuning from the committed weights through the trainer's own loop,
``models/trainer.py:Trainer.train``: its loader thread reads the annotated
views, the augmentations and the losses' sampling run on the card, then
backward and the SGD update. Closed loop, batch ``ims_per_batch``.

Set-up writes the seed's annotated views (PNG and a Label Studio export)
under ``portbench/data/<cell>/`` (kept while the seed stays the same),
builds the trainer once, loads the committed weights, and drives the
trainer through its first ``warmup_steps`` steps, recording the first
``checked_steps`` for the check; the window goes on with the same trainer.

Traffic keys: ``views``, ``view_size``, ``warmup_steps``, ``checked_steps``,
``log_period``, ``traced_steps``.
'''
import json
import os
import shutil
import struct
import sys
import tempfile
import time
import zlib
from typing import Dict, List

import numpy as np
import torch

from portbench.core import HostMeter, Outcome, check, phase, program_config, verify_config
from portbench.reference import detector as ref
from portbench.reference import train as reftrain
from portbench.yardstick import synth
from portbench.yardstick.trace import host_gaps, traced


class StopTraining(Exception):
    '''Raised from the step boundary to end a ``Trainer.train`` call.'''


def write_png(path: str, image: np.ndarray) -> None:
    '''An 8-bit grey PNG, rows unfiltered.'''
    h, w = image.shape

    def chunk(kind, data):
        return struct.pack('>I', len(data)) + kind + data + \
            struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF)
    raw = b''.join(b'\x00' + image[r].tobytes() for r in range(h))
    with open(path, 'wb') as fh:
        fh.write(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 0, 0, 0, 0))
                 + chunk(b'IDAT', zlib.compress(raw, 6)) + chunk(b'IEND', b''))


def write_views(folder: str, n: int, size: int, seed: int) -> str:
    '''The seed's annotated views and their export; reused when the folder
    already holds this seed's.'''
    export = os.path.join(folder, 'export.json')
    marker = os.path.join(folder, 'seed')
    if os.path.isfile(marker) and open(marker, encoding='utf-8').read() == f'{seed} {n} {size}':
        return export
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    tasks = []
    base = {'original_width': size, 'original_height': size, 'image_rotation': 0}
    for i, view in enumerate(synth.annotated_views(n, size, seed)):
        name = f'view_{i:04d}_depth.png'
        write_png(os.path.join(folder, name), view['image'])
        result = [dict(base, type='polygonlabels', from_name='label', to_name='image',
                       value={'points': [[100.0 * x / size, 100.0 * y / size]
                                         for x, y in view['outline']],
                              'polygonlabels': ['mouse']})]
        for kp_name, (x, y) in zip(synth.KEYPOINT_NAMES, view['keypoints']):
            result.append(dict(base, type='keypointlabels', from_name='kp', to_name='image',
                               value={'x': 100.0 * x / size, 'y': 100.0 * y / size,
                                      'width': 0.5, 'keypointlabels': [kp_name]}))
        tasks.append({'id': i + 1,
                      'data': {'image': os.path.join(folder, f'{i:08x}-{name}')},
                      'annotations': [{'id': i + 1, 'result': result}]})
    with open(export, 'w', encoding='utf-8') as fh:
        json.dump(tasks, fh)
    with open(marker, 'w', encoding='utf-8') as fh:
        fh.write(f'{seed} {n} {size}')
    return export


def to_host(x):
    if torch.is_tensor(x):
        return x.detach().to('cpu', copy=True)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


class StepBoundary:
    '''Wraps the trainer's step: records what the check needs during
    set-up, and ends each ``train`` call after a number of steps or once
    the window's time is up.'''

    def __init__(self, trainer, faults):
        self.trainer = trainer
        self.inner = trainer._train_step
        self.faults = faults
        self.record = 0
        self.batches: List[Dict] = []
        self.losses: List[float] = []
        self.momentum = None
        self.stop_after = None
        self.deadline = None
        self.steps = 0
        trainer._train_step = self

    def __call__(self, state, batch, draws):
        recording = len(self.batches) < self.record
        if recording:
            self.batches.append(to_host({'images': batch['images'], 'gt': batch['gt'],
                                         'draws': draws}))
            model = state.model
            model.proposals = ProposalRecorder(model.proposals)
        if 'half_batch' in self.faults:                   # planted fault: half the images
            half = batch['images'].shape[0] // 2
            batch = {'images': batch['images'][:half],
                     'gt': {k: v[:half] for k, v in batch['gt'].items()}}
            draws = {k: tuple(u[:half] for u in v) for k, v in draws.items()}
        if 'frozen_step' in self.faults:                  # planted fault: no update
            losses = state.model.losses(batch['images'], batch['gt'], draws)
            metrics = {k: v.detach() for k, v in losses.items()}
            state.step += 1
        else:
            state, metrics = self.inner(state, batch, draws)
        if recording:
            self.batches[-1]['program_proposals'] = model.proposals.seen
            del model.proposals
        self.steps += 1
        if len(self.losses) < self.record:
            self.losses.append({k: float(v) for k, v in metrics.items() if k != 'lr'})
            if len(self.losses) == 1:
                self.momentum = {n: to_host(s['momentum_buffer'])
                                 for n, s in _named_state(state).items()}
        if self.stop_after is not None and self.steps >= self.stop_after:
            raise StopTraining
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise StopTraining
        return state, metrics


class ProposalRecorder:
    '''Wraps the model's proposal stage for one step and keeps what it
    gave: the proposals (boxes, valid) and the RPN outputs they came from.'''

    def __init__(self, inner):
        self.inner = inner
        self.seen = None

    def __call__(self, *args, **kwargs):
        boxes, valid, (logits, deltas, anchors) = self.inner(*args, **kwargs)
        self.seen = to_host({'boxes': boxes, 'valid': valid, 'logits': list(logits),
                             'deltas': list(deltas)})
        return boxes, valid, (logits, deltas, anchors)


def _named_state(state) -> Dict[str, Dict]:
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: s for p, s in state.optimizer.state.items()
            if 'momentum_buffer' in s and s['momentum_buffer'] is not None}


def drive(trainer, boundary, steps=None, deadline=None) -> None:
    boundary.steps, boundary.stop_after, boundary.deadline = 0, steps, deadline
    try:
        trainer.train()
    except StopTraining:
        pass


def run(ctx) -> Outcome:
    from moseq2_detectron_extract_tpu_torch.io.annot import load_annotations_helper
    from moseq2_detectron_extract_tpu_torch.models.checkpoint import load_model_dir
    from moseq2_detectron_extract_tpu_torch.models.trainer import Trainer
    from moseq2_detectron_extract_tpu_torch.ops import nms

    cell, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    phase(ctx, 'program imported')
    export = write_views(ctx.data_dir, tr['views'], tr['view_size'], ctx.seed)
    items = load_annotations_helper([export], 'RGB', register=False, show_info=False)
    cfg, state_dict, _ = load_model_dir(cell.model_dir)
    cfg, changed = program_config(cfg, cell.config)
    print('portbench: the configuration file sets ' + json.dumps(changed), file=sys.stderr)
    verify_config(cfg, cell.config)
    phase(ctx, 'views and weights read')
    work = tempfile.mkdtemp(prefix='portbench-train-')
    try:
        trainer = Trainer(cfg, work, train_items=items, test_items=[],
                          log_period=tr['log_period'], device=dev)
        trainer.resume_or_load(resume=False)
        trainer.state.model.load_state_dict(state_dict)
        start = {n: to_host(p) for n, p in trainer.state.model.named_parameters()}
        phase(ctx, 'trainer built')
        boundary = StepBoundary(trainer, ctx.faults)
        boundary.record = tr['checked_steps']
        drive(trainer, boundary, steps=tr['checked_steps'])
        after = {n: to_host(p) for n, p in trainer.state.model.named_parameters()}
        drive(trainer, boundary, steps=tr['warmup_steps'] - tr['checked_steps'])
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        phase(ctx, 'warmed up')

        nms.sync_count = 0
        host = HostMeter()
        window_start = time.perf_counter()
        drive(trainer, boundary, deadline=window_start + ctx.seconds)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        window_end = time.perf_counter()
        print('portbench: host over the window ' + json.dumps(host.read()), file=sys.stderr)
        steps = boundary.steps
        images = steps * cfg.ims_per_batch
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
        observed = {'steps': steps, 'images': images, 'window_s': window_end - window_start,
                    'nms_syncs': nms.sync_count, 'model': cell.config}
        trace = None
        if ctx.trace:
            trace = traced(lambda: drive(trainer, boundary, steps=tr['traced_steps']))
            trace.idle_by_host = host_gaps(
                lambda: drive(trainer, boundary, steps=tr['traced_steps']))
        batches, losses, momentum = boundary.batches, boundary.losses, boundary.momentum
        del trainer, boundary
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    phase(ctx, 'window closed')
    checks = compare(ctx, batches, losses, start, momentum, after, cfg.weight_decay)
    phase(ctx, 'checked')
    rate = images / (window_end - window_start)
    return Outcome(window_start=window_start, e2e={'train_img_s': rate},
                   attempted=steps, failed=0, memory_peak_bytes=peak, checks=checks,
                   observed=observed, trace=trace)


def flax_key(torch_name: str, flax_keys) -> str:
    '''The npz key of a program parameter: dots become slashes, a conv or
    dense ``weight`` is a ``kernel``, a GroupNorm's is a ``scale``.'''
    path = torch_name.rsplit('.', 1)
    head = path[0].replace('.', '/')
    if path[1] == 'weight':
        return head + '/kernel' if head + '/kernel' in flax_keys else head + '/scale'
    return head + '/' + path[1]


def gap(program: torch.Tensor, reference: torch.Tensor, floor: float) -> float:
    '''The gap between two norms, against the reference's or the floor.'''
    a, b = float(program.double().norm()), float(reference.double().norm())
    return abs(a - b) / max(b, floor, 1e-30)


def follow(params, cfg, batches, dev, quant=None, own_proposals=False):
    """A reference solver through the recorded steps, each on the proposals
    the program's step sampled from (or, with ``own_proposals``, on its
    own): (each step's loss, the first step's clipped gradient, the change
    of every leaf)."""
    solver = reftrain.Solver(params, cfg)
    losses, first = [], None
    for batch in batches:
        step = to_device({k: batch[k] for k in ('images', 'gt', 'draws')}, dev)
        seen = None if own_proposals else batch['program_proposals']
        if seen is not None and seen['boxes'].shape[0] == step['images'].shape[0]:
            step['proposals'] = (seen['boxes'].to(dev), seen['valid'].to(dev))
        out, grads = solver.run(step, quant=quant)
        losses.append(out)
        if first is None:
            first = {k: g.cpu() for k, g in grads.items()}
    change = {k: (solver.params[k] - params[k]).detach().cpu() for k in first}
    return losses, first, change


def unmatched(a: torch.Tensor, b: torch.Tensor, tol: float = 1e-3) -> int:
    """Boxes of (n, 4) ``a`` with no box of (m, 4) ``b`` within ``tol`` px
    in every coordinate, and the other way round."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return a.shape[0] + b.shape[0]
    near = (a[:, None, :] - b[None, :, :]).abs().amax(-1) <= tol
    return int((~near.any(1)).sum()) + int((~near.any(0)).sum())


def proposal_mismatch(params, cfg, batches, dev) -> int:
    """The proposal stage by itself: the reference's selection of the
    program's own RPN outputs against the program's proposals, as sets per
    image: boxes of either with no twin within 1e-3 px in the other, over
    the recorded steps (every slot of an image the program left out). A
    near tie at the NMS threshold may keep one box for another."""
    det = ref.Detector(params, cfg)
    a = len(cfg['anchor_sizes'][0]) * len(cfg['anchor_aspect_ratios'])
    slots = cfg['rpn_post_nms_topk_train']
    bad = 0
    for batch in batches:
        seen = batch['program_proposals']
        images = batch['images'].shape[0]
        if seen is None:
            bad += images * slots
            continue
        sides = [int(round((lg.shape[1] / a) ** 0.5)) for lg in seen['logits']]
        boxes, valid = reftrain.train_proposals(
            det, sides, [x.to(dev) for x in seen['logits']], [x.to(dev) for x in seen['deltas']],
            cfg['image_size'])
        pv, pb = seen['valid'].to(dev), seen['boxes'].to(dev)
        for i in range(pv.shape[0]):
            bad += unmatched(pb[i][pv[i]], boxes[i][valid[i]])
        bad += (images - pv.shape[0]) * slots
    return bad


def compare(ctx, batches, losses, start, momentum, after, weight_decay) -> List[Dict]:
    """The reference follows the recorded steps from the npz's weights: the
    first step's loss, the first gradient by the worst leaf, the change
    after the last step by the median leaf, and the proposal stage by
    itself. The program's first gradient is its momentum after one step
    less the weight decay of the starting weights."""
    dev, cfg, limits = ctx.device, ctx.cell.config, ctx.cell.limits
    params = ref.load_npz(ctx.cell.model_dir + '/params_f16.npz', dev)
    with ref.full_float32():
        ref_losses, ref_grads, ref_change = follow(params, cfg, batches, dev)
        if 'control' in ctx.faults:
            # the control: the reference in float8 stands as the program
            losses, prog_grads, prog_change = follow(params, cfg, batches, dev, quant='fp8')
        else:
            keys = set(params)
            prog_grads = {flax_key(n, keys): buf - weight_decay * start[n]
                          for n, buf in (momentum or {}).items()}
            prog_change = {flax_key(n, keys): after[n] - start[n] for n in start}
    g_norms = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    g_median = float(np.median(list(g_norms.values())))
    c_median = float(np.median([float(c.double().norm()) for c in ref_change.values()]))
    for step, (a, b) in enumerate(zip(losses, ref_losses)):
        print(f'portbench: step {step} losses ' + json.dumps(
            {k: [a[k], b[k]] for k in b}), file=sys.stderr)
    step_gaps = loss_gaps(losses, ref_losses)
    # the first step's loss, and the worst of the later steps', which the
    # first update moves
    nums = {'loss_gap': step_gaps[0], 'loss_gap_late': max(step_gaps[1:], default=0.0)}
    if 'witness' in ctx.faults:
        witness(params, cfg, batches, dev, losses, ref_losses, ref_grads)
    with ref.full_float32():
        nums['proposal_mismatch'] = proposal_mismatch(params, cfg, batches, dev)
    nums['grad_gap'] = max(gap(prog_grads.get(k, torch.zeros_like(g)), g, g_median)
                           for k, g in ref_grads.items())
    # leaves the reference's gradient leaves at round-off move by round-off alone
    moved = [k for k in ref_change if g_norms[k] >= 1e-3 * g_median]
    changes = sorted((gap(prog_change.get(k, torch.zeros_like(ref_change[k])), ref_change[k],
                          c_median), k) for k in moved)
    nums['change_gap'] = float(np.median([c for c, _ in changes]))
    print('portbench: worst changes ' + json.dumps(changes[-3:]), file=sys.stderr)
    print('portbench: compared ' + json.dumps(nums), file=sys.stderr)
    return [check(name, nums[name], limit) for name, limit in limits['limits'].items()]


def loss_gaps(losses, ref_losses) -> List[float]:
    '''Each step's total-loss gap against the reference's, as a share.'''
    return [abs(a['total_loss'] - b['total_loss']) / abs(b['total_loss'])
            for a, b in zip(losses, ref_losses)]


def witness(params, cfg, batches, dev, losses, ref_losses, ref_grads) -> None:
    '''Second readings of the same recorded steps, printed on stderr: the
    reference under bfloat16 autocast, the reference on its own
    proposals, and the float8 control, each against the float32
    reference, beside the program's.'''
    g_median = float(np.median([float(g.double().norm()) for g in ref_grads.values()]))
    report = {'program': loss_gaps(losses, ref_losses)}
    with ref.full_float32():
        for name, kwargs in (('reference_bf16', {'quant': 'bf16'}),
                             ('reference_own_proposals', {'own_proposals': True}),
                             ('control_fp8', {'quant': 'fp8'})):
            other, grads, _ = follow(params, cfg, batches, dev, **kwargs)
            report[name] = loss_gaps(other, ref_losses)
            report[name + '_grad_gap'] = max(gap(grads[k], g, g_median)
                                             for k, g in ref_grads.items())
    print('portbench: witness ' + json.dumps(report), file=sys.stderr)


def to_device(batch, dev):
    if torch.is_tensor(batch):
        return batch.to(dev)
    if isinstance(batch, dict):
        return {k: to_device(v, dev) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, dev) for v in batch)
    return batch
