'''Chunks of prepped frames sent back to back through ``extract``'s device
path, ``extract.process_chunk``: prep on the card, detection, the instance
selection with one tracker across chunks, the feature windows' clean and
moments; each chunk ended by a synchronise, as the pipeline's selection
stage ends it. Closed loop, one stream.

Traffic keys: ``chunk_frames``, ``ring`` (distinct chunks held in host
memory and sent in turn), ``batch_size`` (the Predictor's), ``frame_height``
and ``frame_width`` (the raw Kinect frame), ``warmup_chunks``,
``samples_per_chunk`` (frames of each chunk of the window that the check
compares), ``reference_batch``, and ``extract_config``: the extraction's
``min_height``, ``max_height`` and ``feature_window``, handed to the
program and to the reference alike.
'''
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.core import HostMeter, Outcome, check, phase, program_config, verify_config
from portbench.reference import detector as ref
from portbench.reference import window as refwin
from portbench.yardstick import flops, synth
from portbench.yardstick.trace import host_gaps, traced


def sample_frames(seed: int, chunk_index: int, frames: int, count: int) -> np.ndarray:
    '''The frames of window chunk ``chunk_index`` that the check compares.'''
    rng = np.random.default_rng([int(seed) % (2 ** 63), chunk_index])
    return np.sort(rng.choice(frames, size=count, replace=False))


def take(out: Dict, idx: np.ndarray) -> Dict:
    '''The compared outputs of frames ``idx`` of one chunk's result.'''
    inf = out['inference']
    dev_idx = torch.as_tensor(idx, device=inf['boxes'].device)
    feats = out['feat_dispatch']['feats_dev']
    return {'boxes': inf['boxes'][dev_idx, 0], 'scores': inf['scores'][dev_idx, 0],
            'masks': inf['masks'][dev_idx, 0], 'keypoints': inf['keypoints'][dev_idx, 0],
            'has': out['num_instances'][idx] > 0, 'origins': out['win_origins'][idx],
            'cleaned': out['feat_dispatch']['cleaned_frames'][dev_idx],
            'centroid': feats['centroid'][dev_idx], 'orientation': feats['orientation'][dev_idx],
            'axis_length': feats['axis_length'][dev_idx]}


class PoolRecorder:
    '''Wraps the detector's ROIAlign entry while a trace runs, to keep each
    call's level shapes and boxes for the bytes bound.'''

    def __init__(self, module):
        self.module = module
        self.inner = module.roi_align
        self.calls: List = []

    def __call__(self, levels, boxes, output_size, *args, **kwargs):
        shapes = [(f.shape[0], f.shape[3], f.shape[1], f.shape[2]) for f in levels]
        self.calls.append((shapes, boxes.detach().clone(), int(output_size)))
        return self.inner(levels, boxes, output_size, *args, **kwargs)

    def __enter__(self):
        self.module.roi_align = self
        return self

    def __exit__(self, *exc):
        self.module.roi_align = self.inner


def _altered(step):
    def altered(frames):
        out = step(frames)
        return dict(out, boxes=out['boxes'] + 2.0)
    return altered


class ShiftedWindows:
    '''Planted fault: the selection stage cuts every feature window 4 px
    to the right of where its box puts it (inside the frame).'''

    def __init__(self, steps):
        self.steps = steps
        self.inner = steps.window_origins

    def __call__(self, centers, shape, crop):
        org = np.array(self.inner(centers, shape, crop))
        org[:, 1] = np.clip(org[:, 1] + 4, 0, max(shape[1] - crop, 0))
        return org

    def __enter__(self):
        self.steps.window_origins = self
        return self

    def __exit__(self, *exc):
        self.steps.window_origins = self.inner


def run(ctx) -> Outcome:
    from contextlib import ExitStack

    from moseq2_detectron_extract_tpu_torch import extract
    from moseq2_detectron_extract_tpu_torch.models.checkpoint import load_model_dir
    from moseq2_detectron_extract_tpu_torch.models import rcnn
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, nms
    from moseq2_detectron_extract_tpu_torch.pipeline import steps
    from moseq2_detectron_extract_tpu_torch.pipeline.steps import make_tracker

    cell, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    model = cell.config
    phase(ctx, 'program imported')
    cfg, state, _ = load_model_dir(cell.model_dir)
    cfg, changed = program_config(cfg, model)
    print('portbench: the configuration file sets ' + json.dumps(changed), file=sys.stderr)
    predictor = Predictor(cfg, state, batch_size=tr['batch_size'], device=dev)
    verify_config(predictor.cfg, model)
    del state
    if 'alter_answer' in ctx.faults:                     # planted fault: boxes moved 2 px
        predictor.step = _altered(predictor.step)
    phase(ctx, 'predictor loaded')
    n = tr['chunk_frames']
    ring = [synth.prepped_chunk(n, tr['frame_height'], tr['frame_width'], ctx.seed, k, dev)
            .cpu().numpy() for k in range(tr['ring'])]
    phase(ctx, 'inputs made')
    with ExitStack() as planted:
        if 'shift_origin' in ctx.faults:
            planted.enter_context(ShiftedWindows(steps))
        config = dict(tr['extract_config'])
        tracker = make_tracker()
        for k in range(tr['warmup_chunks']):
            extract.process_chunk(ring[k % len(ring)], predictor, config, tracker)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        phase(ctx, 'warmed up')

        nms.sync_count = 0
        samples, chunk_s = [], []
        host = HostMeter()
        window_start = time.perf_counter()
        j = 0
        while time.perf_counter() - window_start < ctx.seconds:
            t = time.perf_counter()
            chunk = ring[j % len(ring)]
            if 'half_batch' in ctx.faults:               # planted fault: half the frames
                out = extract.process_chunk(chunk[: n // 2], predictor, config, tracker)
            else:
                out = extract.process_chunk(chunk, predictor, config, tracker)
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            chunk_s.append(time.perf_counter() - t)
            idx = sample_frames(ctx.seed, j, n, tr['samples_per_chunk'])
            # with half the frames left out, the other half's answers stand in
            src = idx % (n // 2) if 'half_batch' in ctx.faults else idx
            samples.append((j % len(ring), idx, take(out, src)))
            j += 1
            del out
        window_end = time.perf_counter()
        print('portbench: host over the window ' + json.dumps(host.read()), file=sys.stderr)
        frames = j * n
        batches = j * -(-n // tr['batch_size'])
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
        observed = {'frames': frames, 'chunks': j, 'batches': batches,
                    'window_s': window_end - window_start, 'chunk_s': chunk_s,
                    'nms_syncs': nms.sync_count, 'model': model,
                    'chunk_frames': n}

        trace = None
        if ctx.trace:
            launches0 = clean_kernel.launch_count
            with PoolRecorder(rcnn) as rec:
                trace = traced(lambda: extract.process_chunk(ring[0], predictor, config, tracker))
            launches1 = clean_kernel.launch_count
            trace.idle_by_host = host_gaps(
                lambda: extract.process_chunk(ring[1], predictor, config, tracker))
            observed['roi_bytes'] = sum(flops.roi_align_bytes(shapes, boxes, out_size)
                                        for shapes, boxes, out_size in rec.calls)
            observed['roi_calls'] = len(rec.calls)
            side = min(int(config['feature_window']), *ring[0].shape[1:])
            observed['clean_bytes'] = (launches1 - launches0) * \
                flops.clean_bytes(n, side)

    del predictor, tracker
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    phase(ctx, 'window closed')
    print('portbench: chunk seconds ' + json.dumps(chunk_s), file=sys.stderr)
    checks = compare(ctx, ring, samples)
    phase(ctx, 'checked')
    rate = frames / (window_end - window_start)
    return Outcome(window_start=window_start, e2e={'infer_fps': rate},
                   attempted=j, failed=0, memory_peak_bytes=peak, checks=checks,
                   observed=observed, trace=trace)


def reference_outputs(det: ref.Detector, frames_u8: torch.Tensor, cfg_extract: Dict,
                      batch: int) -> Dict:
    '''The reference's detection and window features of (N, h, w) prepped
    uint8 frames.'''
    vmin, vmax = cfg_extract['min_height'], cfg_extract['max_height']
    decoded = refwin.decode(frames_u8)
    scaled = refwin.scale_heights(decoded, vmin, vmax)
    parts = [det.detect(scaled[i:i + batch]) for i in range(0, scaled.shape[0], batch)]
    out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    out['has'] = (out['valid'] & out['masks'].flatten(1).any(1)).cpu().numpy()
    out['decoded'] = decoded
    return out


def compare(ctx, ring, samples) -> List[Dict]:
    '''Hold the window's sampled outputs against the plain reference.'''
    tr, limits, dev = ctx.cell.traffic, ctx.cell.limits, ctx.device
    cfg_extract = tr['extract_config']
    model = ctx.cell.config
    params = ref.load_npz(ctx.cell.model_dir + '/params_f16.npz', dev)
    with ref.full_float32():
        det = ref.Detector(params, model)
        # every sampled frame, grouped by the ring chunk it came from
        got, want = [], []
        for k in range(len(ring)):
            rows = [(s, idx) for r, idx, s in samples if r == k]
            if not rows:
                continue
            idx = np.concatenate([i for _, i in rows])
            frames = torch.from_numpy(ring[k][idx]).to(dev)
            want.append(reference_outputs(det, frames, cfg_extract, tr['reference_batch']))
            if 'control' in ctx.faults:                  # the reference in fp8, as the program
                control = ref.Detector(params, model, quant='fp8')
                got.append(program_from_reference(
                    reference_outputs(control, frames, cfg_extract, tr['reference_batch']),
                    cfg_extract))
            else:
                got.append(concat_samples([s for s, _ in rows]))
        got = concat_samples(got)
        want = {k: (torch.cat([w[k] for w in want]) if torch.is_tensor(want[0][k])
                    else np.concatenate([w[k] for w in want])) for k in want[0]}
        numbers = measure(got, want, cfg_extract)
    print('portbench: compared ' + json.dumps(numbers), file=sys.stderr)
    return [check(name, numbers[name], limit) for name, limit in limits['limits'].items()]


def concat_samples(parts: List[Dict]) -> Dict:
    return {k: (torch.cat([torch.as_tensor(p[k]).to(parts[0]['boxes'].device) for p in parts])
                if torch.is_tensor(parts[0][k]) else np.concatenate([p[k] for p in parts]))
            for k in parts[0]}


def program_from_reference(out: Dict, cfg_extract: Dict) -> Dict:
    '''A reference run's outputs in the program's form (the control).'''
    crop_side = min(int(cfg_extract['feature_window']), *out['decoded'].shape[1:])
    org = refwin.origins(out['boxes'].cpu().numpy(), out['has'], out['decoded'].shape[1:],
                         crop_side)
    cleaned = refwin.clean(refwin.crop(out['decoded'], org, crop_side))
    feats = refwin.window_features(cleaned, refwin.crop(out['masks'], org, crop_side), org)
    return {'boxes': out['boxes'], 'scores': out['scores'], 'masks': out['masks'],
            'keypoints': out['keypoints'], 'has': out['has'], 'origins': org,
            'cleaned': cleaned, 'centroid': feats['centroid'],
            'orientation': feats['orientation'], 'axis_length': feats['axis_length']}


def measure(got: Dict, want: Dict, cfg_extract: Dict) -> Dict[str, float]:
    """Every comparable number over the sampled frames: for each quantity
    its median over the frames (``_median``) and its worst (``_max``)."""
    has_p, has_r = np.asarray(got['has']), np.asarray(want['has'])
    both = torch.as_tensor(has_p & has_r, device=want['boxes'].device)
    nums = {'select_mismatch': float(np.sum(has_p != has_r))}
    gaps = {}
    bp, br = got['boxes'].float(), want['boxes']
    gaps['box_px'] = (bp - br).abs().amax(-1)
    gaps['score'] = (got['scores'].float() - want['scores']).abs()
    mp, mr = got['masks'].bool(), want['masks']
    inter = (mp & mr).flatten(1).sum(1).float()
    union = (mp | mr).flatten(1).sum(1).float().clamp(min=1)
    gaps['mask_iou_gap'] = 1 - inter / union
    kp, kr = got['keypoints'].float(), want['keypoints']
    gaps['kp_px'] = torch.linalg.vector_norm(kp[..., :2] - kr[..., :2], dim=-1).median(-1).values
    gaps['kp_score'] = (kp[..., 2] - kr[..., 2]).abs().median(-1).values

    # the windows: the program's origin against the reference's, the
    # program's cleaned window against the reference's clean at that origin
    crop_side = got['cleaned'].shape[-1]
    org_r = refwin.origins(br.cpu().numpy(), has_r, want['decoded'].shape[1:], crop_side)
    org_p = np.asarray(got['origins'])
    off = np.abs(org_p - org_r).max(-1) if len(org_p) else np.zeros(0)
    nums['origin_px_max'] = float(off.max()) if len(off) else 0.0
    # where the window sits: the share of frames that both found a mouse in
    # whose window origin lies more than a pixel from the reference's
    found = has_p & has_r
    nums['origin_mismatch_share'] = float((off[found] > 1).mean()) if found.any() else 0.0
    cleaned_r = refwin.clean(refwin.crop(want['decoded'], org_p, crop_side))
    nums['clean_px'] = float((cleaned_r != got['cleaned'].to(cleaned_r.device)).sum())
    feats = refwin.window_features(refwin.clean(refwin.crop(want['decoded'], org_r, crop_side)),
                                   refwin.crop(want['masks'], org_r, crop_side), org_r)
    gaps['centroid_px'] = torch.linalg.vector_norm(
        got['centroid'].double() - feats['centroid'], dim=-1)
    gaps['axis_px'] = (got['axis_length'].double() - feats['axis_length']).abs().amax(-1)
    turn = (got['orientation'].double() - feats['orientation']).remainder(np.pi)
    gaps['orientation_rad'] = torch.minimum(turn, np.pi - turn)
    for name, values in gaps.items():
        v = torch.nan_to_num(values[both.to(values.device)].double(), nan=float('inf'))
        nums[name + '_median'] = float(v.median()) if v.numel() else 0.0
        nums[name + '_max'] = float(v.max()) if v.numel() else 0.0
    return nums
