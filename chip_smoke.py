#!/usr/bin/env python3
'''Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0] [--model-dir benchmarks/bench_model_fast160]

Phases, each printed with its elapsed seconds as it starts:

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels (nvcc, one process per source, then ctypes);
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes: ROIAlign at batch 16 for the box (out 7, K 16), mask
   (out 14, K 1) and keypoint (out 7, K 1) stages, to 2 bf16 ulps; the
   frame clean on (64, 160, 160) uint8, bit-exact. Times are device time
   per call from a ``torch.profiler`` trace of 20 calls (and, in the
   phase lines, the median CUDA-event time around single calls, which
   includes the host's launch time), beside each kernel's bound (the larger
   of its bytes over 3.35 TB/s and the operations of a minimal form of its
   function over the card's rate for them: 67e12 fp32 operations per second
   for ROIAlign, 66.9e12 two-input min/max for the clean) and the plain
   version's time, with each kernel's launch plan. The ROIAlign entry of the
   report sums its three stage calls, one batch's pooling. No single PyTorch
   call computes either function (torchvision is absent), so there is no
   library time;
4. the main path: ``Predictor.from_model_dir`` on the committed fast160
   model (R50-FPN, full width, weights read from its npz), a chunk of 64
   sentinel-encoded 424x512 frames made from ``--seed``, and
   ``extract.process_chunk`` with both kernels' launch counts set to 0 just
   before and read just after (and whether the FPN levels reach the pool
   as NHWC bf16, which decides whether its NHWC view copies); then 5 timed
   chunks (median wall time of
   each stage and of the chunk, host clock, each stage ended by a
   synchronize) and one chunk under ``torch.profiler`` (the device's busy
   share of its wall time, the copy kernels and the top kernels by device
   time); then the
   same 4-frame input through the port on the card and on the CPU (plain
   versions, f32 model) as a reference check;
5. a JSON line of the kernels, then the result line.

It exits non-zero, without a result line, when CUDA is unavailable, when
the port's package is not beside it, or when any phase fails.
'''
import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
PKG = 'moseq2_detectron_extract_tpu_torch'
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
# H100 SXM fp32 rate outside the tensor cores (an FMA counts 2): ROIAlign.
FP32_OPS_PER_S = 67e12
# Two-input min/max per second for the clean: the card's widest min/max is
# VIMNMX3.U16x2 (cuobjdump of csrc/clean.cu's build), two 16-bit lanes of a
# three-input min or max, i.e. 4 two-input min/max, taken to issue at the
# 32-bit integer min/max rate of 64 per SM per clock: 4 * 64 * 132 SMs *
# 1.98 GHz. (Not measured on the card; a kernel faster than this bound
# would say the rate is higher.)
MINMAX_PER_S = 4 * 64 * 132 * 1.98e9
BF16_TOL = 2.0 ** -6               # 2 bf16 ulps, relative and absolute
# At most 16 taps per output element (4 samples x 4 bilinear taps, the
# weights per ROI and shared by the channels): 16 multiply-adds.
ROI_OPS_PER_OUTPUT = 32
# Min/max operations per pixel of a minimal form of the clean (the form is
# checked against the plain version in tests/test_torch_clean.py):
# the median, 18 (sort each vertical triple, 6; then med3 of the max of the
# lows, the med3 of the mids and the min of the highs of the 3 neighbouring
# columns, 2 + 4 + 2 + 4), and 12 for each of the 3 erosions and 3 dilations
# (row extrema of widths 7 and 9 by doubling, 5; the ellipse's 9 rows,
# sharing the pairs of equal rows, 7).
CLEAN_OPS_PER_PIXEL = 18 + 6 * 12
FRAMES = 64                        # frames per chunk
BATCH = 16                         # frames per detection batch
REPS = 20                          # timed calls per kernel measurement
CHUNKS = 5                         # timed chunks of the main path
TOP_KERNELS = 12                   # kernel names printed from the profiled chunk


def phase(msg: str) -> None:
    print(f'[{time.perf_counter() - T0:8.2f}s] {msg}', flush=True)


def card_query() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def wall_ms(fn, reps: int) -> float:
    """Median over ``reps`` single calls of CUDA-event time around each call:
    it includes the host's launch time wherever the device waits for it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int) -> float:
    """Device time per call: the CUDA kernels that ``reps`` calls launched,
    summed from a ``torch.profiler`` trace, over ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    warnings.filterwarnings('ignore', message='.*Profiler clears events.*')
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us <= 0:
        raise RuntimeError('the profiler recorded no device time')
    return total_us / 1e3 / reps


def roi_inputs(rng, batch: int, k: int, canvas: int = 160, c: int = 256, device='cuda'):
    '''P2..P5 of a 160 canvas (40, 20, 10, 5) and boxes shaped like the
    main path's: small mouse-sized boxes (level 2), with a quarter of the
    box stage's proposals large enough for level 3.'''
    import numpy as np
    import torch
    levels = [torch.from_numpy(rng.normal(0, 1, (batch, canvas // s, canvas // s, c))
                               .astype('float32')).to(device, torch.bfloat16)
              for s in (4, 8, 16, 32)]
    cx = rng.uniform(40, 120, (batch, k))
    cy = rng.uniform(40, 120, (batch, k))
    w = rng.uniform(12, 60, (batch, k))
    h = rng.uniform(8, 40, (batch, k))
    if k > 1:
        w[:, : k // 4] = rng.uniform(115, 160, (batch, k // 4))
        h[:, : k // 4] = rng.uniform(115, 160, (batch, k // 4))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes = np.clip(boxes, 0, canvas).astype('float32')
    return levels, torch.from_numpy(boxes).to(device)


def roi_bound(levels, boxes, out: int):
    '''(bytes, ops) the function needs on these inputs: the distinct taps it
    reads (per image), the boxes, the output; ROI_OPS_PER_OUTPUT (32) fp32
    operations per output element.'''
    import torch
    from moseq2_detectron_extract_tpu_torch.ops.roi_align import (_roi_sample_coords,
                                                                  assign_fpn_levels)
    b, k = boxes.shape[:2]
    c = levels[0].shape[-1]
    flat = boxes.reshape(-1, 4)
    lvl = (assign_fpn_levels(flat) - 2).long()
    strides = (2.0 ** (lvl + 2)).float()
    ys, xs = _roi_sample_coords(flat, out, strides)
    taps = 0
    for li, feat in enumerate(levels):
        hh, ww = feat.shape[1], feat.shape[2]
        sel = lvl == li
        if not sel.any():
            continue

        def touched(coords, size):
            cs = coords.clamp(0, size - 1)
            c0 = cs.floor().long()
            hit = torch.zeros((coords.shape[0], size), dtype=torch.bool, device=coords.device)
            hit.scatter_(1, c0, True)
            hit.scatter_(1, (c0 + 1).clamp(max=size - 1), True)
            return hit

        rows = touched(ys[sel], hh)                    # (n, H)
        cols = touched(xs[sel], ww)                    # (n, W)
        img = torch.div(torch.nonzero(sel)[:, 0], k, rounding_mode='floor')
        grid = torch.zeros((b, hh, ww), dtype=torch.bool, device=boxes.device)
        for i in range(rows.shape[0]):
            grid[img[i]] |= rows[i][:, None] & cols[i][None, :]
        taps += int(grid.sum())
    out_elems = b * k * out * out * c
    nbytes = taps * c * 2 + boxes.numel() * 4 + out_elems * 2
    return nbytes, out_elems * ROI_OPS_PER_OUTPUT


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def check_kernels(rng, reps: int, card: str):
    '''Phase 3: each kernel against its plain version at main-path shapes.'''
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.ops.roi_align import separable_batched_roi_align

    roi = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'max_abs_err': 0.0,
           'bytes': 0, 'ops': 0}
    for stage, out, k in (('box', 7, 16), ('mask', 14, 1), ('keypoint', 7, 1)):
        levels, boxes = roi_inputs(rng, 16, k)
        got = roi_align_kernel.roi_align_cuda(levels, boxes, out)
        ref = separable_batched_roi_align(levels, boxes, out, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        allowed = BF16_TOL * (1 + ref.float().abs())
        if not bool((err <= allowed).all()):
            raise AssertionError(f'roi_align {stage}: kernel differs from plain version '
                                 f'(max abs err {float(err.max()):.3e})')
        kernel = functools.partial(roi_align_kernel.roi_align_cuda, levels, boxes, out)
        plain = functools.partial(separable_batched_roi_align, levels, boxes, out,
                                  out_dtype=torch.bfloat16)
        ms, plain_ms = device_ms(kernel, reps), device_ms(plain, reps)
        wall, plain_wall = wall_ms(kernel, reps), wall_ms(plain, reps)
        nbytes, ops = roi_bound(levels, boxes, out)
        b_ms, by = bound_ms(nbytes, ops)
        plan = roi_align_kernel.launch_plan(16 * k, 256, out, 8)
        phase(f'roi_align {stage} plan: {plan.warps} warps, one per (ROI, output row, '
              f'segment of {-(-out // plan.segs)} columns), {plan.vec} channels a lane')
        phase(f'roi_align {stage} (B=16, K={k}, out={out}, C=256): max_abs_err '
              f'{float(err.max()):.3e} (tol {BF16_TOL:.4f}*(1+|ref|)); device ms: kernel '
              f'{ms:.4f}, plain {plain_ms:.4f}, bound {b_ms:.4f} by {by} ({nbytes} B, '
              f'{ops} ops); wall ms per call: kernel {wall:.4f}, plain {plain_wall:.4f} [{card}]')
        roi['ms'] += ms
        roi['plain_ms'] += plain_ms
        roi['max_abs_err'] = max(roi['max_abs_err'], float(err.max()))
        roi['bytes'] += nbytes
        roi['ops'] += ops
    roi['bound_ms'], roi['bound_by'] = bound_ms(roi['bytes'], roi['ops'])

    frames = torch.from_numpy(rng.integers(0, 256, (64, 160, 160)).astype('uint8')).cuda()
    got = clean_kernel.clean_frames_cuda(frames)
    ref = clean_kernel.clean_frames_plain(frames)
    torch.cuda.synchronize()
    mismatched = int((got != ref).sum())
    if mismatched:
        raise AssertionError(f'clean: kernel differs from plain version at {mismatched} pixels')
    kernel = functools.partial(clean_kernel.clean_frames_cuda, frames)
    plain = functools.partial(clean_kernel.clean_frames_plain, frames)
    ms, plain_ms = device_ms(kernel, reps), device_ms(plain, reps)
    wall, plain_wall = wall_ms(kernel, reps), wall_ms(plain, reps)
    nbytes = 2 * frames.numel()
    ops = CLEAN_OPS_PER_PIXEL * frames.numel()
    b_ms, by = bound_ms(nbytes, ops, MINMAX_PER_S)
    plan = clean_kernel.tile_plan(*frames.shape)
    phase(f'clean plan: {plan.tile_h} x {plan.tile_w} tiles, {plan.blocks} blocks of two '
          f'frames, {plan.smem_bytes} B shared memory')
    phase(f'clean (64, 160, 160) uint8: bit-exact; device ms: kernel {ms:.4f}, plain '
          f'{plain_ms:.4f}, bound {b_ms:.4f} by {by} ({nbytes} B, {ops} ops); wall ms per '
          f'call: kernel {wall:.4f}, plain {plain_wall:.4f} [{card}]')
    clean = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': by,
             'max_abs_err': float((got.int() - ref.int()).abs().max())}
    return roi, clean


def stage_times(chunk, predictor, config, tracker) -> dict:
    '''Wall seconds of each stage of ``process_chunk`` on one chunk (host
    clock, each stage ended by a synchronize).'''
    import torch
    from moseq2_detectron_extract_tpu_torch.pipeline.steps import (run_inference,
                                                                   select_instances)
    from moseq2_detectron_extract_tpu_torch.proc.features import dispatch_instance_features
    times = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    data = run_inference(torch.from_numpy(chunk), predictor, config)
    torch.cuda.synchronize()
    times['prep_and_detect'] = time.perf_counter() - t
    t = time.perf_counter()
    data = select_instances(data, config, tracker)
    torch.cuda.synchronize()
    times['select_and_gather'] = time.perf_counter() - t
    t = time.perf_counter()
    dispatch_instance_features(data['sel_masks'], data['raw_windows'],
                               window_origins=data['win_origins'])
    torch.cuda.synchronize()
    times['clean_and_moments'] = time.perf_counter() - t
    times['chunk'] = sum(times.values())
    return times


def profile_chunk(chunk, predictor, config, tracker, card: str) -> None:
    '''One chunk under ``torch.profiler``: the device's busy share of its
    wall time (profiler overhead included) and the top kernels.'''
    import torch
    from moseq2_detectron_extract_tpu_torch.extract import process_chunk
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        process_chunk(chunk, predictor, config, tracker=tracker)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy_us = sum(e.device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError('the profiler recorded no device time')
    phase(f'profiled chunk: wall {wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms '
          f'({100 * busy_us / 1e3 / (wall * 1e3):.1f}%), {len(kernels)} kernel names, '
          f'{sum(e.count for e in kernels)} launches [{card}]')
    copies = [e for e in kernels if 'copy' in e.key.lower()]
    phase(f'profiled chunk: copy kernels {sum(e.device_time_total for e in copies) / 1e3:.3f} '
          f'ms in {sum(e.count for e in copies)} launches [{card}]')
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:TOP_KERNELS]:
        print(f'  {e.device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}', flush=True)


def reference_check(model_dir: str, chunk, config, devices=('cuda', 'cpu')):
    '''The same 4 frames through the port on the card (kernels) and on the
    CPU (plain versions), both with the model in f32.'''
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch.extract import process_chunk
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.models.weights import (load_params_npz,
                                                                   params_from_jax)
    cfg = ModelConfig.from_yaml(os.path.join(model_dir, 'config.yaml')) \
        .replace(amp_dtype='float32')
    flat = load_params_npz(os.path.join(model_dir, 'params_f16.npz'))
    outs = {}
    for device in devices:
        pred = Predictor(cfg, params_from_jax(flat, cfg.box_pooler_resolution),
                         batch_size=4, device=device)
        outs[device] = process_chunk(chunk, pred, config)
    gpu, cpu = (outs[d] for d in devices)
    for key in ('valid', 'keep'):
        if not torch.equal(gpu['inference'][key].cpu(), cpu['inference'][key]):
            raise AssertionError(f'reference check: {key} differs between card and CPU')
    box_err = float((gpu['inference']['boxes'].cpu() - cpu['inference']['boxes']).abs().max())
    score_err = float((gpu['inference']['scores'].cpu() - cpu['inference']['scores']).abs().max())
    if box_err > 1.0 or score_err > 1e-2:
        raise AssertionError(f'reference check: boxes {box_err:.3f} px, scores {score_err:.2e}')
    same = np.all(gpu['win_origins'] == cpu['win_origins'], axis=1)
    cleaned_equal = bool(torch.equal(gpu['feat_dispatch']['cleaned_frames'].cpu()[same],
                                     cpu['feat_dispatch']['cleaned_frames'][same]))
    if not same.any() or not cleaned_equal:
        raise AssertionError('reference check: cleaned windows differ between card and CPU')
    return box_err, score_err, int(same.sum())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--model-dir', default=os.path.join(REPO, 'benchmarks',
                                                            'bench_model_fast160'))
    args = parser.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; nothing run',
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f'chip_smoke: the {PKG} package is not beside this script', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase(f'torch {torch.__version__} (CUDA {torch.version.cuda}); set '
          f'torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, '
          f'torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}')

    phase('1/5 card')
    card = card_query()
    print(card, flush=True)

    phase('2/5 build kernels (nvcc -> ctypes)')
    from moseq2_detectron_extract_tpu_torch import native
    t = time.perf_counter()
    lib_path = native.build_library()
    native.load_library()
    build_s = time.perf_counter() - t
    with open(os.path.join(os.path.dirname(lib_path), 'build.log'), encoding='utf-8') as fh:
        for line in fh:
            if 'Used' in line or 'spill' in line:
                print('  ' + line.strip(), flush=True)
    phase(f'built {os.path.relpath(lib_path, REPO)} in {build_s:.1f} s')

    phase('3/5 kernels vs plain versions at main-path shapes')
    rng = np.random.default_rng(args.seed)
    roi, clean = check_kernels(rng, REPS, card)

    phase('4/5 main path: Predictor.from_model_dir + process_chunk')
    from moseq2_detectron_extract_tpu_torch.extract import make_tracker, process_chunk
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk
    t = time.perf_counter()
    predictor = Predictor.from_model_dir(args.model_dir, batch_size=BATCH)
    phase(f'loaded {os.path.relpath(args.model_dir, REPO)} in '
          f'{time.perf_counter() - t:.1f} s (amp {predictor.cfg.amp_dtype}, canvas '
          f'{predictor.cfg.image_size}, batch {BATCH})')
    config = {'min_height': 0.0, 'max_height': 100.0, 'feature_window': 160,
              'expected_instances': 1}
    chunk = make_sentinel_chunk(FRAMES, 424, 512, seed=args.seed)
    tracker = make_tracker()

    level_formats = []
    pool_levels = MaskKeypointRCNN.pool_levels

    def spy(fpn_feats):
        level_formats.append([(str(f.dtype), f.is_contiguous(memory_format=torch.channels_last))
                              for f in fpn_feats[:4]])
        return pool_levels(fpn_feats)

    MaskKeypointRCNN.pool_levels = staticmethod(spy)
    roi_align_kernel.launch_count = 0
    clean_kernel.launch_count = 0
    try:
        out = process_chunk(chunk, predictor, config, tracker=tracker)
        torch.cuda.synchronize()
    finally:
        MaskKeypointRCNN.pool_levels = staticmethod(pool_levels)
    nhwc = all(dt == 'torch.bfloat16' and cl for fmt in level_formats for dt, cl in fmt)
    phase(f'FPN levels reaching the pool (dtype, channels_last) per batch: {level_formats[0]} '
          f'... ({len(level_formats)} batches): '
          + ('NHWC bf16 already, the NHWC view copies nothing' if nhwc else
             'not NHWC bf16: pool_levels copies each level once per batch'))
    launches = {'roi_align': roi_align_kernel.launch_count,
                'clean': clean_kernel.launch_count}
    phase(f'main path launches: {launches}')

    n = FRAMES
    inf = out['inference']
    batches = -(-n // BATCH)
    expect = {'boxes': (n, 1, 4), 'masks': (n, 1, 424, 512), 'keypoints': (n, 1, 8, 3)}
    for key, shape in expect.items():
        if tuple(inf[key].shape) != shape:
            raise AssertionError(f'{key} shape {tuple(inf[key].shape)} != {shape}')
    for key in ('boxes', 'scores', 'keypoints', 'mask_probs'):
        if not bool(torch.isfinite(inf[key]).all()):
            raise AssertionError(f'non-finite {key}')
    fd = out['feat_dispatch']
    if tuple(fd['cleaned_frames'].shape) != (n, 160, 160):
        raise AssertionError(f'cleaned windows shape {tuple(fd["cleaned_frames"].shape)}')
    found = int(out['num_instances'].sum())
    has = torch.from_numpy(out['num_instances'] > 0).cuda()
    if not bool(torch.isfinite(fd['feats_dev']['centroid'][has]).all()):
        raise AssertionError('non-finite centroid of a selected instance')
    if launches['roi_align'] != 3 * batches or launches['clean'] != 1:
        raise AssertionError(f'launch counts {launches}; expected roi_align '
                             f'{3 * batches} (3 per batch), clean 1')
    if found < 0.9 * n:
        raise AssertionError(f'the mouse was found in only {found} of {n} frames')

    phase(f'detections found: {found} of {n} frames [{card}]')

    chunks = [make_sentinel_chunk(n, 424, 512, seed=args.seed + 1 + i)
              for i in range(CHUNKS + 1)]
    torch.cuda.reset_peak_memory_stats()
    runs = [stage_times(c, predictor, config, tracker) for c in chunks[:CHUNKS]]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    medians = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    phase(f'{CHUNKS} timed chunks, median wall ms: ' + ', '.join(
        f'{k} {v * 1e3:.2f}' for k, v in medians.items()) + f' [{card}]')
    phase(f'chunk: {n} frames at {n / medians["chunk"]:.1f} frames/s (median; chunks '
          + ', '.join(f'{n / r["chunk"]:.1f}' for r in runs)
          + f'), peak memory {peak_gib:.2f} GiB [{card}]')
    profile_chunk(chunks[CHUNKS], predictor, config, tracker, card)

    box_err, score_err, n_same = reference_check(args.model_dir, chunk[:4], config)
    phase(f'reference check (4 frames, f32 model, card vs CPU plain versions): boxes '
          f'{box_err:.4f} px, scores {score_err:.2e}, cleaned windows equal at '
          f'{n_same} of 4 shared origins')

    phase('5/5 report')
    kernels = [
        {'name': 'roi_align', 'route': 'cuda', 'source': f'{PKG}/csrc/roi_align.cu',
         'replaces': 'moseq2_detectron_extract_tpu/ops/pallas_roi_align.py:35',
         'launches': launches['roi_align'], 'max_abs_err': roi['max_abs_err'],
         'ms': roi['ms'], 'plain_ms': roi['plain_ms'], 'bound_ms': roi['bound_ms'],
         'bound_by': roi['bound_by'], 'library_ms': None},
        {'name': 'clean', 'route': 'cuda', 'source': f'{PKG}/csrc/clean.cu',
         'replaces': 'moseq2_detectron_extract_tpu/ops/pallas_clean.py:74',
         'launches': launches['clean'], 'max_abs_err': clean['max_abs_err'],
         'ms': clean['ms'], 'plain_ms': clean['plain_ms'], 'bound_ms': clean['bound_ms'],
         'bound_by': clean['bound_by'], 'library_ms': None},
    ]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
