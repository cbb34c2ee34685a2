'''Experiment: the four stage-2 layouts of the fused separable ROIAlign on
the card's tensor cores.

    python -m moseq2_detectron_extract_tpu_torch.benchmarks.roi_stage2_exp \\
        [--device cpu] [--seed 0] [--reps 5]

Port of ``benchmarks/roi_stage2_exp.py``. Its four Pallas bodies are the
CUDA kernels of ``csrc/roi_stage2_resident.cu`` (``ops/roi_stage2_kernel.py``),
one loop that keeps an image's pyramid channel slice in shared memory:

  retile     block-diagonal Wx (rows (i, ox)) against T, one oy at a time
  transpose  the same product over all (oy, c) columns in one pass
  dotswap    T as A (rows (oy, c), depth w) against Wx^T (N = ox)
  noxpose    dotswap writing (i, oy, c, ox); also with a bf16 output

First, at a small shape, every variant is held against the port's plain
separable ROIAlign (f32) to 0.05, as the JAX script does. ``--device cpu``
stops there: it runs the plain versions, as the JAX script does off the TPU.
On the card it then times, at the experiment's shape (64 images x 256 ROIs,
canvas 256, C 256, out 7), each variant at block_k 8 and 16 (the kernel on
prepared inputs, and the whole entry with its PyTorch front half), beside
the port's ROIAlign kernel (``csrc/roi_align.cu``) and the two-call cuBLAS
form (``torch.bmm`` for stage 1, ``torch.matmul`` for stage 2, in bf16),
with CUDA events. A variant that fails to launch raises.
'''
import argparse
import subprocess
import sys
from typing import List

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.ops.roi_align import (_separable_inputs,
                                                              separable_batched_roi_align)
from moseq2_detectron_extract_tpu_torch.ops.roi_align_kernel import roi_align_cuda
from moseq2_detectron_extract_tpu_torch.ops.roi_stage2_kernel import (roi_stage2,
                                                                      roi_stage2_cuda,
                                                                      stage2_inputs)

OUT_SIZE = 7
# (label, variant, output dtype), in the JAX script's order
RUNS = (('retile', 'retile', torch.float32),
        ('transpose', 'transpose', torch.float32),
        ('dotswap', 'dotswap', torch.float32),
        ('noxpose', 'noxpose', torch.float32),
        ('noxpose-bf16', 'noxpose', torch.bfloat16))
CHECK_SHAPE = (2, 16, 128, 256)       # b, k, c, canvas of the correctness check
TIMING_SHAPE = (64, 256, 256, 256)    # the experiment's box-stage shape
BLOCK_KS = (8, 16)


def make_inputs(b=64, k=256, c=256, canvas=256, seed=0, device='cuda'):
    '''NHWC bf16 levels P2..P5 and (B, K, 4) f32 boxes on ``device``, from the
    same numpy draws as the JAX script's ``make_inputs``: a seed gives its
    inputs.'''
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    feats = []
    for lvl in range(2, 6):
        s = canvas // (2 ** lvl)
        feats.append(torch.from_numpy(rng.normal(0, 1, (b, s, s, c)))
                     .to(torch.bfloat16).to(device))
    centers = rng.uniform(30, canvas - 30, (b, k, 2))
    sizes = rng.uniform(8, 180, (b, k, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=-1)
    boxes = np.clip(boxes, 0, canvas - 1)
    return feats, torch.from_numpy(boxes.astype(np.float32)).to(device)


def make_variant(name: str, block_k: int, out_dtype=torch.float32):
    '''The variant as a function of (features, boxes, output_size,
    min_level): the kernel on CUDA tensors, its plain version on CPU ones.'''
    def impl(features, boxes, output_size, min_level=2):
        return roi_stage2(features, boxes, output_size, name, block_k, out_dtype, min_level)
    return impl


def two_calls(f_stack, wy, wx):
    '''The dense form in two cuBLAS calls, bf16 in and out: stage 1 with
    ``torch.bmm`` (T in device memory), stage 2 with ``torch.matmul``.'''
    b, h, w, c = f_stack.shape
    k = wy.shape[1]
    t = torch.bmm(wy.reshape(b, k * OUT_SIZE, h), f_stack.reshape(b, h, w * c))
    return torch.matmul(wx.reshape(b * k, 1, OUT_SIZE, w), t.reshape(b * k, OUT_SIZE, w, c))


def event_ms(fn, reps: int) -> float:
    '''Mean ms per call over ``reps`` back-to-back calls after one warm-up,
    from CUDA events around the whole run.'''
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_variants(device, shape=CHECK_SHAPE, seed=1, block_k=8) -> dict:
    '''Each variant against the port's plain separable ROIAlign (f32) at a
    small shape; max abs error per label, each below 0.05.'''
    b, k, c, canvas = shape
    feats, boxes = make_inputs(b, k, c, canvas, seed=seed, device=device)
    ref = separable_batched_roi_align(feats, boxes, OUT_SIZE, out_dtype=torch.float32)
    errs = {}
    for label, variant, dtype in RUNS:
        got = make_variant(variant, block_k, dtype)(feats, boxes, OUT_SIZE).float()
        if variant == 'noxpose':
            got = got.transpose(3, 4)          # (b, k, oy, c, ox) -> (b, k, oy, ox, c)
        errs[label] = float((got - ref).abs().max())
        print(f'{label}: max abs err vs the plain separable ROIAlign = {errs[label]:.5f}',
              flush=True)
        if not errs[label] < 0.05:
            raise AssertionError(f'{label}: max abs err {errs[label]} vs the plain '
                                 'separable ROIAlign is not below 0.05')
    return errs


def time_variants(features, boxes, reps=5, block_ks=BLOCK_KS) -> List[dict]:
    '''CUDA-event ms per call on the card: the port's ROIAlign kernel, the
    two-call cuBLAS form, and each variant at each block_k, both its kernel
    alone (on prepared inputs) and its whole entry.'''
    k = boxes.shape[1]
    rows = [{'label': 'base (roi_align_cuda)', 'block_k': None,
             'ms': event_ms(lambda: roi_align_cuda(features, boxes, OUT_SIZE), reps)}]
    dense = _separable_inputs(features, boxes, OUT_SIZE, 2, as_dtype=torch.bfloat16)
    rows.append({'label': 'two calls (bmm + matmul)', 'block_k': None,
                 'ms': event_ms(lambda: two_calls(*dense), reps)})
    del dense
    for label, variant, dtype in RUNS:
        for bk in block_ks:
            inputs = stage2_inputs(features, boxes, OUT_SIZE, bk)
            kernel = event_ms(lambda: roi_stage2_cuda(*inputs, k, variant, bk, dtype), reps)
            impl = make_variant(variant, bk, dtype)
            entry = event_ms(lambda: impl(features, boxes, OUT_SIZE), reps)
            rows.append({'label': label, 'block_k': bk, 'ms': kernel, 'entry_ms': entry})
    return rows


def card_name() -> str:
    '''The card's name and power limit, as nvidia-smi gives them.'''
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def main(device='cuda', seed=0, reps=5, check_shape=CHECK_SHAPE,
         timing_shape=TIMING_SHAPE) -> dict:
    '''Correctness first; then, on the card, the times. Returns the check's
    errors and, on the card, the card, the timing rows and the timed inputs.
    Raises when CUDA is asked for and absent: it never carries on on the CPU.'''
    dev = resolve_device(device)
    result = {'errors': check_variants(dev, check_shape)}
    if dev.type != 'cuda':
        print('CPU correctness done; timing requires the card', flush=True)
        return result
    b, k, c, canvas = timing_shape
    feats, boxes = make_inputs(b, k, c, canvas, seed=seed, device=dev)
    card = card_name()
    print(f'\nbox-stage shape: {b}x{k} ROIs, canvas {canvas}, C={c}, out {OUT_SIZE} '
          f'[{card}]', flush=True)
    rows = time_variants(feats, boxes, reps)
    for row in rows:
        bk = f'block_k={row["block_k"]:3d}' if row['block_k'] else ' ' * 11
        entry = f'   entry {row["entry_ms"]:8.4f} ms' if 'entry_ms' in row else ''
        print(f'  {row["label"]:26s} {bk}  {row["ms"]:8.4f} ms/batch{entry}', flush=True)
    result.update(card=card, rows=rows, inputs=(feats, boxes))
    return result


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default: check, then time) or 'cpu' (check only)")
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--reps', type=int, default=5, help='timed calls per measurement')
    args = parser.parse_args(argv)
    main(device=args.device, seed=args.seed, reps=args.reps)
    return 0


if __name__ == '__main__':
    sys.exit(cli())
