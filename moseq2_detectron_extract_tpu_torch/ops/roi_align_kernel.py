'''Fused multilevel ROIAlign: the CUDA kernel (``csrc/roi_align.cu``), its
launch plan, and its dispatching entry.

Replaces ``moseq2_detectron_extract_tpu/ops/pallas_roi_align.py`` (Pallas
TPU kernel ``_kernel``, entry ``pallas_separable_roi_align``). On a CUDA
tensor :func:`roi_align` launches the kernel or raises; on a CPU tensor it
runs the plain version, ``roi_align.separable_batched_roi_align``.
'''
import ctypes
from typing import NamedTuple, Sequence

import torch

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.ops.roi_align import separable_batched_roi_align

MAX_OUTPUT_SIZE = 32
SMS = 132                 # streaming multiprocessors of an H100 SXM
WARPS_PER_SM = 8          # warps the plan aims to put on each SM

# launches of the CUDA kernel since the count was last set to 0
launch_count = 0


class RoiPlan(NamedTuple):
    '''How the kernel splits the work: one block per (ROI, group of 32 x
    ``vec`` channels), one warp per (output row, segment of its columns).'''
    vec: int
    segs: int
    groups: int
    warps: int           # in the whole launch


def launch_plan(rois: int, channels: int, output_size: int, vec: int) -> RoiPlan:
    '''The fewest column segments per output row (at most one per column)
    that put WARPS_PER_SM warps on every SM: the box stage (256 ROIs x 7
    rows) needs none, the K = 1 stages (16 ROIs) split their rows so they
    still spread over the card.'''
    groups = -(-channels // (32 * vec))
    rows = rois * output_size * groups
    segs = max(1, min(-(-SMS * WARPS_PER_SM // rows), output_size))
    return RoiPlan(vec, segs, groups, rows * segs)


def _vector_width(features: Sequence[torch.Tensor], channels: int) -> int:
    '''8 (16-byte loads) where the channels, strides and addresses allow
    it, else 1.'''
    ok = channels % 8 == 0 and all(
        f.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in f.stride()[:3])
        for f in features)
    return 8 if ok else 1


def roi_align_cuda(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                   output_size: int, min_level: int = 2) -> torch.Tensor:
    '''Launch the kernel: NHWC bf16 levels (B, H_l, W_l, C), any batch, row
    and column strides with channel stride 1; boxes (B, K, 4) f32 ->
    (B, K, out, out, C) bf16, on the current stream.'''
    global launch_count
    if not 1 <= len(features) <= 4:
        raise ValueError(f'1 to 4 pyramid levels supported, got {len(features)}')
    if not 1 <= output_size <= MAX_OUTPUT_SIZE:
        raise ValueError(f'output_size must be in [1, {MAX_OUTPUT_SIZE}]')
    device = boxes.device
    if device.type != 'cuda':
        raise ValueError('roi_align_cuda needs CUDA tensors')
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[2] != 4 \
            or not boxes.is_contiguous():
        raise ValueError('boxes must be a contiguous (B, K, 4) float32 tensor')
    b, k = boxes.shape[:2]
    c = features[0].shape[-1]
    for f in features:
        if f.device != device or f.dtype != torch.bfloat16 or f.dim() != 4 \
                or f.stride(3) != 1 or f.shape[0] != b or f.shape[3] != c:
            raise ValueError('levels must be NHWC bfloat16 tensors with channel stride 1 '
                             f'(B={b}, H, W, C={c}) on {device}')
    out = torch.empty((b, k, output_size, output_size, c), dtype=torch.bfloat16,
                      device=device)
    if b * k == 0 or c == 0:
        return out
    plan = launch_plan(b * k, c, output_size, _vector_width(features, c))
    ptrs = (ctypes.c_void_p * len(features))(*[f.data_ptr() for f in features])
    meta = (ctypes.c_longlong * (5 * len(features)))(
        *[v for f in features for v in (f.shape[1], f.shape[2], *f.stride()[:3])])
    lib = native.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.m2de_roi_align_bf16(ptrs, meta, len(features), min_level,
                                     boxes.data_ptr(), out.data_ptr(), b, k, c,
                                     output_size, plan.vec, plan.segs, stream)
    native.check(rc, 'roi_align kernel launch')
    launch_count += 1
    return out


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              output_size: int, min_level: int = 2) -> torch.Tensor:
    '''Multilevel ROIAlignV2 of (B, K, 4) boxes over NHWC levels
    (B, H_l, W_l, C) -> (B, K, out, out, C) bf16.

    CUDA tensors go to the kernel: a level that is not bf16 with channel
    stride 1 is converted first (a copy; the main path's levels need none).
    CPU tensors go to the plain version, computed in f32 and rounded to bf16.
    '''
    if boxes.is_cuda:
        levels = [f if f.dtype == torch.bfloat16 and f.stride(3) == 1
                  else f.to(torch.bfloat16).contiguous() for f in features]
        return roi_align_cuda(levels, boxes.float().contiguous(), output_size,
                              min_level)
    return separable_batched_roi_align(features, boxes, output_size, min_level,
                                       out_dtype=torch.bfloat16)
