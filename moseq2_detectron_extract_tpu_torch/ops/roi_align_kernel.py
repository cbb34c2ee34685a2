'''Fused multilevel ROIAlign: the CUDA kernel (``csrc/roi_align.cu``) and
its dispatching entry.

Replaces ``moseq2_detectron_extract_tpu/ops/pallas_roi_align.py`` (Pallas
TPU kernel ``_kernel``, entry ``pallas_separable_roi_align``). On a CUDA
tensor :func:`roi_align` launches the kernel or raises; on a CPU tensor it
runs the plain version, ``roi_align.separable_batched_roi_align``.
'''
from typing import Sequence

import torch

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.ops.roi_align import \
    separable_batched_roi_align

MAX_OUTPUT_SIZE = 32

# launches of the CUDA kernel since the count was last set to 0
launch_count = 0


def roi_align_cuda(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                   output_size: int, min_level: int = 2) -> torch.Tensor:
    '''Launch the kernel: NHWC bf16 levels (B, H_l, W_l, C), boxes (B, K, 4)
    f32 -> (B, K, out, out, C) bf16, on the current stream.'''
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
                or not f.is_contiguous() or f.shape[0] != b or f.shape[3] != c:
            raise ValueError('levels must be contiguous NHWC bfloat16 tensors '
                             f'(B={b}, H, W, C={c}) on {device}')
    if c % 2:
        raise ValueError(f'channel count must be even, got {c}')
    out = torch.empty((b, k, output_size, output_size, c), dtype=torch.bfloat16,
                      device=device)
    if b * k == 0:
        return out
    ptrs = [f.data_ptr() for f in features] + [None] * (4 - len(features))
    hs = [f.shape[1] for f in features] + [0] * (4 - len(features))
    ws = [f.shape[2] for f in features] + [0] * (4 - len(features))
    lib = native.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.m2de_roi_align_bf16(*ptrs, *hs, *ws, len(features), min_level,
                                     boxes.data_ptr(), out.data_ptr(),
                                     b, k, c, output_size, stream)
    native.check(rc, 'roi_align kernel launch')
    launch_count += 1
    return out


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              output_size: int, min_level: int = 2) -> torch.Tensor:
    '''Multilevel ROIAlignV2 of (B, K, 4) boxes over NHWC levels
    (B, H_l, W_l, C) -> (B, K, out, out, C) bf16.

    CUDA tensors go to the kernel (levels are cast to bf16 first); CPU
    tensors to the plain version, computed in f32 and rounded to bf16.
    '''
    if boxes.is_cuda:
        levels = [f.to(torch.bfloat16).contiguous() for f in features]
        return roi_align_cuda(levels, boxes.float().contiguous(), output_size,
                              min_level)
    return separable_batched_roi_align(features, boxes, output_size, min_level,
                                       out_dtype=torch.bfloat16)
