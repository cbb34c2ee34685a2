'''Fused frame clean: the CUDA kernel (``csrc/clean.cu``), its plain
PyTorch version, and the dispatching entry.

Replaces ``moseq2_detectron_extract_tpu/ops/pallas_clean.py`` (Pallas TPU
kernel ``_clean_kernel``, entry ``fused_clean_frames``): a 3x3 median, then
3 erosions and 3 dilations with the 9x9 cv2 ellipse, over each frame
embedded in a zero halo, uint8 in and out. On a CUDA tensor
:func:`fused_clean_frames` launches the kernel or raises; on a CPU tensor it
runs :func:`clean_frames_plain`, which is bit-exact with the kernel.
'''
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.ops.morphology import (ELLIPSE_9X9,
                                                               strel_offsets)

HALO = 25             # reach of the stack: 1 (median) + 3*4 (erode) + 3*4 (dilate)
PAD_COLS = 32         # staged columns each side of a tile: HALO rounded up to 16
MAX_SMEM = 232448     # bytes of shared memory a block may use on sm_90
SMS = 132             # streaming multiprocessors of an H100 SXM
MARGINS = (24, 20, 16, 12, 8, 4, 0)   # the region each of the 7 passes computes

_OFFSETS = strel_offsets(ELLIPSE_9X9)

# launches of the CUDA kernel since the count was last set to 0
launch_count = 0


class TilePlan(NamedTuple):
    '''How the kernel cuts (N, H, W) frames: one block per (pair of frames,
    tile of ``tile_h`` x ``tile_w`` pixels); ``smem_bytes`` of dynamic
    shared memory a block (its two packed-word buffers).'''
    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    pairs: int
    blocks: int
    smem_bytes: int


def smem_bytes(tile_h: int, tile_w: int) -> int:
    '''Two buffers of (tile + halo) rows x (tile + 2 * PAD_COLS) 4-byte
    words, as ``csrc/clean.cu:m2de_clean_smem_bytes`` computes it.'''
    return 2 * (tile_h + 2 * HALO) * (tile_w + 2 * PAD_COLS) * 4


def _tile_cost(tile_h: int, tile_w: int) -> int:
    '''Words a block's seven passes compute: each pass's region, its width
    rounded up to the 4-word groups of the kernel.'''
    return sum((tile_h + 2 * m) * (-(-(tile_w + 2 * m) // 4) * 4) for m in MARGINS)


@functools.lru_cache(maxsize=64)
def tile_plan(n: int, h: int, w: int) -> TilePlan:
    '''The tiles the wrapper launches the kernel with: among the tile
    shapes that fit shared memory (widths a multiple of 16), the one whose
    busiest SM computes the fewest words, ceil(blocks / SMS) blocks of
    ``_tile_cost`` each; ties go to fewer blocks.'''
    if min(n, h, w) < 1:
        raise ValueError(f'no frames to clean in shape {(n, h, w)}')
    pairs = (n + 1) // 2
    best = None
    for tiles_x in range(1, -(-w // 16) + 1):
        tile_w = -(-(-(-w // tiles_x)) // 16) * 16
        if -(-w // tile_w) != tiles_x:
            continue
        for tiles_y in range(1, h + 1):
            tile_h = -(-h // tiles_y)
            if -(-h // tile_h) != tiles_y:
                continue
            size = smem_bytes(tile_h, tile_w)
            if size > MAX_SMEM:
                continue
            blocks = pairs * tiles_y * tiles_x
            key = (-(-blocks // SMS) * _tile_cost(tile_h, tile_w), blocks)
            if best is None or key < best[0]:
                best = (key, TilePlan(tile_h, tile_w, tiles_y, tiles_x, pairs, blocks,
                                      size))
    if best is None:
        raise ValueError(f'frame width {w} too large for the clean kernel')
    return best[1]


def _valid_stencil(x: torch.Tensor, offsets, reach: int, op) -> torch.Tensor:
    '''Reduce ``op`` over shifted windows; the result is ``reach`` smaller
    on every side (no padding: the caller's zero halo supplies the border).'''
    h = x.shape[1] - 2 * reach
    w = x.shape[2] - 2 * reach
    out = None
    for dy, dx in offsets:
        tap = x[:, reach + dy:reach + dy + h, reach + dx:reach + dx + w]
        out = tap if out is None else op(out, tap)
    return out


def clean_frames_plain(frames: torch.Tensor) -> torch.Tensor:
    '''The kernel's function in plain PyTorch: (N, H, W) uint8 -> uint8.

    The frames are zero-padded by the stack's reach; the median and the six
    min/max passes then each shrink the image by their own reach, so what
    is left is the frame, computed exactly as the kernel (and the TPU
    kernel) computes it.
    '''
    x = F.pad(frames, (HALO, HALO, HALO, HALO))
    taps3 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    h, w = x.shape[1] - 2, x.shape[2] - 2
    windows = torch.stack([x[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                           for dy, dx in taps3])
    x = torch.sort(windows, dim=0).values[4]
    for _ in range(3):
        x = _valid_stencil(x, _OFFSETS, 4, torch.minimum)
    reflected = [(-dy, -dx) for dy, dx in _OFFSETS]
    for _ in range(3):
        x = _valid_stencil(x, reflected, 4, torch.maximum)
    return x


def clean_frames_cuda(frames: torch.Tensor) -> torch.Tensor:
    '''Launch the kernel on (N, H, W) contiguous uint8 CUDA frames.'''
    global launch_count
    if frames.device.type != 'cuda' or frames.dtype != torch.uint8 \
            or frames.dim() != 3 or not frames.is_contiguous():
        raise ValueError('frames must be a contiguous (N, H, W) uint8 CUDA tensor')
    n, h, w = frames.shape
    out = torch.empty_like(frames)
    if out.numel() == 0:
        return out
    plan = tile_plan(n, h, w)
    lib = native.load_library()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = lib.m2de_clean_u8(frames.data_ptr(), out.data_ptr(), n, h, w,
                               plan.tile_h, plan.tile_w, stream)
    native.check(rc, 'clean kernel launch')
    launch_count += 1
    return out


def fused_clean_frames(frames: torch.Tensor) -> torch.Tensor:
    '''Median3 + 9x9-ellipse opening (3 iterations) with a zero halo over
    (N, H, W) uint8 frames: the kernel on CUDA, the plain version on CPU.'''
    if frames.is_cuda:
        return clean_frames_cuda(frames.contiguous())
    return clean_frames_plain(frames)
