'''The ROIAlign stage-2 experiment's four layouts: the tensor-core CUDA
kernels, their plain version, launch plan and dispatching entry. All four
run one loop (``csrc/roi_stage2_resident.cu``) that keeps one image's
pyramid channel slice in shared memory while its warps walk the image's
ROIs two at a time; they differ in stage 2 and the epilogue.

Replaces the Pallas TPU kernel bodies of ``benchmarks/roi_stage2_exp.py``
(``_kernel_retile_peroy``, ``_kernel_transpose``, ``_kernel_dotswap``,
``_kernel_noxpose``, launched by its ``make_variant``). All four compute the
fused separable multilevel ROIAlign with the TPU bodies' rounding chain:
bf16 pyramid and weights, stage 1 ``T = Wy @ F`` accumulated in f32 and
rounded to bf16, stage 2 (the contraction of T with Wx over w) accumulated in
f32 and cast to ``out_dtype``. ``noxpose`` writes (B, K, oy, c, ox), the
others (B, K, oy, ox, c).

On a CUDA tensor :func:`roi_stage2` launches the variant's kernel or raises;
on a CPU tensor it runs :func:`roi_stage2_plain`. The main path's pooling
does not come here: it goes through ``roi_align_kernel``.
'''
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.ops.roi_align import (_separable_inputs,
                                                              _separable_weights)

VARIANTS = ('retile', 'transpose', 'dotswap', 'noxpose')
BLOCK_KS = (8, 16)
OUTPUT_SIZE = 7           # the kernels' output size
MMA_DEPTH = 16            # ΣH and Wmax are padded to this (mma.m16n8k16)
THREADS = 256             # 8 warps a block
MAX_SMEM_BYTES = 232448   # shared memory one block may use on an H100
WARPS = THREADS // 32
PAIR = 2                  # ROIs a warp walks together, whatever block_k is
UNIT_CHANNELS = 8         # channels of one F plane and T column
CHANNEL_MULTIPLE = 16     # channels must be a positive multiple (the C launcher checks it too)

# launches of each variant's CUDA kernel since the counts were last set to 0
launch_count = dict.fromkeys(VARIANTS, 0)


class Stage2Plan(NamedTuple):
    '''How a kernel splits the work: one block of THREADS threads per
    (slice of ``cs`` channels, image), its F slice resident in shared
    memory, its warps walking the image's ``pairs`` ROI pairs.'''
    grid: Tuple[int, int, int]   # (channel slices, 1, images)
    blocks: int
    cs: int                      # channels per block
    pairs: int                   # ROI pairs a block walks: Kp / 2
    kp: int                      # ROIs padded to a multiple of block_k
    hp: int                      # ΣH padded to the mma depth
    wp: int                      # Wmax padded to the mma depth
    smem_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resident_smem_bytes(cs: int, hp: int, wp: int) -> int:
    '''Shared memory of a block: the warps' mbarriers (128 B), the F
    slice as cs / 8 planes of (h, w, 8 channels) with h rows padded by 8
    elements, and each warp's own Wy and Wx rows (2 ROIs x 8 rows, padded by
    8 elements) and T tile (16 rows x 16 w x 8 channels).'''
    return 128 + 2 * (cs // UNIT_CHANNELS * hp * (wp * UNIT_CHANNELS + 8)
                      + WARPS * 16 * (hp + 8 + wp + 8) + WARPS * 16 * 16 * UNIT_CHANNELS)


def resident_cs(hp: int, wp: int) -> int:
    '''Channels per block: 16 where everything fits, else 8.'''
    return 16 if resident_smem_bytes(16, hp, wp) <= MAX_SMEM_BYTES else UNIT_CHANNELS


def padded_sizes(rois: int, h_total: int, wmax: int, block_k: int) -> Tuple[int, int, int]:
    '''(Kp, Hp, Wp): the ROIs padded to a multiple of block_k, sum H and Wmax
    to the mma depth.'''
    if block_k not in BLOCK_KS:
        raise ValueError(f'block_k must be one of {BLOCK_KS}, got {block_k}')
    return (_round_up(rois, block_k), _round_up(h_total, MMA_DEPTH),
            _round_up(wmax, MMA_DEPTH))


def launch_plan(variant: str, batch: int, rois: int, channels: int, h_total: int,
                wmax: int, block_k: int) -> Stage2Plan:
    '''The plan of one launch; raises ValueError for what the kernels do not
    take. The variant does not enter: all four run the same loop. The
    channels per block and shared-memory bytes are the C entries'
    ``m2de_roi_stage2_resident_cs`` and ``m2de_roi_stage2_resident_smem_bytes``.'''
    if variant not in VARIANTS:
        raise ValueError(f'variant must be one of {VARIANTS}, got {variant!r}')
    kp, hp, wp = padded_sizes(rois, h_total, wmax, block_k)
    if channels < CHANNEL_MULTIPLE or channels % CHANNEL_MULTIPLE:
        raise ValueError(f'channels must be a positive multiple of {CHANNEL_MULTIPLE}, '
                         f'got {channels}')
    if batch > 65535:
        raise ValueError(f'at most 65535 images, got {batch}')
    cs = resident_cs(hp, wp)
    smem = resident_smem_bytes(cs, hp, wp)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f'an {cs}-channel slice of a pyramid of {h_total} stacked rows and '
                         f'{wmax} columns needs {smem} B of shared memory per block; the card '
                         f'has {MAX_SMEM_BYTES}')
    return Stage2Plan((channels // cs, 1, batch), channels // cs * batch, cs, kp // PAIR, kp,
                      hp, wp, smem)


def _check_call(variant: str, output_size: int, out_dtype: torch.dtype) -> None:
    if output_size != OUTPUT_SIZE:
        raise ValueError(f'the stage-2 kernels pool to {OUTPUT_SIZE} x {OUTPUT_SIZE}, '
                         f'got output_size {output_size}')
    if out_dtype != torch.float32 and (variant, out_dtype) != ('noxpose', torch.bfloat16):
        raise ValueError(f'out_dtype must be float32 (or bfloat16 for noxpose), got '
                         f'{out_dtype} for {variant}')


def tile_counts(wy: torch.Tensor, wx: torch.Tensor, block_k: int):
    '''Per group of ``block_k`` ROIs (B, Kp / block_k): the h tiles and the
    w tiles (of 16) from the lowest to the highest column where any of its
    Wy (B, Kp, 7, Hp), resp. Wx (B, Kp, 7, Wp), rows is nonzero; 0 for a
    group whose weights are all zero. The kernels' warps walk groups of
    :data:`PAIR` ROIs.'''
    def tiles(weights):
        b, kp, _, size = weights.shape
        hit = (weights.reshape(b, kp // block_k, -1, size) != 0).any(2)
        col = torch.arange(size, device=weights.device)
        lo = torch.where(hit, col, size).min(-1).values // MMA_DEPTH
        hi = torch.where(hit, col, -1).max(-1).values // MMA_DEPTH
        return torch.where(hit.any(-1), hi - lo + 1, 0)
    n_ht, n_wt = tiles(wy), tiles(wx)
    return torch.where(n_wt > 0, n_ht, 0), torch.where(n_ht > 0, n_wt, 0)


def mma_count(variant: str, wy: torch.Tensor, wx: torch.Tensor, block_k: int,
              channels: int):
    '''(stage 1, stage 2) mma.m16n8k16 a launch on these weights issues (2048
    multiply-adds each), counted from :func:`tile_counts` as the kernel walks
    its tiles.

    A warp walks the tiles of two ROIs at a time (:func:`tile_counts` with
    block 2); per ROI pair and 8 channels, stage 1 issues 16 n8 tiles of its
    m16 row tile for each (w tile, h tile), the same for all four variants;
    stage 2, for each w tile, 4 per ROI for dotswap and noxpose (their oy
    pairs) and 2 per oy for the block-diagonal product of retile and
    transpose (transpose loads oy 7, T's zero row, but does not multiply
    it), 8 and 14. block_k does not enter.'''
    n_ht, n_wt = tile_counts(wy, wx, PAIR)
    steps, w_tiles = int((n_ht * n_wt).sum()), int(n_wt.sum())
    units = channels // UNIT_CHANNELS
    stage2 = PAIR * 4 if variant in ('dotswap', 'noxpose') else OUTPUT_SIZE * 2
    return steps * 16 * units, w_tiles * stage2 * units


def stage2_inputs(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                  output_size: int, block_k: int, min_level: int = 2):
    '''The kernels' inputs, bf16 and contiguous: the H-stacked pyramid
    (B, Hp, Wp, C), Wy (B, Kp, out, Hp) and Wx (B, Kp, out, Wp), zero past
    ΣH, Wmax and the K real ROIs (make_variant's padding, and the mma
    depth's).'''
    b, k = boxes.shape[:2]
    heights = [f.shape[1] for f in features]
    widths = [f.shape[2] for f in features]
    kp, hp, wp = padded_sizes(k, sum(heights), max(widths), block_k)
    f_stack = torch.zeros((b, hp, wp, features[0].shape[-1]),
                          dtype=torch.bfloat16, device=boxes.device)
    row = 0
    for f in features:
        f_stack[:, row:row + f.shape[1], :f.shape[2]] = f
        row += f.shape[1]
    wy, wx = _separable_weights(heights, widths, boxes, output_size, min_level,
                                h_size=hp, w_size=wp)
    pad = (0, 0, 0, 0, 0, kp - k)
    return (f_stack, F.pad(wy.to(torch.bfloat16), pad).contiguous(),
            F.pad(wx.to(torch.bfloat16), pad).contiguous())


def roi_stage2_plain(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                     output_size: int, variant: str, block_k: int = 8,
                     out_dtype: torch.dtype = torch.float32,
                     min_level: int = 2) -> torch.Tensor:
    '''The plain version of every variant: the TPU bodies' rounding chain
    and make_variant's padding of the ROIs to a multiple of ``block_k``
    with zero weights, then cut. The variants differ only in the layout of
    ``noxpose``'s result.'''
    if variant not in VARIANTS:
        raise ValueError(f'variant must be one of {VARIANTS}, got {variant!r}')
    b, k = boxes.shape[:2]
    f_stack, wy, wx = _separable_inputs(features, boxes, output_size, min_level,
                                        as_dtype=torch.bfloat16)
    pad = (0, 0, 0, 0, 0, (-k) % block_k)
    wy, wx = F.pad(wy, pad), F.pad(wx, pad)
    t = torch.einsum('bkyh,bhwc->bkywc', wy.float(), f_stack.float()).to(torch.bfloat16)
    out = torch.einsum('bkxw,bkywc->bkyxc', wx.float(), t.float())
    if variant == 'noxpose':
        out = out.transpose(3, 4)
    return out[:, :k].to(out_dtype).contiguous()


def roi_stage2_cuda(f_stack: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, rois: int,
                    variant: str, block_k: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    '''Launch ``variant``'s kernel on :func:`stage2_inputs`' tensors, on the
    current stream: -> (B, rois, 7, 7, C), or (B, rois, 7, C, 7) for
    noxpose, in ``out_dtype``: f32, or bf16 for noxpose.'''
    device = f_stack.device
    if device.type != 'cuda':
        raise ValueError('roi_stage2_cuda needs CUDA tensors')
    _check_call(variant, OUTPUT_SIZE, out_dtype)
    if f_stack.dim() != 4:
        raise ValueError('f_stack must be (B, Hp, Wp, C)')
    b, hp, wp, c = f_stack.shape
    plan = launch_plan(variant, b, rois, c, hp, wp, block_k)
    expect = {'f_stack': (f_stack, (b, plan.hp, plan.wp, c)),
              'wy': (wy, (b, plan.kp, OUTPUT_SIZE, plan.hp)),
              'wx': (wx, (b, plan.kp, OUTPUT_SIZE, plan.wp))}
    for name, (t, shape) in expect.items():
        if t.device != device or t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f'{name} must be a contiguous bfloat16 tensor of shape {shape} '
                             f'on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}')
    shape = (b, rois, OUTPUT_SIZE, c, OUTPUT_SIZE) if variant == 'noxpose' else \
        (b, rois, OUTPUT_SIZE, OUTPUT_SIZE, c)
    out = torch.empty(shape, dtype=out_dtype, device=device)
    if b * rois == 0:
        return out
    lib = native.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f'm2de_roi_stage2_{variant}')(
            f_stack.data_ptr(), wy.data_ptr(), wx.data_ptr(), out.data_ptr(), b, rois,
            plan.kp, c, plan.hp, plan.wp, block_k, int(out_dtype == torch.bfloat16),
            stream)
    native.check(rc, f'roi_stage2 {variant} kernel launch')
    launch_count[variant] += 1
    return out


def roi_stage2(features: Sequence[torch.Tensor], boxes: torch.Tensor, output_size: int,
               variant: str, block_k: int = 8, out_dtype: torch.dtype = torch.float32,
               min_level: int = 2) -> torch.Tensor:
    '''Pool (B, K, 4) boxes over NHWC levels (B, H_l, W_l, C) with one of
    the four stage-2 layouts. CUDA tensors: the front half in PyTorch
    (:func:`stage2_inputs`), then the kernel; CPU tensors: the plain version.'''
    _check_call(variant, output_size, out_dtype)
    launch_plan(variant, boxes.shape[0], boxes.shape[1], features[0].shape[-1],
                sum(f.shape[1] for f in features), max(f.shape[2] for f in features),
                block_k)
    if boxes.is_cuda:
        f_stack, wy, wx = stage2_inputs(features, boxes.float(), output_size, block_k,
                                        min_level)
        return roi_stage2_cuda(f_stack, wy, wx, boxes.shape[1], variant, block_k, out_dtype)
    return roi_stage2_plain(features, boxes, output_size, variant, block_k, out_dtype,
                            min_level)
