'''The port's CUDA kernels and its main path on the card.

These tests need a CUDA device and nvcc and skip without them; this file
imports neither JAX nor the JAX package, so it runs on the GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: ROIAlign kernel vs its plain version, 2 bf16 ulps (both take
bf16 weights, round T to bf16 and the output once; the f32 sums run in
another order), and at the main path's stages nearly all equal
(``test_cuda_roi_align_ulps``); the
clean kernel is bit-exact; the stage-2 kernels vs their plain version, 2
bf16 ulps (the same bf16 products summed in f32 in another order, so an
element of T may round to the other bf16 neighbour). The output ops on
the card against the CPU: crop-and-rotate in f32 to 1e-3 (CUDA's ``cosf``
and fused multiply-adds move a source coordinate by about 1e-6 px), the
uint8 crops and the masks equal except at .5 (0.5) edges, the packed masks,
z, pixel counts and heights equal. The NMS kernel's keep mask equals the
plain fixpoint's bit for bit, with no host sync.
'''
import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu_torch.extract import (extract_chunks, prepare_session,
                                                        process_chunk)
from moseq2_detectron_extract_tpu_torch.io.session import Session
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, roi_align_kernel, roi_stage2_kernel
from moseq2_detectron_extract_tpu_torch.ops.instances import packbits_device
from moseq2_detectron_extract_tpu_torch.ops.roi_align import separable_batched_roi_align
from moseq2_detectron_extract_tpu_torch.ops.warp import crop_and_rotate_frames
from moseq2_detectron_extract_tpu_torch.pipeline.steps import (fetch_results,
                                                               make_feature_trackers,
                                                               process_features)
from moseq2_detectron_extract_tpu_torch.proc.keypoints import dispatch_z_lookup
from moseq2_detectron_extract_tpu_torch.proc.scalars import dispatch_scalar_stats
from moseq2_detectron_extract_tpu_torch.proc.roi import get_roi
from moseq2_detectron_extract_tpu_torch.synthetic import (make_sentinel_chunk, proposal_pool,
                                                          rough_arena, write_raw_session)

BF16_TOL = 2.0 ** -6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run on the GPU machine)')
    return torch.device('cuda')


def random_pyramid(b, k, c, canvas=160, seed=0):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 1, (b, canvas // (4 * 2 ** l), canvas // (4 * 2 ** l), c))
             .astype('float32') for l in range(4)]
    cx = rng.uniform(-10, canvas + 10, (b, k))
    cy = rng.uniform(-10, canvas + 10, (b, k))
    wh = rng.uniform(2, 1.5 * canvas, (b, k, 2))
    boxes = np.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                      cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], -1).astype('float32')
    return feats, boxes


@pytest.mark.parametrize('out,k,c', [(7, 16, 256), (14, 1, 256), (7, 1, 256), (5, 3, 6),
                                     (7, 5, 24)])
def test_cuda_roi_align_matches_plain(cuda_device, out, k, c):
    feats, boxes = random_pyramid(4, k, c, seed=out + k + c)
    levels = [torch.from_numpy(f).to(cuda_device, torch.bfloat16) for f in feats]
    bx = torch.from_numpy(boxes).to(cuda_device)
    before = roi_align_kernel.launch_count
    ours = roi_align_kernel.roi_align(levels, bx, out)
    assert roi_align_kernel.launch_count == before + 1
    plain = separable_batched_roi_align(levels, bx, out, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(ours.float(), plain.float(), rtol=BF16_TOL, atol=BF16_TOL)


def bf16_ulps(a, b):
    '''Distance in bf16 steps between two bf16 tensors.'''
    def code(x):
        bits = x.to(torch.bfloat16).contiguous().view(torch.int16).long()
        return torch.where(bits < 0, -(bits & 0x7fff), bits)
    return (code(a) - code(b)).abs()


@pytest.mark.parametrize('out,k', [(7, 16), (14, 1), (7, 1)])
def test_cuda_roi_align_ulps(cuda_device, out, k):
    '''The main path's three stages (B 16, C 256): the kernel rounds as the
    plain version does (bf16 weights, bf16 T), so nearly all elements are
    equal. The plain version sums in cuBLAS's order, so a T or an output on a
    bf16 rounding edge may land on the other neighbour: at most 0.2% of the
    elements differ, at most 0.1% by two ulps or more (outputs whose taps
    nearly cancel, or whose T moved), each within 2 ulps of its magnitude
    (read on the card: 0.0018% and 0.0005% here, 0.066% and 0.011% at
    chip_smoke.py's mask stage).'''
    _assert_kernel_ulps(cuda_device, out, k, 160, seed=40 + out + k)


@pytest.mark.parametrize('out,k', [(7, 256), (14, 1), (7, 1)])
def test_cuda_roi_align_faithful_shapes(cuda_device, out, k):
    '''The faithful model's stages (``benchmarks/bench_model``) on its 256
    canvas (P2 of 64 x 64; the box stage's 256 ROIs an image, 4,096 in a
    batch of 16), held as ``test_cuda_roi_align_ulps`` holds the main
    path's.'''
    _assert_kernel_ulps(cuda_device, out, k, 256, seed=50 + out + k)


def _assert_kernel_ulps(cuda_device, out, k, canvas, seed):
    feats, boxes = random_pyramid(16, k, 256, canvas=canvas, seed=seed)
    levels = [torch.from_numpy(f).to(cuda_device, torch.bfloat16) for f in feats]
    bx = torch.from_numpy(boxes).to(cuda_device)
    ours = roi_align_kernel.roi_align_cuda(levels, bx, out)
    plain = separable_batched_roi_align(levels, bx, out)
    ulps = bf16_ulps(ours, plain)
    far = ulps >= 2
    gap = (ours.float() - plain.float()).abs()
    print(f'out {out} K {k} canvas {canvas}: {int((ulps == 1).sum())} one ulp, '
          f'{int(far.sum())} two or more '
          f'(max {int(ulps.max())} ulps, max abs {float(gap[far].max()) if far.any() else 0.0:.2e}'
          f'), of {ulps.numel()}')
    assert int((ulps >= 1).sum()) <= 2e-3 * ulps.numel()
    assert int(far.sum()) <= 1e-3 * ulps.numel()
    assert bool((gap <= BF16_TOL * (1 + plain.float().abs())).all())


def chain_of_boxes(rng, k: int, chain: int):
    '''(K, 4) boxes, scores, levels and validity: a chain of ``chain``
    unit-offset 10 x 10 boxes with falling scores (each overlaps the next at
    IoU 0.82 and the one after at 0.67, so greedy NMS keeps every other box
    and the fixpoint decides two a round), then random boxes away from it
    with tied scores, three levels and a few padding entries.'''
    boxes = np.zeros((k, 4), 'float32')
    scores = np.zeros(k, 'float32')
    i = np.arange(chain, dtype='float32')
    boxes[:chain] = np.stack([i, np.zeros_like(i), i + 10, np.full_like(i, 10)], -1)
    scores[:chain] = 0.99 - i / 1024
    n = k - chain
    xy = rng.uniform(0, 240, (n, 2)) + [0, 40]
    wh = rng.uniform(4, 60, (n, 2))
    boxes[chain:] = np.concatenate([xy, xy + wh], 1)
    scores[chain:] = np.round(rng.uniform(0, 0.9, n), 2)
    levels = rng.integers(0, 3, k).astype('int32')
    levels[:chain] = 0
    valid = rng.random(k) > 0.02
    valid[:chain] = True
    return boxes, scores, levels, valid


@pytest.mark.parametrize('batched', [False, True])
def test_cuda_nms_at_the_global_cap_matches_cpu(cuda_device, batched):
    '''The faithful model's proposal NMS shape, (2, 1024, 1024), with a
    chain of suppressions past the 32-round cap: the card's keep mask (one
    kernel launch, no host sync) equals the CPU's (32 host syncs).'''
    from moseq2_detectron_extract_tpu_torch.ops import nms
    rng = np.random.default_rng(21)
    parts = [torch.from_numpy(np.stack(p)) for p in zip(*(chain_of_boxes(rng, 1024, 100)
                                                          for _ in range(2)))]
    keep = {}
    for dev in ('cpu', cuda_device):
        boxes, scores, levels, valid = (p.to(dev) for p in parts)
        nms.sync_count, nms.launch_count = 0, 0
        if batched:
            keep[str(dev)] = nms.batched_nms_keep_mask(boxes, scores, levels, 0.7, valid=valid)
        else:
            keep[str(dev)] = nms.nms_keep_mask(boxes, scores, 0.7, valid=valid)
        on_card = dev != 'cpu'
        assert (nms.sync_count, nms.launch_count) == ((0, 1) if on_card else (nms.MAX_ITERS, 0))
    assert torch.equal(keep[str(cuda_device)].cpu(), keep['cpu'])


def exact_threshold_pairs(n: int):
    '''(1, 2n) boxes in pairs whose float32 IoU is exactly float32(0.7):
    [x, y, x + 10s, y + 10s] against [x, y, x + 7s, y + 10s] (inter 70 s^2,
    union 100 s^2, all exact), then pairs whose narrow box's right edge is a
    float32 step further or nearer; the pairs 50 apart, so that no two overlap.'''
    rng = np.random.default_rng(7)
    boxes = []
    for i in range(n):
        x, y = 50.0 * (i % 20), 50.0 * (i // 20)
        step = 2.0 ** int(rng.integers(-2, 3))
        right = np.float32(x + 7 * step)
        right = (right, np.nextafter(right, np.float32(np.inf)),
                 np.nextafter(right, np.float32(0)))[i % 3]
        boxes += [[x, y, x + 10 * step, y + 10 * step], [x, y, float(right), y + 10 * step]]
    boxes = np.asarray(boxes, 'float32')[None]
    scores = np.tile([0.9, 0.8], n)[None].astype('float32')
    return boxes, scores


def near_threshold_pairs(n: int):
    '''(n, 2, 4) boxes, a pair an image, at random float coordinates, whose
    float32 IoU is within 2 float32 steps of float32(0.7): drawn from a
    larger pool by that IoU computed in numpy, one operation at a time, so
    that contracting two of them into an FMA would move some across.'''
    rng = np.random.default_rng(8)
    m = 400 * n
    x, y = (rng.uniform(0, 5, m).astype('float32') for _ in range(2))
    w, h = (rng.uniform(5, 60, m).astype('float32') for _ in range(2))
    right = x + np.float32(0.7) * w
    for _ in range(3):
        step = rng.integers(-1, 2, m)
        toward = np.where(step > 0, np.float32(np.inf), np.float32(0))
        right = np.where(step == 0, right, np.nextafter(right, toward))
    big = np.stack([x, y, x + w, y + h], -1)
    narrow = np.stack([x, y, right, y + h], -1)
    area = [(b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) for b in (big, narrow)]
    inter = (np.minimum(big[:, 2], right) - x) * h
    iou = inter / (area[0] + area[1] - inter)
    at = np.float32(0.7)
    near = np.abs(iou - at) <= 2 * np.spacing(at)
    boxes = np.stack([big, narrow], 1)[near][:n]
    assert len(boxes) == n
    return boxes, np.tile([[0.9, 0.8]], (n, 1)).astype('float32')


def assert_kernel_is_plain(cuda_device, boxes, scores, valid, thr=0.7, levels=None):
    '''The kernel's keep mask against the plain fixpoint's on the same card
    tensors, bit for bit: one launch, no host sync, ``sync_count`` unchanged.'''
    from moseq2_detectron_extract_tpu_torch.ops import nms
    boxes, scores, valid = (t.to(cuda_device) for t in (boxes, scores, valid))
    args = (boxes, scores) if levels is None else (boxes, scores, levels.to(cuda_device))
    entry = nms.nms_keep_mask if levels is None else nms.batched_nms_keep_mask
    syncs, launches = nms.sync_count, nms.launch_count
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        keep = entry(*args, thr, valid=valid)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert (nms.sync_count, nms.launch_count) == (syncs, launches + 1)
    kernel_op = nms.keep_mask_op
    nms.keep_mask_op = lambda b, s, v, t: nms.nms_keep_mask_plain(b, s, t, v)
    try:
        plain = entry(*args, thr, valid=valid)
    finally:
        nms.keep_mask_op = kernel_op
    torch.cuda.synchronize()
    assert keep.dtype == torch.bool and keep.shape == scores.shape
    assert torch.equal(keep, plain), int((keep != plain).sum())
    return keep.cpu()


@pytest.mark.parametrize('b,level_k,shifted', [
    (50, (1000, 1000, 768, 192, 48), True),    # the proposal NMS at inference
    (8, (2000, 2000, 768, 192, 48), True),     # the train proposal NMS
    (50, (1000,), False)])                     # the box head's NMS
def test_cuda_nms_kernel_at_the_main_path_shapes(cuda_device, b, level_k, shifted):
    boxes, scores, levels, valid = proposal_pool(b, level_k, seed=sum(level_k))
    keep = assert_kernel_is_plain(cuda_device, boxes, scores, valid,
                                  levels=levels if shifted else None)
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_cuda_nms_kernel_on_equal_scores(cuda_device):
    '''Rounded scores: ties everywhere, broken by index.'''
    boxes, scores, levels, valid = proposal_pool(4, (700, 300), seed=3)
    scores = torch.round(scores)
    boxes[:, 1::5] = boxes[:, ::5]               # identical boxes, tied scores
    scores[:, 1::5] = scores[:, ::5]
    assert_kernel_is_plain(cuda_device, boxes, scores, valid, levels=levels)


def test_cuda_nms_kernel_at_exactly_the_threshold(cuda_device):
    '''Pairs whose float32 IoU is float32(0.7): not suppressed, as in the
    plain version; one step wider, suppressed. Then pairs at random float
    coordinates within a few rounding steps of the threshold.'''
    from moseq2_detectron_extract_tpu_torch.ops.boxes import pairwise_iou
    boxes, scores = map(torch.from_numpy, exact_threshold_pairs(300))
    iou = pairwise_iou(boxes, boxes)[0, ::2, 1::2].diagonal()
    assert bool((iou[::3] == torch.tensor(0.7, dtype=torch.float32)).all())
    assert bool((iou[1::3] > 0.7).all()) and bool((iou[2::3] < 0.7).all())
    keep = assert_kernel_is_plain(cuda_device, boxes, scores,
                                  torch.ones(scores.shape, dtype=torch.bool))
    assert bool(keep[0, 1::6].all()) and not bool(keep[0, 3::6].any())
    boxes, scores = map(torch.from_numpy, near_threshold_pairs(600))
    iou = pairwise_iou(boxes, boxes)[:, 0, 1]
    at = torch.tensor(0.7, dtype=torch.float32)
    assert min(int((iou == at).sum()), int((iou > at).sum()), int((iou < at).sum())) >= 50
    assert_kernel_is_plain(cuda_device, boxes, scores, torch.ones(scores.shape, dtype=torch.bool))


@pytest.mark.parametrize('k', [1, 33, 100, 1000, 1023])
def test_cuda_nms_kernel_on_invalid_boxes_and_odd_k(cuda_device, k):
    '''Padding boxes, an image with none valid, and K of 1 or not a
    multiple of 32 or 64.'''
    boxes, scores, levels, valid = proposal_pool(3, (k,), canvas=64, seed=k)
    valid &= torch.from_numpy(np.random.default_rng(k).random((3, k)) > 0.2)
    valid[1] = False
    keep = assert_kernel_is_plain(cuda_device, boxes, scores, valid, thr=0.5)
    assert not bool(keep[1].any())


def test_cuda_nms_kernel_on_nan_and_infinite_inputs(cuda_device):
    '''NaN and infinite coordinates and NaN scores fall as torch's
    maximum, minimum, clamp and comparisons take them.'''
    boxes, scores, levels, valid = proposal_pool(2, (300,), canvas=64, seed=9)
    boxes[0, ::7, 0] = float('nan')
    boxes[0, 3::11, 2] = float('inf')
    boxes[1, 5::13] = boxes[1, 4::13] * float('inf')
    scores[1, ::9] = float('nan')
    assert_kernel_is_plain(cuda_device, boxes, scores, valid, thr=0.3)


@pytest.mark.parametrize('k', [5121, 9000])
def test_cuda_nms_kernel_with_the_bits_in_device_memory(cuda_device, k):
    '''K whose slice of bits does not fit in shared memory: the rounds read
    them from the device-memory scratch (a cluster of 14 CTAs at 5,121).'''
    from moseq2_detectron_extract_tpu_torch.ops import nms
    assert not nms.launch_plan(k).bits_in_smem
    boxes, scores, levels, valid = proposal_pool(2, (k - 1000, 1000), seed=k)
    assert_kernel_is_plain(cuda_device, boxes, scores, valid, levels=levels)


@pytest.mark.parametrize('k', [300, 3008, 6000])
def test_cuda_nms_kernel_keeps_the_round_cap(cuda_device, k):
    '''A ladder of 100 boxes that needs 50 rounds: the first 64 decided
    (every other one kept), the rest undecided at the 32-round cap.'''
    from moseq2_detectron_extract_tpu_torch.ops import nms
    rng = np.random.default_rng(k)
    boxes, scores, levels, valid = (torch.from_numpy(np.stack(p)) for p in zip(
        *(chain_of_boxes(rng, k, 100) for _ in range(2))))
    keep = assert_kernel_is_plain(cuda_device, boxes, scores, valid, levels=levels)
    chain = keep[:, :100]
    assert bool(chain[:, :2 * nms.MAX_ITERS:2].all())
    assert not bool(chain[:, 1:2 * nms.MAX_ITERS:2].any())
    assert not bool(chain[:, 2 * nms.MAX_ITERS:].any())


def test_cuda_nms_kernel_plans_can_be_scheduled(cuda_device):
    '''Each plan of the main path's K, and of the device-memory path,
    fits on the card at least once.'''
    import ctypes
    from moseq2_detectron_extract_tpu_torch import native
    from moseq2_detectron_extract_tpu_torch.ops import nms
    lib = native.load_library()
    for k in (64, 1000, 3008, 5008, 5121, 20000):
        plan = nms.launch_plan(k)
        out = ctypes.c_int(0)
        native.check(lib.m2de_nms_max_active_clusters(k, plan.cluster, plan.words_per_cta,
                                                       int(plan.bits_in_smem),
                                                       ctypes.byref(out)), 'occupancy')
        assert out.value >= 1, (k, plan)


@pytest.mark.parametrize('shape', [(64, 160, 160), (3, 77, 101), (2, 424, 512),
                                   (5, 64, 100), (1, 33, 36)])
def test_cuda_clean_bit_exact_vs_plain(cuda_device, shape):
    rng = np.random.default_rng(sum(shape))
    frames = torch.from_numpy(rng.integers(0, 256, shape).astype('uint8')).to(cuda_device)
    before = clean_kernel.launch_count
    ours = clean_kernel.fused_clean_frames(frames)
    assert clean_kernel.launch_count == before + 1
    plain = clean_kernel.clean_frames_plain(frames)
    torch.cuda.synchronize()
    assert torch.equal(ours, plain)


def whole_level_case(level, c, seed=0):
    '''A pyramid whose canvas makes the full-canvas box fall on ``level``:
    that box, one past the canvas on every side and a small one.'''
    canvas = 100 * 2 ** (level - 2)
    rng = np.random.default_rng(seed + level)
    feats = [rng.normal(0, 1, (2, canvas // 2 ** l, canvas // 2 ** l, c)).astype('float32')
             for l in (2, 3, 4, 5)]
    box = [[0, 0, canvas, canvas],
           [-canvas / 8, -canvas / 10, canvas * 1.1, canvas * 1.05],
           [canvas / 3, canvas / 4, canvas / 3 + 9, canvas / 4 + 13]]
    return feats, np.array([box, box[::-1]], 'float32')


@pytest.mark.parametrize('level', [2, 3, 4, 5])
@pytest.mark.parametrize('out', [7, 14])
def test_cuda_roi_align_whole_level_boxes(cuda_device, level, out):
    '''Footprints of the whole level: the kernel walks them in chunks.'''
    feats, boxes = whole_level_case(level, 256)
    levels = [torch.from_numpy(f).to(cuda_device, torch.bfloat16) for f in feats]
    bx = torch.from_numpy(boxes).to(cuda_device)
    ours = roi_align_kernel.roi_align_cuda(levels, bx, out)
    plain = separable_batched_roi_align(levels, bx, out, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(ours.float(), plain.float(), rtol=BF16_TOL, atol=BF16_TOL)


def test_cuda_roi_align_takes_channels_last_levels(cuda_device):
    '''A channels_last NCHW level permuted to NHWC goes in as it is, by
    its strides; so does a level with padded rows (16-byte loads off).'''
    feats, boxes = random_pyramid(2, 6, 64, seed=5)
    bx = torch.from_numpy(boxes).to(cuda_device)
    dense = [torch.from_numpy(f).to(cuda_device, torch.bfloat16) for f in feats]
    nchw = [f.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last) for f in dense]
    views = [f.permute(0, 2, 3, 1) for f in nchw]
    assert all(v.data_ptr() == f.data_ptr() for v, f in zip(views, nchw))
    padded = [torch.zeros((f.shape[0], f.shape[1], f.shape[2] + 1, f.shape[3] + 2),
                          dtype=f.dtype, device=cuda_device) for f in dense]
    for p, f in zip(padded, dense):
        p[:, :, :f.shape[2], :f.shape[3]] = f
    strided = [p[:, :, :f.shape[2], :f.shape[3]] for p, f in zip(padded, dense)]
    plain = separable_batched_roi_align(dense, bx, 7, out_dtype=torch.bfloat16)
    for levels in (views, strided):
        ours = roi_align_kernel.roi_align_cuda(levels, bx, 7)
        torch.cuda.synchronize()
        torch.testing.assert_close(ours.float(), plain.float(), rtol=BF16_TOL, atol=BF16_TOL)


def test_cuda_clean_all_255_shows_the_zero_halo(cuda_device):
    '''The zero halo erodes a white frame from its border; the rest stays
    white; the kernel agrees with the plain version.'''
    frames = torch.full((3, 90, 120), 255, dtype=torch.uint8, device=cuda_device)
    ours = clean_kernel.clean_frames_cuda(frames)
    plain = clean_kernel.clean_frames_plain(frames)
    torch.cuda.synchronize()
    assert torch.equal(ours, plain)
    assert int(ours[:, 0, 0].max()) == 0 and bool((ours[:, 45, 60] == 255).all())


def test_cuda_clean_shared_memory_formula_agrees(cuda_device):
    from moseq2_detectron_extract_tpu_torch import native
    lib = native.load_library()
    for shape in [(64, 160, 160), (3, 77, 101), (2, 424, 512)]:
        plan = clean_kernel.tile_plan(*shape)
        assert lib.m2de_clean_smem_bytes(plan.tile_h, plan.tile_w) == plan.smem_bytes


def small_model():
    '''A small random f32 model: its config and weights.'''
    torch.manual_seed(0)
    cfg = ModelConfig(image_size=64, min_size_test=64, max_size_test=64,
                      resnet_stage_blocks=(1, 1, 1, 1), resnet_width=16,
                      fpn_channels=32, box_fc_dim=32, mask_conv_dims=(32,),
                      keypoint_conv_dims=(32,), rpn_pre_nms_topk_test=32,
                      rpn_post_nms_topk_test=8, test_detections_per_image=1,
                      amp_dtype='float32')
    return cfg, MaskKeypointRCNN(cfg).state_dict()


def test_cuda_process_chunk_matches_cpu(cuda_device):
    '''A small random f32 model: the card (kernels) against the CPU (plain
    versions) through the whole slice.'''
    cfg, state = small_model()
    chunk = make_sentinel_chunk(4, 96, 128, seed=0)
    config = {'min_height': 0, 'max_height': 100, 'feature_window': 64}
    outs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # f32 convolutions on both sides
    try:
        for dev in (cuda_device, torch.device('cpu')):
            pred = Predictor(cfg, state, batch_size=2, score_threshold=0.0, device=dev)
            outs[dev.type] = process_chunk(chunk, pred, config)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    gpu, cpu = outs['cuda'], outs['cpu']
    torch.testing.assert_close(gpu['inference']['boxes'].cpu(), cpu['inference']['boxes'],
                               rtol=1e-3, atol=0.05)
    np.testing.assert_array_equal(gpu['win_origins'], cpu['win_origins'])
    assert torch.equal(gpu['feat_dispatch']['cleaned_frames'].cpu(),
                       cpu['feat_dispatch']['cleaned_frames'])


def test_cuda_process_chunk_with_the_nms_kernel_equals_the_plain_nms(cuda_device):
    '''The small model with the faithful model's uncapped pool (1,000
    proposals a level, about 1,000 candidates on its 64 canvas): the slice's
    outputs with the NMS kernel equal those with the plain fixpoint on the
    card bit for bit (cuDNN deterministic), two launches a batch.'''
    from moseq2_detectron_extract_tpu_torch.ops import nms
    cfg, state = small_model()
    cfg = cfg.replace(rpn_pre_nms_topk_test=1000, rpn_post_nms_topk_test=100,
                      rpn_nms_global_cap=None, test_score_thresh=0.0)
    chunk = make_sentinel_chunk(6, 96, 128, seed=1)
    config = {'min_height': 0, 'max_height': 100, 'feature_window': 64}
    pred = Predictor(cfg, state, batch_size=2, score_threshold=0.0, device=cuda_device)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    kernel_op = nms.keep_mask_op
    try:
        nms.launch_count = 0
        with_kernel = process_chunk(chunk, pred, config)['inference']
        assert nms.launch_count == 2 * 3
        nms.keep_mask_op = lambda b, s, v, t: nms.nms_keep_mask_plain(b, s, t, v)
        with_plain = process_chunk(chunk, pred, config)['inference']
    finally:
        nms.keep_mask_op = kernel_op
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    assert set(with_kernel) == set(with_plain)
    for key, value in with_kernel.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(torch.nan_to_num(value, nan=-7.0),
                               torch.nan_to_num(with_plain[key], nan=-7.0)), key
        else:
            np.testing.assert_array_equal(value, with_plain[key], err_msg=key)


@pytest.fixture
def raw_session(tmp_path):
    '''A small raw session on disk, 20 frames of 96 x 128 over a tilted,
    rough floor: its background is frame 0's, where the mouse leaves a hole
    in the floor's region that the ROI's fill closes.'''
    return write_raw_session(str(tmp_path), 20, height=96, width=128, seed=3)


def assert_plane_close(plane, ref):
    '''The same hypothesis, computed in another order: the unit normal to
    1e-5 and d to 1e-3 mm (as the CPU tests hold the port to JAX).'''
    np.testing.assert_allclose(plane[:3], ref[:3], atol=1e-5)
    np.testing.assert_allclose(plane[3], ref[3], atol=1e-3)


def test_cuda_prepare_session_matches_cpu(cuda_device, raw_session):
    '''The background median, RANSAC and dilation on the card and on the
    CPU: the same background, ROI, true depth and plane.'''
    found = []
    for dev in (cuda_device, torch.device('cpu')):
        session = Session(raw_session)
        found.append((prepare_session(session, {}, device=dev), session.plane))
    (gpu, gpu_plane), (cpu, cpu_plane) = found
    np.testing.assert_array_equal(gpu['bground_im'], cpu['bground_im'])
    np.testing.assert_array_equal(gpu['roi'], cpu['roi'])
    assert gpu['true_depth'] == cpu['true_depth'] and abs(cpu['true_depth'] - 700) < 5
    assert_plane_close(gpu_plane, cpu_plane)


@pytest.mark.parametrize('shape', [(128, 192), (424, 512)])
@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_cuda_get_roi_matches_cpu_where_planes_compete(cuda_device, seed, shape):
    '''``rough_arena``: the accept rule takes several near hypotheses in
    turn, scored by sums that the card adds in another order than the CPU;
    the same ROIs and plane.'''
    image = rough_arena(*shape, seed)
    (gpu_rois, gpu_plane), (cpu_rois, cpu_plane) = (
        get_roi(image, device=dev) for dev in (cuda_device, torch.device('cpu')))
    assert len(gpu_rois) == len(cpu_rois) >= 2
    for gpu, cpu in zip(gpu_rois, cpu_rois):
        np.testing.assert_array_equal(gpu, cpu)
    assert_plane_close(gpu_plane, cpu_plane)


def test_cuda_extract_chunks_matches_cpu(cuda_device, raw_session):
    '''The session path with a small random f32 model: the same prepped
    chunks, and detections as in test_cuda_process_chunk_matches_cpu.'''
    cfg, state = small_model()
    config = {'chunk_size': 8, 'min_height': 0, 'max_height': 100, 'feature_window': 64}
    outs = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (cuda_device, torch.device('cpu')):
            session = Session(raw_session)
            prepared = prepare_session(session, config, device=dev)
            pred = Predictor(cfg, state, batch_size=4, score_threshold=0.0, device=dev)
            outs.append(list(extract_chunks(session, pred, prepared)))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert len(outs[0]) == len(outs[1]) == 3
    for gpu, cpu in zip(*outs):
        np.testing.assert_array_equal(gpu['chunk'], cpu['chunk'])
        np.testing.assert_array_equal(gpu['frame_idxs'], cpu['frame_idxs'])
        torch.testing.assert_close(gpu['inference']['boxes'].cpu(), cpu['inference']['boxes'],
                                   rtol=1e-3, atol=0.05)
        np.testing.assert_array_equal(gpu['win_origins'], cpu['win_origins'])
        assert torch.equal(gpu['feat_dispatch']['cleaned_frames'].cpu(),
                           cpu['feat_dispatch']['cleaned_frames'])
        assert list(gpu['scalars']) == list(cpu['scalars'])
        assert gpu['depth_frames'].shape == cpu['depth_frames'].shape == (8, 80, 80)
        np.testing.assert_array_equal(gpu['scalars']['area_px'], cpu['scalars']['area_px'])


def _uint8_edges_only(ours, ref_f32, tol=1e-3):
    '''The uint8 values of two f32 crops within ``tol`` differ only where
    the reference sits within ``tol`` of a .5 edge.'''
    a = torch.clamp(torch.round(ours), 0, 255).to(torch.uint8)
    b = torch.clamp(torch.round(ref_f32), 0, 255).to(torch.uint8)
    edge = (ref_f32 - torch.floor(ref_f32) - 0.5).abs() <= tol
    return bool(((a == b) | edge).all()), int((a != b).sum())


@pytest.mark.parametrize('n,h,w', [(16, 160, 160), (7, 60, 72)])
def test_cuda_output_ops_match_cpu(cuda_device, n, h, w):
    rng = np.random.default_rng(n)
    frames = torch.from_numpy(rng.integers(0, 110, (n, h, w)).astype(np.uint8))
    centers = np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)], axis=1)
    centers[0] = np.nan
    angles = rng.uniform(0, 360, n)
    angles[1] = np.nan
    gpu = crop_and_rotate_frames(frames.to(cuda_device), centers, angles)
    cpu = crop_and_rotate_frames(frames, centers, angles)
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-3)
    ok, _ = _uint8_edges_only(gpu.cpu(), cpu)
    assert ok
    masks = gpu > 0.5
    assert torch.equal(packbits_device(masks).cpu(), packbits_device(masks.cpu()))
    kpts = np.stack([rng.uniform(-3, w + 3, (n, 8)), rng.uniform(-3, h + 3, (n, 8)),
                     rng.uniform(0, 1, (n, 8))], axis=-1)
    kpts[2, 1] = np.nan
    assert torch.equal(dispatch_z_lookup(kpts, frames.to(cuda_device)).cpu(),
                       dispatch_z_lookup(kpts, frames))
    for a, b in zip(dispatch_scalar_stats(frames.to(cuda_device), 0.0, 100.0),
                    dispatch_scalar_stats(frames, 0.0, 100.0)):
        assert torch.equal(a.cpu(), b)


def _on(data, dev):
    '''A copy of a chunk's dict with every tensor on ``dev``.'''
    if torch.is_tensor(data):
        return data.to(dev)
    if isinstance(data, dict):
        return {k: _on(v, dev) for k, v in data.items()}
    if isinstance(data, tuple):
        return tuple(_on(v, dev) for v in data)
    return data


def test_cuda_back_end_matches_cpu(cuda_device):
    '''``process_features`` + ``fetch_results`` on the card and on the CPU,
    fed one chunk's CPU selection: the brain sees the same host values, so
    everything but the crops is equal, and the crops are equal but at edges.'''
    cfg, state = small_model()
    config = {'min_height': 0, 'max_height': 100, 'feature_window': 64, 'crop_size': (80, 80),
              'frame_dtype': 'uint8', 'true_depth': 700.0}
    pred = Predictor(cfg, state, batch_size=4, score_threshold=0.0, device='cpu')
    sel = dict(process_chunk(make_sentinel_chunk(8, 96, 128, seed=2), pred, config),
               frame_idxs=np.arange(8))
    outs = [fetch_results(process_features(_on(sel, dev), config, make_feature_trackers(config)),
                          config) for dev in (cuda_device, torch.device('cpu'))]
    gpu, cpu = outs
    for key, value in cpu['scalars'].items():
        np.testing.assert_array_equal(gpu['scalars'][key], value, err_msg=key)
    for key, value in cpu['keypoints'].items():
        np.testing.assert_array_equal(gpu['keypoints'][key], value, err_msg=key)
    np.testing.assert_array_equal(gpu['features']['flips'], cpu['features']['flips'])
    np.testing.assert_array_equal(gpu['arena_mask_crops'], cpu['arena_mask_crops'])
    depth = crop_and_rotate_frames(sel['chunk_dev'], cpu['features']['features']['centroid'],
                                   cpu['features']['features']['orientation'])
    edge = (depth - torch.floor(depth) - 0.5).abs().numpy() <= 1e-3
    assert ((gpu['depth_frames'] == cpu['depth_frames']) | edge).all()
    assert (gpu['mask_frames'] != cpu['mask_frames']).mean() < 1e-3


STAGE2_RUNS = [('retile', torch.float32), ('transpose', torch.float32),
               ('dotswap', torch.float32), ('noxpose', torch.float32),
               ('noxpose', torch.bfloat16)]


@pytest.mark.parametrize('variant,dtype', STAGE2_RUNS,
                         ids=[f'{v}-{str(d)[6:]}' for v, d in STAGE2_RUNS])
@pytest.mark.parametrize('b,k,c,canvas,block_k', [
    (16, 16, 256, 160, 8),      # the main path's box stage: sum H 75, Wmax 40 -> 80, 48
    (16, 16, 256, 160, 16),
    (2, 13, 32, 160, 8),        # K not a multiple of block_k
    (2, 21, 32, 256, 16),       # and at the experiment's canvas: 120, 64 (cs 8)
    (2, 21, 32, 256, 8),
    (3, 9, 16, 96, 8),          # sum H 45, Wmax 24 -> 48, 32; C 16: one slice of 16
    (2, 11, 48, 160, 16),       # C 48: three slices of 16
    (2, 11, 48, 256, 8),        # C 48 at cs 8: six slices
])
def test_cuda_roi_stage2_matches_plain(cuda_device, variant, dtype, b, k, c, canvas, block_k):
    feats, boxes = random_pyramid(b, k, c, canvas=canvas, seed=b + k + c + canvas)
    levels = [torch.from_numpy(f).to(cuda_device, torch.bfloat16) for f in feats]
    bx = torch.from_numpy(boxes).to(cuda_device)
    before = roi_stage2_kernel.launch_count[variant]
    ours = roi_stage2_kernel.roi_stage2(levels, bx, 7, variant, block_k, dtype)
    assert roi_stage2_kernel.launch_count[variant] == before + 1
    plain = roi_stage2_kernel.roi_stage2_plain(levels, bx, 7, variant, block_k, dtype)
    torch.cuda.synchronize()
    assert ours.dtype == dtype and ours.shape == plain.shape
    torch.testing.assert_close(ours.float(), plain.float(), rtol=BF16_TOL, atol=BF16_TOL)


def test_cuda_roi_stage2_refuses_what_it_does_not_take(cuda_device):
    feats, boxes = random_pyramid(2, 8, 32, seed=7)
    levels = [torch.from_numpy(f).to(cuda_device, torch.bfloat16) for f in feats]
    bx = torch.from_numpy(boxes).to(cuda_device)
    rs = roi_stage2_kernel
    with pytest.raises(ValueError, match='output_size'):
        rs.roi_stage2(levels, bx, 14, 'dotswap')
    with pytest.raises(ValueError, match='block_k'):
        rs.roi_stage2(levels, bx, 7, 'dotswap', block_k=4)
    with pytest.raises(ValueError, match='variant'):
        rs.roi_stage2(levels, bx, 7, 'blockdiag')
    with pytest.raises(ValueError, match='channels'):
        rs.roi_stage2([f[..., :24] for f in levels], bx, 7, 'dotswap')
    f_stack, wy, wx = rs.stage2_inputs(levels, bx, 7, 8)
    with pytest.raises(ValueError, match='out_dtype'):
        rs.roi_stage2_cuda(f_stack, wy, wx, 8, 'dotswap', 8, torch.float16)
    with pytest.raises(ValueError, match='wy'):
        rs.roi_stage2_cuda(f_stack, wy.float(), wx, 8, 'dotswap', 8)
    with pytest.raises(ValueError, match='wx'):
        rs.roi_stage2_cuda(f_stack, wy, wx.transpose(2, 3).contiguous().transpose(2, 3), 8,
                           'dotswap', 8)
    big = [torch.zeros((1, 1024 // s, 1024 // s, 16), dtype=torch.bfloat16, device=cuda_device)
           for s in (4, 8, 16, 32)]
    with pytest.raises(ValueError, match='shared memory'):
        rs.roi_stage2(big, bx[:1], 7, 'transpose', block_k=16)


def test_cuda_roi_stage2_shared_memory_formula_agrees(cuda_device):
    from moseq2_detectron_extract_tpu_torch import native
    lib = native.load_library()
    for variant in roi_stage2_kernel.VARIANTS:
        for bk in (8, 16):
            for h, w in ((75, 40), (120, 64), (45, 24)):
                plan = roi_stage2_kernel.launch_plan(variant, 4, 16, 256, h, w, bk)
                assert lib.m2de_roi_stage2_resident_smem_bytes(plan.hp, plan.wp) == \
                    plan.smem_bytes
                assert lib.m2de_roi_stage2_resident_cs(plan.hp, plan.wp) == plan.cs


def plain_from_inputs(f_stack, wy, wx, rois, variant, dtype):
    '''The plain version's arithmetic on the kernels' own inputs.'''
    t = torch.einsum('bkyh,bhwc->bkywc', wy.float(), f_stack.float()).to(torch.bfloat16)
    out = torch.einsum('bkxw,bkywc->bkyxc', wx.float(), t.float())[:, :rois]
    if variant == 'noxpose':
        out = out.transpose(3, 4)
    return out.to(dtype)


@pytest.mark.parametrize('variant,dtype', STAGE2_RUNS,
                         ids=[f'{v}-{str(d)[6:]}' for v, d in STAGE2_RUNS])
@pytest.mark.parametrize('canvas', [160, 256])
def test_cuda_roi_stage2_image_of_zero_weights(cuda_device, variant, dtype, canvas):
    '''An image whose ROIs all weigh nothing walks no tile and writes zeros;
    the other image is unchanged by it.'''
    feats, boxes = random_pyramid(2, 13, 32, canvas=canvas, seed=canvas)
    levels = [torch.from_numpy(f).to(cuda_device, torch.bfloat16) for f in feats]
    bx = torch.from_numpy(boxes).to(cuda_device)
    f_stack, wy, wx = roi_stage2_kernel.stage2_inputs(levels, bx, 7, 8)
    wy[1] = 0
    wx[1] = 0
    ours = roi_stage2_kernel.roi_stage2_cuda(f_stack, wy, wx, 13, variant, 8, dtype)
    plain = plain_from_inputs(f_stack, wy, wx, 13, variant, dtype)
    torch.cuda.synchronize()
    assert not ours[1].any()
    torch.testing.assert_close(ours.float(), plain.float(), rtol=BF16_TOL, atol=BF16_TOL)


TWIN_CASES = [(16, 16, 256, 160, 8),    # the box shape: 16 channels a block
              (2, 21, 48, 256, 16),     # the experiment's canvas: 8 channels a block; K odd
              (3, 13, 32, 160, 8)]


def twin_outputs(device, variants, b, k, c, canvas, block_k):
    feats, boxes = random_pyramid(b, k, c, canvas=canvas, seed=b + k + c)
    levels = [torch.from_numpy(f).to(device, torch.bfloat16) for f in feats]
    inputs = roi_stage2_kernel.stage2_inputs(levels, torch.from_numpy(boxes).to(device), 7,
                                             block_k)
    outs = [roi_stage2_kernel.roi_stage2_cuda(*inputs, k, v, block_k) for v in variants]
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize('b,k,c,canvas,block_k', TWIN_CASES)
def test_cuda_dotswap_is_noxpose_permuted(cuda_device, b, k, c, canvas, block_k):
    '''Bit for bit: the two issue the same mma in the same order and differ
    only in the layout they store.'''
    dot, nox = twin_outputs(cuda_device, ('dotswap', 'noxpose'), b, k, c, canvas, block_k)
    assert dot.shape == (b, k, 7, 7, c) and nox.shape == (b, k, 7, c, 7)
    assert torch.equal(dot, nox.transpose(3, 4))


@pytest.mark.parametrize('b,k,c,canvas,block_k', TWIN_CASES)
def test_cuda_transpose_is_retile(cuda_device, b, k, c, canvas, block_k):
    '''Bit for bit: transpose loads T over oy pairs where retile loads one
    oy at a time, and issues retile's mma, each output summed in the same
    order.'''
    tra, ret = twin_outputs(cuda_device, ('transpose', 'retile'), b, k, c, canvas, block_k)
    assert tra.shape == ret.shape == (b, k, 7, 7, c)
    assert torch.equal(tra, ret)


# -- training ----------------------------------------------------------------------
# The gather ROIAlign's backward scatters with index_add_, which accumulates
# with atomics on the card: its feature gradients are not bitwise repeatable,
# and are held to the CPU to 1e-4 of their largest value. Its forward is held
# to 1e-4: nvcc fuses the sample coordinates' multiply-adds, which moves a
# coordinate near 40 (a level's width) by an f32 ulp, 4e-6, and the output by
# up to that times the taps' difference (measured on the card: 1.9e-5). One train step of the tiny model, f32 with TF32 off: the loss
# terms to 1e-4 relative, every gradient and the updated weights to 1e-4 of
# their largest value.

def _no_tf32():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return saved


def _restore_tf32(saved):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize('out,k', [(7, 256), (14, 40)])
def test_cuda_gather_roi_align_forward_and_backward_match_cpu(cuda_device, out, k):
    from moseq2_detectron_extract_tpu_torch.ops.roi_align import batched_multilevel_roi_align
    feats, boxes = random_pyramid(2, k, 64, seed=out)
    grads = np.random.default_rng(out).normal(0, 1, (2, k, out, out, 64)).astype('float32')
    res = {}
    for dev in ('cpu', cuda_device):
        levels = [torch.from_numpy(f).to(dev).requires_grad_() for f in feats]
        pooled = batched_multilevel_roi_align(levels, torch.from_numpy(boxes).to(dev), out)
        pooled.backward(torch.from_numpy(grads).to(dev))
        res[str(dev)] = (pooled.detach().cpu(), [f.grad.cpu() for f in levels])
    (p_cpu, g_cpu), (p_gpu, g_gpu) = res['cpu'], res['cuda']
    torch.testing.assert_close(p_gpu, p_cpu, rtol=0, atol=1e-4)
    for a, b in zip(g_gpu, g_cpu):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_cuda_train_step_matches_cpu(cuda_device):
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN, draw_loss_uniforms
    from moseq2_detectron_extract_tpu_torch.models.train import (TrainState, make_optimizer,
                                                                 make_train_step)
    cfg = ModelConfig(image_size=64, min_size_test=64, max_size_test=64,
                      resnet_stage_blocks=(1, 1, 1, 1), resnet_width=16, fpn_channels=64,
                      box_fc_dim=128, mask_conv_dims=(64, 64), keypoint_conv_dims=(64, 64),
                      amp_dtype='float32', rpn_pre_nms_topk_train=200,
                      rpn_post_nms_topk_train=64, roi_batch_size_per_image=32,
                      max_gt_instances=1, warmup_iters=1, base_lr=0.01)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(0, 1, (2, 3, 64, 64)).astype('float32'))
    masks = torch.zeros((2, 1, 64, 64), dtype=torch.bool)
    masks[0, 0, 10:40, 12:50] = True
    masks[1, 0, 30:55, 5:30] = True
    gt = {'boxes': torch.tensor([[[12.0, 10, 50, 40]], [[5.0, 30, 30, 55]]]),
          'valid': torch.ones((2, 1), dtype=torch.bool), 'masks': masks,
          'keypoints': torch.zeros((2, 1, 8, 3))}
    gt['keypoints'][..., 0] = torch.linspace(14, 28, 8)
    gt['keypoints'][..., 1] = 35.0
    gt['keypoints'][..., 2] = 2.0
    draws = draw_loss_uniforms(torch.Generator().manual_seed(1), cfg, 2, 'cpu')
    torch.manual_seed(0)
    state_dict = MaskKeypointRCNN(cfg).state_dict()
    saved = _no_tf32()
    try:
        out = {}
        for dev in ('cpu', 'cuda'):
            model = MaskKeypointRCNN(cfg)
            model.load_state_dict(state_dict)
            model.to(dev)
            state = TrainState(0, model, make_optimizer(cfg, model))
            batch = {'images': images.to(dev), 'gt': {k: v.to(dev) for k, v in gt.items()}}
            dv = {k: tuple(u.to(dev) for u in pair) for k, pair in draws.items()}
            _, metrics = make_train_step(cfg)(state, batch, dv)
            out[dev] = ({k: float(v) for k, v in metrics.items()},
                        {k: v.detach().cpu() for k, v in model.state_dict().items()})
    finally:
        _restore_tf32(saved)
    (m_cpu, w_cpu), (m_gpu, w_gpu) = out['cpu'], out['cuda']
    for key, value in m_cpu.items():
        assert abs(m_gpu[key] - value) <= 1e-4 * max(abs(value), 1e-6), key
    for name, value in w_cpu.items():
        scale = max(float((value - state_dict[name]).abs().max()), 1e-12)
        assert float((w_gpu[name] - value).abs().max()) <= 1e-4 * max(
            float(value.abs().max()), scale), name


@pytest.mark.parametrize('out,k,c', [(7, 16, 256), (14, 1, 256), (7, 1, 256), (5, 3, 6)])
def test_cuda_registered_op_is_the_kernel(cuda_device, out, k, c):
    '''``m2de::roi_align_bf16`` on CUDA tensors: one launch of the kernel,
    bit for bit ``roi_align_cuda``'s output.'''
    feats, boxes = random_pyramid(3, k, c, seed=out * k + c)
    levels = [torch.from_numpy(f).to(cuda_device, torch.bfloat16) for f in feats]
    bx = torch.from_numpy(boxes).to(cuda_device)
    before = roi_align_kernel.launch_count
    via_op = torch.ops.m2de.roi_align_bf16(levels, bx, out, 2)
    assert roi_align_kernel.launch_count == before + 1
    direct = roi_align_kernel.roi_align_cuda(levels, bx, out, 2)
    torch.cuda.synchronize()
    assert via_op.dtype == torch.bfloat16 and torch.equal(via_op, direct)


def test_cuda_export_tiny_model(cuda_device, tmp_path):
    '''``models/deploy.py`` on the card: the loaded program launches the
    ROIAlign kernel 3 times a batch and, with deterministic cuDNN, equals
    the live model bit for bit.'''
    import os
    from moseq2_detectron_extract_tpu_torch.models.checkpoint import save_checkpoint
    from moseq2_detectron_extract_tpu_torch.models.deploy import (export_model,
                                                                  load_exported_model)
    cfg, state = small_model()
    model_dir = str(tmp_path / 'model')
    os.makedirs(model_dir)
    cfg.replace(test_score_thresh=0.0).to_yaml(os.path.join(model_dir, 'config.yaml'))
    save_checkpoint(model_dir, 0, {'step': 0, 'model': state})
    out = export_model(model_dir, batch_size=2, device='cuda')
    frames = torch.from_numpy(make_sentinel_chunk(4, 96, 128, seed=1)).to(cuda_device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        program = load_exported_model(out, device='cuda')
        assert program._exported_forward is not None
        live = Predictor.from_model_dir(model_dir, batch_size=2, device='cuda')
        roi_align_kernel.launch_count = 0
        got = program(frames)
        torch.cuda.synchronize()
        assert roi_align_kernel.launch_count == 3 * 2
        ref = live(frames)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for key in got:
        assert torch.equal(torch.nan_to_num(got[key], nan=-7.0),
                           torch.nan_to_num(ref[key], nan=-7.0)), key


def test_cuda_find_roi_on_ffv1_session_equals_dat(cuda_device, tmp_path):
    '''An FFV1 session's frames come back as uint16 (a raw .dat's as int16):
    the card's median takes both, and the ROI search gives the same result.'''
    from moseq2_detectron_extract_tpu_torch.io.video import read_frames_raw, write_frames
    dat = write_raw_session(str(tmp_path / 'raw'), 40, 96, 128, seed=2)
    avi_dir = tmp_path / 'avi'
    avi_dir.mkdir()
    for name in ('metadata.json', 'depth_ts.txt'):
        (avi_dir / name).write_bytes((tmp_path / 'raw' / name).read_bytes())
    write_frames(str(avi_dir / 'depth.avi'), read_frames_raw(dat, frame_dims=(128, 96)))
    ours = Session(str(avi_dir / 'depth.avi')).find_roi(device='cuda')
    ref = Session(dat).find_roi(device='cuda')
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
