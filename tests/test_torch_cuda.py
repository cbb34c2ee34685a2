'''The port's CUDA kernels and its main path on the card.

These tests need a CUDA device and nvcc and skip without them; this file
imports neither JAX nor the JAX package, so it runs on the GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: ROIAlign kernel vs its plain version, 2 bf16 ulps (both
compute in f32 and round to bf16 once; sums run in another order); the
clean kernel is bit-exact.
'''
import numpy as np
import pytest
import torch

from moseq2_detectron_extract_tpu_torch.extract import process_chunk
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, roi_align_kernel
from moseq2_detectron_extract_tpu_torch.ops.roi_align import separable_batched_roi_align
from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk

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


def test_cuda_process_chunk_matches_cpu(cuda_device):
    '''A small random f32 model: the card (kernels) against the CPU (plain
    versions) through the whole slice.'''
    torch.manual_seed(0)
    cfg = ModelConfig(image_size=64, min_size_test=64, max_size_test=64,
                      resnet_stage_blocks=(1, 1, 1, 1), resnet_width=16,
                      fpn_channels=32, box_fc_dim=32, mask_conv_dims=(32,),
                      keypoint_conv_dims=(32,), rpn_pre_nms_topk_test=32,
                      rpn_post_nms_topk_test=8, test_detections_per_image=1,
                      amp_dtype='float32')
    state = MaskKeypointRCNN(cfg).state_dict()
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
