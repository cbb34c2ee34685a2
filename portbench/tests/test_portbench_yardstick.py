'''The yardstick's arithmetic against small cases worked by hand.'''
import math
from types import SimpleNamespace

import pytest
import torch

from portbench.yardstick import flops, readers
from portbench.yardstick.trace import reduce_events

TINY = {'image_size': 8, 'resnet_width': 1, 'resnet_depth': 50,
        'resnet_stage_blocks': [1, 1, 1, 1], 'fpn_channels': 2,
        'anchor_sizes': [[8], [16], [32], [64], [128]], 'anchor_aspect_ratios': [1.0],
        'box_pooler_resolution': 2, 'box_fc_dim': 3, 'num_classes': 1,
        'mask_pooler_resolution': 2, 'mask_conv_dims': [2], 'keypoint_pooler_resolution': 2,
        'keypoint_conv_dims': [2], 'num_keypoints': 1, 'test_detections_per_image': 1,
        'rpn_post_nms_topk_test': 2, 'roi_batch_size_per_image': 4,
        'roi_positive_fraction': 0.5}


def test_conv_macs():
    assert flops.conv_macs(3, 3, 2, 5) == 9 * 9 * 2 * 5


def test_backbone_by_hand():
    # canvas 8: stem 7x7 3->1 at 4x4; pool to 2x2; res2 (1->4, mid 1) at 2x2;
    # res3..5 (mid 2, 4, 8; out 8, 16, 32) at 1x1 (the sides halve and round up)
    stem = 16 * 49 * 3
    res2 = 4 * (1 * 4) + 4 * 1 * 1 + 4 * 9 * 1 + 4 * 1 * 4
    res3 = (4 * 8) + (4 * 2) + (9 * 4) + (2 * 8)
    res4 = (8 * 16) + (8 * 4) + (9 * 16) + (4 * 16)
    res5 = (16 * 32) + (16 * 8) + (9 * 64) + (8 * 32)
    fpn = 4 * (4 * 2 + 9 * 4) + (8 * 2 + 9 * 4) + (16 * 2 + 9 * 4) + (32 * 2 + 9 * 4)
    rpn = 4 * (9 * 4 + 2 + 8) + 4 * (9 * 4 + 2 + 8)
    assert flops.backbone_fpn_rpn_flops(TINY) == 2 * (stem + res2 + res3 + res4 + res5 + fpn + rpn)


def test_heads_by_hand():
    box = 2 * 2 * 2 * 3 + 3 * 3 + 3 * 2 + 3 * 4
    mask = 4 * 9 * 2 * 2 + 4 * 4 * 2 * 2 + 16 * 2 * 1
    kp = 4 * 9 * 2 * 2 + 4 * 16 * 2 * 1
    assert flops.head_flops(TINY, 5, 1, 1) == 2 * (5 * box + mask + kp)
    assert flops.inference_flops_per_image(TINY) == \
        flops.backbone_fpn_rpn_flops(TINY) + flops.head_flops(TINY, 2, 1, 1)
    assert flops.train_flops_per_image(TINY) == \
        3 * (flops.backbone_fpn_rpn_flops(TINY) + flops.head_flops(TINY, 4, 2, 2))


def test_roi_align_bytes_one_box():
    # a 16x16 box at (8, 8) on the canvas: level 2 (stride 4); 2 x 2 bins, 4 samples a
    # side at 2.5, 3.5, 4.5, 5.5 level px -> taps 2..6 in each axis: 5 x 5 pixels
    shapes = [(1, 3, 16, 16), (1, 3, 8, 8), (1, 3, 4, 4), (1, 3, 2, 2)]
    boxes = torch.tensor([[[8.0, 8.0, 24.0, 24.0]]])
    got = flops.roi_align_bytes(shapes, boxes, out=2, elem_bytes=2)
    assert got == 25 * 3 * 2 + 16 + 2 * 2 * 3 * 2


def test_roi_align_bytes_shared_taps_count_once():
    shapes = [(1, 1, 16, 16), (1, 1, 8, 8), (1, 1, 4, 4), (1, 1, 2, 2)]
    one = flops.roi_align_bytes(shapes, torch.tensor([[[8.0, 8.0, 24.0, 24.0]]]), 2, 1)
    two = flops.roi_align_bytes(shapes, torch.tensor([[[8.0, 8.0, 24.0, 24.0]] * 2]), 2, 1)
    assert two - one == 16 + 4                    # the second box's coordinates and output


def test_clean_bytes():
    assert flops.clean_bytes(10, 160) == 2 * 10 * 160 * 160


class Ev:
    def __init__(self, kind, start, dur, name):
        self.kind, self.start, self.dur, self.n = kind, start, dur, name

    def device_type(self):
        return 'DeviceType.' + self.kind

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def name(self):
        return self.n


def test_trace_union_and_gaps():
    events = [Ev('CUDA', 0, 100, 'k1'), Ev('CUDA', 50, 100, 'k2'), Ev('CUDA', 400, 100, 'k1'),
              Ev('CPU', 100, 400, 'outer'), Ev('CPU', 120, 50, 'aten::item')]
    t = reduce_events(events, window_s=1e-6)
    assert t.busy_s == pytest.approx(250e-9)
    assert t.device_s == {'k1': pytest.approx(200e-9), 'k2': pytest.approx(100e-9)}
    assert t.idle_by_host == {'aten::item': pytest.approx(250e-9)}
    assert t.kernel_seconds('k1') == (pytest.approx(200e-9), 2)
    assert t.breakdown()['device_ops'][0][0] == 'k1'


def test_readers_on_a_card_run():
    ctx = SimpleNamespace(kind='NVIDIA H100 80GB HBM3')
    trace = SimpleNamespace(busy_s=0.25, window_s=1.0,
                            kernel_seconds=lambda name: (0.001, 3))
    out = SimpleNamespace(trace=trace, observed={
        'frames': 1000, 'window_s': 2.0, 'model': TINY, 'roi_bytes': 3.35e12 * 0.0005,
        'nms_syncs': 30, 'batches': 3, 'chunk_s': [1.0, 3.0, 2.0], 'chunk_frames': 100})
    assert readers.idle_pct(ctx, out) == pytest.approx(75.0)
    assert readers.roofline_pct(ctx, out, 'roi', 'roi_bytes') == pytest.approx(50.0)
    assert readers.per(out, 'nms_syncs', 'batches') == 10
    assert readers.chunk_ms_per_frame(ctx, out) == pytest.approx(20.0)
    mfu = readers.inference_mfu(ctx, out)
    assert mfu == pytest.approx(100 * flops.inference_flops_per_image(TINY) * 500 / 989e12)
    assert readers.idle_pct(SimpleNamespace(kind='cpu'), out) is None
    assert math.isfinite(mfu)


def test_control_rounds_forward_and_backward():
    '''The float8 control: e4m3 on the values, e5m2 on their gradient, each
    with a per-tensor scale.'''
    from portbench.reference.detector import FP8_E5M2_MAX, FP8_MAX, fake_fp8
    x = torch.linspace(-3.0, 5.0, 101, requires_grad=True)
    grad = torch.linspace(1.0, -0.7, 101)
    y = fake_fp8(x)
    y.backward(grad)
    s_x, s_g = 5.0 / FP8_MAX, 1.0 / FP8_E5M2_MAX
    want_y = (x.detach() / s_x).to(torch.float8_e4m3fn).float() * s_x
    want_g = (grad / s_g).to(torch.float8_e5m2).float() * s_g
    assert torch.equal(y.detach(), want_y) and not torch.equal(want_y, x.detach())
    assert torch.equal(x.grad, want_g) and not torch.equal(want_g, grad)
