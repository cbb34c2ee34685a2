'''Port vs JAX package: weights mapping, backbone/FPN, RPN, ROI heads,
anchors, box codec, NMS, proposal selection, keypoint decode, mask paste and
the whole detection forward, on the CPU at small sizes.

Tolerances: the model runs in f32 on both sides; 1e-4 relative on feature
maps and head outputs covers f32 summation order (convolutions and GEMMs
accumulate in different orders in XLA and in PyTorch). Integer-valued or
index outputs (keep masks, top-k order) must match exactly.
'''
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moseq2_detectron_extract_tpu.models import heads as jheads
from moseq2_detectron_extract_tpu.models.anchors import generate_anchors as jax_anchors
from moseq2_detectron_extract_tpu.models.rcnn import MaskKeypointRCNN as JaxRCNN
from moseq2_detectron_extract_tpu.models.rpn import select_proposals as jax_select
from moseq2_detectron_extract_tpu.ops import boxes as jboxes
from moseq2_detectron_extract_tpu.ops.nms import batched_nms_keep_mask as jax_bnms
from moseq2_detectron_extract_tpu_torch.models import heads as theads
from moseq2_detectron_extract_tpu_torch.models.anchors import generate_anchors
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
from moseq2_detectron_extract_tpu_torch.models.rpn import select_proposals
from moseq2_detectron_extract_tpu_torch.models.weights import params_from_jax
from moseq2_detectron_extract_tpu_torch.ops import boxes as tboxes
from moseq2_detectron_extract_tpu_torch.ops.nms import batched_nms_keep_mask, stable_topk

from tests.test_torch_common import jax_init_params, port_config, tiny_jax_config

RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope='module')
def tiny():
    cfg = tiny_jax_config(test_score_thresh=0.0)
    params, flat = jax_init_params(cfg, seed=0)
    model = MaskKeypointRCNN(port_config(cfg))
    model.load_state_dict(params_from_jax(flat), strict=True)
    model.eval()
    return cfg, JaxRCNN(cfg), params, model, flat


def _images(rng, b, s):
    return rng.normal(0, 1, (b, s, s, 3)).astype('float32')


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64), rtol=rtol, atol=atol)


def test_params_from_jax_covers_every_parameter(tiny):
    _, _, _, model, flat = tiny
    state = params_from_jax(flat)
    assert set(state) == set(model.state_dict())
    assert len(state) == len(flat)


def test_backbone_and_fpn_features(tiny):
    cfg, jmodel, params, model, _ = tiny
    images = _images(np.random.default_rng(1), 2, cfg.image_size)
    ref = jmodel.apply(params, jnp.asarray(images), method=JaxRCNN._features)
    with torch.no_grad():
        ours = model.features(_nchw(images))
    assert len(ours) == len(ref) == 5
    for o, r in zip(ours, ref):
        _close(o.permute(0, 2, 3, 1).numpy(), r)


def test_rpn_head(tiny):
    cfg, jmodel, params, model, _ = tiny
    rng = np.random.default_rng(2)
    feats = [rng.normal(0, 1, (2, s, s, cfg.fpn_channels)).astype('float32')
             for s in (16, 8, 4, 2, 1)]
    ref_logits, ref_deltas = jmodel.apply(
        params, [jnp.asarray(f) for f in feats],
        method=lambda m, f: m.rpn_head(f))
    with torch.no_grad():
        logits, deltas = model.rpn_head([_nchw(f) for f in feats])
    for o, r in zip(logits, ref_logits):
        _close(o.numpy(), np.asarray(r).reshape(2, -1))
    for o, r in zip(deltas, ref_deltas):
        _close(o.numpy(), np.asarray(r).reshape(2, -1, 4))


@pytest.mark.parametrize('head', ['box', 'mask', 'keypoint'])
def test_roi_heads(tiny, head):
    cfg, jmodel, params, model, _ = tiny
    res = {'box': cfg.box_pooler_resolution, 'mask': cfg.mask_pooler_resolution,
           'keypoint': cfg.keypoint_pooler_resolution}[head]
    x = np.random.default_rng(3).normal(0, 1, (3, res, res, cfg.fpn_channels)) \
        .astype('float32')
    ref = jmodel.apply(params, jnp.asarray(x),
                       method=lambda m, v: getattr(m, f'{head}_head')(v))
    with torch.no_grad():
        ours = getattr(model, f'{head}_head')(torch.from_numpy(x))
    if head == 'box':
        _close(ours[0].numpy(), ref[0])
        _close(ours[1].numpy(), ref[1])
    else:
        assert tuple(ours.shape) == tuple(ref.shape)
        _close(ours.numpy(), ref)


def test_anchors():
    shapes = ((16, 16), (8, 8), (4, 4), (2, 2), (1, 1))
    args = (shapes, (4, 8, 16, 32, 64), ((8,), (16,), (32,), (64,), (128,)),
            (0.5, 1.0, 2.0))
    for o, r in zip(generate_anchors(*args), jax_anchors(*args)):
        np.testing.assert_array_equal(o, r)


def _random_boxes(rng, shape, lo=0, hi=60):
    c = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(1, 30, shape + (2,))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype('float32')


def test_box_codec_clip_and_iou():
    rng = np.random.default_rng(4)
    boxes = _random_boxes(rng, (2, 20))
    deltas = rng.normal(0, 1, (2, 20, 4)).astype('float32')
    deltas[0, 0, 2] = 9.0                       # past the scale clamp
    w = (10.0, 10.0, 5.0, 5.0)
    dec = tboxes.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(boxes), w)
    _close(dec.numpy(), jboxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(boxes), w),
           rtol=1e-6, atol=1e-4)
    sizes = np.array([[40.0, 50.0], [64.0, 30.0]], 'float32')
    clipped = tboxes.clip_boxes(dec, torch.from_numpy(sizes))
    for i in range(2):
        ref = jboxes.clip_boxes(jnp.asarray(dec[i].numpy()), (sizes[i, 0], sizes[i, 1]))
        np.testing.assert_array_equal(clipped[i].numpy(), np.asarray(ref))
    iou = tboxes.pairwise_iou(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[0]))
    _close(iou.numpy(), jboxes.pairwise_iou(jnp.asarray(boxes[0]), jnp.asarray(boxes[0])),
           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_batched_nms_with_ties_and_padding(seed):
    rng = np.random.default_rng(seed)
    boxes = _random_boxes(rng, (3, 48))
    scores = np.round(rng.uniform(0, 1, (3, 48)), 1).astype('float32')   # many ties
    levels = rng.integers(0, 3, (3, 48)).astype('int32')
    valid = rng.random((3, 48)) > 0.1
    boxes[0, 5] = boxes[0, 4]                   # identical boxes, tied scores
    scores[0, 5] = scores[0, 4]
    ours = batched_nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(levels), 0.5,
                                 valid=torch.from_numpy(valid))
    for i in range(3):
        ref = jax_bnms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                       jnp.asarray(levels[i]), 0.5, valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(ref))


def test_stable_topk_matches_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, -np.inf, 2.0, 3.0, -np.inf, 1.0]], 'float32')
    vals, idx = stable_topk(torch.from_numpy(x), 6)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


@pytest.mark.parametrize('cap', [None, 40])
def test_select_proposals(cap):
    rng = np.random.default_rng(5)
    shapes = ((8, 8), (4, 4), (2, 2))
    anchors = jax_anchors(shapes, (8, 16, 32), ((16,), (32,), (64,)), (0.5, 1.0, 2.0))
    b = 2
    logits = [np.round(rng.normal(0, 1, (b, a.shape[0])), 1).astype('float32')
              for a in anchors]                 # rounded: tied scores
    deltas = [rng.normal(0, 0.3, (b, a.shape[0], 4)).astype('float32') for a in anchors]
    sizes = np.array([[64.0, 64.0], [48.0, 60.0]], 'float32')
    ours = select_proposals([torch.from_numpy(a) for a in anchors],
                            [torch.from_numpy(l) for l in logits],
                            [torch.from_numpy(d) for d in deltas],
                            torch.from_numpy(sizes), 30, 20, 0.7, (1.0, 1.0, 1.0, 1.0),
                            global_cap=cap)
    for i in range(b):
        ref = jax_select([jnp.asarray(a) for a in anchors],
                         [jnp.asarray(l[i]) for l in logits],
                         [jnp.asarray(d[i]) for d in deltas],
                         (sizes[i, 0], sizes[i, 1]), 30, 20, 0.7, (1.0, 1.0, 1.0, 1.0),
                         global_cap=cap)
        np.testing.assert_array_equal(ours[2][i].numpy(), np.asarray(ref[2]))
        _close(ours[0][i].numpy(), ref[0], rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(ours[1][i].numpy(), np.asarray(ref[1]))


def test_heatmaps_to_keypoints():
    rng = np.random.default_rng(6)
    hm = rng.normal(0, 1, (3, 28, 28, 8)).astype('float32')
    hm[0, 3, 4, 0] = hm[0, 20, 1, 0] = 50.0      # tied maxima: the first wins
    boxes = _random_boxes(rng, (3,))
    ours = theads.heatmaps_to_keypoints(torch.from_numpy(hm), torch.from_numpy(boxes))
    ref = jheads.heatmaps_to_keypoints(jnp.asarray(hm), jnp.asarray(boxes))
    _close(ours.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_paste_masks():
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 3, (3, 28, 28)).astype('float32')
    boxes = np.array([[5.5, 8.0, 40.2, 30.0], [-3.0, 10.0, 20.0, 70.0],
                      [30.0, 30.0, 30.5, 31.0]], 'float32')
    ours = theads.paste_masks(torch.from_numpy(logits), torch.from_numpy(boxes), (64, 48))
    ref = np.asarray(jheads.paste_masks(jnp.asarray(logits), jnp.asarray(boxes), (64, 48)))
    # a pixel whose interpolated probability sits within f32 rounding of
    # the 0.5 threshold may flip; none does on this input
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_inference_matches_jax_model(tiny):
    '''The whole forward, each side pooling its own way: the JAX package's
    inference pooling (bf16 weights and T, off the TPU its separable form)
    and the port's plain ROIAlign, which rounds as it does
    (test_torch_roi_align).'''
    cfg, jmodel, params, model, _ = tiny
    images = _images(np.random.default_rng(8), 2, cfg.image_size)
    sizes = np.array([[64.0, 64.0], [56.0, 64.0]], 'float32')
    ref = jax.jit(lambda p, x, s: jmodel.apply(p, x, s, method=JaxRCNN.inference))(
        params, jnp.asarray(images), jnp.asarray(sizes))
    ours = model.inference(_nchw(images), torch.from_numpy(sizes))
    assert set(ours) == set(ref)
    np.testing.assert_array_equal(ours['valid'].numpy(), np.asarray(ref['valid']))
    for key in ('boxes', 'scores', 'keypoints', 'mask_probs', 'keypoint_heatmaps'):
        _close(ours[key].numpy(), ref[key], rtol=1e-3, atol=1e-3)
    # a mask pixel whose pasted probability lies within f32 rounding of the
    # 0.5 threshold may flip: at most 0.1% of the pixels
    flips = (ours['masks'].numpy() != np.asarray(ref['masks'])).sum()
    assert flips <= 1e-3 * ours['masks'].numel(), flips
