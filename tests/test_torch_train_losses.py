'''Port vs JAX package: the loss side of training, on the CPU.

The tiny model of ``test_torch_common`` (one block per stage, width 16,
FPN 64, f32), with the JAX package's own random draws handed to the port
(``tests/jax_draws.py``). Tolerances:

* box encoding within an f32 ulp (1e-6); the matcher (labels, matched indices, the forced positives
  of exact IoU ties on grid anchors), the sampling, ``keypoint_targets``,
  the train proposals' validity and the sampled ROIs: equal; the proposals'
  coordinates to rtol 1e-5 (they decode deltas of f32 convolutions);
* ``crop_resize_mask`` 1e-6; the gather ROIAlign 1e-5 and its feature
  gradient 1e-5 absolute and relative (the scatter sums up to hundreds of
  taps into one feature, in another order);
* every loss term rtol 1e-4; each parameter's gradient: max abs difference
  over max abs value <= 1e-4 (convolutions and GEMMs sum in another order);
* three optimizer steps, one with an inf and a NaN in its gradient: the
  parameters to 1e-5;
* bf16 compute (``amp_dtype: bfloat16``): the total loss within rtol 1e-2
  of the JAX package's bf16 losses and every term within 6e-2 (measured on
  this model, two seeds: total 2.1e-3, the RPN, mask and keypoint terms at
  most 1.3e-3, ``loss_cls`` 1.9e-2 and ``loss_box_reg`` 3.9e-2: bf16 rounds
  the convolutions' inputs to 8 bits of mantissa at other points of the
  graph in XLA and in PyTorch, which moves the proposals and so the few
  positive ROIs the box terms average over).

The JAX losses, gradients and train steps are computed once per module;
the file takes about 35 s on the CPU.
'''
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from moseq2_detectron_extract_tpu.models import heads as jheads
from moseq2_detectron_extract_tpu.models import matcher as jmatcher
from moseq2_detectron_extract_tpu.models.rcnn import MaskKeypointRCNN as JaxRCNN
from moseq2_detectron_extract_tpu.models import rpn as jrpn
from moseq2_detectron_extract_tpu.models import train as jtrain
from moseq2_detectron_extract_tpu.ops import boxes as jboxes
from moseq2_detectron_extract_tpu.ops import roi_align as jroi
from moseq2_detectron_extract_tpu_torch.models import heads, matcher, rpn
from moseq2_detectron_extract_tpu_torch.models.anchors import generate_anchors
from moseq2_detectron_extract_tpu_torch.models.rcnn import (MaskKeypointRCNN,
                                                            draw_loss_uniforms,
                                                            level_shapes)
from moseq2_detectron_extract_tpu_torch.models.train import (TrainState, apply_gradients,
                                                             lr_schedule, make_optimizer,
                                                             make_train_step)
from moseq2_detectron_extract_tpu_torch.models.weights import params_from_jax
from moseq2_detectron_extract_tpu_torch.ops import boxes, roi_align

from tests.jax_draws import loss_draws, subsample_uniforms
from tests.test_torch_common import (flatten_params, jax_init_params, port_config,
                                     tiny_jax_config)

LOSS_KEYS = ('loss_rpn_cls', 'loss_rpn_loc', 'loss_cls', 'loss_box_reg', 'loss_mask',
             'loss_keypoint', 'total_loss')
HEAD_KEYS = ('loss_cls', 'loss_box_reg', 'loss_mask', 'loss_keypoint')


def train_config(**overrides):
    '''The tiny model with a train-time proposal budget its 64 px canvas
    holds (1,023 anchors), and a solver whose LR and clip act at once.'''
    base = dict(rpn_pre_nms_topk_train=200, rpn_post_nms_topk_train=64,
                roi_batch_size_per_image=32, max_gt_instances=2, base_lr=0.02,
                warmup_iters=2, warmup_factor=0.5, grad_clip_norm=1.0)
    base.update(overrides)
    return tiny_jax_config(**base)


def make_batch(cfg, b: int = 2, seed: int = 0):
    '''Normalized images (B, S, S, 3) and the gt of ``losses``: two mice in
    image 0, one (and a padding row) in image 1.'''
    rng = np.random.default_rng(seed)
    s, g, k = cfg.image_size, cfg.max_gt_instances, cfg.num_keypoints
    images = rng.normal(0, 1, (b, s, s, 3)).astype('float32')
    masks = np.zeros((b, g, s, s), bool)
    boxes_ = np.zeros((b, g, 4), 'float32')
    kpts = np.zeros((b, g, k, 3), 'float32')
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(g if i == 0 else 1):
            x1, y1 = rng.integers(2, s // 2, 2)
            x2, y2 = x1 + rng.integers(12, s // 2), y1 + rng.integers(8, s // 3)
            masks[i, j, y1:y2, x1:x2] = True
            masks[i, j, y1, x1] = False
            boxes_[i, j] = (x1, y1, x2, y2)
            kpts[i, j, :, 0] = np.linspace(x1 + 1, x2 - 1, k)
            kpts[i, j, :, 1] = (y1 + y2) / 2 + rng.uniform(-2, 2, k)
            kpts[i, j, :, 2] = 2.0
            kpts[i, j, rng.integers(0, k), 2] = 0.0
            valid[i, j] = True
    gt = {'boxes': boxes_, 'valid': valid, 'masks': masks, 'keypoints': kpts}
    return images, gt


def _torch_gt(gt):
    return {k: torch.from_numpy(v) for k, v in gt.items()}


def _nchw(images):
    return torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))


def n_anchors(cfg):
    per_cell = len(cfg.anchor_sizes[0]) * len(cfg.anchor_aspect_ratios)
    return sum(s * s * per_cell for s in level_shapes(cfg.image_size))


def port_draws(cfg, rng, b):
    return loss_draws(rng, b, n_anchors(cfg), cfg.rpn_post_nms_topk_train +
                      cfg.max_gt_instances)


def port_model(cfg, flat):
    model = MaskKeypointRCNN(port_config(cfg))
    model.load_state_dict(params_from_jax(flat), strict=True)
    return model


def _close(ours, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


def grad_ratio(ours, ref) -> float:
    '''max |ours - ref| / max |ref| of one tensor.'''
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(ours, np.float64) - ref).max() / max(np.abs(ref).max(),
                                                                        1e-30))


@pytest.fixture(scope='module')
def ref():
    '''The JAX losses and gradients of one batch, the train proposals, and
    three JAX optimizer steps (the second with an inf and a NaN).'''
    cfg = train_config()
    params, flat = jax_init_params(cfg, seed=0)
    images, gt = make_batch(cfg)
    jmodel = JaxRCNN(cfg)
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}
    rng = jax.random.PRNGKey(7)

    def loss_fn(p, key):
        losses = jmodel.apply(p, jnp.asarray(images), jgt, key, method=JaxRCNN.losses)
        return losses['total_loss'], losses
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, losses), grads = value_and_grad(params, rng)

    def props(m, x):
        feats = m._features(x)
        sizes = jnp.tile(jnp.asarray([[cfg.image_size] * 2], jnp.float32), (x.shape[0], 1))
        boxes_, _, valid, _ = m._proposals(feats, sizes, train=True)
        return boxes_, valid
    proposals, prop_valid = jax.jit(lambda p, x: jmodel.apply(p, x, method=props))(
        params, jnp.asarray(images))

    # three optimizer steps as make_train_step composes them (value_and_grad,
    # tx.update, apply_updates), the second with an inf and a NaN
    step_keys = jax.random.split(jax.random.PRNGKey(11), 3)
    tx = jtrain.make_optimizer(cfg, params)
    update = jax.jit(tx.update)
    p, opt_state = params, tx.init(params)
    for i, key in enumerate(step_keys):
        _, g = value_and_grad(p, key)
        if i == 1:
            g = jax.tree_util.tree_map(np.array, g)
            g['params']['box_head']['fc2']['bias'][3] = np.inf
            g['params']['rpn_head']['conv']['bias'][5] = np.nan
        updates, opt_state = update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
    state = jtrain.TrainState(step=3, params=p, opt_state=opt_state)
    stepped = flatten_params(jax.tree_util.tree_map(np.asarray, state.params))
    return {'cfg': cfg, 'params': params, 'flat': flat, 'images': images, 'gt': gt,
            'rng': rng, 'losses': {k: float(v) for k, v in losses.items()},
            'grads': flatten_params(jax.tree_util.tree_map(np.asarray, grads)),
            'proposals': np.asarray(proposals), 'prop_valid': np.asarray(prop_valid),
            'step_keys': step_keys, 'stepped': stepped}


# -- boxes, matcher, sampling -------------------------------------------------------

def test_encode_boxes_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 50, (64, 4)).astype('float32')
    src[:, 2:] += src[:, :2] + rng.uniform(0, 30, (64, 2)).astype('float32')
    tgt = rng.uniform(0, 50, (64, 4)).astype('float32')
    tgt[:, 2:] += tgt[:, :2] + rng.uniform(0, 30, (64, 2)).astype('float32')
    src[0, 2] = src[0, 0]                                   # an empty box: eps
    w = (10.0, 10.0, 5.0, 5.0)
    ours = boxes.encode_boxes(torch.from_numpy(src), torch.from_numpy(tgt), w)
    # within an f32 ulp: XLA's CPU code rounds a few quotients the other way
    np.testing.assert_allclose(ours.numpy(), np.asarray(jboxes.encode_boxes(src, tgt, w)),
                               rtol=1e-6, atol=1e-6)
    back = boxes.decode_boxes(ours, torch.from_numpy(src), w)
    np.testing.assert_allclose(back.numpy()[1:], tgt[1:], rtol=1e-4, atol=1e-3)


def test_matcher_forces_the_same_tied_positives():
    '''Integer gt boxes against grid anchors tie exactly at the best IoU;
    the forced set (``iou == per_gt_best``) must be the same.'''
    anchors = np.concatenate(generate_anchors(((16, 16), (8, 8)), (4, 8), ((32,), (64,)),
                                              (0.5, 1.0, 2.0)))
    gt = np.array([[[8, 8, 40, 24], [16, 16, 48, 48], [0, 0, 0, 0]],
                   [[4, 20, 36, 36], [0, 0, 0, 0], [0, 0, 0, 0]]], 'float32')
    valid = np.array([[True, True, False], [True, False, False]])
    idx, labels = matcher.match_anchors_to_gt(torch.from_numpy(anchors),
                                              torch.from_numpy(gt), torch.from_numpy(valid),
                                              0.7, 0.3, allow_low_quality=True)
    forced_total = 0
    for i in range(2):
        ref_idx, ref_labels = jmatcher.match_anchors_to_gt(anchors, gt[i], valid[i],
                                                           0.7, 0.3, True)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(ref_labels))
        iou = np.asarray(jboxes.pairwise_iou(anchors, gt[i]))[:, valid[i]]
        best = iou.max(axis=0)
        ties = (iou == best).sum(axis=0)
        forced_total += int((iou == best).any(axis=1).sum())
        assert ties.max() >= 2, 'no exact tie exercised'
    assert forced_total > 2
    # no valid gt: everything background
    _, none = matcher.match_anchors_to_gt(torch.from_numpy(anchors),
                                          torch.zeros((1, 2, 4)), torch.zeros((1, 2), dtype=bool),
                                          0.7, 0.3, True)
    assert (none == 0).all()


@pytest.mark.parametrize('num,frac', [(64, 0.25), (256, 0.5)])
def test_subsample_labels_with_jax_draws(num, frac):
    rng = np.random.default_rng(num)
    labels = rng.choice([-1, 0, 1], size=(3, 500), p=[0.3, 0.6, 0.1]).astype('int32')
    labels[2, :] = np.where(labels[2] == 1, 0, labels[2])          # no positives
    keys = jax.random.split(jax.random.PRNGKey(num), 3)
    draws = [subsample_uniforms(k, 500) for k in keys]
    ours = matcher.subsample_labels(torch.from_numpy(labels), num, frac,
                                    torch.from_numpy(np.stack([d[0] for d in draws])),
                                    torch.from_numpy(np.stack([d[1] for d in draws])))
    for i in range(3):
        ref = jmatcher.subsample_labels(jnp.asarray(labels[i]), num, frac, keys[i])
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o[i].numpy(), np.asarray(r))


def test_rpn_losses_match_jax():
    cfg = train_config()
    rng = np.random.default_rng(3)
    anchors = np.concatenate(generate_anchors(tuple((s, s) for s in level_shapes(64)),
                                              (4, 8, 16, 32, 64), cfg.anchor_sizes,
                                              cfg.anchor_aspect_ratios))
    a = anchors.shape[0]
    logits = rng.normal(0, 2, (2, a)).astype('float32')
    deltas = rng.normal(0, 0.5, (2, a, 4)).astype('float32')
    _, gt = make_batch(cfg)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    draws = [subsample_uniforms(k, a) for k in keys]
    obj, reg = rpn.rpn_losses(torch.from_numpy(anchors), torch.from_numpy(logits),
                              torch.from_numpy(deltas), torch.from_numpy(gt['boxes']),
                              torch.from_numpy(gt['valid']),
                              tuple(torch.from_numpy(np.stack([d[j] for d in draws]))
                                    for j in range(2)),
                              256, 0.5, 0.7, 0.3, (1.0, 1.0, 1.0, 1.0), 0.0)
    for i in range(2):
        r_obj, r_reg = jrpn.rpn_losses(anchors, logits[i], deltas[i], gt['boxes'][i],
                                       gt['valid'][i], keys[i], 256, 0.5, 0.7, 0.3,
                                       (1.0, 1.0, 1.0, 1.0), 0.0)
        _close(obj[i].item(), r_obj, 1e-6)
        _close(reg[i].item(), r_reg, 1e-6)
    # smooth L1 with a beta, and BCE, elementwise
    x = rng.normal(0, 2, 1000).astype('float32')
    t = (rng.uniform(size=1000) > 0.5).astype('float32')
    np.testing.assert_allclose(rpn._smooth_l1(torch.from_numpy(x), 0.5).numpy(),
                               np.asarray(jrpn._smooth_l1(x, 0.5)), rtol=1e-7)
    np.testing.assert_allclose(rpn._bce_with_logits(torch.from_numpy(x),
                                                    torch.from_numpy(t)).numpy(),
                               np.asarray(jrpn._bce_with_logits(x, t)), rtol=1e-6)


def test_keypoint_targets_equal():
    rng = np.random.default_rng(4)
    bx = rng.uniform(0, 40, (50, 4)).astype('float32')
    bx[:, 2:] = bx[:, :2] + rng.uniform(0, 30, (50, 2)).astype('float32')
    bx[0, 2] = bx[0, 0]
    kp = rng.uniform(-5, 75, (50, 8, 3)).astype('float32')
    kp[..., 2] = rng.integers(0, 3, (50, 8))
    idx, valid = heads.keypoint_targets(torch.from_numpy(kp), torch.from_numpy(bx), 56)
    r_idx, r_valid = jheads.keypoint_targets(kp, bx, 56)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    assert valid.any() and not valid.all()


# -- ROIAlign (gather form) and the mask targets -----------------------------------

def test_crop_resize_mask_matches_jax():
    rng = np.random.default_rng(6)
    masks = rng.uniform(size=(2, 3, 40, 52)) > 0.5
    bx = rng.uniform(-4, 50, (2, 5, 4)).astype('float32')
    bx[..., 2:] = bx[..., :2] + rng.uniform(0, 20, (2, 5, 2)).astype('float32')
    gi = rng.integers(0, 3, (2, 5))
    ours = roi_align.crop_resize_masks(torch.from_numpy(masks), torch.from_numpy(gi),
                                       torch.from_numpy(bx), 28).numpy()
    for i in range(2):
        for j in range(5):
            ref = jroi.crop_resize_mask(jnp.asarray(masks[i, gi[i, j]]), bx[i, j], 28)
            np.testing.assert_allclose(ours[i, j], np.asarray(ref), atol=1e-6)
    one = roi_align.crop_resize_mask(torch.from_numpy(masks[0, 0]), torch.from_numpy(bx[0, 0]),
                                     14)
    np.testing.assert_allclose(one.numpy(), np.asarray(jroi.crop_resize_mask(
        jnp.asarray(masks[0, 0]), bx[0, 0], 14)), atol=1e-6)


@pytest.mark.parametrize('out,k,chunk', [(7, 40, 16), (14, 9, 128)])
def test_gather_roi_align_and_its_gradient_match_jax(out, k, chunk):
    rng = np.random.default_rng(out)
    feats = [rng.normal(0, 1, (2, s, s, 8)).astype('float32') for s in (16, 8, 4, 2)]
    cx, cy = rng.uniform(-8, 72, (2, 2, k))
    wh = rng.uniform(1, 90, (2, 2, k))
    bx = np.stack([cx - wh[0] / 2, cy - wh[1] / 2, cx + wh[0] / 2, cy + wh[1] / 2],
                  -1).astype('float32')
    g = rng.normal(0, 1, (2, k, out, out, 8)).astype('float32')
    ref, vjp = jax.vjp(lambda *f: jroi.batched_multilevel_roi_align(
        tuple(f), jnp.asarray(bx), out, chunk=chunk), *[jnp.asarray(f) for f in feats])
    ref_grads = vjp(jnp.asarray(g))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    ours = roi_align.batched_multilevel_roi_align(tf, torch.from_numpy(bx), out, chunk=chunk)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5)
    ours.backward(torch.from_numpy(g))
    for t, r in zip(tf, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    # the single-image form
    one = roi_align.multilevel_roi_align([torch.from_numpy(f[0]) for f in feats],
                                         torch.from_numpy(bx[0]), out)
    np.testing.assert_allclose(one.numpy(), np.asarray(jroi.multilevel_roi_align(
        tuple(jnp.asarray(f[0]) for f in feats), jnp.asarray(bx[0]), out)), atol=1e-5)


# -- the model's losses ------------------------------------------------------------

def test_train_proposals_equal(ref):
    cfg = ref['cfg']
    model = port_model(cfg, ref['flat'])
    b = ref['images'].shape[0]
    with torch.no_grad():
        feats = model.features(_nchw(ref['images']))
        props, valid, _ = model.proposals(
            feats, torch.full((b, 2), float(cfg.image_size)), train=True)
    np.testing.assert_array_equal(valid.numpy(), ref['prop_valid'])
    np.testing.assert_allclose(props.numpy(), ref['proposals'], rtol=1e-5, atol=1e-4)


def _jax_samples(cfg, proposals, prop_valid, gt, rng, b):
    '''The JAX package's per-image ROI sampling (``rcnn.py:283-302``).'''
    rng, _ = jax.random.split(rng)
    rng, roi_rng = jax.random.split(rng)
    keys = jax.random.split(roi_rng, b)
    out = []
    for i in range(b):
        props = jnp.concatenate([proposals[i], gt['boxes'][i]])
        pvalid = jnp.concatenate([prop_valid[i], gt['valid'][i]])
        iou = jboxes.pairwise_iou(props, gt['boxes'][i])
        iou = jnp.where(gt['valid'][i][None, :], iou, -1.0)
        iou = jnp.where(pvalid[:, None], iou, -1.0)
        labels = jnp.where(jnp.max(iou, axis=1) >= cfg.roi_fg_iou_thresh, 1, 0)
        labels = jnp.where(pvalid, labels, -1)
        idx, valid, is_pos = jmatcher.subsample_labels(
            labels, cfg.roi_batch_size_per_image, cfg.roi_positive_fraction, keys[i])
        out.append((np.asarray(idx), np.asarray(valid), np.asarray(is_pos)))
    return out


def test_roi_head_losses_on_jax_proposals(ref):
    cfg = ref['cfg']
    model = port_model(cfg, ref['flat'])
    b = ref['images'].shape[0]
    draws = port_draws(cfg, ref['rng'], b)
    gt = _torch_gt(ref['gt'])
    props = torch.from_numpy(ref['proposals'])
    pvalid = torch.from_numpy(ref['prop_valid'])
    with torch.no_grad():
        feats = model.features(_nchw(ref['images']))
        heads_out = model.roi_head_part(feats, props, pvalid, gt, draws['roi'])
        s_boxes, s_valid, s_pos, _ = model.sample_rois(props, pvalid, gt, draws['roi'])
    jax_samples = _jax_samples(cfg, ref['proposals'], ref['prop_valid'], ref['gt'],
                               ref['rng'], b)
    all_props = np.concatenate([ref['proposals'], ref['gt']['boxes']], axis=1)
    differing = 0
    for i, (idx, valid, is_pos) in enumerate(jax_samples):
        differing += int((np.abs(s_boxes[i].numpy() - all_props[i][idx]).max(axis=1) > 0).sum())
        np.testing.assert_array_equal(s_valid[i].numpy(), valid)
        np.testing.assert_array_equal(s_pos[i].numpy(), is_pos)
    assert differing == 0, f'{differing} sampled ROIs differ'
    assert s_pos.any()
    for key in HEAD_KEYS:
        _close(heads_out[key].item(), ref['losses'][key], 1e-4)


def test_whole_losses_match_jax(ref):
    cfg = ref['cfg']
    model = port_model(cfg, ref['flat'])
    b = ref['images'].shape[0]
    draws = port_draws(cfg, ref['rng'], b)
    with torch.no_grad():
        losses = model.losses(_nchw(ref['images']), _torch_gt(ref['gt']), draws)
    assert tuple(losses) == LOSS_KEYS
    for key in LOSS_KEYS:
        assert ref['losses'][key] > 0, key
        _close(losses[key].item(), ref['losses'][key], 1e-4)


def test_gradients_match_jax(ref):
    cfg = ref['cfg']
    model = port_model(cfg, ref['flat'])
    b = ref['images'].shape[0]
    draws = port_draws(cfg, ref['rng'], b)
    model.losses(_nchw(ref['images']), _torch_gt(ref['gt']), draws)['total_loss'].backward()
    ref_grads = params_from_jax(ref['grads'])
    named = dict(model.named_parameters())
    assert set(named) <= set(ref_grads)
    # the heatmap deconv's bias moves every bin of a keypoint's softmax alike,
    # so its exact gradient is 0: both sides hold rounding noise there
    shift_invariant = 'keypoint_head.score_lowres.bias'
    top = max(float(g.abs().max()) for g in ref_grads.values())
    assert float(named.pop(shift_invariant).grad.abs().max()) < 1e-5 * top
    assert float(ref_grads[shift_invariant].abs().max()) < 1e-5 * top
    worst = {name: grad_ratio(p.grad.numpy(), ref_grads[name].numpy())
             for name, p in named.items()}
    assert max(worst.values()) <= 1e-4, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    # the FrozenBN statistics are buffers, not parameters: nothing updates them
    assert not any('running' in n or 'stem_norm' in n for n in named)


def test_three_optimizer_steps_match_jax(ref):
    cfg = ref['cfg']
    pcfg = port_config(cfg)
    b = ref['images'].shape[0]
    model = port_model(cfg, ref['flat'])
    state = TrainState(step=0, model=model, optimizer=make_optimizer(pcfg, model))
    batch = {'images': _nchw(ref['images']), 'gt': _torch_gt(ref['gt'])}
    keys = ref['step_keys']
    step = make_train_step(pcfg)
    state, metrics = step(state, batch, port_draws(cfg, keys[0], b))
    assert metrics['lr'] == lr_schedule(pcfg)(0)
    model.losses(batch['images'], batch['gt'], port_draws(cfg, keys[1], b))['total_loss'] \
        .backward()
    model.box_head.fc2.bias.grad[3] = torch.inf
    model.rpn_head.conv.bias.grad[5] = torch.nan
    apply_gradients(state, pcfg)
    state, _ = step(state, batch, port_draws(cfg, keys[2], b))
    assert state.step == 3
    expected = params_from_jax(ref['stepped'])
    moved = 0.0
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), name
        np.testing.assert_allclose(p.detach().numpy(), expected[name].numpy(), atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float((expected[name] - params_from_jax(ref['flat'])[name])
                                 .abs().max()))
    assert moved > 1e-3           # the steps moved the weights well past the tolerance
    for name, buf in model.named_buffers():
        np.testing.assert_array_equal(buf.numpy(), expected[name].numpy())


def test_lr_schedule_at_its_boundaries():
    cfg = train_config(base_lr=0.01, warmup_iters=4, warmup_factor=0.001, lr_steps=(6, 9),
                       lr_gamma=0.1)
    ours = lr_schedule(port_config(cfg))
    ref = jtrain.lr_schedule(cfg)
    for step in range(12):
        assert np.float32(ours(step)) == np.float32(ref(jnp.asarray(step))), step
    assert ours(5) == np.float32(0.01) and ours(9) < ours(8) < ours(5)


def test_bf16_losses_match_jax_within_the_stated_tolerance():
    cfg = train_config(amp_dtype='bfloat16')
    params, flat = jax_init_params(cfg, seed=1)
    images, gt = make_batch(cfg, seed=1)
    rng = jax.random.PRNGKey(2)
    ref = jax.jit(lambda p: JaxRCNN(cfg).apply(p, jnp.asarray(images),
                                               {k: jnp.asarray(v) for k, v in gt.items()},
                                               rng, method=JaxRCNN.losses))(params)
    model = port_model(cfg, flat)
    with torch.no_grad():
        ours = model.losses(_nchw(images), _torch_gt(gt), port_draws(cfg, rng, 2))
    for key in LOSS_KEYS:
        _close(ours[key].item(), float(ref[key]), 1e-2 if key == 'total_loss' else 6e-2)


def test_draw_loss_uniforms_shapes():
    cfg = port_config(train_config())
    draws = draw_loss_uniforms(torch.Generator().manual_seed(0), cfg, 3, 'cpu')
    assert draws['rpn'][0].shape == (3, n_anchors(train_config())) == (3, 1023)
    assert draws['roi'][1].shape == (3, cfg.rpn_post_nms_topk_train + cfg.max_gt_instances)
    for u in (*draws['rpn'], *draws['roi']):
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
