'''The port's trainer and ``train`` command on the CPU, and the npz that
both packages read.

* ``cli.main(['train', ..., '--device', 'cpu', '--max-iter', '4'])`` on a
  tiny export writes ``config.yaml``, ``metrics.jsonl`` (the JAX
  ``MetricsWriter``'s row keys), the checkpoints and ``last_checkpoint``;
  a resumed ``Trainer`` holds the step, the weights and the momentum
  buffers of the checkpoint exactly, and ``--resume`` continues the count.
* ``save_params_npz`` read by the JAX ``load_params_npz``: the keys and
  values of ``params_to_jax``; ``params_to_jax(params_from_jax(p)) == p``.
* The JAX ``MaskKeypointRCNN.inference`` on the port-written npz against
  the port's model on the same weights and images, at
  ``test_torch_model``'s tolerances (1e-3; masks: at most 0.1% of the
  pixels flip), and the JAX ``Predictor`` on the trained model dir's npz
  against the port's at ``test_torch_slice``'s (scores 2e-3, boxes and
  keypoints 0.5 px; detections whose scores tie within 2e-3 lined up), and
  the port's on the npz equal to its own on the checkpoint's weights
  rounded to f16.
* flax's default init: each layer's weight std within 10% of
  lecun_normal's.
* ``zero_nonfinite`` equal to the JAX optax transformation, in place, and
  reached by ``apply_gradients``.
'''
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moseq2_detectron_extract_tpu.models.checkpoint import load_params_npz as jax_load_npz
from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
from moseq2_detectron_extract_tpu.models.predictor import Predictor as JaxPredictor
from moseq2_detectron_extract_tpu.models.rcnn import MaskKeypointRCNN as JaxRCNN
from moseq2_detectron_extract_tpu_torch import cli
from moseq2_detectron_extract_tpu_torch.io.annot import read_annotations
from moseq2_detectron_extract_tpu_torch.models.checkpoint import (get_checkpoint,
                                                                  load_checkpoint,
                                                                  load_model_dir)
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
from moseq2_detectron_extract_tpu_torch.models.train import create_train_state
from moseq2_detectron_extract_tpu_torch.models.trainer import Trainer
from moseq2_detectron_extract_tpu_torch.models.weights import (params_from_jax,
                                                               params_to_jax,
                                                               save_params_npz)
from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names
from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views

from tests.test_torch_common import flatten_params, jax_init_params, tiny_jax_config

TRAIN_ROW_KEYS = {'step', 'loss_rpn_cls', 'loss_rpn_loc', 'loss_cls', 'loss_box_reg',
                  'loss_mask', 'loss_keypoint', 'total_loss', 'lr', 'iters_per_sec'}


def tiny_train_config(**overrides) -> ModelConfig:
    base = dict(image_size=64, min_size_train=60, max_size_train=64, min_size_test=60,
                max_size_test=64, resnet_stage_blocks=(1, 1, 1, 1), resnet_width=16,
                fpn_channels=32, box_fc_dim=32, mask_conv_dims=(32,),
                keypoint_conv_dims=(32,), rpn_pre_nms_topk_train=128,
                rpn_post_nms_topk_train=64, roi_batch_size_per_image=32, ims_per_batch=2,
                max_gt_instances=1, amp_dtype='float32', warmup_iters=2, eval_period=2,
                checkpoint_period=3, base_lr=0.01, test_score_thresh=0.0)
    base.update(overrides)
    return ModelConfig(**base)


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    '''The train command, 4 steps on the CPU, on a 12-view export.'''
    tmp = tmp_path_factory.mktemp('train')
    export = write_annotated_views(str(tmp / 'data'), 12, size=64, seed=0)
    cfg_path = str(tmp / 'cfg.yaml')
    tiny_train_config().to_yaml(cfg_path)
    model_dir = str(tmp / 'model')
    assert cli.main(['train', export, '--model-dir', model_dir, '--config', cfg_path,
                     '--max-iter', '4', '--device', 'cpu', '--log-period', '1']) == 0
    return {'tmp': tmp, 'export': export, 'cfg_path': cfg_path, 'model_dir': model_dir}


def _rows(model_dir):
    with open(os.path.join(model_dir, 'metrics.jsonl'), encoding='utf-8') as fh:
        return [json.loads(line) for line in fh]


def test_train_command_writes_the_model_dir(trained):
    model_dir = trained['model_dir']
    assert sorted(os.listdir(model_dir)) == ['checkpoints', 'config.yaml', 'last_checkpoint',
                                             'metrics.jsonl']
    assert sorted(os.listdir(os.path.join(model_dir, 'checkpoints'))) == \
        ['model_0000003.pt', 'model_0000004.pt']
    with open(os.path.join(model_dir, 'last_checkpoint'), encoding='utf-8') as fh:
        assert fh.read() == 'model_0000004.pt'
    cfg = ModelConfig.from_yaml(os.path.join(model_dir, 'config.yaml'))
    assert cfg == tiny_train_config(max_iter=4)
    assert JaxModelConfig.from_yaml(os.path.join(model_dir, 'config.yaml')).max_iter == 4
    rows = _rows(model_dir)
    train_rows = [r for r in rows if 'total_loss' in r]
    val_rows = [r for r in rows if 'validation_loss' in r]
    assert [r['step'] for r in train_rows] == [1, 2, 3, 4]
    assert all(set(r) == TRAIN_ROW_KEYS for r in train_rows)      # no CUDA: no memory keys
    assert [sorted(r) for r in val_rows] == [['step', 'validation_loss']] * 2
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert train_rows[0]['lr'] == pytest.approx(0.01 * (0.001 + 0.999 * 0 / 2))
    assert train_rows[2]['lr'] == pytest.approx(0.01)


def test_resume_restores_step_weights_and_momentum(trained):
    model_dir = trained['model_dir']
    ckpt = load_checkpoint(get_checkpoint(model_dir))
    assert ckpt['step'] == 4
    items = read_annotations(trained['export'], default_keypoint_names)
    trainer = Trainer(tiny_train_config(max_iter=4), model_dir, train_items=items,
                      test_items=[], device='cpu')
    trainer.resume_or_load(resume=True)
    assert trainer.state.step == 4
    for name, value in trainer.state.model.state_dict().items():
        assert torch.equal(value, ckpt['model'][name]), name
    opt = trainer.state.optimizer.state_dict()
    buffers = [s['momentum_buffer'] for s in opt['state'].values()]
    assert len(buffers) == len(list(trainer.state.model.parameters()))
    for ours, saved in zip(buffers, [s['momentum_buffer']
                                     for s in ckpt['optimizer']['state'].values()]):
        assert torch.equal(ours, saved)
    assert any(float(b.abs().max()) > 0 for b in buffers)
    # the command continues the count from the checkpoint
    resumed = str(trained['tmp'] / 'resumed')
    shutil.copytree(model_dir, resumed)
    cli.main(['train', trained['export'], '--model-dir', resumed, '--config',
              trained['cfg_path'], '--max-iter', '6', '--resume', '--device', 'cpu',
              '--log-period', '1'])
    steps = [r['step'] for r in _rows(resumed) if 'total_loss' in r]
    assert steps == [1, 2, 3, 4, 5, 6]
    assert load_model_dir(resumed)[2] == 6


def test_train_command_options_that_raise(trained, tmp_path):
    # --init-weights is ported (tests/test_torch_convert.py): a file that is
    # not a Detectron2 checkpoint raises
    with pytest.raises(pickle.UnpicklingError):
        cli.main(['train', trained['export'], '--model-dir', str(tmp_path / 'm'),
                  '--init-weights', trained['export'], '--device', 'cpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            cli.main(['train', trained['export'], '--model-dir', str(tmp_path / 'm')])


# two keypoint logits this close are a tie: the packages' logits agree to
# about 6e-3 here (at most 5.97e-3 over 9 runs of this test), so a bin the
# argmax may take in one package and not the other is within twice that
KEYPOINT_TIE = 1.2e-2


def _jax_keypoint_heatmaps(jpred, frames: np.ndarray) -> np.ndarray:
    '''(B, D, S, S, K) keypoint logits of the JAX Predictor's model on
    ``frames``, prepared as its ``_step_impl`` prepares them.'''
    cfg = jpred.cfg
    _, new_h, new_w = jpred._test_geometry(frames.shape[1:])
    x = jax.image.resize(jnp.asarray(frames, jnp.float32), (len(frames), new_h, new_w),
                         method='bilinear')
    x = jnp.pad(x, ((0, 0), (0, cfg.image_size - new_h), (0, cfg.image_size - new_w)))
    x = (jnp.repeat(x[..., None], 3, axis=-1) - jnp.asarray(cfg.pixel_mean, jnp.float32)) / \
        jnp.asarray(cfg.pixel_std, jnp.float32)
    sizes = jnp.tile(jnp.asarray([[new_h, new_w]], jnp.float32), (len(frames), 1))
    out = jpred.model.apply(jpred.params, x, sizes, method=JaxRCNN.inference)
    return np.asarray(out['keypoint_heatmaps'])


def _keypoint_bins(keypoints, boxes, s: int) -> np.ndarray:
    '''The heatmap bin (y * s + x) each decoded (B, D, K, 2) keypoint came
    from: the decode puts a keypoint at the box's corner plus (bin + 0.5)
    box sizes over s.'''
    size = np.maximum(boxes[..., 2:] - boxes[..., :2], 1e-6)[:, :, None, :]
    cells = np.rint((keypoints - boxes[:, :, None, :2]) * s / size - 0.5).astype(int)
    cells = np.clip(cells, 0, s - 1)
    return cells[..., 1] * s + cells[..., 0]


def assert_keypoints_close_or_tied(ours, ref, ours_heat, ref_heat):
    '''Keypoints (``ours``, ``ref``: (keypoints, boxes) of each package)
    within 0.5 px; or else from different heatmap bins, each package's
    logit at the other's bin within ``KEYPOINT_TIE`` of its own: a near-tie,
    which the packages' f32 sums in different orders may break either
    way.'''
    (kp_o, box_o), (kp_r, box_r) = ours, ref
    s, k = ours_heat.shape[2], ours_heat.shape[-1]
    off = np.abs(kp_o - kp_r).max(axis=-1) > 0.5                     # (B, D, K)
    bins_o, bins_r = _keypoint_bins(kp_o, box_o, s), _keypoint_bins(kp_r, box_r, s)
    flat_o = ours_heat.reshape(*ours_heat.shape[:2], -1, k)
    flat_r = ref_heat.reshape(*ref_heat.shape[:2], -1, k)
    for b, d, kk in zip(*np.nonzero(off)):
        io, ir = int(bins_o[b, d, kk]), int(bins_r[b, d, kk])
        assert io != ir, f'keypoint {(b, d, kk)} is off in the same bin {io}'
        ho, hr = flat_o[b, d, :, kk], flat_r[b, d, :, kk]
        gaps = (float(ho.max() - ho[ir]), float(hr.max() - hr[io]))
        print(f'keypoint {(b, d, kk)}: bins {io} (port) and {ir} (JAX), logit gaps {gaps}')
        assert max(gaps) <= KEYPOINT_TIE, (b, d, kk, gaps)


# the Predictors' score tolerance of test_torch_slice
SCORE_ATOL = 2e-3


def tied_order(ours_scores, ref_scores, ours_boxes, ref_boxes) -> np.ndarray:
    '''(B, D) slots of ``ours`` lined up with ``ref``'s: per image the
    order of ``ours``'s detections, among those that put every slot's score
    within ``SCORE_ATOL`` of ``ref``'s, whose boxes lie nearest ``ref``'s.
    The detections are sorted by score, so two whose scores are within the
    packages' score tolerance of each other may take either slot; any other
    change of order has no such order and keeps the identity.'''
    import itertools
    b_count, d_count = ours_scores.shape
    order = np.tile(np.arange(d_count), (b_count, 1))
    for b in range(b_count):
        best = None
        for perm in itertools.permutations(range(d_count)):
            perm = np.asarray(perm)
            if np.abs(ours_scores[b, perm] - ref_scores[b]).max() > SCORE_ATOL:
                continue
            cost = float(np.abs(ours_boxes[b, perm] - ref_boxes[b]).max())
            if best is None or cost < best[0]:
                best = (cost, perm)
        if best is not None:
            order[b] = best[1]
    return order


def test_trained_dir_loads_in_both_packages(trained, tmp_path):
    '''The trained dir through the port's Predictor (its checkpoint) and,
    with its npz, through the JAX package's Predictor.

    The fixture's model is trained 4 steps, so its keypoint heatmaps are
    nearly flat: two bins far apart may hold logits equal to within 1e-4,
    and the argmax then falls on either side by the packages' rounding. A
    keypoint more than 0.5 px off is accepted only in a near-tie in both
    packages, each one's logit at the other's bin within ``KEYPOINT_TIE`` of
    its own maximum (``assert_keypoints_close_or_tied``). The bins are read
    from each package's decoded keypoints and boxes; the port's logits are
    its Predictor's own, the JAX package's its model's on the same
    prepared frames. Its detections' scores tie as closely: two within
    ``SCORE_ATOL`` of each other may take either slot, so the port's are
    lined up with the JAX package's before they are compared (``tied_order``;
    on 24 seeded splits, one swapped two detections 1e-5 apart).

    The npz holds the checkpoint's weights rounded to f16, and the port's
    Predictor on it must give what it gives on the checkpoint's weights so
    rounded, bit for bit. Against the f32 weights themselves a 4-step
    model's detections are not close: the rounding moves a proposal across
    an NMS threshold, and a detection leaves the top 4 (on 24 seeded
    splits, 4 had a slot's score more than 1e-2 off, up to 4.5e-2).'''
    model_dir = trained['model_dir']
    cfg, state, step = load_model_dir(model_dir)
    assert step == 4
    export = tmp_path / 'export'
    export.mkdir()
    shutil.copy(os.path.join(model_dir, 'config.yaml'), export)
    save_params_npz(str(export / 'params_f16.npz'), state, cfg.box_pooler_resolution)
    frames = np.stack([np.asarray(f, np.uint8) for f in
                       [read_image_of(it) for it in read_annotations(
                           trained['export'], default_keypoint_names)[:4]]])
    predictor = Predictor.from_model_dir(str(export), batch_size=2, device='cpu')
    heatmaps = []
    inference = predictor.model.inference

    def keep_heatmaps(*args, **kwargs):
        out = inference(*args, **kwargs)
        heatmaps.append(out['keypoint_heatmaps'].numpy())
        return out

    predictor.model.inference = keep_heatmaps
    ours = predictor(torch.from_numpy(frames))
    from_ckpt = Predictor.from_model_dir(model_dir, batch_size=2, device='cpu')(
        torch.from_numpy(frames))
    jcfg = JaxModelConfig.from_yaml(str(export / 'config.yaml'))
    jpred = JaxPredictor(jcfg, jax_load_npz(str(export / 'params_f16.npz')), batch_size=2)
    ref = jpred(frames)
    # the Predictors' tolerances of test_torch_slice, tied detections lined up
    ref_scores, ref_boxes = np.asarray(ref['scores']), np.asarray(ref['boxes'])
    order = tied_order(ours['scores'].numpy(), ref_scores, ours['boxes'].numpy(), ref_boxes)

    def lined_up(x):
        return np.take_along_axis(x, order.reshape(order.shape + (1,) * (x.ndim - 2)), axis=1)

    np.testing.assert_array_equal(lined_up(ours['valid'].numpy()), np.asarray(ref['valid']))
    np.testing.assert_allclose(lined_up(ours['scores'].numpy()), ref_scores, atol=SCORE_ATOL)
    np.testing.assert_allclose(lined_up(ours['boxes'].numpy()), ref_boxes, atol=0.5)
    assert_keypoints_close_or_tied(
        (lined_up(ours['keypoints'].numpy()[..., :2]), lined_up(ours['boxes'].numpy())),
        (np.asarray(ref['keypoints'])[..., :2], ref_boxes),
        lined_up(np.concatenate(heatmaps)), _jax_keypoint_heatmaps(jpred, frames))
    # the npz's f16 weights: the checkpoint's weights rounded to f16
    rounded = {k: v.half().float() if v.is_floating_point() else v
               for k, v in load_checkpoint(get_checkpoint(model_dir))['model'].items()}
    from_rounded = Predictor(cfg, rounded, batch_size=2, device='cpu')(torch.from_numpy(frames))
    for key, value in ours.items():
        assert torch.equal(torch.nan_to_num(value, nan=-7.0),
                           torch.nan_to_num(from_rounded[key], nan=-7.0)), key
    # the checkpoint itself loads, and gives detections of the same form
    for key, value in from_ckpt.items():
        assert value.shape == ours[key].shape and value.dtype == ours[key].dtype, key
    assert torch.isfinite(from_ckpt['scores']).all()


def read_image_of(item):
    from moseq2_detectron_extract_tpu_torch.io.image import read_image
    return read_image(item['file_name'])


def test_npz_round_trip_through_the_jax_reader(tmp_path):
    cfg = tiny_jax_config()
    _, flat = jax_init_params(cfg, seed=3)
    state = params_from_jax(flat)
    back = params_to_jax(state)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    path = str(tmp_path / 'params_f16.npz')
    save_params_npz(path, state)
    jax_tree = flatten_params(jax_load_npz(path))
    assert set(jax_tree) == set(back)
    for key, value in back.items():
        np.testing.assert_array_equal(jax_tree[key], value.astype(np.float16).astype(np.float32),
                                      err_msg=key)


def test_jax_inference_on_the_port_written_npz(tmp_path):
    cfg = tiny_jax_config(test_score_thresh=0.0)
    model = create_train_state(ModelConfig(**{k: getattr(cfg, k) for k in
                                              cfg.__dataclass_fields__}),
                               seed=4, device='cpu').model
    path = str(tmp_path / 'params_f16.npz')
    save_params_npz(path, model.state_dict())
    params = jax.tree_util.tree_map(jnp.asarray, jax_load_npz(path))
    port = MaskKeypointRCNN(model.cfg)
    port.load_state_dict(params_from_jax(flatten_params(jax_load_npz(path))))
    port.eval()
    images = np.random.default_rng(8).normal(0, 1, (2, 64, 64, 3)).astype('float32')
    ref = jax.jit(lambda p, x: JaxRCNN(cfg).apply(p, x, method=JaxRCNN.inference))(
        params, jnp.asarray(images))
    ours = port.inference(torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2))))
    np.testing.assert_array_equal(ours['valid'].numpy(), np.asarray(ref['valid']))
    for key in ('boxes', 'scores', 'keypoints', 'mask_probs', 'keypoint_heatmaps'):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), rtol=1e-3,
                                   atol=1e-3, err_msg=key)
    flips = (ours['masks'].numpy() != np.asarray(ref['masks'])).sum()
    assert flips <= 1e-3 * ours['masks'].numel(), flips


def test_init_follows_flax_defaults():
    model = create_train_state(tiny_train_config(keypoint_conv_dims=(64, 64)), seed=0,
                               device='cpu').model
    checked = 0
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
            w = m.weight.detach()
            fan_in = (w.shape[0] if isinstance(m, torch.nn.ConvTranspose2d) else w.shape[1]) \
                * int(np.prod(w.shape[2:]))
            if w.numel() >= 2000:
                assert abs(float(w.std()) / np.sqrt(1.0 / fan_in) - 1.0) < 0.1, name
                checked += 1
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(w.abs().max()) <= 2 * std + 1e-6, name
            if m.bias is not None:
                assert not m.bias.any(), name
        elif isinstance(m, torch.nn.GroupNorm):
            assert bool((m.weight == 1).all()) and not m.bias.any(), name
    assert checked > 10
    bn = model.backbone.stem_norm
    assert bool((bn.weight == 1).all()) and bool((bn.running_var == 1).all())


def test_zero_nonfinite_matches_jax_and_apply_gradients_uses_it(monkeypatch):
    from moseq2_detectron_extract_tpu.models import train as jtrain
    from moseq2_detectron_extract_tpu_torch.models import train
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=(4, 5)).astype('float32'), rng.normal(size=(7,)).astype('float32')]
    grads[0][1, 2], grads[0][3, 0], grads[1][4] = np.nan, np.inf, -np.inf
    tx = jtrain.zero_nonfinite()
    ref, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    ours = [torch.from_numpy(g.copy()) for g in grads]
    held = [g.data_ptr() for g in ours]
    train.zero_nonfinite(ours)
    assert [g.data_ptr() for g in ours] == held
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    calls = []
    monkeypatch.setattr(train, 'zero_nonfinite',
                        lambda g, _f=train.zero_nonfinite: calls.append(len(g)) or _f(g))
    model = torch.nn.Linear(5, 4)
    state = train.TrainState(step=0, model=model,
                             optimizer=torch.optim.SGD(model.parameters(), lr=0.1))
    model.weight.grad = torch.from_numpy(grads[0].copy())
    model.bias.grad = torch.full((4,), float('nan'))
    train.apply_gradients(state, ModelConfig())
    assert calls == [2] and state.step == 1
    assert bool(torch.isfinite(model.weight).all() and torch.isfinite(model.bias).all())
