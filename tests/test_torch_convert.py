'''The port's Detectron2 converter (``models/convert.py``) against the JAX
package's converter followed by ``weights.params_from_jax``, against the
Detectron2 oracle of ``tests/test_convert.py``, and through the
``convert-weights`` and ``train --init-weights`` commands.

The Detectron2 states are made with numpy from a seed by the oracle's
``make_backbone_state`` and ``tests/test_convert_e2e.py``'s head tensors
(the oracle module's generator is swapped for a seeded one while they are
made, so the JAX tests that share it see the numbers they always saw).
'''
import contextlib
import os
import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from moseq2_detectron_extract_tpu.models import convert as jax_convert
from moseq2_detectron_extract_tpu.models.rcnn import MaskKeypointRCNN as JaxRCNN
from moseq2_detectron_extract_tpu_torch import cli
from moseq2_detectron_extract_tpu_torch.models import convert
from moseq2_detectron_extract_tpu_torch.models.checkpoint import load_model_dir
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
from moseq2_detectron_extract_tpu_torch.models.weights import params_from_jax
from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views

from tests import test_convert as oracle
from tests.test_convert_e2e import full_tiny_config, make_full_state
from tests.test_torch_common import flatten_params, port_config

FC_DIM, C = 64, 32           # full_tiny_config's box FC and FPN widths


@contextlib.contextmanager
def oracle_seed(seed: int):
    '''Make the oracle's random tensors from ``seed``, leaving its shared
    generator as it was.'''
    saved = oracle.RNG
    oracle.RNG = np.random.default_rng(seed)
    try:
        yield
    finally:
        oracle.RNG = saved


def zoo_state(seed: int = 0, coco_heads: bool = False):
    '''Every tensor of a Detectron2 R50-FPN checkpoint at 1/4 width. With
    ``coco_heads``, the COCO heads: 2 classes and 17 keypoints, plus keys
    the model has no place for.'''
    with oracle_seed(seed):
        state = make_full_state()
        if coco_heads:
            w = oracle._w
            state['roi_heads.box_predictor.cls_score.weight'] = w(3, FC_DIM)
            state['roi_heads.box_predictor.cls_score.bias'] = w(3)
            state['roi_heads.box_predictor.bbox_pred.weight'] = w(8, FC_DIM)
            state['roi_heads.box_predictor.bbox_pred.bias'] = w(8)
            state['roi_heads.keypoint_head.score_lowres.weight'] = w(C, 17, 4, 4)
            state['roi_heads.keypoint_head.score_lowres.bias'] = w(17)
            state['backbone.fpn_lateral2.bias'] = w(C)          # an un-normed FPN's bias
            state['roi_heads.extra_head.weight'] = w(4, 4)      # no place in the model
            state['pixel_mean'] = w(3)                          # ignored, as in the JAX map
    return state


@pytest.fixture(scope='module')
def jax_template():
    cfg = full_tiny_config()
    model = JaxRCNN(cfg)
    images = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax.jit(lambda key: model.init(key, images, method=JaxRCNN.init_params))(
        jax.random.PRNGKey(0))
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _names(report):
    return [line.split(':')[0] for line in report['shape_mismatch']]


@pytest.mark.parametrize('coco_heads', [False, True], ids=['zoo_shapes', 'coco_heads'])
def test_converter_matches_jax_then_params_from_jax(jax_template, coco_heads):
    '''Bit for bit on every tensor: the JAX converter on its template then
    ``params_from_jax``, against the port's converter on the same template
    carried across; the reports list the same Detectron2 names.'''
    cfg, template = jax_template
    state = zoo_state(seed=1, coco_heads=coco_heads)
    jax_params, jax_report = jax_convert.convert_detectron2_params(state, template)
    via_jax = params_from_jax(flatten_params(jax_params))
    port_template = params_from_jax(flatten_params(template))
    ours, report = convert.convert_detectron2_params(state, port_template)

    assert set(ours) == set(via_jax) == set(MaskKeypointRCNN(port_config(cfg)).state_dict())
    differ = [k for k in ours if not torch.equal(ours[k], via_jax[k])]
    assert not differ, differ[:5]
    for key in ('loaded', 'missing_in_source', 'unused'):
        assert report[key] == jax_report[key], key
    assert _names(report) == _names(jax_report)
    if coco_heads:
        assert _names(report) == ['roi_heads.box_predictor.cls_score.weight',
                                  'roi_heads.box_predictor.cls_score.bias',
                                  'roi_heads.box_predictor.bbox_pred.weight',
                                  'roi_heads.box_predictor.bbox_pred.bias',
                                  'roi_heads.keypoint_head.score_lowres.weight',
                                  'roi_heads.keypoint_head.score_lowres.bias']
        # the port reports the source's own (torch) layout
        assert report['shape_mismatch'][4] == ('roi_heads.keypoint_head.score_lowres.weight: '
                                               'source (32, 17, 4, 4) vs model (32, 8, 4, 4)')
        assert report['unused'] == ['roi_heads.extra_head.weight']
    else:
        assert not report['shape_mismatch'] and not report['unused']
        assert not report['missing_in_source']
    # the COCO state's 3 extra keys and 6 mismatched heads are not loaded
    assert len(report['loaded']) == len(state) - 9 * coco_heads


def test_shape_mismatch_keeps_the_ports_init():
    '''The zoo's 17-keypoint ``score_lowres`` (and 2-class predictor) keep
    the template's values, here flax's init from a torch.Generator.'''
    model = MaskKeypointRCNN(port_config(full_tiny_config()))
    from moseq2_detectron_extract_tpu_torch.models.train import init_flax_defaults
    template = init_flax_defaults(model, torch.Generator().manual_seed(3)).state_dict()
    ours, report = convert.convert_detectron2_params(zoo_state(seed=2, coco_heads=True),
                                                     template)
    assert len(report['shape_mismatch']) == 6
    for name in ('keypoint_head.score_lowres.weight', 'box_head.cls_score.weight',
                 'box_head.bbox_pred.bias'):
        assert torch.equal(ours[name], template[name]), name
    assert not torch.equal(ours['keypoint_head.conv_fcn1.weight'],
                           template['keypoint_head.conv_fcn1.weight'])


def test_identity_layouts_against_the_detectron2_oracle():
    '''Every tensor copied as it is gives the Detectron2 function: the
    backbone and FPN, the RPN head and the three ROI heads of the port on
    converted weights against the oracle's torch ops, f32 (the JAX tests'
    tolerances: 2e-4 for the pyramid, 1e-4 for the heads).'''
    state = zoo_state(seed=4)
    cfg = port_config(full_tiny_config())
    model = MaskKeypointRCNN(cfg)
    ours, report = convert.convert_detectron2_params(state, model.state_dict())
    assert not report['shape_mismatch'] and not report['unused']
    model.load_state_dict(ours)
    model.eval()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 64, 64)).astype('float32'))
    with torch.no_grad():
        pyramid = model.features(x)
        ref = oracle.t_fpn(oracle.t_resnet50(x, state), state)
        for level, (got, want) in enumerate(zip(pyramid, ref)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                                       err_msg=f'P{level + 2}')

        logits, _ = model.rpn_head([ref[0]])
        t = F.relu(oracle.t_conv(ref[0], state, 'proposal_generator.rpn_head.conv', pad=1))
        obj = oracle.t_conv(t, state, 'proposal_generator.rpn_head.objectness_logits')
        np.testing.assert_allclose(logits[0].numpy(),
                                   obj.permute(0, 2, 3, 1).reshape(2, -1).numpy(), atol=1e-4)

        pooled = torch.from_numpy(rng.normal(0, 1, (3, 7, 7, C)).astype('float32'))
        nchw = pooled.permute(0, 3, 1, 2)
        cls, _ = model.box_head(pooled)
        h = F.relu(F.linear(nchw.flatten(1), oracle._t(state['roi_heads.box_head.fc1.weight']),
                            oracle._t(state['roi_heads.box_head.fc1.bias'])))
        h = F.relu(F.linear(h, oracle._t(state['roi_heads.box_head.fc2.weight']),
                            oracle._t(state['roi_heads.box_head.fc2.bias'])))
        want = F.linear(h, oracle._t(state['roi_heads.box_predictor.cls_score.weight']),
                        oracle._t(state['roi_heads.box_predictor.cls_score.bias']))
        np.testing.assert_allclose(cls.numpy(), want.numpy(), atol=1e-4)

        y = nchw
        for i in range(1, 9):
            y = F.relu(oracle.t_conv(y, state, f'roi_heads.keypoint_head.conv_fcn{i}', pad=1))
        y = F.conv_transpose2d(y, oracle._t(state['roi_heads.keypoint_head.score_lowres.weight']),
                               oracle._t(state['roi_heads.keypoint_head.score_lowres.bias']),
                               stride=2, padding=1)
        want = F.interpolate(y, scale_factor=2, mode='bilinear', align_corners=False)
        np.testing.assert_allclose(model.keypoint_head(pooled).numpy(),
                                   want.permute(0, 2, 3, 1).numpy(), atol=1e-4)

        pooled14 = torch.from_numpy(rng.normal(0, 1, (2, 14, 14, C)).astype('float32'))
        y = pooled14.permute(0, 3, 1, 2)
        for i in range(1, 5):
            y = F.relu(oracle.t_conv(y, state, f'roi_heads.mask_head.mask_fcn{i}', pad=1))
        y = F.relu(F.conv_transpose2d(y, oracle._t(state['roi_heads.mask_head.deconv.weight']),
                                      oracle._t(state['roi_heads.mask_head.deconv.bias']),
                                      stride=2))
        want = oracle.t_conv(y, state, 'roi_heads.mask_head.predictor')
        np.testing.assert_allclose(model.mask_head(pooled14).numpy(),
                                   want.permute(0, 2, 3, 1).numpy(), atol=1e-4)


def test_caffe2_names_match_jax():
    '''MSRA/Caffe2 ImageNet names: the same Detectron2 state as the JAX
    reader's (fused BN -> identity running statistics), through a .pkl.'''
    with oracle_seed(6):
        w = oracle._w
        caffe2 = {'conv1_w': w(16, 3, 7, 7), 'res_conv1_bn_s': w(16) + 1,
                  'res_conv1_bn_b': w(16)}
        for branch, shape in (('branch2a', (16, 16, 1, 1)), ('branch2b', (16, 16, 3, 3)),
                              ('branch2c', (64, 16, 1, 1)), ('branch1', (64, 16, 1, 1))):
            caffe2[f'res2_0_{branch}_w'] = w(*shape)
            caffe2[f'res2_0_{branch}_bn_s'] = w(shape[0]) + 1
            caffe2[f'res2_0_{branch}_bn_b'] = w(shape[0])
    ours = convert._convert_caffe2_names(caffe2)
    ref = jax_convert._convert_caffe2_names(caffe2)
    assert list(ours) == list(ref)
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key])
    np.testing.assert_array_equal(
        ours['backbone.bottom_up.res2.0.shortcut.norm.running_var'], np.ones(64, 'float32'))


def test_pkl_and_pth_round_trip(tmp_path):
    '''The zoo's pickle (read with latin1) and a torch ``.pth`` under
    ``'model'`` give the same float32 state as the JAX reader; non-numeric
    entries are dropped.'''
    state = zoo_state(seed=7)
    pkl = tmp_path / 'model.pkl'
    with open(pkl, 'wb') as fh:
        pickle.dump({'model': state, '__author__': 'zoo', 'matching_heuristics': True}, fh,
                    protocol=2)
    pth = tmp_path / 'model.pth'
    torch.save({'model': {k: torch.from_numpy(v) for k, v in state.items()},
                'iteration': 5}, str(pth))
    ref = jax_convert.load_detectron2_state(str(pkl))
    for path in (pkl, pth):
        got = convert.load_detectron2_state(str(path))
        assert list(got) == list(ref) == list(state)
        for key, value in ref.items():
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], value)


def test_zoo_full_width_names_and_shapes():
    '''The zoo's full-width name and shape set (R50 width 64, FPN 256, box
    FC 1024, mask 256 x 4, keypoint 512 x 8, 8 keypoints) lands on the
    port's default model with nothing unmapped, mismatched or missing.
    Names and shapes only: zero-stride arrays onto a meta-device template.'''
    from tests import test_convert_fullwidth as fullwidth

    def zeros(*shape, scale=0.1):
        return np.broadcast_to(np.float32(0), shape)
    real_w = oracle._w
    try:
        oracle._w = fullwidth._w = zeros
        state = fullwidth.make_full_zoo_state()
    finally:
        oracle._w = fullwidth._w = real_w
    with torch.device('meta'):
        template = MaskKeypointRCNN(ModelConfig()).state_dict()
    ours, report = convert.convert_detectron2_params(state, template)
    assert not report['shape_mismatch'], report['shape_mismatch']
    assert not report['unused'], report['unused'][:10]
    assert not report['missing_in_source'], report['missing_in_source'][:10]
    assert len(report['loaded']) == len(template) == len(state)
    assert all(ours[k].shape == template[k].shape for k in template)
    assert template['box_head.fc1.weight'].shape == (1024, 256 * 7 * 7)


@pytest.fixture(scope='module')
def converted_dir(tmp_path_factory):
    '''``convert-weights`` on a .pkl of the zoo state with the COCO heads,
    at the tiny f32 config.'''
    work = tmp_path_factory.mktemp('convert_cli')
    pkl = work / 'zoo.pkl'
    state = zoo_state(seed=9, coco_heads=True)
    with open(pkl, 'wb') as fh:
        pickle.dump({'model': state}, fh)
    cfg = port_config(full_tiny_config()).replace(
        min_size_train=60, max_size_train=64, rpn_pre_nms_topk_train=64,
        rpn_post_nms_topk_train=32, roi_batch_size_per_image=16, ims_per_batch=2,
        max_gt_instances=1, warmup_iters=1)
    cfg_path = str(work / 'config.yaml')
    cfg.to_yaml(cfg_path)
    model_dir = str(work / 'model')
    return str(pkl), cfg_path, model_dir, state, work


def test_convert_weights_command_then_predictor(converted_dir, capsys):
    '''The command writes config.yaml and checkpoint 0 with the converted
    weights, prints the JAX command's summary, and the dir loads in the
    Predictor.'''
    pkl, cfg_path, model_dir, state, _ = converted_dir
    assert cli.main(['convert-weights', pkl, '--model-dir', model_dir,
                     '--config', cfg_path]) == 0
    printed = capsys.readouterr().out.splitlines()
    # the 3 keys without a place, and the 6 mismatched heads, are not loaded
    assert printed[0] == (f'loaded {len(state) - 9} tensors, 6 kept initialization '
                          '(shape mismatch), 1 source keys unused')
    assert printed[1] == f'wrote {os.path.abspath(model_dir)}/checkpoints/model_0000000.pt'
    cfg, loaded, step = load_model_dir(model_dir)
    assert step == 0 and cfg.num_keypoints == 8
    np.testing.assert_array_equal(loaded['fpn.output3.weight'].numpy(),
                                  state['backbone.fpn_output3.weight'])
    np.testing.assert_array_equal(loaded['box_head.fc1.weight'].numpy(),
                                  state['roi_heads.box_head.fc1.weight'])
    predictor = Predictor.from_model_dir(model_dir, batch_size=2, device='cpu')
    out = predictor(torch.zeros((2, 64, 64), dtype=torch.uint8))
    assert out['keypoints'].shape == (2, cfg.test_detections_per_image, 8, 3)
    assert bool(torch.isfinite(out['scores']).all())


def test_train_init_weights_two_steps(converted_dir, monkeypatch):
    '''``train --init-weights`` starts from the converted weights (the
    mismatched heads from the trainer's own init) and takes 2 steps.'''
    pkl, cfg_path, _, state, work = converted_dir
    export = write_annotated_views(str(work / 'views'), 6, size=64, seed=0)
    out_dir = str(work / 'trained')
    seen = {}
    from moseq2_detectron_extract_tpu_torch.models import trainer as trainer_mod
    real_train = trainer_mod.Trainer.train

    def spy(self):
        seen['fpn'] = self.state.model.state_dict()['fpn.output3.weight'].clone()
        seen['step'] = self.state.step
        return real_train(self)

    monkeypatch.setattr(trainer_mod.Trainer, 'train', spy)
    assert cli.main(['train', export, '--model-dir', out_dir, '--config', cfg_path,
                     '--max-iter', '2', '--device', 'cpu', '--init-weights', pkl,
                     '--log-period', '1']) == 0
    np.testing.assert_array_equal(seen['fpn'].numpy(), state['backbone.fpn_output3.weight'])
    assert seen['step'] == 0
    with open(os.path.join(out_dir, 'metrics.jsonl'), encoding='utf-8') as fh:
        rows = [line for line in fh if 'total_loss' in line]
    assert len(rows) == 2
    _, trained, step = load_model_dir(out_dir)
    assert step == 2 and all(bool(torch.isfinite(v).all()) for v in trained.values())


def test_train_resumes_a_converted_dir(converted_dir):
    '''``train --resume`` on a ``convert-weights`` dir: checkpoint 0 has no
    momentum, so the trainer takes its step and weights and goes on.'''
    pkl, cfg_path, _, state, work = converted_dir
    model_dir = str(work / 'resumed')
    assert cli.main(['convert-weights', pkl, '--model-dir', model_dir,
                     '--config', cfg_path]) == 0
    export = write_annotated_views(str(work / 'resume_views'), 6, size=64, seed=1)
    assert cli.main(['train', export, '--model-dir', model_dir, '--config', cfg_path,
                     '--max-iter', '1', '--device', 'cpu', '--resume']) == 0
    _, trained, step = load_model_dir(model_dir)
    assert step == 1
    moved = trained['fpn.output3.weight'].numpy() - state['backbone.fpn_output3.weight']
    assert 0 < np.abs(moved).max() < 0.1          # one SGD step from the converted weights
