'''Shared helpers of the PyTorch-port parity tests, and tests of the port's
synthetic chunk generator and device selection.

Every port test makes its inputs with numpy from a seed and feeds the same
arrays to the JAX package and to the port (on the CPU).
'''
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
from moseq2_detectron_extract_tpu.models.rcnn import MaskKeypointRCNN as JaxRCNN
from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
from moseq2_detectron_extract_tpu_torch.models.weights import params_from_jax
from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk


def flatten_params(tree, prefix: str = ''):
    '''A nested dict of arrays -> ``/``-joined keys (the npz layout).'''
    flat = {}
    for key, value in tree.items():
        name = f'{prefix}/{key}' if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten_params(value, name))
        else:
            flat[name] = np.asarray(value)
    return flat


def tiny_jax_config(**overrides) -> JaxModelConfig:
    '''The small model of ``__graft_entry__._tiny_config`` computing in f32
    (one block per stage, width 16, FPN 64).'''
    cfg = JaxModelConfig(
        image_size=64, min_size_test=64, max_size_test=64,
        resnet_stage_blocks=(1, 1, 1, 1), resnet_width=16, fpn_channels=64,
        box_fc_dim=128, mask_conv_dims=(64, 64), keypoint_conv_dims=(64, 64),
        rpn_pre_nms_topk_test=64, rpn_post_nms_topk_test=32,
        rpn_nms_global_cap=96, test_detections_per_image=2,
        amp_dtype='float32')
    return cfg.replace(**overrides)


def port_config(cfg: JaxModelConfig) -> ModelConfig:
    '''The port's config with the same field values.'''
    return ModelConfig(**dataclasses.asdict(cfg))


def jax_init_params(cfg: JaxModelConfig, seed: int = 0):
    '''Random-init flax params of the tiny model; the 1-init FrozenBN
    statistics are randomized too, so the norm mapping is exercised.'''
    model = JaxRCNN(cfg)
    images = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32)
    params = jax.jit(lambda key: model.init(key, images, method=JaxRCNN.init_params))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, params))
    for key in flat:
        if 'FrozenBatchNorm' in key:
            leaf = key.rsplit('/', 1)[1]
            shape = flat[key].shape
            flat[key] = {'scale': rng.uniform(0.5, 1.5, shape),
                         'bias': rng.normal(0, 0.1, shape),
                         'mean': rng.normal(0, 0.1, shape),
                         'var': rng.uniform(0.5, 1.5, shape)}[leaf].astype('float32')
    return jax_tree(flat), flat


def jax_tree(flat):
    '''``/``-joined keys (the npz layout) -> the nested tree of JAX arrays
    that flax's ``apply`` takes.'''
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def port_predictor(cfg: JaxModelConfig, flat, batch_size: int = 4,
                   score_threshold=None) -> Predictor:
    '''A CPU port Predictor holding the JAX params.'''
    return Predictor(port_config(cfg), params_from_jax(flat), batch_size=batch_size,
                     score_threshold=score_threshold, device='cpu')


def test_synthetic_chunk_is_seeded_and_sentinel_encoded():
    a = make_sentinel_chunk(3, 96, 128, seed=5, dropout_rate=0.01)
    b = make_sentinel_chunk(3, 96, 128, seed=5, dropout_rate=0.01)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.uint8 and a.shape == (3, 96, 128)
    assert (a == 255).any()
    body = (a > 0) & (a < 255)
    assert body.sum(axis=(1, 2)).min() > 150        # a mouse in every frame
    # the floor is exactly zero: a 20-px frame border holds no body pixels
    border = body.copy()
    border[:, 20:-20, 20:-20] = False
    assert not border.any()


def test_resolve_device_raises_without_cuda():
    assert resolve_device('cpu') == torch.device('cpu')
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='cuda'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError):
        resolve_device()
