'''The port's PyYAML-free config reader against ``yaml.safe_load`` and the
JAX package's ``ModelConfig.from_yaml`` (exact equality).'''
import dataclasses
import glob
import os

import pytest
import yaml

from moseq2_detectron_extract_tpu.models.config import ModelConfig as JaxModelConfig
from moseq2_detectron_extract_tpu_torch.models.config import (ModelConfig,
                                                              parse_config_yaml,
                                                              read_config_yaml)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, 'benchmarks', '*', 'config.yaml'))) + \
    [os.path.join(REPO, 'tests', 'data', 'tiny_overfit_config.yaml')]


def test_three_committed_model_configs_exist():
    assert len(glob.glob(os.path.join(REPO, 'benchmarks', '*', 'config.yaml'))) == 3


@pytest.mark.parametrize('path', CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_reader_equals_safe_load(path):
    with open(path, encoding='utf-8') as fh:
        expected = yaml.safe_load(fh)
    assert read_config_yaml(path) == expected


@pytest.mark.parametrize('path', CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_from_yaml_equals_jax_config(path):
    ours = dataclasses.asdict(ModelConfig.from_yaml(path))
    ref = dataclasses.asdict(JaxModelConfig.from_yaml(path))
    assert ours == ref


def test_roundtrip_of_to_yaml_output(tmp_path):
    cfg = JaxModelConfig(anchor_sizes=((8, 12), (16,), (32,), (64,), (128,)),
                         resnet_stage_blocks=(1, 2, 1, 1), weight_decay=1e-5,
                         keypoint_names=('Nose', 'Tail: tip', "it's", 'yes', '1.5'),
                         fpn_norm='', mask_on=False)
    path = str(tmp_path / 'config.yaml')
    cfg.to_yaml(path)
    with open(path, encoding='utf-8') as fh:
        assert read_config_yaml(path) == yaml.safe_load(fh)
    assert dataclasses.asdict(ModelConfig.from_yaml(path)) == \
        dataclasses.asdict(JaxModelConfig.from_yaml(path))


@pytest.mark.parametrize('text', ['a:\n  b: 1\n', 'a: {b: 1}\n', 'a:\n- b: 1\n'])
def test_unsupported_constructs_raise(text):
    with pytest.raises(ValueError):
        parse_config_yaml(text)
