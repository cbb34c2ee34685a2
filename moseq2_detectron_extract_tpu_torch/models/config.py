'''Typed model configuration and a reader for its ``config.yaml``.

Port of ``moseq2_detectron_extract_tpu/models/config.py``: the same
dataclass, field for field. PyYAML is not a dependency of the port, so
``read_config_yaml`` reads what ``ModelConfig.to_yaml`` (``yaml.safe_dump``
of the dataclass) writes with the port's YAML reader
(``io.yaml_subset.load``): a top-level mapping of scalars, block lists and
block lists of lists. ``to_yaml`` writes the same mapping with the port's
YAML writer (``io.yaml_subset.dump``), which the JAX package's
``ModelConfig.from_yaml`` reads.
'''
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from moseq2_detectron_extract_tpu_torch.io.yaml_subset import dump, load


@dataclasses.dataclass
class ModelConfig:
    '''Configuration of the Mask+Keypoint R-CNN (inference fields and the
    training fields a ``config.yaml`` carries).'''

    # -- input ---------------------------------------------------------------
    image_size: int = 256
    min_size_train: int = 240
    max_size_train: int = 250
    min_size_test: int = 240
    max_size_test: int = 250
    pixel_mean: Tuple[float, ...] = (1.12, 1.12, 1.12)
    pixel_std: Tuple[float, ...] = (5.79, 5.79, 5.79)
    input_format: str = 'RGB'

    # -- backbone ------------------------------------------------------------
    resnet_depth: int = 50
    resnet_stage_blocks: Optional[Tuple[int, int, int, int]] = None
    resnet_width: int = 64
    freeze_at: int = 0
    backbone_norm: str = 'frozen_bn'
    fpn_channels: int = 256
    fpn_norm: str = 'gn'
    fpn_fuse_type: str = 'avg'

    # -- anchors / RPN -------------------------------------------------------
    anchor_sizes: Tuple[Tuple[float, ...], ...] = ((32,), (64,), (128,), (256,), (512,))
    anchor_aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_pre_nms_topk_train: int = 2000
    rpn_pre_nms_topk_test: int = 1000
    rpn_post_nms_topk_train: int = 1500
    rpn_post_nms_topk_test: int = 256
    rpn_nms_global_cap: int = 1024
    rpn_nms_thresh: float = 0.7
    rpn_batch_size_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_fg_iou_thresh: float = 0.7
    rpn_bg_iou_thresh: float = 0.3
    rpn_smooth_l1_beta: float = 0.0

    # -- ROI heads -----------------------------------------------------------
    num_classes: int = 1
    roi_batch_size_per_image: int = 256
    roi_positive_fraction: float = 0.5
    roi_fg_iou_thresh: float = 0.5
    box_pooler_resolution: int = 7
    box_fc_dim: int = 1024
    box_smooth_l1_beta: float = 0.5
    box_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    rpn_box_reg_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)

    mask_on: bool = True
    mask_pooler_resolution: int = 14
    mask_conv_dims: Tuple[int, ...] = (256, 256, 256, 256)
    mask_resolution: int = 28

    keypoint_on: bool = True
    num_keypoints: int = 8
    keypoint_pooler_resolution: int = 7
    keypoint_conv_dims: Tuple[int, ...] = (512,) * 8
    keypoint_heatmap_size: int = 28
    keypoint_loss_normalize_by_visible: bool = True

    # -- test-time -----------------------------------------------------------
    test_score_thresh: float = 0.5
    test_nms_thresh: float = 0.5
    test_detections_per_image: int = 4

    # -- solver --------------------------------------------------------------
    ims_per_batch: int = 8
    base_lr: float = 0.0025
    max_iter: int = 100_000
    lr_steps: Tuple[int, ...] = (70_000, 80_000, 90_000)
    lr_gamma: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip_norm: float = 10.0
    warmup_iters: int = 1000
    warmup_factor: float = 1e-3
    checkpoint_period: int = 5000
    eval_period: int = 1000
    amp_dtype: str = 'bfloat16'

    # -- dataset-derived -----------------------------------------------------
    keypoint_names: Tuple[str, ...] = ('Nose', 'Left Ear', 'Right Ear', 'Neck',
                                       'Left Hip', 'Right Hip', 'TailBase', 'TailTip')
    oks_sigmas: Tuple[float, ...] = (0.026, 0.035, 0.035, 0.079,
                                     0.107, 0.107, 0.089, 0.026)

    max_gt_instances: int = 8

    def to_yaml(self, path: str) -> None:
        '''Write every field to a yaml file (tuples as lists).'''
        with open(path, 'w', encoding='utf-8') as fh:
            fh.write(dump(_as_lists(dataclasses.asdict(self))))

    @classmethod
    def from_yaml(cls, path: str) -> 'ModelConfig':
        '''Load from a ``config.yaml`` (unknown keys ignored, lists become
        tuples), as the JAX package's ``ModelConfig.from_yaml`` does.'''
        raw = read_config_yaml(path)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in raw.items():
            if k in known:
                if isinstance(v, list):
                    v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
                kwargs[k] = v
        return cls(**kwargs)

    def replace(self, **kwargs) -> 'ModelConfig':
        '''Functional field update.'''
        return dataclasses.replace(self, **kwargs)


def get_base_config() -> ModelConfig:
    '''The base config (the reference's tuned values).'''
    return ModelConfig()


def add_dataset_config(cfg: ModelConfig, num_keypoints: Optional[int] = None,
                       pixel_mean: Optional[List[float]] = None,
                       pixel_std: Optional[List[float]] = None) -> ModelConfig:
    '''Apply the dataset-derived fields (``config.py:140-157``).'''
    updates: Dict[str, Any] = {}
    if num_keypoints is not None:
        updates['num_keypoints'] = num_keypoints
    if pixel_mean is not None:
        updates['pixel_mean'] = tuple(float(v) for v in pixel_mean)
    if pixel_std is not None:
        updates['pixel_std'] = tuple(float(v) for v in pixel_std)
    return cfg.replace(**updates) if updates else cfg


def _as_lists(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _as_lists(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_as_lists(v) for v in value]
    return value


# -- the config.yaml reader ------------------------------------------------------

def _plain_value(value: Any) -> bool:
    '''A scalar, or a list of scalars or of such lists.'''
    if isinstance(value, list):
        return all(_plain_value(v) for v in value)
    return not isinstance(value, dict)


def parse_config_yaml(text: str) -> Dict[str, Any]:
    '''Parse what ``ModelConfig.to_yaml`` writes: a top-level mapping of
    scalars, lists and lists of lists (``io.yaml_subset``; nested mappings
    raise ``ValueError``).'''
    out = load(text)
    if out is None:
        return {}
    if not isinstance(out, dict) or not all(_plain_value(v) for v in out.values()):
        raise ValueError('a model config is a flat mapping of scalars and lists')
    return out


def read_config_yaml(path: str) -> Dict[str, Any]:
    '''Read a model dir's ``config.yaml`` without PyYAML.'''
    with open(path, 'r', encoding='utf-8') as fh:
        return parse_config_yaml(fh.read())
