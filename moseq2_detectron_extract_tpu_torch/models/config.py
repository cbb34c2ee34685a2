'''Typed model configuration and a reader for its ``config.yaml``.

Port of ``moseq2_detectron_extract_tpu/models/config.py``: the same
dataclass, field for field. PyYAML is not a dependency of the port, so
``read_config_yaml`` parses the block-style subset that
``ModelConfig.to_yaml`` (``yaml.safe_dump`` of the dataclass) writes: a
top-level mapping of scalars, block lists and block lists of lists.
'''
import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Tuple


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


# -- YAML subset reader --------------------------------------------------------

# YAML 1.1 plain-scalar resolution, as PyYAML's SafeLoader resolves it
_INT_RE = re.compile(r'^[-+]?(0|[1-9][0-9_]*)$')
_FLOAT_RE = re.compile(r'^[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$'
                       r'|^[-+]?[0-9][0-9_]*(?:\.[0-9_]*)?[eE][-+][0-9]+$')
_BOOLS = {'true': True, 'false': False, 'yes': True, 'no': False,
          'on': True, 'off': False}
_NULLS = {'', '~', 'null', 'Null', 'NULL'}


def _scalar(text: str) -> Any:
    '''Resolve one plain, quoted or empty-flow-list scalar.'''
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return bytes(text[1:-1], 'utf-8').decode('unicode_escape')
    if text == '[]':
        return []
    if text in _NULLS:
        return None
    if text.lower() in _BOOLS:
        return _BOOLS[text.lower()]
    if _INT_RE.match(text):
        return int(text.replace('_', ''))
    if _FLOAT_RE.match(text):
        return float(text.replace('_', ''))
    lowered = text.lower()
    if lowered in ('.inf', '+.inf'):
        return math.inf
    if lowered == '-.inf':
        return -math.inf
    if lowered == '.nan':
        return math.nan
    if text[0] in '[{&*!|>%@`':
        raise ValueError(f'unsupported YAML construct: {text!r}')
    return text


def _parse_seq(lines: List[Tuple[int, str]], pos: int, col: int):
    '''Block sequence whose ``-`` markers sit at column ``col``.'''
    items = []
    while pos < len(lines) and lines[pos][0] == col and \
            (lines[pos][1] == '-' or lines[pos][1].startswith('- ')):
        rest = lines[pos][1][1:]
        inner = rest.lstrip(' ')
        inner_col = col + 1 + (len(rest) - len(inner))
        if inner.startswith('- ') or inner == '-':
            # a list of lists: the first inner item shares this line
            lines[pos] = (inner_col, inner)
            value, pos = _parse_seq(lines, pos, inner_col)
        elif inner == '':
            pos += 1
            if pos < len(lines) and lines[pos][0] > col:
                value, pos = _parse_seq(lines, pos, lines[pos][0])
            else:
                value = None
        else:
            if re.match(r'^[^\'"\s][^:]*:(\s|$)', inner):
                raise ValueError(f'unsupported YAML mapping in a list: {inner!r}')
            value = _scalar(inner)
            pos += 1
        items.append(value)
    return items, pos


def parse_config_yaml(text: str) -> Dict[str, Any]:
    '''Parse the YAML subset ``ModelConfig.to_yaml`` writes.'''
    lines = []
    for raw in text.splitlines():
        stripped = raw.rstrip()
        if not stripped or stripped.lstrip().startswith('#') or stripped == '---':
            continue
        indent = len(stripped) - len(stripped.lstrip(' '))
        lines.append((indent, stripped.lstrip(' ')))
    out: Dict[str, Any] = {}
    pos = 0
    while pos < len(lines):
        indent, content = lines[pos]
        m = re.match(r'^([^\s:][^:]*):(?:\s+(.*))?$', content)
        if indent != 0 or m is None:
            raise ValueError(f'unsupported YAML line: {content!r}')
        key, rest = m.group(1), (m.group(2) or '')
        pos += 1
        if rest.strip():
            out[key] = _scalar(rest)
        elif pos < len(lines) and lines[pos][1].startswith('-') and \
                lines[pos][0] in (0, 2):
            out[key], pos = _parse_seq(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out


def read_config_yaml(path: str) -> Dict[str, Any]:
    '''Read a model dir's ``config.yaml`` without PyYAML.'''
    with open(path, 'r', encoding='utf-8') as fh:
        return parse_config_yaml(fh.read())
