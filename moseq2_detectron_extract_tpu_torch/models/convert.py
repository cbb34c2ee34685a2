'''Detectron2 checkpoint -> the port's ``state_dict``.

Port of ``moseq2_detectron_extract_tpu/models/convert.py``. The reference
trains from the COCO zoo's ``keypoint_rcnn_R_50_FPN_3x`` checkpoint; this
module maps that checkpoint (and Caffe2/MSRA ImageNet backbones) onto
:class:`MaskKeypointRCNN`'s parameter names:

* ``.pkl``  the zoo's format: a pickle of ``{'model': {name: ndarray}}``
  with Detectron2 names, or Caffe2/MSRA names for ImageNet backbones;
* ``.pth``  a torch ``state_dict`` (possibly under ``'model'``).

Layouts: the port's layers take torch's own, which are Detectron2's (conv
OIHW, ``nn.Linear`` (out, in), ``nn.ConvTranspose2d`` (in, out, kh, kw)
without a flip, and the box head's first FC on the NCHW flatten), so every
tensor is copied as it is. The JAX package's transforms (HWIO, the flipped
deconv taps, the NHWC flatten) have no counterpart here;
``tests/test_torch_convert.py`` proves this against the JAX converter
followed by ``weights.params_from_jax``.

Leaves the model does not have (the conv biases of an un-normed FPN, where
this model has GroupNorms) are skipped, as the JAX map skips them.
Shape-mismatched leaves (the zoo's 17-keypoint ``score_lowres`` against 8,
its 80-class box predictor) keep the template's values and are reported,
as DetectionCheckpointer skips them with a warning.
'''
import logging
import pickle
import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

STAGE_BLOCKS = {2: 3, 3: 4, 4: 6, 5: 3}      # R50
_BN_FIELDS = ('weight', 'bias', 'running_mean', 'running_var')


# -- checkpoint readers ----------------------------------------------------------------

def load_detectron2_state(path: str) -> Dict[str, np.ndarray]:
    '''Read a Detectron2 ``.pkl`` or torch ``.pth`` checkpoint into a flat
    ``{name: float32 ndarray}`` dict with Detectron2 names.'''
    if path.endswith('.pkl'):
        with open(path, 'rb') as fh:
            data = pickle.load(fh, encoding='latin1')
    else:
        data = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(data, dict) and 'model' in data:
        data = data['model']
    state: Dict[str, np.ndarray] = {}
    for name, value in data.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        arr = np.asarray(value)
        if arr.dtype == object or not np.issubdtype(arr.dtype, np.number):
            continue
        state[name] = arr.astype(np.float32)
    if _looks_caffe2(state):
        state = _convert_caffe2_names(state)
    return state


def _looks_caffe2(state: Mapping[str, np.ndarray]) -> bool:
    return any(re.match(r'res\d+_\d+_branch', k) for k in state) or 'conv1_w' in state


def _convert_caffe2_names(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    '''MSRA/Caffe2 ImageNet backbone names -> Detectron2 names.

    Caffe2 folds its BN into an affine map (``_bn_s``/``_bn_b`` only): the
    running statistics are made the identity, so FrozenBN gives the same map.
    '''
    out: Dict[str, np.ndarray] = {}
    branch_to_conv = {'branch2a': 'conv1', 'branch2b': 'conv2',
                      'branch2c': 'conv3', 'branch1': 'shortcut'}

    def put_bn(prefix: str, scale: np.ndarray, bias: np.ndarray):
        out[f'{prefix}.norm.weight'] = scale
        out[f'{prefix}.norm.bias'] = bias
        out[f'{prefix}.norm.running_mean'] = np.zeros_like(scale)
        out[f'{prefix}.norm.running_var'] = np.ones_like(scale)

    stem = 'backbone.bottom_up.stem.conv1'
    if 'conv1_w' in state:
        out[f'{stem}.weight'] = state['conv1_w']
        put_bn(stem, state['res_conv1_bn_s'], state['res_conv1_bn_b'])

    for key, value in state.items():
        m = re.match(r'res(\d+)_(\d+)_(branch\w+)_(w|bn_s|bn_b)$', key)
        if not m:
            continue
        stage, block, branch, kind = m.groups()
        prefix = f'backbone.bottom_up.res{stage}.{block}.{branch_to_conv[branch]}'
        if kind == 'w':
            out[f'{prefix}.weight'] = value
        elif kind == 'bn_s':
            put_bn(prefix, value, state[key[:-1] + 'b'])
    return out


# -- the name map ------------------------------------------------------------------------

def _backbone_entries() -> List[Tuple[str, str]]:
    '''(Detectron2 name, port name) for the R50 backbone and the FPN, in the
    JAX map's order.'''
    stem = 'backbone.bottom_up.stem.conv1'
    entries = [(f'{stem}.weight', 'backbone.stem_conv.weight')]
    entries += [(f'{stem}.norm.{f}', f'backbone.stem_norm.{f}') for f in _BN_FIELDS]
    for stage, nblocks in STAGE_BLOCKS.items():
        for block in range(nblocks):
            d2 = f'backbone.bottom_up.res{stage}.{block}'
            ours = f'backbone.res{stage}_{block}'
            convs = ['conv1', 'conv2', 'conv3'] + (['shortcut'] if block == 0 else [])
            for conv in convs:
                entries.append((f'{d2}.{conv}.weight', f'{ours}.{conv}.weight'))
                entries += [(f'{d2}.{conv}.norm.{f}', f'{ours}.{conv}_norm.{f}')
                            for f in _BN_FIELDS]
    for level in (2, 3, 4, 5):
        entries.append((f'backbone.fpn_lateral{level}.weight', f'fpn.lateral{level}.weight'))
        entries.append((f'backbone.fpn_output{level}.weight', f'fpn.output{level}.weight'))
        for kind in ('lateral', 'output'):
            d2 = f'backbone.fpn_{kind}{level}'
            entries.append((f'{d2}.norm.weight', f'fpn.{kind}_norm{level}.weight'))
            entries.append((f'{d2}.norm.bias', f'fpn.{kind}_norm{level}.bias'))
            # un-normed FPN variants carry conv biases instead
            entries.append((f'{d2}.bias', f'fpn.{kind}{level}.bias'))
    return entries


def _head_entries() -> List[Tuple[str, str]]:
    '''(Detectron2 name, port name) for the RPN and the ROI heads.'''
    pairs = [('proposal_generator.rpn_head.conv', 'rpn_head.conv'),
             ('proposal_generator.rpn_head.objectness_logits', 'rpn_head.objectness'),
             ('proposal_generator.rpn_head.anchor_deltas', 'rpn_head.deltas'),
             ('roi_heads.box_head.fc1', 'box_head.fc1'),
             ('roi_heads.box_head.fc2', 'box_head.fc2'),
             ('roi_heads.box_predictor.cls_score', 'box_head.cls_score'),
             ('roi_heads.box_predictor.bbox_pred', 'box_head.bbox_pred')]
    pairs += [(f'roi_heads.mask_head.mask_fcn{i}', f'mask_head.mask_fcn{i}')
              for i in range(1, 5)]
    pairs += [('roi_heads.mask_head.deconv', 'mask_head.deconv'),
              ('roi_heads.mask_head.predictor', 'mask_head.predictor')]
    pairs += [(f'roi_heads.keypoint_head.conv_fcn{i}', f'keypoint_head.conv_fcn{i}')
              for i in range(1, 9)]
    pairs += [('roi_heads.keypoint_head.score_lowres', 'keypoint_head.score_lowres')]
    return [(f'{d2}.{leaf}', f'{ours}.{leaf}') for d2, ours in pairs
            for leaf in ('weight', 'bias')]


def detectron2_name_map() -> List[Tuple[str, str]]:
    '''The whole (Detectron2 name, port ``state_dict`` name) table.'''
    return _backbone_entries() + _head_entries()


# -- conversion --------------------------------------------------------------------------

def convert_detectron2_params(state: Mapping[str, np.ndarray],
                              template: Mapping[str, torch.Tensor]
                              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    '''Map a Detectron2 state onto a ``state_dict`` template.

    Returns ``(state_dict, report)``: a copy of ``template`` with every
    mapped tensor of matching shape replaced (in the template's dtype), and
    ``report`` listing ``loaded``, ``shape_mismatch`` (kept the template's
    values), ``missing_in_source`` and ``unused`` Detectron2 names. A
    loaded tensor takes the template tensor's device and dtype.
    '''
    out = {k: v.detach().clone() for k, v in template.items()}
    report: Dict[str, List[str]] = {'loaded': [], 'shape_mismatch': [],
                                    'missing_in_source': [], 'unused': []}
    used = set()
    for d2_name, name in detectron2_name_map():
        if name not in out:
            # a leaf this variant lacks (e.g. an un-normed FPN's conv bias)
            if d2_name in state:
                used.add(d2_name)
            continue
        if d2_name not in state:
            report['missing_in_source'].append(d2_name)
            continue
        used.add(d2_name)
        value = np.asarray(state[d2_name])
        target = out[name]
        if tuple(value.shape) != tuple(target.shape):
            report['shape_mismatch'].append(
                f'{d2_name}: source {tuple(value.shape)} vs model {tuple(target.shape)}')
            continue
        out[name] = torch.from_numpy(np.array(value, dtype=np.float32)).to(
            device=target.device, dtype=target.dtype)
        report['loaded'].append(d2_name)

    report['unused'] = sorted(
        k for k in state
        if k not in used and not k.startswith(('pixel_', 'anchor_generator')))
    return out, report


def convert_checkpoint(src_path: str, template: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    '''Load ``src_path`` (Detectron2 ``.pkl``/``.pth``) and map it onto
    ``template``.'''
    state = load_detectron2_state(src_path)
    params, report = convert_detectron2_params(state, template)
    logger.info('converted %s: %d loaded, %d shape-mismatched (kept init), '
                '%d missing, %d unused source keys', src_path,
                len(report['loaded']), len(report['shape_mismatch']),
                len(report['missing_in_source']), len(report['unused']))
    for line in report['shape_mismatch']:
        logger.info('  shape mismatch (kept init): %s', line)
    return params, report
