'''JAX parameter trees <-> the port's ``state_dict``.

The committed model dirs hold ``params_f16.npz``: the flax params tree
flattened with ``/``-joined keys (``models/checkpoint.py:93-104``), e.g.
``params/backbone/res2_0/conv1/kernel``. :func:`params_from_jax` maps those
keys onto :class:`MaskKeypointRCNN`'s parameter names and inverts the layout
transforms of ``models/convert.py:15-33``:

* conv kernels          HWIO -> OIHW
* Dense kernels         (in, out) -> Linear (out, in)
* the first box FC      NHWC flatten order -> NCHW flatten order
* ConvTranspose kernels (kh, kw, in, out) -> (in, out, kh, kw), taps flipped
* FrozenBN              scale/bias/mean/var -> weight/bias/running_mean/running_var
* GroupNorm             scale/bias -> weight/bias

The npz is read at run time; no converted weights are stored.
:func:`params_to_jax` is the exact inverse, so :func:`save_params_npz`
writes the npz layout that both packages read.
'''
from typing import Dict, Mapping

import numpy as np
import torch

_BN_FIELDS = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
              'var': 'running_var'}
_DECONVS = {('mask_head', 'deconv'), ('keypoint_head', 'score_lowres')}
_BN_LEAVES = {v: k for k, v in _BN_FIELDS.items()}


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    '''The flat ``/``-keyed arrays of a ``params_f16.npz``, as float32.'''
    with np.load(path) as flat:
        return {key: flat[key].astype(np.float32) for key in flat.files}


def _bn_owner(block_keys, index: int) -> str:
    '''Conv whose norm flax auto-numbered ``FrozenBatchNorm_<index>`` in a
    bottleneck: the shortcut's norm is declared first when it exists.'''
    convs = (['shortcut'] if 'shortcut' in block_keys else []) + \
        ['conv1', 'conv2', 'conv3']
    return convs[index]


def params_from_jax(flat: Mapping[str, np.ndarray],
                    box_pooler_resolution: int = 7) -> Dict[str, torch.Tensor]:
    '''Map flat ``/``-joined flax param keys to a torch ``state_dict``.'''
    paths = {}
    for key, value in flat.items():
        parts = key.split('/')
        if parts and parts[0] == 'params':
            parts = parts[1:]
        paths[tuple(parts)] = np.array(value, dtype=np.float32)   # a writable copy

    block_convs: Dict[str, set] = {}
    for parts in paths:
        if parts[0] == 'backbone' and len(parts) == 4:
            block_convs.setdefault(parts[1], set()).add(parts[2])

    state: Dict[str, torch.Tensor] = {}
    for parts, value in paths.items():
        module, leaf = parts[:-1], parts[-1]
        if module[-1].startswith('FrozenBatchNorm_'):
            index = int(module[-1].rsplit('_', 1)[1])
            if len(module) == 2:                 # the stem's norm
                name = 'backbone.stem_norm'
            else:
                owner = _bn_owner(block_convs[module[1]], index)
                name = f'backbone.{module[1]}.{owner}_norm'
            state[f'{name}.{_BN_FIELDS[leaf]}'] = torch.from_numpy(value)
            continue
        name = '.'.join(module)
        if leaf == 'scale':                      # GroupNorm
            state[f'{name}.weight'] = torch.from_numpy(value)
        elif leaf == 'bias':
            state[f'{name}.bias'] = torch.from_numpy(value)
        elif leaf == 'kernel' and value.ndim == 4 and tuple(module[-2:]) in _DECONVS:
            state[f'{name}.weight'] = torch.from_numpy(
                np.ascontiguousarray(value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]))
        elif leaf == 'kernel' and value.ndim == 4:
            state[f'{name}.weight'] = torch.from_numpy(
                np.ascontiguousarray(value.transpose(3, 2, 0, 1)))
        elif leaf == 'kernel' and value.ndim == 2:
            weight = value.T
            if tuple(module) == ('box_head', 'fc1'):
                s = box_pooler_resolution
                out_dim, in_flat = weight.shape
                c = in_flat // (s * s)
                if c * s * s != in_flat:
                    raise ValueError(f'box fc1 input {in_flat} is not {s}x{s}xC')
                weight = weight.reshape(out_dim, s, s, c).transpose(0, 3, 1, 2) \
                    .reshape(out_dim, in_flat)
            state[f'{name}.weight'] = torch.from_numpy(np.ascontiguousarray(weight))
        else:
            raise ValueError(f'unmapped parameter {"/".join(parts)} {value.shape}')
    return state



def params_to_jax(state: Mapping[str, torch.Tensor],
                  box_pooler_resolution: int = 7) -> Dict[str, np.ndarray]:
    '''A port ``state_dict`` -> the flat ``params/...`` keys of the flax
    params tree, float32 (the inverse of :func:`params_from_jax`).'''
    arrays = {k: v.detach().to('cpu', torch.float32).numpy() for k, v in state.items()}
    flat: Dict[str, np.ndarray] = {}
    for key, value in arrays.items():
        parts = key.split('.')
        module, leaf = parts[:-1], parts[-1]
        if module[-1].endswith('_norm') and leaf in _BN_LEAVES:
            if module == ['backbone', 'stem_norm']:
                name = ['backbone', 'FrozenBatchNorm_0']
            else:
                block = module[1]
                owner = module[2][:-len('_norm')]
                convs = {p.split('.')[2] for p in arrays if p.startswith(f'backbone.{block}.')}
                index = (['shortcut'] if 'shortcut' in convs else [])
                index += ['conv1', 'conv2', 'conv3']
                name = ['backbone', block, f'FrozenBatchNorm_{index.index(owner)}']
            flat['/'.join(['params'] + name + [_BN_LEAVES[leaf]])] = value
            continue
        name = '/'.join(['params'] + module)
        if leaf == 'bias':
            flat[f'{name}/bias'] = value
        elif value.ndim == 1:                        # GroupNorm
            flat[f'{name}/scale'] = value
        elif value.ndim == 4 and tuple(module[-2:]) in _DECONVS:
            flat[f'{name}/kernel'] = np.ascontiguousarray(
                value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
        elif value.ndim == 4:
            flat[f'{name}/kernel'] = np.ascontiguousarray(value.transpose(2, 3, 1, 0))
        elif value.ndim == 2:
            weight = value
            if tuple(module) == ('box_head', 'fc1'):
                s = box_pooler_resolution
                out_dim, in_flat = weight.shape
                c = in_flat // (s * s)
                weight = weight.reshape(out_dim, c, s, s).transpose(0, 2, 3, 1) \
                    .reshape(out_dim, in_flat)
            flat[f'{name}/kernel'] = np.ascontiguousarray(weight.T)
        else:
            raise ValueError(f'unmapped parameter {key} {value.shape}')
    return flat


def save_params_npz(path: str, state: Mapping[str, torch.Tensor],
                    box_pooler_resolution: int = 7, dtype: str = 'float16') -> None:
    '''Write a ``state_dict`` as the JAX package's ``params_f16.npz``
    (``models/checkpoint.py:save_params_npz``): the flax keys, in ``dtype``.'''
    flat = params_to_jax(state, box_pooler_resolution)
    np.savez_compressed(path, **{k: v.astype(dtype) for k, v in flat.items()})
