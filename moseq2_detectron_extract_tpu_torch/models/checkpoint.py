'''Checkpoints in the model-dir layout of the JAX package.

Port of ``moseq2_detectron_extract_tpu/models/checkpoint.py``: a model dir
holds ``config.yaml``, numbered checkpoints under ``checkpoints/`` and a
``last_checkpoint`` pointer, or the compact ``params_f16.npz``. The lookup
order is the JAX package's: a checkpoint first, the npz when there is none.

Deviation: a checkpoint here is one ``torch.save`` file,
``checkpoints/model_<step:07d>.pt`` holding ``{step, model, optimizer}``
(the model's ``state_dict`` and the SGD momentum buffers), not an orbax
directory: the card's machine has no orbax. The npz
(``models.weights.save_params_npz``, importable from here as from the JAX
package's module) is the format both packages read.
'''
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from moseq2_detectron_extract_tpu_torch.io.util import ensure_dir
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.weights import (  # noqa: F401
    load_params_npz, params_from_jax, save_params_npz)

_CKPT_RE = re.compile(r'^model_(\d+)\.pt$')
NPZ_NAME = 'params_f16.npz'


def checkpoint_dir(model_dir: str) -> str:
    '''Directory holding numbered checkpoints.'''
    return os.path.join(model_dir, 'checkpoints')


def checkpoint_name(step: int) -> str:
    '''File name of the checkpoint at ``step``.'''
    return f'model_{step:07d}.pt'


def save_checkpoint(model_dir: str, step: int, state: Dict[str, Any]) -> str:
    '''Save ``state`` as ``checkpoints/model_<step>.pt`` and point
    ``last_checkpoint`` at it (written through a temporary file, so a killed
    save leaves the previous checkpoint in place).'''
    root = ensure_dir(checkpoint_dir(model_dir))
    path = os.path.abspath(os.path.join(root, checkpoint_name(step)))
    torch.save(state, path + '.tmp')
    os.replace(path + '.tmp', path)
    with open(os.path.join(model_dir, 'last_checkpoint'), 'w', encoding='utf-8') as fh:
        fh.write(os.path.basename(path))
    return path


def get_last_checkpoint(model_dir: str) -> Optional[str]:
    '''The latest checkpoint: the one ``last_checkpoint`` names, else the
    highest-numbered one present.'''
    pointer = os.path.join(model_dir, 'last_checkpoint')
    if os.path.exists(pointer):
        with open(pointer, 'r', encoding='utf-8') as fh:
            path = os.path.join(checkpoint_dir(model_dir), fh.read().strip())
        if os.path.isfile(path):
            return path
    root = checkpoint_dir(model_dir)
    if not os.path.isdir(root):
        return None
    steps = [(int(m.group(1)), name) for name in os.listdir(root)
             for m in [_CKPT_RE.match(name)] if m]
    return os.path.join(root, max(steps)[1]) if steps else None


def get_checkpoint(model_dir: str, checkpoint: str = 'last') -> Optional[str]:
    '''``'last'`` or a step number -> that checkpoint's path, or None.'''
    if checkpoint == 'last':
        return get_last_checkpoint(model_dir)
    path = os.path.join(checkpoint_dir(model_dir), checkpoint_name(int(checkpoint)))
    return path if os.path.isfile(path) else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    '''A checkpoint written by :func:`save_checkpoint`, on the CPU.'''
    return torch.load(path, map_location='cpu', weights_only=True)


def load_model_dir(model_dir: str, checkpoint: str = 'last'
                   ) -> Tuple[ModelConfig, Dict[str, torch.Tensor], Optional[int]]:
    '''(config, state_dict, step) of a model dir: its checkpoint, else its
    ``params_f16.npz`` (step None).'''
    cfg_path = os.path.join(model_dir, 'config.yaml')
    cfg = ModelConfig.from_yaml(cfg_path) if os.path.exists(cfg_path) else ModelConfig()
    ckpt_path = get_checkpoint(model_dir, checkpoint)
    npz_path = os.path.join(model_dir, NPZ_NAME)
    if ckpt_path is None:
        if not os.path.exists(npz_path):
            raise FileNotFoundError(f'no checkpoint and no {NPZ_NAME} in {model_dir}')
        state = params_from_jax(load_params_npz(npz_path),
                                box_pooler_resolution=cfg.box_pooler_resolution)
        return cfg, state, None
    restored = load_checkpoint(ckpt_path)
    return cfg, restored['model'], int(restored['step'])
