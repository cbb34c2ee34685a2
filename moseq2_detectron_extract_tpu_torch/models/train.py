'''Training state, LR schedule, optimizer and the train step.

Port of ``moseq2_detectron_extract_tpu/models/train.py``. The optimizer is
optax's chain in its order: non-finite gradient values set to 0, clipping
by the global norm (scaled by ``max_norm / norm`` unless ``norm <
max_norm``, as ``optax.clip_by_global_norm``; ``clip_grad_norm_`` adds
1e-6 to the norm, so it is not used), then ``torch.optim.SGD`` with
momentum and weight decay, which applies the decay and the momentum trace
as ``add_decayed_weights`` and ``sgd`` do (its first update is the
gradient, as optax's trace starting at zero gives). The LR is read at the
step before it is incremented, as ``optax.sgd`` reads its count.

FrozenBN statistics are buffers, so they get no update (optax's
``set_to_zero``); ``freeze_at`` is read and unused, as in the JAX package.
The weights start as flax's defaults do: conv, dense and conv-transpose
kernels ``lecun_normal`` (a normal truncated at 2 sigma, fan-in kh*kw*in),
biases 0, GroupNorm 1 and 0. Parameters stay f32; each layer casts them to
the compute dtype in its forward (``models/layers.py``).
'''
import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
from moseq2_detectron_extract_tpu_torch.utils.profiling import span

# scipy's truncated normal on [-2, 2] has this std; flax divides it out
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class TrainState:
    '''The carried training state: the step, the model (f32 parameters) and
    its optimizer (the momentum buffers).'''
    step: int
    model: MaskKeypointRCNN
    optimizer: torch.optim.SGD


def lr_schedule(cfg: ModelConfig) -> Callable[[int], float]:
    '''Warmup and multi-step decay (Detectron2's WarmupMultiStepLR), in f32
    as the JAX schedule computes it.'''
    def schedule(step: int) -> float:
        f32 = np.float32
        lr = f32(cfg.base_lr)
        for boundary in cfg.lr_steps:
            if step >= boundary:
                lr = f32(lr * f32(cfg.lr_gamma))
        warm = min(f32(step) / f32(max(cfg.warmup_iters, 1)), f32(1.0))
        factor = f32(cfg.warmup_factor) + f32(1.0 - cfg.warmup_factor) * warm
        return float(f32(lr * factor))
    return schedule


def init_flax_defaults(model: nn.Module, generator: torch.Generator) -> nn.Module:
    '''flax's default initialisation: kernels lecun_normal, biases 0,
    GroupNorm scale 1 and bias 0 (FrozenBN buffers stay the identity).'''
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose2d):      # (in, out, kh, kw)
                    fan_in = w.shape[0] * math.prod(w.shape[2:])
                else:                                      # (out, in, ...)
                    fan_in = math.prod(w.shape[1:])
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model


def make_optimizer(cfg: ModelConfig, model: nn.Module) -> torch.optim.SGD:
    '''SGD with momentum and weight decay over every parameter (the LR is
    set before each step from :func:`lr_schedule`).'''
    return torch.optim.SGD(model.parameters(), lr=lr_schedule(cfg)(0),
                           momentum=cfg.momentum, weight_decay=cfg.weight_decay)


def create_train_state(cfg: ModelConfig, seed: int = 0, device='cuda') -> TrainState:
    '''A freshly initialised model (from ``seed``, on the CPU, then moved)
    and its optimizer, at step 0.'''
    dev = resolve_device(device)
    model = MaskKeypointRCNN(cfg)
    init_flax_defaults(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    return TrainState(step=0, model=model, optimizer=make_optimizer(cfg, model))


def zero_nonfinite(grads) -> None:
    '''Set every NaN and +/-inf value of the gradient tensors ``grads`` to 0,
    in place. A single inf (a bf16 overflow) would otherwise make the global
    norm inf, the clip's scale 0 and inf * 0 NaN in every parameter.'''
    for g in grads:
        torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)


def clean_and_clip_gradients(params, max_norm: float) -> torch.Tensor:
    '''Set non-finite gradient values to 0 (:func:`zero_nonfinite`), then
    scale all gradients by ``max_norm / norm`` when their global norm is not
    below ``max_norm`` (``optax.clip_by_global_norm``). Returns the norm
    after the cleaning.'''
    grads = [p.grad for p in params if p.grad is not None]
    zero_nonfinite(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if max_norm:
        for g in grads:
            g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def apply_gradients(state: TrainState, cfg: ModelConfig) -> float:
    '''One optimizer update from the gradients in ``.grad``; increments the
    step and returns the LR it used.'''
    params = [p for group in state.optimizer.param_groups for p in group['params']]
    clean_and_clip_gradients(params, cfg.grad_clip_norm)
    lr = lr_schedule(cfg)(state.step)
    for group in state.optimizer.param_groups:
        group['lr'] = lr
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return lr


def make_train_step(cfg: ModelConfig):
    '''``(state, batch, draws) -> (state, metrics)``: losses, backward and
    one optimizer update. ``batch`` holds images (B, 3, S, S) normalized f32
    and the gt dict of :meth:`MaskKeypointRCNN.losses`; ``draws`` that
    method's random draws. The metrics stay on the device. The three parts
    are the spans ``train.forward``, ``train.backward`` and
    ``train.optimizer``.'''
    def train_step(state: TrainState, batch: Dict, draws) -> tuple:
        with span('train.forward'):
            losses = state.model.losses(batch['images'], batch['gt'], draws)
        with span('train.backward'):
            losses['total_loss'].backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        with span('train.optimizer'):
            metrics['lr'] = apply_gradients(state, cfg)
        return state, metrics
    return train_step


def make_eval_loss_step(cfg: ModelConfig):
    '''``(model, batch, draws) -> losses`` without gradients (the validation
    loss, LossEvalHook).'''
    del cfg

    @torch.no_grad()
    def eval_step(model: MaskKeypointRCNN, batch: Dict, draws) -> Dict[str, torch.Tensor]:
        return model.losses(batch['images'], batch['gt'], draws)
    return eval_step
