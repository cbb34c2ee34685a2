'''Model export: a ``torch.export`` program beside the config and weights.

Port of ``moseq2_detectron_extract_tpu/models/deploy.py:24-89``. The
inference forward (:meth:`MaskKeypointRCNN.inference`) of the Predictor's
model, cast to its compute dtype and on its device, is exported at a fixed
batch of (B, 3, S, S) f32 normalized images and (B, 2) content sizes, so
that deployment runs the recorded program rather than the model's Python.
The ROIAlign launches are the registered op ``m2de::roi_align_bf16``
(``ops/roi_align_kernel.py``) in the graph, and the NMS fixpoints the
registered op ``m2de::nms_keep_mask`` (``ops/nms.py``). An exported model
loads back as a :class:`Predictor` that runs the program.

Deviation from the JAX package: the program is ``model.pt2``
(``torch.export.save``) in place of ``model.hlo`` (serialized StableHLO).
It holds its weights and runs on the device it was exported on.
'''
import logging
import os
from typing import Optional

import torch
from torch import nn

from moseq2_detectron_extract_tpu_torch.io.util import ensure_dir
from moseq2_detectron_extract_tpu_torch.models.checkpoint import (load_model_dir,
                                                                  save_checkpoint)
from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor

PROGRAM_NAME = 'model.pt2'


class _Inference(nn.Module):
    '''``MaskKeypointRCNN.inference`` as a module's forward, for export.'''

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor):
        return self.model.inference(images, image_sizes)


def export_model(model_dir: str, checkpoint: str = 'last',
                 output: Optional[str] = None, batch_size: int = 10,
                 image_size: Optional[int] = None, device='cuda') -> str:
    '''Export a model dir as ``{config.yaml, checkpoint, model.pt2}`` in
    ``output`` (default ``<model_dir>/export``); returns ``output``.

    The batch and the canvas are fixed in the program, as TorchScript fixed
    the reference's run parameters.
    '''
    cfg, state, step = load_model_dir(model_dir, checkpoint)
    if image_size is not None:
        cfg = cfg.replace(image_size=int(image_size))
    predictor = Predictor(cfg, state, batch_size=batch_size, device=device)
    s = cfg.image_size
    images = torch.zeros((batch_size, 3, s, s), dtype=torch.float32, device=predictor.device)
    sizes = torch.full((batch_size, 2), float(s), dtype=torch.float32, device=predictor.device)
    program = torch.export.export(_Inference(predictor.model), (images, sizes))

    output = output or os.path.join(model_dir, 'export')
    ensure_dir(output)
    path = os.path.join(output, PROGRAM_NAME)
    torch.export.save(program, path)
    cfg.to_yaml(os.path.join(output, 'config.yaml'))
    save_checkpoint(output, step or 0, {'step': step or 0, 'model': state})
    logging.info('exported a %d-byte torch.export program', os.path.getsize(path))
    return output


def program_batch(program) -> int:
    '''The batch size an exported program was traced at (its images input).'''
    names = program.graph_signature.user_inputs
    for node in program.graph.nodes:
        if node.op == 'placeholder' and node.name == names[0]:
            return int(node.meta['val'].shape[0])
    raise ValueError('the exported program has no images input')


def load_exported_model(export_dir: str, batch_size: Optional[int] = None,
                        device='cuda') -> Predictor:
    '''An exported model as a Predictor that runs the loaded program at the
    program's batch size (the default ``batch_size``); at another batch
    size it warns and runs the live model built from the config and the
    checkpoint, as the JAX package does.'''
    cfg, state, _ = load_model_dir(export_dir)
    path = os.path.join(export_dir, PROGRAM_NAME)
    program = torch.export.load(path) if os.path.exists(path) else None
    export_batch = program_batch(program) if program is not None else None
    if batch_size is None:
        batch_size = export_batch or 10
    predictor = Predictor(cfg, state, batch_size=batch_size, device=device)
    if program is not None and export_batch == batch_size:
        predictor._exported_forward = program.module()  # noqa: SLF001
    elif program is not None:
        logging.warning('exported program has batch %s but predictor batch is %d; '
                        'falling back to the live model', export_batch, batch_size)
    return predictor
