'''Extraction of one chunk through the device path.

The port's counterpart of what ``moseq2_detectron_extract_tpu/extract.py``
runs per chunk through its pipeline: ``InferenceStep`` (device prep and
detection), ``SelectInstancesStep`` (selection and window gather) and
``dispatch_instance_features`` (window clean and moments). Session IO, ROI
discovery, the host brain and the writers come in later slices.
'''
from typing import Dict, Optional

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.pipeline.steps import (run_inference,
                                                               select_instances)
from moseq2_detectron_extract_tpu_torch.proc.features import dispatch_instance_features
from moseq2_detectron_extract_tpu_torch.proc.tracker import CentroidTracker

# the extract CLI's defaults (cli.py:58-59, pipeline/steps.py:166-169)
DEFAULT_CONFIG = {'min_height': 0.0, 'max_height': 100.0, 'feature_window': 160,
                  'expected_instances': 1}


def make_tracker() -> CentroidTracker:
    '''The selection loop's tracker, with the extract settings.'''
    return CentroidTracker(distance_threshold=50, hit_counter_max=3)


def process_chunk(chunk_u8, predictor, config: Optional[Dict] = None,
                  tracker: Optional[CentroidTracker] = None) -> Dict:
    '''Run one sentinel-encoded (N, H, W) uint8 chunk through prep,
    detection, instance selection and the window feature stage.

    ``chunk_u8`` is a numpy array or tensor of host-prepped frames whose
    dropout pixels hold 255; it is moved to ``predictor.device``. Pass the
    same ``tracker`` for consecutive chunks of a session. Returns the
    selection's fields (see ``pipeline.steps.select_instances``) and
    ``feat_dispatch`` with ``cleaned_frames``, ``feat_masks`` and
    ``feats_dev`` (centroid in frame coordinates, orientation, axis_length).
    '''
    config = {**DEFAULT_CONFIG, **(config or {})}
    chunk = torch.as_tensor(np.asarray(chunk_u8)) if not torch.is_tensor(chunk_u8) \
        else chunk_u8
    if chunk.dtype != torch.uint8 or chunk.dim() != 3:
        raise ValueError('chunk_u8 must be an (N, H, W) uint8 array')
    if tracker is None:
        tracker = make_tracker()
    data = run_inference(chunk, predictor, config)
    data = select_instances(data, config, tracker)
    data['feat_dispatch'] = dispatch_instance_features(
        data['sel_masks'], data['raw_windows'], window_origins=data['win_origins'])
    return data
