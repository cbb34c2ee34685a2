'''Extraction of a session through the device path.

The port's counterpart of ``moseq2_detectron_extract_tpu/extract.py``:
``prepare_session`` is ``extract_session``'s ROI discovery (lines 63-83),
``extract_chunks`` its frame producer and, per chunk, ``process_chunk``
(what the reference's pipeline runs as ``InferenceStep``, device prep and
detection, and ``SelectInstancesStep``, selection, the window gather, the
window clean and moments and the height stats), then ``process_features``
(``ProcessFeaturesStep``: the host brain and the output ops) and
``fetch_results`` (``FetchResultsStep``: what the writers take). The
writers come in a later slice.
'''
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.io.session import Session, Stream
from moseq2_detectron_extract_tpu_torch.pipeline.steps import (FeatureTrackers,
                                                               dispatch_window_features,
                                                               fetch_results,
                                                               make_feature_trackers,
                                                               process_features, produce_chunks,
                                                               run_inference, select_instances)
from moseq2_detectron_extract_tpu_torch.proc.tracker import CentroidTracker

# the extract CLI's defaults (cli.py:46-66, pipeline/steps.py:166-169, 319-393)
DEFAULT_CONFIG = {'min_height': 0.0, 'max_height': 100.0, 'feature_window': 160,
                  'expected_instances': 1,
                  'bg_roi_dilate': (10, 10), 'bg_roi_shape': 'ellipse', 'bg_roi_index': 0,
                  'bg_roi_weights': (1, .1, 1), 'bg_roi_depth_range': (650, 750),
                  'bg_roi_gradient_filter': False, 'bg_roi_gradient_threshold': 3000,
                  'bg_roi_gradient_kernel': 7, 'bg_roi_fill_holes': True,
                  'use_plane_bground': False, 'frame_dtype': 'uint8', 'chunk_size': 1000,
                  'chunk_overlap': 0, 'frame_trim': (0, 0), 'crop_size': (80, 80),
                  'use_tracking': True, 'num_keypoints': 8, 'debug_feature_processing': False,
                  'preview_arena_masks': True}


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
    selection's fields (see ``pipeline.steps.select_instances``),
    ``feat_dispatch`` with ``cleaned_frames``, ``feat_masks`` and
    ``feats_dev`` (centroid in frame coordinates, orientation, axis_length)
    and ``height_stats`` (see ``pipeline.steps.dispatch_window_features``).
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
    return dispatch_window_features(data, config)


def prepare_session(session: Session, config: Optional[Dict] = None, device='cuda') -> Dict:
    '''Find the session's background, ROI and true depth on ``device``
    (``Session.find_roi`` with the config's ``bg_roi_*`` and
    ``use_plane_bground``, cached in ``config['output_dir']`` when it is
    set), and return the config with ``nframes``, ``true_depth``, ``roi``,
    ``bground_im``, ``first_frame``, ``first_frame_idx`` and ``timestamps``.

    ``frame_trim`` belongs to the session: ``Session(path, frame_trim)``.
    '''
    config = {**DEFAULT_CONFIG, **(config or {})}
    session.find_roi(bg_roi_dilate=config['bg_roi_dilate'],
                     bg_roi_shape=config['bg_roi_shape'],
                     bg_roi_index=config['bg_roi_index'],
                     bg_roi_weights=config['bg_roi_weights'],
                     bg_roi_depth_range=config['bg_roi_depth_range'],
                     bg_roi_gradient_filter=config['bg_roi_gradient_filter'],
                     bg_roi_gradient_threshold=config['bg_roi_gradient_threshold'],
                     bg_roi_gradient_kernel=config['bg_roi_gradient_kernel'],
                     bg_roi_fill_holes=config['bg_roi_fill_holes'],
                     use_plane_bground=config['use_plane_bground'],
                     cache_dir=config.get('output_dir'), device=resolve_device(device))
    config.update({'nframes': session.nframes, 'true_depth': session.true_depth,
                   'roi': session.roi, 'first_frame': session.first_frame,
                   'first_frame_idx': session.first_frame_idx,
                   'bground_im': session.bground_im,
                   'timestamps': session.load_timestamps(Stream.DEPTH)})
    return config


def extract_chunks(session: Session, predictor, config: Optional[Dict] = None,
                   tracker: Optional[CentroidTracker] = None,
                   feature_trackers: Optional[FeatureTrackers] = None) -> Iterator[Dict]:
    '''Each chunk of a prepared session (``prepare_session`` first) through
    ``process_chunk`` on ``predictor.device`` (CUDA unless the predictor was
    made for the CPU), then ``process_features`` and ``fetch_results``, with
    one selection tracker and one pair of feature trackers
    (``make_feature_trackers``) across the chunks.

    Yields ``process_chunk``'s output with ``frame_idxs``, ``offset`` (the
    leading frames a previous chunk already gave), ``nframes`` (the chunk's
    true frames; the rest of ``chunk`` is padding) and ``chunk`` (the
    prepped frames), and beside it what ``fetch_results`` gives the
    writers: ``scalars``, ``keypoints``, ``depth_frames``, ``mask_frames``,
    ``arena_mask_crops``, ``arena_mask_origins`` and ``features`` (with
    ``features``, ``flips``, ``keypoints`` and ``num_instances``), over all
    of the chunk's frames, padding included.
    '''
    config = {**DEFAULT_CONFIG, **(config or {})}
    if tracker is None:
        tracker = make_tracker()
    if feature_trackers is None:
        feature_trackers = make_feature_trackers(config)
    for item in produce_chunks(session, config):
        out = process_chunk(item['chunk'], predictor, config, tracker=tracker)
        out.update(item, nframes=len(item['frame_idxs']))
        # the back end pops what it consumes from a copy, so the chunk's
        # own outputs stay in the yielded dict beside the fetched results
        fetched = fetch_results(process_features(dict(out), config, feature_trackers), config)
        out.update({key: fetched[key] for key in fetched.keys() - out.keys()})
        yield out
