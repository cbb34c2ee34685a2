'''Extraction of a session: the ``extract`` command's work.

The port's counterpart of ``moseq2_detectron_extract_tpu/extract.py``:
``extract_session`` (lines 28-159) runs a session through the pipeline's
threads and writes the results file, the keypoints TSV, the instance log
and the status YAML; ``prepare_session`` is its ROI discovery (lines
63-83); ``extract_chunks`` runs the same steps serially, chunk by chunk, in
the caller's thread: the frame producer, ``process_chunk`` (what the
reference's pipeline runs as ``InferenceStep``, device prep and detection,
and ``SelectInstancesStep``, selection, the window gather, the window clean
and moments and the height stats), then ``process_features``
(``ProcessFeaturesStep``: the host brain and the output ops) and
``fetch_results`` (``FetchResultsStep``: what the writers take). The
pipeline's preview steps render each chunk and encode it into
``results_NN.avi``, Motion-JPEG where the reference writes h264 or mp4v
into ``results_NN.mp4`` (the card's machine has no ffmpeg and no cv2).
'''
import logging
import os
import time
import uuid
from copy import deepcopy
from datetime import timedelta
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.io.session import Session, Stream
from moseq2_detectron_extract_tpu_torch.io.util import attach_file_logger, ensure_dir, write_yaml
from moseq2_detectron_extract_tpu_torch.pipeline.pipeline import Pipeline, WorkerError
from moseq2_detectron_extract_tpu_torch.pipeline.steps import (FeatureTrackers, FetchResultsStep,
                                                               InferenceStep, PreviewEncodeStep,
                                                               PreviewVideoWriterStep,
                                                               ProcessFeaturesStep,
                                                               ProduceFramesStep,
                                                               ResultWriterStep,
                                                               SelectInstancesStep,
                                                               dispatch_window_features,
                                                               fetch_results,
                                                               make_feature_trackers,
                                                               make_tracker,
                                                               process_features, produce_chunks,
                                                               run_inference,
                                                               run_inference_prescaled,
                                                               select_instances)
from moseq2_detectron_extract_tpu_torch.proc.tracker import CentroidTracker
from moseq2_detectron_extract_tpu_torch.proc.util import check_completion_status
from moseq2_detectron_extract_tpu_torch.utils.hostmem import tune_host_allocator
from moseq2_detectron_extract_tpu_torch.utils.profiling import span

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


def process_chunk(chunk_u8, predictor, config: Optional[Dict] = None,
                  tracker: Optional[CentroidTracker] = None) -> Dict:
    '''Run one sentinel-encoded (N, H, W) uint8 chunk through prep,
    detection, instance selection and the window feature stage.

    ``chunk_u8`` is a numpy array or tensor of host-prepped frames whose
    dropout pixels hold 255; it is moved to ``predictor.device``, or with
    ``config['device_input'] == 'prescaled'`` resized on the host first
    (``pipeline.steps.run_inference_prescaled``; the returned ``chunk``, a
    copy, then has its sentinels zeroed). Pass the same ``tracker`` for
    consecutive chunks of a session. Returns the
    selection's fields (see ``pipeline.steps.select_instances``),
    ``feat_dispatch`` with ``cleaned_frames``, ``feat_masks`` and
    ``feats_dev`` (centroid in frame coordinates, orientation, axis_length)
    and ``height_stats`` (see ``pipeline.steps.dispatch_window_features``).
    Recorded as the root span ``chunk``.
    '''
    with span('chunk'):
        return _process_chunk(chunk_u8, predictor, config, tracker)


def _process_chunk(chunk_u8, predictor, config: Optional[Dict],
                   tracker: Optional[CentroidTracker]) -> Dict:
    config = {**DEFAULT_CONFIG, **(config or {})}
    chunk = torch.as_tensor(np.asarray(chunk_u8)) if not torch.is_tensor(chunk_u8) \
        else chunk_u8
    if chunk.dtype != torch.uint8 or chunk.dim() != 3:
        raise ValueError('chunk_u8 must be an (N, H, W) uint8 array')
    if tracker is None:
        tracker = make_tracker()
    if config.get('device_input', 'full') == 'prescaled':
        # a copy: the selection zeroes the host chunk's sentinels in place
        host = np.array(chunk.cpu().numpy())
        data = run_inference_prescaled(host, predictor, config)
        data['chunk'] = host
    else:
        data = run_inference(chunk, predictor, config)
    data = select_instances(data, config, tracker)
    return dispatch_window_features(data, config)


def prepare_session(session: Session, config: Optional[Dict] = None, device='cuda',
                    verbose: bool = False) -> Dict:
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
                     cache_dir=config.get('output_dir'), verbose=verbose,
                     device=resolve_device(device))
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


def extract_session(session: Session, config: dict) -> str:
    '''Extract one session through the pipeline's threads; returns the path
    of its status YAML.

    ``config`` holds the extract command's options (``cli.py``); ``device``
    (default ``'cuda'``) runs the model and the device path, and
    ``predictor`` may hand in a loaded Predictor. Writes into
    ``output_dir`` (default: ``proc`` beside the session): ``results_NN.h5``,
    ``results_NN.avi`` (the preview), ``keypoints_NN.tsv``,
    ``instance_log.tsv``, the ROI caches,
    ``results_NN.log`` and ``results_NN.yaml`` (NN: ``bg_roi_index``). A
    session whose status already says ``complete: true`` is skipped. A
    failure of any step is logged, and the status keeps ``complete: false``:
    read the status, not the return value, to know whether it ran.
    '''
    start_time = time.time()
    # keep the chunk-sized host buffers heap-resident across chunks (glibc's
    # default mmap policy faults their pages in anew every chunk)
    tune_host_allocator()
    config.setdefault('device', 'cuda')
    if config.get('output_dir') is None:
        config['output_dir'] = os.path.join(session.dirname, 'proc')
    output_dir = ensure_dir(config['output_dir'])
    attach_file_logger(os.path.join(output_dir, f"results_{config['bg_roi_index']:02d}.log"))

    status_filename = os.path.join(output_dir, f"results_{config['bg_roi_index']:02d}.yaml")
    if check_completion_status(status_filename):
        logging.warning('WARNING: Session appears to already be extracted, so skipping!')
        return status_filename

    status_dict = {
        'complete': False,
        'skip': False,
        'uuid': str(uuid.uuid4()),
        'metadata': session.load_metadata(),
        'parameters': _yaml_safe_config(config),
    }
    write_yaml(status_filename, status_dict)

    try:
        prepared = prepare_session(session, config, device=config['device'], verbose=True)
        config.update({key: value for key, value in prepared.items() if key not in config})
        config.update({key: prepared[key] for key in ('nframes', 'true_depth', 'roi',
                                                      'first_frame', 'first_frame_idx',
                                                      'bground_im', 'timestamps')})
        config['status_dict'] = status_dict

        pipeline = Pipeline(show_progress=config.get('show_progress', True))
        produce = pipeline.add_step(' Read Depth Data', ProduceFramesStep, session=session,
                                    config=config)
        inference = pipeline.add_step(' Model Inference', InferenceStep, config=config)
        select = pipeline.add_step(' Instance Select', SelectInstancesStep, config=config)
        features = pipeline.add_step('Process Features', ProcessFeaturesStep,
                                     show_progress=True, config=config)
        fetch = pipeline.add_step('   Fetch Results', FetchResultsStep, config=config)
        preview = pipeline.add_step('   Preview Video', PreviewVideoWriterStep, config=config)
        encode = pipeline.add_step('  Preview Encode', PreviewEncodeStep, config=config)
        # the writer last: log_processing_status reads steps[-1]; its name is
        # the reference's, spelling included, so that stage_stats keys agree
        writer = pipeline.add_step('    Write Reults', ResultWriterStep, show_progress=True,
                                   config=config)
        pipeline.link(produce, inference)
        pipeline.link(inference, select)
        pipeline.link(select, features)
        pipeline.link(features, fetch)
        pipeline.link(fetch, preview, writer)
        pipeline.link(preview, encode)
        pipeline.add_timed_callback(30.0, log_processing_status)

        pipeline.start()
        while pipeline.is_running():
            time.sleep(0.1)
        pipeline.shutdown()

        status_dict['stage_stats'] = {
            step.step_name.strip(): {
                'busy_s': round(step.busy_seconds, 3),
                'cpu_s': round(step.cpu_seconds, 3),
                'chunks': step.items_processed,
                **({'sub_times': {k: round(v, 3) for k, v in step.sub_times.items()}}
                   if getattr(step, 'sub_times', None) else {}),
            } for step in pipeline.steps
        }
    except WorkerError as work_error:
        logging.error('')
        logging.error('One or more workers encountered an error during extraction:\n')
        for err in work_error.error_info:
            logging.error('Worker "%s" raised an exception:\n%s', err.name.strip(), err.message)
            logging.error('')
    except Exception:  # noqa: BLE001 - logged; the status keeps complete: false
        logging.error('')
        logging.error('Error during extraction', exc_info=True)
        logging.error('')
    else:
        status_dict['complete'] = True
        write_yaml(status_filename, status_dict)
        duration = time.time() - start_time
        fps = session.nframes / max(duration, 1e-6)
        logging.info('Finished processing %d frames in %s (approx. %.2f fps overall)',
                     session.nframes, timedelta(seconds=round(duration)), fps)
    return status_filename


def _yaml_safe_config(config: dict) -> dict:
    '''The config as the status file's ``parameters``: without the Predictor
    and the session's arrays.'''
    out = {}
    for key, value in config.items():
        if key in ('status_dict', 'predictor', 'roi', 'first_frame', 'bground_im',
                   'timestamps'):
            continue
        try:
            out[key] = deepcopy(value)
        except Exception:  # noqa: BLE001 - a value that cannot be copied is kept as text
            out[key] = str(value)
    return out


def log_processing_status(pipeline: Pipeline) -> None:
    '''A status line for the log file: frames written, of the total, and
    frames in progress.'''
    producer = pipeline.progress.get_stats(pipeline.steps[0].step_name)
    complete = pipeline.progress.get_stats(pipeline.steps[-1].step_name)
    if producer is None or complete is None:
        return
    total = producer['total'] or 0
    if total <= 0:
        return
    completed = complete['completed'] or 0
    in_progress = (producer['completed'] or 0) - completed
    nchar = len(str(total))
    logging.info('Completed processing %s / %s frames (%s) in %s, another %s frames in progress',
                 str(completed).rjust(nchar), total, f'{completed / total:.1%}'.rjust(6),
                 timedelta(seconds=round(producer['elapsed'] or 0)),
                 str(in_progress).rjust(nchar), extra={'nostream': True})
