'''Steps of extraction: the host's chunks of prepped frames, then per chunk
inference, instance selection, the host brain, the output ops and the
results writer; as functions of one chunk, and as the pipeline's steps.

Port of ``moseq2_detectron_extract_tpu/pipeline/steps.py``:
``ProduceFramesStep`` (lines 40-86) as the generator ``produce_chunks``;
``InferenceStep.process`` (lines 112-155) as ``run_inference`` and, for
``device_input='prescaled'``, ``run_inference_prescaled``;
``SelectInstancesStep._select_instances`` (lines 200-310, with the instance
log; with the prescaled input, the depth windows cut on the host and
filled on the device, 288-302) and its height-stats dispatch (181-190),
``ProcessFeaturesStep`` (311-401) and ``FetchResultsStep`` (403-445), as
functions of one chunk; then the step classes around them,
``ResultWriterStep`` (447-494), and the preview's ``PreviewVideoWriterStep``
and ``PreviewEncodeStep`` (497-661), which write ``results_NN.avi``
(Motion-JPEG, where the reference writes ``results_NN.mp4``).

The steps run on threads of their own (``pipeline.Pipeline``) and launch
their device work on the device's default stream, so it runs in the order
the steps submit it and a tensor passes from one step to the next without
an event. Each chunk's device tensors are dropped by the last step that
reads them.
'''
import logging
import os
from functools import partial
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.io import hdf5
from moseq2_detectron_extract_tpu_torch.io.result import (create_extract_h5,
                                                          write_extracted_chunk_to_h5)
from moseq2_detectron_extract_tpu_torch.io.session import Session, Stream
from moseq2_detectron_extract_tpu_torch.models.instance_logger import InstanceLogger
from moseq2_detectron_extract_tpu_torch.ops.instances import (gather_selected_mask_windows,
                                                              gather_selected_windows,
                                                              packbits_device, unpackbits_host,
                                                              window_origins)
from moseq2_detectron_extract_tpu_torch.ops.preprocess import (decode_prepped_frames,
                                                               prep_raw_frames_host,
                                                               prescale_frames_host,
                                                               scale_raw_frames)
from moseq2_detectron_extract_tpu_torch.ops.warp import crop_and_rotate_frames
from moseq2_detectron_extract_tpu_torch.proc.features import (dispatch_instance_features,
                                                              finish_instance_features)
from moseq2_detectron_extract_tpu_torch.proc.kalman import (KalmanTracker, KalmanTrackerAngle,
                                                            KalmanTrackerNPoints2D,
                                                            KalmanTrackerPoint2D)
from moseq2_detectron_extract_tpu_torch.proc.keypoints import (dispatch_z_lookup,
                                                               keypoints_to_dict)
from moseq2_detectron_extract_tpu_torch.proc.scalars import (compute_scalars,
                                                             dispatch_scalar_stats)
from moseq2_detectron_extract_tpu_torch.pipeline.pipeline_step import PipelineStep
from moseq2_detectron_extract_tpu_torch.proc.tracker import CentroidTracker
from moseq2_detectron_extract_tpu_torch.utils.profiling import StageTimer, span

FeatureTrackers = Optional[Tuple[KalmanTracker, KalmanTracker]]


def produce_chunks(session: Session, config: Dict) -> Iterator[Dict]:
    '''The session's frames in chunks of ``config['chunk_size']``
    overlapping by ``chunk_overlap``, read and host-prepped
    ``read_block_frames`` (default 32) frames at a time with the session's
    background and ROI (``Session.find_roi`` first).

    Yields ``frame_idxs`` (the chunk's frames), ``chunk`` (prepped frames;
    with ``pad_chunks``, the default, a short tail chunk repeats its last
    frame up to ``chunk_size``) and ``offset`` (0 for the first chunk, then
    ``chunk_overlap``: the frames the previous chunk already gave).
    '''
    chunk_size = config['chunk_size']
    iterator = session.iterate(chunk_size=chunk_size, chunk_overlap=config['chunk_overlap'],
                               streams=(Stream.DEPTH,),
                               block_frames=config.get('read_block_frames', 32))
    iterator.attach_filter(Stream.DEPTH, partial(
        prep_raw_frames_host, bground_im=session.bground_im, roi=session.roi,
        vmin=config['min_height'], vmax=config['max_height'], dtype=config['frame_dtype']))
    for n, (frame_idxs, chunk) in enumerate(iterator):
        if chunk.shape[0] < chunk_size and config.get('pad_chunks', True):
            pad = chunk_size - chunk.shape[0]
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        yield {'frame_idxs': np.asarray(frame_idxs), 'chunk': chunk,
               'offset': 0 if n == 0 else config['chunk_overlap']}


def run_inference(chunk: torch.Tensor, predictor, config: Dict) -> Dict:
    '''Decode the sentinel-encoded uint8 chunk on the device, scale it, and
    run the predictor with the fused selection.

    Returns ``chunk_dev`` (the decoded (N, H, W) depth) and ``inference``.
    The upload is a blocking copy: once this returns, the host chunk is no
    longer read.
    '''
    chunk_dev = decode_prepped_frames(chunk.to(predictor.device, non_blocking=False))
    frames = scale_raw_frames(chunk_dev, config['min_height'], config['max_height'])
    return {'chunk_dev': chunk_dev, 'inference': predictor(frames)}


def run_inference_prescaled(chunk: np.ndarray, predictor, config: Dict) -> Dict:
    '''The prescaled input: fill the sentinel-encoded uint8 chunk's dropouts
    along the rows, scale and resize it to the model's canvas on the host
    (``prescale_frames_host``), and upload only that for the predictor
    (``predict_prescaled``, with the fused selection). The host chunk keeps
    its sentinels: ``select_instances`` cuts the depth windows from it.

    Returns ``inference`` and ``h2d_bytes``, the bytes of the upload.
    '''
    chunk = np.asarray(chunk)
    canvas = prescale_frames_host(chunk, predictor.cfg, vmin=config['min_height'],
                                  vmax=config['max_height'],
                                  fill_sentinel=np.iinfo(chunk.dtype).max)
    return {'inference': predictor.predict_prescaled(canvas, chunk.shape[1:], select=True),
            'h2d_bytes': canvas.nbytes}


def make_tracker() -> CentroidTracker:
    '''The selection loop's tracker, with the extract settings.'''
    return CentroidTracker(distance_threshold=50, hit_counter_max=3)


def select_instances(data: Dict, config: Dict, tracker: CentroidTracker,
                     instance_log: Optional[InstanceLogger] = None) -> Dict:
    '''Pick one instance per frame (host tracker over the small (N, D)
    arrays), then gather its mask, keypoints and depth window on the device.
    With ``instance_log``, each true frame (``data['frame_idxs']``) is
    logged with its kept detections, best first.

    Adds ``chosen_idx``, ``num_instances``, ``kept_boxes``, ``win_origins``
    (N, 2 [y0, x0]), ``sel_masks`` (N, c, c) uint8, ``sel_keypoints``
    (N, K, 3) and ``raw_windows`` (N, c, c). Without ``chunk_dev`` (the
    prescaled input) the depth windows are cut from the host ``chunk``,
    uploaded (their bytes added to ``h2d_bytes``) and filled on the device,
    and ``chunk`` then has its sentinels zeroed. The fetches are the span
    ``chunk.select.fetch``, the host tracker and the window origins
    ``chunk.select.track``.
    '''
    inference = data['inference']
    expected = config.get('expected_instances', 1)
    with span('chunk.select.fetch'):
        keep = inference['keep'].cpu().numpy()
        centers = inference['centers'].cpu().numpy()
        scores = inference['scores'].cpu().numpy()
        raw_boxes = inference['boxes'].cpu().numpy().astype('float64')
        iou = kpts_host = None
        if instance_log is not None and (keep.sum(axis=1) > 1).any():
            iou = inference['mask_iou'].cpu().numpy()
            kpts_host = inference['keypoints'].cpu().numpy()
    boxes = raw_boxes.copy()
    boxes[~keep] = np.nan
    n = keep.shape[0]
    n_true = len(data['frame_idxs']) if instance_log is not None else 0

    chunk_dev = data.get('chunk_dev')
    with span('chunk.select.track'):
        chosen_idx = np.zeros(n, dtype='int32')
        num_instances = np.zeros(n, dtype=int)
        for i in range(n):
            keep_idx = np.flatnonzero(keep[i])
            keep_idx = keep_idx[np.argsort(-scores[i][keep_idx])]
            if i < n_true:
                instance_log.log_frame(int(data['frame_idxs'][i]), keep_idx, scores[i],
                                       mask_iou=iou[i] if iou is not None else None,
                                       centers=centers[i],
                                       keypoints=kpts_host[i] if kpts_host is not None
                                       else None)
            tracked = tracker.update(centers[i], keep[i])
            if len(tracked) > 1:
                tracked.sort(key=lambda o: o.age, reverse=True)
                chosen = [o.last_detection_index for o in tracked[:expected]
                          if o.last_detection_index is not None]
            else:
                chosen = list(keep_idx[:expected])
            num_instances[i] = len(chosen)
            if chosen:
                chosen_idx[i] = chosen[0]

        # window seeds: the chosen detection's box centre [x, y] (NaN if none)
        chosen_boxes = raw_boxes[np.arange(n), chosen_idx]
        sel_centers = np.stack([(chosen_boxes[:, 0] + chosen_boxes[:, 2]) / 2,
                                (chosen_boxes[:, 1] + chosen_boxes[:, 3]) / 2], axis=1)
        sel_centers[num_instances <= 0] = np.nan
        h, w = data['chunk'].shape[1:] if chunk_dev is None else chunk_dev.shape[1:]
        crop = min(int(config.get('feature_window', 160)), h, w)
        origins = window_origins(sel_centers, (h, w), crop)
    dev = inference['masks'].device
    gather_args = (inference['masks'], inference['keypoints'],
                   torch.as_tensor(chosen_idx, dtype=torch.long, device=dev),
                   torch.as_tensor(num_instances > 0, device=dev),
                   torch.as_tensor(origins, device=dev))
    if chunk_dev is not None:
        mask_wins, sel_kpts, raw_wins = gather_selected_windows(*gather_args, chunk_dev,
                                                                crop=crop)
    else:
        # the prescaled input: cut the sentinel-encoded windows from the host
        # chunk, upload and fill them, then zero the host chunk's sentinels
        mask_wins, sel_kpts = gather_selected_mask_windows(*gather_args, crop=crop)
        chunk = np.asarray(data['chunk'])
        wins = np.empty((n, crop, crop), chunk.dtype)
        for i, (y0, x0) in enumerate(origins):
            wins[i] = chunk[i, y0:y0 + crop, x0:x0 + crop]
        raw_wins = decode_prepped_frames(torch.from_numpy(wins).to(dev))
        data['h2d_bytes'] = data.get('h2d_bytes', 0) + wins.nbytes
        data['chunk'] = zero_host_sentinels(chunk)
    data.update(kept_boxes=boxes, chosen_idx=chosen_idx,
                num_instances=num_instances, win_origins=origins,
                sel_masks=mask_wins, sel_keypoints=sel_kpts,
                raw_windows=raw_wins)
    return data


def dispatch_window_features(data: Dict, config: Dict) -> Dict:
    '''The selected windows' clean and moments, then the height stats of
    the raw windows under the feature masks, dispatched without a host sync.

    Adds ``feat_dispatch`` (see ``proc.features.dispatch_instance_features``)
    and ``height_stats`` (``proc.scalars.dispatch_scalar_stats``). Recorded
    as the span ``chunk.window_features``.
    '''
    with span('chunk.window_features'):
        data['feat_dispatch'] = dispatch_instance_features(
            data['sel_masks'], data['raw_windows'], window_origins=data['win_origins'])
        masked = data['raw_windows'] * data['feat_dispatch']['feat_masks']
        data['height_stats'] = dispatch_scalar_stats(masked, config['min_height'],
                                                     config['max_height'])
    return data


def make_feature_trackers(config: Dict) -> FeatureTrackers:
    '''The brain's (point, angle) Kalman trackers, or None without
    ``use_tracking``: the centroid and ``num_keypoints`` keypoints, and the
    angle in degrees, each of order 3 (constant jerk).'''
    if not config.get('use_tracking', True):
        return None
    point = KalmanTracker([KalmanTrackerPoint2D(order=3, delta_t=1.0),
                           KalmanTrackerNPoints2D(config.get('num_keypoints', 8), order=3,
                                                  delta_t=1.0)])
    angle = KalmanTracker([KalmanTrackerAngle(order=3, delta_t=1.0, degrees=True)])
    return point, angle


def process_features(data: Dict, config: Dict, trackers: FeatureTrackers,
                     timers: Optional[StageTimer] = None) -> Dict:
    '''The host brain on one chunk's window features, then the output ops
    on the device, dispatched without a host sync.

    Pops ``feat_dispatch`` and adds ``features`` (see
    ``proc.features.finish_instance_features``; ``timers`` times its host
    stages), ``z_dev`` (keypoint heights in the cleaned windows),
    ``dev_cropped`` ((N, crop_h, crop_w) depth rotated upright, rounded and
    clipped to ``frame_dtype``), ``dev_packed_masks`` (the feature masks
    cropped the same way, bit-packed) and, with ``preview_arena_masks``,
    ``dev_arena_packed`` (the feature-mask windows, bit-packed). Drops the
    chunk's large device inputs (``chunk_dev``, ``sel_masks``,
    ``raw_windows``, ``inference``).
    '''
    point_tracker, angle_tracker = trackers if trackers is not None else (None, None)
    features = finish_instance_features(
        data.pop('feat_dispatch'), data['sel_keypoints'], data['num_instances'],
        point_tracker, angle_tracker, debug=config.get('debug_feature_processing', False),
        debug_dir=config.get('output_dir', '.'), timers=timers)
    data['features'] = features
    n_true = len(data['frame_idxs'])
    empty = np.flatnonzero(np.asarray(data['num_instances'])[:n_true] <= 0)
    if len(empty):
        logging.warning('No instances found for frames %s',
                        np.asarray(data['frame_idxs'])[empty].tolist())
    data['z_dev'] = dispatch_z_lookup(features['keypoints'], features['cleaned_frames'],
                                      frame_origins=features['mask_origins'])

    crop = tuple(config['crop_size'])
    centroids = features['features']['centroid']
    angles = features['features']['orientation']
    # the feature masks are windows around each detection: crop them with
    # window-local centroids (taps outside the window are zero)
    mask_wins = features['masks'].to(torch.uint8)
    local_centroids = np.asarray(centroids, dtype='float64') - \
        np.asarray(data['win_origins'])[:, ::-1]
    if data.get('chunk_dev') is not None:
        cropped = crop_and_rotate_frames(data['chunk_dev'], centroids, angles, crop)
    else:
        # the prescaled input: crop the depth from the filled windows; taps
        # beyond a window are arena floor (0 in prepped depth)
        cropped = crop_and_rotate_frames(data['raw_windows'], local_centroids, angles, crop)
    cropped_masks = crop_and_rotate_frames(mask_wins, local_centroids, angles, crop)
    data['dev_cropped'] = torch.clamp(torch.round(cropped), 0, 255).to(
        getattr(torch, config['frame_dtype']))
    data['dev_packed_masks'] = packbits_device(cropped_masks > 0.5)
    if config.get('preview_arena_masks', True):
        data['dev_arena_packed'] = packbits_device(mask_wins > 0)
    for key in ('chunk_dev', 'sel_masks', 'raw_windows', 'inference'):
        data.pop(key, None)
    features.pop('cleaned_frames', None)
    features.pop('masks', None)
    return data


def fetch_results(data: Dict, config: Dict) -> Dict:
    '''Pull one chunk's device results to the host and assemble what the
    writers take.

    Pops ``height_stats``, ``z_dev``, ``dev_cropped``, ``dev_packed_masks``
    and ``dev_arena_packed``; adds ``scalars`` (the 17 fields of
    ``proc.scalars.compute_scalars``), ``keypoints`` (the dict of
    ``proc.keypoints.keypoints_to_dict``), ``depth_frames`` ((N, crop_h,
    crop_w) ``frame_dtype``), ``mask_frames`` ((N, crop_h, crop_w) uint8)
    and, with the arena masks, ``arena_mask_crops`` ((N, c, c) uint8
    windows) and ``arena_mask_origins`` ((N, 2 [y0, x0])).
    '''
    features = data['features']
    true_depth = config['true_depth']
    data['scalars'] = compute_scalars(
        None, features['features'], min_height=config['min_height'],
        max_height=config['max_height'], true_depth=true_depth,
        height_stats=data.pop('height_stats'))
    data['keypoints'] = keypoints_to_dict(
        features['keypoints'], None, features['features']['centroid'],
        features['features']['orientation'], true_depth=true_depth,
        frame_origins=features['mask_origins'], z_data=data.pop('z_dev'))
    data['depth_frames'] = data.pop('dev_cropped').cpu().numpy()
    data['mask_frames'] = unpackbits_host(data.pop('dev_packed_masks'),
                                          int(config['crop_size'][1])).astype('uint8')
    arena_packed = data.pop('dev_arena_packed', None)
    if arena_packed is not None:
        data['arena_mask_crops'] = unpackbits_host(arena_packed, int(arena_packed.shape[1]))
        data['arena_mask_origins'] = np.asarray(data['win_origins'])
    return data


def zero_host_sentinels(chunk: np.ndarray) -> np.ndarray:
    '''The host chunk with its dropout sentinels (dtype max) zeroed for the
    host's readers, in place, or on a copy when the chunk is read-only.'''
    if not chunk.flags.writeable:
        chunk = chunk.copy()
    np.copyto(chunk, 0, where=(chunk == np.iinfo(chunk.dtype).max))
    return chunk


# -- the pipeline's steps --------------------------------------------------------

class ProduceFramesStep(PipelineStep):
    '''The session's chunks of host-prepped frames (``produce_chunks``).'''

    def __init__(self, session: Session, **kwargs):
        super().__init__(**kwargs)
        self.session = session

    def initialize(self):
        self.reset_progress(self.session.nframes)

    def generate(self):
        for item in produce_chunks(self.session, self.config):
            self.update_progress(len(item['frame_idxs']))
            yield item


class InferenceStep(PipelineStep):
    '''Device decode, scaling and detection of each chunk (``run_inference``),
    or with ``device_input='prescaled'`` the host prescale and detection
    (``run_inference_prescaled``). The Predictor is ``config['predictor']``
    when given, else loaded from ``config['model']`` onto
    ``config['device']``.'''

    def initialize(self):
        self.device_input = self.config.get('device_input', 'full')
        if self.device_input not in ('full', 'prescaled'):
            raise ValueError(f'device_input must be full or prescaled, not {self.device_input!r}')
        predictor = self.config.get('predictor')
        if predictor is None:
            from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
            predictor = Predictor.from_model_dir(
                self.config['model'], batch_size=self.config.get('batch_size', 10),
                score_threshold=self.config.get('instance_threshold', 0.5),
                device=self.config.get('device', 'cuda'),
                checkpoint=str(self.config.get('checkpoint', 'last')))
        self.predictor = predictor

    def process(self, data):
        if self.device_input == 'prescaled' and np.asarray(data['chunk']).dtype != np.uint8:
            # the host prescale maps heights onto 0-255; the reference also
            # goes back to the full-resolution input for uint16 frames
            logging.warning("device_input='prescaled' requires uint8 frames; "
                            'falling back to full-resolution device input')
            self.device_input = 'full'
        if self.device_input == 'prescaled':
            # the host chunk keeps its sentinels: the selection cuts its depth
            # windows from it, then zeroes them
            data.update(run_inference_prescaled(data['chunk'], self.predictor, self.config))
        else:
            data.update(run_inference(torch.as_tensor(data['chunk']), self.predictor,
                                      self.config))
            # the upload has completed (run_inference): zero the sentinels for
            # the host's readers, as the reference does
            data['chunk'] = zero_host_sentinels(data['chunk'])
        self.update_progress(len(data['frame_idxs']))
        return data


class SelectInstancesStep(PipelineStep):
    '''Instance selection with the instance log (``instance_log.tsv`` in
    ``config['output_dir']``), then the window features' dispatch
    (``select_instances``, ``dispatch_window_features``).'''

    def initialize(self):
        self.tracker = make_tracker()
        self.instance_log = InstanceLogger(
            os.path.join(self.config['output_dir'], 'instance_log.tsv'))

    def process(self, data):
        data = select_instances(data, self.config, self.tracker, self.instance_log)
        data = dispatch_window_features(data, self.config)
        self.update_progress(len(data['frame_idxs']))
        return data

    def finalize(self):
        self.instance_log.close()


class ProcessFeaturesStep(PipelineStep):
    '''The host brain and the output ops' dispatch (``process_features``),
    with the feature trackers across the session's chunks.'''

    def initialize(self):
        self.trackers = make_feature_trackers(self.config)
        self.timer = StageTimer('features.')

    @property
    def sub_times(self) -> Dict[str, float]:
        '''Host seconds of the brain's stages (spans ``features.<stage>``).'''
        return self.timer.totals

    def process(self, data):
        data = process_features(data, self.config, self.trackers, timers=self.timer)
        self.update_progress(len(data['frame_idxs']))
        return data

    def finalize(self):
        logging.info('[Process Features] sub-stage busy: %s',
                     {k: round(v, 2) for k, v in self.sub_times.items()},
                     extra={'nostream': True})


class FetchResultsStep(PipelineStep):
    '''The chunk's results pulled to the host (``fetch_results``); the
    chunk's last device tensors are dropped here.'''

    def process(self, data):
        data = fetch_results(data, self.config)
        for key in [k for k, v in data.items() if torch.is_tensor(v)]:
            data.pop(key)
        self.update_progress(len(data['frame_idxs']))
        return data


class ResultWriterStep(PipelineStep):
    '''Each chunk's results into ``results_NN.h5`` and the cumulative
    ``keypoints_NN.tsv`` (NN: ``bg_roi_index``), at the rows of its frames
    less ``first_frame_idx``, without the ``offset`` frames a previous chunk
    wrote and the padded tail past the true frames.'''

    def initialize(self):
        config = self.config
        out_dir = config['output_dir']
        self.h5_path = os.path.join(out_dir, f"results_{config['bg_roi_index']:02d}.h5")
        self.tsv_path = os.path.join(out_dir, f"keypoints_{config['bg_roi_index']:02d}.tsv")
        self.h5 = hdf5.File(self.h5_path, 'w')
        create_extract_h5(self.h5, config, config['status_dict'],
                          param_annotations=config.get('param_annotations'))
        self.keypoint_rows: List[str] = []
        self.reset_progress(config['nframes'])

    def process(self, data):
        offset = data['offset']
        frame_idxs = np.asarray(data['frame_idxs']) - self.config.get('first_frame_idx', 0)
        n_true = len(frame_idxs)
        results = {
            'frame_idxs': frame_idxs[offset:],
            'offset': offset,
            'scalars': {k: v[:n_true] for k, v in data['scalars'].items()},
            'depth_frames': data['depth_frames'][:n_true],
            'mask_frames': data['mask_frames'][:n_true],
            'features': {'flips': np.asarray(data['features']['flips'])[:n_true]},
            'keypoints': {k: v[:n_true] for k, v in data['keypoints'].items()},
        }
        write_extracted_chunk_to_h5(self.h5, results)
        self.h5.flush()

        # the keypoints TSV, rewritten whole each chunk as the reference does;
        # each row is formatted once
        kp = data['keypoints']
        keys = sorted(kp.keys())
        if not self.keypoint_rows:
            self.keypoint_rows.append('\t'.join(['frame'] + keys))
        for row_i, frame in enumerate(frame_idxs[offset:], start=offset):
            self.keypoint_rows.append('\t'.join(
                [str(int(frame))] + [str(float(kp[k][row_i])) for k in keys]))
        with open(self.tsv_path, 'w', encoding='utf-8') as fh:
            fh.write('\n'.join(self.keypoint_rows) + '\n')
        self.update_progress(len(results['frame_idxs']))
        return data['frame_idxs']

    def finalize(self):
        self.h5.close()


class PreviewVideoWriterStep(PipelineStep):
    '''Render the 3-view preview of each chunk in blocks of 128 frames: the
    cleaned crop over the rotated keypoints on the left, the arena with the
    ROI outline, mask fill, boxes and keypoints on the right (``viz.py``),
    in BGR as the reference renders it; each block goes on to the encode
    step as it is rendered. ``sub_times`` holds the seconds spent taking the
    chunk apart (``marshal``) and rendering (``render``), each occurrence
    also a span ``preview.<stage>``.'''

    block = 128

    def initialize(self):
        from moseq2_detectron_extract_tpu_torch.viz import (ArenaView, CleanedFramesView,
                                                            RotatedKeypointsView)
        from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names
        config = self.config
        order = 'bgr'
        vmin, vmax = config['min_height'], config['max_height']
        self.arena_view = ArenaView(config.get('roi'), vmin=vmin, vmax=vmax,
                                    scale=config.get('preview_arena_scale', 1.0), order=order)
        self.rot_kpt_view = RotatedKeypointsView(scale=config.get('preview_crop_scale', 1.5),
                                                 order=order)
        self.clean_view = CleanedFramesView(vmin=vmin, vmax=vmax,
                                            scale=config.get('preview_crop_scale', 1.5),
                                            order=order)
        self.kp_names = default_keypoint_names
        self.timer = StageTimer('preview.', stages=('marshal', 'render'))
        # render buffers by (name, shape, slot); the composites travel to the
        # encode step, so they rotate through a ring with a slot for each block
        # a consumer queue can hold, one being consumed and one being rendered
        self._bufs: dict = {}
        self._ring = 1 + sum((q.maxsize if q.maxsize > 0 else 8) + 1
                             for q in self.output_queues)
        self._block_no = 0

    def _buf(self, name, shape, slot: int = 0):
        key = (name, shape[1:], slot)
        buf = self._bufs.get(key)
        if buf is None or buf.shape[0] < shape[0]:
            buf = np.zeros(shape, np.uint8)
            self._bufs[key] = buf
        return buf[:shape[0]]

    def _rotated_keypoints(self, kp_dict, n):
        cols = []
        for name in self.kp_names:
            x = kp_dict.get(f'rotated/{name}_x_px')
            y = kp_dict.get(f'rotated/{name}_y_px')
            if x is None or y is None:
                return None
            cols.append(np.stack([x[:n], y[:n]], axis=1))
        return np.stack(cols, axis=1)

    @property
    def sub_times(self) -> Dict[str, float]:
        return self.timer.totals

    def process(self, data):
        from moseq2_detectron_extract_tpu_torch.viz import stack_videos
        with self.timer.time('marshal'):
            offset = data['offset']
            n_true = len(data['frame_idxs'])
            chunk = np.asarray(data['chunk'])[offset:n_true]
            cropped = np.asarray(data['depth_frames'])[offset:n_true]
            masks = np.asarray(data['mask_frames'])[offset:n_true]
            frame_idxs = np.asarray(data['frame_idxs'])[offset:]
            arena_crops = data.get('arena_mask_crops')
            arena_origins = data.get('arena_mask_origins')
            if arena_crops is not None:
                arena_crops = arena_crops[offset:n_true]
                arena_origins = arena_origins[offset:n_true]
            ref_kpts = np.asarray(data['features']['keypoints'])[offset:n_true]
            boxes = data.get('kept_boxes')
            if boxes is not None:
                boxes = boxes[offset:n_true]
            rot_kpts = self._rotated_keypoints(data['keypoints'], n_true)
            if rot_kpts is not None:
                rot_kpts = rot_kpts[offset:]

        for s in range(0, len(frame_idxs), self.block):
            e = s + self.block
            with self.timer.time('render'):
                m = len(chunk[s:e])
                cs = self.clean_view.scale
                ch, cw = int(masks.shape[1] * cs), int(masks.shape[2] * cs)
                ah = int(chunk.shape[1] * self.arena_view.scale)
                aw = int(chunk.shape[2] * self.arena_view.scale)
                arena = self.arena_view.render(
                    chunk[s:e], mask_crops=None if arena_crops is None else arena_crops[s:e],
                    mask_origins=None if arena_origins is None else arena_origins[s:e],
                    keypoints=ref_kpts[s:e], boxes=None if boxes is None else boxes[s:e],
                    out=self._buf('arena', (m, ah, aw, 3)))
                clean = self.clean_view.render(cropped[s:e], masks[s:e],
                                               out=self._buf('clean', (m, ch, cw, 3)))
                if rot_kpts is not None:
                    rs = self.rot_kpt_view.scale
                    rh, rw = int(masks.shape[1] * rs), int(masks.shape[2] * rs)
                    rot = self.rot_kpt_view.render(masks[s:e], rot_kpts[s:e],
                                                   out=self._buf('rot', (m, rh, rw, 3)))
                    left = stack_videos([clean, rot], orientation='vertical',
                                        out=self._buf('left', (m, clean.shape[1] + rot.shape[1],
                                                               max(clean.shape[2],
                                                                   rot.shape[2]), 3)))
                else:
                    left = clean
                slot = self._block_no % self._ring
                self._block_no += 1
                composite = stack_videos(
                    [left, arena], orientation='horizontal',
                    out=self._buf('comp', (m, max(left.shape[1], arena.shape[1]),
                                           left.shape[2] + arena.shape[2], 3), slot=slot))
            self._forward({'frame_idxs': frame_idxs[s:e], 'composite': composite})
        return None

    def finalize(self):
        logging.info('[Preview Video] sub-stage busy: %s',
                     {k: round(v, 2) for k, v in self.sub_times.items()},
                     extra={'nostream': True})


class PreviewEncodeStep(PipelineStep):
    '''Encode the rendered blocks into ``results_NN.avi`` (NN:
    ``bg_roi_index``), a stage of its own so that the encode of one block
    overlaps the render of the next. The composites are the render step's
    ring buffers, not read again there, so the frame numbers are stamped in
    place.'''

    def initialize(self):
        from moseq2_detectron_extract_tpu_torch.io.video import PreviewVideoWriter
        config = self.config
        out_path = os.path.join(config['output_dir'], f"results_{config['bg_roi_index']:02d}.avi")
        self.writer = PreviewVideoWriter(out_path, fps=config.get('fps', 30),
                                         vmin=config['min_height'], vmax=config['max_height'],
                                         channel_order='bgr')

    def process(self, data):
        self.writer.write_frames(data['frame_idxs'], data['composite'], writable=True)
        return None

    def finalize(self):
        self.writer.close()
