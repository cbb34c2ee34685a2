'''Dataset generation: frames sampled from sessions for annotation, the
Label Studio tasks, and the model's pre-annotations.

Port of ``moseq2_detectron_extract_tpu/dataset.py``:
:func:`generate_dataset_for_sessions` (the ``generate-dataset`` command)
finds each session's ROI, samples its frames (``random``, ``uniform``,
``list``, or ``kmeans``: one frame per cluster of a mini-batch k-means over
4x-downsampled prepped frames, ``proc/kmeans.py``), and writes them as
``_depth.png`` images with an ``info.json`` per session;
:func:`write_label_studio_tasks` writes the tasks manifest, and
:func:`write_predictions_as_annotations` runs the model over the tasks'
images (the ``infer-dataset`` command) and writes each detection's outline
polygons (:func:`io.annot.mask_to_poly`) and keypoints in percent
coordinates as the task's ``predictions``.

The sessions' ``rgb.mp4`` is h264, which the port does not decode:
``with_rgb`` logs that and writes depth images only, where the JAX package
also writes ``_rgb.png`` images when cv2 can read the file.
'''
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.io.util import ensure_dir


def kmeans_features(session, min_height: float, max_height: float, downsample: int = 4,
                    chunk_size: int = 1000, device='cuda') -> Tuple[torch.Tensor, np.ndarray]:
    '''The k-means data of a session on ``device``: every frame prepped
    (``ops/preprocess.py:prep_raw_frames``), downsampled ``downsample``
    times and flattened to f32 rows; and the rows' frame indices.'''
    from moseq2_detectron_extract_tpu_torch.io.session import Stream
    from moseq2_detectron_extract_tpu_torch.ops.preprocess import prep_raw_frames

    feats, idxs = [], []
    iterator = session.iterate(chunk_size=chunk_size)
    iterator.attach_filter(Stream.DEPTH, lambda f: prep_raw_frames(
        f, bground_im=session.bground_im, roi=session.roi, vmin=min_height, vmax=max_height,
        dtype='uint8', device=device))
    for frame_idxs, chunk in iterator:
        small = chunk[:, ::downsample, ::downsample]
        feats.append(small.reshape(small.shape[0], -1).float())
        idxs.extend(frame_idxs)
    return torch.cat(feats), np.asarray(idxs)


def pick_frames_kmeans(data: torch.Tensor, idxs: np.ndarray, num_samples: int) -> List[int]:
    '''The frame of the member nearest each centre of a mini-batch k-means
    (``proc/kmeans.py``, k = ``min(num_samples, rows)``) of ``data``, in frame
    order.'''
    from moseq2_detectron_extract_tpu_torch.proc.kmeans import minibatch_kmeans, nearest_members
    centers, labels, _ = minibatch_kmeans(data, min(num_samples, len(idxs)))
    nearest = nearest_members(data, centers, labels)
    return sorted(int(idxs[m]) for m in nearest if m >= 0)


def select_frames_kmeans(session, num_samples: int, min_height: float, max_height: float,
                         downsample: int = 4, chunk_size: int = 1000,
                         device='cuda') -> List[int]:
    '''Diverse frames: :func:`pick_frames_kmeans` of
    :func:`kmeans_features` (``m2de/dataset.py:236-288``).'''
    data, idxs = kmeans_features(session, min_height, max_height, downsample=downsample,
                                 chunk_size=chunk_size, device=device)
    return pick_frames_kmeans(data, idxs, num_samples)


def prepare_session_iterator(session, sample_method: str, num_samples: int,
                             frame_indices: Optional[Sequence[int]], min_height: float,
                             max_height: float, device='cuda'):
    '''The frame iterator of a sampling method (``m2de/dataset.py:135-171``):
    ``random`` draws from numpy's global generator.'''
    if sample_method == 'random':
        return session.sample(num_samples)
    if sample_method == 'uniform':
        step = max(session.nframes // max(num_samples, 1), 1)
        return session.index(list(range(0, session.nframes, step))[:num_samples])
    if sample_method == 'kmeans':
        return session.index(select_frames_kmeans(session, num_samples, min_height, max_height,
                                                  device=device))
    if sample_method == 'list':
        if not frame_indices:
            raise ValueError('sample_method=list requires frame indices')
        return session.index(list(frame_indices))
    raise ValueError(f'unknown sample method {sample_method}')


def produce_frames(session, iterator, output_dir: str) -> List[Dict]:
    '''Write the iterator's depth frames as ``<session>_frame_<index>_depth.png``
    under ``output_dir``; their Label Studio tasks (``m2de/dataset.py:175-217``).'''
    from moseq2_detectron_extract_tpu_torch.io.image import write_image

    ensure_dir(output_dir)
    tasks = []
    for batch in iterator:
        frame_idxs, depth_frames = batch[0], np.asarray(batch[1])
        for i, frame_idx in enumerate(frame_idxs):
            name = f'{session.session_id}_frame_{int(frame_idx):08d}'
            depth_path = os.path.join(output_dir, name + '_depth.png')
            write_image(depth_path, depth_frames[i], scale=False, dtype='uint8')
            tasks.append({'id': name,
                          'data': {'depth_image': depth_path, 'session_id': session.session_id,
                                   'frame_index': int(frame_idx)}})
    return tasks


def generate_dataset_for_session(input_file: str, output_dir: str, num_samples: int = 100,
                                 sample_method: str = 'random',
                                 frame_indices: Optional[Sequence[int]] = None,
                                 min_height: float = 0, max_height: float = 100,
                                 bg_roi_depth_range: Tuple[float, float] = (650, 750),
                                 with_rgb: bool = False, device='cuda') -> List[Dict]:
    '''ROI discovery, sampling and the PNGs of one session, and its
    ``info.json`` (``m2de/dataset.py:26-132``); returns its tasks.'''
    from moseq2_detectron_extract_tpu_torch.io.session import Session, Stream
    from moseq2_detectron_extract_tpu_torch.ops.preprocess import (prep_raw_frames,
                                                                   scale_raw_frames)

    session = Session(input_file)
    session.find_roi(bg_roi_depth_range=bg_roi_depth_range,
                     cache_dir=ensure_dir(os.path.join(output_dir, 'cache', session.session_id)),
                     device=device)
    iterator = prepare_session_iterator(session, sample_method, num_samples, frame_indices,
                                        min_height, max_height, device=device)
    iterator.attach_filter(Stream.DEPTH, lambda f: scale_raw_frames(prep_raw_frames(
        f, bground_im=session.bground_im, roi=session.roi, vmin=min_height, vmax=max_height,
        dtype='uint8', device=device), min_height, max_height).cpu().numpy())
    if with_rgb:
        logging.warning('%s: rgb.mp4 is not read (the port decodes no h264); writing depth '
                        'frames only', session.session_id)
    tasks = produce_frames(session, iterator, os.path.join(output_dir, session.session_id))
    with open(os.path.join(output_dir, session.session_id, 'info.json'), 'w',
              encoding='utf-8') as fh:
        json.dump({'session': str(session), 'num_samples': len(tasks),
                   'sample_method': sample_method, 'true_depth': session.true_depth}, fh,
                  indent=2)
    return tasks


def generate_dataset_for_sessions(input_files: Sequence[str], output_dir: str,
                                  **kwargs) -> List[Dict]:
    ''':func:`generate_dataset_for_session` over several sessions; all their tasks.'''
    ensure_dir(output_dir)
    tasks: List[Dict] = []
    for input_file in input_files:
        logging.info('Sampling session %s', input_file)
        tasks.extend(generate_dataset_for_session(input_file, output_dir, **kwargs))
    return tasks


def write_label_studio_tasks(tasks: List[Dict], output_dir: str,
                             filename: str = 'tasks.json') -> str:
    '''Write the Label Studio tasks manifest (``m2de/dataset.py:221-233``).'''
    path = os.path.join(ensure_dir(output_dir), filename)
    with open(path, 'w', encoding='utf-8') as fh:
        json.dump(tasks, fh, indent=2)
    return path


def write_predictions_as_annotations(tasks_file: str, model_dir: str,
                                     checkpoint: str = 'last',
                                     output: Optional[str] = None,
                                     instance_threshold: float = 0.5,
                                     device='cuda') -> str:
    '''Run the model over the tasks and write Label Studio pre-annotations
    (polygon and keypoint results in percent coordinates,
    ``m2de/cli.py:519-632``); returns the output's path.'''
    from moseq2_detectron_extract_tpu_torch.io.annot import get_image_path, mask_to_poly
    from moseq2_detectron_extract_tpu_torch.io.image import read_image
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names

    predictor = Predictor.from_model_dir(model_dir, checkpoint=checkpoint, batch_size=1,
                                         score_threshold=instance_threshold, device=device)
    with open(tasks_file, 'r', encoding='utf-8') as fh:
        tasks = json.load(fh)

    for task in tasks:
        image = np.atleast_3d(read_image(get_image_path(task)))[:, :, 0].astype('uint8')
        h, w = image.shape
        out = predictor(torch.from_numpy(image[None]))
        valid, masks, keypoints = (out[k][0].cpu().numpy()
                                   for k in ('valid', 'masks', 'keypoints'))
        results = []
        for d in np.flatnonzero(valid):
            for contour in mask_to_poly(masks[d]):
                pts = contour.reshape(-1, 2).astype(float)
                results.append({
                    'type': 'polygonlabels',
                    'original_width': w, 'original_height': h,
                    'from_name': 'label', 'to_name': 'image',
                    'value': {
                        'points': [[100.0 * y / h, 100.0 * x / w] for x, y in pts],
                        'polygonlabels': ['mouse'],
                    },
                })
            for ki, kname in enumerate(default_keypoint_names):
                x, y, score = keypoints[d, ki]
                results.append({
                    'type': 'keypointlabels',
                    'original_width': w, 'original_height': h,
                    'from_name': 'keypoints', 'to_name': 'image',
                    'value': {'x': 100.0 * float(x) / w, 'y': 100.0 * float(y) / h,
                              'keypointlabels': [kname], 'score': float(score)},
                })
        task['predictions'] = [{'result': results}]

    output = output or (os.path.splitext(tasks_file)[0] + '.predictions.json')
    with open(output, 'w', encoding='utf-8') as fh:
        json.dump(tasks, fh, indent=2)
    return output
