'''Label Studio tasks and the model's pre-annotations.

Port of ``moseq2_detectron_extract_tpu/dataset.py:155-216``:
:func:`write_label_studio_tasks` writes a tasks manifest, and
:func:`write_predictions_as_annotations` runs the model over the tasks'
images (the ``infer-dataset`` command) and writes each detection's outline
polygons (:func:`io.annot.mask_to_poly`) and keypoints in percent
coordinates as the task's ``predictions``. The frame sampling of the JAX
module (``generate-dataset``) is not ported yet.
'''
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from moseq2_detectron_extract_tpu_torch.io.util import ensure_dir


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
