'''Outlier frames of a results file, written as range reports.

Port of ``moseq2_detectron_extract_tpu/quality.py`` (lines 1-72):
``collapse_indices_to_ranges``, ``_write_ranges`` and ``find_outliers_h5``,
which writes the same three reports beside the results file
(``<results>.nan_keypoints.txt``, ``.jumping_keypoints.txt`` and
``.flips.txt``, each at the first unused name), reading the file with the
port's HDF5 reader.
'''
import logging
import os
from typing import List, Optional, Tuple

import numpy as np

from moseq2_detectron_extract_tpu_torch.io import hdf5
from moseq2_detectron_extract_tpu_torch.io.util import find_unused_file_path
from moseq2_detectron_extract_tpu_torch.proc.keypoints import (default_keypoint_names,
                                                               find_nan_keypoints,
                                                               find_outliers_jumping,
                                                               load_keypoint_data_from_h5)


def collapse_indices_to_ranges(indices: np.ndarray) -> List[Tuple[int, int]]:
    '''Sorted frame indices as inclusive (start, stop) ranges.'''
    ranges: List[Tuple[int, int]] = []
    for idx in np.asarray(indices, dtype=int):
        if ranges and idx == ranges[-1][1] + 1:
            ranges[-1] = (ranges[-1][0], idx)
        else:
            ranges.append((idx, idx))
    return ranges


def _write_ranges(path: str, ranges: List[Tuple[int, int]]) -> None:
    with open(path, 'w', encoding='utf-8') as fh:
        for start, stop in ranges:
            fh.write(f'{start}-{stop}\n' if stop != start else f'{start}\n')


def find_outliers_h5(result_file: str, keypoint_names: Optional[List[str]] = None,
                     jumping_window: int = 4, jumping_thresh: float = 10) -> dict:
    '''Find the outlier frames of a results file and write their reports:
    frames with a NaN keypoint, frames where a keypoint jumps
    (``find_outliers_jumping``) and, where the file has flips, the frames
    where the flip changes. Returns each detector's frame indices.'''
    if keypoint_names is None:
        keypoint_names = [kp for kp in default_keypoint_names if kp != 'TailTip']
    base = os.path.splitext(result_file)[0]

    with hdf5.File(result_file, 'r') as h5:
        kp_data = load_keypoint_data_from_h5(h5, keypoints=keypoint_names + ['TailTip'],
                                             coord_system='reference', units='px')
        flips = h5['metadata/extraction/flips'][()] \
            if 'metadata/extraction/flips' in h5 else None

    nan_idx = find_nan_keypoints(kp_data)
    jump_idx, _dist, _out = find_outliers_jumping(kp_data, window=jumping_window,
                                                  thresh=jumping_thresh)

    out = {'nan_keypoints': nan_idx, 'jumping_keypoints': jump_idx}
    _write_ranges(find_unused_file_path(base + '.nan_keypoints.txt'),
                  collapse_indices_to_ranges(nan_idx))
    _write_ranges(find_unused_file_path(base + '.jumping_keypoints.txt'),
                  collapse_indices_to_ranges(jump_idx))

    if flips is not None:
        flip_changes = np.flatnonzero(np.diff(flips.astype(int)) != 0) + 1
        out['flip_changes'] = flip_changes
        _write_ranges(find_unused_file_path(base + '.flips.txt'),
                      collapse_indices_to_ranges(flip_changes))

    logging.info('Found %d frames with NaN keypoints, %d jumping-keypoint outliers',
                 len(nan_idx), len(jump_idx))
    return out
