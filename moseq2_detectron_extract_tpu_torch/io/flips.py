'''Manual flip corrections of a results file: the flips file, the layered
``flips_N`` datasets and their XOR, and the flip itself with the keypoints
recomputed.

Port of ``moseq2_detectron_extract_tpu/io/flips.py`` (lines 1-169). The
reference opens the file ``r+`` and writes into it; ``flip_dataset`` here
writes the whole file anew beside it and renames it onto the old one
(``io.hdf5.rewrite``), the frames and masks a block of rows at a time, so a
failed flip leaves the file whole.
'''
import itertools
import sys
from datetime import datetime
from functools import reduce
from typing import List, Optional, Tuple

import numpy as np

from moseq2_detectron_extract_tpu_torch.io import hdf5
from moseq2_detectron_extract_tpu_torch.proc.angles import clamp_angles_rad
from moseq2_detectron_extract_tpu_torch.proc.keypoints import (keypoints_to_dict,
                                                               load_keypoint_data_from_h5)


def count_frames(h5_file: str, frames_path: str = '/frames') -> int:
    '''The number of frames of a results file.'''
    with hdf5.File(h5_file, 'r') as h5:
        return h5[frames_path].shape[0]


def read_flips_file(file_path: str, verify: bool = True, verify_vmin: int = 0,
                    verify_vmax: int = sys.maxsize) -> List[Tuple[int, int]]:
    '''The (start, stop) ranges of a flips file: one ``start-stop`` pair of
    integers a line, ``#`` starting a comment. With ``verify`` the ranges
    are checked (``verify_ranges``); a bad file raises RuntimeError.'''
    flips: List[Tuple[int, int]] = []
    with open(file_path, 'r', encoding='utf-8') as flip_file:
        for lno, line in enumerate(flip_file):
            line = line.strip()
            if not line or line[0] == '#':
                continue
            if '#' in line:
                line = line.split('#')[0]
            try:
                parts = [int(i.strip()) for i in line.split('-')]
            except ValueError as exc:
                raise RuntimeError(
                    f'File {file_path} line {lno + 1}: Expected only integer '
                    f'indicies! "{line}"') from exc
            if len(parts) != 2:
                raise RuntimeError(
                    f'File {file_path} line {lno + 1}: Expected exactly 2 indicies, '
                    f'but recieved {len(parts)}! "{line}"')
            flips.append((parts[0], parts[1]))

    if verify:
        try:
            verify_ranges(flips, vmin=verify_vmin, vmax=verify_vmax)
        except RuntimeError as exc:
            raise RuntimeError(f'File {file_path}:\n{exc}') from exc
    return flips


def verify_ranges(ranges: List[Tuple[int, int]], vmin: int = 0,
                  vmax: int = sys.maxsize) -> bool:
    '''Check each range's bounds and that no two overlap; raises
    RuntimeError with every error found.'''
    errors = []
    for start, stop in ranges:
        if stop < start:
            errors.append(f'Range ({start}, {stop}) stop cannot be less than start')
        if start < vmin:
            errors.append(f'Range ({start}, {stop}) start cannot be less than {vmin}')
        if stop > vmax:
            errors.append(f'Range ({start}, {stop}) stop cannot be greater than {vmax}')
    for r1, r2 in itertools.combinations(ranges, 2):
        if max(r1[0], r2[0]) < min(r1[1], r2[1]):
            errors.append(f'Range ({r1[0]}, {r1[1]}) overlaps with range '
                          f'({r2[0]}, {r2[1]})')
    if errors:
        raise RuntimeError('\n'.join(errors))
    return True


def find_unused_dataset_path(h5_file: str, path: str) -> str:
    '''The first ``<path>_N`` that names no dataset of the file.'''
    with hdf5.File(h5_file, 'r') as h5:
        i = 0
        while f'{path}_{i}' in h5:
            i += 1
        return f'{path}_{i}'


def flip_horizontal(data: np.ndarray) -> np.ndarray:
    '''Frames turned by 180 degrees (the reference's "horizontal flip").'''
    return np.rot90(data, k=2, axes=(-2, -1))


def flip_vertical(data: np.ndarray) -> np.ndarray:
    '''Frames mirrored top to bottom.'''
    return np.flip(data, axis=-2)


def _layers(h5, flips_path: str) -> List[np.ndarray]:
    parent, leaf = flips_path.rsplit('/', 1)
    return [h5[f'{parent}/{k}'][()] for k in sorted(h5[parent].keys())
            if k.startswith(f'{leaf}_')]


def _xor(layers: List[np.ndarray]) -> np.ndarray:
    return reduce(np.logical_xor, layers, np.zeros_like(layers[0]))


def recompute_flips(h5, flips_path: str = '/metadata/extraction/flips') -> np.ndarray:
    '''The canonical flips: the XOR of the file's ``flips_N`` layers (``h5``
    a file opened with ``io.hdf5.File(path, 'r')``).'''
    return _xor(_layers(h5, flips_path))


def flip_dataset(h5_file: str, flip_mask: Optional[np.ndarray] = None,
                 flip_ranges: Optional[List[Tuple[int, int]]] = None,
                 frames_path: str = '/frames', frames_mask_path: str = '/frames_mask',
                 angle_path: str = '/scalars/angle',
                 flips_path: str = '/metadata/extraction/flips',
                 flip_class: int = 1) -> None:
    '''Flip the frames a mask or ranges name: their frames and masks turned
    by 180 degrees and pi added to their angles; the flip recorded as a new
    layer ``<flips_path>_N`` (the first flip also keeps the extraction's
    flips as ``_0``) and the canonical flips made the XOR of the layers;
    the keypoints' mm and rotated values recomputed from the new angles.'''
    if flip_ranges is None and flip_mask is None:
        raise RuntimeError('One of flip_mask or flip_ranges must be supplied!')
    if flip_ranges is not None and flip_mask is not None:
        raise RuntimeError('Cannot supply both flip_mask and flip_ranges!')

    with hdf5.File(h5_file, 'r') as h5:
        nframes = h5[frames_path].shape[0]
        if flip_ranges is not None:
            verify_ranges(flip_ranges, vmax=nframes)
            real_flip_mask = np.zeros(nframes, dtype=bool)
            for start, stop in flip_ranges:
                real_flip_mask[start:stop] = bool(flip_class)
        else:
            real_flip_mask = (np.asarray(flip_mask) == flip_class)

        # the layers: flips_0 keeps the extraction's flips, then one a flip
        i = 0
        while f'{flips_path}_{i}' in h5:
            i += 1
        added = {}
        if i == 0:
            flips = h5[flips_path]
            added[f'{flips_path}_0'] = (flips[()], flips.compression_opts, dict(flips.attrs))
            i = 1
        added[f'{flips_path}_{i}'] = (real_flip_mask, 4, {
            'description': 'Manualally applied flips, False=no flip, True=flip',
            'creation': 'Created by moseq2-detectron-extract-tpu-torch, manually applied '
                        f'flips, on {datetime.now()}'})
        flips = _xor(_layers(h5, flips_path) + [data for data, _, _ in added.values()])

        angles = h5[angle_path][()]
        angles[real_flip_mask] = clamp_angles_rad(angles[real_flip_mask] + np.pi)
        ref_keypoints = load_keypoint_data_from_h5(h5, coord_system='reference', units='px')
        centroids = np.stack((h5['/scalars/centroid_x_px'][()],
                              h5['/scalars/centroid_y_px'][()]), axis=1)
        true_depth = h5['/metadata/extraction/true_depth'][()]

    # the z lookup is left out: the reference writes no _z_ key back
    recomputed = keypoints_to_dict(ref_keypoints, None, centroids, np.rad2deg(angles),
                                   true_depth, z_data=np.zeros(ref_keypoints.shape[:2]))

    def flipped(first, block):
        mask = real_flip_mask[first:first + len(block)]
        return np.where(mask.reshape((-1,) + (1,) * (block.ndim - 1)),
                        flip_horizontal(block), block)

    changes = {frames_path: hdf5.Rows(fn=flipped), frames_mask_path: hdf5.Rows(fn=flipped),
               angle_path: hdf5.replaced(angles), flips_path: hdf5.replaced(flips)}
    changes.update({f'/keypoints/{key}': hdf5.replaced(value)
                    for key, value in recomputed.items() if '_z_' not in key})
    hdf5.rewrite(h5_file, changes, added)
