'''The results HDF5 file: its datasets and metadata, and chunked writing.

Port of ``moseq2_detectron_extract_tpu/io/result.py`` (``create_extract_h5``,
lines 18-102, ``write_extracted_chunk_to_h5``, 105-120, ``copy_frame`` and
``trim_results``, 122-170) onto the port's HDF5 writer (``io.hdf5``): the
same dataset names, shapes, dtypes, compression (gzip level 4) and
descriptions. ``extract_version`` names this package, so that a file says
which package wrote it. The reference edits a file in place (h5py's
``r+``); here an edit writes the file anew beside it and renames it onto
the old one (``hdf5.rewrite``), so a failed edit leaves the file whole.
'''
from typing import Dict, Optional

import numpy as np

from moseq2_detectron_extract_tpu_torch import __version__
from moseq2_detectron_extract_tpu_torch.io import hdf5
from moseq2_detectron_extract_tpu_torch.io.util import dict_to_h5
from moseq2_detectron_extract_tpu_torch.proc.keypoints import keypoint_attributes
from moseq2_detectron_extract_tpu_torch.proc.scalars import scalar_attributes


def create_extract_h5(h5_file: hdf5.File, config_data: dict, status_dict: dict,
                      param_annotations: Optional[Dict[str, str]] = None) -> None:
    '''Create every dataset of an extraction's results file and write its
    metadata: the per-frame datasets at their full length (``nframes``),
    then the ROI, background, first frame, true depth, timestamps, the
    parameters (``status_dict['parameters']``, described by
    ``param_annotations``) and the acquisition metadata.'''
    nframes = config_data['nframes']

    h5_file.create_dataset('metadata/uuid', data=status_dict['uuid'])

    for scalar, desc in scalar_attributes().items():
        h5_file.create_dataset(f'scalars/{scalar}', (nframes,), 'float32', compression='gzip')
        h5_file[f'scalars/{scalar}'].attrs['description'] = desc

    for kp, desc in keypoint_attributes().items():
        h5_file.create_dataset(f'keypoints/{kp}', (nframes,), 'float32', compression='gzip')
        h5_file[f'keypoints/{kp}'].attrs['description'] = desc

    h5_file.create_dataset('timestamps', compression='gzip', data=config_data['timestamps'])
    h5_file['timestamps'].attrs['description'] = 'Depth video timestamps'

    crop_size = config_data['crop_size']
    h5_file.create_dataset('frames', (nframes, crop_size[0], crop_size[1]),
                           config_data['frame_dtype'], compression='gzip')
    h5_file['frames'].attrs['description'] = \
        '3D Numpy array of depth frames (nframes x w x h, in mm)'

    if config_data.get('use_tracking_model', False):
        h5_file.create_dataset('frames_mask', (nframes, crop_size[0], crop_size[1]),
                               'float32', compression='gzip')
        h5_file['frames_mask'].attrs['description'] = \
            'Log-likelihood values from the tracking model (nframes x w x h)'
    else:
        h5_file.create_dataset('frames_mask', (nframes, crop_size[0], crop_size[1]),
                               'bool', compression='gzip')
        h5_file['frames_mask'].attrs['description'] = \
            'Boolean mask, false=not mouse, true=mouse'

    if config_data.get('flip_classifier') is not None:
        h5_file.create_dataset('metadata/extraction/flips', (nframes,), 'bool',
                               compression='gzip')
        h5_file['metadata/extraction/flips'].attrs['description'] = \
            'Output from flip classifier, false=no flip, true=flip'

    h5_file.create_dataset('metadata/extraction/true_depth', data=config_data['true_depth'])
    h5_file['metadata/extraction/true_depth'].attrs['description'] = \
        'Detected true depth of arena floor in mm'

    h5_file.create_dataset('metadata/extraction/roi', data=np.asarray(config_data['roi']),
                           compression='gzip')
    h5_file['metadata/extraction/roi'].attrs['description'] = 'ROI mask'

    h5_file.create_dataset('metadata/extraction/first_frame',
                           data=np.asarray(config_data['first_frame']), compression='gzip')
    h5_file['metadata/extraction/first_frame'].attrs['description'] = \
        'First frame of depth dataset'

    h5_file.create_dataset('metadata/extraction/background',
                           data=np.asarray(config_data['bground_im']), compression='gzip')
    h5_file['metadata/extraction/background'].attrs['description'] = \
        'Computed background image'

    extract_version = f'moseq2-detectron-extract-tpu-torch v{__version__}'
    h5_file.create_dataset('metadata/extraction/extract_version', data=extract_version)
    h5_file['metadata/extraction/extract_version'].attrs['description'] = \
        'Version of moseq2-extract'

    dict_to_h5(h5_file, status_dict.get('parameters', {}), 'metadata/extraction/parameters',
               param_annotations)

    for key, value in status_dict.get('metadata', {}).items():
        if isinstance(value, list) and len(value) > 0 and isinstance(value[0], str):
            value = [n.encode('utf8') for n in value]
        if value is not None:
            h5_file.create_dataset(f'metadata/acquisition/{key}', data=value)
        else:
            h5_file.create_dataset(f'metadata/acquisition/{key}', dtype='f')


def write_extracted_chunk_to_h5(h5_file: hdf5.File, results: dict) -> None:
    '''Write one chunk's results at ``results['frame_idxs']`` (file rows),
    leaving out each array's first ``results['offset']`` rows (frames a
    previous chunk already wrote).'''
    frame_range = results['frame_idxs']
    offset = results['offset']

    for scalar, values in results['scalars'].items():
        h5_file[f'scalars/{scalar}'][frame_range] = values[offset:]

    h5_file['frames'][frame_range] = results['depth_frames'][offset:]
    h5_file['frames_mask'][frame_range] = results['mask_frames'][offset:]

    if 'metadata/extraction/flips' in h5_file:
        h5_file['metadata/extraction/flips'][frame_range] = results['features']['flips'][offset:]

    for kp, values in results['keypoints'].items():
        h5_file[f'keypoints/{kp}'][frame_range] = values[offset:]


def _per_frame_datasets(h5) -> list:
    '''The datasets ``copy_frame`` copies a frame of: the frames, the masks,
    every scalar and keypoint and every flips layer.'''
    names = ['/frames', '/frames_mask']
    for base in ('/scalars', '/keypoints/reference', '/keypoints/rotated'):
        names += [f'{base}/{key}' for key in h5[base].keys()]
    names += [f'/metadata/extraction/{key}' for key in h5['/metadata/extraction'].keys()
              if key.startswith('flips')]
    return names


def copy_frame(h5_file: str, src_frame: int, dst_frame: int) -> None:
    '''Copy every per-frame value of frame ``src_frame`` onto frame
    ``dst_frame`` of the results file at ``h5_file`` (rewritten through
    ``hdf5.rewrite``).'''
    with hdf5.File(h5_file, 'r') as h5:
        sources = {name: h5[name][src_frame] for name in _per_frame_datasets(h5)}

    def put(value):
        def fn(first, block):
            if first <= dst_frame < first + len(block):
                block = np.array(block)
                block[dst_frame - first] = value
            return block
        return hdf5.Rows(fn=fn)
    hdf5.rewrite(h5_file, {name: put(value) for name, value in sources.items()})


def trim_results(h5_file: str, start: int, stop: int) -> None:
    '''Cut the results file at ``h5_file`` to frames ``start:stop``: every
    dataset whose name holds ``flips`` or lacks ``metadata`` and that has at
    least ``stop`` rows is written anew with those rows, gzip level 4 (what
    the reference's ``create_dataset(..., compression='gzip')`` gives), its
    dtype and attributes kept.'''
    with hdf5.File(h5_file, 'r') as h5:
        to_trim = [name for name, ds in h5.visit_datasets()
                   if ('flips' in name or 'metadata' not in name)
                   and ds.shape and ds.shape[0] >= stop]
    hdf5.rewrite(h5_file, {name: hdf5.Rows(start, stop, level=4) for name in to_trim})
