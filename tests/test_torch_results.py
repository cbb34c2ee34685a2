'''The writers: the port's ``ResultWriterStep`` (``io/result.py`` on the
port's HDF5 writer, and the keypoints TSV), ``dict_to_h5`` and the instance
log against the JAX package's, on identical inputs.

The same config, status dict and fetched chunks go to JAX's
``ResultWriterStep`` (``create_extract_h5`` and
``write_extracted_chunk_to_h5`` on h5py) and to the port's, with a chunk
overlap, a padded tail and a non-zero ``first_frame_idx``. h5py reads both
files: every dataset and attribute is equal in name, shape, dtype, HDF5 type,
compression and value, except ``extract_version``, which names the package
that wrote the file. The keypoints TSVs and the instance logs are equal text
for text.
'''
import os

import h5py
import numpy as np
import pytest

from moseq2_detectron_extract_tpu.io.util import dict_to_h5 as jax_dict_to_h5
from moseq2_detectron_extract_tpu.models.instance_logger import InstanceLogger as JaxLogger
from moseq2_detectron_extract_tpu.pipeline.steps import ResultWriterStep as JaxWriter
from moseq2_detectron_extract_tpu.proc.keypoints import keypoint_attributes as jax_kp_attrs
from moseq2_detectron_extract_tpu.proc.scalars import scalar_attributes as jax_scalar_attrs
from moseq2_detectron_extract_tpu_torch import __version__
from moseq2_detectron_extract_tpu_torch.io import hdf5
from moseq2_detectron_extract_tpu_torch.io.util import dict_to_h5
from moseq2_detectron_extract_tpu_torch.models.instance_logger import InstanceLogger
from moseq2_detectron_extract_tpu_torch.pipeline.steps import ResultWriterStep
from moseq2_detectron_extract_tpu_torch.proc.keypoints import keypoint_attributes
from moseq2_detectron_extract_tpu_torch.proc.scalars import scalar_attributes

from tests.test_torch_hdf5 import _names, _type_signature

NFRAMES, FIRST, CHUNK, OVERLAP = 50, 3, 20, 4
PARAMS = {'chunk_size': CHUNK, 'chunk_overlap': OVERLAP, 'bg_roi_dilate': (10, 10),
          'bg_roi_weights': (1, .1, 1), 'model': None, 'output_dir': '/tmp/out',
          'use_tracking': True, 'instance_threshold': 0.5, 'keypoint_names': ['Nose', 'Tail'],
          'nested': {'a': 1, 'b': {'c': 'd'}}, 'flags': [True, False], 'mixed': [1, 'x'],
          'odd': {1, 2}, 'np': np.float32(2.5), 'blob': b'raw'}
ANNOTATIONS = {'chunk_size': 'Number of frames for each processing iteration',
               'bg_roi_dilate': 'Size of the mask dilation (to include environment walls)',
               'model': 'Path to the model for inference.', 'output_dir': None,
               'nested': {'a': 'described inside'}}
METADATA = {'SubjectName': 'mouse', 'DepthResolution': [512, 424], 'Names': ['a', 'bc'],
            'Rate': 30.0, 'Missing': None, 'Flag': True}


def _config(tmp, use_tracking_model=False, flip_classifier='model'):
    rng = np.random.default_rng(1)
    status = {'uuid': '9b7c-uuid', 'parameters': PARAMS, 'metadata': METADATA,
              'complete': False, 'skip': False}
    return {'output_dir': tmp, 'bg_roi_index': 0, 'status_dict': status,
            'param_annotations': ANNOTATIONS, 'nframes': NFRAMES, 'first_frame_idx': FIRST,
            'crop_size': (80, 80), 'frame_dtype': 'uint8',
            'use_tracking_model': use_tracking_model, 'flip_classifier': flip_classifier,
            'true_depth': 673.5, 'roi': rng.random((24, 32)) > 0.3,
            'first_frame': rng.integers(0, 800, (24, 32)).astype('int16'),
            'bground_im': rng.normal(700, 5, (24, 32)),
            'timestamps': np.arange(NFRAMES) * 33.3 + 1e6}


def _chunks():
    '''Fetched chunks of frames FIRST.., CHUNK each (the tail padded to CHUNK),
    overlapping by OVERLAP; the padding holds values that must not be written.'''
    rng = np.random.default_rng(2)
    starts = list(range(0, NFRAMES - OVERLAP, CHUNK - OVERLAP))
    out = []
    for n, start in enumerate(starts):
        idxs = np.arange(start, min(NFRAMES, start + CHUNK)) + FIRST

        def col(dtype, nan=False):
            values = rng.normal(100, 30, CHUNK).astype(dtype)
            if nan:
                values[rng.random(CHUNK) < 0.2] = np.nan
            return values
        scalars = {k: col('float64' if k in ('area_px', 'area_mm', 'velocity_theta')
                          else 'float32', nan=True) for k in scalar_attributes()}
        keypoints = {k: col('float64', nan=True) for k in keypoint_attributes()}
        out.append({'frame_idxs': idxs, 'offset': 0 if n == 0 else OVERLAP,
                    'scalars': scalars, 'keypoints': keypoints,
                    'depth_frames': rng.integers(0, 256, (CHUNK, 80, 80)).astype('uint8'),
                    'mask_frames': (rng.random((CHUNK, 80, 80)) > 0.5).astype('uint8'),
                    'features': {'flips': rng.random(CHUNK) > 0.5}})
    return out


def _run(writer_cls, tmp, **kw):
    config = _config(tmp, **kw)
    step = writer_cls(step_name='writer', config=config)
    step.initialize()
    for chunk in _chunks():
        step.process({**chunk, 'scalars': dict(chunk['scalars']),
                      'keypoints': dict(chunk['keypoints'])})
    step.finalize()
    return step.h5_path, step.tsv_path


@pytest.fixture(scope='module', params=[(False, 'model'), (True, None)],
                ids=['bool-mask-flips', 'f32-mask-no-flips'])
def written(request, tmp_path_factory):
    use_tracking_model, flip_classifier = request.param
    ours = _run(ResultWriterStep, str(tmp_path_factory.mktemp('ours')),
                use_tracking_model=use_tracking_model, flip_classifier=flip_classifier)
    ref = _run(JaxWriter, str(tmp_path_factory.mktemp('jax')),
               use_tracking_model=use_tracking_model, flip_classifier=flip_classifier)
    return ours, ref, request.param


def test_attribute_tables_equal_jax():
    assert scalar_attributes() == jax_scalar_attrs()
    assert keypoint_attributes() == jax_kp_attrs()
    assert len(keypoint_attributes()) == 96
    assert keypoint_attributes(['A']) == jax_kp_attrs(['A'])


def test_results_files_have_the_same_datasets_and_types(written):
    (ours, _), (ref, _), (use_tracking_model, flip_classifier) = written
    with h5py.File(ours, 'r') as a, h5py.File(ref, 'r') as b:
        assert _names(a) == _names(b)
        assert ('metadata/extraction/flips' in a) == (flip_classifier is not None)
        assert a['frames_mask'].dtype == ('float32' if use_tracking_model else bool)
        for name in _names(b):
            if not isinstance(b[name], h5py.Dataset):
                assert isinstance(a[name], h5py.Group), name
                continue
            da, db = a[name], b[name]
            assert (da.shape, da.dtype) == (db.shape, db.dtype), name
            assert _type_signature(da) == _type_signature(db), name
            assert (da.compression, da.compression_opts) == (db.compression,
                                                             db.compression_opts), name
            assert dict(da.attrs) == dict(db.attrs), name


def test_results_files_have_the_same_values(written):
    (ours, _), (ref, _), _ = written
    with h5py.File(ours, 'r') as a, h5py.File(ref, 'r') as b:
        for name in _names(b):
            if not isinstance(b[name], h5py.Dataset):
                continue
            va, vb = a[name][()], b[name][()]
            if name == 'metadata/extraction/extract_version':
                assert va == f'moseq2-detectron-extract-tpu-torch v{__version__}'.encode()
                assert vb.startswith(b'moseq2-detectron-extract-tpu v')
            elif isinstance(vb, h5py.Empty):
                assert isinstance(va, h5py.Empty) and va.dtype == vb.dtype, name
            else:
                floats = isinstance(vb, np.ndarray) and vb.dtype.kind == 'f'
                assert type(va) is type(vb) and np.array_equal(va, vb, equal_nan=floats), name


def test_frames_are_written_once_at_their_rows(written):
    '''Row r holds frame FIRST + r, from the first chunk that carried it.'''
    (ours, _), _, _ = written
    chunks = _chunks()
    expected = np.zeros((NFRAMES, 80, 80), 'uint8')
    for chunk in chunks:
        n = len(chunk['frame_idxs'])
        expected[chunk['frame_idxs'][chunk['offset']:] - FIRST] = \
            chunk['depth_frames'][chunk['offset']:n]
    with hdf5.File(ours, 'r') as r:
        np.testing.assert_array_equal(r['frames'][()], expected)
        np.testing.assert_array_equal(r['frames'][10:30], expected[10:30])
        assert r['scalars/centroid_x_px'].shape == (NFRAMES,)


def test_keypoint_tsvs_equal_jax(written):
    (_, ours), (_, ref), _ = written
    with open(ours, encoding='utf-8') as fa, open(ref, encoding='utf-8') as fb:
        text = fa.read()
        assert text == fb.read()
    lines = text.splitlines()
    assert len(lines) == NFRAMES + 1 and lines[1].split('\t')[0] == str(FIRST - FIRST)


def test_dict_to_h5_equals_jax(tmp_path):
    ours, ref = str(tmp_path / 'ours.h5'), str(tmp_path / 'ref.h5')
    with hdf5.File(ours, 'w') as f:
        dict_to_h5(f, PARAMS, 'params', ANNOTATIONS)
    with h5py.File(ref, 'w') as f:
        jax_dict_to_h5(f, PARAMS, 'params', ANNOTATIONS)
    with h5py.File(ours, 'r') as a, h5py.File(ref, 'r') as b:
        assert _names(a) == _names(b)
        for name in _names(b):
            if isinstance(b[name], h5py.Dataset):
                assert _type_signature(a[name]) == _type_signature(b[name]), name
                va, vb = a[name][()], b[name][()]
                assert type(va) is type(vb) and np.array_equal(va, vb) if \
                    not isinstance(vb, h5py.Empty) else isinstance(va, h5py.Empty), name
            assert dict(a[name].attrs) == dict(b[name].attrs), name


def _log_frames(logger_cls, path):
    '''Frames with 0 to 3 kept detections, NaN centres and keypoints.'''
    rng = np.random.default_rng(3)
    logger = logger_cls(path)
    for frame in range(40):
        d = 4
        keep = rng.random(d) < (frame % 4) / 3
        scores = rng.random(d).astype('float32')
        kept = np.flatnonzero(keep)
        kept = kept[np.argsort(-scores[kept])]
        iou = rng.random((d, d)).astype('float32')
        centers = rng.normal(100, 20, (d, 2)).astype('float32')
        keypoints = rng.normal(100, 20, (d, 8, 3)).astype('float32')
        if frame % 5 == 0:
            centers[kept[:1]] = np.nan
        if frame % 7 == 0:
            keypoints[kept[-1:], 2, 0] = np.nan
        multi = len(kept) > 1
        logger.log_frame(frame + 1000, kept, scores, mask_iou=iou if multi else None,
                         centers=centers, keypoints=keypoints if multi else None)
    logger.close()
    with open(path, encoding='utf-8') as fh:
        return fh.read()


def test_instance_logs_equal_jax(tmp_path):
    ours = _log_frames(InstanceLogger, str(tmp_path / 'ours.tsv'))
    ref = _log_frames(JaxLogger, str(tmp_path / 'ref.tsv'))
    assert ours == ref
    assert ours.count('\n') > 40
    pairs = [line for line in ours.splitlines()[1:] if line.split('\t')[3]]
    assert pairs, 'no frame with several detections'


def test_results_file_is_readable_only_after_close(tmp_path):
    '''The port's writer puts the metadata down at close (a deviation from
    h5py, whose file is readable after each flush).'''
    path = str(tmp_path / 'partial.h5')
    f = hdf5.File(path, 'w')
    f.create_dataset('x', (10,), 'f4', compression='gzip')[np.arange(5)] = 1.0
    f.flush()
    with pytest.raises(ValueError):
        hdf5.File(path, 'r')
    f.close()
    with hdf5.File(path, 'r') as r:
        np.testing.assert_array_equal(r['x'][()], [1] * 5 + [0] * 5)
    assert os.path.getsize(path) > 96
