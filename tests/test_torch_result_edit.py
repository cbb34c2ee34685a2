'''Editing a results file, on the CPU against the JAX package.

The input is a results file of ``NFRAMES`` frames made from a seed with
numpy (``write_results``) and written by either package's
``create_extract_h5`` and ``write_extracted_chunk_to_h5``: h5py's (the JAX
package's, chunked along every axis) or the port's writer. Each test gives
two copies of it to the JAX package's edit and to the port's, then reads
both with h5py: every dataset's values, dtype and attributes and its gzip
level equal, bit for bit: frames, masks, flips, angles, trimmed rows, and
the keypoints a flip recomputes (both packages compute them in f64 numpy
from the same f32 angles, then store f32). The flip's ``creation``
attribute holds the time and each package's name, so only its text up to
those is compared.

* ``trim-result``, ``manual-flip`` (twice: the second layer), ``copy_frame``
  and ``verify-flips`` through both command lines (click's ``CliRunner``
  for the JAX package's), with the backups;
* the port's edit path (``io/hdf5.py:rewrite``): a failure midway leaves the
  file as it was and no new file beside it; a dataset is copied a block of
  rows at a time, never whole; a flip applied twice gives back the frames
  and masks bit for bit;
* the flips file's reader and checks, the two frame flips, the XOR of the
  layers and ``clamp_angles_rad`` against the JAX package's.
'''
import filecmp
import os
import shutil

import h5py
import numpy as np
import pytest

from moseq2_detectron_extract_tpu.io import flips as jflips
from moseq2_detectron_extract_tpu.io import result as jresult
from moseq2_detectron_extract_tpu.proc.keypoints import keypoints_to_dict as jkeypoints_to_dict
from moseq2_detectron_extract_tpu_torch.io import flips as pflips
from moseq2_detectron_extract_tpu_torch.io import hdf5
from moseq2_detectron_extract_tpu_torch.io import result as presult

NFRAMES = 300
WRITERS = ['h5py', 'port']
NAN_FRAMES = (10, 11, 12, 150)      # frames with a NaN keypoint
JUMP_FRAMES = (100, 220)            # frames where the nose jumps
CREATION = 'manually applied flips, on '


def results_inputs(seed: int, nframes: int = NFRAMES):
    '''(config_data, status_dict, per-frame results) of a made-up session:
    frames and masks of a blob, scalars, keypoints about the centroid (some
    NaN, some jumping; the mm and rotated values from the JAX package's
    ``keypoints_to_dict``), flips in runs.'''
    rng = np.random.default_rng(seed)
    true_depth = 673.25
    yy, xx = np.mgrid[0:80, 0:80]
    cx, cy = rng.uniform(30, 50, nframes), rng.uniform(30, 50, nframes)
    blob = (xx[None] - cx[:, None, None]) ** 2 / 400 + (yy[None] - cy[:, None, None]) ** 2 / 100
    masks = blob < 1
    frames = np.where(masks, rng.integers(10, 90, (nframes, 80, 80)), 0).astype(np.uint8)
    angles = rng.uniform(0, 2 * np.pi, nframes).astype(np.float32)
    scalars = {name: rng.normal(50, 10, nframes).astype(np.float32)
               for name in jresult.scalar_attributes()}
    scalars['centroid_x_px'] = (cx + 200).astype(np.float32)
    scalars['centroid_y_px'] = (cy + 150).astype(np.float32)
    scalars['angle'] = angles
    centers = np.stack([scalars['centroid_x_px'], scalars['centroid_y_px']], axis=1)
    kp = np.empty((nframes, 8, 3))
    kp[:, :, :2] = centers[:, None] + rng.normal(0, 8, (nframes, 8, 2))
    kp[:, :, 2] = rng.uniform(0, 1, (nframes, 8))
    kp[list(JUMP_FRAMES), 0, :2] += 60
    for i, f in enumerate(NAN_FRAMES):
        kp[f, i % 7, 0] = np.nan
    keypoints = {k: v.astype(np.float32) for k, v in jkeypoints_to_dict(
        kp, frames.astype(np.float32), centers, np.rad2deg(angles), true_depth).items()}
    flips = (np.cumsum(rng.random(nframes) < 0.05) % 2).astype(bool)
    hw = (60, 70)
    config = {'nframes': nframes, 'timestamps': np.arange(nframes) * 33.34,
              'crop_size': (80, 80), 'frame_dtype': 'uint8', 'use_tracking_model': False,
              'flip_classifier': 'model', 'true_depth': true_depth,
              'roi': rng.random(hw) > 0.3,
              'first_frame': rng.integers(0, 1000, hw).astype(np.uint16),
              'bground_im': (rng.random(hw) * 700).astype(np.float32)}
    status = {'uuid': '3f1c7a8e-5b2d-4c9e-8f10-2a6b9d4e7c01',
              'parameters': {'chunk_size': 100, 'crop_size': [80, 80], 'model': None,
                             'bg_roi_depth_range': [650.0, 750.0], 'use_tracking': True,
                             'fps': 30, 'output_dir': '/data/proc', 'frame_dtype': 'uint8'},
              'metadata': {'SubjectName': 'mouse-1', 'SessionName': 'session-1',
                           'DepthResolution': [512, 424], 'IsLittleEndian': True,
                           'NidaqChannels': 0, 'NidaqSamplingRate': 0.0,
                           'ColorDataType': 'Byte[]', 'StartTime': None}}
    chunk = {'frame_idxs': np.arange(nframes), 'offset': 0, 'scalars': scalars,
             'depth_frames': frames, 'mask_frames': masks, 'features': {'flips': flips},
             'keypoints': keypoints}
    annotations = {'chunk_size': 'Number of frames for each processing iteration',
                   'fps': 'Frame rate of camera'}
    return config, status, chunk, annotations


def write_results(path: str, writer: str, seed: int = 0, nframes: int = NFRAMES) -> str:
    '''A results file at ``path`` written by h5py (the JAX package's
    writer) or by the port's.'''
    config, status, chunk, annotations = results_inputs(seed, nframes)
    if writer == 'h5py':
        with h5py.File(path, 'w') as h5:
            jresult.create_extract_h5(h5, config, status, annotations)
            jresult.write_extracted_chunk_to_h5(h5, chunk)
    else:
        with hdf5.File(path, 'w') as h5:
            presult.create_extract_h5(h5, config, status, annotations)
            presult.write_extracted_chunk_to_h5(h5, chunk)
    return path


def h5_tree(path: str) -> dict:
    '''name -> (values, dtype, attributes, gzip level) of every dataset, by h5py.'''
    out = {}
    with h5py.File(path, 'r') as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], obj.dtype, dict(obj.attrs), obj.compression_opts)
        f.visititems(visit)
    return out


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == 'f' and b.dtype.kind == 'f':
            return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, h5py.Empty) or isinstance(b, h5py.Empty):
        return type(a) is type(b) and a.dtype == b.dtype
    return type(a) is type(b) and (a == b or (a != a and b != b))


def assert_same_file(port_path: str, jax_path: str) -> None:
    '''The two files hold the same datasets with the same values, dtypes,
    attributes and gzip levels; the flip's ``creation`` text up to the
    time.'''
    ours, ref = h5_tree(port_path), h5_tree(jax_path)
    assert sorted(ours) == sorted(ref)
    for name in ref:
        (va, ta, aa, la), (vb, tb, ab, lb) = ours[name], ref[name]
        assert ta == tb and la == lb, (name, ta, tb, la, lb)
        if 'creation' in ab:
            for text in (aa.pop('creation'), ab.pop('creation')):
                assert text.startswith('Created by moseq2-detectron-extract-tpu') and \
                    CREATION in text, text
        assert aa == ab, name
        assert _equal(va, vb), name


@pytest.fixture(params=WRITERS)
def pair(request, tmp_path):
    '''Two copies of one results file, ``(port's, JAX package's)``.'''
    src = write_results(str(tmp_path / 'src.h5'), request.param)
    ours, ref = str(tmp_path / 'ours' / 'results_00.h5'), str(tmp_path / 'ref' / 'results_00.h5')
    for path in (ours, ref):
        os.makedirs(os.path.dirname(path))
        shutil.copy(src, path)
    return ours, ref


def _jax_cli(args):
    from click.testing import CliRunner
    from moseq2_detectron_extract_tpu.cli import cli as jax_cli
    return CliRunner().invoke(jax_cli, args, catch_exceptions=False)


def test_trim_result_equals_jax(pair):
    from moseq2_detectron_extract_tpu_torch import cli
    ours, ref = pair
    original = ours + '.orig'
    shutil.copy(ours, original)
    assert cli.main(['trim-result', ours, '--start', '20', '--stop', '250']) == 0
    assert _jax_cli(['trim-result', ref, '--start', '20', '--stop', '250']).exit_code == 0
    assert_same_file(ours, ref)
    assert filecmp.cmp(ours + '.bak', original, shallow=False)
    tree = h5_tree(ours)
    assert tree['frames'][0].shape == (230, 80, 80)
    assert tree['metadata/extraction/roi'][0].shape == (60, 70)


def _write_flips(path, ranges, comment=True):
    with open(path, 'w', encoding='utf-8') as fh:
        if comment:
            fh.write('# frames to flip\n\n')
        for start, stop in ranges:
            fh.write(f'{start}-{stop}  # a note\n' if comment else f'{start}-{stop}\n')
    return path


def test_manual_flip_equals_jax(pair, tmp_path):
    '''Two flips in turn (flips_1, then flips_2), through both command lines.'''
    from moseq2_detectron_extract_tpu_torch import cli
    ours, ref = pair
    for i, ranges in enumerate([[(5, 40), (100, 101), (200, 260)], [(30, 120)]]):
        flips = _write_flips(str(tmp_path / f'flips{i}.txt'), ranges)
        assert cli.main(['manual-flip', ours, flips]) == 0
        assert _jax_cli(['manual-flip', ref, flips]).exit_code == 0
        assert_same_file(ours, ref)
    assert os.path.exists(ours + '.bak') and os.path.exists(ours + '.1.bak')
    with h5py.File(ours, 'r') as h5:
        ext = h5['metadata/extraction']
        assert sorted(ext) == sorted(['flips', 'flips_0', 'flips_1', 'flips_2', 'background',
                                      'extract_version', 'first_frame', 'parameters', 'roi',
                                      'true_depth'])
        np.testing.assert_array_equal(ext['flips'][()], ext['flips_0'][()] ^ ext['flips_1'][()]
                                      ^ ext['flips_2'][()])


def test_copy_frame_equals_jax(pair):
    ours, ref = pair
    presult.copy_frame(ours, 7, 201)
    with h5py.File(ref, 'r+') as h5:
        jresult.copy_frame(h5, 7, 201)
    assert_same_file(ours, ref)


def test_edits_of_a_port_written_file_read_back_by_the_port(tmp_path):
    '''trim, then flip, then trim again, read by the port's reader: what
    h5py reads.'''
    path = write_results(str(tmp_path / 'results_00.h5'), 'port')
    presult.trim_results(path, 3, 280)
    pflips.flip_dataset(path, flip_ranges=[(0, 10), (50, 60)])
    presult.trim_results(path, 0, 270)
    tree = h5_tree(path)
    with hdf5.File(path, 'r') as r:
        names = [name.lstrip('/') for name, _ in r.visit_datasets()]
        assert sorted(names) == sorted(tree)
        for name in names:
            value, dtype, attrs, level = tree[name]
            ds = r[name]
            got = ds[()]
            if isinstance(value, bytes):
                value = value.decode('utf-8')
            if isinstance(value, h5py.Empty):
                assert isinstance(got, hdf5.Empty)
            else:
                assert _equal(np.asarray(got) if isinstance(value, np.ndarray) else got,
                              value), name
            assert ds.compression_opts == level and ds.attrs == attrs, name
    assert tree['frames'][0].shape[0] == 270


def test_flip_twice_gives_back_the_frames(tmp_path):
    path = write_results(str(tmp_path / 'results_00.h5'), 'h5py')
    before = h5_tree(path)
    ranges = [(0, 17), (90, 91), (140, 299)]
    pflips.flip_dataset(path, flip_ranges=ranges)
    once = h5_tree(path)
    assert not np.array_equal(once['frames'][0], before['frames'][0])
    pflips.flip_dataset(path, flip_ranges=ranges)
    after = h5_tree(path)
    for name in ('frames', 'frames_mask', 'metadata/extraction/flips'):
        np.testing.assert_array_equal(after[name][0], before[name][0], err_msg=name)
    np.testing.assert_array_equal(after['metadata/extraction/flips_0'][0],
                                  before['metadata/extraction/flips'][0])
    np.testing.assert_array_equal(after['metadata/extraction/flips_1'][0],
                                  after['metadata/extraction/flips_2'][0])
    # pi added twice comes back to the angle, to f32 rounding
    gap = np.abs(after['scalars/angle'][0] - before['scalars/angle'][0])
    assert np.minimum(gap, 2 * np.pi - gap).max() < 1e-5


def _snapshot(path):
    with open(path, 'rb') as fh:
        return fh.read()


def test_a_failed_edit_leaves_the_file_whole(tmp_path, monkeypatch):
    '''The flip stops in its third block of frames: the file is unchanged
    byte for byte, and no new file is left beside it.'''
    path = write_results(str(tmp_path / 'results_00.h5'), 'h5py')
    before = _snapshot(path)
    calls = []
    flip = pflips.flip_horizontal

    def failing(data):
        calls.append(len(data))
        if len(calls) == 3:
            raise OSError('disk full')
        return flip(data)

    monkeypatch.setattr(pflips, 'flip_horizontal', failing)
    monkeypatch.setattr(hdf5, 'ROWS_PER_COPY', 64)
    with pytest.raises(OSError, match='disk full'):
        pflips.flip_dataset(path, flip_ranges=[(0, 299)])
    assert len(calls) == 3
    assert _snapshot(path) == before
    assert os.listdir(str(tmp_path)) == ['results_00.h5']
    with pytest.raises(KeyError, match='no such datasets'):
        hdf5.rewrite(path, {'/scalars/no_such': hdf5.Rows()})
    assert _snapshot(path) == before and os.listdir(str(tmp_path)) == ['results_00.h5']


def test_rewrite_copies_a_block_of_rows_at_a_time(tmp_path, monkeypatch):
    path = write_results(str(tmp_path / 'results_00.h5'), 'h5py')
    read = hdf5.ReadDataset._read_rows
    spans = []

    def spy(self, start, stop):
        spans.append((self.name, stop - start))
        return read(self, start, stop)

    monkeypatch.setattr(hdf5.ReadDataset, '_read_rows', spy)
    monkeypatch.setattr(hdf5, 'ROWS_PER_COPY', 50)
    hdf5.rewrite(path)
    frames = [n for name, n in spans if name == '/frames']
    assert frames == [50] * 6 and max(n for _, n in spans) == 50
    monkeypatch.undo()
    assert_same_file(path, write_results(str(tmp_path / 'again.h5'), 'h5py'))


@pytest.mark.parametrize('text, vmax', [
    ('1-5\n# comment\n10-20 # trailing\n\n30-31\n', 100),
    ('1-5\n4-9\n', 100),
    ('5-1\n', 100),
    ('1-500\n', 100),
    ('1-2-3\n', 100),
    ('a-b\n', 100),
])
def test_flips_file_reader_equals_jax(text, vmax, tmp_path):
    path = str(tmp_path / 'flips.txt')
    with open(path, 'w', encoding='utf-8') as fh:
        fh.write(text)
    outcomes = []
    for module in (pflips, jflips):
        try:
            outcomes.append(('ok', module.read_flips_file(path, verify_vmax=vmax)))
        except RuntimeError as exc:
            outcomes.append(('error', str(exc)))
    assert outcomes[0] == outcomes[1]


def test_verify_flips_exit_codes_equal_jax(tmp_path):
    from moseq2_detectron_extract_tpu_torch import cli
    good = _write_flips(str(tmp_path / 'good.txt'), [(0, 10), (20, 30)])
    overlap = _write_flips(str(tmp_path / 'overlap.txt'), [(0, 10), (5, 30)])
    for files, code in (([good], 0), ([overlap], 1), ([good, overlap], 1)):
        assert cli.main(['verify-flips'] + files) == code
        assert _jax_cli(['verify-flips'] + files).exit_code == code
    assert cli.main(['verify-flips', good, '--max-frames', '25']) == 1


def test_flip_helpers_equal_jax(tmp_path):
    from moseq2_detectron_extract_tpu.proc.angles import clamp_angles_rad as jclamp
    from moseq2_detectron_extract_tpu_torch.proc.angles import clamp_angles_rad
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 255, (4, 6, 5), dtype=np.uint8)
    np.testing.assert_array_equal(pflips.flip_horizontal(frames), jflips.flip_horizontal(frames))
    np.testing.assert_array_equal(pflips.flip_vertical(frames), jflips.flip_vertical(frames))
    angles = np.concatenate([rng.uniform(-7, 13, 2000), [0, -0.0, np.pi, -np.pi, 2 * np.pi,
                                                         np.nan]]).astype(np.float32)
    ours = clamp_angles_rad(angles + np.pi)
    ref = np.asarray(jclamp(angles + np.pi))
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    path = write_results(str(tmp_path / 'results_00.h5'), 'h5py')
    pflips.flip_dataset(path, flip_ranges=[(3, 9)])
    pflips.flip_dataset(path, flip_mask=np.arange(NFRAMES) % 3 == 0)
    with hdf5.File(path, 'r') as r, h5py.File(path, 'r') as h:
        np.testing.assert_array_equal(pflips.recompute_flips(r), jflips.recompute_flips(h))
        np.testing.assert_array_equal(pflips.recompute_flips(r),
                                      h['metadata/extraction/flips'][()])
    flips = '/metadata/extraction/flips'
    assert pflips.find_unused_dataset_path(path, flips) == \
        jflips.find_unused_dataset_path(path, flips) == flips + '_3'
    assert pflips.count_frames(path) == jflips.count_frames(path) == NFRAMES
    with pytest.raises(RuntimeError, match='One of'):
        pflips.flip_dataset(path)


def test_backup_existing_file(tmp_path):
    from moseq2_detectron_extract_tpu.io.util import backup_existing_file as jbackup
    from moseq2_detectron_extract_tpu_torch.io.util import backup_existing_file
    for module_fn, sub in ((backup_existing_file, 'ours'), (jbackup, 'ref')):
        d = tmp_path / sub
        d.mkdir()
        path = str(d / 'results_00.h5')
        assert module_fn(path) is None
        names = []
        for i in range(3):
            with open(path, 'w', encoding='utf-8') as fh:
                fh.write(str(i))
            names.append(os.path.basename(module_fn(path)))
        assert not os.path.exists(path)
        assert names == ['results_00.h5.bak', 'results_00.h5.1.bak', 'results_00.h5.2.bak']
