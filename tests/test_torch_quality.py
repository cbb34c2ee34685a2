'''The outlier search, on the CPU against the JAX package.

* ``stats.py``: the modified z-score test and the extremes without
  outliers, on data with NaNs, equal;
* ``proc/keypoints.py``: the keypoint loaders (the port's HDF5 reader
  against h5py, on h5py-written and port-written files), the trailing
  moving median, the jumping-keypoint search and the NaN search, equal;
* ``quality.py``: ``find-outliers`` through both command lines on two copies
  of a results file (``tests/test_torch_result_edit.py:write_results``, with
  NaN keypoints and jumps), run twice: the three reports of each run (the
  second at the ``.1.txt`` names) equal byte for byte;
* ``extract --report-outliers``: the port's command on the tiny model writes
  the reports that the JAX package's ``find_outliers_h5`` writes for a copy
  of the same results file.
'''
import os
import shutil

import h5py
import numpy as np
import pytest

from moseq2_detectron_extract_tpu import stats as jstats
from moseq2_detectron_extract_tpu.proc import keypoints as jkp
from moseq2_detectron_extract_tpu_torch import stats
from moseq2_detectron_extract_tpu_torch.io import hdf5
from moseq2_detectron_extract_tpu_torch.proc import keypoints as kp

from tests.test_torch_result_edit import JUMP_FRAMES, NAN_FRAMES, WRITERS, _jax_cli, write_results

REPORTS = ('nan_keypoints', 'jumping_keypoints', 'flips')


def _with_nans(rng, shape, share=0.05):
    data = rng.normal(0, 1, shape)
    data[rng.random(shape) < share] = np.nan
    data.flat[::97] *= 40                          # a few far points
    return data


def test_stats_equal_jax():
    rng = np.random.default_rng(0)
    for data in (_with_nans(rng, 500), _with_nans(rng, (300, 2)), rng.normal(0, 1, 64)):
        for thresh in (2.0, 3.5):
            np.testing.assert_array_equal(stats.is_outlier(data, thresh),
                                          jstats.is_outlier(data, thresh))
    data = rng.normal(0, 1, 400)
    data[:5] = 50
    np.testing.assert_array_equal(stats.exclude_outliers(data), jstats.exclude_outliers(data))
    assert stats.max_exclude_outliers(data) == jstats.max_exclude_outliers(data) < 50
    assert stats.min_exclude_outliers(data, 2.0) == jstats.min_exclude_outliers(data, 2.0)


@pytest.mark.parametrize('writer', WRITERS)
def test_keypoint_loaders_equal_jax(writer, tmp_path):
    path = write_results(str(tmp_path / 'results_00.h5'), writer)
    with hdf5.File(path, 'r') as r, h5py.File(path, 'r') as h:
        for coords in ('reference', 'rotated'):
            for units in ('px', 'mm'):
                ours = kp.load_keypoint_data_from_h5(r, coord_system=coords, units=units)
                ref = jkp.load_keypoint_data_from_h5(h, coord_system=coords, units=units)
                assert ours.dtype == ref.dtype and ours.shape == (300, 8, 3)
                np.testing.assert_array_equal(ours, ref)
        names = ['Nose', 'TailBase']
        flat = {f'/keypoints/{k}': h[f'keypoints/{k}'][()] for k in jkp.keypoint_attributes()}
        np.testing.assert_array_equal(kp.load_keypoint_data_from_dict(flat, names),
                                      jkp.load_keypoint_data_from_dict(flat, names))
        assert np.isnan(ours).any()


@pytest.mark.parametrize('nframes, window', [(200, 4), (200, 1), (150, 5), (3, 4)])
def test_outlier_search_equals_jax(nframes, window):
    rng = np.random.default_rng(nframes + window)
    data = rng.normal(100, 5, (nframes, 8, 3))
    data[rng.random((nframes, 8)) < 0.03, 0] = np.nan
    if nframes > 50:
        data[[20, 21, 90], 2, :2] += 80
    np.testing.assert_array_equal(kp._move_median_axis0(data[:, :, :2], window),
                                  jkp._move_median_axis0(data[:, :, :2], window))
    for thresh in (10, 3.5):
        for ours, ref in zip(kp.find_outliers_jumping(data, window, thresh),
                             jkp.find_outliers_jumping(data, window, thresh)):
            np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(kp.find_nan_keypoints(data), jkp.find_nan_keypoints(data))


def test_collapse_indices_to_ranges_equals_jax():
    from moseq2_detectron_extract_tpu.quality import collapse_indices_to_ranges as jcollapse
    from moseq2_detectron_extract_tpu_torch.quality import collapse_indices_to_ranges
    for idx in ([], [4], [1, 2, 3, 7, 9, 10], np.arange(5, 40)):
        assert collapse_indices_to_ranges(np.asarray(idx)) == jcollapse(np.asarray(idx))


def _reports(path):
    base = os.path.splitext(path)[0]
    out = {}
    for name in REPORTS:
        for suffix in ('', '.1'):
            report = f'{base}.{name}{suffix}.txt'
            with open(report, encoding='utf-8') as fh:
                out[name + suffix] = fh.read()
    return out


@pytest.mark.parametrize('writer', WRITERS)
def test_find_outliers_equals_jax(writer, tmp_path):
    from moseq2_detectron_extract_tpu.quality import find_outliers_h5 as jfind
    from moseq2_detectron_extract_tpu_torch import cli
    from moseq2_detectron_extract_tpu_torch.quality import find_outliers_h5
    src = write_results(str(tmp_path / 'src.h5'), writer)
    ours, ref = str(tmp_path / 'ours.h5'), str(tmp_path / 'ref.h5')
    shutil.copy(src, ours)
    shutil.copy(src, ref)
    assert cli.main(['find-outliers', ours]) == 0
    assert _jax_cli(['find-outliers', ref]).exit_code == 0
    found = find_outliers_h5(ours, jumping_window=6, jumping_thresh=5)
    expect = jfind(ref, jumping_window=6, jumping_thresh=5)
    assert sorted(found) == sorted(expect) == ['flip_changes', 'jumping_keypoints',
                                               'nan_keypoints']
    for key in found:
        np.testing.assert_array_equal(found[key], expect[key])
    assert _reports(ours) == _reports(ref)
    assert set(NAN_FRAMES) <= set(found['nan_keypoints'])
    assert set(JUMP_FRAMES) <= set(found['jumping_keypoints'])


def test_extract_report_outliers_equals_jax(tmp_path):
    '''The port's ``extract --report-outliers`` on the tiny model; the JAX
    package's search on a copy of its results file.'''
    from moseq2_detectron_extract_tpu.quality import find_outliers_h5 as jfind
    from moseq2_detectron_extract_tpu_torch import cli
    from tests.test_torch_extract_session import DATA, NFRAMES, JaxModelConfig
    from tests.synthetic import write_synthetic_session
    session = write_synthetic_session(str(tmp_path / 'raw'), nframes=NFRAMES, seed=9)
    model_dir = tmp_path / 'model'
    model_dir.mkdir()
    JaxModelConfig.from_yaml(os.path.join(DATA, 'tiny_overfit_config.yaml')) \
        .replace(amp_dtype='float32').to_yaml(str(model_dir / 'config.yaml'))
    shutil.copy(os.path.join(DATA, 'tiny_overfit_params.npz'), str(model_dir / 'params_f16.npz'))
    out = str(tmp_path / 'out')
    assert cli.main(['extract', session, '--model', str(model_dir), '--device', 'cpu',
                     '--chunk-size', '32', '--output-dir', out, '--report-outliers']) == 0
    ref = str(tmp_path / 'ref' / 'results_00.h5')
    os.makedirs(os.path.dirname(ref))
    shutil.copy(os.path.join(out, 'results_00.h5'), ref)
    jfind(ref, keypoint_names=[k for k in jkp.default_keypoint_names if k != 'TailTip'])
    for name in REPORTS:
        with open(os.path.join(out, f'results_00.{name}.txt'), encoding='utf-8') as fh, \
                open(os.path.join(os.path.dirname(ref), f'results_00.{name}.txt'),
                     encoding='utf-8') as fr:
            assert fh.read() == fr.read(), name
