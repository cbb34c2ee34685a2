'''The port's host prep (its C++ core and its plain numpy version) against
the JAX package's ``prep_raw_frames_host``: bit for bit.'''
import numpy as np
import pytest

from moseq2_detectron_extract_tpu.ops.preprocess import apply_roi as jax_apply_roi
from moseq2_detectron_extract_tpu.ops.preprocess import bbox_from_roi as jax_bbox
from moseq2_detectron_extract_tpu.ops.preprocess import prep_raw_frames_host as jax_prep
from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.ops import preprocess
from moseq2_detectron_extract_tpu_torch.ops.preprocess import (apply_roi, bbox_from_roi,
                                                               prep_raw_frames_host,
                                                               prep_raw_frames_plain)


def raw_frames(dtype='<u2', shape=(6, 48, 64), seed=0):
    '''Depth around 600-800 mm with dropouts (0) and a few values above 900.'''
    rng = np.random.default_rng(seed)
    frames = rng.integers(560, 820, shape)
    frames[rng.random(shape) < 0.02] = 0
    frames[rng.random(shape) < 0.01] = 1200
    return frames.astype(dtype)


def background(shape=(48, 64), seed=1):
    return np.random.default_rng(seed).uniform(690.0, 760.0, shape)     # truncated to int32


def ellipse_roi(shape=(48, 64)):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    return ((yy - 24) / 18.0) ** 2 + ((xx - 30) / 25.0) ** 2 <= 1.0


CASES = {
    'bg-roi': dict(bground_im=background(), roi=ellipse_roi(), vmin=0.0, vmax=100.0),
    'bg-only': dict(bground_im=background(), vmin=0.0, vmax=100.0),
    'roi-only': dict(roi=ellipse_roi(), vmin=650.0, vmax=800.0),
    'neither': dict(vmin=None, vmax=None),
    'fractional-vmin': dict(bground_im=background(), roi=ellipse_roi(), vmin=7.3, vmax=90.0),
    'vmax-over-254': dict(bground_im=background(), roi=ellipse_roi(), vmin=0.0, vmax=400.0),
    'negative-vmin': dict(bground_im=background(), vmin=-20.5, vmax=60.0),
}


@pytest.mark.parametrize('dtype', ['<u2', '<i2'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_cxx_and_plain_match_jax(case, dtype, monkeypatch):
    frames = raw_frames(dtype)
    kwargs = CASES[case]
    ref = jax_prep(frames, **kwargs)
    plain = prep_raw_frames_plain(frames, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError('the plain version ran where the C++ core should')

    monkeypatch.setattr(preprocess, '_prep_frames_plain', refuse)
    ours = prep_raw_frames_host(frames, **kwargs)
    assert ours.dtype == plain.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(plain, ref)
    assert (ours[frames[(slice(None),) + _crop(kwargs)] == 0] == 255).all()   # dropouts
    assert ours[ours != 255].max() <= 254


def _crop(kwargs):
    if kwargs.get('roi') is None:
        return (slice(None), slice(None))
    (y0, x0), (y1, x1) = bbox_from_roi(kwargs['roi'])
    return (slice(y0, y1), slice(x0, x1))


def test_bbox_drops_the_last_row_and_column():
    roi = np.zeros((20, 30), bool)
    roi[3:11, 5:17] = True                     # rows 3..10, columns 5..16
    assert bbox_from_roi(roi) == jax_bbox(roi) == ((3, 5), (10, 16))
    frames = raw_frames(shape=(2, 20, 30))
    assert prep_raw_frames_host(frames, roi=roi).shape == (2, 7, 11)
    for x in (frames, frames[0]):
        np.testing.assert_array_equal(apply_roi(x, roi), jax_apply_roi(x, roi))
    assert bbox_from_roi(np.zeros((4, 4), bool)) is None
    np.testing.assert_array_equal(prep_raw_frames_host(frames, roi=np.zeros((20, 30), bool)),
                                  jax_prep(frames, roi=np.zeros((20, 30), bool)))


@pytest.mark.parametrize('view', ['columns', 'reversed', 'frames'])
def test_strided_input(view):
    frames = raw_frames(shape=(8, 48, 128))
    sub = {'columns': frames[:, :, ::2], 'reversed': frames[::-1, ::-1],
           'frames': frames[::3, :, 10:74]}[view]
    kwargs = dict(bground_im=background(sub.shape[1:]), roi=ellipse_roi(sub.shape[1:]),
                  vmin=0.0, vmax=100.0)
    np.testing.assert_array_equal(prep_raw_frames_host(sub, **kwargs), jax_prep(sub, **kwargs))


@pytest.mark.parametrize('case', ['bg-roi', 'neither', 'vmax-over-254'])
def test_uint16_frame_dtype_takes_the_plain_version(case):
    frames = raw_frames()
    kwargs = CASES[case]
    ours = prep_raw_frames_host(frames, dtype='uint16', **kwargs)
    ref = jax_prep(frames, dtype='uint16', **kwargs)
    assert ours.dtype == ref.dtype == np.uint16
    np.testing.assert_array_equal(ours, ref)
    assert (ours[frames[(slice(None),) + _crop(kwargs)] == 0] == 65535).all()


def test_negative_int16_takes_the_plain_version():
    frames = raw_frames('<i2')
    frames[0, 0, :5] = -7
    kwargs = CASES['bg-only']
    np.testing.assert_array_equal(prep_raw_frames_host(frames, **kwargs),
                                  jax_prep(frames, **kwargs))


def test_mismatched_background_raises():
    with pytest.raises(ValueError, match='bground_im'):
        prep_raw_frames_host(raw_frames(), bground_im=np.zeros((10, 10)))


def test_failed_host_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / '_build'))
    broken = tmp_path / 'broken.cpp'
    broken.write_text('extern "C" int prep_frames_native( {\n')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.build_host_library(str(broken))
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        native.build_host_library()


def test_host_build_is_cached_by_source(tmp_path, monkeypatch):
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / '_build'))
    first = native.build_host_library()
    assert first == native.build_host_library()
    assert first.startswith(str(tmp_path)) and first.endswith(native.HOST_LIB_NAME)
