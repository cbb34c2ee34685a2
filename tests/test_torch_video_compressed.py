'''Compressed depth on the CPU against the JAX package (whose compressed
path is cv2 5.0's libavcodec here).

* ``write_frames`` (chunked, the keep-open pipe), ``get_video_info``,
  ``read_frames`` and ``load_movie_data`` of each package read the other's
  file, equal to the raw frames;
* ``convert-raw-to-avi`` of each package (its verify pass included) reads
  back through the other package; ``--delete`` removes the raw file only
  after the verify pass;
* a ``depth.avi`` session: ``Session``, its blocked reads, ``find_roi`` and
  a short ``extract`` through ``cli.main`` equal the same on its
  ``depth.dat``;
* what the port cannot decode raises naming the codec or the container.
'''
import os
import shutil
import tarfile

import numpy as np
import pytest
from click.testing import CliRunner

from moseq2_detectron_extract_tpu.cli import cli as jax_cli
from moseq2_detectron_extract_tpu.io import video as jvideo
from moseq2_detectron_extract_tpu_torch import cli
from moseq2_detectron_extract_tpu_torch.io import video
from moseq2_detectron_extract_tpu_torch.io.session import Session
from tests.synthetic import write_synthetic_session

W, H, N = 512, 424, 12    # convert-raw-to-avi assumes Kinect frames


@pytest.fixture()
def kinect_raw(tmp_path):
    rng = np.random.default_rng(11)
    frames = (650 + rng.integers(0, 100, (N, H, W))).astype('<u2')
    frames[:, 100:140, 200:260] = rng.integers(0, 65535, (N, 40, 60), dtype='<u2')
    frames[3, :4] = 0
    path = tmp_path / 'depth.dat'
    frames.tofile(path)
    return str(path), frames


def _write_chunked(write_frames, path, frames):
    pipe = None
    for s in range(0, len(frames), 5):
        pipe = write_frames(path, frames[s:s + 5], close_pipe=False, pipe=pipe)
    pipe.stdin.close()
    pipe.wait()


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_each_package_reads_the_others_file(kinect_raw, tmp_path, writer):
    _, frames = kinect_raw
    path = str(tmp_path / f'{writer}.avi')
    _write_chunked((video if writer == 'port' else jvideo).write_frames, path, frames)
    reader = jvideo if writer == 'port' else video
    info = reader.get_video_info(path)
    assert (info['codec'], info['pixel_format'], info['dims'], info['nframes']) == \
        ('ffv1', 'gray16le', (W, H), N)
    assert info['fps'] == 30.0
    np.testing.assert_array_equal(np.squeeze(reader.read_frames(path)), frames)
    idxs = [7, 3, 4, 5, 11, 0, 9]
    np.testing.assert_array_equal(np.squeeze(reader.read_frames(path, idxs)), frames[idxs])
    np.testing.assert_array_equal(np.squeeze(reader.load_movie_data(path, [2, 9])),
                                  frames[[2, 9]])
    assert reader.get_movie_info(path)['nframes'] == N


@pytest.mark.parametrize('converter', ['port', 'jax'])
def test_convert_raw_to_avi_reads_back_in_the_other_package(kinect_raw, converter):
    path, frames = kinect_raw
    avi = os.path.splitext(path)[0] + '.avi'
    if converter == 'port':
        assert cli.main(['convert-raw-to-avi', path, '--chunk-size', '5', '--delete']) == 0
        assert not os.path.exists(path)
        got = np.squeeze(jvideo.read_frames(avi))
    else:
        result = CliRunner().invoke(jax_cli, ['convert-raw-to-avi', path, '--chunk-size', '5'],
                                    catch_exceptions=False)
        assert result.exit_code == 0, result.output
        got = video.read_frames(avi)
    np.testing.assert_array_equal(got, frames)


def test_convert_verify_raises_on_a_mismatch_and_keeps_the_raw_file(kinect_raw, monkeypatch):
    path, _ = kinect_raw
    real = video.read_frames

    def corrupt(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0, 0, 0] ^= 1
        return out
    monkeypatch.setattr(video, 'read_frames', corrupt)
    with pytest.raises(RuntimeError, match='Conversion mismatch in frames 0-4'):
        cli.main(['convert-raw-to-avi', path, '--chunk-size', '5', '--delete'])
    assert os.path.exists(path)


def _avi_session(dat: str, dirname: str) -> str:
    '''A copy of the session at ``dat`` with its depth in FFV1.'''
    os.makedirs(dirname)
    src = os.path.dirname(dat)
    for name in os.listdir(src):
        if name != 'depth.dat':
            shutil.copy(os.path.join(src, name), dirname)
    session = Session(dat)
    avi = os.path.join(dirname, 'depth.avi')
    frames = video.read_frames_raw(dat, frame_dims=session.depth_metadata['dims'])
    video.write_frames(avi, frames, slices=4)
    return avi


@pytest.fixture(scope='module')
def sessions(tmp_path_factory):
    root = tmp_path_factory.mktemp('sessions')
    dat = write_synthetic_session(str(root / 'raw'), nframes=40, seed=9)
    return dat, _avi_session(dat, str(root / 'avi'))


def test_avi_session_reads_as_dat(sessions):
    dat, avi = sessions
    a, b = Session(dat), Session(avi)
    assert b.nframes == a.nframes == 40
    assert b.depth_metadata['dims'] == a.depth_metadata['dims']
    for block in (None, 7):
        ours = list(b.iterate(chunk_size=16, block_frames=block))
        ref = list(a.iterate(chunk_size=16, block_frames=block))
        for (ia, fa), (ib, fb) in zip(ours, ref):
            assert ia == ib
            np.testing.assert_array_equal(fa, fb.astype(np.uint16))
    got = next(iter(b.index([30, 2, 17])))[1]
    np.testing.assert_array_equal(got, next(iter(a.index([30, 2, 17])))[1].astype(np.uint16))
    np.random.seed(3)
    sampled = next(iter(b.sample(5)))
    np.random.seed(3)
    assert list(sampled[0]) == list(next(iter(a.sample(5)))[0])
    for x, y in zip(b.find_roi(device='cpu'), a.find_roi(device='cpu')):
        np.testing.assert_array_equal(x, y)


def test_avi_iterators_read_in_turn_through_their_own_readers(sessions):
    dat, avi = sessions
    a, b = Session(dat), Session(avi)
    first, second = b.iterate(chunk_size=6), b.index([39, 5, 12, 30], chunk_size=2)
    assert first._reader is not second._reader
    got = [next(first), next(second), next(first), next(second), next(first)]
    ref_first, ref_second = a.iterate(chunk_size=6), a.index([39, 5, 12, 30], chunk_size=2)
    ref = [next(ref_first), next(ref_second), next(ref_first), next(ref_second),
           next(ref_first)]
    for (ig, fg), (ir, fr) in zip(got, ref):
        assert list(ig) == list(ir)
        np.testing.assert_array_equal(fg, fr.astype(np.uint16))
    reader = second._reader
    with pytest.raises(StopIteration):
        next(second)
    assert second._reader is None and reader._dec is None
    with pytest.raises(ValueError, match='closed'):
        reader.read([0])


def _h5_datasets(path):
    import h5py
    out = {}
    with h5py.File(path, 'r') as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_extract_on_avi_equals_dat(sessions, tmp_path):
    from tests.test_torch_extract_session import DATA, JaxModelConfig
    model_dir = tmp_path / 'model'
    model_dir.mkdir()
    JaxModelConfig.from_yaml(os.path.join(DATA, 'tiny_overfit_config.yaml')) \
        .replace(amp_dtype='float32').to_yaml(str(model_dir / 'config.yaml'))
    shutil.copy(os.path.join(DATA, 'tiny_overfit_params.npz'), str(model_dir / 'params_f16.npz'))
    results = {}
    for path in sessions:
        out = str(tmp_path / os.path.basename(path))
        assert cli.main(['extract', path, '--model', str(model_dir), '--device', 'cpu',
                         '--chunk-size', '16', '--output-dir', out]) == 0
        results[path] = _h5_datasets(os.path.join(out, 'results_00.h5'))
    ours, ref = results[sessions[1]], results[sessions[0]]
    assert sorted(ours) == sorted(ref)
    assert np.isfinite(ref['scalars/centroid_x_px']).sum() > 20   # the mouse was found
    # the file names, the output directory and the run's uuid differ by design
    differ = {'metadata/extraction/parameters/input_file',
              'metadata/extraction/parameters/output_dir', 'metadata/uuid'}
    for key in ref:
        if key in differ:
            assert ours[key] != ref[key], key
        else:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_what_the_port_cannot_decode_raises(tmp_path):
    mp4 = tmp_path / 'depth.mp4'
    mp4.write_bytes(b'\0' * 64)
    with pytest.raises(video.CompressedVideoError, match='MP4 container'):
        video.get_movie_info(str(mp4))
    mjpg = str(tmp_path / 'mjpg.avi')
    writer = video.PreviewVideoWriter(mjpg)
    writer.write_frames(None, np.zeros((2, 16, 16), np.uint8))
    writer.close()
    with pytest.raises(video.CompressedVideoError, match="codec 'MJPG'"):
        video.load_movie_data(mjpg, [0])
    with tarfile.open(str(tmp_path / 's.tar.gz'), 'w:gz') as tar:
        tar.add(mjpg, arcname='depth.avi')
    with tarfile.open(str(tmp_path / 's.tar.gz')) as tar:
        with pytest.raises(video.CompressedVideoError, match='tar member depth.avi'):
            video.load_movie_data(tar.getmember('depth.avi'), [0], tar_object=tar)
