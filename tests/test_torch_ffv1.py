'''The port's FFV1 codec (``csrc/ffv1_host.cpp`` through ``io/ffv1.py``)
against libavcodec, through cv2 5.0's FFMPEG backend, both ways.

* cv2 encodes and the port decodes, bit for bit, at an odd size and at
  512x424, 30 frames (keyframes 0, 12 and 24), whole and in random,
  repeated and out-of-order reads that cross keyframes;
* the port encodes at 1, 4 and 24 slices and cv2 decodes, bit for bit;
* the committed libavcodec fixture decodes to its frames, rebuilt from
  their seed (``synthetic.codec_fixture_frames``);
* a flipped byte inside a slice raises, naming the frame and the slice;
* the OpenDML index (``indx`` and ``ix00``) of a file written with the RIFF
  limit lowered reaches every frame, and cv2 reads that file too;
* the port's file is within 10% of cv2's bytes for the same frames (within
  0.1% at cv2's own 2x2 slice grid);
* a configuration record of another version is refused by name.
'''
import os

import cv2
import numpy as np
import pytest

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.io.avi import AviWriter, read_avi
from moseq2_detectron_extract_tpu_torch.io.ffv1 import (Ffv1Error, Ffv1Reader, Ffv1Writer,
                                                        config_info)
from moseq2_detectron_extract_tpu_torch.synthetic import codec_fixture_frames

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
FIXTURE = os.path.join(DATA, 'ffv1_libavcodec_130x106.avi')
SIZES = [(106, 130), (424, 512)]


def _frames(n, height, width, seed):
    '''Depth-like frames with dropouts and a patch of full-range noise.'''
    frames = codec_fixture_frames(n, height, width, seed=seed)
    frames[n // 2, height // 3:height // 2] = 0
    return frames


def cv2_write(path, frames):
    n, h, w = frames.shape
    writer = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*'FFV1'), 30.0, (w, h),
                             [cv2.VIDEOWRITER_PROP_DEPTH, cv2.CV_16U,
                              cv2.VIDEOWRITER_PROP_IS_COLOR, 0])
    assert writer.isOpened()
    for frame in frames:
        writer.write(frame)
    writer.release()


def cv2_read(path):
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame.reshape(frame.shape[:2]))
    cap.release()
    return np.array(out)


@pytest.fixture(scope='module', params=SIZES, ids=['130x106', '512x424'])
def cv2_file(request, tmp_path_factory):
    h, w = request.param
    frames = _frames(30, h, w, seed=h)
    path = str(tmp_path_factory.mktemp('cv2') / 'depth.avi')
    cv2_write(path, frames)
    return path, frames


def test_port_decodes_libavcodec(cv2_file):
    path, frames = cv2_file
    reader = Ffv1Reader(path)
    assert reader.config['version'] == 3 and reader.config['ec'] == 1
    assert np.flatnonzero(reader.index.keyframes).tolist() == [0, 12, 24]
    np.testing.assert_array_equal(reader.read(), frames)


@pytest.mark.parametrize('order', [[29, 3, 13, 12, 11, 0, 25, 24, 5, 5, 23],
                                   [13, 14, 26, 27], [28, 29], [11, 12, 1, 2]])
def test_random_reads_cross_keyframes(cv2_file, order):
    path, frames = cv2_file
    reader = Ffv1Reader(path, threads=3)
    np.testing.assert_array_equal(reader.read(order), frames[order])
    # a read that follows the last one goes on from the decoder's state
    follow = [order[-1] + 1] if order[-1] + 1 < len(frames) else [0]
    np.testing.assert_array_equal(reader.read(follow), frames[follow])


@pytest.mark.parametrize('slices', [1, 4, 24])
@pytest.mark.parametrize('size', SIZES, ids=['130x106', '512x424'])
def test_libavcodec_decodes_port(tmp_path, slices, size):
    frames = _frames(31, *size, seed=slices)
    path = str(tmp_path / 'port.avi')
    writer = Ffv1Writer(path, size[1], size[0], slices=slices)
    writer.write_frames(frames[:17])
    writer.write_frames(frames[17:])
    writer.close()
    info = config_info(read_avi(path).extradata)
    assert info['num_h'] * info['num_v'] == slices and info['version'] == 3
    np.testing.assert_array_equal(cv2_read(path), frames)
    np.testing.assert_array_equal(Ffv1Reader(path).read(), frames)


def test_committed_fixture_decodes_to_its_frames():
    expect = codec_fixture_frames()
    np.testing.assert_array_equal(cv2_read(FIXTURE), expect)
    reader = Ffv1Reader(FIXTURE)
    np.testing.assert_array_equal(reader.read(), expect)
    np.testing.assert_array_equal(reader.read([25, 0, 13]), expect[[25, 0, 13]])


def test_flipped_byte_raises_naming_frame_and_slice(cv2_file, tmp_path):
    path, _ = cv2_file
    index = read_avi(path)
    data = bytearray(open(path, 'rb').read())
    frame = 14
    data[int(index.offsets[frame]) + int(index.sizes[frame]) // 2] ^= 0x20
    bad = str(tmp_path / 'bad.avi')
    with open(bad, 'wb') as fh:
        fh.write(data)
    reader = Ffv1Reader(bad)
    np.testing.assert_array_equal(reader.read([3]), Ffv1Reader(path).read([3]))
    with pytest.raises(Ffv1Error, match=rf'frame {frame}, slice \d+: slice CRC mismatch'):
        reader.read([frame])


def test_opendml_index_reaches_every_frame(tmp_path):
    frames = _frames(40, 106, 130, seed=3)
    path = str(tmp_path / 'odml.avi')
    writer = Ffv1Writer(path, 130, 106, riff_limit=60_000)
    for s in range(0, 40, 7):
        writer.write_frames(frames[s:s + 7])
    writer.close()
    index = read_avi(path)
    assert index.source == 'indx' and index.riffs[0] == 'AVI '
    assert len(index.riffs) > 2 and set(index.riffs[1:]) == {'AVIX'}
    assert sum(index.super) == index.nframes == 40 and index.idx1 < 40
    assert np.flatnonzero(index.keyframes).tolist() == [0, 12, 24, 36]
    walked = read_avi(path, walk=True)
    np.testing.assert_array_equal(walked.offsets, index.offsets)
    np.testing.assert_array_equal(Ffv1Reader(path).read([39, 1, 25]), frames[[39, 1, 25]])
    np.testing.assert_array_equal(cv2_read(path), frames)


@pytest.mark.parametrize('slices, tol', [(24, 0.10), (4, 0.001)])
def test_port_file_within_ten_percent_of_libavcodec(tmp_path, slices, tol):
    # cv2 codes a 2x2 grid: at that grid the port's frames come within a few
    # bytes of libavcodec's (the same coder); at the upstream command's 24
    # slices within 10%
    frames = _frames(30, 424, 512, seed=7)
    ours, ref = str(tmp_path / 'ours.avi'), str(tmp_path / 'ref.avi')
    cv2_write(ref, frames)
    writer = Ffv1Writer(ours, 512, 424, slices=slices)
    writer.write_frames(frames)
    writer.close()
    got, expect = read_avi(ours).sizes.sum(), read_avi(ref).sizes.sum()
    print(f'{slices} slices: port {got} bytes of frames, libavcodec {expect}: {got / expect:.5f}')
    assert abs(got / expect - 1) < tol


def test_other_versions_are_refused_by_name():
    # the first symbol of a configuration record is its version: search
    # seeded byte strings for records that start with versions 1, 2 and 4
    lib = native.load_ffv1_library()
    rng = np.random.default_rng(0)
    found = {}
    info, detail = np.zeros(11, np.int32), np.zeros(1, np.int32)
    while len(found) < 3:
        extra = rng.integers(0, 256, 16, dtype=np.uint8)
        rc = lib.m2de_ffv1_parse_config(extra.ctypes.data, extra.size, info.ctypes.data,
                                        detail.ctypes.data)
        if rc == -3 and int(detail[0]) in (1, 2, 4):
            found.setdefault(int(detail[0]), extra.tobytes())
    for version, extra in found.items():
        with pytest.raises(Ffv1Error, match=f'FFV1 version {version} is not supported'):
            config_info(extra)


def test_versions_without_a_record_are_refused_by_name(tmp_path):
    # versions 0-1 have no configuration record: the keyframe's first symbol
    # after the keyframe bit is the version
    lib = native.load_ffv1_library()
    rng = np.random.default_rng(1)
    while True:
        packet = rng.integers(0, 256, 64, dtype=np.uint8)
        if lib.m2de_ffv1_inline_version(packet.ctypes.data, packet.size) == 1:
            break
    path = str(tmp_path / 'v1.avi')
    writer = AviWriter(path, 16, 16, fourcc=b'FFV1', bit_count=16)
    writer.write([packet.tobytes()])
    writer.close()
    with pytest.raises(Ffv1Error, match='FFV1 version 1 is not supported'):
        Ffv1Reader(path)
