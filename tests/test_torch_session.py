'''The port's session reader against the JAX package's, on sessions written
by ``tests/synthetic.py:write_synthetic_session`` (192 x 128): frames,
metadata and timestamps are held exactly.'''
import os
import shutil
import tarfile

import numpy as np
import pytest

from moseq2_detectron_extract_tpu.io.session import Session as JaxSession
from moseq2_detectron_extract_tpu.io.session import Stream as JaxStream
from moseq2_detectron_extract_tpu.io.session import TimestampMapper as JaxMapper
from moseq2_detectron_extract_tpu.io.util import gen_batch_sequence as jax_batches
from moseq2_detectron_extract_tpu_torch.io.session import Session, Stream, TimestampMapper
from moseq2_detectron_extract_tpu_torch.io.util import gen_batch_sequence
from moseq2_detectron_extract_tpu_torch.io.video import CompressedVideoError, read_frames_raw
from moseq2_detectron_extract_tpu_torch.synthetic import write_raw_session

from tests.synthetic import write_synthetic_session

NFRAMES = 70


@pytest.fixture(scope='module')
def session_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('sess'))
    write_synthetic_session(path, nframes=NFRAMES, seed=4)
    return path


@pytest.fixture(scope='module')
def tar_path(session_dir, tmp_path_factory):
    path = str(tmp_path_factory.mktemp('tar') / 'session_x.tar.gz')
    with tarfile.open(path, 'w:gz') as tar:
        for name in ('depth.dat', 'metadata.json', 'depth_ts.txt'):
            tar.add(os.path.join(session_dir, name), arcname=name)
    return path


def both(path, **kwargs):
    return Session(path, **kwargs), JaxSession(path, **kwargs)


def chunks(iterator):
    return [(list(map(int, idxs)), data) for idxs, data in iterator]


def assert_same_chunks(ours, ref):
    assert len(ours) == len(ref)
    for (oi, od), (ri, rd) in zip(ours, ref):
        assert oi == ri
        assert od.dtype == rd.dtype
        np.testing.assert_array_equal(od, rd)


@pytest.mark.parametrize('kind', ['dir', 'tar'])
@pytest.mark.parametrize('frame_trim', [(0, 0), (5, 7), (0, 10_000)])
def test_session_matches_jax(session_dir, tar_path, kind, frame_trim):
    path = os.path.join(session_dir, 'depth.dat') if kind == 'dir' else tar_path
    ours, ref = both(path, frame_trim=frame_trim)
    for attr in ('nframes', 'first_frame_idx', 'last_frame_idx', 'session_id', 'dirname',
                 'is_compressed', 'depth_metadata'):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert ours.load_metadata() == ref.load_metadata()
    np.testing.assert_array_equal(ours.load_timestamps(Stream.DEPTH),
                                  ref.load_timestamps(JaxStream.DEPTH))
    assert_same_chunks(chunks(ours.iterate(chunk_size=16, chunk_overlap=3)),
                       chunks(ref.iterate(chunk_size=16, chunk_overlap=3)))
    assert str(ours) == str(ref)


@pytest.mark.parametrize('kind', ['dir', 'tar'])
@pytest.mark.parametrize('chunk_size,overlap', [(32, 0), (32, 4), (100, 0)])
def test_blocked_reads_match_unblocked_and_jax(session_dir, tar_path, kind, chunk_size, overlap):
    '''32-frame blocks through a per-frame filter give the whole-chunk read.'''
    path = os.path.join(session_dir, 'depth.dat') if kind == 'dir' else tar_path
    ours, ref = both(path)
    filt = lambda x: (x // 3).astype('uint16')               # noqa: E731  a per-frame filter
    runs = []
    for session, stream, block in ((ours, Stream.DEPTH, 32), (ours, Stream.DEPTH, None),
                                   (ref, JaxStream.DEPTH, 32)):
        it = session.iterate(chunk_size=chunk_size, chunk_overlap=overlap, block_frames=block)
        it.attach_filter(stream, filt)
        runs.append(chunks(it))
    assert_same_chunks(runs[0], runs[1])
    assert_same_chunks(runs[0], runs[2])
    assert [len(i) for i, _ in runs[0]] == [len(b) for b in gen_batch_sequence(
        NFRAMES, chunk_size, overlap)]


def test_sampler_and_indexer_match_jax(session_dir):
    ours, ref = both(os.path.join(session_dir, 'depth.dat'), frame_trim=(3, 2))
    np.random.seed(11)
    sampled = chunks(ours.sample(9, chunk_size=4))
    np.random.seed(11)
    assert_same_chunks(sampled, chunks(ref.sample(9, chunk_size=4)))
    idxs = [40, 2, 3, 4, 17, 0]                 # unordered, with a consecutive run
    assert_same_chunks(chunks(ours.index(idxs, chunk_size=4)), chunks(ref.index(idxs, chunk_size=4)))
    raw = np.fromfile(os.path.join(session_dir, 'depth.dat'), '<i2').reshape(NFRAMES, 128, 192)
    (got_idxs, got), = chunks(ours.index(idxs, chunk_size=10))
    assert got_idxs == [i + 3 for i in idxs]
    np.testing.assert_array_equal(got, raw[got_idxs])


def test_timestamps_fallbacks_match_jax(session_dir, tmp_path):
    '''timestamps.csv in seconds (x 1000), then 30 frames/s made up.'''
    for name in ('depth.dat', 'metadata.json'):
        shutil.copy(os.path.join(session_dir, name), tmp_path / name)
    dat = str(tmp_path / 'depth.dat')
    ours, ref = both(dat, frame_trim=(2, 3))
    made_up = ours.load_timestamps(Stream.DEPTH)
    np.testing.assert_array_equal(made_up, ref.load_timestamps(JaxStream.DEPTH))
    np.testing.assert_allclose(made_up[:2], [2000 / 30, 3000 / 30])
    np.savetxt(tmp_path / 'timestamps.csv', np.c_[np.arange(NFRAMES) * 0.04, np.ones(NFRAMES)],
               delimiter=',', fmt='%.4f')
    ts = ours.load_timestamps(Stream.DEPTH)
    np.testing.assert_array_equal(ts, ref.load_timestamps(JaxStream.DEPTH))
    np.testing.assert_allclose(ts[:2], [80.0, 120.0])
    assert len(ts) == NFRAMES - 5


@pytest.mark.parametrize('nframes,chunk,overlap,offset', [
    (10, 4, 0, 0), (10, 4, 1, 0), (6, 3, 0, 2), (70, 32, 4, 0), (64, 32, 0, 5), (1, 8, 0, 0)])
def test_gen_batch_sequence_matches_jax(nframes, chunk, overlap, offset):
    ours = [list(b) for b in gen_batch_sequence(nframes, chunk, overlap, offset)]
    assert ours == [list(b) for b in jax_batches(nframes, chunk, overlap, offset)]


def test_gen_batch_sequence_cases():
    '''tests/test_io.py's cases.'''
    assert [list(b) for b in gen_batch_sequence(10, 4)] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert list(gen_batch_sequence(10, 4, overlap=1)[1])[0] == 3
    assert list(gen_batch_sequence(6, 3, offset=2)[0]) == [2, 3, 4]


def test_timestamp_mapper_matches_jax():
    ours, ref = TimestampMapper(), JaxMapper()
    for mapper in (ours, ref):
        mapper.add_timestamps('depth', np.array([0.0, 33.0, 66.0, 99.0]))
        mapper.add_timestamps('rgb', np.array([5.0, 40.0, 70.0]))
    assert ours.map_index('rgb', 'depth', [0, 2, 3]) == ref.map_index('rgb', 'depth', [0, 2, 3])
    assert ours.map_time('rgb', 'depth', 1) == ref.map_time('rgb', 'depth', 1) == [40.0]


@pytest.mark.parametrize('name', ['depth.avi', 'depth.mp4'])
def test_compressed_depth_raises(tmp_path, name):
    # the port decodes FFV1 in AVI: what is neither an AVI nor FFV1 raises,
    # naming the container
    (tmp_path / name).write_bytes(b'\0' * 64)
    match = {'depth.avi': 'not a RIFF file', 'depth.mp4': 'MP4 container'}[name]
    with pytest.raises(CompressedVideoError, match=match):
        Session(str(tmp_path / name))


def test_short_read_raises(session_dir, tmp_path):
    dat = tmp_path / 'depth.dat'
    dat.write_bytes(open(os.path.join(session_dir, 'depth.dat'), 'rb').read()[:192 * 128 * 2 * 3])
    with pytest.raises(EOFError):
        read_frames_raw(str(dat), frames=[2, 3], frame_dims=(192, 128))


def test_write_raw_session_reads_back(tmp_path):
    '''The port's raw session: an arena floor near 700, tilted 0.04 and 0.02
    mm per pixel and rough by 1.5 mm, ringed by walls at 500; a mouse up to
    about 70 mm above the floor, dropouts at 0, 30 frames/s.'''
    dat = write_raw_session(str(tmp_path), 6, height=64, width=96, seed=2)
    session = Session(dat)
    assert session.nframes == 6 and session.depth_metadata['dims'] == (96, 64)
    (_, frames), = chunks(session.iterate(chunk_size=10))
    assert frames.shape == (6, 64, 96) and frames.dtype == np.dtype('<i2')
    yy, xx = np.mgrid[0:64, 0:96]
    arena = (xx - 48) ** 2 + (yy - 32) ** 2 < 28 ** 2
    seen = frames[:, ~arena]
    assert set(np.unique(seen)) == {0, 500}
    inside = frames[:, arena].astype(int)
    floor = np.abs(inside - 700) <= 10
    mouse = (inside > 0) & ~floor
    assert floor.mean() > 0.5 and mouse.any()
    assert ((inside[mouse] > 620) & (inside[mouse] < 690)).all()
    # the floor: a least-squares plane gives the tilt, its residual the roughness
    on = floor[0]
    design = np.stack([xx[arena][on] - 48, yy[arena][on] - 32, np.ones(on.sum())], axis=1)
    coef, *_ = np.linalg.lstsq(design, inside[0][on], rcond=None)
    assert np.all(np.abs(coef - [0.04, 0.02, 700]) < [0.01, 0.01, 0.3]), coef
    assert 1.2 < np.std(inside[0][on] - design @ coef) < 1.8
    np.testing.assert_allclose(session.load_timestamps(Stream.DEPTH)[1], 1000 / 30, atol=1e-3)
