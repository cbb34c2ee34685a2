'''The port's HDF5 reader on files that h5py writes, on the CPU.

h5py (which the JAX package and the upstream extractor write their results
with) chunks a dataset along every axis: ``(1100, 80, 80)`` uint8 becomes
``(138, 10, 20)`` chunks. The port's reader must assemble rows from those
chunks and skip the object-header messages it does not use.

* h5py-written ``(n, 80, 80)`` uint8 and f32 and ``(n,)`` bool with h5py's own
  chunk guess: whole, row ranges across chunk edges and single rows equal
  h5py's reading, bit for bit; unwritten chunks hold the fill value; a
  compact layout and a filter other than deflate raise;
* a whole results file written by the JAX package's ``extract_session`` on
  the tiny model: every dataset, attribute and gzip level equal h5py's
  reading (variable-length strings, which h5py reads as bytes, compared as
  h5py's ``asstr()`` gives them);
* the port's ``visualize-result`` on that file: its frames before the
  encode equal those of the JAX package's ``H5ResultPreviewVideoGenerator``
  as ``tests/test_torch_preview.py`` holds them on a port-written file (the
  crop panels equal, the rebuilt arena at ``ARENA_SHARE``).
'''
import os

import h5py
import numpy as np
import pytest

from moseq2_detectron_extract_tpu_torch.io import hdf5

from tests.test_torch_preview import ARENA_SHARE, _decode, capture  # noqa: F401 (a fixture)


def _values(rng, shape, dtype):
    if dtype == 'bool':
        return rng.random(shape) < 0.5
    if dtype == 'uint8':
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.normal(0, 100, shape).astype(dtype)


@pytest.mark.parametrize('nframes', [1100, 37])
@pytest.mark.parametrize('dtype, per_frame', [('uint8', (80, 80)), ('float32', (80, 80)),
                                              ('bool', ())])
def test_h5py_chunks_read_as_h5py_reads_them(nframes, dtype, per_frame, tmp_path):
    path = str(tmp_path / 'chunked.h5')
    rng = np.random.default_rng(nframes)
    data = _values(rng, (nframes,) + per_frame, dtype)
    with h5py.File(path, 'w') as f:
        ds = f.create_dataset('data', data.shape, dtype, compression='gzip')
        ds[...] = data
        ds.attrs['description'] = 'per-frame values'
        chunks = ds.chunks
    if per_frame and nframes == 1100:
        assert chunks[1:] != per_frame, chunks           # split along the other axes
    with hdf5.File(path, 'r') as r:
        ds = r['data']
        assert ds.chunks == chunks and ds.compression_opts == 4
        assert ds.dtype == data.dtype and ds.attrs == {'description': 'per-frame values'}
        np.testing.assert_array_equal(ds[()], data)
        for start, stop in ((0, 5), (130, 290), (nframes - 3, nframes), (7, 8)):
            np.testing.assert_array_equal(ds[start:stop], data[start:stop])
        np.testing.assert_array_equal(ds[nframes // 2], data[nframes // 2])
        np.testing.assert_array_equal(ds[-1], data[-1])


def test_fill_value_and_what_the_reader_refuses(tmp_path):
    path = str(tmp_path / 'misc.h5')
    with h5py.File(path, 'w') as f:
        ds = f.create_dataset('partial', (300, 40, 40), 'int16', compression='gzip',
                              chunks=(50, 20, 40), fillvalue=-7)
        ds[60:110, :20] = 3
        f.create_dataset('unwritten', (10, 4), 'float32', fillvalue=2.5)
        space = h5py.h5s.create_simple((12,))
        plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        plist.set_layout(h5py.h5d.COMPACT)
        compact = h5py.Dataset(h5py.h5d.create(f.id, b'compact', h5py.h5t.NATIVE_INT32,
                                               space, plist))
        compact[...] = np.arange(12)
        f.create_dataset('shuffled', data=np.arange(100.0), compression='gzip', shuffle=True)
    with hdf5.File(path, 'r') as r, h5py.File(path, 'r') as h:
        for name in ('partial', 'unwritten'):
            np.testing.assert_array_equal(r[name][()], h[name][()], err_msg=name)
        np.testing.assert_array_equal(r['partial'][40:120], h['partial'][40:120])
        assert (r['partial'][0] == -7).all() and (r['unwritten'][()] == 2.5).all()
        with pytest.raises(ValueError, match='filter 2 is not supported'):
            r['shuffled']
        with pytest.raises(ValueError, match='layout class 0 is not supported'):
            r['compact']


@pytest.fixture(scope='module')
def jax_results(tmp_path_factory):
    '''A results file written by the JAX package's ``extract_session`` (the
    tiny model, the seed-9 session, the background injected as the JAX
    integration tests do).'''
    from moseq2_detectron_extract_tpu.extract import extract_session
    from moseq2_detectron_extract_tpu.io.session import Session
    from tests.synthetic import make_background
    from tests.test_torch_extract_session import (NFRAMES, _extract_config, make_predictors,
                                                  write_synthetic_session)
    path = write_synthetic_session(str(tmp_path_factory.mktemp('raw9')), nframes=NFRAMES,
                                   seed=9)
    out = str(tmp_path_factory.mktemp('jax_extract'))
    session = Session(path)
    session._bground_im = make_background()
    extract_session(session, _extract_config(out, make_predictors()[1]))
    return os.path.join(out, 'results_00.h5'), NFRAMES


def _h5py_items(path):
    '''name -> (kind, values, attributes, gzip level) of every group and
    dataset, as h5py reads them.'''
    out = {}
    with h5py.File(path, 'r') as f:
        def visit(name, obj):
            attrs = dict(obj.attrs)
            if isinstance(obj, h5py.Group):
                out[name] = ('group', None, attrs, None)
                return
            if h5py.check_string_dtype(obj.dtype) and obj.dtype.kind == 'O':
                value = obj.asstr()[()]
            else:
                value = obj[()]
            out[name] = ('dataset', value, attrs, obj.compression_opts)
        f.visititems(visit)
        out[''] = ('group', None, dict(f.attrs), None)
    return out


def test_jax_written_results_read_as_h5py_reads_them(jax_results):
    path, nframes = jax_results
    ref = _h5py_items(path)
    assert len(ref) > 100
    with hdf5.File(path, 'r') as r:
        seen = set()

        def walk(group):
            name = group.name.strip('/')
            seen.add(name)
            kind, _, attrs, _ = ref[name]
            assert kind == 'group' and group.attrs == attrs, name
            for key in group.keys():
                child = group[key]
                if isinstance(child, hdf5.ReadGroup):
                    walk(child)
                    continue
                cname = child.name.strip('/')
                seen.add(cname)
                kind, value, attrs, level = ref[cname]
                got = child[()]
                assert kind == 'dataset' and child.attrs == attrs, cname
                assert child.compression_opts == level, cname
                if isinstance(value, h5py.Empty):
                    assert isinstance(got, hdf5.Empty) and got.dtype == value.dtype, cname
                elif isinstance(value, np.ndarray):
                    assert got.dtype == value.dtype and got.shape == value.shape, cname
                    np.testing.assert_array_equal(got, value, err_msg=cname)
                    if value.ndim and len(value) == nframes:
                        np.testing.assert_array_equal(child[3:29], value[3:29])
                else:
                    assert type(got) is type(value) and (got == value or got != got), cname
        walk(r.root)
    assert seen == set(ref)
    with h5py.File(path, 'r') as f:
        assert f['frames'].chunks[1:] != f['frames'].shape[1:]


def test_visualize_result_on_a_jax_written_file(jax_results, tmp_path, capture):  # noqa: F811
    from moseq2_detectron_extract_tpu import viz as jviz
    from moseq2_detectron_extract_tpu_torch import cli
    path, nframes = jax_results
    ours, ref = capture
    out = str(tmp_path / 'result.avi')
    assert cli.main(['visualize-result', path, '-o', out, '--chunk-size', '16',
                     '--device', 'cpu']) == 0
    jviz.H5ResultPreviewVideoGenerator(path, str(tmp_path / 'ref.mp4'), chunk_size=16).generate()
    ours_f, ref_f = np.array(ours.frames), np.array(ref.frames)
    assert ours_f.shape == ref_f.shape and len(ours_f) == nframes
    with h5py.File(path, 'r') as fh:
        xs = np.nonzero(fh['metadata/extraction/roi'][()] > 0)[1]
    dest_w = int(xs.max() - xs.min())
    np.testing.assert_array_equal(ours_f[:, :, dest_w:], ref_f[:, :, dest_w:])
    same = (ours_f[:, :, :dest_w] == ref_f[:, :, :dest_w]).all(-1).mean()
    assert same >= ARENA_SHARE
    assert _decode(out)[0][0] == nframes
