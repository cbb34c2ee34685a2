'''The port's HDF5 writer and reader (``io/hdf5.py``) against h5py.

The same content goes through h5py and through the port's writer; h5py
reads both files, and they must agree name for name, value for value and
type for type: shapes, dtypes, the string type (variable-length UTF-8 or
fixed-length ASCII), the enum of numpy bool (int8 base, FALSE/TRUE),
``compression``/``compression_opts``, the null dataspace and the
``description`` attributes. The port's reader reads the port's files back
equal. The content forces more than one node where HDF5 has nodes: a group
of 48 entries (a symbol-table node holds 8) and datasets of more chunks than
one B-tree node indexes (64), written in several appends.
'''
import os

import h5py
import numpy as np
import pytest

from moseq2_detectron_extract_tpu_torch.io import hdf5


def _content(rng, empty):
    '''(path, create_dataset's keywords) of each small dataset.'''
    return [
        ('metadata/uuid', {'data': '4f1c2e9a-uuid'}),
        ('metadata/extraction/true_depth', {'data': np.float64(673.25)}),
        ('metadata/extraction/extract_version', {'data': 'v1 ü'}),
        ('params/int', {'data': 7}),
        ('params/float', {'data': 0.1}),
        ('params/bool', {'data': True}),
        ('params/pair', {'data': np.asarray((10, 10))}),
        ('params/weights', {'data': np.asarray((1, .1, 1))}),
        ('params/names', {'data': np.array([b'Nose', b'Left Ear', b''])}),
        ('params/bools', {'data': np.array([True, False, True])}),
        ('params/none', {'data': empty('f')}),
        ('metadata/acquisition/missing', {'dtype': 'f'}),
        ('metadata/extraction/roi',
         {'data': rng.random((37, 41)) > 0.5, 'compression': 'gzip'}),
        ('metadata/extraction/first_frame',
         {'data': rng.integers(0, 900, (37, 41)).astype('int16'), 'compression': 'gzip'}),
        ('timestamps', {'data': np.arange(300) * 33.3, 'compression': 'gzip'}),
        ('u16', {'data': rng.integers(0, 65535, (5, 3)).astype('uint16')}),
        ('i8', {'data': rng.integers(-100, 100, 6).astype('int8')}),
        ('strings/ascii', {'data': [b'a', b'bc', b'']}),
        ('strings/utf8', {'data': ['é', 'plain']}),
        ('strings/blob', {'data': b'raw bytes'}),
    ]


def _write(module, path, rng_seed=0, chunks=True):
    '''The same content through ``module`` (h5py or the port's hdf5).'''
    rng = np.random.default_rng(rng_seed)
    kw = {'chunks': (7, 6, 5)} if chunks else {}
    with module.File(path, 'w') as f:
        for name, kwargs in _content(rng, module.Empty):
            ds = f.create_dataset(name, **kwargs)
            ds.attrs['description'] = f'about {name}'
        # a group of 48 entries, created in several appends
        for i in range(48):
            ds = f.create_dataset(f'keypoints/reference/kp{i:02d}_x_px', (300,), 'float32',
                                  compression='gzip')
            ds.attrs['description'] = f'X position of kp{i} (pixels) in reference coordinate system.'
        for start in range(0, 300, 97):
            rows = np.arange(start, min(300, start + 97))
            for i in range(48):
                f[f'keypoints/reference/kp{i:02d}_x_px'][rows] = rows * 0.5 + i
        # more chunks than one B-tree node: 1000 rows in chunks of 7 (143
        # chunks), written chunk-unaligned in appends of 333 rows
        frames = f.create_dataset('frames', (1000, 6, 5), 'uint8', compression='gzip', **kw)
        mask = f.create_dataset('frames_mask', (1000, 6, 5), 'bool', compression='gzip', **kw)
        flips = f.create_dataset('metadata/extraction/flips', (1000,), 'bool',
                                 compression='gzip', **({'chunks': (7,)} if chunks else {}))
        flips.attrs['description'] = 'Output from flip classifier, false=no flip, true=flip'
        data = rng.integers(0, 256, (1000, 6, 5)).astype('uint8')
        for start in range(0, 1000, 333):
            rows = np.arange(start, min(1000, start + 333))
            frames[rows] = data[rows]
            mask[rows] = (data[rows] > 128).astype('uint8')
            flips[rows] = data[rows, 0, 0] > 100
        lvl = f.create_dataset('level9', (50,), 'float64', compression='gzip',
                               compression_opts=9)
        lvl[:] = np.linspace(0, 1, 50)
    return data


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('h5')
    ref, ours = str(tmp / 'h5py.h5'), str(tmp / 'port.h5')
    _write(h5py, ref)
    data = _write(hdf5, ours)
    return ref, ours, data


def _names(f):
    names = []
    f.visit(names.append)
    return sorted(names)


def _type_signature(ds):
    '''What h5py says about a dataset's HDF5 type.'''
    tid = ds.id.get_type()
    sig = {'class': tid.get_class(), 'size': tid.get_size(),
           'string': h5py.check_string_dtype(ds.dtype)}
    if isinstance(tid, h5py.h5t.TypeEnumID):
        sig['enum'] = [(tid.get_member_name(i), tid.get_member_value(i))
                       for i in range(tid.get_nmembers())]
        sig['base'] = (tid.get_super().get_class(), tid.get_super().get_size(),
                       tid.get_super().get_sign())
    if isinstance(tid, h5py.h5t.TypeStringID):
        sig['cset'] = tid.get_cset()
        sig['vlen'] = tid.is_variable_str()
        if not tid.is_variable_str():
            sig['pad'] = tid.get_strpad()
    return sig


def _attr_signature(obj, name):
    aid = obj.attrs.get_id(name)
    tid = aid.get_type()
    return (tid.get_class(), h5py.check_string_dtype(aid.dtype), aid.shape,
            tid.is_variable_str() if isinstance(tid, h5py.h5t.TypeStringID) else None)


def test_h5py_reads_the_same_names(files):
    ref, ours, _ = files
    with h5py.File(ref, 'r') as a, h5py.File(ours, 'r') as b:
        assert _names(a) == _names(b)
        assert len(b['keypoints/reference']) == 48


def test_h5py_reads_the_same_types_and_layouts(files):
    ref, ours, _ = files
    with h5py.File(ref, 'r') as a, h5py.File(ours, 'r') as b:
        for name in _names(a):
            if not isinstance(a[name], h5py.Dataset):
                assert isinstance(b[name], h5py.Group), name
                continue
            da, db = a[name], b[name]
            assert da.shape == db.shape, name
            assert da.dtype == db.dtype, name
            assert _type_signature(da) == _type_signature(db), name
            assert (da.compression, da.compression_opts) == (db.compression,
                                                             db.compression_opts), name
            assert (da.chunks is None) == (db.chunks is None), name
            assert da.id.get_space().get_simple_extent_type() == \
                db.id.get_space().get_simple_extent_type(), name
            assert sorted(da.attrs) == sorted(db.attrs), name
            for key in da.attrs:
                assert da.attrs[key] == db.attrs[key], (name, key)
                assert _attr_signature(da, key) == _attr_signature(db, key), (name, key)


def test_h5py_reads_the_same_values(files):
    ref, ours, _ = files
    with h5py.File(ref, 'r') as a, h5py.File(ours, 'r') as b:
        for name in _names(a):
            if isinstance(a[name], h5py.Dataset):
                va, vb = a[name][()], b[name][()]
                if isinstance(va, h5py.Empty):
                    assert isinstance(vb, h5py.Empty) and va.dtype == vb.dtype, name
                else:
                    assert np.array_equal(va, vb), name
                    assert type(va) is type(vb), name


def test_gzip_level_and_null_dataspace(files):
    _, ours, _ = files
    with h5py.File(ours, 'r') as b:
        assert (b['frames'].compression, b['frames'].compression_opts) == ('gzip', 4)
        assert b['level9'].compression_opts == 9
        assert b['params/none'].shape is None and b['metadata/acquisition/missing'].shape is None
        assert b['params/none'].id.get_space().get_simple_extent_type() == h5py.h5s.NULL
        assert h5py.check_string_dtype(b['metadata/uuid'].dtype).encoding == 'utf-8'
        assert h5py.check_string_dtype(b['params/names'].dtype).length == 8
        assert b['frames_mask'].dtype == bool and b['frames_mask'].id.get_type().get_class() == \
            h5py.h5t.ENUM


def test_port_reader_reads_its_files_back(files):
    ref, ours, data = files
    with h5py.File(ref, 'r') as a:
        r = hdf5.File(ours, 'r')
        names = []
        for path, ds in r.visit_datasets():
            names.append(path.lstrip('/'))
            va = a[path][()]
            vb = ds[()]
            if isinstance(va, h5py.Empty):
                assert isinstance(vb, hdf5.Empty) and vb.dtype == va.dtype, path
            elif h5py.check_string_dtype(a[path].dtype) is not None and \
                    h5py.check_string_dtype(a[path].dtype).length is None:
                # h5py gives bytes; the reader str for UTF-8, bytes for ASCII
                utf8 = h5py.check_string_dtype(a[path].dtype).encoding == 'utf-8'
                decoded = np.vectorize(lambda v: v.decode('utf-8'), otypes=[object])(va) \
                    if utf8 else va
                assert np.array_equal(np.asarray(vb, object), np.asarray(decoded, object)), path
            else:
                assert np.array_equal(np.asarray(va), np.asarray(vb)), path
                assert np.asarray(vb).dtype == np.asarray(va).dtype, path
            assert ds.attrs == {k: v for k, v in a[path].attrs.items()}, path
            assert ds.compression == a[path].compression, path
        assert sorted(names) == sorted(n for n in _names(a) if isinstance(a[n], h5py.Dataset))
        r.close()


def test_port_reader_reads_ranges(files):
    _, ours, data = files
    with hdf5.File(ours, 'r') as r:
        frames = r['frames']
        assert frames.shape == (1000, 6, 5) and frames.chunks == (7, 6, 5)
        np.testing.assert_array_equal(frames[330:340], data[330:340])
        np.testing.assert_array_equal(frames[999], data[999])
        np.testing.assert_array_equal(frames[-1], data[-1])
        np.testing.assert_array_equal(r['frames_mask'][5:700], data[5:700] > 128)
        np.testing.assert_array_equal(r['metadata/extraction/flips'][0:1000:3],
                                      (data[:, 0, 0] > 100)[::3])
        assert r['metadata/uuid'][()] == '4f1c2e9a-uuid'
        assert r['metadata/extraction/true_depth'][()] == 673.25
        assert 'keypoints/reference/kp47_x_px' in r and 'keypoints/nope' not in r


def test_chunk_index_and_group_span_several_nodes(files):
    '''The chunk B-tree of ``frames`` has a root above its leaves, and the
    48-entry group's names sit in six symbol-table nodes.'''
    _, ours, _ = files
    with hdf5.File(ours, 'r') as r:
        ds = r['frames']
        index = int.from_bytes(r._read(ds._index + 5, 1), 'little')
        assert index >= 1                     # the root's level: not a leaf
        group = r['keypoints/reference']
        stab = [body for mtype, _, body in r.messages(group.addr) if mtype == hdf5.MSG_STAB][0]
        assert len(group._snods(int.from_bytes(stab[:8], 'little'))) == 6


def test_trees_of_three_levels(tmp_path):
    '''A group of 300 entries (38 symbol-table nodes: a group B-tree of two
    levels) and a dataset of 5,000 chunks (a chunk B-tree of three levels),
    written out of order, read by h5py and by the reader.'''
    path = str(tmp_path / 'deep.h5')
    values = np.arange(5000, dtype='int64') * 3
    with hdf5.File(path, 'w') as f:
        for i in reversed(range(300)):
            f.create_dataset(f'many/n{i:03d}', data=i)
        ds = f.create_dataset('long', (5000,), 'int64', compression='gzip', chunks=(1,))
        for start in (4000, 0, 2500, 1000):
            rows = np.arange(start, start + 1000 if start != 2500 else 4000)
            ds[rows] = values[rows]
        ds[np.arange(2000, 2500)] = values[2000:2500]
    with h5py.File(path, 'r') as f:
        assert list(f['many']) == [f'n{i:03d}' for i in range(300)]
        assert all(f[f'many/n{i:03d}'][()] == i for i in (0, 7, 8, 255, 256, 299))
        np.testing.assert_array_equal(f['long'][()], values)
    with hdf5.File(path, 'r') as r:
        assert r['many'].keys() == [f'n{i:03d}' for i in range(300)]
        np.testing.assert_array_equal(r['long'][1990:2510], values[1990:2510])
        assert int.from_bytes(r._read(r['long']._index + 5, 1), 'little') == 2


def test_rows_written_again_and_rows_never_written(tmp_path):
    '''A stored chunk written to again is read back and rewritten; rows never
    written read as 0 (HDF5's default fill), through h5py and the reader.'''
    path = str(tmp_path / 'rewrite.h5')
    with hdf5.File(path, 'w') as f:
        ds = f.create_dataset('x', (100, 2), 'float32', compression='gzip', chunks=(8, 2))
        ds[np.arange(0, 40)] = 1.0
        ds[np.arange(4, 12)] = 2.0                 # chunks 0 and 1, both stored
        ds[np.array([50, 3, 95])] = np.array([[5, 5], [3, 3], [9, 9]])    # any order
        ds[60] = 6.0
    expected = np.zeros((100, 2), 'float32')
    expected[:40] = 1
    expected[4:12] = 2
    expected[50], expected[3], expected[95], expected[60] = 5, 3, 9, 6
    with h5py.File(path, 'r') as f:
        np.testing.assert_array_equal(f['x'][()], expected)
    with hdf5.File(path, 'r') as r:
        np.testing.assert_array_equal(r['x'][()], expected)


def test_unsupported_inputs_raise(tmp_path):
    with hdf5.File(str(tmp_path / 'bad.h5'), 'w') as f:
        with pytest.raises(ValueError):
            f.create_dataset('x', (4,), 'f4', compression='lzf')
        with pytest.raises(TypeError):
            f.create_dataset('y', data=np.array(['unicode']))
        f.create_dataset('z', (2,), 'f4')
        with pytest.raises(ValueError):
            f.create_dataset('z', (2,), 'f4')
    assert os.path.getsize(str(tmp_path / 'bad.h5')) > 96
    with pytest.raises(ValueError):
        hdf5.File(str(tmp_path / 'bad.h5'), 'a')
