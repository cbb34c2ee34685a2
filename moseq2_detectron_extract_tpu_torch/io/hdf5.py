'''A writer and a reader for the subset of HDF5 that the results file uses.

The card's machine has no h5py, so the port writes its ``results_NN.h5``
itself: pure Python and numpy, with deflate from the standard library's
``zlib``. The file is what h5py's default (``libver`` earliest) gives for the
same calls, and h5py and any HDF5 1.8+ reader open it:

- superblock version 0 (no checksums), version 1 object headers;
- groups as symbol tables: a local heap of names, symbol-table nodes of at
  most 8 entries (group leaf K 4) under a version 1 B-tree of at most 32
  children a node (group internal K 16), more levels where needed;
- datasets of signed and unsigned integers, f32 and f64, numpy bool as
  h5py's enum (int8 base, members ``FALSE`` 0 and ``TRUE`` 1), fixed-length
  byte strings (null padded, ASCII), and variable-length UTF-8 strings, whose
  bytes live in global heap collections;
- scalar, simple and null (``Empty``) dataspaces;
- contiguous layout, or chunks along the first axis, each deflated at the
  requested level (h5py's ``compression='gzip'``: level 4) and indexed by a
  version 1 B-tree of at most 64 chunks a node (chunk K 32), more levels
  where needed;
- attributes of str (variable-length UTF-8) or numeric values.

Streaming. A chunked dataset is created at its full shape; rows are written
into in-memory chunk buffers, and a chunk is deflated and appended to the
file as soon as all of its rows have been written (a chunk written to again
later is read back first). Rows are never all held in memory. The metadata
(object headers, heaps, B-trees) is written by ``close()``: the file is
readable once it is closed, not after each ``flush()`` as h5py's is.

The reader (``File(path, 'r')``) reads the groups, datasets (whole, by an
index, or by a range of the first axis) and attributes of the files this
writer writes, and of h5py's with the earliest file format (its default, in
which the JAX package and the upstream extractor write their results):
chunks split along any axis (h5py's guess cuts ``(1100, 80, 80)`` uint8 into
``(138, 10, 20)``) and the fill value message of any version; messages it
does not need (NIL, modification times, ...) are skipped, and a layout
(compact) or filter (anything but deflate) it cannot decode raises.

Editing. The writer writes a file once, so ``rewrite(path, changes, added)``
edits one by copying it, changed, into a new file beside it and renaming
that onto it (``os.replace``): a failure leaves the old file whole.
'''
import itertools
import os
import shutil
import struct
import tempfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
SIGNATURE = b'\x89HDF\r\n\x1a\n'
GROUP_LEAF_K = 4          # a symbol-table node holds 2K = 8 entries
GROUP_INTERNAL_K = 16     # a group B-tree node holds 2K = 32 children
CHUNK_K = 32              # a chunk B-tree node holds 2K = 64 children
CHUNK_BYTES = 1 << 18     # target bytes of an uncompressed chunk
MAX_CHUNK_ROWS = 4096
GCOL_MIN = 4096           # the smallest global heap collection HDF5 makes
SUPERBLOCK_SIZE = 96

# object header message types
MSG_DATASPACE, MSG_DATATYPE, MSG_FILL = 0x1, 0x3, 0x5
MSG_LAYOUT, MSG_PIPELINE, MSG_ATTRIBUTE, MSG_CONTINUATION, MSG_STAB = 0x8, 0xB, 0xC, 0x10, 0x11
FILTER_DEFLATE = 1


def string_dtype(encoding: str = 'utf-8') -> np.dtype:
    '''The dtype of variable-length strings, as h5py's ``string_dtype``:
    UTF-8 (values are str) or ASCII (values are bytes).'''
    return np.dtype('O', metadata={'vlen': str if encoding == 'utf-8' else bytes})


def is_vlen_str(dtype) -> bool:
    return dtype.kind == 'O' and (dtype.metadata or {}).get('vlen') in (str, bytes)


def _item_type(data):
    '''The one type of a value's items (str, bytes, ...), None if they are
    of several types: h5py's rule for the dtype of a new dataset, which makes
    variable-length strings of str, of bytes and of lists of either.'''
    if isinstance(data, np.ndarray):
        if data.dtype.kind != 'O' or is_vlen_str(data.dtype) or not len(data):
            return None
        types = {type(e) for e in data.flat}
    elif isinstance(data, (list, tuple)):
        types = {_item_type(e) for e in data}
    else:
        return type(data)
    return types.pop() if len(types) == 1 else None


def _encode_str(value, dtype: np.dtype) -> bytes:
    if (dtype.metadata or {}).get('vlen') is str:
        return str(value).encode('utf-8')
    return value if isinstance(value, bytes) else str(value).encode('ascii')


class Empty:
    '''A dataset with a null dataspace: a dtype and no data (h5py.Empty).'''

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __repr__(self):
        return f'Empty(dtype={self.dtype!r})'


def _pad8(data: bytes) -> bytes:
    return data + b'\0' * (-len(data) % 8)


# -- datatypes -------------------------------------------------------------------

def _encode_dtype(dtype: np.dtype) -> bytes:
    '''The datatype message of a numpy dtype.'''
    if dtype.kind == 'b':
        base = _encode_dtype(np.dtype('i1'))
        names = b''.join(_pad8(name + b'\0') for name in (b'FALSE', b'TRUE'))
        return struct.pack('<B3sI', 0x18, (2).to_bytes(3, 'little'), 1) + base + names + \
            bytes([0, 1])
    if dtype.kind in 'iu':
        bits = 0x08 if dtype.kind == 'i' else 0
        return struct.pack('<B3sIHH', 0x10, bytes([bits, 0, 0]), dtype.itemsize, 0,
                           8 * dtype.itemsize)
    if dtype.kind == 'f':
        exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127), 8: (11, 52, 1023)}[dtype.itemsize]
        bits = bytes([0x20, 8 * dtype.itemsize - 1, 0])
        return struct.pack('<B3sIHHBBBBI', 0x11, bits, dtype.itemsize, 0, 8 * dtype.itemsize,
                           mant, exp, 0, mant, bias)
    if dtype.kind == 'S':
        return struct.pack('<B3sI', 0x13, bytes([0x01, 0, 0]), dtype.itemsize)
    if is_vlen_str(dtype):
        # variable-length string (type 1), null terminated, UTF-8 or ASCII;
        # its base type is one unsigned byte, as HDF5 writes it
        cset = 1 if dtype.metadata['vlen'] is str else 0
        base = struct.pack('<B3sIHH', 0x10, bytes([0, 0, 0]), 1, 0, 8)
        return struct.pack('<B3sI', 0x19, bytes([0x01, cset, 0]), 16) + base
    raise TypeError(f'unsupported dtype {dtype!r}')


def _decode_dtype(buf: bytes, pos: int = 0) -> Tuple[np.dtype, int]:
    '''(numpy dtype, end position) of the datatype message at ``pos``.'''
    cv, bits, size = struct.unpack_from('<B3sI', buf, pos)
    cls, pos = cv & 0x0f, pos + 8
    if cls == 0:
        order = '>' if bits[0] & 1 else '<'
        return np.dtype(f'{order}{"i" if bits[0] & 0x08 else "u"}{size}'), pos + 4
    if cls == 1:
        order = '>' if bits[0] & 1 else '<'
        return np.dtype(f'{order}f{size}'), pos + 12
    if cls == 3:
        return np.dtype(f'S{size}'), pos
    if cls == 8:
        nmembers = int.from_bytes(bits[:2], 'little')
        base, pos = _decode_dtype(buf, pos)
        names = []
        for _ in range(nmembers):
            end = buf.index(b'\0', pos)
            names.append(buf[pos:end])
            pos += len(_pad8(buf[pos:end + 1]))
        values = np.frombuffer(buf, base, nmembers, pos)
        pos += nmembers * base.itemsize
        if names == [b'FALSE', b'TRUE'] and list(values) == [0, 1]:
            return np.dtype('bool'), pos
        raise TypeError(f'unsupported enum {names}')
    if cls == 9:
        if bits[0] & 0x0f != 1:
            raise TypeError('variable-length sequences are not supported')
        _, pos = _decode_dtype(buf, pos)
        return string_dtype('utf-8' if bits[1] & 0x0f else 'ascii'), pos
    raise TypeError(f'unsupported datatype class {cls}')


def _encode_dataspace(shape) -> bytes:
    '''Version 1 for scalar and simple shapes (max dims = dims), version 2
    for the null dataspace (``shape`` None).'''
    if shape is None:
        return bytes([2, 0, 0, 2])
    out = struct.pack('<BBBB4x', 1, len(shape), 1 if shape else 0, 0)
    return out + b''.join(struct.pack('<Q', d) for d in shape) * (2 if shape else 1)


def _decode_dataspace(buf: bytes, pos: int = 0):
    version, rank, flags = buf[pos], buf[pos + 1], buf[pos + 2]
    if version == 1:
        start = pos + 8
    else:
        if buf[pos + 3] == 2:
            return None
        start = pos + 4
    return tuple(struct.unpack_from(f'<{rank}Q', buf, start))


# -- the writer --------------------------------------------------------------------

class _Out:
    '''The output file: data appended at its end, offsets returned.'''

    def __init__(self, path: str):
        self.fh = open(path, 'w+b')
        self.fh.write(b'\0' * SUPERBLOCK_SIZE)
        self.end = SUPERBLOCK_SIZE

    def append(self, data: bytes) -> int:
        addr = self.end
        self.fh.seek(addr)
        self.fh.write(data)
        self.end += len(data)
        return addr

    def reserve(self, size: int) -> int:
        addr = self.end
        self.end += size
        return addr

    def write_at(self, addr: int, data: bytes) -> None:
        self.fh.seek(addr)
        self.fh.write(data)


class _GlobalHeap:
    '''Variable-length strings, packed into global heap collections at close.'''

    def __init__(self):
        self.objects: List[bytes] = []

    def add(self, data: bytes) -> int:
        self.objects.append(data)
        return len(self.objects) - 1

    def write(self, out: _Out) -> List[Tuple[int, int]]:
        '''Write the collections; returns (address, index) per string.'''
        refs: List[Tuple[int, int]] = []
        pos = 0
        while pos < len(self.objects):
            body, count = b'', 0
            while pos + count < len(self.objects) and count < 65534:
                obj = self.objects[pos + count]
                piece = struct.pack('<HH4xQ', count + 1, 1, len(obj)) + _pad8(obj)
                if body and 16 + len(body) + len(piece) + 16 > 1 << 16:
                    break
                body += piece
                count += 1
            size = max(GCOL_MIN, 16 + len(body) + 16)
            size += -size % 8
            free = size - 16 - len(body)
            data = b'GCOL' + bytes([1, 0, 0, 0]) + struct.pack('<Q', size) + body + \
                struct.pack('<HH4xQ', 0, 0, free) + b'\0' * (free - 16)
            addr = out.append(data)
            refs += [(addr, i + 1) for i in range(count)]
            pos += count
        return refs


class _Attrs:
    '''A writer object's attributes: name -> (dtype, shape, value).'''

    def __init__(self):
        self._items: Dict[str, Tuple[np.dtype, object, object]] = {}

    def __setitem__(self, name: str, value) -> None:
        if isinstance(value, str):
            self._items[name] = (string_dtype(), (), value)
        else:
            arr = np.asarray(value)
            if arr.dtype.kind not in 'biufS':
                raise TypeError(f'unsupported attribute value {value!r}')
            self._items[name] = (arr.dtype, arr.shape, arr)

    def messages(self, heap: _GlobalHeap):
        out = []
        for name, (dtype, shape, value) in self._items.items():
            dt = _encode_dtype(dtype)
            ds = _encode_dataspace(shape)
            if is_vlen_str(dtype):
                raw = _encode_str(value, dtype)
                data = ('vlen', len(raw), heap.add(raw))
            else:
                data = np.ascontiguousarray(value, dtype.newbyteorder('<')
                                            if dtype.kind in 'iuf' else dtype).tobytes()
            encoded = name.encode('utf-8') + b'\0'
            out.append((encoded, dt, ds, data))
        return out


class _WNode:
    def __init__(self, file: 'File', name: str):
        self.file = file
        self.name = name
        self.attrs = _Attrs()


class _WGroup(_WNode):
    def __init__(self, file: 'File', name: str):
        super().__init__(file, name)
        self.children: Dict[str, _WNode] = {}

    def _walk(self, path: str, create: bool) -> Tuple['_WGroup', str]:
        parts = [p for p in path.split('/') if p]
        if not parts:
            raise ValueError(f'bad path {path!r}')
        group = self if not path.startswith('/') else self.file
        for part in parts[:-1]:
            child = group.children.get(part)
            if child is None:
                if not create:
                    raise KeyError(path)
                child = group.children[part] = _WGroup(self.file, f'{group.name.rstrip("/")}/{part}')
            if not isinstance(child, _WGroup):
                raise KeyError(f'{path}: {part} is not a group')
            group = child
        return group, parts[-1]

    def create_dataset(self, path: str, shape=None, dtype=None, data=None,
                       compression: Optional[str] = None, compression_opts: Optional[int] = None,
                       chunks=None) -> '_WDataset':
        '''As h5py's: ``data`` (an array, a scalar, a str or ``Empty``) or
        ``shape`` and ``dtype``; ``dtype`` alone makes a null dataspace.
        ``compression='gzip'`` (level ``compression_opts``, default 4)
        chunks the dataset along its first axis (``chunks``: the chunk
        shape, or its rows by default from ``CHUNK_BYTES``).'''
        group, leaf = self._walk(path, create=True)
        if leaf in group.children:
            raise ValueError(f'{path} exists')
        item_type = _item_type(data) if data is not None else None
        if isinstance(data, Empty):
            dtype, shape, data = data.dtype, None, None
        elif item_type in (str, bytes) and dtype is None:
            dtype = string_dtype('utf-8' if item_type is str else 'ascii')
            data = np.array(data, dtype=object) if not isinstance(data, (str, bytes)) else data
            shape = np.shape(data) if shape is None else tuple(shape)
        elif data is not None:
            data = np.asarray(data)
            if data.dtype.kind == 'U':
                raise TypeError('numpy unicode arrays are not supported; encode them')
            dtype = np.dtype(dtype) if dtype is not None else data.dtype
            shape = data.shape if shape is None else tuple(shape)
        elif dtype is None:
            raise TypeError('one of data, shape or dtype must be given')
        dtype = dtype if isinstance(dtype, np.dtype) else np.dtype(dtype)
        if compression not in (None, 'gzip'):
            raise ValueError(f'unsupported compression {compression!r}')
        level = None
        if compression == 'gzip':
            level = 4 if compression_opts is None else int(compression_opts)
        if shape is not None:
            shape = tuple(int(d) for d in shape)
        node = _WDataset(self.file, f'{group.name.rstrip("/")}/{leaf}', shape, dtype, level,
                         chunks)
        group.children[leaf] = node
        if data is not None:
            node[()] = data
        return node

    def require_group(self, path: str) -> '_WGroup':
        '''The group at ``path``, made (with its parents) if it is not there.'''
        if not [p for p in path.split('/') if p]:
            return self if not path.startswith('/') else self.file
        group, leaf = self._walk(path, create=True)
        child = group.children.get(leaf)
        if child is None:
            child = group.children[leaf] = _WGroup(self.file, f'{group.name.rstrip("/")}/{leaf}')
        if not isinstance(child, _WGroup):
            raise ValueError(f'{path} is a dataset')
        return child

    def __getitem__(self, path: str) -> _WNode:
        group, leaf = self._walk(path, create=False)
        if leaf not in group.children:
            raise KeyError(path)
        return group.children[leaf]

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True


class _WDataset(_WNode):
    def __init__(self, file, name, shape, dtype, level, chunks):
        super().__init__(file, name)
        self.shape, self.dtype, self.level = shape, dtype, level
        self.chunks = None
        if shape is None:
            if level is not None:
                raise ValueError('an empty dataset cannot be compressed')
            self._data = None
            return
        if level is not None and shape and min(shape) > 0:
            row = max(1, int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize)
            rows = int(chunks[0]) if chunks is not None else \
                max(1, min(shape[0], MAX_CHUNK_ROWS, CHUNK_BYTES // row))
            self.chunks = (rows,) + tuple(shape[1:])
            self._open: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
            self._stored: Dict[int, Tuple[int, int]] = {}    # chunk -> (address, bytes)
            self._data = None
        else:
            self.level = None
            self._data = np.zeros(shape, dtype) if not is_vlen_str(dtype) else \
                np.full(shape, dtype.metadata['vlen'](), dtype=object)

    @property
    def compression(self):
        return 'gzip' if self.level is not None else None

    @property
    def compression_opts(self):
        return self.level

    def _rows(self, key) -> np.ndarray:
        n = self.shape[0]
        if isinstance(key, slice):
            return np.arange(n)[key]
        idx = np.asarray(key)
        if idx.dtype.kind not in 'iu' or idx.ndim > 1:
            raise TypeError(f'unsupported selection {key!r}')
        idx = np.where(idx < 0, idx + n, idx).reshape(-1)
        if len(idx) and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f'{key!r} out of range for {self.shape}')
        return idx

    def __setitem__(self, key, value) -> None:
        if self.shape is None:
            raise TypeError('an empty dataset holds no data')
        whole = _is_whole(key) or (isinstance(key, slice) and key == slice(None))
        if self.chunks is None:
            if is_vlen_str(self.dtype):
                self._data[key if not whole else ()] = value if isinstance(value, (str, bytes)) \
                    else np.asarray(value, object)
            elif whole:
                self._data[...] = value
            else:
                self._data[key] = value
            return
        rows = np.arange(self.shape[0]) if whole else self._rows(key)
        scalar_row = not whole and np.ndim(key) == 0 and not isinstance(key, slice)
        values = np.asarray(value, self.dtype)
        values = np.broadcast_to(values, (len(rows),) + self.shape[1:]) if not scalar_row else \
            np.broadcast_to(values, self.shape[1:])[None]
        size = self.chunks[0]
        order = np.argsort(rows, kind='stable')
        rows, values = rows[order], values[order]
        bounds = np.flatnonzero(np.diff(rows // size)) + 1
        for part_rows, part_values in zip(np.split(rows, bounds), np.split(values, bounds)):
            if not len(part_rows):
                continue
            chunk = int(part_rows[0] // size)
            buf, written = self._chunk_buffer(chunk)
            local = part_rows - chunk * size
            buf[local] = part_values
            written[local] = True
            if written[:min(size, self.shape[0] - chunk * size)].all():
                self._store(chunk)

    def _chunk_buffer(self, chunk: int):
        if chunk not in self._open:
            buf = np.zeros(self.chunks, self.dtype)
            written = np.zeros(self.chunks[0], bool)
            if chunk in self._stored:
                addr, nbytes = self._stored.pop(chunk)
                self.file._out.fh.seek(addr)
                raw = zlib.decompress(self.file._out.fh.read(nbytes))
                buf[...] = np.frombuffer(raw, _disk_dtype(self.dtype)).reshape(self.chunks)
                written[:] = True
            self._open[chunk] = (buf, written)
        return self._open[chunk]

    def _store(self, chunk: int) -> None:
        buf, _ = self._open.pop(chunk)
        raw = zlib.compress(np.ascontiguousarray(buf, _disk_dtype(self.dtype)).tobytes(),
                            self.level)
        self._stored[chunk] = (self.file._out.append(raw), len(raw))

    def __getitem__(self, key):
        if self.shape is None:
            return Empty(self.dtype)
        if self.chunks is None:
            return self._data[key]
        raise TypeError('read a written file back with File(path, "r")')


def _is_whole(key) -> bool:
    return key is Ellipsis or (isinstance(key, tuple) and key == ())


def _disk_dtype(dtype: np.dtype) -> np.dtype:
    '''The bytes a dtype has on disk: little endian; bool as its int8 enum.'''
    if dtype.kind == 'b':
        return np.dtype('i1')
    return dtype.newbyteorder('<') if dtype.kind in 'iuf' else dtype


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack('<HHB3x', mtype, len(body), flags) + body


def _object_header(messages: List[bytes]) -> bytes:
    body = b''.join(messages)
    return struct.pack('<BBHII4x', 1, 0, len(messages), 1, len(body)) + body


def _btree_node(node_type: int, level: int, keys: List[bytes], children: List[int],
                key_size: int, k: int, left: int = UNDEF, right: int = UNDEF) -> bytes:
    '''A version 1 B-tree node, allocated at its full size (2K children).'''
    out = b'TREE' + struct.pack('<BBHQQ', node_type, level, len(children), left, right)
    for key, child in zip(keys, children):
        out += key + struct.pack('<Q', child)
    out += keys[len(children)]
    size = 24 + (2 * k + 1) * key_size + 2 * k * 8
    return out + b'\0' * (size - len(out))


def _write_btree(out: _Out, node_type: int, entries: List[Tuple[bytes, int]], last_key: bytes,
                 key_size: int, k: int) -> int:
    '''A B-tree over ``entries`` (left key, child address), in order, whose
    right-most key is ``last_key``; returns the root's address. Each level
    packs up to 2K children a node, siblings linked.'''
    level = 0
    while True:
        groups = [entries[i:i + 2 * k] for i in range(0, len(entries), 2 * k)] or [[]]
        size = 24 + (2 * k + 1) * key_size + 2 * k * 8
        addrs = [out.reserve(size) for _ in groups]
        upper = []
        for g, group in enumerate(groups):
            right_key = groups[g + 1][0][0] if g + 1 < len(groups) else last_key
            keys = [e[0] for e in group] + [right_key]
            node = _btree_node(node_type, level, keys, [e[1] for e in group], key_size, k,
                               addrs[g - 1] if g else UNDEF,
                               addrs[g + 1] if g + 1 < len(groups) else UNDEF)
            out.write_at(addrs[g], node)
            upper.append((keys[0], addrs[g]))
        if len(groups) == 1:
            return addrs[0]
        entries, level = upper, level + 1


class File(_WGroup):
    '''An HDF5 file: ``File(path, 'w')`` writes one (closed by ``close()`` or
    a ``with`` block), ``File(path, 'r')`` returns a reader
    (``HDF5Reader``).'''

    def __new__(cls, path: str, mode: str = 'r'):
        if mode == 'r':
            return HDF5Reader(path)
        if mode != 'w':
            raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")
        return super().__new__(cls)

    def __init__(self, path: str, mode: str = 'r'):
        super().__init__(self, '/')
        self.filename = path
        self._out = _Out(path)
        self._closed = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def flush(self) -> None:
        '''Push the chunks written so far to the OS (the metadata waits for
        ``close``).'''
        self._out.fh.flush()

    def close(self) -> None:
        if self._closed:
            return
        heap = _GlobalHeap()
        # every variable-length string goes to the global heap first
        attr_msgs = {}
        vlen_data = {}

        def gather(node):
            attr_msgs[id(node)] = node.attrs.messages(heap)
            if isinstance(node, _WGroup):
                for child in node.children.values():
                    gather(child)
            elif node.shape is not None and node.chunks is None and is_vlen_str(node.dtype):
                items = [_encode_str(v, node.dtype)
                         for v in np.asarray(node._data, object).reshape(-1)]
                vlen_data[id(node)] = [(len(raw), heap.add(raw)) for raw in items]
        gather(self)
        refs = heap.write(self._out)
        addrs = {}
        root_addr = self._write_node(self, refs, attr_msgs, vlen_data, addrs)
        btree, lheap = addrs['stab', id(self)]
        eof = self._out.end
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + \
            struct.pack('<HHI', GROUP_LEAF_K, GROUP_INTERNAL_K, 0) + \
            struct.pack('<QQQQ', 0, UNDEF, eof, UNDEF) + \
            struct.pack('<QQII', 0, root_addr, 1, 0) + struct.pack('<QQ', btree, lheap)
        self._out.write_at(0, sb)
        self._out.fh.truncate(eof)
        self._out.fh.close()
        self._closed = True

    # -- metadata ----------------------------------------------------------------
    def _attribute_messages(self, node, refs, attr_msgs) -> List[bytes]:
        out = []
        for name, dt, ds, data in attr_msgs[id(node)]:
            if isinstance(data, tuple):
                _, length, index = data
                addr, obj = refs[index]
                data = struct.pack('<IQI', length, addr, obj)
            body = struct.pack('<BBHHH', 1, 0, len(name), len(dt), len(ds)) + \
                _pad8(name) + _pad8(dt) + _pad8(ds) + data
            out.append(_message(MSG_ATTRIBUTE, body))
        return out

    def _write_node(self, node, refs, attr_msgs, vlen_data, addrs) -> int:
        if isinstance(node, _WGroup):
            return self._write_group(node, refs, attr_msgs, vlen_data, addrs)
        return self._write_dataset(node, refs, attr_msgs, vlen_data)

    def _write_group(self, group: _WGroup, refs, attr_msgs, vlen_data, addrs) -> int:
        names = sorted(group.children, key=lambda s: s.encode('utf-8'))
        entries = []                       # (name, header address, cache type, scratch)
        for name in names:
            child = group.children[name]
            addr = self._write_node(child, refs, attr_msgs, vlen_data, addrs)
            if isinstance(child, _WGroup):
                entries.append((name, addr, 1, struct.pack('<QQ', *addrs['stab', id(child)])))
            else:
                entries.append((name, addr, 0, b'\0' * 16))
        # the local heap: the empty name at offset 0, then each name, 8-byte
        # aligned, then one free block
        data, offsets = b'\0' * 8, {}
        for name in names:
            offsets[name] = len(data)
            data += _pad8(name.encode('utf-8') + b'\0')
        free_at = len(data)
        data += struct.pack('<QQ', 1, 16)   # free block: no next (1), 16 bytes
        heap_addr = self._out.reserve(32)
        data_addr = self._out.append(data)
        self._out.write_at(heap_addr, b'HEAP' + bytes([0, 0, 0, 0]) +
                           struct.pack('<QQQ', len(data), free_at, data_addr))
        # symbol-table nodes of 2K entries each, sorted by name
        per_node = 2 * GROUP_LEAF_K
        snods = []
        for i in range(0, len(entries), per_node):
            part = entries[i:i + per_node]
            body = b'SNOD' + struct.pack('<BBH', 1, 0, len(part))
            for name, addr, cache, scratch in part:
                body += struct.pack('<QQII', offsets[name], addr, cache, 0) + scratch
            body += b'\0' * (8 + per_node * 40 - len(body))
            snods.append((offsets[part[-1][0]], self._out.append(body)))
        # the B-tree: child i holds names in (key i, key i+1]; key 0 is ""
        btree = self._write_group_btree(snods)
        addrs['stab', id(group)] = (btree, heap_addr)
        msgs = [_message(MSG_STAB, struct.pack('<QQ', btree, heap_addr))]
        msgs += self._attribute_messages(group, refs, attr_msgs)
        return self._out.append(_object_header(msgs))

    def _write_group_btree(self, children: List[Tuple[int, int]]) -> int:
        '''``children``: (heap offset of the largest name below, address).'''
        level, k = 0, GROUP_INTERNAL_K
        size = 24 + (2 * k + 1) * 8 + 2 * k * 8
        while True:
            groups = [children[i:i + 2 * k] for i in range(0, len(children), 2 * k)] or [[]]
            addrs = [self._out.reserve(size) for _ in groups]
            upper = []
            for g, group in enumerate(groups):
                left_key = 0 if g == 0 else groups[g - 1][-1][0]
                keys = [struct.pack('<Q', left_key)] + [struct.pack('<Q', c[0]) for c in group]
                node = _btree_node(0, level, keys, [c[1] for c in group], 8, k,
                                   addrs[g - 1] if g else UNDEF,
                                   addrs[g + 1] if g + 1 < len(groups) else UNDEF)
                self._out.write_at(addrs[g], node)
                upper.append((group[-1][0] if group else 0, addrs[g]))
            if len(groups) == 1:
                return addrs[0]
            children, level = upper, level + 1

    def _write_dataset(self, ds: _WDataset, refs, attr_msgs, vlen_data) -> int:
        msgs = [_message(MSG_DATASPACE, _encode_dataspace(ds.shape)),
                _message(MSG_DATATYPE, _encode_dtype(ds.dtype), flags=1)]
        chunked = ds.chunks is not None
        # fill value message v2, as HDF5 writes it: allocation late
        # (contiguous) or incremental (chunked), written if set (at
        # allocation for strings), the default value (size 0)
        fill_time = 0 if is_vlen_str(ds.dtype) else 2
        msgs.append(_message(MSG_FILL, bytes([2, 3 if chunked else 2, fill_time, 1, 0, 0, 0, 0]),
                             flags=1))
        if chunked:
            for chunk in sorted(ds._open):
                ds._store(chunk)
            rank = len(ds.shape)
            key_size = 8 + 8 * (rank + 1)

            def key(chunk, nbytes):
                return struct.pack('<II', nbytes, 0) + struct.pack(
                    f'<{rank + 1}Q', chunk * ds.chunks[0], *([0] * rank))
            stored = sorted(ds._stored.items())
            if stored:
                entries = [(key(c, nbytes), addr) for c, (addr, nbytes) in stored]
                last = stored[-1][0]
                right = struct.pack('<II', 0, 0) + struct.pack(
                    f'<{rank + 1}Q', (last + 1) * ds.chunks[0], *ds.chunks[1:],
                    _disk_dtype(ds.dtype).itemsize)
                index = _write_btree(self._out, 1, entries, right, key_size, CHUNK_K)
            else:
                index = UNDEF
            dims = list(ds.chunks) + [_disk_dtype(ds.dtype).itemsize]
            msgs.append(_message(MSG_LAYOUT, struct.pack('<BBBQ', 3, 2, rank + 1, index) +
                                 struct.pack(f'<{rank + 1}I', *dims)))
            msgs.append(_message(MSG_PIPELINE, struct.pack('<BB6x', 1, 1) + struct.pack(
                '<HHHH', FILTER_DEFLATE, 8, 1, 1) + b'deflate\0' +
                struct.pack('<II', ds.level, 0), flags=1))
        elif ds.shape is None:
            msgs.append(_message(MSG_LAYOUT, struct.pack('<BBQQ', 3, 1, UNDEF, 0)))
        else:
            if is_vlen_str(ds.dtype):
                raw = b''.join(struct.pack('<IQI', length, *refs[index])
                               for length, index in vlen_data[id(ds)])
            else:
                raw = np.ascontiguousarray(ds._data, _disk_dtype(ds.dtype)).tobytes()
            addr = self._out.append(raw) if raw else UNDEF
            msgs.append(_message(MSG_LAYOUT, struct.pack('<BBQQ', 3, 1, addr, len(raw))))
        msgs += self._attribute_messages(ds, refs, attr_msgs)
        return self._out.append(_object_header(msgs))


# -- the reader --------------------------------------------------------------------

class HDF5Reader:
    '''Reads the files ``File(path, 'w')`` writes: ``reader['a/b']`` is a
    ``ReadGroup`` or a ``ReadDataset``.'''

    def __init__(self, path: str):
        self.filename = path
        self.fh = open(path, 'rb')
        self._gheaps: Dict[int, Dict[int, bytes]] = {}
        try:
            sb = self._read(0, SUPERBLOCK_SIZE)
            if sb[:8] != SIGNATURE or sb[8] != 0:
                raise ValueError(f'{path}: not an HDF5 file with a version 0 superblock')
            self.root = ReadGroup(self, '/', struct.unpack_from('<Q', sb, 64)[0])
        except Exception:
            self.fh.close()
            raise

    def _read(self, addr: int, size: int) -> bytes:
        self.fh.seek(addr)
        data = self.fh.read(size)
        if len(data) != size:
            raise ValueError(f'{self.filename}: truncated at {addr}')
        return data

    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        '''(type, flags, body) of each message of the object header at ``addr``.'''
        version, _, count, _, size = struct.unpack('<BBHII', self._read(addr, 12))
        if version != 1:
            raise ValueError(f'object header version {version} at {addr}')
        out, blocks = [], [(addr + 16, size)]
        while blocks and len(out) < count:
            start, length = blocks.pop(0)
            data = self._read(start, length)
            pos = 0
            while pos + 8 <= length and len(out) < count:
                mtype, msize, flags = struct.unpack_from('<HHB', data, pos)
                body = data[pos + 8:pos + 8 + msize]
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack('<QQ', body[:16]))
                out.append((mtype, flags, body))
                pos += 8 + msize
        return out

    def global_object(self, addr: int, index: int) -> bytes:
        if addr not in self._gheaps:
            size = struct.unpack('<Q', self._read(addr + 8, 8))[0]
            data = self._read(addr, size)
            objects, pos = {}, 16
            while pos + 16 <= size:
                idx, _, length = struct.unpack_from('<HH4xQ', data, pos)
                if idx == 0:
                    break
                objects[idx] = data[pos + 16:pos + 16 + length]
                pos += 16 + length + (-length % 8)
            self._gheaps[addr] = objects
        return self._gheaps[addr][index]

    def __getitem__(self, path: str):
        return self.root[path]

    def __contains__(self, path: str) -> bool:
        return path in self.root

    def visit_datasets(self):
        '''(path, ReadDataset) of every dataset, depth first in name order.'''
        return self.root.visit_datasets()

    def close(self) -> None:
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fill_value(body: bytes) -> Optional[bytes]:
    '''The fill value's bytes from a fill value message (versions 1-3), or
    None where it is undefined or the library's default.'''
    version = body[0]
    if version in (1, 2):
        if version == 2 and not body[3]:
            return None
        size = struct.unpack_from('<I', body, 4)[0]
        return body[8:8 + size] or None
    if version == 3:
        if not body[1] & 0x20:
            return None
        size = struct.unpack_from('<I', body, 2)[0]
        return body[6:6 + size] or None
    raise ValueError(f'fill value message version {version}')


def _read_attrs(reader: HDF5Reader, msgs) -> Dict[str, object]:
    attrs = {}
    for mtype, _, body in msgs:
        if mtype != MSG_ATTRIBUTE:
            continue
        version, _, nlen, dtlen, dslen = struct.unpack_from('<BBHHH', body)
        if version != 1:
            raise ValueError(f'attribute message version {version}')
        pos = 8
        name = body[pos:pos + nlen - 1].decode('utf-8')
        pos += nlen + (-nlen % 8)
        dtype, _ = _decode_dtype(body, pos)
        pos += dtlen + (-dtlen % 8)
        shape = _decode_dataspace(body, pos)
        pos += dslen + (-dslen % 8)
        attrs[name] = _decode_values(reader, body[pos:], dtype, shape)
    return attrs


def _decode_values(reader: HDF5Reader, raw: bytes, dtype: np.dtype, shape):
    if shape is None:
        return Empty(dtype)
    count = int(np.prod(shape, dtype=np.int64))
    if is_vlen_str(dtype):
        items = []
        for i in range(count):
            length, addr, index = struct.unpack_from('<IQI', raw, 16 * i)
            value = reader.global_object(addr, index)[:length] if length else b''
            items.append(value.decode('utf-8') if dtype.metadata['vlen'] is str else value)
        if shape == ():
            return items[0]
        return np.array(items, dtype=object).reshape(shape)
    disk = _disk_dtype(dtype)
    arr = np.frombuffer(raw, disk, count).reshape(shape)
    arr = arr.astype(dtype) if dtype.kind == 'b' else arr.copy()
    return arr[()] if shape == () else arr


class ReadGroup:
    def __init__(self, reader: HDF5Reader, name: str, addr: int):
        self.reader, self.name, self.addr = reader, name, addr
        msgs = reader.messages(addr)
        stab = [body for mtype, _, body in msgs if mtype == MSG_STAB]
        if not stab:
            raise ValueError(f'{name}: not a symbol-table group')
        btree, heap = struct.unpack('<QQ', stab[0][:16])
        hdr = reader._read(heap, 32)
        if hdr[:4] != b'HEAP':
            raise ValueError(f'{name}: bad local heap')
        size, _, data_addr = struct.unpack_from('<QQQ', hdr, 8)
        names = reader._read(data_addr, size)
        self._entries: Dict[str, int] = {}
        for snod in self._snods(btree):
            node = reader._read(snod, 8 + 2 * GROUP_LEAF_K * 40)
            if node[:4] != b'SNOD':
                raise ValueError(f'{name}: bad symbol-table node')
            for i in range(struct.unpack_from('<H', node, 6)[0]):
                offset, obj = struct.unpack_from('<QQ', node, 8 + 40 * i)
                child = names[offset:names.index(b'\0', offset)].decode('utf-8')
                self._entries[child] = obj
        self.attrs = _read_attrs(reader, msgs)

    def _snods(self, addr: int) -> List[int]:
        hdr = self.reader._read(addr, 24)
        if hdr[:4] != b'TREE' or hdr[4] != 0:
            raise ValueError(f'{self.name}: bad group B-tree node')
        level, used = hdr[5], struct.unpack_from('<H', hdr, 6)[0]
        body = self.reader._read(addr + 24, used * 16 + 8)
        children = [struct.unpack_from('<Q', body, 8 + 16 * i)[0] for i in range(used)]
        if level == 0:
            return children
        return [s for child in children for s in self._snods(child)]

    def keys(self):
        return sorted(self._entries, key=lambda s: s.encode('utf-8'))

    def _child(self, name: str):
        addr = self._entries[name]
        path = f'{self.name.rstrip("/")}/{name}'
        if any(mtype == MSG_STAB for mtype, _, _ in self.reader.messages(addr)):
            return ReadGroup(self.reader, path, addr)
        return ReadDataset(self.reader, path, addr)

    def __getitem__(self, path: str):
        node = self if not path.startswith('/') else self.reader.root
        for part in [p for p in path.split('/') if p]:
            if not isinstance(node, ReadGroup) or part not in node._entries:
                raise KeyError(path)
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def visit_datasets(self):
        for name in self.keys():
            child = self._child(name)
            if isinstance(child, ReadGroup):
                yield from child.visit_datasets()
            else:
                yield child.name, child


class ReadDataset:
    def __init__(self, reader: HDF5Reader, name: str, addr: int):
        self.reader, self.name = reader, name
        msgs = reader.messages(addr)
        self.compression, self.compression_opts, self.chunks = None, None, None
        self._layout, fill = None, None
        for mtype, _, body in msgs:
            if mtype == MSG_DATASPACE:
                self.shape = _decode_dataspace(body)
            elif mtype == MSG_DATATYPE:
                self.dtype, _ = _decode_dtype(body)
            elif mtype == MSG_LAYOUT:
                self._layout = body
            elif mtype == MSG_FILL:
                fill = _fill_value(body)
            elif mtype == MSG_PIPELINE:
                nfilters, pos = body[1], 8
                for _ in range(nfilters):
                    fid, nlen, _, nvals = struct.unpack_from('<HHHH', body, pos)
                    pos += 8 + nlen + (-nlen % 8)
                    vals = struct.unpack_from(f'<{nvals}I', body, pos)
                    pos += 4 * nvals + (4 if nvals % 2 else 0)
                    if fid != FILTER_DEFLATE:
                        raise ValueError(f'{name}: filter {fid} is not supported')
                    self.compression, self.compression_opts = 'gzip', vals[0]
        self.attrs = _read_attrs(reader, msgs)
        self._fill = 0
        if fill and self.shape is not None and self.dtype.kind in 'biuf' and \
                len(fill) == self.dtype.itemsize:
            self._fill = np.frombuffer(fill, _disk_dtype(self.dtype))[0]
        if self._layout[0] != 3:
            raise ValueError(f'{name}: layout message version {self._layout[0]}')
        if self._layout[1] == 2:
            rank = self._layout[2]
            self._index = struct.unpack_from('<Q', self._layout, 3)[0]
            self.chunks = tuple(struct.unpack_from(f'<{rank}I', self._layout, 11))[:-1]
            self._chunk_map = None
        elif self._layout[1] != 1:
            raise ValueError(f'{name}: layout class {self._layout[1]} is not supported')

    def _chunk_records(self, addr: int, rank: int,
                       out: Dict[Tuple[int, ...], Tuple[int, int, int]]):
        '''Each chunk's (address, bytes, filter mask), keyed by its index
        along every axis: the B-tree key holds the chunk's offset in each
        dimension (and a trailing 0 for the element).'''
        key_size = 8 + 8 * (rank + 1)
        hdr = self.reader._read(addr, 24)
        if hdr[:4] != b'TREE' or hdr[4] != 1:
            raise ValueError(f'{self.name}: bad chunk B-tree node')
        level, used = hdr[5], struct.unpack_from('<H', hdr, 6)[0]
        body = self.reader._read(addr + 24, used * (key_size + 8) + key_size)
        for i in range(used):
            pos = i * (key_size + 8)
            nbytes, mask = struct.unpack_from('<II', body, pos)
            offsets = struct.unpack_from(f'<{rank}Q', body, pos + 8)
            child = struct.unpack_from('<Q', body, pos + key_size)[0]
            if level:
                self._chunk_records(child, rank, out)
            else:
                out[tuple(o // c for o, c in zip(offsets, self.chunks))] = (child, nbytes, mask)

    def _read_rows(self, start: int, stop: int) -> np.ndarray:
        '''Rows ``start:stop``, assembled from every chunk that overlaps
        them (chunks may split the other axes too, as h5py's do); a chunk
        never written holds the fill value.'''
        out = np.full((max(0, stop - start),) + self.shape[1:], self._fill, self.dtype)
        if stop <= start:
            return out
        if self._chunk_map is None:
            self._chunk_map = {}
            if self._index != UNDEF:
                self._chunk_records(self._index, len(self.shape), self._chunk_map)
        disk = _disk_dtype(self.dtype)
        grid = [range(start // self.chunks[0], (stop - 1) // self.chunks[0] + 1)]
        grid += [range(-(-n // c)) for n, c in zip(self.shape[1:], self.chunks[1:])]
        for index in itertools.product(*grid):
            rec = self._chunk_map.get(index)
            if rec is None:
                continue
            addr, nbytes, mask = rec
            raw = self.reader._read(addr, nbytes)
            if not mask & 1 and self.compression:
                raw = zlib.decompress(raw)
            data = np.frombuffer(raw, disk).reshape(self.chunks)
            src, dst = [], []
            for axis, (i, size, n) in enumerate(zip(index, self.chunks, self.shape)):
                lo = i * size
                a, b = (max(start, lo), min(stop, lo + size)) if axis == 0 else \
                    (lo, min(n, lo + size))
                src.append(slice(a - lo, b - lo))
                dst.append(slice(a - start, b - start) if axis == 0 else slice(a, b))
            out[tuple(dst)] = data[tuple(src)]
        return out

    def __getitem__(self, key=()):
        if self.shape is None:
            return Empty(self.dtype)
        if self.chunks is None:
            addr, size = struct.unpack_from('<QQ', self._layout, 2)
            if addr != UNDEF and size:
                raw = self.reader._read(addr, size)
            else:                              # never written: the fill value
                count = int(np.prod(self.shape, dtype=np.int64))
                raw = b'\0' * (16 * count) if is_vlen_str(self.dtype) else \
                    np.full(count, self._fill, _disk_dtype(self.dtype)).tobytes()
            values = _decode_values(self.reader, raw, self.dtype, self.shape)
            return values if _is_whole(key) else values[key]
        n = self.shape[0]
        if _is_whole(key):
            return self._read_rows(0, n)
        if isinstance(key, slice):
            start, stop, step = key.indices(n)
            if step == 1:
                return self._read_rows(start, stop)
        if isinstance(key, (int, np.integer)):
            row = int(key) + (n if key < 0 else 0)
            if not 0 <= row < n:
                raise IndexError(key)
            return self._read_rows(row, row + 1)[0]
        return self._read_rows(0, n)[key]


# -- editing a file: read it, write it anew beside it, rename -------------------------

ROWS_PER_COPY = 1024        # rows that rewrite() moves at a time
KEEP = 'keep'               # Rows(level=KEEP): the source's gzip level


class Rows:
    '''What ``rewrite`` writes in place of a dataset: its rows
    ``start:stop`` of the source (all by default), each block of rows passed
    through ``fn(first_row, block)`` (``first_row`` the block's first row in
    the source) where ``fn`` is given, at gzip ``level`` (the source's by
    default; None writes it uncompressed).'''

    def __init__(self, start: int = 0, stop: Optional[int] = None, fn=None, level=KEEP):
        self.start, self.stop, self.fn, self.level = start, stop, fn, level


def replaced(values) -> Rows:
    '''A ``Rows`` that writes ``values`` (the dataset's whole length) in
    place of the source's rows.'''
    values = np.asarray(values)
    return Rows(fn=lambda first, block: values[first:first + len(block)])


def _gzip(level: Optional[int]) -> Dict[str, object]:
    return {'compression': None if level is None else 'gzip', 'compression_opts': level}


def _copy_dataset(ds: ReadDataset, dst: File, rows: Rows) -> None:
    name = ds.name
    level = ds.compression_opts if rows.level == KEEP else rows.level
    if ds.shape is None:
        out = dst.create_dataset(name, data=Empty(ds.dtype))
    elif not ds.shape or is_vlen_str(ds.dtype):
        values = ds[()]
        if rows.fn is not None:
            values = rows.fn(0, values)
        out = dst.create_dataset(name, data=values, **_gzip(level))
    else:
        n = ds.shape[0]
        start, stop = rows.start, n if rows.stop is None else rows.stop
        if not 0 <= start <= stop <= n:
            raise IndexError(f'{name}: rows {start}:{stop} of {n}')
        out = dst.create_dataset(name, (stop - start,) + tuple(ds.shape[1:]), ds.dtype,
                                 **_gzip(level))
        whole = ds[()] if ds.chunks is None else None     # a contiguous source is read once
        for first in range(start, stop, ROWS_PER_COPY):
            last = min(stop, first + ROWS_PER_COPY)
            block = ds[first:last] if whole is None else whole[first:last]
            if rows.fn is not None:
                block = rows.fn(first, block)
            out[first - start:last - start] = block
    for key, value in ds.attrs.items():
        out.attrs[key] = value


def rewrite(path: str, changes: Optional[Dict[str, Rows]] = None,
            added: Optional[Dict[str, Tuple[object, Optional[int], Dict[str, object]]]] = None
            ) -> None:
    '''Edit the HDF5 file at ``path`` by writing it anew: every group and
    dataset, with its attributes, dtype and gzip level, is copied by the
    port's writer into a new file beside it, which then replaces it
    (``os.replace``). Until that rename the file stays as it was: a failure
    on the way removes the new file and leaves the old one whole.

    ``changes`` maps a dataset's path (``/a/b``) to a ``Rows``: what to
    write in its place. ``added`` maps new datasets' paths to (data, gzip
    level or None, attributes). A dataset is copied ``ROWS_PER_COPY`` rows
    at a time, never whole (a 54,000-frame result holds about 1.4 GB of f32
    masks); the new file's chunks are the writer's own (along the first
    axis), not the source's.'''
    changes = {'/' + k.lstrip('/'): v for k, v in (changes or {}).items()}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               prefix=os.path.basename(path) + '.', suffix='.tmp')
    os.close(fd)
    try:
        with HDF5Reader(path) as src:
            dst = File(tmp, 'w')
            try:
                def copy(group: ReadGroup):
                    for key, value in group.attrs.items():
                        dst.require_group(group.name).attrs[key] = value
                    for key in group.keys():
                        child = group._child(key)
                        if isinstance(child, ReadGroup):
                            dst.require_group(child.name)
                            copy(child)
                        else:
                            _copy_dataset(child, dst, changes.pop(child.name, Rows()))
                copy(src.root)
                if changes:
                    raise KeyError(f'no such datasets: {sorted(changes)}')
                for name, (data, level, attrs) in (added or {}).items():
                    out = dst.create_dataset(name, data=data, **_gzip(level))
                    for key, value in attrs.items():
                        out.attrs[key] = value
            finally:
                dst.close()
        shutil.copymode(path, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
