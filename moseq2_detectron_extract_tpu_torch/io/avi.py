'''RIFF AVI files: one walker for the AVIs that libavformat and the port
write, and the port's OpenDML writer.

``read_avi`` reads the headers (``avih``; ``strh``; ``strf``, a
``BITMAPINFOHEADER`` and the codec's extradata after it; ``dmlh``) and the
index of the first video stream's frames (``00dc``/``00db`` chunks): the
OpenDML ``indx`` super index and its ``ix00`` standard indexes when the file
has them (a set bit 31 in a size marks a frame that is *not* a keyframe),
else the AVI 1.0 ``idx1`` (``AVIIF_KEYFRAME`` marks a keyframe), else a walk
of the ``movi`` lists. An AVI 1.0 RIFF stops at 1 GiB, and a compressed
session passes that, so only the OpenDML index reaches every frame. Only
the headers and the indexes are read; ``walk=True`` also walks every chunk
of every ``movi`` list (the frames then come from the walk, in file order).

``AviWriter`` writes one video stream of encoded frames as OpenDML (AVI
2.0): the first ``RIFF AVI `` holds the headers, a ``movi`` list, its
``ix00`` standard index and the legacy ``idx1``; past ``riff_limit`` bytes
each further ``RIFF AVIX`` holds a ``movi`` list with its own ``ix00``; the
``indx`` super index in the stream header points at every ``ix00``, and
``dmlh`` holds the total frame count.
'''
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional, Sequence

import numpy as np

RIFF_LIMIT = 1 << 30             # an AVI 1.0 RIFF's size, then OpenDML's AVIX
SUPER_INDEX_ENTRIES = 256        # room for 256 RIFFs in the indx super index
AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10
_NOT_KEYFRAME = 0x80000000       # in an ix00 entry's size
_FRAME_IDS = (b'00dc', b'00db')


class AviError(ValueError):
    '''Not an AVI this module can read.'''


@dataclass
class AviIndex:
    '''What ``read_avi`` found: headers, frames and how they were indexed.'''
    fourcc: str = ''                  # strf's biCompression (strh's handler if empty)
    width: int = 0
    height: int = 0
    fps: float = 0.0                  # strh's rate / scale
    rate: int = 0
    extradata: bytes = b''
    offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    sizes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    keyframes: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    source: str = ''                  # 'indx', 'idx1' or 'walk'
    riffs: List[str] = field(default_factory=list)
    idx1: Optional[int] = None        # idx1's entry count
    super: List[int] = field(default_factory=list)   # frames per ix00 in indx
    avih_frames: int = 0
    strh_length: int = 0
    dmlh_frames: Optional[int] = None

    @property
    def nframes(self) -> int:
        '''Frames in the index.'''
        return len(self.offsets)


def _read(fh: BinaryIO, pos: int, size: int) -> bytes:
    fh.seek(pos)
    data = fh.read(size)
    if len(data) != size:
        raise AviError(f'short read at {pos}: wanted {size} bytes, got {len(data)}')
    return data


def _parse_header_list(data: bytes, index: AviIndex, supers: List[tuple]) -> None:
    '''The chunks of a ``hdrl`` list (and the lists inside it).'''
    pos = 0
    stream = -1
    while pos + 8 <= len(data):
        fourcc = data[pos:pos + 4]
        size = struct.unpack_from('<I', data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if fourcc == b'LIST':
            if body[:4] == b'strl':
                stream += 1
            if body[:4] != b'strl' or stream == 0:
                _parse_header_list(body[4:], index, supers)
        elif fourcc == b'avih' and len(body) >= 40:
            index.avih_frames = struct.unpack_from('<I', body, 16)[0]
        elif fourcc == b'strh' and len(body) >= 36:
            kind, handler = body[:4], body[4:8]
            if kind != b'vids':
                raise AviError(f'the first stream is {kind!r}, not video')
            scale, rate = struct.unpack_from('<II', body, 20)
            index.rate = rate
            index.fps = rate / scale if scale else 0.0
            index.strh_length = struct.unpack_from('<I', body, 32)[0]
            index.fourcc = handler.decode('latin-1').strip('\0 ')
        elif fourcc == b'strf' and len(body) >= 40:
            width, height, _planes, _bits, compression = struct.unpack_from('<iiHH4s', body, 4)
            index.width, index.height = width, abs(height)
            if compression.strip(b'\0'):
                index.fourcc = compression.decode('latin-1').strip('\0 ')
            index.extradata = bytes(body[40:])
        elif fourcc == b'indx' and len(body) >= 24:
            per_entry, _sub, kind, n = struct.unpack_from('<HBBI', body, 0)
            if kind == 0 and per_entry == 4:      # AVI_INDEX_OF_INDEXES
                for k in range(n):
                    supers.append(struct.unpack_from('<QII', body, 24 + 16 * k))
        elif fourcc == b'dmlh' and len(body) >= 4:
            index.dmlh_frames = struct.unpack_from('<I', body, 0)[0]
        pos += 8 + size + (size & 1)


def _walk_movi(fh: BinaryIO, start: int, end: int, frames: List[tuple]) -> None:
    '''Every frame chunk of the ``movi`` list between ``start`` and ``end``
    (nested ``rec `` lists included), as (payload offset, size).'''
    pos = start
    while pos + 8 <= end:
        head = _read(fh, pos, 8)
        fourcc, size = head[:4], struct.unpack_from('<I', head, 4)[0]
        if fourcc == b'LIST':
            _walk_movi(fh, pos + 12, pos + 8 + size, frames)
        elif fourcc in _FRAME_IDS:
            frames.append((pos + 8, size))
        pos += 8 + size + (size & 1)


def read_avi(filename: str, walk: bool = False) -> AviIndex:
    '''The headers and the frame index of an AVI file (see the module).'''
    index = AviIndex()
    supers: List[tuple] = []
    movis: List[tuple] = []          # (start of the 'movi' fourcc, end)
    idx1 = None
    with open(filename, 'rb') as fh:
        fh.seek(0, 2)
        file_size = fh.tell()
        pos = 0
        while pos + 12 <= file_size:
            head = _read(fh, pos, 12)
            if head[:4] != b'RIFF':
                if pos == 0:
                    raise AviError(f'{filename} is not a RIFF file')
                break
            riff_size = struct.unpack_from('<I', head, 4)[0]
            kind = head[8:12]
            if pos == 0 and kind != b'AVI ':
                raise AviError(f'{filename} is a RIFF {kind!r}, not an AVI')
            index.riffs.append(kind.decode('latin-1'))
            riff_end = min(pos + 8 + riff_size, file_size)
            sub = pos + 12
            while sub + 8 <= riff_end:
                chunk = _read(fh, sub, 12 if sub + 12 <= riff_end else 8)
                fourcc, size = chunk[:4], struct.unpack_from('<I', chunk, 4)[0]
                if fourcc == b'LIST' and chunk[8:12] == b'hdrl':
                    _parse_header_list(_read(fh, sub + 12, size - 4), index, supers)
                elif fourcc == b'LIST' and chunk[8:12] == b'movi':
                    movis.append((sub + 8, min(sub + 8 + size, riff_end)))
                elif fourcc == b'idx1' and idx1 is None:
                    idx1 = np.frombuffer(_read(fh, sub + 8, size - size % 16), np.uint32) \
                        .reshape(-1, 4)
                sub += 8 + size + (size & 1)
            pos = pos + 8 + riff_size + (riff_size & 1)
        if not movis:
            raise AviError(f'{filename} has no movi list')
        index.idx1 = None if idx1 is None else len(idx1)
        frames: List[tuple] = []
        keys: List[bool] = []
        index.super = [entry[2] for entry in supers]
        if supers and not walk:
            index.source = 'indx'
            for offset, size, _count in supers:
                data = _read(fh, offset, size)
                if data[:2] != b'ix' and data[:4] != b'indx':
                    raise AviError(f'{filename}: no ix00 chunk at {offset}')
                per_entry, _sub, _kind, n, _ckid, base = struct.unpack_from('<HBBI4sQ', data, 8)
                entries = np.frombuffer(data, np.uint32, 2 * n, 32).reshape(n, 2) \
                    if per_entry == 2 else np.zeros((0, 2), np.uint32)
                frames.extend(zip((base + entries[:, 0].astype(np.int64)).tolist(),
                                  (entries[:, 1] & 0x7FFFFFFF).tolist()))
                keys.extend(((entries[:, 1] & _NOT_KEYFRAME) == 0).tolist())
        elif idx1 is not None and not walk:
            index.source = 'idx1'
            ids = idx1[:, 0].tobytes()
            video = [ids[4 * k:4 * k + 4] in _FRAME_IDS for k in range(len(idx1))]
            entries = idx1[np.asarray(video, bool)]
            offsets = entries[:, 2].astype(np.int64)
            if len(offsets):
                movi = movis[0][0]
                # offsets count from the 'movi' fourcc, or from the file's start
                relative = _read(fh, movi + int(offsets[0]), 4) in _FRAME_IDS
                offsets = offsets + (movi if relative else 0) + 8
            frames = list(zip(offsets.tolist(), entries[:, 3].astype(np.int64).tolist()))
            keys = ((entries[:, 1] & AVIIF_KEYFRAME) != 0).tolist()
        else:
            index.source = 'walk'
            for start, end in movis:
                _walk_movi(fh, start + 4, end, frames)
            keys = [True] * len(frames)
    index.offsets = np.asarray([f[0] for f in frames], np.int64)
    index.sizes = np.asarray([f[1] for f in frames], np.int64)
    index.keyframes = np.asarray(keys, bool)
    return index


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b'\0' if len(payload) % 2 else b''
    return fourcc + struct.pack('<I', len(payload)) + payload + pad


class AviWriter:
    '''Writes encoded frames of one size into an OpenDML AVI at ``fps``
    (see the module): ``fourcc`` names the codec, ``extradata`` follows
    ``strf``'s BITMAPINFOHEADER, ``bit_count`` is its biBitCount.

    ``write(chunks, keyframes)`` appends encoded frames (all keyframes when
    ``keyframes`` is None); ``close()`` writes the indexes and the counts.
    ``riff_limit`` is the size at which a RIFF is closed and the next
    ``AVIX`` begins (1 GiB; smaller in tests).'''

    def __init__(self, filename: str, width: int, height: int, fps: float = 30,
                 fourcc: bytes = b'MJPG', bit_count: int = 24, extradata: bytes = b'',
                 riff_limit: int = RIFF_LIMIT):
        self.filename = filename
        self.width, self.height, self.fps = int(width), int(height), fps
        self.fourcc, self.bit_count, self.extradata = fourcc, int(bit_count), bytes(extradata)
        self.riff_limit = int(riff_limit)
        self.nframes = 0
        self.max_chunk = 0
        self._fh = open(filename, 'wb+')
        self._riffs: List[dict] = []     # per RIFF: start, movi, chunks [(pos, size, key)]
        self._super: List[tuple] = []    # (ix00 offset, ix00 size, frames)
        self._write_headers()
        self._open_riff(b'AVI ')

    def _write_headers(self) -> None:
        fh = self._fh
        fh.write(b'RIFF\0\0\0\0AVI ')
        self._hdrl = fh.tell()
        fh.write(b'LIST\0\0\0\0hdrl')
        self._avih = fh.tell()
        fh.write(_chunk(b'avih', bytes(56)))
        strl = fh.tell()
        fh.write(b'LIST\0\0\0\0strl')
        self._strh = fh.tell()
        fh.write(_chunk(b'strh', bytes(56)))
        bih = struct.pack('<IiiHH4sIiiII', 40 + len(self.extradata), self.width, self.height, 1,
                          self.bit_count, self.fourcc,
                          self.width * self.height * max(self.bit_count, 8) // 8, 0, 0, 0, 0)
        fh.write(_chunk(b'strf', bih + self.extradata))
        self._indx = fh.tell()
        fh.write(_chunk(b'indx', bytes(24 + 16 * SUPER_INDEX_ENTRIES)))
        self._patch_list(strl)
        odml = fh.tell()
        fh.write(b'LIST\0\0\0\0odml')
        self._dmlh = fh.tell()
        fh.write(_chunk(b'dmlh', bytes(248)))
        self._patch_list(odml)
        self._patch_list(self._hdrl)

    def _patch_list(self, start: int) -> None:
        '''Set the size of the LIST or RIFF at ``start`` to end here.'''
        end = self._fh.tell()
        self._fh.seek(start + 4)
        self._fh.write(struct.pack('<I', end - start - 8))
        self._fh.seek(end)

    def _open_riff(self, kind: bytes) -> None:
        fh = self._fh
        start = 0 if kind == b'AVI ' else fh.tell()
        if kind != b'AVI ':
            fh.write(b'RIFF\0\0\0\0' + kind)
        movi = fh.tell()
        fh.write(b'LIST\0\0\0\0movi')
        self._riffs.append({'start': start, 'movi': movi, 'chunks': []})

    def _close_riff(self) -> None:
        fh, riff = self._fh, self._riffs[-1]
        chunks = riff['chunks']
        base = riff['movi'] + 8      # the 'movi' fourcc
        ix = fh.tell()
        entries = b''.join(struct.pack('<II', pos + 8 - base, size | (0 if key else _NOT_KEYFRAME))
                           for pos, size, key in chunks)
        fh.write(_chunk(b'ix00', struct.pack('<HBBI4sQI', 2, 0, 1, len(chunks), b'00dc', base, 0)
                        + entries))
        self._super.append((ix, fh.tell() - ix, len(chunks)))
        if len(self._super) > SUPER_INDEX_ENTRIES:
            raise RuntimeError(f'more than {SUPER_INDEX_ENTRIES} RIFFs in {self.filename}')
        self._patch_list(riff['movi'])
        if riff['start'] == 0:
            fh.write(_chunk(b'idx1', b''.join(
                struct.pack('<4sIII', b'00dc', AVIIF_KEYFRAME if key else 0, pos - base, size)
                for pos, size, key in chunks)))
        self._patch_list(riff['start'])

    def _riff_room(self, nbytes: int) -> bool:
        riff = self._riffs[-1]
        n = len(riff['chunks']) + 1
        index = 32 + 8 * n + (8 + 16 * n if riff['start'] == 0 else 0)
        return self._fh.tell() + nbytes + 8 + index - riff['start'] <= self.riff_limit \
            or not riff['chunks']

    def write(self, chunks: Sequence[bytes], keyframes: Optional[Sequence[bool]] = None) -> None:
        '''Append encoded frames; ``keyframes[i]`` marks chunk i a keyframe.'''
        fh = self._fh
        for i, data in enumerate(chunks):
            size = len(data)
            if not self._riff_room(size + (size & 1)):
                self._close_riff()
                self._open_riff(b'AVIX')
            pos = fh.tell()
            fh.write(b'00dc' + struct.pack('<I', size))
            fh.write(data)
            if size & 1:
                fh.write(b'\0')
            self._riffs[-1]['chunks'].append((pos, size, True if keyframes is None
                                              else bool(keyframes[i])))
            self.nframes += 1
            self.max_chunk = max(self.max_chunk, size)

    def close(self) -> None:
        '''Write the indexes and the counts, and close the file.'''
        if self._fh is None:
            return
        fh = self._fh
        self._close_riff()
        end = fh.tell()
        first = len(self._riffs[0]['chunks'])
        usec = int(round(1e6 / self.fps))
        fh.seek(self._avih + 8)
        fh.write(struct.pack('<14I', usec, int(self.max_chunk * self.fps), 0, AVIF_HASINDEX,
                             first, 0, 1, self.max_chunk + 8, self.width, self.height,
                             0, 0, 0, 0))
        fh.seek(self._strh + 8)
        fh.write(struct.pack('<4s4sIHHIIIIIIIIhhhh', b'vids', self.fourcc, 0, 0, 0, 0, 1,
                             int(round(self.fps)), 0, self.nframes, self.max_chunk + 8,
                             0xFFFFFFFF, 0, 0, 0, self.width, self.height))
        fh.seek(self._indx + 8)
        fh.write(struct.pack('<HBBI4s3I', 4, 0, 0, len(self._super), b'00dc', 0, 0, 0))
        for offset, size, frames in self._super:
            fh.write(struct.pack('<QII', offset, size, frames))
        fh.seek(self._dmlh + 8)
        fh.write(struct.pack('<I', self.nframes))
        fh.seek(end)
        fh.close()
        self._fh = None
