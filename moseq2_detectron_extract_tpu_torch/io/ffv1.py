'''FFV1 in AVI: the port's reader and writer of compressed depth.

A ctypes binding of ``csrc/ffv1_host.cpp`` (FFV1 version 3, RFC 9043,
gray16 with the range coder), built with g++ by
``native.build_host_library`` at the first call; a failed build raises.
There is no other decoder to fall back on.

FFV1 frames are intra-coded, but a frame that is not a keyframe carries on
each slice's adapted context states from the frame before, so frame *i* is
decoded from the keyframe at or before it. :class:`Ffv1Reader` keeps its
decoder's state between calls: a read that starts where the last one ended
goes on from there, without going back to the keyframe.

:class:`Ffv1Writer` writes what the upstream extractor's ffmpeg command
asks for (``-vcodec ffv1 -slices 24 -slicecrc 1``, libavcodec's keyframe
every 12 frames) into an OpenDML AVI (``io/avi.py``). Its bytes differ from
ffmpeg's; its frames decode to the same samples.
'''
import math
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.io.avi import RIFF_LIMIT, AviWriter, read_avi

DEFAULT_SLICES = 24
GOP = 12                         # a keyframe every GOP frames, libavcodec's default
EC = 1                           # a CRC in every slice (``-slicecrc 1``)
THREADS = max(1, min(8, os.cpu_count() or 1))
DECODE_BATCH = 256               # frames per decoder call (bounds the bytes read at once)
SUPPORTED_VERSION = 3

ERRORS = {
    -1: 'malformed configuration record', -2: 'configuration record CRC mismatch',
    -3: 'unsupported version', -4: 'not gray16 with the range coder',
    -5: 'a frame that is not a keyframe with no keyframe decoded before it',
    -6: 'slice chain broken or slice count changed', -7: 'slice CRC mismatch',
    -8: 'bad slice header', -9: 'slice does not end where its size says',
    -10: 'slice marked damaged by its encoder',
}


class Ffv1Error(RuntimeError):
    '''An FFV1 stream the port cannot decode, or a damaged one.'''


def _ptr(array: np.ndarray) -> int:
    return array.ctypes.data


def _bytes_array(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)


def config_info(extradata: bytes) -> dict:
    '''The fields of an FFV1 configuration record: version, micro_version,
    coder, colorspace, bits, num_h, num_v (the slice grid), ec, intra,
    quant_tables, contexts. Raises :class:`Ffv1Error` naming what it
    refuses.'''
    extra = _bytes_array(extradata)
    info = np.zeros(11, np.int32)
    detail = np.zeros(1, np.int32)
    rc = native.load_ffv1_library().m2de_ffv1_parse_config(_ptr(extra), len(extradata),
                                                           _ptr(info), _ptr(detail))
    _raise_config(rc, int(detail[0]))
    keys = ('version', 'micro_version', 'coder', 'colorspace', 'bits', 'num_h', 'num_v', 'ec',
            'intra', 'quant_tables', 'contexts')
    return dict(zip(keys, (int(v) for v in info)))


def _raise_config(rc: int, detail: int) -> None:
    if rc == -3:
        raise Ffv1Error(f'FFV1 version {detail} is not supported: the port decodes version '
                        f'{SUPPORTED_VERSION} (what ffmpeg writes with -slices)')
    if rc == -4 and detail >= 100000:
        raise Ffv1Error(f'FFV1 coder {detail - 100000} (Golomb-Rice): the port decodes the '
                        'range coder')
    if rc == -4:
        raise Ffv1Error(f'FFV1 colorspace {detail // 1000} with {detail % 1000}-bit samples: '
                        'the port decodes gray16')
    if rc:
        raise Ffv1Error(f'FFV1 configuration record: {ERRORS.get(rc, rc)}')


def slice_grid(slices: int, width: int, height: int) -> Tuple[int, int]:
    '''(num_h, num_v) of a grid of ``slices`` slices, as square as the count
    allows with num_h >= num_v (24 -> 6 x 4, 4 -> 2 x 2).'''
    for num_v in range(int(math.isqrt(slices)), 0, -1):
        if slices % num_v == 0 and slices // num_v <= width and num_v <= height:
            return slices // num_v, num_v
    raise ValueError(f'{slices} slices do not fit a {width}x{height} frame')


class Ffv1Encoder:
    '''Encodes uint16 (N, H, W) frames to FFV1 version 3 packets: a grid of
    ``slices`` slices, each with its CRC, a keyframe every ``GOP`` frames
    counted across calls, on ``threads`` threads.'''

    def __init__(self, width: int, height: int, slices: int = DEFAULT_SLICES,
                 threads: int = THREADS):
        self.width, self.height = int(width), int(height)
        self.num_h, self.num_v = slice_grid(int(slices), self.width, self.height)
        self.threads = int(threads)
        self._lib = native.load_ffv1_library()
        self._enc = self._lib.m2de_ffv1_encoder_new(self.width, self.height, self.num_h,
                                                    self.num_v, GOP, EC)
        if not self._enc:
            raise ValueError(f'cannot encode {self.width}x{self.height} frames in '
                             f'{self.num_h}x{self.num_v} slices')
        size = self._lib.m2de_ffv1_encoder_extradata(self._enc, None, 0)
        extra = np.empty(size, np.uint8)
        self._lib.m2de_ffv1_encoder_extradata(self._enc, _ptr(extra), size)
        self.extradata = extra.tobytes()
        self._buf = np.empty(0, np.uint8)

    def encode(self, frames: np.ndarray) -> Tuple[List[memoryview], np.ndarray]:
        '''(packets, keyframe flags) of (N, H, W) frames; the packets are views
        into a buffer kept until the next call.'''
        frames = np.ascontiguousarray(frames, dtype=np.uint16)
        if frames.ndim != 3 or frames.shape[1:] != (self.height, self.width):
            raise ValueError(f'frames of shape {frames.shape} for a '
                             f'{self.width}x{self.height} encoder')
        n = len(frames)
        sizes = np.zeros(n, np.int64)
        keys = np.zeros(n, np.uint8)
        total = self._lib.m2de_ffv1_encode(self._enc, _ptr(frames), n, self.threads,
                                           _ptr(sizes), _ptr(keys))
        if self._buf.size < total:
            self._buf = np.empty(total, np.uint8)
        self._lib.m2de_ffv1_encoder_fetch(self._enc, _ptr(self._buf))
        ends = np.cumsum(sizes)
        view = memoryview(self._buf)
        return [view[int(e - s):int(e)] for s, e in zip(sizes, ends)], keys.astype(bool)

    def close(self) -> None:
        '''Free the encoder.'''
        if self._enc:
            self._lib.m2de_ffv1_encoder_free(self._enc)
            self._enc = None

    def __del__(self):
        self.close()


class Ffv1Writer:
    '''uint16 (N, H, W) frames into an FFV1 AVI, block by block
    (``write_frames``); ``close()`` writes the indexes.'''

    def __init__(self, filename: str, width: int, height: int, fps: float = 30,
                 slices: int = DEFAULT_SLICES, threads: int = THREADS,
                 riff_limit: int = RIFF_LIMIT):
        self.encoder = Ffv1Encoder(width, height, slices=slices, threads=threads)
        self.avi = AviWriter(filename, width, height, fps=fps, fourcc=b'FFV1', bit_count=16,
                             extradata=self.encoder.extradata, riff_limit=riff_limit)

    def write_frames(self, frames: np.ndarray) -> None:
        '''Encode and append (N, H, W) frames (cast to uint16).'''
        packets, keys = self.encoder.encode(np.asarray(frames).astype(np.uint16, copy=False))
        self.avi.write(packets, keys)

    def close(self) -> None:
        '''Write the AVI's indexes and close it.'''
        self.avi.close()
        self.encoder.close()


class Ffv1Reader:
    '''Random access to the frames of an FFV1 AVI.

    ``read(frames)`` decodes each run of consecutive wanted frames from the
    keyframe at or before its start, or from where the last call left the
    decoder when that is nearer, on ``threads`` threads (a batch's slices
    in parallel), and returns the frames in the order asked.'''

    def __init__(self, filename: str, threads: int = THREADS):
        self._lock = threading.Lock()
        self.filename = filename
        self.threads = int(threads)
        self.index = read_avi(filename)
        if self.index.fourcc.upper() != 'FFV1':
            raise Ffv1Error(f'{filename}: codec {self.index.fourcc or "unknown"!r} in AVI; the '
                            'port decodes FFV1 only (the JAX package reads other codecs '
                            'through ffmpeg or cv2)')
        self.width, self.height = self.index.width, self.index.height
        self._lib = native.load_ffv1_library()
        self._fh = open(filename, 'rb')
        self._next: Optional[int] = None          # the frame the decoder's state is ready for
        self._key_idx = np.flatnonzero(self.index.keyframes)
        if not self.index.extradata:
            self._raise_inline_version()
        extra = _bytes_array(self.index.extradata)
        err, detail = np.zeros(1, np.int32), np.zeros(1, np.int32)
        self._dec = self._lib.m2de_ffv1_decoder_new(_ptr(extra), len(self.index.extradata),
                                                    self.width, self.height, _ptr(err),
                                                    _ptr(detail))
        if not self._dec:
            _raise_config(int(err[0]), int(detail[0]))
        self.config = config_info(self.index.extradata)

    def _raise_inline_version(self) -> None:
        '''Versions 0-1 carry their parameters in each keyframe, not in the
        extradata: name the version and refuse it.'''
        if not self.index.nframes:
            raise Ffv1Error(f'{self.filename}: no configuration record and no frames')
        packet = _bytes_array(self._read_bytes(int(self.index.offsets[0]),
                                               int(self.index.sizes[0])))
        version = self._lib.m2de_ffv1_inline_version(_ptr(packet), packet.size)
        _raise_config(-3, version)

    @property
    def nframes(self) -> int:
        '''Frames in the file.'''
        return self.index.nframes

    def _read_bytes(self, offset: int, size: int) -> bytes:
        self._fh.seek(offset)
        data = self._fh.read(size)
        if len(data) != size:
            raise EOFError(f'{self.filename}: short read at {offset}')
        return data

    def _start_of(self, frame: int) -> int:
        '''The frame to decode from to reach ``frame``.'''
        k = np.searchsorted(self._key_idx, frame, side='right') - 1
        if k < 0:
            raise Ffv1Error(f'{self.filename}: no keyframe at or before frame {frame}')
        key = int(self._key_idx[k])
        if self._next is not None and key <= self._next <= frame:
            return self._next
        return key

    def _decode(self, first: int, last: int, outs: np.ndarray, threads: int) -> None:
        '''Decode frames first..last-1 in order; ``outs`` holds each frame's
        output address (0: decode without keeping it).'''
        offsets, sizes = self.index.offsets, self.index.sizes
        for b in range(first, last, DECODE_BATCH):
            e = min(b + DECODE_BATCH, last)
            off, size = offsets[b:e], sizes[b:e]
            if np.all(np.diff(off) > 0):
                base = int(off[0])
                block = np.frombuffer(self._read_bytes(base, int(off[-1] + size[-1]) - base),
                                      np.uint8)
                ptrs = (_ptr(block) + (off - base)).astype(np.uint64)
                keep = block
            else:
                keep = [_bytes_array(self._read_bytes(int(o), int(s))) for o, s in zip(off, size)]
                ptrs = np.array([_ptr(k) for k in keep], np.uint64)
            sizes_arr = np.ascontiguousarray(size, np.int64)
            out_ptrs = np.ascontiguousarray(outs[b - first:e - first], np.uint64)
            err_frame = np.zeros(1, np.int64)
            err_slice = np.zeros(1, np.int32)
            self._next = None
            rc = self._lib.m2de_ffv1_decode(self._dec, _ptr(ptrs), _ptr(sizes_arr), e - b,
                                            _ptr(out_ptrs), threads, _ptr(err_frame),
                                            _ptr(err_slice))
            del keep
            if rc:
                where = f'frame {b + int(err_frame[0])}'
                if err_slice[0] >= 0:
                    where += f', slice {int(err_slice[0])}'
                raise Ffv1Error(f'{self.filename}: {where}: {ERRORS.get(rc, rc)}')
            self._next = e

    def read(self, frames: Optional[Sequence[int]] = None,
             threads: Optional[int] = None) -> np.ndarray:
        '''(len(frames), H, W) uint16 frames in the order asked; every frame
        when ``frames`` is None or empty; on ``threads`` threads, the
        reader's own count when None.'''
        threads = self.threads if threads is None else int(threads)
        frames = list(range(self.nframes)) if frames is None or len(frames) == 0 \
            else [int(f) for f in frames]
        bad = [f for f in frames if not 0 <= f < self.nframes]
        if bad:
            raise IndexError(f'{self.filename}: frames {bad[:5]} outside 0..{self.nframes - 1}')
        out = np.empty((len(frames), self.height, self.width), np.uint16)
        row_bytes = self.height * self.width * 2
        wanted = {}
        for row, f in enumerate(frames):
            wanted.setdefault(f, row)
        order = sorted(wanted)
        with self._lock:
            if not self._dec:
                raise ValueError(f'{self.filename}: the reader is closed')
            i = 0
            while i < len(order):
                j = i
                while j + 1 < len(order) and order[j + 1] == order[j] + 1:
                    j += 1
                start, stop = order[i], order[j] + 1
                first = self._start_of(start)
                outs = np.zeros(stop - first, np.uint64)
                for f in range(start, stop):
                    outs[f - first] = _ptr(out) + wanted[f] * row_bytes
                self._decode(first, stop, outs, threads)
                i = j + 1
        seen = {}
        for row, f in enumerate(frames):
            if f in seen:
                out[row] = out[seen[f]]
            seen.setdefault(f, row)
        return out

    def close(self) -> None:
        '''Free the decoder and close the file, once no read is running.'''
        with self._lock:
            if getattr(self, '_dec', None):
                self._lib.m2de_ffv1_decoder_free(self._dec)
                self._dec = None
            if getattr(self, '_fh', None):
                self._fh.close()
                self._fh = None

    def __del__(self):
        self.close()
