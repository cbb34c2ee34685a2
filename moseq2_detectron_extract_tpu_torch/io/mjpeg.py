'''Motion-JPEG in an AVI container: the port's preview video format.

The JAX package encodes its preview through ffmpeg's h264 or cv2's mp4v
(``io/video.py:164-182, 482-635``); the card's machine has neither, so the
port writes ``results_NN.avi``: each frame a baseline JPEG made by the C++
core ``csrc/mjpeg_host.cpp`` (built with g++ by
``native.build_host_library``; frames of a block are encoded on a few
threads), stored in a RIFF AVI as ``00dc`` chunks.

An AVI 1.0 RIFF stops at 1 GiB; a 54,000-frame session is 2-3 GB of JPEGs.
So ``MjpegAviWriter`` writes OpenDML (AVI 2.0) through
``io/avi.py:AviWriter``.

``forward_coefficients`` is the plain numpy version of the encoder's
colour conversion, subsampling, DCT and quantisation, which the tests hold
the C++ to exactly.
'''
import ctypes
import os
import struct
from typing import List

import numpy as np

from moseq2_detectron_extract_tpu_torch import native
from moseq2_detectron_extract_tpu_torch.io.avi import RIFF_LIMIT, AviWriter, read_avi

DEFAULT_QUALITY = 90

ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                   48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                   22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                   47, 55, 62, 63])
LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                   14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                   18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 +
                    [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38)


def quant_tables(quality: int):
    '''The Annex K luminance and chrominance tables scaled to ``quality``
    (1-100) as libjpeg scales them; natural order.'''
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((base * scale + 50) // 100, 1, 255) for base in (LUMA_Q, CHROMA_Q))


def _cosines() -> np.ndarray:
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing='ij')
    c = np.where(u == 0, np.sqrt(0.125), 0.5 * np.cos((2 * x + 1) * u * np.pi / 16))
    # C++'s std::lround: half away from zero
    return (np.sign(c) * np.floor(np.abs(c) * 8192.0 + 0.5)).astype(np.int64)


COSINES = _cosines()


def _blocks(plane: np.ndarray) -> np.ndarray:
    '''(H, W) -> (H/8, W/8, 8, 8).'''
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def forward_coefficients(frame: np.ndarray, quality: int = DEFAULT_QUALITY,
                         order: str = 'rgb') -> np.ndarray:
    '''An (H, W, 3) uint8 frame's quantised DCT coefficients as the encoder
    computes them: (MCUs, 6 [Y00, Y01, Y10, Y11, Cb, Cr], 64) int32 in
    natural order, MCUs row by row.'''
    h, w = frame.shape[:2]
    h16, w16 = -(-h // 16) * 16, -(-w // 16) * 16
    padded = frame[np.minimum(np.arange(h16), h - 1)][:, np.minimum(np.arange(w16), w - 1)]
    px = padded.astype(np.int64)
    r, g, b = (px[..., 0], px[..., 1], px[..., 2]) if order == 'rgb' else \
        (px[..., 2], px[..., 1], px[..., 0])
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32768) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32768) >> 16

    def sub(c):
        return np.minimum(255, (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] +
                                c[1::2, 1::2] + 2) >> 2)

    ql, qc = quant_tables(quality)

    def forward(plane, q):
        blocks = _blocks(plane - 128)                                   # (by, bx, 8 y, 8 x)
        t = (np.einsum('ux,abyx->abyu', COSINES, blocks) + (1 << 10)) >> 11
        f = (np.einsum('vy,abyu->abvu', COSINES, t) + (1 << 14)) >> 15
        q = q.reshape(8, 8)
        return np.sign(f) * ((np.abs(f) + q // 2) // q)

    ly = forward(y, ql)                                                 # (2 my, 2 mx, 8, 8)
    my, mx = h16 // 16, w16 // 16
    ly = ly.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    lcb = forward(sub(cb), qc).reshape(my * mx, 1, 64)
    lcr = forward(sub(cr), qc).reshape(my * mx, 1, 64)
    return np.concatenate([ly, lcb, lcr], axis=1).astype(np.int32)


def _u8(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def forward_coefficients_native(frame: np.ndarray, quality: int = DEFAULT_QUALITY,
                                order: str = 'rgb') -> np.ndarray:
    '''``forward_coefficients`` by the C++ core.'''
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    h, w = frame.shape[:2]
    out = np.empty((-(-h // 16) * -(-w // 16), 6, 64), np.int32)
    rc = native.load_mjpeg_library().m2de_jpeg_forward(
        _u8(frame), h, w, int(quality), int(order == 'bgr'),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f'm2de_jpeg_forward returned {rc}')
    return out


ENCODE_THREADS = min(4, os.cpu_count() or 1)


class JpegBlockEncoder:
    '''Encodes (N, H, W, 3) uint8 blocks to JPEGs at ``DEFAULT_QUALITY`` in
    one C++ call, on ``ENCODE_THREADS`` threads, into a buffer kept between
    blocks.'''

    def __init__(self):
        self._buf = np.empty(0, np.uint8)

    def encode(self, frames: np.ndarray, order: str = 'rgb') -> List[memoryview]:
        '''One JPEG per frame, views into the kept buffer (valid until the
        next call).'''
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim != 4 or frames.shape[3] != 3:
            raise ValueError('frames must be (N, H, W, 3) uint8')
        n, h, w = frames.shape[:3]
        sizes = np.zeros(n, np.int64)
        if self._buf.size < n * h * w // 2:
            self._buf = np.empty(n * h * w // 2, np.uint8)
        lib = native.load_mjpeg_library()
        for _ in range(2):
            rc = lib.m2de_jpeg_encode_block(
                _u8(frames), n, h, w, DEFAULT_QUALITY, int(order == 'bgr'), ENCODE_THREADS,
                _u8(self._buf), self._buf.size,
                sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if rc != 1:
                break
            self._buf = np.empty(int(sizes.sum()) * 2, np.uint8)
        if rc != 0:
            raise RuntimeError(f'm2de_jpeg_encode_block returned {rc}')
        ends = np.cumsum(sizes)
        view = memoryview(self._buf)
        return [view[int(e - s):int(e)] for s, e in zip(sizes, ends)]


class MjpegAviWriter(AviWriter):
    '''Writes JPEG frames of one size into an OpenDML AVI at ``fps``
    (``io/avi.py:AviWriter``).

    ``write(jpegs)`` appends encoded frames; ``write_frames(frames, order)``
    encodes (N, H, W, 3) uint8 blocks first. ``close()`` writes the indexes
    and the counts. ``riff_limit`` is the size at which a RIFF is closed and
    the next ``AVIX`` begins (1 GiB; smaller in tests).'''

    def __init__(self, filename: str, width: int, height: int, fps: float = 30,
                 riff_limit: int = RIFF_LIMIT):
        super().__init__(filename, width, height, fps=fps, fourcc=b'MJPG', bit_count=24,
                         riff_limit=riff_limit)
        self.encoder = JpegBlockEncoder()

    def write_frames(self, frames: np.ndarray, order: str = 'rgb') -> None:
        '''Encode (N, H, W, 3) uint8 frames (``order`` 'rgb' or 'bgr') and
        append them.'''
        if frames.shape[1:3] != (self.height, self.width):
            raise ValueError(f'frames are {frames.shape[1:3]}, the video is '
                             f'{(self.height, self.width)}')
        self.write(self.encoder.encode(frames, order))


def read_avi_index(filename: str) -> dict:
    '''Walk an AVI's RIFFs (``io/avi.py:read_avi``): ``frames`` [(offset,
    size)] of every ``00dc`` chunk in file order, ``riffs`` (the RIFF kinds),
    ``idx1`` (its entry count, or None), ``super`` (the ``indx`` entries'
    frame counts), the headers' ``avih_frames``, ``strh_length``,
    ``dmlh_frames``, ``width``, ``height`` and ``rate``, ``jpeg_ok`` (every
    frame starts with SOI and ends with EOI) and ``sof_sizes`` (each frame's
    SOF0 (height, width)).'''
    index = read_avi(filename, walk=True)
    frames = list(zip(index.offsets.tolist(), index.sizes.tolist()))
    jpeg_ok, sof_sizes = True, []
    with open(filename, 'rb') as fh:
        for offset, size in frames:
            fh.seek(offset)
            data = fh.read(size)
            jpeg_ok &= data[:2] == b'\xff\xd8' and data[-2:] == b'\xff\xd9'
            sof_sizes.append(_sof0_size(data, 0, len(data)))
    return {'frames': frames, 'riffs': index.riffs, 'idx1': index.idx1, 'super': index.super,
            'avih_frames': index.avih_frames, 'strh_length': index.strh_length,
            'dmlh_frames': index.dmlh_frames, 'width': index.width, 'height': index.height,
            'rate': index.rate, 'jpeg_ok': jpeg_ok, 'sof_sizes': sof_sizes}


def _sof0_size(data: bytes, start: int, end: int):
    '''(height, width) of the SOF0 segment of the JPEG in ``data[start:end]``,
    walking its marker segments; None without one before the scan.'''
    pos = start + 2
    while pos + 4 <= end and data[pos] == 0xFF:
        marker = data[pos + 1]
        length = struct.unpack_from('>H', data, pos + 2)[0]
        if marker == 0xC0:
            return struct.unpack_from('>HH', data, pos + 5)
        if marker == 0xDA:
            return None
        pos += 2 + length
    return None
