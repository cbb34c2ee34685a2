'''TIFF caches of ROI discovery, with the intensity scale in a sidecar.

Port of ``moseq2_detectron_extract_tpu/io/image.py`` (lines 22-83) without
cv2 or PIL. Images are stored as uint8 or uint16 grey TIFFs, the linear
scale that maps them back to depth in ``<file>.scale.json``. The writer
writes baseline TIFFs (little-endian, one uncompressed strip); the reader
takes uncompressed and LZW strips with or without horizontal differencing,
which is what cv2 writes, so a cache written by the JAX package reads the
same.
'''
import json
import os
import struct
from typing import Optional, Tuple, Union

import numpy as np

_SCALE_SIDECAR_SUFFIX = '.scale.json'
_SHORT, _LONG = 3, 4
_TYPE_FORMATS = {1: 'B', 3: 'H', 4: 'I'}


def write_image(filename: str, image: np.ndarray, scale: bool = True,
                scale_factor: Optional[Union[Tuple[float, float], float]] = None,
                dtype: str = 'uint16') -> None:
    '''Write ``image`` scaled into ``dtype``'s range, and the scale's sidecar.

    The scale is (vmin, vmax) from ``scale_factor`` (a pair, or a max with
    vmin 0), else the image's own range.
    '''
    image = np.asarray(image)
    info = np.iinfo(dtype)
    if scale:
        if scale_factor is None:
            vmin, vmax = float(np.nanmin(image)), float(np.nanmax(image))
            if vmax <= vmin:
                vmax = vmin + 1.0
        elif isinstance(scale_factor, (int, float)):
            vmin, vmax = 0.0, float(scale_factor)
        else:
            vmin, vmax = float(scale_factor[0]), float(scale_factor[1])
        scaled = (image.astype('float64') - vmin) / (vmax - vmin)
        scaled = np.clip(scaled, 0.0, 1.0) * (info.max - info.min) + info.min
        out = scaled.astype(dtype)
        meta = {'scaled': True, 'vmin': vmin, 'vmax': vmax, 'dtype': str(dtype)}
    else:
        out = image.astype(dtype)
        meta = {'scaled': False, 'vmin': 0.0, 'vmax': float(info.max), 'dtype': str(dtype)}
    write_tiff(filename, out)
    with open(filename + _SCALE_SIDECAR_SUFFIX, 'w', encoding='utf-8') as fh:
        json.dump(meta, fh)


def read_tiff_image(filename: str, scale: bool = True) -> np.ndarray:
    '''A TIFF written by :func:`write_image` (or the JAX package's), with its
    intensities restored (f64) when the sidecar says it was scaled.'''
    raw = read_tiff(filename)
    sidecar = filename + _SCALE_SIDECAR_SUFFIX
    if scale and os.path.exists(sidecar):
        with open(sidecar, 'r', encoding='utf-8') as fh:
            meta = json.load(fh)
        if meta.get('scaled', False):
            info = np.iinfo(meta['dtype'])
            frac = (raw.astype('float64') - info.min) / (info.max - info.min)
            return frac * (meta['vmax'] - meta['vmin']) + meta['vmin']
    return raw


def write_tiff(filename: str, image: np.ndarray) -> None:
    '''A 2-D uint8 or uint16 image as a baseline grey TIFF: little-endian,
    one uncompressed strip.'''
    image = np.ascontiguousarray(image)
    if image.ndim != 2 or image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f'write_tiff takes a 2-D uint8 or uint16 image, not '
                         f'{image.dtype} {image.shape}')
    height, width = image.shape
    data = image.astype(image.dtype.newbyteorder('<'), copy=False).tobytes()
    entries = [(256, _LONG, width), (257, _LONG, height),
               (258, _SHORT, 8 * image.dtype.itemsize), (259, _SHORT, 1),   # no compression
               (262, _SHORT, 1),                                           # black is zero
               (273, _LONG, 0), (277, _SHORT, 1), (278, _LONG, height),
               (279, _LONG, len(data)), (284, _SHORT, 1), (339, _SHORT, 1)]  # unsigned
    ifd_size = 2 + 12 * len(entries) + 4
    data_offset = 8 + ifd_size
    ifd = struct.pack('<H', len(entries))
    for tag, typ, value in entries:
        value = data_offset if tag == 273 else value
        packed = struct.pack('<H', value) + b'\0\0' if typ == _SHORT else struct.pack('<I', value)
        ifd += struct.pack('<HHI', tag, typ, 1) + packed
    ifd += struct.pack('<I', 0)                                        # no next IFD
    with open(filename, 'wb') as fh:
        fh.write(b'II*\0' + struct.pack('<I', 8) + ifd + data)


def read_tiff(filename: str) -> np.ndarray:
    '''The first image of a grey 8- or 16-bit TIFF (uncompressed or LZW,
    predictor 1 or 2), as uint8 or uint16.'''
    with open(filename, 'rb') as fh:
        buf = fh.read()
    order = {b'II': '<', b'MM': '>'}.get(buf[:2])
    if order is None or struct.unpack(order + 'H', buf[2:4])[0] != 42:
        raise ValueError(f'{filename}: not a TIFF file')
    (ifd,) = struct.unpack(order + 'I', buf[4:8])
    (count,) = struct.unpack(order + 'H', buf[ifd:ifd + 2])
    tags = {}
    for i in range(count):
        at = ifd + 2 + 12 * i
        tag, typ, n = struct.unpack(order + 'HHI', buf[at:at + 8])
        if typ not in _TYPE_FORMATS:
            continue
        fmt = order + _TYPE_FORMATS[typ] * n
        size = struct.calcsize(fmt)
        src = at + 8 if size <= 4 else struct.unpack(order + 'I', buf[at + 8:at + 12])[0]
        tags[tag] = struct.unpack(fmt, buf[src:src + size])
    width, height, bits = tags[256][0], tags[257][0], tags.get(258, (1,))[0]
    compression, predictor = tags.get(259, (1,))[0], tags.get(317, (1,))[0]
    if bits not in (8, 16) or tags.get(277, (1,))[0] != 1 or compression not in (1, 5):
        raise ValueError(f'{filename}: reads grey 8- or 16-bit images, uncompressed or LZW, '
                         f'not {bits} bits, compression {compression}')
    strips = []
    for offset, nbytes in zip(tags[273], tags[279]):
        strip = buf[offset:offset + nbytes]
        strips.append(lzw_decode(strip) if compression == 5 else strip)
    dtype = np.dtype(f'{order}u{bits // 8}')
    image = np.frombuffer(b''.join(strips), dtype=dtype, count=width * height) \
        .reshape(height, width).astype(dtype.newbyteorder('='))
    if predictor == 2:                           # horizontal differencing
        image = np.cumsum(image, axis=1, dtype=image.dtype)
    return image


def lzw_decode(data: bytes) -> bytes:
    '''A TIFF LZW strip: MSB-first codes of 9-12 bits, 256 clears the table,
    257 ends the strip, and the width grows one code early.'''
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b'', b'']
    width, pos, prev = 9, 0, b''
    nbits = 8 * len(data)
    data = bytes(data) + b'\0\0\0'
    while pos + width <= nbits:
        byte, bit = divmod(pos, 8)
        code = (int.from_bytes(data[byte:byte + 3], 'big') >> (24 - bit - width)) \
            & ((1 << width) - 1)
        pos += width
        if code == 256:
            del table[258:]
            width, prev = 9, b''
            continue
        if code == 257:
            break
        if not prev:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            table.append(prev + entry[:1])
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
        out += entry
        prev = entry
    return bytes(out)
