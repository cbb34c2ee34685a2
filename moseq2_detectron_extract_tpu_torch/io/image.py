'''Images with the intensity scale in a sidecar: TIFF caches of ROI
discovery and the PNG frames of training data.

Port of ``moseq2_detectron_extract_tpu/io/image.py`` (lines 22-83) without
cv2 or PIL. Images are stored as uint8 or uint16 grey TIFFs or PNGs (by the
file's extension, as ``cv2.imwrite`` picks), the linear scale that maps
them back to depth in ``<file>.scale.json``. The TIFF writer writes
baseline TIFFs (little-endian, one uncompressed strip); the reader takes
uncompressed and LZW strips with or without horizontal differencing,
which is what cv2 writes, so a cache written by the JAX package reads the
same. PNGs are read and written with ``zlib``: 8-bit grey, RGB and RGBA and
16-bit grey, not interlaced; colour comes back in cv2's BGR(A) order, as
``cv2.imread(..., IMREAD_UNCHANGED)`` gives it. :func:`read_image` tells
the two formats apart by their first bytes.
'''
import json
import os
import struct
import zlib
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
    if filename.lower().endswith('.png'):
        write_png(filename, out)
    else:
        write_tiff(filename, out)
    with open(filename + _SCALE_SIDECAR_SUFFIX, 'w', encoding='utf-8') as fh:
        json.dump(meta, fh)


def read_tiff_image(filename: str, scale: bool = True) -> np.ndarray:
    '''A TIFF or PNG written by :func:`write_image` (or the JAX package's),
    with its intensities restored (f64) when the sidecar says it was
    scaled.'''
    with open(filename, 'rb') as fh:
        magic = fh.read(8)
    raw = read_png(filename) if magic == _PNG_MAGIC else read_tiff(filename)
    sidecar = filename + _SCALE_SIDECAR_SUFFIX
    if scale and os.path.exists(sidecar):
        with open(sidecar, 'r', encoding='utf-8') as fh:
            meta = json.load(fh)
        if meta.get('scaled', False):
            info = np.iinfo(meta['dtype'])
            frac = (raw.astype('float64') - info.min) / (info.max - info.min)
            return frac * (meta['vmax'] - meta['vmin']) + meta['vmin']
    return raw


def read_image(filename: str, scale: bool = True) -> np.ndarray:
    '''Read a PNG or TIFF, applying the scale sidecar.'''
    return read_tiff_image(filename, scale=scale)


# -- PNG ---------------------------------------------------------------------------

_PNG_MAGIC = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}       # grey, RGB, RGBA


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack('>I', len(data)) + kind + data + \
        struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(filename: str, image: np.ndarray) -> None:
    '''Write a (H, W) uint8 or uint16 grey image, or a (H, W, 3|4) uint8
    BGR(A) image (cv2's channel order), as a PNG with no row filters.'''
    image = np.ascontiguousarray(image)
    if image.ndim == 2 and image.dtype in (np.uint8, np.uint16):
        color, rows = 0, image
    elif image.ndim == 3 and image.shape[2] in (3, 4) and image.dtype == np.uint8:
        color = 2 if image.shape[2] == 3 else 6
        rgb = image[..., [2, 1, 0] + ([3] if image.shape[2] == 4 else [])]
        rows = rgb.reshape(image.shape[0], -1)
    else:
        raise ValueError(f'write_png takes grey uint8/uint16 or BGR(A) uint8, not '
                         f'{image.dtype} {image.shape}')
    height, width = image.shape[:2]
    bits = 8 * image.dtype.itemsize
    raw = np.ascontiguousarray(rows.astype(rows.dtype.newbyteorder('>'), copy=False)) \
        .view(np.uint8).reshape(height, -1)
    scanlines = np.concatenate([np.zeros((height, 1), np.uint8), raw], axis=1)
    header = struct.pack('>IIBBBBB', width, height, bits, color, 0, 0, 0)
    with open(filename, 'wb') as fh:
        fh.write(_PNG_MAGIC + _png_chunk(b'IHDR', header)
                 + _png_chunk(b'IDAT', zlib.compress(scanlines.tobytes(), 6))
                 + _png_chunk(b'IEND', b''))


def _unfilter_row(kind: int, row: bytearray, prior: bytearray, bpp: int) -> bytearray:
    '''Undo one scanline's PNG filter (types 0-4) in place.'''
    n = len(row)
    if kind == 1:
        sub = np.frombuffer(row, np.uint8).reshape(-1, bpp)
        return bytearray(np.cumsum(sub, axis=0, dtype=np.uint8).tobytes())
    if kind == 2:
        return bytearray((np.frombuffer(row, np.uint8) + np.frombuffer(prior, np.uint8))
                         .tobytes())
    if kind == 3:
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF
    elif kind != 0:
        raise ValueError(f'PNG filter type {kind} is not defined')
    return row


def read_png(filename: str) -> np.ndarray:
    '''A non-interlaced 8-bit grey, RGB or RGBA or 16-bit grey PNG: (H, W)
    grey, or (H, W, 3|4) in BGR(A) order, uint8 or uint16.'''
    with open(filename, 'rb') as fh:
        buf = fh.read()
    if buf[:8] != _PNG_MAGIC:
        raise ValueError(f'{filename}: not a PNG file')
    pos, idat, header = 8, [], None
    while pos < len(buf):
        (length,) = struct.unpack('>I', buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', data)
        elif kind == b'IDAT':
            idat.append(data)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError(f'{filename}: no IHDR chunk')
    width, height, bits, color, _, _, interlace = header
    if interlace:
        raise ValueError(f'{filename}: interlaced PNGs are not read')
    if color not in _PNG_CHANNELS or bits not in (8, 16) or (bits == 16 and color != 0):
        raise ValueError(f'{filename}: reads 8-bit grey, RGB and RGBA and 16-bit grey '
                         f'PNGs, not colour type {color} at {bits} bits')
    channels = _PNG_CHANNELS[color]
    bpp = channels * bits // 8
    stride = width * bpp
    data = zlib.decompress(b''.join(idat))
    out = bytearray(height * stride)
    prior = bytearray(stride)
    for y in range(height):
        start = y * (stride + 1)
        row = _unfilter_row(data[start], bytearray(data[start + 1:start + 1 + stride]),
                            prior, bpp)
        out[y * stride:(y + 1) * stride] = row
        prior = row
    image = np.frombuffer(bytes(out), dtype=np.dtype('>u2') if bits == 16 else np.uint8)
    image = image.astype(image.dtype.newbyteorder('=')).reshape(height, width, channels)
    if channels == 1:
        return image[..., 0]
    return np.ascontiguousarray(image[..., [2, 1, 0] + ([3] if channels == 4 else [])])


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
