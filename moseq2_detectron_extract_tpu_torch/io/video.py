'''Depth video: frame counts and reads of raw 16-bit ``.dat`` files and of
lossless FFV1 ``.avi`` files; the FFV1 writer; the jet colormap and the
preview video's writer.

Port of ``moseq2_detectron_extract_tpu/io/video.py`` (``get_raw_info``,
``read_frames_raw``, ``get_video_info``, ``write_frames``, ``read_frames``,
``load_movie_data``, ``get_movie_info``; ``_jet_lut``,
``apply_colormap_jet`` and ``PreviewVideoWriter``, lines 440-635). Random
access to raw frames is coalesced into one seek and read per run of
consecutive frames, and a run that lands on consecutive output rows is read
straight into them.

The JAX package reads and writes compressed depth through ffmpeg or cv2;
the card's machine has neither, so the port decodes and encodes FFV1 in AVI
itself (``io/ffv1.py``, ``io/avi.py``). It refuses, with
:class:`CompressedVideoError` naming the codec or container, what it cannot
decode: ``.mp4`` files, AVIs of another codec, and a tar member that is not
``depth.dat``.

The preview writer writes Motion-JPEG in an AVI (``io/mjpeg.py``) where the
JAX package writes h264 or mp4v through ffmpeg or cv2, which the card's
machine does not have; its frames are the JAX writer's, frame numbers
included (``ops/draw.py``).
'''
import os
import tarfile
from itertools import groupby
from operator import itemgetter
from typing import Iterable, List, Optional, Tuple, TypedDict, Union

import numpy as np

from moseq2_detectron_extract_tpu_torch.io.avi import AviError
from moseq2_detectron_extract_tpu_torch.io.ffv1 import (DEFAULT_SLICES, Ffv1Error, Ffv1Reader,
                                                        Ffv1Writer)
from moseq2_detectron_extract_tpu_torch.io.mjpeg import RIFF_LIMIT, MjpegAviWriter
from moseq2_detectron_extract_tpu_torch.ops.draw import DrawList

VideoFile = Union[str, tarfile.TarInfo]


class CompressedVideoError(RuntimeError):
    '''A compressed stream the port cannot decode: an ``.mp4``, an AVI of
    another codec than FFV1, or a tar member that is not ``depth.dat``.'''


class VideoInfo(TypedDict):
    '''Codec, pixel format, size, rate and length of a compressed stream.'''
    file: str
    codec: str
    pixel_format: str
    dims: Tuple[int, int]
    fps: float
    nframes: int


class RawVideoInfo(TypedDict):
    '''Size and shape of a raw ``.dat`` stream.'''
    bytes: int
    nframes: int
    dims: Tuple[int, int]
    bytes_per_frame: int


def collapse_consecutive_values(values: Iterable[int]) -> List[Tuple[int, int]]:
    '''Sorted values as (start, run length) pairs of consecutive runs.'''
    grouped = []
    for _, group in groupby(enumerate(values), lambda ix: ix[0] - ix[1]):
        local = list(map(itemgetter(1), group))
        grouped.append((local[0], len(local)))
    return grouped


def _name(filename: VideoFile) -> str:
    return (filename.name if isinstance(filename, tarfile.TarInfo) else str(filename)).lower()


def _kind(filename: VideoFile) -> str:
    ''''dat' or 'avi'; raises for what the port cannot read.'''
    name = _name(filename)
    if name.endswith('.dat'):
        return 'dat'
    if isinstance(filename, tarfile.TarInfo):
        raise CompressedVideoError(
            f'tar member {filename.name}: the port reads depth.dat from a tar archive, not '
            'compressed video (the JAX package stages it for ffmpeg or cv2)')
    if name.endswith('.mp4'):
        raise CompressedVideoError(
            f'{name}: an MP4 container (h264 through ffmpeg or cv2 in the JAX package); the '
            'port decodes FFV1 in AVI only')
    if name.endswith('.avi'):
        return 'avi'
    raise RuntimeError(f'unknown movie format: {name}')


def open_ffv1_reader(filename: VideoFile) -> Optional[Ffv1Reader]:
    '''An open reader of an FFV1 ``.avi``, or None for a raw ``.dat``. Its
    owner passes it to :func:`read_frames` (``reader=``), so that a read
    that follows the last one goes on without going back to its keyframe,
    and closes it.'''
    if _kind(filename) != 'avi':
        return None
    try:
        return Ffv1Reader(str(filename))
    except (AviError, Ffv1Error) as err:
        raise CompressedVideoError(str(err)) from err


def get_raw_info(filename: VideoFile, bit_depth: int = 16,
                 frame_dims: Tuple[int, int] = (512, 424)) -> RawVideoInfo:
    '''Frame count and shape of a raw ``.dat`` file or tar member;
    ``frame_dims`` is (width, height).'''
    bytes_per_frame = int((frame_dims[0] * frame_dims[1] * bit_depth) / 8)
    nbytes = filename.size if isinstance(filename, tarfile.TarInfo) else os.stat(filename).st_size
    return {'bytes': nbytes, 'nframes': int(nbytes / bytes_per_frame), 'dims': frame_dims,
            'bytes_per_frame': bytes_per_frame}


def read_frames_raw(filename: VideoFile, frames: Optional[Union[int, Iterable[int]]] = None,
                    frame_dims: Tuple[int, int] = (512, 424), bit_depth: int = 16,
                    dtype='<i2', tar_object: Optional[tarfile.TarFile] = None) -> np.ndarray:
    '''(len(frames), height, width) frames of a raw little-endian ``.dat``
    file or tar member, in the order asked; all frames when ``frames`` is
    None or empty.'''
    info = get_raw_info(filename, bit_depth=bit_depth, frame_dims=frame_dims)
    if isinstance(frames, (int, np.integer)):
        frames = [int(frames)]
    elif frames is not None:
        frames = [int(i) for i in frames]
    if not frames:
        frames = list(range(info['nframes']))

    pos = {f: i for i, f in enumerate(frames)}
    blocks = []
    for start, nframes in collapse_consecutive_values(sorted(frames)):
        idxs = [pos[start + i] for i in range(nframes)]
        consec = idxs == list(range(idxs[0], idxs[0] + nframes))
        blocks.append({'seek': max(0, start * info['bytes_per_frame']),
                       'nbytes': nframes * info['bytes_per_frame'],
                       'shape': (nframes, frame_dims[1], frame_dims[0]),
                       'idxs': slice(idxs[0], idxs[0] + nframes) if consec else idxs})

    out = np.empty((len(frames), frame_dims[1], frame_dims[0]), dtype=np.dtype(dtype))
    if tar_object is not None:
        member = tar_object.extractfile(filename)
        if member is None:
            raise FileNotFoundError(f'could not open tar member {filename}')
        with member:
            for blk in blocks:
                member.seek(blk['seek'])
                chunk = member.read(blk['nbytes'])
                out[blk['idxs'], ...] = np.frombuffer(chunk, dtype=np.dtype(dtype)) \
                    .reshape(blk['shape'])
    elif isinstance(filename, (str, os.PathLike)):
        with open(filename, 'rb') as fh:
            for blk in blocks:
                fh.seek(blk['seek'])
                if isinstance(blk['idxs'], slice):
                    got = fh.readinto(memoryview(out[blk['idxs']]).cast('B'))
                    if got != blk['nbytes']:
                        raise EOFError(f'short read: wanted {blk["nbytes"]} bytes, got {got} '
                                       f'({filename})')
                else:
                    chunk = np.fromfile(fh, dtype=np.dtype(dtype),
                                        count=blk['shape'][0] * frame_dims[0] * frame_dims[1])
                    out[blk['idxs'], ...] = chunk.reshape(blk['shape'])
    else:
        raise ValueError(f'cannot read frames from {filename!r} without a tar object')
    return out


def get_video_info(filename: VideoFile, tar_object: Optional[tarfile.TarFile] = None
                   ) -> VideoInfo:
    '''Codec, pixel format, dims (width, height), fps and frame count of an
    FFV1 ``.avi``, from its headers and index, not from a decode.'''
    reader = open_ffv1_reader(filename)   # refuses all but gray16
    if reader is None:
        raise CompressedVideoError(f'{_name(filename)}: not a compressed video')
    try:
        return {'file': str(filename), 'codec': 'ffv1', 'pixel_format': 'gray16le',
                'dims': (reader.width, reader.height), 'fps': reader.index.fps,
                'nframes': reader.nframes}
    finally:
        reader.close()


class Ffv1Pipe:
    '''The keep-open surface of the JAX package's ffmpeg pipe
    (``pipe.stdin.close()``, then ``pipe.wait()``) over an
    :class:`io.ffv1.Ffv1Writer`.'''

    def __init__(self, writer: Ffv1Writer):
        self.writer = writer
        self.stdin = self

    def close(self) -> None:
        '''``stdin.close()``: the file is finished in ``wait()``.'''

    def wait(self) -> int:
        '''Write the AVI's indexes and close it; 0.'''
        self.writer.close()
        return 0


def write_frames(filename: str, frames: np.ndarray, threads: int = 6, fps: int = 30,
                 pixel_format: str = 'gray16le', codec: str = 'ffv1', close_pipe: bool = True,
                 pipe: Optional[Ffv1Pipe] = None, slices: int = DEFAULT_SLICES,
                 slicecrc: int = 1, frame_size: Optional[str] = None) -> Optional[Ffv1Pipe]:
    '''Encode (N, H, W) frames as uint16 into a lossless FFV1 AVI
    (``ffmpeg -vcodec ffv1 -slices 24 -slicecrc 1``). With
    ``close_pipe=False`` the returned pipe takes the next chunk as ``pipe=``;
    ``pipe.stdin.close()`` and ``pipe.wait()`` finish the file.'''
    if codec != 'ffv1' or pixel_format != 'gray16le' or not slicecrc:
        raise CompressedVideoError(
            f'{codec}/{pixel_format} (slicecrc {slicecrc}): the port writes ffv1/gray16le with '
            'slice CRCs only')
    frames = np.asarray(frames)
    if frame_size is not None and frame_size != f'{frames.shape[2]}x{frames.shape[1]}':
        raise ValueError(f'frame_size {frame_size} for frames of {frames.shape[1:]}')
    if pipe is None:
        pipe = Ffv1Pipe(Ffv1Writer(filename, frames.shape[2], frames.shape[1], fps=fps,
                                  slices=slices, threads=max(int(threads), 1)))
    pipe.writer.write_frames(frames)
    if close_pipe:
        pipe.stdin.close()
        pipe.wait()
        return None
    return pipe


def read_frames(filename: VideoFile, frames=None, threads: int = 6, fps: int = 30,
                pixel_format: str = 'gray16le', frame_size: Optional[Tuple[int, int]] = None,
                slices: int = DEFAULT_SLICES, slicecrc: int = 1,
                tar_object: Optional[tarfile.TarFile] = None,
                reader: Optional[Ffv1Reader] = None, **_) -> np.ndarray:
    '''(len(frames), height, width) uint16 frames of an FFV1 ``.avi``, in
    the order asked (random and repeated indices allowed), decoded on
    ``threads`` threads; every frame when ``frames`` is None or empty.
    ``reader`` is the caller's open reader of the file
    (:func:`open_ffv1_reader`); without it the file is opened for this call
    alone.'''
    if pixel_format != 'gray16le':
        raise CompressedVideoError(f'{pixel_format}: the port decodes gray16le depth only')
    if isinstance(frames, (int, np.integer)):
        frames = [int(frames)]
    own = reader is None
    if own:
        reader = open_ffv1_reader(filename)
        if reader is None:
            raise CompressedVideoError(f'{_name(filename)}: not a compressed video')
    try:
        if frame_size and tuple(frame_size) != (reader.width, reader.height):
            raise ValueError(f'{filename} is {reader.width}x{reader.height}, not {frame_size}')
        return reader.read(frames, threads=max(int(threads), 1))
    except Ffv1Error as err:
        raise RuntimeError(str(err)) from err
    finally:
        if own:
            reader.close()


def load_movie_data(filename: VideoFile, frames=None, frame_dims: Tuple[int, int] = (512, 424),
                    bit_depth: int = 16, reader: Optional[Ffv1Reader] = None,
                    **kwargs) -> np.ndarray:
    '''Frames of a raw ``.dat`` stream ('<i2') or an FFV1 ``.avi``
    (uint16, through ``reader`` when given); other streams raise.'''
    if isinstance(frames, (int, np.integer)):
        frames = [int(frames)]
    if _kind(filename) == 'avi':
        kwargs.pop('tar_object', None)
        return read_frames(filename, frames, reader=reader, **kwargs)
    return read_frames_raw(filename, frames=frames, frame_dims=frame_dims,
                           bit_depth=bit_depth, **kwargs)


def get_movie_info(filename: VideoFile, frame_dims: Tuple[int, int] = (512, 424),
                   bit_depth: int = 16, tar_object: Optional[tarfile.TarFile] = None):
    '''Size and shape of a raw ``.dat`` stream, or :func:`get_video_info`
    of an FFV1 ``.avi``; other streams raise.'''
    if _kind(filename) == 'avi':
        return get_video_info(filename, tar_object=tar_object)
    return get_raw_info(filename, frame_dims=frame_dims, bit_depth=bit_depth)


def _jet_lut() -> np.ndarray:
    x = np.linspace(0.0, 1.0, 256)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype('uint8')


_JET_LUT = _jet_lut()
_JET_LUT_BGR = np.ascontiguousarray(_JET_LUT[:, ::-1])


def apply_colormap_jet(frames: np.ndarray, vmin: float = 0, vmax: float = 100,
                       out: Optional[np.ndarray] = None, order: str = 'rgb') -> np.ndarray:
    '''Single-channel frames -> uint8 colour frames (``frames.shape + (3,)``)
    through a 256-entry jet table, in ``order`` 'rgb' or 'bgr'. uint8 frames
    fold the [vmin, vmax] rescale into the table; others are rescaled,
    clipped and cast first. ``out`` is written when it has the result's
    shape.'''
    if order not in ('rgb', 'bgr'):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    frames = np.asarray(frames)
    base_lut = _JET_LUT if order == 'rgb' else _JET_LUT_BGR
    scale = 255.0 / max(vmax - vmin, 1e-6)
    if frames.dtype == np.uint8:
        vals = np.clip((np.arange(256) - vmin) * scale, 0, 255).astype('uint8')
        lut = base_lut[vals]
    else:
        frames = np.clip((frames.astype('float32') - vmin) * scale, 0, 255).astype('uint8')
        lut = base_lut
    if out is not None and out.shape == frames.shape + (3,):
        np.take(lut, frames, axis=0, out=out)
        return out
    return lut[frames]


class PreviewVideoWriter:
    '''The preview video: blocks of frames into a Motion-JPEG AVI.

    Gray (N, H, W) blocks are colormapped; colour (N, H, W, 3) blocks are in
    ``channel_order``. Odd heights and widths are padded to even with
    zeros, each frame's number is stamped at (5, h - 40) as the JAX writer
    stamps it (``cv2.putText``, scale 1, thickness 2, white), and the
    frames are encoded in ``channel_order`` at ``io/mjpeg.py``'s quality.
    ``riff_limit`` is the AVI's RIFF size (``io/mjpeg.py``).'''

    def __init__(self, filename: str, fps: int = 30, vmin: float = 0, vmax: float = 100,
                 channel_order: str = 'rgb', riff_limit: int = RIFF_LIMIT) -> None:
        self.filename = filename
        self.fps = fps
        self.vmin = vmin
        self.vmax = vmax
        self.channel_order = channel_order
        self.riff_limit = riff_limit
        self._avi: Optional[MjpegAviWriter] = None
        self._buf: Optional[np.ndarray] = None

    def write_frames(self, frame_idxs: Optional[np.ndarray], frames: np.ndarray,
                     writable: bool = False) -> None:
        '''Append ``frames``; ``frame_idxs`` (or None) are stamped on them.

        ``writable=True`` declares a C-contiguous uint8 colour block safe to
        stamp in place (a render buffer the caller does not read again);
        otherwise the block is copied into a buffer kept between calls.'''
        if frames.shape[1] % 2:
            frames = np.pad(frames, ((0, 0), (0, 1)) + ((0, 0),) * (frames.ndim - 2))
        if frames.shape[2] % 2:
            frames = np.pad(frames, ((0, 0), (0, 0), (0, 1)) + ((0, 0),) * (frames.ndim - 3))
        if frames.ndim == 3:
            block = apply_colormap_jet(frames, self.vmin, self.vmax, order=self.channel_order)
        elif frames.dtype == np.uint8 and writable and frames.flags.c_contiguous:
            block = frames
        else:
            if self._buf is None or self._buf.shape != frames.shape:
                self._buf = np.empty(frames.shape, np.uint8)
            block = self._buf
            block[...] = frames if frames.dtype == np.uint8 else frames.astype('uint8')
        n, h, w = block.shape[:3]
        if frame_idxs is not None:
            stamps = DrawList()
            for i in range(n):
                stamps.number(i, int(frame_idxs[i]), (5, h - 40), 'stamp', (255, 255, 255))
            stamps.draw(block)
        if self._avi is None:
            self._avi = MjpegAviWriter(self.filename, w, h, fps=self.fps,
                                       riff_limit=self.riff_limit)
        self._avi.write_frames(block, order=self.channel_order)

    def close(self) -> None:
        '''Write the AVI's indexes and close it.'''
        if self._avi is not None:
            self._avi.close()
            self._avi = None
