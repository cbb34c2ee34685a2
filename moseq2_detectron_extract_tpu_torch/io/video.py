'''Raw depth video: frame counts and reads of 16-bit ``.dat`` files; the
jet colormap and the preview video's writer.

Port of ``moseq2_detectron_extract_tpu/io/video.py`` (``get_raw_info``,
``read_frames_raw``, ``load_movie_data``, ``get_movie_info``;
``_jet_lut``, ``apply_colormap_jet`` and ``PreviewVideoWriter``, lines
440-635). Random
access is coalesced into one seek and read per run of consecutive frames,
and a run that lands on consecutive output rows is read straight into them.
Compressed depth (``.avi``, ``.mp4``) needs an ffmpeg decoder, which the
port does not have: it raises :class:`CompressedVideoError`.

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

from moseq2_detectron_extract_tpu_torch.io.mjpeg import RIFF_LIMIT, MjpegAviWriter
from moseq2_detectron_extract_tpu_torch.ops.draw import DrawList

VideoFile = Union[str, tarfile.TarInfo]


class CompressedVideoError(RuntimeError):
    '''A compressed (.avi, .mp4) stream: the port reads raw .dat depth only.'''


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


def _refuse_compressed(filename: VideoFile) -> None:
    name = _name(filename)
    if name.endswith(('.avi', '.mp4')):
        raise CompressedVideoError(
            f'{name}: compressed depth video needs an ffmpeg decoder, which the port '
            'does not have (the JAX package reads it through ffmpeg or cv2); '
            'convert the session to raw depth.dat')
    if not name.endswith('.dat'):
        raise RuntimeError(f'unknown movie format: {name}')


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


def load_movie_data(filename: VideoFile, frames=None, frame_dims: Tuple[int, int] = (512, 424),
                    bit_depth: int = 16, **kwargs) -> np.ndarray:
    '''Frames of a raw ``.dat`` stream; compressed streams raise.'''
    _refuse_compressed(filename)
    if isinstance(frames, (int, np.integer)):
        frames = [int(frames)]
    return read_frames_raw(filename, frames=frames, frame_dims=frame_dims,
                           bit_depth=bit_depth, **kwargs)


def get_movie_info(filename: VideoFile, frame_dims: Tuple[int, int] = (512, 424),
                   bit_depth: int = 16) -> RawVideoInfo:
    '''Size and shape of a raw ``.dat`` stream; compressed streams raise.'''
    _refuse_compressed(filename)
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
