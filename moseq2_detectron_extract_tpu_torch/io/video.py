'''Raw depth video: frame counts and reads of 16-bit ``.dat`` files.

Port of ``moseq2_detectron_extract_tpu/io/video.py`` (``get_raw_info``,
``read_frames_raw``, ``load_movie_data``, ``get_movie_info``). Random
access is coalesced into one seek and read per run of consecutive frames,
and a run that lands on consecutive output rows is read straight into them.
Compressed depth (``.avi``, ``.mp4``) needs an ffmpeg decoder, which the
port does not have: it raises :class:`CompressedVideoError`.
'''
import os
import tarfile
from itertools import groupby
from operator import itemgetter
from typing import Iterable, List, Optional, Tuple, TypedDict, Union

import numpy as np

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
