'''A MoSeq session on disk (a loose directory or a ``.tar.gz``): depth
frames, metadata, timestamps, and the ROI discovery that extraction starts
with.

Port of ``moseq2_detectron_extract_tpu/io/session.py`` (``Session``,
``SessionFramesIterator``, ``SessionFramesSampler``,
``SessionFramesIndexer``, ``TimestampMapper``). ``Session.find_roi`` runs
the background median and the plane RANSAC on ``device`` (CUDA unless the
caller asks for the CPU) and caches its results as TIFFs when given a
``cache_dir``.
'''
import logging
import os
import tarfile
from enum import Enum
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, TypedDict, Union

import numpy as np

from moseq2_detectron_extract_tpu_torch.io.image import read_tiff_image, write_image
from moseq2_detectron_extract_tpu_torch.io.util import (gen_batch_sequence, load_metadata,
                                                        load_timestamps)
from moseq2_detectron_extract_tpu_torch.io.video import (get_movie_info, load_movie_data,
                                                         open_ffv1_reader)


class Stream(str, Enum):
    '''A data stream within a session.'''
    DEPTH = 'depth'
    RGB = 'rgb'


class Session:
    '''A (possibly tar-compressed) MoSeq session: depth.dat (or a directory's
    FFV1 depth.avi), metadata.json and timestamps; ``frame_trim`` drops
    frames at the start and the end.'''

    def __init__(self, path: str, frame_trim: Tuple[int, int] = (0, 0)):
        self.tar: Optional[tarfile.TarFile] = None
        self.tar_members: Optional[List[tarfile.TarInfo]] = None
        self.tar_names: List[str] = []
        self._true_depth: Optional[float] = None
        self._first_frame: Optional[np.ndarray] = None
        self._bground_im: Optional[np.ndarray] = None
        self._roi: Optional[np.ndarray] = None
        self.plane: Optional[np.ndarray] = None
        self.session_path = path
        self._init_session(path)
        self._trim_frames(frame_trim)

    def _init_session(self, input_file: str) -> None:
        self.dirname = os.path.dirname(input_file)
        if input_file.endswith(('.tar.gz', '.tgz')):
            base = os.path.basename(input_file).replace('.tar.gz', '').replace('.tgz', '')
            self.dirname = os.path.join(self.dirname, base)
            self.tar = tarfile.open(input_file, mode='r:*')
            self.tar_members = self.tar.getmembers()
            self.tar_names = [m.name for m in self.tar_members]
            self.depth_file: Union[str, tarfile.TarInfo] = \
                self.tar_members[self.tar_names.index('depth.dat')]
            self.session_id = os.path.basename(input_file).split('.')[0]
        else:
            self.depth_file = input_file
            self.session_id = os.path.basename(self.dirname)

        meta = self.load_metadata()
        self.depth_metadata = get_movie_info(
            self.depth_file, frame_dims=tuple(meta.get('DepthResolution', (512, 424))),
            tar_object=self.tar)
        # rgb.mp4 is compressed, which the port cannot read: the session has
        # no rgb stream, as in the JAX package when it cannot probe the file
        self.rgb_file: Optional[str] = None
        self.rgb_metadata = None

    def _trim_frames(self, frame_trim: Tuple[int, int]) -> None:
        self.frame_trim = frame_trim
        self.nframes = self.depth_metadata['nframes']
        self.first_frame_idx = frame_trim[0] if 0 < frame_trim[0] < self.nframes else 0
        if self.nframes - frame_trim[1] > self.first_frame_idx:
            self.last_frame_idx = self.nframes - frame_trim[1]
        else:
            self.last_frame_idx = self.nframes
        self.nframes = self.last_frame_idx - self.first_frame_idx

    @property
    def is_compressed(self) -> bool:
        '''True when backed by a tar archive.'''
        return self.tar is not None

    def _tar_member(self, name: str):
        return self.tar.extractfile(self.tar_members[self.tar_names.index(name)])

    def load_metadata(self) -> dict:
        '''The session's metadata.json (an empty dict if absent).'''
        if self.tar is not None and 'metadata.json' in self.tar_names:
            member = self._tar_member('metadata.json')
            if member is None:
                raise ValueError('could not read metadata from tar')
            with member:
                return load_metadata(member)
        meta_path = os.path.join(self.dirname, 'metadata.json')
        if os.path.exists(meta_path):
            return load_metadata(meta_path)
        return {}

    def load_timestamps(self, stream: Stream) -> np.ndarray:
        '''Trimmed timestamps (ms) of ``stream``: depth_ts.txt, else
        timestamps.csv in seconds; 30 frames/s made up when both are absent.'''
        search = ([('depth_ts.txt', 1.0), ('timestamps.csv', 1000.0)]
                  if stream == Stream.DEPTH else [('rgb_ts.txt', 1.0)])
        for name, factor in search:
            if self.tar is not None and name in self.tar_names:
                with self._tar_member(name) as member:
                    ts = load_timestamps(member, col=0)
                return ts[self.first_frame_idx:self.last_frame_idx] * factor
            path = os.path.join(self.dirname, name)
            if os.path.exists(path):
                ts = load_timestamps(path, col=0)
                return ts[self.first_frame_idx:self.last_frame_idx] * factor
        logging.warning('no timestamp file found for %s; synthesizing 30fps timestamps', stream)
        return np.arange(self.first_frame_idx, self.last_frame_idx) * (1000.0 / 30.0)

    def find_roi(self, bg_roi_dilate: Tuple[int, int] = (10, 10), bg_roi_shape: str = 'ellipse',
                 bg_roi_index: int = 0, bg_roi_weights: Tuple[float, float, float] = (1, .1, 1),
                 bg_roi_depth_range: Tuple[float, float] = (650, 750),
                 bg_roi_gradient_filter: bool = False, bg_roi_gradient_threshold: float = 3000,
                 bg_roi_gradient_kernel: int = 7, bg_roi_fill_holes: bool = True,
                 use_plane_bground: bool = False, verbose: bool = False,
                 cache_dir: Optional[str] = None, device='cuda'):
        '''First frame, background, ROI mask and true depth (the median
        background depth inside the ROI), each read from ``cache_dir`` when
        cached there and written there when computed.

        The background is the temporal median of every 500th frame, each
        5x5-median blurred; the ROI is the chosen region of a plane RANSAC
        over the background (``proc.roi.get_roi``). Both run on ``device``.
        '''
        from moseq2_detectron_extract_tpu_torch.proc.roi import get_bground_im, get_roi

        use_cache = cache_dir is not None
        cache_dir = cache_dir or ''

        ff_filename = os.path.join(cache_dir, 'first_frame.tiff')
        if self._first_frame is not None:
            first_frame = self._first_frame
        elif use_cache and os.path.exists(ff_filename):
            first_frame = read_tiff_image(ff_filename, scale=True)[None]
        else:
            first_frame = next(iter(self.index([0], streams=(Stream.DEPTH,))))[1]
            if use_cache:
                write_image(ff_filename, first_frame[0], scale=True,
                            scale_factor=bg_roi_depth_range)

        bg_filename = os.path.join(cache_dir, 'bground.tiff')
        if self._bground_im is not None:
            bground_im = self._bground_im
        elif use_cache and os.path.exists(bg_filename):
            if verbose:
                logging.info('Loading cached background...')
            bground_im = read_tiff_image(bg_filename, scale=True)
        else:
            if verbose:
                logging.info('Computing background...')
            bg_idxs = np.arange(0, self.nframes, 500)
            bg_frames = next(iter(self.index(bg_idxs, chunk_size=len(bg_idxs) + 1)))[1]
            bground_im = get_bground_im(bg_frames, device=device)

        if use_cache and not use_plane_bground and not os.path.exists(bg_filename):
            write_image(bg_filename, np.asarray(bground_im), scale=True)

        roi_filename = os.path.join(cache_dir, f'roi_{bg_roi_index:02d}.tiff')
        if use_cache and os.path.exists(roi_filename):
            if verbose:
                logging.info('Loading cached ROI...')
            roi = read_tiff_image(roi_filename, scale=True) > 0
        else:
            if verbose:
                logging.info('Computing roi...')
            rois, plane = get_roi(bground_im, dilate_size=bg_roi_dilate,
                                  dilate_shape=bg_roi_shape, weights=bg_roi_weights,
                                  depth_range=bg_roi_depth_range,
                                  gradient_filter=bg_roi_gradient_filter,
                                  gradient_threshold=bg_roi_gradient_threshold,
                                  gradient_kernel=bg_roi_gradient_kernel,
                                  fill_holes=bg_roi_fill_holes, device=device)
            self.plane = plane
            if use_plane_bground:
                yy, xx = np.meshgrid(np.arange(bground_im.shape[0]),
                                     np.arange(bground_im.shape[1]), indexing='ij')
                plane_im = -(plane[0] * xx + plane[1] * yy + plane[3]) / plane[2]
                bground_im = plane_im.reshape(bground_im.shape)
                if use_cache:
                    write_image(bg_filename, bground_im, scale=True)
            roi = rois[bg_roi_index]
            if use_cache:
                write_image(roi_filename, roi.astype('uint8') * 255, scale=True, dtype='uint8')

        true_depth = float(np.median(np.asarray(bground_im)[np.asarray(roi) > 0]))
        if verbose:
            logging.info('Detected true depth: %s', true_depth)
        self._true_depth = true_depth
        self._first_frame = np.asarray(first_frame)
        self._bground_im = np.asarray(bground_im)
        self._roi = np.asarray(roi)
        return self._first_frame, self._bground_im, self._roi, true_depth

    def _found(self, value):
        if value is None:
            raise RuntimeError('call Session.find_roi() first')
        return value

    @property
    def true_depth(self) -> float:
        '''Median background depth inside the ROI (after find_roi()).'''
        return self._found(self._true_depth)

    @property
    def first_frame(self) -> np.ndarray:
        '''First depth frame (after find_roi()).'''
        return self._found(self._first_frame)

    @property
    def bground_im(self) -> np.ndarray:
        '''Median background image (after find_roi()).'''
        return self._found(self._bground_im)

    @property
    def roi(self) -> np.ndarray:
        '''ROI mask (after find_roi()).'''
        return self._found(self._roi)

    def iterate(self, chunk_size: int = 1000, chunk_overlap: int = 0,
                streams: Iterable[Stream] = (Stream.DEPTH,),
                block_frames: Optional[int] = None) -> 'SessionFramesIterator':
        '''All frames in overlapping chunks; ``block_frames`` reads and
        filters raw depth that many frames at a time.'''
        return SessionFramesIterator(self, chunk_size, chunk_overlap, streams,
                                     block_frames=block_frames)

    def sample(self, num_samples: int, chunk_size: int = 1000,
               streams: Iterable[Stream] = (Stream.DEPTH,)) -> 'SessionFramesSampler':
        '''Randomly sampled frames in chunks.'''
        return SessionFramesSampler(self, num_samples, chunk_size=chunk_size,
                                    chunk_overlap=0, streams=streams)

    def index(self, frame_idxs: Sequence[int], chunk_size: int = 1000,
              streams: Iterable[Stream] = (Stream.DEPTH,)) -> 'SessionFramesIndexer':
        '''The given frames (relative to the trimmed start) in chunks.'''
        return SessionFramesIndexer(self, frame_idxs, chunk_size=chunk_size,
                                    chunk_overlap=0, streams=streams)

    def __str__(self) -> str:
        return (f'{self.session_path} ({self.nframes} frames, '
                f'[{self.first_frame_idx}:{self.last_frame_idx}])')


class _FilterItem(TypedDict):
    filter: Callable[[np.ndarray], np.ndarray]
    streams: Iterable[Stream]


class SessionFramesIterator:
    '''Chunks of frames in order, each through the filters attached to its
    stream.

    With ``block_frames`` a depth chunk is read (or decoded) and filtered
    ``block_frames`` frames at a time into the chunk: a 32-frame block of
    Kinect frames (14 MB) stays in the last-level cache between the read
    and the filter, where a whole 1000-frame raw chunk (434 MB) would not.
    Only valid when every depth filter works frame by frame, as the host
    prep does.

    An FFV1 session is read through the iterator's own decoder, which goes
    on from one chunk or block to the next without going back to a keyframe
    (``io/ffv1.py``), and is closed when the iterator is spent.
    '''

    def __init__(self, session: Session, chunk_size: int, chunk_overlap: int,
                 streams: Iterable[Stream], block_frames: Optional[int] = None):
        self.session = session
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.block_frames = block_frames
        self.streams: List[Stream] = list(dict.fromkeys(streams).keys())
        self.batches = list(self.generate_samples())
        self.current = 0
        self.filters: List[_FilterItem] = []
        self._reader = open_ffv1_reader(session.depth_file)

    @property
    def nframes(self) -> int:
        '''Total frames produced across batches (overlap counted twice).'''
        return sum(len(b) for b in self.batches)

    @property
    def nbatches(self) -> int:
        '''Number of batches.'''
        return len(self.batches)

    def attach_filter(self, stream: Union[Stream, Iterable[Stream]],
                      filterer: Callable[[np.ndarray], np.ndarray]) -> None:
        '''Attach a filter, applied in order, to the given stream(s).'''
        streams = [stream] if isinstance(stream, Stream) else list(stream)
        self.filters.append({'filter': filterer, 'streams': streams})

    def _apply_filters(self, data: np.ndarray, stream: Stream) -> np.ndarray:
        for filt in self.filters:
            if stream in filt['streams']:
                data = filt['filter'](data)
        return data

    def generate_samples(self):
        '''Ordered batches over the trimmed frame range.'''
        return gen_batch_sequence(self.session.nframes, self.chunk_size,
                                  self.chunk_overlap, self.session.first_frame_idx)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return self

    def __next__(self):
        if self.current >= len(self.batches):
            if self._reader is not None:
                self._reader.close()
                self._reader = None
            raise StopIteration
        frame_idxs = list(self.batches[self.current])
        self.current += 1
        out = [frame_idxs]
        for stream in self.streams:
            if stream != Stream.DEPTH:
                raise ValueError(f'the session has no readable {stream.value} stream')
            if self.block_frames:
                out.append(self._read_depth_blocked(frame_idxs))
                continue
            data = load_movie_data(self.session.depth_file, frame_idxs,
                                   frame_dims=self.session.depth_metadata['dims'],
                                   tar_object=self.session.tar, reader=self._reader)
            out.append(self._apply_filters(data, stream))
        return tuple(out)

    def _read_depth_blocked(self, frame_idxs: List[int]) -> np.ndarray:
        bs = int(self.block_frames)
        out: Optional[np.ndarray] = None
        for s in range(0, len(frame_idxs), bs):
            sub = frame_idxs[s:s + bs]
            raw = load_movie_data(self.session.depth_file, sub,
                                  frame_dims=self.session.depth_metadata['dims'],
                                  tar_object=self.session.tar, reader=self._reader)
            filt = np.asarray(self._apply_filters(raw, Stream.DEPTH))
            if out is None:
                out = np.empty((len(frame_idxs),) + filt.shape[1:], filt.dtype)
            out[s:s + len(sub)] = filt
        if out is None:
            return np.empty((0,) + tuple(self.session.depth_metadata['dims'][::-1]), np.uint8)
        return out


class SessionFramesSampler(SessionFramesIterator):
    '''Chunks of randomly sampled frames (numpy's global generator).'''

    def __init__(self, session: Session, num_samples: int, chunk_size: int,
                 chunk_overlap: int, streams: Iterable[Stream]):
        self.num_samples = int(num_samples)
        super().__init__(session, chunk_size, chunk_overlap, streams)

    def generate_samples(self):
        offset = self.session.first_frame_idx
        seq = np.arange(offset, offset + self.session.nframes)
        chosen = np.sort(np.random.choice(seq, min(self.num_samples, len(seq)), replace=False))
        return [chosen[i:i + self.chunk_size] for i in range(0, len(chosen), self.chunk_size)]


class SessionFramesIndexer(SessionFramesIterator):
    '''Chunks of the given frames, relative to the trimmed start.'''

    def __init__(self, session: Session, frame_idxs: Sequence[int], chunk_size: int,
                 chunk_overlap: int, streams: Iterable[Stream]):
        self.frame_idxs = list(frame_idxs)
        super().__init__(session, chunk_size, chunk_overlap, streams)

    def generate_samples(self):
        offset = self.session.first_frame_idx
        idxs = [int(i) + offset for i in self.frame_idxs]
        return [idxs[i:i + self.chunk_size] for i in range(0, len(idxs), self.chunk_size)]


class TimestampMapper:
    '''Nearest-timestamp index mapping across streams.'''

    def __init__(self) -> None:
        self.timestamp_map: dict = {}

    def add_timestamps(self, name: str, timestamps: np.ndarray) -> None:
        '''Register a stream's timestamps.'''
        self.timestamp_map[name] = np.asarray(timestamps)

    def map_index(self, query: str, reference: str,
                  index: Union[int, Sequence[int]]) -> List[int]:
        '''Indices of the query stream nearest in time to the reference's.'''
        if isinstance(index, int):
            index = [index]
        ref_times = self.timestamp_map[reference][list(index)]
        query_times = self.timestamp_map[query]
        return [int(np.abs(query_times - t).argmin()) for t in ref_times]

    def map_time(self, query: str, reference: str,
                 index: Union[int, Sequence[int]]) -> List[float]:
        '''Timestamps of the query stream nearest in time to the reference's.'''
        idxs = self.map_index(query, reference, index)
        return [float(self.timestamp_map[query][i]) for i in idxs]
