'''Chunk ranges, timestamps and session metadata.

Port of ``moseq2_detectron_extract_tpu/io/util.py`` (``gen_batch_sequence``,
lines 21-34; ``load_timestamps``, 111-132; ``load_metadata``, 135-140;
``find_unused_file_path``, 149-157).
'''
import json
import os
from typing import IO, List, Union

import numpy as np


def gen_batch_sequence(nframes: int, chunk_size: int, overlap: int = 0,
                       offset: int = 0) -> List[range]:
    '''Ranges of ``chunk_size`` indices covering ``offset .. offset + nframes``,
    each overlapping the previous one by ``overlap`` indices.'''
    seq = range(offset, nframes + offset)
    out = []
    for i in range(offset, len(seq) + offset - overlap, chunk_size - overlap):
        block = seq[i - offset:i - offset + chunk_size]
        if len(block) > 0:
            out.append(block)
    return out


def load_timestamps(path_or_file: Union[str, IO[bytes]], col: int = 0) -> np.ndarray:
    '''Column ``col`` of a whitespace or comma separated text file, as f64.'''
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, 'r', encoding='utf-8') as fh:
            return load_timestamps(fh, col)
    ts = []
    for raw in path_or_file:
        if isinstance(raw, bytes):
            raw = raw.decode('utf-8')
        raw = raw.strip()
        if raw:
            ts.append(float(raw.replace(',', ' ').split()[col]))
    return np.array(ts, dtype='float64')


def load_metadata(path_or_file: Union[str, IO[bytes]]) -> dict:
    '''A session's ``metadata.json``.'''
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, 'r', encoding='utf-8') as fh:
            return json.load(fh)
    return json.load(path_or_file)


def find_unused_file_path(path: str) -> str:
    '''``path`` if unused, else ``stem.N.ext`` with the first free N.'''
    if not os.path.exists(path):
        return path
    stem, ext = os.path.splitext(path)
    i = 1
    while os.path.exists(f'{stem}.{i}{ext}'):
        i += 1
    return f'{stem}.{i}{ext}'
