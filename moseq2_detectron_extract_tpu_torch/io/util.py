'''Chunk ranges, timestamps, session metadata, the YAML and HDF5 helpers of
the writers, and logging.

Port of ``moseq2_detectron_extract_tpu/io/util.py`` (``gen_batch_sequence``,
lines 21-34; ``read_yaml``, ``write_yaml`` and ``_sanitize_for_yaml``, 37-64,
on the port's own YAML emitter and reader; ``dict_to_h5``, 67-108, on the
port's HDF5 writer; ``load_timestamps``, 111-132; ``load_metadata``,
135-140; ``ensure_dir``, 143-146; ``find_unused_file_path``, 149-157;
``backup_existing_file``, 160-166;
``setup_logging`` and ``attach_file_logger``, 168-231, with a plain stream
handler where the reference's writes through tqdm, and a log file per
session when several run on threads of one process;
``scan_unextracted_sessions``, ``wrap_command_with_local`` and
``wrap_command_with_slurm``, 233-279).
'''
import json
import logging
import logging.handlers
import os
import threading
import uuid
from typing import IO, Any, Dict, List, Optional, Sequence, Union

import numpy as np

from moseq2_detectron_extract_tpu_torch.io import hdf5, yaml_subset


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


def backup_existing_file(path: str) -> Optional[str]:
    '''Rename ``path``, if it exists, to the first unused ``<path>.bak``
    name (``find_unused_file_path``); returns the new name, or None.'''
    if not os.path.exists(path):
        return None
    backup = find_unused_file_path(path + '.bak')
    os.rename(path, backup)
    return backup


def ensure_dir(path: str) -> str:
    '''Create ``path`` (and parents) if missing.'''
    os.makedirs(path, exist_ok=True)
    return path


def read_yaml(path: str) -> Any:
    '''Read a YAML file (``io.yaml_subset.load``).'''
    with open(path, 'r', encoding='utf-8') as fh:
        return yaml_subset.load(fh.read())


def write_yaml(path: str, data: dict) -> None:
    '''Write a dict to a YAML file, numpy values as Python's.'''
    text = yaml_subset.dump(_sanitize_for_yaml(data))
    with open(path, 'w', encoding='utf-8') as fh:
        fh.write(text)


def _sanitize_for_yaml(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _sanitize_for_yaml(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize_for_yaml(v) for v in value]
    if isinstance(value, np.ndarray):
        return _sanitize_for_yaml(value.tolist())
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, uuid.UUID):
        return str(value)
    return value


def dict_to_h5(h5_file, data: dict, root: str = '',
               annotations: Optional[Dict[str, Any]] = None) -> None:
    '''Write a dict into an HDF5 file (``io.hdf5.File``) under ``root``,
    as the JAX package's ``dict_to_h5`` does with h5py: None as an empty
    f32 dataset, dicts as groups, lists of strings as fixed-length byte
    strings, other lists and arrays as arrays, str as a variable-length
    string, bool, int and float as scalars, anything else as its JSON.
    ``annotations`` maps keys to ``description`` attributes.'''
    if root and not root.endswith('/'):
        root = root + '/'
    if annotations is None:
        annotations = {}
    for key, value in data.items():
        dest = f'{root}{key}'
        try:
            if value is None:
                h5_file.create_dataset(dest, data=hdf5.Empty('f'))
            elif isinstance(value, dict):
                ann = annotations.get(key)
                dict_to_h5(h5_file, value, dest, ann if isinstance(ann, dict) else None)
                continue
            elif isinstance(value, (list, tuple)):
                arr = np.asarray(value)
                if arr.dtype.kind in ('U', 'S', 'O'):
                    arr = np.array([str(v).encode('utf8') for v in value])
                h5_file.create_dataset(dest, data=arr)
            elif isinstance(value, np.ndarray):
                h5_file.create_dataset(dest, data=value)
            elif isinstance(value, (str, bytes)):
                h5_file.create_dataset(dest, data=value)
            elif isinstance(value, (bool, np.bool_)):
                h5_file.create_dataset(dest, data=bool(value))
            elif isinstance(value, (int, float, np.integer, np.floating)):
                h5_file.create_dataset(dest, data=value)
            else:
                h5_file.create_dataset(dest, data=json.dumps(value, default=str))
        except Exception:  # noqa: BLE001 - one bad metadata value must not end a run
            logging.warning('could not write metadata key %s', dest)
            continue
        ann = annotations.get(key)
        if isinstance(ann, str):
            h5_file[dest].attrs['description'] = ann


class StreamHandler(logging.StreamHandler):
    '''A stream handler that leaves out records logged with
    ``extra={'nostream': True}`` (they reach the log file only).'''

    def emit(self, record):
        if record.__dict__.get('nostream', False):
            return
        super().emit(record)


_MEMORY_HANDLER: Optional[logging.handlers.MemoryHandler] = None
_LOG_FORMAT = '%(asctime)s [%(levelname)s] %(message)s'


def setup_logging(level: int = logging.INFO, add_defered_file_handler: bool = False) -> None:
    '''Configure the root logger with a stream handler to stderr. With
    ``add_defered_file_handler`` the records are also kept in memory until
    ``attach_file_logger`` names the run's log file, so the early ones reach
    it too.'''
    global _MEMORY_HANDLER
    root = logging.getLogger()
    root.setLevel(level)
    for handler in list(root.handlers):
        root.removeHandler(handler)
    stream = StreamHandler()
    stream.setFormatter(logging.Formatter('%(message)s'))
    root.addHandler(stream)
    if add_defered_file_handler:
        _MEMORY_HANDLER = logging.handlers.MemoryHandler(capacity=10000,
                                                         flushLevel=logging.CRITICAL + 1)
        _MEMORY_HANDLER.setFormatter(logging.Formatter(_LOG_FORMAT))
        root.addHandler(_MEMORY_HANDLER)


def set_log_owner(owner: Optional[str]) -> None:
    '''Mark the calling thread as working for ``owner`` (a session), so
    that a log file attached in it takes only that owner's records (see
    :func:`attach_file_logger`). Threads started with
    :func:`inherit_log_owner` work for the same owner.'''
    threading.current_thread().log_owner = owner


def log_owner() -> Optional[str]:
    '''The calling thread's owner (:func:`set_log_owner`), or None.'''
    return getattr(threading.current_thread(), 'log_owner', None)


def inherit_log_owner(thread: threading.Thread) -> threading.Thread:
    '''Give a thread that is not started yet the calling thread's owner.'''
    thread.log_owner = log_owner()
    return thread


class _OwnerFilter(logging.Filter):
    '''Passes the records logged by threads working for one owner.'''

    def __init__(self, owner: str):
        super().__init__()
        self.owner = owner

    def filter(self, record):
        return log_owner() == self.owner


def attach_file_logger(log_path: str) -> None:
    '''Log to ``log_path`` (appending), after the records kept in memory.

    In a thread without an owner (:func:`set_log_owner`), the file takes
    every record, and a file handler attached before is closed first, so
    that consecutive sessions in one process do not log into each other's
    files. In a thread with an owner, such as each session of
    ``parallel.sessions``, the file takes only the records of that owner's
    threads, and only that owner's earlier file is closed.'''
    global _MEMORY_HANDLER
    root = logging.getLogger()
    owner = log_owner()
    for handler in list(root.handlers):
        if isinstance(handler, logging.FileHandler) and \
                getattr(handler, 'log_owner', None) == owner:
            root.removeHandler(handler)
            handler.close()
    file_handler = logging.FileHandler(log_path, mode='a', encoding='utf-8')
    file_handler.setFormatter(logging.Formatter(_LOG_FORMAT))
    file_handler.log_owner = owner
    if owner is not None:
        file_handler.addFilter(_OwnerFilter(owner))
    if _MEMORY_HANDLER is not None:
        _MEMORY_HANDLER.setTarget(file_handler)
        _MEMORY_HANDLER.flush()
        root.removeHandler(_MEMORY_HANDLER)
        _MEMORY_HANDLER.close()
        _MEMORY_HANDLER = None
    root.addHandler(file_handler)


def detach_file_logger() -> None:
    '''Close the log file that the calling thread's owner attached.'''
    root = logging.getLogger()
    owner = log_owner()
    for handler in list(root.handlers):
        if isinstance(handler, logging.FileHandler) and \
                getattr(handler, 'log_owner', None) == owner:
            root.removeHandler(handler)
            handler.close()


_SESSION_ARCHIVES = ('.tar.gz', '.tgz')


def _is_port_output(fname: str) -> bool:
    '''An AVI the port writes beside the results: the extract preview
    ``results_NN.avi`` and the previews ``preview.avi`` and
    ``<results>.preview.avi``.'''
    return (fname.startswith('results_') and fname.endswith('.avi')) or \
        fname.endswith('preview.avi')


def scan_unextracted_sessions(input_dir: str, extension: str = '.dat',
                              bg_roi_index: int = 0) -> List[str]:
    '''Session files under ``input_dir`` (sorted) without a completed status:
    a file ending in ``extension`` is extracted when
    ``proc/results_NN.yaml`` beside it says ``complete: true``, a
    ``.tar.gz``/``.tgz`` session when ``<stem>/proc/results_NN.yaml`` does
    (NN: ``bg_roi_index``). With ``extension='.avi'`` the port's own preview
    AVIs are not taken for sessions.'''
    from moseq2_detectron_extract_tpu_torch.proc.util import check_completion_status

    found: List[str] = []
    for root, _dirs, files in os.walk(input_dir):
        for fname in files:
            own = fname.endswith(extension) and not _is_port_output(fname)
            if not (own or fname.endswith(_SESSION_ARCHIVES)):
                continue
            if own:
                status = os.path.join(root, 'proc', f'results_{bg_roi_index:02d}.yaml')
            else:
                stem = fname.replace('.tar.gz', '').replace('.tgz', '')
                status = os.path.join(root, stem, 'proc', f'results_{bg_roi_index:02d}.yaml')
            if not check_completion_status(status):
                found.append(os.path.join(root, fname))
    return sorted(found)


def wrap_command_with_local(commands: Sequence[str], output_path: str) -> List[str]:
    '''The commands as they are, to run one after another on this machine
    (``output_path`` is unused, as in the reference).'''
    del output_path
    return list(commands)


def wrap_command_with_slurm(commands: Sequence[str], prefix: Optional[str] = None,
                            partition: str = 'main', ncpus: int = 4, memory: str = '16GB',
                            wall_time: str = '3:00:00') -> List[str]:
    '''Each command as one ``sbatch --wrap`` job, after ``prefix;`` when
    given.'''
    out = []
    for cmd in commands:
        if prefix:
            cmd = f'{prefix}; {cmd}'
        out.append(f'sbatch --partition {partition} --cpus-per-task {ncpus} '
                   f'--mem {memory} --time {wall_time} --wrap "{cmd}"')
    return out
