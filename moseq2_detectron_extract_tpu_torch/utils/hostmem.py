'''Host allocator tuning for the streaming extraction.

Port of ``moseq2_detectron_extract_tpu/utils/hostmem.py`` (lines 26-43).
glibc's malloc serves blocks above ``M_MMAP_THRESHOLD`` (128 KB by default)
with fresh ``mmap`` regions and gives them back on free, so a pipeline that
allocates and frees chunk-sized host buffers every chunk pays a new
page-fault pass each time. Raising ``M_MMAP_THRESHOLD`` and
``M_TRIM_THRESHOLD`` keeps those blocks in the heap and their pages warm; it
costs only the resident high-water mark.
'''
import ctypes
import ctypes.util
import logging
import threading

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done = False
_lock = threading.Lock()


def tune_host_allocator(threshold_bytes: int = 1 << 30) -> bool:
    '''Keep freed blocks up to ``threshold_bytes`` in the heap for reuse.
    Idempotent, and safe to call from several sessions' threads at once;
    True when ``mallopt`` took both thresholds.'''
    with _lock:
        return _tune(threshold_bytes)


def _tune(threshold_bytes: int) -> bool:
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library('c') or 'libc.so.6', use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)
        _done = bool(ok1 and ok2)
        if not _done:
            logging.debug('mallopt rejected the allocator thresholds')
        return _done
    except (OSError, AttributeError):  # not glibc
        logging.debug('host allocator tuning unavailable', exc_info=True)
        return False
