'''The arithmetic of the readers of the program's own spans: the closed
spans of the program's recorder (``utils/profiling.py``) whose host start
lies in the run's window, ``[window_start, window_start + window_s]`` on
``time.perf_counter``. Each returns None where the run has no window, the
program has no recorder, or no span of the name fell in the window.'''
import statistics
from typing import Dict, List, Optional


def window_spans(out, name: str) -> Optional[List[Dict]]:
    '''The window's closed spans named ``name``, or None.'''
    window = out.observed.get('window_s')
    if not window:
        return None
    try:
        from moseq2_detectron_extract_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, 'spans', None)
    if read is None:
        return None
    found = read(out.window_start, out.window_start + window, name)
    return found or None


def values(out, name: str, key: str) -> Optional[List[float]]:
    '''``key`` (``host_ms``, ``device_ms``, ``cpu_ms``) of each window span
    named ``name`` that has it, or None.'''
    found = window_spans(out, name)
    got = [s[key] for s in found or () if s.get(key) is not None]
    return got or None


def median(out, name: str, key: str) -> Optional[float]:
    '''The median of ``key`` over the window's spans named ``name``.'''
    got = values(out, name, key)
    return None if got is None else statistics.median(got)


def p90(out, name: str, key: str) -> Optional[float]:
    '''The 90th percentile of ``key`` over the window's spans named
    ``name`` (linear between the closest ranks).'''
    got = values(out, name, key)
    if got is None:
        return None
    if len(got) == 1:
        return got[0]
    return statistics.quantiles(got, n=10, method='inclusive')[-1]


def total_per(out, name: str, key: str, per: str) -> Optional[float]:
    '''The window's total of ``key`` over spans named ``name``, divided by
    the number of the window's spans named ``per``.'''
    got = values(out, name, key)
    count = window_spans(out, per)
    if got is None or count is None:
        return None
    return sum(got) / len(count)
