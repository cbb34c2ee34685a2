'''Profiling hooks: a cProfile of the whole process, a ``torch.profiler``
trace, and per-stage wall times.

Port of ``moseq2_detectron_extract_tpu/utils/profiling.py``.
``enable_profiling`` is the ``MOSEQ_DETECTRON_PROFILE`` hook of the CLI;
``torch_trace`` stands where the reference's ``jax_trace`` captures a
``jax.profiler`` trace.
'''
import atexit
import cProfile
import io
import logging
import os
import pstats
import threading
import time
from contextlib import contextmanager

_PROFILER = None
_LOCK = threading.Lock()


def enable_profiling(output_prefix: str = 'profiling_stats') -> None:
    '''Profile the whole process with cProfile; at exit write
    ``<prefix>.prof_stats`` (``pstats`` data) and ``<prefix>.txt`` (the 60
    functions of most cumulative time). A second call does nothing.'''
    global _PROFILER
    with _LOCK:
        if _PROFILER is not None:
            return
        _PROFILER = cProfile.Profile()
    _PROFILER.enable()
    atexit.register(_dump_profile, _PROFILER, output_prefix)


def _dump_profile(profiler: cProfile.Profile, output_prefix: str) -> None:
    profiler.disable()
    profiler.dump_stats(output_prefix + '.prof_stats')
    stream = io.StringIO()
    pstats.Stats(profiler, stream=stream).sort_stats('cumulative').print_stats(60)
    with open(output_prefix + '.txt', 'w', encoding='utf-8') as fh:
        fh.write(stream.getvalue())
    logging.info('profiling stats written to %s.txt', output_prefix)


@contextmanager
def torch_trace(log_dir: str, cuda: bool = True):
    '''Trace the CPU (and with ``cuda``, the CUDA device's) activity of the
    block with ``torch.profiler`` and write it to
    ``<log_dir>/trace.json`` (Chrome trace format): the counterpart of the
    reference's ``jax_trace``, which writes a TensorBoard trace.'''
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class StageTimer:
    '''Wall time per named stage: the sum and the count of each stage's
    occurrences.'''

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextmanager
    def time(self, name: str):
        '''Time one occurrence of a stage.'''
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        '''Mean seconds per stage.'''
        return {name: self.totals[name] / max(self.counts[name], 1) for name in self.totals}
