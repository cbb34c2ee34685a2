'''Profiling hooks: the port's recorder of spans and counters, a cProfile of
the whole process, a ``torch.profiler`` trace, and per-stage wall times.

Port of ``moseq2_detectron_extract_tpu/utils/profiling.py``.
``enable_profiling`` is the ``MOSEQ_DETECTRON_PROFILE`` hook of the CLI;
``torch_trace`` stands where the reference's ``jax_trace`` captures a
``jax.profiler`` trace.

The recorder is always on. ``span(name)`` times a stretch of the program
on the host's ``time.perf_counter_ns`` clock and, on a thread that uses a
CUDA device, between two timing events on the current stream; the events
are read once they have completed, never by a synchronise on the way. A
span opened with no span open on its thread is a root: it starts a group
(``root``, its own id) that the spans opened inside it share. ``count``
adds to a named counter and credits the innermost open span. Closed spans
go into a ring of ``RING_SPANS``, so a long run holds constant memory;
``spans(start, end)`` reads the closed spans whose host start lies in a
``time.perf_counter`` interval.
'''
import atexit
import cProfile
import io
import itertools
import json
import logging
import os
import pstats
import statistics
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch

RING_SPANS = 1 << 16
# span pairs of events waiting for their stream; past this many a span
# records no device time
MAX_PENDING = 4096
# pending spans looked at when a span closes
RESOLVE_PER_CLOSE = 4

_PROFILER = None
_LOCK = threading.Lock()
_NULL = nullcontext()


class Span:
    '''One span: open while its ``with`` block runs, then a closed record.'''

    __slots__ = ('recorder', 'name', 'device', 'cpu', 'indexed', 'id', 'parent', 'root',
                 'batch', 'thread', 'start_ns', 'end_ns', 'cpu_ns', 'child_ns', 'counters',
                 'events', 'device_ms', 'next_batch', 'annotation', 'up')

    def __init__(self, recorder: 'Recorder', name: str, device: bool, cpu: bool,
                 indexed: bool):
        self.recorder = recorder
        self.name = name
        self.device = device
        self.cpu = cpu
        self.indexed = indexed
        self.counters = None
        self.events = None
        self.device_ms = None
        self.annotation = None
        self.cpu_ns = None
        self.child_ns = 0
        self.next_batch = 0

    def place(self):
        '''Give the span its id, thread, parent, root and batch from the
        thread's innermost open span; returns the thread's open spans.'''
        rec = self.recorder
        stack, self.thread = rec.thread_stack()
        up = stack[-1] if stack else None
        self.up = up
        self.id = next(rec.ids)
        if up is None:
            self.parent, self.root, self.batch = None, self.id, None
        else:
            self.parent, self.root, self.batch = up.id, up.root, up.batch
        return stack

    def __enter__(self):
        rec = self.recorder
        stack = self.place()
        up = self.up
        if self.indexed:
            if up is None:
                self.batch = 0
            else:
                self.batch = up.next_batch
                up.next_batch += 1
        stack.append(self)
        if self.cpu:
            self.cpu_ns = time.thread_time_ns()
        if self.device and torch.cuda.is_initialized() and len(rec.pending) < MAX_PENDING:
            self.events = rec.event_pair()
            self.events[0].record()
        if rec.annotating:
            self.annotation = torch.autograd.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        rec = self.recorder
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
            self.annotation = None
        if self.events is not None:
            try:
                self.events[1].record()
            except RuntimeError:                # the block left the device it began on
                rec.release(self.events)
                self.events = None
        if self.cpu:
            self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        stack, _ = rec.thread_stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.up is not None:
            self.up.child_ns += self.end_ns - self.start_ns
            self.up = None
        rec.ring.append(self)
        if self.events is not None:
            rec.pending.append(self)
        if rec.pending:
            rec.resolve(RESOLVE_PER_CLOSE)
        return False

    def as_dict(self) -> Dict:
        host_ns = self.end_ns - self.start_ns
        return {'name': self.name, 'id': self.id, 'parent': self.parent, 'root': self.root,
                'batch': self.batch, 'thread': self.thread, 'start_s': self.start_ns * 1e-9,
                'host_ms': host_ns * 1e-6, 'self_ms': (host_ns - self.child_ns) * 1e-6,
                'device_ms': self.device_ms,
                'cpu_ms': None if self.cpu_ns is None else self.cpu_ns * 1e-6,
                'counters': dict(self.counters) if self.counters else {}}


class Recorder:
    '''The spans and counters of one process, thread safe. The module's
    functions use the one instance ``RECORDER``.'''

    def __init__(self, capacity: int = RING_SPANS):
        self.ring = deque(maxlen=capacity)
        self.pending = deque()
        self.ids = itertools.count(1)
        self.totals: Dict[str, int] = {}
        self.annotating = 0
        self._local = threading.local()
        self._pools: Dict[int, List] = {}
        self._count_lock = threading.Lock()
        self._resolve_lock = threading.Lock()

    def thread_stack(self):
        '''This thread's open spans and its name.'''
        local = self._local
        try:
            return local.stack, local.name
        except AttributeError:
            local.stack, local.name = [], threading.current_thread().name
            return local.stack, local.name

    def span(self, name: str, device: bool = True, cpu: bool = False, indexed: bool = False):
        '''A context manager that records the block as span ``name``.
        ``device`` False records no device time (a host thread); ``cpu``
        records the thread's CPU time (``time.thread_time``); ``indexed``
        numbers the span among its parent's indexed children (``batch``,
        which the spans inside it inherit). Does nothing while
        ``torch.export`` or ``torch.compile`` traces.'''
        if torch.compiler.is_exporting() or torch.compiler.is_compiling():
            return _NULL
        return Span(self, name, device, cpu, indexed)

    def record(self, name: str, start_ns: int, end_ns: int) -> None:
        '''A span closed already: ``[start_ns, end_ns)`` on
        ``time.perf_counter_ns``, a child of the innermost open span, with
        no device time.'''
        if torch.compiler.is_exporting() or torch.compiler.is_compiling():
            return
        s = Span(self, name, False, False, False)
        s.place()
        if s.up is not None:
            s.up.child_ns += end_ns - start_ns
        s.start_ns, s.end_ns, s.up = start_ns, end_ns, None
        self.ring.append(s)

    def count(self, name: str, n: int = 1) -> None:
        '''Add ``n`` to counter ``name`` and to the innermost open span's.'''
        with self._count_lock:
            self.totals[name] = self.totals.get(name, 0) + n
        stack, _ = self.thread_stack()
        if stack:
            top = stack[-1]
            if top.counters is None:
                top.counters = {}
            top.counters[name] = top.counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        '''Every counter's total since the process began.'''
        with self._count_lock:
            return dict(self.totals)

    def event_pair(self):
        dev = torch.cuda.current_device()
        pool = self._pools.get(dev)
        if pool:
            try:
                return pool.pop()
            except IndexError:
                pass
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), dev)

    def release(self, events) -> None:
        self._pools.setdefault(events[2], []).append(events)

    def _settle(self, s: Span) -> None:
        events, s.events = s.events, None
        try:
            s.device_ms = events[0].elapsed_time(events[1])
        except RuntimeError:
            s.device_ms = None
        self.release(events)

    def resolve(self, budget: Optional[int] = None) -> None:
        '''Read the device time of pending spans whose end event has
        completed, oldest first; ``budget`` None waits for every one.'''
        lock = self._resolve_lock
        if budget is not None and not lock.acquire(blocking=False):
            return
        if budget is None:
            lock.acquire()
        try:
            looked = 0
            while self.pending and (budget is None or looked < budget):
                s = self.pending[0]
                if budget is not None:
                    looked += 1
                    if not s.events[1].query():
                        return
                else:
                    s.events[1].synchronize()
                self.pending.popleft()
                self._settle(s)
        finally:
            lock.release()

    def spans(self, start: Optional[float] = None, end: Optional[float] = None,
              name: Optional[str] = None) -> List[Dict]:
        '''The closed spans whose host start lies in ``[start, end]``
        (``time.perf_counter`` seconds; None: unbounded) in the order they
        closed, each
        as a dict: name, id, parent, root, batch, thread, start_s, host_ms,
        self_ms (less the child spans), device_ms (None without device
        events), cpu_ms (None unless asked for) and the counters credited
        to it. Waits for the device times still pending.'''
        self.resolve()
        lo = None if start is None else int(start * 1e9)
        hi = None if end is None else int(end * 1e9)
        return [s.as_dict() for s in list(self.ring)
                if (lo is None or s.start_ns >= lo) and (hi is None or s.start_ns <= hi)
                and (name is None or s.name == name)]


RECORDER = Recorder()


def span(name: str, device: bool = True, cpu: bool = False, indexed: bool = False):
    '''Record the block as span ``name`` in the process's recorder
    (:meth:`Recorder.span`).'''
    return RECORDER.span(name, device=device, cpu=cpu, indexed=indexed)


def count(name: str, n: int = 1) -> None:
    '''Add ``n`` to the process's counter ``name`` (:meth:`Recorder.count`).'''
    RECORDER.count(name, n)


def spans(start: Optional[float] = None, end: Optional[float] = None,
          name: Optional[str] = None) -> List[Dict]:
    '''The process's closed spans in a ``time.perf_counter`` interval
    (:meth:`Recorder.spans`).'''
    return RECORDER.spans(start, end, name)


def counters() -> Dict[str, int]:
    '''The process's counter totals.'''
    return RECORDER.counters()


def _p90(values: List[float]) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method='inclusive')[-1]


def summarize(records: List[Dict]) -> Dict[str, Dict]:
    '''Spans by name: the count, host and device ms (total, median, p90),
    self ms (total, median) and the counters credited to them.'''
    by_name: Dict[str, List[Dict]] = {}
    for r in records:
        by_name.setdefault(r['name'], []).append(r)
    out = {}
    for name, rs in sorted(by_name.items()):
        row = {'count': len(rs)}
        for key in ('host_ms', 'device_ms', 'self_ms'):
            values = [r[key] for r in rs if r[key] is not None]
            if values:
                row[key] = {'total': sum(values), 'median': statistics.median(values)}
                if key != 'self_ms':
                    row[key]['p90'] = _p90(values)
        counts: Dict[str, int] = {}
        for r in rs:
            for k, v in r['counters'].items():
                counts[k] = counts.get(k, 0) + v
        if counts:
            row['counters'] = counts
        out[name] = row
    return out


def enable_profiling(output_prefix: str = 'profiling_stats') -> None:
    '''Profile the whole process with cProfile; at exit write
    ``<prefix>.prof_stats`` (``pstats`` data), ``<prefix>.txt`` (the 60
    functions of most cumulative time) and ``<prefix>.spans.json`` (the
    recorder's spans by name over the ring, :func:`summarize`, and the
    counters). A second call does nothing.'''
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
    with open(output_prefix + '.spans.json', 'w', encoding='utf-8') as fh:
        json.dump({'spans': summarize(spans()), 'counters': counters()}, fh, indent=1)
    logging.info('profiling stats written to %s.txt', output_prefix)


@contextmanager
def torch_trace(log_dir: str, cuda: bool = True):
    '''Trace the CPU (and with ``cuda``, the CUDA device's) activity of the
    block with ``torch.profiler`` and write it to
    ``<log_dir>/trace.json`` (Chrome trace format): the counterpart of the
    reference's ``jax_trace``, which writes a TensorBoard trace. While the
    block runs, every span also enters the trace as a ``record_function``
    range; at its end ``<log_dir>/spans.json`` holds the block's spans
    (ids, parents, host, device and self ms), their summary by name and the
    counters' increments.'''
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = counters()
    with torch.profiler.profile(activities=activities) as prof:
        with _LOCK:
            RECORDER.annotating += 1
        start = time.perf_counter()
        try:
            yield prof
        finally:
            end = time.perf_counter()
            with _LOCK:
                RECORDER.annotating -= 1
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
    records = spans(start, end)
    after = counters()
    with open(os.path.join(log_dir, 'spans.json'), 'w', encoding='utf-8') as fh:
        json.dump({'clock': 'time.perf_counter', 'window': [start, end],
                   'summary': summarize(records),
                   'counters': {k: v - before.get(k, 0) for k, v in after.items()
                                if v != before.get(k, 0)},
                   'spans': records}, fh, indent=1)


class StageTimer:
    '''Wall time per named stage: the sum and the count of each stage's
    occurrences, each occurrence also a span ``<prefix><stage>``.
    ``stages`` start at zero.'''

    def __init__(self, prefix: str = '', stages=()):
        self.prefix = prefix
        self.totals = {name: 0.0 for name in stages}
        self.counts = {name: 0 for name in stages}
        self._mark = None

    def _add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextmanager
    def time(self, name: str):
        '''Time one occurrence of a stage.'''
        with span(self.prefix + name):
            start = time.perf_counter_ns()
            try:
                yield
            finally:
                self._add(name, (time.perf_counter_ns() - start) * 1e-9)

    def start(self) -> None:
        '''Mark the start of a run of laps.'''
        self._mark = time.perf_counter_ns()

    def lap(self, name: str) -> None:
        '''Time the stretch since the previous lap (or :meth:`start`) as one
        occurrence of a stage.'''
        now = time.perf_counter_ns()
        RECORDER.record(self.prefix + name, self._mark, now)
        self._add(name, (now - self._mark) * 1e-9)
        self._mark = now

    def summary(self) -> dict:
        '''Mean seconds per stage.'''
        return {name: self.totals[name] / max(self.counts[name], 1) for name in self.totals}
