'''A device trace of a stretch of work, reduced to what the metrics read.

``traced(fn)`` runs ``fn`` under ``torch.profiler`` with CUDA activity
only, synchronises, and returns a :class:`Trace`: the length of the traced
window on the host clock, the seconds in which some operation ran on the
device (the union of kernel, copy and set intervals) and device seconds by
operation name. Recording the host's operators too slows a launch-bound
host by about half, which would read as device idle time, so
``host_gaps(fn)`` runs ``fn`` once more with CPU activity on, only to name
the idle gaps by what the host was doing when each began (the innermost
host event open at that moment, or "host Python" when none was).
'''
import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)

    def kernel_seconds(self, fragment: str) -> Tuple[float, int]:
        '''Device seconds and launches of the operations whose name holds
        ``fragment``.'''
        keys = [k for k in self.device_s if fragment in k]
        return sum(self.device_s[k] for k in keys), sum(self.launches[k] for k in keys)

    def breakdown(self) -> Dict[str, List]:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {'device_ops': [[k[:160], v] for k, v in ops],
                'idle_gaps': [[k[:160], v] for k, v in gaps]}


def _profile(fn: Callable[[], None], host: bool):
    cuda = torch.cuda.is_available()
    acts = ([torch.profiler.ProfilerActivity.CUDA] if cuda else []) + \
        ([torch.profiler.ProfilerActivity.CPU] if host or not cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return reduce_events(prof.profiler.kineto_results.events(), window)


def traced(fn: Callable[[], None]) -> Trace:
    '''Run ``fn`` under the profiler (device activity) and reduce its trace.'''
    return _profile(fn, host=False)


def host_gaps(fn: Callable[[], None]) -> Dict[str, float]:
    '''Run ``fn`` under the profiler with the host's operators recorded, and
    return its idle gaps by host activity.'''
    return _profile(fn, host=True).idle_by_host


def reduce_events(events, window_s: float) -> Trace:
    '''The trace's device intervals and their gaps against the host events.'''
    device, host = [], []
    for e in events:
        kind = str(e.device_type())
        if kind.endswith('CUDA'):
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif kind.endswith('CPU') and e.duration_ns() > 0:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    trace = Trace(window_s=window_s, busy_s=0.0)
    for start, end, name in device:
        trace.device_s[name] = trace.device_s.get(name, 0.0) + (end - start) * 1e-9
        trace.launches[name] = trace.launches.get(name, 0) + 1
    device.sort()
    host.sort()
    starts = [h[0] for h in host]
    busy_ns = 0
    cur_s = cur_e = None
    gaps = []
    for start, end, _ in device:
        if cur_e is None:
            cur_s, cur_e = start, end
        elif start > cur_e:
            busy_ns += cur_e - cur_s
            gaps.append((cur_e, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    trace.busy_s = busy_ns * 1e-9
    for g0, g1 in gaps:
        label = 'host Python'
        i = bisect.bisect_right(starts, g0) - 1
        # the innermost open host event: the latest start that still covers g0
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] > g0:
                label = host[j][2]
                break
        trace.idle_by_host[label] = trace.idle_by_host.get(label, 0.0) + (g1 - g0) * 1e-9
    return trace
