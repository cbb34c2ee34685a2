'''The port's pipeline runtime (``pipeline/pipeline.py``,
``pipeline_step.py``, ``progress.py``): steps on threads, bounded queues,
end of stream, errors and the timed callback.

Every test that starts a pipeline waits for it with a deadline of its own
(``run``) and fails, rather than hangs, when a step does not finish.
'''
import threading
import time

import pytest

from moseq2_detectron_extract_tpu_torch.pipeline.pipeline import (Pipeline, WorkerError,
                                                                  WorkerErrorInfo)
from moseq2_detectron_extract_tpu_torch.pipeline.pipeline_step import PipelineStep
from moseq2_detectron_extract_tpu_torch.pipeline.progress import ProcessProgress

DEADLINE = 20.0


def run(pipeline: Pipeline, deadline: float = DEADLINE) -> None:
    '''Start, wait until no step is running (at most ``deadline`` s), shut down.'''
    pipeline.start()
    end = time.monotonic() + deadline
    while pipeline.is_running():
        if time.monotonic() > end:
            pipeline.shutdown_event.set()
            pytest.fail(f'the pipeline did not finish in {deadline} s')
        time.sleep(0.01)
    pipeline.shutdown(timeout=2.0)
    assert not any(step.is_alive() for step in pipeline.steps)


class Numbers(PipelineStep):
    def generate(self):
        for i in range(self.config['n']):
            self.update_progress()
            yield {'i': i}


class AddOne(PipelineStep):
    def process(self, data):
        if self.config.get('jitter'):
            time.sleep(0.001 * (data['i'] % 3))
        data = dict(data, i=data['i'] + 1)
        self.update_progress()
        return data


class Collect(PipelineStep):
    def initialize(self):
        self.items = []
        self.finalized = False

    def process(self, data):
        self.items.append(data['i'])

    def finalize(self):
        self.finalized = True


class Fails(PipelineStep):
    def process(self, data):
        if data['i'] == self.config['at']:
            raise RuntimeError(f'bad item {data["i"]}')
        return data


def test_order_is_kept_through_a_chain():
    p = Pipeline(queue_size=2, show_progress=False)
    src = p.add_step('src', Numbers, config={'n': 50})
    steps = [p.add_step(f'add{k}', AddOne, config={'jitter': True}) for k in range(3)]
    sink = p.add_step('sink', Collect, config={})
    p.link(src, steps[0])
    p.link(steps[0], steps[1])
    p.link(steps[1], steps[2])
    p.link(steps[2], sink)
    run(p)
    assert sink.items == [i + 3 for i in range(50)]
    assert [s.items_processed for s in p.steps] == [50, 50, 50, 50, 50]
    assert p.progress.get_stats('src')['completed'] == 50


def test_fan_out_gives_every_consumer_every_item_in_order():
    p = Pipeline(queue_size=1, show_progress=False)
    src = p.add_step('src', Numbers, config={'n': 30})
    a = p.add_step('a', Collect, config={})
    b = p.add_step('b', AddOne, config={})
    c = p.add_step('c', Collect, config={})
    p.link(src, a, b)
    p.link(b, c)
    run(p)
    assert a.items == list(range(30))
    assert c.items == list(range(1, 31))


def test_end_of_stream_reaches_every_step():
    p = Pipeline(show_progress=False)
    src = p.add_step('src', Numbers, config={'n': 0})
    mid = p.add_step('mid', AddOne, config={})
    sinks = [p.add_step(f'sink{k}', Collect, config={}) for k in range(2)]
    p.link(src, mid)
    p.link(mid, *sinks)
    run(p)
    assert all(s.finalized and s.items == [] for s in sinks)
    assert all(step.is_complete.is_set() for step in p.steps)


def test_a_failing_step_raises_worker_error_with_its_traceback():
    p = Pipeline(queue_size=2, show_progress=False)
    src = p.add_step('src', Numbers, config={'n': 10_000})
    bad = p.add_step('  bad step', Fails, config={'at': 5})
    sink = p.add_step('sink', Collect, config={})
    p.link(src, bad)
    p.link(bad, sink)
    p.start()
    end = time.monotonic() + DEADLINE
    while p.is_running():
        assert time.monotonic() < end, 'the pipeline did not stop after the failure'
        time.sleep(0.01)
    with pytest.raises(WorkerError) as info:
        p.shutdown(timeout=2.0)
    errors = info.value.error_info
    assert [e.name for e in errors] == ['  bad step']
    assert isinstance(errors[0], WorkerErrorInfo)
    assert 'RuntimeError: bad item 5' in errors[0].message and 'Traceback' in errors[0].message
    assert p.shutdown_event.is_set()
    assert not any(step.is_alive() for step in p.steps)
    assert src.items_processed < 10_000
    assert len(sink.items) <= 5 and sink.items == list(range(len(sink.items)))


def test_a_step_that_fails_to_initialize_stops_the_run():
    class BadInit(AddOne):
        def initialize(self):
            raise ValueError('no model')

    p = Pipeline(show_progress=False)
    src = p.add_step('src', Numbers, config={'n': 100})
    p.link(src, p.add_step('bad', BadInit, config={}))
    with pytest.raises(WorkerError, match='bad'):
        run(p)


def test_timed_callback_runs_and_stops():
    calls = []
    release = threading.Event()

    class Slow(PipelineStep):
        def process(self, data):
            release.wait(5.0)
            return data

    p = Pipeline(show_progress=False)
    src = p.add_step('src', Numbers, config={'n': 1})
    p.link(src, p.add_step('slow', Slow, config={}))
    p.add_timed_callback(0.02, lambda pipe: calls.append(pipe))
    p.add_timed_callback(0.02, lambda pipe: 1 / 0)          # failures are swallowed
    p.start()
    end = time.monotonic() + DEADLINE
    while len(calls) < 3:
        assert time.monotonic() < end, 'the callback did not run'
        time.sleep(0.01)
    release.set()
    while p.is_running():
        assert time.monotonic() < end
        time.sleep(0.01)
    p.shutdown(timeout=2.0)
    assert calls[0] is p
    time.sleep(0.1)
    count = len(calls)
    time.sleep(0.1)
    assert len(calls) == count
    assert not any(cb.is_alive() for cb in p._callbacks)


def test_a_step_has_one_input():
    p = Pipeline(show_progress=False)
    a = p.add_step('a', Numbers, config={'n': 1})
    b = p.add_step('b', Numbers, config={'n': 1})
    c = p.add_step('c', Collect, config={})
    p.link(a, c)
    with pytest.raises(ValueError, match='already has an input'):
        p.link(b, c)


def test_busy_and_cpu_seconds_are_counted():
    class Spin(PipelineStep):
        def process(self, data):
            end = time.thread_time() + 0.01
            while time.thread_time() < end:
                pass
            return data

    p = Pipeline(show_progress=False)
    src = p.add_step('src', Numbers, config={'n': 5})
    spin = p.add_step('spin', Spin, config={})
    p.link(src, spin)
    run(p)
    assert spin.items_processed == 5
    assert spin.cpu_seconds >= 0.05 and spin.busy_seconds >= spin.cpu_seconds * 0.9


def test_progress_counters():
    progress = ProcessProgress(enable=False)
    progress.add('x')
    progress.reset('x', 100)
    progress.update('x', 30)
    progress.update('y', 5)                       # unknown names are ignored
    stats = progress.get_stats('x')
    assert stats['total'] == 100 and stats['completed'] == 30 and stats['elapsed'] >= 0
    assert progress.get_stats('y') is None
    progress.close()


def test_stress_many_threads_with_a_short_switch_interval():
    '''More steps than cores, switching threads every microsecond, all
    counting into one shared progress counter: every item arrives, in order,
    and no update of the counter is lost.'''
    import os
    import sys

    class Counted(AddOne):
        def update_progress(self, n: int = 1):
            self.progress.update('shared', n)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        p = Pipeline(queue_size=1, show_progress=False)
        p.progress.add('shared')
        src = p.add_step('src', Numbers, config={'n': 200})
        steps = [p.add_step(f'add{k}', Counted, config={}) for k in range((os.cpu_count() or 4) + 4)]
        sink = p.add_step('sink', Collect, config={})
        for a, b in zip([src] + steps, steps + [sink]):
            p.link(a, b)
        run(p, deadline=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert sink.items == [i + len(steps) for i in range(200)]
    assert p.progress.get_stats('shared')['completed'] == 200 * len(steps)
