'''The pipeline: steps on threads, linked by bounded queues, with a shared
shutdown and the steps' errors gathered.

Port of ``moseq2_detectron_extract_tpu/pipeline/pipeline.py`` (lines
16-106): ``add_step``, ``link`` (a step has one input), timed callbacks,
``start``, ``is_running`` and ``shutdown``, whose join waits at most
``timeout`` seconds a step and raises ``WorkerError`` with each failed
step's traceback. The step threads log for the log owner of the thread
that starts them, so that sessions on threads of one process keep their
own log files.
'''
import logging
import queue
import threading
import time
from typing import Callable, List, NamedTuple, Type

import torch

from moseq2_detectron_extract_tpu_torch.io.util import inherit_log_owner
from moseq2_detectron_extract_tpu_torch.pipeline.pipeline_step import PipelineStep
from moseq2_detectron_extract_tpu_torch.pipeline.progress import ProcessProgress


class WorkerErrorInfo(NamedTuple):
    '''A failed step's name and formatted traceback.'''
    name: str
    message: str


class WorkerError(Exception):
    '''Raised by ``Pipeline.shutdown`` when one or more steps failed.'''

    def __init__(self, error_info: List[WorkerErrorInfo]):
        self.error_info = error_info
        super().__init__('; '.join(e.name for e in error_info))


class _TimedCallback(threading.Thread):
    def __init__(self, interval: float, callback, pipeline):
        super().__init__(daemon=True)
        self.interval = interval
        self.callback = callback
        self.pipeline = pipeline
        self.stop_event = threading.Event()

    def run(self):
        while not self.stop_event.wait(self.interval):
            try:
                self.callback(self.pipeline)
            except Exception:  # noqa: BLE001 - a status line must not end a run
                logging.debug('timed callback failed', exc_info=True)


class Pipeline:
    '''Steps on threads, linked by queues of at most ``queue_size`` items.'''

    def __init__(self, queue_size: int = 2, show_progress: bool = True):
        self.steps: List[PipelineStep] = []
        self.queue_size = queue_size
        self.shutdown_event = threading.Event()
        self.progress = ProcessProgress(enable=show_progress)
        self._callbacks: List[_TimedCallback] = []

    def add_step(self, name: str, step_cls: Type[PipelineStep], show_progress: bool = False,
                 **kwargs) -> PipelineStep:
        '''Make a step and register it.'''
        step = step_cls(step_name=name, progress=self.progress, show_progress=show_progress,
                        **kwargs)
        step.shutdown_event = self.shutdown_event
        self.steps.append(step)
        self.progress.add(name, show=show_progress)
        return step

    def link(self, src: PipelineStep, *dests: PipelineStep) -> None:
        '''Give each of ``dests`` a queue of its own from ``src``.'''
        for dest in dests:
            if dest.input_queue is not None:
                raise ValueError(f'step {dest.step_name} already has an input')
            q: queue.Queue = queue.Queue(maxsize=self.queue_size)
            src.output_queues.append(q)
            dest.input_queue = q

    def add_timed_callback(self, interval: float,
                           callback: Callable[['Pipeline'], None]) -> None:
        '''Call ``callback(pipeline)`` every ``interval`` seconds while running.'''
        self._callbacks.append(_TimedCallback(interval, callback, self))

    def start(self) -> None:
        '''Start the steps and the callbacks, each working for the calling
        thread's log owner (``io.util.inherit_log_owner``); the steps run
        with the calling thread's current CUDA device.'''
        cuda_device = torch.cuda.current_device() if torch.cuda.is_initialized() else None
        for step in self.steps:
            step.cuda_device = cuda_device
            inherit_log_owner(step).start()
        for cb in self._callbacks:
            inherit_log_owner(cb).start()

    def is_running(self) -> bool:
        '''True while a step is still working and none has failed.'''
        if self.shutdown_event.is_set():
            return False
        return not all(step.is_complete.is_set() for step in self.steps)

    def shutdown(self, timeout: float = 3.0) -> None:
        '''Join the steps (at most ``timeout`` seconds a step, 1 at least),
        stop them and the callbacks; raise ``WorkerError`` if a step failed.'''
        deadline = time.time() + max(timeout, 1.0) * max(len(self.steps), 1)
        for step in self.steps:
            step.join(timeout=max(0.1, deadline - time.time()))
        self.shutdown_event.set()
        for cb in self._callbacks:
            cb.stop_event.set()
        self.progress.close()
        errors = [WorkerErrorInfo(step.step_name, step.error_info)
                  for step in self.steps if step.error_info is not None]
        if errors:
            raise WorkerError(errors)
