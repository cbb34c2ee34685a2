'''A pipeline step: initialize, process and finalize on a thread of its own.

Port of ``moseq2_detectron_extract_tpu/pipeline/pipeline_step.py`` (lines
15-127). A step takes dicts from its input queue, processes them and puts
each result on every output queue; a producer step (no input queue) drives
``generate()`` instead. ``None`` on a queue ends the stream, and passes on
downstream. A step that raises keeps its traceback in ``error_info`` and
sets the pipeline's shutdown event, which stops every step. Each item a
step makes or processes is the root span ``stage.<step name>``.
'''
import logging
import queue
import threading
import time
import traceback
from typing import List, Optional

import torch

from moseq2_detectron_extract_tpu_torch.utils.profiling import span


class PipelineStep(threading.Thread):
    '''One stage of the pipeline, run on its own thread.'''

    def __init__(self, step_name: str, config: dict, progress=None,
                 show_progress: bool = False, **kwargs):
        super().__init__(name=step_name, daemon=True)
        self.step_name = step_name
        self.config = config
        self.input_queue: Optional[queue.Queue] = None
        self.output_queues: List[queue.Queue] = []
        self.shutdown_event: Optional[threading.Event] = None
        self.progress = progress
        self.show_progress = show_progress
        self.is_complete = threading.Event()
        self.error_info: Optional[str] = None
        # wall seconds in process()/generate(), and the host CPU seconds this
        # thread used meanwhile (time.thread_time): waits on the device or
        # on a lock count in the first only
        self.busy_seconds = 0.0
        self.cpu_seconds = 0.0
        self.items_processed = 0
        self.span_name = 'stage.' + step_name.strip()
        # the CUDA device the thread makes current (Pipeline.start gives the
        # starting thread's), so that launches without a tensor's device
        # follow the session's card
        self.cuda_device: Optional[int] = None

    # -- hooks ---------------------------------------------------------------
    def initialize(self):
        '''Called once on the step's thread before the first item.'''

    def process(self, data):
        '''Transform one item; return the result to pass on (None: nothing).'''
        raise NotImplementedError

    def finalize(self):
        '''Called once after the input stream has ended.'''

    def generate(self):
        '''A producer step yields its items here.'''
        return iter(())

    # -- progress ------------------------------------------------------------
    def reset_progress(self, total: int):
        if self.progress is not None:
            self.progress.reset(self.step_name, total)

    def update_progress(self, n: int = 1):
        if self.progress is not None:
            self.progress.update(self.step_name, n)

    def write_message(self, message: str, level: int = logging.INFO):
        '''Log a message attributed to this step.'''
        logging.log(level, '[%s] %s', self.step_name.strip(), message)

    # -- running -------------------------------------------------------------
    def _forward(self, data):
        for out_q in self.output_queues:
            while self.shutdown_event is None or not self.shutdown_event.is_set():
                try:
                    out_q.put(data, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def run(self):
        if self.cuda_device is None:
            self._run()
        else:
            with torch.cuda.device(self.cuda_device):
                self._run()

    def _run(self):
        try:
            self.initialize()
            if self.input_queue is None:
                gen = self.generate()
                while not self.shutdown_event.is_set():
                    t0, c0 = time.perf_counter(), time.thread_time()
                    try:
                        with span(self.span_name):
                            item = next(gen)
                    except StopIteration:
                        break
                    self.busy_seconds += time.perf_counter() - t0
                    self.cpu_seconds += time.thread_time() - c0
                    self.items_processed += 1
                    self._forward(item)
            else:
                while not self.shutdown_event.is_set():
                    try:
                        data = self.input_queue.get(timeout=0.25)
                    except queue.Empty:
                        continue
                    if data is None:
                        break
                    t0, c0 = time.perf_counter(), time.thread_time()
                    with span(self.span_name):
                        result = self.process(data)
                    self.busy_seconds += time.perf_counter() - t0
                    self.cpu_seconds += time.thread_time() - c0
                    self.items_processed += 1
                    if result is not None:
                        self._forward(result)
            self.finalize()
            if self.items_processed:
                logging.info('[%s] %.2fs busy over %d chunks (%.2fs/chunk)',
                             self.step_name.strip(), self.busy_seconds, self.items_processed,
                             self.busy_seconds / self.items_processed,
                             extra={'nostream': True})
            self._forward(None)
        except Exception:  # noqa: BLE001 - a step's failure surfaces as WorkerError
            self.error_info = traceback.format_exc()
            if self.shutdown_event is not None:
                self.shutdown_event.set()
        finally:
            self.is_complete.set()
