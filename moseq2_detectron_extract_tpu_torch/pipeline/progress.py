'''Per-step progress counters.

Port of ``moseq2_detectron_extract_tpu/pipeline/progress.py``: the same
``add``, ``reset``, ``update``, ``get_stats`` and ``close``, without tqdm
(the card's machine has none): it keeps the counters that
``extract.log_processing_status`` reads and draws no bars.
'''
import threading
import time
from typing import Dict, Optional


class ProcessProgress:
    '''One counter (total, completed, start time) per pipeline step.'''

    def __init__(self, enable: bool = True):
        self.enable = enable
        self._stats: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def add(self, name: str, total: Optional[int] = None, show: bool = True):
        '''Register a step.'''
        with self._lock:
            self._stats[name] = {'total': total, 'completed': 0, 'start': time.time()}

    def reset(self, name: str, total: int):
        '''Set a step's total.'''
        with self._lock:
            if name in self._stats:
                self._stats[name]['total'] = total

    def update(self, name: str, n: int = 1):
        '''Advance a step's count of completed items.'''
        with self._lock:
            if name in self._stats:
                self._stats[name]['completed'] += n

    def get_stats(self, name: str) -> Optional[dict]:
        '''``total``, ``completed`` and ``elapsed`` seconds of a step.'''
        with self._lock:
            stats = self._stats.get(name)
            if stats is None:
                return None
            return {'total': stats['total'], 'completed': stats['completed'],
                    'elapsed': time.time() - stats['start']}

    def close(self):
        '''Nothing to close without bars; kept for the reference's interface.'''
