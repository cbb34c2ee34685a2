'''Several sessions extracted at once, on threads of one process, one
device per session.

Port of ``moseq2_detectron_extract_tpu/parallel/sessions.py`` (lines
1-92). Each device gets its own copy of the Predictor
(``Predictor.to_device``); each session runs ``extract.extract_session`` on
a thread of its own, under ``torch.cuda.device`` of its card, so that the
kernels launched through ``ctypes`` and the current stream follow it. The
sessions take the devices in turn (round robin) and at most
``max_concurrent`` run at once. A session that fails is logged and left
out of the result.

What the sessions' threads share is made safe for it: the kernels' launch
and sync counts count under a lock (``ops/clean_kernel.py``,
``ops/roi_align_kernel.py``, ``ops/nms.py``), the host allocator is tuned
once under a lock (``utils/hostmem.py``), each session's log file takes
only its own threads' records (``io/util.py:set_log_owner``, which the
pipeline's step threads inherit), and the native libraries load once under
a lock (``native.py``). ``torch.backends.cudnn.deterministic`` is one
setting of the process: set it, if at all, before the sessions start. Two
sessions on one card share its default stream; each session's output is
the same as that session's alone.
'''
import logging
import threading
from copy import deepcopy
from typing import Dict, List, Optional, Sequence

import torch

from moseq2_detectron_extract_tpu_torch.device import resolve_device
from moseq2_detectron_extract_tpu_torch.io.util import detach_file_logger, set_log_owner


def _build_device_predictors(config: dict, devices) -> list:
    '''One Predictor per device: ``config['predictor']``, or the model dir's
    weights loaded once on the host, copied to each device. The given
    Predictor is left where it is.'''
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor

    base = config.get('predictor')
    if base is None:
        base = Predictor.from_model_dir(
            config['model'], checkpoint=str(config.get('checkpoint', 'last')),
            batch_size=config.get('batch_size', 10),
            score_threshold=config.get('instance_threshold'), device='cpu')
    return [base.to_device(dev) for dev in devices]


def default_devices() -> List[torch.device]:
    '''Every CUDA device; raises when there is none (the CPU is used only
    when the caller names it).'''
    if not torch.cuda.is_available():
        raise RuntimeError('extract_sessions_sharded needs CUDA devices, and '
                           'torch.cuda.is_available() is False; pass devices=["cpu"] '
                           'to run on the CPU')
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def extract_sessions_sharded(session_paths: Sequence[str], config: dict,
                             devices: Optional[Sequence] = None,
                             max_concurrent: Optional[int] = None) -> Dict[str, str]:
    '''Extract several sessions at once; returns {session path: status YAML
    path} for each session that ran (a failed one is logged and left out).

    ``config`` is the extract command's config; each session gets a copy
    with its own ``output_dir`` (``proc`` beside the session), ``device``
    and Predictor. ``devices`` (default: every CUDA device) are taken in
    turn; ``max_concurrent`` sessions run at once (default: one per
    device).
    '''
    from moseq2_detectron_extract_tpu_torch.extract import extract_session
    from moseq2_detectron_extract_tpu_torch.io.session import Session

    devices = default_devices() if devices is None else [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError('no devices to extract on')
    max_concurrent = max_concurrent or len(devices)
    predictors = _build_device_predictors(config, devices)
    results: Dict[str, str] = {}
    lock = threading.Lock()
    sem = threading.Semaphore(max_concurrent)

    def run_one(idx: int, path: str):
        with sem:
            slot = idx % len(devices)
            device = devices[slot]
            session_config = deepcopy({k: v for k, v in config.items()
                                       if k not in ('predictor', 'output_dir')})
            session_config.update(output_dir=None, device=str(device),
                                  predictor=predictors[slot])
            set_log_owner(path)
            try:
                if device.type == 'cuda':
                    with torch.cuda.device(device):
                        status = _run(path, session_config)
                else:
                    status = _run(path, session_config)
                with lock:
                    results[path] = status
            except Exception:  # noqa: BLE001 - one failed session must not end the others
                logging.error('session %s failed', path, exc_info=True)
            finally:
                detach_file_logger()

    def _run(path: str, session_config: dict) -> str:
        session = Session(path, frame_trim=session_config.get('frame_trim', (0, 0)))
        return extract_session(session, session_config)

    threads = [threading.Thread(target=run_one, args=(i, p), daemon=True)
               for i, p in enumerate(session_paths)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results
