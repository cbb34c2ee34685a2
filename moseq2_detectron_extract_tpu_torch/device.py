'''Device selection: CUDA by default, the CPU only when asked for.'''
import torch


def resolve_device(device='cuda') -> torch.device:
    '''``device`` as a ``torch.device``; raises if CUDA is asked for and absent.

    There is no silent fall back to the CPU: a caller that wants the CPU
    (the tests) says so with ``device='cpu'``.
    '''
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device!r} requested but torch.cuda.is_available() is '
            "False; pass device='cpu' to run on the CPU")
    return dev
