'''The process group data-parallel training runs over.

Port of ``moseq2_detectron_extract_tpu/parallel/mesh.py:make_mesh``. The
JAX package lays one mesh axis over the local devices of one program; the
port runs one process per device instead, joined by a ``torch.distributed``
process group: NCCL between CUDA devices, gloo between CPU processes. Its
address is the caller's: a ``FileStore`` path or an ``init_method`` such as
``tcp://localhost:<port>``. Nothing is read from the environment.
'''
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from moseq2_detectron_extract_tpu_torch.device import resolve_device


class Mesh(NamedTuple):
    '''One rank's place in the default process group: ``world`` processes,
    this one ``rank``, and its ``device``.'''
    world: int
    rank: int
    device: torch.device


def make_mesh(rank: int, world: int, device='cuda', store_path: Optional[str] = None,
              init_method: Optional[str] = None) -> Mesh:
    '''Join (or make) the default process group as ``rank`` of ``world``.

    ``device`` names this rank's device: ``'cuda'`` takes card ``rank``
    (``'cuda:N'`` card N), with NCCL; ``'cpu'`` uses gloo. It raises when
    CUDA is asked for and absent. Exactly one of ``store_path`` (a
    ``FileStore`` file every rank can reach; it must not hold an earlier
    group's) and ``init_method`` is given. A group already made is reused
    when its world and rank agree.
    '''
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', rank)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            raise RuntimeError(f'a process group of world {dist.get_world_size()}, rank '
                               f'{dist.get_rank()} exists; asked for {world}, {rank}')
        return Mesh(world, rank, dev)
    if (store_path is None) == (init_method is None):
        raise ValueError('give exactly one of store_path and init_method')
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    kwargs = {'backend': backend, 'world_size': world, 'rank': rank}
    if store_path is not None:
        kwargs['store'] = dist.FileStore(store_path, world)
    else:
        kwargs['init_method'] = init_method
    if dev.type == 'cuda':
        kwargs['device_id'] = dev
    dist.init_process_group(**kwargs)
    return Mesh(world, rank, dev)
