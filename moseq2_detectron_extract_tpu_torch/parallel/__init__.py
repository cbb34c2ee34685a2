'''Scale-out: a process group, data-parallel training, and several
sessions extracted at once on threads, one device per session.

Port of ``moseq2_detectron_extract_tpu/parallel/``: the JAX package's
device mesh becomes a ``torch.distributed`` process group
(``mesh.make_mesh``), its sharded train step one process per rank with the
gradients all-reduced (``data_parallel``), and its per-chip sessions one
Predictor per CUDA device (``sessions``).
'''
from moseq2_detectron_extract_tpu_torch.parallel.data_parallel import (make_dp_train_step,
                                                                       replicate_state,
                                                                       shard_batch)
from moseq2_detectron_extract_tpu_torch.parallel.mesh import Mesh, make_mesh
from moseq2_detectron_extract_tpu_torch.parallel.sessions import extract_sessions_sharded

__all__ = ['Mesh', 'make_mesh', 'make_dp_train_step', 'replicate_state', 'shard_batch',
           'extract_sessions_sharded']
