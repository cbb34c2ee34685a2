'''One rank of the data-parallel tests (``tests/test_torch_parallel.py``),
started by ``torch.multiprocessing`` with gloo on the CPU; it holds no test
itself. It imports no JAX: the inputs (config, weights, batch and the
global batch's draws) come in one ``torch.save`` file, and each rank writes
its results to another.

Each rank runs, from the same weights:

* ``dp``: ``make_dp_train_step`` on its half of the batch (rank 1's weights
  are perturbed first, so ``replicate_state`` has to make them rank 0's);
* ``plain``: what a plain DDP step does, each rank's loss its own batch's
  mean and the gradients averaged over the ranks, then the same clip and
  SGD.
'''
import torch
import torch.distributed as dist


def _state(cfg, state_dict):
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
    from moseq2_detectron_extract_tpu_torch.models.train import TrainState, make_optimizer
    model = MaskKeypointRCNN(cfg)
    model.load_state_dict(state_dict, strict=True)
    return TrainState(step=0, model=model, optimizer=make_optimizer(cfg, model))


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.named_parameters()}


def run(rank: int, world: int, store: str, inputs: str, outputs: str) -> None:
    torch.set_num_threads(1)
    from moseq2_detectron_extract_tpu_torch.models.augment import augment_batch
    from moseq2_detectron_extract_tpu_torch.models.train import apply_gradients
    from moseq2_detectron_extract_tpu_torch.parallel import (make_dp_train_step, make_mesh,
                                                            replicate_state, shard_batch)
    from moseq2_detectron_extract_tpu_torch.parallel.data_parallel import _rows

    data = torch.load(inputs, weights_only=False)
    cfg = data['cfg']
    mesh = make_mesh(rank, world, 'cpu', store_path=store)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(mesh, data['batch']).items()}
    aug, loss_draws = data['aug'], data['loss']

    state = _state(cfg, data['state_dict'])
    if rank:
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
    state = replicate_state(mesh, state)
    state, metrics = make_dp_train_step(cfg, mesh)(state, batch, (aug, loss_draws))

    plain = _state(cfg, data['state_dict'])
    b = batch['image'].shape[0]
    lo, hi = rank * b, (rank + 1) * b
    images, gt = augment_batch(_rows(aug, lo, hi), batch['image'], batch['masks'],
                               batch['keypoints'], batch['valid'], cfg)
    losses = plain.model.losses(images, gt, _rows(loss_draws, lo, hi))
    losses['total_loss'].backward()
    for p in plain.model.parameters():
        if p.grad is not None:
            dist.all_reduce(p.grad)
            p.grad /= world
    plain_metrics = {}
    for key, value in losses.items():
        value = value.detach().clone()
        dist.all_reduce(value)
        plain_metrics[key] = value / world
    apply_gradients(plain, cfg)

    torch.save({'params': _params(state), 'metrics': metrics, 'step': state.step,
                'plain_params': _params(plain), 'plain_metrics': plain_metrics},
               outputs.format(rank))
    dist.destroy_process_group()
