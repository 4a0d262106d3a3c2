"""Data-parallel training across processes (counterpart of the ``data`` axis of
fiery_tpu/parallel/mesh.py).

The JAX package shards the batch over a 1-D ``data`` mesh, replicates the state,
and lets GSPMD insert the gradient psum and take BatchNorm's statistics over the
global batch. Here each process (a rank, one card each under ``torchrun``) holds a
replica and its share of the batch:
  - the model and the uncertainty weights run inside DistributedDataParallel,
    whose gradient all-reduce averages over the ranks; the clip and Adam then run
    identically on every rank (``make_parallel_trainer``);
  - every BatchNorm takes its statistics over the ranks (kernel K10's synchronised
    path, ops/batch_norm.py; the BatchNorms' ``process_group``);
  - the masked regression losses divide by the global batch's mask count
    (training/losses.py ``spatial_regression_loss``), and the logged losses are
    the global ones;
  - a step's random draws (latent noise, drop-connect) are those of the global
    batch, of which each rank keeps its rows (``RankGenerator``, ``rank_rows``);
  - the loaders read disjoint strided shards of each epoch, and the validation's
    metric states are summed across the ranks before ``compute()`` (``sum_states``).
One process on the whole batch and W ranks on its W shares then take the same
step, up to the order of f32 sums.

    python -m torch.distributed.run --nproc_per_node N -m fiery_tpu_torch.train \
        --config fiery_tpu_torch/configs/baseline.yml ...

cfg.BATCHSIZE is per rank, as the JAX package reads it per chip: the global batch
is BATCHSIZE x world. Not ported yet: the camera axis (``create_mesh(n_model > 1)``,
``batch_shardings``) and the BEV spatial axis (``bev_sharding``).
"""

import os

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from fiery_tpu_torch.utils.device import resolve_device

# the variables torchrun sets for each process it starts
LAUNCH_VARS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR')


def maybe_initialize_distributed(device=None, backend=None):
    """Join the process group that ``torchrun`` describes (its variables
    ``LAUNCH_VARS`` set): NCCL for a CUDA device, gloo for the CPU, unless
    ``backend`` names one (two gloo ranks may share one card). The device is
    ``device`` when given, else ``cuda:LOCAL_RANK``; without the variables it is
    ``resolve_device(device)`` and no group is made. Returns the device."""
    if not all(v in os.environ for v in LAUNCH_VARS):
        return resolve_device(device)
    local_rank = int(os.environ['LOCAL_RANK'])
    device = resolve_device(f'cuda:{local_rank}' if device is None else device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ('nccl' if device.type == 'cuda' else 'gloo'),
                                rank=int(os.environ['RANK']),
                                world_size=int(os.environ['WORLD_SIZE']))
    return device


def rank_and_world(group=None):
    """(rank, world size) in ``group`` (the default group), (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class RankGenerator(torch.Generator):
    """A training step's generator on one of ``world`` ranks: each draw of the
    model's is that of the global batch (``world`` times the rank's rows, from this
    one stream), of which the rank keeps its own rows (``rank_rows``), so that the
    ranks together draw what one process on the whole batch draws."""

    def __new__(cls, device, rank, world):
        return super().__new__(cls, device=device)

    def __init__(self, device, rank, world):
        self.rank, self.world = rank, world


def rank_rows(t, rows, rank):
    """Rows [rank rows, (rank + 1) rows) of t along dim 0: rank ``rank``'s share of
    a global-batch tensor."""
    return t[rank * rows:(rank + 1) * rows]


def draw_batch(fn, shape, generator, device):
    """fn(shape, generator=generator, device=device), fn ``torch.rand`` or
    ``torch.randn`` with shape[0] the rank's rows; under a ``RankGenerator`` the
    global batch's draw, of which the rank's rows are returned."""
    world = getattr(generator, 'world', 1)
    if world == 1:
        return fn(shape, generator=generator, device=device)
    full = fn((world * shape[0],) + tuple(shape[1:]), generator=generator, device=device)
    return rank_rows(full, shape[0], generator.rank)


def _fingerprint(tensors):
    """(len(tensors), 2) f64: each tensor's sum and sum of squares in f64."""
    return torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                        for t in tensors])


def make_parallel_trainer(trainer, group=None):
    """Make ``trainer`` (training/trainer.py) one rank of a data-parallel trainer over
    ``group`` (the default group): its BatchNorms synchronised, its losses module in
    DistributedDataParallel (``broadcast_buffers=False``: under synchronised
    statistics the running statistics are the same on every rank already), the
    masked losses over the global mask count. Raises unless every rank then holds
    rank 0's weights, running statistics and step. Returns the trainer."""
    from fiery_tpu_torch.models.layers import BatchNorm
    if not dist.is_initialized():
        raise RuntimeError('make_parallel_trainer needs a process group '
                           '(maybe_initialize_distributed, under torchrun)')
    group = dist.group.WORLD if group is None else group
    for m in trainer.model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    trainer.step_losses.group = group
    trainer.forward_losses = DistributedDataParallel(trainer.step_losses, process_group=group,
                                                     broadcast_buffers=False)
    trainer.group = group
    trainer.rank, trainer.world = dist.get_rank(group), dist.get_world_size(group)
    states = list(trainer.model.state_dict().values()) + list(trainer.uncertainty.values())
    mine = torch.cat([_fingerprint(states).flatten(),
                      torch.tensor([float(trainer.step)], dtype=torch.float64,
                                   device=trainer.device)])
    gathered = [torch.empty_like(mine) for _ in range(trainer.world)]
    dist.all_gather(gathered, mine, group=group)
    differ = [r for r, g in enumerate(gathered) if not torch.equal(g, gathered[0])]
    if differ:
        raise RuntimeError(f'ranks {differ} do not start from rank 0\'s weights, statistics '
                           f'and step')
    return trainer


def global_losses(losses, total, group):
    """The ranks' average of each loss and of the total (a mean over equal shares of
    the batch is the global batch's mean; the masked losses are already scaled to
    the global count): one all-reduce."""
    keys = list(losses)
    stacked = torch.stack([losses[k] for k in keys] + [total])
    dist.all_reduce(stacked, group=group)
    stacked = stacked / dist.get_world_size(group)
    return dict(zip(keys, stacked[:-1])), stacked[-1]


def max_across_ranks(values, group=None):
    """The element-wise maximum over the ranks of a list of ints (DEPTH_CULL's
    per-camera keeps, so that every rank culls alike); the list itself without a
    process group."""
    if not dist.is_initialized():
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    if dist.get_backend(group) == 'nccl':
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return [int(v) for v in t.cpu()]


def sum_states(states, group=None):
    """Every rank's array ``states`` (a metric's ``state()``), gathered and summed in
    rank order in f64, as ``process_allgather(...).sum(0)`` does; the array itself
    without a process group."""
    states = torch.as_tensor(states, dtype=torch.float64)
    if not dist.is_initialized():
        return states.numpy()
    if dist.get_backend(group) == 'nccl':
        states = states.cuda()
    gathered = [torch.empty_like(states) for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, states, group=group)
    total = gathered[0]
    for g in gathered[1:]:
        total = total + g
    return total.cpu().numpy()
