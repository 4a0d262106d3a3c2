"""Data- and camera-parallel training across processes (counterpart of the
``data`` and ``model`` axes of fiery_tpu/parallel/mesh.py).

The JAX package shards the batch over the ``data`` axis of its mesh, replicates the
state, and lets GSPMD insert the gradient psum and take BatchNorm's statistics over
the global batch. Its optional second axis, ``model``, shards the cameras (dim 2 of
``image``, ``intrinsics`` and ``extrinsics``), and GSPMD gathers the encoder's
outputs where the splat combines every camera of a sample. Here the W processes
(ranks, one card each under ``torchrun``) form a mesh of D data shards by M camera
ranks, rank r = d M + m: the camera axis is the minor one, as in ``create_mesh``'s
``reshape(n // n_model, n_model)``. Each data shard's M ranks (its camera group)
hold its samples, and each encodes N / M of every sample's N cameras:
  - the model and the uncertainty weights run inside DistributedDataParallel over
    the world, whose gradient all-reduce averages over the W ranks; the clip and
    Adam then run identically on every rank (``make_parallel_trainer``);
  - the encoder's outputs (depth and features) are gathered over the camera group
    before the splat (``gather_cameras``), whose backward sums the group's
    gradients, so that the world's average is the global batch's gradient;
  - the encoder's BatchNorms take their statistics over the world, where each image
    is counted once, the BatchNorms after the splat over the rank's data group (the
    D ranks of its camera index), where each data shard is counted once (kernel
    K10's synchronised path, ops/batch_norm.py; the BatchNorms' ``process_group``);
  - the masked regression losses divide by the global batch's mask count, summed
    over the data group (training/losses.py ``spatial_regression_loss``), and the
    logged losses are the data group's average;
  - a step's random draws (latent noise, drop-connect) are those of the global
    batch, of which each rank keeps its rows: the latent noise of its data shard,
    the drop-connect masks of its images (``RankGenerator``, ``rank_rows``);
  - the loaders read disjoint strided shards of each epoch, one a data shard, and
    the validation's metric states are summed over the data group before
    ``compute()`` (``sum_states``).
One process on the whole batch and W ranks on their shares then take the same
step, up to the order of f32 sums. With M = 1 the data group is the world and no
camera group exists.

    python -m torch.distributed.run --nproc_per_node N -m fiery_tpu_torch.train \
        --config fiery_tpu_torch/configs/baseline.yml [--camera-parallel M] ...

cfg.BATCHSIZE is per data shard, as the JAX package reads it per chip of its data
axis: the global batch is BATCHSIZE x W / M. As in the JAX package, the camera axis
is for training only: the eval forward takes every camera on each rank. Not ported
yet: the BEV spatial axis (``bev_sharding``, ``bev_constraint``).
"""

import dataclasses
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
    """A training step's generator on data shard ``rank`` of ``world`` and camera rank
    ``camera`` of ``cameras``: each draw of the model's is that of the global batch
    (from this one stream), of which the rank keeps its own rows (``rank_rows``):
    of a per-sample draw its data shard's, of a per-image draw (drop-connect) its
    data shard's images of its cameras. The ranks together then draw what one
    process on the whole batch draws."""

    def __new__(cls, device, rank, world, camera=0, cameras=1):
        return super().__new__(cls, device=device)

    def __init__(self, device, rank, world, camera=0, cameras=1):
        self.rank, self.world, self.camera, self.cameras = rank, world, camera, cameras


def rank_rows(t, rows, rank, camera=0, cameras=1, per_frame=None):
    """Rank ``rank``'s ``rows`` rows of a global-batch tensor ``t`` along dim 0: rows
    [rank rows, (rank + 1) rows). With ``per_frame`` = n (t's dim 0 then counts
    images, (sample, frame, camera) with the camera minor, and the rank encodes n
    cameras of each of its sample-frames), the data shard's images whose camera
    lies in [camera n, (camera + 1) n): ``cameras`` blocks of n a sample-frame, not
    one contiguous block."""
    if per_frame is None or cameras == 1:
        return t[rank * rows:(rank + 1) * rows]
    shard = t[rank * rows * cameras:(rank + 1) * rows * cameras]
    shard = shard.reshape(rows // per_frame, cameras, per_frame, *t.shape[1:])
    return shard[:, camera].reshape(rows, *t.shape[1:])


def draw_batch(fn, shape, generator, device, per_frame=None):
    """fn(shape, generator=generator, device=device), fn ``torch.rand`` or
    ``torch.randn`` with shape[0] the rank's rows; under a ``RankGenerator`` the
    global batch's draw, of which the rank's rows are returned. ``per_frame`` = n
    marks a draw of images, n cameras of each sample-frame (``rank_rows``): its
    global draw spans every camera rank's images too."""
    world = getattr(generator, 'world', 1)
    cameras = getattr(generator, 'cameras', 1) if per_frame is not None else 1
    if world * cameras == 1:
        return fn(shape, generator=generator, device=device)
    full = fn((world * cameras * shape[0],) + tuple(shape[1:]), generator=generator,
              device=device)
    return rank_rows(full, shape[0], generator.rank, generator.camera, cameras, per_frame)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in a (D data shards) x (M camera ranks) mesh of W = D M ranks,
    rank r = d M + m within ``world``: the process groups it takes part in and its
    coordinates. ``data`` is the D ranks of camera index m (``world`` itself when
    M = 1), ``camera`` the M ranks of data shard d (None when M = 1)."""
    world: object
    data: object
    camera: object
    data_rank: int
    data_size: int
    camera_rank: int
    cameras: int


def create_mesh(cameras=1, group=None):
    """The mesh of ``group``'s ranks (the default group) with ``cameras`` ranks a
    camera group. Every rank must call it, with the same arguments: it makes every
    rank's camera group and data group, in the same order on each (a rank that
    makes them in another order, or not at all, hangs the others). Raises when
    ``cameras`` does not divide the world size."""
    if not dist.is_initialized():
        raise RuntimeError('create_mesh needs a process group '
                           '(maybe_initialize_distributed, under torchrun)')
    group = dist.group.WORLD if group is None else group
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if cameras < 1 or world % cameras:
        raise ValueError(f'{cameras} camera ranks a data shard must divide the {world} ranks')
    if cameras == 1:
        return Mesh(group, group, None, rank, world, 0, 1)
    ranks = dist.get_process_group_ranks(group)
    shards = world // cameras
    camera_groups = [dist.new_group([ranks[d * cameras + m] for m in range(cameras)])
                     for d in range(shards)]
    data_groups = [dist.new_group([ranks[d * cameras + m] for d in range(shards)])
                   for m in range(cameras)]
    d, m = divmod(rank, cameras)
    return Mesh(group, data_groups[m], camera_groups[d], d, shards, m, cameras)


class _GatherCameras(torch.autograd.Function):
    """All-gather over a camera group along dim 1, in the group's rank order; the
    backward is its adjoint: the sum over the group of the gradients with respect
    to the gathered tensor (an all-reduce), of which each rank keeps its own slice.
    One code path on NCCL and gloo alike (gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[1]
        xt = x.transpose(0, 1).contiguous()             # the cameras leading
        parts = [torch.empty_like(xt) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, xt, group=group)
        return torch.cat(parts).transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        n, group = ctx.n, ctx.group
        # a copy, never the incoming gradient itself: the all-reduce is in place
        gt = grad.transpose(0, 1).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(gt, group=group)
        m = dist.get_rank(group)
        return gt[m * n:(m + 1) * n].transpose(0, 1).contiguous(), None


def gather_cameras(x, group):
    """(b s, n, ...) on each of a camera group's M ranks -> (b s, M n, ...): every
    rank's cameras, concatenated in the group's rank order (``_GatherCameras``)."""
    return _GatherCameras.apply(x, group)


def _fingerprint(tensors):
    """(len(tensors), 2) f64: each tensor's sum and sum of squares in f64."""
    return torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                        for t in tensors])


def make_parallel_trainer(trainer, group=None, cameras=1):
    """Make ``trainer`` (training/trainer.py) one rank of a parallel trainer over
    ``group`` (the default group), ``cameras`` ranks a camera group
    (``create_mesh``; every rank calls this with the same arguments): its
    BatchNorms synchronised (the encoder's over the world, the others over the
    rank's data group), its losses module in DistributedDataParallel over the world
    (``broadcast_buffers=False``: under synchronised statistics the running
    statistics are the same on every rank already), the masked losses over the
    data group's mask count, and with ``cameras`` > 1 the encoder's outputs
    gathered over the camera group. Raises when ``cameras`` does not divide the
    world size or the number of cameras, and unless every rank then holds rank 0's
    weights, running statistics and step. Returns the trainer."""
    from fiery_tpu_torch.models.layers import BatchNorm
    n_cameras = len(trainer.cfg.IMAGE.NAMES)
    if cameras < 1 or n_cameras % cameras:
        raise ValueError(f'{cameras} camera ranks a data shard must divide the '
                         f'{n_cameras} cameras')
    mesh = create_mesh(cameras, group)
    encoder = {id(m) for m in trainer.model.encoder.modules()}
    for m in trainer.model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = mesh.world if id(m) in encoder else mesh.data
    trainer.model.camera_group = mesh.camera
    trainer.step_losses.group = mesh.data
    trainer.forward_losses = DistributedDataParallel(trainer.step_losses,
                                                     process_group=mesh.world,
                                                     broadcast_buffers=False)
    trainer.group = mesh.data
    trainer.rank, trainer.world = mesh.data_rank, mesh.data_size
    trainer.camera, trainer.cameras = mesh.camera_rank, mesh.cameras
    states = list(trainer.model.state_dict().values()) + list(trainer.uncertainty.values())
    mine = torch.cat([_fingerprint(states).flatten(),
                      torch.tensor([float(trainer.step)], dtype=torch.float64,
                                   device=trainer.device)])
    gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size(mesh.world))]
    dist.all_gather(gathered, mine, group=mesh.world)
    differ = [r for r, g in enumerate(gathered) if not torch.equal(g, gathered[0])]
    if differ:
        raise RuntimeError(f'ranks {differ} do not start from rank 0\'s weights, statistics '
                           f'and step')
    return trainer


def global_losses(losses, total, group):
    """The ranks' average of each loss and of the total over ``group`` (a data
    group: a mean over equal shares of the batch is the global batch's mean; the
    masked losses are already scaled to the global count): one all-reduce."""
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
    """Every rank's array ``states`` (a metric's ``state()``) of ``group`` (a data
    group, where each data shard is counted once), gathered and summed in rank
    order in f64, as ``process_allgather(...).sum(0)`` does; the array itself
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
