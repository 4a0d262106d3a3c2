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
is for training only: the eval forward takes every camera on each rank.

The BEV spatial axis (``bev_sharding`` and ``bev_constraint`` of the JAX package,
``make_parallel_trainer(..., bev_parallel=True)``, ``train.py --bev-parallel``)
splits the X rows (dim -3 of a channels-last BEV tensor) of every activation after
the splat over the camera group. After ``gather_cameras`` every rank of the group
holds every camera, so each runs the splat, the warps and the egopose concat on the
whole grid and then keeps its share of the rows (``row_plan``, ``RowShare``): the
temporal model, the rollout and the decoder run on the share, the layers that read
neighbouring rows take them from the neighbouring ranks (``exchange_rows``, whose
backward sends the halo's gradients back to their owners), the pyramid pooling's
spatial mean sums the shares (``group_row_mean``), and the distributions and the
segmentation loss's top-k take the whole grid (``gather_rows``). The row-sharded
modules' BatchNorms take their statistics over the world, the masked losses count
over the world, and the logged losses are the world's average; everything else is
as under the camera axis. Eval stays unsharded, as in the JAX package.
"""

import contextlib
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


# the decoder's total stride (three stride-2 stages): the row plan's inner edges are
# multiples of it, so that a share at every level of the decoder is the full-width
# share divided by that level's stride
BEV_STRIDE = 8


def row_plan(rows, shares, unit=BEV_STRIDE):
    """The edges (e_0 = 0, e_1, ..., e_M = rows) of M contiguous shares of ``rows``
    rows whose edges are multiples of ``unit``: the rows / unit units dealt out as
    evenly as they go, the first shares taking one more (200 rows in 2 shares:
    104 + 96). Raises where ``unit`` does not divide the rows (nor then does the
    decoder's stride) or a share would be empty."""
    if rows % unit:
        raise ValueError(f'{rows} BEV rows are not a multiple of the decoder\'s stride {unit}')
    units = rows // unit
    if shares < 1 or units < shares:
        raise ValueError(f'{rows} BEV rows hold {units} blocks of {unit}: share '
                         f'{units} of {shares} would be empty')
    edges = [0]
    for m in range(shares):
        edges.append(edges[-1] + unit * (units // shares + (m < units % shares)))
    return tuple(edges)


@dataclasses.dataclass(frozen=True)
class RowShare:
    """Share ``index`` of a camera group's rows: the rows [edges[index],
    edges[index + 1]) of the full-resolution grid (``row_plan``), and ``group``, the
    camera group whose ranks hold the shares in rank order. At a level of stride s
    (1, 2, 4 or 8 in the decoder) share m is [e_m / s, ceil(e_(m+1) / s))."""
    group: object
    index: int
    edges: tuple

    @property
    def size(self):
        return len(self.edges) - 1

    def _at(self, m, s):
        return self.edges[m] // s, -(-self.edges[m + 1] // s)

    def stride(self, rows):
        """The stride of the level where this share holds ``rows`` rows (the
        finest such). Raises when no level has that many."""
        s = 1
        while s <= self.edges[-1]:
            start, stop = self._at(self.index, s)
            if stop - start == rows:
                return s
            s *= 2
        raise ValueError(f'share {self.index} of the rows {self.edges} has no level of '
                         f'{rows} rows')

    def level(self, rows):
        """(start, stop, total) of the share at the level where it holds ``rows``."""
        s = self.stride(rows)
        return (*self._at(self.index, s), -(-self.edges[-1] // s))

    def counts(self, rows):
        """Every share's row count at the level where this one holds ``rows``."""
        s = self.stride(rows)
        return [b - a for a, b in (self._at(m, s) for m in range(self.size))]


_ROWS = None       # the RowShare of the row-sharded modules being run, or None


@contextlib.contextmanager
def bev_rows(share):
    """Run the layers inside on ``share``'s rows (None: the whole grid): the
    convolutions, the bilinear upsample, the causal max pool and the pyramid
    pooling read ``current_rows()``."""
    global _ROWS
    prev, _ROWS = _ROWS, share
    try:
        yield
    finally:
        _ROWS = prev


def current_rows():
    return _ROWS


def _memory_like(t, x):
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
    if fmt is not None and x.is_contiguous(memory_format=fmt):
        return t.contiguous(memory_format=fmt)
    return t.contiguous()


class _ExchangeHalo(torch.autograd.Function):
    """The rows that the neighbouring shares lend: (the last ``above`` rows of share
    m - 1, the first ``below`` rows of share m + 1) along dim -2, each empty where
    share m lies at the grid's edge. One all-gather of every rank's edge rows (one
    code path on NCCL and gloo); the backward is its adjoint: the halos' gradients
    go back to their owners, which add them to their edge rows."""

    @staticmethod
    def forward(ctx, x, group, index, above, below):
        ctx.group, ctx.index, ctx.above, ctx.below = group, index, above, below
        ctx.shape = x.shape
        size = dist.get_world_size(group)
        rows = x.shape[-2]
        top, bottom = x[..., :below, :], x[..., rows - above:, :]
        mine = torch.cat([top.reshape(-1), bottom.reshape(-1)])
        parts = [torch.empty_like(mine) for _ in range(size)]
        dist.all_gather(parts, mine, group=group)
        n_top = top.numel()
        recv_above = (parts[index - 1][n_top:].view(bottom.shape) if index > 0
                      else bottom[..., :0, :])
        recv_below = (parts[index + 1][:n_top].view(top.shape) if index < size - 1
                      else top[..., :0, :])
        return _memory_like(recv_above, x), _memory_like(recv_below, x)

    @staticmethod
    def backward(ctx, g_above, g_below):
        group, index, above, below = ctx.group, ctx.index, ctx.above, ctx.below
        size = dist.get_world_size(group)
        lead, rows, w = ctx.shape[:-2], ctx.shape[-2], ctx.shape[-1]
        n_top, n_bottom = below * w * lead.numel(), above * w * lead.numel()
        dtype, device = g_above.dtype, g_above.device
        g_above = g_above.reshape(-1) if index > 0 else torch.zeros(n_bottom, dtype=dtype,
                                                                    device=device)
        g_below = g_below.reshape(-1) if index < size - 1 else torch.zeros(
            n_top, dtype=dtype, device=device)
        mine = torch.cat([g_above, g_below])
        parts = [torch.empty_like(mine) for _ in range(size)]
        dist.all_gather(parts, mine, group=group)
        dx = torch.zeros(ctx.shape, dtype=dtype, device=device)
        if index > 0 and below:
            # share m - 1 borrowed this share's first rows as its lower halo
            dx[..., :below, :] += parts[index - 1][n_bottom:].view(*lead, below, w)
        if index < size - 1 and above:
            dx[..., rows - above:, :] += parts[index + 1][:n_bottom].view(*lead, above, w)
        return dx, None, None, None, None


def exchange_rows(x, above, below, edge=(0, 0), fill=0.0, share=None):
    """x (..., h, w), the rank's rows along dim -2 -> (..., a + h + b, w): the
    ``above`` rows of the share above and the ``below`` rows of the share below,
    or, at the grid's true top and bottom edges, ``edge`` = (top, bottom) rows of
    ``fill`` (a layer's own padding). Also returns a, the rows put above.
    ``share``: the RowShare (``current_rows()`` when None)."""
    share = current_rows() if share is None else share
    start, stop, total = share.level(x.shape[-2])
    # every rank checks every share, so that all raise or none waits on the others
    for m, n in enumerate(share.counts(x.shape[-2])):
        lends = max(above if m < share.size - 1 else 0, below if m > 0 else 0)
        if n < lends:
            raise ValueError(f'share {m} of the rows {share.edges} holds {n} rows at this '
                             f'level, thinner than the halo of {lends} rows it lends')
    if above or below:
        recv_above, recv_below = _ExchangeHalo.apply(x, share.group, share.index, above,
                                                     below)
    else:
        recv_above = recv_below = x[..., :0, :]
    if start == 0:
        recv_above = torch.full_like(x[..., :1, :], fill).expand(
            *x.shape[:-2], edge[0], x.shape[-1])
    if stop == total:
        recv_below = torch.full_like(x[..., :1, :], fill).expand(
            *x.shape[:-2], edge[1], x.shape[-1])
    if not recv_above.shape[-2] and not recv_below.shape[-2]:
        return x, 0
    out = torch.cat([recv_above, x, recv_below], dim=-2)
    return _memory_like(out, x), recv_above.shape[-2]


class _GroupRowMean(torch.autograd.Function):
    """The mean over dims -2 and -1 of the whole grid from the shares of a group:
    each rank's partial sums (in f32 at least), summed over the group (an
    all-reduce), over the whole grid's ``count`` values; the backward is the
    adjoint: the group's gradients summed (an all-reduce), over ``count``, on every
    value."""

    @staticmethod
    def forward(ctx, x, group, count):
        ctx.group, ctx.count, ctx.shape, ctx.dtype = group, count, x.shape, x.dtype
        acc = torch.promote_types(x.dtype, torch.float32)
        total = x.to(acc).sum(dim=(-2, -1), keepdim=True)
        dist.all_reduce(total, group=group)
        return (total / count).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.promote_types(g.dtype, torch.float32)).clone()
        dist.all_reduce(g, group=ctx.group)
        return (g / ctx.count).to(ctx.dtype).expand(ctx.shape), None, None


def group_row_mean(x, share=None):
    """(..., h, w) rows of a share -> (..., 1, 1): the mean over the whole grid's
    rows and columns (``_GroupRowMean``)."""
    share = current_rows() if share is None else share
    _, _, total = share.level(x.shape[-2])
    return _GroupRowMean.apply(x, share.group, total * x.shape[-1])


class _GatherRows(torch.autograd.Function):
    """All-gather of the shares' rows along ``dim``, in the group's rank order
    (shares of unequal rows padded to the largest, then cropped); the backward is
    its adjoint: the group's gradients summed (an all-reduce), of which each rank
    keeps its own rows."""

    @staticmethod
    def forward(ctx, x, group, index, counts, dim):
        ctx.group, ctx.index, ctx.counts, ctx.dim = group, index, counts, dim
        widest = max(counts)
        xt = x.movedim(dim, 0)
        if xt.shape[0] < widest:
            xt = torch.cat([xt, xt.new_zeros((widest - xt.shape[0],) + xt.shape[1:])])
        xt = xt.contiguous()
        parts = [torch.empty_like(xt) for _ in counts]
        dist.all_gather(parts, xt, group=group)
        out = torch.cat([p[:n] for p, n in zip(parts, counts)]).movedim(0, dim)
        return out.contiguous()

    @staticmethod
    def backward(ctx, grad):
        g = grad.movedim(ctx.dim, 0).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        start = sum(ctx.counts[:ctx.index])
        return (g[start:start + ctx.counts[ctx.index]].movedim(0, ctx.dim).contiguous(),
                None, None, None, None)


def gather_rows(x, dim, share=None):
    """The share's rows along ``dim`` on each rank of its group -> the whole grid's
    rows, every share in the group's order (``_GatherRows``)."""
    share = current_rows() if share is None else share
    dim = dim % x.dim()
    return _GatherRows.apply(x, share.group, share.index, tuple(share.counts(x.shape[dim])),
                             dim)


def _fingerprint(tensors):
    """(len(tensors), 2) f64: each tensor's sum and sum of squares in f64."""
    return torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                        for t in tensors])


def make_parallel_trainer(trainer, group=None, cameras=1, bev_parallel=False):
    """Make ``trainer`` (training/trainer.py) one rank of a parallel trainer over
    ``group`` (the default group), ``cameras`` ranks a camera group
    (``create_mesh``; every rank calls this with the same arguments): its
    BatchNorms synchronised (the encoder's over the world, the others over the
    rank's data group), its losses module in DistributedDataParallel over the world
    (``broadcast_buffers=False``: under synchronised statistics the running
    statistics are the same on every rank already), the masked losses over the
    data group's mask count, and with ``cameras`` > 1 the encoder's outputs
    gathered over the camera group. With ``bev_parallel`` (``cameras`` > 1) each
    rank of a camera group also trains its share of the BEV rows (``row_plan``;
    the module docstring): the temporal model's, the rollout's and the decoder's
    BatchNorms then synchronise over the world, as do the masked losses' count and
    the logged losses, and the distributions' over the data group. Raises when
    ``cameras`` does not divide the world size or the number of cameras, when
    ``bev_parallel`` has no camera group or the rows no share for each rank, and
    unless every rank then holds rank 0's weights, running statistics and step.
    Returns the trainer."""
    from fiery_tpu_torch.models.layers import BatchNorm
    n_cameras = len(trainer.cfg.IMAGE.NAMES)
    if cameras < 1 or n_cameras % cameras:
        raise ValueError(f'{cameras} camera ranks a data shard must divide the '
                         f'{n_cameras} cameras')
    if bev_parallel and cameras < 2:
        raise ValueError('the BEV spatial axis splits the rows over a camera group: it '
                         'needs cameras > 1')
    model = trainer.model
    edges = row_plan(model.cfg.bev_size[0], cameras) if bev_parallel else None
    mesh = create_mesh(cameras, group)
    world = {id(m) for m in model.encoder.modules()}
    if bev_parallel:
        world |= {id(m) for name in ('temporal_model', 'future_prediction', 'decoder')
                  if hasattr(model, name) for m in getattr(model, name).modules()}
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = mesh.world if id(m) in world else mesh.data
    model.camera_group = mesh.camera
    trainer.step_losses.group = mesh.data
    if bev_parallel:
        model.row_share = RowShare(mesh.camera, mesh.camera_rank, edges)
        trainer.step_losses.group = mesh.world
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
