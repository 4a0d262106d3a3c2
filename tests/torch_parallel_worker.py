"""One rank of the port's data-, camera- and BEV-parallel CPU tests
(tests/test_torch_parallel*.py, tests/test_torch_camera_parallel*.py,
tests/test_torch_bev_parallel*.py), and the inputs they share with the one-process
references:

    python tests/torch_parallel_worker.py CASE RANK WORLD INIT_FILE OUT

joins a gloo group of WORLD ranks through ``file://INIT_FILE``, runs CASE on its
share of seeded inputs (numpy) with two intra-op threads, and writes what it got
to OUT (``torch.save``). ``spawn_ranks`` starts WORLD of them and returns their
results in rank order. Imports nothing of JAX.
"""

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS, MOMENTUM = 1e-5, 0.1
BN_SHAPES = {4: (4, 6, 5, 7), 5: (4, 3, 6, 5, 7)}    # channels-first, C = 6; batch 4
BN_SEED = 40
LOSS_SHAPE = (4, 3, 6, 5, 2)      # (b, s, h, w, c); rank 0 holds rows 0-1, rank 1 rows 2-3
LOSS_SEED = 41
STEP_SEED = 7                      # the generator seed of the training step
# tests/test_parallel.py's tiny_cfg shapes: 1 camera at 16 x 32, a 16 x 16 BEV, D = 2,
# rf 2, 1 future frame, b0 at 8 channels, latent 2; 2 samples a rank
TINY_DP = {
    'PRECISION': 32, 'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 1, 'BATCHSIZE': 2,
    'IMAGE': {'FINAL_DIM': (16, 32), 'NAMES': ['CAM_A']},
    'LIFT': {'X_BOUND': [-4.0, 4.0, 0.5], 'Y_BOUND': [-4.0, 4.0, 0.5],
             'D_BOUND': [2.0, 4.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 8},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 8, 'PYRAMID_POOLING': False},
              'DISTRIBUTION': {'LATENT_DIM': 2},
              'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 1}},
    'DATASET': {'NAME': 'synthetic', 'N_SYNTHETIC_SAMPLES': 8},
}
# tests/test_torch_trainer.py's TINY (the shapes at which the port's one-process step
# is held to JAX's), 1 sample a rank: 2 cameras at 64 x 96, D = 6, C = 16, a 32 x 32
# BEV, rf 3, 2 future frames, latent 4
TINY_JAX = {
    'PRECISION': 32, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2, 'BATCHSIZE': 1,
    'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B']},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
             'D_BOUND': [2.0, 8.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4},
              'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 2}},
}


def bn_inputs(dims, post, dtype=torch.float32):
    """(x, residual or None, dy, weight, bias, running_mean, running_var) of the
    whole batch, channels-first, seeded by (dims, post); the ranks take rows of
    dim 0. Each sample has its own offset and scale, so that the ranks' shares
    differ."""
    from fiery_tpu_torch.ops.batch_norm import POSTS, RESIDUAL_POSTS
    rng = np.random.RandomState(BN_SEED + 10 * dims + POSTS.index(post))
    shape = BN_SHAPES[dims]
    B, C = shape[0], shape[1]
    scale = (1.0 + np.arange(B)).reshape((B,) + (1,) * (len(shape) - 1))
    x = rng.randn(*shape) * scale + 0.3 * np.arange(B).reshape(scale.shape)
    res = rng.randn(*shape) if post in RESIDUAL_POSTS else None
    dy = rng.randn(*shape)
    w, b = rng.rand(C) + 0.5, rng.randn(C)
    rm, rv = rng.randn(C) * 0.1, rng.rand(C) + 0.5
    t = lambda a, d=dtype: None if a is None else torch.from_numpy(a).to(d)   # noqa: E731
    return (t(x), t(res), t(dy), t(w, torch.float32), t(b, torch.float32),
            t(rm, torch.float32), t(rv, torch.float32))


def loss_inputs():
    """(prediction, target) of LOSS_SHAPE: rank 0's rows mostly valid, rank 1's
    mostly ignored (255), so that their mask counts differ."""
    rng = np.random.RandomState(LOSS_SEED)
    pred = rng.randn(*LOSS_SHAPE).astype(np.float32)
    target = rng.randn(*LOSS_SHAPE).astype(np.float32)
    keep = rng.rand(*LOSS_SHAPE[:-1])
    keep[:2] = keep[:2] < 0.9
    keep[2:] = keep[2:] < 0.1
    target[..., 0] = np.where(keep > 0, target[..., 0], 255.0)
    return torch.from_numpy(pred), torch.from_numpy(target)


def metric_inputs(seed=42):
    """(predicted classes, true classes, predicted ids, true ids), (4, 2, 12, 12)
    ints: the IoU's and the panoptic metric's inputs, with instances."""
    rng = np.random.RandomState(seed)
    shape = (4, 2, 12, 12)
    seg_pred, seg_true = rng.randint(0, 2, shape), rng.randint(0, 2, shape)
    ids_true = np.zeros(shape, np.int64)
    ids_pred = np.zeros(shape, np.int64)
    for b in range(shape[0]):
        for k in range(1, 4):
            y, x = rng.randint(0, 9, 2)
            ids_true[b, :, y:y + 3, x:x + 3] = k
            dy, dx = rng.randint(-1, 2, 2)
            ids_pred[b, :, max(0, y + dy):y + dy + 3, max(0, x + dx):x + dx + 3] = k
    return seg_pred, seg_true, ids_pred, ids_true


def rows_of(t, rank, world):
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def bn_run(x, res, dy, w, b, rm, rv, post, group):
    """One training BatchNorm with autograd: y, the batch statistics, the running
    statistics after, and the gradients of x, weight, bias and the residual."""
    from fiery_tpu_torch.ops.batch_norm import (batch_norm, batch_norm_forward,
                                                batch_norm_sync_forward)
    x = x.clone().requires_grad_(True)
    w, b = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    res = None if res is None else res.clone().requires_grad_(True)
    rm, rv = rm.clone(), rv.clone()
    with torch.no_grad():
        if group is None:
            _, mean, var, clamp = batch_norm_forward(x, w, b, rm.clone(), rv.clone(), True,
                                                     MOMENTUM, EPS, post, res)
        else:
            _, mean, var, clamp = batch_norm_sync_forward(x, w, b, rm.clone(), rv.clone(),
                                                          MOMENTUM, EPS, post, res, group)
    y = batch_norm(x, w, b, rm, rv, True, MOMENTUM, EPS, post, res, group=group)
    (y.float() * dy.float()).sum().backward()
    return {'y': y.detach(), 'mean': mean, 'var': var, 'clamp': clamp,
            'running_mean': rm, 'running_var': rv, 'dx': x.grad, 'dweight': w.grad,
            'dbias': b.grad, 'dres': None if res is None else res.grad}


def case_bn(rank, world):
    """K10's synchronised plain versions: each post, 4-D and 5-D, on the rank's
    rows over the whole group (f32), and over a group of the rank alone against
    the unsynchronised path (f32 and bf16); the masked loss on the rank's rows; the
    metric states of its rows summed over the ranks."""
    from fiery_tpu_torch.ops.batch_norm import POSTS
    from fiery_tpu_torch.parallel.mesh import sum_states
    from fiery_tpu_torch.training.losses import spatial_regression_loss
    from fiery_tpu_torch.training.metrics import IntersectionOverUnion, PanopticMetric
    alone = [dist.new_group([r]) for r in range(world)][rank]
    out = {'world': {}, 'alone': {}, 'fused': {}}
    for dims in (4, 5):
        for post in POSTS:
            x, res, dy, w, b, rm, rv = bn_inputs(dims, post)
            mine = [None if t is None else rows_of(t, rank, world) for t in (x, res, dy)]
            out['world'][dims, post] = bn_run(*mine, w, b, rm, rv, post, dist.group.WORLD)
            for dtype in (torch.float32, torch.bfloat16):
                x, res, dy, w, b, rm, rv = bn_inputs(dims, post, dtype)
                mine = [None if t is None else rows_of(t, rank, world) for t in (x, res, dy)]
                out['alone'][dims, post, dtype] = bn_run(*mine, w, b, rm, rv, post, alone)
                out['fused'][dims, post, dtype] = bn_run(*mine, w, b, rm, rv, post, None)
    pred, target = loss_inputs()
    pred = rows_of(pred, rank, world).clone().requires_grad_(True)
    loss = spatial_regression_loss(pred, rows_of(target, rank, world), norm=1,
                                   future_discount=0.9, group=dist.group.WORLD)
    loss.backward()
    out['loss'], out['loss_grad'] = loss.detach(), pred.grad
    seg_pred, seg_true, ids_pred, ids_true = (rows_of(a, rank, world) for a in metric_inputs())
    iou, panoptic = IntersectionOverUnion(2), PanopticMetric(2)
    iou.update(seg_pred, seg_true)
    panoptic.update(ids_pred, ids_true)
    out['iou_state'] = sum_states(iou.state())
    out['panoptic_state'] = sum_states(panoptic.state())
    return out


def tiny_cfg(cfg_dict=TINY_DP):
    from fiery_tpu_torch.utils.config import get_cfg
    return get_cfg(cfg_dict=cfg_dict)


def cull_cfg():
    """TINY_DP with depth planes out to 12 m, past the 4 m grid: DEPTH_CULL's keeps
    then drop planes."""
    from fiery_tpu_torch.utils.config import get_cfg
    return get_cfg(cfg_dict={**TINY_DP, 'LIFT': {**TINY_DP['LIFT'],
                                                 'D_BOUND': [2.0, 12.0, 1.0]}})


def seeded_trainer(cfg, seed=3):
    """A CPU trainer with seeded weights and running statistics (the same on every
    rank and in the one-process reference)."""
    from fiery_tpu_torch.serve import init_params
    from fiery_tpu_torch.training.trainer import Trainer
    trainer = Trainer(cfg, device='cpu')
    init_params(trainer.model, seed=seed)
    rng = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for name, buf in trainer.model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(torch.from_numpy(rng.randn(*buf.shape).astype(np.float32) * 0.1))
            elif name.endswith('running_var'):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    return trainer


def global_batch(cfg, n=4, seed=5):
    """The global batch of a step: n synthetic samples, numpy."""
    from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
    return SyntheticFutureDataset(cfg, n_samples=n, n_instances=2,
                                  seed=seed).get_batch(list(range(n)))


def global_noise(cfg, n=4, seed=6):
    return np.random.RandomState(seed).randn(n, 1, cfg.MODEL.DISTRIBUTION.LATENT_DIM) \
        .astype(np.float32)


def take_step(trainer, batch, generator=None, noise=None):
    """One training step; what the tests compare: losses, gradients, the new state."""
    losses, total = trainer.compute_gradients(batch, generator, noise)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    grads.update({'uncertainty.' + k: p.grad.clone() for k, p in trainer.uncertainty.items()})
    trainer.apply_gradients()
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    state.update({'uncertainty.' + k: p.detach().clone()
                  for k, p in trainer.uncertainty.items()})
    return {'losses': losses, 'total': total, 'grads': grads, 'state': state,
            'exp_avg': [trainer.optimizer.state[p]['exp_avg'].clone() for p in trainer.params]}


def case_steps(rank, world):
    """The tiny training step on the rank's 2 samples of the 4-sample batch
    with drop-connect and the step's generator ('drop'); at TINY_JAX, the step on
    the rank's sample of 2 without drop-connect and with the global batch's noise
    ('noise'); the validation before the first step and DEPTH_CULL's keep of the
    rank's first batch, the maximum over the ranks."""
    import fiery_tpu_torch.models.efficientnet as efficientnet
    from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
    from fiery_tpu_torch.parallel.mesh import make_parallel_trainer, max_across_ranks
    from fiery_tpu_torch.train import depth_plane_keep, validate
    from fiery_tpu_torch.training.trainer import step_generator
    cfg = tiny_cfg()
    batch = {k: rows_of(v, rank, world) for k, v in global_batch(cfg).items()}
    out = {}
    trainer = make_parallel_trainer(seeded_trainer(cfg))
    trainloader, valloader = prepare_dataloaders(cfg, process_index=rank, process_count=world)
    out['validate'] = validate(trainer, valloader)
    out['depth_keep'] = max_across_ranks(depth_plane_keep(cull_cfg(),
                                                          numeric_batch(trainloader.peek())))
    out['drop'] = take_step(trainer, batch, step_generator(STEP_SEED, 0, 'cpu', rank, world))
    saved = efficientnet._GLOBAL_PARAMS['b0']
    efficientnet._GLOBAL_PARAMS['b0'] = (1.0, 1.0, 0.0)
    try:
        cfg = tiny_cfg(TINY_JAX)
        trainer = make_parallel_trainer(seeded_trainer(cfg))
    finally:
        efficientnet._GLOBAL_PARAMS['b0'] = saved
    batch = {k: rows_of(v, rank, world) for k, v in global_batch(cfg, n=world).items()}
    out['noise'] = take_step(trainer, batch, noise=torch.from_numpy(global_noise(cfg, n=world)))
    return out


CAMERAS = 2                        # camera ranks a data shard in the camera-parallel cases
GATHER_SHAPE = (3, 4, 5, 2, 3)     # (b s, N, h, w, C): 2 cameras a rank
GATHER_SEED = 43
# TINY_JAX (2 cameras) with 2 samples a data shard: drop-connect at b0's rate
TINY_CAM = {**TINY_JAX, 'BATCHSIZE': 2}


def gather_inputs(world):
    """(x, grads): the (b s, N, h, w, C) f64 tensor whose cameras the ranks split,
    and each rank's gradient with respect to the gathered tensor (differing by
    rank)."""
    rng = np.random.RandomState(GATHER_SEED)
    x = torch.from_numpy(rng.randn(*GATHER_SHAPE))
    return x, [torch.from_numpy(rng.randn(*GATHER_SHAPE)) for _ in range(world)]


# TINY_CAM on a 24 x 32 grid: the BEV axis's shares at M = 2 are 16 and 8 rows
TINY_BEV = {**TINY_CAM, 'LIFT': {**TINY_CAM['LIFT'], 'X_BOUND': [-6.0, 6.0, 0.5]}}
# TINY_DP with 2 cameras: the validation's and DEPTH_CULL's camera-parallel cases
TINY_DP_CAM = {**TINY_DP, 'IMAGE': {**TINY_DP['IMAGE'], 'NAMES': ['CAM_A', 'CAM_B']}}


def cam_cull_cfg():
    """TINY_DP_CAM with depth planes out to 12 m, past the 4 m grid: DEPTH_CULL's
    keeps then drop planes."""
    return tiny_cfg({**TINY_DP_CAM, 'LIFT': {**TINY_DP_CAM['LIFT'],
                                             'D_BOUND': [2.0, 12.0, 1.0]}})


def case_gather(rank, world):
    """``gather_cameras`` over a camera group of the whole world in f64: the
    gathered tensor and the rank's input gradient under its own output gradient;
    the mesh's coordinates; and the refusals of camera counts that divide neither
    the ranks nor the cameras (a message each)."""
    from fiery_tpu_torch.parallel.mesh import create_mesh, gather_cameras, make_parallel_trainer
    mesh = create_mesh(world)
    x, grads = gather_inputs(world)
    n = x.shape[1] // world
    mine = x[:, rank * n:(rank + 1) * n].clone().requires_grad_(True)
    out = gather_cameras(mine, mesh.camera)
    (out * grads[rank]).sum().backward()
    refused = {}
    for key, fn in (('ranks', lambda: create_mesh(world + 1)),
                    ('cameras', lambda: make_parallel_trainer(seeded_trainer(tiny_cfg()),
                                                              cameras=world))):
        try:
            fn()
        except ValueError as e:
            refused[key] = str(e)
    return {'out': out.detach(), 'grad': mine.grad, 'refused': refused,
            'mesh': (mesh.data_rank, mesh.data_size, mesh.camera_rank, mesh.cameras,
                     dist.get_world_size(mesh.data), dist.get_world_size(mesh.camera))}


def case_cameras(rank, world):
    """The camera-parallel tiny step at (D, M) = (world / 2, 2): TINY_CAM on the
    data shard's 2 samples of the 2 D-sample batch, with drop-connect and the step's
    generator ('drop'). At world 4 also, at TINY_DP_CAM, the validation and
    DEPTH_CULL's keep of the shard's first batch, the maximum over the world; and at
    TINY_JAX, without drop-connect and with the global batch's noise, the step on
    the shard's sample of D ('noise'), and the same step with the BEV spatial axis
    ('bev_noise': each rank of a camera group trains 16 of the 32 rows)."""
    import fiery_tpu_torch.models.efficientnet as efficientnet
    from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
    from fiery_tpu_torch.parallel.mesh import make_parallel_trainer, max_across_ranks
    from fiery_tpu_torch.train import depth_plane_keep, validate
    from fiery_tpu_torch.training.trainer import step_generator
    shards = world // CAMERAS
    shard, camera = divmod(rank, CAMERAS)
    out = {}
    if world == 4:
        cfg = tiny_cfg(TINY_DP_CAM)
        trainer = make_parallel_trainer(seeded_trainer(cfg), cameras=CAMERAS)
        trainloader, valloader = prepare_dataloaders(cfg, process_index=shard,
                                                     process_count=shards)
        out['validate'] = validate(trainer, valloader)
        out['validate_group'] = dist.get_process_group_ranks(trainer.group)
        out['depth_keep'] = max_across_ranks(depth_plane_keep(
            cam_cull_cfg(), numeric_batch(trainloader.peek())))
    cfg = tiny_cfg(TINY_CAM)
    trainer = make_parallel_trainer(seeded_trainer(cfg), cameras=CAMERAS)
    out['mesh'] = (trainer.rank, trainer.world, trainer.camera, trainer.cameras)
    batch = {k: rows_of(v, shard, shards) for k, v in global_batch(cfg, n=2 * shards).items()}
    out['drop'] = take_step(trainer, batch, step_generator(STEP_SEED, 0, 'cpu', shard, shards,
                                                           camera, CAMERAS))
    if world == 4:
        saved = efficientnet._GLOBAL_PARAMS['b0']
        efficientnet._GLOBAL_PARAMS['b0'] = (1.0, 1.0, 0.0)
        try:
            cfg = tiny_cfg(TINY_JAX)
            trainer = make_parallel_trainer(seeded_trainer(cfg), cameras=CAMERAS)
        finally:
            efficientnet._GLOBAL_PARAMS['b0'] = saved
        batch = {k: rows_of(v, shard, shards) for k, v in global_batch(cfg, n=shards).items()}
        out['noise'] = take_step(trainer, batch,
                                 noise=torch.from_numpy(global_noise(cfg, n=shards)))
        efficientnet._GLOBAL_PARAMS['b0'] = (1.0, 1.0, 0.0)
        try:
            trainer = make_parallel_trainer(seeded_trainer(cfg), cameras=CAMERAS,
                                            bev_parallel=True)
        finally:
            efficientnet._GLOBAL_PARAMS['b0'] = saved
        out['bev_noise'] = take_step(trainer, batch,
                                     noise=torch.from_numpy(global_noise(cfg, n=shards)))
    return out


ROWS_X, ROWS_W = 40, 6      # the layer checks' grid: 40 rows (5 blocks of 8), 6 columns
ROWS_SEED = 44


def rows_inputs(kind):
    """(x, g, module): a whole-grid f64 input of the layer ``kind``, a gradient
    with respect to its whole output, and the layer (f64, seeded), for
    ``case_rows``. Rows are dim -2 of every input, at full resolution unless the
    layer reads a coarser level."""
    from fiery_tpu_torch.models.layers import Conv2d, Conv3d
    rng = np.random.RandomState(ROWS_SEED + ROWS_KINDS.index(kind))
    torch.manual_seed(ROWS_SEED + ROWS_KINDS.index(kind))
    shape = {'conv3x3': (2, 3, ROWS_X, ROWS_W), 'conv7x7s2': (2, 3, ROWS_X, ROWS_W),
             'conv1x1s2': (2, 3, ROWS_X, ROWS_W), 'causal_conv3d': (2, 3, 3, ROWS_X, ROWS_W),
             'max_pool3d': (2, 3, 3, ROWS_X, ROWS_W), 'bilinear': (2, 3, ROWS_X // 2, ROWS_W),
             'row_mean': (2, 3, 3, ROWS_X, ROWS_W), 'gather': (2, 3, ROWS_X, ROWS_W)}[kind]
    module = {'conv3x3': lambda: Conv2d(3, 4, 3, padding=1, bias=True),
              'conv7x7s2': lambda: Conv2d(3, 4, 7, stride=2, padding=3, bias=False),
              'conv1x1s2': lambda: Conv2d(3, 4, 1, stride=2, bias=False),
              'causal_conv3d': lambda: Conv3d(3, 4, (2, 3, 3), padding=(0, 1, 1), bias=False),
              'bilinear': lambda: torch.nn.Upsample(scale_factor=2, mode='bilinear',
                                                    align_corners=False)}.get(kind)
    module = module().double() if module is not None else None
    x = torch.from_numpy(rng.randn(*shape))
    return x, module


ROWS_KINDS = ('conv3x3', 'conv7x7s2', 'conv1x1s2', 'causal_conv3d', 'max_pool3d', 'bilinear',
              'row_mean', 'gather')


def rows_layer(kind, module, x):
    """The layer ``kind`` on x, inside or outside ``bev_rows`` alike."""
    import torch.nn.functional as F

    from fiery_tpu_torch.models.layers import upsample_rows
    from fiery_tpu_torch.models.temporal_layers import causal_max_pool3d
    from fiery_tpu_torch.parallel.mesh import current_rows, gather_rows, group_row_mean
    if kind == 'causal_conv3d':
        return module(F.pad(x, (0, 0, 0, 0, 1, 0)))
    if kind == 'max_pool3d':
        return causal_max_pool3d(x)
    if kind == 'bilinear':
        return upsample_rows(module, x)
    if kind == 'row_mean':
        if current_rows() is None:
            return x.mean(dim=(-2, -1), keepdim=True)
        return group_row_mean(x)
    if kind == 'gather':
        return x * 1.0 if current_rows() is None else gather_rows(x, -2)
    return module(x)


def case_rows(rank, world):
    """The BEV axis's row layers in f64 over shares of ``row_plan(ROWS_X, M)``, M = 3
    (the world) and M = 2 (ranks 0 and 1): for each kind of layer the rank's output
    rows and input gradient under the whole output gradient's rows (for the row
    mean and the gather, whose outputs every rank holds whole, under a gradient of
    its own). Also the whole-grid results of the same inputs, K10's synchronised
    plain statistics on uneven shares against the whole grid's, and the refusals
    of an empty share and of a share thinner than a halo."""
    from fiery_tpu_torch.ops.batch_norm import batch_norm_forward, batch_norm_sync_forward
    from fiery_tpu_torch.parallel.mesh import RowShare, bev_rows, exchange_rows, row_plan
    pair = dist.new_group([0, 1])
    out = {}
    for shares, group in ((3, dist.group.WORLD), (2, pair)):
        if rank >= shares:
            continue
        edges = row_plan(ROWS_X, shares)
        share = RowShare(group, rank, edges)
        for kind in ROWS_KINDS:
            x, module = rows_inputs(kind)
            level = ROWS_X // x.shape[-2]
            lo, hi = edges[rank] // level, edges[rank + 1] // level
            whole_x = x.clone().requires_grad_(True)
            whole = rows_layer(kind, module, whole_x)
            rng = np.random.RandomState(ROWS_SEED + 100 + shares * 10 + rank)
            if kind in ('row_mean', 'gather'):
                g = torch.from_numpy(rng.randn(*whole.shape))
                mine_g = g
            else:
                g = torch.from_numpy(np.random.RandomState(ROWS_SEED + 200).randn(*whole.shape))
                olo, ohi = (lo * whole.shape[-2] // x.shape[-2],
                            hi * whole.shape[-2] // x.shape[-2])
                mine_g = g[..., olo:ohi, :]
            (whole * g).sum().backward()
            mine_x = x[..., lo:hi, :].clone().requires_grad_(True)
            with bev_rows(share):
                mine = rows_layer(kind, module, mine_x)
            (mine * mine_g).sum().backward()
            out[shares, kind] = {'rows': (lo, hi), 'whole': whole.detach(),
                                 'whole_grad': whole_x.grad, 'out': mine.detach(),
                                 'grad': mine_x.grad, 'g': g}
        # K10's synchronised statistics over uneven shares of the rows (f32 plain)
        x = torch.from_numpy(np.random.RandomState(ROWS_SEED + 300).randn(
            2, 5, ROWS_X, ROWS_W).astype(np.float32) * 3 + 1)
        C = x.shape[1]
        w, b = torch.ones(C), torch.zeros(C)
        _, mean, var, _ = batch_norm_forward(x, w, b, torch.zeros(C), torch.ones(C), True,
                                             0.1, 1e-5)
        _, smean, svar, _ = batch_norm_sync_forward(
            x[..., edges[rank]:edges[rank + 1], :].contiguous(), w, b, torch.zeros(C),
            torch.ones(C), 0.1, 1e-5, 'none', None, group)
        out[shares, 'bn'] = {'whole': (mean, var), 'sync': (smean, svar)}
    refused = {}
    try:
        row_plan(16, 3)
    except ValueError as e:
        refused['empty'] = str(e)
    try:
        # share 0 of (0, 2, 40) holds 2 rows; a 7 x 7 kernel's share below needs 3
        share = RowShare(dist.group.WORLD, rank, (0, 2, 24, 40))
        exchange_rows(torch.zeros(1, 1, [2, 22, 16][rank], 3), 3, 2, share=share)
    except ValueError as e:
        refused['thin'] = str(e)
    out['refused'] = refused
    return out


def case_bev(rank, world):
    """The BEV-parallel tiny step at (D, M) = (world / 2, 2): TINY_BEV (a 24-row
    grid, shares of 16 and 8 rows) on the data shard's 2 samples of the 2 D-sample
    batch, with drop-connect and the step's generator ('drop'); at world 2 also the
    camera step without the axis ('cameras'), with the row layers made to raise."""
    import fiery_tpu_torch.parallel.mesh as mesh
    from fiery_tpu_torch.parallel.mesh import make_parallel_trainer
    from fiery_tpu_torch.training.trainer import step_generator
    shards = world // CAMERAS
    shard, camera = divmod(rank, CAMERAS)
    cfg = tiny_cfg(TINY_BEV)
    trainer = make_parallel_trainer(seeded_trainer(cfg), cameras=CAMERAS, bev_parallel=True)
    out = {'mesh': (trainer.rank, trainer.world, trainer.camera, trainer.cameras),
           'share': (trainer.model.row_share.index, trainer.model.row_share.edges),
           'groups': {n: dist.get_world_size(m.process_group)
                      for n, m in trainer.model.named_modules() if hasattr(m, 'process_group')}}
    batch = {k: rows_of(v, shard, shards) for k, v in global_batch(cfg, n=2 * shards).items()}
    generator = step_generator(STEP_SEED, 0, 'cpu', shard, shards, camera, CAMERAS)
    out['drop'] = take_step(trainer, batch, generator)
    if world != 2:
        return out

    def refuse(*a, **k):
        raise AssertionError('a row layer ran without the BEV axis')
    level = mesh.RowShare.level
    for cls in (mesh._ExchangeHalo, mesh._GatherRows, mesh._GroupRowMean):
        cls.apply = refuse
    mesh.RowShare.level = refuse
    try:
        trainer = make_parallel_trainer(seeded_trainer(cfg), cameras=CAMERAS)
        out['cameras'] = take_step(trainer, batch, step_generator(STEP_SEED, 0, 'cpu', shard,
                                                                  shards, camera, CAMERAS))
    finally:
        for cls in (mesh._ExchangeHalo, mesh._GatherRows, mesh._GroupRowMean):
            del cls.apply
        mesh.RowShare.level = level
    return out


CASES = {'bn': case_bn, 'steps': case_steps, 'gather': case_gather, 'cameras': case_cameras,
         'rows': case_rows, 'bev': case_bev}


def spawn_ranks(case, tmp_path, world=2, timeout=600):
    """Run ``case`` on ``world`` gloo ranks in fresh processes; their results in
    rank order. Raises with a rank's output when one fails."""
    env = {**os.environ, 'GLOO_SOCKET_IFNAME': 'lo', 'PYTHONPATH': REPO}
    init = tmp_path / f'{case}_init'
    outs = [tmp_path / f'{case}_rank{r}.pt' for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), str(init), str(outs[r])], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f'rank {r} of {case} exited {p.returncode}:\n{logs[r][-4000:]}')
    return [torch.load(o, weights_only=False) for o in outs]


def main(argv):
    case, rank, world, init, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(2)
    dist.init_process_group('gloo', init_method=f'file://{init}', rank=rank, world_size=world)
    try:
        torch.save(CASES[case](rank, world), out)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1:])
