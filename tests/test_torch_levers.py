"""The lift levers of fiery_tpu_torch against the JAX reference (CPU, f32):
LIFT.WARP_FREE (``warp_points_to_present``), LIFT.DEPTH_CULL
(``compute_depth_plane_keep`` and the culled splat), DATASET.PREWARP_LABELS
(``warp_label_stack``, ``PrewarpTransform``), the configuration checks, and the
combination LIFT.TOPK + LIFT.WARP_FREE (+ TRIM_TRAIN + PREWARP_LABELS in training)
through a tiny model: the eval forward within rtol/atol 1e-3, and one training step
held as tests/test_torch_trainer.py holds the dense one (losses 1e-4, gradients as
relative L2 errors 1e-2 per module and 1e-1 per leaf). Both JAX computations go
through one jit. Inputs are made with numpy from fixed seeds and handed to both.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fiery_tpu.models.efficientnet as jax_efficientnet
from fiery_tpu.data import label_warp as JLW
from fiery_tpu.models.fiery import FieryConfig as JaxFieryConfig
from fiery_tpu.ops import lift_splat as JLS
from fiery_tpu.ops import warp as JW
from fiery_tpu.training.losses import compute_losses as jax_compute_losses
from fiery_tpu.training.trainer import Trainer as JaxTrainer
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu.utils.weight_import import import_torch_state_dict
import fiery_tpu_torch.models.efficientnet as efficientnet
from fiery_tpu_torch.data import label_warp as LW
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.models.fiery import FieryConfig
from fiery_tpu_torch.ops import lift_splat as LS
from fiery_tpu_torch.ops import warp as W
from fiery_tpu_torch.serve import calibrate_batchnorm, init_params, make_request
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.geometry import calculate_birds_eye_view_parameters
from fiery_tpu_torch.utils.weight_import import train_state_from_jax
from test_lift_splat import _nuscenes_like_rig
from test_torch_trainer import TINY

BOUNDS = ((-8.0, 8.0, 0.5), (-8.0, 8.0, 0.5), (-10.0, 10.0, 20.0))
COMBO = {**TINY, 'LIFT': {**TINY['LIFT'], 'TOPK': 3, 'WARP_FREE': True},
         'DATASET': {'PREWARP_LABELS': True},
         'MODEL': {**TINY['MODEL'],
                   'TEMPORAL_MODEL': {**TINY['MODEL']['TEMPORAL_MODEL'], 'TRIM_TRAIN': True}}}


def _flows(rng, b):
    flow = np.zeros((b, 6), np.float32)
    flow[:, 0] = rng.uniform(-3, 3, b)
    flow[:, 1] = rng.uniform(-2, 2, b)
    flow[:, 5] = rng.uniform(-0.3, 0.3, b)
    return flow


def test_warp_points_to_present_matches_jax():
    """Random metric points and poses, non-square bounds, 1e-5; and for poses of an
    integer number of cells (the design of tests/test_warp.py) the voxel ids of the
    moved points equal the JAX package's exactly."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-50, 50, (4, 7, 9, 2)).astype(np.float32)
    flow = _flows(rng, 4)
    bounds = ((-50.0, 50.0), (-30.0, 30.0))
    want = np.asarray(JW.warp_points_to_present(jnp.asarray(pts), jnp.asarray(flow),
                                                (50.0, 30.0), bounds))
    got = W.warp_points_to_present(torch.from_numpy(pts), torch.from_numpy(flow),
                                   (50.0, 30.0), bounds).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    shift = np.zeros((2, 6), np.float32)
    shift[:, :2] = [[1.5, -1.0], [-0.5, 2.0]]                # 3, -2, -1 and 4 cells
    xyz = rng.uniform(-7, 7, (2, 500, 3)).astype(np.float32)
    ids = []
    for mod, tensor in ((JW, jnp.asarray), (W, torch.from_numpy)):
        xy = mod.warp_points_to_present(tensor(xyz[..., :2]), tensor(shift), (8.0, 8.0),
                                        ((-8.0, 8.0), (-8.0, 8.0)))
        moved = np.concatenate([np.asarray(xy), xyz[..., 2:]], axis=-1)
        ids.append(np.asarray(JLS.voxel_ids(jnp.asarray(moved), res, start, dim)))
    np.testing.assert_array_equal(ids[1], ids[0])


def test_compute_depth_plane_keep_and_culled_splat_match_jax():
    """The keep counts equal the JAX package's, and the splat with them equals the JAX
    culled splat (planes sliced out), as does a splat with counts that cull planes
    inside the grid (so the routing to the dump bin is exercised)."""
    frustum = LS.create_frustum((64, 96), 8, (2.0, 26.0, 1.0))
    intr, extr = _nuscenes_like_rig(n_frames=2, jitter=0.3, seed=2)
    intr[...] = np.array([[76.0, 0, 48], [0, 76.0, 30], [0, 0, 1]], np.float32)
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    keep = LS.compute_depth_plane_keep(frustum, intr, extr, res, start, dim)
    want_keep = JLS.compute_depth_plane_keep(frustum, intr, extr, res, start, dim)
    np.testing.assert_array_equal(keep, want_keep)
    assert keep.dtype == np.int32 and keep.sum() < 0.8 * 24 * 6

    geometry = np.array(JLS.get_geometry(jnp.asarray(frustum), jnp.asarray(intr),
                                         jnp.asarray(extr)))        # (2, 6, D, h, w, 3)
    rng = np.random.RandomState(3)
    D, h, w = frustum.shape[:3]
    depth = rng.dirichlet(np.ones(D), (2, 6, h, w)).astype(np.float32)
    feat = rng.randn(2, 6, h, w, 5).astype(np.float32)
    lifted = jnp.asarray(depth[..., :, None] * feat[..., None, :])
    full = LS.lift_splat_depth(torch.from_numpy(depth), torch.from_numpy(feat),
                               torch.from_numpy(geometry), res, start, dim)
    for counts in (tuple(keep), (3, 1, 2, 4, 24, 2)):
        want = np.asarray(jax.jit(lambda f, g: JLS.lift_splat(
            f, g, res, start, dim, depth_keep=counts))(lifted, jnp.asarray(geometry)))
        got = LS.lift_splat_depth(torch.from_numpy(depth), torch.from_numpy(feat),
                                  torch.from_numpy(geometry), res, start, dim,
                                  depth_keep=counts)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got, full)        # the second counts culled in-grid planes
    with pytest.raises(ValueError, match='cameras'):
        LS.lift_splat_depth(torch.from_numpy(depth), torch.from_numpy(feat),
                            torch.from_numpy(geometry), res, start, dim, depth_keep=(1, 2))


def test_culled_ids_take_their_counts_from_a_device_constant(monkeypatch):
    """The culled splat's voxel ids equal those of the form that built a tensor from
    the counts on every call (planes d >= keep[n] of camera n sent to the dump
    bin), its output still equals the JAX package's culled splat, and a second call
    makes no tensor from a Python list (so a culled forward can be captured)."""
    frustum = LS.create_frustum((32, 48), 8, (2.0, 10.0, 1.0))
    intr, extr = _nuscenes_like_rig(n_frames=1, jitter=0.3, seed=4)
    intr[...] = np.array([[38.0, 0, 24], [0, 38.0, 16], [0, 0, 1]], np.float32)
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    geometry = np.array(JLS.get_geometry(jnp.asarray(frustum), jnp.asarray(intr),
                                         jnp.asarray(extr)))        # (1, 6, D, h, w, 3)
    rng = np.random.RandomState(5)
    D, h, w = frustum.shape[:3]
    depth = rng.dirichlet(np.ones(D), (1, 6, h, w)).astype(np.float32)
    feat = rng.randn(1, 6, h, w, 3).astype(np.float32)
    counts = (3, 1, 8, 5, 0, 2)
    seen = []
    monkeypatch.setattr(LS, 'bev_pool', lambda d, f, ids, *a: seen.append(ids) or
                        LS.bev_pool_plain(d, f, ids, *a))
    args = (torch.from_numpy(depth), torch.from_numpy(feat), torch.from_numpy(geometry),
            res, start, dim)
    got = LS.lift_splat_depth(*args, depth_keep=counts)
    ids = LS.voxel_ids(torch.from_numpy(geometry), res, start, dim).permute(0, 1, 3, 4, 2)
    X, Y, Z = (int(d) for d in dim)
    keep = torch.tensor(counts)
    culled = torch.arange(D) >= keep.view(1, 6, 1, 1, 1)
    want_ids = torch.where(culled, torch.full_like(ids, X * Y * Z), ids)
    assert torch.equal(seen[0], want_ids) and int(culled.sum()) > 0
    lifted = jnp.asarray(depth[..., :, None] * feat[..., None, :])
    want = np.asarray(jax.jit(lambda f, g: JLS.lift_splat(
        f, g, res, start, dim, depth_keep=counts))(lifted, jnp.asarray(geometry)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    def no_tensor(*a, **kw):
        raise AssertionError('lift_splat_depth made a tensor from a Python list')

    monkeypatch.setattr(torch, 'tensor', no_tensor)
    again = LS.lift_splat_depth(*args, depth_keep=counts)
    assert torch.equal(again, got) and torch.equal(seen[1], want_ids)


def test_host_label_prewarp_matches_jax():
    cfg, jcfg = get_cfg(cfg_dict=TINY), jax_get_cfg(cfg_dict=TINY)
    batch = SyntheticFutureDataset(cfg, n_samples=2, n_instances=2, seed=7).get_batch([0, 1])
    batch['future_egomotion'][..., [0, 1, 5]] += np.random.RandomState(8).uniform(
        -1.0, 1.0, batch['future_egomotion'][..., [0, 1, 5]].shape).astype(np.float32)
    got = LW.make_prewarp_transform(cfg)(batch)
    want = JLW.make_prewarp_transform(jcfg)(batch)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got['warped_label_stack'], want['warped_label_stack'])
    stack = np.random.RandomState(9).randn(2, 3, 32, 32, 7).astype(np.float32)
    ego = _flows(np.random.RandomState(10), 6).reshape(2, 3, 6)
    np.testing.assert_array_equal(LW.warp_label_stack(stack, ego, (8.0, 8.0)),
                                  JLW.warp_label_stack(stack, ego, (8.0, 8.0)))


@pytest.mark.parametrize('lift', [{'DEPTH_CULL': True, 'TOPK': 2},
                                  {'DEPTH_CULL': True, 'WARP_FREE': True},
                                  {'TOPK': 7}])
def test_from_cfg_refuses_what_the_jax_package_refuses(lift):
    """DEPTH_CULL is exclusive with TOPK and WARP_FREE, and TOPK lies in [1, D]: both
    packages raise ValueError."""
    overrides = {**TINY, 'LIFT': {**TINY['LIFT'], **lift}}
    with pytest.raises(ValueError):
        JaxFieryConfig.from_cfg(jax_get_cfg(cfg_dict=overrides))
    with pytest.raises(ValueError):
        FieryConfig.from_cfg(get_cfg(cfg_dict=overrides))
    with pytest.raises(ValueError, match='exclusive'):
        FieryConfig(depth_topk=8, depth_keep=(48,) * 6)
    with pytest.raises(ValueError, match='exclusive'):
        FieryConfig(warp_free=True, depth_keep=(48,) * 6)


def test_every_lever_is_accepted():
    mc = FieryConfig.from_cfg(get_cfg(cfg_dict=COMBO))
    assert (mc.depth_topk, mc.warp_free, mc.temporal_trim_train) == (3, True, True)
    cull = get_cfg(cfg_dict={**TINY, 'LIFT': {**TINY['LIFT'], 'DEPTH_CULL': True}})
    assert FieryConfig.from_cfg(cull).depth_keep is None
    assert Trainer(cull, depth_keep=[4, 5], device='cpu').model.cfg.depth_keep == (4, 5)


@pytest.fixture(scope='module')
def combo():
    """One jit of the JAX eval forward and of the JAX training step's losses,
    gradients and new BatchNorm statistics, and the port's counterparts, from the
    port's seeded weights imported into the JAX tree. The training state and batch
    are built as tests/test_torch_trainer.py builds them (BatchNorm statistics
    randomised, uncertainty weights, a synthetic batch, here prewarped on the host,
    and the latent noise); the eval forward takes BatchNorm statistics calibrated on
    two clips, so that its activations are of unit scale. Drop-connect off."""
    mp = pytest.MonkeyPatch()
    for module in (jax_efficientnet, efficientnet):
        mp.setitem(module._GLOBAL_PARAMS, 'b0', (1.0, 1.0, 0.0))
    try:
        cfg, jcfg = get_cfg(cfg_dict=COMBO), jax_get_cfg(cfg_dict=COMBO)
        trainer = Trainer(cfg, device='cpu')
        jtrainer = JaxTrainer(jcfg)
        assert (jtrainer.model_cfg.depth_topk, jtrainer.model_cfg.warp_free,
                jtrainer.model_cfg.temporal_trim_train) == (3, True, True)
        init_params(trainer.model, seed=3)
        inputs = ('image', 'intrinsics', 'extrinsics', 'future_egomotion')

        def jax_variables():
            return import_torch_state_dict(
                {'model.' + k: v.numpy().copy()
                 for k, v in trainer.model.state_dict().items()},
                jtrainer.model_cfg, strict=True)[0]

        calibrate_batchnorm(trainer.model, [make_request(cfg, seed=s) for s in (6, 7)])
        serve_stats = jax_variables()['batch_stats']
        request = make_request(cfg, seed=8)
        request['future_egomotion'][..., 5] = 0.2          # a turn: rotated geometry
        trainer.model.eval()
        with torch.no_grad():
            got_served = trainer.model(*(torch.from_numpy(request[k]) for k in inputs))
        trainer.model.train()

        rng = np.random.RandomState(4)
        with torch.no_grad():
            for name, buf in trainer.model.named_buffers():
                if name.endswith('running_mean'):
                    buf.copy_(torch.from_numpy(rng.randn(*buf.shape).astype(np.float32) * 0.1))
                elif name.endswith('running_var'):
                    buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape)
                                               .astype(np.float32)))
            for p in trainer.uncertainty.values():
                p.fill_(float(rng.randn() * 0.2))
        batch = SyntheticFutureDataset(cfg, n_samples=2, n_instances=2,
                                       seed=5).get_batch([0, 1])
        batch = LW.make_prewarp_transform(cfg)(batch)
        noise = rng.randn(2, 1, 4).astype(np.float32)
        variables = jax_variables()
        params = {'model': variables['params'],
                  'uncertainty': {k: np.float32(v.item())
                                  for k, v in trainer.uncertainty.items()}}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(params, batch_stats):
            labels, fdi = jtrainer.prepare_future_labels(jbatch)
            output, mutated = jtrainer.model.apply(
                {'params': params['model'], 'batch_stats': batch_stats},
                *(jbatch[k] for k in inputs), fdi, noise=jnp.asarray(noise), train=True,
                mutable=['batch_stats'])
            losses = jax_compute_losses(output, labels, params['uncertainty'], jcfg)
            return sum(losses.values()), (losses, mutated['batch_stats'])

        def both(params, batch_stats, serve_stats, req):
            served = jtrainer.model.apply(
                {'params': params['model'], 'batch_stats': serve_stats}, *req, None,
                train=False)
            return served, jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats)

        served, ((_, (losses, new_stats)), grads) = jax.jit(both)(
            params, variables['batch_stats'], serve_stats,
            tuple(jnp.asarray(request[k]) for k in inputs))
        want = dict(served=jax.tree.map(np.asarray, served), losses=jax.tree.map(
            np.asarray, losses), new_stats=jax.tree.map(np.asarray, new_stats),
            grads=jax.tree.map(np.asarray, grads), stats=variables['batch_stats'])
        got_losses, _ = trainer.compute_gradients(batch, noise=torch.from_numpy(noise))
        return trainer, got_served, got_losses, want
    finally:
        mp.undo()


def test_combo_eval_forward_matches_jax(combo):
    trainer, got, _, want = combo
    assert sorted(got) == sorted(k for k, v in want['served'].items() if v is not None)
    for k, v in got.items():
        assert float(np.abs(want['served'][k]).max()) > 0, k
        np.testing.assert_allclose(v.numpy(), want['served'][k], rtol=1e-3, atol=1e-3,
                                   err_msg=k)


def test_combo_train_step_matches_jax(combo):
    """Losses within 1e-4; every gradient leaf within a relative L2 error of 1e-1
    (its norm floored at 1e-3 of its module's); the modules the levers change (the
    encoder, under K5's backward and the warp-free geometry, the temporal model under
    TRIM_TRAIN, the distributions) within 1e-2 per module; and the new BatchNorm
    statistics, which TRIM_TRAIN takes over the kept frames only.

    The future prediction and the decoder, which no lever changes, are held per leaf
    only: their f32 gradients here move by 0.2-0.7 % between two runs of one framework
    that differ only in the order of their sums (XLA's or torch's CPU threading), and
    the JAX-to-port error is 0.9-1.8 % over torch's thread counts 1 to 6, while the
    modules upstream agree within 1e-4. tests/test_torch_trainer.py holds them per
    module on the dense step."""
    trainer, _, losses, want = combo
    assert sorted(losses) == sorted(want['losses'])
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(want['losses'][k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    grads, grad_uw = train_state_from_jax(want['grads'], want['stats'], trainer.model.cfg)
    got = {n: p.grad.double() for n, p in trainer.model.named_parameters()}
    assert len(got) > 100
    for m in sorted({n.split('.')[0] for n in got}):
        names = [n for n in got if n.split('.')[0] == m]
        a = torch.cat([got[n].flatten() for n in names])
        b = torch.cat([grads[n].double().flatten() for n in names])
        if m not in ('future_prediction', 'decoder'):
            assert float((a - b).norm() / b.norm()) <= 1e-2, m
        for n in names:
            floor = max(float(grads[n].double().norm()), 1e-3 * float(b.norm()))
            assert float((got[n] - grads[n].double()).norm()) / floor <= 1e-1, n
    for k, p in trainer.uncertainty.items():
        np.testing.assert_allclose(float(p.grad), float(grad_uw[k]), rtol=1e-4, atol=1e-6)
    new, _ = train_state_from_jax(want['grads'], want['new_stats'], trainer.model.cfg)
    state = trainer.model.state_dict()
    names = [k for k in new if k.endswith(('running_mean', 'running_var'))]
    assert len(names) > 100
    for k in names:
        np.testing.assert_allclose(state[k].numpy(), new[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_train_cli_culls_depth_planes_and_prewarps_labels(capsys, monkeypatch, tmp_path):
    """The train CLI computes DEPTH_CULL's keep counts from the first batch's
    calibrations, and under PREWARP_LABELS trains on host-warped label stacks."""
    from fiery_tpu_torch import train
    from fiery_tpu_torch.serve import BASELINE
    opts = ['DATASET.NAME', 'synthetic', 'PRECISION', '32', 'N_FUTURE_FRAMES', '2',
            'BATCHSIZE', '1', 'IMAGE.FINAL_DIM', '(64, 96)',
            'IMAGE.NAMES', "['CAM_A', 'CAM_B']", 'LIFT.X_BOUND', '[-8.0, 8.0, 0.5]',
            'LIFT.Y_BOUND', '[-8.0, 8.0, 0.5]', 'LIFT.D_BOUND', '[2.0, 30.0, 2.0]',
            'LIFT.DEPTH_CULL', 'True', 'DATASET.PREWARP_LABELS', 'True',
            'MODEL.ENCODER.NAME', 'efficientnet-b0', 'MODEL.ENCODER.OUT_CHANNELS', '16',
            'MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS', '16',
            'MODEL.DISTRIBUTION.LATENT_DIM', '4', 'MODEL.FUTURE_PRED.N_GRU_BLOCKS', '1',
            'MODEL.FUTURE_PRED.N_RES_LAYERS', '1', 'DATASET.N_SYNTHETIC_SAMPLES', '1',
            'LOG_DIR', str(tmp_path)]
    # TensorBoard stays out of the run (its import pulls in TensorFlow where installed)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    trainer = train.main(['--config', BASELINE, '--device', 'cpu', '--steps', '1',
                          *opts]).trainer
    lines = [line for line in capsys.readouterr().out.strip().splitlines()
             if line.startswith('{')]
    keep = trainer.model.cfg.depth_keep
    assert lines[0] == '{"depth_keep": %s}' % list(keep)
    cfg = get_cfg(cfg_dict={'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B']},
                            'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
                                     'D_BOUND': [2.0, 30.0, 2.0]},
                            'N_FUTURE_FRAMES': 2, 'BATCHSIZE': 1})
    batch = SyntheticFutureDataset(cfg, n_samples=1, seed=0).get_batch([0])
    assert keep == tuple(train.depth_plane_keep(cfg, batch))
    assert len(keep) == 2 and min(keep) < 14          # far planes of the 14 are culled
    assert len(lines) == 2 and '"total_loss"' in lines[1]
