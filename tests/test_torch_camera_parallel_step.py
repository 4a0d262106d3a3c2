"""The port's camera-parallel training step on the CPU: gloo ranks
(tests/torch_parallel_worker.py, ``make_parallel_trainer(..., cameras=2)``) at
(D data shards, M camera ranks) = (1, 2) and (2, 2), each encoding 1 of the 2
cameras of tests/test_torch_trainer.py's TINY, against the port's one process on
the global batch (2 samples a data shard), with drop-connect on and the same step
generator (``step_generator(..., shard, shards, camera, cameras)`` draws the global
batch's noise and masks); and, at (2, 2) without drop-connect and with explicit
noise, against the JAX package's ``make_parallel_train_step`` on
``create_mesh(4, n_model=2)`` with ``shard_batch``, whose image sharding names the
``model`` axis (tests/test_parallel.py's camera test): the losses, running
statistics and parameters of that step, and the Adam moments of the JAX data-axis
step on the same batch, as that camera-sharded step doubles the encoder's
depthwise weight gradients (a test of its own documents that fault of the
reference). At (2, 2) the ranks also take that data-axis step with the BEV
spatial axis on. Also, at (2, 2) and
tests/test_parallel.py's tiny_cfg shapes with 2 cameras, the validation's scores
from the data group's summed states and DEPTH_CULL's keeps.

Tolerances are tests/test_torch_parallel_step.py's: losses and running statistics
1e-4 relative (1e-5 absolute); gradients as relative L2 errors, 1e-2 a top-level
module and 1e-1 a leaf; parameters within 2 lr (after one Adam step a bound that
any gradient meets: the backward is held by the gradients and moments); the Adam
first moments as the gradients. Every rank's parameters, statistics and moments are equal bit for bit.
The JAX steps run in a reference process whose XLA CPU code is capped at AVX2
(tests/torch_jax_reference.py), so that the reference does not move with the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fiery_tpu.models.efficientnet as jax_efficientnet
from fiery_tpu.parallel.mesh import create_mesh, make_parallel_train_step, shard_batch
from fiery_tpu.training.trainer import TrainState
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu.utils.weight_import import import_torch_state_dict
import fiery_tpu_torch.models.efficientnet as efficientnet
from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
from fiery_tpu_torch.train import depth_plane_keep, validate
from fiery_tpu_torch.training.trainer import step_generator
from fiery_tpu_torch.utils.weight_import import checkpoint_state_from_jax
from torch_jax_reference import start_jax_reference
from test_torch_parallel_step import _ExplicitNoise, assert_gradients_close, assert_step_close
from torch_parallel_worker import (CAMERAS, STEP_SEED, TINY_CAM, TINY_DP_CAM, TINY_JAX,
                                   cam_cull_cfg,
                                   global_batch, global_noise, seeded_trainer, spawn_ranks,
                                   take_step, tiny_cfg)
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

MESHES = {(1, 2): 2, (2, 2): 4}     # (data shards, camera ranks): world size


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Each mesh's ranks' results, spawned when a test first asks for them."""
    spawned = {}

    def get(mesh):
        if mesh not in spawned:
            spawned[mesh] = spawn_ranks('cameras', tmp_path_factory.mktemp(f'cameras{mesh[0]}'),
                                        MESHES[mesh], timeout=400)
        return spawned[mesh]
    return get


def assert_ranks_equal(got):
    for g in got[1:]:
        for k in got[0]['state']:
            assert torch.equal(g['state'][k], got[0]['state'][k]), k
        for a, b in zip(g['exp_avg'], got[0]['exp_avg']):
            assert torch.equal(a, b)
        assert torch.equal(g['total'], got[0]['total'])


@pytest.mark.parametrize('mesh', sorted(MESHES))
def test_camera_ranks_take_the_one_process_step(ranks, mesh):
    """Drop-connect on, the step's generator: losses, gradients, running statistics,
    parameters and Adam moments of the global batch's step; every rank equal."""
    shards, cameras = mesh
    results = ranks(mesh)
    for r, got in enumerate(results):
        assert got['mesh'] == (r // cameras, shards, r % cameras, cameras)
    cfg = tiny_cfg(TINY_CAM)
    trainer = seeded_trainer(cfg)
    names = [n for n, _ in trainer.model.named_parameters()] + \
        ['uncertainty.' + k for k in trainer.uncertainty]
    want = take_step(trainer, global_batch(cfg, n=2 * shards), step_generator(STEP_SEED, 0, 'cpu'))
    got = [r['drop'] for r in results]
    assert_ranks_equal(got)
    np.testing.assert_allclose(float(got[0]['total']), float(want['total']), rtol=1e-4)
    assert_step_close(got[0], want, cfg.OPTIMIZER.LR, set(names))
    assert_gradients_close(got[0]['grads'], want['grads'])
    assert_gradients_close(dict(zip(names, got[0]['exp_avg'])),
                           dict(zip(names, want['exp_avg'])))
    # the encoder learned from both cameras' images: its gradient is not that of one
    enc = [n for n in names if n.startswith('encoder.')]
    assert sum(float(got[0]['grads'][n].norm()) for n in enc) > 0


def jax_step(jtrainer, params, variables, batch, mesh):
    """The JAX package's ``make_parallel_train_step`` on ``mesh`` from the imported
    weights: (the batch as sharded, the new state, the metrics)."""
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables['batch_stats'], opt_state=jtrainer.tx.init(params))
    sharded = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    new, metrics = make_parallel_train_step(jtrainer, mesh)(state, sharded, jax.random.key(0))
    return sharded, jax.tree.map(np.asarray, new), metrics


def norm_ratio(a, b):
    return float(torch.as_tensor(a).double().norm() / torch.as_tensor(b).double().norm())


def jax_camera_steps():
    """Drop-connect off, explicit noise, on the global batch of two samples: the
    JAX package's ``make_parallel_train_step`` on a (data 2, model 2) mesh and on
    the data axis alone (``create_mesh(2)``), from the seeded port's weights. Returns
    (the parameter names, the camera-sharded image's partition spec, each step's
    metrics and new state in the port's checkpoint layout). Run in a reference
    process (``torch_jax_reference``)."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_efficientnet, efficientnet):
            mp.setitem(module._GLOBAL_PARAMS, 'b0', (1.0, 1.0, 0.0))
        cfg, jcfg = tiny_cfg(TINY_JAX), jax_get_cfg(cfg_dict=TINY_JAX)
        port = seeded_trainer(cfg)
        jtrainer = _ExplicitNoise(jcfg)
        variables, _ = import_torch_state_dict(
            {'model.' + k: v.numpy() for k, v in port.model.state_dict().items()},
            jtrainer.model_cfg, strict=True)
        params = {'model': variables['params'],
                  'uncertainty': {k: np.float32(0.0) for k in port.uncertainty}}
        batch = {**global_batch(cfg, n=2), 'noise': global_noise(cfg, n=2)}
        camera_mesh = create_mesh(4, n_model=CAMERAS)
        assert camera_mesh.devices.shape == (2, 2)
        sharded, new, metrics = jax_step(jtrainer, params, variables, batch, camera_mesh)
        _, data_new, data_metrics = jax_step(jtrainer, params, variables, batch,
                                             create_mesh(2))

        def port_state(new):
            return checkpoint_state_from_jax({'step': 1, 'params': new.params,
                                              'batch_stats': new.batch_stats,
                                              'opt_state': new.opt_state}, port)
        names = [n for n, _ in port.model.named_parameters()] + \
            ['uncertainty.' + k for k in port.uncertainty]
        return {'names': names, 'image_spec': str(sharded['image'].sharding.spec),
                'camera': ({k: np.asarray(v) for k, v in metrics.items()}, port_state(new)),
                'data': ({k: np.asarray(v) for k, v in data_metrics.items()},
                         port_state(data_new))}


@pytest.fixture(autouse=True, scope='module')
def jax_steps_started(tmp_path_factory):
    """``jax_camera_steps`` in a reference process whose XLA code is capped at AVX2
    (tests/torch_jax_reference.py: under AVX-512 XLA's f32 reductions move the
    data-axis step's decoder gradient by about the bound), started with the module
    so that its compile runs beside the ranks of the first tests."""
    reference = start_jax_reference('test_torch_camera_parallel_step:jax_camera_steps',
                                    tmp_path_factory.mktemp('jax_steps'))
    yield reference
    reference.stop()


@pytest.fixture(scope='module')
def jax_steps(jax_steps_started):
    return jax_steps_started.result()


def exp_avg_by_name(state, names):
    return {n: state['optimizer']['state'][i]['exp_avg'] for i, n in enumerate(names)}


def test_camera_ranks_take_the_jax_camera_sharded_step(ranks, jax_steps):
    """(2, 2), drop-connect off, explicit noise: the port's four ranks against
    ``make_parallel_train_step`` on a (data 2, model 2) mesh whose image sharding
    puts the cameras on ``model``: its losses and running statistics (the forward),
    and its parameters within 2 lr. After one Adam step each update is about
    lr sign(m), so two updates never differ by more than about 2 lr: that bound
    holds for any gradient and checks nothing of the backward. The backward is held
    to the JAX data-axis step on the same batch instead (tests/test_parallel.py
    holds that step to one device): the ranks' Adam first moments against its, at
    the gradients' tolerances. The camera-sharded step's own moments are not the
    global batch's (``test_the_jax_camera_sharded_step_scales_the_depthwise_gradients``)."""
    results = ranks((2, 2))
    cfg, names = tiny_cfg(TINY_JAX), jax_steps['names']
    (metrics, want_state), (_, data_state) = jax_steps['camera'], jax_steps['data']
    assert 'model' in jax_steps['image_spec']
    want = {'losses': {k: np.asarray(v) for k, v in metrics.items() if k != 'total_loss'},
            'state': {**want_state['model'], **{'uncertainty.' + k: v for k, v in
                                                want_state['uncertainty'].items()}}}
    got = [r['noise'] for r in results]
    assert_ranks_equal(got)
    assert sorted(got[0]['losses']) == sorted(want['losses'])
    np.testing.assert_allclose(float(got[0]['total']), float(metrics['total_loss']),
                               rtol=1e-4, atol=1e-5)
    assert_step_close(got[0], want, cfg.OPTIMIZER.LR, set(names))
    data = exp_avg_by_name(data_state, names)
    assert_gradients_close(dict(zip(names, got[0]['exp_avg'])),
                           {n: torch.as_tensor(v) for n, v in data.items()})


def test_bev_ranks_take_the_jax_data_axis_step(ranks, jax_steps):
    """(2, 2) with the BEV spatial axis (each rank of a camera group trains 16 of
    the 32 rows), drop-connect off, explicit noise: the port's four ranks against
    the JAX data-axis step on the same batch, which the JAX package's own tests hold
    to one device: its losses, running statistics, parameters within 2 lr and Adam
    first moments, at the tolerances above. (The JAX package's bev-parallel step
    runs on the camera axis, whose depthwise gradients it scales, so it is not the
    reference.)"""
    results = ranks((2, 2))
    cfg, names = tiny_cfg(TINY_JAX), jax_steps['names']
    metrics, state = jax_steps['data']
    want = {'losses': {k: v for k, v in metrics.items() if k != 'total_loss'},
            'state': {**state['model'], **{'uncertainty.' + k: v for k, v in
                                           state['uncertainty'].items()}}}
    got = [r['bev_noise'] for r in results]
    assert_ranks_equal(got)
    assert sorted(got[0]['losses']) == sorted(want['losses'])
    np.testing.assert_allclose(float(got[0]['total']), float(metrics['total_loss']),
                               rtol=1e-4, atol=1e-5)
    assert_step_close(got[0], want, cfg.OPTIMIZER.LR, set(names))
    assert_gradients_close(dict(zip(names, got[0]['exp_avg'])),
                           {n: torch.as_tensor(v) for n, v in
                            exp_avg_by_name(state, names).items()})


def test_the_jax_camera_sharded_step_scales_the_depthwise_gradients(jax_steps):
    """Documents a fault of the reference, not of the port: the pinned JAX's
    camera-sharded ``make_parallel_train_step`` multiplies by M the gradient of
    every depthwise convolution's weight in the encoder (the weight gradient of a
    grouped convolution whose batch is split over both mesh axes), and so raises
    the clipped global norm, which scales every other gradient by one factor (0.951
    here). Its Adam moments against the data-axis step's on the same batch: the
    same directions, the depthwise weights' ratio M times the others'. This is why
    the port's backward is held to the data-axis step. A JAX that partitions
    grouped convolutions correctly fails this test and nothing of the port's."""
    names = jax_steps['names']
    camera_state, data_state = jax_steps['camera'][1], jax_steps['data'][1]
    camera, data = exp_avg_by_name(camera_state, names), exp_avg_by_name(data_state, names)
    depthwise = [n for n in names if n.startswith('encoder.') and '_depthwise_conv' in n]
    assert depthwise
    ratios = {n: norm_ratio(camera[n], data[n]) for n in names
              if float(torch.as_tensor(data[n]).norm()) > 0}
    others = [r for n, r in ratios.items() if n not in depthwise]
    clip = float(np.median(others))
    assert clip < 0.99                       # the scaled gradients raised the clipped norm
    np.testing.assert_allclose(others, clip, rtol=1e-3)
    np.testing.assert_allclose([ratios[n] for n in depthwise], CAMERAS * clip, rtol=1e-3)


def test_validation_counts_each_data_shard_once_and_the_depth_keeps_agree(ranks):
    """(2, 2) at TINY_DP_CAM (tests/test_parallel.py's tiny_cfg shapes, 2 cameras):
    each rank validates its data shard's share with every camera, and the states of
    its data group (the ranks of its camera index, one a data shard), summed, score
    as one process on the whole val set; the maximum of the ranks' DEPTH_CULL keeps
    is the keep of the global first batch."""
    results = ranks((2, 2))
    cfg = tiny_cfg(TINY_DP_CAM)
    trainer = seeded_trainer(cfg)
    trainloader, valloader = prepare_dataloaders(cfg, batch_size=2 * cfg.BATCHSIZE)
    iou, vpq = validate(trainer, valloader)
    cull = cam_cull_cfg()
    want_keep = [int(k) for k in depth_plane_keep(cull, numeric_batch(trainloader.peek()))]
    assert len(want_keep) == 2
    assert max(want_keep) < cull.LIFT.D_BOUND[1] - cull.LIFT.D_BOUND[0]
    for rank, r in enumerate(results):
        assert r['validate_group'] == [rank % CAMERAS, rank % CAMERAS + CAMERAS]
        got_iou, got_vpq = r['validate']
        np.testing.assert_allclose(got_iou, iou, rtol=1e-12)
        np.testing.assert_allclose(got_vpq, vpq, rtol=1e-12)
        assert r['depth_keep'] == want_keep
