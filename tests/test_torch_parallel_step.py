"""The port's data-parallel training step on the CPU: the tiny step
(tests/test_parallel.py's tiny_cfg shapes, 2 samples a rank) on two gloo ranks
(tests/torch_parallel_worker.py, ``make_parallel_trainer``) against the port's one
process on the 4-sample batch, with drop-connect on and the same step generator
(``step_generator(..., rank, world)`` draws the global batch's noise and masks);
and, without drop-connect and with explicit noise, against the JAX package's
``make_parallel_train_step`` on a 2-device mesh (conftest's virtual CPU devices),
at tests/test_torch_trainer.py's TINY shapes (its global batch of 2, a sample a
rank), where that file holds the port's one-process step to JAX's.
Also the validation's scores from the ranks' summed states, and DEPTH_CULL's keeps.

Tolerances are tests/test_torch_trainer.py's: losses and running statistics
1e-4 relative (1e-5 absolute); gradients as relative L2 errors, 1e-2 a top-level
module and 1e-1 a leaf (floored at 1e-3 of its module's norm), the uncertainty
weights' 1e-4. After the first Adam step a parameter moves by about lr times the
sign of its clipped gradient, so a gradient that is zero up to rounding may move
it the other way: parameters are held within 2 lr; the Adam first moments (0.1
times the clipped, decayed gradient) as the gradients are. The ranks' parameters
and statistics are equal bit for bit.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fiery_tpu.models.efficientnet as jax_efficientnet
from fiery_tpu.parallel.mesh import create_mesh, make_parallel_train_step, shard_batch
from fiery_tpu.training.trainer import Trainer as JaxTrainer, TrainState
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu.utils.weight_import import import_torch_state_dict
import fiery_tpu_torch.models.efficientnet as efficientnet
from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
from fiery_tpu_torch.train import depth_plane_keep, validate
from fiery_tpu_torch.training.trainer import step_generator
from fiery_tpu_torch.utils.weight_import import checkpoint_state_from_jax
from torch_parallel_worker import (STEP_SEED, TINY_JAX, cull_cfg, global_batch, global_noise,
                                   seeded_trainer, spawn_ranks, take_step, tiny_cfg)

WORLD = 2


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return spawn_ranks('steps', tmp_path_factory.mktemp('steps'), WORLD)


def assert_gradients_close(got, want):
    """Relative L2: 1e-2 a top-level module, 1e-1 a leaf (floored at 1e-3 of its
    module's norm)."""
    assert sorted(got) == sorted(want)
    for m in sorted({n.split('.')[0] for n in got}):
        names = [n for n in got if n.split('.')[0] == m]
        a = torch.cat([got[n].double().flatten() for n in names])
        b = torch.cat([want[n].double().flatten() for n in names])
        assert float((a - b).norm() / b.norm()) <= 1e-2, m
        for n in names:
            floor = max(float(want[n].double().norm()), 1e-3 * float(b.norm()))
            assert float((got[n].double() - want[n].double()).norm()) / floor <= 1e-1, n


def assert_step_close(got, want, lr, param_names):
    for k, v in want['losses'].items():
        np.testing.assert_allclose(float(got['losses'][k]), float(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k, v in want['state'].items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got['state'][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
        elif k in param_names:
            np.testing.assert_allclose(got['state'][k], v, rtol=0, atol=2 * lr + 1e-6,
                                       err_msg=k)


def test_two_ranks_take_the_one_process_step(ranks):
    """Drop-connect on, the step's generator: losses, gradients, running statistics,
    parameters and Adam moments of the 4-sample step; both ranks equal."""
    cfg = tiny_cfg()
    trainer = seeded_trainer(cfg)
    names = [n for n, _ in trainer.model.named_parameters()] + \
        ['uncertainty.' + k for k in trainer.uncertainty]
    want = take_step(trainer, global_batch(cfg), step_generator(STEP_SEED, 0, 'cpu'))
    got = [r['drop'] for r in ranks]
    for k in got[0]['state']:
        assert torch.equal(got[0]['state'][k], got[1]['state'][k]), k
    for a, b in zip(got[0]['exp_avg'], got[1]['exp_avg']):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(got[0]['total']), float(want['total']), rtol=1e-4)
    assert_step_close(got[0], want, cfg.OPTIMIZER.LR, set(names))
    assert_gradients_close(got[0]['grads'], want['grads'])
    assert_gradients_close(dict(zip(names, got[0]['exp_avg'])),
                           dict(zip(names, want['exp_avg'])))
    # drop-connect ran: some sample's branch was dropped by the shared draws
    assert float(want['losses']['segmentation']) > 0


class _ExplicitNoise(JaxTrainer):
    """The JAX trainer with the latent noise of the step taken from the batch
    (``noise``, sharded with it on the mesh's data axis)."""

    def train_step(self, state, batch, rng):
        batch = dict(batch)
        noise = batch.pop('noise')
        model = self.model
        self.model = types.SimpleNamespace(apply=functools.partial(model.apply, noise=noise))
        try:
            return super().train_step(state, batch, rng)
        finally:
            self.model = model


def test_two_ranks_take_the_jax_two_device_step(ranks, monkeypatch):
    """Drop-connect off, explicit noise: the port's world-2 step against
    ``make_parallel_train_step`` on a 2-device mesh."""
    for module in (jax_efficientnet, efficientnet):
        monkeypatch.setitem(module._GLOBAL_PARAMS, 'b0', (1.0, 1.0, 0.0))
    cfg, jcfg = tiny_cfg(TINY_JAX), jax_get_cfg(cfg_dict=TINY_JAX)
    port = seeded_trainer(cfg)
    jtrainer = _ExplicitNoise(jcfg)
    variables, _ = import_torch_state_dict(
        {'model.' + k: v.numpy() for k, v in port.model.state_dict().items()},
        jtrainer.model_cfg, strict=True)
    params = {'model': variables['params'],
              'uncertainty': {k: np.float32(0.0) for k in port.uncertainty}}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables['batch_stats'], opt_state=jtrainer.tx.init(params))
    mesh = create_mesh(WORLD)
    batch = {**global_batch(cfg, n=WORLD), 'noise': global_noise(cfg, n=WORLD)}
    new, metrics = make_parallel_train_step(jtrainer, mesh)(
        state, shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh),
        jax.random.key(0))
    new = jax.tree.map(np.asarray, new)
    want_state = checkpoint_state_from_jax(
        {'step': 1, 'params': new.params, 'batch_stats': new.batch_stats,
         'opt_state': new.opt_state}, port)
    names = [n for n, _ in port.model.named_parameters()] + \
        ['uncertainty.' + k for k in port.uncertainty]
    want = {'losses': {k: np.asarray(v) for k, v in metrics.items() if k != 'total_loss'},
            'state': {**want_state['model'], **{'uncertainty.' + k: v for k, v in
                                                want_state['uncertainty'].items()}}}
    got = [r['noise'] for r in ranks]
    for k in got[0]['state']:
        assert torch.equal(got[0]['state'][k], got[1]['state'][k]), k
    assert sorted(got[0]['losses']) == sorted(want['losses'])
    np.testing.assert_allclose(float(got[0]['total']), float(metrics['total_loss']),
                               rtol=1e-4, atol=1e-5)
    assert_step_close(got[0], want, cfg.OPTIMIZER.LR, set(names))
    theirs = want_state['optimizer']['state']
    assert_gradients_close(dict(zip(names, got[0]['exp_avg'])),
                           {n: theirs[i]['exp_avg'] for i, n in enumerate(names)})


def test_validation_sums_the_ranks_and_the_depth_keeps_agree(ranks):
    """The ranks' validation on their shards of the val set, summed, scores as one
    process on all of it; the maximum of the ranks' DEPTH_CULL keeps is the keep of
    the global first batch."""
    cfg = tiny_cfg()
    trainer = seeded_trainer(cfg)
    trainloader, valloader = prepare_dataloaders(cfg, batch_size=WORLD * cfg.BATCHSIZE)
    iou, vpq = validate(trainer, valloader)
    want_keep = [int(k) for k in depth_plane_keep(cull_cfg(), numeric_batch(trainloader.peek()))]
    assert max(want_keep) < cull_cfg().LIFT.D_BOUND[1] - cull_cfg().LIFT.D_BOUND[0]
    for r in ranks:
        got_iou, got_vpq = r['validate']
        np.testing.assert_allclose(got_iou, iou, rtol=1e-12)
        np.testing.assert_allclose(got_vpq, vpq, rtol=1e-12)
        assert r['depth_keep'] == want_keep
