"""One training step of fiery_tpu_torch against the JAX reference step (CPU, f32).

Same weights (the port's seeded ones, imported into the JAX tree), same synthetic
batch, same latent noise, drop-connect off on both sides (the JAX package's rate is
patched in-process; drop-connect has its own test in test_torch_modules.py). Held:
the loss dict, every gradient leaf relative to that leaf's largest |g|, and the new
BatchNorm statistics; then the optimizer alone, the port's update against the optax
chain on identical gradients. Also: the trainer and the train CLI refuse the CPU
unless asked.

The gradients are held as relative L2 errors, per top-level module (1e-2) and per
leaf (1e-1), not to 1e-3 of each leaf's largest |g|: neither framework's f32 step
is that accurate on every leaf. The deep layers of the decoder and the BatchNorms'
biases have gradients that are sums of terms of both signs, which f32 rounding
moves by several per cent of their largest value, and XLA's CPU reductions sum in
order. A wrong gradient formula (the splat's or the warp's backward, say) gives
errors of order 1 on every leaf upstream of it.

The JAX step runs in a reference process whose XLA CPU code is capped at AVX2
(tests/torch_jax_reference.py). Under AVX-512 XLA's f32 reductions take another
order, which moves the future distribution's first BatchNorm's batch variance by
about the statistics' bound (1e-4 relative) from its f64 value, while the port's
stays within 1e-6 of it on any host.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fiery_tpu.models.efficientnet as jax_efficientnet
from fiery_tpu.training.trainer import Trainer as JaxTrainer
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu.utils.weight_import import import_torch_state_dict
import fiery_tpu_torch.models.efficientnet as efficientnet
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.serve import init_params
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.weight_import import train_state_from_jax
from torch_jax_reference import start_jax_reference
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

# efficientnet-b0, 2 cameras at 64x96, D = 6, C = 16, a 32x32 BEV, rf 3, 2 future
# frames, latent 4, 1 GRU block of 2 bottlenecks, batch 2, f32
TINY = {
    'PRECISION': 32, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2, 'BATCHSIZE': 2,
    'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B']},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
             'D_BOUND': [2.0, 8.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4},
              'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 2}},
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def seeded_step_inputs(seed=3):
    """The port's trainer with seeded weights, running statistics and uncertainty
    weights, the synthetic batch and the latent noise of the step."""
    cfg = get_cfg(cfg_dict=TINY)
    trainer = Trainer(cfg, device='cpu')
    init_params(trainer.model, seed=seed)
    rng = np.random.RandomState(seed + 1)
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
                                   seed=seed + 2).get_batch([0, 1])
    noise = rng.randn(2, 1, 4).astype(np.float32)
    return trainer, batch, noise


def drop_connect_off():
    mp = pytest.MonkeyPatch()
    for module in (jax_efficientnet, efficientnet):
        mp.setitem(module._GLOBAL_PARAMS, 'b0', (1.0, 1.0, 0.0))
    return mp


def jax_train_step(seed=3):
    """JAX's step on the seeded state and batch, through one jit: the total, the
    losses, the new statistics, the gradients, the parameters and the statistics
    before (numpy trees). Run in a reference process (``torch_jax_reference``)."""
    mp = drop_connect_off()
    try:
        trainer, batch, noise = seeded_step_inputs(seed)
        jcfg = jax_get_cfg(cfg_dict=TINY)
        jtrainer = JaxTrainer(jcfg)
        variables, _ = import_torch_state_dict(
            {'model.' + k: v.numpy() for k, v in trainer.model.state_dict().items()},
            jtrainer.model_cfg, strict=True)
        params = {'model': variables['params'],
                  'uncertainty': {k: np.float32(v.item())
                                  for k, v in trainer.uncertainty.items()}}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(params, batch_stats):
            labels, fdi = jtrainer.prepare_future_labels(jbatch)
            output, mutated = jtrainer.model.apply(
                {'params': params['model'], 'batch_stats': batch_stats},
                jbatch['image'], jbatch['intrinsics'], jbatch['extrinsics'],
                jbatch['future_egomotion'], fdi, noise=jnp.asarray(noise), train=True,
                mutable=['batch_stats'])
            from fiery_tpu.training.losses import compute_losses
            losses = compute_losses(output, labels, params['uncertainty'], jcfg)
            return sum(losses.values()), (losses, mutated['batch_stats'])

        (total, (losses, new_stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params, variables['batch_stats'])
        return dict(total=float(total), losses=_np_tree(losses),
                    new_stats=_np_tree(new_stats), grads=_np_tree(grads),
                    params=_np_tree(params), stats=_np_tree(variables['batch_stats']))
    finally:
        mp.undo()


@pytest.fixture(autouse=True, scope='module')
def jax_step_started(tmp_path_factory):
    """``jax_train_step`` in a reference process whose XLA code is capped at AVX2
    (tests/torch_jax_reference.py: XLA's AVX-512 reductions move this step's batch
    statistics by about the bound), started with the module so that its compile
    runs beside the module's first tests."""
    reference = start_jax_reference('test_torch_trainer:jax_train_step',
                                    tmp_path_factory.mktemp('jax_step'))
    yield reference
    reference.stop()


def run_steps(reference, seed=3):
    """Both steps on one seeded state and batch: JAX's from the reference process,
    the port's here."""
    mp = drop_connect_off()
    try:
        trainer, batch, noise = seeded_step_inputs(seed)
        jtrainer = JaxTrainer(jax_get_cfg(cfg_dict=TINY))
        got_losses, got_total = trainer.compute_gradients(batch, noise=torch.from_numpy(noise))
        return trainer, jtrainer, got_losses, float(got_total), reference.result()
    finally:
        mp.undo()


@pytest.fixture(scope='module')
def step(jax_step_started):
    return run_steps(jax_step_started)


def test_trainer_and_train_cli_refuse_the_cpu_unless_asked(monkeypatch, capsys, tmp_path):
    from fiery_tpu_torch import train
    from fiery_tpu_torch.serve import BASELINE
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        Trainer(get_cfg(cfg_dict=TINY))
    tiny_opts = ['DATASET.NAME', 'synthetic', 'PRECISION', '32', 'N_FUTURE_FRAMES', '2',
                 'BATCHSIZE', '1', 'IMAGE.FINAL_DIM', '(64, 96)',
                 'IMAGE.NAMES', "['CAM_A', 'CAM_B']", 'LIFT.X_BOUND', '[-8.0, 8.0, 0.5]',
                 'LIFT.Y_BOUND', '[-8.0, 8.0, 0.5]', 'LIFT.D_BOUND', '[2.0, 8.0, 1.0]',
                 'MODEL.ENCODER.NAME', 'efficientnet-b0', 'MODEL.ENCODER.OUT_CHANNELS', '16',
                 'MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS', '16',
                 'MODEL.DISTRIBUTION.LATENT_DIM', '4', 'MODEL.FUTURE_PRED.N_GRU_BLOCKS', '1',
                 'MODEL.FUTURE_PRED.N_RES_LAYERS', '1', 'DATASET.N_SYNTHETIC_SAMPLES', '2',
                 'LOGGING_INTERVAL', '1', 'LOG_DIR', str(tmp_path)]
    # TensorBoard stays out of the run (its import pulls in TensorFlow where installed)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with pytest.raises(RuntimeError, match='CUDA'):
        train.main(['--config', BASELINE, '--steps', '1', *tiny_opts])
    # baseline.yml's own set is nuScenes trainval under ./nuscenes/, absent here
    with pytest.raises(FileNotFoundError, match='v1.0-trainval'):
        train.main(['--config', BASELINE, '--device', 'cpu', '--steps', '1'])
    trainer = train.main(['--config', BASELINE, '--device', 'cpu', '--steps', '2',
                          *tiny_opts]).trainer
    lines = [line for line in capsys.readouterr().out.strip().splitlines()
             if line.startswith('{')]
    assert len(lines) == 2 and '"total_loss"' in lines[0] and '"step": 2' in lines[1]
    assert next(trainer.model.parameters()).device.type == 'cpu'


def test_eval_step_and_prewarped_labels():
    """eval_step: the eval forward (present distribution, zero noise) with the future
    distribution's parameters and the losses, the model left in training mode; a
    batch that carries its warped label stack gives the same labels."""
    from fiery_tpu_torch.ops.warp import cumulative_warp_features_reverse
    cfg = get_cfg(cfg_dict=TINY)
    trainer = Trainer(cfg, device='cpu')
    init_params(trainer.model, seed=1)
    batch = SyntheticFutureDataset(cfg, n_samples=2, n_instances=2, seed=2).get_batch([0, 1])
    output, labels, losses = trainer.eval_step(batch)
    assert trainer.model.training
    assert {'future_mu', 'future_log_sigma', 'present_mu'} <= set(output)
    assert output['segmentation'].shape == (2, 3, 32, 32, 2)
    assert all(torch.isfinite(v) for v in losses.values())
    t = trainer.to_device(batch)
    stack = torch.cat([t['segmentation'][:, 2:].float(), t['instance'][:, 2:, ..., None].float(),
                       t['centerness'][:, 2:], t['offset'][:, 2:], t['flow'][:, 2:]], dim=-1)
    prewarped = dict(batch, warped_label_stack=cumulative_warp_features_reverse(
        stack, t['future_egomotion'][:, 2:], spatial_extent=(8.0, 8.0)))
    got, got_fdi = trainer.prepare_future_labels(trainer.to_device(prewarped))
    want, want_fdi = trainer.prepare_future_labels(t)
    assert sorted(got) == sorted(want) and torch.equal(got_fdi, want_fdi)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_train_step_losses_match_jax(step):
    trainer, _, losses, total, want = step
    assert sorted(losses) == sorted(want['losses'])
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(want['losses'][k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(total, want['total'], rtol=1e-4, atol=1e-5)


def test_train_step_gradients_match_jax(step):
    """Relative L2 error of the gradients: within 1e-2 over each top-level module,
    within 1e-1 on each leaf (whose norm is floored at 1e-3 of its module's, for
    the leaves whose gradient is zero up to rounding); see the module docstring."""
    trainer, _, _, _, want = step
    grads, grad_uw = train_state_from_jax(want['grads'], want['stats'], trainer.model.cfg)
    got = {n: p.grad.double() for n, p in trainer.model.named_parameters()}
    assert sorted(got) == sorted(n for n in grads if n in got) and len(got) > 100
    modules = sorted({n.split('.')[0] for n in got})
    for m in modules:
        names = [n for n in got if n.split('.')[0] == m]
        a = torch.cat([got[n].flatten() for n in names])
        b = torch.cat([grads[n].double().flatten() for n in names])
        module_err = float((a - b).norm() / b.norm())
        assert module_err <= 1e-2, (m, module_err)
        for n in names:
            floor = max(float(grads[n].double().norm()), 1e-3 * float(b.norm()))
            leaf_err = float((got[n] - grads[n].double()).norm()) / floor
            assert leaf_err <= 1e-1, (n, leaf_err)
    for k, p in trainer.uncertainty.items():
        np.testing.assert_allclose(float(p.grad), float(grad_uw[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert float(trainer.model.future_distribution.last_conv[1].weight.grad.abs().max()) > 0


def test_train_step_batch_statistics_match_jax(step):
    trainer, _, _, _, want = step
    new, _ = train_state_from_jax(want['params'], want['new_stats'], trainer.model.cfg)
    got = trainer.model.state_dict()
    names = [k for k in new if k.endswith(('running_mean', 'running_var'))]
    assert len(names) > 100
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), new[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_optimizer_update_matches_optax(step):
    """On identical gradients (the JAX step's), the port's clip + Adam with coupled
    L2 moves every parameter as the optax chain does, within 1e-6."""
    trainer, jtrainer, _, _, want = step
    grads, grad_uw = train_state_from_jax(want['grads'], want['stats'], trainer.model.cfg)
    before, _ = train_state_from_jax(want['params'], want['stats'], trainer.model.cfg)
    # the port's state is the JAX one (same weights), so optax starts where it does
    updates, _ = jax.jit(lambda g, p: jtrainer.tx.update(g, jtrainer.tx.init(p), p))(
        want['grads'], want['params'])
    upd, upd_uw = train_state_from_jax(_np_tree(updates), want['stats'], trainer.model.cfg)
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in jax.tree.leaves(want['grads']))))
    assert norm > trainer.cfg.GRAD_NORM_CLIP          # the clip is active
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.grad = grads[name].clone()
        for k, p in trainer.uncertainty.items():
            p.grad = grad_uw[k].clone()
    start = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    trainer.apply_gradients()
    for name, p in trainer.model.named_parameters():
        torch.testing.assert_close(start[name], before[name], rtol=0, atol=0)
        np.testing.assert_allclose((p.detach() - start[name]).numpy(), upd[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    for k, p in trainer.uncertainty.items():
        np.testing.assert_allclose(float(p.detach()) - float(want['params']['uncertainty'][k]),
                                   float(upd_uw[k]), rtol=0, atol=1e-6, err_msg=k)
