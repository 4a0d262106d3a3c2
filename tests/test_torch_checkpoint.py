"""fiery_tpu_torch.utils.checkpoint (save, load, resume) and the JAX state
converter, on the CPU at a tiny size.

Held bit for bit: a checkpoint's round trip (model, uncertainty weights, Adam
state, step), sync and async; N training steps against k steps, a checkpoint, a
fresh trainer that loads it and N - k more steps (each step's noise and
drop-connect drawn from ``step_generator(seed, step)``); a reference-format
(Lightning) dict of ``tests/torch_golden.py`` ``GoldenFiery`` loaded strictly
through ``load_torch_full_checkpoint`` against the JAX import of that dict; an
efficientnet_pytorch dict loaded into the backbone only. ``find_latest_checkpoint``
resolves the same trees as the JAX function. A JAX TrainState after one optax
step, converted by ``checkpoint_state_from_jax``, takes the second step as JAX
does, within ``tests/test_torch_trainer.py``'s tolerances: losses 1e-4 relative
(1e-5 absolute), BatchNorm statistics the same, and on JAX's gradients the
updated parameters within 1e-6 absolute and the Adam moments within 1e-4 of each
leaf's largest moment. The moments carry the clip's factor: the gradient's global
norm (2e5 here, against a clip of 5, over entries that span many decades) is an
f32 sum in another order on each side (one dot product against optax's per-leaf
sums), which moves that factor by up to ~1e-5 (1.4e-5 of a leaf's largest
second moment seen with two threads); Adam's update divides it out.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fiery_tpu.models.efficientnet as jax_efficientnet
from fiery_tpu.training.losses import compute_losses as jax_compute_losses
from fiery_tpu.training.trainer import Trainer as JaxTrainer
from fiery_tpu.utils.checkpoint import find_latest_checkpoint as jax_find_latest
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu.utils.weight_import import import_torch_state_dict
import fiery_tpu_torch.models.efficientnet as efficientnet
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.serve import init_params
from fiery_tpu_torch.training.trainer import Trainer, step_generator
from fiery_tpu_torch.utils.checkpoint import (find_latest_checkpoint, load_checkpoint,
                                              load_pretrained_params, load_torch_full_checkpoint,
                                              load_torch_pretrained, save_checkpoint,
                                              save_checkpoint_async, wait_for_async_save)
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.weight_import import checkpoint_state_from_jax, train_state_from_jax

TINY = {
    'PRECISION': 32, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2, 'BATCHSIZE': 2,
    'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B']},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
             'D_BOUND': [2.0, 8.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4},
              'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 1}},
    'DATASET': {'NAME': 'synthetic'},
}


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    """Two intra-op threads: the suite runs files in parallel processes, and a
    training step on every core of each of them oversubscribes the machine (a
    step here then takes 20x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_drop_connect(monkeypatch):
    for module in (jax_efficientnet, efficientnet):
        monkeypatch.setitem(module._GLOBAL_PARAMS, 'b0', (1.0, 1.0, 0.0))


def _flat(state, prefix=''):
    """Every tensor and number of a nested state, keyed by its path."""
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            out.update(_flat(v, f'{prefix}/{k}'))
        return out
    if isinstance(state, (list, tuple)):
        return _flat(dict(enumerate(state)), prefix)
    return {prefix: state}


def _assert_states_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert torch.equal(g.cpu(), w.cpu()), k
        else:
            assert g == w, k


def _batches(cfg, n, seed=2):
    ds = SyntheticFutureDataset(cfg, n_samples=2 * n, n_instances=2, seed=seed)
    return [ds.get_batch([2 * i, 2 * i + 1]) for i in range(n)]


def _trained(cfg, batches, seed=0):
    trainer = Trainer(cfg, device='cpu')
    init_params(trainer.model, seed=seed)
    for batch in batches:
        trainer.train_step(batch, step_generator(seed, trainer.step, 'cpu'))
    return trainer


def test_round_trip_bit_for_bit_sync_and_async(tmp_path):
    cfg = get_cfg(cfg_dict=TINY)
    trainer = _trained(cfg, _batches(cfg, 1))
    state = trainer.state()
    assert trainer.step == 1 and len(state['optimizer']['state']) == len(trainer.params)
    save_checkpoint(str(tmp_path / 'sync'), trainer, cfg)
    save_checkpoint_async(str(tmp_path / 'async'), trainer, cfg)
    wait_for_async_save()
    for name in ('sync', 'async'):
        loaded, loaded_cfg = load_checkpoint(str(tmp_path / name))
        _assert_states_equal(loaded, state)
        assert loaded_cfg.convert_to_dict() == cfg.convert_to_dict()
        fresh = Trainer(loaded_cfg, device='cpu')
        fresh.load_state(loaded, strict=True)
        _assert_states_equal(fresh.state(), state)


def test_a_state_that_does_not_fit_raises(tmp_path):
    cfg = get_cfg(cfg_dict=TINY)
    trainer = Trainer(cfg, device='cpu')
    state = trainer.state()
    missing = dict(state, model={k: v for k, v in state['model'].items()
                                 if not k.startswith('decoder.bn1')})
    with pytest.raises(RuntimeError, match='decoder.bn1'):
        Trainer(cfg, device='cpu').load_state(missing, strict=True)
    wider = get_cfg(cfg_dict={**TINY, 'MODEL': {**TINY['MODEL'],
                                                 'ENCODER': {**TINY['MODEL']['ENCODER'],
                                                             'OUT_CHANNELS': 24}}})
    with pytest.raises(RuntimeError, match='size mismatch'):
        Trainer(wider, device='cpu').load_state(state, strict=True)
    with pytest.raises(KeyError, match='uncertainty'):
        Trainer(cfg, device='cpu').load_state(
            dict(state, uncertainty={'segmentation_weight': torch.zeros(())}), strict=True)


def test_resume_equals_uninterrupted_training_bit_for_bit(tmp_path):
    """3 steps against 1 step, a checkpoint, a fresh trainer (other seeded weights)
    that loads it, and 2 more steps."""
    cfg = get_cfg(cfg_dict=TINY)
    batches = _batches(cfg, 3)
    whole = _trained(cfg, batches)
    first = _trained(cfg, batches[:1])
    save_checkpoint(str(tmp_path / 'ckpt'), first, cfg)
    state, _ = load_checkpoint(str(tmp_path / 'ckpt'))
    resumed = Trainer(cfg, device='cpu')
    init_params(resumed.model, seed=5)
    resumed.load_state(state, strict=True)
    for batch in batches[1:]:
        resumed.train_step(batch, step_generator(0, resumed.step, 'cpu'))
    assert resumed.step == whole.step == 3
    _assert_states_equal(resumed.state(), whole.state())


def _make_tree(root, layout):
    """Checkpoint directories as both packages lay them out when complete
    (state/state.pt and config.json); entries without config.json are cut short."""
    for rel, complete, mtime in layout:
        path = os.path.join(root, rel)
        os.makedirs(os.path.join(path, 'state'), exist_ok=True)
        open(os.path.join(path, 'state', 'state.pt'), 'w').close()
        if complete:
            open(os.path.join(path, 'config.json'), 'w').close()
        run = os.path.dirname(path)
        if mtime is not None:
            os.utime(run, (mtime, mtime))


@pytest.mark.parametrize('layout,target', [
    ([('run/checkpoint_epoch0', True, None)], 'run/checkpoint_epoch0'),
    ([('run/checkpoint_epoch0', True, None), ('run/checkpoint_epoch2', True, None),
      ('run/checkpoint_epoch10', False, None)], 'run'),
    ([('run/checkpoint_epoch3', True, None), ('run/checkpoint_final', True, None)], 'run'),
    ([('run/checkpoint_epoch3', True, None), ('run/checkpoint_final', False, None)], 'run'),
    ([('run/checkpoint_epoch1', False, None)], 'run'),
    ([('logs/a/checkpoint_epoch4', True, 1000), ('logs/b/checkpoint_epoch1', True, 2000),
      ('logs/c/checkpoint_epoch9', False, 3000)], 'logs'),
    ([('logs/a/checkpoint_final', True, 3000), ('logs/b/checkpoint_epoch1', True, 2000)],
     'logs'),
    ([], 'nowhere'),
])
def test_find_latest_checkpoint_resolves_as_jax(tmp_path, layout, target):
    _make_tree(str(tmp_path), layout)
    path = str(tmp_path / target)
    assert find_latest_checkpoint(path) == jax_find_latest(path)


def test_find_latest_checkpoint_skips_uncommitted(tmp_path):
    cfg = get_cfg(cfg_dict=TINY)
    trainer = Trainer(cfg, device='cpu')
    save_checkpoint(str(tmp_path / 'run' / 'checkpoint_epoch0'), trainer, cfg)
    save_checkpoint(str(tmp_path / 'run' / 'checkpoint_epoch1'), trainer, cfg)
    os.remove(tmp_path / 'run' / 'checkpoint_epoch1' / 'config.json')
    assert find_latest_checkpoint(str(tmp_path / 'run')) == str(
        tmp_path / 'run' / 'checkpoint_epoch0')
    assert find_latest_checkpoint(str(tmp_path / 'run' / 'checkpoint_epoch1')) is None


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_converted_jax_state_continues_as_the_next_jax_step(no_drop_connect):
    """JAX takes two steps (explicit noise); its state after the first, converted,
    gives the port's second step: the same losses and BatchNorm statistics, and on
    JAX's second gradients the same parameters and Adam moments."""
    cfg, jcfg = get_cfg(cfg_dict=TINY), jax_get_cfg(cfg_dict=TINY)
    trainer = Trainer(cfg, device='cpu')
    init_params(trainer.model, seed=3)
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for name, buf in trainer.model.named_buffers():
            if name.endswith('running_var'):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    batches = _batches(cfg, 2, seed=5)
    noises = [rng.randn(2, 1, 4).astype(np.float32) for _ in range(2)]

    jtrainer = JaxTrainer(jcfg)
    variables, _ = import_torch_state_dict(
        {'model.' + k: v.numpy() for k, v in trainer.model.state_dict().items()},
        jtrainer.model_cfg, strict=True)
    params = {'model': variables['params'],
              'uncertainty': {k: np.float32(0.0) for k in trainer.uncertainty}}

    @jax.jit
    def step(params, batch_stats, opt_state, batch, noise):
        def loss_fn(params):
            labels, fdi = jtrainer.prepare_future_labels(batch)
            output, mutated = jtrainer.model.apply(
                {'params': params['model'], 'batch_stats': batch_stats},
                batch['image'], batch['intrinsics'], batch['extrinsics'],
                batch['future_egomotion'], fdi, noise=noise, train=True,
                mutable=['batch_stats'])
            losses = jax_compute_losses(output, labels, params['uncertainty'], jcfg)
            return sum(losses.values()), (losses, mutated['batch_stats'])
        (_, (losses, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = jtrainer.tx.update(grads, opt_state, params)
        import optax
        return optax.apply_updates(params, updates), stats, opt_state, losses, grads

    opt_state = jtrainer.tx.init(params)
    stats = variables['batch_stats']
    history = []
    for batch, noise in zip(batches, noises):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params, stats, opt_state, losses, grads = step(params, stats, opt_state, jb,
                                                       jnp.asarray(noise))
        history.append(_np_tree(dict(params=params, stats=stats, opt_state=opt_state,
                                     losses=losses, grads=grads)))
    after1, after2 = history

    state = checkpoint_state_from_jax(
        {'step': 1, 'params': after1['params'], 'batch_stats': after1['stats'],
         'opt_state': after1['opt_state']}, trainer)
    port = Trainer(cfg, device='cpu')
    port.load_state(state, strict=True)
    assert port.step == 1
    losses, _ = port.compute_gradients(batches[1], noise=torch.from_numpy(noises[1]))
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(after2['losses'][k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    new_stats, _ = train_state_from_jax(after2['params'], after2['stats'], port.model.cfg)
    got = port.model.state_dict()
    for k in [k for k in new_stats if k.endswith(('running_mean', 'running_var'))]:
        np.testing.assert_allclose(got[k].numpy(), new_stats[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)

    grads, grad_uw = train_state_from_jax(after2['grads'], after2['stats'], port.model.cfg)
    with torch.no_grad():
        for name, p in port.model.named_parameters():
            p.grad = grads[name].clone()
        for k, p in port.uncertainty.items():
            p.grad = grad_uw[k].clone()
    port.apply_gradients()
    assert port.step == 2
    want = checkpoint_state_from_jax(
        {'step': 2, 'params': after2['params'], 'batch_stats': after2['stats'],
         'opt_state': after2['opt_state']}, port)
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want['model'][name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    for k, p in port.uncertainty.items():
        np.testing.assert_allclose(float(p.detach()), float(want['uncertainty'][k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    mine = port.optimizer.state_dict()['state']
    for i, theirs in want['optimizer']['state'].items():
        assert float(mine[i]['step']) == float(theirs['step']) == 2.0
        for key in ('exp_avg', 'exp_avg_sq'):
            scale = float(theirs[key].abs().max())
            np.testing.assert_allclose(mine[i][key].numpy(), theirs[key].numpy(), rtol=0,
                                       atol=1e-4 * scale, err_msg=f'{i} {key}')


GOLDEN_CFG = {**TINY, 'MODEL': {**TINY['MODEL'],
                                'FUTURE_PRED': {'N_GRU_BLOCKS': 2, 'N_RES_LAYERS': 2}}}


@pytest.fixture(scope='module')
def golden_ckpt(tmp_path_factory):
    """A reference-format checkpoint: GoldenFiery's state_dict under ``model.`` with
    the uncertainty weights, and the config in ``hyper_parameters``."""
    from torch_golden import (GoldenFiery, prefixed_state_dict, randomize_bn3d_stats,
                              randomize_bn_stats)
    torch.manual_seed(11)
    golden = GoldenFiery(
        C=16, D=6, final_dim=(64, 96), d_bound=(2.0, 8.0, 1.0), x_bound=(-8.0, 8.0, 0.5),
        y_bound=(-8.0, 8.0, 0.5), receptive_field=3, n_future=2, latent_dim=4,
        start_out_channels=16, n_gru_blocks=2, n_res_layers=2,
        future_in_channels=16 + 2 * 6, version='b0')
    randomize_bn_stats(golden, seed=5)
    randomize_bn3d_stats(golden.temporal_model, seed=6)
    sd = prefixed_state_dict(golden, 'model.')
    for i, k in enumerate(('segmentation_weight', 'centerness_weight', 'offset_weight',
                           'flow_weight')):
        sd[f'model.{k}'] = np.float32(0.1 * (i + 1))
    path = str(tmp_path_factory.mktemp('golden') / 'fiery.ckpt')
    torch.save({'state_dict': {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                'hyper_parameters': jax_get_cfg(cfg_dict=GOLDEN_CFG).convert_to_dict(),
                'epoch': 19, 'global_step': 12345}, path)
    return path, sd


def test_reference_checkpoint_loads_strictly_and_equals_the_jax_import(golden_ckpt):
    path, sd = golden_ckpt
    state, cfg = load_torch_full_checkpoint(path)
    assert tuple(cfg.IMAGE.FINAL_DIM) == (64, 96) and cfg.MODEL.FUTURE_PRED.N_GRU_BLOCKS == 2
    assert state['step'] == 0 and state['optimizer'] is None
    variables, uncertainty = import_torch_state_dict(
        sd, JaxTrainer(jax_get_cfg(cfg_dict=GOLDEN_CFG)).model_cfg, strict=True)
    trainer = Trainer(cfg, device='cpu')
    want, want_uw = train_state_from_jax({'model': variables['params'],
                                          'uncertainty': uncertainty},
                                         variables['batch_stats'], trainer.model.cfg)
    assert sorted(state['model']) == sorted(want)
    for k, v in want.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(state['model'][k], v), k
    for k, v in want_uw.items():
        assert torch.equal(state['uncertainty'][k], v), k
    trainer.load_state(state, strict=True)
    torch.testing.assert_close(trainer.uncertainty['flow_weight'].detach(),
                               torch.tensor(0.4), rtol=0, atol=0)


def test_reference_checkpoint_that_does_not_fit_raises(golden_ckpt, tmp_path):
    path, sd = golden_ckpt
    blob = torch.load(path, weights_only=False)
    del blob['state_dict']['model.decoder.first_conv.weight']
    torch.save(blob, str(tmp_path / 'short.ckpt'))
    with pytest.raises(RuntimeError, match='decoder.first_conv.weight'):
        load_torch_full_checkpoint(str(tmp_path / 'short.ckpt'))
    # without strict the same file warm-starts every other entry
    state, cfg = load_torch_full_checkpoint(str(tmp_path / 'short.ckpt'), strict=False)
    assert 'decoder.first_conv.weight' in state['model']


def test_efficientnet_dict_loads_the_backbone_only(tmp_path):
    cfg = get_cfg(cfg_dict=TINY)
    trainer = Trainer(cfg, device='cpu')
    init_params(trainer.model, seed=1)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    g = torch.Generator().manual_seed(2)
    backbone = {k: torch.randn(v.shape, generator=g) if v.is_floating_point() else v
                for k, v in trainer.model.encoder.backbone.state_dict().items()}
    extra = {'_conv_head.weight': torch.zeros(8, 4, 1, 1), '_bn1.weight': torch.ones(8),
             '_fc.weight': torch.zeros(10, 8), '_blocks.15._project_conv.weight':
             torch.zeros(4, 4, 1, 1)}
    torch.save({**backbone, **extra}, str(tmp_path / 'effnet.pth'))
    load_torch_pretrained(str(tmp_path / 'effnet.pth'), trainer)
    after = trainer.model.state_dict()
    for k, v in after.items():
        if k.startswith('encoder.backbone.'):
            assert torch.equal(v, backbone[k[len('encoder.backbone.'):]]), k
        else:
            assert torch.equal(v, before[k]), k
    del backbone['_bn0.weight']
    torch.save(backbone, str(tmp_path / 'short.pth'))
    with pytest.raises(KeyError, match='_bn0.weight'):
        load_torch_pretrained(str(tmp_path / 'short.pth'), trainer)


def test_load_pretrained_params_copies_matching_parameters(tmp_path):
    """A warm start from a checkpoint directory: the parameters whose name and shape
    match; the running statistics, the Adam state and the step stay."""
    cfg = get_cfg(cfg_dict=TINY)
    source = _trained(cfg, _batches(cfg, 1))
    save_checkpoint(str(tmp_path / 'ckpt'), source, cfg)
    target = Trainer(cfg, device='cpu')
    stats = {k: v.clone() for k, v in target.model.state_dict().items() if 'running' in k}
    load_pretrained_params(str(tmp_path / 'ckpt'), target)
    for (name, p), (_, q) in zip(target.model.named_parameters(),
                                 source.model.named_parameters()):
        assert torch.equal(p, q), name
    for k, v in stats.items():
        assert torch.equal(target.model.state_dict()[k], v), k
    assert target.step == 0 and not target.optimizer.state_dict()['state']
