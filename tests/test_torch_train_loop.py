"""The training loop (``python -m fiery_tpu_torch.train``) and the evaluation
(``python -m fiery_tpu_torch.evaluate``) on the CPU at a tiny size.

The loop writes the JAX loop's scalar keys to metrics.jsonl and the epoch and
final checkpoints; ``--resume auto`` continues from the newest complete
checkpoint at its step; ``--steps`` ends a run. The evaluation of converted
weights agrees with the JAX ``eval_checkpoint(state_cfg=...)`` over the same 2
val batches, with the host tracker and with the device tracker: IoU, PQ, SQ and
RQ at both crops within 1e-6 absolute. Both run the eval forward of the same
weights in f32; the test first counts the pixels whose argmax differs between the
two forwards, prints them, and requires none (a differing pixel would move the
IoU by up to 1 / its support). With random weights no predicted instance matches a
true one, so PQ, SQ and RQ are 0 on both sides there; a second pair of cases
replaces both forwards with heads made from the batch's own labels, cut so that
most instances match but not all, and holds PQ, SQ and RQ strictly between 0 and
1 at both crops, equal to JAX's, with the chosen tracker called.

TensorBoard is kept out of these runs (its import pulls in TensorFlow where that is
installed, ~20 s); the loop's JSONL mirror is what they read.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.training.trainer import Trainer as JaxTrainer
from fiery_tpu.training.trainer import TrainState
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu.utils.weight_import import import_torch_state_dict
from fiery_tpu_torch import evaluate, train
from fiery_tpu_torch.data.dataset import prepare_dataloaders
from fiery_tpu_torch.serve import BASELINE, calibrate_batchnorm, init_params, make_request
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.checkpoint import load_checkpoint
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.weight_import import checkpoint_state_from_jax

TINY_OPTS = ['DATASET.NAME', 'synthetic', 'PRECISION', '32', 'N_FUTURE_FRAMES', '2',
             'BATCHSIZE', '2', 'IMAGE.FINAL_DIM', '(64, 96)',
             'IMAGE.NAMES', "['CAM_A', 'CAM_B']", 'LIFT.X_BOUND', '[-8.0, 8.0, 0.5]',
             'LIFT.Y_BOUND', '[-8.0, 8.0, 0.5]', 'LIFT.D_BOUND', '[2.0, 8.0, 1.0]',
             'MODEL.ENCODER.NAME', 'efficientnet-b0', 'MODEL.ENCODER.OUT_CHANNELS', '16',
             'MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS', '16',
             'MODEL.DISTRIBUTION.LATENT_DIM', '4', 'MODEL.FUTURE_PRED.N_GRU_BLOCKS', '1',
             'MODEL.FUTURE_PRED.N_RES_LAYERS', '1', 'DATASET.N_SYNTHETIC_SAMPLES', '4',
             'LOGGING_INTERVAL', '1']
# the scalars of the JAX loop besides the losses (train.py at the repository root)
JAX_LOOP_KEYS = {'total_loss', 'segmentation_weight', 'centerness_weight', 'offset_weight',
                 'flow_weight', 'val_iou_background', 'val_iou_dynamic', 'val_vpq_vehicles'}


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
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)


def _metrics(run_dir):
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def _main(log_dir, *extra):
    return train.main(['--config', BASELINE, '--device', 'cpu', *extra, *TINY_OPTS,
                       'LOG_DIR', str(log_dir)])


def test_train_loop_writes_scalars_and_checkpoints_then_resumes(tmp_path, no_tensorboard,
                                                                capsys):
    run = _main(tmp_path, 'EPOCHS', '2')
    assert run.trainer.step == 4 and [r['step'] for r in run.steps] == [1, 2, 3, 4]
    records = _metrics(run.save_dir)
    keys = {k for r in records for k in r if k != 'step'}
    assert JAX_LOOP_KEYS | {'segmentation', 'instance_center', 'instance_offset',
                            'instance_flow', 'probabilistic'} <= keys
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert sorted({r['step'] for r in records if 'val_iou_dynamic' in r}) == [2, 4]
    for name, step in (('checkpoint_epoch0', 2), ('checkpoint_epoch1', 4),
                       ('checkpoint_final', 4)):
        state, cfg = load_checkpoint(os.path.join(run.save_dir, name))
        assert state['step'] == step and cfg.EPOCHS == 2, name
    out = capsys.readouterr().out
    assert 'Training complete' in out and '"val_vpq_vehicles"' in out

    # a preempted run: the second epoch's checkpoints never committed
    shutil.rmtree(os.path.join(run.save_dir, 'checkpoint_epoch1'))
    os.remove(os.path.join(run.save_dir, 'checkpoint_final', 'config.json'))
    resumed = _main(tmp_path, '--resume', 'auto', 'EPOCHS', '2')
    assert 'Resuming from ' + os.path.join(run.save_dir, 'checkpoint_epoch0') in (
        capsys.readouterr().out)
    assert resumed.save_dir != run.save_dir
    assert [r['step'] for r in resumed.steps] == [3, 4]
    steps = sorted({r['step'] for r in _metrics(resumed.save_dir)})
    assert steps == [3, 4]
    state, _ = load_checkpoint(os.path.join(resumed.save_dir, 'checkpoint_final'))
    assert state['step'] == 4 and int(state['optimizer']['state'][0]['step']) == 4


def test_resume_auto_without_checkpoints_starts_fresh_and_steps_cap_the_run(
        tmp_path, no_tensorboard, capsys):
    run = _main(tmp_path / 'logs', '--resume', 'auto', '--steps', '1', 'EPOCHS', '3')
    out = capsys.readouterr().out
    assert 'no checkpoint under' in out and run.trainer.step == 1
    assert sorted(os.listdir(run.save_dir)) == ['checkpoint_final', 'metrics.jsonl']
    with pytest.raises(SystemExit, match='no complete checkpoint'):
        _main(tmp_path / 'logs', '--resume', str(tmp_path / 'nothing'), 'EPOCHS', '1')


EVAL_CFG = {
    'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 2, 'BATCHSIZE': 1, 'PRECISION': 32,
    'IMAGE': {'FINAL_DIM': (32, 48), 'NAMES': ['CAM_A', 'CAM_B']},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
             'D_BOUND': [2.0, 6.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4},
              'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 1}},
    'DATASET': {'NAME': 'synthetic', 'N_SYNTHETIC_SAMPLES': 8},
}


@pytest.fixture(scope='module')
def converted():
    """Seeded port weights with calibrated BatchNorm as a JAX TrainState, and that
    state converted back to the port's checkpoint state."""
    cfg, jcfg = get_cfg(cfg_dict=EVAL_CFG), jax_get_cfg(cfg_dict=EVAL_CFG)
    trainer = Trainer(cfg, device='cpu')
    init_params(trainer.model, seed=7)
    calibrate_batchnorm(trainer.model, [make_request(cfg, seed=s) for s in (1, 2)])
    with torch.no_grad():
        # a vehicle class that wins on part of the grid
        trainer.model.decoder.segmentation_head[3].bias.copy_(torch.tensor([0.0, 0.5]))
    jtrainer = JaxTrainer(jcfg)
    variables, _ = import_torch_state_dict(
        {'model.' + k: v.numpy() for k, v in trainer.model.state_dict().items()},
        jtrainer.model_cfg, strict=True)
    params = {'model': variables['params'],
              'uncertainty': {k: np.float32(0.0) for k in trainer.uncertainty}}
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=variables['batch_stats'],
                        opt_state=jtrainer.tx.init(params))
    state = checkpoint_state_from_jax(
        jax.tree.map(np.asarray, {'step': jstate.step, 'params': jstate.params,
                                  'batch_stats': jstate.batch_stats,
                                  'opt_state': jstate.opt_state}), trainer)
    return cfg, jcfg, state, jstate, jtrainer


def test_eval_forwards_agree_on_every_argmax(converted):
    cfg, _, state, jstate, jtrainer = converted
    trainer = Trainer(cfg.clone(), device='cpu')
    trainer.load_state(state, strict=True)
    _, valloader = prepare_dataloaders(cfg)
    jeval = jax.jit(jtrainer.eval_step)
    n_pixels, n_vehicle, differ = 0, 0, []
    for i, batch in enumerate(valloader):
        output, _, _ = trainer.eval_step(batch)
        joutput, _, _ = jeval(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        got = output['segmentation'].argmax(-1).numpy()
        want = np.asarray(jnp.argmax(joutput['segmentation'], axis=-1))
        n_pixels += want.size
        n_vehicle += int((want == 1).sum())
        differ += [(i, *map(int, where)) for where in np.argwhere(got != want)]
    print(f'argmax: {len(differ)} of {n_pixels} pixels differ ({n_vehicle} vehicle in '
          f'JAX): {differ[:20]}')
    assert 0 < n_vehicle < n_pixels and not differ


@pytest.mark.parametrize('device_matching', [False, True])
def test_eval_checkpoint_agrees_with_jax(converted, device_matching, tmp_path):
    from evaluate import eval_checkpoint as jax_eval_checkpoint
    cfg, jcfg, state, jstate, _ = converted
    want = jax_eval_checkpoint(None, max_batches=2, state_cfg=(jstate, jcfg),
                               device_matching=device_matching)
    got = evaluate.eval_checkpoint(None, max_batches=2, state_cfg=(state, cfg),
                                   device_matching=device_matching, device='cpu')
    print({k: (float(got[k]), float(v)) for k, v in want.items()})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=0, atol=1e-6, err_msg=k)
    assert got['iou_100x100'] > 0


def _planted_heads(labels, one_hot, as_array):
    """Heads made from the labels, so that most predicted instances match true ones,
    but not all, and not for the same reason everywhere: the true class as logits
    of 8 against 0 but with every fifth pixel of a diagonal pattern and the grid's
    last quarter of rows made background (SQ below 1, and instances lost outside
    the 30x30 crop only), the true centreness and offsets, and the true flow
    reversed (the trackers' matches across frames then differ from the truth's)."""
    s, h, w = labels['segmentation'].shape[1:]
    t, x, y = np.meshgrid(np.arange(s), np.arange(h), np.arange(w), indexing='ij')
    cut = ((7 * x + 3 * y + t) % 5 == 0) | (x >= 3 * h // 4)
    seg = labels['segmentation'] * as_array(~cut)
    return {'segmentation': 8.0 * one_hot(seg), 'instance_center': labels['centerness'],
            'instance_offset': labels['offset'], 'instance_flow': -labels['flow']}


@pytest.mark.parametrize('device_matching', [False, True])
def test_eval_checkpoint_agrees_with_jax_on_planted_matches(converted, device_matching,
                                                            monkeypatch):
    """Both evaluations with their forward replaced by the heads of the batch's own
    labels, so that predicted instances match true ones: the crops of the ids, the
    int16 ids, the tracker and the panoptic update then meet nonzero PQ, SQ and RQ
    at both crops, which agree within 1e-6 absolute."""
    from evaluate import eval_checkpoint as jax_eval_checkpoint
    cfg, jcfg, state, jstate, _ = converted

    def port_step(self, batch, noise=None):
        labels, _ = self.prepare_future_labels(self.to_device(batch))
        heads = _planted_heads(labels, lambda s: torch.nn.functional.one_hot(s, 2).float(),
                               lambda a: torch.from_numpy(a).to(self.device))
        return heads, labels, {}

    jax_eval_step = JaxTrainer.eval_step

    def jax_step(self, state, batch, noise=None):
        # the network's output with its heads replaced, so that the output keeps the
        # structure that the module-level jit of the JAX tracker has already seen
        output, labels, losses = jax_eval_step(self, state, batch, noise)
        heads = _planted_heads(labels, lambda s: jax.nn.one_hot(s, 2), jnp.asarray)
        return {**output, **heads}, labels, losses

    monkeypatch.setattr(Trainer, 'eval_step', port_step)
    monkeypatch.setattr(JaxTrainer, 'eval_step', jax_step)
    calls = {'device': 0, 'host': 0}

    def counted(key, fn):
        def call(*args):
            calls[key] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(evaluate, 'device_consistent',
                        counted('device', evaluate.device_consistent))
    monkeypatch.setattr(evaluate, 'predict_instance_segmentation_and_trajectories',
                        counted('host', evaluate.predict_instance_segmentation_and_trajectories))
    want = jax_eval_checkpoint(None, max_batches=2, state_cfg=(jstate, jcfg),
                               device_matching=device_matching)
    got = evaluate.eval_checkpoint(None, max_batches=2, state_cfg=(state, cfg),
                                   device_matching=device_matching, device='cpu')
    print({k: (float(got[k]), float(v)) for k, v in want.items()})
    assert calls == ({'device': 2, 'host': 0} if device_matching else {'device': 0, 'host': 2})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=0, atol=1e-6, err_msg=k)
        assert 0 < got[k] < 1, k


def test_evaluate_cli_on_a_checkpoint(converted, tmp_path, capsys):
    """The CLI on a checkpoint directory prints the four lines of the JAX CLI."""
    from fiery_tpu_torch.utils.checkpoint import save_checkpoint
    cfg, _, state, _, _ = converted
    trainer = Trainer(cfg, device='cpu')
    trainer.load_state(state, strict=True)
    save_checkpoint(str(tmp_path / 'ckpt'), trainer, cfg)
    results = evaluate.main(['--checkpoint', str(tmp_path / 'ckpt'), '--max-batches', '1',
                             '--device', 'cpu'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0::2] == ['iou', 'pq', 'sq', 'rq']
    assert lines[1].startswith('iou_30x30: ') and 'iou_100x100: ' in lines[1]
    assert all(np.isfinite(v) for v in results.values())
