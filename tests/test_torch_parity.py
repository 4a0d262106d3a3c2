"""The accuracy-parity runner (``python -m fiery_tpu_torch.parity``) against the
JAX package's (``parity.py`` at the repository root), on the CPU at a tiny size.

One reference-format checkpoint serves every case: ``tests/torch_golden.py``'s
GoldenFiery from seed 11 with its BatchNorm statistics randomised, saved as
``tests/test_parity.py`` saves it (``{'state_dict': 'model.'..., 'hyper_parameters':
cfg}``), with the four uncertainty weights that a released checkpoint holds; its
config (the JAX parity test's TINY widths) reads the fake nuScenes tree that the
module writes. Held:
  * the port's twin (``fiery_tpu_torch/golden.py``) equals ``tests/torch_golden.py``'s
    built from the same seed: the same state_dict keys, shapes and values, and the
    same outputs on the same inputs, bit for bit in f32;
  * the port's ``stage_diffs`` on that checkpoint reports the stages of JAX's
    ``parity._stage_diffs``, each below 5e-3 relative (``tests/test_parity.py``'s
    bound), and its twin refuses a checkpoint missing one key;
  * ``parity.main --dataroot TREE --max-batches 2 --device cpu`` returns the rows of
    JAX's ``evaluate.eval_checkpoint`` on that tree and checkpoint within 1e-6
    absolute with the host tracker (the device tracker's table is held to JAX's in
    ``tests/test_torch_train_loop.py``; a second JAX evaluation here would take the
    file past its time budget), and prints the rows that JAX's ``parity.main``
    prints for the same numbers.
"""

import os
import sys

import numpy as np
import pytest
import torch

from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu_torch import golden as port_golden
from fiery_tpu_torch import parity
from fiery_tpu_torch.data.fake_nuscenes import make_fake_nuscenes
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.utils.checkpoint import load_torch_full_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))

import torch_golden  # noqa: E402
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

# tests/test_parity.py's TINY widths, on the tree's two cameras and 320 x 180 JPEGs
TINY = {
    'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2, 'BATCHSIZE': 1, 'PRECISION': 32,
    'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_FRONT', 'CAM_BACK'],
              'ORIGINAL_WIDTH': 320, 'ORIGINAL_HEIGHT': 180, 'RESIZE_SCALE': 0.4,
              'TOP_CROP': 8},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
             'D_BOUND': [2.0, 8.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4},
              'FUTURE_PRED': {'N_GRU_BLOCKS': 2, 'N_RES_LAYERS': 2}},
    'DATASET': {'NAME': 'nuscenes', 'VERSION': 'mini'},
    'N_WORKERS': 0,
}
TWIN = dict(C=16, D=6, final_dim=(64, 96), d_bound=(2.0, 8.0, 1.0), x_bound=(-8.0, 8.0, 0.5),
            y_bound=(-8.0, 8.0, 0.5), receptive_field=3, n_future=2, latent_dim=4,
            start_out_channels=16, n_gru_blocks=2, n_res_layers=2,
            future_in_channels=16 + 2 * 6, version='b0')


def _twin(module, seed=11):
    torch.manual_seed(seed)
    twin = module.GoldenFiery(**TWIN)
    module.randomize_bn_stats(twin, seed=5)
    module.randomize_bn3d_stats(twin.temporal_model, seed=6)
    return twin.eval()


@pytest.fixture(scope='module')
def released(tmp_path_factory):
    """(checkpoint path, fake nuScenes dataroot, the JAX package's (state, cfg) of
    the checkpoint). The state is the JAX importer's strict import of the
    checkpoint's weights, as its ``load_torch_full_checkpoint`` makes it, without
    that function's compile of a whole training state."""
    from fiery_tpu.training.trainer import Trainer as JaxTrainer
    from fiery_tpu.training.trainer import TrainState
    from fiery_tpu.utils.weight_import import import_torch_state_dict
    root = tmp_path_factory.mktemp('parity')
    sd = torch_golden.prefixed_state_dict(_twin(torch_golden), 'model.')
    for i, k in enumerate(('segmentation_weight', 'centerness_weight', 'offset_weight',
                           'flow_weight')):
        sd[f'model.{k}'] = np.float32(0.1 * (i + 1))
    path = str(root / 'fake_fiery.ckpt')
    jcfg = jax_get_cfg(cfg_dict=TINY)
    torch.save({'state_dict': {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                'hyper_parameters': jcfg.convert_to_dict(), 'epoch': 19,
                'global_step': 12345}, path)
    variables, uncertainty = import_torch_state_dict(sd, JaxTrainer(jcfg).model_cfg,
                                                     strict=True)
    jstate = TrainState(step=np.int32(0), params={'model': variables['params'],
                                                  'uncertainty': uncertainty},
                        batch_stats=variables['batch_stats'], opt_state=None)
    tree = make_fake_nuscenes(str(root / 'tree'), n_samples=6, width=320, height=180)
    return path, tree, (jstate, jcfg)


@pytest.fixture
def jitted_jax_fiery(monkeypatch):
    """The JAX model's ``apply`` under ``jax.jit`` (its eager call, op by op, takes
    ~40 s on the tiny model here; the stages it reports are the same)."""
    import jax
    from fiery_tpu.models import fiery as jax_fiery
    eager = jax_fiery.Fiery

    class Fiery(eager):
        def apply(self, variables, *args, **kwargs):
            return jax.jit(lambda v, *a: eager.apply(self, v, *a, **kwargs))(variables, *args)

    monkeypatch.setattr(jax_fiery, 'Fiery', Fiery)


def test_twin_equals_the_test_twin_bit_for_bit():
    want, got = _twin(torch_golden), _twin(port_golden)
    want_sd, got_sd = want.state_dict(), got.state_dict()
    assert list(got_sd) == list(want_sd)
    for k, v in want_sd.items():
        assert got_sd[k].shape == v.shape and torch.equal(got_sd[k], v), k
    rng = np.random.RandomState(3)
    image = torch.from_numpy(rng.randn(1, 5, 2, 3, 64, 96).astype(np.float32))
    intr = torch.from_numpy(np.broadcast_to(np.array(
        [[40.0, 0, 48], [0, 40.0, 32], [0, 0, 1]], np.float32), (1, 5, 2, 3, 3)).copy())
    extr = torch.eye(4).repeat(1, 5, 2, 1, 1)
    extr[..., 0, 3] = torch.tensor([0.5, -0.5])
    ego = torch.from_numpy((rng.randn(1, 5, 6) * 0.05).astype(np.float32))
    fdi = torch.from_numpy(rng.rand(1, 3, 6, 32, 32).astype(np.float32))
    noise = torch.from_numpy(rng.randn(1, 1, 4).astype(np.float32))
    with torch.no_grad():
        out_want = want(image, intr, extr, ego, fdi, noise)
        out_got = got(image, intr, extr, ego, fdi, noise)
    assert sorted(out_got) == sorted(out_want)
    for k, v in out_want.items():
        assert (v is None and out_got[k] is None) or torch.equal(out_got[k], v), k


def test_stage_diffs_have_the_jax_stages_below_the_bound(released, jitted_jax_fiery, tmp_path,
                                                         capsys):
    import parity as jax_parity
    from fiery_tpu.data.synthetic import SyntheticFutureDataset as JaxSynthetic
    path, _, (jstate, jcfg) = released
    want = jax_parity._stage_diffs(path, jstate, jcfg, JaxSynthetic(
        jcfg, n_samples=1, n_instances=2, seed=0).get_batch([0]))
    state, cfg = load_torch_full_checkpoint(path)
    batch = SyntheticFutureDataset(cfg, n_samples=1, n_instances=2, seed=0).get_batch([0])
    got = parity.stage_diffs(path, state, cfg, batch, 'cpu')
    print({k: (want[k], got.get(k)) for k in want})
    assert sorted(got) == sorted(want)
    for name, (absd, rel) in got.items():
        assert np.isfinite(rel) and rel < 5e-3, (name, absd, rel)
    assert 'Per-stage activation diffs' in capsys.readouterr().out

    # the twin loads strictly: a checkpoint without one of its keys is refused
    blob = torch.load(path, weights_only=False)
    del blob['state_dict']['model.decoder.first_conv.weight']
    torch.save(blob, str(tmp_path / 'short.ckpt'))
    with pytest.raises(RuntimeError, match='decoder.first_conv.weight'):
        parity.stage_diffs(str(tmp_path / 'short.ckpt'), state, cfg, batch, 'cpu')


def test_table_equals_jax_eval_checkpoint(released, monkeypatch, capsys):
    import evaluate as jax_evaluate
    import parity as jax_parity
    from fiery_tpu.utils import checkpoint as jax_checkpoint
    path, tree, (jstate, jcfg) = released
    want = jax_evaluate.eval_checkpoint(None, tree, None, 2, state_cfg=(jstate, jcfg.clone()))
    capsys.readouterr()
    got = parity.main(['--torch-checkpoint', path, '--dataroot', tree, '--max-batches', '2',
                       '--device', 'cpu'])
    printed = capsys.readouterr().out
    assert got['stages'] is None
    rows = got['metrics']
    print({k: (rows[k], float(want[k])) for k in rows})
    assert list(rows) == [k for k in parity.TABLE if k in want] and len(rows) == 6
    for k, v in rows.items():
        np.testing.assert_allclose(v, float(want[k]), rtol=0, atol=1e-6, err_msg=k)
    assert rows['iou_100x100'] > 0

    # JAX's runner prints the same rows for the same numbers
    monkeypatch.setattr(jax_checkpoint, 'load_torch_full_checkpoint',
                        lambda _: (jstate, jcfg.clone()))
    monkeypatch.setattr(jax_evaluate, 'eval_checkpoint', lambda *a, **k: dict(rows))
    monkeypatch.setattr(sys, 'argv', ['parity.py', '--torch-checkpoint', path,
                                      '--dataroot', tree, '--max-batches', '2'])
    jax_parity.main()
    jax_printed = capsys.readouterr().out

    def table(text):
        lines = text.splitlines()
        return lines[next(i for i, line in enumerate(lines)
                          if line.split()[:2] == ['metric', 'ours']):]
    assert table(printed) == table(jax_printed) and len(table(printed)) == 7


def test_write_reference_checkpoint_round_trips(released, tmp_path):
    """A port state written in the reference format holds the released file's keys
    and loads back to the same state."""
    path = released[0]
    state, cfg = load_torch_full_checkpoint(path)
    again = parity.write_reference_checkpoint(str(tmp_path / 'again.ckpt'), state, cfg)
    want = torch.load(path, weights_only=False)['state_dict']
    got = torch.load(again, weights_only=False)['state_dict']
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].reshape(v.shape), v), k
    back, back_cfg = load_torch_full_checkpoint(again)
    assert back_cfg == cfg
    for part in ('model', 'uncertainty'):
        assert sorted(back[part]) == sorted(state[part])
        for k, v in state[part].items():
            assert torch.equal(back[part][k], v), (part, k)
