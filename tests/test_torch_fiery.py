"""fiery_tpu_torch end to end against fiery_tpu at a tiny config (CPU, f32).

Weights: ``Fiery(cfg).init`` of the JAX package, converted to numpy, BatchNorm
running statistics randomised (see ``jax_tiny_model``), then ``state_dict_from_jax``
-> ``load_state_dict(strict=True)``. Inputs are
made with numpy from fixed seeds. Also: the weight conversion inverts the JAX
package's importer bit for bit, the package imports nothing of JAX, and the
entry points refuse to fall back to the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fiery_tpu.models.fiery import Fiery as JaxFiery
from fiery_tpu.models.fiery import FieryConfig as JaxFieryConfig
from fiery_tpu.utils.weight_import import import_torch_state_dict
from fiery_tpu_torch.models.fiery import Fiery, FieryConfig
from fiery_tpu_torch.utils.weight_import import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# efficientnet-b0, 64x96 images, 2 cameras, D = 6, C = 16, a 32x32 BEV, rf = 3,
# 2 future frames, latent 4, 1 GRU block
TINY = dict(encoder_name='efficientnet-b0', encoder_out_channels=16,
            d_bound=(2.0, 8.0, 1.0), final_dim=(64, 96), latent_dim=4, n_gru_blocks=1,
            n_res_layers=2, start_out_channels=16, time_receptive_field=3,
            n_future_frames=2, x_bound=(-8.0, 8.0, 0.5), y_bound=(-8.0, 8.0, 0.5))


def tiny_request(seed, n_frames=3):
    """uint8 images (1, s, 2, 64, 96, 3), intrinsics, extrinsics, egomotion."""
    rng = np.random.RandomState(seed)
    b, n, (H, W) = 1, 2, TINY['final_dim']
    K = np.array([[40.0, 0, 48], [0, 40.0, 32], [0, 0, 1]], np.float32)
    th = 0.4
    E0 = np.eye(4, dtype=np.float32)
    E1 = np.array([[np.cos(th), -np.sin(th), 0, 0.5], [np.sin(th), np.cos(th), 0, -0.3],
                   [0, 0, 1, 0.2], [0, 0, 0, 1]], np.float32)
    return (rng.randint(0, 256, (b, n_frames, n, H, W, 3)).astype(np.uint8),
            np.broadcast_to(K, (b, n_frames, n, 3, 3)).copy(),
            np.broadcast_to(np.stack([E0, E1]), (b, n_frames, n, 4, 4)).copy(),
            (rng.randn(b, n_frames, 6) * 0.05).astype(np.float32))


def _randomize_stats(tree, rng):
    """mean + N(0, 0.1) std, var x U(0.5, 1.5) around each BN's batch statistics."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and 'mean' not in v:
            out[k] = _randomize_stats(v, rng)
        elif isinstance(v, dict):
            var = np.maximum(v['var'], 1e-2)
            out[k] = {'mean': (v['mean'] + rng.randn(*var.shape) * 0.1 * np.sqrt(var))
                      .astype(np.float32),
                      'var': (var * rng.uniform(0.5, 1.5, var.shape)).astype(np.float32)}
    return out


def jax_tiny_model(seed=0):
    """(jax config, jax model, numpy variables); the future distribution is
    initialised too, so every mapped weight exists. BatchNorm statistics are those
    of a two-clip batch (a train-mode pass with BN momentum 1), randomised around
    them: identity statistics would make BN trivial, and statistics that do not
    normalise let the He-initialised residual stacks grow the outputs to 1e3,
    where f32 noise alone exceeds atol 1e-3."""
    jcfg = JaxFieryConfig(**TINY)
    model = JaxFiery(cfg=jcfg)
    clips = [tiny_request(seed + i, n_frames=3 + 2) for i in range(2)]
    image, intr, extr, ego = (np.concatenate(a) for a in zip(*clips))
    fdi = np.zeros((2, 3, 32, 32, 6), np.float32)
    variables = jax.jit(model.init, static_argnames='train')(
        {'params': jax.random.key(seed)}, image, intr, extr, ego, fdi, train=False)
    calibrate = JaxFiery(cfg=dataclasses.replace(jcfg, bn_momentum=1.0))
    _, batch = jax.jit(lambda v, *a: calibrate.apply(
        v, *a, train=True, mutable=['batch_stats'],
        rngs={'sample': jax.random.key(seed), 'dropout': jax.random.key(seed)}))(
            variables, image, intr, extr, ego, fdi)
    stats = _randomize_stats(jax.tree.map(np.asarray, batch['batch_stats']),
                             np.random.RandomState(seed + 1))
    return jcfg, model, {'params': jax.tree.map(np.asarray, variables['params']),
                         'batch_stats': stats}


def ported_tiny_model(variables):
    model = Fiery(FieryConfig(**TINY)).eval()
    model.load_state_dict(state_dict_from_jax(variables, model.cfg), strict=True)
    return model


@pytest.fixture(scope='module')
def tiny():
    jcfg, jmodel, variables = jax_tiny_model()
    return jcfg, jmodel, variables, ported_tiny_model(variables)


def test_full_tiny_eval_forward_matches_jax(tiny):
    """uint8 images in, every output key out; rtol/atol 1e-3 is the tolerance of
    test_full_graph_golden_parity, for the depth of the graph."""
    jcfg, jmodel, variables, model = tiny
    image, intr, extr, ego = tiny_request(1)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, None, train=False))(
        variables, image, intr, extr, ego)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (image, intr, extr, ego)))
    assert sorted(got) == sorted(k for k, v in want.items() if v is not None)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-3, atol=1e-3,
                                   err_msg=k)


def test_state_dict_from_jax_round_trips_bit_exactly(tiny):
    jcfg, _, variables, model = tiny
    sd = {'model.' + k: v.numpy() for k, v in model.state_dict().items()}
    back, _ = import_torch_state_dict(sd, jcfg, variables=variables, strict=True)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    for coll in ('params', 'batch_stats'):
        want = dict(leaves(variables[coll]))
        got = dict(leaves(back[coll]))
        assert sorted(got) == sorted(want), coll
        for path, v in want.items():
            np.testing.assert_array_equal(got[path], v, err_msg='/'.join(path))


def test_port_imports_nothing_of_jax():
    """Every module of the package, and chip_smoke.py's imports, in a fresh process;
    none imports matplotlib on import (the visualise CLI does when it draws)."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import fiery_tpu_torch\n'
        'for m in pkgutil.walk_packages(fiery_tpu_torch.__path__, "fiery_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'import chip_smoke\n'
        'bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", '
        '"flax", "fiery_tpu", "matplotlib"))\n'
        'assert not bad, bad\n'
        'print(" ".join(k for k in sys.modules if k.startswith("fiery_tpu_torch")))\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    modules = set(out.stdout.split())
    assert len(modules) >= 47
    assert {'fiery_tpu_torch.ops.lap', 'fiery_tpu_torch.postprocess.instance',
            'fiery_tpu_torch.training.metrics', 'fiery_tpu_torch.evaluate',
            'fiery_tpu_torch.training.losses', 'fiery_tpu_torch.training.trainer',
            'fiery_tpu_torch.train', 'fiery_tpu_torch.data.synthetic',
            'fiery_tpu_torch.data.labels', 'fiery_tpu_torch.data.label_warp',
            'fiery_tpu_torch.data.dataset', 'fiery_tpu_torch.utils.checkpoint',
            'fiery_tpu_torch.utils.bn_fold', 'fiery_tpu_torch.serve_graph',
            'fiery_tpu_torch.export', 'fiery_tpu_torch.native',
            'fiery_tpu_torch.data.nuscenes_dataset', 'fiery_tpu_torch.data.nuscenes_indexer',
            'fiery_tpu_torch.data.fake_nuscenes', 'fiery_tpu_torch.data.lyft_splits',
            'fiery_tpu_torch.utils.quaternion', 'fiery_tpu_torch.utils.visualisation',
            'fiery_tpu_torch.visualise', 'fiery_tpu_torch.parallel',
            'fiery_tpu_torch.parallel.mesh', 'fiery_tpu_torch.utils.rounding'} <= modules


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from fiery_tpu_torch.serve import build_fiery, predict
    from fiery_tpu_torch.utils.config import get_cfg
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = get_cfg(cfg_dict={'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0'}}})
    with pytest.raises(RuntimeError, match='CUDA'):
        build_fiery(cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        build_fiery(cfg, device='cuda')
    model = build_fiery(cfg, device='cpu')
    assert next(model.parameters()).device.type == 'cpu' and not model.training
    assert callable(predict)
