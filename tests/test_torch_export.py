"""The served path's CPU side (counterpart of tests/test_export.py): the export
artifact (``fiery_tpu_torch/export.py``), a ``torch.export`` program, round trips
bit for bit, from seeded weights and from a checkpoint; a file without its magic
and a program loaded on another device than its own are refused; the CLI exports
and validates at a tiny config; requests of another shape or dtype are refused
before any copy (``serve_graph.check_request``); and the captured form refuses the
CPU and a forward that updates BatchNorm statistics rather than falling back to
the eager model. No JAX: the fold itself is held to the JAX package's in
tests/test_torch_bn_fold.py, the program to JAX's artifact in
tests/test_torch_export_program.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fiery_tpu_torch.export import (MAGIC, batch_request, export_model, load_exported,
                                    read_artifact)
from fiery_tpu_torch.models.layers import BatchNorm
from fiery_tpu_torch.serve import build_fiery, build_served, make_request, predict
from fiery_tpu_torch.serve_graph import (ServedFiery, check_request, is_eval_forward,
                                         request_spec)
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.bn_fold import bn_conv_pairs, fold_batchnorm
from fiery_tpu_torch.utils.checkpoint import save_checkpoint
from fiery_tpu_torch.utils.config import get_cfg

from test_torch_trainer import TINY
from torch_threads import THREAD_ENV, few_threads  # noqa: F401  (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def cfg():
    return get_cfg(cfg_dict=TINY)


@pytest.fixture(scope='module')
def exported(cfg):
    """(artifact bytes, folded state_dict, program) of the tiny config at batch 2."""
    return export_model(cfg, batch=2, device='cpu')


def test_export_round_trip_on_the_cpu(cfg, exported, tmp_path):
    blob, state_dict, program = exported
    path = tmp_path / 'model.fiery'
    path.write_bytes(blob)
    artifact = read_artifact(str(path))
    assert artifact['batch'] == 2 and artifact['fold_bn']
    assert artifact['config'] == cfg and artifact['device'] == torch.device('cpu')
    # the program holds the folded weights (f32 under PRECISION 32)
    assert sorted(program.state_dict) == sorted(state_dict)
    for k, v in program.state_dict.items():
        assert torch.equal(v, state_dict[k]), k
    model = build_fiery(cfg, device='cpu')
    for _, bn in bn_conv_pairs(model)[0]:          # folded: identity statistics
        assert torch.equal(state_dict[f'{bn}.weight'], torch.ones_like(state_dict[f'{bn}.weight']))
        assert not state_dict[f'{bn}.running_mean'].any()

    loaded = load_exported(str(path), device='cpu')
    assert isinstance(loaded, torch.fx.GraphModule) and is_eval_forward(loaded)
    live = build_fiery(cfg, device='cpu', state_dict=state_dict)
    request = batch_request(cfg, 2)
    got, want = predict(loaded, request), predict(live, request)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert v.shape[0] == 2 and torch.isfinite(v).all(), k
        assert torch.equal(got[k], v), k


def test_export_from_a_checkpoint(cfg, tmp_path):
    trainer = Trainer(cfg, device='cpu')
    save_checkpoint(str(tmp_path / 'ckpt'), trainer, cfg)
    _, state_dict, program = export_model(cfg, checkpoint=str(tmp_path / 'ckpt'),
                                          device='cpu')
    want, n = fold_batchnorm(trainer.model.state_dict(), trainer.model)
    assert n > 90 and sorted(state_dict) == sorted(want)
    for k, v in want.items():
        assert torch.equal(state_dict[k], v), k
    for k, v in program.state_dict.items():
        assert torch.equal(v, want[k]), k


def test_export_rejects_garbage(tmp_path):
    path = tmp_path / 'bad.fiery'
    path.write_bytes(b'not an artifact')
    with pytest.raises(ValueError, match='not a fiery_tpu_torch export artifact'):
        load_exported(str(path), device='cpu')


def test_a_program_loads_only_on_its_device(exported, tmp_path):
    """A program exported for the card (its header names cuda:0) is refused on the
    CPU before anything is loaded."""
    blob = exported[0]
    n = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 8], 'little')
    start = len(MAGIC) + 8
    header = json.loads(blob[start:start + n])
    header['device'] = 'cuda:0'
    header = json.dumps(header).encode()
    path = tmp_path / 'card.fiery'
    path.write_bytes(MAGIC + len(header).to_bytes(8, 'little') + header + blob[start + n:])
    assert read_artifact(str(path))['device'] == torch.device('cuda', 0)
    with pytest.raises(ValueError, match='exported for cuda:0; it does not run on cpu'):
        load_exported(str(path), device='cpu')


def _overrides(tree, prefix=''):
    """A config dict as the CLI's KEY VALUE pairs."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _overrides(v, f'{prefix}{k}.')
        else:
            out += [prefix + k, repr(v)]
    return out


def test_export_cli_validates_on_the_cpu(tmp_path):
    out = tmp_path / 'tiny.fiery'
    env = {**{k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}, **THREAD_ENV}
    run = subprocess.run(
        [sys.executable, '-m', 'fiery_tpu_torch.export', '--output', str(out),
         '--device', 'cpu', '--validate'] + _overrides(TINY),
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert 'validate ok: the exported program matches the live model' in run.stdout
    assert read_artifact(str(out))['config'] == get_cfg(cfg_dict=TINY)


def test_check_request_rejects_shape_and_dtype(cfg):
    spec = request_spec(cfg, batch=1)
    request = make_request(cfg, seed=0)
    check_request(request, spec)
    check_request({k: torch.from_numpy(v) for k, v in request.items()}, spec)
    assert {k: tuple(v.shape) for k, v in request.items()} == {
        k: shape for k, (shape, _) in spec.items()}
    with pytest.raises(ValueError, match='image: shape'):
        check_request(batch_request(cfg, 2), spec)
    with pytest.raises(TypeError, match='image: dtype'):
        check_request({**request, 'image': request['image'].astype(np.float32)}, spec)
    with pytest.raises(TypeError, match='intrinsics: dtype'):
        check_request({**request, 'intrinsics': request['intrinsics'].astype(np.float64)},
                      spec)
    with pytest.raises(ValueError, match='no extrinsics'):
        check_request({k: v for k, v in request.items() if k != 'extrinsics'}, spec)


def test_the_captured_form_refuses_the_cpu(cfg):
    model = build_fiery(cfg, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        ServedFiery(model, cfg)
    state_dict = {k: v.float() if v.is_floating_point() else v
                  for k, v in model.state_dict().items()}
    with pytest.raises(RuntimeError, match='CUDA'):
        build_served(cfg, state_dict, device='cpu')
    with pytest.raises(ValueError, match='fold_bn'):
        build_fiery(cfg, device='cpu', fold_bn=True)


def test_a_program_that_updates_batchnorm_statistics_is_not_served():
    """The check that stands for ``model.training`` on a program's module, which
    keeps the mode it was traced in: a traced training BatchNorm holds a
    ``batch_norm_train`` node (its statistics written in place) and is refused; the
    eval one is served."""
    bn = BatchNorm(8, post='relu')
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        train = torch.export.export(bn.train(), (x,), strict=False).module()
        served = torch.export.export(bn.eval(), (x,), strict=False).module()
    assert not is_eval_forward(train) and is_eval_forward(served)
    assert not is_eval_forward(bn.train()) and is_eval_forward(bn.eval())
