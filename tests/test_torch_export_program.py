"""The served forward as a ``torch.export`` program (fiery_tpu_torch/export.py), on
the CPU at tiny shapes.

- ``torch.library.opcheck`` on each operator of ops/library.py: its schema and
  its shape function against its CPU implementation (shapes, dtypes, strides),
  eager and traced. None has an autograd formula of its own (the
  ``autograd.Function``s of ops/*.py keep the backward kernels), so the inputs
  require no gradient and opcheck's autograd check has nothing to hold; that no
  implementation but the CPU's and the CUDA one is registered is checked apart.
- The tiny dense and combination (LIFT.TOPK 3, LIFT.WARP_FREE) configs exported at
  batch 1 and 2: the graph holds the ``fiery_torch`` nodes at the counts the
  config gives (one K1; one K2 dense, none warp-free; one K5 under TOPK; a K10 a
  BatchNorm call of the eager forward; two K11 a GRU step), and no plain splat;
  the saved and loaded program equals the eager folded model bit for bit; an
  eager forward after an export equals one before it (no cached constant or plan
  was taken over by the trace).
- In a fresh process an artifact loads and answers a request with
  ``fiery_tpu_torch.models`` never imported.
- The same weights (JAX's tiny model with randomised BatchNorm statistics, carried
  across by ``state_dict_from_jax``) through JAX's artifact
  (fiery_tpu/utils/export_lib.py, BatchNorm folded, called through a fresh
  ``jax.jit``) and through the port's program agree within rtol = atol = 1e-3,
  the tolerance of the port's f32 forward parity tests (tests/test_torch_fiery.py).
"""

import functools
import os
import subprocess
import sys
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from fiery_tpu.training.trainer import TrainState
from fiery_tpu.utils import checkpoint as jax_checkpoint
from fiery_tpu.utils import export_lib as jax_export
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu_torch.export import (batch_request, export_model, export_program,
                                    load_exported)
from fiery_tpu_torch.models.layers import BatchNorm
from fiery_tpu_torch.ops import spatial_gru as GRU
from fiery_tpu_torch.models.fiery import FieryConfig
from fiery_tpu_torch.serve import build_fiery, predict, seeded_state_dict
from fiery_tpu_torch.utils import device as device_utils
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.weight_import import state_dict_from_jax

from test_torch_fiery import jax_tiny_model, tiny_request
from test_torch_trainer import TINY
from torch_threads import THREAD_ENV, few_threads  # noqa: F401  (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = torch.ops.fiery_torch
LEVERS = {'dense': {}, 'combo': {'TOPK': 3, 'WARP_FREE': True}}


def _cfg(levers):
    return get_cfg(cfg_dict={**TINY, 'LIFT': {**TINY['LIFT'], **LEVERS[levers]}})


# ---- the operators ----

def _rows(rng, shape):
    """A channels-first view of channels-last memory, as the convolutions return."""
    t = torch.from_numpy(rng.randn(*shape[:1], *shape[2:], shape[1]).astype(np.float32))
    return t.movedim(-1, 1)


def _op_cases():
    rng = np.random.RandomState(0)
    S, N, h, w, D, C, bins = 2, 2, 3, 4, 6, 5, 4 * 4 * 2
    depth = torch.from_numpy(rng.rand(S, N, h, w, D).astype(np.float32))
    feat = torch.from_numpy(rng.randn(S, N, h, w, C).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, bins + 1, (S, N, h, w, D)).astype(np.int32))
    tied = torch.from_numpy(rng.randint(0, 3, (S, N, h, w, D)).astype(np.float32))
    x4, x5 = _rows(rng, (2, 8, 5, 6)), _rows(rng, (2, 8, 3, 5, 6))
    params = [torch.from_numpy(a.astype(np.float32)) for a in
              (rng.rand(8) + 0.5, rng.randn(8), rng.randn(8), rng.rand(8) + 0.5)]
    out = GRU.gru_output(_rows(rng, (2, 8, 5, 6)), 3)
    return {
        'bev_pool': (OPS.bev_pool, (depth, feat, ids, bins, 1)),
        'bev_pool_z2': (OPS.bev_pool, (depth, feat, ids, bins, 2)),
        'topk_select': (OPS.topk_select, (tied, ids, 3)),
        'bev_warp': (OPS.bev_warp, (torch.randn(2, 8, 6, 4),
                                    torch.tensor([[1.0, -0.5, 0, 0, 0, 0.3],
                                                  [-2.0, 0.25, 0, 0, 0, -0.1]]), 4.0, 3.0)),
        'batch_norm_4d': (OPS.batch_norm, (x4, *params, 1e-5, 'swish', None)),
        'batch_norm_5d_add_relu': (OPS.batch_norm, (x5, *params, 1e-5, 'add_relu',
                                                    _rows(rng, (2, 8, 3, 5, 6)))),
        'batch_norm_train': (OPS.batch_norm_train, (x4, *params[:2], params[2].clone(),
                                                    params[3].clone(), 0.1, 1e-5, 'relu',
                                                    None)),
        'gru_reset_concat': (OPS.gru_reset_concat, (_rows(rng, (2, 4, 5, 6)),
                                                    _rows(rng, (2, 8, 5, 6)),
                                                    _rows(rng, (2, 8, 5, 6)))),
        'gru_state_update': (OPS.gru_state_update, (*(_rows(rng, (2, 8, 5, 6)) for _ in
                                                      range(3)), out, 1)),
    }


@pytest.mark.parametrize('case', list(_op_cases()))
def test_opcheck(case):
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


def test_the_operators_run_on_cpu_and_cuda_only():
    """Each operator has a CPU and a CUDA implementation and none for any other
    backend: no default, composite or autograd one."""
    names = ('bev_pool', 'topk_select', 'bev_warp', 'batch_norm', 'batch_norm_train',
             'gru_reset_concat', 'gru_state_update')
    for name in names:
        qualname = f'fiery_torch::{name}'
        for key in ('CPU', 'CUDA'):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key), (name, key)
        for key in ('CompositeImplicitAutograd', 'CompositeExplicitAutograd', 'Autograd',
                    'XPU', 'MPS'):
            assert not torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key), (
                name, key)


# ---- the program ----

@functools.cache
def _seeded(levers):
    return seeded_state_dict(_cfg(levers), device='cpu')


@functools.cache
def _exported(levers, batch):
    """(cfg, artifact bytes, folded f32 state_dict, program) of the tiny config at
    ``batch``, exported once a module."""
    cfg = _cfg(levers)
    return (cfg, *export_model(cfg, batch=batch, device='cpu', state_dict=_seeded(levers)))


def _bn_calls(model, request):
    """The BatchNorm calls of one eager forward, counted by hooks."""
    calls = [0]
    hooks = [m.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
             for m in model.modules() if isinstance(m, BatchNorm)]
    predict(model, request)
    for hook in hooks:
        hook.remove()
    return calls[0]


@pytest.mark.parametrize('batch', [1, 2])
@pytest.mark.parametrize('levers', list(LEVERS))
def test_the_program_holds_the_kernels(levers, batch):
    cfg, _, state_dict, program = _exported(levers, batch)
    model = build_fiery(cfg, 'cpu', state_dict)
    mc = model.cfg
    nodes = Counter(str(n.target) for n in program.graph.nodes if n.op == 'call_function')
    ours = {k.split('.')[1]: v for k, v in nodes.items() if k.startswith('fiery_torch.')}
    gru_steps = mc.n_gru_blocks * mc.n_future
    want = {'bev_pool': 1, 'bev_warp': 0 if mc.warp_free else 1,
            'topk_select': 1 if mc.depth_topk else 0,
            'batch_norm': _bn_calls(model, batch_request(cfg, batch)),
            'gru_reset_concat': gru_steps, 'gru_state_update': gru_steps}
    assert ours == {k: v for k, v in want.items() if v}
    # K1, K10 and K11 are in, and no plain version's gathers and scatters
    assert want['bev_pool'] and want['batch_norm'] > 50 and gru_steps == 2
    assert not [k for k in nodes if any(
        op in k for op in ('index_add', 'index.Tensor', 'scatter', 'gather', 'grid_sampler'))]


@pytest.mark.parametrize('batch', [1, 2])
@pytest.mark.parametrize('levers', list(LEVERS))
def test_the_loaded_program_equals_the_eager_folded_model(levers, batch, tmp_path):
    cfg, blob, state_dict, _ = _exported(levers, batch)
    path = tmp_path / 'model.fiery'
    path.write_bytes(blob)
    loaded = load_exported(str(path), device='cpu')
    live = build_fiery(cfg, 'cpu', state_dict)
    request = batch_request(cfg, batch)
    got, want = predict(loaded, request), predict(live, request)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert v.shape[0] == batch and torch.isfinite(v).all(), k
        assert torch.equal(got[k], v), k


def test_an_eager_forward_after_an_export_equals_one_before():
    """The device constants (``utils/device.device_constant``) are made outside the
    trace's fake tensors: from an empty cache, the export fills it with real
    tensors, which its program holds as constants and the eager forward after it
    uses."""
    cfg = _cfg('combo')
    model = build_fiery(cfg, 'cpu', _seeded('combo'), fold_bn=True)
    request = batch_request(cfg, 1)
    before = predict(model, request)
    device_utils._constant.cache_clear()
    program = export_program(model, cfg, 1)
    assert device_utils._constant.cache_info().currsize > 0
    assert program.constants and not any(isinstance(v, FakeTensor)
                                         for v in program.constants.values())
    after = predict(model, request)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


FRESH = r'''
import sys
import numpy as np
import torch
from fiery_tpu_torch.export import load_exported, read_artifact
from fiery_tpu_torch.serve_graph import request_spec

path, out = sys.argv[1:]
module = load_exported(path, device='cpu')
rng = np.random.RandomState(5)
request = []
for shape, dtype in request_spec(read_artifact(path)['config'], 1).values():
    if dtype == torch.uint8:
        request.append(torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8)))
    else:
        request.append(torch.eye(shape[-1]).expand(shape).contiguous() if shape[-1] in (3, 4)
                       else torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.1))
with torch.inference_mode():
    answer = module(*request)
torch.save({'request': request, 'answer': answer,
            'modules': sorted(m for m in sys.modules if m.startswith('fiery_tpu'))}, out)
'''


def test_a_fresh_process_serves_an_artifact_without_the_model_code(tmp_path):
    cfg, blob, state_dict, _ = _exported('dense', 1)
    path = tmp_path / 'model.fiery'
    path.write_bytes(blob)
    env = {**{k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}, **THREAD_ENV}
    run = subprocess.run([sys.executable, '-c', FRESH, str(path), str(tmp_path / 'out.pt')],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    result = torch.load(tmp_path / 'out.pt', weights_only=False)
    assert not any(m.startswith('fiery_tpu_torch.models') for m in result['modules'])
    assert 'fiery_tpu_torch.ops.library' in result['modules']
    assert not any(m == 'fiery_tpu' or m.startswith('fiery_tpu.') for m in result['modules'])
    live = build_fiery(cfg, 'cpu', state_dict)
    with torch.inference_mode():
        want = live(*result['request'])
    assert sorted(result['answer']) == sorted(want)
    for k, v in want.items():
        assert torch.equal(result['answer'][k], v), k


def test_the_program_agrees_with_the_jax_artifact(tmp_path):
    """The JAX twin's tiny model with randomised BatchNorm statistics
    (``jax_tiny_model``, as tests/test_torch_bn_fold.py takes it), exported by JAX
    from a checkpoint of its variables, and carried by ``state_dict_from_jax`` into
    the port's program."""
    _, _, variables = jax_tiny_model(seed=2)
    cfg, jcfg = get_cfg(cfg_dict=TINY), jax_get_cfg(cfg_dict=TINY)
    # the eval forward reads no future distribution (JAX's fold refuses BatchNorms
    # that its forward does not run), so JAX's checkpoint leaves it out
    served = {c: {k: v for k, v in tree.items() if k != 'future_distribution'}
              for c, tree in variables.items()}
    state = TrainState(step=np.zeros((), np.int32), params={'model': served['params']},
                       batch_stats=served['batch_stats'],
                       opt_state={'unused': np.zeros((1,), np.float32)})
    jax_checkpoint.save_checkpoint(str(tmp_path / 'jax_ckpt'), state, jcfg)
    blob, _, _ = jax_export.export_model(jcfg, checkpoint=str(tmp_path / 'jax_ckpt'))
    (tmp_path / 'jax.fiery').write_bytes(blob)
    fn, params = jax_export.load_exported(str(tmp_path / 'jax.fiery'))

    port_blob, _, _ = export_model(
        cfg, device='cpu', state_dict=state_dict_from_jax(variables, FieryConfig.from_cfg(cfg)))
    (tmp_path / 'port.fiery').write_bytes(port_blob)
    module = load_exported(str(tmp_path / 'port.fiery'), device='cpu')

    # JAX's artifact takes the whole clip (past, present and future frames); the
    # forward reads the receptive field's
    image, intr, extr, ego = tiny_request(4, n_frames=TINY['TIME_RECEPTIVE_FIELD']
                                          + TINY['N_FUTURE_FRAMES'])
    want = jax.jit(lambda p, *a: fn(p, *a))(params, image, intr, extr, ego)
    rf = TINY['TIME_RECEPTIVE_FIELD']
    got = predict(module, {'image': image[:, :rf], 'intrinsics': intr[:, :rf],
                           'extrinsics': extr[:, :rf], 'future_egomotion': ego[:, :rf]})
    assert sorted(got) == sorted(k for k, v in want.items() if v is not None)
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-3, atol=1e-3,
                                   err_msg=k)
