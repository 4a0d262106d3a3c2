"""Helpers of the config-family tests (tests/test_torch_family_*.py): each JAX
config family at tiny widths through the JAX package and the port (CPU, f32).

A family is a YAML of the JAX package (its copy under fiery_tpu_torch/configs/
for the port) with ``TINY_OPTS`` on top: efficientnet-b0, 2 cameras at 64 x 96,
C = 16, latent 4, one GRU block, batch 2; each family keeps what makes it a family
(the temporal model, the frames, the heads) and takes a tiny grid of its own.

Weights go from JAX to the port, the direction that needs no table of the JAX
package's (which has none for INBETWEEN_LAYERS): the JAX model's parameter shapes
from ``jax.eval_shape`` of its ``init``, He-normal (fan-out) kernels drawn with
numpy, unit BatchNorm scales and zero biases; ``state_dict_from_jax`` loads them
into the port, whose ``calibrate_batchnorm`` sets the running statistics from two
seeded requests (unit-scale activations), and those statistics go back into the
JAX tree through the weight table's BatchNorm entries. The JAX eval forward and
training step then run in one jit; drop-connect is off on both sides.
"""

import argparse
import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fiery_tpu.models.efficientnet as jax_efficientnet
from fiery_tpu.training.losses import compute_losses as jax_compute_losses
from fiery_tpu.training.trainer import Trainer as JaxTrainer
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
import fiery_tpu_torch.models.efficientnet as efficientnet
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.models.fiery import Fiery
from fiery_tpu_torch.models.layers import BatchNorm
from fiery_tpu_torch.ops.batch_norm import _check_card
from fiery_tpu_torch.serve import calibrate_batchnorm, make_request
from fiery_tpu_torch.training.trainer import INPUTS, Trainer
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.weight_import import (build_mapping, state_dict_from_jax,
                                                 train_state_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, 'fiery_tpu', 'configs')
PORT_CONFIGS = os.path.join(REPO, 'fiery_tpu_torch', 'configs')
# every YAML of the JAX package, relative to its configs folder
YAMLS = sorted(os.path.relpath(os.path.join(d, f), JAX_CONFIGS)
               for d, _, files in os.walk(JAX_CONFIGS) for f in files if f.endswith('.yml'))

# each model family of the JAX package's YAMLs (YAMLs that differ only in data
# flags build the same model), and the two overrides that no YAML sets, at full width
FAMILIES = {
    'baseline': ('baseline.yml', ()),
    'identity': ('single_timeframe.yml', ()),
    'temporal': ('temporal_single_timeframe.yml', ()),
    'static_pon': ('literature/static_pon_setting.yml', ()),
    'pon': ('literature/pon_setting.yml', ()),
    'fishing': ('literature/fishing_setting.yml', ()),
    'lyft': ('lyft/baseline.yml', ()),
    'downsample_16': ('baseline.yml', ('MODEL.ENCODER.DOWNSAMPLE', '16')),
    'inbetween_1': ('baseline.yml', ('MODEL.TEMPORAL_MODEL.INBETWEEN_LAYERS', '1')),
    'inbetween_2': ('baseline.yml', ('MODEL.TEMPORAL_MODEL.INBETWEEN_LAYERS', '2')),
}
# the clip a loader hands the trainer under MODEL.SUBSAMPLE: 3 past and present and
# 5 future frames (the synthetic set does not subsample, in either package)
SUBSAMPLED_CLIP = ('TIME_RECEPTIVE_FIELD', '3', 'N_FUTURE_FRAMES', '5')

TINY_OPTS = ('PRECISION', '32', 'BATCHSIZE', '2', 'IMAGE.FINAL_DIM', '(64, 96)',
             'IMAGE.NAMES', "['CAM_A', 'CAM_B']", 'LIFT.X_BOUND', '[-8.0, 8.0, 0.5]',
             'LIFT.Y_BOUND', '[-8.0, 8.0, 0.5]', 'LIFT.D_BOUND', '[2.0, 8.0, 1.0]',
             'MODEL.ENCODER.NAME', 'efficientnet-b0', 'MODEL.ENCODER.OUT_CHANNELS', '16',
             'MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS', '16',
             'MODEL.DISTRIBUTION.LATENT_DIM', '4', 'MODEL.FUTURE_PRED.N_GRU_BLOCKS', '1',
             'MODEL.FUTURE_PRED.N_RES_LAYERS', '2')


def configs(yaml, opts=()):
    """(port cfg, JAX cfg) of ``yaml`` (relative to the configs folders), each read
    from its own package's copy, with ``opts`` merged as CLI overrides."""
    def args(root):
        return argparse.Namespace(config_file=os.path.join(root, yaml), opts=list(opts))
    return get_cfg(args(PORT_CONFIGS)), jax_get_cfg(args(JAX_CONFIGS))


def tiny_configs(yaml, opts=()):
    return configs(yaml, TINY_OPTS + tuple(opts))


def no_drop_connect():
    """A MonkeyPatch that sets b0's drop-connect rate to 0 in both packages."""
    mp = pytest.MonkeyPatch()
    for module in (jax_efficientnet, efficientnet):
        mp.setitem(module._GLOBAL_PARAMS, 'b0', (1.0, 1.0, 0.0))
    return mp


def init_arguments(cfg, mc, batch=1):
    """Abstract inputs of the JAX model's init for a port cfg and its FieryConfig:
    images, calibration and ego-motion of the receptive field's frames, and the
    future distribution's (b, 1 + n_future, X, Y, 6) input."""
    s, n, (H, W) = mc.receptive_field, len(cfg.IMAGE.NAMES), tuple(cfg.IMAGE.FINAL_DIM)
    X, Y = mc.bev_size
    shapes = [((batch, s, n, H, W, 3), jnp.uint8), ((batch, s, n, 3, 3), jnp.float32),
              ((batch, s, n, 4, 4), jnp.float32), ((batch, s, 6), jnp.float32),
              ((batch, 1 + mc.n_future, X, Y, 6), jnp.float32)]
    return [jax.ShapeDtypeStruct(shape, dtype) for shape, dtype in shapes]


def variable_shapes(jmodel, cfg, mc):
    """The JAX model's {'params', 'batch_stats'} as ShapeDtypeStructs (no compile)."""
    return jax.eval_shape(lambda *a: jmodel.init({'params': jax.random.key(0)}, *a,
                                                 train=False), *init_arguments(cfg, mc))


def he_variables(shapes, seed):
    """Numpy variables of those shapes: kernels N(0, 2 / fan_out), BatchNorm scales and
    variances 1, every other leaf 0."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == 'kernel':
            fan_out = math.prod(s.shape[:-2]) * s.shape[-1]
            return (rng.randn(*s.shape) * math.sqrt(2.0 / fan_out)).astype(np.float32)
        return np.full(s.shape, 1.0 if name in ('scale', 'var') else 0.0, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def stats_to_jax(state_dict, mc, batch_stats):
    """A copy of the JAX ``batch_stats`` tree with the port state_dict's running
    statistics, through the weight table (the fused BatchNorms' parts concatenated)."""
    out = copy.deepcopy(batch_stats)
    for path, names, _, collection in build_mapping(mc):
        if collection != 'batch_stats':
            continue
        names = names if isinstance(names, tuple) else (names,)
        node = out
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = np.concatenate(
            [state_dict[n[len('model.'):]].numpy() for n in names]).astype(np.float32)
    return out


def family(yaml, opts=(), seed=0, batch_opts=None, forward_only=False):
    """One family through both packages: the port's eval forward on a seeded request
    and, unless ``forward_only``, one training step on a seeded synthetic batch of 2
    (made from the port cfg with ``batch_opts`` merged, if given: the clip a loader
    hands the trainer), against the JAX package's, both JAX computations in one jit.

    Returns a dict: cfg, jcfg, trainer (the port's, after its step's backward: the
    gradients in ``.grad``), variables (the JAX tree both started from), request,
    served (the port's eval outputs), want_served, and for a step losses (the port's),
    noise, batch and want (losses, grads, new_stats and stats of the JAX step)."""
    mp = no_drop_connect()
    try:
        cfg, jcfg = tiny_configs(yaml, opts)
        trainer = Trainer(cfg, device='cpu')
        jtrainer = JaxTrainer(jcfg)
        mc = trainer.model.cfg
        assert dataclasses_equal(mc, jtrainer.model_cfg)
        variables = he_variables(variable_shapes(jtrainer.model, cfg, mc), seed)
        trainer.model.load_state_dict(state_dict_from_jax(variables, mc), strict=True)
        calibrate_batchnorm(trainer.model, [make_request(cfg, seed=s) for s in (6, 7)])
        variables = {'params': variables['params'], 'batch_stats': stats_to_jax(
            trainer.model.state_dict(), mc, variables['batch_stats'])}
        request = make_request(cfg, seed=seed + 8)
        request['future_egomotion'][..., 5] = 0.1           # a turn: rotated warps
        trainer.model.eval()
        with torch.no_grad():
            served = trainer.model(*(torch.from_numpy(request[k]) for k in INPUTS))
        trainer.model.train()
        req = tuple(jnp.asarray(request[k]) for k in INPUTS)
        out = dict(cfg=cfg, jcfg=jcfg, trainer=trainer, variables=variables,
                   request=request, served=served)
        if forward_only:
            want = jax.jit(lambda v, *a: jtrainer.model.apply(v, *a, None, train=False))(
                variables, *req)
            out['want_served'] = jax.tree.map(np.asarray, want)
            return out

        rng = np.random.RandomState(seed + 1)
        with torch.no_grad():
            for p in trainer.uncertainty.values():
                p.fill_(float(rng.randn() * 0.2))
        batch_cfg = cfg
        if batch_opts:
            batch_cfg = cfg.clone()
            batch_cfg.defrost()
            batch_cfg.merge_from_list(list(batch_opts))
        batch = SyntheticFutureDataset(batch_cfg, n_samples=2, n_instances=2,
                                       seed=seed + 2).get_batch([0, 1])
        noise = (rng.randn(2, 1, mc.latent_dim).astype(np.float32)
                 if mc.probabilistic_enabled and mc.n_future else None)
        params = {'model': variables['params'],
                  'uncertainty': {k: np.float32(v.item())
                                  for k, v in trainer.uncertainty.items()}}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jnoise = None if noise is None else jnp.asarray(noise)

        def loss_fn(params, batch_stats):
            labels, fdi = jtrainer.prepare_future_labels(jbatch)
            output, mutated = jtrainer.model.apply(
                {'params': params['model'], 'batch_stats': batch_stats},
                *(jbatch[k] for k in INPUTS), fdi, noise=jnoise, train=True,
                mutable=['batch_stats'])
            losses = jax_compute_losses(output, labels, params['uncertainty'], jcfg)
            return sum(losses.values()), (losses, mutated['batch_stats'])

        def both(params, batch_stats, req):
            served = jtrainer.model.apply(
                {'params': params['model'], 'batch_stats': batch_stats}, *req, None,
                train=False)
            return served, jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats)

        want_served, ((_, (losses, new_stats)), grads) = jax.jit(both)(
            params, variables['batch_stats'], req)
        got_losses, _ = trainer.compute_gradients(
            batch, noise=None if noise is None else torch.from_numpy(noise))
        out.update(want_served=jax.tree.map(np.asarray, want_served), losses=got_losses,
                   noise=noise, batch=batch, want=dict(
                       losses=jax.tree.map(np.asarray, losses),
                       new_stats=jax.tree.map(np.asarray, new_stats),
                       grads=jax.tree.map(np.asarray, grads),
                       stats=variables['batch_stats']))
        return out
    finally:
        mp.undo()


def dataclasses_equal(port, jax_cfg):
    """True if every field of the port's FieryConfig equals the JAX one's field of
    the same name (the JAX one has more, for the TPU)."""
    import dataclasses
    return all(getattr(jax_cfg, f.name) == getattr(port, f.name)
               for f in dataclasses.fields(port))


def assert_forward_matches(got, want, rtol=1e-3, atol=1e-3):
    """Every output key of the port, f32, within rtol/atol of JAX's; JAX's None
    outputs are absent from the port's; no output is all zeros."""
    assert sorted(got) == sorted(k for k, v in want.items() if v is not None)
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        assert float(np.abs(want[k]).max()) > 0, k
        np.testing.assert_allclose(v.numpy(), want[k], rtol=rtol, atol=atol, err_msg=k)


def assert_step_matches(fam, leaves_only=(), stats_rtol=None):
    """The port's step against JAX's: losses within 1e-3; the gradients as relative
    L2 errors, within 1e-2 over each top-level module (but those in
    ``leaves_only``) and within 1e-1 on each leaf (its norm floored at 1e-3 of its
    module's); the uncertainty weights' gradients; the new BatchNorm statistics
    within rtol 1e-4, atol 1e-5 (tests/test_torch_trainer.py's tolerances), or the
    rtol that ``stats_rtol`` gives a top-level module."""
    trainer, want = fam['trainer'], fam['want']
    assert sorted(fam['losses']) == sorted(want['losses'])
    for k, v in fam['losses'].items():
        np.testing.assert_allclose(float(v), float(want['losses'][k]), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    cfg = trainer.model.cfg
    grads, grad_uw = train_state_from_jax(want['grads'], want['stats'], cfg)
    got = {n: p.grad.double() for n, p in trainer.model.named_parameters()}
    assert sorted(got) == sorted(n for n in grads if n in got)
    for m in sorted({n.split('.')[0] for n in got}):
        names = [n for n in got if n.split('.')[0] == m]
        a = torch.cat([got[n].flatten() for n in names])
        b = torch.cat([grads[n].double().flatten() for n in names])
        assert float(b.norm()) > 0, m
        if m not in leaves_only:
            assert float((a - b).norm() / b.norm()) <= 1e-2, m
        for n in names:
            floor = max(float(grads[n].double().norm()), 1e-3 * float(b.norm()))
            assert float((got[n] - grads[n].double()).norm()) / floor <= 1e-1, n
    for k, p in trainer.uncertainty.items():
        np.testing.assert_allclose(float(p.grad), float(grad_uw[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    new, _ = train_state_from_jax(want['grads'], want['new_stats'], cfg)
    state = trainer.model.state_dict()
    names = [k for k in new if k.endswith(('running_mean', 'running_var'))]
    assert names
    for k in names:
        rtol = (stats_rtol or {}).get(k.split('.')[0], 1e-4)
        np.testing.assert_allclose(state[k].numpy(), new[k].numpy(), rtol=rtol, atol=1e-5,
                                   err_msg=k)


def assert_batchnorm_layouts(fam):
    """Every BatchNorm call of a training forward (the family's batch) and of an
    eval forward (its request) passes the layout checks of the BatchNorm kernel
    (K10 takes a channels-last x, and a residual of x's shape, dtype and layout),
    which its plain version on the CPU does not make: the card's check run in a
    hook on each call. Returns the number of calls checked."""
    model = Fiery(fam['trainer'].model.cfg)
    calls = []

    def hook(module, args, kwargs):
        residual = kwargs.get('residual', args[1] if len(args) > 1 else None)
        post = kwargs.get('post', args[2] if len(args) > 2 else None) or module.post
        _check_card('batch_norm', args[0], residual, post)
        calls.append(module.training)

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            batch = {k: torch.from_numpy(np.asarray(fam['batch'][k])) for k in INPUTS}
            labels, fdi = fam['trainer'].prepare_future_labels(
                fam['trainer'].to_device(fam['batch']))
            model.train()(*(batch[k] for k in INPUTS), fdi, noise=None if fam['noise'] is None
                          else torch.from_numpy(fam['noise']))
            model.eval()(*(torch.from_numpy(fam['request'][k]) for k in INPUTS))
    finally:
        for h in handles:
            h.remove()
    assert any(calls) and not all(calls)
    return len(calls)
