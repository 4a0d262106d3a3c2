"""One (1, 3, 3) Bottleneck3D between the temporal blocks
(MODEL.TEMPORAL_MODEL.INBETWEEN_LAYERS 1, which no YAML sets) on baseline.yml,
against the JAX package at tiny widths (CPU, f32): the eval forward and one
training step against JAX's in one jit, as tests/test_torch_trainer.py holds
them, and the BatchNorm fold against the JAX package's fold, as
tests/test_torch_bn_fold.py holds it (every tensor bit for bit in f32, the same
count; the folded forward within the unfolded one's tolerance).

The weights of those Bottleneck3Ds come from the port's own table
(``utils/weight_import.py`` ``temporal_mapping``): the JAX package's table has no
entries for them.
"""

import copy

import numpy as np
import pytest
import torch

from fiery_tpu.models.fiery import Fiery as JaxFiery
from fiery_tpu.models.fiery import FieryConfig as JaxFieryConfig
from fiery_tpu.utils import bn_fold as jax_bn_fold
from fiery_tpu_torch.models.temporal_layers import Bottleneck3D
from fiery_tpu_torch.training.trainer import INPUTS
from fiery_tpu_torch.utils.bn_fold import fold_batchnorm
from fiery_tpu_torch.utils.weight_import import state_dict_from_jax

import torch_family as tf
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)
from test_torch_bn_fold import _bits, _randomize_affine

INBETWEEN = ('MODEL.TEMPORAL_MODEL.INBETWEEN_LAYERS', '1', 'N_FUTURE_FRAMES', '2')


@pytest.fixture(scope='module')
def inbetween():
    return tf.family('baseline.yml', INBETWEEN)


def test_inbetween_layers_eval_forward_matches_jax(inbetween):
    model = inbetween['trainer'].model
    blocks = [type(m).__name__ for m in model.temporal_model.model]
    assert blocks == ['TemporalBlock', 'Bottleneck3D', 'TemporalBlock', 'Bottleneck3D']
    tf.assert_forward_matches(inbetween['served'], inbetween['want_served'])


def test_inbetween_layers_train_step_matches_jax(inbetween):
    """As the other families' steps; the future distribution's new statistics within
    1e-3: its input carries the label maps (the ignore value 255 among them), where
    a channel's mean^2 / var reaches 150 and JAX's f32 variance, E[x^2] - E[x]^2,
    is 1.4e-4 from the f64 statistic of the port's input while the port's is 7e-6."""
    grads = [m.layers.conv.conv.weight for m in inbetween['trainer'].model.modules()
             if isinstance(m, Bottleneck3D)]
    assert len(grads) == 2 and all(float(g.grad.abs().max()) > 0 for g in grads)
    tf.assert_step_matches(inbetween, stats_rtol={'future_distribution': 1e-3})


def test_inbetween_layers_fold_equals_the_jax_fold(inbetween):
    """The JAX tree with random BatchNorm scales and biases, folded by the JAX package
    and converted, against the port's fold of the converted tree: every tensor bit
    for bit, the same count, the Bottleneck3Ds' six BatchNorms among them; the
    folded forward (of the variables, without the random affines) equals the
    unfolded one within rtol/atol 1e-3."""
    cfg, jcfg = tf.tiny_configs('baseline.yml', INBETWEEN)
    model = copy.deepcopy(inbetween['trainer'].model).eval()
    variables = inbetween['variables']
    affine = {'params': _randomize_affine(variables['params'], np.random.RandomState(4)),
              'batch_stats': variables['batch_stats']}
    jmodel = JaxFiery(cfg=JaxFieryConfig.from_cfg(jcfg))
    jax_bn_fold.populate_eps_registry(jmodel, variables,
                                      tf.init_arguments(cfg, model.cfg)[:4] + [None])
    folded, n_jax = jax_bn_fold.fold_batchnorm(affine)
    want = state_dict_from_jax(folded, model.cfg)
    unfolded = state_dict_from_jax(affine, model.cfg)
    got, n = fold_batchnorm(unfolded, model)
    assert n == n_jax and sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
    inner = [k for k in want if '.layers.' in k and k.startswith('temporal_model.')
             and k.endswith('.running_var')]
    assert len(inner) == 6
    for k in inner:
        assert not torch.equal(got[k[:-len('running_var')] + 'bias'],
                               unfolded[k[:-len('running_var')] + 'bias'])

    # the forward on the variables, whose statistics normalise (the random affines
    # above grow the outputs to 1e4)
    request = inbetween['request']
    plain_sd = state_dict_from_jax(variables, model.cfg)
    model.load_state_dict(plain_sd)
    with torch.inference_mode():
        plain = model(*(torch.from_numpy(request[k]) for k in INPUTS))
        model.load_state_dict(fold_batchnorm(plain_sd, model)[0])
        fold = model(*(torch.from_numpy(request[k]) for k in INPUTS))
    for k, v in fold.items():
        np.testing.assert_allclose(v.numpy(), plain[k].numpy(), rtol=1e-3, atol=1e-3,
                                   err_msg=k)


def test_every_batchnorm_call_meets_the_kernel_layout(inbetween):
    """The BatchNorm kernel's layout checks hold on every call of a training and an
    eval forward (tests/test_torch_family_temporal.py has the fault they found)."""
    assert tf.assert_batchnorm_layouts(inbetween) > 50
