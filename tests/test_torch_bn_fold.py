"""fiery_tpu_torch.utils.bn_fold against fiery_tpu.utils.bn_fold (CPU).

The tiny JAX model of tests/test_torch_fiery.py, its BatchNorm statistics
randomised there and its scales and biases randomised here, is folded by the JAX
package and converted (``state_dict_from_jax``), and converted and folded by the
port: every tensor equal bit for bit in f32 (the split fused prologs and heads
included), the same count. The port's folded forward equals its unfolded one at
the JAX fold test's tolerance (rtol 2e-4, atol 2e-5) per module, and the JAX
package's serving function (``make_serving_fn``, one jit) at rtol/atol 1e-3 for
the whole model; under PRECISION 16 the folded weights are the bf16 rounding of
the JAX package's folded f32 ones.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from fiery_tpu.utils import bn_fold as jax_bn_fold
from fiery_tpu_torch.models.fiery import FieryConfig
from fiery_tpu_torch.models.layers import BatchNorm, Bottleneck, ConvBlock, Conv2d
from fiery_tpu_torch.serve import build_fiery
from fiery_tpu_torch.utils.bn_fold import bn_conv_pairs, fold_batchnorm
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.weight_import import state_dict_from_jax

from test_torch_fiery import TINY, jax_tiny_model, ported_tiny_model, tiny_request
from test_torch_trainer import TINY as TINY_CFG


def _randomize_affine(tree, rng):
    """Every BatchNorm's scale in U(0.5, 1.5) and bias in N(0, 0.5), in place of
    their initial 1 and 0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and 'scale' in v:
            out[k] = {**v, 'scale': rng.uniform(0.5, 1.5, v['scale'].shape).astype(np.float32),
                      'bias': (rng.randn(*v['bias'].shape) * 0.5).astype(np.float32)}
        elif isinstance(v, dict):
            out[k] = _randomize_affine(v, rng)
        else:
            out[k] = v
    return out


@pytest.fixture(scope='module')
def tiny():
    """(jax model, its variables, the same with random BatchNorm scales and biases,
    the JAX fold of those and its count, the port model of the variables). The
    forward runs on the variables, whose statistics normalise; the fold's bits are
    held on the random affines."""
    _, jmodel, variables = jax_tiny_model(seed=3)
    affine = {'params': _randomize_affine(variables['params'], np.random.RandomState(4)),
              'batch_stats': variables['batch_stats']}
    jax_bn_fold.populate_eps_registry(jmodel, variables, tiny_request(1) + (None,))
    folded, n_folded = jax_bn_fold.fold_batchnorm(affine)
    return jmodel, variables, affine, folded, n_folded, ported_tiny_model(variables)


def _bits(t):
    a = t.detach().numpy()
    return a.view(np.uint32) if a.dtype == np.float32 else a


def test_fold_equals_the_jax_fold_bit_for_bit(tiny):
    _, _, variables, jax_folded, n_jax, model = tiny
    want = state_dict_from_jax(jax_folded, model.cfg)
    unfolded = state_dict_from_jax(variables, model.cfg)
    got, n = fold_batchnorm(unfolded, model)
    assert n == n_jax and n > 90
    assert sorted(got) == sorted(want)
    changed = 0
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
        changed += not torch.equal(v, unfolded[k])
    # every BatchNorm's four tensors and its conv's weight moved
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert changed >= 5 * n_bn


def test_folded_forward_matches_the_jax_serving_function(tiny):
    jmodel, variables, _, _, _, model = tiny
    inputs = tiny_request(2)
    fn, arg_params = jax_bn_fold.make_serving_fn(jmodel, variables, inputs + (None,))
    want = jax.jit(fn)(arg_params, *inputs, None)
    folded = copy.deepcopy(model)
    folded.load_state_dict(fold_batchnorm(model.state_dict(), model)[0])
    with torch.inference_mode():
        got = folded(*(torch.from_numpy(a) for a in inputs))
        unfolded = model(*(torch.from_numpy(a) for a in inputs))
    assert sorted(got) == sorted(k for k, v in want.items() if v is not None)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-3, atol=1e-3,
                                   err_msg=k)
        np.testing.assert_allclose(v.numpy(), unfolded[k].numpy(), rtol=1e-3, atol=1e-3,
                                   err_msg=k)


def test_precision_16_casts_the_f32_fold_once(tiny):
    """build_fiery(fold_bn=True) folds in f32 and then casts: each bf16 conv weight is
    bf16(the JAX package's folded f32 kernel); the BatchNorms stay f32, bit for bit."""
    _, _, variables, jax_folded, _, _ = tiny
    cfg = get_cfg(cfg_dict={**TINY_CFG, 'PRECISION': 16})
    assert FieryConfig.from_cfg(cfg) == FieryConfig(**TINY, precision=16)
    model = build_fiery(cfg, device='cpu', fold_bn=True,
                        state_dict=state_dict_from_jax(variables, FieryConfig(**TINY)))
    want = state_dict_from_jax(jax_folded, model.cfg)
    got = model.state_dict()
    n_bf16 = 0
    for k, v in want.items():
        if got[k].dtype == torch.bfloat16:
            n_bf16 += 1
            v = v.to(torch.bfloat16)
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                          v.view(torch.int16).numpy(), err_msg=k)
        else:
            np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
    assert n_bf16 > 100


def _randomize_stats(module, seed):
    """Running means N(0, 1), variances in [0.25, 2.25], as tests/test_bn_fold.py
    has them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g))
                m.running_var.copy_(0.25 + 2.0 * torch.rand(m.num_features, generator=g))
    return module.eval()


@pytest.mark.parametrize('make, in_channels, n_folded', [
    (lambda: ConvBlock(6, 10), 6, 1),
    (lambda: Bottleneck(8, 12, downsample=True), 8, 4),
    (lambda: Bottleneck(8, 12, upsample=True), 8, 4),   # its middle conv a ConvTranspose
], ids=['convblock', 'bottleneck_down', 'bottleneck_up'])
def test_fold_per_module(make, in_channels, n_folded):
    module = _randomize_stats(make(), seed=in_channels + n_folded)
    folded_sd, n = fold_batchnorm(module.state_dict(), module)
    assert n == n_folded
    folded = copy.deepcopy(module)
    folded.load_state_dict(folded_sd)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, in_channels, 8, 8)
                         .astype(np.float32))
    with torch.no_grad():
        want, got = module(x), folded(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)


def test_unpaired_batchnorm_raises():
    module = torch.nn.Sequential(Conv2d(3, 4, 1, bias=False), BatchNorm(4), BatchNorm(4))
    assert bn_conv_pairs(module) == ([('0', '1')], ['2'])
    with pytest.raises(ValueError, match='Unfoldable'):
        fold_batchnorm(module.state_dict(), module)
    assert fold_batchnorm(module.state_dict(), module, strict=False)[1] == 1
    with pytest.raises(TypeError, match='f32'):
        fold_batchnorm({k: v.to(torch.bfloat16) for k, v in module.state_dict().items()},
                       module, strict=False)
