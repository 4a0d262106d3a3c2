"""Two repairs of the port's training path (CPU).

- The pyramid pooling broadcasts its 1x1 pooled map to the BEV grid instead of
  resizing it: the forward is the resize's bit for bit in bf16 (PRECISION 16),
  and the module (train mode, batch statistics) holds to the JAX package's in f32:
  forward within 1e-5, gradients of x and of the parameters within a relative L2
  error of 1e-4.
- The training forward draws its drop-connect masks and latent noise from the
  generator it is given, and from no other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.models.temporal_layers import (
    PyramidSpatioTemporalPooling as JaxPooling)
from fiery_tpu_torch.models.layers import resize_bilinear
from fiery_tpu_torch.models.temporal_layers import (PyramidSpatioTemporalPooling,
                                                    _causal_avg_pool3d)
from fiery_tpu_torch.utils.weight_import import _conv1x1x1_norm_act, _to_torch_layout

from test_torch_fiery import _randomize_stats
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def pooling_pair(seed=0, C=14, reduction=5, T=3, H=12, W=10):
    """The JAX pooling with its initial weights and randomised statistics, and the
    port's module loaded with them."""
    jmodule = JaxPooling(reduction_channels=reduction, pool_sizes=[(2, H, W)])
    x = np.random.RandomState(seed).randn(2, T, H, W, C).astype(np.float32)
    variables = jax.tree.map(np.asarray, jmodule.init(jax.random.key(seed), x))
    variables['batch_stats'] = _randomize_stats(variables['batch_stats'],
                                                np.random.RandomState(seed + 1))
    module = PyramidSpatioTemporalPooling(C, reduction, [(2, H, W)])
    state = {}
    for path, name, kind, coll in _conv1x1x1_norm_act(('Conv1x1x1NormActivated_0',),
                                                      'features.0.conv_bn_relu'):
        leaf = variables[coll]
        for k in path:
            leaf = leaf[k]
        state[name] = torch.tensor(_to_torch_layout(np.asarray(leaf), kind))
    state['features.0.conv_bn_relu.norm.num_batches_tracked'] = torch.tensor(0)
    module.load_state_dict(state, strict=True)
    return jmodule, variables, module, x


@pytest.mark.parametrize('drop_front', [0, 1])
def test_pyramid_pooling_broadcast_matches_resize_and_jax(drop_front):
    jmodule, variables, module, x = pooling_pair(seed=drop_front)
    # bf16: the broadcast equals the resize bit for bit (eval, as served)
    xb = torch.from_numpy(x).to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    module.eval()
    with torch.no_grad():
        got = module(xb, drop_front=drop_front)
        pooled = module.features[0].conv_bn_relu(
            _causal_avg_pool3d(xb, module.pool_sizes[0])[:, :, drop_front:])
        b, c, t = pooled.shape[:3]
        frames = resize_bilinear(pooled.transpose(1, 2).reshape(b * t, c, 1, 1), x.shape[2:4])
        want = frames.view(b, t, c, *x.shape[2:4]).transpose(1, 2)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)

    # f32, train mode: forward and gradients against JAX
    cot = np.random.RandomState(9).randn(*got.permute(0, 2, 3, 4, 1).shape).astype(np.float32)

    def loss(params, x_in):
        y, _ = jmodule.apply({'params': params, 'batch_stats': variables['batch_stats']},
                             x_in, train=True, drop_front=drop_front, mutable=['batch_stats'])
        return jnp.sum(y * cot), y

    (gp, gx), want = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
        variables['params'], x)
    module.train()
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
    y = module(xt, drop_front=drop_front)
    (y * torch.from_numpy(cot).permute(0, 4, 1, 2, 3)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert rel_l2(xt.grad.permute(0, 2, 3, 4, 1).numpy(), gx) <= 1e-4
    inner = gp['Conv1x1x1NormActivated_0']
    branch = module.features[0].conv_bn_relu
    for got_g, want_g in ((branch.conv.weight.grad, _to_torch_layout(
            np.asarray(inner['Conv_0']['kernel']), 'conv3d_1x1')),
                          (branch.norm.weight.grad, inner['BatchNorm_0']['BatchNorm_0']['scale']),
                          (branch.norm.bias.grad, inner['BatchNorm_0']['BatchNorm_0']['bias'])):
        assert rel_l2(got_g.numpy(), want_g) <= 1e-4


def test_training_draws_come_from_the_given_generator():
    """Drop-connect and the latent noise of a training forward: the same seed gives
    the same output, another seed another, and torch's default generator is not
    touched."""
    from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
    from fiery_tpu_torch.serve import init_params
    from fiery_tpu_torch.training.trainer import INPUTS, Trainer
    from fiery_tpu_torch.utils.config import get_cfg
    from test_torch_trainer import TINY

    cfg = get_cfg(cfg_dict=TINY)
    trainer = Trainer(cfg, device='cpu')
    model = init_params(trainer.model, seed=0).train()
    batch = trainer.to_device(SyntheticFutureDataset(cfg, n_samples=2, seed=0)
                              .get_batch([0, 1]))
    _, fdi = trainer.prepare_future_labels(batch)
    assert any(blk.drop_rate > 0 and blk.has_skip for blk in model.encoder.backbone._blocks)

    def forward(seed):
        with torch.no_grad():
            out = model(*(batch[k] for k in INPUTS), fdi,
                        generator=torch.Generator().manual_seed(seed))
        return out['segmentation']

    rng_state = torch.get_rng_state()
    a, b, c = forward(7), forward(7), forward(8)
    assert torch.equal(torch.get_rng_state(), rng_state)
    assert torch.equal(a, b) and not torch.equal(a, c)
