"""K10's plain version (fiery_tpu_torch BatchNorm with post=) against the JAX
package's BatchNorm(post=) (CPU), and the tiny model's path through it.

Forward: f32 within 1e-5 (atol and rtol); bf16 within one bf16 ulp of JAX's
value (it matches bit for bit in these cases: every bf16 operation rounds as
XLA's CPU rounds it). Running statistics within 1e-6 relative (1e-7 absolute).
Gradients of x, scale, bias and the residual under jax.grad: relative L2 error
1e-4, in f32 (in bf16 JAX rounds every operation of its backward, sums included,
and its gradients stand 1-3% from the exact ones; the port forms the backward in
f32, and chip_smoke.py holds the bf16 kernel to its plain version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.models.layers import BatchNorm as JaxBatchNorm
from fiery_tpu_torch.models.layers import BatchNorm
from fiery_tpu_torch.ops import batch_norm as bn_op

POSTS = ('none', 'relu', 'swish', 'add', 'add_relu', 'relu_add')
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def bf16_ulp(v):
    a = np.maximum(np.abs(v.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def run_both(post, train, dtype, shape, mean=0.0, std=1.0, seed=0, momentum=0.1,
             eps=1e-5):
    """The same numpy inputs through JAX (value, new statistics, grads) and the
    port; returns a dict of pairs (port, jax) as float64 numpy, channels-last."""
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = (rng.randn(*shape) * std + mean).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32) if post in bn_op.RESIDUAL_POSTS else None
    cot = rng.randn(*shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    rmean = (mean + rng.randn(C) * 0.1 * std).astype(np.float32)
    rvar = (std * std * rng.uniform(0.5, 1.5, C)).astype(np.float32)
    jd = JNP[dtype]
    xj = jnp.asarray(x, jd)
    rj = None if res is None else jnp.asarray(res, jd)
    module = JaxBatchNorm(momentum=momentum, epsilon=eps, dtype=jd, post=post)
    stats = {'BatchNorm_0': {'mean': rmean, 'var': rvar}}

    def loss(params, x_in, r_in):
        y, new = module.apply({'params': params, 'batch_stats': stats}, x_in, train=train,
                              residual=r_in, mutable=['batch_stats'])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, new)

    params = {'BatchNorm_0': {'scale': scale, 'bias': bias}}
    argnums = (0, 1) if res is None else (0, 1, 2)
    grads, (y_j, new_j) = jax.jit(jax.grad(loss, argnums=argnums, has_aux=True))(
        params, xj, rj)

    bn = BatchNorm(C, eps=eps, momentum=momentum, post=post).train(train)
    with torch.no_grad():
        for p, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, rmean),
                     (bn.running_var, rvar)):
            p.copy_(torch.from_numpy(v))

    def channels_first(a):
        t = torch.tensor(np.asarray(jnp.asarray(a, jd).astype(jnp.float32))).to(dtype)
        return t.movedim(-1, 1).requires_grad_()

    xt = channels_first(x)
    rt = None if res is None else channels_first(res)
    y = bn(xt, residual=rt)
    (y.float() * torch.from_numpy(cot).movedim(-1, 1)).sum().backward()

    def np64(t):
        return t.detach().float().movedim(1, -1).double().numpy()

    out = {'y': (np64(y), np.asarray(y_j.astype(jnp.float32), np.float64)),
           'dx': (np64(xt.grad), np.asarray(grads[1].astype(jnp.float32), np.float64)),
           'dscale': (bn.weight.grad.double().numpy(),
                      np.asarray(grads[0]['BatchNorm_0']['scale'], np.float64)),
           'dbias': (bn.bias.grad.double().numpy(),
                     np.asarray(grads[0]['BatchNorm_0']['bias'], np.float64))}
    if res is not None:
        out['dres'] = (np64(rt.grad), np.asarray(grads[2].astype(jnp.float32), np.float64))
    if train:
        out['running_mean'] = (bn.running_mean.double().numpy(),
                               np.asarray(new_j['batch_stats']['BatchNorm_0']['mean']))
        out['running_var'] = (bn.running_var.double().numpy(),
                              np.asarray(new_j['batch_stats']['BatchNorm_0']['var']))
    return out


def check(out, dtype):
    got, want = out['y']
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        bad = np.abs(got - want) > bf16_ulp(want)
        assert not bad.any(), f'{int(bad.sum())} values beyond one bf16 ulp, max ' \
                              f'{np.abs(got - want).max()}'
    for k in ('running_mean', 'running_var'):
        if k in out:
            np.testing.assert_allclose(*out[k], rtol=1e-6, atol=1e-7, err_msg=k)
    if dtype != torch.float32:
        return
    for k in ('dx', 'dscale', 'dbias', 'dres'):
        if k in out:
            err = rel_l2(*out[k])
            assert err <= 1e-4, f'{k}: relative L2 error {err:.3e}'


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('post', POSTS)
def test_batchnorm_matches_jax(post, train, dtype):
    """Every epilogue, eval and training, f32 and bf16; 5-D inputs (the temporal
    model's) for relu and add, 4-D for the others."""
    shape = (2, 3, 6, 5, 12) if post in ('relu', 'add') else (3, 7, 6, 12)
    check(run_both(post, train, dtype, shape, seed=POSTS.index(post)), dtype)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_batchnorm_bf16_offset_mean_matches_jax(train):
    """Inputs of mean 37.3 and std 0.5 in bf16 (PRECISION 16): JAX rounds the mean,
    mul and bias to bf16 and then each operation; normalising with f32 constants
    and rounding once (F.batch_norm) lands up to 0.2 away on outputs of |y| < 4."""
    check(run_both('none', train, torch.bfloat16, (2, 16, 16, 8), mean=37.3, std=0.5,
                   seed=5), torch.bfloat16)


def test_batchnorm_cumulative_momentum_and_errors():
    """momentum None: one batch from reset sets the running statistics to the batch
    statistics (the biased variance); a residual epilogue needs a residual."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, 5, 6, 3).astype(np.float32)).movedim(-1, 1)
    bn = BatchNorm(3, momentum=None).train()
    bn(x)
    xd = x.double()
    torch.testing.assert_close(bn.running_mean, xd.mean((0, 2, 3)).float())
    torch.testing.assert_close(bn.running_var, xd.var((0, 2, 3), unbiased=False).float())
    assert int(bn.num_batches_tracked) == 1
    with pytest.raises(ValueError):
        BatchNorm(3, post='add')(x)
    with pytest.raises(ValueError):
        BatchNorm(3, post='gelu')
    assert bn_op.rows_form(x) == '4d' and bn_op.rows_form(x.contiguous()) is None


def test_tiny_path_runs_every_bn_and_gru_step_through_the_wrappers():
    """The tiny model's request and training step: every BatchNorm call goes
    through batch_norm (forward) and batch_norm_backward, on channels-last rows,
    and every SpatialGRU step through the two K11 launches forward and backward."""
    from fiery_tpu_torch.ops.spatial_gru import spatial_gru, spatial_gru_backward
    from fiery_tpu_torch.serve import calibrate_batchnorm, init_params, make_request
    from fiery_tpu_torch.training.trainer import Trainer
    from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
    from fiery_tpu_torch.utils.config import get_cfg
    from test_torch_trainer import TINY as TINY_TRAIN

    cfg = get_cfg(cfg_dict=TINY_TRAIN)
    trainer = Trainer(cfg, device='cpu')
    model = init_params(trainer.model, seed=0)
    calibrate_batchnorm(model, [make_request(cfg, seed=1)])
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    calls, forms = [0], set()

    def hook(module, args, kwargs):
        calls[0] += 1
        forms.add(bn_op.rows_form(args[0]))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in bns]
    mc = model.cfg
    gru_steps = mc.n_gru_blocks * mc.n_future
    counters = (bn_op.batch_norm_forward, bn_op.batch_norm_backward, spatial_gru,
                spatial_gru_backward)
    try:
        for training in (False, True):
            for c in counters:
                c.plain_calls = 0
            calls[0] = 0
            if training:
                batch = SyntheticFutureDataset(cfg, n_samples=2, seed=0).get_batch([0, 1])
                trainer.train_step(batch, torch.Generator().manual_seed(0))
            else:
                model.eval()
                from fiery_tpu_torch.serve import predict
                predict(model, make_request(cfg, seed=2))
            assert calls[0] > 0 and forms == {'4d', '5d'}, forms
            assert bn_op.batch_norm_forward.plain_calls == calls[0]
            assert spatial_gru.plain_calls == 2 * gru_steps
            if training:
                assert bn_op.batch_norm_backward.plain_calls == calls[0]
                assert spatial_gru_backward.plain_calls == 2 * gru_steps
    finally:
        for h in handles:
            h.remove()
    assert bn_op.batch_norm_forward.launches == 0 and spatial_gru.launches == 0
