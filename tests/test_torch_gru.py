"""K11's plain version (the SpatialGRU's gate arithmetic, fiery_tpu_torch
ops/spatial_gru.py) against the JAX package (CPU).

- A 2-step SpatialGRU of the tiny model, weights through state_dict_from_jax, in
  training (batch statistics): forward within 1e-5, gradients of the input frames,
  the initial state and every parameter within a relative L2 error of 1e-3 (f32).
- The gate arithmetic of SpatialGRU.__call__ in bf16, bit for bit: every bf16
  operation rounds as XLA's CPU rounds it (sigmoid as 1 / (1 + exp(-z)), each
  step rounded); in f32 within 1e-6 (XLA's f32 exp differs by ulps).
- The hand-written backward equals autograd of the plain forward (f32, 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.models.temporal_layers import SpatialGRU as JaxSpatialGRU
from fiery_tpu_torch.ops import spatial_gru as gru_op
from fiery_tpu_torch.utils.weight_import import state_dict_from_jax

from test_torch_fiery import jax_tiny_model, ported_tiny_model
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope='module')
def tiny():
    _, _, variables = jax_tiny_model(seed=4)
    return variables, ported_tiny_model(variables)


def test_spatial_gru_matches_jax(tiny):
    variables, model = tiny
    sub = {c: variables[c]['future_prediction']['SpatialGRU_0']
           for c in ('params', 'batch_stats')}
    rng = np.random.RandomState(30)
    x = rng.randn(2, 2, 32, 32, 4).astype(np.float32)          # 2 steps, latent 4
    state = rng.randn(2, 32, 32, 16).astype(np.float32)
    cot = rng.randn(2, 2, 32, 32, 16).astype(np.float32)
    module = JaxSpatialGRU(hidden_size=16)

    def loss(params, x_in, s_in):
        y, _ = module.apply({'params': params, 'batch_stats': sub['batch_stats']}, x_in,
                            s_in, train=True, mutable=['batch_stats'])
        return jnp.sum(y * cot), y

    (gp, gx, gs), want = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        sub['params'], x, state)

    gru = model.future_prediction.spatial_grus[0].train()
    xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3).requires_grad_()
    st = torch.from_numpy(state).permute(0, 3, 1, 2).requires_grad_()
    got = gru(xt, st)
    (got * torch.from_numpy(cot).permute(0, 1, 4, 2, 3)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 1, 3, 4, 2).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert rel_l2(xt.grad.permute(0, 1, 3, 4, 2).numpy(), gx) <= 1e-3
    assert rel_l2(st.grad.permute(0, 2, 3, 1).numpy(), gs) <= 1e-3
    # the JAX parameter gradients in the port's layout, through the weight table
    params = jax.tree.map(np.zeros_like, variables['params'])
    params['future_prediction']['SpatialGRU_0'] = jax.tree.map(np.asarray, gp)
    grads = state_dict_from_jax({'params': params, 'batch_stats': variables['batch_stats']},
                                model.cfg)
    prefix = 'future_prediction.spatial_grus.0.'
    named = dict(gru.named_parameters())
    assert len(named) == 7
    for name, p in named.items():
        err = rel_l2(p.grad.numpy(), grads[prefix + name].numpy())
        assert err <= 1e-3, (name, err)


def jax_gate_math(x_t, gates_pre, h, h_tilde):
    """The gate arithmetic of fiery_tpu SpatialGRU.__call__ around its convs (the
    fused gate conv's output gates_pre = [update, reset] pre-activations)."""
    C = h.shape[-1]
    gates = jax.nn.sigmoid(gates_pre + 0.0)
    update_gate, reset_gate = gates[..., :C], gates[..., C:]
    cat = jnp.concatenate([x_t, (1.0 - reset_gate) * h], axis=-1)
    return cat, (1.0 - update_gate) * h + update_gate * h_tilde


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_gate_math_rounds_as_jax(dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.RandomState(31)
    x_t, h, h_tilde = (jnp.asarray(rng.randn(2, 9, 11, c) * 2, jd) for c in (5, 8, 8))
    gates_pre = jnp.asarray(rng.randn(2, 9, 11, 16) * 3, jd)
    cat, h_new = jax.jit(jax_gate_math)(x_t, gates_pre, h, h_tilde)

    def port(a):
        return torch.tensor(np.asarray(a.astype(jnp.float32))).to(dtype).permute(0, 3, 1, 2)

    def back(t):
        return t.float().permute(0, 2, 3, 1).numpy()

    u_pre, r_pre = port(gates_pre[..., :8]), port(gates_pre[..., 8:])
    got_cat = gru_op.reset_concat_plain(port(x_t), r_pre, port(h))
    got_h = gru_op.state_update_plain(u_pre, port(h), port(h_tilde))
    tol = 0.0 if dtype == torch.bfloat16 else 1e-6
    for got, want in ((got_cat, cat), (got_h, h_new)):
        np.testing.assert_allclose(back(got), np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_backward_equals_autograd_of_forward():
    rng = np.random.RandomState(32)
    x_t, r_pre, u_pre, h, ht = (torch.from_numpy(rng.randn(2, c, 5, 6).astype(np.float32) * 2)
                                .requires_grad_() for c in (3, 4, 4, 4, 4))
    g_cat, g_out = (torch.from_numpy(rng.randn(2, c, 5, 6).astype(np.float32)) for c in (7, 4))
    want = torch.autograd.grad(gru_op.reset_concat_plain(x_t, r_pre, h), (r_pre, h), g_cat)
    got = gru_op.reset_concat_backward_plain(g_cat[:, 3:], r_pre.detach(), h.detach())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    want = torch.autograd.grad(gru_op.state_update_plain(u_pre, h, ht), (u_pre, h, ht), g_out)
    got = gru_op.state_update_backward_plain(g_out, u_pre.detach(), h.detach(), ht.detach())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
