"""fiery_tpu_torch.training.losses against fiery_tpu.training.losses (the JAX
reference), f32 on the CPU, inputs made with numpy from fixed seeds. The
kth_largest kernel-vs-plain test is in test_torch_train_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.training import losses as JL
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu_torch.training import losses as L
from fiery_tpu_torch.utils.config import get_cfg


def _rows_with_ties(rng, rows=4, n=400, k=100):
    """Rows of non-negative losses with a block of exact zeros (masked pixels) and,
    in every other row, a run of equal values straddling the k-th position."""
    x = rng.rand(rows, n).astype(np.float32)
    x[:, : n // 3] = 0.0
    for r in range(0, rows, 2):
        order = np.argsort(-x[r])
        x[r, order[k - 5:k + 7]] = x[r, order[k - 5]]
    x[1, :] = np.where(rng.rand(n) < 0.8, 0.0, x[1])     # the k-th value is a zero
    return x


def test_kth_largest_plain_matches_jax_radix_select():
    rng = np.random.RandomState(0)
    x = np.concatenate([_rows_with_ties(rng), rng.randn(3, 400).astype(np.float32)])
    x[-1, :7] = [-0.0, 0.0, np.inf, -np.inf, 1e-40, -1e-40, 3.0]
    for k in (1, 37, 100, 400):
        want = np.asarray(JL._kth_largest(jnp.asarray(x), k))
        got = L.kth_largest(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f'k={k}')


@pytest.mark.parametrize('ties', [False, True])
def test_top_k_mean_forward_and_gradient_match_jax(ties):
    """Value and gradient equal the JAX custom VJP; with ties at the k-th value the
    gradient is spread over every entry >= it (more than k of them)."""
    rng = np.random.RandomState(1)
    k = 100
    x = _rows_with_ties(rng) if ties else rng.randn(4, 400).astype(np.float32)
    x = x.reshape(2, 2, 400)
    want, want_grad = jax.value_and_grad(lambda v: 3.0 * JL._top_k_mean(v, k))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = 3.0 * L.top_k_mean(xt, k)
    (grad,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(got.detach()) / 3.0, float(torch.topk(
        torch.from_numpy(x), k).values.mean()), rtol=1e-6)
    picked = (grad > 0).sum(-1)
    assert bool((picked > k).any()) == ties
    torch.testing.assert_close(grad.sum(-1), torch.full((2, 2), 3.0 / 4))


def _label_maps(rng, b=2, s=3, h=12, w=10):
    seg = rng.randint(0, 2, (b, s, h, w)).astype(np.int32)
    seg[:, :, :2] = 255
    offset = rng.randn(b, s, h, w, 2).astype(np.float32)
    offset[rng.rand(b, s, h, w) < 0.6] = 255.0
    return seg, offset


def test_segmentation_loss_matches_jax():
    rng = np.random.RandomState(2)
    seg, _ = _label_maps(rng)
    pred = rng.randn(*seg.shape, 2).astype(np.float32)
    for top_k in (False, True):
        kw = dict(class_weights=[1.0, 2.0], ignore_index=255, use_top_k=top_k,
                  top_k_ratio=0.25, future_discount=0.95)
        want, want_grad = jax.value_and_grad(lambda p: JL.segmentation_loss(
            p, jnp.asarray(seg), **kw))(jnp.asarray(pred))
        pt = torch.from_numpy(pred).requires_grad_()
        got = L.segmentation_loss(pt, torch.from_numpy(seg), **kw)
        (grad,) = torch.autograd.grad(got, pt)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize('norm', [1, 2])
def test_spatial_regression_loss_matches_jax(norm):
    rng = np.random.RandomState(3 + norm)
    _, target = _label_maps(rng)
    pred = rng.randn(*target.shape).astype(np.float32)
    want = JL.spatial_regression_loss(jnp.asarray(pred), jnp.asarray(target), norm,
                                      future_discount=0.95)
    got = L.spatial_regression_loss(torch.from_numpy(pred), torch.from_numpy(target), norm,
                                     future_discount=0.95)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    empty = torch.full_like(torch.from_numpy(target), 255.0)
    assert float(L.spatial_regression_loss(torch.from_numpy(pred), empty, norm)) == 0.0


def _outputs_and_labels(rng, b=2, s=3, h=12, w=10, latent=4):
    seg, offset = _label_maps(rng, b, s, h, w)
    flow = np.where(offset == 255.0, 255.0, rng.randn(*offset.shape)).astype(np.float32)
    output = {'segmentation': rng.randn(b, s, h, w, 2),
              'instance_center': rng.rand(b, s, h, w, 1),
              'instance_offset': rng.randn(b, s, h, w, 2),
              'instance_flow': rng.randn(b, s, h, w, 2),
              'present_mu': rng.randn(b, 1, latent), 'present_log_sigma': rng.randn(b, 1, latent),
              'future_mu': rng.randn(b, 1, latent), 'future_log_sigma': rng.randn(b, 1, latent)}
    output = {k: v.astype(np.float32) for k, v in output.items()}
    labels = {'segmentation': seg, 'centerness': rng.rand(b, s, h, w, 1).astype(np.float32),
              'offset': offset, 'flow': flow}
    return output, labels


def test_probabilistic_loss_matches_jax():
    output, _ = _outputs_and_labels(np.random.RandomState(5))
    want = JL.probabilistic_loss({k: jnp.asarray(v) for k, v in output.items()})
    got = L.probabilistic_loss({k: torch.from_numpy(v) for k, v in output.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_compute_losses_matches_jax():
    """The whole loss dict, with non-zero uncertainty weights, and its gradient with
    respect to the segmentation logits and the weights."""
    rng = np.random.RandomState(6)
    output, labels = _outputs_and_labels(rng)
    overrides = {'SEMANTIC_SEG': {'TOP_K_RATIO': 0.3}, 'FUTURE_DISCOUNT': 0.9}
    jcfg, cfg = jax_get_cfg(cfg_dict=overrides), get_cfg(cfg_dict=overrides)
    uw = {k: float(v) for k, v in zip(
        ['segmentation_weight', 'centerness_weight', 'offset_weight', 'flow_weight'],
        rng.randn(4) * 0.3)}

    def jax_total(out, weights):
        d = JL.compute_losses(out, {k: jnp.asarray(v) for k, v in labels.items()},
                              weights, jcfg)
        return sum(d.values()), d

    (want_total, want), (want_g_out, want_g_uw) = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in output.items()},
            {k: jnp.asarray(v, jnp.float32) for k, v in uw.items()})
    out_t = {k: torch.from_numpy(v).requires_grad_() for k, v in output.items()}
    weights = L.init_uncertainty_weights(True)
    with torch.no_grad():
        for k, v in uw.items():
            weights[k].fill_(v)
    got = L.compute_losses(out_t, {k: torch.from_numpy(v) for k, v in labels.items()},
                           weights, cfg)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(float(v.detach()), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    sum(got.values()).backward()
    for k, t in out_t.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g_out[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for k, p in weights.items():
        np.testing.assert_allclose(float(p.grad), float(want_g_uw[k]), rtol=1e-5, err_msg=k)
