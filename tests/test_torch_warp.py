"""fiery_tpu_torch.ops.warp against fiery_tpu.ops.warp (the JAX reference) and torch's
own affine_grid + grid_sample. The bev_warp kernel-vs-plain test needs a CUDA card
and skips without one."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp

from fiery_tpu.ops import warp as JW
from fiery_tpu_torch.ops import warp as W
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


def _poses(rng, shape):
    flow = np.zeros(shape + (6,), np.float32)
    flow[..., 0] = rng.uniform(-3, 3, shape)        # forward metres
    flow[..., 1] = rng.uniform(-3, 3, shape)        # sideways metres
    flow[..., 2] = rng.uniform(-0.2, 0.2, shape)
    flow[..., 3:5] = rng.uniform(-0.02, 0.02, shape + (2,))
    flow[..., 5] = rng.uniform(-0.3, 0.3, shape)    # yaw
    return flow


def test_compose_poses_matches_jax():
    flow = _poses(np.random.RandomState(0), (2, 4))
    want = np.asarray(JW.compose_poses_to_present(jnp.asarray(flow)))
    got = W.compose_poses_to_present(torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cumulative_warp_plain_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 3, 16, 16, 8).astype(np.float32)
    flow = _poses(rng, (1, 3))
    extent = (8.0, 8.0)
    want = np.asarray(JW.cumulative_warp_features(jnp.asarray(x), jnp.asarray(flow),
                                                  mode='bilinear', spatial_extent=extent))
    got = W.cumulative_warp_features(torch.from_numpy(x), torch.from_numpy(flow),
                                     mode='bilinear', spatial_extent=extent).numpy()
    np.testing.assert_array_equal(got[:, -1], x[:, -1])
    assert np.abs(got[:, :-1] - x[:, :-1]).max() > 0.1   # the past frames moved
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('hw', [(40, 50), (200, 200)])
def test_bev_warp_plain_matches_grid_sample(hw):
    """The plain warp is torch's affine_grid + grid_sample (align_corners=False,
    zero padding) with the reference's sign conventions."""
    rng = np.random.RandomState(2)
    H, Wd = hw
    x = torch.from_numpy(rng.randn(3, H, Wd, 4).astype(np.float32))
    flow = torch.from_numpy(_poses(rng, (3,)))
    extent = (50.0, 25.0)
    got = W.bev_warp_plain(x, flow, extent)
    theta = torch.stack([torch.cos(flow[:, 5]), -torch.sin(flow[:, 5]), flow[:, 1] / extent[1],
                         torch.sin(flow[:, 5]), torch.cos(flow[:, 5]), -flow[:, 0] / extent[0]],
                        -1).view(3, 2, 3)
    xc = x.permute(0, 3, 1, 2)
    grid = F.affine_grid(theta, list(xc.shape), align_corners=False)
    want = F.grid_sample(xc, grid, mode='bilinear', padding_mode='zeros',
                         align_corners=False).permute(0, 2, 3, 1)
    # affine_grid builds its base grid with linspace and a batched matmul, a few f32
    # ulp away from the explicit arithmetic; unnormalising multiplies that by W / 2
    # (100 px here). 5e-4 is the tolerance tests/test_warp.py holds JAX to.
    torch.testing.assert_close(got, want, rtol=0, atol=5e-4)


def test_warp_theta_and_grid_match_jax():
    rng = np.random.RandomState(3)
    flow = _poses(rng, (4,))
    want_theta = np.asarray(JW._warp_theta(jnp.asarray(flow), (50.0, 50.0), jnp.float32))
    theta = W._warp_theta(torch.from_numpy(flow), (50.0, 50.0), torch.float32)
    np.testing.assert_allclose(theta.numpy(), want_theta, rtol=1e-6, atol=1e-7)
    want_grid = np.asarray(JW._affine_grid(jnp.asarray(want_theta), 20, 30))
    np.testing.assert_allclose(W._affine_grid(theta, 20, 30).numpy(), want_grid,
                               rtol=1e-6, atol=1e-6)


def test_warp_features_rejects_unported_mode():
    """Bilinear and nearest are the two modes; any other raises."""
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match='bicubic'):
        W.warp_features(x, torch.zeros(1, 6), mode='bicubic', spatial_extent=(1.0, 1.0))
    assert W.warp_features(x, None) is x
    with pytest.raises(ValueError, match='no gradient'):
        W.warp_features(x.requires_grad_(), torch.zeros(1, 6), mode='nearest',
                        spatial_extent=(1.0, 1.0))


def test_cumulative_warp_reverse_nearest_matches_jax():
    """The label warp (nearest, reverse poses) equals the JAX package's exactly on
    generic poses, label-like values included (integers, 255 ignore)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 24, 20, 7).astype(np.float32)
    x[..., 0] = rng.randint(0, 3, x.shape[:-1])
    x[..., 3:5] = np.where(rng.rand(*x.shape[:-1], 1) < 0.5, 255.0, x[..., 3:5])
    flow = _poses(rng, (2, 4))
    extent = (6.0, 5.0)
    want = np.asarray(JW.cumulative_warp_features_reverse(
        jnp.asarray(x), jnp.asarray(flow), mode='nearest', spatial_extent=extent))
    got = W.cumulative_warp_features_reverse(torch.from_numpy(x), torch.from_numpy(flow),
                                             mode='nearest', spatial_extent=extent).numpy()
    np.testing.assert_array_equal(got[:, 0], x[:, 0])
    assert (got[:, 1:] == 0).mean() > 0.01            # some taps fell outside the map
    np.testing.assert_array_equal(got, want)


def test_bev_warp_nearest_plain_matches_grid_sample():
    """torch's grid_sample(mode='nearest') on the plain version's grid; it rounds
    half to even as torch.round does."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(3, 30, 40, 5).astype(np.float32))
    flow = torch.from_numpy(_poses(rng, (3,)))
    extent = (15.0, 20.0)
    got = W.bev_warp_nearest_plain(x, flow, extent)
    grid = W._affine_grid(W._warp_theta(flow, extent, torch.float32), 30, 40)
    want = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode='nearest', padding_mode='zeros',
                         align_corners=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bev_warp_backward_plain_is_autograd_of_plain():
    """The plain backward equals torch autograd through the plain forward, and the
    autograd.Function routes a CPU tensor's gradient to it."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(3, 20, 18, 4).astype(np.float32)).requires_grad_()
    flow = torch.from_numpy(_poses(rng, (3,)))
    g = torch.from_numpy(rng.randn(3, 20, 18, 4).astype(np.float32))
    extent = (10.0, 9.0)
    (want,) = torch.autograd.grad(W.bev_warp_plain(x, flow, extent), x, g)
    got = W.bev_warp_backward_plain(g, flow, extent)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    (through_fn,) = torch.autograd.grad(W.bev_warp(x, flow, extent), x, g)
    torch.testing.assert_close(through_fn, got, rtol=0, atol=0)
    assert float(got.abs().sum()) > 0


def test_cumulative_warp_backward_matches_jax_vjp():
    """K2's gradient with respect to the features against jax.vjp of the JAX
    cumulative warp, f32."""
    import jax
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, 16, 16, 6).astype(np.float32)
    flow = _poses(rng, (2, 3))
    g = rng.randn(*x.shape).astype(np.float32)
    extent = (8.0, 8.0)
    _, vjp = jax.vjp(lambda v: JW.cumulative_warp_features(
        v, jnp.asarray(flow), mode='bilinear', spatial_extent=extent), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = W.cumulative_warp_features(xt, torch.from_numpy(flow), mode='bilinear',
                                     spatial_extent=extent)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_warp_kernel_matches_plain(dtype):
    """On the card: kernel vs plain version at the baseline serve shapes. Both do
    the same rounded f32 operations in the same order (f32: atol 1e-5); bf16 rounds
    theta, the grid and the output at the same places (within one bf16 ulp)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 200, 200, 64).astype(np.float32)).to('cuda', dtype)
    flow = torch.from_numpy(_poses(rng, (2,))).cuda()
    launches = W.bev_warp.launches
    got = W.bev_warp(x, flow, (50.0, 50.0)).float()
    assert W.bev_warp.launches == launches + 1
    want = W.bev_warp_plain(x, flow, (50.0, 50.0)).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((got - want).abs() <= ulp + 1e-5).all())
