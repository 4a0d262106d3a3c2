"""fiery_tpu_torch.ops.lift_splat against fiery_tpu.ops.lift_splat (the JAX reference).

Inputs are made with numpy from fixed seeds and handed to both. The bev_pool
kernel-vs-plain test needs a CUDA card and skips without one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiery_tpu.ops import lift_splat as JLS
from fiery_tpu_torch.ops import lift_splat as LS
from fiery_tpu_torch.utils.geometry import calculate_birds_eye_view_parameters

FINAL_DIM, DOWNSAMPLE, D_BOUND = (64, 96), 8, (2.0, 8.0, 1.0)
BOUNDS = ((-8.0, 8.0, 0.5), (-8.0, 8.0, 0.5), (-10.0, 10.0, 20.0))


def _rig(rng, b=2, n=3):
    """Cameras looking outwards at 1.6 m with a little random jitter."""
    H, W = FINAL_DIM
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    intr = np.broadcast_to(K, (b, n, 3, 3)).copy()
    extr = np.zeros((b, n, 4, 4), np.float32)
    for i in range(b):
        for j in range(n):
            yaw = 2 * np.pi * j / n + rng.uniform(-0.1, 0.1)
            c, s = np.cos(yaw), np.sin(yaw)
            extr[i, j, :3, :3] = [[-s, 0, c], [c, 0, s], [0, -1, 0]]
            extr[i, j, :3, 3] = [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), 1.6]
            extr[i, j, 3, 3] = 1.0
    return intr, extr


def _geometry(rng, b=2, n=3):
    frustum = JLS.create_frustum(FINAL_DIM, DOWNSAMPLE, D_BOUND)
    intr, extr = _rig(rng, b, n)
    return frustum, intr, extr


def test_create_frustum_matches_jax():
    np.testing.assert_array_equal(LS.create_frustum(FINAL_DIM, DOWNSAMPLE, D_BOUND),
                                  JLS.create_frustum(FINAL_DIM, DOWNSAMPLE, D_BOUND))


def test_get_geometry_matches_jax():
    frustum, intr, extr = _geometry(np.random.RandomState(0))
    want = np.asarray(JLS.get_geometry(jnp.asarray(frustum), jnp.asarray(intr),
                                       jnp.asarray(extr)))
    got = LS.get_geometry(torch.from_numpy(frustum), torch.from_numpy(intr),
                          torch.from_numpy(extr)).numpy()
    assert got.shape == want.shape == (2, 3, 6, 8, 12, 3)
    # f32 inverse and matmul in two libraries: a few ulp at |xyz| <= ~10 m
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_voxel_ids_match_jax_exactly():
    """Same geometry in, int-exact ids out: trunc (not floor) keeps points in the
    (-1, 0) fractional bin, and out-of-bounds points go to the dump bin X*Y*Z."""
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    rng = np.random.RandomState(1)
    geom = rng.uniform(-11.0, 11.0, (4000, 3)).astype(np.float32)
    low_edge = (start - res / 2.0).astype(np.float32)
    # points in the (-1, 0) fractional bin of x, of y, and of both
    frac = rng.uniform(0.05, 0.95, (300, 1)).astype(np.float32)
    edge = rng.uniform(-3.0, 3.0, (300, 3)).astype(np.float32)
    edge[:100, 0] = low_edge[0] - frac[:100, 0] * res[0]
    edge[100:200, 1] = low_edge[1] - frac[100:200, 0] * res[1]
    edge[200:, :2] = low_edge[:2] - frac[200:] * res[:2]
    geom = np.concatenate([geom, edge])

    want = np.asarray(JLS.voxel_ids(jnp.asarray(geom), res, start, dim))
    got = LS.voxel_ids(torch.from_numpy(geom), res, start, dim).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    dump = int(np.prod(dim))
    assert (got == dump).sum() > 1000                    # out of bounds: routed to dump
    assert (got[4000:] != dump).all()                    # (-1, 0) bins survive
    np.testing.assert_array_equal(got[4000:4100] // int(dim[1] * dim[2]), 0)


def test_lift_splat_plain_matches_jax():
    rng = np.random.RandomState(2)
    frustum, intr, extr = _geometry(rng)
    geometry = np.asarray(JLS.get_geometry(jnp.asarray(frustum), jnp.asarray(intr),
                                           jnp.asarray(extr)))
    D, h, w = frustum.shape[:3]
    features = rng.randn(2, 3, h, w, D, 16).astype(np.float32)
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    want = np.asarray(JLS.lift_splat(jnp.asarray(features), jnp.asarray(geometry),
                                     res, start, dim))
    got = LS.lift_splat(torch.from_numpy(features), torch.tensor(geometry),
                        res, start, dim).numpy()
    assert got.shape == want.shape == (2, 32, 32, 16)
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lift_splat_depth_matches_jax_outer_product_splat():
    """The serving splat (depth and features unlifted, through bev_pool) equals the
    JAX splat of the lifted volume softmax(depth) x features."""
    rng = np.random.RandomState(3)
    frustum, intr, extr = _geometry(rng)
    geometry = np.asarray(JLS.get_geometry(jnp.asarray(frustum), jnp.asarray(intr),
                                           jnp.asarray(extr)))
    D, h, w = frustum.shape[:3]
    head = rng.randn(2 * 3, h, w, D + 16).astype(np.float32)
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    vol = np.asarray(JLS.depth_feature_outer_product(jnp.asarray(head), D, 16))
    want = np.asarray(JLS.lift_splat(jnp.asarray(vol.reshape(2, 3, h, w, D, 16)),
                                     jnp.asarray(geometry), res, start, dim))
    depth = torch.softmax(torch.from_numpy(head[..., :D]), dim=-1).view(2, 3, h, w, D)
    feat = torch.from_numpy(head[..., D:]).view(2, 3, h, w, 16)
    got = LS.lift_splat_depth(depth, feat, torch.tensor(geometry), res, start,
                              dim).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_depth_feature_outer_product_matches_jax():
    x = np.random.RandomState(4).randn(2, 3, 5, 6 + 4).astype(np.float32)
    want = np.asarray(JLS.depth_feature_outer_product(jnp.asarray(x), 6, 4))
    got = LS.depth_feature_outer_product(torch.from_numpy(x), 6, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_all_out_of_bounds_geometry_splats_nothing():
    rng = np.random.RandomState(5)
    D, h, w = 6, 8, 12
    geometry = torch.from_numpy(rng.uniform(100.0, 200.0, (1, 2, D, h, w, 3))
                                .astype(np.float32))
    depth = torch.softmax(torch.from_numpy(rng.randn(1, 2, h, w, D).astype(np.float32)), -1)
    feat = torch.from_numpy(rng.randn(1, 2, h, w, 16).astype(np.float32))
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    out = LS.lift_splat_depth(depth, feat, geometry, res, start, dim)
    assert out.shape == (1, 32, 32, 16)
    assert float(out.abs().sum()) == 0.0
    ids = LS.voxel_ids(geometry, res, start, dim)
    assert (ids == int(np.prod(dim))).all()


def test_bev_pool_backward_plain_is_autograd_of_plain():
    """The plain backward equals torch autograd through the plain forward (dump-bin
    rows get nothing), and the autograd.Function routes a CPU tensor's gradient to it."""
    rng = np.random.RandomState(7)
    S, N, h, w, D, C, num_bins, z = 2, 3, 4, 5, 6, 8, 60, 3
    ids = torch.from_numpy(rng.randint(0, num_bins + 1, (S, N, h, w, D)).astype(np.int32))
    depth = torch.from_numpy(rng.rand(S, N, h, w, D).astype(np.float32)).requires_grad_()
    feat = torch.from_numpy(rng.randn(S, N, h, w, C).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(S, num_bins // z, C).astype(np.float32))
    want = torch.autograd.grad(LS.bev_pool_plain(depth, feat, ids, num_bins, z),
                               (depth, feat), g)
    got = LS.bev_pool_backward_plain(depth, feat, ids, g, num_bins, z)
    through_fn = torch.autograd.grad(LS.bev_pool(depth, feat, ids, num_bins, z),
                                     (depth, feat), g)
    for a, b, c in zip(got, want, through_fn):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(c, a, rtol=0, atol=0)
    dump = ids == num_bins
    assert bool(dump.any()) and float(got[0].detach()[dump].abs().max()) == 0.0


def test_lift_splat_depth_backward_matches_jax_vjp():
    """K1's gradients with respect to depth and features against jax.vjp of the JAX
    splat of softmax(depth) x features (``_sorted_splat_bwd`` through the outer
    product), f32."""
    import jax
    rng = np.random.RandomState(8)
    frustum, intr, extr = _geometry(rng)
    geometry = np.asarray(JLS.get_geometry(jnp.asarray(frustum), jnp.asarray(intr),
                                           jnp.asarray(extr)))
    D, h, w = frustum.shape[:3]
    depth = rng.dirichlet(np.ones(D), (2, 3, h, w)).astype(np.float32)
    feat = rng.randn(2, 3, h, w, 16).astype(np.float32)
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    g = rng.randn(2, 32, 32, 16).astype(np.float32)

    def jax_splat(d, f):
        return JLS.lift_splat(d[..., :, None] * f[..., None, :], jnp.asarray(geometry),
                              res, start, dim)

    _, vjp = jax.vjp(jax_splat, jnp.asarray(depth), jnp.asarray(feat))
    want = vjp(jnp.asarray(g))
    dt, ft = (torch.from_numpy(a).requires_grad_() for a in (depth, feat))
    out = LS.lift_splat_depth(dt, ft, torch.tensor(geometry), res, start, dim)
    got = torch.autograd.grad(out, (dt, ft), torch.from_numpy(g))
    for name, a, b in zip(('d_depth', 'd_feat'), got, want):
        assert float(np.abs(np.asarray(b)).max()) > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_bev_pool_checks_its_inputs():
    depth = torch.rand(1, 2, 3, 4, 5)
    with pytest.raises(ValueError):
        LS.bev_pool(depth, torch.rand(1, 2, 3, 4, 8), torch.zeros(1, 2, 3, 4, 6,
                                                                  dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        LS.bev_pool(depth, torch.rand(1, 2, 3, 4, 8),
                    torch.zeros(1, 2, 3, 4, 5, dtype=torch.int32), 10, z_bins=3)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_pool_kernel_matches_plain(dtype):
    """On the card: kernel vs plain version at the baseline serve shapes. The plain
    version's index_add_ on the card sums in the order its atomics land: f32 within
    rtol/atol 1e-5; bf16: the f32 sums round once, so within one bf16 ulp."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.RandomState(6)
    S, N, h, w, D, C = 3, 6, 28, 60, 48, 64
    num_bins = 200 * 200
    ids = torch.from_numpy(rng.randint(0, num_bins + 1, (S, N, h, w, D)).astype(np.int32))
    depth = torch.softmax(torch.from_numpy(rng.randn(S, N, h, w, D).astype(np.float32)), -1)
    feat = torch.from_numpy(rng.randn(S, N, h, w, C).astype(np.float32))
    args = [t.cuda() for t in (depth.to(dtype), feat.to(dtype), ids)]
    launches = LS.bev_pool.launches
    got = LS.bev_pool(*args, num_bins).float()
    assert LS.bev_pool.launches == launches + LS.BEV_POOL_KERNELS
    want = LS.bev_pool_plain(*args, num_bins).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((got - want).abs() <= ulp + 1e-5).all())
