"""On the card: the training path's kernels against their plain versions at the
full-width training shapes of baseline.yml (batch 3): the splat's backward (K1),
the warp's backward (K2), the k-th largest value of the top-k loss (K3) and the
nearest warp of the label stack (K4); and the splat's forward (K1) against the
plain version on the host, bit for bit, on adversarial buckets (one row a voxel,
33, 1000, every row in one voxel, every row dumped) at D = 48 and D = 8, its
order stage exactly, and two runs of both directions bit for bit. Every test
needs a CUDA device and skips without one.

The file imports nothing of JAX, so that it runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_gpu.py
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.ops import lift_splat as LS
from fiery_tpu_torch.ops import warp as W
from fiery_tpu_torch.training import losses as L

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _poses(rng, n):
    flow = np.zeros((n, 6), np.float32)
    flow[:, 0] = rng.uniform(-3, 3, n)
    flow[:, 1] = rng.uniform(-3, 3, n)
    flow[:, 5] = rng.uniform(-0.3, 0.3, n)
    return flow


def _within(got, want, dtype):
    """f32: 1e-5 + 1e-5 |want|; bf16: one bf16 ulp of want (+1e-5)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-5 * want.abs()
    else:
        tol = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7) + 1e-5
    return bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_pool_backward_kernel_matches_plain(cuda, dtype):
    rng = np.random.RandomState(1)
    S, N, h, w, D, C, num_bins = 9, 6, 28, 60, 48, 64, 200 * 200
    ids = torch.from_numpy(rng.randint(0, num_bins + 1, (S, N, h, w, D)).astype(np.int32))
    depth = torch.softmax(torch.from_numpy(rng.randn(S, N, h, w, D).astype(np.float32)), -1)
    feat = torch.from_numpy(rng.randn(S, N, h, w, C).astype(np.float32))
    g = torch.from_numpy(rng.randn(S, num_bins, C).astype(np.float32))
    args = [t.to(cuda) for t in (depth.to(dtype), feat.to(dtype), ids, g.to(dtype))]
    launches = LS.bev_pool_backward.launches
    got = LS.bev_pool_backward(*args, num_bins)
    assert LS.bev_pool_backward.launches == launches + 1
    want = LS.bev_pool_backward_plain(*args, num_bins)
    for a, b in zip(got, want):
        assert a.dtype == dtype and _within(a, b, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_warp_backward_kernel_matches_plain(cuda, dtype):
    rng = np.random.RandomState(2)
    g = torch.from_numpy(rng.randn(6, 200, 200, 64).astype(np.float32)).to(cuda, dtype)
    pose = torch.from_numpy(_poses(rng, 6)).to(cuda)
    launches = W.bev_warp_backward.launches
    got = W.bev_warp_backward(g, pose, (50.0, 50.0))
    assert W.bev_warp_backward.launches == launches + 1
    assert got.dtype == dtype
    assert _within(got, W.bev_warp_backward_plain(g, pose, (50.0, 50.0)), dtype)


def test_bev_warp_autograd_launches_both_kernels(cuda):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 50, 40, 8).astype(np.float32)).to(cuda).requires_grad_()
    pose = torch.from_numpy(_poses(rng, 2)).to(cuda)
    fwd, bwd = W.bev_warp.launches, W.bev_warp_backward.launches
    W.bev_warp(x, pose, (25.0, 20.0)).square().sum().backward()
    assert (W.bev_warp.launches, W.bev_warp_backward.launches) == (fwd + 1, bwd + 1)
    xp = x.detach().requires_grad_()
    W.bev_warp_plain(xp, pose, (25.0, 20.0)).square().sum().backward()
    torch.testing.assert_close(x.grad, xp.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('ties', [False, True])
def test_kth_largest_kernel_equals_plain(cuda, ties):
    """15 rows of 40,000 losses, k = 10,000; with ties, 3/4 of each row is exactly 0
    (ignored pixels) or one repeated value straddles the k-th position."""
    rng = np.random.RandomState(4)
    x = rng.rand(15, 40000).astype(np.float32) * 3.0
    if ties:
        x[::2, :30000] = 0.0
        x[1::2, rng.permutation(40000)[:20000]] = np.float32(1.5)
    x = torch.from_numpy(x).to(cuda)
    launches = L.kth_largest.launches
    got = L.kth_largest(x, 10000)
    assert L.kth_largest.launches == launches + 1
    assert torch.equal(got, L.kth_largest_plain(x, 10000))


def test_bev_warp_nearest_kernel_equals_plain(cuda):
    """The label stack: 12 frames of 200 x 200 x 7 f32, integer-valued and 255
    ignore labels included; equal, not close."""
    rng = np.random.RandomState(5)
    x = rng.randn(12, 200, 200, 7).astype(np.float32)
    x[..., :2] = rng.randint(0, 3, (12, 200, 200, 2))
    x[..., 3:] = np.where(rng.rand(12, 200, 200, 1) < 0.7, 255.0, x[..., 3:])
    x = torch.from_numpy(x).to(cuda)
    pose = torch.from_numpy(_poses(rng, 12)).to(cuda)
    launches = W.bev_warp_nearest.launches
    got = W.bev_warp_nearest(x, pose, (50.0, 50.0))
    assert W.bev_warp_nearest.launches == launches + 1
    assert torch.equal(got, W.bev_warp_nearest_plain(x, pose, (50.0, 50.0)))


def _bucket_ids(case, shape, num_bins, rng):
    """(S, N, h, w, D) voxel ids whose in-grid buckets all hold ``case`` rows (1, 33,
    1000; the rows of a bucket drawn from all over the sample, so that they reach
    the kernel out of order, and the rows left over dumped), or where every row of a
    sample falls in one voxel ('all'), or every row is dumped ('dumped')."""
    S, rows = shape[0], int(np.prod(shape[1:]))
    ids = np.full((S, rows), num_bins, np.int64)
    for s in range(S):
        if case == 'all':
            ids[s] = rng.randint(num_bins)
        elif case != 'dumped':
            n = rows // case
            perm = rng.permutation(rows)[:n * case]
            ids[s, perm] = np.repeat(rng.permutation(num_bins)[:n], case)
    return torch.from_numpy(ids.reshape(shape).astype(np.int32))


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


BUCKETS = [1, 33, 1000, 'all', 'dumped']


@pytest.mark.parametrize('case', BUCKETS)
@pytest.mark.parametrize('D', [48, 8])
def test_bev_pool_order_stage_equals_plain(cuda, case, D):
    rng = np.random.RandomState(10)
    ids = _bucket_ids(case, (2, 6, 8, 16, D), 200 * 200, rng)
    launches = LS.bev_pool_order.launches
    got = LS.bev_pool_order(ids.to(cuda), 200 * 200)
    assert LS.bev_pool_order.launches == launches + LS.BEV_POOL_KERNELS
    want = LS.bev_pool_order_plain(ids, 200 * 200)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a.cpu(), b)


@pytest.mark.parametrize('case', BUCKETS)
@pytest.mark.parametrize('D', [48, 8])
@pytest.mark.parametrize('C', [64, 20])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_pool_equals_the_host_plain_version_bit_for_bit(cuda, case, D, C, dtype):
    """C = 64 takes 16-byte accesses, C = 20 one value an access."""
    rng = np.random.RandomState(11)
    S, N, h, w, num_bins = 2, 6, 8, 16, 200 * 200
    ids = _bucket_ids(case, (S, N, h, w, D), num_bins, rng)
    depth = torch.softmax(torch.from_numpy(rng.randn(S, N, h, w, D).astype(np.float32)),
                          -1).to(dtype)
    feat = torch.from_numpy(rng.randn(S, N, h, w, C).astype(np.float32)).to(dtype)
    launches = LS.bev_pool.launches
    got = LS.bev_pool(depth.to(cuda), feat.to(cuda), ids.to(cuda), num_bins).cpu()
    assert LS.bev_pool.launches == launches + LS.BEV_POOL_KERNELS
    want = LS.bev_pool_plain(depth, feat, ids, num_bins)
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize('case', [33, 1000, 'all'])
@pytest.mark.parametrize('C', [64, 20])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_pool_backward_on_buckets_within_gates(cuda, case, C, dtype):
    rng = np.random.RandomState(12)
    S, N, h, w, D, num_bins = 2, 6, 8, 16, 48, 200 * 200
    ids = _bucket_ids(case, (S, N, h, w, D), num_bins, rng)
    depth = torch.softmax(torch.from_numpy(rng.randn(S, N, h, w, D).astype(np.float32)), -1)
    feat = torch.from_numpy(rng.randn(S, N, h, w, C).astype(np.float32))
    g = torch.from_numpy(rng.randn(S, num_bins, C).astype(np.float32))
    args = [t.to(cuda) for t in (depth.to(dtype), feat.to(dtype), ids, g.to(dtype))]
    got = LS.bev_pool_backward(*args, num_bins)
    want = LS.bev_pool_backward_plain(*args, num_bins)
    for a, b in zip(got, want):
        assert a.dtype == dtype and _within(a, b, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_pool_two_runs_give_the_same_bits(cuda, dtype):
    """Forward and backward at the serve shapes (3 x 6 x 28 x 60, D = 48, C = 64)."""
    rng = np.random.RandomState(13)
    S, N, h, w, D, C, num_bins = 3, 6, 28, 60, 48, 64, 200 * 200
    ids = torch.from_numpy(rng.randint(0, num_bins + 1, (S, N, h, w, D)).astype(np.int32))
    ids[:, :, :, :20] = torch.from_numpy(rng.randint(0, 300, (S, N, h, 20, D)).astype(
        np.int32))                    # crowded voxels, as near the cameras
    depth = torch.softmax(torch.from_numpy(rng.randn(S, N, h, w, D).astype(np.float32)), -1)
    feat = torch.from_numpy(rng.randn(S, N, h, w, C).astype(np.float32))
    g = torch.from_numpy(rng.randn(S, num_bins, C).astype(np.float32))
    args = [t.to(cuda) for t in (depth.to(dtype), feat.to(dtype), ids)]
    gc = g.to(cuda, dtype)
    first = [LS.bev_pool(*args, num_bins), *LS.bev_pool_backward(*args, gc, num_bins)]
    second = [LS.bev_pool(*args, num_bins), *LS.bev_pool_backward(*args, gc, num_bins)]
    for a, b in zip(first, second):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(_bits(first[0].cpu()), _bits(LS.bev_pool_plain(*(
        t.cpu() for t in args), num_bins)))
