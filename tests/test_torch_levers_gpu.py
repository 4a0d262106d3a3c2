"""On the card: the top-k depth select (K5) and its backward against their plain
versions, at the combo's shapes (LIFT.TOPK 8 of 48 depth bins; 3 samples x 6
cameras x 28 x 60 pixels served), with planted ties; and the sparse splat's
autograd through K5 and K1. Every test needs a CUDA device and skips without one.

The file imports nothing of JAX, so that it runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_levers_gpu.py
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.ops import lift_splat as LS

pytestmark = pytest.mark.gpu

D = 48


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def planted_depth(rng, n_pix):
    """(n_pix, D) f32 weights: softmax rows, and every fourth row of three repeated
    levels, all +0.0, all ones, or with -0.0 beside +0.0 (ties at the k-th value)."""
    x = rng.randn(n_pix, D).astype(np.float32)
    out = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    out[0::16] = rng.randint(0, 3, out[0::16].shape) / 4.0
    out[4::16] = 0.0
    out[8::16] = 1.0
    out[12::16] = rng.choice([-0.0, 0.0, 0.25], out[12::16].shape)
    return torch.from_numpy(out)


@pytest.mark.parametrize('k', [1, 8, D])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_topk_select_kernel_equals_plain(cuda, dtype, k):
    rng = np.random.RandomState(k)
    n_pix = 3 * 6 * 28 * 60
    depth = planted_depth(rng, n_pix).to(cuda, dtype).view(3, 6, 28, 60, D)
    ids = torch.from_numpy(rng.randint(0, 40001, (3, 6, 28, 60, D)).astype(np.int32)).to(cuda)
    launches = LS.topk_select.launches
    got = LS.topk_select(depth, ids, k)
    assert LS.topk_select.launches == launches + 1
    want = LS.topk_select_plain(depth, ids, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape == (3, 6, 28, 60, k)
        assert torch.equal(a, b)
    # rows of equal weights take the first k bins
    ones = got[2].view(n_pix, k)[8::16]
    assert torch.equal(ones, torch.arange(k, device=cuda, dtype=torch.uint8).expand_as(ones))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_topk_select_backward_kernel_equals_plain(cuda, dtype):
    rng = np.random.RandomState(1)
    n_pix = 9 * 6 * 28 * 60
    depth = planted_depth(rng, n_pix).to(cuda, dtype)
    ids = torch.zeros((n_pix, D), dtype=torch.int32, device=cuda)
    _, _, idx = LS.topk_select_plain(depth, ids, 8)
    g = torch.from_numpy(rng.randn(n_pix, 8).astype(np.float32)).to(cuda, dtype)
    launches = LS.topk_select_backward.launches
    got = LS.topk_select_backward(g, idx, D)
    assert LS.topk_select_backward.launches == launches + 1
    want = LS.topk_select_backward_plain(g, idx, D)
    assert got.dtype == dtype and torch.equal(got, want)


def test_lift_splat_topk_autograd_launches_k5_and_k1(cuda):
    """One forward and one backward of the sparse splat: K5 once, K1's forward kernels
    once each, their backward kernels once each; the splat equals the CPU's plain
    path bit for bit and the gradients within f32 reordering."""
    rng = np.random.RandomState(2)
    B, N, h, w, C = 2, 3, 8, 12, 16
    depth = torch.softmax(torch.from_numpy(rng.randn(B, N, h, w, D).astype(np.float32)), -1)
    feat = torch.from_numpy(rng.randn(B, N, h, w, C).astype(np.float32))
    geometry = torch.from_numpy(rng.uniform(-9, 9, (B, N, D, h, w, 3)).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, 32, 32, C).astype(np.float32))
    bev = ([0.5, 0.5, 20.0], [-7.75, -7.75, 0.0], [32, 32, 1])
    results = {}
    for dev in ('cpu', cuda):
        d, f = (t.to(dev).requires_grad_() for t in (depth, feat))
        counts = (LS.topk_select.launches, LS.bev_pool.launches,
                  LS.bev_pool_backward.launches, LS.topk_select_backward.launches)
        out = LS.lift_splat_topk(d, f, geometry.to(dev), 8, *bev)
        grads = torch.autograd.grad(out, (d, f), g.to(dev))
        after = (LS.topk_select.launches, LS.bev_pool.launches,
                 LS.bev_pool_backward.launches, LS.topk_select_backward.launches)
        assert [b - a for a, b in zip(counts, after)] == (
            [0] * 4 if dev == 'cpu' else [1, LS.BEV_POOL_KERNELS, 1, 1])
        results[str(dev)] = [out.detach().cpu(), *(x.cpu() for x in grads)]
    # the splat equals the host's bits (K1 sums in index_add_'s order); the
    # gradients are within f32 reordering
    assert torch.equal(results['cuda'][0], results['cpu'][0])
    for a, b in zip(results['cuda'], results['cpu']):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_topk_select_refuses_what_the_kernel_cannot_take(cuda):
    ids = torch.zeros((4, 65), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match='64'):
        LS.topk_select(torch.rand((4, 65), device=cuda), ids, 8)
    with pytest.raises(TypeError):
        LS.topk_select(torch.rand((4, 48), device=cuda, dtype=torch.float16),
                       ids[:, :48], 8)
