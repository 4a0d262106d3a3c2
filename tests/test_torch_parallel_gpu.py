"""On the card: K10's synchronised statistics (the data-parallel path,
ops/batch_norm.py) in a one-rank NCCL group, against their plain versions and
against the unsynchronised kernels. Every test needs a CUDA device and skips
without one.

Held: the rank's f64 sums within 1e-12 relative of the plain version's (another
order of f64 additions), the statistics within 1e-6 relative, y within 1e-5 + 1e-5
|y| in f32 and one bf16 ulp in bf16, the gradients within a relative L2 error of
1e-5 in f32 and 1e-2 in bf16 (tests/test_torch_norm_gru_gpu.py's tolerances); and
the one-rank path equal to the unsynchronised kernels bit for bit, with its
launches: a reduction and an apply pass a channel slice and one finalize, forward
and backward.

The file imports nothing of JAX, so that it runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_gpu.py
"""

import pytest
import torch
import torch.distributed as dist

from fiery_tpu_torch.ops import batch_norm as BN

pytestmark = pytest.mark.gpu
# channels-first shapes: 4-D, 5-D, and more channels than one launch takes
SHAPES = ((6, 144, 28, 60), (2, 35, 3, 40, 44), (3, 2688, 7, 15))


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.cuda.set_device(0)
    init = tmp_path_factory.mktemp('nccl') / 'init'
    dist.init_process_group('nccl', init_method=f'file://{init}', rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _rows(shape, dtype, gen, mean=0.0):
    """A channels-first view of channels-last memory on the card."""
    t = torch.randn(shape[:1] + shape[2:] + shape[1:2], generator=gen, device='cuda') + mean
    return t.to(dtype).movedim(-1, 1)


def _inputs(shape, post, dtype, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    C = shape[1]
    x = _rows(shape, dtype, gen, mean=0.5)
    res = _rows(shape, dtype, gen) if post in BN.RESIDUAL_POSTS else None
    dy = _rows(shape, dtype, gen)
    w = torch.rand(C, generator=gen, device='cuda') + 0.5
    b = torch.randn(C, generator=gen, device='cuda')
    rm = torch.randn(C, generator=gen, device='cuda') * 0.1 + 0.5
    rv = torch.rand(C, generator=gen, device='cuda') + 0.5
    return x, res, dy, w, b, rm, rv


def _within(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-5 * want.abs()
    else:
        tol = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7) + 1e-5
    return bool(((got - want).abs() <= tol).all())


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', SHAPES, ids=['4d', '5d', 'wide'])
@pytest.mark.parametrize('post', BN.POSTS)
def test_sync_kernels_match_plain(group, post, shape, dtype):
    x, res, dy, w, b, rm, rv = _inputs(shape, post, dtype, BN.POSTS.index(post))
    slices = len(BN.channel_slices(shape[1]))
    n0 = (BN.batch_norm_partials_card.launches, BN.batch_norm_finalize_card.launches,
          BN.batch_norm_forward.launches)
    sums = BN.batch_norm_partials_card(x, res, post)
    want_sums = BN.batch_norm_partials_plain(x)
    assert _rel_l2(sums, want_sums) <= 1e-12
    gathered = BN.gather_sums(sums, group)
    assert torch.equal(gathered[0], sums)
    stats_k = BN.batch_norm_finalize_card(gathered, rmk := rm.clone(), rvk := rv.clone(), 0.1)
    stats_p = BN.batch_norm_finalize_plain(gathered, rmp := rm.clone(), rvp := rv.clone(), 0.1)
    for a, c in ((stats_k, stats_p), (rmk, rmp), (rvk, rvp)):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6 * float(c.abs().max()))
    y, mean, var, clamp = BN.batch_norm_sync_forward(x, w, b, rm.clone(), rv.clone(), 0.1,
                                                     1e-3, post, res, group)
    assert (BN.batch_norm_partials_card.launches, BN.batch_norm_finalize_card.launches,
            BN.batch_norm_forward.launches) == (n0[0] + 2 * slices, n0[1] + 2, n0[2] + slices)
    assert _within(y, BN.batch_norm_plain(x, w, b, mean, var, 1e-3, post, res), dtype)
    n0 = (BN.batch_norm_backward_partials_card.launches,
          BN.batch_norm_backward_finalize_card.launches,
          BN.batch_norm_backward_apply_card.launches)
    gk = BN.batch_norm_backward_sync(dy, x, w, b, mean, var, clamp, 1e-3, post, res, group)
    assert (BN.batch_norm_backward_partials_card.launches,
            BN.batch_norm_backward_finalize_card.launches,
            BN.batch_norm_backward_apply_card.launches) == (n0[0] + slices, n0[1] + 1,
                                                           n0[2] + slices)
    local, dres = BN.batch_norm_backward_partials_plain(dy, x, w, b, mean, var, 1e-3, post, res)
    dparams = BN.batch_norm_backward_finalize_plain(local[None], 0, clamp)
    dx = BN.batch_norm_backward_apply_plain(dy, x, w, b, mean, var, dparams, 1e-3, post, res)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, a, c in zip(('dx', 'dweight', 'dbias', 'dres'), gk, (dx, *dparams[:2], dres)):
        if c is not None:
            assert _rel_l2(a, c) <= tol, name


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', SHAPES, ids=['4d', '5d', 'wide'])
@pytest.mark.parametrize('post', BN.POSTS)
def test_one_rank_gives_the_fused_bits(group, post, shape, dtype):
    x, res, dy, w, b, rm, rv = _inputs(shape, post, dtype, 100 + BN.POSTS.index(post))
    runs = []
    for g in (group, None):
        stats = (rm.clone(), rv.clone())
        xg = x.clone().requires_grad_(True)
        wg, bg = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        rg = None if res is None else res.clone().requires_grad_(True)
        y = BN.batch_norm(xg, wg, bg, *stats, True, 0.1, 1e-3, post, rg, group=g)
        y.backward(dy)
        runs.append([y, *stats, xg.grad, wg.grad, bg.grad] + ([rg.grad] if rg is not None
                                                               else []))
    for a, c in zip(*runs):
        assert a.dtype == c.dtype and torch.equal(a, c)
