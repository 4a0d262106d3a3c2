"""On the card: the top-k depth select (K5, csrc/topk_select.cu) and the top-k
loss's k-th value (K3, csrc/kth_largest.cu) against their plain versions, equal in
every value, each call one launch.

K5 at D = 28, 48 and 64, k = 1, 8 and D, f32 and bf16, on the planted-ties depth of
chip_smoke.py (softmax rows, three repeated levels, all +0.0, all ones, -0.0 beside
+0.0), at pixel counts that fill no block, one block and the serve shape, and on
weights one element off 16-byte alignment (the kernel's per-weight loads). K3 on 1,
15 and 200 rows of 40,000, 61,760 and 80,000 (the 200 x 200, 320 x 193 and 400 x 200
grids), random rows, rows with ties at the k-th value and loss-like rows, k = 1,
n / 4 and n; rows of 150,000, longer than the blocks' registers hold; rows of signed
zeros. Every test needs a CUDA device and skips without one. The file imports
nothing of JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_select_gpu.py
"""

import pytest
import torch

from fiery_tpu_torch.ops import lift_splat as LS
from fiery_tpu_torch.training import losses as L

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def planted_depth(n_pix, D, dtype, device, seed):
    """chip_smoke.py's planted_topk_depth: (n_pix, D) softmax weights of seeded
    logits, every fourth row planted with ties at the k-th value: three repeated
    levels, all +0.0, all ones, or -0.0 beside +0.0."""
    g = torch.Generator(device=device).manual_seed(seed)
    depth = torch.softmax(torch.randn((n_pix, D), generator=g, device=device), -1)
    levels = torch.randint(0, 3, (n_pix, D), generator=g, device=device) / 4.0
    signed = torch.tensor([-0.0, 0.0, 0.25], device=device)[
        torch.randint(0, 3, (n_pix, D), generator=g, device=device)]
    depth[0::16], depth[4::16], depth[8::16] = levels[0::16], 0.0, 1.0
    depth[12::16] = signed[12::16]
    return depth.to(dtype)


def assert_select_equal(depth, ids, k):
    launches = LS.topk_select.launches
    got = LS.topk_select(depth, ids, k)
    assert LS.topk_select.launches == launches + 1
    want = LS.topk_select_plain(depth, ids, k)
    for part, a, b in zip(('top_w', 'ids_k', 'idx'), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, part
        assert torch.equal(a, b), f'{part}: {int((a != b).sum())} values differ'
        if part == 'top_w':   # -0.0 and +0.0 are distinct weights
            assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                      else torch.int32),
                               b.view(torch.int16 if b.dtype == torch.bfloat16
                                      else torch.int32)), part


@pytest.mark.parametrize('n_pix', [1, 63, 64, 100, 30240])
@pytest.mark.parametrize('k_of', ['1', '8', 'D'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('D', [28, 48, 64])
def test_topk_select_equals_plain(cuda, D, dtype, k_of, n_pix):
    k = {'1': 1, '8': 8, 'D': D}[k_of]
    depth = planted_depth(n_pix, D, dtype, cuda, seed=D + k + n_pix)
    g = torch.Generator(device=cuda).manual_seed(n_pix)
    ids = torch.randint(0, 40001, (n_pix, D), generator=g, device=cuda, dtype=torch.int32)
    assert_select_equal(depth, ids, k)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_topk_select_unaligned_weights(cuda, dtype):
    """Weights that start one element past a 16-byte boundary take the per-weight
    loads; the serve shape's 5-D layout."""
    n_pix, D = 3 * 6 * 28 * 60, 48
    flat = planted_depth(n_pix * D + 1, 1, dtype, cuda, seed=3).view(-1)
    depth = flat[1:].view(3, 6, 28, 60, D)
    assert depth.is_contiguous() and depth.data_ptr() % 16
    g = torch.Generator(device=cuda).manual_seed(4)
    ids = torch.randint(0, 40001, depth.shape, generator=g, device=cuda, dtype=torch.int32)
    assert_select_equal(depth, ids, 8)


def k3_rows(rows, n, kind, device):
    g = torch.Generator(device=device).manual_seed(rows * 7 + n)
    x = torch.rand((rows, n), generator=g, device=device) * 3.0
    if kind == 'ties':      # exact zeros below the k-th; a value repeated across it
        x[::2, : 3 * n // 4] = 0.0
        x[1::2, ::2] = 1.5
    elif kind == 'loss':    # cross-entropy of random logits, a quarter of the pixels ignored
        logits = torch.randn((rows, n, 4), generator=g, device=device) * 2.0
        x = -torch.log_softmax(logits, -1)[..., 0]
        x[torch.rand((rows, n), generator=g, device=device) < 0.25] = 0.0
    return x.contiguous()


@pytest.mark.parametrize('kind', ['random', 'ties', 'loss'])
@pytest.mark.parametrize('n', [40000, 61760, 80000])
@pytest.mark.parametrize('rows', [1, 15, 200])
def test_kth_largest_equals_plain(cuda, rows, n, kind):
    x = k3_rows(rows, n, kind, cuda)
    for k in (1, n // 4, n):
        launches = L.kth_largest.launches
        got = L.kth_largest(x, k)
        assert L.kth_largest.launches == launches + 1
        want = L.kth_largest_plain(x, k)
        assert torch.equal(got, want), f'k = {k}: {int((got != want).sum())} rows differ'
    # the top-k mean from the threshold, against torch.topk's in f64
    k = n // 4
    mean = float(L._top_k_sum_from_threshold(x, L.kth_largest(x, k), k).sum() / (rows * k))
    ref = float(torch.topk(x.double(), k).values.mean())
    assert abs(mean - ref) <= 1e-6 * abs(ref)


@pytest.mark.parametrize('kind', ['random', 'ties', 'loss'])
def test_kth_largest_rows_longer_than_registers(cuda, kind):
    """Rows of more than 8 x 16,384 keys: each block reads the rest of its chunk again
    from memory in every pass, and the early stop looks there too."""
    n = 150000
    x = k3_rows(3, n, kind, cuda)
    assert L.kth_largest_plan(n) * L.KTH_KEYS_PER_BLOCK < n
    for k in (1, 7, n // 4, n - 3, n):
        got, want = L.kth_largest(x, k), L.kth_largest_plain(x, k)
        assert torch.equal(got, want), f'k = {k}: {int((got != want).sum())} rows differ'


def test_kth_largest_signed_zeros(cuda):
    """Rows of -0.0 and +0.0 only: the kernel's k-th key tells them apart as the JAX
    package's does (-0.0 below +0.0); the plain version's value equals it."""
    x = torch.zeros((2, 40000), device=cuda)
    x[0, ::2] = -0.0
    x[1, :10000] = -0.0
    got = L.kth_largest(x, 20000)
    assert torch.equal(got, L.kth_largest_plain(x, 20000))
    assert got.view(torch.int32).tolist() == [[0], [0]]     # +0.0: 20,000 of them
    got = L.kth_largest(x, 35000)
    assert got.view(torch.int32).tolist() == [[-2 ** 31], [-2 ** 31]]   # -0.0
