"""On the card: the top-k select's backward kernel (K5 backward,
csrc/topk_select.cu) against its plain version, equal in every bit, one launch a
call, at D = 28, 48 and 64, k = 1, 8 and D, f32 and bf16, on 1, 30,240 and 90,720
pixels (the idx from K5 forward on chip_smoke.py's planted-ties depth); bf16 rows of
56 bytes (D = 28, k = 3) after whole blocks; g and idx off 16-byte alignment; the
kernel's single-value stores into an unaligned d_depth (its C entry called
directly). Every test needs a CUDA device and skips without one. The file imports
nothing of JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_topk_bwd_gpu.py
"""

import ctypes

import pytest
import torch

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.ops import lift_splat as LS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def planted_depth(n_pix, D, dtype, device, seed):
    """chip_smoke.py's planted_topk_depth: softmax rows, every fourth planted with
    ties at the k-th value (three levels, all +0.0, all ones, -0.0 beside +0.0)."""
    g = torch.Generator(device=device).manual_seed(seed)
    depth = torch.softmax(torch.randn((n_pix, D), generator=g, device=device), -1)
    levels = torch.randint(0, 3, (n_pix, D), generator=g, device=device) / 4.0
    signed = torch.tensor([-0.0, 0.0, 0.25], device=device)[
        torch.randint(0, 3, (n_pix, D), generator=g, device=device)]
    depth[0::16], depth[4::16], depth[8::16] = levels[0::16], 0.0, 1.0
    depth[12::16] = signed[12::16]
    return depth.to(dtype)


def inputs(n_pix, D, k, dtype, device, seed):
    """(g, idx): idx from K5 forward, g seeded with -0.0 among its values."""
    depth = planted_depth(n_pix, D, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    ids = torch.randint(0, 40001, (n_pix, D), generator=gen, device=device, dtype=torch.int32)
    idx = LS.topk_select(depth, ids, k)[2]
    g = torch.randn((n_pix, k), generator=gen, device=device)
    g[torch.rand((n_pix, k), generator=gen, device=device) < 0.1] = -0.0
    return g.to(dtype), idx


def bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def assert_backward_equal(g, idx, D):
    launches = LS.topk_select_backward.launches
    got = LS.topk_select_backward(g, idx, D)
    assert LS.topk_select_backward.launches == launches + 1
    want = LS.topk_select_backward_plain(g, idx, D)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(bits(got), bits(want)), f'{int((got != want).sum())} values differ'


@pytest.mark.parametrize('n_pix', [1, 30240, 90720])
@pytest.mark.parametrize('k_of', ['1', '8', 'D'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('D', [28, 48, 64])
def test_topk_backward_equals_plain(cuda, D, dtype, k_of, n_pix):
    k = {'1': 1, '8': 8, 'D': D}[k_of]
    g, idx = inputs(n_pix, D, k, dtype, cuda, seed=D + k + n_pix)
    assert_backward_equal(g, idx, D)


@pytest.mark.parametrize('n_pix', [1, 129, 30240])
def test_topk_backward_rows_of_56_bytes(cuda, n_pix):
    """bf16 at D = 28: a row is 56 bytes, so a tail block ends inside a 16-byte word."""
    g, idx = inputs(n_pix, 28, 3, torch.bfloat16, cuda, seed=n_pix)
    assert_backward_equal(g, idx, 28)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_topk_backward_unaligned_inputs(cuda, dtype):
    """g and idx one element past a 16-byte boundary, in the serve shape's 5-D layout."""
    shape, D, k = (3, 6, 28, 60), 48, 8
    g0, idx0 = inputs(30240, D, k, dtype, cuda, seed=5)
    g_buf = torch.empty(g0.numel() + 1, dtype=dtype, device=cuda)
    i_buf = torch.empty(idx0.numel() + 1, dtype=torch.uint8, device=cuda)
    g_buf[1:] = g0.reshape(-1)
    i_buf[1:] = idx0.reshape(-1)
    g, idx = g_buf[1:].view(shape + (k,)), i_buf[1:].view(shape + (k,))
    assert g.data_ptr() % 16 and idx.data_ptr() % 16
    assert_backward_equal(g, idx, D)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_topk_backward_single_value_stores(cuda, dtype):
    """The C entry into a d_depth one element off 16-byte alignment: every value by a
    single store; the values around it untouched."""
    n_pix, D, k = 1000, 28, 8
    g, idx = inputs(n_pix, D, k, dtype, cuda, seed=9)
    out = torch.full((n_pix * D + 2,), 7.0, dtype=dtype, device=cuda)
    fn = _build.load('topk_select').fiery_topk_select_backward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(g.data_ptr(), idx.data_ptr(), out[1:].data_ptr(), n_pix, D, k,
            int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    want = LS.topk_select_backward_plain(g, idx, D)
    assert torch.equal(bits(out[1:-1].view(n_pix, D)), bits(want))
    assert float(out[0]) == 7.0 and float(out[-1]) == 7.0


def test_topk_backward_refuses_k_above_d(cuda):
    g = torch.zeros((4, 9), device=cuda)
    with pytest.raises(ValueError):
        LS.topk_select_backward(g, torch.zeros((4, 9), dtype=torch.uint8, device=cuda), 8)
