"""The launch plan of the SpatialGRU gate kernels (K11), as ops/spatial_gru.py
computes it in Python: the (batch, pixel) strides of each operand layout the GRU
hands the kernels, the vector width of each channel count, stride and alignment,
the grid, and what the wrappers hand the kernel. No card and no JAX: the kernel's
arguments are caught on 'meta' tensors.
"""

import pytest
import torch

from fiery_tpu_torch.ops import spatial_gru as GRU
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

B, T, H, W = 3, 4, 20, 24


def rows(shape, dtype=torch.bfloat16, device='cpu'):
    """A (B, C, H, W) view of channels-last memory."""
    b, c, h, w = shape
    return torch.zeros((b, h, w, c), dtype=dtype, device=device).permute(0, 3, 1, 2)


def layouts(dtype=torch.bfloat16, device='cpu'):
    """The operand layouts of a GRU step: {name: (tensor, (batch, pixel) strides)}."""
    C, Cx = 64, 32
    seq = GRU.gru_output(torch.empty((B, C, H, W), dtype=dtype, device=device), T)
    x = torch.zeros((B, T, H, W, Cx), dtype=dtype, device=device).permute(0, 1, 4, 2, 3)
    latent = torch.zeros((B, 1, 1, 1, Cx), dtype=dtype, device=device).expand(
        B, T, H, W, Cx).permute(0, 1, 4, 2, 3)
    dcat = rows((B, Cx + C, H, W), dtype, device)
    return {'slot': (seq[:, 2], (T * H * W * C, C)),
            'frame': (x[:, 1], (T * H * W * Cx, Cx)),
            'latent': (latent[:, 0], (Cx, 0)),
            'dcat state half': (dcat[:, Cx:], (H * W * (Cx + C), Cx + C)),
            'conv output': (rows((B, C, H, W), dtype, device), (H * W * C, C)),
            'one map': (rows((1, C, H, W), dtype, device), (0, C)),
            'one row': (rows((B, C, 1, W), dtype, device), (W * C, C)),
            'one column': (rows((B, C, H, 1), dtype, device), (H * C, C))}


@pytest.mark.parametrize('name', list(layouts()))
def test_pixel_strides_address_every_element(name):
    """(bs, ps): element (b, c, i, j) lies at b bs + (i W + j) ps + c from the view's
    first element, for every layout the GRU hands the kernels."""
    t, want = layouts()[name]
    assert GRU.pixel_strides(t) == want
    b, c, h, w = t.shape
    bs, ps = want
    bi, ci, ii, ji = torch.meshgrid(*(torch.arange(n) for n in t.shape), indexing='ij')
    offsets = bi * t.stride(0) + ci * t.stride(1) + ii * t.stride(2) + ji * t.stride(3)
    kernel = bi * bs + (ii * w + ji) * ps + ci
    assert torch.equal(offsets, kernel)


def test_pixel_strides_refuse_other_layouts():
    """Channels not contiguous (the standard layout), or pixels not evenly spaced
    (a column crop of channels-last rows)."""
    assert GRU.pixel_strides(torch.zeros((B, 64, H, W))) is None
    assert GRU.pixel_strides(rows((B, 64, H, W + 1))[..., :W]) is None
    assert GRU.pixel_strides(torch.zeros((B, 64, H))) is None


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
def test_vector_width_of_channels_strides_and_alignment(dtype):
    """16 bytes (8 bf16, 4 f32) at the GRU's shapes; narrower where a channel count,
    a stride or an address is not a multiple of 16 bytes."""
    es = torch.empty((), dtype=dtype).element_size()
    full = 16 // es
    for name, (t, st) in layouts(dtype).items():
        assert GRU.vector_width((32, 64), st, es, 0) == full, name
    assert GRU.vector_width((0, 35), (35,), es, 0) == 1
    assert GRU.vector_width((0, 36), (36,), es, 0) == 4
    assert GRU.vector_width((0, 64), (99,), es, 0) == 1        # a slice of 99-channel rows
    assert GRU.vector_width((0, 64), (100,), es, 0) == 4
    assert GRU.vector_width((0, 64), (64,), es, 8) == 8 // es
    assert GRU.vector_width((0, 64), (64,), es, 4) == 4 // es
    assert GRU.vector_width((0, 64), (64,), es, 2) == 1
    assert GRU.vector_width((2, 64), (64,), es, 0) == min(2, full)


@pytest.mark.parametrize('G', [4, 8, 12, 16, 64, 128, 256, 1024])
@pytest.mark.parametrize('P', [1, 255, 40_000])
def test_grid_covers_every_pixel_once(P, G):
    pix, tiles = GRU.launch_grid(P, G)
    assert G * pix <= max(GRU.THREADS, G) and (tiles - 1) * pix < P <= tiles * pix


@pytest.fixture
def caught(monkeypatch):
    """The kernel's arguments, caught: the card paths (``*_card``, the operators'
    CUDA implementations) run on 'meta' tensors, and each launch lands in the
    returned list as (plan fields, pointers); the plan cache and the counters are
    the test's own."""
    calls = []

    def fn(plan, *args):
        calls.append((list(plan), args))
        return 0

    monkeypatch.setattr(GRU, '_fn', lambda: fn)
    monkeypatch.setattr(GRU, '_PLANS', {})
    monkeypatch.setattr(GRU.spatial_gru, 'launches', 0)
    monkeypatch.setattr(GRU.spatial_gru_backward, 'launches', 0)
    monkeypatch.setattr(torch._C, '_cuda_getCurrentRawStream', lambda dev: 0, raising=False)
    return calls


def _plan_fields(kind, V, G, Cx, strides):
    pix, tiles = GRU.launch_grid(H * W, G)
    fields = [kind, 1, V, H * W, B, G, pix, tiles, Cx]
    for st in list(strides) + [(0, 0)] * (GRU.MAX_OPERANDS - len(strides)):
        fields += st
    return fields


@pytest.mark.parametrize('x_layout', ['latent', 'frame'])
def test_wrappers_hand_the_plan_and_count_launches(caught, x_layout):
    """One GRU step forward and backward as the GRU runs it: each wrapper hands the
    kernel its plan (kind, dtype, V, pixels, maps, G, PIX, tiles, C_x, strides)
    and its operands' pointers in the kernel's order, and counts one launch."""
    L = layouts(device='meta')
    x_t, x_st = L[x_layout]
    Cx = x_t.shape[1]
    h, h_st = L['slot']
    r_pre, u_pre, ht = (rows((B, 64, H, W), device='meta') for _ in range(3))
    conv = L['conv output'][1]
    cat = GRU.reset_concat_card(x_t, r_pre, h)
    assert cat.shape == (B, Cx + 64, H, W) and GRU.pixel_strides(cat) == (
        H * W * (Cx + 64), Cx + 64)
    plan, ptrs = caught[-1]
    assert plan == _plan_fields(0, 8, (Cx + 64) // 8, Cx,
                                [x_st, conv, h_st, GRU.pixel_strides(cat)])
    assert len(ptrs) == GRU.MAX_OPERANDS + 1 and ptrs[4:7] == (None,) * 3
    out = GRU.gru_output(h, T)
    GRU.state_update_card(u_pre, h, ht, out, 1)
    assert caught[-1][0] == _plan_fields(1, 8, 8, 0, [conv, h_st, conv, h_st])
    assert GRU.spatial_gru.launches == 2
    dcat, dcat_st = L['dcat state half']
    GRU.reset_concat_backward(dcat, r_pre, h)
    assert caught[-1][0] == _plan_fields(2, 8, 8, 0, [dcat_st, conv, h_st, conv, conv])
    GRU.state_update_backward(out[:, 1], u_pre, h, ht)
    assert caught[-1][0] == _plan_fields(3, 8, 8, 0, [h_st, conv, h_st, conv, conv, conv,
                                                     conv])
    assert GRU.spatial_gru_backward.launches == 2 and len(caught) == 4


def test_plans_are_made_once_per_key(caught):
    """A second call of the same shapes, strides and alignment reuses its plan; an
    address that is only 4-byte aligned makes a new plan of 2 bf16 a thread."""
    r_pre, h = rows((B, 64, H, W), device='meta'), rows((B, 64, H, W), device='meta')
    x_t = rows((B, 32, H, W), device='meta')
    for _ in range(3):
        GRU.reset_concat_card(x_t, r_pre, h)
    assert len(GRU._PLANS) == 1 and len(caught) == 3
    plan = GRU._plan(0, (x_t, r_pre, h, rows((B, 96, H, W), device='meta')), 4)
    assert list(plan)[2] == 2 and len(GRU._PLANS) == 2


def test_gradients_of_other_layouts_are_copied_and_inputs_refused(caught):
    """A gradient in the standard layout is copied to channels-last rows before the
    launch; a forward operand laid out so raises, as does a dtype mix."""
    r_pre, u_pre, h, ht = (rows((B, 64, H, W), device='meta') for _ in range(4))
    dout = torch.zeros((B, 64, H, W), dtype=torch.bfloat16, device='meta')
    GRU.state_update_backward(dout, u_pre, h, ht)
    assert caught[-1][0][9:11] == [H * W * 64, 64]
    with pytest.raises(ValueError):
        GRU.state_update_card(dout, h, ht, rows((B, 64, H, W), device='meta')[:, None], 0)
    with pytest.raises(ValueError):
        GRU.reset_concat_card(rows((B, 32, H, W), torch.float32, 'meta'), r_pre, h)
    with pytest.raises(ValueError):
        GRU.reset_concat_card(rows((B, 32, H, W), device='meta'),
                              rows((B, 48, H, W), device='meta'), h)
