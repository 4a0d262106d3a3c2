"""The launch plan of the BatchNorm kernel (K10), as ops/batch_norm.py computes it
in Python: the vector width of each channel count, the row chunks of the blocks
and the order in which a thread walks them, and what the wrapper hands the
kernel. No card and no JAX: the kernel's arguments are caught on 'meta' tensors.
"""

import pytest
import torch

from fiery_tpu_torch.ops import batch_norm as BN
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

# the channel counts of the served path's BatchNorm calls (full-width baseline.yml)
SERVED_CHANNELS = (16, 21, 23, 24, 32, 35, 48, 56, 64, 112, 128, 144, 160, 192, 256, 336,
                   672, 960)
SMS = 132


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
@pytest.mark.parametrize('C', SERVED_CHANNELS)
def test_vector_width_of_served_channels(C, dtype):
    """16-byte accesses (8 bf16, 4 f32): for every multiple of 8 on its own rows;
    for the odd counts 21, 23 and 35 on 8 (bf16) or 4 (f32) rows a kernel row, when
    the row count allows it, else one channel a thread."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    full = 16 // itemsize
    if C % 8 == 0:
        assert BN.vector_width(C, itemsize, rows=1) == (full, 1)
    else:
        assert C in (21, 23, 35)
        assert BN.vector_width(C, itemsize, rows=120_000) == (full, full)
        assert BN.vector_width(C, itemsize, rows=18) == (2, 2)
        assert BN.vector_width(C, itemsize, rows=1) == (1, 1)
        assert BN.vector_width(C, itemsize, (C + 1,), rows=120_000) == (1, 1)


def test_unaligned_dy_slice_takes_a_narrower_width():
    """A channel slice of a concat's gradient is read in place: its row stride and
    its address narrow the access to what both allow."""
    def width_of(dy, C=64):
        return BN.vector_width(C, dy.element_size(), (BN.row_stride(dy),),
                               dy.data_ptr() & 15, rows=dy.numel() // C)

    cat = torch.zeros((2, 99, 5, 6), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert BN.row_stride(cat[:, 35:]) == 99 and width_of(cat[:, 35:]) == (1, 1)
    cat = torch.zeros((2, 100, 5, 6), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert width_of(cat[:, 36:]) == (4, 1)     # stride 100, 72 bytes in
    cat = torch.zeros((2, 98, 5, 6), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert width_of(cat[:, 34:]) == (2, 1)     # stride 98, 68 bytes in
    cat = torch.zeros((2, 128, 5, 6), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert width_of(cat[:, 64:]) == (8, 1) and width_of(cat[:, 60:124]) == (4, 1)
    assert BN.vector_width(64, 2, (64,), align=2) == (1, 1)
    assert BN.vector_width(64, 4, (64,), align=8) == (2, 1)


@pytest.mark.parametrize('M,C,V,fold', [
    (1, 21, 1, 1), (7, 960, 8, 1), (100, 35, 1, 1), (5000, 16, 8, 1), (37_813, 144, 8, 1),
    (1_451_520, 144, 8, 1), (22_680, 960, 8, 1), (120_000, 64, 4, 1), (480_000, 35, 8, 8),
    (3_000, 1023, 1, 1), (1_080, 22, 8, 4), (1_200, 23, 4, 4)])
def test_blocks_cover_every_row_once_and_walk_back(M, C, V, fold):
    G, threads, R, blocks = BN.grid(M, C, V, fold, SMS)
    L, Mk = fold * C // V, M // fold
    assert G * L <= threads <= (1024 if V == 1 else 512) and threads % 32 == 0
    assert R % G == 0 and blocks == -(-Mk // R) and (blocks - 1) * R < Mk <= blocks * R
    assert blocks <= SMS and BN.partial_slots(blocks) == blocks + -(-blocks // 8)
    seen = torch.zeros(Mk, dtype=torch.int32)
    for b in range(blocks):
        chunk = []
        for g in range(G):
            first = BN.thread_rows(Mk, R, G, b, g)
            second = BN.thread_rows(Mk, R, G, b, g, second_pass=True)
            assert list(second) == list(first)[::-1]
            chunk.extend(first)
        if chunk:
            assert min(chunk) >= b * R and max(chunk) < min(Mk, (b + 1) * R)
            seen[torch.tensor(chunk)] += 1
    assert bool((seen == 1).all())


def test_large_calls_fill_the_card_and_small_ones_take_what_their_rows_fill():
    assert BN.grid(54 * 112 * 240, 144, 8, 1, SMS)[3] == SMS
    assert BN.grid(18 * 112 * 240, 144, 8, 1, SMS)[3] == SMS
    assert BN.grid(1, 23, 1, 1, SMS)[3] == 1
    assert BN.grid(64, 64, 8, 1, SMS)[3] == 1
    assert BN.grid(22_680, 960, 8, 1, SMS)[3] == SMS


@pytest.fixture
def caught(monkeypatch):
    """The kernels' arguments, caught: the card path (``batch_norm_card``, the
    operators' CUDA implementation) runs on 'meta' tensors, and each launch lands
    in the returned list; the plan cache and the counters are the test's own."""
    calls = []

    def fn(name):
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(BN, '_fn', fn)
    monkeypatch.setattr(BN, '_sms', lambda dev: SMS)
    monkeypatch.setattr(BN, '_PLANS', {})
    # the wrappers' counters, restored after the test
    monkeypatch.setattr(BN.batch_norm_forward, 'launches', 0)
    monkeypatch.setattr(BN.batch_norm_forward, 'forms', {'4d': 0, '5d': 0})
    monkeypatch.setattr(BN.batch_norm_backward, 'launches', 0)
    monkeypatch.setattr(torch._C, '_cuda_getCurrentRawStream', lambda dev: 0, raising=False)
    return calls


def _meta_rows(shape, dtype=torch.bfloat16):
    return torch.empty(shape[:1] + shape[2:] + shape[1:2], dtype=dtype,
                       device='meta').movedim(-1, 1)


@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
def test_wrappers_hand_the_plan_and_a_partial_slot_per_block(caught, monkeypatch, training):
    """The forward and backward pass the plan (V, fold, G, threads, R, blocks) to the
    kernel, allocate a partial buffer of a slot per block and per group of 8 in
    training and for the backward, and count 2 launches a training call each way,
    1 an eval call."""
    partials = []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        if kw.get('dtype') is torch.float64:
            partials.append(tuple(t.shape))
        return t

    monkeypatch.setattr(BN.torch, 'empty', spy)
    shape, C = (6, 144, 28, 60), 144
    x = _meta_rows(shape)
    params = [torch.empty(C, device='meta') for _ in range(4)]
    fwd0, bwd0 = BN.batch_norm_forward.launches, BN.batch_norm_backward.launches
    _, stats = BN.batch_norm_card(x, *params, training, 0.1, 1e-3, 'swish', None)
    mean, var, clamp = stats if training else (params[2], params[3], None)
    assert BN.batch_norm_forward.launches == fwd0 + (2 if training else 1)
    M = x.numel() // C
    V, fold = BN.vector_width(C, 2, rows=M)
    plan = (M, C, V, fold, *BN.grid(M, C, V, fold, SMS))
    name, args = caught[-1]
    assert name == 'fiery_batch_norm_forward' and args[11:19] == plan
    blocks = plan[-1]
    assert partials == ([(BN.partial_slots(blocks), 2, C)] if training else [])
    dy = _meta_rows((6, 200, 28, 60))[:, 8:152]        # a channel slice, read in place
    BN.batch_norm_backward(dy, x, params[0], params[1], mean, var, clamp, 1e-3, 'swish',
                           None, training)
    assert BN.batch_norm_backward.launches == bwd0 + 2
    name, args = caught[-1]
    assert name == 'fiery_batch_norm_backward' and args[1] == 200 and args[13:21] == plan
    assert partials[-1] == (BN.partial_slots(blocks), 2, C)
