"""The BatchNorm kernel (K10) on the encoder's wide layers at downsample 16
(MODEL.ENCODER.DOWNSAMPLE 16: 1,632 and 2,688 channels, beyond a launch's 1,024),
as ops/batch_norm.py plans them in Python: a call launches the kernels once a
channel slice, each slice a multiple of 8 channels wide but the last, its rows a
whole row apart. The kernel's arguments are caught on 'meta' tensors, as
tests/test_torch_bn_plan.py catches them; no card and no JAX.
"""

import pytest
import torch

from fiery_tpu_torch.models.fiery import Fiery, FieryConfig
from fiery_tpu_torch.models.layers import BatchNorm
from fiery_tpu_torch.ops import batch_norm as BN

from test_torch_bn_plan import SMS, _meta_rows, caught  # noqa: F401  (a fixture)
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


def test_downsample_16_calls_are_sliced():
    """The channel counts of the encoder at downsample 16 beyond a launch's limit,
    and each one's slices: equal, 8-channel-aligned, covering every channel once."""
    model = Fiery(FieryConfig(encoder_downsample=16))
    wide = sorted({m.num_features for m in model.modules()
                   if isinstance(m, BatchNorm) and m.num_features > BN.MAX_CHANNELS})
    assert wide == [1632, 2688]
    assert BN.channel_slices(1632) == [(0, 816), (816, 1632)]
    assert BN.channel_slices(2688) == [(0, 896), (896, 1792), (1792, 2688)]
    for C in (1, 64, 1024, 1025, 1632, 2047, 2049, 2688, 5000):
        slices = BN.channel_slices(C)
        assert [c for c0, c1 in slices for c in range(c0, c1)] == list(range(C))
        assert all(c1 - c0 <= BN.MAX_CHANNELS and c0 % 8 == 0 for c0, c1 in slices)
        assert len(slices) == -(-C // BN.MAX_CHANNELS)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('C,post', [(1632, 'swish'), (2688, 'swish'), (1025, 'add_relu')])
def test_a_wide_call_launches_once_a_slice(caught, monkeypatch, C, post, training, dtype):
    """Forward and backward hand each slice its plan (slice's C, V, fold, G, threads,
    R, blocks as for a call of that width whose rows are C values apart), x, y, the
    residual, dy, dx and every per-channel vector moved to the slice's first channel,
    one partial buffer for the largest slice, and ``ld`` = C last; launches counted
    once a slice."""
    es = torch.empty((), dtype=dtype).element_size()
    shape = (18, C, 7, 15)
    x = _meta_rows(shape, dtype)
    residual = _meta_rows(shape, dtype) if post == 'add_relu' else None
    params = [torch.empty(C, device='meta') for _ in range(4)]
    fwd0, bwd0 = BN.batch_norm_forward.launches, BN.batch_norm_backward.launches
    _, stats = BN.batch_norm_card(x, *params, training, 0.1, 1e-3, post, residual)
    mean, var, clamp = stats if training else (params[2], params[3], None)
    slices = BN.channel_slices(C)
    per_call = 2 if training else 1
    assert BN.batch_norm_forward.launches == fwd0 + per_call * len(slices)
    M = x.numel() // C
    launches = [args for name, args in caught if name == 'fiery_batch_norm_forward']
    assert len(launches) == len(slices)
    for (c0, c1), args in zip(slices, launches):
        Cs = c1 - c0
        V, fold = BN.vector_width(Cs, es, (C,) if Cs < C else (), 0, M)
        assert fold == 1 and args[11:19] == (M, Cs, V, fold, *BN.grid(M, Cs, V, fold, SMS))
        assert args[0] == c0 * es and args[2] == c0 * es          # x, y
        assert args[1] == (c0 * es if residual is not None else 0)
        assert args[8] == args[9] == c0 * 4                      # weight, bias
        assert args[-1] == C
    assert (launches[-1][13] == 1) == (C % 8 != 0)       # 16-byte accesses but at 1,025

    dy = _meta_rows(shape, dtype)
    BN.batch_norm_backward(dy, x, params[0], params[1], mean, var, clamp, 1e-3, post,
                           residual, training)
    assert BN.batch_norm_backward.launches == bwd0 + 2 * len(slices)
    launches = [args for name, args in caught if name == 'fiery_batch_norm_backward']
    assert len(launches) == len(slices)
    for (c0, c1), args in zip(slices, launches):
        assert args[0] == args[2] == args[4] == c0 * es          # dy, x, dx
        assert args[1] == C and args[-1] == C and args[14] == c1 - c0
        assert args[11] == 16 * c0                                # its (4, slice's C) params
