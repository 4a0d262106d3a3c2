"""On the card: the BatchNorm kernel with its epilogues (K10) and the SpatialGRU's
gate kernels (K11), forward and backward, against their plain versions, and the
tiny model's request and training step through them. Every test needs a CUDA
device and skips without one.

Tolerances: forward within 1e-5 + 1e-5 |y| in f32 and one bf16 ulp in bf16;
batch and running statistics within 1e-6 relative; gradients within a relative
L2 error of 1e-5 in f32 and 1e-2 in bf16.

The file imports nothing of JAX, so that it runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_norm_gru_gpu.py
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.ops import batch_norm as BN
from fiery_tpu_torch.ops import spatial_gru as GRU

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


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


def _rows(shape, dtype, cuda, gen, mean=0.0):
    """A channels-first view of channels-last memory."""
    t = torch.randn(shape[:1] + shape[2:] + shape[1:2], generator=gen, device=cuda) + mean
    return t.to(dtype).movedim(-1, 1)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('post', BN.POSTS)
def test_batch_norm_kernels_match_plain(cuda, post, training, dtype):
    gen = torch.Generator(device=cuda).manual_seed(BN.POSTS.index(post))
    shape = (2, 35, 3, 40, 44) if post in ('relu', 'add') else (6, 144, 28, 60)
    C = shape[1]
    x = _rows(shape, dtype, cuda, gen, mean=0.5)
    res = _rows(shape, dtype, cuda, gen) if post in BN.RESIDUAL_POSTS else None
    dy = _rows(shape, dtype, cuda, gen)
    w = torch.rand(C, generator=gen, device=cuda) + 0.5
    b = torch.randn(C, generator=gen, device=cuda)
    rm = torch.randn(C, generator=gen, device=cuda) * 0.1 + 0.5
    rv = torch.rand(C, generator=gen, device=cuda) + 0.5
    stats_k, stats_p = (rm.clone(), rv.clone()), (rm.clone(), rv.clone())
    launches = BN.batch_norm_forward.launches
    got = BN.batch_norm_forward(x, w, b, *stats_k, training, 0.1, 1e-3, post, res)
    want = BN.batch_norm_forward_plain(x, w, b, *stats_p, training, 0.1, 1e-3, post, res)
    # the statistics with their reduction, then apply in training; apply in eval
    assert BN.batch_norm_forward.launches == launches + (2 if training else 1)
    assert got[0].stride() == x.stride() and _within(got[0], want[0], dtype)
    for a, c in zip(got[1:3] + stats_k, want[1:3] + stats_p):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6 * float(c.abs().max()))
    mean, var, clamp = got[1:]
    launches = BN.batch_norm_backward.launches
    gk = BN.batch_norm_backward(dy, x, w, b, mean, var, clamp, 1e-3, post, res, training)
    gp = BN.batch_norm_backward_plain(dy, x, w, b, mean, var, clamp, 1e-3, post, res,
                                      training)
    assert BN.batch_norm_backward.launches == launches + 2     # reduce + finalize, apply
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, a, c in zip(('dx', 'dweight', 'dbias', 'dres'), gk, gp):
        if c is not None:
            assert _rel_l2(a, c) <= tol, name


def test_batch_norm_is_deterministic_and_refuses_other_layouts(cuda):
    """Two runs of the training forward and backward give the same bits: the
    statistics and the parameter gradients are f64 sums in a fixed order."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _rows((54, 48, 112, 240), torch.bfloat16, cuda, gen)
    dy = _rows((54, 48, 112, 240), torch.bfloat16, cuda, gen)
    w, b = torch.ones(48, device=cuda), torch.zeros(48, device=cuda)
    runs = []
    for _ in range(2):
        fwd = BN.batch_norm_forward(x, w, b, torch.zeros(48, device=cuda),
                                    torch.ones(48, device=cuda), True, 0.1, 1e-3, 'swish')
        bwd = BN.batch_norm_backward(dy, x, w, b, *fwd[1:], 1e-3, 'swish', None, True)
        runs.append(fwd + bwd[:3])
    for a, c in zip(runs[0], runs[1]):
        assert torch.equal(a, c)
    with pytest.raises(ValueError):
        BN.batch_norm_forward(x.contiguous(), w, b, torch.zeros(48, device=cuda),
                              torch.ones(48, device=cuda), False, 0.0, 1e-3)


def _differing(got, want):
    """Positions where got and want differ in their bits (two NaNs agree)."""
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    same = got.contiguous().view(bits) == want.contiguous().view(bits)
    return ~(same | (torch.isnan(got) & torch.isnan(want)))


@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('post', ['none', 'swish', 'add_relu'])
@pytest.mark.parametrize('C', [21, 23, 35])
def test_batch_norm_odd_channel_counts_match_plain(cuda, C, post, training):
    """The served path's channel counts that are not multiples of 8, bf16, at row
    counts that fold 8 rows (16-byte accesses), 2 rows and none (one channel a
    thread): y equal to the plain version in every bit, statistics and gradients
    within the gates."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    shape = (2, C, 3, 30, 34) if C == 35 else (18, C, 1, 1) if training else (1, C, 1, 1)
    dtype = torch.bfloat16
    x = _rows(shape, dtype, cuda, gen, mean=0.5)
    res = _rows(shape, dtype, cuda, gen) if post in BN.RESIDUAL_POSTS else None
    dy = _rows(shape, dtype, cuda, gen)
    w = torch.rand(C, generator=gen, device=cuda) + 0.5
    b = torch.randn(C, generator=gen, device=cuda)
    rm = torch.randn(C, generator=gen, device=cuda) * 0.1 + 0.5
    rv = torch.rand(C, generator=gen, device=cuda) + 0.5
    stats_k, stats_p = (rm.clone(), rv.clone()), (rm.clone(), rv.clone())
    got = BN.batch_norm_forward(x, w, b, *stats_k, training, 0.1, 1e-3, post, res)
    want = BN.batch_norm_forward_plain(x, w, b, *stats_p, training, 0.1, 1e-3, post, res)
    assert int(_differing(got[0], want[0]).sum()) == 0
    for a, c in zip(got[1:3] + stats_k, want[1:3] + stats_p):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6 * float(c.abs().max()))
    mean, var, clamp = got[1:]
    gk = BN.batch_norm_backward(dy, x, w, b, mean, var, clamp, 1e-3, post, res, training)
    gp = BN.batch_norm_backward_plain(dy, x, w, b, mean, var, clamp, 1e-3, post, res,
                                      training)
    for name, a, c in zip(('dx', 'dweight', 'dbias', 'dres'), gk, gp):
        if c is not None:
            assert _rel_l2(a, c) <= 1e-2, name


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_batch_norm_backward_reads_a_dy_slice_at_an_odd_row_stride(cuda, dtype):
    """dy as the gradient of a concat gives it: a channel slice of 99-channel rows,
    read in place (no copy) at the narrower width that its stride allows."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    shape, C = (6, 64, 28, 60), 64
    x = _rows(shape, dtype, cuda, gen, mean=0.5)
    dcat = _rows((6, 99, 28, 60), dtype, cuda, gen)
    dy = dcat[:, 35:]
    w = torch.rand(C, generator=gen, device=cuda) + 0.5
    b = torch.randn(C, generator=gen, device=cuda)
    _, mean, var, clamp = BN.batch_norm_forward(x, w, b, torch.zeros(C, device=cuda),
                                                torch.ones(C, device=cuda), True, 0.1, 1e-3,
                                                'relu')
    copies = sum(BN.batch_norm_backward.grad_copies.values())
    gk = BN.batch_norm_backward(dy, x, w, b, mean, var, clamp, 1e-3, 'relu', None, True)
    assert sum(BN.batch_norm_backward.grad_copies.values()) == copies
    gp = BN.batch_norm_backward_plain(dy.contiguous(), x, w, b, mean, var, clamp, 1e-3,
                                      'relu', None, True)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, a, c in zip(('dx', 'dweight', 'dbias'), gk, gp):
        assert _rel_l2(a, c) <= tol, name


# The epilogues that take a max: CUDA's fmaxf, which the kernel uses, returns 0
# for a NaN where torch.clamp_min returns the NaN, so at a NaN input (z or the
# residual) the kernel and the plain version differ by design.
MAX_POSTS = ('relu', 'add_relu', 'relu_add')


def bf16_sweep(cuda, post, C, seeded=False):
    """All 65,536 bf16 bit patterns as x, in eval with mean 0, var + eps = 1,
    weight 1 and bias 0, so that z = x (16-byte accesses at C = 64, one channel a
    thread at C = 1); with ``seeded``, instead seeded constants per channel (mean
    and var of order 1, weight and bias from 1e-38 to 10, so that z and its steps
    reach the subnormals). The residual is x in reverse order; dy is 1. For y, dx
    and dres: (values whose bits differ from the plain version's, of them at a NaN
    input of an epilogue that takes a max (MAX_POSTS), a few of the others as
    (x, kernel, plain))."""
    x = torch.arange(-32768, 32768, dtype=torch.int32, device=cuda).to(torch.int16).view(
        torch.bfloat16)
    x = x.view(65536 // C, 1, 1, C).movedim(-1, 1)
    res = x.flip(0) if post in BN.RESIDUAL_POSTS else None
    if seeded:
        rng = np.random.RandomState(C)
        mean, var, w, b = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
            rng.randn(C) * 2, rng.uniform(0.1, 4.0, C),
            rng.randn(C) * 10.0 ** rng.uniform(-38, 1, C),
            rng.randn(C) * 10.0 ** rng.uniform(-38, 1, C)))
        eps = 1e-3
    else:
        w, b = torch.ones(C, device=cuda), torch.zeros(C, device=cuda)
        mean, var = torch.zeros(C, device=cuda), torch.full((C,), 0.75, device=cuda)
        eps = 0.25
    y = BN.batch_norm_forward(x, w, b, mean, var, False, 0.0, eps, post, res)[0]
    y_plain = BN.batch_norm_forward_plain(x, w, b, mean, var, False, 0.0, eps, post, res)[0]
    dy = torch.ones_like(x)
    gk = BN.batch_norm_backward(dy, x, w, b, mean, var, None, eps, post, res, False)
    gp = BN.batch_norm_backward_plain(dy, x, w, b, mean, var, None, eps, post, res, False)
    nan = torch.isnan(x) | (torch.isnan(res) if res is not None else False)
    out = {}
    for name, a, c in (('y', y, y_plain), ('dx', gk[0], gp[0]), ('dres', gk[3], gp[3])):
        if c is not None:
            diff = _differing(a, c)
            excused = diff & nan if post in MAX_POSTS else torch.zeros_like(diff)
            bad = diff & ~excused
            out[name] = (int(diff.sum()), int(excused.sum()), list(zip(
                x[bad][:4].float().tolist(), a[bad][:4].float().tolist(),
                c[bad][:4].float().tolist())))
    return out


@pytest.mark.parametrize('C,seeded', [(64, False), (1, False), (64, True)],
                         ids=['C64', 'C1', 'C64-seeded'])
@pytest.mark.parametrize('post', BN.POSTS)
def test_batch_norm_every_bf16_value(cuda, post, C, seeded):
    """bf16_sweep: y, dx and dres equal to the plain version in every bit, but at
    the NaN inputs of the epilogues that take a max."""
    for name, (diff, excused, examples) in bf16_sweep(cuda, post, C, seeded).items():
        assert diff == excused, (name, examples)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('B,Cx', [(1, 32), (3, 64)])
def test_spatial_gru_kernels_match_plain(cuda, B, Cx, dtype):
    """One step's two launches and their backward at the rollout's shapes (served
    B = 1 with the latent's 32 channels, trained B = 3 with 64), the state read
    from and written into slots of (B, T, C, H, W) buffers, the concat's gradient
    a channel slice, as the GRU runs them."""
    gen = torch.Generator(device=cuda).manual_seed(B)
    C, T, H, W = 64, 4, 200, 200
    x = torch.randn((B, T, H, W, Cx), generator=gen, device=cuda).to(dtype).permute(0, 1, 4, 2, 3)
    prev = GRU.gru_output(torch.empty((B, C, H, W), dtype=dtype, device=cuda), T)
    prev.copy_(torch.randn(prev.shape, generator=gen, device=cuda))
    h = prev[:, 1]
    r_pre, u_pre, ht = (_rows((B, C, H, W), dtype, cuda, gen) for _ in range(3))
    launches = GRU.spatial_gru.launches
    cat = GRU.reset_concat(x[:, 1], r_pre, h)
    assert _within(cat, GRU.reset_concat_plain(x[:, 1], r_pre, h), dtype)
    out = GRU.gru_output(h, T)
    GRU.state_update(u_pre, h, ht, out, 2)
    assert _within(out[:, 2], GRU.state_update_plain(u_pre, h, ht), dtype)
    assert GRU.spatial_gru.launches == launches + 2
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    dcat = _rows((B, Cx + C, H, W), dtype, cuda, gen)
    dout = prev.flip(1)[:, 0]
    launches = GRU.spatial_gru_backward.launches
    got = GRU.reset_concat_backward(dcat[:, Cx:], r_pre, h) \
        + GRU.state_update_backward(dout, u_pre, h, ht)
    assert GRU.spatial_gru_backward.launches == launches + 2
    want = GRU.reset_concat_backward_plain(dcat[:, Cx:], r_pre, h) \
        + GRU.state_update_backward_plain(dout, u_pre, h, ht)
    for i, (a, c) in enumerate(zip(got, want)):
        assert _rel_l2(a, c) <= tol, i


def gru_sweep(cuda, C, offset=0):
    """All 65,536 bf16 bit patterns as r_pre and as u_pre (C channels a pixel; with
    ``offset``, each operand a channel slice at that offset of C + 2 offset
    channel rows, so that the kernels take narrower accesses), h in reverse order,
    h_tilde rolled by one, x_t seeded. For each forward output and each backward
    output: the values whose bits differ from the plain version's."""
    side = int((65536 // C) ** 0.5)          # one map of side x side pixels

    def operand(values):
        rows = torch.zeros((1, side, side, C + 2 * offset), dtype=torch.bfloat16,
                           device=cuda)
        rows[..., offset:offset + C] = values.view(1, side, side, C)
        return rows.movedim(-1, 1)[:, offset:offset + C]

    every = torch.arange(-32768, 32768, dtype=torch.int32, device=cuda).to(
        torch.int16).view(torch.bfloat16)
    z, h, ht = operand(every), operand(every.flip(0)), operand(every.roll(1))
    gen = torch.Generator(device=cuda).manual_seed(C)
    x_t = operand(torch.randn(65536, generator=gen, device=cuda).to(torch.bfloat16))
    g = operand(torch.randn(65536, generator=gen, device=cuda).to(torch.bfloat16))
    slot = operand(torch.zeros_like(every))
    got = {'cat': GRU.reset_concat(x_t, z, h), 'h_new': GRU.state_update(z, h, ht, slot[:, None], 0)}
    want = {'cat': GRU.reset_concat_plain(x_t, z, h), 'h_new': GRU.state_update_plain(z, h, ht)}
    for name, a, c in zip(('dr_pre', 'dh_reset', 'du_pre', 'dh_update', 'dh_tilde'),
                          GRU.reset_concat_backward(g, z, h) + GRU.state_update_backward(
                              g, z, h, ht),
                          GRU.reset_concat_backward_plain(g, z, h)
                          + GRU.state_update_backward_plain(g, z, h, ht)):
        got[name], want[name] = a, c
    return {k: int(_differing(got[k], want[k]).sum()) for k in got}


@pytest.mark.parametrize('C,offset', [(64, 0), (64, 2), (64, 1), (1, 0)],
                         ids=['16-byte', '4-byte', '2-byte', 'C1'])
def test_spatial_gru_every_bf16_value(cuda, C, offset):
    """gru_sweep: both forward launches equal to the plain version in every bit for
    every bf16 input, at each access width; the backward (f32 in the plain
    version's order, rounded once) too."""
    assert gru_sweep(cuda, C, offset) == dict.fromkeys(
        ('cat', 'h_new', 'dr_pre', 'dh_reset', 'du_pre', 'dh_update', 'dh_tilde'), 0)


def test_tiny_model_runs_every_bn_and_gru_step_on_the_kernels(cuda):
    """The tiny config's request and training step on the card: one K10 launch per
    BatchNorm call and per BatchNorm backward, two K11 launches per GRU step each
    way, and no plain version."""
    from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
    from fiery_tpu_torch.models.layers import BatchNorm
    from fiery_tpu_torch.serve import (build_fiery, calibrate_batchnorm, init_params,
                                       make_request, predict)
    from fiery_tpu_torch.training.trainer import Trainer
    from fiery_tpu_torch.utils.config import get_cfg
    tiny = {'PRECISION': 16, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2, 'BATCHSIZE': 2,
            'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B']},
            'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
                     'D_BOUND': [2.0, 8.0, 1.0]},
            'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
                      'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
                      'DISTRIBUTION': {'LATENT_DIM': 4},
                      'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 2}}}
    cfg = get_cfg(cfg_dict=tiny)
    model = init_params(build_fiery(cfg), seed=0)
    calibrate_batchnorm(model, [make_request(cfg, seed=1)])
    calls = [0, 0]       # BatchNorm calls, and the K10 forward launches they imply

    def hook(module, _):
        calls[0] += 1
        calls[1] += 2 if module.training else 1

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(hook)
    counters = (BN.batch_norm_forward, BN.batch_norm_backward, GRU.spatial_gru,
                GRU.spatial_gru_backward)
    for c in counters:
        c.launches = c.plain_calls = 0
    predict(model, make_request(cfg, seed=2))
    torch.cuda.synchronize()
    assert calls[0] > 0 and BN.batch_norm_forward.launches == calls[0] == calls[1]
    assert GRU.spatial_gru.launches == 2 * 2
    trainer = Trainer(cfg)
    init_params(trainer.model, seed=0)
    for m in trainer.model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(hook)
    calls[:] = [0, 0]
    for c in counters:
        c.launches = 0
    batch = SyntheticFutureDataset(cfg, n_samples=2, seed=0).get_batch([0, 1])
    trainer.train_step(batch, torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert BN.batch_norm_forward.launches == calls[1]
    assert BN.batch_norm_backward.launches == 2 * calls[0]
    assert GRU.spatial_gru.launches == GRU.spatial_gru_backward.launches == 4
    assert all(c.plain_calls == 0 for c in counters)
