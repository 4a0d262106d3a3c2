"""The top-k depth select (K5) and the sparse splat of fiery_tpu_torch against the
JAX reference (``_topk_select_nosort`` and ``lift_splat_topk`` of
fiery_tpu/ops/lift_splat.py), on the CPU.

Inputs are made with numpy from fixed seeds and handed to both. The select is held
exactly: the same set, the same slot order (ascending bin), ties at the k-th weight
included, in f32 and in bf16 (whose keys are 16 bits wide). The kernel-vs-plain
tests are in test_torch_levers_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.ops import lift_splat as JLS
from fiery_tpu_torch.ops import lift_splat as LS
from fiery_tpu_torch.utils.geometry import calculate_birds_eye_view_parameters

D = 48
FINAL_DIM, DOWNSAMPLE, D_BOUND = (64, 96), 8, (2.0, 8.0, 1.0)
BOUNDS = ((-8.0, 8.0, 0.5), (-8.0, 8.0, 0.5), (-10.0, 10.0, 20.0))


def tie_rows(seed, rows=64):
    """(rows, D) f32 weights, each representable in bf16: softmax rows, rows of a few
    repeated levels (ties at the k-th value), rows of all +0.0, rows with -0.0 beside
    +0.0 and negative values, and rows whose bf16 softmax underflows to +0.0 in most
    bins."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, D).astype(np.float32)
    out = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    q = rows // 8
    out[q:2 * q] = rng.randint(0, 3, (q, D)) / 4.0
    out[2 * q:3 * q] = 0.0
    out[3 * q:4 * q] = rng.choice([-0.0, 0.0, -0.5, 0.25], (q, D))
    logits = rng.randn(q, D) * 40.0
    out[4 * q:5 * q] = np.exp(logits - logits.max(-1, keepdims=True))
    out[5 * q:6 * q] = 1.0                         # USE_DEPTH_DISTRIBUTION False
    # round to bf16 (torch and JAX both round to nearest even)
    return torch.from_numpy(out.astype(np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize('k', [1, 8, D])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_topk_select_plain_equals_jax_nosort(dtype, k):
    depth = tie_rows(k)
    ids = np.random.RandomState(100 + k).randint(0, 10 ** 6, depth.shape).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_w, want_ids = JLS._topk_select_nosort(jnp.asarray(depth, jdt), jnp.asarray(ids), k)
    got_w, got_ids, idx = LS.topk_select_plain(torch.from_numpy(depth).to(tdt),
                                               torch.from_numpy(ids), k)
    assert got_w.dtype == tdt and got_ids.dtype == torch.int32 and idx.dtype == torch.uint8
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    # the port copies each selected weight; the JAX one-hot sum runs through XLA's
    # CPU arithmetic, which flushes subnormal weights to zero
    got = got_w.float().numpy()
    subnormal = (got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    assert subnormal.sum() < 0.01 * got.size
    np.testing.assert_array_equal(np.where(subnormal, 0.0, got),
                                  np.asarray(want_w.astype(jnp.float32)))
    # the slots hold distinct bins in ascending order, and the ids are theirs
    assert bool((idx[:, 1:] > idx[:, :-1]).all())
    np.testing.assert_array_equal(np.take_along_axis(ids, idx.long().numpy(), -1),
                                  got_ids.numpy())
    # rows of equal weights take the first k bins
    np.testing.assert_array_equal(idx[40:48].numpy(), np.broadcast_to(np.arange(k), (8, k)))


def test_topk_select_backward_plain_is_autograd_of_the_select():
    """The gradient reaches exactly the selected bins; the plain backward equals
    autograd through the gather, and the autograd.Function routes CPU tensors to it."""
    rng = np.random.RandomState(3)
    depth = torch.from_numpy(tie_rows(3, 16)).requires_grad_()
    ids = torch.from_numpy(rng.randint(0, 50, (16, D)).astype(np.int32))
    g = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    top_w, _, idx = LS.topk_select(depth, ids, 8)
    got = torch.autograd.grad(top_w, depth, g)[0]
    want = torch.autograd.grad(depth.gather(-1, idx.long()), depth, g)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(LS.topk_select_backward_plain(g, idx, D), want, rtol=0, atol=0)
    assert int((got != 0).sum(-1).max()) <= 8


def _geometry(seed):
    from test_torch_lift_splat import _geometry as rig
    frustum, intr, extr = rig(np.random.RandomState(seed))
    return np.array(JLS.get_geometry(jnp.asarray(frustum), jnp.asarray(intr),
                                     jnp.asarray(extr))), frustum.shape[:3]


@pytest.mark.parametrize('k', [1, 3])
def test_lift_splat_topk_and_gradients_match_jax(k):
    """Values and the d_depth / d_feat gradients against jax.vjp of the JAX sparse
    splat, f32, within 1e-5 + 1e-5 |x| (the order of the f32 sums differs)."""
    geometry, (Dg, h, w) = _geometry(11)
    rng = np.random.RandomState(12)
    depth = rng.dirichlet(np.ones(Dg) * 0.5, (2, 3, h, w)).astype(np.float32)
    depth[0, 0, :2] = 0.25                     # ties at the k-th value
    feat = rng.randn(2, 3, h, w, 16).astype(np.float32)
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    g = rng.randn(2, 32, 32, 16).astype(np.float32)

    want, vjp = jax.vjp(lambda d, f: JLS.lift_splat_topk(d, f, jnp.asarray(geometry), k,
                                                         res, start, dim),
                        jnp.asarray(depth), jnp.asarray(feat))
    want_grads = vjp(jnp.asarray(g))
    dt, ft = (torch.from_numpy(a).requires_grad_() for a in (depth, feat))
    out = LS.lift_splat_topk(dt, ft, torch.from_numpy(geometry), k, res, start, dim)
    got_grads = torch.autograd.grad(out, (dt, ft), torch.from_numpy(g))
    assert float(np.abs(np.asarray(want)).sum()) > 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, a, b in zip(('d_depth', 'd_feat'), got_grads, want_grads):
        assert float(np.abs(np.asarray(b)).max()) > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_lift_splat_topk_at_full_k_is_the_dense_splat():
    geometry, (Dg, h, w) = _geometry(13)
    rng = np.random.RandomState(14)
    depth = torch.softmax(torch.from_numpy(rng.randn(2, 3, h, w, Dg).astype(np.float32)), -1)
    feat = torch.from_numpy(rng.randn(2, 3, h, w, 16).astype(np.float32))
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    geom = torch.from_numpy(geometry)
    sparse = LS.lift_splat_topk(depth, feat, geom, Dg, res, start, dim)
    dense = LS.lift_splat_depth(depth, feat, geom, res, start, dim)
    torch.testing.assert_close(sparse, dense, rtol=1e-6, atol=1e-6)


def test_topk_select_checks_its_inputs():
    depth = torch.rand(2, 6)
    ids = torch.zeros(2, 6, dtype=torch.int32)
    for k in (0, 7):
        with pytest.raises(ValueError, match='k'):
            LS.topk_select(depth, ids, k)
    with pytest.raises(ValueError, match='shaped'):
        LS.topk_select(depth, ids[:, :5], 2)
    with pytest.raises(ValueError, match='uint8'):
        LS.topk_select_backward(torch.rand(2, 3), torch.zeros(2, 3, dtype=torch.int64), 6)
