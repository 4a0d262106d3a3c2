"""The splat's order stage (K1, fiery_tpu_torch.ops.lift_splat.bev_pool_order_plain)
and the arithmetic of its pool, on the CPU.

The K1 forward kernel buckets the in-grid rows by voxel in ascending row order and
sums each bucket in that order. ``ordered_sum`` below repeats that arithmetic on
the host (f32 products, then f32 adds in list order, the z voxels of a cell added
in order): it must equal ``bev_pool_plain`` (the outer product and index_add_) bit
for bit at Z = 1, and the JAX package's ``lift_splat`` within the splat tests'
tolerance. Inputs are made with numpy from fixed seeds.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiery_tpu.ops import lift_splat as JLS
from fiery_tpu_torch.ops import lift_splat as LS
from fiery_tpu_torch.utils.geometry import calculate_birds_eye_view_parameters
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

FINAL_DIM, DOWNSAMPLE, D_BOUND = (64, 96), 8, (2.0, 8.0, 1.0)
BOUNDS = ((-8.0, 8.0, 0.5), (-8.0, 8.0, 0.5), (-10.0, 10.0, 20.0))


def _geometry(rng, b=2, n=3):
    """(b, n, D, h, w, 3) ego-frame points of cameras looking outwards at 1.6 m with
    a little random jitter (the rig of tests/test_torch_lift_splat.py)."""
    H, W = FINAL_DIM
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    intr = np.broadcast_to(K, (b, n, 3, 3)).copy()
    extr = np.zeros((b, n, 4, 4), np.float32)
    for i in range(b):
        for j in range(n):
            yaw = 2 * np.pi * j / n + rng.uniform(-0.1, 0.1)
            c, s = np.cos(yaw), np.sin(yaw)
            extr[i, j, :3, :3] = [[-s, 0, c], [c, 0, s], [0, -1, 0]]
            extr[i, j, :3, 3] = [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), 1.6]
            extr[i, j, 3, 3] = 1.0
    frustum = JLS.create_frustum(FINAL_DIM, DOWNSAMPLE, D_BOUND)
    return np.array(JLS.get_geometry(jnp.asarray(frustum), jnp.asarray(intr),
                                     jnp.asarray(extr))), frustum.shape[:3]


def ordered_sum(depth, feat, ids, num_bins, z_bins=1):
    """The K1 pool's arithmetic: every bucket of bev_pool_order_plain summed from 0
    in its order, one f32 add a row, then the z_bins voxels of a cell in order."""
    order, offsets = LS.bev_pool_order_plain(ids, num_bins, z_bins)
    S, D, C = depth.shape[0], depth.shape[-1], feat.shape[-1]
    order = order.long()
    prod = depth.reshape(-1).float()[order][:, None] * feat.reshape(-1, C).float()[order // D]
    start, counts = offsets[:-1].long(), (offsets[1:] - offsets[:-1]).long()
    acc = torch.zeros((S * num_bins, C), dtype=torch.float32)
    for j in range(int(counts.max())):
        live = counts > j
        acc[live] = acc[live] + prod[start[live] + j]
    acc = acc.view(S, num_bins // z_bins, z_bins, C)
    out = acc[:, :, 0]
    for z in range(1, z_bins):
        out = out + acc[:, :, z]
    return out.to(depth.dtype)


def _ids(case, rng, shape, num_bins):
    """Voxel ids of one adversarial case: random with dumped rows, a voxel of its own
    for every row, every row in one voxel, every row dumped."""
    n = int(np.prod(shape))
    if case == 'random':
        ids = rng.randint(0, num_bins + 1, n)
    elif case == 'ones':
        ids = rng.permutation(num_bins)[:n]
    elif case == 'one bucket':
        ids = np.full(n, 7)
    else:
        ids = np.full(n, num_bins)
    return torch.from_numpy(ids.reshape(shape).astype(np.int32))


def test_order_plain_is_a_stable_argsort_by_key():
    rng = np.random.RandomState(0)
    S, N, h, w, D, num_bins = 2, 3, 4, 5, 6, 50
    ids = rng.randint(0, num_bins + 1, (S, N, h, w, D)).astype(np.int32)
    order, offsets = LS.bev_pool_order_plain(torch.from_numpy(ids), num_bins)
    flat = ids.reshape(S, -1)
    keys = (flat + np.arange(S)[:, None] * num_bins).reshape(-1)
    rows = np.arange(keys.size)
    valid = flat.reshape(-1) < num_bins
    want = rows[valid][np.argsort(keys[valid], kind='stable')]
    assert order.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want)
    counts = np.bincount(keys[valid], minlength=S * num_bins)
    np.testing.assert_array_equal(offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    # ascending rows within every key
    for k in range(S * num_bins):
        seg = order.numpy()[offsets[k]:offsets[k + 1]]
        assert (np.diff(seg) > 0).all()
    with pytest.raises(ValueError):
        LS.bev_pool_order_plain(torch.from_numpy(ids), num_bins, z_bins=7)
    # a CPU tensor takes the plain version
    got = LS.bev_pool_order(torch.from_numpy(ids), num_bins)
    assert all(torch.equal(a, b) for a, b in zip(got, (order, offsets)))


@pytest.mark.parametrize('case', ['random', 'ones', 'one bucket', 'all dumped'])
@pytest.mark.parametrize('D', [8, 48])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ordered_sum_equals_plain_bit_for_bit(case, D, dtype):
    """Z = 1: the pool's order gives index_add_'s bits, in f32 and in bf16."""
    rng = np.random.RandomState(1)
    S, N, h, w, C = 2, 2, 3, 4, 16
    num_bins = 2 * N * h * w * D
    ids = _ids(case, rng, (S, N, h, w, D), num_bins)
    depth = torch.softmax(torch.from_numpy(rng.randn(S, N, h, w, D).astype(np.float32)),
                          -1).to(dtype)
    feat = torch.from_numpy(rng.randn(S, N, h, w, C).astype(np.float32)).to(dtype)
    want = LS.bev_pool_plain(depth, feat, ids, num_bins)
    got = ordered_sum(depth, feat, ids, num_bins)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    if case == 'all dumped':
        assert float(want.float().abs().sum()) == 0.0
    else:
        assert float(want.float().abs().sum()) > 0.0


def test_ordered_sum_with_two_z_bins_is_within_1e_6():
    rng = np.random.RandomState(2)
    S, N, h, w, D, C, num_bins, z = 2, 2, 3, 4, 8, 16, 60, 2
    ids = torch.from_numpy(rng.randint(0, num_bins + 1, (S, N, h, w, D)).astype(np.int32))
    depth = torch.softmax(torch.from_numpy(rng.randn(S, N, h, w, D).astype(np.float32)), -1)
    feat = torch.from_numpy(rng.randn(S, N, h, w, C).astype(np.float32))
    want = LS.bev_pool_plain(depth, feat, ids, num_bins, z)
    got = ordered_sum(depth, feat, ids, num_bins, z)
    assert got.shape == want.shape == (S, num_bins // z, C)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_ordered_splat_matches_jax_lift_splat():
    """lift_splat_depth's inputs through the pool's arithmetic against the JAX
    package's lift_splat of the lifted volume (the splat tests' 1e-5)."""
    rng = np.random.RandomState(3)
    geometry, (D, h, w) = _geometry(rng)
    head = rng.randn(2 * 3, h, w, D + 16).astype(np.float32)
    res, start, dim = calculate_birds_eye_view_parameters(*BOUNDS)
    vol = np.asarray(JLS.depth_feature_outer_product(jnp.asarray(head), D, 16))
    want = np.asarray(JLS.lift_splat(jnp.asarray(vol.reshape(2, 3, h, w, D, 16)),
                                     jnp.asarray(geometry), res, start, dim))
    depth = torch.softmax(torch.from_numpy(head[..., :D]), dim=-1).view(2, 3, h, w, D)
    feat = torch.from_numpy(head[..., D:]).view(2, 3, h, w, 16)
    ids = LS.voxel_ids(torch.from_numpy(geometry), res, start, dim).permute(0, 1, 3, 4, 2)
    X, Y, Z = (int(d) for d in dim)
    got = ordered_sum(depth, feat, ids.contiguous(), X * Y * Z, Z).view(2, X, Y, 16)
    assert float(np.abs(want).sum()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        LS.lift_splat_depth(depth, feat, torch.from_numpy(geometry), res, start, dim), got,
        rtol=0, atol=0)


def test_scan_tile_matches_the_kernel_source():
    """The wrapper finds a key's offset as base[key // _SCAN_TILE] + local[key]: the
    tile must be the kernel's (threads x items of its scan blocks)."""
    src = open(os.path.join(os.path.dirname(LS.__file__), '..', 'csrc', 'bev_pool.cu')).read()
    threads = int(re.search(r'constexpr int kThreads = (\d+);', src).group(1))
    items = int(re.search(r'constexpr int kScanItems = (\d+);', src).group(1))
    assert threads * items == LS._SCAN_TILE
