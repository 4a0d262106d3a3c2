"""K2 backward as a gather, on the CPU: a vectorised PyTorch emulation of the kernel
(csrc/bev_warp.cu ``warp_gather_kernel``) against ``bev_warp_backward_plain`` bit
for bit, f32 and bf16, at angles across [-pi, pi], translations that push the map
partly and wholly out, and 200 x 200, 400 x 200 and 320 x 193 grids.

The kernel gives each 16 x 16 tile of input pixels the output pixels of its region
(``gather_regions`` below, a copy of the kernel's arithmetic), lists them by sample cell in
ascending order, and sums for each input pixel the lists of its four tap cells,
k = 0..3, in that order. The emulation keeps only the taps whose output pixel lies in
the region of its input pixel's tile and adds them in that order (index_add_ of each
tap in ascending output pixel). It must keep every valid tap of every output pixel
that lands in the map: that is the proof on the CPU that the region misses no
contribution. The kernel itself against the plain version on the card, and its
staging bound against ``gather_region_entries`` below:
tests/test_torch_train_gpu.py.
"""

import math

import numpy as np
import pytest
import torch

from fiery_tpu_torch.ops import warp as W
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

EXTENT = (50.0, 50.0)
# the kernel's tile side and the most output pixels a block stages
# (csrc/bev_warp.cu GT and GATHER_MAX_ENTRIES)
T = 16
GATHER_MAX_ENTRIES = 6900


def _margins(H, Wd, dtype):
    """The region's margins in input pixels: the grid's rounding to the dtype (half
    an ulp of |gx| < 2: 2^-8 in bf16, none in f32) times W/2 or H/2, plus 2^-12 of
    W/2 or H/2 for the f32 error of the forward's arithmetic."""
    hu = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    return 0.5 * Wd * (hu + 2.0 ** -12), 0.5 * H * (hu + 2.0 ** -12)


def gather_region_entries(H, Wd, dtype):
    """The staging a block needs (csrc/bev_warp.cu ``gather_entries``): a region's
    area bounded over every pose. The region is at most 2 r + 3 wide, r = |P|
    (half-widths): the rounded |cos|, |sin| are at most 1 and the map's determinant
    cos^2 + sin^2 after rounding at least (1 - 2^-8)^2."""
    ex, ey = _margins(H, Wd, dtype)
    s = (1 + 2.0 ** -8) / (1 - 2.0 ** -8) ** 2
    hx, hy = (T + 1) / 2 + ex, (T + 1) / 2 + ey
    rj, ri = s * (hx + hy * Wd / H), s * (hx * H / Wd + hy)
    return math.ceil(2 * rj + 3) * math.ceil(2 * ri + 3)


def gather_regions(pose, shape, dtype, spatial_extent):
    """Each 16 x 16 tile's region, computed as the kernel computes it
    (csrc/bev_warp.cu ``tile_region``, every f64 operation in the same order):
    (i0, i1, j0, j1), each (B, tiles down, tiles across) int64, empty where i0 > i1
    or j0 > j1. The region holds every output pixel one of whose taps lands in the
    tile: those sample in cells [tx0 - 1, tx0 + 15] x [ty0 - 1, ty0 + 15], so before
    the grid's rounding within the margins of the square
    [tx0 - 1, tx0 + 16) x [ty0 - 1, ty0 + 16) of sample points, and the map from
    output pixel centres to sample points is
        [ix + 0.5 - kx; iy + 0.5 - ky] = [[t00, t01 W/H], [t10 H/W, t11]]
                                          [j + 0.5 - W/2; i + 0.5 - H/2],
    kx = (W/2)(t02 + 1), ky = (H/2)(t12 + 1), with the rounded theta; the region is
    the bounding box of the square's preimage, one pixel wider each way."""
    B, H, Wd = shape[:3]
    th = W._warp_theta(pose.float(), spatial_extent, dtype).float().double()
    t00, t01, t02 = th[:, 0, 0, None, None], th[:, 0, 1, None, None], th[:, 0, 2, None, None]
    t10, t11, t12 = th[:, 1, 0, None, None], th[:, 1, 1, None, None], th[:, 1, 2, None, None]
    b, c = t01 * Wd / H, t10 * H / Wd
    det = t00 * t11 - b * c
    p00, p01, p10, p11 = t11 / det, -b / det, -c / det, t00 / det
    kx, ky = 0.5 * Wd * (t02 + 1.0), 0.5 * H * (t12 + 1.0)
    ex, ey = _margins(H, Wd, dtype)
    hx, hy = 0.5 * (T + 1) + ex, 0.5 * (T + 1) + ey
    ty0 = torch.arange(0, H, T, dtype=torch.float64)[:, None]
    tx0 = torch.arange(0, Wd, T, dtype=torch.float64)[None, :]
    xc, yc = (tx0 + T // 2) - kx, (ty0 + T // 2) - ky
    jc = p00 * xc + p01 * yc + (0.5 * Wd - 0.5)
    ic = p10 * xc + p11 * yc + (0.5 * H - 0.5)
    rj = p00.abs() * hx + p01.abs() * hy
    ri = p10.abs() * hx + p11.abs() * hy
    j0 = (torch.ceil(jc - rj) - 1.0).clamp_min(0.0)
    j1 = (torch.floor(jc + rj) + 1.0).clamp_max(Wd - 1.0)
    i0 = (torch.ceil(ic - ri) - 1.0).clamp_min(0.0)
    i1 = (torch.floor(ic + ri) + 1.0).clamp_max(H - 1.0)
    empty = (j0 > j1) | (i0 > i1)

    def fix(lo, hi):
        return torch.where(empty, 0.0, lo).long(), torch.where(empty, -1.0, hi).long()

    (i0, i1), (j0, j1) = fix(i0, i1), fix(j0, j1)
    return i0, i1, j0, j1


def poses(seed, n=6):
    """Angles spread over [-pi, pi] (both ends included), translations of 0-2 m,
    one pose that pushes the map half out and one that pushes it wholly out."""
    rng = np.random.RandomState(seed)
    flow = np.zeros((n, 6), np.float32)
    flow[:, 5] = np.linspace(-math.pi, math.pi, n) + rng.uniform(-0.05, 0.05, n)
    flow[0, 5], flow[-1, 5] = -math.pi, math.pi
    flow[:, 0] = rng.uniform(-2, 2, n)
    flow[:, 1] = rng.uniform(-2, 2, n)
    flow[1, :2] = (27.0, -13.0)          # about half the map out
    flow[2, :2] = (-130.0, 0.0)          # the whole map out
    return torch.from_numpy(flow)


def emulate_gather(g, pose, extent):
    """The kernel's sums: (dx in g's dtype, taps kept, taps of the forward that land
    in the map)."""
    B, H, Wd, C = g.shape
    ix, iy = W._sample_coords(pose, g.shape, g.dtype, extent)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - x0, iy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    i0, i1, j0, j1 = gather_regions(pose, g.shape, g.dtype, extent)
    bi = torch.arange(B)[:, None, None]
    oi = torch.arange(H)[None, :, None].expand(B, H, Wd)
    oj = torch.arange(Wd)[None, None, :].expand(B, H, Wd)
    gf = g.float().reshape(-1, C)
    dx = torch.zeros((B * H * Wd, C), dtype=torch.float32)
    kept = landing = 0
    for k in range(4):
        px, py = x0 + (k & 1), y0 + (k >> 1)
        lands = (px >= 0) & (px < Wd) & (py >= 0) & (py < H)
        pxl, pyl = px.clamp(0, Wd - 1).long(), py.clamp(0, H - 1).long()
        ty, tx = pyl // T, pxl // T
        inside = ((oi >= i0[bi, ty, tx]) & (oi <= i1[bi, ty, tx])
                  & (oj >= j0[bi, ty, tx]) & (oj <= j1[bi, ty, tx]))
        keep = (lands & inside).reshape(-1)
        w = ((wx1 if k & 1 else wx0) * (wy1 if k >> 1 else wy0)).reshape(-1)
        rows = ((bi * H + pyl) * Wd + pxl).reshape(-1)
        dx.index_add_(0, rows[keep], gf[keep] * w[keep, None])
        kept += int(keep.sum())
        landing += int(lands.sum())
    return dx.view(B, H, Wd, C).to(g.dtype), kept, landing


def same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hw', [(200, 200), (400, 200), (320, 193)],
                         ids=['200x200', '400x200', '320x193'])
def test_gather_order_equals_plain_bit_for_bit(hw, dtype):
    H, Wd = hw
    pose = poses(H + Wd)
    g = torch.from_numpy(np.random.RandomState(H).randn(6, H, Wd, 2).astype(np.float32)).to(dtype)
    got, kept, landing = emulate_gather(g, pose, EXTENT)
    want = W.bev_warp_backward_plain(g, pose, EXTENT)
    assert kept == landing > 0
    assert same_bits(got, want)
    assert float(want[2].abs().max()) == 0.0       # the pose that leaves the map
    assert float(want[1].abs().max()) > 0.0


@pytest.mark.parametrize('hw,dtype', [((200, 200), torch.bfloat16), ((400, 200), torch.bfloat16),
                                      ((320, 193), torch.float32), ((193, 320), torch.bfloat16)],
                         ids=['200x200', '400x200', '320x193-f32', '193x320'])
def test_region_areas_stay_within_the_staging_bound(hw, dtype):
    """Over 721 angles (every quarter degree) and translations that move the map by up
    to twice its extent, no tile's region is larger than the staging the wrapper
    sizes from the shapes alone, and a region is a few tiles' worth of pixels."""
    H, Wd = hw
    n = 721
    pose = torch.zeros((n, 6))
    pose[:, 5] = torch.linspace(-math.pi, math.pi, n)
    pose[:, :2] = torch.from_numpy(np.random.RandomState(0).uniform(-100, 100, (n, 2)))
    i0, i1, j0, j1 = gather_regions(pose, (n, H, Wd), dtype, EXTENT)
    area = (i1 - i0 + 1).clamp_min(0) * (j1 - j0 + 1).clamp_min(0)
    bound = gather_region_entries(H, Wd, dtype)
    assert int(area.max()) <= bound <= GATHER_MAX_ENTRIES
    assert int(area.max()) >= T * T


def test_card_theta_needs_a_card_tensor():
    """theta as the kernels compute it comes only from the card."""
    with pytest.raises(ValueError, match='CUDA'):
        W.card_theta(poses(0), EXTENT, torch.float32)
