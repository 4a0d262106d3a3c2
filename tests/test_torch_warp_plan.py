"""The launch plan of the warp's forward kernels (K2 bilinear, K4 nearest), as
ops/warp.py computes it in Python: the access width of each (channel count, dtype,
alignment), the lanes a pixel, the tile and the grid, that the blocks cover every
output value once, and what the wrapper hands the kernel. No card and no JAX: the
kernel's arguments are caught on 'meta' tensors.
"""

import pytest
import torch

from fiery_tpu_torch.ops import warp as W

BF16, F32 = 2, 4


@pytest.mark.parametrize('C,itemsize,align,V', [
    (64, BF16, 0, 8), (64, F32, 0, 4), (16, BF16, 0, 8), (16, F32, 0, 4),
    (7, F32, 0, 1), (7, BF16, 0, 1), (12, BF16, 0, 4), (6, F32, 0, 2),
    (64, BF16, 8, 4), (64, BF16, 4, 2), (64, BF16, 2, 1), (64, F32, 8, 2),
    (64, F32, 4, 1), (64, BF16, 6, 1)])
def test_access_width(C, itemsize, align, V):
    """16 bytes (8 bf16, 4 f32) when C and the addresses allow it; else the widest
    narrower access both allow, down to one value."""
    assert W.access_width(C, itemsize, align) == V


@pytest.mark.parametrize('itemsize,align', [(F32, 2), (F32, 6), (BF16, 1), (BF16, 3)])
def test_an_access_the_kernels_do_not_take_raises(itemsize, align):
    with pytest.raises(ValueError, match='accesses of whole'):
        W.access_width(64, itemsize, align)


@pytest.mark.parametrize('shape,itemsize,plan', [
    ((2, 200, 200, 64), BF16, (8, 3, 8, 25, 1250)),      # serve: 8 lanes a pixel
    ((6, 200, 200, 64), BF16, (8, 3, 8, 25, 3750)),      # the training step's past frames
    ((2, 200, 200, 64), F32, (4, 4, 8, 25, 1250)),       # 16 lanes
    ((6, 200, 200, 16), BF16, (8, 1, 16, 25, 1950)),     # 2 lanes, tiles of 8 x 16
    ((12, 200, 200, 7), F32, (1, 3, 8, 25, 7500)),       # K4's label stack, 7 of 8 lanes
    ((6, 400, 200, 64), BF16, (8, 3, 8, 25, 7500)),
    ((6, 320, 193, 64), F32, (4, 4, 8, 25, 6000)),
    ((1, 5, 3, 1), F32, (1, 0, 32, 1, 1)),               # 1 lane, tiles of 8 x 32
    ((1, 8, 8, 512), BF16, (8, 5, 8, 1, 1))])            # 64 accesses a pixel on 32 lanes
def test_plan_of_each_shape(shape, itemsize, plan):
    assert W.warp_plan(*shape, itemsize, 0) == plan


def test_maps_of_2_31_values_raise():
    with pytest.raises(ValueError, match='2\\^31'):
        W.warp_plan(1, 4096, 4096, 128, BF16, 0)


@pytest.mark.parametrize('shape,itemsize', [
    ((2, 20, 19, 64), BF16), ((1, 17, 9, 7), F32), ((2, 9, 33, 16), BF16),
    ((1, 13, 10, 512), BF16), ((1, 3, 5, 1), F32)])
def test_blocks_cover_every_output_value_once(shape, itemsize):
    """The kernel's walk, in Python: block -> map and tile, thread -> lane group and
    lane, pixel passes of the groups and access loops of the lanes."""
    B, H, Wd, C = shape
    V, log2g, tile_h, tiles_w, blocks = W.warp_plan(*shape, itemsize, 0)
    G, tiles_per_map = 1 << log2g, blocks // B
    seen = torch.zeros(shape, dtype=torch.int32)
    for block in range(blocks):
        b, tile = divmod(block, tiles_per_map)
        i0, j0 = (tile // tiles_w) * tile_h, (tile % tiles_w) * W.TILE_W
        for t in range(W.FWD_THREADS):
            lane = t & (G - 1)
            for m in range(t >> log2g, tile_h * W.TILE_W, W.FWD_THREADS >> log2g):
                i, j = i0 + m // W.TILE_W, j0 + m % W.TILE_W
                if i >= H or j >= Wd:
                    continue
                for q in range(lane, C // V, G):
                    seen[b, i, j, q * V:(q + 1) * V] += 1
    assert bool((seen == 1).all())


@pytest.fixture
def caught(monkeypatch):
    """The forward kernel's arguments, caught: the wrappers run their card path on
    'meta' tensors and each launch lands in the returned list; the counters are
    the test's own."""
    calls = []
    monkeypatch.setattr(W, '_kernel', lambda name: lambda *a: calls.append((name, a)) or 0)
    monkeypatch.setattr(W, '_check_card', lambda *a: None)
    monkeypatch.setattr(torch._C, '_cuda_getCurrentRawStream', lambda dev: 0, raising=False)
    monkeypatch.setattr(W.bev_warp, 'launches', 0)
    monkeypatch.setattr(W.bev_warp_nearest, 'launches', 0)
    return calls


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
def test_wrappers_hand_the_plan(caught, dtype):
    """bev_warp and bev_warp_nearest pass the shape, the extents' and the map's
    reciprocals, the dtype, the mode and the plan, and count one launch each; a
    map starting 2 values past a 16-byte boundary takes a narrower access."""
    x = torch.empty((6, 200, 200, 64), dtype=dtype, device='meta')
    pose = torch.empty((6, 6), device='meta')
    W.bev_warp(x, pose, (50.0, 25.0))
    W.bev_warp_nearest(x, pose, (50.0, 25.0))
    assert (W.bev_warp.launches, W.bev_warp_nearest.launches) == (1, 1)
    es = x.element_size()
    for (name, args), nearest in zip(caught, (0, 1)):
        assert name == 'fiery_bev_warp' and args[3:7] == (6, 200, 200, 64)
        assert args[7:11] == (1 / 50.0, 1 / 25.0, 1 / 200, 1 / 200)
        assert args[11:13] == (int(dtype == torch.bfloat16), nearest)
        assert args[13:18] == W.warp_plan(6, 200, 200, 64, es, 0)
    shifted = torch.empty(6 * 200 * 200 * 64 + 2, dtype=dtype, device='meta')[2:].view(
        6, 200, 200, 64)
    W.bev_warp(shifted, pose, (50.0, 25.0))
    assert caught[-1][1][13] == 2             # 4 bytes in (bf16), 8 bytes (f32)
