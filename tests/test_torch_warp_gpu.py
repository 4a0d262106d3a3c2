"""On the card: the warp's forward kernels. K2 (bilinear) equal in every value to its
plain version on the host given the kernels' theta (``card_theta``), in f32 and
bf16, at 16 and 64 channels, on 200 x 200, 400 x 200 and 320 x 193 grids, at
small and wide poses, through each access width (16 bytes, and narrower when the
map starts off a 16-byte boundary); K4 (nearest) equal to its plain version on the
same grids. Every test needs a CUDA device and skips without one.

The file imports nothing of JAX, so that it runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_warp_gpu.py
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.ops import warp as W

pytestmark = pytest.mark.gpu

EXTENT = (50.0, 50.0)
GRIDS = [(200, 200), (400, 200), (320, 193)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _poses(seed, n=4):
    """Small ego-motions; from the third of four on, an angle of 2.5 rad half out
    of the map and one wholly out."""
    rng = np.random.RandomState(seed)
    flow = np.zeros((n, 6), np.float32)
    flow[:, 0] = rng.uniform(-3, 3, n)
    flow[:, 1] = rng.uniform(-3, 3, n)
    flow[:, 5] = rng.uniform(-0.3, 0.3, n)
    if n >= 4:
        flow[2] = (27.0, -13.0, 0.0, 0.0, 0.0, 2.5)
        flow[3] = (-130.0, 0.0, 0.0, 0.0, 0.0, -1.0)
    return torch.from_numpy(flow)


def _host(x, pose, cuda):
    """The plain version on the host given the kernels' theta."""
    theta = W.card_theta(pose.to(cuda), EXTENT, x.dtype).cpu()
    return W.bev_warp_plain(x, pose, EXTENT, theta=theta)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('C', [16, 64])
@pytest.mark.parametrize('hw', GRIDS, ids=['200x200', '400x200', '320x193'])
def test_bev_warp_equals_the_host_given_the_kernels_theta(cuda, hw, C, dtype):
    """Equal values (the plain version writes x * 0 outside the map, -0.0 for a
    negative x, the kernel +0.0), one launch."""
    H, Wd = hw
    x = torch.from_numpy(np.random.RandomState(H + Wd + C).randn(4, H, Wd, C).astype(
        np.float32)).to(dtype)
    pose = _poses(C)
    launches = W.bev_warp.launches
    got = W.bev_warp(x.to(cuda), pose.to(cuda), EXTENT)
    assert W.bev_warp.launches == launches + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got.cpu(), _host(x, pose, cuda))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('shift', [1, 2, 3])
def test_bev_warp_off_a_16_byte_boundary(cuda, shift, dtype):
    """A map whose first value lies ``shift`` values past a 16-byte boundary takes
    a narrower access (2 to 8 bytes) and computes the same values."""
    n = 2 * 200 * 200 * 64
    x = torch.from_numpy(np.random.RandomState(shift).randn(n + shift).astype(
        np.float32)).to(dtype)
    pose = _poses(shift, 2)
    xc = x.to(cuda)[shift:].view(2, 200, 200, 64)
    assert W.access_width(64, xc.element_size(), xc.data_ptr() & 15) < 16 // xc.element_size()
    got = W.bev_warp(xc, pose.to(cuda), EXTENT).cpu()
    assert torch.equal(got, _host(x[shift:].view(2, 200, 200, 64), pose, cuda))


@pytest.mark.parametrize('hw', GRIDS, ids=['200x200', '400x200', '320x193'])
def test_bev_warp_nearest_equals_plain(cuda, hw):
    """K4 on label stacks of 7 f32 channels (integer values and 255 ignore labels
    included): equal, not close, one launch."""
    H, Wd = hw
    rng = np.random.RandomState(H + Wd)
    x = rng.randn(6, H, Wd, 7).astype(np.float32)
    x[..., :2] = rng.randint(0, 3, (6, H, Wd, 2))
    x[..., 3:] = np.where(rng.rand(6, H, Wd, 1) < 0.7, 255.0, x[..., 3:])
    x = torch.from_numpy(x).to(cuda)
    pose = _poses(H, 6).to(cuda)
    launches = W.bev_warp_nearest.launches
    got = W.bev_warp_nearest(x, pose, EXTENT)
    assert W.bev_warp_nearest.launches == launches + 1
    assert torch.equal(got, W.bev_warp_nearest_plain(x, pose, EXTENT))
