"""On the card: the pixel grouping and relabel kernel (K7, csrc/group_pixels.cu)
against its plain version, equal in every value, one launch a call for every frame:
the served heads' centres from K6 (random heads, 3-level plateaus); planted
near-ties (pixels on the bisector of their two nearest centres: distances equal, or
one f32 ulp apart); K = 1, 100 and 1,024; a frame with no valid centre and one with
no foreground; non-finite offsets and logits; centres in a band of rows or of
columns; 200 x 200, 400 x 200 and 320 x 193 grids; C = 2 and 3 logits; two calls equal; the shared-memory bound and a frame
beyond it refused. tests/test_torch_group_rule.py holds the kernel's plan to the JAX
package on the CPU. Every test needs a CUDA device and skips without one. The file
imports nothing of JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_group_gpu.py
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.postprocess import instance as I

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def random_frames(rng, B, h, w, K, C, device):
    """Centres at random pixels (80 % valid), offsets of 4 pixels' spread, logits."""
    centers = np.stack([rng.randint(0, h, (B, K)), rng.randint(0, w, (B, K))], -1)
    valid = rng.rand(B, K) < 0.8
    offset = rng.randn(B, h, w, 2) * 4.0
    logits = rng.randn(B, h, w, C)
    return (torch.from_numpy(centers.astype(np.int32)).to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(offset.astype(np.float32)).to(device),
            torch.from_numpy(logits.astype(np.float32)).to(device))


def near_ties(rng, B, h, w, K, C, device):
    """tests/test_torch_group_rule.py ``near_ties`` on the card: each pixel moved onto
    the bisector of its two nearest valid centres, a third to their midpoint, a third
    to the bisector's nearest point, a third there and one ulp along a row."""
    centers, valid, offset, logits = random_frames(rng, B, h, w, K, C, device)
    grid = torch.stack(torch.meshgrid(torch.arange(h, device=device),
                                      torch.arange(w, device=device), indexing='ij'), -1)
    p = grid[None].double() + offset.double()
    c = centers.double()
    d = ((c[:, :, None, None] - p[:, None]) ** 2).sum(-1)
    d[~valid] = float('inf')
    two = torch.sort(d, dim=1, stable=True).indices[:, :2]
    del d
    frames = torch.arange(B, device=device)[:, None, None]
    a, b = c[frames, two[:, 0]], c[frames, two[:, 1]]
    mid = (a + b) / 2
    u = b - a
    u = u / u.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    onto = p - ((p - mid) * u).sum(-1, keepdim=True) * u
    kind = torch.from_numpy(rng.randint(0, 3, (B, h, w))).to(device)
    q = torch.where((kind == 0)[..., None], mid, onto).float()
    step = torch.where(torch.from_numpy(rng.rand(B, h, w) < 0.5).to(device),
                       float('inf'), float('-inf'))
    q[..., 0] = torch.where(kind == 2, torch.nextafter(q[..., 0], step), q[..., 0])
    return centers, valid, (q - grid.float()).contiguous(), logits


def assert_ids_equal(centers, valid, offset, logits):
    launches = I.instance_ids.launches
    got = I.instance_ids(centers, valid, offset, logits)
    assert I.instance_ids.launches == launches + 1
    want = I.instance_ids_plain(centers, valid, offset, logits)
    assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want), f'{int((got != want).sum())} pixels differ'
    return got


CASES = [
    ('random', 100, (200, 200), 2), ('random', 1, (200, 200), 2),
    ('random', 1024, (200, 200), 3), ('random', 100, (400, 200), 3),
    ('random', 100, (320, 193), 2), ('random', 1024, (320, 193), 2),
    ('near ties', 100, (200, 200), 2), ('near ties', 1024, (200, 200), 2),
    ('near ties', 100, (320, 193), 3), ('no valid centre', 100, (200, 200), 2),
    ('no foreground', 100, (200, 200), 3), ('non-finite', 100, (200, 200), 2),
    ('band of rows', 100, (200, 200), 2), ('band of columns', 100, (320, 193), 2),
]


@pytest.mark.parametrize('case,K,hw,C', CASES,
                         ids=[f'{c}-K{k}-{h}x{w}-C{n}' for c, k, (h, w), n in CASES])
def test_ids_kernel_equals_plain(cuda, case, K, hw, C):
    rng = np.random.RandomState(K + hw[0] + C + len(case))
    B = 5
    make = near_ties if case == 'near ties' else random_frames
    centers, valid, offset, logits = make(rng, B, *hw, K, C, cuda)
    if case == 'band of rows':       # as random weights place them: the walk runs along columns
        centers[..., 0] = torch.from_numpy(rng.randint(0, 3, (B, K))).to(cuda)
    if case == 'band of columns':
        centers[..., 1] = torch.from_numpy(rng.randint(190, 193, (B, K))).to(cuda)
    if case == 'no valid centre':
        valid[0] = False
    if case == 'no foreground':
        logits[0, ..., 1] = logits[0].min() - 1.0
    if case == 'non-finite':
        offset[0, 3, :10, 0] = float('nan')
        offset[0, 4, :10, 1] = float('inf')
        offset[1, 5, :10, 0] = float('-inf')
        offset[1, 6, :5] = 3e38
        logits[0, 7, :10, 0] = float('nan')
        logits[1, 8, :10, 1] = float('nan')
        valid[1, 0] = False
    got = assert_ids_equal(centers, valid, offset, logits)
    if case in ('no valid centre', 'no foreground'):
        assert not got[0].any() and got[1].any()


@pytest.mark.parametrize('hw', [(200, 200), (400, 200), (320, 193)],
                         ids=['200x200', '400x200', '320x193'])
@pytest.mark.parametrize('heat', ['random', 'plateaus'])
def test_ids_kernel_on_k6_centres(cuda, heat, hw):
    """The decode's own inputs: K6's centres (100 slots) on random heatmaps or 3-level
    plateaus, with random offsets and 2-class logits; two calls the same."""
    rng = np.random.RandomState(hw[1])
    h, w = hw
    x = rng.rand(5, h, w)
    if heat == 'plateaus':
        coarse = rng.rand(5, -(-h // 8), -(-w // 8))
        x = (np.floor(np.kron(coarse, np.ones((1, 8, 8))) * 3) / 3 + 0.05)[:, :h, :w]
    centers, valid = I.find_instance_centers(torch.from_numpy(x.astype(np.float32)).to(cuda))
    _, _, offset, logits = random_frames(rng, 5, h, w, 100, 2, cuda)
    got = assert_ids_equal(centers, valid, offset, logits)
    assert torch.equal(got, I.instance_ids(centers, valid, offset, logits))


def test_ids_kernel_shared_bound(cuda):
    """The bound: 4 bytes a pixel of a block's ceil(h / 16) rows, at most 25,600
    pixels, so every frame K6 takes (its strips of ceil(h / 8) rows at most as
    large); larger frames refused."""
    assert I._group_shared_bytes(200, 200) == 4 * 13 * 200
    assert I._group_shared_bytes(2048, 200) == 4 * 128 * 200
    assert I._group_shared_bytes(2064, 200) == 0
    for h, w in ((200, 200), (400, 200), (320, 193), (1000, 200)):
        assert I._centers_shared_bytes(h, w, 1) and I._group_shared_bytes(h, w)
    centers = torch.zeros((1, 4, 2), dtype=torch.int32, device=cuda)
    valid = torch.ones((1, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match='shared memory'):
        I.instance_ids(centers, valid, torch.zeros((1, 2000, 2000, 2), device=cuda),
                       torch.zeros((1, 2000, 2000, 2), device=cuda))


def test_ids_kernel_many_frames(cuda):
    """30 frames in one launch: more clusters of 16 blocks than the card runs at once."""
    rng = np.random.RandomState(30)
    assert_ids_equal(*random_frames(rng, 30, 200, 200, 100, 2, cuda))
