"""On the card: the decode and tracking kernels (K6-K9) against their plain versions
at the served shapes (K8 also over a whole clip, two calls with the same bits), the
device tracker's one K8 launch a request, and the tracker without a host
synchronisation. Every test needs a CUDA device and skips without one.

The file imports nothing of JAX, so that it runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_gpu.py
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.evaluate import device_consistent
from fiery_tpu_torch.ops import lap as L
from fiery_tpu_torch.postprocess import instance as I

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def serve_shaped_outputs(seed, device):
    """5 frames of 200 x 200 with dense random heads (every frame fills its 100
    centre slots); in every other frame the centre heatmap is quantised to 3 levels,
    so the 100th slot falls inside a tie."""
    rng = np.random.RandomState(seed)
    out = {'segmentation': rng.randn(1, 5, 200, 200, 2),
           'instance_center': rng.rand(1, 5, 200, 200, 1),
           'instance_offset': rng.randn(1, 5, 200, 200, 2) * 4.0,
           'instance_flow': rng.randn(1, 5, 200, 200, 2)}
    c = out['instance_center']
    c[:, ::2] = np.floor(c[:, ::2] * 3) / 3 + 0.05
    return {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in out.items()}


def tracker_cost(rng, K, n_live_rows, n_live_cols):
    """(K, K) cost padded as the tracker pads it: row 0 and column 0 invalid,
    distances clipped at 30, invalid pairs 1e4."""
    prev = rng.uniform(0, 200, (K, 2))
    cur = rng.uniform(0, 200, (K, 2))
    near = rng.rand(K) < 0.5
    cur[near] = prev[rng.permutation(K)][near] + rng.randn(int(near.sum()), 2) * 2.0
    dist = np.sqrt(((prev[:, None] - cur[None]) ** 2).sum(-1))
    valid = np.zeros((K, K), bool)
    valid[1:n_live_rows + 1, 1:n_live_cols + 1] = True
    return np.where(valid, np.minimum(dist, 30.0), 1e4).astype(np.float32)


@pytest.mark.parametrize('sparse', [False, True])
def test_centers_and_ids_kernels_equal_plain(cuda, sparse):
    """K6 and K7 equal their plain versions exactly (integer outputs). Sparse
    heatmaps have fewer than 100 peaks a frame: the -inf padding slots must take the
    lowest pixel indices, as lax.top_k gives them."""
    out = serve_shaped_outputs(12, cuda)
    center = out['instance_center'].reshape(5, 200, 200).contiguous()
    if sparse:
        g = torch.Generator(device=cuda).manual_seed(0)
        center = center * (torch.rand(center.shape, generator=g, device=cuda) < 0.001)
    launches = I.find_instance_centers.launches
    c_k, v_k = I.find_instance_centers(center)
    assert I.find_instance_centers.launches == launches + 1
    c_p, v_p = I.find_instance_centers_plain(center)
    assert bool(v_p.all()) != sparse
    assert torch.equal(c_k, c_p) and torch.equal(v_k, v_p)
    offset = out['instance_offset'].reshape(5, 200, 200, 2).contiguous()
    seg = out['segmentation'].reshape(5, 200, 200, 2).contiguous()
    launches = I.instance_ids.launches
    ids_k = I.instance_ids(c_p, v_p, offset, seg)
    assert I.instance_ids.launches == launches + 2
    assert torch.equal(ids_k, I.instance_ids_plain(c_p, v_p, offset, seg))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _within_one_ulp(got, want):
    spacing = torch.nextafter(want.abs(), torch.full_like(want, float('inf'))) - want.abs()
    return bool(((got - want).abs() <= spacing).all())


@pytest.mark.parametrize('num_slots', [101, 501])
def test_segment_centroids_kernel_within_one_ulp(cuda, num_slots):
    """K8 within one f32 ulp of its plain version (f64 sums in another, fixed order),
    with and without flow; the grid centres (integer sums) and valid equal; two calls
    give the same bits; one launch a call."""
    rng = np.random.RandomState(num_slots)
    labels = torch.from_numpy(rng.randint(0, num_slots, size=(2, 200, 200)).astype(
        np.int32)).to(cuda)
    flow = torch.from_numpy((rng.randn(2, 200, 200, 2) * 3).astype(np.float32)).to(cuda)
    for f in (None, flow):
        launches = I.segment_centroids.launches
        c_k, v_k = I.segment_centroids(labels, num_slots, f)
        assert I.segment_centroids.launches == launches + 1
        c_again, v_again = I.segment_centroids(labels, num_slots, f)
        c_p, v_p = I.segment_centroids_plain(labels, num_slots, f)
        assert torch.equal(v_k, v_p) and torch.equal(v_again, v_k)
        assert torch.equal(_bits(c_again), _bits(c_k))
        assert _within_one_ulp(c_k, c_p)
        if f is None:
            assert torch.equal(_bits(c_k), _bits(c_p))


@pytest.mark.parametrize('hw', [(200, 200), (33, 41)], ids=['200x200', '33x41'])
def test_segment_centroids_clip_kernel(cuda, hw):
    """The clip entry on decoded-like ids (runs of equal ids in rows, background, ids
    outside the slots): grid centres and valid equal to the plain version, flow
    centres within one f32 ulp, two calls the same bits, one launch for all frames.
    33 x 41 frames take the kernel's unaligned path."""
    h, w = hw
    rng = np.random.RandomState(h)
    ids = np.zeros((5, h, w), np.int32)
    for f in range(5):
        for k in range(1, 101):
            r, c = rng.randint(0, h - 3), rng.randint(0, w - 5)
            ids[f, r:r + 3, c:c + rng.randint(1, 6)] = k
    ids[:, 0, :3] = 150
    labels = torch.from_numpy(ids).to(cuda)
    flow = torch.from_numpy((rng.randn(5, h, w, 2) * 4).astype(np.float32)).to(cuda)
    launches = I.segment_centroids.launches
    grid, adv, valid = I.segment_centroids_clip(labels, 101, flow)
    assert I.segment_centroids.launches == launches + 1
    again = I.segment_centroids_clip(labels, 101, flow)
    want = I.segment_centroids_clip_plain(labels.cpu(), 101, flow.cpu())
    assert torch.equal(_bits(grid.cpu()), _bits(want[0]))
    assert _within_one_ulp(adv.cpu(), want[1])
    assert torch.equal(valid.cpu(), want[2])
    for a, b in zip(again, (grid, adv, valid)):
        assert torch.equal(_bits(a), _bits(b))


def test_tracker_launches_k8_once_a_request(cuda):
    """The device tracker takes every frame's centroids from one K8 launch."""
    out = serve_shaped_outputs(14, cuda)
    launches = I.segment_centroids.launches
    device_consistent(out)
    assert I.segment_centroids.launches == launches + 1


@pytest.mark.parametrize('n_rows', [1, 8, 101])
def test_lap_kernel_equals_plain(cuda, n_rows):
    """K9's col4row equals the plain version's exactly on tracker-padded 101 x 101
    costs; n_rows is read on the device."""
    rng = np.random.RandomState(n_rows)
    cost = torch.from_numpy(np.stack([tracker_cost(rng, 101, n_rows - 1, 60)
                                      for _ in range(3)]))
    rows = torch.full((3,), n_rows, dtype=torch.int32)
    want = L.linear_sum_assignment_plain(cost, rows)
    launches = L.linear_sum_assignment.launches
    got = L.linear_sum_assignment(cost.to(cuda), rows.to(cuda)).cpu()
    assert L.linear_sum_assignment.launches == launches + 1
    assert torch.equal(got, want)


def lap_problems(name):
    """(costs (B, n, n) f32, n_rows) of one K9 problem set beyond the tracker's:
    integer costs (ties in most steps), rows of non-finite costs, and the sizes
    that take the kernel's other paths (one and two columns a lane, a staged
    matrix above 48 KB, a matrix read from global memory, n = 1024)."""
    rng = np.random.RandomState(len(name))
    if name == 'integers':
        return rng.randint(0, 5, (3, 101, 101)).astype(np.float32), [1, 8, 101]
    if name == 'non-finite rows':
        cost = np.stack([tracker_cost(rng, 101, 40, 60) for _ in range(2)])
        cost[0, 3] = np.inf
        cost[1, 7] = np.nan
        cost[1, [9, 12]] = np.inf
        cost[1, [9, 12], 5] = 1.0
        return cost, [101, 101]
    n = {'n=17': 17, 'n=40': 40, 'n=200': 200, 'n=238': 238, 'n=1024': 1024}[name]
    return rng.rand(1, n, n).astype(np.float32), [n]


@pytest.mark.parametrize('name', ['integers', 'non-finite rows', 'n=17', 'n=40', 'n=200',
                                  'n=238', 'n=1024'])
def test_lap_kernel_equals_plain_on_every_problem_set(cuda, name):
    """K9's col4row equals the plain version's (on the CPU) exactly."""
    cost, n_rows = lap_problems(name)
    cost = torch.from_numpy(cost)
    rows = torch.tensor(n_rows, dtype=torch.int32)
    want = L.linear_sum_assignment_plain(cost, rows)
    got = L.linear_sum_assignment(cost.to(cuda), rows.to(cuda)).cpu()
    assert torch.equal(got, want)
    if name == 'non-finite rows':
        assert got[0, 3] == got[1, 7] == got[1, 12] == -1


def test_device_tracking_never_waits_on_the_host(cuda):
    out = serve_shaped_outputs(13, cuda)
    torch.cuda.set_sync_debug_mode('error')
    try:
        ids = device_consistent(out)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert ids.shape == (1, 5, 200, 200) and ids.dtype == torch.int32
    assert int(ids.min()) == 0 and int(ids.max()) > 100
