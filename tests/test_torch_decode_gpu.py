"""On the card: the decode and tracking kernels (K6-K9) against their plain versions
at the served shapes, and the device tracker without a host synchronisation. Every
test needs a CUDA device and skips without one.

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


@pytest.mark.parametrize('num_slots', [101, 501])
def test_segment_centroids_kernel_within_one_ulp(cuda, num_slots):
    """K8 within one f32 ulp of its plain version (f64 sums in another order)."""
    rng = np.random.RandomState(num_slots)
    labels = torch.from_numpy(rng.randint(0, num_slots, size=(2, 200, 200)).astype(
        np.int32)).to(cuda)
    flow = torch.from_numpy((rng.randn(2, 200, 200, 2) * 3).astype(np.float32)).to(cuda)
    for f in (None, flow):
        c_k, v_k = I.segment_centroids(labels, num_slots, f)
        c_p, v_p = I.segment_centroids_plain(labels, num_slots, f)
        assert torch.equal(v_k, v_p)
        spacing = torch.nextafter(c_p.abs(), torch.full_like(c_p, float('inf'))) - c_p.abs()
        assert bool(((c_k - c_p).abs() <= spacing).all())


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


def test_device_tracking_never_waits_on_the_host(cuda):
    out = serve_shaped_outputs(13, cuda)
    torch.cuda.set_sync_debug_mode('error')
    try:
        ids = device_consistent(out)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert ids.shape == (1, 5, 200, 200) and ids.dtype == torch.int32
    assert int(ids.min()) == 0 and int(ids.max()) > 100
