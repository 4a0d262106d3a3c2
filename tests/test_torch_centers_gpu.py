"""On the card: the instance-centre kernel (K6) against its plain version, equal,
on the heatmaps tests/test_torch_centers_rule.py holds the selection rule to JAX
with (random, no peak, a flat plateau, ties at the k-th slot, few peaks), at
k = 1, 100 and 1024, on 5 frames of 200 x 200, 400 x 200 and 320 x 193, one launch
a call for every frame; a 5 x 5 window; two calls equal; a frame larger than the
kernel's shared memory refused. Every test needs a CUDA device and skips without
one.

The file imports nothing of JAX, so that it runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_centers_gpu.py
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.postprocess import instance as I

pytestmark = pytest.mark.gpu

CASES = ['random', 'no peak', 'plateau', 'ties', 'few peaks']


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def heatmaps(case, T, h, w, seed):
    """T frames of the named kind (tests/test_torch_centers_rule.py ``heatmap``)."""
    rng = np.random.RandomState(seed)
    if case == 'random':
        x = rng.rand(T, h, w)
    elif case == 'no peak':
        x = rng.rand(T, h, w) * 0.09
    elif case == 'plateau':
        x = np.full((T, h, w), 0.5)
    elif case == 'ties':
        coarse = rng.rand(T, -(-h // 4), -(-w // 4))
        x = (np.floor(np.kron(coarse, np.ones((1, 4, 4))) * 3) / 3 + 0.05)[:, :h, :w]
    elif case == 'few peaks':
        x = rng.rand(T, h, w) * (rng.rand(T, h, w) < 0.0005)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize('k', [1, 100, 1024])
@pytest.mark.parametrize('hw', [(200, 200), (400, 200), (320, 193)],
                         ids=['200x200', '400x200', '320x193'])
@pytest.mark.parametrize('case', CASES)
def test_centers_kernel_equals_plain(cuda, case, hw, k):
    center = heatmaps(case, 5, *hw, seed=hw[0] + k).to(cuda)
    launches = I.find_instance_centers.launches
    got_c, got_v = I.find_instance_centers(center, max_instances=k)
    assert I.find_instance_centers.launches == launches + 1
    want_c, want_v = I.find_instance_centers_plain(center, max_instances=k)
    assert torch.equal(got_c, want_c) and torch.equal(got_v, want_v)


def test_centers_kernel_window_5_and_two_calls(cuda):
    center = heatmaps('ties', 5, 200, 200, seed=3).to(cuda)
    got = I.find_instance_centers(center, nms_kernel_size=5)
    again = I.find_instance_centers(center, nms_kernel_size=5)
    want = I.find_instance_centers_plain(center, nms_kernel_size=5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_centers_kernel_refuses_a_frame_beyond_its_shared_memory(cuda):
    assert I._centers_shared_bytes(200, 200, 1) == 4 * (25 * 200 + 27 * 202)
    assert I._centers_shared_bytes(4000, 4000, 1) == 0
    with pytest.raises(ValueError, match='shared memory'):
        I.find_instance_centers(torch.zeros((1, 4000, 4000), device=cuda))
