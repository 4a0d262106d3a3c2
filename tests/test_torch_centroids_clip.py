"""K8 over a whole clip, on the CPU: the batched centroid plain version against the
per-frame one, and the device tracker (one K8 launch a request: every frame's
per-id centroids at once, each step scattering the previous frame's through its
id map) against the JAX package's device tracker on random clips where instances
vanish, appear and take fresh ids, and on a planted scene. Ids must be equal. The
kernel against its plain version on the card: tests/test_torch_decode_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.postprocess import instance as JI
from fiery_tpu_torch.postprocess import instance as I
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize('num_slots', [7, 101])
def test_clip_plain_equals_per_frame_plain(num_slots):
    """Both kinds of centroid of every frame equal ``segment_centroids_plain`` per
    frame in every bit, and valid is the same; ids outside [0, num_slots) drop."""
    rng = np.random.RandomState(num_slots)
    labels = t(rng.randint(-2, num_slots + 3, size=(5, 23, 31)).astype(np.int32))
    flow = t((rng.randn(5, 23, 31, 2) * 5).astype(np.float32))
    grid, adv, valid = I.segment_centroids_clip(labels, num_slots, flow)
    assert grid.shape == adv.shape == (5, num_slots, 2) and valid.shape == (5, num_slots)
    for f in range(5):
        g1, v1 = I.segment_centroids_plain(labels[f:f + 1], num_slots)
        a1, v2 = I.segment_centroids_plain(labels[f:f + 1], num_slots, flow[f:f + 1])
        assert torch.equal(grid[f].view(torch.int32), g1[0].view(torch.int32))
        assert torch.equal(adv[f].view(torch.int32), a1[0].view(torch.int32))
        assert torch.equal(valid[f], v1[0]) and torch.equal(valid[f], v2[0])


def random_clip(rng, s=5, h=40, w=40):
    """Boxes moving at integer velocities, each present in a random run of frames (so
    some vanish and some appear later), drawn in a random order each frame (some
    overlap) and numbered 1.. per frame in a random order; the flow carries each box."""
    n = rng.randint(4, 12)
    start = rng.randint(4, h - 10, size=(n, 2))
    vel = rng.randint(-3, 4, size=(n, 2))
    first = rng.randint(0, s, n)
    last = np.minimum(s - 1, first + rng.randint(0, s, n))
    pred = np.zeros((s, h, w), np.int32)
    flow = np.zeros((s, h, w, 2), np.float32)
    for f in range(s):
        live = [k for k in rng.permutation(n) if first[k] <= f <= last[k]]
        for local, k in enumerate(live, start=1):
            x, y = np.clip(start[k] + vel[k] * f, 0, [h - 4, w - 5])
            pred[f, x:x + 4, y:y + 5] = local
            flow[f, x:x + 4, y:y + 5] = vel[k]
    # ids must stay consecutive per frame after overlaps
    for f in range(s):
        ids = np.unique(pred[f])
        pred[f] = np.searchsorted(ids, pred[f])
    return pred, flow


def planted_clip(s=5, h=64, w=64, n=8, seed=3):
    """n vehicles (5 x 3 px) at seeded integer velocities, the flow carrying each
    from frame to frame; per-frame ids in a shuffled order. Returns (ids, flow, gt)."""
    rng = np.random.RandomState(seed)
    paths = []
    while len(paths) < n:
        p, v = rng.randint(4, h - 12, 2), rng.randint(-2, 3, 2)
        path = np.stack([p + v * f for f in range(s)])
        if path.min() < 1 or (path + [5, 3]).max() > min(h, w) - 1:
            continue
        if all(np.abs(path - q).max(1).min() >= 8 for q in paths):
            paths.append(path)
    pred = np.zeros((s, h, w), np.int32)
    gt = np.zeros((s, h, w), np.int32)
    flow = np.zeros((s, h, w, 2), np.float32)
    for f in range(s):
        for local, k in enumerate(rng.permutation(n), start=1):
            r, c = paths[k][f]
            pred[f, r:r + 5, c:c + 3] = local
            gt[f, r:r + 5, c:c + 3] = k + 1
            flow[f, r:r + 5, c:c + 3] = paths[k][1] - paths[k][0]
    return pred, flow, gt


def jax_tracker(pred, flow):
    """The JAX package's device tracker over a batch of clips, under a fresh jit."""
    fn = jax.jit(jax.vmap(JI.make_instance_id_temporally_consistent_device))
    return np.asarray(fn(jnp.asarray(pred), jnp.asarray(flow)))


def test_device_tracker_equals_jax_on_random_clips():
    rng = np.random.RandomState(0)
    clips = [random_clip(rng) for _ in range(6)]
    pred = np.stack([c[0] for c in clips])
    flow = np.stack([c[1] for c in clips])
    want = jax_tracker(pred, flow)
    launches = I.segment_centroids.launches
    got = I.make_instance_id_temporally_consistent_device(t(pred), t(flow))
    assert I.segment_centroids.launches == launches   # the CPU takes the plain versions
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # fresh ids were handed out beyond frame 0's, and some ids vanished
    assert int(got.max()) > int(pred[:, 0].max())
    assert any(len(np.unique(got[b, -1])) < len(np.unique(got[b])) for b in range(6))


def test_device_tracker_follows_a_planted_scene_as_jax_does():
    pred, flow, gt = planted_clip()
    want = jax_tracker(pred[None], flow[None])[0]
    got = I.make_instance_id_temporally_consistent_device(t(pred)[None], t(flow)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)
    ids = got.numpy()
    for k in range(1, int(gt.max()) + 1):
        assert len(np.unique(ids[gt == k])) == 1
    assert len({int(np.unique(ids[gt == k])[0]) for k in range(1, int(gt.max()) + 1)}) == 8
    assert (ids[gt == 0] == 0).all()


def test_single_frame_clip_needs_no_centroids():
    pred = t(np.random.RandomState(1).randint(0, 3, (2, 1, 8, 8)).astype(np.int32))
    got = I.make_instance_id_temporally_consistent_device(pred, torch.zeros(2, 1, 8, 8, 2))
    assert torch.equal(got, pred)
