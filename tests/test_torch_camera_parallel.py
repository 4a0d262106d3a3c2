"""The camera axis of the port's mesh on the CPU (parallel/mesh.py), without JAX:
``gather_cameras`` on two gloo ranks in f64 (tests/torch_parallel_worker.py), whose
forward is the concatenation of the ranks' cameras and whose backward is its
adjoint, held against autograd of the one-process concatenation under a gradient
that differs by rank (equal to the last bit: a sum of two f64 values is the same
in any order); the mesh's coordinates and groups; the refusal of a camera count
that divides neither the ranks nor the cameras; ``rank_rows``'s choice of a
rank's images from the global batch's per-image draw; and the model's refusal of
a share of the cameras outside a camera group.
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.parallel.mesh import rank_rows
from fiery_tpu_torch.training.trainer import Trainer
from torch_parallel_worker import TINY_CAM, gather_inputs, global_batch, spawn_ranks, tiny_cfg
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

WORLD = 2


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return spawn_ranks('gather', tmp_path_factory.mktemp('gather'), WORLD, timeout=300)


def test_gather_forward_is_the_concatenation_of_the_cameras(ranks):
    x, _ = gather_inputs(WORLD)
    for r in ranks:
        assert r['out'].dtype == torch.float64
        assert torch.equal(r['out'], x)


def test_gather_backward_is_the_adjoint(ranks):
    """Each rank's input gradient is its slice of the sum over the ranks of their
    gradients with respect to the gathered tensor: autograd of one process that
    concatenates the ranks' inputs and sums the ranks' losses."""
    x, grads = gather_inputs(WORLD)
    n = x.shape[1] // WORLD
    parts = [x[:, r * n:(r + 1) * n].clone().requires_grad_(True) for r in range(WORLD)]
    whole = torch.cat(parts, dim=1)
    sum((whole * g).sum() for g in grads).backward()
    for r, got in enumerate(ranks):
        assert torch.equal(got['grad'], parts[r].grad), r
        # not the rank's own slice alone, nor that slice times the ranks
        assert not torch.equal(got['grad'], grads[r][:, r * n:(r + 1) * n])


def test_mesh_of_one_data_shard_of_two_camera_ranks(ranks):
    for r, got in enumerate(ranks):
        # (data rank, data shards, camera rank, cameras, data group size, camera group size)
        assert got['mesh'] == (0, 1, r, WORLD, 1, WORLD)


def test_uneven_camera_splits_raise(ranks):
    for got in ranks:
        assert sorted(got['refused']) == ['cameras', 'ranks']
        assert f'must divide the {WORLD} ranks' in got['refused']['ranks']
        assert 'must divide the 1 cameras' in got['refused']['cameras']


@pytest.mark.parametrize('shards,cameras,b,s,n_cameras', [
    (1, 2, 1, 3, 2), (2, 2, 2, 3, 2), (2, 3, 2, 2, 6), (3, 2, 1, 2, 4), (1, 6, 2, 3, 6)])
def test_rank_rows_picks_the_ranks_images(shards, cameras, b, s, n_cameras):
    """A per-image draw of the global batch, (shard, sample, frame, camera) with the
    camera minor: each rank keeps its shard's images of its cameras, in the order
    its encoder holds them, and the ranks together keep every image once."""
    n = n_cameras // cameras
    t = torch.arange(shards * b * s * n_cameras)
    grid = t.reshape(shards, b, s, n_cameras)
    seen = []
    for d in range(shards):
        for m in range(cameras):
            got = rank_rows(t, b * s * n, d, m, cameras, per_frame=n)
            assert torch.equal(got, grid[d, :, :, m * n:(m + 1) * n].reshape(-1)), (d, m)
            seen.append(got)
    assert torch.equal(torch.cat(seen).sort().values, t)
    # without per_frame: the data shard's contiguous block, as before
    assert torch.equal(rank_rows(t, b * s * n_cameras, shards - 1),
                       grid[shards - 1].reshape(-1))


def test_model_refuses_a_share_of_the_cameras_outside_a_camera_group():
    """In training without a camera group, images of 1 of the 2 cameras raise; no
    gather is made up."""
    cfg = tiny_cfg(TINY_CAM)
    trainer = Trainer(cfg, device='cpu')
    batch = {k: torch.as_tensor(v) for k, v in global_batch(cfg, n=1).items()}
    assert batch['image'].shape[2] == 2
    labels, fdi = trainer.prepare_future_labels(batch)
    with pytest.raises(ValueError, match='1 cameras encoded for the 2'):
        trainer.model(batch['image'][:, :, :1], batch['intrinsics'], batch['extrinsics'],
                      batch['future_egomotion'], fdi)
    losses = trainer.step_losses([batch[k] for k in ('image', 'intrinsics', 'extrinsics',
                                                     'future_egomotion')], fdi, labels)
    assert np.isfinite(float(losses['segmentation'].detach()))
