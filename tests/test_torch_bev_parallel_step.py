"""The port's BEV-parallel training step on the CPU: gloo ranks
(tests/torch_parallel_worker.py case ``bev``, ``make_parallel_trainer(...,
cameras=2, bev_parallel=True)``) at (D data shards, M camera ranks) = (1, 2) and
(2, 2) on TINY_BEV (tests/test_torch_trainer.py's TINY on a 24 x 32 grid: the
shares are 16 and 8 rows, so K10's synchronised statistics, the halos and the row
gathers meet uneven shares), against the port's one process on the global batch (2
samples a data shard), with drop-connect on and the same step generator. Also, at
(1, 2), the camera step without the axis on the same ranks, with the row layers
made to raise: that path never enters them. The JAX-facing case (the ranks against the JAX
data-axis step) is tests/test_torch_camera_parallel_step.py's
``test_bev_ranks_take_the_jax_data_axis_step``, which reuses that file's JAX steps.

Tolerances are tests/test_torch_parallel_step.py's: losses and running statistics
1e-4 relative (1e-5 absolute); gradients as relative L2 errors, 1e-2 a top-level
module and 1e-1 a leaf; parameters within 2 lr; the Adam first moments as the
gradients. Every rank's parameters, statistics and moments are equal bit for bit.
"""

import numpy as np
import pytest

from fiery_tpu_torch.training.trainer import step_generator
from test_torch_camera_parallel_step import MESHES, assert_ranks_equal
from test_torch_parallel_step import assert_gradients_close, assert_step_close
from torch_parallel_worker import (STEP_SEED, TINY_BEV, global_batch, seeded_trainer,
                                   spawn_ranks, take_step, tiny_cfg)
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Each mesh's ranks' results, spawned when a test first asks for them."""
    spawned = {}

    def get(mesh):
        if mesh not in spawned:
            spawned[mesh] = spawn_ranks('bev', tmp_path_factory.mktemp(f'bev{mesh[0]}'),
                                        MESHES[mesh], timeout=400)
        return spawned[mesh]
    return get


@pytest.fixture(scope='module')
def one_process():
    """The port's one-process step on each mesh's global batch."""
    done = {}

    def get(shards):
        if shards not in done:
            cfg = tiny_cfg(TINY_BEV)
            trainer = seeded_trainer(cfg)
            names = [n for n, _ in trainer.model.named_parameters()] + \
                ['uncertainty.' + k for k in trainer.uncertainty]
            done[shards] = names, take_step(trainer, global_batch(cfg, n=2 * shards),
                                            step_generator(STEP_SEED, 0, 'cpu'))
        return done[shards]
    return get


@pytest.mark.parametrize('mesh,key', [((1, 2), 'drop'), ((1, 2), 'cameras'),
                                      ((2, 2), 'drop')])
def test_bev_ranks_take_the_one_process_step(ranks, one_process, mesh, key):
    """Drop-connect on, the step's generator: losses, gradients, running statistics,
    parameters and Adam moments of the global batch's step; every rank equal. 'drop'
    is the step with the BEV axis, 'cameras' the camera axis alone."""
    shards, cameras = mesh
    results = ranks(mesh)
    for r, got in enumerate(results):
        assert got['mesh'] == (r // cameras, shards, r % cameras, cameras)
        assert got['share'] == (r % cameras, (0, 16, 24))
    names, want = one_process(shards)
    got = [r[key] for r in results]
    assert_ranks_equal(got)
    np.testing.assert_allclose(float(got[0]['total']), float(want['total']), rtol=1e-4)
    assert_step_close(got[0], want, tiny_cfg(TINY_BEV).OPTIMIZER.LR, set(names))
    assert_gradients_close(got[0]['grads'], want['grads'])
    assert_gradients_close(dict(zip(names, got[0]['exp_avg'])),
                           dict(zip(names, want['exp_avg'])))


@pytest.mark.parametrize('mesh', sorted(MESHES))
def test_bev_batchnorm_groups(ranks, mesh):
    """The encoder's and the row-sharded modules' BatchNorms synchronise over the
    world, the distributions' over the data group."""
    shards, cameras = mesh
    groups = ranks(mesh)[0]['groups']
    for name, size in groups.items():
        top = name.split('.')[0]
        want = shards if top in ('present_distribution', 'future_distribution') \
            else shards * cameras
        assert size == want, name
    assert {n.split('.')[0] for n in groups} == {
        'encoder', 'temporal_model', 'present_distribution', 'future_distribution',
        'future_prediction', 'decoder'}
