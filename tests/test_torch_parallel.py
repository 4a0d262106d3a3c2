"""Data-parallel pieces of the port on the CPU, at world size 2 (gloo ranks in
fresh processes, tests/torch_parallel_worker.py) against one process on the whole
input: K10's synchronised statistics (ops/batch_norm.py's plain versions, every
epilogue, 4-D and 5-D), the masked loss's global denominator, the metric states'
sum. No JAX: the reference is the port's own unsynchronised path.

Held: the batch statistics within one f32 ulp of one process's on the
concatenated input and equal on both ranks bit for bit; y within 1e-5 and dx, the
residual's gradient and the ranks' summed parameter gradients within relative L2
1e-4 (tests/test_torch_batchnorm.py's f32 tolerances); the running statistics
within 1e-6 relative. A group of one rank gives the unsynchronised path's bits
exactly, in f32 and bf16. The card's kernels are held to these plain versions in
tests/test_torch_parallel_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from fiery_tpu_torch.ops.batch_norm import POSTS
from fiery_tpu_torch.training.losses import spatial_regression_loss
from fiery_tpu_torch.training.metrics import IntersectionOverUnion, PanopticMetric
from torch_parallel_worker import (bn_inputs, bn_run, loss_inputs, metric_inputs, rows_of,
                                   spawn_ranks)
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

WORLD = 2


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return spawn_ranks('bn', tmp_path_factory.mktemp('bn'), WORLD)


def rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def within_ulp(got, want):
    """|got - want| <= one f32 ulp of want, elementwise."""
    spacing = np.spacing(np.abs(want.numpy()).astype(np.float32))
    return bool((np.abs(got.numpy() - want.numpy()) <= spacing).all())


@pytest.mark.parametrize('dims', [4, 5])
@pytest.mark.parametrize('post', POSTS)
def test_synchronised_batchnorm_equals_one_process(ranks, dims, post):
    x, res, dy, w, b, rm, rv = bn_inputs(dims, post)
    want = bn_run(x, res, dy, w, b, rm, rv, post, None)
    got = [r['world'][dims, post] for r in ranks]
    for k in ('mean', 'var', 'clamp', 'running_mean', 'running_var'):
        assert torch.equal(got[0][k], got[1][k]), k
    assert within_ulp(got[0]['mean'], want['mean'])
    assert within_ulp(got[0]['var'], want['var'])
    assert torch.equal(got[0]['clamp'], want['clamp'])
    for k in ('running_mean', 'running_var'):
        np.testing.assert_allclose(got[0][k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g['y'], rows_of(want['y'], r, WORLD), rtol=1e-5, atol=1e-5)
        assert rel_l2(g['dx'], rows_of(want['dx'], r, WORLD)) <= 1e-4
        if res is not None:
            assert rel_l2(g['dres'], rows_of(want['dres'], r, WORLD)) <= 1e-4
    for k in ('dweight', 'dbias'):
        assert rel_l2(got[0][k] + got[1][k], want[k]) <= 1e-4, k
    # each rank's own sums, not the global ones (DDP averages them)
    assert rel_l2(got[0]['dweight'], want['dweight']) > 1e-2


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('dims', [4, 5])
@pytest.mark.parametrize('post', POSTS)
def test_group_of_one_rank_gives_the_unsynchronised_bits(ranks, dims, post, dtype):
    for r in ranks:
        alone, fused = r['alone'][dims, post, dtype], r['fused'][dims, post, dtype]
        for k, v in fused.items():
            assert (v is None) == (alone[k] is None), k
            if v is not None:
                assert alone[k].dtype == v.dtype and torch.equal(alone[k], v), k


def test_masked_loss_takes_the_global_count(ranks):
    """The ranks hold 90% and 10% valid pixels: the mean of their values is the
    global batch's loss, and each rank's gradient is W times the global one on its
    rows (DDP's average then gives the global gradient); the mean of per-rank
    ratios would miss by far."""
    pred, target = loss_inputs()
    pred = pred.clone().requires_grad_(True)
    want = spatial_regression_loss(pred, target, norm=1, future_discount=0.9)
    want.backward()
    got = torch.stack([r['loss'] for r in ranks])
    np.testing.assert_allclose(float(got.mean()), float(want.detach()), rtol=1e-6)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r['loss_grad'] / WORLD, rows_of(pred.grad, rank, WORLD),
                                   rtol=1e-6, atol=1e-12)
    per_rank = [float(spatial_regression_loss(rows_of(pred.detach(), rank, WORLD),
                                              rows_of(target, rank, WORLD), norm=1,
                                              future_discount=0.9)) for rank in range(WORLD)]
    assert abs(np.mean(per_rank) - float(want.detach())) > 1e-2 * abs(float(want.detach()))


def test_metric_states_are_summed_over_the_ranks(ranks):
    seg_pred, seg_true, ids_pred, ids_true = metric_inputs()
    iou, panoptic = IntersectionOverUnion(2), PanopticMetric(2)
    iou.update(seg_pred, seg_true)
    panoptic.update(ids_pred, ids_true)
    for r in ranks:
        np.testing.assert_array_equal(r['iou_state'], iou.state())
        np.testing.assert_allclose(r['panoptic_state'], panoptic.state(), rtol=1e-12)
        assert float(r['panoptic_state'][1].sum()) > 0
