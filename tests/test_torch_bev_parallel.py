"""The BEV spatial axis's row layers on the CPU, in f64: three gloo ranks
(tests/torch_parallel_worker.py case ``rows``) hold the shares of
``row_plan(40, M)``, M = 3 (16, 16 and 8 rows) and M = 2 (ranks 0 and 1: 24 and
16 rows), and run each kind of layer that reads rows across a share's edge inside
``bev_rows``: the 3x3 convolution, the 7x7 stride-2 and the 1x1 stride-2
convolutions, the causal (2, 3, 3) Conv3d, ``causal_max_pool3d``, the bilinear x2
upsample (``upsample_rows``), the pyramid pooling's ``group_row_mean`` and
``gather_rows``. Each rank's output rows equal the layer's on the whole grid, and
its input gradient under the whole output gradient's rows equals the whole grid's
input gradient on its rows, within 1e-12 (for the row mean and the gather, whose
output every rank holds whole, under a gradient of each rank's own: the sum of the
ranks' whole-grid input gradients). K10's synchronised plain statistics over the
uneven shares equal the whole grid's within 1e-6 relative (f32). The plan refuses a
share that would be empty, and the exchange a share thinner than the halo it
lends, on every rank. No JAX."""

import pytest
import torch

from fiery_tpu_torch.parallel.mesh import RowShare, row_plan
from torch_parallel_worker import ROWS_KINDS, ROWS_X, spawn_ranks, seeded_trainer, tiny_cfg
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return spawn_ranks('rows', tmp_path_factory.mktemp('rows'), 3, timeout=300)


@pytest.mark.parametrize('shares', [3, 2])
@pytest.mark.parametrize('kind', ROWS_KINDS)
def test_row_layers_equal_the_whole_grid(ranks, shares, kind):
    results = [r[shares, kind] for r in ranks[:shares]]
    edges = row_plan(ROWS_X, shares)
    assert [b - a for a, b in zip(edges, edges[1:])] == \
        {3: [16, 16, 8], 2: [24, 16]}[shares]
    replicated = kind in ('row_mean', 'gather')
    total_grad = sum(r['whole_grad'] for r in results)
    for r in results:
        lo, hi = r['rows']
        whole_rows, in_rows = r['whole'].shape[-2], r['whole_grad'].shape[-2]
        if replicated:
            want_out, want_grad = r['whole'], total_grad[..., lo:hi, :]
        else:
            scale = whole_rows // in_rows if whole_rows >= in_rows else None
            olo, ohi = ((lo * scale, hi * scale) if scale else
                        (lo * whole_rows // in_rows, -(-hi * whole_rows // in_rows)))
            want_out, want_grad = r['whole'][..., olo:ohi, :], r['whole_grad'][..., lo:hi, :]
        assert r['out'].shape == want_out.shape
        torch.testing.assert_close(r['out'], want_out, rtol=0, atol=1e-12)
        torch.testing.assert_close(r['grad'], want_grad, rtol=0, atol=1e-12)


@pytest.mark.parametrize('shares', [3, 2])
def test_synchronised_statistics_weigh_uneven_shares_by_their_rows(ranks, shares):
    for r in ranks[:shares]:
        (mean, var), (smean, svar) = r[shares, 'bn']['whole'], r[shares, 'bn']['sync']
        torch.testing.assert_close(smean, mean, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(svar, var, rtol=1e-6, atol=0)


def test_empty_and_thin_shares_are_refused(ranks):
    for r in ranks:
        assert r['refused']['empty'] == '16 BEV rows hold 2 blocks of 8: share 2 of 3 ' \
            'would be empty'
        assert r['refused']['thin'].startswith('share 0 of the rows (0, 2, 24, 40) holds 2 '
                                               'rows')
    with pytest.raises(ValueError, match='not a multiple'):
        row_plan(36, 2)
    with pytest.raises(ValueError, match='no level of 5 rows'):
        RowShare(None, 0, row_plan(200, 2)).level(5)


def test_row_plan_of_the_baseline_grid():
    """200 rows in 2 shares: 104 + 96, and at the decoder's levels 52 + 48,
    26 + 24, 13 + 12, each share the full share over the level's stride."""
    edges = row_plan(200, 2)
    assert edges == (0, 104, 200)
    for m, rows in enumerate((104, 96)):
        share = RowShare(None, m, edges)
        for s in (1, 2, 4, 8):
            start, stop, total = share.level(rows // s)
            assert (start, stop, total) == (edges[m] // s, edges[m + 1] // s, 200 // s)
        assert share.counts(rows // 8) == [13, 12]
    assert row_plan(200, 3) == (0, 72, 136, 200)
    assert row_plan(200, 25)[-2:] == (192, 200)


def test_the_axis_needs_a_camera_group():
    from fiery_tpu_torch.parallel.mesh import make_parallel_trainer
    with pytest.raises(ValueError, match='needs cameras > 1'):
        make_parallel_trainer(seeded_trainer(tiny_cfg()), cameras=1, bev_parallel=True)
    assert row_plan(8, 1) == (0, 8)
