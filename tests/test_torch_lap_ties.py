"""K9's plain version (fiery_tpu_torch.ops.lap) against the JAX solver
(fiery_tpu.ops.lap.linear_sum_assignment, through a fresh jax.jit) and scipy's
optimum on costs whose minima tie often: small integers, all rows or the first
n_rows of them. And the rule past the JAX solver's contract (finite costs): a
row whose search meets no finite reduced cost stays unassigned. The kernel
against the plain version on the card: tests/test_torch_decode_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from fiery_tpu.ops.lap import linear_sum_assignment as jax_lsa
from fiery_tpu_torch.ops import lap as L
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


def jax_col4row(cost, n_rows):
    return np.asarray(jax.jit(lambda c, r: jax_lsa(c, n_rows=r))(
        jnp.asarray(cost), jnp.int32(n_rows)))


@pytest.mark.parametrize('n,n_rows,levels', [(17, 17, 3), (64, 20, 4), (101, 8, 5),
                                             (101, 101, 5)])
def test_plain_equals_jax_on_integer_costs(n, n_rows, levels):
    """Costs drawn from {0, .., levels - 1}: most steps meet tied minima, where an
    unassigned column wins, then the lowest index. col4row equal to JAX's; the
    augmented rows' total equal to scipy's optimum of those rows; the other rows
    -1."""
    rng = np.random.RandomState(n + n_rows)
    cost = rng.randint(0, levels, (n, n)).astype(np.float32)
    rows = torch.tensor([n_rows], dtype=torch.int32)
    got = L.linear_sum_assignment(torch.from_numpy(cost)[None], rows)[0].numpy()
    np.testing.assert_array_equal(got, jax_col4row(cost, n_rows))
    live = got[:n_rows]
    assert (got[n_rows:] == -1).all() and len(set(live.tolist())) == n_rows
    r, c = scipy.optimize.linear_sum_assignment(cost[:n_rows])
    assert cost[np.arange(n_rows), live].sum() == cost[r, c].sum()


def test_rows_without_a_finite_path_stay_unassigned():
    """A row of NaN, and a row whose only finite column another such row holds:
    each stays -1; the other rows take the optimum of the finite rest."""
    rng = np.random.RandomState(0)
    cost = rng.randint(0, 4, (9, 9)).astype(np.float32)
    cost[[2, 6]] = np.inf
    cost[[2, 6], 0] = 1.0                # rows 2 and 6 can only take column 0
    cost[5] = np.nan
    got = L.linear_sum_assignment(torch.from_numpy(cost)[None])[0].numpy()
    assert got[5] == got[6] == -1 and got[2] == 0
    rest = [0, 1, 2, 3, 4, 7, 8]
    r, c = scipy.optimize.linear_sum_assignment(cost[rest])
    assert cost[rest, got[rest]].sum() == cost[rest][r, c].sum()
    assert len(set(got[rest].tolist())) == len(rest)
