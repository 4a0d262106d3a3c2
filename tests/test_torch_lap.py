"""fiery_tpu_torch.ops.lap against fiery_tpu.ops.lap (the JAX Jonker-Volgenant solver)
and scipy's Hungarian optimum. The kernel against its plain version on the card:
tests/test_torch_decode_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from fiery_tpu.ops.lap import linear_sum_assignment as jax_lsa
from fiery_tpu_torch.ops import lap as L


def tracker_cost(rng, K, n_prev, n_cur):
    """A (K, K) cost padded as the tracker pads it: row 0 and column 0 invalid, live
    rows 1..n_prev and columns 1..n_cur, distances clipped at 30, invalid pairs 1e4.
    Half the current centres sit near a previous one, the rest anywhere."""
    prev = rng.uniform(0, 200, (K, 2)).astype(np.float32)
    cur = rng.uniform(0, 200, (K, 2)).astype(np.float32)
    near = rng.rand(K) < 0.5
    cur[near] = prev[rng.permutation(K)][near] + rng.randn(int(near.sum()), 2).astype(
        np.float32) * 2.0
    dist = np.sqrt(((prev[:, None] - cur[None]) ** 2).sum(-1)).astype(np.float32)
    valid = np.zeros((K, K), bool)
    valid[1:n_prev + 1, 1:n_cur + 1] = True
    return np.where(valid, np.minimum(dist, np.float32(30.0)), np.float32(1e4)).astype(
        np.float32)


def jax_col4row(cost, n_rows=None):
    if n_rows is None:
        return np.asarray(jax.jit(lambda c: jax_lsa(c))(jnp.asarray(cost)))
    return np.asarray(jax.jit(lambda c, r: jax_lsa(c, n_rows=r))(
        jnp.asarray(cost), jnp.int32(n_rows)))


def scipy_total(cost, n_rows):
    r, c = scipy.optimize.linear_sum_assignment(cost[:n_rows].astype(np.float64))
    return cost[r, c].astype(np.float64).sum()


@pytest.mark.parametrize('n', [1, 2, 5, 17, 32])
def test_plain_equals_jax_on_random_costs(n):
    """Unpadded random costs, all rows: the same col4row as the JAX solver."""
    rng = np.random.RandomState(n)
    cost = (rng.rand(n, n) * rng.choice([1.0, 100.0])).astype(np.float32)
    got = L.linear_sum_assignment(torch.from_numpy(cost)[None])[0].numpy()
    np.testing.assert_array_equal(got, jax_col4row(cost))
    assert sorted(got.tolist()) == list(range(n))
    np.testing.assert_allclose(cost[np.arange(n), got].astype(np.float64).sum(),
                               scipy_total(cost, n), rtol=0, atol=1e-4)


@pytest.mark.parametrize('K,n_prev,n_cur,use_n_rows', [
    (16, 5, 7, False), (16, 5, 7, True), (41, 12, 9, True), (41, 30, 35, False),
    (101, 1, 3, True), (101, 7, 8, True), (101, 40, 38, True)])
def test_plain_equals_jax_on_tracker_costs(K, n_prev, n_cur, use_n_rows):
    """Padded tracker costs, with and without n_rows: col4row equal to JAX's; the
    live rows' total is scipy's optimum of the unpadded problem within 1e-4."""
    rng = np.random.RandomState(K + n_prev + n_cur)
    cost = tracker_cost(rng, K, n_prev, n_cur)
    n_rows = n_prev + 1 if use_n_rows else None
    rows = None if n_rows is None else torch.tensor([n_rows], dtype=torch.int32)
    got = L.linear_sum_assignment(torch.from_numpy(cost)[None], n_rows=rows)[0].numpy()
    np.testing.assert_array_equal(got, jax_col4row(cost, n_rows))
    live = np.arange(1, n_prev + 1)
    sub = cost[1:n_prev + 1, 1:n_cur + 1]
    total = cost[live, got[live]].astype(np.float64)
    total = np.where(total < 1e4, total, 0.0).sum()   # rows forced onto padding
    np.testing.assert_allclose(total, scipy_total(sub, n_prev), rtol=0, atol=1e-4)
    if use_n_rows:
        assert (got[n_rows:] == -1).all()


def test_batch_is_independent_problems():
    rng = np.random.RandomState(3)
    costs = np.stack([tracker_cost(rng, 24, n, 10) for n in (0, 4, 23)])
    rows = torch.tensor([1, 5, 24], dtype=torch.int32)
    got = L.linear_sum_assignment(torch.from_numpy(costs), n_rows=rows).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], jax_col4row(costs[b], int(rows[b])))


def test_plain_counts_steps_and_rejects_bad_shapes():
    L.linear_sum_assignment(torch.ones(2, 5, 5))
    assert L.linear_sum_assignment_plain.steps >= 10      # at least one step per row
    with pytest.raises(ValueError):
        L.linear_sum_assignment(torch.ones(4, 5))
    with pytest.raises(ValueError):
        L.linear_sum_assignment(torch.ones(1, 5, 5), n_rows=torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        L.linear_sum_assignment(torch.ones(1, 5, 5, device='meta'))
