"""The instance-centre selection of kernel K6 (csrc/instance_centers.cu), in Python,
against the JAX package's ``find_instance_centers`` (CPU).

A score is a positive peak value or -inf, so lax.top_k's order is: the peaks by
value descending, ties by lowest pixel index, then the lowest-index pixels that
are not peaks. ``rule`` is that statement; ``cluster_rule`` is the kernel's way to
it, step by step: strips of ceil(h / 8) rows, each strip's peaks in pixel order,
a radix descent over the peaks whose histograms are summed strip by strip, each
strip's share of the ties at the k-th key, the selected pairs gathered in any
order and sorted, and the padding slots from each strip's non-peak ranks. Both
must give JAX's centres and valid flags on random heatmaps, frames without a peak,
a flat plateau (every pixel a peak, all tied), ties at the k-th slot and few
peaks, at k = 1, 100 and 1024.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fiery_tpu.postprocess import instance as JI

NB = 8           # the kernel's blocks a frame (one cluster), a strip each


def peak_keys(heat, thr, nms):
    """Each pixel's order key: a peak's f32 bits with the sign bit set, 0 for the
    rest (score -inf), flattened."""
    h, w = heat.shape
    x = np.where(heat >= thr, heat, np.float32(-1.0)).astype(np.float32)
    p = (nms - 1) // 2
    padded = np.pad(x, p, constant_values=-np.inf)
    pooled = np.full_like(x, -np.inf)
    for di in range(nms):
        for dj in range(nms):
            pooled = np.maximum(pooled, padded[di:di + h, dj:dj + w])
    peak = (x == pooled) & (x > 0)
    return np.where(peak, x.view(np.uint32) | np.uint32(0x80000000), 0).astype(
        np.uint32).reshape(-1)


def _out(idx, n_valid, w):
    idx = np.asarray(idx, np.int64)
    centers = np.stack([idx // w, idx % w], -1).astype(np.int32)
    return centers, np.arange(len(idx)) < n_valid


def rule(heat, thr, nms, k):
    """Peaks by value descending (lowest index first among equals), then the
    lowest-index non-peaks."""
    keys = peak_keys(heat, thr, nms)
    peaks = np.flatnonzero(keys)
    peaks = peaks[np.lexsort((peaks, -keys[peaks].astype(np.int64)))]
    rest = np.flatnonzero(keys == 0)
    return _out(np.concatenate([peaks, rest])[:k], min(len(peaks), k), heat.shape[1])


def cluster_rule(heat, thr, nms, k, push_order=None):
    """The kernel's selection, strip by strip (see the module docstring); the
    selected pairs reach block 0 in ``push_order`` of the strips."""
    h, w = heat.shape
    keys = peak_keys(heat, thr, nms)
    rows = -(-h // NB)
    firsts = [min(h, r * rows) * w for r in range(NB)]
    strips = [np.arange(firsts[r], min(h, r * rows + rows) * w) for r in range(NB)]
    plists = [s[keys[s] != 0] for s in strips]                 # peaks in pixel order
    counts = [len(pl) for pl in plists]
    n = sum(counts)
    kth, take = 0, [0] * NB
    if n > k:
        prefix, mask, want = 0, 0, k
        for level in range(4):
            shift = 24 - 8 * level
            hists = []
            for pl in plists:
                kk = keys[pl].astype(np.int64)
                kk = kk[(kk & mask) == prefix]
                hists.append(np.bincount((kk >> shift) & 255, minlength=256))
            total = np.sum(hists, axis=0)                     # the strips in rank order
            ge = np.cumsum(total[::-1])                         # digits >= 255 - t
            t = int(np.argmax(ge >= want))
            digit = 255 - t
            prefix |= digit << shift
            mask |= 255 << shift
            want -= int(ge[t] - total[digit])
        kth = prefix
        ties = [int(hist[kth & 255]) for hist in hists]
        take = [want - sum(ties[:r]) for r in range(NB)]
    selected = []
    for r in (push_order or range(NB)):
        pix = plists[r]
        kk = keys[pix].astype(np.int64)
        if n > k:
            tie_rank = np.cumsum(kk == kth) - 1
            sel = (kk > kth) | ((kk == kth) & (tie_rank < take[r]))
        else:
            sel = np.ones(len(pix), bool)
        selected += [((~int(key) & 0xffffffff) << 32) | int(i)
                     for key, i in zip(kk[sel], pix[sel])]
    assert len(selected) == min(n, k)
    idx = [s & 0xffffffff for s in sorted(selected)]
    if n < k:
        slots = {}
        for r in range(NB):
            before = firsts[r] - sum(counts[:r])                # non-peaks in earlier strips
            nonpeak = strips[r][keys[strips[r]] == 0]
            for rank, p in enumerate(nonpeak):
                if before + rank < k - n:
                    slots[n + before + rank] = int(p)
        idx += [slots[s] for s in range(n, k)]
    return _out(idx, min(n, k), w)


def heatmap(case, h, w, seed):
    rng = np.random.RandomState(seed)
    if case == 'random':
        return rng.rand(h, w).astype(np.float32)
    if case == 'no peak':                                        # every score -inf
        return (rng.rand(h, w) * 0.09).astype(np.float32)
    if case == 'plateau':                                        # every pixel a peak
        return np.full((h, w), 0.5, np.float32)
    if case == 'ties':                                           # 3 levels of 4 x 4 plateaus
        coarse = rng.rand(-(-h // 4), -(-w // 4))
        return (np.floor(np.kron(coarse, np.ones((4, 4))) * 3) / 3 + 0.05)[:h, :w].astype(
            np.float32)
    if case == 'few peaks':
        x = rng.rand(h, w) * (rng.rand(h, w) < 0.01)
        return x.astype(np.float32)
    raise ValueError(case)


CASES = ['random', 'no peak', 'plateau', 'ties', 'few peaks']


@pytest.mark.parametrize('k', [1, 100, 1024])
@pytest.mark.parametrize('case', CASES)
def test_rules_equal_jax(case, k):
    h, w = 40, 48
    heat = heatmap(case, h, w, seed=len(case) + k)
    want_c, want_v = (np.asarray(a) for a in JI.find_instance_centers(
        jnp.asarray(heat), 0.1, 3, k))
    for got_c, got_v in (rule(heat, 0.1, 3, k), cluster_rule(heat, 0.1, 3, k),
                         cluster_rule(heat, 0.1, 3, k, push_order=range(NB - 1, -1, -1))):
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_v, want_v)


@pytest.mark.parametrize('hw,k,nms', [((33, 20), 100, 3), ((5, 30), 100, 3),
                                      ((40, 48), 100, 5)])
def test_cluster_rule_on_odd_grids_and_windows(hw, k, nms):
    """Strips of unequal heights (33 rows: 5 a strip, the last 3), strips with no
    rows (5 rows), and a 5 x 5 NMS window."""
    heat = heatmap('ties', *hw, seed=hw[0])
    want_c, want_v = (np.asarray(a) for a in JI.find_instance_centers(
        jnp.asarray(heat), 0.1, nms, k))
    for got_c, got_v in (rule(heat, 0.1, nms, k), cluster_rule(heat, 0.1, nms, k)):
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_v, want_v)
