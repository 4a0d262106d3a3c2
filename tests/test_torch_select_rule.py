"""The selection rules of the top-k depth select (K5, csrc/topk_select.cu) and of the
top-k loss's k-th value (K3, csrc/kth_largest.cu), emulated step by step in this
file and held bit for bit against the JAX functions they replace, on the CPU.

K5's kernel keeps a pixel's D order keys in registers padded to MAXD (D rounded up
to 16) with key 0, finds the k-th largest key bit by bit from the top (keep
cand = kth | bit while #{key >= cand} >= k), then takes every bin above it and the
lowest ties at it, in ascending bin order: held against ``_kth_largest_bits`` and
``_topk_select_nosort`` of fiery_tpu/ops/lift_splat.py. K3's kernel splits a row
over a cluster of blocks (``kth_largest_plan``), sums the blocks' 256-bin
histograms of 8-bit digits in four passes, carries the rank from pass to pass, and
stops early when the chosen bin holds one key: held against ``_kth_largest`` of
fiery_tpu/training/losses.py. Inputs are made with numpy from fixed seeds; one
``jax.jit`` a case. The kernels themselves are held against their plain versions on
the card (test_torch_select_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.ops import lift_splat as JLS
from fiery_tpu.training import losses as JL
from fiery_tpu_torch.ops import lift_splat as LS
from fiery_tpu_torch.training import losses as L
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


# ---------------------------------------------------------------- K5: the depth select

def k5_keys(bits, nbits):
    """csrc/topk_select.cu `order_key` on raw bits (int64): sign bit set for values
    >= 0, every bit flipped for negative ones, in the weight's own width."""
    top = 1 << (nbits - 1)
    full = (1 << nbits) - 1
    return np.where(bits & top, ~bits & full, bits | top)


def k5_emulation(depth, k):
    """(kth key, selected bins (rows, k) ascending) as the kernel forms them."""
    nbits = 16 if depth.dtype == torch.bfloat16 else 32
    raw = depth.view(torch.int16 if nbits == 16 else torch.int32).numpy().astype(np.int64)
    raw &= (1 << nbits) - 1
    rows, D = raw.shape
    maxd = -(-D // 16) * 16
    key = np.zeros((rows, maxd), np.int64)          # registers past D hold key 0
    key[:, :D] = k5_keys(raw, nbits)
    kth = np.zeros(rows, np.int64)
    for bit in range(nbits - 1, -1, -1):
        cand = kth | (1 << bit)
        kth = np.where((key >= cand[:, None]).sum(-1) >= k, cand, kth)
    live = np.arange(maxd) < D
    gt = key > kth[:, None]
    eq = (key == kth[:, None]) & live                # the padding may equal kth
    ties = k - gt.sum(-1)
    sel = gt | (eq & (np.cumsum(eq, -1) <= ties[:, None]))
    assert (sel.sum(-1) == k).all()
    bins = np.stack([np.flatnonzero(s) for s in sel])
    return kth, bins


def planted_depth(rng, rows, D, k, dtype):
    """(rows, D) weights: softmax rows; rows with ties at the k-th value; all +0.0;
    -0.0 beside +0.0 and negatives; all equal; and rows holding the bf16 bit pattern
    0xFFFF (a NaN whose key is 0, the padding's key)."""
    x = rng.randn(rows, D).astype(np.float32)
    out = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    q = rows // 8
    order = np.argsort(-out[:q], -1, kind='stable')
    for r in range(q):                               # a run of equal values around k
        out[r, order[r, max(k - 3, 0):k + 3]] = out[r, order[r, k - 1]]
    out[q:2 * q] = rng.randint(0, 3, (q, D)) / 4.0
    out[2 * q:3 * q] = 0.0
    out[3 * q:4 * q] = rng.choice([-0.0, 0.0, -0.5, 0.25], (q, D))
    out[4 * q:5 * q] = 1.0
    t = torch.from_numpy(out).to(dtype).contiguous()
    if dtype == torch.bfloat16:
        nan = t[5 * q:6 * q].view(torch.int16)
        nan[:, ::3] = -1                              # 0xFFFF
    return t


@pytest.mark.parametrize('k_of', ['1', '8', 'D'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('D', [28, 48, 64])
def test_k5_bit_search_and_sweep_equal_jax(D, dtype, k_of):
    k = {'1': 1, '8': 8, 'D': D}[k_of]
    rng = np.random.RandomState(D * 7 + k)
    depth = planted_depth(rng, 64, D, k, dtype)
    ids = torch.from_numpy(rng.randint(0, 10 ** 6, depth.shape).astype(np.int32))
    kth, bins = k5_emulation(depth, k)

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jdepth = jnp.asarray(depth.float().numpy()).astype(jdt)
    if dtype == torch.bfloat16:                      # the exact bits, NaN patterns too
        jdepth = jax.lax.bitcast_convert_type(
            jnp.asarray(depth.view(torch.int16).numpy()), jnp.bfloat16)

    def reference(d, i):
        u, nbits = JLS._order_bits(d)
        w, ik = JLS._topk_select_nosort(d, i, k)
        return JLS._kth_largest_bits(u, k, nbits)[..., 0], w, ik

    want_kth, want_w, want_ids = jax.jit(reference)(jdepth, jnp.asarray(ids.numpy()))
    np.testing.assert_array_equal(kth, np.asarray(want_kth).astype(np.int64))
    got_ids = np.take_along_axis(ids.numpy(), bins, -1)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    # the weights as bits: the kernel copies them; XLA's CPU sum of the one-hot
    # flushes subnormals and quiets NaNs, so compare where JAX kept the bits
    nbits_view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    got_w = np.take_along_axis(depth.view(nbits_view).numpy(), bins, -1)
    jw = np.asarray(jax.lax.bitcast_convert_type(
        want_w, jnp.int16 if dtype == torch.bfloat16 else jnp.int32))
    plain = depth.float().numpy()
    normal = np.abs(np.take_along_axis(plain, bins, -1)) >= np.finfo(np.float32).tiny
    finite = np.isfinite(np.take_along_axis(plain, bins, -1))
    keep = normal & finite
    np.testing.assert_array_equal(got_w[keep], jw[keep])
    # and the port's plain version (the kernel's contract) takes the same bins
    _, _, idx = LS.topk_select_plain(depth, ids, k)
    np.testing.assert_array_equal(idx.numpy().astype(np.int64), bins)


# ---------------------------------------------------------------- K3: the k-th value

def k3_keys(x):
    bits = x.view(np.uint32).astype(np.int64)
    return np.where(bits >> 31, ~bits & 0xFFFFFFFF, bits | 0x80000000)


def k3_value(key):
    bits = np.where(key >> 31, key ^ 0x80000000, ~key & 0xFFFFFFFF)
    return np.array(bits, np.uint32).view(np.float32)


def k3_emulation(x, k):
    """Each row's k-th largest as csrc/kth_largest.cu finds it: the row in
    ``kth_largest_plan(n)`` contiguous chunks, four passes of 8-bit digits whose
    histogram is the sum of the chunks', the rank carried between passes, and an
    early stop when the chosen bin holds one key. Returns (values, passes run)."""
    rows, n = x.shape
    C = L.kth_largest_plan(n)
    chunk = -(-n // C)
    starts = list(range(0, n, chunk))
    assert len(starts) <= C
    out, passes = np.zeros(rows, np.float32), np.zeros(rows, np.int64)
    for r in range(rows):
        key = k3_keys(x[r])
        prefix, rank = 0, k
        for p in range(4):
            shift = 24 - 8 * p
            high = 0 if p == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
            digit = (key >> shift) & 0xFF
            active = (key & high) == prefix
            hist = sum(np.bincount(digit[s:s + chunk][active[s:s + chunk]], minlength=256)
                       for s in starts)
            above = np.concatenate([np.cumsum(hist[::-1])[::-1][1:], [0]])  # bins > b
            b = int(np.flatnonzero(above + hist >= rank).max())
            rank -= int(above[b])
            prefix |= b << shift
            passes[r] = p + 1
            if hist[b] == 1 and p < 3:                # the unique key with these bits
                mask = (0xFFFFFFFF << shift) & 0xFFFFFFFF
                prefix = int(key[(key & mask) == prefix][0])
                break
        out[r] = k3_value(prefix)
    return out, passes


def k3_rows(rng, rows, n):
    """Random rows; ignored pixels (exact zeros) below the k-th; a value repeated
    across the k-th position; -0.0 beside +0.0; a loss-like row (continuous, a
    quarter zeros)."""
    x = (rng.rand(rows, n) * 3.0).astype(np.float32)
    x[0, : 3 * n // 4] = 0.0
    if rows > 1:
        x[1, ::2] = np.float32(1.5)
    if rows > 2:
        x[2] = rng.choice([-0.0, 0.0, 1.0], n)
    if rows > 3:
        logits = rng.randn(n, 4) * 2.0
        x[3] = (np.log(np.exp(logits).sum(-1)) - logits[:, 0]).astype(np.float32)
        x[3, rng.rand(n) < 0.25] = 0.0
    return x


@pytest.mark.parametrize('k_of', ['1', 'n/4', 'n'])
@pytest.mark.parametrize('n', [40000, 61760, 80000])
def test_k3_passes_equal_jax(n, k_of):
    k = {'1': 1, 'n/4': n // 4, 'n': n}[k_of]
    rng = np.random.RandomState(n % 997 + k % 13)
    x = k3_rows(rng, 4, n)
    got, passes = k3_emulation(x, k)
    want = np.asarray(jax.jit(lambda v: JL._kth_largest(v, k))(jnp.asarray(x)))[:, 0]
    # bit for bit, so -0.0 and +0.0 are told apart as the JAX keys tell them
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    plain = L.kth_largest_plain(torch.from_numpy(x), k)[:, 0].numpy()
    np.testing.assert_array_equal(got, plain)        # == (torch.topk's zeros may differ in sign)
    assert passes.min() >= 1 and passes.max() <= 4


def test_k3_early_stop_and_plan():
    """A row of distinct values stops after the pass whose bin holds one key; a row
    whose k-th value repeats runs all four passes. Every plan covers the row with at
    most C chunks that fit a block's registers up to 8 x 16,384 keys."""
    rng = np.random.RandomState(5)
    x = np.stack([rng.permutation(40000).astype(np.float32) + 1.0,
                  np.full(40000, 2.0, np.float32)])
    got, passes = k3_emulation(x, 10000)
    np.testing.assert_array_equal(got, [30001.0, 2.0])
    assert passes[0] < 4 and passes[1] == 4
    for n in (1, 400, 40000, 61760, 65536, 65537, 80000, 131072, 200000):
        C = L.kth_largest_plan(n)
        chunk = -(-n // C)
        assert C in (4, 8) and C * chunk >= n
        assert chunk <= L.KTH_KEYS_PER_BLOCK or n > 8 * L.KTH_KEYS_PER_BLOCK
