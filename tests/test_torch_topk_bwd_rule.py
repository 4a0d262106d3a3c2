"""The tile plan of the top-k select's backward kernel (K5 backward,
csrc/topk_select.cu), emulated in PyTorch, against ``topk_select_backward_plain``,
and that against the JAX package's VJP of ``_topk_select_nosort``'s top_w (CPU).

The kernel: a block takes PIXELS = 128 consecutive pixels; their d_depth rows are
one span of 128 x D values, zeroed in a shared tile; each of the block's k slots a
pixel (a contiguous span of g and idx) goes to the tile at (e / k) x D + idx, the
pixel taken as a multiply-high by ceil(2^32 / k); the tile leaves as whole 16-byte
words when d_depth is 16-byte aligned, and the values past the last whole word (or
all of them, unaligned) one at a time. ``emulate`` does that step by step and counts
each output value's writes; every value must be written once and equal the plain
version bit for bit, at D = 28, 48 and 64, k = 1, 8 and D, f32 and bf16, 1 to
90,720 pixels, and bf16 rows of 56 bytes (D = 28, k = 3).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.ops import lift_splat as JL
from fiery_tpu_torch.ops import lift_splat as LS

# the kernel's pixels a block, read from its source
with open(os.path.join(os.path.dirname(__file__), '..', 'fiery_tpu_torch', 'csrc',
                       'topk_select.cu')) as _f:
    PIXELS = int(re.search(r'constexpr int kBwdPixels = (\d+);', _f.read()).group(1))


def tiles(n_pix, D, es, aligned):
    """Each block's (first pixel, pixels, 16-byte stores, single-value stores)."""
    out = []
    for p0 in range(0, n_pix, PIXELS):
        n = min(PIXELS, n_pix - p0)
        words = n * D * es // 16 if aligned else 0
        out.append((p0, n, words, n * D - words * 16 // es))
    return out


def slot_pixel(e, k):
    """e / k as the kernel takes it: __umulhi(e, ceil(2^32 / k)), or e for k = 1."""
    if k == 1:
        return e
    return (e * ((2 ** 32 + k - 1) // k)) >> 32


def emulate(g, idx, D, aligned=True):
    """(d_depth (n_pix, D), the number of writes of each of its values)."""
    n_pix, k = g.shape
    es = g.element_size()
    gf, xf = g.reshape(-1), idx.reshape(-1).long()
    out = torch.empty(n_pix * D, dtype=g.dtype)
    writes = torch.zeros(n_pix * D, dtype=torch.int64)
    for p0, n, words, singles in tiles(n_pix, D, es, aligned):
        tile = torch.zeros(n * D, dtype=g.dtype)
        e = torch.arange(n * k, dtype=torch.int64)
        p = slot_pixel(e, k)
        d = xf[p0 * k + e]
        live = d < D
        tile[p[live] * D + d[live]] = gf[p0 * k + e][live]
        base = p0 * D
        assert not aligned or base * es % 16 == 0      # every span starts on a word
        per_word = 16 // es
        out[base:base + words * per_word] = tile[:words * per_word]
        out[base + words * per_word:base + n * D] = tile[words * per_word:]
        writes[base:base + n * D] += 1
        assert words * per_word + singles == n * D
    return out.view(n_pix, D), writes


def selection(n_pix, D, k, dtype, seed):
    """(depth, idx) from the port's plain select on softmax rows with planted ties
    (every fourth row: three levels, all zeros, or all ones)."""
    g = torch.Generator().manual_seed(seed)
    depth = torch.softmax(torch.randn((n_pix, D), generator=g), -1)
    depth[0::12] = torch.randint(0, 3, (n_pix, D), generator=g)[0::12] / 4.0
    depth[4::12], depth[8::12] = 0.0, 1.0
    depth = depth.to(dtype)
    ids = torch.randint(0, 40001, (n_pix, D), generator=g, dtype=torch.int32)
    return depth, LS.topk_select_plain(depth, ids, k)[2]


def cotangent(n_pix, k, dtype, seed):
    """Seeded g with -0.0 and +0.0 among its values."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n_pix, k), generator=g)
    x[torch.rand((n_pix, k), generator=g) < 0.1] = -0.0
    return x.to(dtype)


def bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('k_of', ['1', '8', 'D'])
@pytest.mark.parametrize('D', [28, 48, 64])
def test_tile_plan_equals_plain(D, k_of, dtype):
    """Tails of 1 and 44 pixels after whole blocks, aligned and not."""
    k = {'1': 1, '8': 8, 'D': D}[k_of]
    for n_pix in (1, 3 * PIXELS + 44):
        _, idx = selection(n_pix, D, k, dtype, seed=D * k + n_pix)
        g = cotangent(n_pix, k, dtype, seed=n_pix)
        want = LS.topk_select_backward_plain(g, idx, D)
        for aligned in (True, False):
            got, writes = emulate(g, idx, D, aligned)
            assert bool((writes == 1).all())
            assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize('n_pix', [30240, 90720], ids=['serve', 'train'])
def test_tile_plan_at_the_path_shapes(n_pix):
    """The combination's shapes: 3 and 9 samples x 6 cameras x 28 x 60 pixels, D = 48,
    k = 8, bf16 (whole blocks only at 30,240 = 236.25 x 128: a tail of 32 pixels)."""
    _, idx = selection(n_pix, 48, 8, torch.bfloat16, seed=n_pix)
    g = cotangent(n_pix, 8, torch.bfloat16, seed=1)
    got, writes = emulate(g, idx, 48)
    assert bool((writes == 1).all())
    assert torch.equal(bits(got), bits(LS.topk_select_backward_plain(g, idx, 48)))


@pytest.mark.parametrize('n_pix,D,dtype,aligned,last', [
    (1, 28, torch.bfloat16, True, (0, 1, 3, 4)),        # 56 bytes: 3 words, 4 values
    (1, 28, torch.float32, True, (0, 1, 7, 0)),         # 112 bytes: 7 words
    (1, 48, torch.bfloat16, True, (0, 1, 6, 0)),
    (129, 28, torch.bfloat16, True, (128, 1, 3, 4)),    # the tail block
    (128, 28, torch.bfloat16, True, (0, 128, 448, 0)),  # a whole block: words only
    (5, 64, torch.float32, False, (0, 5, 0, 320)),      # unaligned: single values
    (300, 48, torch.bfloat16, True, (256, 44, 264, 0)),
])
def test_store_widths(n_pix, D, dtype, aligned, last):
    es = torch.tensor([], dtype=dtype).element_size()
    plan = tiles(n_pix, D, es, aligned)
    assert plan[-1] == last
    assert sum(n for _, n, _, _ in plan) == n_pix
    assert [p0 for p0, _, _, _ in plan] == list(range(0, n_pix, PIXELS))


@pytest.mark.parametrize('k', [1, 2, 3, 7, 8, 28, 48, 63, 64])
def test_slot_pixel_is_exact(k):
    """The multiply-high equals e // k for every slot of a block."""
    e = torch.arange(PIXELS * k, dtype=torch.int64)
    assert torch.equal(slot_pixel(e, k), e // k)


@pytest.mark.parametrize('k_of', ['1', '8', 'D'])
@pytest.mark.parametrize('D', [28, 48, 64])
def test_plain_equals_jax_vjp(D, k_of):
    """topk_select_backward_plain on the port's idx equals the gradient of the JAX
    package's _topk_select_nosort top_w (a fresh jax.jit), f32, and bf16 at k = 8.
    The JAX gradient sums g with zeros, so its -0.0 are +0.0: compared by value."""
    k = {'1': 1, '8': 8, 'D': D}[k_of]
    n_pix = 200
    dtypes = [(torch.float32, jnp.float32)] + ([(torch.bfloat16, jnp.bfloat16)] if k == 8
                                                else [])
    for dtype, jdt in dtypes:
        depth, idx = selection(n_pix, D, k, dtype, seed=D + k)
        g = cotangent(n_pix, k, dtype, seed=k)
        ids = jnp.zeros((n_pix, D), jnp.int32)
        d_np = depth.float().numpy()
        g_np = g.float().numpy()

        def top_w(x):
            return JL._topk_select_nosort(x, ids, k)[0]

        def vjp(x, ct):
            return jax.vjp(top_w, x)[1](ct)[0]

        want = np.asarray(jax.jit(vjp)(jnp.asarray(d_np, jdt), jnp.asarray(g_np, jdt)),
                          np.float32)
        got = LS.topk_select_backward_plain(g, idx, D).float().numpy()
        np.testing.assert_array_equal(got, want)
        assert (got != 0).sum() <= n_pix * k
