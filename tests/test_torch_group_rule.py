"""The pixel grouping and relabel of kernel K7 (csrc/group_pixels.cu), in Python,
against the port's plain version and the JAX package (CPU).

``cluster_plan`` is the kernel's way, step by step: 16 blocks a frame, block r
taking rows r, r + 16, ...; the
frame's valid centres compacted in index order and ordered by (a, index), a the
coordinate along the longer side of their bounding box; each foreground pixel's
centre from a binary search along a and a walk each way, stopped where the squared
gap to the box along the other axis plus da * da exceeds the best distance; the
least (distance, index) pair; each block's presence bitmap of K + 1 bits, OR-ed
over the blocks; each id's rank from the popcount prefix of the words. It must equal ``instance_ids_plain``
and the JAX package's ``group_pixels`` + foreground + ``make_instance_seg_consecutive``
(``get_instance_segmentation_and_centers``, ``decode_instance_predictions``) in
every value: random frames, planted near-ties (distances equal, or one f32 ulp
apart), K = 1, 100 and 1,024, a frame with no valid centre and one with no
foreground, non-finite offsets and logits, centres in a band of rows or of columns,
200 x 200, 400 x 200 and 320 x 193 grids, C = 2 and 3. The kernel's shared-memory bound is held against K6's strip rule.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.postprocess import instance as JI
from fiery_tpu_torch.postprocess import instance as I
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

NB = 16            # the kernel's blocks a frame (one cluster): rows r, r + 16, ... each
MAX_K = 1024
CSRC = os.path.join(os.path.dirname(__file__), '..', 'fiery_tpu_torch', 'csrc')


def popcount(x):
    x = np.asarray(x, np.uint64)
    return np.array([bin(int(v)).count('1') for v in x.reshape(-1)], np.int64).reshape(x.shape)


def foreground(logits, vehicles_id):
    """argmax over the last axis as the kernel walks it: the first maximum, a NaN
    the first maximum it meets."""
    best, cls = logits[..., 0].copy(), np.zeros(logits.shape[:-1], np.int64)
    for c in range(1, logits.shape[-1]):
        x = logits[..., c]
        take = (x > best) | (np.isnan(x) & ~np.isnan(best))
        best, cls = np.where(take, x, best), np.where(take, c, cls)
    return cls == vehicles_id


def fused(dx, b):
    """f32 fma(dx, dx, b): dx * dx is exact in f64, the sum rounded once to f64 and
    then to f32."""
    return (dx.astype(np.float64) ** 2 + b.astype(np.float64)).astype(np.float32)


def nearest(sa, sb, sk, pa, pb, g2, first_valid, fma=False):
    """The kernel's search for every pixel at once, along axis a (f32 arithmetic,
    each operation rounded on its own): the centres ordered by (a, index), a walk
    each way from the first a >= pa, stopped where g2 + da * da (g2: the squared gap
    from pb to the centres' range along b) exceeds the best distance. Returns the
    first argmin's index, 0 when every distance is +inf, first_valid when they are
    NaN. ``fma``: d = fma(dx, dx, dy * dy) as XLA's CPU contracts dx * dx + dy * dy,
    dx being da ('a') or db ('b'); the walk stops alike."""
    with np.errstate(over='ignore', invalid='ignore'):
        return _nearest(sa, sb, sk, pa, pb, g2, first_valid, fma)


def _nearest(sa, sb, sk, pa, pb, g2, first_valid, fma):
    n = len(sa)
    nan = np.isnan(pa) | np.isnan(pb)
    lo = np.searchsorted(sa, pa, side='left')          # first a >= pa
    dmin = np.full(pa.shape, np.inf, np.float32)
    kmin = np.full(pa.shape, MAX_K, np.int64)
    for step, start in ((1, lo), (-1, lo - 1)):
        u = start.copy()
        walking = ~nan & (u >= 0) & (u < n)
        while walking.any():
            at = np.flatnonzero(walking)
            e = u[at]
            da = sa[e] - pa[at]
            daa = da * da
            go = ~((g2[at] + daa) > dmin[at])
            db = sb[e] - pb[at]
            if fma:
                d = fused(da, db * db) if fma == 'a' else fused(db, daa)
            else:
                d = daa + db * db
            k = sk[e]
            better = go & ((d < dmin[at]) | ((d == dmin[at]) & (k < kmin[at])))
            dmin[at[better]], kmin[at[better]] = d[better], k[better]
            on = at[go]
            u[on] += step
            walking[:] = False
            walking[on] = (u[on] >= 0) & (u[on] < n)
    out = np.where(dmin < np.inf, kmin, 0)
    out[nan] = first_valid
    return out


def frame_plan(centers, valid, offset, logits, vehicles_id=1, fma=False):
    """One frame through the kernel's plan: (h, w) int32 relabelled ids."""
    h, w, C = logits.shape
    K = len(valid)
    vk = np.flatnonzero(valid)                            # compacted, index order
    box = centers[vk].astype(np.int64)
    rows = len(vk) == 0 or np.ptp(box[:, 0]) >= np.ptp(box[:, 1])   # the walk's axis
    a_ax, b_ax = (0, 1) if rows else (1, 0)
    ab = centers[vk][:, [a_ax, b_ax]].astype(np.float32)
    order = np.lexsort((vk, ab[:, 0]))                    # by (a, index)
    sa, sb, sk = ab[order, 0].copy(), ab[order, 1].copy(), vk[order]
    b_min, b_max = (np.float32(box[:, b_ax].min()), np.float32(box[:, b_ax].max())) \
        if len(vk) else (np.float32(0), np.float32(0))
    words = (K + 32) // 32
    flat_off = offset.reshape(-1, 2)
    flat_logits = logits.reshape(-1, C)
    bitmaps, strips = [], []
    for r in range(NB):
        pix = (np.arange(r, h, NB)[:, None] * w + np.arange(w)[None]).reshape(-1)
        ids = np.zeros(len(pix), np.int64)
        if len(vk):
            fg = foreground(flat_logits[pix], vehicles_id)
            q = pix[fg]
            p = np.stack([(q // w).astype(np.float32) + flat_off[q, 0],
                          (q % w).astype(np.float32) + flat_off[q, 1]])
            pa, pb = p[a_ax], p[b_ax]
            with np.errstate(over='ignore', invalid='ignore'):
                gap = np.where(pb < b_min, b_min - pb, np.where(pb > b_max, pb - b_max,
                                                                np.float32(0)))
                g2 = (gap * gap).astype(np.float32)
            mode = fma and ('a' if rows else 'b')
            ids[fg] = nearest(sa, sb, sk, pa, pb, g2, vk[0], mode) + 1
        bits = np.zeros(words, np.uint64)
        bits[0] = 1                                       # id 0 is present
        for i in np.unique(ids[ids > 0]):
            bits[i >> 5] |= np.uint64(1 << (int(i) & 31))
        bitmaps.append(bits)
        strips.append(ids)
    word_or = np.bitwise_or.reduce(np.stack(bitmaps), axis=0)
    counts = popcount(word_or)
    before = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.zeros((h, w), np.int32)
    for r, ids in enumerate(strips):
        wd = ids >> 5
        upto = (np.uint64(2) << (ids & 31).astype(np.uint64)) - np.uint64(1)
        out[r::NB] = (before[wd] + popcount(word_or[wd] & upto) - 1).reshape(-1, w)
    return out


def cluster_plan(centers, valid, offset, logits, vehicles_id=1, fma=False):
    return np.stack([frame_plan(*x, vehicles_id, fma)
                     for x in zip(centers, valid, offset, logits)])


def plain(centers, valid, offset, logits, vehicles_id=1):
    return I.instance_ids_plain(torch.from_numpy(centers), torch.from_numpy(valid),
                                torch.from_numpy(offset), torch.from_numpy(logits),
                                vehicles_id).numpy()


def jax_ids(centers, valid, offset, logits, vehicles_id=1):
    """The JAX package's group_pixels, foreground and relabel (ids 0..K), a frame at a
    time through a fresh jax.jit."""
    K = valid.shape[1]

    def frame(c, v, o, s):
        ids = JI.group_pixels(c, v, o)
        keep = (jnp.argmax(s, axis=-1) == vehicles_id) & jnp.any(v)
        return JI.make_instance_seg_consecutive(jnp.where(keep, ids, 0), K + 1)

    fn = jax.jit(frame)
    return np.stack([np.asarray(fn(*(jnp.asarray(a) for a in x)))
                     for x in zip(centers, valid, offset, logits)])


def random_frames(rng, B, h, w, K, C, n_valid=None):
    centers = np.stack([rng.randint(0, h, (B, K)), rng.randint(0, w, (B, K))], -1)
    if n_valid is None:
        valid = rng.rand(B, K) < 0.8
    else:
        valid = np.arange(K)[None].repeat(B, 0) < n_valid
    offset = (rng.randn(B, h, w, 2) * 4.0).astype(np.float32)
    logits = rng.randn(B, h, w, C).astype(np.float32)
    return centers.astype(np.int32), valid, offset, logits


def near_ties(rng, B, h, w, K, C):
    """Each pixel moved onto the bisector of its two nearest valid centres: a third to
    their midpoint (equal distances), a third to the nearest point of the bisector
    (distances a few f32 ulps apart), a third there and then one ulp along a row."""
    centers, valid, offset, logits = random_frames(rng, B, h, w, K, C)
    grid = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing='ij'), -1)
    p = grid[None] + offset.astype(np.float64)                     # (B, h, w, 2)
    c = centers.astype(np.float64)
    d = ((c[:, :, None, None] - p[:, None]) ** 2).sum(-1)
    d[~valid] = np.inf
    two = np.argsort(d, axis=1, kind='stable')[:, :2]              # (B, 2, h, w)
    frames = np.arange(B)[:, None, None]
    a, b = c[frames, two[:, 0]], c[frames, two[:, 1]]
    mid = (a + b) / 2
    u = b - a
    u = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
    onto = p - ((p - mid) * u).sum(-1, keepdims=True) * u
    kind = rng.randint(0, 3, (B, h, w))
    q = np.where((kind == 0)[..., None], mid, onto).astype(np.float32)
    step = np.where(rng.rand(B, h, w) < 0.5, np.float32(np.inf), np.float32(-np.inf))
    q[..., 0] = np.where(kind == 2, np.nextafter(q[..., 0], step), q[..., 0])
    return centers, valid, (q - grid.astype(np.float32)).astype(np.float32), logits


def best_two(centers, valid, offset):
    """Per pixel, the two least f32 distances over the valid centres (the check that
    the planted ties are there)."""
    B, h, w, _ = offset.shape
    px = np.arange(h, dtype=np.float32)[:, None] + offset[..., 0]
    py = np.arange(w, dtype=np.float32)[None, :] + offset[..., 1]
    c = centers.astype(np.float32)
    dx = c[:, :, 0, None, None] - px[:, None]
    dy = c[:, :, 1, None, None] - py[:, None]
    d = np.where(valid[:, :, None, None], dx * dx + dy * dy, np.float32(np.inf))
    d.sort(axis=1)
    return d[:, 0], d[:, 1]


CASES = [
    ('random', 100, (200, 200), 2), ('random', 1, (200, 200), 2),
    ('random', 100, (400, 200), 3), ('random', 100, (320, 193), 2),
    ('random', 1024, (64, 48), 3), ('near ties', 100, (200, 200), 2),
    ('near ties', 1024, (64, 64), 2), ('no valid centre', 100, (200, 200), 2),
    ('no foreground', 100, (200, 200), 3), ('non-finite', 100, (64, 48), 2),
    ('band of rows', 100, (200, 200), 2), ('band of columns', 100, (320, 193), 2),
]


@pytest.mark.parametrize('case,K,hw,C', CASES,
                         ids=[f'{c}-K{k}-{h}x{w}-C{n}' for c, k, (h, w), n in CASES])
def test_cluster_plan_equals_plain_and_jax(case, K, hw, C):
    rng = np.random.RandomState(K + hw[0] + C + len(case))
    h, w = hw
    B = 2
    if case == 'near ties':
        inputs = near_ties(rng, B, h, w, K, C)
        lo, hi = best_two(*inputs[:3])
        one_ulp = (hi > lo) & (hi == np.nextafter(lo, np.float32(np.inf)))
        assert (lo == hi).sum() > 100 and one_ulp.sum() > 30
    else:
        inputs = random_frames(rng, B, h, w, K, C)
    centers, valid, offset, logits = inputs
    if case == 'band of rows':       # as random weights place them: the walk runs along columns
        centers[..., 0] = rng.randint(0, 3, centers.shape[:2])
    if case == 'band of columns':
        centers[..., 1] = rng.randint(190, 193, centers.shape[:2])
    if case == 'no valid centre':
        valid[0] = False
    if case == 'no foreground':
        logits[0, ..., 1] = logits[0].min() - 1.0
    if case == 'non-finite':
        offset[0, 3, :10, 0] = np.nan
        offset[0, 4, :10, 1] = np.inf
        offset[1, 5, :10, 0] = -np.inf
        offset[1, 6, :5] = np.float32(3e38)
        logits[0, 7, :10, 0] = np.nan
        logits[1, 8, :10, 1] = np.nan
        valid[1, 0] = False                              # the first valid centre is 1
    got = cluster_plan(centers, valid, offset, logits)
    want = plain(centers, valid, offset, logits)
    np.testing.assert_array_equal(got, want)
    reference = jax_ids(centers, valid, offset, logits)
    if case == 'near ties':
        # XLA's CPU rounds d as one fma, the port (and the kernel) each operation
        # on its own: on ties that differ in the last bit the two pick apart, and the
        # plan with XLA's rounding picks as JAX does
        np.testing.assert_array_equal(cluster_plan(centers, valid, offset, logits, fma=True),
                                      reference)
    else:
        np.testing.assert_array_equal(want, reference)
    if case == 'no valid centre':
        assert not want[0].any() and want[1].any()
    if case == 'no foreground':
        assert not want[0].any() and want[1].any()


def test_cluster_plan_equals_jax_decode():
    """The served decode: the JAX package's decode_instance_predictions and its
    single-frame get_instance_segmentation_and_centers (fresh jax.jit each), against
    the plan on the same centres and the port's CPU decode."""
    rng = np.random.RandomState(3)
    out = {'segmentation': rng.randn(1, 3, 200, 200, 2).astype(np.float32),
           'instance_center': rng.rand(1, 3, 200, 200, 1).astype(np.float32),
           'instance_offset': (rng.randn(1, 3, 200, 200, 2) * 4.0).astype(np.float32)}
    want = np.asarray(jax.jit(JI.decode_instance_predictions)(
        {k: jnp.asarray(v) for k, v in out.items()}))
    port = I.decode_instance_predictions({k: torch.from_numpy(v) for k, v in out.items()})
    np.testing.assert_array_equal(port.numpy(), want)
    center = torch.from_numpy(out['instance_center'][0, ..., 0])
    centers, valid = (t.numpy() for t in I.find_instance_centers_plain(center))
    assert valid.all()
    got = cluster_plan(centers, valid, out['instance_offset'][0], out['segmentation'][0])
    np.testing.assert_array_equal(got, want[0])
    # one frame with a foreground mask, as get_instance_segmentation_and_centers takes it
    fg = rng.rand(200, 200) < 0.3
    seg_j, c_j, v_j = jax.jit(JI.get_instance_segmentation_and_centers)(
        jnp.asarray(out['instance_center'][0, 1]), jnp.asarray(out['instance_offset'][0, 1]),
        jnp.asarray(fg))
    logits = np.stack([~fg, fg], -1).astype(np.float32)
    got = frame_plan(np.asarray(c_j), np.asarray(v_j), out['instance_offset'][0, 1], logits)
    np.testing.assert_array_equal(got, np.asarray(seg_j))


@pytest.mark.parametrize('K', [1, 31, 32, 100, 1024])
def test_bitmap_ranks_equal_the_cumsum_relabel(K):
    """The popcount ranks over OR-ed strip bitmaps equal make_instance_seg_consecutive
    on id sets that cross word boundaries (ids 31, 32, 63, 64, K)."""
    rng = np.random.RandomState(K)
    ids = rng.choice(np.unique(np.r_[0, [i for i in (31, 32, 63, 64) if i <= K], K,
                                     rng.randint(0, K + 1, 20)]).astype(np.int64), (8, 30))
    words = (K + 32) // 32
    strips = np.array_split(ids.reshape(-1), NB)
    word_or = np.zeros(words, np.uint64)
    word_or[0] = 1
    for s in strips:
        for i in s:
            word_or[i >> 5] |= np.uint64(1 << (int(i) & 31))
    before = np.concatenate([[0], np.cumsum(popcount(word_or))[:-1]])
    upto = (np.uint64(2) << (ids & 31).astype(np.uint64)) - np.uint64(1)
    got = before[ids >> 5] + popcount(word_or[ids >> 5] & upto) - 1
    want = I.make_instance_seg_consecutive(torch.from_numpy(ids)[None], K + 1)[0].numpy()
    np.testing.assert_array_equal(got, want)


def constants(source):
    """The ``constexpr int`` constants of a kernel source, evaluated in order."""
    values = {}
    text = open(os.path.join(CSRC, source)).read()
    for name, expr in re.findall(r'constexpr int (\w+) = ([^;]+);', text):
        values[name] = eval(expr, {}, dict(values))  # noqa: S307 (the repo's own source)
    return values


def test_shared_bound_takes_every_frame_k6_takes():
    """Every (h, w, pad) K6 decodes (strips of ceil(h / 8) rows: their keys and
    staged rows in its MAX_DYNAMIC bytes) leaves K7's blocks, of ceil(h / 16) rows,
    at most MAX_BLOCK_PIXELS pixels, which K7 holds in its dynamic shared memory, 4
    bytes a pixel; the block's static and dynamic shared memory fit the H100's
    227 KB; p w < 2^32 for every pixel index p of a block (the multiply-high row)."""
    k6, k7 = constants('instance_centers.cu'), constants('group_pixels.cu')
    most, max_k, threads = k7['MAX_BLOCK_PIXELS'], k7['MAX_K'], k7['THREADS']
    assert k7['NB'] == NB and k7['MAX_DYNAMIC'] == 4 * most
    assert max_k <= threads and max_k == MAX_K and threads % 8 == 0
    static = max_k * (16 + 8 + 4) + (NB + 3) * ((max_k + 32) // 32) * 4 + threads // 32 * 4 + 20
    assert static + 4 * most <= 227 * 1024
    assert most * most < 2 ** 32
    for h in list(range(1, 90)) + [200, 320, 400, 1000, 1024, 1600, 3000]:
        for w in (1, 7, 48, 193, 200, 256, 1000, 1024, 3000):
            for pad in (0, 1, 2):
                rows6 = -(-h // k6['NB'])
                if 4 * (rows6 * w + (rows6 + 2 * pad) * (w + 2 * pad)) <= k6['MAX_DYNAMIC']:
                    assert -(-h // NB) * w <= most, (h, w, pad)
    assert -(-400 // NB) * 200 <= most


@pytest.mark.parametrize('w', [1, 2, 3, 7, 193, 200, 256, 1000, 25600])
def test_row_of_a_pixel_is_exact(w):
    """The block's row of pixel p, __umulhi(p, ceil(2^32 / w)), is p // w for every
    p of a block (at most MAX_BLOCK_PIXELS = 25,600 pixels)."""
    p = np.arange(25600, dtype=np.uint64)
    if w == 1:
        return
    inv = np.uint64(0xffffffff // w + 1)
    np.testing.assert_array_equal((p * inv) >> np.uint64(32), p // np.uint64(w))


def test_phase_probe_stamps_every_phase():
    """``python -m fiery_tpu_torch.group_stages`` finds each phase's marker in the
    kernel's source: seven stamps, the last after the ids' store."""
    from fiery_tpu_torch import group_stages
    src = group_stages.stamped_source()
    for i in range(7):
        assert src.count(f'g_stamps[blockIdx.x * 8 + {i}]') == 1
    assert src.index('g_stamps[blockIdx.x * 8 + 6]') > src.index('ids[frame_px')
