"""Camera-to-BEV lifting (Lift-Splat) in PyTorch, channels-last.

Counterpart of fiery_tpu/ops/lift_splat.py. Every frustum point keeps a fixed
slot: out-of-bounds points are routed to a dump bin (id X*Y*Z) that is dropped.
The main path (``lift_splat_depth``) never materialises the (P, C) lifted volume:
the ``bev_pool`` kernels (csrc/bev_pool.cu) bucket the rows by voxel and let each
output cell sum its rows' depth x feature products in ascending row order, as the
plain version's ``index_add_`` does on the host (bit for bit at Z = 1); its
backward kernel gathers the output gradient rows and contracts them with features
and depth without building the volume either. ``lift_splat``
keeps the JAX signature over a lifted volume and is the plain reference form.
The sparse splat (``lift_splat_topk``, LIFT.TOPK) picks each pixel's k largest
depth bins with the ``topk_select`` kernel (csrc/topk_select.cu) and splats them
through ``bev_pool`` at D = k. Both forwards are operators,
``torch.ops.fiery_torch.bev_pool`` and ``topk_select`` (ops/library.py; CUDA
implementations ``bev_pool_card``, ``topk_select_card``).
"""

import ctypes

import numpy as np
import torch

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.utils.device import device_constant


def create_frustum(final_dim, downsample, d_bound):
    """Fixed (D, h, w, 3) numpy grid of (u, v, depth) image-plane points."""
    H, W = final_dim
    h, w = H // downsample, W // downsample
    depth_grid = np.arange(d_bound[0], d_bound[1], d_bound[2], dtype=np.float32)
    x_grid = np.linspace(0, W - 1, w, dtype=np.float32)
    y_grid = np.linspace(0, H - 1, h, dtype=np.float32)
    return np.stack(np.broadcast_arrays(
        x_grid[None, None, :], y_grid[None, :, None], depth_grid[:, None, None]),
        axis=-1)


def get_geometry(frustum, intrinsics, extrinsics):
    """Unproject frustum points to the ego frame.

    frustum: (D, h, w, 3); intrinsics (..., N, 3, 3); extrinsics (..., N, 4, 4).
    Returns (..., N, D, h, w, 3) ego-frame xyz.
    """
    rotation = extrinsics[..., :3, :3]
    translation = extrinsics[..., :3, 3]
    points = torch.cat([frustum[..., :2] * frustum[..., 2:3], frustum[..., 2:3]], dim=-1)
    # inv_ex: linalg.inv's result without its singularity check, which waits on the card
    combined = rotation @ torch.linalg.inv_ex(intrinsics).inverse
    pts = torch.einsum('...ij,dhwj->...dhwi', combined, points)
    return pts + translation[..., None, None, None, :]


def voxel_ids(geometry, bev_resolution, bev_start_position, bev_dimension):
    """Flat int32 BEV bin ids of ego-frame points (..., 3); out of bounds -> X*Y*Z.

    Computed in geometry's dtype. Trunc (toward zero), not floor: fractional bins
    in (-1, 0) land in bin 0 and survive the bounds check, as in the reference.
    """
    res = device_constant(bev_resolution, geometry.dtype, geometry.device)
    start = device_constant(bev_start_position, geometry.dtype, geometry.device)
    X, Y, Z = (int(d) for d in bev_dimension)
    vox = torch.trunc((geometry - (start - res / 2.0)) / res).to(torch.int32)
    dim = device_constant((X, Y, Z), torch.int32, geometry.device)
    valid = ((vox >= 0) & (vox < dim)).all(dim=-1)
    flat = (vox[..., 0] * Y + vox[..., 1]) * Z + vox[..., 2]
    return torch.where(valid, flat, torch.full_like(flat, X * Y * Z))


def splat_rows(rows, ids, num_bins, z_bins):
    """Plain segment-sum of one sample's (P, C) rows into num_bins + 1 bins (the
    last is the dump bin, dropped), then summed over consecutive groups of z_bins.
    Accumulates in f32; returns (num_bins // z_bins, C) f32."""
    out = torch.zeros((num_bins + 1, rows.shape[-1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, ids.reshape(-1).long(), rows.reshape(-1, rows.shape[-1]).float())
    return out[:-1].view(num_bins // z_bins, z_bins, -1).sum(dim=1)


def lift_splat(features, geometry, bev_resolution, bev_start_position, bev_dimension):
    """Splat a lifted volume: (B, N, h, w, D, C) point features + (B, N, D, h, w, 3)
    geometry -> (B, X, Y, C). The plain reference form of the JAX signature."""
    B, C = features.shape[0], features.shape[-1]
    X, Y, Z = (int(d) for d in bev_dimension)
    ids = voxel_ids(geometry, bev_resolution, bev_start_position, bev_dimension)
    ids = ids.permute(0, 1, 3, 4, 2)   # (B, N, D, h, w) -> (B, N, h, w, D)
    out = torch.stack([splat_rows(features[b], ids[b], X * Y * Z, Z) for b in range(B)])
    return out.to(features.dtype).view(B, X, Y, C)


def depth_feature_outer_product(x, D, C):
    """(B, h, w, D + C) head output -> (B, h, w, D, C) softmax_D(depth) x features."""
    depth = torch.softmax(x[..., :D], dim=-1)
    return depth[..., :, None] * x[..., None, D:D + C]


def bev_pool_plain(depth, feat, ids, num_bins, z_bins=1):
    """Plain version of ``bev_pool``: the f32 outer product, then an index_add_
    segment-sum per sample, cast to depth's dtype."""
    vol = depth.float()[..., :, None] * feat.float()[..., None, :]
    out = torch.stack([splat_rows(vol[s], ids[s], num_bins, z_bins)
                       for s in range(depth.shape[0])])
    return out.to(depth.dtype)


def bev_pool_backward_plain(depth, feat, ids, g, num_bins, z_bins=1):
    """Plain version of ``bev_pool_backward``: gather each frustum row's output
    gradient row g[s, id // z_bins] (zero for the dump bin), then contract it with
    feat for d_depth and with depth for d_feat, in f32; both cast to depth's dtype."""
    S, N, h, w, D = depth.shape
    C = feat.shape[-1]
    valid = ids < num_bins
    first_row = torch.arange(S, device=ids.device).view(S, 1, 1, 1, 1) * (num_bins // z_bins)
    rows = torch.where(valid, ids, 0).long() // z_bins + first_row
    gg = g.float().reshape(-1, C)[rows.view(-1)].view(S, N, h, w, D, C)
    gg = gg * valid[..., None].to(gg.dtype)
    d_depth = torch.einsum('snhwc,snhwdc->snhwd', feat.float(), gg)
    d_feat = torch.einsum('snhwd,snhwdc->snhwc', depth.float(), gg)
    return d_depth.to(depth.dtype), d_feat.to(depth.dtype)


def bev_pool_order_plain(ids, num_bins, z_bins=1):
    """Plain version of ``bev_pool_order``: a stable sort of the in-grid rows by key.

    ids (S, ..., D) int32 voxel ids in [0, num_bins] (num_bins is the dump bin). Row
    r is the flat index into ids; its key is s * num_bins + id, the voxel id itself
    and not id // z_bins, so that the rows of each voxel keep ascending row order
    (z_bins is checked only). Returns (order, offsets): order (n,) int32, the n
    in-grid rows by ascending key and, within a key, ascending row; offsets
    (S * num_bins + 1,) int32, key k's rows being order[offsets[k]:offsets[k + 1]]."""
    if num_bins % z_bins:
        raise ValueError(f'bev_pool_order: num_bins {num_bins} is not a multiple of {z_bins}')
    S = ids.shape[0]
    flat = ids.reshape(S, -1).long()
    valid = (flat >= 0) & (flat < num_bins)
    keys = (flat + torch.arange(S, device=ids.device)[:, None] * num_bins)[valid]
    rows = torch.arange(flat.numel(), device=ids.device).view(S, -1)[valid]
    order = rows[torch.sort(keys, stable=True).indices]
    counts = torch.bincount(keys, minlength=S * num_bins)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return order.to(torch.int32), offsets.to(torch.int32)


# the kernels of one bev_pool call (count, scan, fill, pool), each launched once;
# bev_pool_order launches as many (count, scan, fill, order)
BEV_POOL_KERNELS = 4
_SCAN_TILE = 2048      # keys a scan block (csrc/bev_pool.cu kScanTile)
_FNS = {}
_LAYOUTS = {}


def _fn(lib, name, argtypes, restype=ctypes.c_int):
    """The ctypes function ``name`` of kernel library ``lib``, its argument types set
    once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes, fn.restype = argtypes, restype
        _FNS[name] = fn
    return fn


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _layout(S, pix_per_sample, D, num_bins, z_bins=1):
    """Starts of the splat workspace's parts (counts, local offsets, tile bases, list,
    order, cells) and its size, in int32 words: ``fiery_bev_pool_layout``, once a
    shape."""
    key = (S, pix_per_sample, D, num_bins, z_bins)
    out = _LAYOUTS.get(key)
    if out is None:
        arr = (ctypes.c_longlong * 7)()
        fn = _fn('bev_pool', 'fiery_bev_pool_layout', [_LL, _LL, _I, _I, _I, _P])
        if fn(S, pix_per_sample, D, num_bins, z_bins, arr) != 0:
            raise ValueError(f'bev_pool: {S} x {pix_per_sample} x {D} rows or {S} x '
                             f'{num_bins} voxels do not fit in int32')
        out = _LAYOUTS[key] = tuple(arr)
    return out


def _check_pool_shapes(name, depth, feat, ids, num_bins, z_bins):
    S, N, h, w, D = depth.shape
    C = feat.shape[-1]
    if feat.shape != (S, N, h, w, C) or ids.shape != depth.shape:
        raise ValueError(f'{name}: shapes depth {tuple(depth.shape)}, feat '
                         f'{tuple(feat.shape)}, ids {tuple(ids.shape)} do not agree')
    if num_bins % z_bins:
        raise ValueError(f'{name}: num_bins {num_bins} is not a multiple of {z_bins}')


def _check_pool_inputs(name, depth, feat, ids, num_bins, z_bins):
    _check_pool_shapes(name, depth, feat, ids, num_bins, z_bins)
    if depth.device.type == 'cpu':
        return
    if depth.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {depth.device}')
    _check_pool_card(name, depth, feat, ids)


def _check_pool_card(name, depth, feat, ids):
    if depth.dtype not in (torch.float32, torch.bfloat16) or feat.dtype != depth.dtype:
        raise TypeError(f'{name}: depth/feat must share float32 or bfloat16, got '
                        f'{depth.dtype}/{feat.dtype}')
    if ids.dtype != torch.int32:
        raise TypeError(f'{name}: ids must be int32, got {ids.dtype}')
    if not (depth.is_contiguous() and feat.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f'{name}: inputs must be contiguous')
    if not (feat.device == depth.device == ids.device):
        raise ValueError(f'{name}: inputs must be on one device')


def bev_pool_card(depth, feat, ids, num_bins, z_bins):
    """K1 forward on the card, the CUDA implementation of
    ``torch.ops.fiery_torch.bev_pool``: its int32 workspace allocated from the
    shapes alone (``_layout``), then ``BEV_POOL_KERNELS`` launches."""
    _check_pool_card('bev_pool', depth, feat, ids)
    S, N, h, w, D = depth.shape
    C = feat.shape[-1]
    ws = torch.empty(_layout(S, N * h * w, D, num_bins, z_bins)[6], dtype=torch.int32,
                     device=depth.device)
    out = torch.empty((S, num_bins // z_bins, C), dtype=depth.dtype, device=depth.device)
    fn = _fn('bev_pool', 'fiery_bev_pool', [_P] * 5 + [_LL] * 2 + [_I] * 7 + [_P])
    rc = fn(depth.data_ptr(), feat.data_ptr(), ids.data_ptr(), out.data_ptr(), ws.data_ptr(),
            S, N * h * w, h, w, D, C, num_bins, z_bins, int(depth.dtype == torch.bfloat16),
            torch.cuda.current_stream(depth.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'bev_pool kernel launch failed: CUDA error {rc}')
    bev_pool.launches += BEV_POOL_KERNELS
    return out


class _BevPool(torch.autograd.Function):
    """The fused splat with its backward kernel; the ids get no gradient."""

    @staticmethod
    def forward(ctx, depth, feat, ids, num_bins, z_bins):
        ctx.save_for_backward(depth, feat, ids)
        ctx.num_bins, ctx.z_bins = num_bins, z_bins
        return torch.ops.fiery_torch.bev_pool(depth, feat, ids, num_bins, z_bins)

    @staticmethod
    def backward(ctx, g):
        depth, feat, ids = ctx.saved_tensors
        d_depth, d_feat = bev_pool_backward(depth, feat, ids, g.contiguous(),
                                            ctx.num_bins, ctx.z_bins)
        return d_depth, d_feat, None, None, None


def bev_pool(depth, feat, ids, num_bins, z_bins=1):
    """Fused lift + splat (kernel K1, csrc/bev_pool.cu), differentiable in depth and
    feat.

    depth (S, N, h, w, D) softmax weights; feat (S, N, h, w, C); ids (S, N, h, w, D)
    int32 flat voxel ids in [0, num_bins] (num_bins is the dump bin). Returns
    out (S, num_bins // z_bins, C) with out[s, id // z_bins] += depth * feat,
    accumulated in f32 in ascending row order within each voxel, the z_bins voxels
    of a cell added in order, and cast to depth's dtype; its backward is
    ``bev_pool_backward``. The forward is ``torch.ops.fiery_torch.bev_pool``
    (ops/library.py): a CPU tensor takes the plain versions; a CUDA tensor launches
    the kernels (``BEV_POOL_KERNELS`` of them, counted in ``bev_pool.launches``),
    with no host sync.
    """
    _check_pool_shapes('bev_pool', depth, feat, ids, num_bins, z_bins)
    if torch.is_grad_enabled() and (depth.requires_grad or feat.requires_grad):
        return _BevPool.apply(depth, feat, ids, num_bins, z_bins)
    # no graph to record
    return torch.ops.fiery_torch.bev_pool(depth, feat, ids, num_bins, z_bins)


bev_pool.launches = 0


def bev_pool_order(ids, num_bins, z_bins=1):
    """The order stage of ``bev_pool`` on its own, for tests and measurements:
    returns (order, offsets) as ``bev_pool_order_plain`` does. On the card it runs
    the splat's count, scan and fill kernels and then one that writes every bucket
    in the order the pool kernel sums it (with the pool's sorts), four launches
    counted in ``bev_pool_order.launches``, and reads the number of in-grid rows
    back to the host (a sync, which ``bev_pool`` never makes). A CPU tensor takes
    the plain version."""
    if ids.device.type == 'cpu':
        return bev_pool_order_plain(ids, num_bins, z_bins)
    if (ids.device.type != 'cuda' or ids.dtype != torch.int32 or not ids.is_contiguous()
            or ids.dim() != 5):
        raise ValueError(f'bev_pool_order: ids must be (S, N, h, w, D) contiguous int32 on a '
                         f'CUDA device, got {ids.dtype} {tuple(ids.shape)} on {ids.device}')
    if num_bins % z_bins:
        raise ValueError(f'bev_pool_order: num_bins {num_bins} is not a multiple of {z_bins}')
    S, N, h, w, D = ids.shape
    lay = _layout(S, N * h * w, D, num_bins)
    ws = torch.empty(lay[6], dtype=torch.int32, device=ids.device)
    fn = _fn('bev_pool', 'fiery_bev_pool_order', [_P, _P, _LL, _LL] + [_I] * 4 + [_P])
    rc = fn(ids.data_ptr(), ws.data_ptr(), S, N * h * w, h, w, D, num_bins,
            torch.cuda.current_stream(ids.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'bev_pool_order kernel launch failed: CUDA error {rc}')
    bev_pool_order.launches += BEV_POOL_KERNELS
    keys = S * num_bins
    k = torch.arange(keys + 1, device=ids.device)
    offsets = ws[lay[2]:lay[3]][k // _SCAN_TILE] + ws[lay[1]:lay[1] + keys + 1]
    return ws[lay[4]:lay[4] + int(offsets[-1])].clone(), offsets


bev_pool_order.launches = 0


def bev_pool_backward(depth, feat, ids, g, num_bins, z_bins=1):
    """Gradients of ``bev_pool`` (kernel K1 backward, csrc/bev_pool.cu): g
    (S, num_bins // z_bins, C) in depth's dtype -> (d_depth, d_feat), shaped and
    typed as depth and feat, summed in f32 in a fixed order (the kernel fuses each
    product into its sum). For each frustum row p and bin d with id = ids[p, d] not
    the dump bin, r = g[s, id // z_bins]:
        d_feat[p, c] = sum_d depth[p, d] r[c],   d_depth[p, d] = sum_c feat[p, c] r[c].
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    _check_pool_inputs('bev_pool_backward', depth, feat, ids, num_bins, z_bins)
    S, N, h, w, D = depth.shape
    C = feat.shape[-1]
    if g.shape != (S, num_bins // z_bins, C):
        raise ValueError(f'bev_pool_backward: g {tuple(g.shape)} must be '
                         f'{(S, num_bins // z_bins, C)}')
    if depth.device.type == 'cpu':
        return bev_pool_backward_plain(depth, feat, ids, g, num_bins, z_bins)
    if g.dtype != depth.dtype or not g.is_contiguous() or g.device != depth.device:
        raise ValueError(f'bev_pool_backward: g must be contiguous {depth.dtype} on '
                         f'{depth.device}, got {g.dtype} on {g.device}')
    if C > 256:
        raise ValueError(f'bev_pool_backward: C = {C} > 256 channels')
    fn = _fn('bev_pool', 'fiery_bev_pool_backward', [_P] * 6 + [_LL] * 2 + [_I] * 5 + [_P])
    d_depth = torch.empty_like(depth)
    d_feat = torch.empty_like(feat)
    rc = fn(depth.data_ptr(), feat.data_ptr(), ids.data_ptr(), g.data_ptr(),
            d_depth.data_ptr(), d_feat.data_ptr(), S * N * h * w, N * h * w, D, C,
            num_bins, z_bins, int(depth.dtype == torch.bfloat16),
            torch.cuda.current_stream(depth.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'bev_pool_backward kernel launch failed: CUDA error {rc}')
    bev_pool_backward.launches += 1
    return d_depth, d_feat


bev_pool_backward.launches = 0


def lift_splat_depth(depth, feat, geometry, bev_resolution, bev_start_position,
                     bev_dimension, depth_keep=None):
    """The serving splat: depth (B, N, h, w, D), features (B, N, h, w, C) and
    geometry (B, N, D, h, w, 3) -> (B, X, Y, C), through ``bev_pool``. The ids are
    reordered to the (h, w, D) layout of depth instead of transposing features.

    depth_keep: optional per-camera keep counts (N,) from
    ``compute_depth_plane_keep``; the planes d >= depth_keep[n] of camera n go to
    the dump bin, which gives the JAX package's culled splat (which slices them out)
    exactly."""
    B, C = depth.shape[0], feat.shape[-1]
    X, Y, Z = (int(d) for d in bev_dimension)
    ids = voxel_ids(geometry, bev_resolution, bev_start_position, bev_dimension)
    ids = ids.permute(0, 1, 3, 4, 2)
    if depth_keep is not None:
        N, D = ids.shape[1], ids.shape[-1]
        if len(depth_keep) != N:
            raise ValueError(f'depth_keep has {len(depth_keep)} counts for {N} cameras')
        keep = device_constant(tuple(int(k) for k in depth_keep), torch.int64, ids.device)
        culled = torch.arange(D, device=ids.device) >= keep.view(1, N, 1, 1, 1)
        ids = torch.where(culled, torch.full_like(ids, X * Y * Z), ids)
    out = bev_pool(depth.contiguous(), feat.contiguous(), ids.contiguous(), X * Y * Z, Z)
    return out.view(B, X, Y, C)


def _order_bits(x):
    """Order-preserving unsigned keys of floats, as int64, in their native width:
    bf16 -> 16 bits, anything else -> 32 bits of its f32 value. The sign bit is set
    for values >= 0 and every bit flipped for negative ones (-0.0 and +0.0 are
    distinct keys). Returns (keys, nbits)."""
    if x.dtype == torch.bfloat16:
        b = x.view(torch.int16).to(torch.int64) & 0xFFFF
        return torch.where((b >> 15) == 0, b | 0x8000, ~b & 0xFFFF), 16
    b = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where((b >> 31) == 0, b | 0x80000000, ~b & 0xFFFFFFFF), 32


def _kth_largest_bits(u, k, nbits):
    """Exact k-th largest key along the last axis, (..., 1): the 4-bit dense
    histogram descent of the JAX package, nbits / 4 levels."""
    prefix = torch.zeros(u.shape[:-1] + (1,), dtype=u.dtype, device=u.device)
    rank = torch.full(u.shape[:-1] + (1,), k, dtype=torch.int64, device=u.device)
    buckets = torch.arange(16, device=u.device)
    for level in range(nbits // 4):
        shift = nbits - 4 - 4 * level
        b = (u >> shift) & 0xF
        onehot = b[..., None] == buckets
        if level:
            active = (u >> (shift + 4)) == (prefix >> (shift + 4))
            onehot &= active[..., None]
        hist = onehot.sum(dim=-2)                                  # (..., 16)
        cnt_ge = torch.cumsum(hist.flip(-1), dim=-1).flip(-1)
        bstar = (cnt_ge >= rank).sum(dim=-1, keepdim=True) - 1     # largest bucket >= rank
        cnt_gt = torch.where(buckets == bstar, cnt_ge - hist, 0).sum(dim=-1, keepdim=True)
        rank = rank - cnt_gt
        prefix = prefix | (bstar << shift)
    return prefix


def topk_select_plain(depth, ids, k):
    """Plain version of ``topk_select``, the JAX package's ``_topk_select_nosort``
    step by step: the exact k-th key, then every bin above it and the lowest-index
    ties at it, compacted into k slots in ascending bin order. Returns (top_w,
    ids_k, idx) with idx the selected bins (..., k) uint8."""
    u, nbits = _order_bits(depth)
    kth = _kth_largest_bits(u, k, nbits)
    gt, eq = u > kth, u == kth
    n_gt = gt.sum(dim=-1, keepdim=True)
    eq_rank = torch.cumsum(eq.long(), dim=-1)                      # 1-based among ties
    sel = gt | (eq & (eq_rank <= k - n_gt))                        # exactly k true
    slot = torch.where(sel, torch.cumsum(sel.long(), dim=-1) - 1, k)
    D = depth.shape[-1]
    bins = torch.arange(D, device=depth.device).expand(depth.shape).contiguous()
    # slot k collects the unselected bins and is dropped
    idx = torch.zeros(depth.shape[:-1] + (k + 1,), dtype=torch.int64, device=depth.device)
    idx = idx.scatter(-1, slot, bins)[..., :k]
    return depth.gather(-1, idx), ids.gather(-1, idx), idx.to(torch.uint8)


def topk_select_backward_plain(g, idx, D):
    """Plain version of ``topk_select_backward``."""
    out = torch.zeros(g.shape[:-1] + (D,), dtype=g.dtype, device=g.device)
    return out.scatter(-1, idx.long(), g)


def _check_topk_inputs(depth, ids, k):
    D = depth.shape[-1]
    if ids.shape != depth.shape:
        raise ValueError(f'topk_select: ids {tuple(ids.shape)} must be shaped as depth '
                         f'{tuple(depth.shape)}')
    if not 1 <= k <= D:
        raise ValueError(f'topk_select: k = {k} outside [1, {D}]')


def _check_topk_card(depth, ids):
    D = depth.shape[-1]
    if depth.device.type != 'cuda' or ids.device != depth.device:
        raise ValueError(f'topk_select: depth and ids must share a CUDA device, got '
                         f'{depth.device} and {ids.device}')
    if depth.dtype not in (torch.float32, torch.bfloat16) or ids.dtype != torch.int32:
        raise TypeError(f'topk_select: depth must be float32 or bfloat16 and ids int32, '
                        f'got {depth.dtype}/{ids.dtype}')
    if D > 64:
        raise ValueError(f'topk_select: D = {D} > 64 depth bins')
    if not (depth.is_contiguous() and ids.is_contiguous()):
        raise ValueError('topk_select: inputs must be contiguous')


def topk_select_card(depth, ids, k):
    """K5 on the card, the CUDA implementation of ``torch.ops.fiery_torch.topk_select``:
    (top_w, ids_k, idx) as ``topk_select_plain`` returns them, one launch."""
    _check_topk_card(depth, ids)
    D = depth.shape[-1]
    fn = _build.load('topk_select').fiery_topk_select
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shape = depth.shape[:-1] + (k,)
    top_w = torch.empty(shape, dtype=depth.dtype, device=depth.device)
    ids_k = torch.empty(shape, dtype=torch.int32, device=depth.device)
    idx = torch.empty(shape, dtype=torch.uint8, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    rc = fn(depth.data_ptr(), ids.data_ptr(), top_w.data_ptr(), ids_k.data_ptr(),
            idx.data_ptr(), depth.numel() // D, D, k, int(depth.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError(f'topk_select kernel launch failed: CUDA error {rc}')
    topk_select.launches += 1
    return top_w, ids_k, idx


class _TopkSelect(torch.autograd.Function):
    """The select with its backward kernel; the ids get no gradient."""

    @staticmethod
    def forward(ctx, depth, ids, k):
        top_w, ids_k, idx = torch.ops.fiery_torch.topk_select(depth, ids, k)
        ctx.save_for_backward(idx)
        ctx.D = depth.shape[-1]
        ctx.mark_non_differentiable(ids_k, idx)
        ctx.set_materialize_grads(False)
        return top_w, ids_k, idx

    @staticmethod
    def backward(ctx, g, g_ids, g_idx):
        if g is None:
            return None, None, None
        idx, = ctx.saved_tensors
        return topk_select_backward(g.contiguous(), idx, ctx.D), None, None


def topk_select(depth, ids, k):
    """Exact top-k depth bins of each pixel (kernel K5, csrc/topk_select.cu),
    differentiable in depth.

    depth (..., D) float32 or bfloat16 weights, ids (..., D) int32 voxel ids ->
    (top_w (..., k) in depth's dtype, ids_k (..., k) int32, idx (..., k) uint8): the
    JAX package's ``_topk_select_nosort`` set (ties at the k-th weight take the
    lowest bins) in ascending bin order, and the selected bins. The gradient of
    top_w flows back to the selected bins (``topk_select_backward``). The forward is
    ``torch.ops.fiery_torch.topk_select`` (ops/library.py): a CPU tensor takes the
    plain versions; a CUDA tensor launches the kernels.
    """
    _check_topk_inputs(depth, ids, k)
    if torch.is_grad_enabled() and depth.requires_grad:
        return _TopkSelect.apply(depth, ids, k)
    return torch.ops.fiery_torch.topk_select(depth, ids, k)     # no graph to record


topk_select.launches = 0


def topk_select_backward(g, idx, D):
    """Gradient of ``topk_select`` with respect to depth (kernel K5 backward,
    csrc/topk_select.cu): g (..., k) -> d_depth (..., D) of g's dtype, with
    d_depth[..., idx[..., j]] = g[..., j] and zero elsewhere. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    if idx.shape != g.shape or idx.dtype != torch.uint8:
        raise ValueError(f'topk_select_backward: idx must be uint8 shaped as g '
                         f'{tuple(g.shape)}, got {idx.dtype} {tuple(idx.shape)}')
    if g.device.type == 'cpu':
        return topk_select_backward_plain(g, idx, D)
    k = g.shape[-1]
    if (g.device.type != 'cuda' or idx.device != g.device
            or g.dtype not in (torch.float32, torch.bfloat16)
            or not (g.is_contiguous() and idx.is_contiguous()) or not 1 <= k <= D <= 64):
        raise ValueError(f'topk_select_backward: g must be contiguous float32 or bfloat16 '
                         f'on the device of idx with 1 <= k <= D <= 64, got {g.dtype} on '
                         f'{g.device}, k = {k}, D = {D}')
    fn = _build.load('topk_select').fiery_topk_select_backward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    d_depth = torch.empty(g.shape[:-1] + (D,), dtype=g.dtype, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = fn(g.data_ptr(), idx.data_ptr(), d_depth.data_ptr(), g.numel() // k, D, k,
            int(g.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f'topk_select_backward kernel launch failed: CUDA error {rc}')
    topk_select_backward.launches += 1
    return d_depth


topk_select_backward.launches = 0


def lift_splat_topk(depth, feat, geometry, k, bev_resolution, bev_start_position,
                    bev_dimension):
    """The sparse top-k splat (LIFT.TOPK): only the k largest depth bins of each
    pixel enter the splat. depth (B, N, h, w, D), features (B, N, h, w, C), geometry
    (B, N, D, h, w, 3) -> (B, X, Y, C). ``topk_select`` (K5) picks the bins and their
    voxel ids, and ``bev_pool`` (K1) splats them at D = k; the k-wide lifted volume
    is never built, and the gradient runs through K1's backward and then K5's."""
    B, C = depth.shape[0], feat.shape[-1]
    X, Y, Z = (int(d) for d in bev_dimension)
    ids = voxel_ids(geometry, bev_resolution, bev_start_position, bev_dimension)
    ids = ids.permute(0, 1, 3, 4, 2).contiguous()                 # (B, N, h, w, D)
    top_w, ids_k, _ = topk_select(depth.contiguous(), ids, k)
    out = bev_pool(top_w, feat.contiguous(), ids_k, X * Y * Z, Z)
    return out.view(B, X, Y, C)


def compute_depth_plane_keep(frustum, intrinsics, extrinsics, bev_resolution,
                             bev_start_position, bev_dimension, t_margin=0.5,
                             rot_margin_deg=2.0):
    """Per-camera keep count of leading depth planes (static far-plane culling,
    LIFT.DEPTH_CULL), in numpy over observed calibrations.

    A depth plane of camera n can be culled when, for every observed pose, every
    point of it lies outside the XY BEV box widened by the slack
    ``t_margin + d_cam * sin(rot_margin)`` (d_cam: the distance from the camera),
    which bounds how far a point moves under any pose within the margins of an
    observed one. Only a contiguous far range is culled.

    frustum (D, h, w, 3); intrinsics / extrinsics (..., N, 3, 3) / (..., N, 4, 4)
    over any number of observed frames. Returns np.int32 (N,) keep counts.
    """
    frustum = np.asarray(frustum)
    intr = np.asarray(intrinsics, np.float64).reshape(-1, *intrinsics.shape[-3:])
    extr = np.asarray(extrinsics, np.float64).reshape(-1, *extrinsics.shape[-3:])
    n_obs, N = intr.shape[0], intr.shape[1]
    D = frustum.shape[0]
    res = np.asarray(bev_resolution, np.float64)
    start = np.asarray(bev_start_position, np.float64)
    dim = np.asarray(bev_dimension)
    # the XY box of bins [0, dim), widened by one bin: voxel_ids truncates, so the
    # (-1, 0) fractional bin lands in bin 0
    lo = start[:2] - res[:2] / 2.0 - res[:2]
    hi = start[:2] - res[:2] / 2.0 + dim[:2] * res[:2] + res[:2]
    points = np.concatenate([frustum[..., :2] * frustum[..., 2:3], frustum[..., 2:3]],
                            axis=-1)
    rot_sin = np.sin(np.radians(rot_margin_deg))
    keep = np.zeros((N,), np.int32)
    for n in range(N):
        needed = np.zeros((D,), bool)
        for o in range(n_obs):
            R, t = extr[o, n, :3, :3], extr[o, n, :3, 3]
            combined = R @ np.linalg.inv(intr[o, n])
            pts = np.einsum('ij,dhwj->dhwi', combined, points) + t   # (D, h, w, 3)
            slack = t_margin + np.linalg.norm(pts - t, axis=-1) * rot_sin
            inside = ((pts[..., 0] > lo[0] - slack) & (pts[..., 0] < hi[0] + slack)
                      & (pts[..., 1] > lo[1] - slack) & (pts[..., 1] < hi[1] + slack))
            needed |= inside.any(axis=(1, 2))
        # contiguous far cull: keep through the last needed plane
        keep[n] = int(np.max(np.nonzero(needed)[0])) + 1 if needed.any() else 1
    return keep
