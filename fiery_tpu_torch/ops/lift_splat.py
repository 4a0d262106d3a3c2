"""Camera-to-BEV lifting (Lift-Splat) in PyTorch, channels-last.

Counterpart of fiery_tpu/ops/lift_splat.py. Every frustum point keeps a fixed
slot: out-of-bounds points are routed to a dump bin (id X*Y*Z) that is dropped.
The main path (``lift_splat_depth``) never materialises the (P, C) lifted volume:
the ``bev_pool`` kernel (csrc/bev_pool.cu) multiplies depth and features on the
fly while it splats, and its backward kernel gathers the output gradient rows and
contracts them with features and depth without building it either. ``lift_splat``
keeps the JAX signature over a lifted volume and is the plain reference form.
"""

import ctypes

import numpy as np
import torch

from fiery_tpu_torch.ops import _build


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
    combined = rotation @ torch.linalg.inv(intrinsics)
    pts = torch.einsum('...ij,dhwj->...dhwi', combined, points)
    return pts + translation[..., None, None, None, :]


def voxel_ids(geometry, bev_resolution, bev_start_position, bev_dimension):
    """Flat int32 BEV bin ids of ego-frame points (..., 3); out of bounds -> X*Y*Z.

    Computed in geometry's dtype. Trunc (toward zero), not floor: fractional bins
    in (-1, 0) land in bin 0 and survive the bounds check, as in the reference.
    """
    res = torch.as_tensor(np.asarray(bev_resolution), dtype=geometry.dtype,
                          device=geometry.device)
    start = torch.as_tensor(np.asarray(bev_start_position), dtype=geometry.dtype,
                            device=geometry.device)
    X, Y, Z = (int(d) for d in bev_dimension)
    vox = torch.trunc((geometry - (start - res / 2.0)) / res).to(torch.int32)
    dim = torch.tensor([X, Y, Z], dtype=torch.int32, device=geometry.device)
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


def _check_pool_inputs(name, depth, feat, ids, num_bins, z_bins):
    S, N, h, w, D = depth.shape
    C = feat.shape[-1]
    if feat.shape != (S, N, h, w, C) or ids.shape != depth.shape:
        raise ValueError(f'{name}: shapes depth {tuple(depth.shape)}, feat '
                         f'{tuple(feat.shape)}, ids {tuple(ids.shape)} do not agree')
    if num_bins % z_bins:
        raise ValueError(f'{name}: num_bins {num_bins} is not a multiple of {z_bins}')
    if depth.device.type == 'cpu':
        return
    if depth.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {depth.device}')
    if depth.dtype not in (torch.float32, torch.bfloat16) or feat.dtype != depth.dtype:
        raise TypeError(f'{name}: depth/feat must share float32 or bfloat16, got '
                        f'{depth.dtype}/{feat.dtype}')
    if ids.dtype != torch.int32:
        raise TypeError(f'{name}: ids must be int32, got {ids.dtype}')
    if not (depth.is_contiguous() and feat.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f'{name}: inputs must be contiguous')
    if not (feat.device == depth.device == ids.device):
        raise ValueError(f'{name}: inputs must be on one device')


class _BevPool(torch.autograd.Function):
    """The fused splat with its backward kernel; the ids get no gradient."""

    @staticmethod
    def forward(ctx, depth, feat, ids, num_bins, z_bins):
        ctx.save_for_backward(depth, feat, ids)
        ctx.num_bins, ctx.z_bins = num_bins, z_bins
        if depth.device.type == 'cpu':
            return bev_pool_plain(depth, feat, ids, num_bins, z_bins)
        S, N, h, w, D = depth.shape
        C = feat.shape[-1]
        fn = _build.load('bev_pool').fiery_bev_pool
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.zeros((S, num_bins // z_bins, C), dtype=torch.float32,
                          device=depth.device)
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        rc = fn(depth.data_ptr(), feat.data_ptr(), ids.data_ptr(), out.data_ptr(),
                S * N * h * w, N * h * w, D, C, num_bins, z_bins,
                int(depth.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f'bev_pool kernel launch failed: CUDA error {rc}')
        bev_pool.launches += 1
        return out if depth.dtype == torch.float32 else out.to(depth.dtype)

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
    accumulated in f32 and cast to depth's dtype; its backward is
    ``bev_pool_backward``. A CPU tensor takes the plain versions; a CUDA tensor
    launches the kernels.
    """
    _check_pool_inputs('bev_pool', depth, feat, ids, num_bins, z_bins)
    return _BevPool.apply(depth, feat, ids, num_bins, z_bins)


bev_pool.launches = 0


def bev_pool_backward(depth, feat, ids, g, num_bins, z_bins=1):
    """Gradients of ``bev_pool`` (kernel K1 backward, csrc/bev_pool.cu): g
    (S, num_bins // z_bins, C) in depth's dtype -> (d_depth, d_feat), shaped and
    typed as depth and feat, summed in f32. For each frustum row p and bin d with
    id = ids[p, d] not the dump bin, r = g[s, id // z_bins]:
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
    fn = _build.load('bev_pool').fiery_bev_pool_backward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    d_depth = torch.empty_like(depth)
    d_feat = torch.empty_like(feat)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    rc = fn(depth.data_ptr(), feat.data_ptr(), ids.data_ptr(), g.data_ptr(),
            d_depth.data_ptr(), d_feat.data_ptr(), S * N * h * w, N * h * w, D, C,
            num_bins, z_bins, int(depth.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f'bev_pool_backward kernel launch failed: CUDA error {rc}')
    bev_pool_backward.launches += 1
    return d_depth, d_feat


bev_pool_backward.launches = 0


def lift_splat_depth(depth, feat, geometry, bev_resolution, bev_start_position,
                     bev_dimension):
    """The serving splat: depth (B, N, h, w, D), features (B, N, h, w, C) and
    geometry (B, N, D, h, w, 3) -> (B, X, Y, C), through ``bev_pool``. The ids are
    reordered to the (h, w, D) layout of depth instead of transposing features."""
    B, C = depth.shape[0], feat.shape[-1]
    X, Y, Z = (int(d) for d in bev_dimension)
    ids = voxel_ids(geometry, bev_resolution, bev_start_position, bev_dimension)
    ids = ids.permute(0, 1, 3, 4, 2).contiguous()
    out = bev_pool(depth.contiguous(), feat.contiguous(), ids, X * Y * Z, Z)
    return out.view(B, X, Y, C)
