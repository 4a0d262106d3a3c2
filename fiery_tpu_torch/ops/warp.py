"""SE(2) ego-motion warps of channels-last BEV maps (counterpart of fiery_tpu/ops/warp.py).

torch ``grid_sample`` parity: align_corners=False, zero padding, the reference's
forward-axis sign flip and (tx, ty) swap. Three kernels of csrc/bev_warp.cu run the
warps on the card: ``bev_warp`` (bilinear, the features), ``bev_warp_backward``
(its gradient with respect to the features, a gather: each input pixel sums the
output pixels whose taps land on it) and ``bev_warp_nearest`` (the label maps).
Their plain versions below are the same arithmetic in the same order, with every
division a multiplication by a reciprocal (as PyTorch's CUDA division by a scalar
computes it), so that the two agree on CPU and card alike. theta and the sampling
grid are rounded to the feature dtype (as the JAX package computes them in x.dtype);
the 4-tap blend is f32, rounded once. The kernels' f32 cos and sin can differ from
the host's in the last bit; ``card_theta`` gives theta as the kernels compute it,
and the plain versions on the host, given that theta, compute what the kernels do.
The bilinear forward is the operator ``torch.ops.fiery_torch.bev_warp``
(ops/library.py; CUDA implementation ``bev_warp_card``).
"""

import ctypes
import functools

import torch

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.utils.geometry import (invert_pose_matrix, mat2pose_vec,
                                            pose_vec2mat)


def _warp_theta(flow, spatial_extent, dtype):
    """(b, 6) pose vectors -> (b, 2, 3) theta: rows [cos, -sin, ty], [sin, cos, tx]
    with tx = -flow_x / extent_x (forward axis inverted), ty = flow_y / extent_y."""
    angle = flow[:, 5]
    tx = -flow[:, 0] * (1.0 / spatial_extent[0])
    ty = flow[:, 1] * (1.0 / spatial_extent[1])
    cos_t, sin_t = torch.cos(angle), torch.sin(angle)
    return torch.stack([cos_t, -sin_t, ty, sin_t, cos_t, tx],
                       dim=-1).view(-1, 2, 3).to(dtype)


def _affine_grid(theta, H, W):
    """F.affine_grid parity (align_corners=False) in f32: (b, 2, 3) -> (b, H, W, 2),
    grid[..., 0] indexing W and grid[..., 1] indexing H."""
    t = theta.float()
    xs = (2.0 * torch.arange(W, dtype=torch.float32, device=t.device) + 1.0) * (1.0 / W) - 1.0
    ys = (2.0 * torch.arange(H, dtype=torch.float32, device=t.device) + 1.0) * (1.0 / H) - 1.0
    bx, by = xs[None, None, :], ys[None, :, None]
    gx = t[:, 0, 0, None, None] * bx + t[:, 0, 1, None, None] * by + t[:, 0, 2, None, None]
    gy = t[:, 1, 0, None, None] * bx + t[:, 1, 1, None, None] * by + t[:, 1, 2, None, None]
    return torch.stack([gx, gy], dim=-1)


def _sample_coords(pose, shape, dtype, spatial_extent, theta=None):
    """(ix, iy), each (B, H, W) f32: where each output pixel samples the input, in
    input pixels. theta and the grid are rounded to ``dtype``; theta is computed from
    the pose unless given."""
    _, H, W = shape[:3]
    if theta is None:
        theta = _warp_theta(pose.float(), spatial_extent, dtype)
    grid = _affine_grid(theta, H, W).to(dtype).float()
    ix = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    return ix, iy


def _bilinear_taps(ix, iy, H, W):
    """The four taps of each sample point: [(flat pixel index, weight), ...], each
    (B, H, W); an out-of-map tap has weight 0 (and a clamped index)."""
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - x0, iy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    taps = []
    for yf, xf, w in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                      (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        valid = (xf >= 0) & (xf < W) & (yf >= 0) & (yf < H)
        flat = yf.clamp(0, H - 1).long() * W + xf.clamp(0, W - 1).long()
        taps.append((flat, w * valid.to(w.dtype)))
    return taps


def _gather(image, flat):
    """image (B, H, W, C), flat (B, Ho, Wo) pixel indices -> (B, Ho, Wo, C)."""
    B, C = image.shape[0], image.shape[-1]
    bi = torch.arange(B, device=image.device).view(B, 1, 1)
    return image.reshape(B, -1, C)[bi, flat]


def bev_warp_plain(x, pose, spatial_extent, theta=None):
    """Plain version of ``bev_warp``: four gathers blended in f32, rounded once.
    theta (B, 2, 3) in x's dtype replaces the one computed from the pose, as in
    ``bev_warp_backward_plain``."""
    B, H, W, _ = x.shape
    ix, iy = _sample_coords(pose, x.shape, x.dtype, spatial_extent,
                            None if theta is None else theta.to(x.device))
    xf = x.float()
    out = None
    for flat, w in _bilinear_taps(ix, iy, H, W):
        term = _gather(xf, flat) * w[..., None]
        out = term if out is None else out + term
    return out.to(x.dtype)


def bev_warp_backward_plain(g, pose, spatial_extent, theta=None):
    """Plain version of ``bev_warp_backward``: the gradient of ``bev_warp`` with
    respect to x, each output value's g scattered into its four taps with f32
    ``index_add_``, rounded once to g's dtype (the forward's x dtype). theta (B, 2, 3)
    in g's dtype replaces the one computed from the pose: ``card_theta``'s, to hold
    the kernel to this version on the host."""
    B, H, W, C = g.shape
    ix, iy = _sample_coords(pose, g.shape, g.dtype, spatial_extent,
                            None if theta is None else theta.to(g.device))
    gf = g.float()
    dx = torch.zeros((B * H * W, C), dtype=torch.float32, device=g.device)
    base = (torch.arange(B, device=g.device) * (H * W)).view(B, 1, 1)
    for flat, w in _bilinear_taps(ix, iy, H, W):
        dx.index_add_(0, (flat + base).view(-1), (gf * w[..., None]).view(-1, C))
    return dx.view(B, H, W, C).to(g.dtype)


def bev_warp_nearest_plain(x, pose, spatial_extent):
    """Plain version of ``bev_warp_nearest``: torch.round (half to even) of the
    sample point, zero outside the map."""
    _, H, W, _ = x.shape
    ix, iy = _sample_coords(pose, x.shape, x.dtype, spatial_extent)
    xr, yr = torch.round(ix), torch.round(iy)
    valid = (xr >= 0) & (xr < W) & (yr >= 0) & (yr < H)
    flat = yr.clamp(0, H - 1).long() * W + xr.clamp(0, W - 1).long()
    return _gather(x, flat) * valid[..., None].to(x.dtype)


def _check_shapes(name, x, pose):
    if x.dim() != 4 or pose.shape != (x.shape[0], 6):
        raise ValueError(f'{name}: x {tuple(x.shape)} must be (B, H, W, C) and pose '
                         f'{tuple(pose.shape)} (B, 6)')


def _check_card(name, x, pose):
    """What the kernels take: CUDA tensors on one device, float32 or bfloat16 maps,
    float32 poses, contiguous."""
    if x.device.type != 'cuda' or pose.device != x.device:
        raise ValueError(f'{name}: x on {x.device}, pose on {pose.device}')
    if x.dtype not in (torch.float32, torch.bfloat16) or pose.dtype != torch.float32:
        raise TypeError(f'{name}: x must be float32 or bfloat16 and pose float32, got '
                        f'{x.dtype}/{pose.dtype}')
    if not (x.is_contiguous() and pose.is_contiguous()):
        raise ValueError(f'{name}: inputs must be contiguous')


def _scalars(x, spatial_extent):
    H, W = x.shape[1:3]
    return (1.0 / spatial_extent[0], 1.0 / spatial_extent[1], 1.0 / W, 1.0 / H,
            int(x.dtype == torch.bfloat16))


# the forward kernels' launch (csrc/bev_warp.cu ``warp_tile``): 256 threads a block,
# tiles of TILE_W output columns
FWD_THREADS = 256
TILE_W = 8


def access_width(C, itemsize, align):
    """V, the channels a lane of the forward kernels moves with one access: the
    widest power of two with V * itemsize <= 16 bytes that divides C and whose bytes
    divide ``align`` (the OR of the input's and output's addresses, mod 16). 16
    bytes for 64 channels of bf16 or f32. Raises where no access the kernels take
    (16, 8, 4 or 2 bytes, one or more whole values) fits the addresses."""
    if align % itemsize:
        raise ValueError(f'bev_warp: addresses aligned to {align & -align} bytes; the '
                         f'kernels take accesses of whole {itemsize}-byte values')
    V = 16 // itemsize
    while V > 1 and (C % V or align % (V * itemsize)):
        V //= 2
    return V


@functools.lru_cache(maxsize=None)
def warp_plan(B, H, W, C, itemsize, align):
    """The forward kernels' launch plan (vec, log2g, tile_h, tiles_w, blocks): vec
    channels an access (``access_width``); 2^log2g lanes an output pixel, the
    accesses of a pixel rounded up to a power of two, at most 32 (a lane loops over
    the rest); tiles of TILE_W x tile_h output pixels, tile_h enough for one pass of
    the block's lane groups and at least 8; blocks, B maps of tiles. Raises for a
    map the kernels do not take (H W C >= 2^31: their offsets inside a map are
    32-bit)."""
    if H * W * C >= 2 ** 31:
        raise ValueError(f'bev_warp: a {H} x {W} x {C} map has 2^31 values or more')
    V = access_width(C, itemsize, align)
    log2g = min(5, (C // V - 1).bit_length())
    tile_h = max(8, (FWD_THREADS >> log2g) // TILE_W)
    tiles_w = -(-W // TILE_W)
    blocks = B * tiles_w * -(-H // tile_h)
    if blocks >= 2 ** 31:
        raise ValueError(f'bev_warp: {B} maps of {H} x {W} need {blocks} blocks')
    return V, log2g, tile_h, tiles_w, blocks


_ARGTYPES = {
    'fiery_bev_warp': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
    + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_void_p],
    'fiery_bev_warp_backward': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_float] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    'fiery_bev_warp_theta': [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float] * 2
    + [ctypes.c_int, ctypes.c_void_p],
    'fiery_bev_warp_gather_entries': [ctypes.c_int] * 3,
}


@functools.lru_cache(maxsize=None)
def _kernel(name):
    """A ctypes entry of csrc/bev_warp.cu, its argument types set once."""
    fn = getattr(_build.load('bev_warp'), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch_warp(x, pose, spatial_extent, nearest):
    """fiery_bev_warp on the card (bilinear or nearest), planned by ``warp_plan``."""
    out = torch.empty_like(x)
    xp, op = x.data_ptr(), out.data_ptr()
    plan = warp_plan(*x.shape, x.element_size(), (xp | op) & 15)
    rc = _kernel('fiery_bev_warp')(xp, pose.data_ptr(), op, *x.shape,
                                   *_scalars(x, spatial_extent), int(nearest), *plan,
                                   torch._C._cuda_getCurrentRawStream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f'bev_warp kernel launch failed: CUDA error {rc}')
    return out


def card_theta(pose, spatial_extent, dtype):
    """theta (B, 2, 3) in ``dtype`` as the kernels compute it from pose (B, 6), a
    float32 CUDA tensor (csrc/bev_warp.cu ``make_theta``): what ``_warp_theta``
    computes, with the card's f32 cos and sin. Given it, the plain versions on the
    host compute what the kernels compute."""
    if pose.device.type != 'cuda' or pose.dtype != torch.float32 or not pose.is_contiguous():
        raise ValueError('card_theta: pose must be a contiguous float32 CUDA tensor')
    theta = torch.empty((pose.shape[0], 2, 3), dtype=dtype, device=pose.device)
    rc = _kernel('fiery_bev_warp_theta')(
        pose.data_ptr(), theta.data_ptr(), pose.shape[0], 1.0 / spatial_extent[0],
        1.0 / spatial_extent[1], int(dtype == torch.bfloat16),
        torch.cuda.current_stream(pose.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'bev_warp theta kernel launch failed: CUDA error {rc}')
    return theta


@functools.lru_cache(maxsize=None)
def _gather_entries(H, W, dtype):
    """Output pixels a K2 backward block stages for an H x W map; 0 beyond the
    kernel's staging."""
    return _kernel('fiery_bev_warp_gather_entries')(H, W, int(dtype == torch.bfloat16))


def bev_warp_card(x, pose, extent_x, extent_y):
    """K2 forward on the card, the CUDA implementation of
    ``torch.ops.fiery_torch.bev_warp``: one launch of fiery_bev_warp (bilinear), which
    computes theta from the pose itself."""
    _check_card('bev_warp', x, pose)
    out = _launch_warp(x, pose, (extent_x, extent_y), nearest=False)
    bev_warp.launches += 1
    return out


class _BevWarp(torch.autograd.Function):
    """The bilinear warp with its backward kernel; the pose is input data and gets
    no gradient."""

    @staticmethod
    def forward(ctx, x, pose, spatial_extent):
        ctx.save_for_backward(pose)
        ctx.spatial_extent = spatial_extent
        return torch.ops.fiery_torch.bev_warp(x, pose, *spatial_extent)

    @staticmethod
    def backward(ctx, g):
        (pose,) = ctx.saved_tensors
        return bev_warp_backward(g.contiguous(), pose, ctx.spatial_extent), None, None


def bev_warp(x, pose, spatial_extent):
    """SE(2) bilinear warp (kernel K2, csrc/bev_warp.cu), differentiable in x.

    x (B, H, W, C) float32 or bfloat16, channels-last; pose (B, 6) float32;
    spatial_extent (extent_x, extent_y) in metres. Returns x warped by each pose,
    same shape and dtype; its backward is ``bev_warp_backward``. The forward is
    ``torch.ops.fiery_torch.bev_warp`` (ops/library.py), the extents its float
    arguments: a CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels.
    """
    _check_shapes('bev_warp', x, pose)
    if torch.is_grad_enabled() and x.requires_grad:
        return _BevWarp.apply(x, pose, spatial_extent)
    return torch.ops.fiery_torch.bev_warp(x, pose, *spatial_extent)   # no graph to record


bev_warp.launches = 0


def bev_warp_backward(g, pose, spatial_extent):
    """Gradient of ``bev_warp`` with respect to x (kernel K2 backward,
    csrc/bev_warp.cu): g (B, H, W, C) in the forward's dtype -> dx, same shape and
    dtype, summed in f32 in the plain version's order and rounded once; one launch
    writes dx whole, NaN in every value of a map whose pose is not finite. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    _check_shapes('bev_warp_backward', g, pose)
    if g.device.type == 'cpu':
        return bev_warp_backward_plain(g, pose, spatial_extent)
    _check_card('bev_warp_backward', g, pose)
    B, H, W, C = g.shape
    cap = _gather_entries(H, W, g.dtype)
    if not cap:
        raise ValueError(f'bev_warp_backward: a {H} x {W} map needs more staged output '
                         'pixels a block than the kernel holds')
    dx = torch.empty_like(g)
    vec = C % 8 == 0 and g.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = _kernel('fiery_bev_warp_backward')(
        g.data_ptr(), pose.data_ptr(), dx.data_ptr(), B, H, W, C,
        *_scalars(g, spatial_extent), int(vec), cap, stream)
    if rc != 0:
        raise RuntimeError(f'bev_warp_backward kernel launch failed: CUDA error {rc}')
    bev_warp_backward.launches += 1
    return dx


bev_warp_backward.launches = 0


def bev_warp_nearest(x, pose, spatial_extent):
    """SE(2) nearest warp (kernel K4, the nearest mode of csrc/bev_warp.cu), for label
    maps: no gradient. Same arguments as ``bev_warp``. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if x.requires_grad:
        raise ValueError('bev_warp_nearest has no gradient; it warps label maps')
    _check_shapes('bev_warp_nearest', x, pose)
    if x.device.type == 'cpu':
        return bev_warp_nearest_plain(x, pose, spatial_extent)
    _check_card('bev_warp_nearest', x, pose)
    out = _launch_warp(x, pose, spatial_extent, nearest=True)
    bev_warp_nearest.launches += 1
    return out


bev_warp_nearest.launches = 0

_WARPS = {'bilinear': bev_warp, 'nearest': bev_warp_nearest}


def warp_features(x, flow, mode='bilinear', spatial_extent=None):
    """SE(2) warp of BEV maps x (b, H, W, C) by pose vectors flow (b, 6), bilinear
    or nearest. H is the forward (X) axis, W the sides (Y) axis."""
    if flow is None:
        return x
    if mode not in _WARPS:
        raise ValueError(f'warp mode {mode!r}: expected one of {sorted(_WARPS)}')
    return _WARPS[mode](x.contiguous(), flow.float().contiguous(), spatial_extent)


def compose_poses_to_present(flow):
    """(b, t, 6) incremental poses -> (b, t-1, 6): entry i is flow[i] @ ... @ flow[t-2]."""
    seq_len = flow.shape[1]
    flow_mat = pose_vec2mat(flow)
    mats = [flow_mat[:, -2]]
    for t in reversed(range(seq_len - 2)):
        mats.append(flow_mat[:, t] @ mats[-1])
    return mat2pose_vec(torch.stack(mats[::-1], dim=1))


def warp_points_to_present(points_xy, flow, spatial_extent, bev_bounds):
    """Map frame-t metric BEV points (..., 2) to the present frame: the inverse of
    ``warp_features``' sampling affine in point space, so that past frames splat
    straight into the present grid (the warp-free lift, LIFT.WARP_FREE).

    points_xy's leading axis matches flow (b, 6); bev_bounds ((x_lo, x_hi),
    (y_lo, y_hi)). Computed in the points' dtype, in the JAX package's order of
    operations: a rotation with aspect a = h_x / h_y about the grid centre, after
    the extent-scaled translation."""
    (x_lo, x_hi), (y_lo, y_hi) = bev_bounds
    c_x, h_x = (x_lo + x_hi) / 2.0, (x_hi - x_lo) / 2.0
    c_y, h_y = (y_lo + y_hi) / 2.0, (y_hi - y_lo) / 2.0
    a = h_x / h_y
    dt = points_xy.dtype
    angle = flow[:, 5].to(dt)
    # the theta translation in metric units of the output grid's axes
    fx = (flow[:, 0] * (h_x / spatial_extent[0])).to(dt)
    fy = (flow[:, 1] * (h_y / spatial_extent[1])).to(dt)
    shape = (-1,) + (1,) * (points_xy.dim() - 2)
    cos_t, sin_t = torch.cos(angle).view(shape), torch.sin(angle).view(shape)
    p = points_xy[..., 0] - c_x + fx.view(shape)
    q = points_xy[..., 1] - c_y - fy.view(shape)
    x_p = c_x + cos_t * p - (a * sin_t) * q
    y_p = c_y + (sin_t / a) * p + cos_t * q
    return torch.stack([x_p, y_p], dim=-1)


def cumulative_warp_features(x, flow, mode='bilinear', spatial_extent=None):
    """Warp past BEV frames x (b, t, H, W, C) to the present by the composed poses
    of flow (b, t, 6); the present frame x[:, -1] is unchanged."""
    b, seq_len = x.shape[:2]
    if seq_len == 1:
        return x
    poses = compose_poses_to_present(flow)
    warped = warp_features(
        x[:, :-1].reshape(b * (seq_len - 1), *x.shape[2:]),
        poses.reshape(b * (seq_len - 1), 6), mode=mode, spatial_extent=spatial_extent,
    ).view(b, seq_len - 1, *x.shape[2:])
    return torch.cat([warped, x[:, -1:]], dim=1)


def cumulative_warp_features_reverse(x, flow, mode='nearest', spatial_extent=None):
    """Warp future BEV frames x (b, t, H, W, C) back to the present frame (label
    preparation): x[:, 0] is unchanged, x[:, i] is warped by
    inv(flow[0]) @ ... @ inv(flow[i-1]), flow (b, t, 6)."""
    b, seq_len = x.shape[:2]
    if seq_len == 1:
        return x
    inv = invert_pose_matrix(pose_vec2mat(flow))
    mats = [inv[:, 0]]
    for i in range(2, seq_len):
        mats.append(mats[-1] @ inv[:, i - 1])
    poses = mat2pose_vec(torch.stack(mats, dim=1))
    warped = warp_features(
        x[:, 1:].reshape(b * (seq_len - 1), *x.shape[2:]),
        poses.reshape(b * (seq_len - 1), 6), mode=mode, spatial_extent=spatial_extent,
    ).view(b, seq_len - 1, *x.shape[2:])
    return torch.cat([x[:, :1], warped], dim=1)
