"""SE(2) ego-motion warps of channels-last BEV maps (counterpart of fiery_tpu/ops/warp.py).

torch ``grid_sample`` parity: align_corners=False, zero padding, the reference's
forward-axis sign flip and (tx, ty) swap. The bilinear warp runs in the
``bev_warp`` kernel (csrc/bev_warp.cu) on the card; its plain version below is
the same arithmetic in the same order, with every division a multiplication by
a reciprocal (as PyTorch's CUDA division by a scalar computes it), so that the two
agree on CPU and card alike. theta and the sampling grid are rounded to the feature
dtype (as the JAX package computes them in x.dtype); the 4-tap blend is f32,
rounded once.
"""

import ctypes

import torch

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.utils.geometry import mat2pose_vec, pose_vec2mat


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


def _grid_sample_bilinear(image, grid):
    """Bilinear sample of f32 image (B, H, W, C) at f32 grid (B, Ho, Wo, 2)."""
    B, H, W, _ = image.shape
    ix = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - x0, iy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    bi = torch.arange(B, device=image.device).view(B, 1, 1)

    def tap(yf, xf):
        valid = (xf >= 0) & (xf < W) & (yf >= 0) & (yf < H)
        xi = xf.clamp(0, W - 1).long()
        yi = yf.clamp(0, H - 1).long()
        return image[bi, yi, xi] * valid[..., None].to(image.dtype)

    return (tap(y0, x0) * (wy0 * wx0)[..., None]
            + tap(y0, x0 + 1) * (wy0 * wx1)[..., None]
            + tap(y0 + 1, x0) * (wy1 * wx0)[..., None]
            + tap(y0 + 1, x0 + 1) * (wy1 * wx1)[..., None])


def bev_warp_plain(x, pose, spatial_extent):
    """Plain version of ``bev_warp``."""
    H, W = x.shape[1:3]
    theta = _warp_theta(pose.float(), spatial_extent, x.dtype)
    grid = _affine_grid(theta, H, W).to(x.dtype).float()
    return _grid_sample_bilinear(x.float(), grid).to(x.dtype)


def bev_warp(x, pose, spatial_extent):
    """SE(2) bilinear warp (kernel K2, csrc/bev_warp.cu).

    x (B, H, W, C) float32 or bfloat16, channels-last; pose (B, 6) float32;
    spatial_extent (extent_x, extent_y) in metres. Returns x warped by each pose,
    same shape and dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel.
    """
    if x.dim() != 4 or pose.shape != (x.shape[0], 6):
        raise ValueError(f'bev_warp: x {tuple(x.shape)} must be (B, H, W, C) and pose '
                         f'{tuple(pose.shape)} (B, 6)')
    if x.device.type == 'cpu':
        return bev_warp_plain(x, pose, spatial_extent)
    if x.device.type != 'cuda' or pose.device != x.device:
        raise ValueError(f'bev_warp: x on {x.device}, pose on {pose.device}')
    if x.dtype not in (torch.float32, torch.bfloat16) or pose.dtype != torch.float32:
        raise TypeError(f'bev_warp: x must be float32 or bfloat16 and pose float32, got '
                        f'{x.dtype}/{pose.dtype}')
    if not (x.is_contiguous() and pose.is_contiguous()):
        raise ValueError('bev_warp: inputs must be contiguous')
    lib = _build.load('bev_warp')
    fn = lib.fiery_bev_warp
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 \
        + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), pose.data_ptr(), out.data_ptr(), B, H, W, C,
            1.0 / spatial_extent[0], 1.0 / spatial_extent[1], 1.0 / W, 1.0 / H,
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f'bev_warp kernel launch failed: CUDA error {rc}')
    bev_warp.launches += 1
    return out


bev_warp.launches = 0


def warp_features(x, flow, mode='bilinear', spatial_extent=None):
    """SE(2) warp of BEV maps x (b, H, W, C) by pose vectors flow (b, 6). H is the
    forward (X) axis, W the sides (Y) axis. Only the bilinear mode is ported."""
    if flow is None:
        return x
    if mode != 'bilinear':
        raise NotImplementedError(f'warp mode {mode!r}: only bilinear is ported')
    return bev_warp(x.contiguous(), flow.float().contiguous(), spatial_extent)


def compose_poses_to_present(flow):
    """(b, t, 6) incremental poses -> (b, t-1, 6): entry i is flow[i] @ ... @ flow[t-2]."""
    seq_len = flow.shape[1]
    flow_mat = pose_vec2mat(flow)
    mats = [flow_mat[:, -2]]
    for t in reversed(range(seq_len - 2)):
        mats.append(flow_mat[:, t] @ mats[-1])
    return mat2pose_vec(torch.stack(mats[::-1], dim=1))


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
