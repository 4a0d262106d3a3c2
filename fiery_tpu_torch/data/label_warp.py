"""Numpy pose helpers, the nearest SE(2) warp and the host label prewarp.

A copy of fiery_tpu/data/label_warp.py: the pose conversions of utils/geometry.py
and the nearest warp of ops/warp.py in numpy, f32 throughout, so that the synthetic
dataset makes the same labels as the JAX package's; and the label stack's warp to
the present frame (``warp_label_stack``), which DATASET.PREWARP_LABELS runs on the
host between steps (``PrewarpTransform``), so that the training step takes the
warped stack as it is and no label warp (kernel K4) runs on the card.
"""

import numpy as np


def _euler2mat(angle):
    """(..., 3) [rx, ry, rz] -> (..., 3, 3), R = Rx @ Ry @ Rz (f32)."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    cosz, sinz = np.cos(z), np.sin(z)
    cosy, siny = np.cos(y), np.sin(y)
    cosx, sinx = np.cos(x), np.sin(x)
    zeros = np.zeros_like(z)
    ones = np.ones_like(z)
    zmat = np.stack([cosz, -sinz, zeros,
                     sinz, cosz, zeros,
                     zeros, zeros, ones], axis=-1).reshape(*z.shape, 3, 3)
    ymat = np.stack([cosy, zeros, siny,
                     zeros, ones, zeros,
                     -siny, zeros, cosy], axis=-1).reshape(*z.shape, 3, 3)
    xmat = np.stack([ones, zeros, zeros,
                     zeros, cosx, -sinx,
                     zeros, sinx, cosx], axis=-1).reshape(*z.shape, 3, 3)
    return xmat @ ymat @ zmat


def _pose_vec2mat(vec):
    """(..., 6) [tx, ty, tz, rx, ry, rz] -> (..., 4, 4) SE(3)."""
    translation = vec[..., :3, None]
    rot = _euler2mat(vec[..., 3:])
    transform = np.concatenate([rot, translation], axis=-1)
    bottom = np.zeros_like(transform[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return np.concatenate([transform, bottom], axis=-2)


def _invert_pose(x):
    rot_t = np.swapaxes(x[..., :3, :3], -1, -2)
    t = x[..., :3, 3:]
    inv = np.concatenate([rot_t, -rot_t @ t], axis=-1)
    bottom = np.zeros_like(inv[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return np.concatenate([inv, bottom], axis=-2)


def _mat2pose_vec(matrix):
    rotx = np.arctan2(-matrix[..., 1, 2], matrix[..., 2, 2])
    cosy = np.sqrt(matrix[..., 1, 2] ** 2 + matrix[..., 2, 2] ** 2)
    roty = np.arctan2(matrix[..., 0, 2], cosy)
    rotz = np.arctan2(-matrix[..., 0, 1], matrix[..., 0, 0])
    rotation = np.stack([rotx, roty, rotz], axis=-1)
    translation = matrix[..., :3, 3]
    return np.concatenate([translation, rotation], axis=-1)


def _warp_nearest(x, flow, spatial_extent):
    """Numpy twin of ops/warp.py warp_features(mode='nearest').

    x: (b, H, W, C) f32; flow: (b, 6) f32 pose vectors.
    """
    b, H, W, _ = x.shape
    angle = flow[:, 5]
    tx = -flow[:, 0] / np.float32(spatial_extent[0])
    ty = flow[:, 1] / np.float32(spatial_extent[1])
    cos_t, sin_t = np.cos(angle), np.sin(angle)
    theta = np.stack([cos_t, -sin_t, ty, sin_t, cos_t, tx],
                     axis=-1).reshape(b, 2, 3).astype(np.float32)

    xs = ((2.0 * np.arange(W, dtype=np.float32) + 1.0) / W - 1.0)
    ys = ((2.0 * np.arange(H, dtype=np.float32) + 1.0) / H - 1.0)
    base = np.stack([np.broadcast_to(xs[None, :], (H, W)),
                     np.broadcast_to(ys[:, None], (H, W)),
                     np.ones((H, W), np.float32)], axis=-1)       # (H, W, 3)
    grid = np.einsum('bkm,ijm->bijk', theta, base)                # (b, H, W, 2)

    ix = ((grid[..., 0] + 1.0) * W - 1.0) / 2.0
    iy = ((grid[..., 1] + 1.0) * H - 1.0) / 2.0
    # np.round is round-half-to-even, same as the device path (and torch)
    xi = np.round(ix).astype(np.int64)
    yi = np.round(iy).astype(np.int64)
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    xi_c = np.clip(xi, 0, W - 1)
    yi_c = np.clip(yi, 0, H - 1)
    out = x[np.arange(b)[:, None, None], yi_c, xi_c]              # (b, H, W, C)
    return out * valid[..., None].astype(x.dtype)


def warp_label_stack(stack, future_egomotion, spatial_extent):
    """Numpy twin of cumulative_warp_features_reverse(mode='nearest'): stack
    (b, s, H, W, C) f32 label maps, future_egomotion (b, s, 6) f32. Frame 0 is
    returned unchanged; frame i is warped by inv(flow[0]) @ ... @ inv(flow[i-1])."""
    stack = np.asarray(stack, np.float32)
    flow = np.asarray(future_egomotion, np.float32)
    b, s = stack.shape[:2]
    if s == 1:
        return stack
    inv = _invert_pose(_pose_vec2mat(flow))
    mats = [inv[:, 0]]
    for i in range(2, s):
        mats.append(mats[-1] @ inv[:, i - 1])
    poses = _mat2pose_vec(np.stack(mats, axis=1)).astype(np.float32)
    warped = _warp_nearest(
        stack[:, 1:].reshape(b * (s - 1), *stack.shape[2:]),
        poses.reshape(b * (s - 1), 6), spatial_extent,
    ).reshape(b, s - 1, *stack.shape[2:])
    return np.concatenate([stack[:, :1], warped], axis=1)


class PrewarpTransform:
    """Batch transform that adds ``warped_label_stack``: the label maps stacked as
    ``Trainer.prepare_future_labels`` stacks them (segmentation, instance,
    centerness, offset[, flow], channels-last) and warped on the host. The raw
    label keys stay in the batch. A class, not a closure, so that it pickles into
    data-loader worker processes."""

    def __init__(self, cfg):
        self.rf = cfg.TIME_RECEPTIVE_FIELD
        self.ext = (cfg.LIFT.X_BOUND[1], cfg.LIFT.Y_BOUND[1])
        self.with_flow = cfg.INSTANCE_FLOW.ENABLED

    def __call__(self, batch):
        rf = self.rf
        maps = [np.asarray(batch['segmentation'][:, rf - 1:], np.float32),
                np.asarray(batch['instance'][:, rf - 1:], np.float32)[..., None],
                np.asarray(batch['centerness'][:, rf - 1:], np.float32),
                np.asarray(batch['offset'][:, rf - 1:], np.float32)]
        if self.with_flow:
            maps.append(np.asarray(batch['flow'][:, rf - 1:], np.float32))
        stacked = np.concatenate(maps, axis=-1)
        ego = np.asarray(batch['future_egomotion'][:, rf - 1:], np.float32)
        out = dict(batch)
        out['warped_label_stack'] = warp_label_stack(stacked, ego, self.ext)
        return out


def make_prewarp_transform(cfg):
    return PrewarpTransform(cfg)
