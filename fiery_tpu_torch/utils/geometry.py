"""Pose math and BEV grid parameters (counterpart of fiery_tpu/utils/geometry.py)."""

import numpy as np
import torch

from fiery_tpu_torch.utils.rounding import sqrt_rn


def calculate_birds_eye_view_parameters(x_bounds, y_bounds, z_bounds):
    """(resolution, start_position, dimension) numpy arrays of the BEV grid."""
    bounds = [x_bounds, y_bounds, z_bounds]
    bev_resolution = np.array([row[2] for row in bounds], dtype=np.float64)
    bev_start_position = np.array([row[0] + row[2] / 2.0 for row in bounds],
                                  dtype=np.float64)
    bev_dimension = np.array([int((row[1] - row[0]) / row[2]) for row in bounds],
                             dtype=np.int64)
    return bev_resolution, bev_start_position, bev_dimension


def euler2mat(angle):
    """Euler angles (..., 3) [rx, ry, rz] -> rotation (..., 3, 3), R = Rx @ Ry @ Rz."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    cosz, sinz = torch.cos(z), torch.sin(z)
    cosy, siny = torch.cos(y), torch.sin(y)
    cosx, sinx = torch.cos(x), torch.sin(x)
    zeros, ones = torch.zeros_like(z), torch.ones_like(z)
    zmat = torch.stack([cosz, -sinz, zeros, sinz, cosz, zeros, zeros, zeros, ones],
                       dim=-1).view(*z.shape, 3, 3)
    ymat = torch.stack([cosy, zeros, siny, zeros, ones, zeros, -siny, zeros, cosy],
                       dim=-1).view(*z.shape, 3, 3)
    xmat = torch.stack([ones, zeros, zeros, zeros, cosx, -sinx, zeros, sinx, cosx],
                       dim=-1).view(*z.shape, 3, 3)
    return xmat @ ymat @ zmat


def pose_vec2mat(vec):
    """6-DoF pose (..., 6) [tx, ty, tz, rx, ry, rz] -> (..., 4, 4) SE(3) matrix."""
    transform = torch.cat([euler2mat(vec[..., 3:]), vec[..., :3, None]], dim=-1)
    bottom = torch.zeros_like(transform[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([transform, bottom], dim=-2)


def mat2pose_vec(matrix):
    """(..., 4, 4) SE(3) matrix -> 6-DoF vector, inverse of ``pose_vec2mat``."""
    rotx = torch.atan2(-matrix[..., 1, 2], matrix[..., 2, 2])
    cosy = sqrt_rn(matrix[..., 1, 2] ** 2 + matrix[..., 2, 2] ** 2)
    roty = torch.atan2(matrix[..., 0, 2], cosy)
    rotz = torch.atan2(-matrix[..., 0, 1], matrix[..., 0, 0])
    rotation = torch.stack([rotx, roty, rotz], dim=-1)
    return torch.cat([matrix[..., :3, 3], rotation], dim=-1)


def pack_sequence_dim(x):
    """(b, s, ...) -> (b*s, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def unpack_sequence_dim(x, b, s):
    """(b*s, ...) -> (b, s, ...)."""
    return x.reshape(b, s, *x.shape[1:])


def invert_pose_matrix(x):
    """Invert a batch of (..., 4, 4) rigid poses analytically: [R^T, -R^T t]."""
    rot_t = x[..., :3, :3].transpose(-1, -2)
    inv = torch.cat([rot_t, -rot_t @ x[..., :3, 3:]], dim=-1)
    bottom = torch.zeros_like(inv[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([inv, bottom], dim=-2)
