"""Temporal building blocks and the SpatialGRU (counterpart of
fiery_tpu/models/temporal_layers.py), channels-first (B, C, T, H, W) inside the
channels-last temporal model.

Causal (kt, kh, kw) convolutions are real Conv3d with kt - 1 zero frames padded at
the front of time, as the reference computes them. Attribute names are the
reference's torch parameter names.
"""

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from fiery_tpu_torch.models.layers import (BatchNorm, Conv2d, Conv3d, ConvBlock,
                                           resize_bilinear)
from fiery_tpu_torch.ops.spatial_gru import (gru_frames, gru_output, gru_reset_concat,
                                             gru_stack, gru_state_update)


class Conv1x1x1NormActivated(nn.Sequential):
    """1x1x1 Conv3d (``conv``) + BatchNorm3d (``norm``) with the ReLU folded in."""

    def __init__(self, in_channels, out_channels, bn_momentum=0.1):
        super().__init__(OrderedDict([
            ('conv', Conv3d(in_channels, out_channels, kernel_size=1, bias=False)),
            ('norm', BatchNorm(out_channels, momentum=bn_momentum, post='relu')),
        ]))


class CausalConv3d(nn.Module):
    """Causal (kt, kh, kw) Conv3d + BN + ReLU: kt - 1 zero frames before t = 0."""

    def __init__(self, in_channels, out_channels, kernel_size=(2, 3, 3), bn_momentum=0.1):
        super().__init__()
        kt, kh, kw = kernel_size
        self.kt = kt
        self.conv = Conv3d(in_channels, out_channels, kernel_size,
                           padding=(0, kh // 2, kw // 2), bias=False)
        self.norm = BatchNorm(out_channels, momentum=bn_momentum, post='relu')

    def forward(self, x):
        if self.kt > 1:
            x = F.pad(x, (0, 0, 0, 0, self.kt - 1, 0))
        return self.norm(self.conv(x))


def causal_max_pool3d(x, kernel_size=(2, 3, 3)):
    """Max pool, stride 1, zero frames before t = 0, -inf spatial padding."""
    kt, kh, kw = kernel_size
    x = F.pad(x, (0, 0, 0, 0, kt - 1, 0))
    return F.max_pool3d(x, kernel_size, stride=1, padding=(0, kh // 2, kw // 2))


class Bottleneck3D(nn.Module):
    """1x1x1 down-project -> causal conv -> 1x1x1 up-project, + residual."""

    def __init__(self, in_channels, out_channels=None, kernel_size=(2, 3, 3),
                 bn_momentum=0.1):
        super().__init__()
        out_channels = out_channels or in_channels
        mid = in_channels // 2
        self.layers = nn.Sequential(OrderedDict([
            ('conv_down_project', Conv1x1x1NormActivated(in_channels, mid, bn_momentum)),
            ('conv', CausalConv3d(mid, mid, kernel_size, bn_momentum)),
            ('conv_up_project', Conv1x1x1NormActivated(mid, out_channels, bn_momentum)),
        ]))
        self.projection = None
        if out_channels != in_channels:
            self.projection = _projection(in_channels, out_channels, bn_momentum)

    def forward(self, x):
        h = self.layers(x)
        if self.projection is None:
            return h + x
        conv, bn = self.projection
        return bn(conv(x), residual=h)


def _projection(in_channels, out_channels, bn_momentum):
    """The residual's 1x1x1 conv + BN, whose epilogue adds the block's output."""
    return nn.Sequential(Conv3d(in_channels, out_channels, kernel_size=1, bias=False),
                         BatchNorm(out_channels, momentum=bn_momentum, post='add'))


def _causal_avg_pool3d(x, pool_size):
    """AvgPool3d(kernel (2, ph, pw), stride (1, ph, pw), one front time pad,
    count_include_pad=False), last step dropped: out[0] = avg(x[0]),
    out[t] = (avg(x[t-1]) + avg(x[t])) / 2."""
    kt, ph, pw = pool_size
    assert kt == 2, 'time kernel must be 2'
    # the spatial average of each (ph, pw) window as a reshape-mean: one parallel
    # reduction, where avg_pool3d runs one thread per output window
    b, c, t, H, W = x.shape
    h = x[..., :H - H % ph, :W - W % pw].reshape(
        b, c, t, H // ph, ph, W // pw, pw).mean(dim=(4, 6))
    return torch.cat([h[:, :, :1], (h[:, :, :-1] + h[:, :, 1:]) / 2.0], dim=2)


class _PoolBranch(nn.Module):
    def __init__(self, in_channels, reduction_channels, bn_momentum):
        super().__init__()
        self.conv_bn_relu = Conv1x1x1NormActivated(in_channels, reduction_channels,
                                                   bn_momentum)


class PyramidSpatioTemporalPooling(nn.Module):
    """Causal spatio-temporal pyramid pooling, resized back to the input's (H, W)."""

    def __init__(self, in_channels, reduction_channels, pool_sizes, bn_momentum=0.1):
        super().__init__()
        self.pool_sizes = [tuple(p) for p in pool_sizes]
        self.features = nn.ModuleList([
            _PoolBranch(in_channels, reduction_channels, bn_momentum)
            for _ in self.pool_sizes])

    def forward(self, x, drop_front=0):
        # drop_front=1: frame 0 is causal context only; its pooled output is dropped
        b, _, _, h, w = x.shape
        out = []
        for pool_size, branch in zip(self.pool_sizes, self.features):
            pooled = branch.conv_bn_relu(_causal_avg_pool3d(x, pool_size)[:, :, drop_front:])
            c, t = pooled.shape[1:3]
            if pooled.shape[-2:] == (1, 1):
                # a bilinear resize of a 1x1 map is a broadcast (exactly, as the JAX
                # package's resize computes it); its gradient is then a sum, not
                # 40,000 atomic adds into each value
                out.append(pooled.expand(b, c, t, h, w))
                continue
            frames = pooled.transpose(1, 2).reshape(b * t, c, *pooled.shape[-2:])
            frames = resize_bilinear(frames, (h, w))
            out.append(frames.view(b, t, c, h, w).transpose(1, 2))
        return torch.cat(out, dim=1)


class TemporalBlock(nn.Module):
    """Parallel causal conv paths (2x3x3, 1x3x3, 1x1x1) + optional pyramid pooling,
    aggregated by a 1x1x1 conv, with a residual connection.

    ``drop_front`` > 0 returns only output frames [drop_front:] and computes only
    what they need: every temporal kernel has extent <= 2, so output frame t reads
    input frames {t-1, t}. Exact at eval (running-stat BN).
    """

    def __init__(self, in_channels, out_channels=None, use_pyramid_pooling=False,
                 pool_sizes=None, bn_momentum=0.1):
        super().__init__()
        out_channels = out_channels or in_channels
        half = in_channels // 2
        self.convolution_paths = nn.ModuleList([
            nn.Sequential(Conv1x1x1NormActivated(in_channels, half, bn_momentum),
                          CausalConv3d(half, half, (2, 3, 3), bn_momentum)),
            nn.Sequential(Conv1x1x1NormActivated(in_channels, half, bn_momentum),
                          CausalConv3d(half, half, (1, 3, 3), bn_momentum)),
            Conv1x1x1NormActivated(in_channels, half, bn_momentum),
        ])
        agg_in = 3 * half
        self.pyramid_pooling = None
        if use_pyramid_pooling:
            reduction = in_channels // 3
            self.pyramid_pooling = PyramidSpatioTemporalPooling(
                in_channels, reduction, pool_sizes, bn_momentum)
            agg_in += len(pool_sizes) * reduction
        self.aggregation = nn.Sequential(
            Conv1x1x1NormActivated(agg_in, out_channels, bn_momentum))
        self.projection = None
        if out_channels != in_channels:
            self.projection = _projection(in_channels, out_channels, bn_momentum)

    def forward(self, x, drop_front=0):
        s = drop_front
        assert 0 <= s < x.shape[2]
        # the (2,3,3) path and the pooling read one context frame before s; the
        # causal conv's zero pre-pad corrupts only that frame's own output. The three
        # 1x1x1 prologs run over the context frame too and drop it after: in training
        # (TRIM_TRAIN) their BatchNorms then take batch statistics over the frames
        # the JAX package's fused prolog covers
        xc = x[:, :, s - 1:] if s else x
        xs = x[:, :, s:]
        prolog1, conv1 = self.convolution_paths[1]
        p0, p1, p2 = (self.convolution_paths[0](xc), prolog1(xc),
                      self.convolution_paths[2](xc))
        if s:
            p0, p1, p2 = p0[:, :, 1:], p1[:, :, 1:], p2[:, :, 1:]
        paths = [p0, conv1(p1), p2]
        if self.pyramid_pooling is not None:
            paths.append(self.pyramid_pooling(xc, drop_front=min(s, 1)))
        h = self.aggregation(torch.cat(paths, dim=1))
        if self.projection is None:
            return xs + h
        conv, bn = self.projection
        return bn(conv(xs), residual=h)


class SpatialGRU(nn.Module):
    """Convolutional GRU with 3x3 gates; the same weights at every step. The gate
    arithmetic around the convolutions is kernel K11 (ops/spatial_gru.py)."""

    def __init__(self, input_size, hidden_size, bn_momentum=0.1):
        super().__init__()
        c = input_size + hidden_size
        self.conv_update = Conv2d(c, hidden_size, 3, padding=1, bias=True)
        self.conv_reset = Conv2d(c, hidden_size, 3, padding=1, bias=True)
        self.conv_state_tilde = ConvBlock(c, hidden_size, 3, bn_momentum=bn_momentum)

    def forward(self, x, state):
        """x (B, T, C_in, H, W) frames, state (B, C_h, H, W) -> (B, T, C_h, H, W)."""
        out = gru_output(state, x.shape[1])
        states = []
        for t, x_t in enumerate(gru_frames(x)):
            x_and_state = torch.cat([x_t, state], dim=1)
            # the reference gates the state with (1 - reset)
            tilde = self.conv_state_tilde(
                gru_reset_concat(x_t, self.conv_reset(x_and_state), state))
            state = gru_state_update(self.conv_update(x_and_state), state, tilde, out, t)
            states.append(state)
        return gru_stack(out, states)
