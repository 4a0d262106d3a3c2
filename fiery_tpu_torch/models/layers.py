"""2D building blocks (counterpart of fiery_tpu/models/layers.py).

These run inside the channels-last public modules on channels-first (N, C, H, W)
views, the layout cuDNN's convolutions take; a view of a contiguous NHWC tensor
permuted to NCHW is already in PyTorch's channels_last memory format, so no copy
is made. Attribute names are the reference's torch parameter names, so a
state_dict matches the checkpoint format fiery_tpu/utils/weight_import.py maps.
BatchNorm is torch's (momentum convention, running statistics at eval; eps 1e-5
unless stated).
"""

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F


def resize_bilinear(x, out_hw):
    """F.interpolate(mode='bilinear', align_corners=False) of (N, C, H, W)."""
    return F.interpolate(x, size=tuple(out_hw), mode='bilinear', align_corners=False)


class ConvBlock(nn.Module):
    """conv (attribute ``conv``) + BN (``norm``) + ReLU."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 bn_momentum=0.1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.norm = nn.BatchNorm2d(out_channels, momentum=bn_momentum)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


def _bn_relu(channels, bn_momentum):
    return nn.Sequential(nn.BatchNorm2d(channels, momentum=bn_momentum), nn.ReLU())


class Bottleneck(nn.Module):
    """1x1 down-project -> 3x3 conv (stride 2 when ``downsample``) -> 1x1 up-project,
    each followed by BN + ReLU, with a residual: identity, or a projection
    (2x2 max pool when downsampling, then 1x1 conv + BN)."""

    def __init__(self, in_channels, out_channels=None, kernel_size=3, downsample=False,
                 bn_momentum=0.1):
        super().__init__()
        out_channels = out_channels or in_channels
        mid = in_channels // 2
        self.downsample = downsample
        self.layers = nn.Sequential(OrderedDict([
            ('conv_down_project', nn.Conv2d(in_channels, mid, 1, bias=False)),
            ('abn_down_project', _bn_relu(mid, bn_momentum)),
            ('conv', nn.Conv2d(mid, mid, kernel_size, stride=2 if downsample else 1,
                               padding=(kernel_size - 1) // 2, bias=False)),
            ('abn', _bn_relu(mid, bn_momentum)),
            ('conv_up_project', nn.Conv2d(mid, out_channels, 1, bias=False)),
            ('abn_up_project', _bn_relu(out_channels, bn_momentum)),
        ]))
        if out_channels == in_channels and not downsample:
            self.projection = None
        else:
            proj = OrderedDict()
            if downsample:
                proj['upsample_skip_proj'] = nn.MaxPool2d(2, stride=2)
            proj['conv_skip_proj'] = nn.Conv2d(in_channels, out_channels, 1, bias=False)
            proj['bn_skip_proj'] = nn.BatchNorm2d(out_channels, momentum=bn_momentum)
            self.projection = nn.Sequential(proj)

    def forward(self, x):
        residual = self.layers(x)
        if self.projection is None:
            return residual + x
        if self.downsample:
            # pad right/bottom if odd so the max pool matches the strided conv
            x = F.pad(x, (0, x.shape[-1] % 2, 0, x.shape[-2] % 2))
        return residual + self.projection(x)


class UpsamplingConcat(nn.Module):
    """Bilinear 2x upsample of the first input, concat after the skip, then
    2 x (3x3 conv + BN + ReLU) in ``conv``."""

    def __init__(self, in_channels, out_channels, scale_factor=2, bn_momentum=0.1):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=bn_momentum),
            nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=bn_momentum),
            nn.ReLU(),
        )

    def forward(self, x_to_upsample, x):
        sf = self.scale_factor
        x_to_upsample = resize_bilinear(
            x_to_upsample, (sf * x_to_upsample.shape[-2], sf * x_to_upsample.shape[-1]))
        return self.conv(torch.cat([x, x_to_upsample], dim=1))


class UpsamplingAdd(nn.Module):
    """Bilinear 2x upsample + 1x1 conv + BN (``upsample_layer.{1,2}``), added to the skip."""

    def __init__(self, in_channels, out_channels, scale_factor=2, bn_momentum=0.1):
        super().__init__()
        self.upsample_layer = nn.Sequential(
            nn.Upsample(scale_factor=scale_factor, mode='bilinear', align_corners=False),
            nn.Conv2d(in_channels, out_channels, 1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=bn_momentum),
        )

    def forward(self, x, x_skip):
        return self.upsample_layer(x) + x_skip

