"""2D building blocks (counterpart of fiery_tpu/models/layers.py).

These run inside the channels-last public modules on channels-first (N, C, H, W)
views, the layout cuDNN's convolutions take; a view of a contiguous NHWC tensor
permuted to NCHW is already in PyTorch's channels_last memory format, so no copy
is made. Attribute names are the reference's torch parameter names, so a
state_dict matches the checkpoint format fiery_tpu/utils/weight_import.py maps.

Mixed precision as the JAX package has it: parameters may stay float32 while the
activations are bfloat16 (PRECISION 16); ``Conv2d`` and ``Conv3d`` cast their
weights to the input's dtype on the fly, and ``BatchNorm`` keeps float32
parameters and statistics for any input dtype.
"""

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F


class _InputDtype:
    """Convolution mixin: compute in the input's dtype, weights cast on the fly."""

    def _conv_forward(self, x, weight, bias):
        return super()._conv_forward(x, weight.to(x.dtype),
                                     None if bias is None else bias.to(x.dtype))


class Conv2d(_InputDtype, nn.Conv2d):
    pass


class Conv3d(_InputDtype, nn.Conv3d):
    pass


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over the channels (dim 1) of a 4-D or 5-D input, the port's one BN.

    Eval normalises with the running statistics, as torch's BatchNorm2d/3d do. In
    training it normalises with the batch statistics and updates the running ones
    as the JAX package's ``_BNCore`` does: running <- (1 - m) running + m batch,
    with the BIASED batch variance (torch's own update takes the unbiased one).
    torch's fused kernel updates a copy with the unbiased variance v n / (n - 1),
    and the biased update is formed from it with a few C-sized operations instead
    of a second pass over the activation.
    """

    def _check_input_dim(self, x):
        if x.dim() not in (4, 5):
            raise ValueError(f'BatchNorm expects a 4-D or 5-D input, got {x.dim()}-D')

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        # momentum None: the cumulative average, 1 / batches seen
        m = self.momentum if self.momentum is not None else 1.0 / float(
            self.num_batches_tracked)
        unbiased = self.running_var.clone()      # (1 - m) old + m v n / (n - 1) after
        out = F.batch_norm(x, self.running_mean, unbiased, self.weight, self.bias, True,
                           m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # (1 - m) old + m v = (1 - m) old / n + unbiased (n - 1) / n
            self.running_var.mul_((1.0 - m) / n).add_(unbiased, alpha=(n - 1) / n)
        return out


def resize_bilinear(x, out_hw):
    """F.interpolate(mode='bilinear', align_corners=False) of (N, C, H, W)."""
    return F.interpolate(x, size=tuple(out_hw), mode='bilinear', align_corners=False)


class ConvBlock(nn.Module):
    """conv (attribute ``conv``) + BN (``norm``) + ReLU."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 bn_momentum=0.1):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                           padding=(kernel_size - 1) // 2, bias=False)
        self.norm = BatchNorm(out_channels, momentum=bn_momentum)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


def _bn_relu(channels, bn_momentum):
    return nn.Sequential(BatchNorm(channels, momentum=bn_momentum), nn.ReLU())


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
            ('conv_down_project', Conv2d(in_channels, mid, 1, bias=False)),
            ('abn_down_project', _bn_relu(mid, bn_momentum)),
            ('conv', Conv2d(mid, mid, kernel_size, stride=2 if downsample else 1,
                            padding=(kernel_size - 1) // 2, bias=False)),
            ('abn', _bn_relu(mid, bn_momentum)),
            ('conv_up_project', Conv2d(mid, out_channels, 1, bias=False)),
            ('abn_up_project', _bn_relu(out_channels, bn_momentum)),
        ]))
        if out_channels == in_channels and not downsample:
            self.projection = None
        else:
            proj = OrderedDict()
            if downsample:
                proj['upsample_skip_proj'] = nn.MaxPool2d(2, stride=2)
            proj['conv_skip_proj'] = Conv2d(in_channels, out_channels, 1, bias=False)
            proj['bn_skip_proj'] = BatchNorm(out_channels, momentum=bn_momentum)
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
            Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm(out_channels, momentum=bn_momentum),
            nn.ReLU(),
            Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm(out_channels, momentum=bn_momentum),
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
            Conv2d(in_channels, out_channels, 1, bias=False),
            BatchNorm(out_channels, momentum=bn_momentum),
        )

    def forward(self, x, x_skip):
        return self.upsample_layer(x) + x_skip

