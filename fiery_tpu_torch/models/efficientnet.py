"""EfficientNet-b0/b4 backbone truncated for the FPN encoder (counterpart of
fiery_tpu/models/efficientnet.py), channels-first inside the encoder.

TF-style SAME padding (asymmetric for even inputs under stride 2), BN eps 1e-3,
swish, squeeze-excitation; attribute names follow efficientnet_pytorch
(_conv_stem, _bn0, _blocks.i._expand_conv, ...). In training, block i of the n
kept blocks drops its residual branch per sample with probability
drop_connect_rate * i / n (drop-connect), with masks drawn from a torch.Generator.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from fiery_tpu_torch.models.layers import BatchNorm, Conv2d
from fiery_tpu_torch.parallel.mesh import draw_batch

# (num_repeat, kernel, stride, expand_ratio, in_filters, out_filters, se_ratio)
_BLOCK_ARGS = [
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
]

# width_coefficient, depth_coefficient, drop_connect_rate
_GLOBAL_PARAMS = {
    'b0': (1.0, 1.0, 0.2),
    'b4': (1.4, 1.8, 0.2),
}


def round_filters(filters, width_coefficient, divisor=8):
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats, depth_coefficient):
    return int(math.ceil(depth_coefficient * repeats))


def block_specs(version):
    """Flat per-block spec list: (kernel, stride, expand, in_ch, out_ch, se_ratio)."""
    width, depth, _ = _GLOBAL_PARAMS[version]
    specs = []
    for repeat, k, s, e, ci, co, se in _BLOCK_ARGS:
        ci_r = round_filters(ci, width)
        co_r = round_filters(co, width)
        for i in range(round_repeats(repeat, depth)):
            specs.append((k, s if i == 0 else 1, e, ci_r if i == 0 else co_r, co_r, se))
    return specs


def truncation_index(version, downsample):
    """Index of the last kept block (inclusive) when truncating at the given stride:
    for downsample 8, everything through stage 5 (b0 -> 10, b4 -> 21)."""
    _, depth, _ = _GLOBAL_PARAMS[version]
    if downsample == 16:
        return sum(round_repeats(r, depth) for r, *_ in _BLOCK_ARGS) - 1
    assert downsample == 8
    return sum(round_repeats(r, depth) for r, *_ in _BLOCK_ARGS[:5]) - 1


class SamePadConv2d(Conv2d):
    """Conv2d with TF SAME padding: total (ceil(n/s) - 1) * s + k - n, the odd pixel
    at the end."""

    def forward(self, x):
        ih, iw = x.shape[-2:]
        sh, sw = self.stride
        kh, kw = self.kernel_size
        ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
        pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
        if ph or pw:
            x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        return self._conv_forward(x, self.weight, self.bias)


def swish(x):
    return x * torch.sigmoid(x)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation."""

    def __init__(self, kernel, stride, expand_ratio, in_channels, out_channels, se_ratio,
                 bn_momentum=0.1, bn_epsilon=1e-3, drop_rate=0.0):
        super().__init__()
        self.drop_rate = drop_rate
        expanded = in_channels * expand_ratio

        def bn(c, post):
            return BatchNorm(c, eps=bn_epsilon, momentum=bn_momentum, post=post)

        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self._expand_conv = SamePadConv2d(in_channels, expanded, 1, bias=False)
            self._bn0 = bn(expanded, 'swish')
        self._depthwise_conv = SamePadConv2d(expanded, expanded, kernel, stride=stride,
                                             groups=expanded, bias=False)
        self._bn1 = bn(expanded, 'swish')
        self.has_se = bool(se_ratio) and 0 < se_ratio <= 1
        if self.has_se:
            squeezed = max(1, int(in_channels * se_ratio))
            self._se_reduce = SamePadConv2d(expanded, squeezed, 1)
            self._se_expand = SamePadConv2d(squeezed, expanded, 1)
        self._project_conv = SamePadConv2d(expanded, out_channels, 1, bias=False)
        self.has_skip = stride == 1 and in_channels == out_channels
        self._bn2 = bn(out_channels, 'add' if self.has_skip else 'none')

    def forward(self, x, generator=None, per_frame=None):
        """x (N, C, H, W). In training with a drop rate, the residual branch of each
        sample is kept with probability 1 - rate and scaled by 1 / (1 - rate); the
        uniforms come from ``generator`` (torch's default one if None; a
        ``RankGenerator``'s are the global batch's, parallel/mesh.py, of which
        ``per_frame``, the cameras of each sample-frame in N, picks the rank's)."""
        inputs = x
        if self.has_expand:
            x = self._bn0(self._expand_conv(x))
        x = self._bn1(self._depthwise_conv(x))
        if self.has_se:
            s = x.mean(dim=(-2, -1), keepdim=True)
            s = self._se_expand(swish(self._se_reduce(s)))
            x = torch.sigmoid(s) * x
        x = self._project_conv(x)
        if not (self.has_skip and self.training and self.drop_rate > 0):
            # the residual add rides the BN, as in the JAX package, unless
            # drop-connect must mask the branch first
            return self._bn2(x, residual=inputs if self.has_skip else None)
        x = self._bn2(x, post='none')
        keep = 1.0 - self.drop_rate
        device = generator.device if generator is not None else x.device
        u = draw_batch(torch.rand, (x.shape[0], 1, 1, 1), generator, device, per_frame)
        x = x / keep * (u < keep).to(device=x.device, dtype=x.dtype)
        return x + inputs


class EfficientNetFPN(nn.Module):
    """Truncated EfficientNet returning the two FPN endpoints: for downsample 8,
    (reduction_4 at stride 16, reduction_3 at stride 8); for 16, (reduction_5,
    reduction_4)."""

    def __init__(self, version='b4', downsample=8, bn_momentum=0.1):
        super().__init__()
        width, _, drop_connect_rate = _GLOBAL_PARAMS[version]
        self.downsample = downsample
        stem = round_filters(32, width)
        self._conv_stem = SamePadConv2d(3, stem, 3, stride=2, bias=False)
        self._bn0 = BatchNorm(stem, eps=1e-3, momentum=bn_momentum, post='swish')
        n_blocks = truncation_index(version, downsample) + 1
        # the rate grows with the block's index over the truncated length
        self._blocks = nn.ModuleList([
            MBConvBlock(k, s, e, ci, co, se, bn_momentum=bn_momentum,
                        drop_rate=drop_connect_rate * i / n_blocks)
            for i, (k, s, e, ci, co, se) in enumerate(block_specs(version)[:n_blocks])])

    def forward(self, x, generator=None, per_frame=None):
        x = self._bn0(self._conv_stem(x))
        endpoints = {}
        prev = x
        for block in self._blocks:
            x = block(x, generator, per_frame)
            if prev.shape[-2] > x.shape[-2]:
                endpoints[f'reduction_{len(endpoints) + 1}'] = prev
            prev = x
        endpoints[f'reduction_{len(endpoints) + 1}'] = x
        if self.downsample == 16:
            return endpoints['reduction_5'], endpoints['reduction_4']
        return endpoints['reduction_4'], endpoints['reduction_3']
