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

The op after a BatchNorm (ReLU, swish, a residual add) is its ``post=`` epilogue,
at the sites where the JAX package folds it (``post=`` of its BatchNorm). Where a
ReLU inside an index-numbered ``nn.Sequential`` is folded, an ``nn.Identity`` keeps
its slot, so the state_dict keys of the modules after it do not move.
"""

from collections import Counter, OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from fiery_tpu_torch.ops.batch_norm import POSTS, batch_norm


class _InputDtype:
    """Convolution mixin: compute in the input's dtype, weights cast on the fly, and
    return channels-last memory, the layout the BatchNorm kernel takes. An output in
    another layout (PyTorch's CPU convolutions return one for a 5-D batch of 1) is
    copied, and counted by its shape in ``layout_copies``."""

    layout_copies = Counter()

    def _conv_forward(self, x, weight, bias):
        return self._out_layout(super()._conv_forward(
            x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype)))

    def _out_layout(self, y):
        if not y.is_contiguous(memory_format=self.out_format):
            _InputDtype.layout_copies[tuple(y.shape)] += 1
            y = y.contiguous(memory_format=self.out_format)
        return y


class Conv2d(_InputDtype, nn.Conv2d):
    out_format = torch.channels_last


class Conv3d(_InputDtype, nn.Conv3d):
    out_format = torch.channels_last_3d


class ConvTranspose2d(_InputDtype, nn.ConvTranspose2d):
    """A transposed conv as ``Conv2d`` computes: in the input's dtype, channels-last
    out. Its weight is (in, out, kh, kw)."""
    out_format = torch.channels_last

    def forward(self, x):
        return self._out_layout(F.conv_transpose2d(
            x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype),
            self.stride, self.padding, self.output_padding, self.groups, self.dilation))


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over the channels (dim 1) of a 4-D or 5-D input with the op that
    follows it fused in (``post``, one of ops.batch_norm.POSTS: none, relu, swish,
    add, add_relu, relu_add), the port's one BN; it runs kernel K10
    (ops/batch_norm.py) and is what the JAX package's ``_BNCore`` computes.

    Eval normalises with the running statistics. In training it normalises with
    the batch statistics and updates the running ones as ``_BNCore`` does:
    running <- (1 - m) running + m batch, with the BIASED batch variance (torch's
    own update takes the unbiased one); momentum None is the cumulative average,
    m = 1 / batches seen. The epilogues add, add_relu and relu_add take the
    ``residual`` argument of ``forward``; ``post=`` of ``forward`` overrides the
    module's for one call. With ``process_group`` set (a ``torch.distributed``
    group; parallel/mesh.py ``make_parallel_trainer`` sets it), training takes the
    statistics over the group's ranks (sync-BN, as the JAX package's BatchNorm over
    a batch sharded on its ``data`` axis); eval is unchanged.
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1, post='none'):
        super().__init__(num_features, eps=eps, momentum=momentum)
        if post not in POSTS:
            raise ValueError(f'Invalid BN epilogue {post}')
        self.post = post
        self.process_group = None

    def _check_input_dim(self, x):
        if x.dim() not in (4, 5):
            raise ValueError(f'BatchNorm expects a 4-D or 5-D input, got {x.dim()}-D')

    def extra_repr(self):
        return super().extra_repr() + f', post={self.post}'

    def forward(self, x, residual=None, post=None):
        self._check_input_dim(x)
        m = 0.0
        if self.training:
            self.num_batches_tracked.add_(1)
            # momentum None: the cumulative average, 1 / batches seen
            m = self.momentum if self.momentum is not None else 1.0 / float(
                self.num_batches_tracked)
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          self.training, m, self.eps, self.post if post is None else post,
                          residual, self.process_group)


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
        self.norm = BatchNorm(out_channels, momentum=bn_momentum, post='relu')

    def forward(self, x):
        return self.norm(self.conv(x))


def _bn_relu(channels, bn_momentum):
    return nn.Sequential(BatchNorm(channels, momentum=bn_momentum, post='relu'))


class Bottleneck(nn.Module):
    """1x1 down-project -> 3x3 conv (stride 2 when ``downsample``; a 3x3 transposed
    conv of stride 2 when ``upsample``) -> 1x1 up-project, each followed by BN +
    ReLU, with a residual: identity, or a projection (2x2 max pool when
    downsampling, a bilinear 2x upsample when upsampling, then 1x1 conv + BN)."""

    def __init__(self, in_channels, out_channels=None, kernel_size=3, downsample=False,
                 bn_momentum=0.1, upsample=False):
        super().__init__()
        if downsample and upsample:
            raise ValueError('a Bottleneck downsamples or upsamples, not both')
        out_channels = out_channels or in_channels
        mid = in_channels // 2
        self.downsample, self.upsample = downsample, upsample
        pad = (kernel_size - 1) // 2
        if upsample:
            conv = ConvTranspose2d(mid, mid, kernel_size, stride=2, padding=pad,
                                   output_padding=1, bias=False)
        else:
            conv = Conv2d(mid, mid, kernel_size, stride=2 if downsample else 1, padding=pad,
                          bias=False)
        self.layers = nn.Sequential(OrderedDict([
            ('conv_down_project', Conv2d(in_channels, mid, 1, bias=False)),
            ('abn_down_project', _bn_relu(mid, bn_momentum)),
            ('conv', conv),
            ('abn', _bn_relu(mid, bn_momentum)),
            ('conv_up_project', Conv2d(mid, out_channels, 1, bias=False)),
            ('abn_up_project', _bn_relu(out_channels, bn_momentum)),
        ]))
        if out_channels == in_channels and not (downsample or upsample):
            self.projection = None
            # the identity residual rides the last BN: relu(bn(h)) + x
            self.layers.abn_up_project[0].post = 'relu_add'
        else:
            proj = OrderedDict()
            if downsample:
                proj['upsample_skip_proj'] = nn.MaxPool2d(2, stride=2)
            elif upsample:
                proj['upsample_skip_proj'] = nn.Upsample(scale_factor=2, mode='bilinear',
                                                         align_corners=False)
            proj['conv_skip_proj'] = Conv2d(in_channels, out_channels, 1, bias=False)
            proj['bn_skip_proj'] = BatchNorm(out_channels, momentum=bn_momentum,
                                             post='add')
            self.projection = nn.Sequential(proj)

    def forward(self, x):
        if self.projection is None:
            return self.layers.abn_up_project[0](self.layers[:-1](x), residual=x)
        residual = self.layers(x)
        skip = x
        if self.downsample:
            # pad right/bottom if odd so the max pool matches the strided conv
            skip = F.pad(skip, (0, skip.shape[-1] % 2, 0, skip.shape[-2] % 2))
        if self.downsample or self.upsample:
            skip = self.projection.upsample_skip_proj(skip)
        skip = self.projection.conv_skip_proj(skip)
        return self.projection.bn_skip_proj(skip, residual=residual)


class UpsamplingConcat(nn.Module):
    """Bilinear 2x upsample of the first input, concat after the skip, then
    2 x (3x3 conv + BN + ReLU) in ``conv``."""

    def __init__(self, in_channels, out_channels, scale_factor=2, bn_momentum=0.1):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = nn.Sequential(
            Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm(out_channels, momentum=bn_momentum, post='relu'),
            nn.Identity(),          # the ReLU, folded into the BN; keeps conv.3, conv.4
            Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm(out_channels, momentum=bn_momentum, post='relu'),
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
            BatchNorm(out_channels, momentum=bn_momentum, post='add'),
        )

    def forward(self, x, x_skip):
        up, conv, bn = self.upsample_layer
        return bn(conv(up(x)), residual=x_skip)

