"""The reference graph as plain torch modules: the twin that the accuracy-parity
runner (``python -m fiery_tpu_torch.parity --stages``) holds the port against.

These modules are built from torch primitives. They reproduce the reference FIERY
module tree, so that ``state_dict()`` carries the parameter names of the reference
checkpoint format (``model.encoder.backbone._blocks.3._depthwise_conv.weight``,
...), and their ``forward`` reproduces the reference's eval-mode numerics. They
use no kernel of the port and none of its fused or sliced layers: plain NCHW
convolutions, ``nn.BatchNorm*``, ``F.grid_sample`` and an ``index_add_`` splat,
so that they stay independent of the code they check. Each module runs on the
device its parameters are on (``GoldenFiery(..., device=)``).

Name and shape contracts, by reference file:
  * encoder: fiery/models/encoder.py:7-104 and efficientnet_pytorch's MBConv
    layout (_expand_conv/_bn0/_depthwise_conv/_bn1/_se_reduce/_se_expand/
    _project_conv/_bn2, TF-SAME padding, swish, BN eps 1e-3);
  * decoder: fiery/models/decoder.py:7-91 (torchvision resnet18 BasicBlock
    naming conv1/bn1/conv2/bn2/downsample.{0,1});
  * layers: fiery/layers/convolutions.py (UpsamplingConcat, UpsamplingAdd,
    Bottleneck with OrderedDict naming);
  * distributions: fiery/models/distributions.py;
  * future prediction and SpatialGRU: fiery/layers/temporal.py:10-62,
    fiery/models/future_prediction.py.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from fiery_tpu_torch.models.efficientnet import block_specs, round_filters, truncation_index


def swish(x):
    return x * torch.sigmoid(x)


class SamePadConv2d(nn.Conv2d):
    """Conv2d with TF-style SAME padding (what efficientnet_pytorch's
    Conv2dStaticSamePadding computes)."""

    def forward(self, x):
        ih, iw = x.shape[-2:]
        sh, sw = self.stride
        kh, kw = self.kernel_size
        ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
        pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
        x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation,
                        self.groups)


class GoldenMBConv(nn.Module):
    def __init__(self, kernel, stride, expand, in_ch, out_ch, se_ratio):
        super().__init__()
        expanded = in_ch * expand
        bn = lambda c: nn.BatchNorm2d(c, eps=1e-3, momentum=0.01)  # noqa: E731
        if expand != 1:
            self._expand_conv = SamePadConv2d(in_ch, expanded, 1, bias=False)
            self._bn0 = bn(expanded)
        self._depthwise_conv = SamePadConv2d(expanded, expanded, kernel,
                                             stride=stride, groups=expanded,
                                             bias=False)
        self._bn1 = bn(expanded)
        squeezed = max(1, int(in_ch * se_ratio))
        self._se_reduce = SamePadConv2d(expanded, squeezed, 1)
        self._se_expand = SamePadConv2d(squeezed, expanded, 1)
        self._project_conv = SamePadConv2d(expanded, out_ch, 1, bias=False)
        self._bn2 = bn(out_ch)
        self._id_skip = stride == 1 and in_ch == out_ch

    def forward(self, x):
        inputs = x
        if hasattr(self, '_expand_conv'):
            x = swish(self._bn0(self._expand_conv(x)))
        x = swish(self._bn1(self._depthwise_conv(x)))
        s = F.adaptive_avg_pool2d(x, 1)
        s = self._se_expand(swish(self._se_reduce(s)))
        x = torch.sigmoid(s) * x
        x = self._bn2(self._project_conv(x))
        if self._id_skip:
            x = x + inputs
        return x


class GoldenBackbone(nn.Module):
    """Truncated EfficientNet with efficientnet_pytorch naming."""

    def __init__(self, version, downsample):
        super().__init__()
        width = {'b0': 1.0, 'b4': 1.4}[version]
        stem = round_filters(32, width)
        self._conv_stem = SamePadConv2d(3, stem, 3, stride=2, bias=False)
        self._bn0 = nn.BatchNorm2d(stem, eps=1e-3, momentum=0.01)
        specs = block_specs(version)
        n_blocks = truncation_index(version, downsample) + 1
        self._blocks = nn.ModuleList([
            GoldenMBConv(k, s, e, ci, co, se)
            for (k, s, e, ci, co, se) in specs[:n_blocks]])


class GoldenUpsamplingConcat(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.upsample = nn.Upsample(scale_factor=2, mode='bilinear',
                                    align_corners=False)
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x_to_upsample, x):
        x_to_upsample = self.upsample(x_to_upsample)
        return self.conv(torch.cat([x, x_to_upsample], dim=1))


class GoldenEncoder(nn.Module):
    """model.encoder: backbone + upsampling_layer + depth_layer.

    forward returns the lifted volume (B, C, D, h, w) like reference
    encoder.py:93-104 (softmax depth ⊗ features outer product)."""

    def __init__(self, C, D, version='b0', downsample=8):
        super().__init__()
        self.C, self.D, self.downsample = C, D, downsample
        self.backbone = GoldenBackbone(version, downsample)
        up_in = {('b0', 8): 112 + 40, ('b4', 8): 160 + 56,
                 ('b0', 16): 320 + 112, ('b4', 16): 448 + 160}[(version, downsample)]
        up_out = 512 if downsample == 16 else 128
        self.upsampling_layer = GoldenUpsamplingConcat(up_in, up_out)
        self.depth_layer = nn.Conv2d(up_out, C + D, kernel_size=1, padding=0)

    def forward(self, x):
        x = swish(self.backbone._bn0(self.backbone._conv_stem(x)))
        endpoints = {}
        prev = x
        for block in self.backbone._blocks:
            x = block(x)
            if prev.shape[2] > x.shape[2]:
                endpoints[f'reduction_{len(endpoints) + 1}'] = prev
            prev = x
        endpoints[f'reduction_{len(endpoints) + 1}'] = x
        if self.downsample == 16:
            f_hi, f_lo = endpoints['reduction_5'], endpoints['reduction_4']
        else:
            f_hi, f_lo = endpoints['reduction_4'], endpoints['reduction_3']
        x = self.upsampling_layer(f_hi, f_lo)
        x = self.depth_layer(x)
        depth = x[:, :self.D].softmax(dim=1)
        return depth.unsqueeze(1) * x[:, self.D:self.D + self.C].unsqueeze(2)


class GoldenBasicBlock(nn.Module):
    """torchvision resnet18 BasicBlock naming (conv1/bn1/conv2/bn2/downsample)."""

    def __init__(self, in_ch, out_ch, stride=1, zero_init_residual=True):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        if zero_init_residual:
            nn.init.zeros_(self.bn2.weight)
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch))
        else:
            self.downsample = None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + identity)


class GoldenUpsamplingAdd(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.upsample_layer = nn.Sequential(
            nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False),
            nn.Conv2d(in_channels, out_channels, 1, padding=0, bias=False),
            nn.BatchNorm2d(out_channels))

    def forward(self, x, x_skip):
        return self.upsample_layer(x) + x_skip


def _golden_head(in_ch, out_ch, sigmoid=False):
    layers = [nn.Conv2d(in_ch, in_ch, 3, padding=1, bias=False),
              nn.BatchNorm2d(in_ch), nn.ReLU(inplace=True),
              nn.Conv2d(in_ch, out_ch, 1, padding=0)]
    if sigmoid:
        layers.append(nn.Sigmoid())
    return nn.Sequential(*layers)


class GoldenDecoder(nn.Module):
    def __init__(self, in_channels, n_classes=2, predict_future_flow=True):
        super().__init__()
        self.predict_future_flow = predict_future_flow
        self.first_conv = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3,
                                    bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(GoldenBasicBlock(64, 64),
                                    GoldenBasicBlock(64, 64))
        self.layer2 = nn.Sequential(GoldenBasicBlock(64, 128, stride=2),
                                    GoldenBasicBlock(128, 128))
        self.layer3 = nn.Sequential(GoldenBasicBlock(128, 256, stride=2),
                                    GoldenBasicBlock(256, 256))
        self.up3_skip = GoldenUpsamplingAdd(256, 128)
        self.up2_skip = GoldenUpsamplingAdd(128, 64)
        self.up1_skip = GoldenUpsamplingAdd(64, in_channels)
        self.segmentation_head = _golden_head(in_channels, n_classes)
        self.instance_offset_head = _golden_head(in_channels, 2)
        self.instance_center_head = _golden_head(in_channels, 1, sigmoid=True)
        if predict_future_flow:
            self.instance_future_head = _golden_head(in_channels, 2)

    def forward(self, x):
        b, s, c, h, w = x.shape
        x = x.view(b * s, c, h, w)
        skip1 = x
        x = F.relu(self.bn1(self.first_conv(x)))
        x = self.layer1(x)
        skip2 = x
        x = self.layer2(x)
        skip3 = x
        x = self.layer3(x)
        x = self.up3_skip(x, skip3)
        x = self.up2_skip(x, skip2)
        x = self.up1_skip(x, skip1)
        out = {
            'segmentation': self.segmentation_head(x),
            'instance_center': self.instance_center_head(x),
            'instance_offset': self.instance_offset_head(x),
        }
        if self.predict_future_flow:
            out['instance_flow'] = self.instance_future_head(x)
        return {k: v.view(b, s, *v.shape[1:]) for k, v in out.items()}


class GoldenBottleneck(nn.Module):
    """Reference convolutions.Bottleneck naming (layers.conv_down_project, ...)."""

    def __init__(self, in_channels, out_channels=None, downsample=False):
        super().__init__()
        from collections import OrderedDict
        out_channels = out_channels or in_channels
        mid = in_channels // 2
        self._downsample = downsample
        conv = nn.Conv2d(mid, mid, 3, stride=2 if downsample else 1, padding=1,
                         bias=False)
        self.layers = nn.Sequential(OrderedDict([
            ('conv_down_project', nn.Conv2d(in_channels, mid, 1, bias=False)),
            ('abn_down_project', nn.Sequential(nn.BatchNorm2d(mid),
                                               nn.ReLU(inplace=True))),
            ('conv', conv),
            ('abn', nn.Sequential(nn.BatchNorm2d(mid), nn.ReLU(inplace=True))),
            ('conv_up_project', nn.Conv2d(mid, out_channels, 1, bias=False)),
            ('abn_up_project', nn.Sequential(nn.BatchNorm2d(out_channels),
                                             nn.ReLU(inplace=True))),
            ('dropout', nn.Dropout2d(p=0.0)),
        ]))
        if out_channels == in_channels and not downsample:
            self.projection = None
        else:
            from collections import OrderedDict as OD
            proj = OD()
            if downsample:
                proj['upsample_skip_proj'] = nn.MaxPool2d(2, stride=2)
            proj['conv_skip_proj'] = nn.Conv2d(in_channels, out_channels, 1,
                                               bias=False)
            proj['bn_skip_proj'] = nn.BatchNorm2d(out_channels)
            self.projection = nn.Sequential(proj)

    def forward(self, x):
        residual = self.layers(x)
        if self.projection is not None:
            if self._downsample:
                x = F.pad(x, (0, x.shape[-1] % 2, 0, x.shape[-2] % 2))
            return residual + self.projection(x)
        return residual + x


class GoldenDistribution(nn.Module):
    """model.{present,future}_distribution (reference distributions.py)."""

    def __init__(self, in_channels, latent_dim, min_log_sigma=-5.0,
                 max_log_sigma=5.0):
        super().__init__()
        compress = in_channels // 2
        self.latent_dim = latent_dim
        self.min_log_sigma, self.max_log_sigma = min_log_sigma, max_log_sigma
        encoder = nn.Module()
        encoder.model = nn.Sequential(
            GoldenBottleneck(in_channels, compress, downsample=True),
            GoldenBottleneck(compress, compress, downsample=True),
            GoldenBottleneck(compress, compress, downsample=True),
            GoldenBottleneck(compress, compress, downsample=True))
        self.encoder = encoder
        self.last_conv = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(compress, 2 * latent_dim, 1))

    def forward(self, s_t):
        b = s_t.shape[0]
        encoding = self.encoder.model(s_t[:, 0])
        mu_log_sigma = self.last_conv(encoding).view(b, 1, 2 * self.latent_dim)
        mu = mu_log_sigma[:, :, :self.latent_dim]
        log_sigma = torch.clamp(mu_log_sigma[:, :, self.latent_dim:],
                                self.min_log_sigma, self.max_log_sigma)
        return mu, log_sigma


class GoldenSpatialGRU(nn.Module):
    """Reference layers/temporal.py:10-62 conv GRU."""

    def __init__(self, input_size, hidden_size):
        super().__init__()
        self.conv_update = nn.Conv2d(input_size + hidden_size, hidden_size, 3,
                                     padding=1, bias=True)
        self.conv_reset = nn.Conv2d(input_size + hidden_size, hidden_size, 3,
                                    padding=1, bias=True)
        # conv_state_tilde is a reference ConvBlock (conv + BN + ReLU) with
        # attribute names .conv / .norm (convolutions.py ConvBlock)
        self.conv_state_tilde = nn.Module()
        self.conv_state_tilde.conv = nn.Conv2d(input_size + hidden_size,
                                               hidden_size, 3, padding=1,
                                               bias=False)
        self.conv_state_tilde.norm = nn.BatchNorm2d(hidden_size)

    def gru_cell(self, x, state):
        xh = torch.cat([x, state], dim=1)
        update = torch.sigmoid(self.conv_update(xh))
        reset = torch.sigmoid(self.conv_reset(xh))
        # note: reference gates the state with (1 - reset), temporal.py:60
        xrh = torch.cat([x, (1.0 - reset) * state], dim=1)
        tilde = F.relu(self.conv_state_tilde.norm(self.conv_state_tilde.conv(xrh)))
        return (1.0 - update) * state + update * tilde

    def forward(self, x, state):
        # x: (b, t, c, h, w); state: (b, c_h, h, w)
        out = []
        h = state
        for t in range(x.shape[1]):
            h = self.gru_cell(x[:, t], h)
            out.append(h)
        return torch.stack(out, dim=1)


def _golden_conv1x1x1(in_ch, out_ch):
    from collections import OrderedDict
    return nn.Sequential(OrderedDict([
        ('conv', nn.Conv3d(in_ch, out_ch, kernel_size=1, bias=False)),
        ('norm', nn.BatchNorm3d(out_ch)),
        ('activation', nn.ReLU(inplace=True))]))


class GoldenCausalConv3d(nn.Module):
    """Left-time-padded Conv3d + BN + ReLU (reference temporal.py:65-85)."""

    def __init__(self, in_ch, out_ch, kernel_size=(2, 3, 3)):
        super().__init__()
        kt, kh, kw = kernel_size
        self._pad = (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0)
        self.conv = nn.Conv3d(in_ch, out_ch, kernel_size, bias=False)
        self.norm = nn.BatchNorm3d(out_ch)

    def forward(self, x):
        return F.relu(self.norm(self.conv(F.pad(x, self._pad))))


class GoldenPyramidPooling(nn.Module):
    """reference temporal.py:167-215 with pool_sizes=[(2, h, w)]."""

    def __init__(self, in_channels, reduction_channels, pool_sizes):
        super().__init__()
        from collections import OrderedDict
        feats = []
        for pool_size in pool_sizes:
            feats.append(nn.Sequential(OrderedDict([
                ('avgpool', nn.AvgPool3d(kernel_size=pool_size,
                                         stride=(1, *pool_size[1:]),
                                         padding=(pool_size[0] - 1, 0, 0),
                                         count_include_pad=False)),
                ('conv_bn_relu', _golden_conv1x1x1(in_channels,
                                                   reduction_channels))])))
        self.features = nn.ModuleList(feats)

    def forward(self, x):
        b, _, t, h, w = x.shape
        out = []
        for f in self.features:
            x_pool = f(x)[:, :, :-1].contiguous()
            c = x_pool.shape[1]
            x_pool = F.interpolate(x_pool.view(b * t, c, *x_pool.shape[-2:]),
                                   (h, w), mode='bilinear', align_corners=False)
            out.append(x_pool.view(b, c, t, h, w))
        return torch.cat(out, 1)


class GoldenTemporalBlock(nn.Module):
    """reference temporal.py:218-281."""

    def __init__(self, in_channels, out_channels, use_pyramid_pooling,
                 pool_sizes):
        super().__init__()
        half = in_channels // 2
        self.use_pyramid_pooling = use_pyramid_pooling
        paths = []
        for kernel_size in [(2, 3, 3), (1, 3, 3)]:
            paths.append(nn.Sequential(
                _golden_conv1x1x1(in_channels, half),
                GoldenCausalConv3d(half, half, kernel_size)))
        paths.append(_golden_conv1x1x1(in_channels, half))
        self.convolution_paths = nn.ModuleList(paths)
        agg_in = 3 * half
        if use_pyramid_pooling:
            reduction = in_channels // 3
            self.pyramid_pooling = GoldenPyramidPooling(in_channels, reduction,
                                                        pool_sizes)
            agg_in += len(pool_sizes) * reduction
        self.aggregation = nn.Sequential(_golden_conv1x1x1(agg_in, out_channels))
        if out_channels != in_channels:
            self.projection = nn.Sequential(
                nn.Conv3d(in_channels, out_channels, kernel_size=1, bias=False),
                nn.BatchNorm3d(out_channels))
        else:
            self.projection = None

    def forward(self, x):
        residual = torch.cat([conv(x) for conv in self.convolution_paths], dim=1)
        if self.use_pyramid_pooling:
            residual = torch.cat([residual, self.pyramid_pooling(x)], dim=1)
        residual = self.aggregation(residual)
        if self.projection is not None:
            x = self.projection(x)
        return x + residual


class GoldenTemporalModel(nn.Module):
    """model.temporal_model (reference temporal_model.py:6-52)."""

    def __init__(self, in_channels, receptive_field, input_shape,
                 start_out_channels=64, use_pyramid_pooling=True):
        super().__init__()
        self.receptive_field = receptive_field
        h, w = input_shape
        blocks = []
        block_in, block_out = in_channels, start_out_channels
        for _ in range(receptive_field - 1):
            blocks.append(GoldenTemporalBlock(
                block_in, block_out, use_pyramid_pooling,
                [(2, h, w)] if use_pyramid_pooling else None))
            block_in = block_out
        self.model = nn.Sequential(*blocks)

    def forward(self, x):
        x = x.permute(0, 2, 1, 3, 4)
        x = self.model(x)
        x = x.permute(0, 2, 1, 3, 4).contiguous()
        return x[:, self.receptive_field - 1:]


def randomize_bn3d_stats(module, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
    return module


class GoldenFuturePrediction(nn.Module):
    """model.future_prediction (reference future_prediction.py:7-36)."""

    def __init__(self, in_channels, latent_dim, n_gru_blocks=3, n_res_layers=3):
        super().__init__()
        self.n_gru_blocks = n_gru_blocks
        self.spatial_grus = nn.ModuleList([
            GoldenSpatialGRU(latent_dim if i == 0 else in_channels, in_channels)
            for i in range(n_gru_blocks)])
        self.res_blocks = nn.ModuleList([
            nn.Sequential(*[GoldenBottleneck(in_channels)
                            for _ in range(n_res_layers)])
            for _ in range(n_gru_blocks)])

    def forward(self, x, hidden_state):
        for i in range(self.n_gru_blocks):
            x = self.spatial_grus[i](x, hidden_state)
            b, n_future, c, h, w = x.shape
            x = self.res_blocks[i](x.view(b * n_future, c, h, w))
            x = x.view(b, n_future, c, h, w)
        return x


def randomize_bn_stats(module, seed=0):
    """Give every BN layer non-trivial running stats + affine params so the
    importer's mean/var/scale/bias mapping is actually exercised."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
    return module


def prefixed_state_dict(module, prefix):
    """The module's entries under ``prefix`` as numpy arrays, without BatchNorm's
    ``num_batches_tracked``."""
    return {prefix + k: v.detach().cpu().numpy() for k, v in module.state_dict().items()
            if not k.endswith('num_batches_tracked')}


# ---------------------------------------------------------------------------
# Full-graph golden model: the composed reference forward (fiery.py:130-191)
# ---------------------------------------------------------------------------

def golden_euler2mat(angle):
    """torch restatement of reference geometry.py:109-140 (R = Rx @ Ry @ Rz)."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    zeros, ones = torch.zeros_like(z), torch.ones_like(z)
    zmat = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones],
                       dim=-1).view(*z.shape, 3, 3)
    ymat = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy],
                       dim=-1).view(*z.shape, 3, 3)
    xmat = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx],
                       dim=-1).view(*z.shape, 3, 3)
    return xmat @ ymat @ zmat


def golden_pose_vec2mat(vec):
    """torch restatement of reference geometry.py:143-157."""
    translation = vec[..., :3].unsqueeze(-1)
    rot = golden_euler2mat(vec[..., 3:])
    transform = torch.cat([rot, translation], dim=-1)
    bottom = torch.zeros_like(transform[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([transform, bottom], dim=-2)


def golden_mat2pose_vec(matrix):
    """torch restatement of reference geometry.py:82-106."""
    rotx = torch.atan2(-matrix[..., 1, 2], matrix[..., 2, 2])
    cosy = torch.sqrt(matrix[..., 1, 2] ** 2 + matrix[..., 2, 2] ** 2)
    roty = torch.atan2(matrix[..., 0, 2], cosy)
    rotz = torch.atan2(-matrix[..., 0, 1], matrix[..., 0, 0])
    rotation = torch.stack([rotx, roty, rotz], dim=-1)
    return torch.cat([matrix[..., :3, 3], rotation], dim=-1)


def golden_warp_features(x, flow, spatial_extent):
    """Reference geometry.py:181-222 SE(2) bilinear warp; x (b, c, h, w), flow (b, 6)."""
    b = x.shape[0]
    angle = flow[:, 5]
    tx = -flow[:, 0] / spatial_extent[0]
    ty = flow[:, 1] / spatial_extent[1]
    cos_t, sin_t = torch.cos(angle), torch.sin(angle)
    transformation = torch.stack(
        [cos_t, -sin_t, ty, sin_t, cos_t, tx], dim=-1).view(b, 2, 3)
    grid = F.affine_grid(transformation, size=list(x.shape), align_corners=False)
    return F.grid_sample(x, grid.float(), mode='bilinear', padding_mode='zeros',
                         align_corners=False)


def golden_cumulative_warp_features(x, flow, spatial_extent):
    """Reference geometry.py:225-253: past frames warped to the present frame.

    x (b, t, c, h, w); flow (b, t, 6)."""
    flow_mat = golden_pose_vec2mat(flow)
    # frame t is warped by the composed pose flow[t] @ ... @ flow[-2]
    mats = [flow_mat[:, -2]]
    for t in reversed(range(x.shape[1] - 2)):
        mats.append(flow_mat[:, t] @ mats[-1])
    mats = mats[::-1]
    out = [golden_warp_features(x[:, t], golden_mat2pose_vec(mats[t]),
                                spatial_extent)
           for t in range(x.shape[1] - 1)] + [x[:, -1]]
    return torch.stack(out, dim=1)


class GoldenFiery(nn.Module):
    """The composed reference graph (fiery.py:130-191) from the per-stage golden
    modules, plus torch restatements of the geometry path: frustum
    (fiery.py:109-128), get_geometry (fiery.py:193-208), voxel pooling as a dense
    scatter-add oracle (fiery.py:221-273), cumulative warp (geometry.py:225-253).
    Eval-mode only (the train path adds stochastic drop-connect / future-dist
    sampling). Built on ``device``."""

    def __init__(self, C=16, D=6, final_dim=(64, 96), downsample=8,
                 d_bound=(2.0, 8.0, 1.0), x_bound=(-8.0, 8.0, 0.5),
                 y_bound=(-8.0, 8.0, 0.5), z_bound=(-10.0, 10.0, 20.0),
                 receptive_field=3, n_future=2, latent_dim=4,
                 start_out_channels=16, n_gru_blocks=2, n_res_layers=2,
                 future_in_channels=None, version='b0', device='cpu'):
        super().__init__()
        self.C, self.D = C, D
        self.receptive_field = receptive_field
        self.n_future = n_future
        self.latent_dim = latent_dim
        self.spatial_extent = (x_bound[1], y_bound[1])
        bounds = [x_bound, y_bound, z_bound]
        # buffers kept out of the state_dict: they move with the module
        self.register_buffer('bev_resolution', torch.tensor([r[2] for r in bounds]),
                             persistent=False)
        self.register_buffer('bev_start', torch.tensor([r[0] + r[2] / 2.0 for r in bounds]),
                             persistent=False)
        self.bev_dim = [int((r[1] - r[0]) / r[2]) for r in bounds]

        H, W = final_dim
        h, w = H // downsample, W // downsample
        depths = torch.arange(*d_bound, dtype=torch.float32)
        xs = torch.linspace(0, W - 1, w)
        ys = torch.linspace(0, H - 1, h)
        frustum = torch.stack(torch.broadcast_tensors(
            xs.view(1, 1, w), ys.view(1, h, 1), depths.view(-1, 1, 1)), dim=-1)
        self.register_buffer('frustum', frustum)     # (D, h, w, 3) (u, v, depth)

        bev_hw = (self.bev_dim[0], self.bev_dim[1])
        self.encoder = GoldenEncoder(C, D, version, downsample)
        self.temporal_model = GoldenTemporalModel(
            C + 6, receptive_field, bev_hw, start_out_channels)
        self.present_distribution = GoldenDistribution(start_out_channels,
                                                       latent_dim)
        self.future_distribution = GoldenDistribution(
            future_in_channels or start_out_channels, latent_dim)
        self.future_prediction = GoldenFuturePrediction(
            start_out_channels, latent_dim, n_gru_blocks, n_res_layers)
        self.decoder = GoldenDecoder(start_out_channels)
        self.to(device)

    def get_geometry(self, intrinsics, extrinsics):
        """Reference fiery.py:193-208; intrinsics (B, n, 3, 3), extrinsics (B, n, 4, 4)."""
        rotation = extrinsics[..., :3, :3]
        translation = extrinsics[..., :3, 3]
        points = torch.cat([self.frustum[..., :2] * self.frustum[..., 2:3],
                            self.frustum[..., 2:3]], dim=-1)     # (D, h, w, 3)
        combined = rotation @ torch.inverse(intrinsics)          # (B, n, 3, 3)
        pts = torch.einsum('bnij,dhwj->bndhwi', combined, points)
        return pts + translation.view(*translation.shape[:2], 1, 1, 1, 3)

    def voxel_pool(self, feats, geometry):
        """Dense scatter-add oracle for reference fiery.py:221-273.

        feats (B, n, C, D, h, w); geometry (B, n, D, h, w, 3) -> (B, C, X, Y)."""
        B = feats.shape[0]
        X, Y, Z = self.bev_dim
        out = feats.new_zeros(B, X * Y * Z, self.C)
        vox = torch.trunc((geometry - (self.bev_start - self.bev_resolution / 2.0))
                          / self.bev_resolution).long()          # (B, n, D, h, w, 3)
        valid = ((vox >= 0)
                 & (vox < torch.tensor([X, Y, Z], device=vox.device))).all(dim=-1)
        flat = (vox[..., 0] * Y + vox[..., 1]) * Z + vox[..., 2]
        f = feats.permute(0, 1, 3, 4, 5, 2).reshape(B, -1, self.C)  # points x C
        flat = flat.reshape(B, -1)
        valid = valid.reshape(B, -1)
        for b in range(B):
            ids = flat[b][valid[b]]
            out[b].index_add_(0, ids, f[b][valid[b]])
        return (out.view(B, X, Y, Z, self.C).sum(dim=3)
                .permute(0, 3, 1, 2).contiguous())               # (B, C, X, Y)

    def forward(self, image, intrinsics, extrinsics, future_egomotion,
                future_distribution_inputs=None, noise=None):
        # image (b, s, n, 3, H, W); channels-first like the reference
        rf = self.receptive_field
        b, s, n = image.shape[:3]
        image = image[:, :rf].contiguous()
        intrinsics = intrinsics[:, :rf]
        extrinsics = extrinsics[:, :rf]
        ego = future_egomotion[:, :rf]
        output = {}

        packed = image.view(b * rf, n, *image.shape[3:])
        feats = self.encoder(packed.reshape(b * rf * n, *image.shape[3:]))
        feats = feats.view(b * rf, n, self.C, self.D, *feats.shape[-2:])
        geometry = self.get_geometry(intrinsics.reshape(b * rf, n, 3, 3),
                                     extrinsics.reshape(b * rf, n, 4, 4))
        x = self.voxel_pool(feats, geometry)
        x = x.view(b, rf, self.C, *x.shape[-2:])                 # (b, rf, C, X, Y)

        x = golden_cumulative_warp_features(x, ego, self.spatial_extent)

        # spatial egopose concat, shifted right (reference fiery.py:148-155)
        h, w = x.shape[-2:]
        ego_maps = ego.view(b, rf, 6, 1, 1).expand(b, rf, 6, h, w)
        ego_maps = torch.cat([torch.zeros_like(ego_maps[:, :1]),
                              ego_maps[:, :rf - 1]], dim=1)
        x = torch.cat([x, ego_maps], dim=2)

        states = self.temporal_model(x)
        present_state = states[:, :1]

        present_mu, present_ls = self.present_distribution(present_state)
        future_mu, future_ls = None, None
        if future_distribution_inputs is not None:
            fdi = future_distribution_inputs[:, 1:]
            fdi = fdi.reshape(b, 1, -1, h, w)
            future_features = torch.cat([present_state, fdi], dim=2)
            future_mu, future_ls = self.future_distribution(future_features)
        output.update({'present_mu': present_mu, 'present_log_sigma': present_ls,
                       'future_mu': future_mu, 'future_log_sigma': future_ls})

        if noise is None:
            noise = torch.zeros_like(present_mu)
        sample = present_mu + torch.exp(present_ls) * noise      # eval semantics
        future_input = sample.view(b, 1, self.latent_dim, 1, 1).expand(
            b, self.n_future, self.latent_dim, h, w)
        future_states = self.future_prediction(future_input, present_state[:, 0])
        states_cat = torch.cat([present_state, future_states], dim=1)
        output.update(self.decoder(states_cat))
        return output
