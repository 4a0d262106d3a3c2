"""BEV decoder: resnet18-style trunk (layers 1-3) with UpsamplingAdd skip stages and
four output heads (counterpart of fiery_tpu/models/decoder.py).

The JAX package fuses the heads' 3x3 convs into one block-diagonal conv
(``FusedHeads``); here they are the reference's four plain heads, and
utils/weight_import.state_dict_from_jax splits the fused weights.
"""

import torch
import torch.nn as nn

from fiery_tpu_torch.models.layers import BatchNorm, Conv2d, UpsamplingAdd


class BasicBlock(nn.Module):
    """torchvision resnet BasicBlock (conv1/bn1/conv2/bn2/downsample)."""

    def __init__(self, in_channels, channels, stride=1, bn_momentum=0.1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = BatchNorm(channels, momentum=bn_momentum, post='relu')
        self.conv2 = Conv2d(channels, channels, 3, padding=1, bias=False)
        project = stride != 1 or in_channels != channels
        # relu(bn2(h) + identity) rides whichever BN comes last, as in the JAX package
        self.bn2 = BatchNorm(channels, momentum=bn_momentum,
                             post='none' if project else 'add_relu')
        self.downsample = None
        if project:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, channels, 1, stride=stride, bias=False),
                BatchNorm(channels, momentum=bn_momentum, post='add_relu'))

    def forward(self, x):
        h = self.bn1(self.conv1(x))
        if self.downsample is None:
            return self.bn2(self.conv2(h), residual=x)
        h = self.bn2(self.conv2(h))
        conv, bn = self.downsample
        return bn(conv(x), residual=h)


def _head(in_channels, out_channels, bn_momentum):
    return nn.Sequential(
        Conv2d(in_channels, in_channels, 3, padding=1, bias=False),
        BatchNorm(in_channels, momentum=bn_momentum, post='relu'),
        nn.Identity(),          # the ReLU, folded into the BN; keeps the key of [3]
        Conv2d(in_channels, out_channels, 1))


class Decoder(nn.Module):
    def __init__(self, in_channels, n_classes=2, predict_future_flow=True, bn_momentum=0.1):
        super().__init__()
        m = bn_momentum
        self.first_conv = Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, momentum=m, post='relu')
        self.layer1 = nn.Sequential(BasicBlock(64, 64, 1, m), BasicBlock(64, 64, 1, m))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2, m), BasicBlock(128, 128, 1, m))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2, m), BasicBlock(256, 256, 1, m))
        self.up3_skip = UpsamplingAdd(256, 128, bn_momentum=m)
        self.up2_skip = UpsamplingAdd(128, 64, bn_momentum=m)
        self.up1_skip = UpsamplingAdd(64, in_channels, bn_momentum=m)
        self.segmentation_head = _head(in_channels, n_classes, m)
        self.instance_offset_head = _head(in_channels, 2, m)
        self.instance_center_head = _head(in_channels, 1, m)
        self.instance_future_head = (_head(in_channels, 2, m) if predict_future_flow
                                     else None)

    def forward(self, x):
        """x (b, s, h, w, c) channels-last -> dict of (b, s, h, w, ·) head outputs.
        x may be a strided view (the last frame of a training stack); it is made
        contiguous (no copy when it is already) because its first skip is the
        residual of the BatchNorm kernel, which takes only x's channels-last layout."""
        b, s = x.shape[:2]
        x = x.reshape(b * s, *x.shape[2:]).contiguous().permute(0, 3, 1, 2)
        skip1 = x
        x = self.bn1(self.first_conv(x))
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
            'instance_center': torch.sigmoid(self.instance_center_head(x)),
            'instance_offset': self.instance_offset_head(x),
        }
        if self.instance_future_head is not None:
            out['instance_flow'] = self.instance_future_head(x)
        return {k: v.permute(0, 2, 3, 1).reshape(b, s, *v.shape[2:], v.shape[1])
                for k, v in out.items()}
