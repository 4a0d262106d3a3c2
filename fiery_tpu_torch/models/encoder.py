"""Image encoder: EfficientNet FPN + categorical-depth head (counterpart of
fiery_tpu/models/encoder.py).

Input channels-last (B, H, W, 3); output the depth distribution (B, h, w, D) and
the context features (B, h, w, C) unlifted, with h, w = H, W / downsample. Their
outer product is never built: the bev_pool kernel forms it while it splats.
"""

import torch
import torch.nn as nn

from fiery_tpu_torch.models.efficientnet import (EfficientNetFPN, block_specs,
                                                 truncation_index)
from fiery_tpu_torch.models.layers import Conv2d, UpsamplingConcat


def _endpoint_channels(version, downsample):
    """Channels of the backbone's reduction endpoints, in order."""
    specs = block_specs(version)[:truncation_index(version, downsample) + 1]
    chans = [specs[i - 1][4] for i in range(1, len(specs)) if specs[i][1] == 2]
    return chans + [specs[-1][4]]


class Encoder(nn.Module):
    def __init__(self, out_channels, depth_channels, version='b4', downsample=8,
                 use_depth_distribution=True, bn_momentum=0.1):
        super().__init__()
        self.C, self.D = out_channels, depth_channels
        self.use_depth_distribution = use_depth_distribution
        self.backbone = EfficientNetFPN(version, downsample, bn_momentum)
        chans = _endpoint_channels(version, downsample)
        hi, lo = (4, 3) if downsample == 16 else (3, 2)
        upsampling_out = 512 if downsample == 16 else 128
        self.upsampling_layer = UpsamplingConcat(chans[hi] + chans[lo], upsampling_out,
                                                 bn_momentum=bn_momentum)
        head = out_channels + depth_channels if use_depth_distribution else out_channels
        self.depth_layer = Conv2d(upsampling_out, head, kernel_size=1)

    def forward(self, x, generator=None):
        """x (B, H, W, 3) -> (depth (B, h, w, D), features (B, h, w, C)). The
        generator draws the backbone's drop-connect masks in training."""
        feat_hi, feat_lo = self.backbone(x.permute(0, 3, 1, 2), generator)
        x = self.depth_layer(self.upsampling_layer(feat_hi, feat_lo)).permute(0, 2, 3, 1)
        D, C = self.D, self.C
        if not self.use_depth_distribution:
            return torch.ones((*x.shape[:-1], D), dtype=x.dtype, device=x.device), x
        return torch.softmax(x[..., :D], dim=-1), x[..., D:D + C]
