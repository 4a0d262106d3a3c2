"""Temporal model over BEV state sequences (counterpart of
fiery_tpu/models/temporal_model.py). Public layout channels-last (B, T, H, W, C)."""

import torch.nn as nn

from fiery_tpu_torch.models.temporal_layers import Bottleneck3D, TemporalBlock


def temporal_out_channels(name, in_channels, receptive_field, start_out_channels=64,
                          extra_in_channels=0):
    """Output channels of the temporal model (sizes the modules after it)."""
    if name == 'identity':
        return in_channels
    n_layers = receptive_field - 1
    if n_layers == 0:
        return in_channels
    return start_out_channels + extra_in_channels * max(0, n_layers - 1)


class TemporalModelIdentity(nn.Module):
    """Pass-through keeping only frames >= receptive_field - 1."""

    def __init__(self, receptive_field):
        super().__init__()
        self.receptive_field = receptive_field

    def forward(self, x, trim=False):
        return x[:, self.receptive_field - 1:]


class TemporalModel(nn.Module):
    """Stack of receptive_field - 1 TemporalBlocks, each followed by
    ``n_spatial_layers_between_temporal_layers`` (1, 3, 3) Bottleneck3Ds, in one
    flat ``model`` Sequential as the reference numbers its layers."""

    def __init__(self, in_channels, receptive_field, input_shape, start_out_channels=64,
                 extra_in_channels=0, n_spatial_layers_between_temporal_layers=0,
                 use_pyramid_pooling=True, bn_momentum=0.1):
        super().__init__()
        self.receptive_field = receptive_field
        h, w = input_shape
        layers = []
        block_in, block_out = in_channels, start_out_channels
        for _ in range(receptive_field - 1):
            layers.append(TemporalBlock(
                block_in, block_out, use_pyramid_pooling,
                [(2, h, w)] if use_pyramid_pooling else None, bn_momentum))
            for _ in range(n_spatial_layers_between_temporal_layers):
                layers.append(Bottleneck3D(block_out, kernel_size=(1, 3, 3),
                                           bn_momentum=bn_momentum))
            block_in = block_out
            block_out += extra_in_channels
        self.model = nn.Sequential(*layers)

    def forward(self, x, trim=False):
        """x (B, T, H, W, C) -> (B, 1, H, W, C'): the present frame's state.

        trim=True (eval): each TemporalBlock emits one frame fewer than its input
        (drop_front=1), so the stack converges on the present frame instead of
        computing every frame and keeping the last. Exact under running-stat BN.
        """
        x = x.permute(0, 4, 1, 2, 3)
        for layer in self.model:
            x = layer(x, drop_front=1) if trim and isinstance(layer, TemporalBlock) \
                else layer(x)
        x = x.permute(0, 2, 3, 4, 1)
        return x if trim else x[:, self.receptive_field - 1:]
