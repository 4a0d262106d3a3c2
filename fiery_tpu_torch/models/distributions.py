"""Present/future latent distributions, diagonal Gaussians (counterpart of
fiery_tpu/models/distributions.py)."""

import torch
import torch.nn as nn

from fiery_tpu_torch.models.layers import Bottleneck, Conv2d


class DistributionEncoder(nn.Module):
    """Four downsampling Bottlenecks in ``model``."""

    def __init__(self, in_channels, out_channels, bn_momentum=0.1):
        super().__init__()
        self.model = nn.Sequential(*[
            Bottleneck(in_channels if i == 0 else out_channels, out_channels,
                       downsample=True, bn_momentum=bn_momentum)
            for i in range(4)])

    def forward(self, x):
        return self.model(x)


class DistributionModule(nn.Module):
    """(mu, log_sigma), each (b, 1, latent_dim) f32, log_sigma clamped."""

    def __init__(self, in_channels, latent_dim, min_log_sigma=-5.0, max_log_sigma=5.0,
                 bn_momentum=0.1):
        super().__init__()
        compress_dim = in_channels // 2
        self.latent_dim = latent_dim
        self.min_log_sigma, self.max_log_sigma = min_log_sigma, max_log_sigma
        self.encoder = DistributionEncoder(in_channels, compress_dim, bn_momentum)
        self.last_conv = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                       Conv2d(compress_dim, 2 * latent_dim, 1))

    def forward(self, s_t):
        """s_t (b, 1, h, w, c) channels-last."""
        b, s = s_t.shape[:2]
        assert s == 1
        encoding = self.encoder(s_t[:, 0].permute(0, 3, 1, 2))
        mu_log_sigma = self.last_conv(encoding).view(b, 1, 2 * self.latent_dim).float()
        mu = mu_log_sigma[..., :self.latent_dim]
        log_sigma = torch.clamp(mu_log_sigma[..., self.latent_dim:],
                                self.min_log_sigma, self.max_log_sigma)
        return mu, log_sigma
