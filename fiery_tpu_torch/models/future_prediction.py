"""Future state rollout: stacked [SpatialGRU -> Bottleneck x n] blocks (counterpart
of fiery_tpu/models/future_prediction.py)."""

import torch.nn as nn

from fiery_tpu_torch.models.layers import Bottleneck
from fiery_tpu_torch.models.temporal_layers import SpatialGRU


class FuturePrediction(nn.Module):
    def __init__(self, in_channels, latent_dim, n_gru_blocks=3, n_res_layers=3,
                 bn_momentum=0.1):
        super().__init__()
        self.spatial_grus = nn.ModuleList([
            SpatialGRU(latent_dim if i == 0 else in_channels, in_channels, bn_momentum)
            for i in range(n_gru_blocks)])
        self.res_blocks = nn.ModuleList([
            nn.Sequential(*[Bottleneck(in_channels, bn_momentum=bn_momentum)
                            for _ in range(n_res_layers)])
            for _ in range(n_gru_blocks)])

    def forward(self, x, hidden_state):
        """x (b, n_future, h, w, latent) channels-last, hidden_state (b, h, w, c)
        -> (b, n_future, h, w, c). Every GRU block starts from hidden_state."""
        x = x.permute(0, 1, 4, 2, 3)
        hidden = hidden_state.permute(0, 3, 1, 2)
        for gru, res in zip(self.spatial_grus, self.res_blocks):
            x = gru(x, hidden)
            b, n_future = x.shape[:2]
            x = res(x.reshape(b * n_future, *x.shape[2:])).view(b, n_future, *x.shape[2:])
        return x.permute(0, 1, 3, 4, 2)
