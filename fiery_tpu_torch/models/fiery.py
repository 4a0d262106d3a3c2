"""Top-level FIERY model (counterpart of fiery_tpu/models/fiery.py).

encoder -> bev_pool splat (kernel K1) -> bilinear ego-motion warp (kernel K2) ->
egopose concat -> temporal model -> latent sample -> SpatialGRU rollout -> decoder.
Eval (``model.eval()``) trims the temporal model to the present frame and samples
the present distribution (zero noise unless given); training (``model.train()``)
runs the whole temporal model, batch-statistics BatchNorm and drop-connect, and
samples the future distribution of the warped future labels. The levers of the
JAX package: LIFT.TOPK splats only each pixel's k largest depth bins (kernel K5,
then K1 at D = k); LIFT.WARP_FREE moves the past frames' lift geometry into the
present frame, so no BEV warp runs; TRIM_TRAIN trims the temporal model in
training too; DEPTH_CULL (``depth_keep``) drops far depth planes that never reach
the grid. Tensor conventions,
channels-last everywhere:
  image (b, s, n, H, W, 3) uint8 or float, intrinsics (b, s, n, 3, 3),
  extrinsics (b, s, n, 4, 4), future_egomotion (b, s, 6), BEV states (b, t, X, Y, C);
  outputs (f32): segmentation (b, t, X, Y, n_classes), instance_center (b, t, X, Y, 1),
  instance_offset / instance_flow (b, t, X, Y, 2), present_mu / present_log_sigma and,
  given future distribution inputs, future_mu / future_log_sigma (b, 1, L).
"""

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from fiery_tpu_torch.models.decoder import Decoder
from fiery_tpu_torch.models.distributions import DistributionModule
from fiery_tpu_torch.models.encoder import Encoder
from fiery_tpu_torch.models.future_prediction import FuturePrediction
from fiery_tpu_torch.models.temporal_model import (TemporalModel, TemporalModelIdentity,
                                                   temporal_out_channels)
from fiery_tpu_torch.ops.lift_splat import (create_frustum, get_geometry, lift_splat_depth,
                                            lift_splat_topk)
from fiery_tpu_torch.ops.warp import (compose_poses_to_present, cumulative_warp_features,
                                      warp_points_to_present)
from fiery_tpu_torch.parallel.mesh import bev_rows, draw_batch, gather_cameras, gather_rows
from fiery_tpu_torch.utils.geometry import (calculate_birds_eye_view_parameters,
                                            pack_sequence_dim)

# ImageNet statistics of the reference preprocessing, applied on device to raw uint8
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class FieryConfig:
    """Static model configuration distilled from the CfgNode."""
    time_receptive_field: int = 3
    n_future_frames: int = 4
    subsample: bool = False
    final_dim: Tuple[int, int] = (224, 480)
    x_bound: Tuple[float, float, float] = (-50.0, 50.0, 0.5)
    y_bound: Tuple[float, float, float] = (-50.0, 50.0, 0.5)
    z_bound: Tuple[float, float, float] = (-10.0, 10.0, 20.0)
    d_bound: Tuple[float, float, float] = (2.0, 50.0, 1.0)
    encoder_downsample: int = 8
    encoder_name: str = 'efficientnet-b4'
    encoder_out_channels: int = 64
    use_depth_distribution: bool = True
    temporal_name: str = 'temporal_block'
    start_out_channels: int = 64
    extra_in_channels: int = 0
    inbetween_layers: int = 0
    pyramid_pooling: bool = True
    input_egopose: bool = True
    latent_dim: int = 32
    min_log_sigma: float = -5.0
    max_log_sigma: float = 5.0
    n_gru_blocks: int = 3
    n_res_layers: int = 3
    bn_momentum: float = 0.1
    n_classes: int = 2
    instance_flow_enabled: bool = True
    probabilistic_enabled: bool = True
    probabilistic_future_dim: int = 6
    precision: int = 32   # 16 -> bf16 compute (BN and the geometry stay f32)
    # per-camera kept depth-plane counts (compute_depth_plane_keep, LIFT.DEPTH_CULL),
    # given by Trainer(cfg, depth_keep=...); None splats every plane
    depth_keep: Optional[Tuple[int, ...]] = None
    # LIFT.TOPK: splat only each pixel's k largest depth bins; 0 splats all of them
    depth_topk: int = 0
    # MODEL.TEMPORAL_MODEL.TRIM_TRAIN: trim the temporal model in training too, so
    # the BatchNorms' batch statistics cover the kept frames only
    temporal_trim_train: bool = False
    # LIFT.WARP_FREE: the past frames' lift geometry moves into the present frame
    # (bin assignment instead of the bilinear warp of the splatted features)
    warp_free: bool = False

    def __post_init__(self):
        if self.subsample and (self.time_receptive_field + self.n_future_frames + 1) // 2 != 8:
            raise ValueError('MODEL.SUBSAMPLE expects TIME_RECEPTIVE_FIELD 5 and '
                             'N_FUTURE_FRAMES 10 (8 subsampled frames)')
        H, W = self.final_dim
        if H % 16 or W % 16:
            raise ValueError(f'IMAGE.FINAL_DIM must be divisible by 16 (got '
                             f'{self.final_dim}): the encoder FPN upsamples the '
                             f'stride-16 endpoint by exactly 2x onto the stride-8 one.')
        if self.depth_topk:
            if not 0 < self.depth_topk <= self.depth_channels:
                raise ValueError(f'LIFT.TOPK must be in [1, D={self.depth_channels}] '
                                 f'(got {self.depth_topk})')
            if self.depth_keep is not None:
                raise ValueError('LIFT.TOPK and LIFT.DEPTH_CULL are exclusive: the sparse '
                                 'top-k splat already drops out-of-bounds mass via the '
                                 'dump bin.')
        if self.warp_free and self.depth_keep is not None:
            raise ValueError('LIFT.WARP_FREE and LIFT.DEPTH_CULL are exclusive: the static '
                             'culling envelope is computed in per-frame grid coordinates '
                             'and does not account for the ego motion folded into the '
                             'geometry.')

    @classmethod
    def from_cfg(cls, cfg):
        """Build from a CfgNode (fiery_tpu_torch.utils.config.get_cfg()). The keep
        counts of DEPTH_CULL depend on the rig and come later (``Trainer``), but its
        exclusive combinations are refused here."""
        if cfg.LIFT.DEPTH_CULL and (cfg.LIFT.TOPK or cfg.LIFT.WARP_FREE):
            raise ValueError(
                'LIFT.DEPTH_CULL is exclusive with LIFT.TOPK (the sparse splat already '
                'drops out-of-bounds mass via the dump bin) and with LIFT.WARP_FREE (the '
                'static culling envelope is computed in per-frame grid coordinates and '
                'does not account for the ego motion folded into the geometry).')
        return cls(
            time_receptive_field=cfg.TIME_RECEPTIVE_FIELD,
            n_future_frames=cfg.N_FUTURE_FRAMES,
            subsample=cfg.MODEL.SUBSAMPLE,
            final_dim=tuple(cfg.IMAGE.FINAL_DIM),
            x_bound=tuple(cfg.LIFT.X_BOUND),
            y_bound=tuple(cfg.LIFT.Y_BOUND),
            z_bound=tuple(cfg.LIFT.Z_BOUND),
            d_bound=tuple(cfg.LIFT.D_BOUND),
            encoder_downsample=cfg.MODEL.ENCODER.DOWNSAMPLE,
            encoder_name=cfg.MODEL.ENCODER.NAME,
            encoder_out_channels=cfg.MODEL.ENCODER.OUT_CHANNELS,
            use_depth_distribution=cfg.MODEL.ENCODER.USE_DEPTH_DISTRIBUTION,
            depth_topk=cfg.LIFT.TOPK,
            warp_free=cfg.LIFT.WARP_FREE,
            temporal_trim_train=cfg.MODEL.TEMPORAL_MODEL.TRIM_TRAIN,
            temporal_name=cfg.MODEL.TEMPORAL_MODEL.NAME,
            start_out_channels=cfg.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS,
            extra_in_channels=cfg.MODEL.TEMPORAL_MODEL.EXTRA_IN_CHANNELS,
            inbetween_layers=cfg.MODEL.TEMPORAL_MODEL.INBETWEEN_LAYERS,
            pyramid_pooling=cfg.MODEL.TEMPORAL_MODEL.PYRAMID_POOLING,
            input_egopose=cfg.MODEL.TEMPORAL_MODEL.INPUT_EGOPOSE,
            latent_dim=cfg.MODEL.DISTRIBUTION.LATENT_DIM,
            min_log_sigma=cfg.MODEL.DISTRIBUTION.MIN_LOG_SIGMA,
            max_log_sigma=cfg.MODEL.DISTRIBUTION.MAX_LOG_SIGMA,
            n_gru_blocks=cfg.MODEL.FUTURE_PRED.N_GRU_BLOCKS,
            n_res_layers=cfg.MODEL.FUTURE_PRED.N_RES_LAYERS,
            bn_momentum=cfg.MODEL.BN_MOMENTUM,
            n_classes=len(cfg.SEMANTIC_SEG.WEIGHTS),
            instance_flow_enabled=cfg.INSTANCE_FLOW.ENABLED,
            probabilistic_enabled=cfg.PROBABILISTIC.ENABLED,
            probabilistic_future_dim=cfg.PROBABILISTIC.FUTURE_DIM,
            precision=cfg.PRECISION,
        )

    @property
    def receptive_field(self):
        # Lyft subsampling halves the effective sequence
        return 3 if self.subsample else self.time_receptive_field

    @property
    def n_future(self):
        return 5 if self.subsample else self.n_future_frames

    @property
    def spatial_extent(self):
        return (self.x_bound[1], self.y_bound[1])

    @property
    def bev_parameters(self):
        return calculate_birds_eye_view_parameters(self.x_bound, self.y_bound, self.z_bound)

    @property
    def bev_size(self):
        _, _, dim = self.bev_parameters
        return (int(dim[0]), int(dim[1]))

    @property
    def depth_channels(self):
        return int((self.d_bound[1] - self.d_bound[0]) / self.d_bound[2])

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.precision == 16 else torch.float32


class Fiery(nn.Module):
    def __init__(self, cfg: FieryConfig):
        super().__init__()
        c = self.cfg = cfg
        self.register_buffer('frustum', torch.from_numpy(create_frustum(
            c.final_dim, c.encoder_downsample, c.d_bound)), persistent=False)
        self.register_buffer('image_mean', torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer('image_std', torch.tensor(IMAGENET_STD), persistent=False)
        m = c.bn_momentum
        self.encoder = Encoder(c.encoder_out_channels, c.depth_channels,
                               c.encoder_name.split('-')[1], c.encoder_downsample,
                               c.use_depth_distribution, m)
        temporal_in = c.encoder_out_channels + (6 if c.input_egopose else 0)
        if c.temporal_name == 'identity':
            self.temporal_model = TemporalModelIdentity(c.receptive_field)
        elif c.temporal_name == 'temporal_block':
            self.temporal_model = TemporalModel(
                temporal_in, c.receptive_field, c.bev_size, c.start_out_channels,
                c.extra_in_channels, c.inbetween_layers, c.pyramid_pooling, m)
        else:
            raise NotImplementedError(f'Temporal module {c.temporal_name}')
        fp_in = temporal_out_channels(c.temporal_name, temporal_in, c.receptive_field,
                                      c.start_out_channels, c.extra_in_channels)
        if c.n_future > 0:
            if c.probabilistic_enabled:
                dist = dict(latent_dim=c.latent_dim, min_log_sigma=c.min_log_sigma,
                            max_log_sigma=c.max_log_sigma, bn_momentum=m)
                self.present_distribution = DistributionModule(fp_in, **dist)
                # conditioned on the future labels: training (and eval with labels)
                self.future_distribution = DistributionModule(
                    fp_in + c.n_future * c.probabilistic_future_dim, **dist)
            self.future_prediction = FuturePrediction(fp_in, c.latent_dim, c.n_gru_blocks,
                                                      c.n_res_layers, m)
        self.decoder = Decoder(fp_in, c.n_classes, c.instance_flow_enabled, m)
        # the camera group of a camera-parallel trainer (parallel/mesh.py
        # make_parallel_trainer): in training the images are then the rank's cameras,
        # and the encoder's outputs are gathered over the group before the splat
        self.camera_group = None
        # the rank's share of the BEV rows under the BEV spatial axis (a RowShare of
        # the camera group, make_parallel_trainer(bev_parallel=True)): in training the
        # modules after the splat then run on the share
        self.row_share = None

    def forward(self, image, intrinsics, extrinsics, future_egomotion,
                future_distribution_inputs=None, noise=None, generator=None):
        """future_distribution_inputs (b, 1 + n_future, X, Y, 6): the warped label
        maps of the present and future frames, which training needs. noise (b, 1, L):
        the latent's standard-normal draw; if None, training draws it from
        ``generator`` (torch's default one if None) and eval takes zero. The
        generator also draws the drop-connect masks. In training with a
        ``row_share`` the BEV outputs are the share's rows (dim 2), the
        distributions' the whole grid's."""
        c = self.cfg
        rf, dt = c.receptive_field, c.compute_dtype
        image = image[:, :rf]
        if image.dtype == torch.uint8:
            image = (image.float() / 255.0 - self.image_mean) / self.image_std
        image = image.to(dt)
        egomotion = future_egomotion[:, :rf].float()
        x = self.calculate_birds_eye_view_features(
            image, intrinsics[:, :rf].float(), extrinsics[:, :rf].float(), generator,
            egomotion=egomotion if c.warp_free else None)
        if not c.warp_free:
            x = cumulative_warp_features(x, egomotion, mode='bilinear',
                                         spatial_extent=c.spatial_extent)
        if c.input_egopose:
            b, s = egomotion.shape[:2]
            h, w = x.shape[2:4]
            ego = egomotion[:, :, None, None, :].expand(b, s, h, w, 6)
            # at time 0 there is no egomotion: shift right, zero-fill
            ego = torch.cat([torch.zeros_like(ego[:, :1]), ego[:, :rf - 1]], dim=1)
            x = torch.cat([x, ego.to(x.dtype)], dim=-1)

        share = self.row_share if self.training else None
        if share is not None:
            # the BEV spatial axis: the rank's rows from here to the heads
            if x.shape[2] != share.edges[-1]:
                raise ValueError(f'a plan of {share.edges[-1]} rows for a grid of '
                                 f'{x.shape[2]}')
            x = x[:, :, share.edges[share.index]:share.edges[share.index + 1]].contiguous()

        # eval trims the stack to the present frame (exact under running statistics);
        # training keeps every frame, whose batch statistics the BatchNorms need,
        # unless TRIM_TRAIN trims it too
        with bev_rows(share):
            states = self.temporal_model(x, trim=not self.training or c.temporal_trim_train)
        output = {}
        if c.n_future > 0:
            present_state = states[:, :1]
            b, _, h, w, _ = present_state.shape
            if c.probabilistic_enabled:
                # the distributions take the whole grid on every rank of the group
                whole = present_state if share is None else gather_rows(present_state, 2,
                                                                        share)
                sample, distributions = self.distribution_forward(
                    whole, future_distribution_inputs, noise, generator)
                output.update(distributions)
                future_input = sample[:, :, None, None, :].expand(
                    b, c.n_future, h, w, c.latent_dim).to(dt)
            else:
                future_input = torch.zeros((b, c.n_future, h, w, c.latent_dim), dtype=dt,
                                           device=present_state.device)
            with bev_rows(share):
                future_states = self.future_prediction(future_input, present_state[:, 0])
                bev_output = self.decoder(torch.cat([present_state, future_states], dim=1))
        else:
            with bev_rows(share):
                bev_output = self.decoder(states[:, -1:])
        output.update({k: v.float() for k, v in bev_output.items()})
        return output

    def distribution_forward(self, present_state, future_distribution_inputs, noise,
                             generator):
        """The latent sample (b, 1, L) f32: mu + exp(log_sigma) * noise, of the future
        distribution in training and of the present one in eval; and the
        distributions' parameters."""
        b, _, h, w, _ = present_state.shape
        mu, log_sigma = self.present_distribution(present_state)
        output = {'present_mu': mu, 'present_log_sigma': log_sigma}
        if future_distribution_inputs is not None:
            # the future frames' label maps, flattened into channels
            fdi = future_distribution_inputs[:, 1:].permute(0, 2, 3, 1, 4).reshape(
                b, h, w, -1)[:, None].to(present_state.dtype)
            future_mu, future_log_sigma = self.future_distribution(
                torch.cat([present_state, fdi], dim=-1))
            output['future_mu'], output['future_log_sigma'] = future_mu, future_log_sigma
            if self.training:
                mu, log_sigma = future_mu, future_log_sigma
        elif self.training:
            raise ValueError('training samples the future distribution: pass '
                             'future_distribution_inputs')
        if noise is None:
            if self.training:
                device = generator.device if generator is not None else mu.device
                noise = draw_batch(torch.randn, mu.shape, generator, device)
            else:
                noise = torch.zeros_like(mu)
        return mu + torch.exp(log_sigma) * noise.to(mu.device, mu.dtype), output

    def calculate_birds_eye_view_features(self, x, intrinsics, extrinsics, generator=None,
                                          egomotion=None):
        """(b, s, n, H, W, 3) images -> (b, s, X, Y, C) BEV features. With
        ``egomotion`` (b, s, 6) (the warp-free lift) the past frames' geometry is
        moved into the present frame by the composed poses, in f32, before it is
        cast to the compute dtype; the present frame's is left as it is. In
        training with a ``camera_group`` of M ranks, x holds the rank's n = N / M
        cameras of the N that the calibrations hold: the encoder runs on them, and
        its depth and features are gathered over the group before the splat."""
        c = self.cfg
        b, s, n = x.shape[:3]
        geometry = get_geometry(self.frustum, pack_sequence_dim(intrinsics),
                                pack_sequence_dim(extrinsics))   # (b*s, N, D, h, w, 3)
        if egomotion is not None and s > 1:
            geometry = geometry.reshape(b, s, *geometry.shape[1:])
            poses = compose_poses_to_present(egomotion)            # (b, s-1, 6)
            past = pack_sequence_dim(geometry[:, :-1])
            xy = warp_points_to_present(past[..., :2], pack_sequence_dim(poses),
                                        c.spatial_extent, (c.x_bound[:2], c.y_bound[:2]))
            past = torch.cat([xy, past[..., 2:]], dim=-1).view(b, s - 1, *past.shape[1:])
            geometry = pack_sequence_dim(torch.cat([past, geometry[:, -1:]], dim=1))
        depth, feat = self.encoder(x.reshape(b * s * n, *x.shape[3:]), generator, per_frame=n)
        depth = depth.reshape(b * s, n, *depth.shape[1:])          # (b*s, n, h, w, D)
        feat = feat.reshape(b * s, n, *feat.shape[1:])             # (b*s, n, h, w, C)
        if self.training and self.camera_group is not None:
            depth = gather_cameras(depth, self.camera_group)      # (b*s, N, h, w, D)
            feat = gather_cameras(feat, self.camera_group)
        if depth.shape[1] != intrinsics.shape[2]:
            raise ValueError(f'{depth.shape[1]} cameras encoded for the '
                             f'{intrinsics.shape[2]} of the calibrations')
        res, start, dim = c.bev_parameters
        geometry = geometry.to(feat.dtype)
        if c.depth_topk:
            bev = lift_splat_topk(depth, feat, geometry, c.depth_topk, res, start, dim)
        else:
            bev = lift_splat_depth(depth, feat, geometry, res, start, dim,
                                   depth_keep=c.depth_keep)
        return bev.view(b, s, *bev.shape[1:])
