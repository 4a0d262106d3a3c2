"""Synthetic in-memory dataset: scripted moving boxes in BEV + random camera images
(a copy of fiery_tpu/data/synthetic.py; the same arrays for the same seed).

Shapes and dict layout are those of the real pipeline, channels-last:
  image (s, n, H, W, 3) uint8 RAW pixels (normalised on device like the real
  loader path), intrinsics (s, n, 3, 3), extrinsics (s, n, 4, 4),
  future_egomotion (s, 6), segmentation (s, X, Y, 1) int, instance (s, X, Y) int,
  centerness (s, X, Y, 1), offset (s, X, Y, 2), flow (s, X, Y, 2).
"""

import numpy as np

from fiery_tpu_torch.data.labels import convert_instance_mask_to_center_and_offset_label
from fiery_tpu_torch.utils.geometry import calculate_birds_eye_view_parameters

# ImageNet statistics of the reference preprocessing
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class SyntheticFutureDataset:
    """learnable=True paints each instance into the camera images as a bright blob at
    its projected pixel location (size ~ 1/depth), so the lift-splat geometry path has
    real signal to learn from; learnable=False keeps pure-noise images (mechanics-only
    testing)."""

    def __init__(self, cfg, n_samples=8, n_instances=3, seed=0, learnable=True):
        self.learnable = learnable
        self.cfg = cfg
        self.n_samples = n_samples
        self.n_instances = n_instances
        self.seed = seed
        self.receptive_field = cfg.TIME_RECEPTIVE_FIELD
        self.sequence_length = cfg.TIME_RECEPTIVE_FIELD + cfg.N_FUTURE_FRAMES
        self.n_cameras = len(cfg.IMAGE.NAMES)
        self.final_dim = tuple(cfg.IMAGE.FINAL_DIM)
        _, _, dim = calculate_birds_eye_view_parameters(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
        self.bev_size = (int(dim[0]), int(dim[1]))
        self.spatial_extent = (cfg.LIFT.X_BOUND[1], cfg.LIFT.Y_BOUND[1])

    def __len__(self):
        return self.n_samples

    def _camera_rig(self, rng):
        """Six (or n) cameras looking outwards with a plausible pinhole intrinsic."""
        H, W = self.final_dim
        fx = 0.5 * W
        K = np.array([[fx, 0.0, W / 2.0], [0.0, fx, H / 2.0], [0.0, 0.0, 1.0]],
                     dtype=np.float32)
        intrinsics = np.stack([K] * self.n_cameras)
        extrinsics = []
        for i in range(self.n_cameras):
            yaw = 2.0 * np.pi * i / self.n_cameras
            c, s = np.cos(yaw), np.sin(yaw)
            # camera +z (view dir) along ego (c, s, 0); +x right; +y down
            R = np.array([[-s, 0.0, c],
                          [c, 0.0, s],
                          [0.0, -1.0, 0.0]], dtype=np.float32)
            E = np.eye(4, dtype=np.float32)
            E[:3, :3] = R
            E[:3, 3] = [0.0, 0.0, 1.6]
            extrinsics.append(E)
        return intrinsics, np.stack(extrinsics)

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        s, n = self.sequence_length, self.n_cameras
        H, W = self.final_dim
        X, Y = self.bev_size

        image = 0.3 * rng.randn(s, n, H, W, 3).astype(np.float32)
        intrinsics, extrinsics = self._camera_rig(rng)
        intrinsics = np.broadcast_to(intrinsics, (s, n, 3, 3)).copy()
        extrinsics = np.broadcast_to(extrinsics, (s, n, 4, 4)).copy()

        # constant small forward egomotion + slight yaw
        ego_vec = np.zeros(6, dtype=np.float32)
        ego_vec[0] = rng.uniform(0.2, 0.8)
        ego_vec[5] = rng.uniform(-0.01, 0.01)
        future_egomotion = np.broadcast_to(ego_vec, (s, 6)).copy()

        # scripted rectangular instances moving with constant pixel velocity
        instance = np.zeros((s, X, Y), dtype=np.int32)
        for inst_id in range(1, self.n_instances + 1):
            x0 = rng.randint(X // 4, 3 * X // 4)
            y0 = rng.randint(Y // 4, 3 * Y // 4)
            vx, vy = rng.randint(-2, 3), rng.randint(-2, 3)
            hx, hy = rng.randint(3, 7), rng.randint(3, 7)
            for t in range(s):
                cx, cy = x0 + vx * t, y0 + vy * t
                xs, xe = max(0, cx - hx), min(X, cx + hx)
                ys, ye = max(0, cy - hy), min(Y, cy + hy)
                if xs < xe and ys < ye:
                    instance[t, xs:xe, ys:ye] = inst_id

        if self.learnable:
            self._paint_instances(image, instance, intrinsics, extrinsics, rng)

        segmentation = (instance > 0).astype(np.int32)[..., None]
        center, offset, flow = convert_instance_mask_to_center_and_offset_label(
            instance, future_egomotion, num_instances=self.n_instances,
            ignore_index=self.cfg.DATASET.IGNORE_INDEX,
            spatial_extent=self.spatial_extent)

        # raw uint8 pixels, as the real loader ships them (the model normalises
        # on the device): map the normalised-space image back through the
        # ImageNet statistics
        image_u8 = np.clip((image * IMAGENET_STD + IMAGENET_MEAN) * 255.0,
                           0.0, 255.0).round().astype(np.uint8)

        return {
            'image': image_u8,
            'intrinsics': intrinsics,
            'extrinsics': extrinsics,
            'future_egomotion': future_egomotion,
            'segmentation': segmentation,
            'instance': instance,
            'centerness': center,
            'offset': offset,
            'flow': flow,
        }

    def _paint_instances(self, image, instance, intrinsics, extrinsics, rng):
        """Draw a coloured gaussian blob per instance in every camera that sees it."""
        s, n = image.shape[:2]
        H, W = self.final_dim
        res_x = (2 * self.spatial_extent[0]) / self.bev_size[0]
        res_y = (2 * self.spatial_extent[1]) / self.bev_size[1]
        vv, uu = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing='ij')
        n_inst = int(instance.max())
        colours = rng.uniform(1.5, 3.0, (n_inst + 1, 3)).astype(np.float32)
        for t in range(s):
            for inst_id in range(1, n_inst + 1):
                mask = instance[t] == inst_id
                if not mask.any():
                    continue
                ix, iy = np.argwhere(mask).mean(axis=0)
                # BEV bin -> ego metres (bin centers span [-extent, extent])
                x_m = (ix + 0.5) * res_x - self.spatial_extent[0]
                y_m = (iy + 0.5) * res_y - self.spatial_extent[1]
                p_ego = np.array([x_m, y_m, 0.5, 1.0])
                for cam in range(n):
                    E = extrinsics[t, cam]
                    K = intrinsics[t, cam]
                    E_inv = np.eye(4)
                    R = E[:3, :3]
                    E_inv[:3, :3] = R.T
                    E_inv[:3, 3] = -R.T @ E[:3, 3]
                    p_cam = E_inv @ p_ego
                    z = p_cam[2]
                    if z < 2.0:
                        continue
                    u = K[0, 0] * p_cam[0] / z + K[0, 2]
                    v = K[1, 1] * p_cam[1] / z + K[1, 2]
                    if not (-20 <= u < W + 20 and -20 <= v < H + 20):
                        continue
                    sigma = max(2.0, 60.0 / z)
                    blob = np.exp(-(((uu - u) ** 2) + ((vv - v) ** 2))
                                  / (2 * sigma ** 2)).astype(np.float32)
                    image[t, cam] += blob[..., None] * colours[inst_id]

    def get_batch(self, indices):
        samples = [self[i] for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
