"""nuScenes and Lyft datasets: windows of 6-camera frames and BEV labels,
channels-last (the port's copy of fiery_tpu/data/nuscenes_dataset.py, which it
matches sample for sample: tests/test_torch_nuscenes_loader.py).

Scene splits, chronological sliding windows that do not cross a scene, JPEG ->
bilinear resize -> top crop (the images ship as raw uint8; the model normalises
them on the device) with the resize and crop folded into the intrinsics,
camera -> "flat" lidar-ego extrinsics through quaternion chains, cv2.fillPoly
rasterisation of the annotations' bottom corners under a yaw-only ego pose, the
6-DoF egomotion between consecutive lidar poses, Lyft's ::2 subsample with the
egomotion composed, and the centerness, offset and flow labels.

The dataset touches a narrow indexing interface (``nusc.sample``, ``nusc.get``,
``nusc.version``, ``nusc.dataroot``), which ``data/nuscenes_indexer.NuScenesIndex``
provides from the JSON tables. Quaternions come from ``utils/quaternion.py``.

Decoding: through the native pipe (``fiery_tpu_torch/native``) when it builds, else
PIL; a call that the pipe refuses (a file that is not a JPEG, a crop that leaves
the resized image) is decoded by PIL. ``take_decode_counts()`` says how many
images each decoder decoded; the loader adds up the counts of its workers.
"""

import hashlib
import os
from collections import Counter

import numpy as np
from PIL import Image

from fiery_tpu_torch.data.label_warp import (
    _mat2pose_vec as mat2pose_vec_np,
    _pose_vec2mat as pose_vec2mat_np,
)
from fiery_tpu_torch.data.labels import convert_instance_mask_to_center_and_offset_label
from fiery_tpu_torch.data.lyft_splits import TRAIN_LYFT_INDICES, VAL_LYFT_INDICES
from fiery_tpu_torch.data.nuscenes_indexer import NuScenesIndex, create_splits_scenes
from fiery_tpu_torch.native import decode_resize_crop_normalize, image_pipe_available
from fiery_tpu_torch.utils.geometry import calculate_birds_eye_view_parameters
from fiery_tpu_torch.utils.quaternion import (
    quat_inverse,
    quat_to_rotation_matrix,
    quat_yaw,
    yaw_quat,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

LYFT_VEHICLE_CATEGORIES = ['bus', 'car', 'construction_vehicle', 'trailer', 'truck']


def _pose_matrix(rotation_quat, translation):
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_rotation_matrix(rotation_quat)
    m[:3, 3] = translation
    return m


def _invert_rigid(m):
    out = np.eye(4, dtype=np.float64)
    r_t = m[:3, :3].T
    out[:3, :3] = r_t
    out[:3, 3] = -r_t @ m[:3, 3]
    return out


def box_bottom_corners(translation, size, rotation_quat):
    """Bottom 4 corners (3, 4) of a 3D box, nuScenes devkit convention
    (size = (width, length, height); x-axis = length/forward)."""
    w, l, h = size
    x_c = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
    y_c = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    z_c = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
    corners = quat_to_rotation_matrix(rotation_quat) @ np.vstack([x_c, y_c, z_c])
    corners = corners + np.asarray(translation, dtype=np.float64)[:, None]
    return corners[:, [2, 3, 7, 6]]


def resize_and_crop_image(img, resize_dims, crop):
    """PIL bilinear resize then crop."""
    img = img.resize(resize_dims, resample=Image.BILINEAR)
    return img.crop(crop)


def normalise_image(img):
    """PIL -> normalised float32 (H, W, 3)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def update_intrinsics_np(K, top_crop, left_crop, scale_width, scale_height):
    K = np.array(K, dtype=np.float64)
    K[0, 0] *= scale_width
    K[0, 2] = K[0, 2] * scale_width - left_crop
    K[1, 1] *= scale_height
    K[1, 2] = K[1, 2] * scale_height - top_crop
    return K


class FuturePredictionDataset:
    """Sliding-window dataset over nuScenes/Lyft samples (channels-last outputs)."""

    def __init__(self, nusc, is_train, cfg, is_lyft=False):
        self.nusc = nusc
        self.is_train = is_train
        self.cfg = cfg
        self.is_lyft = is_lyft
        self.dataroot = getattr(nusc, 'dataroot', None) or getattr(nusc, 'data_path', '')
        self.sequence_length = cfg.TIME_RECEPTIVE_FIELD + cfg.N_FUTURE_FRAMES

        self.scenes = self.get_scenes()
        self.ixes = self.prepro()
        self.indices = self.get_indices()
        self.augmentation_parameters = self.get_resizing_and_cropping_parameters()

        self.bev_resolution, self.bev_start_position, self.bev_dimension = (
            calculate_birds_eye_view_parameters(
                cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND))
        self.spatial_extent = (cfg.LIFT.X_BOUND[1], cfg.LIFT.Y_BOUND[1])
        self.decode_counts = Counter()

        # optional on-disk cache of the rasterised labels: the cv2.fillPoly pass is
        # a large share of host __getitem__ time and is deterministic per sample
        self.label_cache_dir = cfg.DATASET.LABEL_CACHE_DIR
        if self.label_cache_dir:
            grid_key = hashlib.md5(str((
                cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND,
                cfg.DATASET.FILTER_INVISIBLE_VEHICLES, self.is_lyft,
            )).encode()).hexdigest()[:10]
            self.label_cache_dir = os.path.join(self.label_cache_dir, grid_key)
            os.makedirs(self.label_cache_dir, exist_ok=True)

    # -- indexing ---------------------------------------------------------
    def get_scenes(self):
        if self.is_lyft:
            scenes = [row['name'] for row in self.nusc.scene]
            indices = TRAIN_LYFT_INDICES if self.is_train else VAL_LYFT_INDICES
            # the split constants index the full 180-scene Lyft train set;
            # indices beyond the tree's scene count are skipped, so that a
            # smaller tree still splits
            return [scenes[i] for i in indices if i < len(scenes)]
        split = {'v1.0-trainval': {True: 'train', False: 'val'},
                 'v1.0-mini': {True: 'mini_train', False: 'mini_val'}}[
                     self.nusc.version][self.is_train]
        return create_splits_scenes()[split]

    def prepro(self):
        samples = [s for s in self.nusc.sample
                   if self.nusc.get('scene', s['scene_token'])['name'] in self.scenes]
        samples.sort(key=lambda x: (x['scene_token'], x['timestamp']))
        return samples

    def get_indices(self):
        indices = []
        for index in range(len(self.ixes)):
            current = []
            previous = None
            valid = True
            for t in range(self.sequence_length):
                index_t = index + t
                if index_t >= len(self.ixes):
                    valid = False
                    break
                rec = self.ixes[index_t]
                if previous is not None and rec['scene_token'] != previous['scene_token']:
                    valid = False
                    break
                current.append(index_t)
                previous = rec
            if valid:
                indices.append(current)
        return np.asarray(indices)

    def get_resizing_and_cropping_parameters(self):
        original_height = self.cfg.IMAGE.ORIGINAL_HEIGHT
        original_width = self.cfg.IMAGE.ORIGINAL_WIDTH
        final_height, final_width = self.cfg.IMAGE.FINAL_DIM
        resize_scale = self.cfg.IMAGE.RESIZE_SCALE
        resize_dims = (int(original_width * resize_scale),
                       int(original_height * resize_scale))
        resized_width, resized_height = resize_dims
        crop_h = self.cfg.IMAGE.TOP_CROP
        crop_w = int(max(0, (resized_width - final_width) / 2))
        crop = (crop_w, crop_h, crop_w + final_width, crop_h + final_height)
        return {'scale_width': resize_scale, 'scale_height': resize_scale,
                'resize_dims': resize_dims, 'crop': crop}

    # -- per-frame pieces -------------------------------------------------
    def get_input_data(self, rec):
        """Returns images (N, H, W, 3) uint8, intrinsics (N, 3, 3), extrinsics
        (N, 4, 4): camera -> yaw-only ("flat") lidar ego frame. The cameras' JPEGs
        are decoded in one call of the native pipe when it is available, else with
        PIL (``_load_images``)."""
        intrinsics, extrinsics, filenames = [], [], []

        lidar_sample = self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])
        lidar_pose = self.nusc.get('ego_pose', lidar_sample['ego_pose_token'])
        yaw = quat_yaw(lidar_pose['rotation'])
        lidar_to_world = _pose_matrix(yaw_quat(yaw), lidar_pose['translation'])

        for cam in self.cfg.IMAGE.NAMES:
            camera_sample = self.nusc.get('sample_data', rec['data'][cam])

            car_egopose = self.nusc.get('ego_pose', camera_sample['ego_pose_token'])
            world_to_car_egopose = _invert_rigid(
                _pose_matrix(car_egopose['rotation'], car_egopose['translation']))

            sensor_sample = self.nusc.get('calibrated_sensor',
                                          camera_sample['calibrated_sensor_token'])
            intrinsic = np.array(sensor_sample['camera_intrinsic'], dtype=np.float64)
            car_egopose_to_sensor = _invert_rigid(
                _pose_matrix(sensor_sample['rotation'], sensor_sample['translation']))

            lidar_to_sensor = car_egopose_to_sensor @ world_to_car_egopose @ lidar_to_world
            sensor_to_lidar = np.linalg.inv(lidar_to_sensor).astype(np.float32)

            filenames.append(os.path.join(self.dataroot, camera_sample['filename']))

            crop = self.augmentation_parameters['crop']
            intrinsics.append(update_intrinsics_np(
                intrinsic, crop[1], crop[0],
                self.augmentation_parameters['scale_width'],
                self.augmentation_parameters['scale_height']).astype(np.float32))
            extrinsics.append(sensor_to_lidar)

        images = self._load_images(filenames)
        return (images, np.stack(intrinsics), np.stack(extrinsics))

    def _load_images(self, filenames):
        resize_dims = self.augmentation_parameters['resize_dims']
        crop = self.augmentation_parameters['crop']
        # raw uint8 frames after the resize and crop; the model normalises them on
        # the device (4x fewer bytes to the card than normalised f32)
        if self._use_native_images():
            blobs = []
            for path in filenames:
                with open(path, 'rb') as f:
                    blobs.append(f.read())
            try:
                # mean 0 / std 1/255 makes the pipe emit the raw pixel value in
                # f32; rint is exact (error ~1e-5 << 0.5) before the u8 cast
                raw = decode_resize_crop_normalize(
                    blobs, resize_dims, crop, np.zeros(3, np.float32),
                    np.full(3, 1.0 / 255.0, np.float32),
                    fast_scale=bool(self.cfg.DATASET.FAST_DECODE))
                self.decode_counts['native'] += len(filenames)
                return np.rint(raw).astype(np.uint8)
            except RuntimeError:
                # a file that is not a JPEG, or a crop that leaves the resized
                # image: PIL decodes this call
                self.decode_counts['native_refused'] += len(filenames)
        images = []
        for path in filenames:
            img = Image.open(path)
            if self.cfg.DATASET.FAST_DECODE:
                # PIL's counterpart of the pipe's fast path: a DCT-domain scaled
                # decode to the smallest size covering resize_dims
                img.draft('RGB', (resize_dims[0], resize_dims[1]))
            images.append(np.asarray(
                resize_and_crop_image(img, resize_dims, crop), dtype=np.uint8))
        self.decode_counts['pil'] += len(filenames)
        return np.stack(images)

    def _use_native_images(self):
        if getattr(self, '_native_images', None) is None:
            self._native_images = image_pipe_available()
        return self._native_images

    def take_decode_counts(self):
        """The images decoded by each decoder ('native', 'pil') since the last
        call, and the images of the calls that the pipe refused
        ('native_refused', which PIL then decoded); resets the counts."""
        counts, self.decode_counts = self.decode_counts, Counter()
        return counts

    def _get_top_lidar_pose(self, rec):
        egopose = self.nusc.get(
            'ego_pose',
            self.nusc.get('sample_data', rec['data']['LIDAR_TOP'])['ego_pose_token'])
        trans = -np.array(egopose['translation'])
        yaw = quat_yaw(egopose['rotation'])
        rot_inv = quat_inverse(yaw_quat(yaw))
        return trans, rot_inv

    def get_label_cached(self, rec, instance_map):
        """Cache wrapper: rasterise once per sample (with LOCAL instance ids + the
        instance tokens), then remap local ids onto the window-consistent map."""
        if not self.label_cache_dir:
            return self.get_birds_eye_view_label(rec, instance_map)

        path = os.path.join(self.label_cache_dir, rec['token'] + '.npz')
        if os.path.exists(path):
            data = np.load(path, allow_pickle=False)
            seg, inst_local = data['segmentation'], data['instance']
            z_pos, attr = data['z_position'], data['attribute']
            tokens = [t for t in data['tokens']]
        else:
            local_map = {}
            seg, inst_local, z_pos, local_map, attr = self.get_birds_eye_view_label(
                rec, local_map)
            tokens = [t for t, _ in sorted(local_map.items(), key=lambda kv: kv[1])]
            np.savez_compressed(path, segmentation=seg, instance=inst_local,
                                z_position=z_pos, attribute=attr,
                                tokens=np.asarray(tokens, dtype=str))

        # remap local ids (1..n in token order) to window-consistent global ids
        lut = np.zeros(len(tokens) + 1, dtype=inst_local.dtype)
        for local_id, token in enumerate(tokens, start=1):
            if token not in instance_map:
                instance_map[token] = len(instance_map) + 1
            lut[local_id] = instance_map[token]
        return seg, lut[inst_local.astype(np.int64)], z_pos, instance_map, attr

    def get_birds_eye_view_label(self, rec, instance_map):
        """Rasterise annotations into (X, Y) segmentation/instance/z/attribute maps.

        """
        import cv2
        translation, rotation_inv = self._get_top_lidar_pose(rec)
        X, Y = int(self.bev_dimension[0]), int(self.bev_dimension[1])
        segmentation = np.zeros((X, Y))
        instance = np.zeros((X, Y))
        z_position = np.zeros((X, Y))
        attribute_label = np.zeros((X, Y))

        for annotation_token in rec['anns']:
            annotation = self.nusc.get('sample_annotation', annotation_token)

            if not self.is_lyft:
                if 'vehicle' not in annotation['category_name']:
                    continue
                if (self.cfg.DATASET.FILTER_INVISIBLE_VEHICLES
                        and int(annotation['visibility_token']) == 1):
                    continue
                instance_attribute = int(annotation['visibility_token'])
            else:
                if annotation['category_name'] not in LYFT_VEHICLE_CATEGORIES:
                    continue
                instance_attribute = 0

            if annotation['instance_token'] not in instance_map:
                instance_map[annotation['instance_token']] = len(instance_map) + 1
            instance_id = instance_map[annotation['instance_token']]

            poly_region, z = self._get_poly_region_in_image(
                annotation, translation, rotation_inv)
            cv2.fillPoly(instance, [poly_region], instance_id)
            cv2.fillPoly(segmentation, [poly_region], 1.0)
            cv2.fillPoly(z_position, [poly_region], z)
            cv2.fillPoly(attribute_label, [poly_region], instance_attribute)

        return segmentation, instance, z_position, instance_map, attribute_label

    def _get_poly_region_in_image(self, annotation, ego_translation, ego_rotation_inv):
        # box translate then rotate into the yaw-only ego frame
        center = np.asarray(annotation['translation'], dtype=np.float64) + ego_translation
        rot = quat_to_rotation_matrix(ego_rotation_inv)
        corners = box_bottom_corners(center, annotation['size'], annotation['rotation'])
        corners = rot @ corners
        pts = corners[:2].T
        pts = np.round(
            (pts - self.bev_start_position[:2] + self.bev_resolution[:2] / 2.0)
            / self.bev_resolution[:2]).astype(np.int32)
        pts[:, [1, 0]] = pts[:, [0, 1]]
        # the z label is the rotated box centre's height, not a bottom corner's
        z = (rot @ center)[2]
        return pts, z

    def get_future_egomotion(self, rec, index):
        """6-DoF pose of ego frame t in frame t+1 (lidar poses)."""
        future_egomotion = np.eye(4, dtype=np.float64)
        if index < len(self.ixes) - 1:
            rec_t1 = self.ixes[index + 1]
            if rec['scene_token'] == rec_t1['scene_token']:
                def lidar_egopose(r):
                    p = self.nusc.get(
                        'ego_pose',
                        self.nusc.get('sample_data', r['data']['LIDAR_TOP'])['ego_pose_token'])
                    return _pose_matrix(p['rotation'], p['translation'])
                egopose_t0 = lidar_egopose(rec)
                egopose_t1 = lidar_egopose(rec_t1)
                future_egomotion = _invert_rigid(egopose_t1) @ egopose_t0
                future_egomotion[3, :3] = 0.0
                future_egomotion[3, 3] = 1.0
        return mat2pose_vec_np(future_egomotion.astype(np.float32))

    # -- sample assembly --------------------------------------------------
    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index):
        images, intrinsics, extrinsics = [], [], []
        segmentations, instances = [], []
        future_egomotions, tokens, z_positions, attributes = [], [], [], []

        instance_map = {}
        for index_t in self.indices[index]:
            rec = self.ixes[index_t]
            img, intr, extr = self.get_input_data(rec)
            seg, inst, z_pos, instance_map, attr = self.get_label_cached(
                rec, instance_map)
            images.append(img)
            intrinsics.append(intr)
            extrinsics.append(extr)
            segmentations.append(seg.astype(np.int32))
            instances.append(inst.astype(np.int32))
            z_positions.append(z_pos.astype(np.float32))
            attributes.append(attr.astype(np.int32))
            future_egomotions.append(
                self.get_future_egomotion(rec, index_t).astype(np.float32))
            tokens.append(rec['token'])

        data = {
            'image': np.stack(images),    # raw uint8 frames
            'intrinsics': np.stack(intrinsics),
            'extrinsics': np.stack(extrinsics),
            'segmentation': np.stack(segmentations)[..., None],
            'instance': np.stack(instances),
            'z_position': np.stack(z_positions)[..., None],
            'attribute': np.stack(attributes)[..., None],
            'future_egomotion': np.stack(future_egomotions),
        }

        if self.cfg.MODEL.SUBSAMPLE:
            # Lyft 5 Hz -> 2.5 Hz: every other frame, the egomotions composed
            ego_mat = pose_vec2mat_np(data['future_egomotion'])
            accum = np.zeros_like(ego_mat)
            accum[:-1] = ego_mat[:-1] @ ego_mat[1:]
            accum_vec = mat2pose_vec_np(accum)
            for key in data:
                if key != 'future_egomotion':
                    data[key] = data[key][::2].copy()
            data['future_egomotion'] = accum_vec[::2].copy()
            tokens = tokens[::2]

        center, offset, flow = convert_instance_mask_to_center_and_offset_label(
            data['instance'], data['future_egomotion'],
            num_instances=len(instance_map),
            ignore_index=self.cfg.DATASET.IGNORE_INDEX,
            subtract_egomotion=True, spatial_extent=self.spatial_extent)
        data['centerness'] = center
        data['offset'] = offset
        data['flow'] = flow
        data['sample_token'] = np.asarray(tokens)
        return data


def build_real_datasets(cfg):
    """The index and the train and val datasets of DATASET.NAME 'nuscenes' (tables
    under ``DATAROOT/VERSION/v1.0-VERSION``) or 'lyft' (the same schema under
    ``DATAROOT/trainval/train_data``). The mini version keeps the first 10 windows
    of each split."""
    version = cfg.DATASET.VERSION
    if cfg.DATASET.NAME == 'nuscenes':
        dataroot = os.path.join(cfg.DATASET.DATAROOT, version)
        nusc = NuScenesIndex(version=f'v1.0-{version}', dataroot=dataroot,
                             verbose=False)
        is_lyft = False
    elif cfg.DATASET.NAME == 'lyft':
        dataroot = os.path.join(cfg.DATASET.DATAROOT, 'trainval')
        nusc = NuScenesIndex(version='lyft', dataroot=dataroot,
                             table_root=os.path.join(dataroot, 'train_data'),
                             verbose=False)
        is_lyft = True
    else:
        raise ValueError(cfg.DATASET.NAME)

    traindata = FuturePredictionDataset(nusc, True, cfg, is_lyft=is_lyft)
    valdata = FuturePredictionDataset(nusc, False, cfg, is_lyft=is_lyft)
    if version == 'mini':
        traindata.indices = traindata.indices[:10]
        valdata.indices = valdata.indices[:10]
    return traindata, valdata
