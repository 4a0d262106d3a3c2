"""Write an on-disk, v1.0-mini-shaped synthetic nuScenes (or Lyft) tree: the 12 JSON
tables and one JPEG a (sample, camera) (the port's copy of
tools/make_fake_nuscenes.py, which writes the same tables and JPEG bytes for the
same arguments).

    python -m fiery_tpu_torch.data.fake_nuscenes DEST [--lyft] [--width 1600]
        [--height 900] [--train-scenes 2] [--val-scenes 1] [--samples 12] [--seed 0]

It drives the real-data path end to end without the dataset: NuScenesIndex's
tables and derived fields, the mini splits, sliding windows, JPEG decode ->
resize -> crop, the intrinsics folded, the quaternion extrinsics, cv2
rasterisation, egomotion and the labels.

Layout (what ``data/nuscenes_dataset.build_real_datasets`` reads):
    <dest>/mini/v1.0-mini/*.json      # 12 tables
    <dest>/mini/samples/CAM_*/*.jpg   # one JPEG a (sample, camera)
used as ``DATASET.DATAROOT <dest>  DATASET.VERSION mini``; with ``--lyft``
    <dest>/trainval/train_data/*.json
    <dest>/trainval/samples/CAM_*/*.jpg
used as ``DATASET.NAME lyft  DATASET.DATAROOT <dest>``.

The geometry is nuScenes-like: 6 cameras at about their real yaws, fx = 1266 at
1600 wide, the ego on a gentle arc at ~7 m/s (2 Hz keyframes), vehicles at
constant velocity in the world frame, and a pedestrian and a car of visibility 1
a scene, which the label filters drop.
"""

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fiery_tpu_torch.data.nuscenes_indexer import MINI_TRAIN, MINI_VAL
from fiery_tpu_torch.utils.quaternion import quat_multiply, yaw_quat

# approximate real nuScenes camera yaws (deg, ego frame: x forward, y left)
CAMERA_YAW_DEG = {
    'CAM_FRONT': 0.0,
    'CAM_FRONT_LEFT': 55.0,
    'CAM_FRONT_RIGHT': -55.0,
    'CAM_BACK': 180.0,
    'CAM_BACK_LEFT': 110.0,
    'CAM_BACK_RIGHT': -110.0,
}
# ego-to-optical axes: camera z = ego x (forward), x = -ego y, y = -ego z;
# as a (w, x, y, z) quaternion this is the fixture's [0.5, -0.5, 0.5, -0.5]
OPTICAL_QUAT = np.array([0.5, -0.5, 0.5, -0.5])


def camera_rotation_quat(yaw_deg):
    return quat_multiply(yaw_quat(np.deg2rad(yaw_deg)), OPTICAL_QUAT)


def _render_image(noise, width, height, scene_i, t, cam_i):
    """Cheap structured image, distinct per (scene, frame, camera): sky/ground
    gradient + a few parallax 'building' rectangles that shift with time, plus
    ``noise``, the image's draw of ``rng.normal(0, 2, (height, width, 3))``. The
    JAX tool's arithmetic on the same elements (its masks are rectangles, taken
    here by their rows and columns)."""
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    img = np.empty((height, width, 3), np.float32)
    img[..., 0] = 90 + 120 * y + 10 * cam_i
    img[..., 1] = 120 + 80 * y + 8 * scene_i
    img[..., 2] = 200 - 140 * y
    for k in range(4):
        w = 0.08 + 0.05 * ((k + cam_i) % 3)
        cx = ((0.22 * k + 0.13 * cam_i + 0.07 * t + 0.3 * scene_i) % 1.0)
        rows = np.flatnonzero((y[:, 0] > 0.35) & (y[:, 0] < 0.62 + 0.04 * k))
        cols = np.flatnonzero(np.abs(x[0] - cx) < w)
        img[np.ix_(rows, cols)] *= 0.45 + 0.1 * k
    img += noise.astype(np.float32)
    return np.clip(img, 0, 255, out=img).astype(np.uint8)


def _write_image(path, quality, noise, *args):
    from PIL import Image
    Image.fromarray(_render_image(noise, *args)).save(path, quality=quality)


def make_fake_nuscenes(dest, n_train_scenes=2, n_val_scenes=1, n_samples=12,
                       width=1600, height=900, seed=0, cameras=None,
                       image_quality=85, lyft=False):
    """Write the tree; returns the dataroot to pass as DATASET.DATAROOT.

    With ``lyft=True`` the same table schema is written Lyft-Level-5-shaped:
    tables under ``<dest>/trainval/train_data/``,
    plain category names ('car'/'truck'/'pedestrian'), and scene splitting by
    index (data/lyft_splits.py) instead of by name — scenes are interleaved
    train/val by the real split constants, so write >=2 scenes. Use as
    ``DATASET.NAME lyft  DATASET.DATAROOT <dest>``."""
    cameras = list(cameras or CAMERA_YAW_DEG)
    root = os.path.join(dest, 'trainval' if lyft else 'mini')
    table_dir = os.path.join(root, 'train_data' if lyft else 'v1.0-mini')
    os.makedirs(table_dir, exist_ok=True)
    rng = np.random.RandomState(seed)

    tables = {name: [] for name in
              ['category', 'attribute', 'visibility', 'instance', 'sensor',
               'calibrated_sensor', 'ego_pose', 'log', 'scene', 'sample',
               'sample_data', 'sample_annotation']}
    tables['category'] = [
        {'token': 'cat_car',
         'name': 'car' if lyft else 'vehicle.car', 'description': ''},
        {'token': 'cat_truck',
         'name': 'truck' if lyft else 'vehicle.truck', 'description': ''},
        {'token': 'cat_ped',
         'name': 'pedestrian' if lyft else 'human.pedestrian.adult',
         'description': ''},
    ]
    tables['visibility'] = [
        {'token': str(v), 'level': f'v{v}', 'description': ''} for v in range(1, 5)]
    tables['sensor'] = [{'token': 'sen_lidar', 'channel': 'LIDAR_TOP',
                         'modality': 'lidar'}]
    tables['calibrated_sensor'] = [{
        'token': 'cal_lidar', 'sensor_token': 'sen_lidar',
        'rotation': [1.0, 0.0, 0.0, 0.0], 'translation': [0.94, 0.0, 1.84],
        'camera_intrinsic': []}]
    fx = 1266.0 * width / 1600.0
    for cam in cameras:
        tables['sensor'].append({'token': f'sen_{cam}', 'channel': cam,
                                 'modality': 'camera'})
        yaw = CAMERA_YAW_DEG[cam]
        trans = [1.5 * np.cos(np.deg2rad(yaw)), 1.5 * np.sin(np.deg2rad(yaw)), 1.5]
        tables['calibrated_sensor'].append({
            'token': f'cal_{cam}', 'sensor_token': f'sen_{cam}',
            'rotation': [float(v) for v in camera_rotation_quat(yaw)],
            'translation': [float(v) for v in trans],
            'camera_intrinsic': [[fx, 0.0, width / 2.0],
                                 [0.0, fx, height / 2.0],
                                 [0.0, 0.0, 1.0]]})

    if lyft:
        # lyft splits are by scene INDEX (VAL starts 0, 2, 4...; TRAIN 1, 3...)
        scene_names = [f'host-a-lidar0-{i}' for i in
                       range(n_train_scenes + n_val_scenes)]
    else:
        scene_names = MINI_TRAIN[:n_train_scenes] + MINI_VAL[:n_val_scenes]
    pending = []
    with ThreadPoolExecutor(max_workers=2) as writer:
        for scene_i, scene_name in enumerate(scene_names):
            scene_token = f'scene{scene_i}'
            tables['log'].append({'token': f'log{scene_i}', 'location': 'fake',
                                  'vehicle': 'fake', 'date_captured': ''})
            tables['scene'].append({
                'token': scene_token, 'name': scene_name, 'log_token': f'log{scene_i}',
                'nbr_samples': n_samples, 'description': 'synthetic',
                'first_sample_token': f's{scene_i}_0',
                'last_sample_token': f's{scene_i}_{n_samples - 1}'})

            # ego drives a gentle arc: ~3.5 m per 0.5 s keyframe
            ego_yaw = 0.3 * scene_i + 0.03 * np.arange(n_samples)
            ego_xy = np.zeros((n_samples, 2))
            for t in range(1, n_samples):
                ego_xy[t] = ego_xy[t - 1] + 3.5 * np.array(
                    [np.cos(ego_yaw[t - 1]), np.sin(ego_yaw[t - 1])])

            # vehicles: world-frame constant velocity around the ego path
            n_cars = 5
            car_xy0 = ego_xy[0] + rng.uniform(-25, 25, (n_cars, 2))
            car_vel = rng.uniform(-2.5, 2.5, (n_cars, 2))
            car_yaw = rng.uniform(-np.pi, np.pi, n_cars)
            for c in range(n_cars):
                cat = 'cat_truck' if c % 3 == 2 else 'cat_car'
                tables['instance'].append({
                    'token': f'veh_{scene_i}_{c}', 'category_token': cat,
                    'nbr_annotations': n_samples,
                    'first_annotation_token': f'ann_{scene_i}_{c}_0',
                    'last_annotation_token': f'ann_{scene_i}_{c}_{n_samples - 1}'})
            tables['instance'].append({
                'token': f'ped_{scene_i}', 'category_token': 'cat_ped',
                'nbr_annotations': n_samples,
                'first_annotation_token': f'annp_{scene_i}_0',
                'last_annotation_token': f'annp_{scene_i}_{n_samples - 1}'})
            tables['instance'].append({
                'token': f'ghost_{scene_i}', 'category_token': 'cat_car',
                'nbr_annotations': n_samples,
                'first_annotation_token': f'anng_{scene_i}_0',
                'last_annotation_token': f'anng_{scene_i}_{n_samples - 1}'})

            for t in range(n_samples):
                token = f's{scene_i}_{t}'
                stamp = 1_000_000_000 + 500_000 * t
                tables['sample'].append({
                    'token': token, 'scene_token': scene_token, 'timestamp': stamp,
                    'prev': f's{scene_i}_{t - 1}' if t else '',
                    'next': f's{scene_i}_{t + 1}' if t < n_samples - 1 else ''})
                ego_token = f'ego_{scene_i}_{t}'
                tables['ego_pose'].append({
                    'token': ego_token,
                    'rotation': [float(v) for v in yaw_quat(ego_yaw[t])],
                    'translation': [float(ego_xy[t, 0]), float(ego_xy[t, 1]), 0.0],
                    'timestamp': stamp})
                tables['sample_data'].append({
                    'token': f'sd_LIDAR_TOP_{scene_i}_{t}', 'sample_token': token,
                    'ego_pose_token': ego_token, 'calibrated_sensor_token': 'cal_lidar',
                    'filename': f'samples/LIDAR_TOP/{token}.bin', 'fileformat': 'bin',
                    'is_key_frame': True, 'height': 0, 'width': 0,
                    'timestamp': stamp, 'prev': '', 'next': ''})
                for cam_i, cam in enumerate(cameras):
                    rel = f'samples/{cam}/{token}.jpg'
                    os.makedirs(os.path.join(root, 'samples', cam), exist_ok=True)
                    # the draws stay in the JAX tool's order on this thread; the
                    # image is composed and encoded on another, a few in flight
                    noise = rng.normal(0.0, 2.0, (height, width, 3))
                    while len(pending) >= 4:
                        pending.pop(0).result()
                    pending.append(writer.submit(
                        _write_image, os.path.join(root, rel), image_quality, noise, width,
                        height, scene_i, t, cam_i))
                    tables['sample_data'].append({
                        'token': f'sd_{cam}_{scene_i}_{t}', 'sample_token': token,
                        'ego_pose_token': ego_token,
                        'calibrated_sensor_token': f'cal_{cam}',
                        'filename': rel, 'fileformat': 'jpg', 'is_key_frame': True,
                        'height': height, 'width': width, 'timestamp': stamp,
                        'prev': '', 'next': ''})
                for c in range(n_cars):
                    pos = car_xy0[c] + t * car_vel[c]
                    tables['sample_annotation'].append({
                        'token': f'ann_{scene_i}_{c}_{t}', 'sample_token': token,
                        'instance_token': f'veh_{scene_i}_{c}',
                        'visibility_token': '4',
                        'translation': [float(pos[0]), float(pos[1]), 0.75],
                        'size': [1.9, 4.5, 1.6],
                        'rotation': [float(v) for v in yaw_quat(car_yaw[c])],
                        'attribute_tokens': [], 'num_lidar_pts': 30,
                        'num_radar_pts': 5,
                        'prev': f'ann_{scene_i}_{c}_{t - 1}' if t else '',
                        'next': (f'ann_{scene_i}_{c}_{t + 1}'
                                 if t < n_samples - 1 else '')})
                # pedestrian (category-filtered) + invisible car (visibility-filtered)
                tables['sample_annotation'].append({
                    'token': f'annp_{scene_i}_{t}', 'sample_token': token,
                    'instance_token': f'ped_{scene_i}', 'visibility_token': '4',
                    'translation': [float(ego_xy[t, 0] + 6.0),
                                    float(ego_xy[t, 1] + 3.0), 0.9],
                    'size': [0.6, 0.6, 1.8], 'rotation': [1.0, 0.0, 0.0, 0.0],
                    'attribute_tokens': [], 'num_lidar_pts': 8, 'num_radar_pts': 0,
                    'prev': '', 'next': ''})
                tables['sample_annotation'].append({
                    'token': f'anng_{scene_i}_{t}', 'sample_token': token,
                    'instance_token': f'ghost_{scene_i}', 'visibility_token': '1',
                    'translation': [float(ego_xy[t, 0] - 9.0),
                                    float(ego_xy[t, 1] - 4.0), 0.75],
                    'size': [1.9, 4.5, 1.6], 'rotation': [1.0, 0.0, 0.0, 0.0],
                    'attribute_tokens': [], 'num_lidar_pts': 2, 'num_radar_pts': 0,
                    'prev': '', 'next': ''})
        for future in pending:
            future.result()

    for name, records in tables.items():
        with open(os.path.join(table_dir, name + '.json'), 'w') as f:
            json.dump(records, f)
    return dest


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('dest', help='output dir; tree lands in <dest>/mini/')
    parser.add_argument('--train-scenes', type=int, default=2)
    parser.add_argument('--val-scenes', type=int, default=1)
    parser.add_argument('--samples', type=int, default=12,
                        help='keyframes per scene (T=3 past + 4 future needs >=7)')
    parser.add_argument('--width', type=int, default=1600)
    parser.add_argument('--height', type=int, default=900)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--lyft', action='store_true',
                        help='write a Lyft-Level-5-shaped tree instead '
                             '(trainval/train_data tables, plain categories)')
    args = parser.parse_args()
    make_fake_nuscenes(args.dest, args.train_scenes, args.val_scenes,
                       args.samples, args.width, args.height, args.seed,
                       lyft=args.lyft)
    n_imgs = args.samples * (args.train_scenes + args.val_scenes) * 6
    kind = 'Lyft' if args.lyft else 'nuScenes'
    sub = 'trainval' if args.lyft else 'mini'
    print(f'fake {kind} tree at {args.dest}/{sub} '
          f'({args.train_scenes}+{args.val_scenes} scenes, '
          f'{args.samples} samples each, {n_imgs} JPEGs '
          f'{args.width}x{args.height}).\nUse: DATASET.DATAROOT {args.dest} ' +
          ('DATASET.NAME lyft' if args.lyft else 'DATASET.VERSION mini'))


if __name__ == '__main__':
    main()
