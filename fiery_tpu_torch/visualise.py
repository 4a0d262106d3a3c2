"""Visualisation entry point: render a checkpoint's future-instance predictions to
PNG (counterpart of visualise.py at the repository root).

    python -m fiery_tpu_torch.visualise --checkpoint RUN/checkpoint_final \
        [--data DIR] [--output-dir output_vis] [--device cpu]

``--data`` is a directory of example ``.npz`` clips (keys image, intrinsics,
extrinsics, future_egomotion; batch 1); without one, four clips of the synthetic
dataset (seed 7) stand in, as in the JAX package. Each clip becomes
``<output-dir>/<i>.png``: the six cameras of the present frame in a 2 x 3 grid
(the back row mirrored) beside the bird's-eye view of the present frame's
instances and their tracked centres' trajectories. The instances are decoded on
the model's device and tracked on the host. Only this module imports matplotlib,
and only when it draws. It runs on the CUDA card unless given --device cpu.
"""

import argparse
import glob
import os

import numpy as np

from fiery_tpu_torch.postprocess.instance import predict_instance_segmentation_and_trajectories
from fiery_tpu_torch.serve import predict
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.checkpoint import load_checkpoint
from fiery_tpu_torch.utils.visualisation import (convert_figure_numpy,
                                                 generate_instance_colours, make_contour,
                                                 plot_instance_map)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
IMAGENET_STD = np.array([0.229, 0.224, 0.225])
INPUT_KEYS = ('image', 'intrinsics', 'extrinsics', 'future_egomotion')


def plot_prediction(image, output, cfg):
    """The 6-camera grid and the bird's-eye-view instance map with the matched
    centres' trajectories, as an (h, w, 3) uint8 image.

    image: (1, T, N, H, W, 3), raw uint8 or ImageNet-normalised f32; output: the
    model's output dict for that clip."""
    import cv2
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    consistent_instance_seg, matched_centers = \
        predict_instance_segmentation_and_trajectories(output, compute_matched_centers=True)

    # bird's-eye panel: the present frame's instances and their trajectories
    unique_ids = np.unique(consistent_instance_seg[0, 0])[1:]
    instance_map = dict(zip(unique_ids, unique_ids))
    instance_colours = generate_instance_colours(instance_map)
    vis_image = plot_instance_map(consistent_instance_seg[0, 0], instance_map)

    trajectory_img = np.zeros(vis_image.shape, dtype=np.uint8)
    for instance_id in unique_ids:
        path = matched_centers[instance_id]
        for t in range(len(path) - 1):
            color = instance_colours[instance_id].tolist()
            cv2.line(trajectory_img, tuple(map(int, path[t])),
                     tuple(map(int, path[t + 1])), color, 4)

    temp_img = cv2.addWeighted(vis_image, 0.7, trajectory_img, 0.3, 1.0) \
        if trajectory_img.any() else vis_image
    mask = ~np.all(trajectory_img == 0, axis=2)
    vis_image[mask] = temp_img[mask]

    # a 2 x 4 grid: cameras 0-2 on the top row, 3-5 mirrored on the bottom row,
    # the bird's-eye panel spanning the right column; the cameras' names
    val_w = 2.99
    cameras = list(getattr(cfg.IMAGE, 'NAMES', []))
    image_ratio = cfg.IMAGE.FINAL_DIM[0] / cfg.IMAGE.FINAL_DIM[1]
    val_h = val_w * image_ratio
    fig = plt.figure(figsize=(4 * val_w, 2 * val_h))
    gs = matplotlib.gridspec.GridSpec(2, 4, width_ratios=(val_w,) * 4)
    gs.update(wspace=0.0, hspace=0.0, left=0.0, right=1.0, top=1.0, bottom=0.0)

    n_cams = image.shape[2]
    present = min(cfg.TIME_RECEPTIVE_FIELD, image.shape[1]) - 1
    for i in range(min(6, n_cams)):
        ax = fig.add_subplot(gs[i // 3, i % 3])
        img = np.asarray(image[0, present, i])
        if img.dtype == np.uint8:      # the loaders' raw frames
            img = img.astype(np.float64) / 255.0
        else:                          # normalised f32 (e.g. offline npz clips)
            img = np.clip(img * IMAGENET_STD + IMAGENET_MEAN, 0, 1)
        if i >= 3:
            img = img[:, ::-1]
        if i < len(cameras):
            ax.annotate(cameras[i].replace('_', ' ').replace('CAM ', ''),
                        (0.01, 0.87), c='white', xycoords='axes fraction',
                        fontsize=14)
        ax.imshow(img)
        ax.axis('off')
    ax = fig.add_subplot(gs[:, 3])
    ax.imshow(make_contour(vis_image[::-1, ::-1]))
    ax.axis('off')
    out = convert_figure_numpy(fig)
    plt.close(fig)
    return out


def example_clips(cfg, data_path):
    """The clips to draw: the ``.npz`` files under data_path, else four synthetic
    ones."""
    files = sorted(glob.glob(os.path.join(data_path, '*.npz'))) if data_path else []
    if files:
        clips = []
        for f in files:
            with np.load(f) as d:
                clips.append({k: d[k] for k in INPUT_KEYS})
        return clips
    print('No example npz found; using synthetic clips.')
    from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
    ds = SyntheticFutureDataset(cfg, n_samples=4, seed=7)
    return [{k: v for k, v in ds.get_batch([i]).items() if k in INPUT_KEYS}
            for i in range(4)]


def visualise(checkpoint_path, data_path='', output_dir='output_vis', device=None):
    """Draw each clip's prediction with the checkpoint's weights; returns the PNGs'
    paths."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    state, cfg = load_checkpoint(checkpoint_path)
    trainer = Trainer(cfg, device=device)
    trainer.load_state({**state, 'optimizer': None}, strict=True)
    model = trainer.model.eval()
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i, clip in enumerate(example_clips(cfg, data_path)):
        figure_numpy = plot_prediction(clip['image'], predict(model, clip), cfg)
        path = os.path.join(output_dir, f'{i}.png')
        plt.imsave(path, figure_numpy)
        print(f'Saved output in {path}')
        paths.append(path)
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--checkpoint', required=True, type=str)
    parser.add_argument('--data', default='', type=str,
                        help='directory of example .npz clips')
    parser.add_argument('--output-dir', default='output_vis', type=str)
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = parser.parse_args(argv)
    return visualise(args.checkpoint, args.data, args.output_dir, args.device)


if __name__ == '__main__':
    main()
