"""The port's visualisation (fiery_tpu_torch.utils.visualisation, the visualise CLI
and the loop's VIS_INTERVAL videos) against the JAX package's.

Held exactly: the ``jet`` lookup table against ``matplotlib.cm.jet(np.linspace(0,
1, 256))`` and ``jet`` against ``matplotlib.cm.jet`` on floats (f32 and f64, NaN,
below 0, 1.0, above 1) and integers; ``flow_to_image``, ``heatmap_image``,
``plot_instance_map``, ``make_contour`` and ``generate_instance_colours`` against
the JAX functions' uint8 output on the same arrays; ``visualise_output`` on a
planted scene, with and without flow, the port's decode and host tracker against
JAX's; the CLI's figure (``plot_prediction``) against visualise.py's at the
repository root. Then one tiny run of the port's training loop on a fake nuScenes
tree on the CPU (VIS_INTERVAL 1, 3 steps, one epoch), its evaluation and the
visualise CLI on its checkpoint: the videos are written (a GIF a step and one of
the validation, frames of the panels' shape), the losses finite, the PNGs
written.
"""

import json
import os
import sys

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from fiery_tpu.utils import visualisation as jax_vis
from fiery_tpu.utils.config import get_cfg as jax_get_cfg
from fiery_tpu_torch import evaluate, train, visualise
from fiery_tpu_torch.data.fake_nuscenes import make_fake_nuscenes
from fiery_tpu_torch.serve import BASELINE
from fiery_tpu_torch.utils import visualisation as vis
from fiery_tpu_torch.utils.config import get_cfg

matplotlib.use('Agg')


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_jet_equals_matplotlib():
    import matplotlib.cm
    mpl_jet = matplotlib.colormaps['jet']
    assert np.array_equal(vis.JET_LUT[:256], mpl_jet(np.linspace(0, 1, 256)))
    rng = np.random.RandomState(0)
    x = rng.uniform(-0.2, 1.2, 1000)
    x[:4] = [np.nan, 1.0, 0.0, 255.5 / 256]
    for values in (x, x.astype(np.float32), x.reshape(10, 100),
                   rng.randint(-3, 260, 500)):
        assert np.array_equal(vis.jet(values), mpl_jet(values))


def test_primitives_equal_jax():
    rng = np.random.RandomState(1)
    flow = rng.randn(24, 20, 2).astype(np.float32) * 2
    flow[0, 0] = np.nan
    for autoscale in (False, True):
        assert np.array_equal(vis.flow_to_image(flow, autoscale),
                              jax_vis.flow_to_image(flow, autoscale))
    for heat in (rng.rand(24, 20).astype(np.float32), np.full((5, 6), 0.3, np.float32),
                 rng.randn(9, 7)):
        assert np.array_equal(vis.heatmap_image(heat), jax_vis.heatmap_image(heat))
    ids = rng.randint(0, 9, (24, 20))
    instance_map = {i: i for i in range(9)}
    bg = rng.randint(0, 256, (24, 20, 3), dtype=np.uint8)
    for kw in ({}, {'bg_image': bg}):
        assert np.array_equal(vis.plot_instance_map(ids, instance_map, **kw),
                              jax_vis.plot_instance_map(ids, instance_map, **kw))
    for double in (False, True):
        assert np.array_equal(vis.make_contour(bg, (9, 8, 7), double),
                              jax_vis.make_contour(bg, (9, 8, 7), double))
    want = jax_vis.generate_instance_colours({i: 3 * i for i in range(40)})
    got = vis.generate_instance_colours({i: 3 * i for i in range(40)})
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) and got[k].dtype == np.uint8 for k in want)


def planted(seed, s=3, h=32, w=32, n=4):
    """Labels and heads of a scene with n moving blobs: (labels, output) numpy."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    labels = {'instance': np.zeros((1, s, h, w), np.int64),
              'segmentation': np.zeros((1, s, h, w), np.int64),
              'centerness': np.zeros((1, s, h, w, 1), np.float32),
              'offset': np.zeros((1, s, h, w, 2), np.float32),
              'flow': np.zeros((1, s, h, w, 2), np.float32)}
    centers = rng.uniform(6, h - 6, (n, 2))
    velocity = rng.uniform(-1.5, 1.5, (n, 2))
    for t in range(s):
        for i in range(n):
            cy, cx = centers[i] + t * velocity[i]
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < 9
            labels['instance'][0, t][mask] = i + 1
            labels['segmentation'][0, t][mask] = 1
            labels['centerness'][0, t, :, :, 0] = np.maximum(
                labels['centerness'][0, t, :, :, 0],
                np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8))
            labels['offset'][0, t][mask] = np.stack([cy - yy, cx - xx], -1)[mask]
            labels['flow'][0, t][mask] = velocity[i]
    noise = lambda *shape: 0.05 * rng.randn(*shape).astype(np.float32)  # noqa: E731
    seg = labels['segmentation'].astype(np.float32)
    output = {'segmentation': np.stack([1 - seg, seg], -1) + noise(1, s, h, w, 2),
              'instance_center': labels['centerness'] + noise(1, s, h, w, 1),
              'instance_offset': labels['offset'] + noise(1, s, h, w, 2),
              'instance_flow': labels['flow'] + noise(1, s, h, w, 2)}
    return labels, output


@pytest.mark.parametrize('flow', [True, False], ids=['flow', 'no-flow'])
def test_visualise_output_equals_jax(flow):
    labels, output = planted(2)
    d = {'INSTANCE_FLOW': {'ENABLED': flow}}
    want = jax_vis.visualise_output(labels, {k: jnp.asarray(v) for k, v in output.items()},
                                    jax_get_cfg(cfg_dict=d))
    got = vis.visualise_output({k: torch.from_numpy(v) for k, v in labels.items()},
                               {k: torch.from_numpy(v) for k, v in output.items()},
                               get_cfg(cfg_dict=d))
    assert got.dtype == np.uint8 and got.shape == (1, 3, 5 * 32, 2 * 32, 3)
    assert np.array_equal(got, want)
    # the planted instances were found, tracked and drawn in their colours
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 20


def test_plot_prediction_equals_the_jax_cli():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import visualise as jax_cli
    _, output = planted(3)
    rng = np.random.RandomState(4)
    image = rng.randint(0, 256, (1, 3, 6, 16, 24, 3), dtype=np.uint8)
    d = {'IMAGE': {'FINAL_DIM': (16, 24)}}
    want = jax_cli.plot_prediction(image, {k: jnp.asarray(v) for k, v in output.items()},
                                   jax_get_cfg(cfg_dict=d))
    got = visualise.plot_prediction(image, {k: torch.from_numpy(v) for k, v in output.items()},
                                    get_cfg(cfg_dict=d))
    assert got.dtype == np.uint8 and got.ndim == 3
    assert np.array_equal(got, want)


TINY_TREE_OPTS = [
    'PRECISION', '32', 'TIME_RECEPTIVE_FIELD', '2', 'N_FUTURE_FRAMES', '2', 'BATCHSIZE', '2',
    'IMAGE.FINAL_DIM', '(64, 96)', 'IMAGE.ORIGINAL_WIDTH', '320', 'IMAGE.ORIGINAL_HEIGHT',
    '180', 'IMAGE.RESIZE_SCALE', '0.4', 'IMAGE.TOP_CROP', '8',
    'IMAGE.NAMES', "['CAM_FRONT', 'CAM_BACK']", 'LIFT.X_BOUND', '[-8.0, 8.0, 0.5]',
    'LIFT.Y_BOUND', '[-8.0, 8.0, 0.5]', 'LIFT.D_BOUND', '[2.0, 8.0, 1.0]',
    'MODEL.ENCODER.NAME', 'efficientnet-b0', 'MODEL.ENCODER.OUT_CHANNELS', '16',
    'MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS', '16', 'MODEL.DISTRIBUTION.LATENT_DIM', '4',
    'MODEL.FUTURE_PRED.N_GRU_BLOCKS', '1', 'MODEL.FUTURE_PRED.N_RES_LAYERS', '1',
    'LOGGING_INTERVAL', '1', 'VIS_INTERVAL', '1', 'N_WORKERS', '0', 'EPOCHS', '1',
    'DATASET.NAME', 'nuscenes', 'DATASET.VERSION', 'mini']


def test_tiny_loop_on_a_tree_writes_videos_then_evaluates_and_draws(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    tree = make_fake_nuscenes(str(tmp_path / 'tree'), n_samples=6, width=320, height=180)
    run = train.main(['--config', BASELINE, '--device', 'cpu', *TINY_TREE_OPTS,
                      'DATASET.DATAROOT', tree, 'LOG_DIR', str(tmp_path / 'runs')])
    # 2 train scenes of 3 windows of 4 frames: 3 steps of 2
    assert [r['step'] for r in run.steps] == [1, 2, 3]
    assert all(r['video_ms'] > 0 for r in run.steps)
    names = sorted(os.path.basename(v['path']) for v in run.videos)
    assert names == ['train_outputs_step1.gif', 'train_outputs_step2.gif',
                     'train_outputs_step3.gif', 'val_outputs_step3.gif']
    for video in run.videos:
        # the 3 frames from the present on, 5 rows of 32 x 32 maps, GT | prediction
        assert video['shape'] == (1, 3, 5 * 32, 2 * 32, 3)
        with Image.open(video['path']) as gif:
            assert gif.size == (2 * 32, 5 * 32) and 1 <= gif.n_frames <= 3
    with open(os.path.join(run.save_dir, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    losses = [r['total_loss'] for r in records if 'total_loss' in r]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    # the train loader's look and 3 batches of 2 samples of 4 frames of 2 cameras
    assert dict(run.loaders[0].decode_counts) == {'native': 4 * 2 * 4 * 2}

    final = os.path.join(run.save_dir, 'checkpoint_final')
    results = evaluate.main(['--checkpoint', final, '--device', 'cpu', '--max-batches', '2'])
    assert results and all(np.isfinite(v) for v in results.values())
    paths = visualise.main(['--checkpoint', final, '--device', 'cpu',
                            '--output-dir', str(tmp_path / 'vis')])
    assert len(paths) == 4
    for path in paths:
        assert np.asarray(Image.open(path)).shape[-1] in (3, 4)
