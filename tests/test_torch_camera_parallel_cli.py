"""``python -m torch.distributed.run --nproc_per_node 4 -m fiery_tpu_torch.train
--device cpu --camera-parallel 2``: four gloo ranks, two data shards of two camera
ranks, train the tiny synthetic config with 2 cameras for 2 steps (a sample a data
shard); the run exits 0 and leaves one run directory with one checkpoint,
``checkpoint_final`` at step 2, and one line a step and key in metrics.jsonl, all
written by rank 0. A camera count that divides the ranks but not the cameras
refuses to start."""

import glob
import json
import os
import subprocess
import sys

from fiery_tpu_torch.serve import BASELINE
from fiery_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_parallel_cli import REPO, TINY_DP_OPTS, _free_port
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

TWO_CAMERAS = ['IMAGE.NAMES', "['CAM_A', 'CAM_B']"]


def torchrun(n_ranks, cameras, log_dir, names=TWO_CAMERAS, extra=()):
    env = {**os.environ, 'GLOO_SOCKET_IFNAME': 'lo', 'OMP_NUM_THREADS': '2',
           'PYTHONPATH': REPO}
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node', str(n_ranks),
           '--master_addr', '127.0.0.1', '--master_port', str(_free_port()),
           '-m', 'fiery_tpu_torch.train', '--config', BASELINE, '--device', 'cpu',
           '--camera-parallel', str(cameras), *extra, '--steps', '2', *TINY_DP_OPTS, *names,
           'LOG_DIR', str(log_dir)]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def test_torchrun_four_ranks_two_cameras_each_train_and_rank_0_saves(tmp_path):
    out = torchrun(4, 2, tmp_path)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert 'x 2 data shard(s) of 2 camera ranks' in out.stdout
    assert out.stdout.count('Training complete') == 1
    runs = glob.glob(str(tmp_path / '*'))
    assert len(runs) == 1, runs
    checkpoints = sorted(os.path.basename(p) for p in glob.glob(os.path.join(runs[0],
                                                                             'checkpoint*')))
    assert checkpoints == ['checkpoint_final']
    state, cfg = load_checkpoint(os.path.join(runs[0], 'checkpoint_final'))
    assert state['step'] == 2 and cfg.BATCHSIZE == 1 and len(cfg.IMAGE.NAMES) == 2
    with open(os.path.join(runs[0], 'metrics.jsonl')) as f:
        lines = [json.loads(line) for line in f]
    keys = [(d['step'], k) for d in lines for k in d if k != 'step']
    assert len(keys) == len(set(keys)) and {s for s, _ in keys} == {1, 2}


def test_torchrun_refuses_a_camera_count_that_does_not_divide_the_cameras(tmp_path):
    """Two ranks, --camera-parallel 2, one camera: every rank raises before a step."""
    out = torchrun(2, 2, tmp_path, names=())
    assert out.returncode != 0
    assert 'must divide the 1 cameras' in out.stdout + out.stderr
    assert 'Training complete' not in out.stdout
    assert not glob.glob(str(tmp_path / '*' / 'checkpoint*'))
