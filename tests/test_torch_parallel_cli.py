"""``python -m torch.distributed.run --nproc_per_node 2 -m fiery_tpu_torch.train
--device cpu``: two gloo ranks train the tiny synthetic config for 2 steps (1
sample a rank); the run exits 0 and leaves one run directory with one checkpoint,
``checkpoint_final`` at step 2, and one line a step and key in metrics.jsonl, all
written by rank 0."""

import glob
import json
import os
import socket
import subprocess
import sys

from fiery_tpu_torch.serve import BASELINE
from fiery_tpu_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/torch_parallel_worker.py's TINY_DP, a sample a rank, 4 samples: 2 steps an epoch
TINY_DP_OPTS = ['DATASET.NAME', 'synthetic', 'PRECISION', '32', 'TIME_RECEPTIVE_FIELD', '2',
                'N_FUTURE_FRAMES', '1', 'BATCHSIZE', '1', 'IMAGE.FINAL_DIM', '(16, 32)',
                'IMAGE.NAMES', "['CAM_A']", 'LIFT.X_BOUND', '[-4.0, 4.0, 0.5]',
                'LIFT.Y_BOUND', '[-4.0, 4.0, 0.5]', 'LIFT.D_BOUND', '[2.0, 4.0, 1.0]',
                'MODEL.ENCODER.NAME', 'efficientnet-b0', 'MODEL.ENCODER.OUT_CHANNELS', '8',
                'MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS', '8',
                'MODEL.TEMPORAL_MODEL.PYRAMID_POOLING', 'False',
                'MODEL.DISTRIBUTION.LATENT_DIM', '2', 'MODEL.FUTURE_PRED.N_GRU_BLOCKS', '1',
                'MODEL.FUTURE_PRED.N_RES_LAYERS', '1', 'DATASET.N_SYNTHETIC_SAMPLES', '4',
                'LOGGING_INTERVAL', '1', 'EPOCHS', '1']


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_torchrun_two_ranks_train_and_rank_0_saves(tmp_path):
    env = {**os.environ, 'GLOO_SOCKET_IFNAME': 'lo', 'OMP_NUM_THREADS': '2',
           'PYTHONPATH': REPO}
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node', '2',
           '--master_addr', '127.0.0.1', '--master_port', str(_free_port()),
           '-m', 'fiery_tpu_torch.train', '--config', BASELINE, '--device', 'cpu',
           '--steps', '2', *TINY_DP_OPTS, 'LOG_DIR', str(tmp_path)]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert 'x 2 rank(s)' in out.stdout and out.stdout.count('Training complete') == 1
    runs = glob.glob(str(tmp_path / '*'))
    assert len(runs) == 1, runs
    checkpoints = sorted(os.path.basename(p) for p in glob.glob(os.path.join(runs[0],
                                                                             'checkpoint*')))
    assert checkpoints == ['checkpoint_final']
    state, cfg = load_checkpoint(os.path.join(runs[0], 'checkpoint_final'))
    assert state['step'] == 2 and cfg.BATCHSIZE == 1
    with open(os.path.join(runs[0], 'metrics.jsonl')) as f:
        lines = [json.loads(line) for line in f]
    keys = [(d['step'], k) for d in lines for k in d if k != 'step']
    assert len(keys) == len(set(keys)) and {s for s, _ in keys} == {1, 2}
