"""``python -m torch.distributed.run --nproc_per_node 4 -m fiery_tpu_torch.train
--device cpu --camera-parallel 2 --bev-parallel``: four gloo ranks, two data shards
of two camera ranks, each rank of a camera group training its 8 of the 16 BEV rows
of the tiny synthetic config with 2 cameras, for 2 steps (a sample a data shard);
the run exits 0 and leaves one run directory with one checkpoint,
``checkpoint_final`` at step 2, and finite losses, all written by rank 0.
``--bev-parallel`` without a camera group exits before a step, as the JAX CLI
does."""

import glob
import json
import math
import os

import pytest

from fiery_tpu_torch import train
from fiery_tpu_torch.serve import BASELINE
from fiery_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_camera_parallel_cli import torchrun
from test_torch_parallel_cli import TINY_DP_OPTS
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


def test_torchrun_four_ranks_split_the_bev_rows_and_rank_0_saves(tmp_path):
    out = torchrun(4, 2, tmp_path, extra=['--bev-parallel'])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert ('x 2 data shard(s) of 2 camera ranks, each training its share of the BEV rows'
            in out.stdout)
    assert out.stdout.count('Training complete') == 1
    runs = glob.glob(str(tmp_path / '*'))
    assert len(runs) == 1, runs
    checkpoints = sorted(os.path.basename(p) for p in glob.glob(os.path.join(runs[0],
                                                                             'checkpoint*')))
    assert checkpoints == ['checkpoint_final']
    state, cfg = load_checkpoint(os.path.join(runs[0], 'checkpoint_final'))
    assert state['step'] == 2 and len(cfg.IMAGE.NAMES) == 2
    with open(os.path.join(runs[0], 'metrics.jsonl')) as f:
        lines = [json.loads(line) for line in f]
    losses = [v for d in lines for k, v in d.items() if k == 'total_loss']
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)


@pytest.mark.parametrize('cameras', [[], ['--camera-parallel', '1']])
def test_bev_parallel_without_a_camera_group_exits(tmp_path, cameras):
    with pytest.raises(SystemExit, match='--bev-parallel requires --camera-parallel > 1'):
        train.main(['--config', BASELINE, '--device', 'cpu', '--bev-parallel', *cameras,
                    '--steps', '1', *TINY_DP_OPTS, 'LOG_DIR', str(tmp_path)])
    assert not glob.glob(str(tmp_path / '*'))
