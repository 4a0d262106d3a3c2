"""``python -m fiery_tpu_torch.train --profile-dir DIR`` on the CPU at a tiny size.

The run traces ``trace_probe.TRAIN_SCHEDULE``'s window (the first step skipped, one
of warm-up, three recorded) into ``DIR/rank0.pt.trace.json``: the file parses as
JSON, holds the profiler's markers of the three recorded steps and no other step's,
and the recorded steps' convolutions and Adam updates; the run prints the trace's
path. The logged losses equal, bit for bit, those of the same run without the flag.
"""

import json
import os
import sys

import numpy as np
import torch

from fiery_tpu_torch import train
from fiery_tpu_torch.serve import BASELINE
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

# a tiny model on the synthetic set: 6 samples of 1 make 6 steps in one epoch; the
# run stops after step 5, so that the window (steps 3-5) closes with the schedule
TINY_OPTS = ['DATASET.NAME', 'synthetic', 'PRECISION', '32', 'N_FUTURE_FRAMES', '2',
             'TIME_RECEPTIVE_FIELD', '2', 'BATCHSIZE', '1', 'IMAGE.FINAL_DIM', '(32, 48)',
             'IMAGE.NAMES', "['CAM_A', 'CAM_B']", 'LIFT.X_BOUND', '[-8.0, 8.0, 1.0]',
             'LIFT.Y_BOUND', '[-8.0, 8.0, 1.0]', 'LIFT.D_BOUND', '[2.0, 6.0, 1.0]',
             'MODEL.ENCODER.NAME', 'efficientnet-b0', 'MODEL.ENCODER.OUT_CHANNELS', '8',
             'MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS', '8',
             'MODEL.DISTRIBUTION.LATENT_DIM', '4', 'MODEL.FUTURE_PRED.N_GRU_BLOCKS', '1',
             'MODEL.FUTURE_PRED.N_RES_LAYERS', '1', 'DATASET.N_SYNTHETIC_SAMPLES', '6',
             'LOGGING_INTERVAL', '1', 'EPOCHS', '1']


def _losses(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"epoch"')]


def test_profile_dir_traces_the_window_and_changes_no_step(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    argv = ['--config', BASELINE, '--device', 'cpu', '--steps', '5', *TINY_OPTS]
    plain = train.main(argv + ['LOG_DIR', str(tmp_path / 'plain')])
    want = _losses(capsys)
    profiled = train.main(['--profile-dir', str(tmp_path / 'trace'), *argv, 'LOG_DIR',
                           str(tmp_path / 'profiled')])
    out = capsys.readouterr().out
    got = [json.loads(line) for line in out.splitlines() if line.startswith('{"epoch"')]
    assert plain.profile is None and len(want) == 5
    assert got == want, 'the profiled run logged other losses'
    for k, v in plain.trainer.model.state_dict().items():
        assert torch.equal(profiled.trainer.model.state_dict()[k], v), k

    path = str(tmp_path / 'trace' / 'rank0.pt.trace.json')
    assert profiled.profile == {'profile_trace': path, 'rank': 0, 'steps': [3, 4, 5],
                                'k10_launches': {'trace': 0, 'counted': 0, 'whole': True}}
    assert json.dumps(profiled.profile) in out
    assert os.listdir(tmp_path / 'trace') == ['rank0.pt.trace.json']
    with open(path) as f:
        events = json.load(f)['traceEvents']
    names = [e.get('name', '') for e in events]
    # the profiler numbers its steps from 0 at the run's first: steps 3-5 are 2-4
    assert sorted({n for n in names if n.startswith('ProfilerStep#')}) == [
        'ProfilerStep#2', 'ProfilerStep#3', 'ProfilerStep#4']
    assert names.count('aten::convolution') >= 3 * 10
    assert sum(n.startswith('Optimizer.step#Adam.step') for n in names) == 3
    assert np.all(np.isfinite([r['total_loss'] for r in got]))
