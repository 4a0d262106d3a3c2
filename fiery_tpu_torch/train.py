"""Train FIERY for a number of steps on the synthetic dataset and print the losses.

    python -m fiery_tpu_torch.train --config fiery_tpu_torch/configs/baseline.yml \
        --steps 5 DATASET.NAME synthetic

Trailing KEY VALUE pairs override the config, the levers included, e.g. the
sparse, warp-free combination with host-warped labels:

    python -m fiery_tpu_torch.train --config fiery_tpu_torch/configs/baseline.yml \
        --steps 5 DATASET.NAME synthetic LIFT.TOPK 8 LIFT.WARP_FREE True \
        DATASET.PREWARP_LABELS True

The weights are seeded random (He normal); batches of BATCHSIZE clips come from the
synthetic dataset in order. Under LIFT.DEPTH_CULL the kept depth planes are
computed from the first batch's calibrations; under DATASET.PREWARP_LABELS each
batch's label stack is warped on the host before its step (outside the step's
time). It runs on the CUDA card unless given --device cpu. Checkpoints,
validation and several cards are not supported yet.
"""

import argparse
import json
import time

import numpy as np
import torch

from fiery_tpu_torch.data.label_warp import make_prewarp_transform
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.ops.lift_splat import compute_depth_plane_keep, create_frustum
from fiery_tpu_torch.serve import init_params
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.geometry import calculate_birds_eye_view_parameters


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', dest='config_file', required=True)
    p.add_argument('--steps', type=int, default=5)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    p.add_argument('opts', nargs=argparse.REMAINDER, help='KEY VALUE config overrides')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_cfg(args)
    if cfg.DATASET.NAME != 'synthetic':
        raise NotImplementedError(f'DATASET.NAME {cfg.DATASET.NAME!r}: only the synthetic '
                                  f'dataset is ported')
    dataset = SyntheticFutureDataset(cfg, n_samples=max(cfg.DATASET.N_SYNTHETIC_SAMPLES,
                                                        cfg.BATCHSIZE), seed=args.seed)

    def batch_at(step):
        start = step * cfg.BATCHSIZE
        return dataset.get_batch([(start + i) % len(dataset) for i in range(cfg.BATCHSIZE)])

    depth_keep = None
    if cfg.LIFT.DEPTH_CULL:
        depth_keep = depth_plane_keep(cfg, batch_at(0))
        print(json.dumps({'depth_keep': [int(k) for k in depth_keep]}), flush=True)
    prewarp = make_prewarp_transform(cfg) if cfg.DATASET.PREWARP_LABELS else None
    trainer = Trainer(cfg, depth_keep=depth_keep, device=args.device)
    init_params(trainer.model, seed=args.seed)
    generator = torch.Generator(device=trainer.device).manual_seed(args.seed)
    for step in range(args.steps):
        batch = batch_at(step)
        if prewarp is not None:
            batch = prewarp(batch)
        t0 = time.perf_counter()
        losses, total = trainer.train_step(batch, generator)
        record = {'step': step, 'total_loss': float(total),
                  **{k: float(v) for k, v in losses.items()},
                  'seconds': round(time.perf_counter() - t0, 3)}
        print(json.dumps(record), flush=True)
    return trainer


def depth_plane_keep(cfg, batch):
    """The per-camera kept depth-plane counts of LIFT.DEPTH_CULL, from the
    calibrations of a batch (numpy)."""
    frustum = create_frustum(cfg.IMAGE.FINAL_DIM, cfg.MODEL.ENCODER.DOWNSAMPLE,
                             cfg.LIFT.D_BOUND)
    res, start, dim = calculate_birds_eye_view_parameters(
        cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
    return compute_depth_plane_keep(
        frustum, np.asarray(batch['intrinsics']), np.asarray(batch['extrinsics']),
        res, start, dim, t_margin=cfg.LIFT.CULL_T_MARGIN,
        rot_margin_deg=cfg.LIFT.CULL_ROT_MARGIN)


if __name__ == '__main__':
    main()
