"""Train FIERY for a number of steps on the synthetic dataset and print the losses.

    python -m fiery_tpu_torch.train --config fiery_tpu_torch/configs/baseline.yml \
        --steps 5 DATASET.NAME synthetic

Trailing KEY VALUE pairs override the config. The weights are seeded random (He
normal); batches of BATCHSIZE clips come from the synthetic dataset in order. It
runs on the CUDA card unless given --device cpu. Checkpoints, validation and
several cards are not supported yet.
"""

import argparse
import json
import time

import torch

from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.serve import init_params
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.config import get_cfg


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
    trainer = Trainer(cfg, device=args.device)
    init_params(trainer.model, seed=args.seed)
    dataset = SyntheticFutureDataset(cfg, n_samples=max(cfg.DATASET.N_SYNTHETIC_SAMPLES,
                                                        cfg.BATCHSIZE), seed=args.seed)
    generator = torch.Generator().manual_seed(args.seed)
    for step in range(args.steps):
        start = step * cfg.BATCHSIZE
        indices = [(start + i) % len(dataset) for i in range(cfg.BATCHSIZE)]
        t0 = time.perf_counter()
        losses, total = trainer.train_step(dataset.get_batch(indices), generator)
        record = {'step': step, 'total_loss': float(total),
                  **{k: float(v) for k, v in losses.items()},
                  'seconds': round(time.perf_counter() - t0, 3)}
        print(json.dumps(record), flush=True)
    return trainer


if __name__ == '__main__':
    main()
