"""Time two checkouts of this repository on one card, in turns:

    python -m fiery_tpu_torch.turns PARENT_CHECKOUT . --rounds 1

Each round runs one fresh process per checkout in the order A B B A, each from
its checkout's root, so that the two trees never share a process. A process
builds its kernels and then measures full-width baseline.yml (PRECISION 16,
seeded random weights, BatchNorm calibrated on two seeded clips), dense and the
levers' combination (LIFT.TOPK 8, LIFT.WARP_FREE; DATASET.PREWARP_LABELS in
training, the labels warped on the host outside the step):
  * request ms: host clock around ``predict`` + synchronize, after a warm-up;
  * step ms at batch 3: host clock around ``Trainer.train_step`` + synchronize,
    drop-connect and noise drawn on the card, after a warm-up step.
Each process prints one JSON line of its medians; the last line gathers them per
checkout. Only entry points that both trees have are used. Needs a CUDA card.
A step's stage times are ``chip_smoke.py``'s (``stage_times``).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r'''
import argparse, json, statistics, sys, time
import torch
from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.data.label_warp import make_prewarp_transform
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.serve import (BASELINE, build_fiery, calibrate_batchnorm, init_params,
                                   make_request, predict)
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.config import get_cfg

requests, steps = int(sys.argv[1]), int(sys.argv[2])
_build.build_all()
combo = ['LIFT.TOPK', '8', 'LIFT.WARP_FREE', 'True']
out = {}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


for kind, opts in (('dense', []), ('combo', combo)):
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=list(opts)))
    model = init_params(build_fiery(cfg), seed=0)
    calibrate_batchnorm(model, [make_request(cfg, seed=s) for s in (6, 7)])
    reqs = [make_request(cfg, seed=10 + i) for i in range(requests + 1)]
    ms = [timed(lambda r=r: predict(model, r)) for r in reqs]
    out[f'request_ms_{kind}'] = statistics.median(ms[1:])
    out[f'request_ms_{kind}_all'] = ms[1:]
    del model
    topts = ['DATASET.NAME', 'synthetic'] + opts + (
        ['DATASET.PREWARP_LABELS', 'True'] if kind == 'combo' else [])
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=topts))
    trainer = Trainer(cfg)
    init_params(trainer.model, seed=0)
    calibrate_batchnorm(trainer.model, [make_request(cfg, seed=s) for s in (6, 7)])
    b = cfg.BATCHSIZE
    data = SyntheticFutureDataset(cfg, n_samples=b * (steps + 1), seed=0)
    batches = [data.get_batch(range(i * b, (i + 1) * b)) for i in range(steps + 1)]
    if cfg.DATASET.PREWARP_LABELS:
        transform = make_prewarp_transform(cfg)
        batches = [transform(x) for x in batches]
    gen = torch.Generator(device='cuda').manual_seed(0)
    ms = [timed(lambda x=x: trainer.train_step(x, gen)) for x in batches]
    out[f'step_ms_{kind}'] = statistics.median(ms[1:])
    out[f'step_ms_{kind}_all'] = ms[1:]
    del trainer
    torch.cuda.empty_cache()
print('TURNS ' + json.dumps(out), flush=True)
'''


def run(tree, requests, steps):
    tree = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, '-c', CHILD, str(requests), str(steps)], cwd=tree,
                          env=env, capture_output=True, text=True, timeout=1800)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('TURNS ')]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f'{tree}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n'
                           f'{proc.stderr[-3000:]}')
    return json.loads(lines[-1][len('TURNS '):])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('a', help='checkout A (e.g. the parent commit unpacked)')
    parser.add_argument('b', help='checkout B')
    parser.add_argument('--rounds', type=int, default=1)
    parser.add_argument('--requests', type=int, default=10)
    parser.add_argument('--steps', type=int, default=4)
    args = parser.parse_args()
    results = {args.a: [], args.b: []}
    for _ in range(args.rounds):
        for tree in (args.a, args.b, args.b, args.a):
            r = run(tree, args.requests, args.steps)
            results[tree].append(r)
            print(json.dumps({'tree': tree, **r}), flush=True)
    summary = {tree: {k: statistics.median(r[k] for r in rs) for k in rs[0]
                      if not k.endswith('_all')} for tree, rs in results.items()}
    print(json.dumps({'medians_of_process_medians': summary}), flush=True)


if __name__ == '__main__':
    main()
