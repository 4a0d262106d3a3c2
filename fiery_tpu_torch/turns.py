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
    drop-connect and noise drawn on the card, after a warm-up step;
  * the same requests again, with the host time inside the BatchNorm wrapper
    (K10's ``ops.batch_norm.batch_norm_forward``, where ``batch_norm`` calls it in
    either tree) summed per request: its ms and its share of the request's ms,
    and the launch plans its cache added (misses) over those requests;
  * after the timed runs, one request, one request with instances
    (``predict_instances``) and one step under torch.profiler: the device busy
    ms and the device-side kernels and copies (``kernels_<key>``), and the device
    ms and launches of the BatchNorm kernel (K10), the GRU's gate kernels (K11),
    the assignment kernel (K9), the centroid kernel (K8), the splat forward (K1,
    its kernels; not the memset of its counters) and backward (K1b), the warp's
    kernel (K2; in a step also its nearest mode, K4) and the warp's backward
    (K2b), by their kernels' names in either tree (keys
    ``<k10|k11|k9|k8|k1|k1b|k2|k2b>_<request|instances|step>_ms_<kind>`` and
    ``..._launches``);
  * the host µs of one call (batches of 100 calls, synchronized outside the
    clock) of the splat (``bev_pool``, 4 x 4 pixels of 8 bins into 64 voxels,
    bf16: ``k1_host_us``), of the centroids (``segment_centroids``, 8 x 8 ids in
    101 slots with flow: ``k8_host_us``) and of the warp's backward
    (``bev_warp_backward``, 8 x 8 x 64 bf16: ``k2b_host_us``).
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
from fiery_tpu_torch.ops import batch_norm as BN
from fiery_tpu_torch.ops import lift_splat as LS
from fiery_tpu_torch.ops import warp as WP
from fiery_tpu_torch.postprocess import instance as PI
from fiery_tpu_torch.data.label_warp import make_prewarp_transform
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.serve import (BASELINE, build_fiery, calibrate_batchnorm, init_params,
                                   make_request, predict, predict_instances)
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.config import get_cfg

requests, steps = int(sys.argv[1]), int(sys.argv[2])
_build.build_all()
# the kernels' names, of either tree, in their anonymous namespace (which keeps out
# Adam's multi_tensor_apply_kernel): K10 (three launches a pass, or two), K11 (the
# GRU gates, forward and backward), K9 (the assignment), K8 (the centroids: two
# launches a tracking step, or one a request), K1 forward (one atomic kernel, or
# four), K1 backward, K2 (the warp, and in a step its nearest mode K4) and K2
# backward (an atomic scatter, or a gather)
KERNELS = {'k10': ('::stats_kernel', '::stats_finalize_kernel', '::apply_kernel',
                   '::backward_reduce_kernel', '::backward_finalize_kernel',
                   '::backward_apply_kernel'),
           'k11': ('::reset_concat', '::state_update'),
           'k9': ('::lap_kernel',),
           'k8': ('::centroid_kernel', '::centroid_clip_kernel'),
           'k2': ('::bev_warp_kernel',),
           'k2b': ('::warp_scatter_kernel', '::warp_gather_kernel'),
           'k1': ('::bev_pool_kernel', '::splat_count_kernel', '::splat_scan_kernel',
                  '::splat_fill_kernel', '::splat_pool_kernel'),
           'k1b': ('::pool_backward_kernel', '::splat_backward_kernel')}


def profiled(fn, out, key):
    """fn() under torch.profiler: out['busy_<key>'] the device busy ms, and for
    each kernel of KERNELS out['<kernel>_<key>'] its device ms and
    out['<kernel>_<key>_launches'] its launches."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    out[f'busy_{key}'] = sum(e.self_device_time_total for e in ev) / 1e3
    out[f'kernels_{key}'] = sum(e.count for e in ev)
    for name, symbols in KERNELS.items():
        mine = [e for e in ev if any(k in e.key for k in symbols)]
        out[f'{name}_{key}'] = sum(e.self_device_time_total for e in mine) / 1e3
        out[f'{name}_{key}_launches'] = sum(e.count for e in mine)

combo = ['LIFT.TOPK', '8', 'LIFT.WARP_FREE', 'True']
out = {}


def host_us(fn, n=3000, batch=100):
    """Host µs of one call of fn."""
    spent = 0.0
    with torch.inference_mode():
        for _ in range(50):
            fn()
        for _ in range(n // batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            spent += time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * spent / (n // batch * batch)


gen = torch.Generator(device='cuda').manual_seed(0)
depth = torch.rand((1, 1, 4, 4, 8), generator=gen, device='cuda').to(torch.bfloat16)
feat = torch.randn((1, 1, 4, 4, 64), generator=gen, device='cuda').to(torch.bfloat16)
ids = torch.randint(0, 65, (1, 1, 4, 4, 8), generator=gen, device='cuda', dtype=torch.int32)
labels = torch.randint(0, 101, (1, 8, 8), generator=gen, device='cuda', dtype=torch.int32)
flow = torch.randn((1, 8, 8, 2), generator=gen, device='cuda')
grad = torch.randn((1, 8, 8, 64), generator=gen, device='cuda').to(torch.bfloat16)
pose = torch.zeros((1, 6), device='cuda')
out['k1_host_us'] = host_us(lambda: LS.bev_pool(depth, feat, ids, 64))
out['k8_host_us'] = host_us(lambda: PI.segment_centroids(labels, 101, flow))
out['k2b_host_us'] = host_us(lambda: WP.bev_warp_backward(grad, pose, (50.0, 50.0)))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def k10_host(fn):
    """(ms of fn(), of it the host ms inside the K10 forward wrapper, the plans its
    cache added), the wrapper timed where ops.batch_norm.batch_norm looks it up."""
    orig, spent = BN.batch_norm_forward, [0.0]

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            spent[0] += time.perf_counter() - t0

    wrapper.__dict__.update(orig.__dict__)    # the counters the wrapper bumps
    BN.batch_norm_forward, plans = wrapper, len(BN._PLANS)
    try:
        ms = timed(fn)
    finally:
        BN.batch_norm_forward = orig
        orig.__dict__.update(wrapper.__dict__)
    return ms, 1e3 * spent[0], len(BN._PLANS) - plans


for kind, opts in (('dense', []), ('combo', combo)):
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=list(opts)))
    model = init_params(build_fiery(cfg), seed=0)
    calibrate_batchnorm(model, [make_request(cfg, seed=s) for s in (6, 7)])
    reqs = [make_request(cfg, seed=10 + i) for i in range(requests + 1)]
    ms = [timed(lambda r=r: predict(model, r)) for r in reqs]
    out[f'request_ms_{kind}'] = statistics.median(ms[1:])
    out[f'request_ms_{kind}_all'] = ms[1:]
    host = [k10_host(lambda r=r: predict(model, r)) for r in reqs[1:]]
    out[f'k10_host_ms_{kind}'] = statistics.median(h[1] for h in host)
    out[f'k10_host_share_{kind}'] = statistics.median(h[1] / h[0] for h in host)
    out[f'k10_plan_misses_{kind}'] = sum(h[2] for h in host)
    profiled(lambda: predict(model, reqs[1]), out, f'request_ms_{kind}')
    profiled(lambda: predict_instances(model, reqs[1]), out, f'instances_ms_{kind}')
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
    profiled(lambda: trainer.train_step(batches[1], gen), out, f'step_ms_{kind}')
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
