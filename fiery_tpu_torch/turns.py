"""Time two checkouts of this repository on one card, in turns:

    python -m fiery_tpu_torch.turns PARENT_CHECKOUT . --rounds 1

Each round runs one fresh process per checkout in the order A B B A, each from
its checkout's root, so that the two trees never share a process. A process
builds its kernels and then measures full-width baseline.yml (PRECISION 16,
seeded random weights, BatchNorm calibrated on two seeded clips), dense and the
levers' combination (LIFT.TOPK 8, LIFT.WARP_FREE; DATASET.PREWARP_LABELS in
training, the labels warped on the host outside the step):
  * request ms: host clock around ``predict`` + synchronize, after a warm-up; and
    the same for the served model, every BatchNorm folded
    (``serve.seeded_state_dict``, ``build_fiery(..., fold_bn=True)``):
    ``folded_request_ms_<kind>``;
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
    forward (K2), its nearest mode (K4) and both together (K2K4: older trees ran
    them as one kernel, so only this key reads them there), the warp's backward
    (K2b), the instance centres (K6), the pixel grouping (K7), the top-k depth
    select (K5) and its backward (K5b) and the top-k loss's k-th value (K3), by their
    kernels' names in either tree (keys ``<k10|k11|k9|k8|k6|k7|k1|k1b|k2|k4|k2k4|k2b|
    k5|k5b|k3>_<request|instances|step>_ms_<kind>`` and ``..._launches``), and the
    memsets among the kernels and copies (``memsets_<key>``);
  * the host µs of one call (batches of 100 calls, synchronized outside the
    clock) of the splat (``bev_pool``, 4 x 4 pixels of 8 bins into 64 voxels,
    bf16: ``k1_host_us``), of the centroids (``segment_centroids``, 8 x 8 ids in
    101 slots with flow: ``k8_host_us``), of the warp and its backward
    (``bev_warp``, ``bev_warp_backward``, 8 x 8 x 64 bf16: ``k2_host_us``,
    ``k2b_host_us``), of the centres (``find_instance_centers``, one 16 x 16
    frame: ``k6_host_us``), of the top-k select (``topk_select``, the splat's
    4 x 4 pixels, k = 3: ``k5_host_us``), of an eval BatchNorm (``batch_norm``,
    8 x 8 x 64 bf16 channels-last, post relu: ``k10_host_us``) and of the GRU's
    two gate calls (``gru_reset_concat`` and ``gru_state_update`` on 8 x 8 x 64
    bf16: ``k11_reset_host_us``, ``k11_update_host_us``);
  * last, each of those kernels alone, the same calls in either tree: K2 forward
    at the serve and training shapes (2 and 6 maps of 200 x 200 x 64 bf16), K4 on
    a label stack (12 maps of 200 x 200 x 7 f32) and K6 on a request's 5 frames of
    200 x 200, K5 at the serve and training shapes (3 and 9 samples of 6 x 28 x 60
    pixels, 48 bins, k = 8, bf16, planted ties), K5's backward at the training shape
    (its idx, a bf16 gradient), K7 on the 5 frames of K6 (its 100 centres, offsets
    and 2-class logits) and K3 on 15 rows of 40,000 (k = 10,000, random and with
    ties), device ms a call (``k2_serve_kernel_ms``, ``k2_train_kernel_ms``,
    ``k4_kernel_ms``, ``k6_kernel_ms``, ``k5_serve_kernel_ms``,
    ``k5_train_kernel_ms``, ``k5b_train_kernel_ms``, ``k7_kernel_ms``,
    ``k3_random_kernel_ms``, ``k3_ties_kernel_ms``) and launches a call
    (``..._kernel_launches``, from the wrappers' launch counters; a trace that
    holds fewer is taken again, up to 5 times, else its ms is scaled from the
    launches it holds and ``..._kernel_trace_whole`` is false).
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
from fiery_tpu_torch.ops import spatial_gru as GRU
from fiery_tpu_torch.ops import warp as WP
from fiery_tpu_torch.postprocess import instance as PI
from fiery_tpu_torch.data.label_warp import make_prewarp_transform
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.training import losses as L
from fiery_tpu_torch.serve import (BASELINE, build_fiery, calibrate_batchnorm, init_params,
                                   make_request, predict, predict_instances,
                                   seeded_state_dict)
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.config import get_cfg

requests, steps = int(sys.argv[1]), int(sys.argv[2])
_build.build_all()
# the kernels' names, of either tree, in their anonymous namespace (which keeps out
# Adam's multi_tensor_apply_kernel): K10 (three launches a pass, or two), K11 (the
# GRU gates, forward and backward), K9 (the assignment), K8 (the centroids: two
# launches a tracking step, or one a request), K1 forward (one atomic kernel, or
# four), K1 backward, K2 forward and K4 (its nearest mode; one kernel for both
# in older trees, so there only 'k2k4' reads them), K2 backward (an atomic
# scatter, or a gather), K6 (the instance centres), K7 (the pixel grouping: an
# assign and a relabel launch, or one cluster launch), K5 (the top-k depth select)
# and its backward (K5b), and K3 (the top-k loss's k-th value)
KERNELS = {'k10': ('::stats_kernel', '::stats_finalize_kernel', '::apply_kernel',
                   '::backward_reduce_kernel', '::backward_finalize_kernel',
                   '::backward_apply_kernel'),
           'k11': ('::reset_concat', '::state_update'),
           'k9': ('::lap_kernel',),
           'k8': ('::centroid_kernel', '::centroid_clip_kernel'),
           'k2': ('::bev_warp_tile_kernel',),
           'k4': ('::nearest_warp_tile_kernel',),
           'k2k4': ('::bev_warp_kernel', '::bev_warp_tile_kernel', '::nearest_warp_tile_kernel'),
           'k6': ('::centers_kernel', '::centers_cluster_kernel'),
           'k7': ('::assign_kernel', '::relabel_kernel', '::group_cluster_kernel'),
           'k2b': ('::warp_scatter_kernel', '::warp_gather_kernel'),
           'k1': ('::bev_pool_kernel', '::splat_count_kernel', '::splat_scan_kernel',
                  '::splat_fill_kernel', '::splat_pool_kernel'),
           'k1b': ('::pool_backward_kernel', '::splat_backward_kernel'),
           'k5': ('::topk_select_kernel',),
           'k5b': ('::topk_select_backward_kernel',),
           'k3': ('::kth_largest_kernel',)}


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
    out[f'memsets_{key}'] = sum(e.count for e in ev if e.key.startswith('Memset'))
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
out['k2_host_us'] = host_us(lambda: WP.bev_warp(grad, pose, (50.0, 50.0)))
heat = torch.rand((1, 16, 16), generator=gen, device='cuda')
out['k6_host_us'] = host_us(lambda: PI.find_instance_centers(heat))
out['k5_host_us'] = host_us(lambda: LS.topk_select(depth, ids, 3))
rows = grad.permute(0, 3, 1, 2)                # (1, 64, 8, 8) channels-last
ones, zeros = torch.ones(64, device='cuda'), torch.zeros(64, device='cuda')
out['k10_host_us'] = host_us(lambda: BN.batch_norm(rows, ones, zeros, zeros, ones, False, 0.1,
                                                   1e-5, 'relu'))
slots = GRU.gru_output(rows, 2)
out['k11_reset_host_us'] = host_us(lambda: GRU.gru_reset_concat(rows, rows, rows))
out['k11_update_host_us'] = host_us(lambda: GRU.gru_state_update(rows, rows, rows, slots, 0))



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
    folded = build_fiery(cfg, state_dict=seeded_state_dict(cfg, seed=0), fold_bn=True)
    ms = [timed(lambda r=r: predict(folded, r)) for r in reqs]
    out[f'folded_request_ms_{kind}'] = statistics.median(ms[1:])
    out[f'folded_request_ms_{kind}_all'] = ms[1:]
    del folded
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


def kernel_alone(fn, key, name, counter, reps=20, attempts=5):
    """Device ms a call of fn's kernels (KERNELS[name]), profiled over reps calls
    after a warm-up: out['<key>_kernel_ms'], and the launches a call makes,
    out['<key>_kernel_launches'], from the launch counter of the wrapper
    ``counter`` (as each tree counts them). A trace that holds fewer of those
    launches (CUPTI drops some) is taken again, up to ``attempts`` times; if none
    is whole, the ms is scaled from the launches it saw, and
    out['<key>_kernel_trace_whole'] is False."""
    def window():
        # a trace's first launches can go unrecorded, more as the process runs the
        # model (python -m fiery_tpu_torch.trace_probe): spin kernels and a pause first
        for _ in range(64):
            torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        time.sleep(0.002)
        for _ in range(reps):
            fn()

    for _ in range(3):
        fn()
    for _ in range(attempts):
        got, made = {}, counter.launches
        profiled(window, got, key)
        made = counter.launches - made
        seen = got[f'{name}_{key}_launches']
        if seen == made:
            break
    out[f'{key}_kernel_ms'] = got[f'{name}_{key}'] * made / max(seen, 1) / reps
    out[f'{key}_kernel_launches'] = made / reps
    out[f'{key}_kernel_trace_whole'] = seen == made


# after the timed runs: K2 forward at the serve and training shapes (2 and 6 maps
# of 200 x 200 x 64 bf16), K4 on the label stack (12 maps of 200 x 200 x 7 f32),
# K6 on a request's 5 frames: the same calls in either tree
x2 = torch.randn((6, 200, 200, 64), generator=gen, device='cuda').to(torch.bfloat16)
p6 = torch.zeros((6, 6), device='cuda')
p6[:, 0], p6[:, 1], p6[:, 5] = 1.3, -0.4, 0.07
kernel_alone(lambda: WP.bev_warp(x2[:2], p6[:2], (50.0, 50.0)), 'k2_serve', 'k2k4',
             WP.bev_warp)
kernel_alone(lambda: WP.bev_warp(x2, p6, (50.0, 50.0)), 'k2_train', 'k2k4', WP.bev_warp)
lab = torch.randn((12, 200, 200, 7), generator=gen, device='cuda')
p12 = p6.repeat(2, 1)
kernel_alone(lambda: WP.bev_warp_nearest(lab, p12, (50.0, 50.0)), 'k4', 'k2k4',
             WP.bev_warp_nearest)
heat5 = torch.rand((5, 200, 200), generator=gen, device='cuda')
kernel_alone(lambda: PI.find_instance_centers(heat5), 'k6', 'k6', PI.find_instance_centers)
# K5 at the serve and training shapes (3 and 9 samples x 6 cameras x 28 x 60 pixels, 48
# bins, k = 8, bf16 softmax weights, every fourth pixel planted with ties) and K3 on the
# segmentation loss's 15 rows of 40,000 (k = 10,000), random and with ties
for key, samples in (('k5_serve', 3), ('k5_train', 9)):
    d5 = torch.softmax(torch.randn((samples * 10080, 48), generator=gen, device='cuda'), -1)
    d5[0::16] = torch.randint(0, 3, (samples * 10080, 48), generator=gen,
                              device='cuda')[0::16] / 4.0
    d5[4::16], d5[8::16] = 0.0, 1.0
    d5 = d5.to(torch.bfloat16).view(samples, 6, 28, 60, 48)
    i5 = torch.randint(0, 40001, d5.shape, generator=gen, device='cuda', dtype=torch.int32)
    kernel_alone(lambda: LS.topk_select(d5, i5, 8), key, 'k5', LS.topk_select)
# K5 backward at the training shape (the idx of the select above, a bf16 gradient) and
# K7 on a request's 5 frames (K6's 100 centres of heat5, offsets of 4 pixels' spread,
# 2-class logits)
idx5 = LS.topk_select(d5, i5, 8)[2]
g5 = torch.randn(idx5.shape, generator=gen, device='cuda').to(torch.bfloat16)
kernel_alone(lambda: LS.topk_select_backward(g5, idx5, 48), 'k5b_train', 'k5b',
             LS.topk_select_backward)
c7, v7 = PI.find_instance_centers(heat5)
off7 = torch.randn((5, 200, 200, 2), generator=gen, device='cuda') * 4.0
seg7 = torch.randn((5, 200, 200, 2), generator=gen, device='cuda')
kernel_alone(lambda: PI.instance_ids(c7, v7, off7, seg7), 'k7', 'k7', PI.instance_ids)
x3 = torch.rand((15, 40000), generator=gen, device='cuda') * 3.0
kernel_alone(lambda: L.kth_largest(x3, 10000), 'k3_random', 'k3', L.kth_largest)
x3[::2, :30000] = 0.0
x3[1::2, ::2] = 1.5
kernel_alone(lambda: L.kth_largest(x3, 10000), 'k3_ties', 'k3', L.kth_largest)
del x2, lab, d5, i5, x3, idx5, g5, off7, seg7
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
