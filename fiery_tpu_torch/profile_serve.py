"""Where the serve time goes on the card: python -m fiery_tpu_torch.profile_serve

Full-width baseline.yml at batch 1 (PRECISION 16, seeded random weights, BatchNorm
statistics calibrated on two seeded clips); ``--topk 8 --warp-free`` serves the
sparse, warp-free combination (LIFT.TOPK 8, LIFT.WARP_FREE True). Prints, as JSON
lines:
  * the request wall time (host clock around predict_instances + synchronize),
    median of --requests requests after a warm-up;
  * each stage's device time (CUDA events around the encoder, the bev_pool splat,
    or the top-k splat (K5, K1), the bev_warp warp, the temporal model, the present distribution, the future
    rollout, the decoder, the instance decode (K6, K7) and the temporal ID
    tracking (K8, K9)), median over the same requests;
  * from torch.profiler over three requests: the device busy time per request, its
    share of the wall time, the kernels that take the most device time, and the
    BatchNorm (K10), GRU gate (K11), centroid (K8, by its kernel's name in this
    tree or the one before it) and assignment (K9) kernels' launches and device
    time;
  * the host time of one call (µs, host clock over 3000 calls at a small shape,
    in batches of 100 with a synchronize between batches outside the clock, so
    the card never holds the host back) of the eval BatchNorm with its ReLU
    (K10), of ``F.batch_norm`` + ``F.relu`` on the same tensors, of the GRU's two
    gate calls (K11) when serving, of the splat (K1: one memset and four kernels
    a call), of the centroids (K8: 8 x 8 ids, 101 slots, with flow) and of the
    warp's backward (K2: 8 x 8 x 64 bf16).
Needs a CUDA card.
"""

import argparse
import functools
import json
import statistics
import time

import torch
import torch.nn.functional as F

from fiery_tpu_torch import evaluate as evaluate_module
from fiery_tpu_torch.models import fiery as fiery_module
from fiery_tpu_torch.models.layers import BatchNorm
from fiery_tpu_torch.ops.batch_norm import batch_norm_forward
from fiery_tpu_torch.ops.lap import linear_sum_assignment
from fiery_tpu_torch.ops.lift_splat import bev_pool
from fiery_tpu_torch.ops.warp import bev_warp, bev_warp_backward
from fiery_tpu_torch.postprocess.instance import find_instance_centers, segment_centroids
from fiery_tpu_torch.ops.spatial_gru import (gru_output, gru_reset_concat, gru_state_update,
                                             spatial_gru)
from fiery_tpu_torch.serve import (BASELINE, build_fiery, calibrate_batchnorm, init_params,
                                   make_request, predict_instances)
from fiery_tpu_torch.utils.config import get_cfg

MODULE_STAGES = ('encoder', 'temporal_model', 'present_distribution', 'future_prediction',
                 'decoder')
FUNCTION_STAGES = {'bev_pool_splat': (fiery_module, 'lift_splat_depth'),
                   'topk_splat': (fiery_module, 'lift_splat_topk'),
                   'bev_warp': (fiery_module, 'cumulative_warp_features'),
                   'decode': (evaluate_module, 'decode_instance_predictions'),
                   'track': (evaluate_module, 'make_instance_id_temporally_consistent_device')}


class StageTimer:
    """CUDA events around each stage of one request; read after a synchronize."""

    def __init__(self):
        self.events = {}

    def start(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.setdefault(name, []).append([ev, None])

    def stop(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name][-1][1] = ev

    def read_ms(self):
        out = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.events.items()}
        self.events = {}
        return out


def instrument(model, timer):
    for name in MODULE_STAGES:
        module = getattr(model, name)
        module.register_forward_pre_hook(lambda m, a, n=name: timer.start(n))
        module.register_forward_hook(lambda m, a, o, n=name: timer.stop(n))
    for stage, (module, attr) in FUNCTION_STAGES.items():
        fn = getattr(module, attr)

        @functools.wraps(fn)
        def timed(*args, _fn=fn, _stage=stage, **kw):
            timer.start(_stage)
            out = _fn(*args, **kw)
            timer.stop(_stage)
            return out
        setattr(module, attr, timed)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--requests', type=int, default=10)
    parser.add_argument('--topk', type=int, default=0,
                        help='LIFT.TOPK: splat only the k largest depth bins per pixel')
    parser.add_argument('--warp-free', action='store_true',
                        help='LIFT.WARP_FREE: lift past frames straight into the present')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_serve needs a CUDA device')

    opts = ['LIFT.TOPK', str(args.topk), 'LIFT.WARP_FREE', str(args.warp_free)]
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=opts))
    model = init_params(build_fiery(cfg), seed=0)
    calibrate_batchnorm(model, [make_request(cfg, seed=s) for s in (6, 7)])
    requests = [make_request(cfg, seed=10 + i) for i in range(args.requests)]
    timer = StageTimer()
    instrument(model, timer)
    predict_instances(model, make_request(cfg, seed=9))
    torch.cuda.synchronize()
    timer.read_ms()

    walls, stages = [], []
    for req in requests:
        t0 = time.perf_counter()
        predict_instances(model, req)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        stages.append(timer.read_ms())
    stage_ms = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    print(json.dumps({'topk': args.topk, 'warp_free': args.warp_free,
                      'request_ms_median': statistics.median(walls),
                      'request_ms': walls, 'stage_device_ms_median': stage_ms,
                      'stage_device_ms_sum': sum(stage_ms.values())}), flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    batch_norm_forward.launches = spatial_gru.launches = linear_sum_assignment.launches = 0
    segment_centroids.launches = 0
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for req in requests[:3]:
            predict_instances(model, req)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 3
    timer.read_ms()
    rows = []   # device-side events only (kernels, copies): no double count of the ops
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and not e.is_user_annotation):
            rows.append((e.self_device_time_total / 3e3, e.count / 3, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(json.dumps({'profiled_wall_ms_per_request': wall_ms,
                      'device_busy_ms_per_request': busy_ms,
                      'device_busy_share': busy_ms / wall_ms if wall_ms else None,
                      'kernels_per_request': sum(r[1] for r in rows)}), flush=True)
    # K10's kernels (stats, apply; eval runs apply only), K11's (reset_concat,
    # state_update), K8's and K9's, by their symbols
    for name, symbols, fn in (('batch_norm', ('::stats_kernel<', '::apply_kernel<'),
                               batch_norm_forward),
                              ('spatial_gru', ('reset_concat_kernel', 'state_update_kernel'),
                               spatial_gru),
                              ('segment_centroids', ('::centroid_kernel',
                                                     '::centroid_clip_kernel'),
                               segment_centroids),
                              ('lap', ('::lap_kernel',), linear_sum_assignment)):
        print(json.dumps({'kernel': name, 'launches_per_request': fn.launches / 3,
                          'device_ms_per_request': sum(
                              r[0] for r in rows if any(s in r[2] for s in symbols))}),
              flush=True)
    for ms, count, key in rows[:25]:
        print(json.dumps({'kernel': key[:120], 'device_ms_per_request': ms,
                          'calls_per_request': count}), flush=True)
    print(json.dumps({'host_us_per_call': host_us_per_call()}), flush=True)
    print(json.dumps({'device': torch.cuda.get_device_name(0)}), flush=True)


def host_us_per_call(n=3000, batch=100):
    """Host µs of one call of each wrapper the request (or step) makes, against the
    PyTorch calls it replaced, at a small bf16 shape (64 channels, 8 x 8; the splat
    4 x 4 pixels of 8 bins into 64 voxels; the centroids 8 x 8 ids in 101 slots with
    flow; the warp 8 x 8 x 64; the centres one 16 x 16 frame): n calls in batches,
    the card synchronized between batches outside the clock."""
    x = torch.randn(1, 64, 8, 8, device='cuda', dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    gen = torch.Generator(device='cuda').manual_seed(0)
    depth = torch.rand((1, 1, 4, 4, 8), generator=gen, device='cuda').to(torch.bfloat16)
    feat = torch.randn((1, 1, 4, 4, 64), generator=gen, device='cuda').to(torch.bfloat16)
    ids = torch.randint(0, 65, (1, 1, 4, 4, 8), generator=gen, device='cuda',
                        dtype=torch.int32)
    labels = torch.randint(0, 101, (1, 8, 8), generator=gen, device='cuda',
                           dtype=torch.int32)
    flow = torch.randn((1, 8, 8, 2), generator=gen, device='cuda')
    g = torch.randn((1, 8, 8, 64), generator=gen, device='cuda').to(torch.bfloat16)
    pose = torch.zeros((1, 6), device='cuda')
    heat = torch.rand((1, 16, 16), generator=gen, device='cuda')
    bn = init_params(BatchNorm(64, post='relu'), seed=0).cuda().eval()
    h = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    slot = gru_output(h, 1)
    calls = {'batch_norm_relu (K10)': lambda: bn(x),
             'F.batch_norm + F.relu': lambda: F.relu(F.batch_norm(
                 x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.1,
                 bn.eps)),
             'gru_reset_concat (K11)': lambda: gru_reset_concat(h, h, h),
             'gru_state_update (K11)': lambda: gru_state_update(h, h, h, slot, 0),
             'bev_pool (K1)': lambda: bev_pool(depth, feat, ids, 64),
             'segment_centroids (K8)': lambda: segment_centroids(labels, 101, flow),
             'bev_warp_backward (K2)': lambda: bev_warp_backward(g, pose, (50.0, 50.0)),
             'bev_warp (K2)': lambda: bev_warp(g, pose, (50.0, 50.0)),
             'find_instance_centers (K6)': lambda: find_instance_centers(heat)}
    out = {}
    with torch.inference_mode():
        for name, fn in calls.items():
            for _ in range(50):
                fn()
            spent = 0.0
            for _ in range(n // batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(batch):
                    fn()
                spent += time.perf_counter() - t0
            torch.cuda.synchronize()
            out[name] = 1e6 * spent / (n // batch * batch)
    return out


if __name__ == '__main__':
    main()
