"""Smoke run of fiery_tpu_torch on one CUDA card: python3 chip_smoke.py

Builds the package's CUDA kernels from csrc/, then:
  1. serves three seeded full-width baseline.yml requests (PRECISION 16, random
     weights) through predict_instances, the decode and the device tracker
     included, and checks how often each of the six kernels ran on that path,
     that the device tracker never waits on the host, and how far the host
     (scipy) tracker's ids are from the device tracker's; times the request
     with and without decoding;
  2. holds K1 and K2 against their plain PyTorch versions at the baseline serve
     shapes, in f32 and in bf16, and times kernel, plain version and library call;
  3. runs a tiny config on the card and on the CPU with the same seeded weights
     and request, and compares every output;
  4. holds the decode and tracking kernels (K6-K9) against their plain versions
     at the served shapes and on planted inputs (K6, K7 and K9 exactly, K8
     within one f32 ulp), and times them;
  5. decodes and tracks a planted full-width scene of 20 moving vehicles, which
     both trackers must follow exactly (vehicle PQ = 1).
Prints a "kernels" JSON line, the card's name and power limit, and as its last
line {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Without a CUDA card, or without the package beside it, it fails.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.optimize
import torch
import torch.nn.functional as F

from fiery_tpu_torch.evaluate import device_consistent
from fiery_tpu_torch.models.fiery import FieryConfig
from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.ops.lap import linear_sum_assignment, linear_sum_assignment_plain
from fiery_tpu_torch.ops.lift_splat import (bev_pool, bev_pool_plain, create_frustum,
                                            get_geometry, voxel_ids)
from fiery_tpu_torch.ops.warp import bev_warp, bev_warp_plain
from fiery_tpu_torch.postprocess.instance import (
    find_instance_centers, find_instance_centers_plain, instance_ids, instance_ids_plain,
    predict_instance_segmentation_and_trajectories, segment_centroids,
    segment_centroids_plain)
from fiery_tpu_torch.serve import (BASELINE, build_fiery, calibrate_batchnorm, init_params,
                                   make_request, predict, predict_instances)
from fiery_tpu_torch.training.metrics import PanopticMetric
from fiery_tpu_torch.utils.config import get_cfg

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 and f64 (non-tensor-core) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12
REPS = 25
# the wrappers whose launches the main path counts, by kernel name
COUNTERS = {'bev_pool': bev_pool, 'bev_warp': bev_warp,
            'instance_centers': find_instance_centers, 'group_pixels': instance_ids,
            'segment_centroids': segment_centroids, 'lap': linear_sum_assignment}


def log(*args):
    print(*args, flush=True)


def smi_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=REPS, warmup=3):
    """Median over reps of one call's time on the stream (CUDA events around the
    call), after warm-up. It includes the gaps while the host launches the call's
    kernels, so for a call of short kernels it measures the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def kernel_ms(fn, symbols, reps=REPS, warmup=3):
    """Mean device time per call of the kernels whose names contain one of
    ``symbols`` (torch.profiler's CUPTI trace over reps calls, after warm-up): the
    kernel's own time, without the host's launch gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and any(sym in e.key for sym in symbols))
    if total_us <= 0:
        raise AssertionError(f'the profiler saw no device time for {symbols}')
    return total_us / 1e3 / reps


def bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    mag = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_close(name, got, want, dtype):
    """f32: |got - want| <= 1e-5 + 1e-5 |want|. bf16: within one bf16 ulp of the
    plain value (+1e-5): both sides form the same f32 terms and differ only in
    the order of their f32 sums before the one rounding to bf16."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = (1e-5 + 1e-5 * want.abs()) if dtype == torch.float32 else (bf16_ulp(want) + 1e-5)
    bad = int((err > tol).sum())
    max_err = float(err.max())
    log(f'  {name} {str(dtype)[6:]}: max_abs_err={max_err:.3e} over_tol={bad}')
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f'{name} {dtype}: {bad} values outside tolerance, '
                             f'max abs err {max_err}')
    return max_err


def bev_pool_inputs(device):
    """Baseline serve shapes: 3 samples x 6 cameras x 28 x 60 px x 48 bins, C = 64,
    voxel ids from the seeded camera rig of make_request."""
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=[]))
    mc = FieryConfig.from_cfg(cfg)
    req = make_request(cfg, seed=0)
    frustum = torch.from_numpy(create_frustum(mc.final_dim, mc.encoder_downsample,
                                              mc.d_bound)).to(device)
    intr = torch.from_numpy(req['intrinsics'][0]).to(device)    # (s, n, 3, 3)
    extr = torch.from_numpy(req['extrinsics'][0]).to(device)
    res, start, dim = mc.bev_parameters
    ids = voxel_ids(get_geometry(frustum, intr, extr), res, start, dim)
    ids = ids.permute(0, 1, 3, 4, 2).contiguous()               # (S, N, h, w, D)
    g = torch.Generator(device=device).manual_seed(1)
    S, N, h, w, D = ids.shape
    C = mc.encoder_out_channels
    depth = torch.softmax(torch.randn((S, N, h, w, D), generator=g, device=device), -1)
    feat = torch.randn((S, N, h, w, C), generator=g, device=device)
    num_bins = int(np.prod(dim))
    return depth, feat, ids, num_bins, int(dim[2])


def phase_bev_pool(device):
    depth32, feat32, ids, num_bins, z = bev_pool_inputs(device)
    S, C = depth32.shape[0], feat32.shape[-1]
    valid = int((ids < num_bins).sum())
    log(f'bev_pool: {ids.numel()} rows, {valid} in the grid, {num_bins} bins')
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        depth, feat = depth32.to(dtype), feat32.to(dtype)
        got = bev_pool(depth, feat, ids, num_bins, z)
        want = bev_pool_plain(depth, feat, ids, num_bins, z)
        torch.cuda.synchronize()
        err = check_close('bev_pool', got, want, dtype)

        flat_ids = (ids.view(S, -1).long()
                    + torch.arange(S, device=device)[:, None] * (num_bins + 1)).view(-1)

        def library():
            vol = depth[..., :, None] * feat[..., None, :]
            out = torch.zeros((S * (num_bins + 1), C), dtype=dtype, device=device)
            out.index_add_(0, flat_ids, vol.view(-1, C))
            return out

        es = depth.element_size()
        nbytes = depth.numel() * es + feat.numel() * es + ids.numel() * 4 + S * (
            num_bins // z) * C * es
        flops = 2.0 * valid * C
        bound_ms, bound_by = bound(nbytes, flops)
        rec[dtype] = dict(
            max_abs_err=err,
            ms=kernel_ms(lambda: bev_pool(depth, feat, ids, num_bins, z), ['bev_pool_kernel']),
            call_ms=time_ms(lambda: bev_pool(depth, feat, ids, num_bins, z)),
            plain_ms=time_ms(lambda: bev_pool_plain(depth, feat, ids, num_bins, z)),
            library_ms=time_ms(library), bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, flops=flops)
        log(f'  bev_pool {str(dtype)[6:]}: ' + json.dumps(
            {k: v for k, v in rec[dtype].items() if k != 'max_abs_err'}))
    return rec


def phase_bev_warp(device, spatial_extent=(50.0, 50.0)):
    g = torch.Generator(device=device).manual_seed(2)
    B, H, W, C = 2, 200, 200, 64
    x32 = torch.randn((B, H, W, C), generator=g, device=device)
    pose = torch.zeros((B, 6), device=device)
    pose[:, 0] = torch.rand(B, generator=g, device=device) * 4.0 - 2.0   # metres
    pose[:, 1] = torch.rand(B, generator=g, device=device) * 2.0 - 1.0
    pose[:, 5] = torch.rand(B, generator=g, device=device) * 0.2 - 0.1   # radians
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        got = bev_warp(x, pose, spatial_extent)
        want = bev_warp_plain(x, pose, spatial_extent)
        torch.cuda.synchronize()
        err = check_close('bev_warp', got, want, dtype)

        def library():
            theta = torch.stack([torch.cos(pose[:, 5]), -torch.sin(pose[:, 5]),
                                 pose[:, 1] / spatial_extent[1], torch.sin(pose[:, 5]),
                                 torch.cos(pose[:, 5]), -pose[:, 0] / spatial_extent[0]],
                                -1).view(B, 2, 3).to(dtype)
            xc = x.permute(0, 3, 1, 2)
            grid = torch.nn.functional.affine_grid(theta, list(xc.shape),
                                                   align_corners=False)
            return torch.nn.functional.grid_sample(xc, grid, mode='bilinear',
                                                   padding_mode='zeros',
                                                   align_corners=False)

        nbytes = 2 * x.numel() * x.element_size() + pose.numel() * 4
        flops = 7.0 * x.numel() + 30.0 * B * H * W
        bound_ms, bound_by = bound(nbytes, flops)
        rec[dtype] = dict(
            max_abs_err=err,
            ms=kernel_ms(lambda: bev_warp(x, pose, spatial_extent), ['bev_warp_kernel']),
            call_ms=time_ms(lambda: bev_warp(x, pose, spatial_extent)),
            plain_ms=time_ms(lambda: bev_warp_plain(x, pose, spatial_extent)),
            library_ms=time_ms(library), bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, flops=flops)
        log(f'  bev_warp {str(dtype)[6:]}: ' + json.dumps(
            {k: v for k, v in rec[dtype].items() if k != 'max_abs_err'}))
    return rec


def tiny_cfg():
    return get_cfg(cfg_dict={
        'PRECISION': 32, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2,
        'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B']},
        'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
                 'D_BOUND': [2.0, 8.0, 1.0]},
        'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
                  'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
                  'DISTRIBUTION': {'LATENT_DIM': 4},
                  'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 2}},
    })


def phase_tiny_card_vs_cpu():
    """Same seeded weights and request through the kernels (cuda) and the plain
    versions (cpu), f32 with TF32 off: every output within rtol/atol 1e-3."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_cfg()
    cpu = init_params(build_fiery(cfg, device='cpu'), seed=3)
    calibrate_batchnorm(cpu, [make_request(cfg, seed=s) for s in (6, 7)])
    card = build_fiery(cfg, device='cuda')
    card.load_state_dict(cpu.state_dict())
    request = make_request(cfg, seed=5)
    want = predict(cpu, request)
    got = predict(card, request)
    torch.cuda.synchronize()
    for k, v in want.items():
        d = (got[k].cpu() - v).abs()
        log(f'  tiny {k}: max_abs_err={float(d.max()):.3e} max_abs={float(v.abs().max()):.3e}')
        torch.testing.assert_close(got[k].cpu(), v, rtol=1e-3, atol=1e-3, msg=k)
    torch.backends.cudnn.allow_tf32 = True


def phase_serve(n_requests=3):
    """Full-width baseline.yml (PRECISION 16) at batch 1, seeded random weights.
    The main path is predict_instances (forward, decode, device tracker). After
    it, predict and predict_instances are timed in turns on the same requests: the
    request time without and with decoding."""
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=[]))
    model = init_params(build_fiery(cfg), seed=0)
    calibrate_batchnorm(model, [make_request(cfg, seed=s) for s in (6, 7)])
    mc = model.cfg
    X, Y = mc.bev_size
    T = 1 + mc.n_future
    expected = {'segmentation': (1, T, X, Y, mc.n_classes), 'instance_center': (1, T, X, Y, 1),
                'instance_offset': (1, T, X, Y, 2), 'instance_flow': (1, T, X, Y, 2),
                'present_mu': (1, 1, mc.latent_dim), 'present_log_sigma': (1, 1, mc.latent_dim)}
    requests = [make_request(cfg, seed=10 + i) for i in range(n_requests)]
    warm = make_request(cfg, seed=9)       # warm-up (cuDNN plans, kernels)
    predict_instances(model, warm)
    predict_instances(model, warm, device_matching=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    times, outputs, tracks = [], [], []
    for req in requests:
        t0 = time.perf_counter()
        out, ids = predict_instances(model, req)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        outputs.append(out)
        tracks.append(ids)
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    for out, ids in zip(outputs, tracks):
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != expected:
            raise AssertionError(f'output shapes {shapes} != {expected}')
        for k, v in out.items():
            if v.dtype != torch.float32 or not torch.isfinite(v).all():
                raise AssertionError(f'{k}: dtype {v.dtype} or non-finite values')
        if (ids.shape != (1, T, X, Y) or ids.dtype != torch.int32 or int(ids.min()) < 0
                or int(ids.max()) > T * 100):
            raise AssertionError(f'instance ids {ids.dtype} {tuple(ids.shape)} '
                                 f'in [{int(ids.min())}, {int(ids.max())}]')
    # per request: one splat, one warp, one decode (K7 launches twice), and per
    # tracking step two centroid launches (previous, current) and one assignment
    per_request = {'bev_pool': 1, 'bev_warp': 1, 'instance_centers': 1, 'group_pixels': 2,
                   'segment_centroids': 2 * (T - 1), 'lap': T - 1}
    for name, n in per_request.items():
        if launches[name] != n * n_requests:
            raise AssertionError(f'{name} launched {launches[name]} times for '
                                 f'{n_requests} requests, expected {n * n_requests}')

    log(f'serve (main path): request_ms={[round(t, 3) for t in times]} '
        f'peak_mem_bytes={peak} launches={launches}')
    # the request time without and with decoding, in turns on the same requests
    timed = {predict: [], predict_instances: []}
    for _ in range(3):
        for req in requests:
            for fn in (predict, predict_instances):
                t0 = time.perf_counter()
                fn(model, req)
                torch.cuda.synchronize()
                timed[fn].append(1e3 * (time.perf_counter() - t0))
    bare, full = timed[predict], timed[predict_instances]
    log(f'serve: request_ms={[round(t, 3) for t in bare]} '
        f'median_ms={statistics.median(bare):.3f} (predict, without decoding)')
    log(f'serve with decode and tracking: request_ms={[round(t, 3) for t in full]} '
        f'median_ms={statistics.median(full):.3f} (predict_instances)')

    # the device decode and tracking never wait on the host
    torch.cuda.set_sync_debug_mode('error')
    try:
        for out in outputs:
            device_consistent(out)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    log('serve: device decode + tracking ran under set_sync_debug_mode("error")')
    diffs, unexplained = [], []
    for out, ids in zip(outputs, tracks):
        host, dev = predict_instance_segmentation_and_trajectories(out), ids.cpu().numpy()
        diffs.append(int((host != dev).sum()))
        unexplained.append(relabel_disagreement(dev, host))
    log(f'serve: pixels whose host (scipy, f16 flow) id differs from the device id: '
        f'{diffs} of {T * X * Y} per request, {unexplained} after the best relabel of the '
        f'device ids; ids per request: {[int(ids.max()) for ids in tracks]}')
    return launches, outputs


def relabel_disagreement(a, b):
    """Pixels that no renaming of a's ids explains: for each id of a, the pixels
    whose id in b is not the one most of that id's pixels take in b. Unlike a pixel
    count of a != b, one fresh id numbered differently does not shift the rest."""
    a = a.reshape(-1).astype(np.int64)
    b = b.reshape(-1).astype(np.int64)
    nb = int(b.max()) + 1
    joint = np.bincount(a * nb + b, minlength=(int(a.max()) + 1) * nb).reshape(-1, nb)
    return int(a.size - joint.max(axis=1).sum())


def planted_heatmaps(device, T=5, H=200, W=200):
    """Seeded heatmaps of 8 x 8 plateaus quantised to 3 levels: every frame has
    hundreds of equal top-level peaks, so the 100th slot falls inside a tie."""
    g = torch.Generator().manual_seed(4)
    coarse = torch.rand((T, H // 8, W // 8), generator=g)
    smooth = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2)
    return (torch.floor(smooth * 3) / 3 + 0.05).to(device)


def tracker_costs(n_rows, seed, K=101):
    """(len(n_rows), K, K) costs padded as the tracker pads them: row 0 and column 0
    invalid, n_rows - 1 live rows against 60 live columns, distances clipped at 30,
    invalid pairs 1e4. Half the current centres sit near a previous one."""
    rng = np.random.RandomState(seed)
    out = []
    for n in n_rows:
        prev = rng.uniform(0, 200, (K, 2)).astype(np.float32)
        cur = rng.uniform(0, 200, (K, 2)).astype(np.float32)
        near = rng.rand(K) < 0.5
        cur[near] = prev[rng.permutation(K)][near] + rng.randn(
            int(near.sum()), 2).astype(np.float32) * 2.0
        dist = np.sqrt(((prev[:, None] - cur[None]) ** 2).sum(-1)).astype(np.float32)
        valid = np.zeros((K, K), bool)
        valid[1:n, 1:61] = True
        out.append(np.where(valid, np.minimum(dist, np.float32(30.0)), np.float32(1e4)))
    return np.stack(out).astype(np.float32)


def ulp32(x):
    """Spacing of f32 values at |x|."""
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float('inf'))) - a


def phase_decode_kernels(device, outputs):
    """K6-K9 against their plain versions at the shapes of the served request:
    K6 and K7 on the served heads and on planted inputs (exactly), K8 on the served
    ids and flow (within one f32 ulp), K9 on seeded tracker costs (exactly, and its
    total within 1e-3 of scipy's optimum). Times each."""
    out = outputs[0]
    _, T, H, W, C = out['segmentation'].shape
    center = out['instance_center'].reshape(T, H, W).contiguous()
    offset = out['instance_offset'].reshape(T, H, W, 2).contiguous()
    seg = out['segmentation'].reshape(T, H, W, C).contiguous()
    rec = {}

    # K6 and K7, exactly, on the served heads; on 3-level plateaus (ties at the
    # 100th slot) with the served offsets; on the planted scene (20 peaks a frame,
    # so 80 slots of -inf padding that must take the lowest pixel indices)
    scene, _ = planted_scene(device, T, H, W)
    cases = [('served', center, offset, seg),
             ('plateaus', planted_heatmaps(device, T, H, W), offset, seg),
             ('planted scene', scene['instance_center'].reshape(T, H, W).contiguous(),
              scene['instance_offset'].reshape(T, H, W, 2).contiguous(),
              scene['segmentation'].reshape(T, H, W, C).contiguous())]
    for name, c, o, sg in cases:
        ck, vk = find_instance_centers(c)
        cp, vp = find_instance_centers_plain(c)
        ik = instance_ids(cp, vp, o, sg)
        ip = instance_ids_plain(cp, vp, o, sg)
        torch.cuda.synchronize()
        if not (torch.equal(ck, cp) and torch.equal(vk, vp)):
            raise AssertionError(f'instance_centers {name}: kernel != plain')
        if not torch.equal(ik, ip):
            raise AssertionError(f'group_pixels {name}: kernel != plain at '
                                 f'{int((ik != ip).sum())} pixels')
        log(f'  instance_centers, group_pixels {name}: equal to plain; valid centres '
            f'per frame {vp.sum(1).tolist()}, ids per frame {ip.reshape(T, -1).amax(1).tolist()}')
        if name == 'served':
            centers, valid, decoded = cp, vp, ip

    def topk_library():
        x = torch.where(center >= 0.1, center, -1.0)
        pooled = F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]
        scores = torch.where((x == pooled) & (x > 0), x, -float('inf')).view(T, -1)
        return torch.topk(scores, 100)

    nbytes = center.numel() * 4 + T * 100 * 9
    rec['instance_centers'] = dict(
        max_abs_err=0.0, ms=kernel_ms(lambda: find_instance_centers(center), ['centers_kernel']),
        call_ms=time_ms(lambda: find_instance_centers(center)),
        plain_ms=time_ms(lambda: find_instance_centers_plain(center)),
        library_ms=time_ms(topk_library), bytes=nbytes, flops=10.0 * center.numel())

    def argmin_library():
        px = torch.arange(H, device=device, dtype=torch.float32)[:, None] + offset[..., 0]
        py = torch.arange(W, device=device, dtype=torch.float32)[None, :] + offset[..., 1]
        d = ((centers[:, :, 0, None, None] - px[:, None]) ** 2
             + (centers[:, :, 1, None, None] - py[:, None]) ** 2)
        return torch.where(valid[:, :, None, None], d, float('inf')).argmin(dim=1)

    fg = (seg.argmax(-1) == 1) & valid.any(1)[:, None, None]
    pair_ops = 5.0 * float((fg.reshape(T, -1).sum(1) * valid.sum(1)).sum())
    nbytes = offset.numel() * 4 + seg.numel() * 4 + centers.numel() * 4 + valid.numel() \
        + T * H * W * 4
    rec['group_pixels'] = dict(
        max_abs_err=0.0, ms=kernel_ms(lambda: instance_ids(centers, valid, offset, seg),
                                      ['assign_kernel', 'relabel_kernel']),
        call_ms=time_ms(lambda: instance_ids(centers, valid, offset, seg)),
        plain_ms=time_ms(lambda: instance_ids_plain(centers, valid, offset, seg)),
        library_ms=time_ms(argmin_library), bytes=nbytes, flops=pair_ops)

    # K8: one tracking step's two calls, on the served ids and flow
    prev = decoded[:1].contiguous()
    flow = out['instance_flow'][:, 0].contiguous()
    cur = decoded[1:2].contiguous()
    calls = [(prev, T * 100 + 1, flow), (cur, 101, None)]
    err, parts = 0.0, []
    for labels, slots, f in calls:
        ck, vk = segment_centroids(labels, slots, f)
        cp, vp = segment_centroids_plain(labels, slots, f)
        torch.cuda.synchronize()
        diff = (ck - cp).abs()
        if not torch.equal(vk, vp) or bool((diff > ulp32(cp)).any()):
            raise AssertionError(f'segment_centroids ({slots} slots): kernel differs from '
                                 f'plain by more than one f32 ulp (max {float(diff.max())})')
        err = max(err, float(diff.max()))
        rows = labels.reshape(-1).long()
        vals = torch.ones((rows.numel(), 3), dtype=torch.float64, device=device)

        def library(rows=rows, vals=vals, slots=slots):
            return torch.zeros((slots, 3), dtype=torch.float64, device=device).index_add_(
                0, rows, vals)

        nb = labels.numel() * 4 + (0 if f is None else f.numel() * 4) + slots * 9
        parts.append(dict(
            ms=kernel_ms(lambda: segment_centroids(labels, slots, f), ['centroid_kernel']),
            call_ms=time_ms(lambda: segment_centroids(labels, slots, f)),
            plain_ms=time_ms(lambda: segment_centroids_plain(labels, slots, f)),
            library_ms=time_ms(library),
            bound=bound(nb, labels.numel() * (3.0 + (2.0 if f is not None else 0.0)),
                        F64_FLOPS_PER_S)))
    log(f'  segment_centroids: within one f32 ulp of plain (max abs err {err:.3e}); '
        f'previous frame (501 slots, flow) {parts[0]}, current (101 slots) {parts[1]}')
    # the tracker launches it as often for each kind: report the mean of the two
    rec['segment_centroids'] = dict(
        max_abs_err=err, **{k: (parts[0][k] + parts[1][k]) / 2
                            for k in ('ms', 'call_ms', 'plain_ms', 'library_ms')},
        bound_pair=(parts[0]['bound'], parts[1]['bound']))

    # K9
    n_rows = [1, 8, 101]
    cost = torch.from_numpy(tracker_costs(n_rows, seed=5)).to(device)
    rows_t = torch.tensor(n_rows, dtype=torch.int32, device=device)
    got = linear_sum_assignment(cost, rows_t)
    want = linear_sum_assignment_plain(cost, rows_t)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError('lap: kernel col4row != plain')
    cost_np = cost.cpu().numpy().astype(np.float64)
    for b, n in enumerate(n_rows):
        col = got[b].cpu().numpy()
        live = np.arange(1, n)
        picked = cost_np[b, live, col[live]]
        total = picked[picked < 1e4].sum()        # rows beyond 60 take padding columns
        r, c = scipy.optimize.linear_sum_assignment(cost_np[b, 1:n, 1:61])
        if abs(total - cost_np[b, 1:n, 1:61][r, c].sum()) > 1e-3 or (col[n:] != -1).any():
            raise AssertionError(f'lap n_rows={n}: total {total} is not the optimum '
                                 f'{cost_np[b, 1:n, 1:61][r, c].sum()}')
    log('  lap: equal to plain for n_rows 1, 8, 101; totals within 1e-3 of scipy')
    full, full_rows = cost[2:].contiguous(), rows_t[2:].contiguous()
    linear_sum_assignment_plain(full, full_rows)
    steps = linear_sum_assignment_plain.steps
    host = cost_np[2]

    def scipy_once():
        t0 = time.perf_counter()
        scipy.optimize.linear_sum_assignment(host)
        return 1e3 * (time.perf_counter() - t0)

    scipy_ms = statistics.median(scipy_once() for _ in range(REPS))
    rec['lap'] = dict(
        max_abs_err=0.0, ms=kernel_ms(lambda: linear_sum_assignment(full, full_rows),
                                      ['lap_kernel']),
        call_ms=time_ms(lambda: linear_sum_assignment(full, full_rows)),
        plain_ms=time_ms(lambda: linear_sum_assignment_plain(full, full_rows), reps=3,
                         warmup=1),
        library_ms=None, scipy_ms=scipy_ms, bytes=full.numel() * 4 + 4 + 101 * 4,
        flops=3.0 * 101 * steps, steps=steps)

    for name, r in rec.items():
        if 'bound_pair' in r:
            (b0, by0), (b1, by1) = r.pop('bound_pair')
            r['bound_ms'], r['bound_by'] = (b0 + b1) / 2, by0 if b0 >= b1 else by1
        else:
            r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['flops'])
        log(f'  {name}: ' + json.dumps({k: v for k, v in r.items() if k != 'max_abs_err'}))
    return rec


def planted_scene(device, T=5, H=200, W=200, n=20, seed=6):
    """A network output dict of n vehicles (5 x 3 px boxes) moving at seeded integer
    velocities: the centre heatmap peaks at each box centre, offsets point at it,
    the flow carries each box to the next frame. Returns (output, gt ids (1, T, H, W))."""
    rng = np.random.RandomState(seed)
    bh, bw = 5, 3
    paths = []
    while len(paths) < n:
        p, v = rng.randint(10, H - 10 - bh, 2), rng.randint(-3, 4, 2)
        path = np.stack([p + v * t for t in range(T)])
        if path.min() < 2 or (path + [bh, bw]).max() > min(H, W) - 2:
            continue
        if all(np.abs(path - q).max(1).min() >= 10 for q in paths):
            paths.append(path)
    gt = np.zeros((1, T, H, W), np.int64)
    seg = np.zeros((1, T, H, W, 2), np.float32)
    seg[..., 0] = 4.0
    center = np.zeros((1, T, H, W, 1), np.float32)
    offset = np.zeros((1, T, H, W, 2), np.float32)
    flow = np.zeros((1, T, H, W, 2), np.float32)
    x, y = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing='ij')
    for k, path in enumerate(paths, start=1):
        for t, (r, c) in enumerate(path):
            box = (0, t, slice(r, r + bh), slice(c, c + bw))
            cr, cc = r + bh // 2, c + bw // 2
            gt[box] = k
            seg[box] = [0.0, 4.0]
            center[0, t, ..., 0] = np.maximum(
                center[0, t, ..., 0], np.exp(-((x - cr) ** 2 + (y - cc) ** 2) / 2.0))
            offset[box + (0,)] = cr - x[r:r + bh, c:c + bw]
            offset[box + (1,)] = cc - y[r:r + bh, c:c + bw]
            flow[box] = path[1] - path[0]      # the box's constant velocity
    output = {k: torch.from_numpy(v).to(device) for k, v in
              (('segmentation', seg), ('instance_center', center),
               ('instance_offset', offset), ('instance_flow', flow))}
    return output, gt


def phase_planted_scene(device):
    """Both trackers must follow the 20 planted vehicles: one id per vehicle over
    all frames, background 0, vehicle PQ = 1."""
    output, gt = planted_scene(device)
    ids = device_consistent(output).cpu().numpy()
    n = int(gt.max())
    per_vehicle = [np.unique(ids[gt == k]) for k in range(1, n + 1)]
    if (any(len(v) != 1 or v[0] == 0 for v in per_vehicle)
            or len({int(v[0]) for v in per_vehicle}) != n or (ids[gt == 0] != 0).any()):
        raise AssertionError(f'planted scene: tracks {per_vehicle} do not follow the '
                             f'{n} vehicles')
    metric = PanopticMetric(n_classes=2)
    metric.update(ids, gt)
    pq = float(metric.compute()['pq'][1])
    if abs(pq - 1.0) > 1e-12:
        raise AssertionError(f'planted scene: vehicle PQ {pq} != 1')
    host = predict_instance_segmentation_and_trajectories(output)
    if not np.array_equal(host, ids):
        raise AssertionError(f'planted scene: host ids differ at {int((host != ids).sum())} '
                             'pixels')
    log(f'planted scene: {n} vehicles tracked over {gt.shape[1]} frames by the device and '
        f'the host tracker alike, vehicle PQ {pq}')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        sys.exit(1)
    device = torch.device('cuda')
    log(smi_line())
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    _build.build_all()
    log(f'build: {time.perf_counter() - t0:.1f} s for {_build.kernel_names()}')

    # the serve first, so that its request times come before torch.profiler (which
    # times the kernels below) has hooked into the process
    t0 = time.perf_counter()
    launches, outputs = phase_serve()
    log(f'full-width serve: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    pool = phase_bev_pool(device)
    warp = phase_bev_warp(device)
    log(f'kernels vs plain: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    phase_tiny_card_vs_cpu()
    log(f'tiny card vs cpu: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    decode = phase_decode_kernels(device, outputs)
    log(f'decode kernels vs plain: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    phase_planted_scene(device)
    log(f'planted scene: ok ({time.perf_counter() - t0:.1f} s)')

    records = {'bev_pool': pool[torch.bfloat16], 'bev_warp': warp[torch.bfloat16], **decode}
    kernels = []
    for name, source, replaces in [
            ('bev_pool', 'bev_pool.cu', 'fiery_tpu/ops/lift_splat.py:104'),
            ('bev_warp', 'bev_warp.cu', 'fiery_tpu/ops/warp.py:71'),
            ('instance_centers', 'instance_centers.cu', 'fiery_tpu/postprocess/instance.py:73'),
            ('group_pixels', 'group_pixels.cu', 'fiery_tpu/postprocess/instance.py:98'),
            ('segment_centroids', 'segment_centroids.cu',
             'fiery_tpu/postprocess/instance.py:324'),
            ('lap', 'lap.cu', 'fiery_tpu/ops/lap.py:23')]:
        r = records[name]      # bev_pool and bev_warp: bf16, the serve path's dtype
        entry = {'name': name, 'route': 'cuda', 'source': 'fiery_tpu_torch/csrc/' + source,
                 'replaces': replaces, 'launches': launches[name],
                 'max_abs_err': r['max_abs_err'], 'ms': r['ms'], 'plain_ms': r['plain_ms'],
                 'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
                 'library_ms': r['library_ms']}
        entry['call_ms'] = r['call_ms']
        if 'scipy_ms' in r:
            entry['scipy_ms'] = r['scipy_ms']
        kernels.append(entry)
    log(json.dumps({'kernels': kernels}))
    log(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
