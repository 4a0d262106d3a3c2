"""Smoke run of fiery_tpu_torch on one CUDA card: python3 chip_smoke.py

Builds the package's CUDA kernels from csrc/, then:
  1. holds each kernel against its plain PyTorch version at the baseline serve
     shapes, in f32 and in bf16, and times kernel, plain version and library call;
  2. runs a tiny config on the card and on the CPU with the same seeded weights
     and request, and compares every output;
  3. serves three seeded full-width baseline.yml requests (PRECISION 16, random
     weights) and checks that both kernels ran on that path.
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
import torch

from fiery_tpu_torch.models.fiery import FieryConfig
from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.ops.lift_splat import (bev_pool, bev_pool_plain, create_frustum,
                                            get_geometry, voxel_ids)
from fiery_tpu_torch.ops.warp import bev_warp, bev_warp_plain
from fiery_tpu_torch.serve import (BASELINE, build_fiery, calibrate_batchnorm, init_params,
                                   make_request, predict)
from fiery_tpu_torch.utils.config import get_cfg

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor-core) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
REPS = 25


def log(*args):
    print(*args, flush=True)


def smi_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=REPS, warmup=3):
    """Median over reps of one call's device time (CUDA events), after warm-up."""
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
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        rec[dtype] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: bev_pool(depth, feat, ids, num_bins, z)),
            plain_ms=time_ms(lambda: bev_pool_plain(depth, feat, ids, num_bins, z)),
            library_ms=time_ms(library), bound_ms=bound,
            bound_by='bytes' if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
            else 'operations', bytes=nbytes, flops=flops)
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
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        rec[dtype] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: bev_warp(x, pose, spatial_extent)),
            plain_ms=time_ms(lambda: bev_warp_plain(x, pose, spatial_extent)),
            library_ms=time_ms(library), bound_ms=bound,
            bound_by='bytes' if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
            else 'operations', bytes=nbytes, flops=flops)
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
    """Full-width baseline.yml (PRECISION 16) at batch 1, seeded random weights."""
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
    predict(model, make_request(cfg, seed=9))           # warm-up (cuDNN plans, kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bev_pool.launches = bev_warp.launches = 0
    times, outputs = [], []
    for req in requests:
        t0 = time.perf_counter()
        out = predict(model, req)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        outputs.append(out)
    launches = {'bev_pool': bev_pool.launches, 'bev_warp': bev_warp.launches}
    peak = torch.cuda.max_memory_allocated()
    for out in outputs:
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != expected:
            raise AssertionError(f'output shapes {shapes} != {expected}')
        for k, v in out.items():
            if v.dtype != torch.float32 or not torch.isfinite(v).all():
                raise AssertionError(f'{k}: dtype {v.dtype} or non-finite values')
    for name, n in launches.items():
        if n != n_requests:
            raise AssertionError(f'{name} launched {n} times for {n_requests} requests')
    log(f'serve: request_ms={[round(t, 3) for t in times]} '
        f'median_ms={statistics.median(times):.3f} peak_mem_bytes={peak} '
        f'launches={launches}')
    return launches


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

    t0 = time.perf_counter()
    pool = phase_bev_pool(device)
    warp = phase_bev_warp(device)
    log(f'kernels vs plain: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    phase_tiny_card_vs_cpu()
    log(f'tiny card vs cpu: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    launches = phase_serve()
    log(f'full-width serve: ok ({time.perf_counter() - t0:.1f} s)')

    kernels = []
    for name, rec, source, replaces in [
            ('bev_pool', pool, 'fiery_tpu_torch/csrc/bev_pool.cu',
             'fiery_tpu/ops/lift_splat.py:104'),
            ('bev_warp', warp, 'fiery_tpu_torch/csrc/bev_warp.cu',
             'fiery_tpu/ops/warp.py:71')]:
        r = rec[torch.bfloat16]     # the serve path's dtype
        kernels.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': launches[name],
                        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'], 'library_ms': r['library_ms']})
    log(json.dumps({'kernels': kernels}))
    log(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
