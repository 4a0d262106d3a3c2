"""Where the pixel grouping's time goes, by phase: python -m fiery_tpu_torch.group_stages

Builds a copy of the pixel grouping kernel (K7, csrc/group_pixels.cu) in which
thread 0 of every block reads the card's global timer at the end of each phase,
and runs it on 5 frames of 200 x 200 with 100 centre slots from K6: the heads of
the served request of ``chip_smoke.py`` (baseline.yml, seeded random weights,
BatchNorm calibrated), uniform random heatmaps (offsets of 4 pixels' spread,
random 2-class logits), and the same with every centre moved into the top 32 rows
(the band random weights give). For each it prints one JSON line: the call's
device ms (CUDA events around 50 calls, after warm-up), each phase's µs (the most
and the mean over the blocks), whether the ids equal the plain version's, the
foreground pixels and the walk's axis. Phases: the foreground list (with the
centres' reads), the centres ordered, the nearest centres, the cluster barrier
(the wait for the cluster's slowest block), the ranks, the ids written. Needs a
CUDA card.
"""

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.postprocess import instance as I

PHASES = ('foreground list', 'centres ordered', 'nearest centres', 'cluster barrier',
          'ranks', 'ids written')
# the stamps: after each marker of the source (thread 0 of a block, the global timer)
_MARKS = [
    ('  // every block of the cluster runs before another writes to its inbox: arrive',
     0, True),
    ('  // 2. the valid centres, compacted', 1, True),
    ('  // 3. each foreground pixel\'s nearest', 2, True),
    ('  // 4. every block\'s bitmap', 3, True),
    ('  cluster.sync();   // every block\'s bitmap is in every inbox\n', 4, False),
    ('  // 5. the block\'s relabelled ids', 5, True),
]


def _stamp(i):
    return ('  if (threadIdx.x == 0) { unsigned long long t_; asm volatile('
            '"mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
            f'g_stamps[blockIdx.x * 8 + {i}] = t_; }}\n')


def stamped_source():
    """csrc/group_pixels.cu with the phase stamps and fiery_group_stamps(ptr)."""
    with open(os.path.join(_build.CSRC, 'group_pixels.cu')) as f:
        src = f.read()
    src = src.replace('namespace {\n', 'namespace {\n__device__ unsigned long long* g_stamps;\n',
                      1)
    for marker, i, before in _MARKS:
        if marker not in src:
            raise RuntimeError(f'group_stages: marker {marker.strip()!r} not in the source')
        src = src.replace(marker, _stamp(i) + marker if before else marker + _stamp(i))
    tail = '        (int)s_before[wd] + __popc(s_or[wd] & ((2u << (id & 31)) - 1u)) - 1;\n  }\n'
    if tail not in src:
        raise RuntimeError('group_stages: the kernel\'s last store is not in the source')
    src = src.replace(tail, tail + '  __syncthreads();\n' + _stamp(6))
    return src + ('\nextern "C" int fiery_group_stamps(void* p) {\n'
                  '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n')


def build():
    """The stamped copy, compiled beside the package's kernels and loaded."""
    os.makedirs(_build.BUILD, exist_ok=True)
    cu = os.path.join(_build.BUILD, 'group_pixels_stamped.cu')
    so = os.path.join(_build.BUILD, 'libgroup_pixels_stamped.so')
    with open(cu, 'w') as f:
        f.write(stamped_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', so, cu], check=True)
    lib = ctypes.CDLL(so)
    lib.fiery_group_pixels.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.fiery_group_stamps.argtypes = [ctypes.c_void_p]
    return lib


def served_heads(device):
    """The first served request's heads, as chip_smoke.py's serve phase makes them."""
    from fiery_tpu_torch.serve import (BASELINE, build_fiery, calibrate_batchnorm,
                                       init_params, make_request, predict)
    from fiery_tpu_torch.utils.config import get_cfg
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=[]))
    model = init_params(build_fiery(cfg), seed=0)
    calibrate_batchnorm(model, [make_request(cfg, seed=s) for s in (6, 7)])
    out = predict(model, make_request(cfg, seed=10))
    T, H, W = out['segmentation'].shape[1:4]
    return (out['instance_center'].reshape(T, H, W).contiguous(),
            out['instance_offset'].reshape(T, H, W, 2).contiguous(),
            out['segmentation'].reshape(T, H, W, -1).contiguous())


def cases(device):
    g = torch.Generator(device=device).manual_seed(0)
    heat = torch.rand((5, 200, 200), generator=g, device=device)
    offset = torch.randn((5, 200, 200, 2), generator=g, device=device) * 4.0
    seg = torch.randn((5, 200, 200, 2), generator=g, device=device)
    centers, valid = I.find_instance_centers(heat)
    band = centers.clone()
    band[..., 0] = band[..., 0] % 32
    center, s_off, s_seg = served_heads(device)
    s_centers, s_valid = I.find_instance_centers(center)
    return {'served': (s_centers, s_valid, s_off, s_seg),
            'uniform': (centers, valid, offset, seg),
            'band of rows': (band, valid, offset, seg)}


def main():
    import chip_smoke as cs   # the repository root's measurement helpers
    if not torch.cuda.is_available():
        raise SystemExit('group_stages needs a CUDA card')
    _build.build_all(['group_pixels', 'instance_centers'])
    device = torch.device('cuda')
    lib = build()
    print(cs.smi_line(), flush=True)
    for name, (centers, valid, offset, seg) in cases(device).items():
        B, K = valid.shape
        h, w = offset.shape[1:3]
        stamps = torch.zeros((B * 16, 8), dtype=torch.int64, device=device)
        if lib.fiery_group_stamps(stamps.data_ptr()) != 0:
            raise RuntimeError('group_stages: could not set the stamp buffer')
        ids = torch.empty((B, h, w), dtype=torch.int32, device=device)

        def call():
            rc = lib.fiery_group_pixels(centers.data_ptr(), valid.data_ptr(), offset.data_ptr(),
                                        seg.data_ptr(), ids.data_ptr(), B, h, w, K,
                                        seg.shape[-1], 1, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f'group_stages: launch failed, CUDA error {rc}')

        ms = cs.time_ms(lambda: [call() for _ in range(50)]) / 50
        call()
        torch.cuda.synchronize()
        equal = bool(torch.equal(ids, I.instance_ids_plain(centers, valid, offset, seg)))
        s = stamps[:, :7].cpu().numpy().astype(np.float64)
        s = s[s[:, 0] > 0]
        us = np.diff(s, axis=1) / 1e3
        box = centers.float().amax(1) - centers.float().amin(1)
        fg = (seg.argmax(-1) == 1).reshape(B, -1).sum(1)
        print(json.dumps({
            'case': name, 'ms': ms, 'equal': equal,
            'phase_us_most': dict(zip(PHASES, us.max(0).round(2).tolist())),
            'phase_us_mean': dict(zip(PHASES, us.mean(0).round(2).tolist())),
            'span_us': round((s[:, 6].max() - s[:, 0].min()) / 1e3, 2),
            'foreground_px': fg.tolist(),
            'walk_axis': ['rows' if b[0] >= b[1] else 'columns' for b in box.tolist()]}),
            flush=True)


if __name__ == '__main__':
    main()
