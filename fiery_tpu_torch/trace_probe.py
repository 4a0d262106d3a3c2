"""Lost launches in torch.profiler's traces, and the training CLI's profiled window.

On the H100 the first launches of a trace can go unrecorded, more of them the more
work the process has done. ``trace_lead_in`` absorbs them with spin kernels, and
``TrainProfile`` (``python -m fiery_tpu_torch.train --profile-dir DIR``) opens its
window with it and counts K10's launches in the trace against the port's own
counters.

    python -m fiery_tpu_torch.trace_probe

measures whether torch.profiler keeps every launch of a window, after each thing
the training loop does and after work of other kinds. After each stage it takes
profiled windows of 25 calls of the BatchNorm kernel (K10, eval forward, 64
channels), one launch a call, each window opened by one of these lead-ins: none
('bare'), 8 spin kernels and a 2 ms pause ('spins8'), a 20 ms pause alone
('pause20ms'), and 64 spin kernels and a 2 ms pause ('spins64', the lead-in of
``trace_lead_in``). It prints one JSON line a stage: the launches each window held
(25 when whole), the threads alive, the device memory allocated. The stages, in
order: a fresh process; 200,000 launches of one elementwise kernel; threads
that each pin a small tensor and exit; pinned batches of 64 MB allocated, copied
with ``non_blocking=True`` and freed; ~200 distinct PyTorch kernels launched once
each (unary and binary ops over five dtypes); a cuDNN convolution and a cuBLAS
product, forward and backward, f32 and bf16; three full-width training steps on
one batch (baseline.yml, PRECISION 16, batch 3, the synthetic set; pageable
batches); ``train.main`` for two epochs of 3 steps (as ``chip_smoke.py``
``phase_train_loop``); the evaluation CLI with both trackers; then
``gc.collect()`` and the host and device caches emptied. Needs a CUDA card.
"""

import argparse
import gc
import json
import os
import shutil
import tempfile
import threading
import time

import torch

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.ops.batch_norm import (
    batch_norm_backward, batch_norm_backward_apply_card, batch_norm_backward_finalize_card,
    batch_norm_backward_partials_card, batch_norm_finalize_card, batch_norm_forward,
    batch_norm_partials_card)

WINDOWS = 4
CALLS = 25
# the wrappers that count K10's launches
K10_COUNTERS = (batch_norm_forward, batch_norm_backward, batch_norm_partials_card,
                batch_norm_finalize_card, batch_norm_backward_partials_card,
                batch_norm_backward_finalize_card, batch_norm_backward_apply_card)
# the training CLI's profiled window: the run's first step skipped, one step of
# warm-up, three recorded (a whole run's CUDA trace is too large to write or open)
TRAIN_SCHEDULE = dict(skip_first=1, wait=0, warmup=1, active=3, repeat=1)
# (spin kernels, pause in s) before a window's calls
LEAD_INS = {'bare': (0, 0.0), 'spins8': (8, 0.002), 'pause20ms': (0, 0.02),
            'spins64': (64, 0.002)}


def trace_lead_in(spins=64):
    """The first launches of a profiler trace can go unrecorded on the H100: none in
    a fresh process, more as the process runs the model (2 after three training
    steps, 4-5 after the training loop and evaluation, more after the phases of
    ``chip_smoke.py``), whatever the time since the trace began. Spin kernels, of
    no measured group, go first to absorb them: ``spins`` of them, then a pause. A
    trace that still holds one of them lost none of the launches after them."""
    for _ in range(spins):
        torch.cuda._sleep(10000)
    torch.cuda.synchronize()
    time.sleep(0.002)


def k10_launches():
    """K10's kernel launches that its wrappers have counted in this process, the
    synchronised path's included."""
    return sum(fn.launches for fn in K10_COUNTERS)


def k10_pass(key):
    """The K10 pass a kernel's name belongs to, or None: its kernels are templates
    in an anonymous namespace ("(anonymous namespace)::apply_kernel<..."), which
    keeps out other kernels whose names hold the same words (Adam's
    multi_tensor_apply_kernel). The synchronised path's finalize kernels
    ("::finalize_stats_kernel(", "::finalize_grads_kernel(") are no pass."""
    for name in ('backward_reduce', 'backward_apply', 'stats', 'apply'):
        if f'::{name}_kernel<' in key:
            return name
    return None


def k10_kernels_in(events):
    """K10's kernel launches in profiler key averages, its finalize kernels included."""
    return sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and (k10_pass(e.key) or '::finalize_stats_kernel(' in e.key
                    or '::finalize_grads_kernel(' in e.key))


class TrainProfile:
    """torch.profiler over ``TRAIN_SCHEDULE``'s window of a training run, written
    as one Chrome trace a rank, ``<directory>/rank<r>.pt.trace.json`` (Perfetto or
    chrome://tracing open it). Call ``step(s)`` after the run's training step s.
    On a CUDA device the window opens with ``trace_lead_in`` and ends with a
    synchronisation, and the trace's K10 launches are counted against K10's
    counters over the window. When the trace is written it prints one JSON line,
    on every rank: the path, the run's steps in the window, and both counts (a
    short trace is reported, not an error). ``record`` holds the same."""

    def __init__(self, directory, rank, device):
        self.path = os.path.join(directory, f'rank{rank}.pt.trace.json')
        self.rank, self.cuda = rank, torch.device(device).type == 'cuda'
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=activities, schedule=torch.profiler.schedule(**TRAIN_SCHEDULE),
            on_trace_ready=self._ready)
        self.steps, self.counted_from, self.record = [], None, None

    def __enter__(self):
        os.makedirs(os.path.dirname(self.path) or '.', exist_ok=True)
        self.prof.__enter__()
        return self

    def _recording(self):
        return self.prof.current_action in (torch.profiler.ProfilerAction.RECORD,
                                            torch.profiler.ProfilerAction.RECORD_AND_SAVE)

    def step(self, step):
        recording = self._recording()
        if recording:
            self.steps.append(step)
            if self.cuda:
                torch.cuda.synchronize()
        self.prof.step()
        if not recording and self._recording():
            # the window opens
            if self.cuda:
                trace_lead_in()
            self.counted_from = k10_launches()

    def _ready(self, prof):
        prof.export_chrome_trace(self.path)
        counted = k10_launches() - self.counted_from
        traced = k10_kernels_in(prof.key_averages()) if self.cuda else 0
        self.record = {'profile_trace': self.path, 'rank': self.rank, 'steps': self.steps,
                       'k10_launches': {'trace': traced, 'counted': counted,
                                        'whole': traced == counted}}
        print(json.dumps(self.record), flush=True)

    def __exit__(self, *exc):
        if self.cuda and self._recording():
            torch.cuda.synchronize()
        return self.prof.__exit__(*exc)


def launches_in_window(fn, spins, pause):
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(spins):
            torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        time.sleep(pause)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not any(s in e.key for s in ('spin', 'sleep', 'Memcpy', 'Memset')))


def probe(stage, device):
    bn_x = torch.randn((3, 64, 50, 50), device=device, dtype=torch.bfloat16).to(
        memory_format=torch.channels_last)
    w, b = torch.ones(64, device=device), torch.zeros(64, device=device)
    rm, rv = torch.zeros(64, device=device), torch.ones(64, device=device)
    windows = {name: [launches_in_window(
        lambda: batch_norm_forward(bn_x, w, b, rm, rv, False, 0.1, 1e-5), *lead)
        for _ in range(WINDOWS)] for name, lead in LEAD_INS.items()}
    print(json.dumps({'stage': stage, 'windows': windows,
                      'threads': sorted(t.name for t in threading.enumerate()),
                      'device_allocated_bytes': torch.cuda.memory_allocated()}), flush=True)


def distinct_kernels(device):
    """Launch each of ~200 distinct PyTorch kernels once; returns how many calls."""
    n = 0
    for dtype in (torch.float32, torch.float16, torch.bfloat16, torch.float64, torch.int32):
        x = torch.arange(1, 4097, device=device).to(dtype)
        for op in ('neg', 'abs', 'sign', 'square', 'sqrt', 'exp', 'log', 'sin', 'cos',
                   'tanh', 'sigmoid', 'floor', 'ceil', 'round', 'reciprocal', 'rsqrt',
                   'erf', 'log1p', 'expm1', 'relu', 'cumsum', 'sum', 'amax', 'argmax',
                   'sort', 'flip', 'clone', 'mean', 'prod', 'logsumexp'):
            try:
                getattr(torch, op)(x) if op not in ('cumsum', 'flip', 'logsumexp') else (
                    getattr(torch, op)(x, 0) if op != 'flip' else torch.flip(x, (0,)))
                n += 1
            except RuntimeError:
                pass
        for op in ('add', 'sub', 'mul', 'maximum', 'minimum', 'eq', 'lt', 'remainder',
                   'atan2', 'pow', 'fmod', 'hypot'):
            try:
                getattr(torch, op)(x, x.flip(0))
                n += 1
            except RuntimeError:
                pass
    torch.cuda.synchronize()
    return n


def libraries(device):
    """A convolution (cuDNN) and a matrix product (cuBLAS), forward and backward, in
    f32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((3, 64, 56, 120), device=device, dtype=dtype,
                        requires_grad=True).to(memory_format=torch.channels_last)
        conv = torch.nn.Conv2d(64, 64, 3, padding=1).to(device, dtype).to(
            memory_format=torch.channels_last)
        conv(x).sum().backward()
        a = torch.randn((512, 512), device=device, dtype=dtype, requires_grad=True)
        (a @ a).sum().backward()
    torch.cuda.synchronize()


def main(argv=None):
    import chip_smoke as cs
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('trace_probe needs a CUDA card')
    from fiery_tpu_torch import evaluate as evaluate_cli
    from fiery_tpu_torch import train as train_cli
    from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
    from fiery_tpu_torch.serve import BASELINE, init_params
    from fiery_tpu_torch.training.trainer import Trainer, step_generator
    from fiery_tpu_torch.utils.config import get_cfg
    device = torch.device('cuda')
    print(cs.smi_line(), flush=True)
    _build.build_all()
    probe('fresh', device)
    x = torch.ones((1 << 10,), device=device)
    for _ in range(200_000):
        x.mul_(1.0)
    torch.cuda.synchronize()
    probe('200,000 launches of one elementwise kernel', device)

    log_dir = tempfile.mkdtemp(prefix='fiery_trace_probe_')
    opts = ['DATASET.NAME', 'synthetic', 'DATASET.N_SYNTHETIC_SAMPLES', '9',
            'LOGGING_INTERVAL', '1', 'LOG_DIR', log_dir]
    try:
        def pin_small():
            torch.empty(1024, pin_memory=True)
        threads = [threading.Thread(target=pin_small) for _ in range(30)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        probe('30 threads that pinned a tensor and exited', device)

        for _ in range(8):
            host = torch.empty(64 << 20, dtype=torch.uint8, pin_memory=True)
            on_card = host.to(device, non_blocking=True)
            torch.cuda.synchronize()
            del host, on_card
        probe('8 pinned batches of 64 MB, copied non_blocking and freed', device)
        n = distinct_kernels(device)
        probe(f'{n} distinct PyTorch kernels launched once each', device)
        libraries(device)
        probe('cuDNN convolutions and cuBLAS products, forward and backward', device)

        cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=opts))
        trainer = Trainer(cfg, device=device)
        init_params(trainer.model, seed=0)
        train_loader, _ = prepare_dataloaders(cfg)
        batch = numeric_batch(train_loader.peek())
        for _ in range(3):
            trainer.train_step(batch, step_generator(0, trainer.step, device))
        torch.cuda.synchronize()
        del trainer
        probe('three training steps, pageable batches', device)

        run = train_cli.main(['--config', BASELINE, *opts, 'EPOCHS', '2'])
        final = f'{run.save_dir}/checkpoint_final'
        del run
        probe('train.main, two epochs', device)

        for extra in ([], ['--device-matching']):
            evaluate_cli.main(['--checkpoint', final, '--max-batches', '2', *extra])
        probe('evaluate, both trackers', device)

        gc.collect()
        if hasattr(torch._C, '_host_emptyCache'):
            torch._C._host_emptyCache()
        torch.cuda.empty_cache()
        probe('gc.collect, host and device caches emptied', device)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


if __name__ == '__main__':
    main()
