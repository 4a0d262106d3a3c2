"""Training entry point (counterpart of train.py at the repository root).

    python -m fiery_tpu_torch.train --config fiery_tpu_torch/configs/baseline.yml \
        DATASET.NAME synthetic EPOCHS 1 [--resume auto] [--steps N] [--device cpu]

Trailing KEY VALUE pairs override the config, the levers included, e.g. the
sparse, warp-free combination with host-warped labels:

    python -m fiery_tpu_torch.train --config fiery_tpu_torch/configs/baseline.yml \
        DATASET.NAME synthetic LIFT.TOPK 8 LIFT.WARP_FREE True DATASET.PREWARP_LABELS True

The loop of the JAX package's: epochs of the train loader (``data/dataset.py``:
shuffled, drop_last, batches pinned for the card and made, with the label prewarp
of DATASET.PREWARP_LABELS, off the thread that runs the steps); every
LOGGING_INTERVAL steps (and at step 1) the losses as scalars; every VIS_INTERVAL
steps the ground truth against the prediction on the step's batch as a video
(``utils/visualisation.visualise_output``); after each epoch a validation (IoU
accumulated on the device, VPQ from the host tracker, the uncertainty weights,
the video of the first val batch) and an asynchronous checkpoint
``checkpoint_epochN``; at the end ``checkpoint_final``. Scalars go to
``<run>/metrics.jsonl`` (one ``{"step": s, key: value}`` a line, the JAX loop's
keys) and videos to ``<run>/videos/<key>_step<s>.gif`` (``train_outputs``,
``val_outputs``), both to TensorBoard too when ``torch.utils.tensorboard``
imports. The run directory is ``LOG_DIR/<date>_<host>_<TAG>``.

The real sets train with ``DATASET.NAME nuscenes DATASET.VERSION mini
DATASET.DATAROOT <tree>`` (or ``DATASET.NAME lyft DATASET.DATAROOT <tree>``), e.g.
on a tree of ``python -m fiery_tpu_torch.data.fake_nuscenes``.

``--resume DIR|auto`` continues from a checkpoint (``auto``: the newest complete
one under LOG_DIR, or a fresh start when there is none) at epoch step // (steps
an epoch). PRETRAINED.LOAD_WEIGHTS with PRETRAINED.PATH warm-starts a fresh run.
Weights start seeded random (He normal, ``--seed``). Each step draws its noise
and drop-connect masks from a generator seeded by (seed, step), so that k steps,
a checkpoint and a resume draw what an uninterrupted run does. Under
LIFT.DEPTH_CULL the kept depth planes come from a first look at the train loader.
``--steps N`` ends the run after global step N (then only ``checkpoint_final``).
It runs on the CUDA card unless given --device cpu.

Data-parallel over several processes (parallel/mesh.py), one card each:

    python -m torch.distributed.run --nproc_per_node N -m fiery_tpu_torch.train \
        --config fiery_tpu_torch/configs/baseline.yml DATASET.NAME synthetic

BATCHSIZE is per rank (the global batch is BATCHSIZE x N), each rank reads its
shard of every epoch, the BatchNorm statistics and the masked losses are global,
the ranks' DEPTH_CULL keeps are the maximum of theirs, and the validation sums the
ranks' metric states. Only rank 0 prints, logs, writes videos and saves
checkpoints; every rank resumes from the checkpoint rank 0 finds, behind a
barrier. On the CPU (``--device cpu``) the ranks use gloo.
"""

import argparse
import io
import json
import os
import socket
import time
import types

import numpy as np
import torch
import torch.distributed as dist

from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
from fiery_tpu_torch.evaluate import update_metrics
from fiery_tpu_torch.ops.lift_splat import compute_depth_plane_keep, create_frustum
from fiery_tpu_torch.parallel.mesh import (make_parallel_trainer, max_across_ranks,
                                           maybe_initialize_distributed, rank_and_world,
                                           sum_states)
from fiery_tpu_torch.serve import init_params
from fiery_tpu_torch.training.metrics import IntersectionOverUnion, PanopticMetric
from fiery_tpu_torch.training.trainer import Trainer, step_generator
from fiery_tpu_torch.utils.checkpoint import (find_latest_checkpoint, load_checkpoint,
                                              load_pretrained_params, save_checkpoint,
                                              save_checkpoint_async, wait_for_async_save)
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.geometry import calculate_birds_eye_view_parameters
from fiery_tpu_torch.utils.visualisation import visualise_output


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', dest='config_file', required=True)
    p.add_argument('--resume', default='',
                   help="a checkpoint dir, a run dir (its latest checkpoint), or 'auto' "
                        '(the newest complete checkpoint under LOG_DIR)')
    p.add_argument('--steps', type=int, default=None,
                   help='end the run after this global step')
    p.add_argument('--seed', type=int, default=0,
                   help="the seeded weights and the steps' random stream")
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    p.add_argument('opts', nargs=argparse.REMAINDER, help='KEY VALUE config overrides')
    return p.parse_args(argv)


class MetricLogger:
    """Scalars as a JSONL mirror and videos as GIFs, and both to TensorBoard when it
    imports."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self.video_dir = os.path.join(log_dir, 'videos')
        self.jsonl = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir)
        except ImportError:
            self.tb = None

    def scalar(self, key, value, step):
        self.jsonl.write(json.dumps({'step': int(step), key: float(value)}) + '\n')
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalar(key, float(value), step)

    def video(self, key, frames, step):
        """frames: (1, T, H, W, 3) uint8. Written as an animated GIF (a frame each
        500 ms, looping) to ``<run>/videos/<key>_step<step>.gif``, and as the same
        GIF in a TensorBoard image summary, which its images tab plays (GIF merges
        equal consecutive frames). Returns {'key', 'step', 'path', 'shape'}, the
        frames' shape."""
        from PIL import Image
        frames = np.asarray(frames)
        imgs = [Image.fromarray(frame) for frame in frames[0]]
        buf = io.BytesIO()
        imgs[0].save(buf, format='GIF', save_all=True, append_images=imgs[1:],
                     duration=500, loop=0)
        os.makedirs(self.video_dir, exist_ok=True)
        path = os.path.join(self.video_dir, f'{key}_step{step}.gif')
        with open(path, 'wb') as f:
            f.write(buf.getvalue())
        if self.tb is not None:
            from tensorboard.compat.proto.summary_pb2 import Summary
            image = Summary.Image(height=frames.shape[2], width=frames.shape[3],
                                  colorspace=3, encoded_image_string=buf.getvalue())
            self.tb._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=key, image=image)]), step)
        return {'key': key, 'step': step, 'path': path, 'shape': frames.shape}

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def depth_plane_keep(cfg, batch):
    """The per-camera kept depth-plane counts of LIFT.DEPTH_CULL, from the
    calibrations of a batch."""
    frustum = create_frustum(cfg.IMAGE.FINAL_DIM, cfg.MODEL.ENCODER.DOWNSAMPLE,
                             cfg.LIFT.D_BOUND)
    res, start, dim = calculate_birds_eye_view_parameters(
        cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
    return compute_depth_plane_keep(
        frustum, np.asarray(batch['intrinsics']), np.asarray(batch['extrinsics']),
        res, start, dim, t_margin=cfg.LIFT.CULL_T_MARGIN,
        rot_margin_deg=cfg.LIFT.CULL_ROT_MARGIN)


def new_run_dir(cfg):
    base = os.path.join(cfg.LOG_DIR, time.strftime('%d%B%Y_%H%M%S') + '_'
                        + socket.gethostname() + '_' + cfg.TAG)
    path, n = base, 0
    while os.path.exists(path):
        n += 1
        path = f'{base}_{n}'
    return path


def validate(trainer, valloader, on_first=None):
    """One pass over the val loader: IoU of each class over the whole grid
    (accumulated on the device) and the vehicles' VPQ from the host tracker.
    ``on_first(output, labels)`` is called with the first batch's. Data-parallel,
    each rank passes over its shard and the ranks' states are summed before the
    scores (``sum_states``)."""
    n_classes = trainer.model.cfg.n_classes
    X, Y = trainer.model.cfg.bev_size
    whole = {'whole': ((0, X), (0, Y))}
    panoptic = {'whole': PanopticMetric(n_classes)}
    iou_states = torch.zeros((1, 4, n_classes), dtype=torch.float32, device=trainer.device)
    for i, batch in enumerate(valloader):
        output, labels, _ = trainer.eval_step(numeric_batch(batch))
        if i == 0 and on_first is not None:
            on_first(output, labels)
        iou_states = update_metrics(output, labels, iou_states, panoptic, whole, n_classes,
                                    device_matching=False)
    iou = IntersectionOverUnion(n_classes)
    iou_state = iou_states[0].cpu().numpy().astype(np.float64)
    if trainer.group is not None:
        iou_state = sum_states(iou_state, trainer.group)
        panoptic['whole'].load_state(sum_states(panoptic['whole'].state(), trainer.group))
    iou.load_state(iou_state)
    return iou.compute(), panoptic['whole'].compute()['pq'][1]


def _from_rank_0(value):
    """Rank 0's value on every rank (a path, say)."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def main(argv=None):
    """Train; returns the run: ``trainer``, ``save_dir``, ``steps``, a record per
    step of this run (step, ms waiting on the loader, ms from the batch to the end
    of the step's logging, ms of its video or None, host clock), ``videos``, what
    ``MetricLogger.video`` returned for each video written, and ``loaders``, the train and val loaders (their
    decode counts and transform times)."""
    args = parse_args(argv)
    cfg = get_cfg(args)
    device = maybe_initialize_distributed(args.device)
    rank, world = rank_and_world()
    trainloader, valloader = prepare_dataloaders(cfg, device=device, process_index=rank,
                                                 process_count=world)
    steps_max, steps_min = max_across_ranks([len(trainloader), -len(trainloader)])
    if steps_max != -steps_min:
        raise ValueError(f'the ranks\' shards give {-steps_min} to {steps_max} batches an '
                         f'epoch: N_SYNTHETIC_SAMPLES (or the split) must shard evenly')
    log = print if rank == 0 else (lambda *a, **k: None)

    depth_keep = None
    if cfg.LIFT.DEPTH_CULL:
        peek = trainloader.peek()
        if peek is None:
            raise ValueError('empty training dataset')
        # every rank culls with the largest keep of any rank's first batch
        depth_keep = max_across_ranks(depth_plane_keep(cfg, peek))
        log(json.dumps({'depth_keep': depth_keep}), flush=True)
    trainer = Trainer(cfg, depth_keep=depth_keep, device=device)
    init_params(trainer.model, seed=args.seed)

    save_dir = _from_rank_0(new_run_dir(cfg))
    logger = MetricLogger(save_dir) if rank == 0 else None
    log(f'Logging to {save_dir}; device {device}, batch {cfg.BATCHSIZE} x {world} '
        f'rank(s), {len(trainloader)} steps an epoch', flush=True)
    # the JAX loop takes a first batch here to initialise its state; the look
    # advances the loader's epoch counter, so that the epochs below shuffle as its do
    trainloader.peek()

    start_epoch = 0
    if args.resume:
        target = cfg.LOG_DIR if args.resume == 'auto' else args.resume
        if dist.is_initialized():
            dist.barrier()
        resolved = _from_rank_0(find_latest_checkpoint(target))
        if resolved is None:
            if args.resume != 'auto':
                raise SystemExit(f'--resume: no complete checkpoint at {target}')
            log(f'--resume auto: no checkpoint under {target}, starting fresh', flush=True)
        else:
            log(f'Resuming from {resolved}', flush=True)
            state, _ = load_checkpoint(resolved)
            trainer.load_state(state, strict=True)
            start_epoch = trainer.step // max(1, len(trainloader))
    elif cfg.PRETRAINED.LOAD_WEIGHTS and cfg.PRETRAINED.PATH:
        log(f'Warm-starting from {cfg.PRETRAINED.PATH}', flush=True)
        load_pretrained_params(cfg.PRETRAINED.PATH, trainer)
    if dist.is_initialized():
        make_parallel_trainer(trainer)

    run = types.SimpleNamespace(trainer=trainer, save_dir=save_dir, steps=[], videos=[],
                                loaders=(trainloader, valloader))
    capped = False
    for epoch in range(start_epoch, cfg.EPOCHS):
        epoch_start = time.perf_counter()
        batches = iter(trainloader)
        while not capped:
            if args.steps is not None and trainer.step >= args.steps:
                capped = True
                break
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            batch = numeric_batch(batch)
            losses, total = trainer.train_step(
                batch, step_generator(args.seed, trainer.step, device, rank, world))
            step = trainer.step
            if rank == 0 and (step % cfg.LOGGING_INTERVAL == 0 or step == 1):
                scalars = {'total_loss': float(total),
                           **{k: float(v) for k, v in losses.items()}}
                print(json.dumps({'epoch': epoch, 'step': step, **scalars}), flush=True)
                for k, v in scalars.items():
                    logger.scalar(k, v, step)
            t2 = time.perf_counter()
            video_ms = None
            if rank == 0 and step % cfg.VIS_INTERVAL == 0:
                # the ground truth against the prediction of the updated weights
                output, labels, _ = trainer.eval_step(batch)
                run.videos.append(logger.video(
                    'train_outputs', visualise_output(labels, output, cfg), step))
                video_ms = 1e3 * (time.perf_counter() - t2)
            run.steps.append({'step': step, 'loader_wait_ms': 1e3 * (t1 - t0),
                              'step_ms': 1e3 * (t2 - t1), 'video_ms': video_ms})
        if capped:
            batches.close()
            break

        step = trainer.step
        iou, vpq = validate(trainer, valloader, on_first=None if rank else (
            lambda output, labels: run.videos.append(logger.video(
                'val_outputs', visualise_output(labels, output, cfg), step))))
        if rank:
            continue
        uw = {k: float(v.detach()) for k, v in trainer.uncertainty.items()}
        logger.scalar('segmentation_weight', 1.0 / np.exp(uw['segmentation_weight']), step)
        for k in ('centerness_weight', 'offset_weight', 'flow_weight'):
            if k in uw:
                logger.scalar(k, 1.0 / (2 * np.exp(uw[k])), step)
        for name, score in zip(['background', 'dynamic'], iou):
            logger.scalar(f'val_iou_{name}', score, step)
        logger.scalar('val_vpq_vehicles', vpq, step)
        print(json.dumps({'epoch': epoch, 'step': step,
                          'seconds': round(time.perf_counter() - epoch_start, 3),
                          'val_iou_background': float(iou[0]),
                          'val_iou_dynamic': float(iou[1]),
                          'val_vpq_vehicles': float(vpq)}), flush=True)
        save_checkpoint_async(os.path.join(save_dir, f'checkpoint_epoch{epoch}'), trainer, cfg)

    if rank == 0:
        wait_for_async_save()
        save_checkpoint(os.path.join(save_dir, 'checkpoint_final'), trainer, cfg)
        logger.close()
    trainloader.shutdown()
    valloader.shutdown()
    if dist.is_initialized():
        # the ranks end together, after rank 0's checkpoint is on disk
        dist.barrier()
    log(f'Training complete; checkpoints in {save_dir}', flush=True)
    return run


if __name__ == '__main__':
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
