"""Smoke run of fiery_tpu_torch on one CUDA card: python3 chip_smoke.py

Builds the package's CUDA kernels from csrc/, then:
  1. serves three seeded full-width baseline.yml requests (PRECISION 16, random
     weights) through predict_instances, the decode and the device tracker
     included, and checks how often each kernel ran on that path (one BatchNorm
     launch per eval BatchNorm call, counted by hooks in a warm-up request; two GRU
     launches per rollout step), that no plain version ran, that the device
     tracker never waits on the host, and how far the host (scipy) tracker's ids
     are from the device tracker's; times the request with and without decoding;
     then the served form (phase_served_graph, dense and combined): the seeded
     weights folded in f32, cast and captured as CUDA graphs (serve.build_served),
     the launches of the warm-ups and captures counted, none in a replay; three
     requests through both graphs equal to the eager folded model bit for bit, ids
     too; folded vs unfolded within relative L2 2e-2 at PRECISION 32 (TF32 off;
     the bf16 distances printed); eager and replayed requests timed in turns, the
     host's part of a replay, the peak memory; after the timed
     phases, a profiled replay holds the same kernels by name and count as an
     eager request, with device busy and K10's ms of each; then the exported
     program (phase_exported, dense and combined; export.py): the folded forward
     exported on the card with torch.export (no launch while tracing), its graph
     holding the fiery_torch operators (K1, K2 or K5, K10, K11) as often as the
     eager folded forward launches their kernels, loaded in-process (captured by
     ServedFiery, the launches counted) and in a fresh python3 process that
     imports only ops/library.py and export.py (no fiery_tpu_torch.models), three
     requests bit for bit against the eager folded model and ServedFiery, the
     program's module launching the forward's kernels, its captured requests
     timed in turns with ServedFiery's and the eager folded model's, and a
     profiled replay of its predict holding the eager folded forward's kernels
     by name and count (``--only exported`` runs this phase alone);
  2. holds K1 and K2 against their plain PyTorch versions at the baseline serve
     shapes, in f32 and in bf16 (K2 also at the training step's 6 maps, and equal
     to the plain version on the host, given the card's theta, in every value), and
     times kernel, plain version and library call;
     K1's forward also at the training shape (9 samples), equal to the plain
     version on the host bit for bit and in two runs, its order stage equal to
     its plain version, every launch of a call timed by stage, beside two probes
     (csrc/bev_pool_probes.cu): the atomic design it replaced, with vector
     reductions, and the L2 gather of its feature rows (its floor);
  3. runs a tiny config on the card and on the CPU with the same seeded weights
     and request, and compares every output;
  4. holds the decode and tracking kernels (K6-K9) against their plain versions
     at the served shapes and on planted inputs (K6, K7 and K9 exactly, K6 also on
     frames with no peak, a flat plateau and 400 x 200, 320 x 193 and 320 x 192
     grids, K7 on K = 1, 100 and 1,024 centres, planted near-ties, frames with no
     valid centre or no foreground, non-finite inputs, those grids and C = 2 and 3; K8 over
     the request's clip in one launch, its grid centres equal to the plain version
     on the host and its flow centres within one f32 ulp, two calls with the same
     bits), K9 also on tie-heavy, non-finite and n = 17 to 1024 problems, and
     times them: K8 beside the launch floor (an empty kernel's device time), K9
     against its latency bound (a chain of dependent warp minima) and split into a
     launch, rows and Dijkstra steps; K4's and K8's library calls compute the
     kernels' whole functions;
  5. decodes and tracks a planted full-width scene of 20 moving vehicles, which
     both trackers must follow exactly (vehicle PQ = 1);
  6. trains: three full-width baseline.yml training steps at batch 3 (PRECISION
     16, seeded random weights, synthetic clips, drop-connect and noise drawn on
     the card) after a warm-up step, checking the losses, that the parameters and
     BatchNorm statistics moved, and how often each training kernel ran per step
     (the BatchNorm and GRU kernels forward and backward included); runs one more
     step, from the batch on the card, under set_sync_debug_mode('error'); prints
     the median step time, the peak memory, per-stage times (CUDA events, and the
     host clock with a synchronize between stages) and the top device kernels of a
     profiled step, with K3's, K5's and K5 backward's device ms in it;
  7. holds the training kernels (K1 and K2 backward, K3 top-k select, K4 nearest
     warp) against their plain versions at the training shapes, and times them (K3
     on random rows and on rows with ties at the k-th value)
     (K1 backward beside the L2 gather of its gradient rows; two runs bit for bit;
     K2 backward equal to the plain version on the host, given the card's theta,
     bit for bit, also at wide poses on 400 x 200, 320 x 193 and 320 x 192 grids,
     and to a second call, and NaN for a map whose pose is not finite);
  8. runs a tiny training step on the card and on the CPU from the same weights,
     batch and noise, and compares the losses and gradients;
  9. the levers: serves three full-width requests and trains three full-width
     steps at batch 3 of the combination LIFT.TOPK 8 + LIFT.WARP_FREE (+
     DATASET.PREWARP_LABELS and host-warped labels in training), with the launch
     counts of that path (the top-k select K5 and its backward, K1 at D = 8, no
     K2, no K4); holds K5 and its backward against their plain versions at those
     shapes, bf16 and f32, with planted ties, exactly (the backward also bit for
     bit at D = 28, 48, 64, k = 1, 8, D, on 1 to 90,720 pixels, and on 56-byte
     bf16 rows), and times them; and runs the tiny combination card vs CPU,
     forward and training step;
 10. holds the BatchNorm kernel (K10: every epilogue, eval and training, forward
     and backward, 4-D and 5-D, f32 and bf16; y bit for bit) and the GRU's gate
     kernels (K11, forward and backward, batch 1 and 3) against their plain
     versions at the training step's shapes; runs K10's exact checks (every bf16
     value through every epilogue, C = 21, 23, 35, a dy slice at an odd row
     stride, two runs with the same bits) and K11's (every bf16 value through its
     four kernels at each access width, bit for bit); times each K10 pass at the
     largest training and served calls, bf16 and f32, post none and swish, and
     K11 (with autograd's sum of its two dh parts, and the host µs of a call).
 11. drives the training and evaluation entry points at full width (PRECISION 16,
     batch 3, seeded weights, the synthetic set; phase_train_loop): two epochs of
     python -m fiery_tpu_torch.train (3 steps each, a validation and a checkpoint
     each, batches pinned by the loader), a --resume auto after the second epoch's
     checkpoints are deleted, one epoch of the combination with the label prewarp
     in the loader, and python -m fiery_tpu_torch.evaluate on the final checkpoint
     with either tracker, each path with its launches counted; checks
     metrics.jsonl, the checkpoints' steps and that the final one equals the
     trainer bit for bit; prints the H2D copy of a batch pinned and pageable, the
     copies of a profiled step, the loop's step walls with the loader's wait, the
     loader's rate alone, the checkpoint's cost and VPQ from both trackers; the
     first run has --profile-dir (check_profile: one trace of steps 3-5, its
     profiler step markers those three, its K10 launches equal to the
     counters'); then requires every launch of four
     profiled K10 windows after it; then the accuracy-parity runner
     (phase_parity; ``--only parity`` runs it alone): a reference checkpoint of
     full-width seeded weights through the twin's strict load, and in a fresh
     process python -m fiery_tpu_torch.parity --stages --dataroot TREE
     --max-batches 2 --device-matching on a fake nuScenes tree: every stage below
     5e-3 relative in f32, K1, K2, K10, K11 and K6-K9 launched, no plain version,
     every row of the table finite.
 12. the nuScenes and Lyft loader on trees of real JPEGs that the port's writer
     makes in a temporary directory (phase_real_set; ``--only real_set`` runs it
     alone): a nuScenes mini tree at 1600 x 900 (3 scenes of 12 samples) and a
     Lyft tree at lyft/baseline.yml's 1920 x 1080 (2 scenes of 17); the loader
     alone on baseline.yml at batch 3 (a sample's decode, rasterisation and
     label generation ms on one core, batches a second in N_WORKERS workers,
     every image by the decoder the machine has: the native pipe where it
     builds, else PIL; the prewarp's ms in the workers and whether the loader or
     the step sets the pace); python -m fiery_tpu_torch.train on it at full
     width, PRECISION 16, batch 3, VIS_INTERVAL 1 (3 steps; LOOP_DENSE's
     launches, finite losses, the train and val videos as GIFs of 5 frames),
     one combination epoch with the prewarp in the workers, the evaluation CLI
     with the device tracker (finite IoU and VPQ), one epoch of lyft/baseline.yml (15
     frames loaded, 8 kept), and the visualise CLI where matplotlib imports;
     each step's wall and loader wait.
 13. the JAX package's other config families (phase_families, FAMILIES): the
     single-frame model (single_timeframe.yml), the temporal model without a
     future (temporal_single_timeframe.yml), both on PON's 400 x 200 grid
     (static_pon_setting.yml, pon_setting.yml), fishing_setting.yml (320 x 192,
     D = 28; also under LIFT.TOPK 8), Lyft's MODEL.SUBSAMPLE (lyft/baseline.yml)
     and baseline.yml with the encoder at downsample 16 and with a Bottleneck3D
     between the temporal blocks, each at full width, PRECISION 16, seeded
     weights: three eager requests through predict_instances (outputs, ids, the
     tracker under set_sync_debug_mode('error'), each kernel's launches a request
     as the family derives them), the served graphs (replays equal to the eager
     folded model bit for bit, 10 requests of each in turns, a profiled replay's
     busy, peak memory) and a warm-up and two training steps at the family's
     BATCHSIZE (losses, parameters and statistics moved, launches a step, step ms,
     peak memory); K1 and K5 (and their backwards) at fishing's D = 28, K2 forward
     and backward and K4 at pon's 400 x 200 of extent (50, 25), and K6-K8 on the
     pon and fishing heads against their plain versions, timed; and
     python -m fiery_tpu_torch.export --validate of pon_setting.yml in-process
     (the program exported, loaded, captured and held against the live model).
     ``python3 chip_smoke.py --only families`` builds the kernels and runs this
     phase alone (no result line).
 14. data-parallel training (phase_data_parallel, after the training loop;
     ``--only data_parallel`` runs it alone): in a one-rank NCCL group, the
     full-width baseline.yml step at batch 3 of a DistributedDataParallel trainer
     whose BatchNorms synchronise their statistics (K10's partials, gather,
     finalize and apply launches, counted against the step's BatchNorm calls; no
     plain version; a second step under set_sync_debug_mode('error')) against the
     unsynchronised step from the same weights, batch and generator (run three
     times): losses and running statistics bit for bit, gradients and Adam
     moments within twice that step's own run-to-run spread (its backward adds with atomics in the
     bilinear upsamples' and adaptive pooling's gradients), the two timed in turns
     with their peak memory; the synchronised kernels against their plain
     versions at every training call shape of the step, timed beside
     torch.nn.SyncBatchNorm's function at world size 1; two gloo ranks on the
     card (this script, started with --dp-out), batch 3 each, against one
     process at batch 6 in f32 (TF32 off, its convolutions and squeeze-excitation
     means on the halves of its batch, which the random full-width step is
     sensitive to) at the CPU test's tolerances, their weights equal bit for bit
     (the training CLI under torchrun runs on NCCL in --only multi_card, on gloo
     in phase 15).
 15. camera-parallel training (phase_camera_parallel, after the data-parallel
     phase; ``--only camera_parallel`` runs it alone): two gloo ranks on the card
     (this script, started with --cam-out) form one camera group, each encoding 3
     of the 6 cameras of the full-width baseline.yml step at batch 3, the
     encoder's outputs gathered before the splat, against one process whose
     encoder runs each rank's cameras apart, in f32 (TF32 off) at the CPU test's
     tolerances, the ranks' weights equal bit for bit; one step at batch 1 of
     LIFT.TOPK 8 + LIFT.WARP_FREE held the same way (the bf16 step runs on the ranks
     in the CLI run below); each rank's launches and peak memory against the one process's, with
     the bytes the encoder's forward holds; ``python -m torch.distributed.run
     --nproc_per_node 2 -m fiery_tpu_torch.train --camera-parallel 2 --bev-parallel``
     on the card for 2 steps (the camera gather and the BEV rows both).
 16. BEV-parallel training (phase_bev_parallel, after the camera-parallel phase;
     ``--only bev_parallel`` runs it alone): the row gather's and the row mean's
     NCCL calls in a group of one rank (the identity); two gloo ranks on the card
     (this script, started with --bev-out) form one camera group that also splits
     the 200 BEV rows (104 + 96) after the splat, the same two steps held against
     one process whose encoder runs each rank's cameras apart and whose modules
     after the splat run each rank's rows apart with its halos
     (``rows_in_groups``), at the CPU test's tolerances; each rank's launches and
     peak memory.
  Then the lever accuracy study (phase_accuracy; ``--only accuracy`` runs it
  alone): fiery_tpu_torch.accuracy_ab at its BASE, dense and topk8_warpfree trained
  150 steps each and evaluated (matched, dense-parity, cross-served), and the
  activation study: falling finite losses, the JAX harness's JSON keys, dense
  against dense exact, every kernel of the path launched (K1-K7, K10, K11 and the
  backwards), no plain version, each mode's launches a step those predicted; then
  a request and a training step at BASE for dense, topk8 and topk8_warpfree, card
  against the CPU's plain path; the steps/s and each kernel's launches a step.
``--only multi_card`` (not in the default run; refused on fewer than four cards)
runs the one-card phases' held checks with NCCL ranks on cards 0 and 1 (the
data-parallel step against one process at batch 6, the camera group of two with
and without the BEV rows), then python -m torch.distributed.run --nproc_per_node 4
of the training CLI with --camera-parallel 2 --bev-parallel for 2 steps (the four
ranks' states bit for bit) and one card's plain run, and prints their step walls
(phase_multi_card).
The request and the step also print K10's census (each BatchNorm call's shape
and epilogue, from hooks) with its summed bound, and K10's device time in one
profiled request and step.
Each kernel timing is told the launches a call makes, and a profiler trace that
holds another count is taken again (five tries, then the run fails); each trace
starts with a few spin kernels and a pause, as its first launches can go
unrecorded.
Prints a "kernels" JSON line, the card's name and power limit, and as its last
line {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Without a CUDA card, or without the package beside it, it fails.
"""

import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import types
from collections import Counter

import numpy as np
import scipy.optimize
import torch
import torch.distributed as dist
import torch.nn.functional as F

from fiery_tpu_torch.data.dataset import prepare_dataloaders
from fiery_tpu_torch.data.label_warp import make_prewarp_transform
from fiery_tpu_torch.data.labels import convert_instance_mask_to_center_and_offset_label
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.evaluate import device_consistent
from fiery_tpu_torch.models.fiery import FieryConfig
from fiery_tpu_torch.models.layers import BatchNorm, ConvTranspose2d, _InputDtype
from fiery_tpu_torch.native import build_error as native_build_error
from fiery_tpu_torch.native import image_pipe_available
from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.ops.batch_norm import (
    POSTS, batch_norm_backward, batch_norm_backward_apply_card, batch_norm_backward_apply_plain,
    batch_norm_backward_finalize_card, batch_norm_backward_finalize_plain,
    batch_norm_backward_partials_card, batch_norm_backward_partials_plain,
    batch_norm_backward_plain, batch_norm_backward_sync, batch_norm_finalize_card,
    batch_norm_finalize_plain, batch_norm_forward, batch_norm_forward_plain,
    batch_norm_partials_card, batch_norm_partials_plain, batch_norm_plain,
    batch_norm_sync_forward, channel_slices, gather_sums)
from fiery_tpu_torch.models import temporal_layers
from fiery_tpu_torch.parallel.mesh import (RowShare, _memory_like, gather_cameras,
                                           gather_rows, group_row_mean, make_parallel_trainer,
                                           maybe_initialize_distributed, row_plan)
from fiery_tpu_torch.ops import lift_splat as lift_splat_module
from fiery_tpu_torch.ops.lap import linear_sum_assignment, linear_sum_assignment_plain
from fiery_tpu_torch.ops.spatial_gru import (gru_output, reset_concat, reset_concat_backward,
                                             reset_concat_backward_plain, reset_concat_plain,
                                             spatial_gru, spatial_gru_backward, state_update,
                                             state_update_backward,
                                             state_update_backward_plain, state_update_plain)
from fiery_tpu_torch.ops.lift_splat import (BEV_POOL_KERNELS, bev_pool, bev_pool_backward,
                                            bev_pool_backward_plain, bev_pool_order,
                                            bev_pool_order_plain, bev_pool_plain,
                                            create_frustum, get_geometry, topk_select,
                                            topk_select_backward,
                                            topk_select_backward_plain, topk_select_plain,
                                            voxel_ids)
from fiery_tpu_torch.ops.warp import (_affine_grid, _warp_theta, bev_warp,
                                      bev_warp_backward, bev_warp_backward_plain,
                                      bev_warp_nearest, bev_warp_nearest_plain,
                                      bev_warp_plain, card_theta)
from fiery_tpu_torch import serve_graph
from fiery_tpu_torch.profile_serve import host_us_per_call
from fiery_tpu_torch.postprocess.instance import (
    find_instance_centers, find_instance_centers_plain, instance_ids, instance_ids_plain,
    predict_instance_segmentation_and_trajectories, segment_centroids,
    segment_centroids_clip, segment_centroids_clip_plain, segment_centroids_plain)
from fiery_tpu_torch.serve import (BASELINE, build_fiery, build_served, calibrate_batchnorm,
                                   init_params, make_request, predict, predict_instances,
                                   seeded_state_dict)
from fiery_tpu_torch.parity_probe import randomise_batchnorm
from fiery_tpu_torch.trace_probe import k10_pass, trace_lead_in
from fiery_tpu_torch.training.losses import (_top_k_sum_from_threshold, compute_losses,
                                             kth_largest, kth_largest_plain,
                                             kth_largest_plan)
from fiery_tpu_torch.training.metrics import PanopticMetric
from fiery_tpu_torch.training.trainer import INPUTS, Trainer, step_generator
from fiery_tpu_torch.utils.checkpoint import load_checkpoint
from fiery_tpu_torch.utils.config import get_cfg

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 and f64 (non-tensor-core) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12
REPS = 25
# the wrappers whose launches the main path counts, by kernel name
COUNTERS = {'bev_pool': bev_pool, 'bev_warp': bev_warp,
            'instance_centers': find_instance_centers, 'group_pixels': instance_ids,
            'segment_centroids': segment_centroids, 'lap': linear_sum_assignment,
            'bev_pool_backward': bev_pool_backward, 'bev_warp_backward': bev_warp_backward,
            'kth_largest': kth_largest, 'bev_warp_nearest': bev_warp_nearest,
            'topk_select': topk_select, 'topk_select_backward': topk_select_backward,
            'batch_norm': batch_norm_forward, 'batch_norm_backward': batch_norm_backward,
            'spatial_gru': spatial_gru, 'spatial_gru_backward': spatial_gru_backward}
# the wrappers whose plain versions must not run on the card's paths
PLAIN_COUNTED = (batch_norm_forward, batch_norm_backward, spatial_gru, spatial_gru_backward)
TRAIN_KERNELS = ('bev_pool', 'bev_pool_backward', 'bev_warp', 'bev_warp_backward',
                 'kth_largest', 'bev_warp_nearest', 'topk_select', 'topk_select_backward',
                 'batch_norm', 'batch_norm_backward', 'spatial_gru', 'spatial_gru_backward')
TRAIN_ONLY = ('bev_pool_backward', 'bev_warp_backward', 'kth_largest', 'bev_warp_nearest',
              'topk_select_backward', 'batch_norm_backward', 'spatial_gru_backward')
# the levers' combination (the JAX package's fastest configuration): the sparse top-k
# splat and the warp-free lift; training adds the host label warp
COMBO_OPTS = ('LIFT.TOPK', '8', 'LIFT.WARP_FREE', 'True')
COMBO_TRAIN_OPTS = COMBO_OPTS + ('DATASET.PREWARP_LABELS', 'True')
def expected_launches(mc, cfg, bn_launches, bn_calls=None):
    """The launches of every counted kernel a request (``bn_calls`` None) or a
    training step (``bn_calls``: the step's BatchNorm calls) of a model:
    K1 (one splat), K5 under LIFT.TOPK, K2 for past frames (receptive field above 1,
    not warp-free), K11 twice a GRU step of each block, K10 as the hooks counted;
    a request decodes (K6, K7 once) and tracks (K8 once for a clip of more than one
    frame, K9 once a step); a step adds the backward kernels of K1, K2, K5, K10 and
    K11, K3 once (the top-k segmentation loss) and K4 once when there are future
    label frames to warp back."""
    T = 1 + mc.n_future
    warp = int(mc.receptive_field > 1 and not mc.warp_free)
    gru = 2 * mc.n_gru_blocks * mc.n_future
    out = dict.fromkeys(COUNTERS, 0)
    out.update(bev_pool=BEV_POOL_KERNELS, topk_select=int(bool(mc.depth_topk)), bev_warp=warp,
               spatial_gru=gru, batch_norm=bn_launches)
    if bn_calls is None:
        out.update(instance_centers=1, group_pixels=1, segment_centroids=int(T > 1), lap=T - 1)
    else:
        out.update(bev_pool_backward=1, bev_warp_backward=warp,
                   topk_select_backward=out['topk_select'],
                   kth_largest=int(cfg.SEMANTIC_SEG.USE_TOP_K),
                   bev_warp_nearest=int(mc.n_future > 0 and not cfg.DATASET.PREWARP_LABELS),
                   batch_norm_backward=2 * bn_calls, spatial_gru_backward=gru)
    return out


def check_launches(name, got, per_call, n_calls):
    if got != {k: n * n_calls for k, n in per_call.items()}:
        raise AssertionError(f'{name}: launches {got} in {n_calls} calls, expected '
                             f'{per_call} a call')


def expected_outputs(mc):
    """{output: shape} of a request at batch 1 for a FieryConfig: the heads over
    the present and future frames, flow if enabled, the present distribution when
    there is a future to sample."""
    X, Y = mc.bev_size
    T = 1 + mc.n_future
    out = {'segmentation': (1, T, X, Y, mc.n_classes), 'instance_center': (1, T, X, Y, 1),
           'instance_offset': (1, T, X, Y, 2)}
    if mc.instance_flow_enabled:
        out['instance_flow'] = (1, T, X, Y, 2)
    if mc.probabilistic_enabled and mc.n_future:
        out.update(present_mu=(1, 1, mc.latent_dim), present_log_sigma=(1, 1, mc.latent_dim))
    return out


def check_request_outputs(name, mc, outputs, ids_max=None):
    """Every (output dict, ids) of predict_instances: the expected shapes, f32 and
    finite values, (1, frames, X, Y) int32 ids in [0, ids_max]."""
    expected = expected_outputs(mc)
    X, Y = mc.bev_size
    T = 1 + mc.n_future
    for out, ids in outputs:
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != expected:
            raise AssertionError(f'{name}: output shapes {shapes} != {expected}')
        for k, v in out.items():
            if v.dtype != torch.float32 or not torch.isfinite(v).all():
                raise AssertionError(f'{name}: {k}: dtype {v.dtype} or non-finite values')
        if (ids.shape != (1, T, X, Y) or ids.dtype != torch.int32 or int(ids.min()) < 0
                or (ids_max is not None and int(ids.max()) > ids_max)):
            raise AssertionError(f'{name}: instance ids {ids.dtype} {tuple(ids.shape)} '
                                 f'in [{int(ids.min())}, {int(ids.max())}]')


def replays_match_eager(name, served, eager, requests):
    """Each request through both graphs of ``served`` against ``eager`` (the eager
    folded model): no wrapper called in a replay, every output and the ids equal
    bit for bit. Returns (eager outputs, replayed ids) a request."""
    out = []
    for i, req in enumerate(requests):
        reset_counters()
        got, got_ids = served.predict_instances(req)
        bare = served.predict(req)
        replayed = {k: fn.launches for k, fn in COUNTERS.items() if fn.launches}
        if replayed:
            raise AssertionError(f'{name}: a replay called the wrappers: {replayed}')
        want, want_ids = predict_instances(eager, req)
        if sorted(got) != sorted(want) or sorted(bare) != sorted(want):
            raise AssertionError(f'{name}: outputs {sorted(got)}, {sorted(bare)} != '
                                 f'{sorted(want)}')
        differ = {k: bits_differ(got[k], v) + bits_differ(bare[k], v) for k, v in want.items()}
        differ['ids'] = int((got_ids != want_ids).sum())
        if any(differ.values()):
            raise AssertionError(f'{name}: request {i}: values whose bits differ between '
                                 f'the replay and the eager folded model: {differ}')
        out.append((want, got_ids))
    return out


def in_turns(calls, requests, reps, warmup):
    """{name: host ms of each call} of the callables ``calls`` ({name: fn(request)}),
    each once a round in turns over the requests, each call ended by a synchronize;
    the first ``warmup`` rounds untimed."""
    times = {k: [] for k in calls}
    for i in range(warmup + reps):
        for key, fn in calls.items():
            t0 = time.perf_counter()
            fn(requests[i % len(requests)])
            torch.cuda.synchronize()
            if i >= warmup:
                times[key].append(1e3 * (time.perf_counter() - t0))
    return times


def log(*args):
    print(*args, flush=True)


def reset_counters():
    """Every launch counter, the plain versions' calls, the BatchNorm kernel's
    layouts, and the layout copies of the convolutions and BatchNorm gradients."""
    for fn in COUNTERS.values():
        fn.launches = 0
    for fn in PLAIN_COUNTED:
        fn.plain_calls = 0
    batch_norm_forward.forms = {k: 0 for k in batch_norm_forward.forms}
    batch_norm_backward.grad_copies.clear()
    _InputDtype.layout_copies.clear()


def layout_report():
    """The BatchNorm kernel's calls by layout and the copies made for layouts, since
    reset_counters(); fails if a plain version ran."""
    plain = {name: fn.plain_calls for name, fn in zip(
        ('batch_norm', 'batch_norm_backward', 'spatial_gru', 'spatial_gru_backward'),
        PLAIN_COUNTED)}
    if any(plain.values()):
        raise AssertionError(f'plain versions ran on the card: {plain}')
    return {'batch_norm_forms': dict(batch_norm_forward.forms),
            'conv_layout_copies': {str(k): v for k, v in _InputDtype.layout_copies.items()},
            'bn_grad_layout_copies': {str(k): v for k, v in
                                      batch_norm_backward.grad_copies.items()}}


def count_bn_calls(model, fn):
    """fn() with a forward pre-hook on every BatchNorm of model: (its result, the
    number of BatchNorm calls it made, each counted once a channel slice (a call of
    more than MAX_CHANNELS channels launches the kernels once a slice), the K10
    forward launches they imply: two a call and slice in training mode (the
    statistics with their reduction, then apply), one in eval; and the census of
    the calls, (shape, bytes a value, post, with a residual, training) each)."""
    census = []

    def hook(module, args, kwargs):
        x = args[0]
        residual = kwargs.get('residual', args[1] if len(args) > 1 else None)
        post = kwargs.get('post', args[2] if len(args) > 2 else None) or module.post
        census.append((tuple(x.shape), x.element_size(), post, residual is not None,
                       module.training))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    slices = [len(channel_slices(c[0][1])) for c in census]
    return (out, sum(slices), sum((2 if c[4] else 1) * n for c, n in zip(census, slices)),
            census)


def census_bound(census, backward=False):
    """K10's summed bound over a census of BatchNorm calls: (calls, GB, bound ms),
    each call's bytes over the HBM rate, its inputs read once and its outputs
    written once (the per-channel vectors left out). Forward: x (and the residual)
    read, y written. Backward: dy and x read, dx written, and for add_relu the
    residual read and its gradient written."""
    total = 0
    for shape, es, post, with_res, _ in census:
        n = es * int(np.prod(shape))
        if backward:
            total += n * (3 + (2 if post == 'add_relu' else 0))
        else:
            total += n * (2 + (1 if with_res else 0))
    return len(census), total / 1e9, 1e3 * total / HBM_BYTES_PER_S


K10_PASS_NAMES = ('stats', 'apply', 'backward_reduce', 'backward_apply')


def k10_device_ms(events):
    """K10's device ms by pass over profiler key averages."""
    out = dict.fromkeys(K10_PASS_NAMES, 0.0)
    for e in events:
        name = k10_pass(e.key)
        if name:
            out[name] += e.self_device_time_total / 1e3
    return out


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


def kernel_ms(fn, symbols, launches, reps=REPS, warmup=3, attempts=5):
    """Mean device time per call of the kernels whose names contain one of
    ``symbols`` (torch.profiler's CUPTI trace over reps calls, after warm-up): the
    kernel's own time, without the host's launch gaps. A call launches them
    ``launches`` times; a trace that holds another count (CUPTI now and then drops
    a window's kernels) is taken again, up to ``attempts`` times, before it fails.
    Each trace starts with ``trace_lead_in``."""
    return pass_ms(fn, lambda key: 'all' if any(s in key for s in symbols) else None,
                   {'all': launches}, reps, warmup, attempts)['all']


def pass_ms(fn, classify, launches, reps=REPS, warmup=3, attempts=5, optional=()):
    """kernel_ms by group, from one trace: {name: mean device ms per call} over
    the kernels that ``classify(kernel name)`` puts in each group of ``launches``
    ({name: launches a call}). The trace must hold reps x launches of each group's
    kernels (a group in ``optional`` may also be absent), else it is taken again, up
    to ``attempts`` times, and then the call fails."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    want = {name: reps * n for name, n in launches.items()}
    for _ in range(attempts):
        with torch.profiler.profile(activities=activities) as prof:
            trace_lead_in()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(launches, 0.0)
        seen = dict.fromkeys(launches, 0)
        for e in prof.key_averages():
            group = classify(e.key) if e.device_type == torch.autograd.DeviceType.CUDA else None
            if group in out:
                out[group] += e.self_device_time_total / 1e3 / reps
                seen[group] += e.count
        if all(seen[k] == n or (k in optional and seen[k] == 0) for k, n in want.items()) \
                and all(v > 0 for k, v in out.items() if seen[k]):
            return out
        log(f'  the trace held {seen} launches, expected {want}; measuring again')
    raise AssertionError(f'the profiler did not see {want} launches in {attempts} traces')


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


K1_STAGES = ('memset', 'count', 'scan', 'fill', 'pool')


def k1_stage(key):
    """The stage of a K1 forward call that a device activity belongs to (the memset
    of its counters, or one of its four kernels), or None."""
    if key.startswith('Memset'):
        return 'memset'
    for stage in K1_STAGES[1:]:
        if f'::splat_{stage}_kernel' in key:
            return stage
    return None


def k1_ms(fn):
    """(device ms of every launch of the K1 forward calls fn makes, the same by
    stage); a trace may hold no memset."""
    by_stage = pass_ms(fn, k1_stage, dict.fromkeys(K1_STAGES, 1), optional=('memset',))
    return sum(by_stage.values()), by_stage


def probe_fn(name, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.load('bev_pool_probes'), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def gather_floor_ms(idx, src, row_bytes):
    """Device ms of the L2 gather probe (csrc/bev_pool_probes.cu) over the rows idx
    (int32, in the order a kernel gathers them) of src, row_bytes each: the least
    time that gather takes at the card's L2 rate."""
    size = probe_fn('fiery_gather_probe_sink', [ctypes.c_longlong, ctypes.c_int],
                    ctypes.c_longlong)
    sink = torch.empty(size(idx.numel(), row_bytes), dtype=torch.int32, device=src.device)
    fn = probe_fn('fiery_gather_probe', [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

    def run():
        rc = fn(idx.data_ptr(), idx.numel(), src.data_ptr(), row_bytes, sink.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f'gather probe launch failed: CUDA error {rc}')

    return kernel_ms(run, ['gather_probe_kernel'], 1)


def red_probe(depth, feat, ids, num_bins, z):
    """The atomic design K1's forward replaced, with red.global.add.v4.f32
    (csrc/bev_pool_probes.cu): (its output as a call would give it, the probe
    kernel's device ms, a call's ms: the zeroed f32 grid, the probe, the cast)."""
    S, N, h, w, D = depth.shape
    C = feat.shape[-1]
    fn = probe_fn('fiery_splat_red_probe', [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])

    def call():
        out = torch.zeros((S, num_bins // z, C), dtype=torch.float32, device=depth.device)
        rc = fn(depth.data_ptr(), feat.data_ptr(), ids.data_ptr(), out.data_ptr(),
                S * N * h * w, N * h * w, D, C, num_bins, z,
                int(depth.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f'red probe launch failed: CUDA error {rc}')
        return out.to(depth.dtype)

    return call(), kernel_ms(call, ['red_probe_kernel'], 1), time_ms(call)


def phase_bev_pool(device):
    """K1's forward at the serve shapes (3 samples) and at the training shapes (9:
    three clips of the serve rig), f32 and bf16: equal to the plain version on the
    host bit for bit, and to itself in a second call; within tolerance of the plain
    version on the card; its order stage equal to its plain version. Times every
    launch of a call by stage, the call, the plain version, the library call (outer
    product + index_add_), the L2 gather floor of its feature rows and the atomic
    design's probe; prints the host µs of one call."""
    depth_serve, feat_serve, ids_serve, num_bins, z = bev_pool_inputs(device)
    host = host_us_per_call()
    log('  host µs of one wrapper call (small shapes): ' + json.dumps(host))
    rec = {}
    for shape_name, reps in (('serve', 1), ('train', 3)):
        ids = ids_serve.repeat(reps, 1, 1, 1, 1).contiguous()
        S, N, h, w, D = ids.shape
        C = feat_serve.shape[-1]
        if reps == 1:
            depth32, feat32 = depth_serve, feat_serve
        else:
            gen = torch.Generator(device=device).manual_seed(3)
            depth32 = torch.softmax(torch.randn(ids.shape, generator=gen, device=device), -1)
            feat32 = torch.randn((S, N, h, w, C), generator=gen, device=device)
        valid = int((ids < num_bins).sum())
        log(f'bev_pool {shape_name}: {ids.numel()} rows, {valid} in the grid, {num_bins} bins')
        order, offsets = bev_pool_order(ids, num_bins, z)
        want_order, want_offsets = bev_pool_order_plain(ids.cpu(), num_bins, z)
        if not (torch.equal(order.cpu(), want_order) and torch.equal(offsets.cpu(), want_offsets)):
            raise AssertionError(f'bev_pool_order {shape_name}: differs from its plain version')
        sizes = offsets[1:] - offsets[:-1]
        log(f'  bev_pool_order {shape_name}: equal to plain; {int((sizes > 0).sum())} keys with '
            f'rows, largest bucket {int(sizes.max())}, {int((sizes > 32).sum())} over 32 rows, '
            f'{int((sizes > 512).sum())} over 512')
        feat_rows = (order.long() // D).to(torch.int32)    # the pool's gather, in order
        for dtype in (torch.float32, torch.bfloat16):
            depth, feat = depth32.to(dtype), feat32.to(dtype)
            got = bev_pool(depth, feat, ids, num_bins, z)
            again = bev_pool(depth, feat, ids, num_bins, z)
            want = bev_pool_plain(depth, feat, ids, num_bins, z)
            torch.cuda.synchronize()
            err = check_close(f'bev_pool {shape_name}', got, want, dtype)
            on_host = bev_pool_plain(depth.cpu(), feat.cpu(), ids.cpu(), num_bins, z)
            n_host, n_runs = bits_differ(got.cpu(), on_host), bits_differ(got, again)
            log(f'  bev_pool {shape_name} {str(dtype)[6:]}: values whose bits differ from the '
                f'plain version on the host {n_host}, from a second call {n_runs}')
            if n_host or n_runs:
                raise AssertionError(f'bev_pool {shape_name} {dtype}: {n_host} values differ '
                                     f'from the host plain version, {n_runs} between two calls')
            del want, on_host, again
            flat_ids = (ids.view(S, -1).long()
                        + torch.arange(S, device=device)[:, None] * (num_bins + 1)).view(-1)

            def library(depth=depth, feat=feat, flat_ids=flat_ids):
                vol = depth[..., :, None] * feat[..., None, :]
                out = torch.zeros((S * (num_bins + 1), C), dtype=dtype, device=device)
                out.index_add_(0, flat_ids, vol.view(-1, C))
                return out

            es = depth.element_size()
            nbytes = depth.numel() * es + feat.numel() * es + ids.numel() * 4 + S * (
                num_bins // z) * C * es
            flops = 2.0 * valid * C
            bound_ms, bound_by = bound(nbytes, flops)
            ms, by_stage = k1_ms(lambda: bev_pool(depth, feat, ids, num_bins, z))
            probe_out, probe_ms, probe_call_ms = red_probe(depth, feat, ids, num_bins, z)
            check_close(f'red probe {shape_name}', probe_out, got, dtype)
            del probe_out
            rec[(shape_name, dtype)] = dict(
                max_abs_err=err, ms=ms, pass_ms=by_stage,
                call_ms=time_ms(lambda: bev_pool(depth, feat, ids, num_bins, z)),
                plain_ms=time_ms(lambda: bev_pool_plain(depth, feat, ids, num_bins, z),
                                 reps=5, warmup=1),
                library_ms=time_ms(library, reps=5, warmup=1), bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, flops=flops,
                l2_floor_ms=gather_floor_ms(feat_rows, feat, C * es),
                red_probe_ms=probe_ms, red_probe_call_ms=probe_call_ms,
                host_us=host['bev_pool (K1)'])
            log(f'  bev_pool {shape_name} {str(dtype)[6:]}: ' + json.dumps(
                {k: v for k, v in rec[(shape_name, dtype)].items() if k != 'max_abs_err'}))
        del order, offsets, feat_rows
    log(f'  bev_pool timings: {smi_line()}')
    return rec


def phase_bev_warp(device, spatial_extent=(50.0, 50.0)):
    """K2 forward against its plain version, f32 and bf16, at the serve shape (2 maps
    of 200 x 200 x 64, the request's past frames) and at the training shape (6 maps:
    3 clips x 2 past frames): within tolerance on the card and equal in every value
    to the plain version on the host given the kernels' theta; times the kernel,
    the call, the plain version and the library call, with the bound, at both."""
    g = torch.Generator(device=device).manual_seed(2)
    H, W, C = 200, 200, 64
    rec = {}
    for shape_name, B in (('serve', 2), ('train', 6)):
        x32 = torch.randn((B, H, W, C), generator=g, device=device)
        pose = torch.zeros((B, 6), device=device)
        pose[:, 0] = torch.rand(B, generator=g, device=device) * 4.0 - 2.0   # metres
        pose[:, 1] = torch.rand(B, generator=g, device=device) * 2.0 - 1.0
        pose[:, 5] = torch.rand(B, generator=g, device=device) * 0.2 - 0.1   # radians
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            got = bev_warp(x, pose, spatial_extent)
            want = bev_warp_plain(x, pose, spatial_extent)
            torch.cuda.synchronize()
            err = check_close(f'bev_warp {shape_name}', got, want, dtype)
            # equal values to the plain version on the host given the kernel's theta
            # (f32 cos and sin on the card and on the host can differ in the last
            # bit); the plain version's out-of-map outputs are x * 0, -0.0 where x is
            # negative, the kernel's +0.0
            on_host = bev_warp_plain(x.cpu(), pose.cpu(), spatial_extent,
                                     theta=card_theta(pose, spatial_extent, dtype).cpu())
            host = int((got.cpu() != on_host).sum())
            log(f'  bev_warp {shape_name} {str(dtype)[6:]}: values that differ from the plain '
                f'version on the host {host} ({bits_differ(got.cpu(), on_host)} differ in '
                f'their bits: signed zeros)')
            if host:
                raise AssertionError(f'bev_warp {shape_name} {dtype}: {host} values differ '
                                     'from the host')
            del got, want, on_host

            def library(x=x, pose=pose, B=B, dtype=dtype):
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
            rec[(shape_name, dtype)] = dict(
                max_abs_err=err,
                ms=kernel_ms(lambda: bev_warp(x, pose, spatial_extent),
                             ['::bev_warp_tile_kernel'], 1),
                call_ms=time_ms(lambda: bev_warp(x, pose, spatial_extent)),
                plain_ms=time_ms(lambda: bev_warp_plain(x, pose, spatial_extent)),
                library_ms=time_ms(library), bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)
            log(f'  bev_warp {shape_name} {str(dtype)[6:]}: ' + json.dumps(
                {k: v for k, v in rec[(shape_name, dtype)].items() if k != 'max_abs_err'}))
    log(f'  bev_warp timings: {smi_line()}')
    return rec


TINY = {
    'PRECISION': 32, 'TIME_RECEPTIVE_FIELD': 3, 'N_FUTURE_FRAMES': 2,
    'IMAGE': {'FINAL_DIM': (64, 96), 'NAMES': ['CAM_A', 'CAM_B']},
    'LIFT': {'X_BOUND': [-8.0, 8.0, 0.5], 'Y_BOUND': [-8.0, 8.0, 0.5],
             'D_BOUND': [2.0, 8.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 16},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 16},
              'DISTRIBUTION': {'LATENT_DIM': 4},
              'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 2}},
}


# the tiny combination: k = 3 of its D = 6 depth bins, warp-free
TINY_COMBO = {**TINY, 'LIFT': {**TINY['LIFT'], 'TOPK': 3, 'WARP_FREE': True}}


def voxel_ids_of(fn):
    """Run fn() and return the voxel ids that the splats of its forwards computed
    (on the host), in call order."""
    captured, original = [], lift_splat_module.voxel_ids

    def capture(*args, **kw):
        ids = original(*args, **kw)
        captured.append(ids.cpu())
        return ids

    lift_splat_module.voxel_ids = capture
    try:
        return fn(), captured
    finally:
        lift_splat_module.voxel_ids = original


def phase_tiny_card_vs_cpu(overrides=TINY, name='tiny', yaw=None, rel_l2=None):
    """Same seeded weights and request (its ego-motion turned by ``yaw`` radians a
    frame, if given) through the kernels (cuda) and the plain versions (cpu), f32
    with TF32 off: every output within rtol/atol 1e-3, or, given ``rel_l2``, each
    output's relative L2 error within it (for random weights whose outputs reach
    hundreds, where f32 rounding alone exceeds 1e-3 on values near 0); and how many
    voxel ids the two devices' lift geometry puts in different bins."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_cfg(cfg_dict=overrides)
    cpu = init_params(build_fiery(cfg, device='cpu'), seed=3)
    calibrate_batchnorm(cpu, [make_request(cfg, seed=s) for s in (6, 7)])
    card = build_fiery(cfg, device='cuda')
    card.load_state_dict(cpu.state_dict())
    request = make_request(cfg, seed=5)
    if yaw is not None:
        request['future_egomotion'][..., 5] = yaw
    want, ids_cpu = voxel_ids_of(lambda: predict(cpu, request))
    got, ids_card = voxel_ids_of(lambda: predict(card, request))
    torch.cuda.synchronize()
    differ = sum(int((a != b).sum()) for a, b in zip(ids_card, ids_cpu))
    log(f'  {name}: voxel ids that differ card vs cpu: {differ} of '
        f'{sum(a.numel() for a in ids_cpu)}')
    for k, v in want.items():
        d = (got[k].cpu() - v).abs()
        rel = float(d.double().norm() / v.double().norm().clamp_min(1e-30))
        log(f'  {name} {k}: max_abs_err={float(d.max()):.3e} '
            f'max_abs={float(v.abs().max()):.3e} rel_l2={rel:.3e}')
        if rel_l2 is None:
            torch.testing.assert_close(got[k].cpu(), v, rtol=1e-3, atol=1e-3, msg=k)
        elif not rel <= rel_l2:
            raise AssertionError(f'{name} {k}: relative L2 error {rel} above {rel_l2}')
    torch.backends.cudnn.allow_tf32 = True


def phase_serve(n_requests=3, opts=(), name='serve'):
    """Full-width baseline.yml (PRECISION 16) at batch 1, seeded random weights,
    with the config overrides ``opts``. The main path is predict_instances
    (forward, decode, device tracker). After it, predict and predict_instances are
    timed in turns on the same requests: the request time without and with
    decoding."""
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=list(opts)))
    model = init_params(build_fiery(cfg), seed=0)
    calibrate_batchnorm(model, [make_request(cfg, seed=s) for s in (6, 7)])
    mc = model.cfg
    X, Y = mc.bev_size
    T = 1 + mc.n_future
    requests = [make_request(cfg, seed=10 + i) for i in range(n_requests)]
    warm = make_request(cfg, seed=9)       # warm-up (cuDNN plans, kernels)
    _, bn_calls, bn_launches, census = count_bn_calls(
        model, lambda: predict_instances(model, warm))
    predict_instances(model, warm, device_matching=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, outputs, tracks = [], [], []
    for req in requests:
        t0 = time.perf_counter()
        out, ids = predict_instances(model, req)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        outputs.append(out)
        tracks.append(ids)
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    layouts = layout_report()
    peak = torch.cuda.max_memory_allocated()
    check_request_outputs(name, mc, zip(outputs, tracks), ids_max=T * 100)
    # K10's launches a request counted by hooks in the warm-up request
    check_launches(name, launches, expected_launches(mc, cfg, bn_launches), n_requests)

    log(f'{name} (main path): request_ms={[round(t, 3) for t in times]} '
        f'peak_mem_bytes={peak} launches={launches}')
    log(f'{name}: {bn_calls} BatchNorm calls per request; per {n_requests} requests '
        f'{json.dumps(layouts)}')
    n_calls, gb, bound_ms = census_bound(census)
    log(f'{name} K10 census: {n_calls} calls, {gb:.4f} GB (inputs read once, outputs '
        f'written once), summed bound {bound_ms:.4f} ms at 3.35 TB/s; channel counts '
        f'{sorted({c[0][1] for c in census})}; calls under 1 M values '
        f'{sum(np.prod(c[0]) < 1e6 for c in census)}')
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
    log(f'{name}: request_ms={[round(t, 3) for t in bare]} '
        f'median_ms={statistics.median(bare):.3f} (predict, without decoding)')
    log(f'{name} with decode and tracking: request_ms={[round(t, 3) for t in full]} '
        f'median_ms={statistics.median(full):.3f} (predict_instances)')

    # the device decode and tracking never wait on the host
    torch.cuda.set_sync_debug_mode('error')
    try:
        for out in outputs:
            device_consistent(out)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    log(f'{name}: device decode + tracking ran under set_sync_debug_mode("error")')
    diffs, unexplained = [], []
    for out, ids in zip(outputs, tracks):
        host, dev = predict_instance_segmentation_and_trajectories(out), ids.cpu().numpy()
        diffs.append(int((host != dev).sum()))
        unexplained.append(relabel_disagreement(dev, host))
    log(f'{name}: pixels whose host (scipy, f16 flow) id differs from the device id: '
        f'{diffs} of {T * X * Y} per request, {unexplained} after the best relabel of the '
        f'device ids; ids per request: {[int(ids.max()) for ids in tracks]}')

    def profile():
        """One request under torch.profiler: K10's device ms against its summed
        bound (called after every timed phase)."""
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            predict_instances(model, requests[0])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
        k10 = k10_device_ms(events)
        busy = sum(e.self_device_time_total for e in events) / 1e3
        log(f'{name} profiled request: device busy {busy:.3f} ms; K10 {sum(k10.values()):.4f} '
            f'ms ({json.dumps({k: round(v, 4) for k, v in k10.items()})}) against its summed '
            f'bound {bound_ms:.4f} ms ({n_calls} calls, {gb:.4f} GB); {smi_line()}')

    return launches, outputs, profile


DECODE_KERNELS = ('instance_centers', 'group_pixels', 'segment_centroids', 'lap')


def window_kernels(fn, k10_launches, attempts=5):
    """(Counter of the CUDA kernels fn() launches by name, Counter of its memsets and
    memcpys by name, device busy ms, K10's device ms by pass) from one profiled
    window after ``trace_lead_in``, the lead-in's spin kernels left out. A CUDA
    graph's memset and memcpy nodes run as the driver's kernels (``memset32``,
    ``memcpy128``, ...): they count as memsets and memcpys. A window lost launches
    of fn when it holds none of the lead-in's spin kernels (the loss went past the
    lead-in) or K10 launches other than ``k10_launches``: it is taken again, with
    twice the spin kernels, up to ``attempts`` times, and then the call fails."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(attempts):
        spins = 64 << attempt
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            trace_lead_in(spins)
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
        kept = sum(e.count for e in events if 'spin_kernel' in e.key)
        events = [e for e in events if 'spin_kernel' not in e.key]
        is_copy = [e.key.lower().startswith(('memset', 'memcpy')) for e in events]
        copies = Counter({e.key: e.count for e, c in zip(events, is_copy) if c})
        kernels = Counter({e.key: e.count for e, c in zip(events, is_copy) if not c})
        k10 = sum(n for key, n in kernels.items() if k10_pass(key) == 'apply')
        if kept and k10 == k10_launches:
            busy = sum(e.self_device_time_total for e in events) / 1e3
            return kernels, copies, busy, k10_device_ms(events)
        log(f'  the window kept {kept} of the lead-in\'s {spins} spin kernels and held '
            f'{k10} K10 launches, expected {k10_launches}; profiling again')
    raise AssertionError(f'no window held the lead-in and the {k10_launches} K10 launches '
                         f'in {attempts} tries')


def alike_windows(fns, k10_launches, differ, attempts=3):
    """{key: window_kernels(fn)} for ``fns`` once ``differ(windows)`` finds no
    difference (returns None). A window can still lose launches to the profiler:
    while a difference shows, all the windows are taken again, up to ``attempts``
    times; a difference that stays in every take fails the call."""
    for _ in range(attempts):
        windows = {key: window_kernels(fn, k10_launches) for key, fn in fns.items()}
        difference = differ(windows)
        if difference is None:
            return windows
        log(f'  {difference}; profiling all the windows again')
    raise AssertionError(difference)


def phase_served_graph(opts=(), name='served graph'):
    """The served form at full width (baseline.yml, PRECISION 16, batch 1, the seeded
    weights): ``build_served`` folds every BatchNorm in f32, casts and captures
    predict and predict_instances as CUDA graphs. Checks the launches made while
    capturing (the warm-ups and the capture, each wrapper counted where it
    launches), that a replay calls no wrapper, that three seeded requests (none the
    captured one) give the eager folded model's outputs and ids bit for bit through
    both graphs, and that the folded outputs are finite and, at PRECISION 32 (TF32
    off) on the same weights, within relative L2 2e-2 of the unfolded model's (the
    bf16 distances printed); times predict and predict_instances eager (folded) and
    replayed, 20 each in turns, the host's part of a replay and the peak memory. Returns a
    closure that profiles a replay against an eager request (called after the
    timed phases): the same kernels by name and count, device busy, K10's ms."""
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=list(opts)))
    state_dict = seeded_state_dict(cfg, seed=0)
    unfolded = build_fiery(cfg, state_dict=state_dict)
    eager = build_fiery(cfg, state_dict=state_dict, fold_bn=True)
    requests = [make_request(cfg, seed=10 + i) for i in range(3)]
    for model in (unfolded, eager):
        predict_instances(model, requests[0])
    torch.cuda.synchronize()
    reset_counters()
    predict_instances(eager, requests[0])
    per_request = {k: fn.launches for k, fn in COUNTERS.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counters()
    t0 = time.perf_counter()
    served = build_served(cfg, state_dict)
    build_s = time.perf_counter() - t0
    captured = {k: fn.launches for k, fn in COUNTERS.items()}
    # the warm-ups and the capture of each graph: the forward in both, the decode
    # and tracking in predict_instances'
    runs = serve_graph.WARMUP + 1
    expected = {k: n * runs * (1 if k in DECODE_KERNELS else 2) for k, n in per_request.items()}
    if captured != expected:
        raise AssertionError(f'{name}: launches while capturing {captured}, expected '
                             f'{expected}')
    layout_report()

    outputs = []
    for req, (want, got_ids) in zip(requests, replays_match_eager(name, served, eager,
                                                                  requests)):
        plain = predict(unfolded, req)
        errs = {k: rel_l2(v, plain[k]) for k, v in want.items()}
        if any(not torch.isfinite(v).all() for v in want.values()):
            raise AssertionError(f'{name}: non-finite folded outputs')
        outputs.append((got_ids, errs))
    # the fold's own error is held at PRECISION 32 (TF32 off), on the same weights:
    # in bf16 a random-weight network moves by 0.1-0.6 relative L2 from any rounding
    # change (bf16 against f32 alone does), so the bf16 distances are printed, beside
    # each bf16 model's distance from the f32 unfolded one
    cfg32 = get_cfg(argparse.Namespace(config_file=BASELINE,
                                       opts=list(opts) + ['PRECISION', '32']))
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = predict(build_fiery(cfg32, state_dict=state_dict), requests[0])
        fold32 = predict(build_fiery(cfg32, state_dict=state_dict, fold_bn=True), requests[0])
    finally:
        torch.backends.cudnn.allow_tf32 = True
    diag = {'f32 folded vs unfolded': {k: rel_l2(fold32[k], v) for k, v in ref.items()},
            'bf16 unfolded vs f32': {k: rel_l2(predict(unfolded, requests[0])[k], v)
                                     for k, v in ref.items()},
            'bf16 folded vs f32': {k: rel_l2(predict(eager, requests[0])[k], v)
                                   for k, v in ref.items()}}
    for key, e in diag.items():
        log(f'{name}: {key}, relative L2 by output: '
            f'{ {k: float(f"{v:.3e}") for k, v in e.items()} }')
    if max(diag['f32 folded vs unfolded'].values()) > 2e-2:
        raise AssertionError(f'{name}: f32 folded vs unfolded relative L2 above 2e-2')
    launched = {k: v for k, v in captured.items() if v}
    log(f'{name}: captured in {build_s:.1f} s (fold, cast, {serve_graph.WARMUP} warm-ups '
        f'and a capture of each graph; launches while capturing {launched}); 3 requests '
        f'through both graphs equal the eager folded model bit for bit, ids too (ids a '
        f'request {[int(ids.max()) for ids, _ in outputs]}); no wrapper ran in a replay')
    log(f'{name}: bf16 folded vs unfolded, relative L2 by output, per request: '
        f'{[{k: float(f"{v:.3e}") for k, v in errs.items()} for _, errs in outputs]}')

    # eager (folded) and replayed, in turns on the three requests
    reps = 20
    calls = {'eager predict': lambda r: predict(eager, r),
             'graph predict': served.predict,
             'eager predict_instances': lambda r: predict_instances(eager, r),
             'graph predict_instances': served.predict_instances}
    times = in_turns(calls, requests, reps, warmup=3)
    host = {'replay': [], 'predict_instances': []}
    for i in range(reps):
        served.load(requests[i % 3])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served.replay('predict_instances')
        host['replay'].append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served.predict_instances(requests[i % 3])
        host['predict_instances'].append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    smi = smi_line()
    for key, ms in times.items():
        log(f'{name} {key}: request_ms={[round(t, 3) for t in ms]} '
            f'median_ms={statistics.median(ms):.3f} spread_ms={min(ms):.3f}-{max(ms):.3f} '
            f'({reps} in turns); {smi}')
    log(f'{name}: host us of a replay (graph launch, no sync) median '
        f'{statistics.median(host["replay"]):.1f} ({min(host["replay"]):.1f}-'
        f'{max(host["replay"]):.1f}); of a whole predict_instances before its sync '
        f'(check, copies in, replay, copies out) median '
        f'{statistics.median(host["predict_instances"]):.1f}; peak memory with the '
        f'graphs\' pool {peak} bytes ({peak - held} above the {held} held before the '
        f'capture), reserved {torch.cuda.memory_reserved()}; {smi}')

    def profile():
        """A replay's kernels against an eager folded request's, by name and count,
        each window whole (K10's launches all recorded); device busy and K10's ms
        of each, and of the unfolded model's request."""
        k10 = per_request['batch_norm']
        served.load(requests[0])

        def memsets(copies):
            return sum(n for key, n in copies.items() if key.lower().startswith('memset'))

        def differ(windows):
            (replay, replay_copies), (eager_kernels, eager_copies) = (
                windows['replay'][:2], windows['eager folded'][:2])
            if replay != eager_kernels or memsets(replay_copies) != memsets(eager_copies):
                return (f'{name}: the replay\'s kernels differ from an eager '
                        f'request\'s: {dict(replay - eager_kernels)} more, '
                        f'{dict(eager_kernels - replay)} fewer; memsets '
                        f'{dict(replay_copies)} against {dict(eager_copies)}')
            return None

        windows = alike_windows(
            {'replay': lambda: served.replay('predict_instances'),
             'eager folded': lambda: predict_instances(eager, requests[0]),
             'eager unfolded': lambda: predict_instances(unfolded, requests[0])}, k10, differ)
        replay, replay_copies = windows['replay'][:2]
        for key, (kernels, copies, busy, k10_ms) in windows.items():
            log(f'{name} profiled {key} (predict_instances): {sum(kernels.values())} kernel '
                f'launches of {len(kernels)} kernels, copies {json.dumps(copies)}; device '
                f'busy {busy:.3f} ms; K10 {sum(k10_ms.values()):.4f} ms in {k10} launches '
                f'({json.dumps({k: round(v, 4) for k, v in k10_ms.items() if v})}); '
                f'{smi_line()}')
        log(f'{name}: a replay launches the same {sum(replay.values())} kernels, by name '
            f'and count, and {memsets(replay_copies)} memsets, as an eager request')

    return profile


# the program's operators (ops/library.py) and the counters of their kernels
PROGRAM_OPS = {'bev_pool': 'bev_pool', 'bev_warp': 'bev_warp', 'topk_select': 'topk_select',
               'batch_norm': 'batch_norm', 'gru_reset_concat': 'spatial_gru',
               'gru_state_update': 'spatial_gru'}
# the names of their kernels in a profiled window (anonymous-namespace templates)
PROGRAM_KERNELS = {'bev_pool': ('::splat_count_kernel', '::splat_scan_kernel',
                                '::splat_fill_kernel', '::splat_pool_kernel'),
                   'bev_warp': ('::bev_warp_tile_kernel',),
                   'topk_select': ('::topk_select_kernel',),
                   'batch_norm': ('::apply_kernel<',),
                   'spatial_gru': ('::reset_concat', '::state_update')}


def program_nodes(program):
    """{operator: nodes} of the ``fiery_torch`` operators in an exported program."""
    nodes = Counter(str(n.target) for n in program.graph.nodes if n.op == 'call_function')
    return {k.split('.')[1]: n for k, n in nodes.items() if k.startswith('fiery_torch.')}


def phase_exported(opts=(), name='exported'):
    """The served forward as a ``torch.export`` program at full width (baseline.yml,
    PRECISION 16, batch 1, the seeded weights; export.py): exported on the card,
    which launches no kernel; its graph holds the ``fiery_torch`` operators as
    often as an eager folded forward launches their kernels (K1's four launches a
    node); written, loaded in-process (``load_exported``: ``ServedFiery`` captures
    the program's module) with the launches of the warm-ups and captures counted;
    the program's module called eagerly once, its kernels counted by the
    wrappers; three requests through the program's graphs equal to the eager
    folded model's outputs and ids and to ``ServedFiery`` of the model
    (``build_served``) bit for bit; the program's captured predict and
    predict_instances, ``ServedFiery``'s and the eager folded model's timed, 20
    each in turns. Returns (a record, the artifact's path and the requests, whose
    answers ``program_fresh_process`` takes in another process, the in-process
    answers, a closure that profiles a replay of the program's predict against an
    eager folded forward: the same kernels by name and count)."""
    from fiery_tpu_torch import export as export_lib
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=list(opts)))
    state_dict = seeded_state_dict(cfg, seed=0)
    eager = build_fiery(cfg, state_dict=state_dict, fold_bn=True)
    requests = [make_request(cfg, seed=10 + i) for i in range(3)]
    predict_instances(eager, requests[0])
    torch.cuda.synchronize()
    reset_counters()
    _, _, bn_launches, census = count_bn_calls(eager, lambda: predict(eager, requests[0]))
    per_forward = {k: fn.launches for k, fn in COUNTERS.items()}
    reset_counters()
    predict_instances(eager, requests[0])
    per_request = {k: fn.launches for k, fn in COUNTERS.items()}

    reset_counters()
    t0 = time.perf_counter()
    blob, _, program = export_lib.export_model(cfg, state_dict=state_dict)
    export_s = time.perf_counter() - t0
    traced = {k: fn.launches for k, fn in COUNTERS.items() if fn.launches}
    if traced:
        raise AssertionError(f'{name}: the export launched kernels: {traced}')
    nodes = program_nodes(program)
    want_nodes = {'bev_pool': per_forward['bev_pool'] // BEV_POOL_KERNELS,
                  'bev_warp': per_forward['bev_warp'], 'topk_select': per_forward['topk_select'],
                  'batch_norm': len(census),
                  'gru_reset_concat': per_forward['spatial_gru'] // 2,
                  'gru_state_update': per_forward['spatial_gru'] // 2}
    if nodes != {k: n for k, n in want_nodes.items() if n}:
        raise AssertionError(f'{name}: the program\'s operators {nodes}, expected {want_nodes}')
    if not all(nodes.get(k) for k in ('bev_pool', 'batch_norm', 'gru_reset_concat',
                                        'gru_state_update')):
        raise AssertionError(f'{name}: K1, K10 or K11 missing from the program: {nodes}')
    directory = tempfile.mkdtemp(prefix='fiery_program_')
    path = os.path.join(directory, 'model.fiery')
    with open(path, 'wb') as f:
        f.write(blob)

    reset_counters()
    t0 = time.perf_counter()
    loaded = export_lib.load_exported(path)
    load_s = time.perf_counter() - t0
    captured = {k: fn.launches for k, fn in COUNTERS.items()}
    runs = serve_graph.WARMUP + 1
    expected = {k: n * runs * (1 if k in DECODE_KERNELS else 2) for k, n in per_request.items()}
    if captured != expected:
        raise AssertionError(f'{name}: launches while loading and capturing {captured}, '
                             f'expected {expected}')
    layout_report()
    # the program's module called eagerly: its operators launch the kernels
    reset_counters()
    with torch.inference_mode():
        loaded.model(*(loaded.static[k] for k in serve_graph.INPUTS))
    torch.cuda.synchronize()
    program_launches = {k: fn.launches for k, fn in COUNTERS.items()}
    if program_launches != per_forward:
        raise AssertionError(f'{name}: the program\'s module launched {program_launches}, '
                             f'an eager folded forward {per_forward}')
    layout_report()

    served = build_served(cfg, state_dict)
    answers = []
    for i, (want, ids) in enumerate(replays_match_eager(name, loaded, eager, requests)):
        other, other_ids = served.predict_instances(requests[i])
        bare = loaded.predict(requests[i])
        differ = {k: bits_differ(other[k], v) + bits_differ(bare[k], v) for k, v in want.items()}
        differ['ids'] = int((other_ids != ids).sum())
        if any(differ.values()):
            raise AssertionError(f'{name}: request {i}: values whose bits differ between '
                                 f'the program and ServedFiery: {differ}')
        answers.append(({k: v.cpu() for k, v in bare.items()}, ids.cpu()))
    log(f'{name}: exported in {export_s:.1f} s ({os.path.getsize(path)} bytes; operators '
        f'{nodes}; no launch while tracing), loaded and captured in {load_s:.1f} s '
        f'(launches {({k: v for k, v in captured.items() if v})}); its module launches '
        f'{({k: v for k, v in program_launches.items() if v})} a forward, as the eager '
        f'folded model; 3 requests through its graphs equal the eager folded model and '
        f'ServedFiery bit for bit, ids too')

    reps = 20
    calls = {'program predict': loaded.predict, 'ServedFiery predict': served.predict,
             'eager folded predict': lambda r: predict(eager, r),
             'program predict_instances': loaded.predict_instances,
             'ServedFiery predict_instances': served.predict_instances,
             'eager folded predict_instances': lambda r: predict_instances(eager, r)}
    times = in_turns(calls, requests, reps, warmup=3)
    smi = smi_line()
    for key, ms in times.items():
        log(f'{name} {key}: request_ms={[round(t, 3) for t in ms]} '
            f'median_ms={statistics.median(ms):.3f} spread_ms={min(ms):.3f}-{max(ms):.3f} '
            f'({reps} in turns); {smi}')
    record = {'export_s': export_s, 'load_s': load_s, 'bytes': os.path.getsize(path),
              'nodes': nodes, 'program_launches': {k: v for k, v in program_launches.items()
                                                   if v},
              'ms': {k: statistics.median(v) for k, v in times.items()}}

    def profile():
        """A replay of the program's predict against an eager folded forward and a
        replay of ServedFiery's: the same kernels by name and count, K1, K2 or K5,
        K10 and K11 among them; device busy of each."""
        loaded.load(requests[0])
        served.load(requests[0])

        def differ(windows):
            eager_kernels = windows['eager folded'][0]
            for key in ('program replay', 'ServedFiery replay'):
                if windows[key][0] != eager_kernels:
                    return (f'{name}: the {key}\'s kernels differ from an eager folded '
                            f'forward\'s: {dict(windows[key][0] - eager_kernels)} more, '
                            f'{dict(eager_kernels - windows[key][0])} fewer')
            return None

        windows = alike_windows({'program replay': lambda: loaded.replay('predict'),
                                 'ServedFiery replay': lambda: served.replay('predict'),
                                 'eager folded': lambda: predict(eager, requests[0])},
                                bn_launches, differ)
        program_kernels = windows['program replay'][0]
        ours = {k: sum(n for kern, n in program_kernels.items() if any(s in kern for s in syms))
                for k, syms in PROGRAM_KERNELS.items()}
        want = {k: per_forward[k] for k in PROGRAM_KERNELS}
        if ours != want or not all(ours[k] for k in ('bev_pool', 'batch_norm', 'spatial_gru')) \
                or not (ours['bev_warp'] or ours['topk_select']):
            raise AssertionError(f'{name}: the program replay\'s kernels {ours}, expected {want}')
        for key, (kernels, copies, busy, k10_ms) in windows.items():
            log(f'{name} profiled {key} (predict): {sum(kernels.values())} kernel launches '
                f'of {len(kernels)} kernels, copies {json.dumps(copies)}; device busy '
                f'{busy:.3f} ms; K10 {sum(k10_ms.values()):.4f} ms; {smi_line()}')
        log(f'{name}: a replay of the program launches the same {sum(program_kernels.values())} '
            f'kernels, by name and count, as an eager folded forward (ours: {ours})')
        record['replay_busy_ms'] = windows['program replay'][2]

    return record, (path, requests), answers, profile


PROGRAM_CHILD = r"""
import sys
import time
import torch
from fiery_tpu_torch.ops import library  # noqa: F401
from fiery_tpu_torch import export

answers, modules = [], None
for path, requests_path in zip(sys.argv[2::2], sys.argv[3::2]):
    t0 = time.perf_counter()
    served = export.load_exported(path)
    load_s = time.perf_counter() - t0
    got = []
    for request in torch.load(requests_path):
        out, ids = served.predict_instances(request)
        got.append(({k: v.cpu() for k, v in served.predict(request).items()}, ids.cpu()))
    answers.append((got, load_s))
    del served
modules = sorted(m for m in sys.modules if m.split('.')[0] in ('fiery_tpu', 'fiery_tpu_torch'))
torch.save({'answers': answers, 'modules': modules}, sys.argv[1])
"""


def program_fresh_process(items):
    """Each (name, (artifact path, requests), in-process answers) loaded and answered
    in one fresh python3 process that imports only ``ops/library.py`` and
    ``export.py``: no module of ``fiery_tpu_torch.models`` (or of the JAX package)
    imported, every output and the ids equal to the in-process program's bit for
    bit. Removes the artifacts' directories."""
    directory = os.path.dirname(items[0][1][0])
    args = [os.path.join(directory, 'answers.pt')]
    for i, (_, (path, requests), _) in enumerate(items):
        args += [path, os.path.join(directory, f'requests{i}.pt')]
        torch.save([{k: torch.from_numpy(v) for k, v in r.items()} for r in requests], args[-1])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', PROGRAM_CHILD] + args,
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f'the fresh process failed (rc {proc.returncode}):\n'
                             f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
    result = torch.load(args[0], weights_only=False)
    bad = [m for m in result['modules']
           if m.startswith('fiery_tpu_torch.models') or m.split('.')[0] == 'fiery_tpu']
    if bad or 'fiery_tpu_torch.ops.library' not in result['modules']:
        raise AssertionError(f'the fresh process imported {bad}')
    for (name, _, want), (got, load_s) in zip(items, result['answers']):
        for i, ((w_out, w_ids), (g_out, g_ids)) in enumerate(zip(want, got)):
            differ = {k: bits_differ(g_out[k], v) for k, v in w_out.items()}
            differ['ids'] = int((g_ids != w_ids).sum())
            if sorted(g_out) != sorted(w_out) or any(differ.values()):
                raise AssertionError(f'{name}: request {i} in the fresh process: {differ}')
        log(f'{name}: loaded in a fresh process in {load_s:.1f} s (its modules: '
            f'{len(result["modules"])} of fiery_tpu_torch, none of models); 3 requests equal '
            f'the in-process program bit for bit')
    log(f'fresh process: {time.perf_counter() - t0:.1f} s in all')
    shutil.rmtree(directory, ignore_errors=True)
    for _, (path, _), _ in items[1:]:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)


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
    coarse = torch.rand((T, -(-H // 8), -(-W // 8)), generator=g)
    smooth = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :H, :W]
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


def group_frames(rng, B, h, w, K, C, device):
    """B frames of K centres at random pixels (80 % valid), offsets of 4 pixels'
    spread and C-class logits."""
    centers = np.stack([rng.randint(0, h, (B, K)), rng.randint(0, w, (B, K))], -1)
    return (torch.from_numpy(centers.astype(np.int32)).to(device),
            torch.from_numpy(rng.rand(B, K) < 0.8).to(device),
            torch.from_numpy((rng.randn(B, h, w, 2) * 4.0).astype(np.float32)).to(device),
            torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32)).to(device))


def group_near_ties(rng, B, h, w, K, C, device):
    """group_frames with each pixel moved onto the bisector of its two nearest valid
    centres: a third to their midpoint (equal distances), a third to the bisector's
    nearest point (a few f32 ulps apart), a third there and one ulp along a row."""
    centers, valid, offset, logits = group_frames(rng, B, h, w, K, C, device)
    grid = torch.stack(torch.meshgrid(torch.arange(h, device=device),
                                      torch.arange(w, device=device), indexing='ij'), -1)
    p = grid[None].double() + offset.double()
    c = centers.double()
    d = ((c[:, :, None, None] - p[:, None]) ** 2).sum(-1)
    d[~valid] = float('inf')
    two = torch.sort(d, dim=1, stable=True).indices[:, :2]
    del d
    frames = torch.arange(B, device=device)[:, None, None]
    a, b = c[frames, two[:, 0]], c[frames, two[:, 1]]
    mid = (a + b) / 2
    u = b - a
    u = u / u.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    onto = p - ((p - mid) * u).sum(-1, keepdim=True) * u
    kind = torch.from_numpy(rng.randint(0, 3, (B, h, w))).to(device)
    q = torch.where((kind == 0)[..., None], mid, onto).float()
    step = torch.where(torch.from_numpy(rng.rand(B, h, w) < 0.5).to(device),
                       float('inf'), float('-inf'))
    q[..., 0] = torch.where(kind == 2, torch.nextafter(q[..., 0], step), q[..., 0])
    return centers, valid, (q - grid.float()).contiguous(), logits


def group_pixels_cases(device):
    """(name, K7's arguments) of the cases tests/test_torch_group_gpu.py holds, 5
    frames each."""
    for case, K, (h, w), C in [
            ('random', 100, (200, 200), 2), ('random', 1, (200, 200), 2),
            ('random', 1024, (200, 200), 3), ('random', 100, (400, 200), 3),
            ('random', 100, (320, 193), 2), ('random', 1024, (320, 193), 2),
            ('random', 100, (320, 192), 3), ('random', 1024, (320, 192), 2),
            ('near ties', 100, (200, 200), 2), ('near ties', 1024, (200, 200), 2),
            ('near ties', 100, (320, 193), 3), ('near ties', 100, (320, 192), 2),
            ('no valid centre', 100, (200, 200), 2),
            ('no foreground', 100, (200, 200), 3), ('non-finite', 100, (200, 200), 2),
            ('band of rows', 100, (200, 200), 2), ('band of columns', 100, (320, 193), 2)]:
        rng = np.random.RandomState(K + h + C + len(case))
        make = group_near_ties if case == 'near ties' else group_frames
        centers, valid, offset, logits = make(rng, 5, h, w, K, C, device)
        if case == 'band of rows':
            centers[..., 0] = torch.from_numpy(rng.randint(0, 3, (5, K))).to(device)
        if case == 'band of columns':
            centers[..., 1] = torch.from_numpy(rng.randint(190, 193, (5, K))).to(device)
        if case == 'no valid centre':
            valid[0] = False
        if case == 'no foreground':
            logits[0, ..., 1] = logits[0].min() - 1.0
        if case == 'non-finite':
            offset[0, 3, :10, 0] = float('nan')
            offset[0, 4, :10, 1] = float('inf')
            offset[1, 5, :10, 0] = float('-inf')
            offset[1, 6, :5] = 3e38
            logits[0, 7, :10, 0] = float('nan')
            logits[1, 8, :10, 1] = float('nan')
            valid[1, 0] = False
        yield f'{case} K = {K} {h} x {w} C = {C}', (centers, valid, offset, logits)


def phase_decode_kernels(device, outputs):
    """K6-K9 against their plain versions at the shapes of the served request:
    K6 and K7 on the served heads and on planted inputs (exactly; K7 also on
    ``group_pixels_cases``), K8 on the served
    ids and flow (within one f32 ulp), K9 on seeded tracker costs (exactly, and its
    total within 1e-3 of scipy's optimum) and on ``lap_problem_sets``. Times each,
    K9 also against its latency bound (``warp_min_ns``) and by ``lap_breakdown``."""
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
    # K6 alone, exactly: a request's frames with no peak (every score -inf: the
    # centres are pixels 0..99, all invalid), one flat plateau above the threshold
    # (every pixel a peak, all tied), and the literature families' grids (400 x 200,
    # 320 x 193, and fishing_setting.yml's 320 x 192) on the served heads' values and
    # on 3-level plateaus
    gk = torch.Generator(device=device).manual_seed(11)
    grids = [(f'{name} {h2} x {w2}', c) for h2, w2 in ((400, 200), (320, 193), (320, 192))
             for name, c in (('served values', center.flatten()[torch.randint(
                 0, center.numel(), (T, h2, w2), generator=gk, device=device)]),
                             ('plateaus', planted_heatmaps(device, T, h2, w2)))]
    for name, c in [('no peak', torch.full((T, H, W), 0.05, device=device)),
                    ('flat plateau', torch.full((T, H, W), 0.5, device=device))] + grids:
        ck, vk = find_instance_centers(c)
        cp, vp = find_instance_centers_plain(c)
        torch.cuda.synchronize()
        if not (torch.equal(ck, cp) and torch.equal(vk, vp)):
            raise AssertionError(f'instance_centers {name}: kernel != plain')
        log(f'  instance_centers {name}: equal to plain; valid centres per frame '
            f'{vp.sum(1).tolist()}')

    # K7 alone, exactly: random centres at K = 1, 100 and 1,024, planted near-ties, a
    # frame with no valid centre and one with no foreground, non-finite offsets and
    # logits, 400 x 200, 320 x 193 and 320 x 192 grids, C = 2 and 3
    for name, args in group_pixels_cases(device):
        got, want = instance_ids(*args), instance_ids_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f'group_pixels {name}: kernel != plain at '
                                 f'{int((got != want).sum())} pixels')
        log(f'  group_pixels {name}: equal to plain; ids per frame '
            f'{want.reshape(want.shape[0], -1).amax(1).tolist()}')
        del got, want, args
    torch.cuda.empty_cache()

    def topk_library():
        x = torch.where(center >= 0.1, center, -1.0)
        pooled = F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]
        scores = torch.where((x == pooled) & (x > 0), x, -float('inf')).view(T, -1)
        return torch.topk(scores, 100)

    nbytes = center.numel() * 4 + T * 100 * 9
    rec['instance_centers'] = dict(
        max_abs_err=0.0, ms=kernel_ms(lambda: find_instance_centers(center),
                                      ['::centers_cluster_kernel'], 1),
        call_ms=time_ms(lambda: find_instance_centers(center)),
        plain_ms=time_ms(lambda: find_instance_centers_plain(center)),
        library_ms=time_ms(topk_library), bytes=nbytes, flops=10.0 * center.numel())
    # the selection's share: no peak (no radix select, no sort) and every pixel a
    # tied peak
    for key, value in (('no_peak', 0.05), ('flat_plateau', 0.5)):
        c = torch.full((T, H, W), value, device=device)
        rec['instance_centers'][f'ms_{key}'] = kernel_ms(lambda: find_instance_centers(c),
                                                         ['::centers_cluster_kernel'], 1)

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
                                      ['::group_cluster_kernel'], 1),
        call_ms=time_ms(lambda: instance_ids(centers, valid, offset, seg)),
        plain_ms=time_ms(lambda: instance_ids_plain(centers, valid, offset, seg)),
        library_ms=time_ms(argmin_library), bytes=nbytes, flops=pair_ops)

    # K8: the tracker's one launch for the clip (101 slots: every frame's ids), on
    # the served ids and flow, against the plain version on the host: grid centres
    # and valid equal, flow centres within one f32 ulp; two calls with the same bits
    flow_all = out['instance_flow'].reshape(T, H, W, 2).contiguous()
    K = 101
    got = segment_centroids_clip(decoded, K, flow_all)
    again = segment_centroids_clip(decoded, K, flow_all)
    want = segment_centroids_clip_plain(decoded.cpu(), K, flow_all.cpu())
    torch.cuda.synchronize()
    grid_bits = bits_differ(got[0].cpu(), want[0])
    diff = (got[1].cpu() - want[1]).abs()
    twice = sum(bits_differ(a, b) for a, b in zip(got[:2], again[:2])) + int(
        (got[2] != again[2]).sum())
    if grid_bits or not torch.equal(got[2].cpu(), want[2]) or bool(
            (diff > ulp32(want[1])).any()) or twice:
        raise AssertionError(f'segment_centroids_clip: grid bits differ in {grid_bits}, flow '
                             f'max err {float(diff.max())}, two calls differ in {twice}')
    err = float(diff.max())
    # the single-kind entry at 501 slots with flow and at 101 without (the two calls of
    # a tracking step before the clip entry), within one f32 ulp
    for labels, slots, f in ((decoded[:1].contiguous(), T * 100 + 1, flow_all[:1]),
                             (decoded[1:2].contiguous(), 101, None)):
        ck, vk = segment_centroids(labels, slots, f)
        cp, vp = segment_centroids_plain(labels.cpu(), slots, None if f is None else f.cpu())
        dk = (ck.cpu() - cp).abs()
        if not torch.equal(vk.cpu(), vp) or bool((dk > ulp32(cp)).any()):
            raise AssertionError(f'segment_centroids ({slots} slots): kernel differs from '
                                 f'plain by more than one f32 ulp (max {float(dk.max())})')
        err = max(err, float(dk.max()))

    def centroid_library():
        """The same function in PyTorch calls: ids outside [0, K) to a spare slot per
        frame, the counts and the grid and advected coordinate sums by index_add_ in
        f64, the means."""
        ids = decoded.reshape(T, -1).long()
        ids = torch.where((ids >= 0) & (ids < K), ids, K)
        ids = (ids + torch.arange(T, device=device)[:, None] * (K + 1)).reshape(-1)
        gx = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(T, H, W)
        gy = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(T, H, W)
        counts = torch.zeros(T * (K + 1), dtype=torch.float64, device=device).index_add_(
            0, ids, torch.ones(ids.numel(), dtype=torch.float64, device=device))
        sums = torch.zeros((T * (K + 1), 4), dtype=torch.float64, device=device).index_add_(
            0, ids, torch.stack([gx, gy, gx + flow_all[..., 0], gy + flow_all[..., 1]],
                                -1).reshape(-1, 4).double())
        mean = (sums / counts[:, None].clamp_min(1.0)).float().view(T, K + 1, 4)[:, :K]
        return mean[..., :2], mean[..., 2:], counts.view(T, K + 1)[:, :K] > 0

    lib = centroid_library()
    if (bits_differ(lib[0].cpu(), want[0]) or not torch.equal(lib[2].cpu(), want[2])
            or bool(((lib[1].cpu() - want[1]).abs() > ulp32(want[1])).any())):
        raise AssertionError('segment_centroids_clip: the library calls do not compute the '
                             'kernel\'s function')
    fn = _build.load('segment_centroids').fiery_empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def empty():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError('empty kernel launch failed')

    nbytes = decoded.numel() * 4 + flow_all.numel() * 4 + T * K * (8 + 8 + 1)
    rec['segment_centroids'] = dict(
        max_abs_err=err, ms=kernel_ms(lambda: segment_centroids_clip(decoded, K, flow_all),
                                      ['::centroid_clip_kernel'], 1),
        call_ms=time_ms(lambda: segment_centroids_clip(decoded, K, flow_all)),
        plain_ms=time_ms(lambda: segment_centroids_clip_plain(decoded, K, flow_all)),
        library_ms=time_ms(centroid_library), bytes=nbytes, flops=5.0 * decoded.numel(),
        launch_floor_ms=kernel_ms(empty, ['::empty_kernel'], 1),
        ms_501_slots=kernel_ms(lambda: segment_centroids(decoded[:1].contiguous(), T * 100 + 1,
                                                         flow_all[:1]),
                               ['::centroid_clip_kernel'], 1))
    log(f'  segment_centroids_clip: grid centres and valid equal to plain on the host, flow '
        f'centres within one f32 ulp (max abs err {err:.3e}); two calls the same bits')

    # K9
    n_rows = [1, 8, 101]
    cost = torch.from_numpy(tracker_costs(n_rows, seed=5)).to(device)
    rows_t = torch.tensor(n_rows, dtype=torch.int32, device=device)
    got = linear_sum_assignment(cost, rows_t)
    want = linear_sum_assignment_plain(cost, rows_t)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError('lap: kernel col4row != plain')
    lap_problem_sets(device)
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
    min_ns = warp_min_ns()
    breakdown = lap_breakdown(cost[2:3])
    rec['lap'] = dict(
        max_abs_err=0.0, ms=kernel_ms(lambda: linear_sum_assignment(full, full_rows),
                                      ['lap_kernel'], 1),
        call_ms=time_ms(lambda: linear_sum_assignment(full, full_rows)),
        plain_ms=time_ms(lambda: linear_sum_assignment_plain(full, full_rows), reps=3,
                         warmup=1),
        library_ms=None, scipy_ms=scipy_ms, bytes=full.numel() * 4 + 4 + 101 * 4,
        flops=3.0 * 101 * steps, steps=steps, warp_min_ns=min_ns,
        latency_bound_ms=steps * min_ns * 1e-6, **breakdown)
    rec['lap']['latency_share'] = rec['lap']['latency_bound_ms'] / rec['lap']['ms']
    for name, r in rec.items():
        r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['flops'], F64_FLOPS_PER_S if
                                             name == 'segment_centroids' else F32_FLOPS_PER_S)
        log(f'  {name}: ' + json.dumps({k: v for k, v in r.items() if k != 'max_abs_err'}))
    return rec


def lap_problem_sets(device):
    """K9 against its plain version (on the host, where a Dijkstra step costs no
    synchronisation), col4row exactly, on the problems beyond the tracker's: 101 x
    101 integer costs in {0, .., 4}, where most steps meet tied minima, with n_rows
    1, 8 and 101; tracker costs with a row of +inf, a row of NaN, and two rows that
    can only take one column (the second must stay -1); and random costs at n = 17
    and 40 (one and two columns a lane), 200 (the matrix staged in over 48 KB of
    shared memory), 238 (read from global memory) and 1024, the limit."""
    rng = np.random.RandomState(9)
    nonfinite = tracker_costs([101, 101], seed=11)
    nonfinite[0, 3] = np.inf
    nonfinite[1, 7] = np.nan
    nonfinite[1, [9, 12]] = np.inf
    nonfinite[1, [9, 12], 5] = 1.0
    sets = [('integers', rng.randint(0, 5, (3, 101, 101)).astype(np.float32), [1, 8, 101]),
            ('non-finite rows', nonfinite, [101, 101])]
    sets += [(f'n={n}', rng.rand(1, n, n).astype(np.float32), [n])
             for n in (17, 40, 200, 238, 1024)]
    for name, cost, n_rows in sets:
        cost, rows_t = torch.from_numpy(cost), torch.tensor(n_rows, dtype=torch.int32)
        t0 = time.perf_counter()
        want = linear_sum_assignment_plain(cost, rows_t)
        plain_s = time.perf_counter() - t0
        got = linear_sum_assignment(cost.to(device), rows_t.to(device)).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f'lap {name}: kernel col4row != plain at '
                                 f'{int((got != want).sum())} rows')
        if name == 'non-finite rows' and not (got[0, 3] == got[1, 7] == got[1, 12] == -1):
            raise AssertionError('lap: a row without a finite path was assigned')
        log(f'  lap {name}: equal to plain ({linear_sum_assignment_plain.steps} Dijkstra '
            f'steps, plain {plain_s:.1f} s on the host)')


def lap_breakdown(cost, n_rows=(0, 1, 8, 30, 60, 101)):
    """Where K9's time goes on one (1, n, n) tracker problem: its device ms at each
    count of rows to augment, against those rows and the Dijkstra steps they take
    (the plain version counts them); a least-squares fit gives the µs of a launch,
    of a row and of a step."""
    fit = []
    for nr in n_rows:
        rows_t = torch.tensor([nr], dtype=torch.int32, device=cost.device)
        linear_sum_assignment_plain(cost.cpu(), rows_t.cpu())
        fit.append((nr, linear_sum_assignment_plain.steps, kernel_ms(
            lambda: linear_sum_assignment(cost, rows_t), ['lap_kernel'], 1)))
    A = np.array([[1.0, nr, steps] for nr, steps, _ in fit])
    coef = np.linalg.lstsq(A, np.array([ms for _, _, ms in fit]), rcond=None)[0] * 1e3
    log('  lap device ms by rows (Dijkstra steps): '
        + json.dumps({f'{nr} ({steps})': ms for nr, steps, ms in fit}))
    return dict(launch_us=float(coef[0]), row_us=float(coef[1]), step_us=float(coef[2]))


def warp_min_ns(iters=(1 << 16, 1 << 20)):
    """ns of one dependent warp-wide minimum (redux.sync) on the card: one warp runs
    a chain of them (csrc/lap.cu fiery_lap_min_chain), timed with CUDA events at
    two chain lengths; the difference over the difference of lengths."""
    fn = _build.load('lap').fiery_lap_min_chain
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, dtype=torch.int32, device='cuda')

    def chain(n):
        rc = fn(n, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f'min chain launch failed: CUDA error {rc}')

    short, long_ = (time_ms(lambda n=n: chain(n), reps=5, warmup=1) for n in iters)
    return 1e6 * (long_ - short) / (iters[1] - iters[0])


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


def stage_times(trainer, batch, generator, sync):
    """Time of each stage of one training step. sync=False: CUDA events recorded on
    the current stream between the stages of Trainer.train_step, each stage's span
    including its host launch gaps. sync=True: the host clock between stages with
    torch.cuda.synchronize() at each boundary, so that every stage's device work
    is inside its own span and the stages sum to the step. Also returns whether
    the autograd engine's backward ran on the stream the events are recorded on
    (read in a gradient hook on the loss)."""
    names = ['H2D copy of the batch', 'label prep (K4, or the prewarped stack)',
             'forward', 'losses (K3)', 'backward', 'clip + Adam']
    marks = []

    def mark():
        if sync:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        else:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    main_stream = torch.cuda.current_stream()
    backward_streams = []
    mark()
    batch = trainer.to_device(batch)
    mark()
    labels, fdi = trainer.prepare_future_labels(batch)
    mark()
    output = trainer.model(*(batch[k] for k in INPUTS), fdi, generator=generator)
    mark()
    total = sum(compute_losses(output, labels, trainer.uncertainty, trainer.cfg).values())
    total.register_hook(lambda g: backward_streams.append(torch.cuda.current_stream()))
    mark()
    trainer.optimizer.zero_grad(set_to_none=True)
    total.backward()
    mark()
    trainer.apply_gradients()
    mark()
    if sync:
        times = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    else:
        marks[-1].synchronize()
        times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    same = all(st == main_stream for st in backward_streams)
    return dict(zip(names, times)), same


def phase_train(n_steps=3, kind='dense', opts=()):
    """Full-width baseline.yml training at batch 3 (PRECISION 16: f32 weights, bf16
    compute), seeded random weights with BatchNorm calibrated as for serving,
    synthetic clips, with the config overrides ``opts``; under
    DATASET.PREWARP_LABELS each batch's label stack is warped on the host before
    its step, outside the step's time. One warm-up step, then the main path:
    n_steps timed steps with the launch counts read around them, held to
    ``expected_launches``."""
    name = 'train' if kind == 'dense' else f'train {kind}'
    held = torch.cuda.memory_allocated()       # what earlier phases still hold
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE,
                                     opts=['DATASET.NAME', 'synthetic', *opts]))
    trainer = Trainer(cfg)
    init_params(trainer.model, seed=0)
    calibrate_batchnorm(trainer.model, [make_request(cfg, seed=s) for s in (6, 7)])
    b = cfg.BATCHSIZE
    t0 = time.perf_counter()
    dataset = SyntheticFutureDataset(cfg, n_samples=b * (n_steps + 2), seed=0)
    batches = [dataset.get_batch(range(i * b, (i + 1) * b)) for i in range(n_steps + 2)]
    log(f'{name}: {len(batches)} synthetic batches of {b} clips in '
        f'{time.perf_counter() - t0:.1f} s')
    prewarp_ms = None
    if cfg.DATASET.PREWARP_LABELS:
        transform, prewarp_ms = make_prewarp_transform(cfg), []
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            batches[i] = transform(batch)
            prewarp_ms.append(1e3 * (time.perf_counter() - t0))
        log(f'{name}: host label prewarp ms per batch of {b} clips (numpy, outside the '
            f'step): {[round(t, 3) for t in prewarp_ms]}')
        prewarp_ms = statistics.median(prewarp_ms)
    # drop-connect masks and the latent noise drawn on the card
    gen = torch.Generator(device='cuda').manual_seed(0)
    # warm-up: cuDNN plans, kernel loads; and the BatchNorm calls of a step
    _, bn_calls, bn_launches, census = count_bn_calls(
        trainer.model, lambda: trainer.train_step(batches[0], gen))
    torch.cuda.synchronize()
    m = trainer.model
    watched = {'stem conv': m.encoder.backbone._conv_stem.weight,
               'future distribution': m.future_distribution.last_conv[1].weight,
               'segmentation head': m.decoder.segmentation_head[3].weight,
               'segmentation uncertainty': trainer.uncertainty['segmentation_weight'],
               'stem BN running var': m.encoder.backbone._bn0.running_var,
               'decoder BN running mean': m.decoder.bn1.running_mean,
               'future distribution BN running var':
                   m.future_distribution.encoder.model[0].layers.abn[0].running_var}
    before = {k: v.detach().clone() for k, v in watched.items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, records = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        losses, total = trainer.train_step(batches[1 + i], gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        records.append({'total': float(total), **{k: float(v) for k, v in losses.items()}})
    launches = {k: COUNTERS[k].launches for k in TRAIN_KERNELS}
    layouts = layout_report()
    peak = torch.cuda.max_memory_allocated()
    for r in records:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f'{name}: non-finite losses {r}')
    check_launches(name, {k: fn.launches for k, fn in COUNTERS.items()},
                   expected_launches(trainer.model.cfg, cfg, bn_launches, bn_calls), n_steps)
    for k, v in watched.items():
        if torch.equal(v.detach(), before[k]):
            raise AssertionError(f'{name}: {k} did not change')
    log(f'{name} (main path): step_ms={[round(x, 3) for x in times]} '
        f'median_step_ms={statistics.median(times):.3f} peak_mem_bytes={peak} '
        f'(of which {held} held by earlier phases) launches={launches}')
    for i, r in enumerate(records):
        log(f'  step {i} losses: ' + json.dumps({k: round(v, 5) for k, v in r.items()}))
    log(f'{name}: parameters, uncertainty weights and BatchNorm statistics changed')
    log(f'{name}: {bn_calls} BatchNorm calls per step; per {n_steps} steps '
        f'{json.dumps(layouts)}')
    fwd_census, bwd_census = census_bound(census), census_bound(census, backward=True)
    log(f'{name} K10 census: {bn_calls} calls; forward {fwd_census[1]:.4f} GB, summed bound '
        f'{fwd_census[2]:.4f} ms; backward {bwd_census[1]:.4f} GB, summed bound '
        f'{bwd_census[2]:.4f} ms (inputs read once, outputs written once, 3.35 TB/s); '
        f'channel counts {sorted({c[0][1] for c in census})}')

    # no host sync from the batch's arrival on the card to the end of the step's
    # device work (the drop-connect masks and the noise are drawn on the card)
    on_card = trainer.to_device(batches[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode('error')
    try:
        trainer.train_step(on_card, gen)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    log(f'{name}: a step from the batch on the card ran under set_sync_debug_mode("error") '
        f'in {1e3 * (time.perf_counter() - t0):.3f} ms')
    del on_card

    stages, same_stream = stage_times(trainer, batches[-1], gen, sync=False)
    log(f'{name} stages (CUDA events between stages, ms): '
        + json.dumps({k: round(v, 3) for k, v in stages.items()})
        + f' sum {sum(stages.values()):.3f}; backward on the events\' stream: {same_stream}')
    stages, _ = stage_times(trainer, batches[-1], gen, sync=True)
    log(f'{name} stages (host clock, synchronized between stages, ms): '
        + json.dumps({k: round(v, 3) for k, v in stages.items()})
        + f' sum {sum(stages.values()):.3f}')
    rec = dict(step_ms=statistics.median(times), peak_bytes=peak, held_bytes=held,
               stages=stages, prewarp_ms=prewarp_ms)

    def profile():
        """One step under torch.profiler: the device busy time and the top kernels.
        Called after every timed phase, so that no timed step runs after the
        profiler has hooked into the process."""
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=activities) as prof:
            trainer.train_step(batches[-1], gen)
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        # device-side kernels and copies; not the ranges that user annotations
        # (Optimizer.step) span on the device timeline, which hold kernels of their own
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
        rec['busy_ms'] = sum(e.self_device_time_total for e in events) / 1e3
        n_kernels = sum(e.count for e in events)
        log(f'{name} profiled step: wall {wall:.3f} ms (profiler on), device busy '
            f'{rec["busy_ms"]:.3f} ms, {n_kernels} device-side kernels and copies')
        k10 = k10_device_ms(events)
        rec['k10_ms'] = sum(k10.values())
        log(f'{name} profiled step: K10 {rec["k10_ms"]:.4f} ms '
            f'({json.dumps({k: round(v, 4) for k, v in k10.items()})}) against its summed '
            f'bound {fwd_census[2] + bwd_census[2]:.4f} ms (forward {fwd_census[2]:.4f}, '
            f'backward {bwd_census[2]:.4f}); {smi_line()}')
        # the selects' device ms and launches in this step: K3 (both configurations),
        # K5 and its backward (the combination)
        for key, symbol in (('k3', '::kth_largest_kernel<'), ('k5', '::topk_select_kernel<'),
                            ('k5b', '::topk_select_backward_kernel<')):
            mine = [e for e in events if symbol in e.key]
            rec[f'{key}_ms'] = sum(e.self_device_time_total for e in mine) / 1e3
            rec[f'{key}_launches'] = sum(e.count for e in mine)
        log(f'{name} profiled step: K3 {rec["k3_ms"]:.4f} ms ({rec["k3_launches"]} launches), '
            f'K5 {rec["k5_ms"]:.4f} ms ({rec["k5_launches"]}), K5 backward '
            f'{rec["k5b_ms"]:.4f} ms ({rec["k5b_launches"]})')
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
            log(f'  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:110]}')

    def step():
        """One more step, on a batch of the timed run: its wall ms."""
        t0 = time.perf_counter()
        trainer.train_step(batches[1], gen)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    return launches, rec, types.SimpleNamespace(step=step, profile=profile)


LOOP_DENSE = ('bev_pool', 'bev_pool_backward', 'bev_warp', 'bev_warp_backward', 'kth_largest',
              'bev_warp_nearest', 'batch_norm', 'batch_norm_backward', 'spatial_gru',
              'spatial_gru_backward', 'instance_centers', 'group_pixels')
LOOP_COMBO = ('bev_pool', 'bev_pool_backward', 'kth_largest', 'topk_select',
              'topk_select_backward', 'batch_norm', 'batch_norm_backward', 'spatial_gru',
              'spatial_gru_backward', 'instance_centers', 'group_pixels')
EVAL_KERNELS = ('bev_pool', 'bev_warp', 'bev_warp_nearest', 'batch_norm', 'spatial_gru',
                'instance_centers', 'group_pixels')


def path_launches(name, run, expected, absent=()):
    """Reset the counters, run a path, and require a launch of each expected kernel
    and none of the absent ones; returns the counts."""
    reset_counters()
    result = run()
    launches = {k: COUNTERS[k].launches for k in COUNTERS}
    layout_report()
    missing = [k for k in expected if not launches[k]]
    present = [k for k in absent if launches[k]]
    if missing or present:
        raise AssertionError(f'{name}: kernels not launched {missing}, launched but '
                             f'not on the path {present}: {launches}')
    log(f'{name} (main path) launches: {json.dumps({k: v for k, v in launches.items() if v})}')
    return result, launches


def loop_walls(name, run):
    """The loop's steps by the host clock: the wait on the loader, and the rest of
    each step (LOGGING_INTERVAL 1: every step ends in a synchronising read), and
    the ms of each step's video where the run drew one (outside the step)."""
    waits = [r['loader_wait_ms'] for r in run.steps]
    steps = [r['step_ms'] for r in run.steps]
    walls = [a + b for a, b in zip(waits, steps)]
    videos = [r['video_ms'] for r in run.steps]
    line = (f'{name}: steps {[r["step"] for r in run.steps]} loader_wait_ms='
            f'{[round(x, 3) for x in waits]} step_ms={[round(x, 3) for x in steps]} '
            f'wall_ms={[round(x, 3) for x in walls]}')
    if any(v is not None for v in videos):
        line += f' video_ms={[v if v is None else round(v, 3) for v in videos]}'
    if len(steps) > 1:
        line += (f'; after the first step of each epoch: median wait '
                 f'{statistics.median(waits[1:]):.3f}, step {statistics.median(steps[1:]):.3f}, '
                 f'wall {statistics.median(walls[1:]):.3f}')
    log(line)
    return {'loader_wait_ms': waits, 'step_ms': steps}


def read_metrics(run_dir):
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def phase_train_loop():
    """The training and evaluation entry points in this process at the full width of
    baseline.yml (PRECISION 16, batch 3, seeded weights, the synthetic set) in a
    temporary LOG_DIR: two epochs of 3 steps (9 clips) with a validation and a
    checkpoint each; a resume after the second epoch's checkpoints are deleted; one
    epoch of the combination with the label prewarp in the loader; the evaluation
    CLI on the final checkpoint with the host and the device tracker. Each path's
    launches are counted. Prints the H2D copy of a batch, pinned and pageable, and
    the copies of one profiled step; the loop's step walls with the loader's wait;
    the loader's batches a second; the checkpoint's cost; VPQ of both trackers."""
    from fiery_tpu_torch import evaluate as evaluate_cli
    from fiery_tpu_torch import train as train_cli
    from fiery_tpu_torch.training.trainer import step_generator
    from fiery_tpu_torch.utils.checkpoint import (host_copy, load_checkpoint, save_checkpoint,
                                                  save_checkpoint_async, serialise,
                                                  wait_for_async_save)
    log_dir = tempfile.mkdtemp(prefix='fiery_train_loop_')
    opts = ['DATASET.NAME', 'synthetic', 'DATASET.N_SYNTHETIC_SAMPLES', '9',
            'LOGGING_INTERVAL', '1', 'LOG_DIR', log_dir]
    try:
        # 1. two epochs, each with its validation and checkpoint, steps 3-5 traced
        # (--profile-dir), late in the process, where a trace loses most launches
        profile_dir = os.path.join(log_dir, 'profile')
        run, _ = path_launches('train loop', lambda: train_cli.main(
            ['--config', BASELINE, '--profile-dir', profile_dir, *opts, 'EPOCHS', '2']),
            LOOP_DENSE)
        profile = check_profile('train loop --profile-dir', run, profile_dir)
        trainer = run.trainer
        records = read_metrics(run.save_dir)
        keys = {k for r in records for k in r}
        needed = {'total_loss', 'segmentation', 'probabilistic', 'val_iou_dynamic',
                  'val_vpq_vehicles', 'segmentation_weight'}
        if not needed <= keys or not all(np.isfinite(v) for r in records for v in r.values()):
            raise AssertionError(f'train loop: metrics.jsonl keys {sorted(keys)}')
        saved = {}
        for name, step in (('checkpoint_epoch0', 3), ('checkpoint_epoch1', 6),
                           ('checkpoint_final', 6)):
            saved[name], _ = load_checkpoint(os.path.join(run.save_dir, name))
            if saved[name]['step'] != step:
                raise AssertionError(f'{name}: step {saved[name]["step"]}, expected {step}')
        live = trainer.state()
        n_tensors = 0
        for part in ('model', 'uncertainty'):
            for k, v in live[part].items():
                n_tensors += 1
                if not torch.equal(saved['checkpoint_final'][part][k], v.cpu()):
                    raise AssertionError(f'checkpoint_final: {part} {k} differs')
        for i, st in live['optimizer']['state'].items():
            for k, v in st.items():
                n_tensors += 1
                if not torch.equal(saved['checkpoint_final']['optimizer']['state'][i][k],
                                   v.cpu()):
                    raise AssertionError(f'checkpoint_final: Adam state {i} {k} differs')
        log(f'train loop: metrics.jsonl holds {len(records)} scalars; checkpoints at steps '
            f'3, 6, 6; checkpoint_final equals the trainer bit for bit ({n_tensors} tensors)')
        val = [r for r in records if 'val_vpq_vehicles' in r or 'val_iou_dynamic' in r]
        log(f'train loop validation: {json.dumps(val)}')
        dense_walls = loop_walls('train loop steps', run)

        # 2. resume after a preemption that lost the second epoch's checkpoints
        shutil.rmtree(os.path.join(run.save_dir, 'checkpoint_epoch1'))
        shutil.rmtree(os.path.join(run.save_dir, 'checkpoint_final'))
        resumed, _ = path_launches('train loop resumed', lambda: train_cli.main(
            ['--config', BASELINE, '--resume', 'auto', *opts, 'EPOCHS', '2']), LOOP_DENSE)
        if [r['step'] for r in resumed.steps] != [4, 5, 6] or resumed.trainer.step != 6:
            raise AssertionError(f'resume: steps {[r["step"] for r in resumed.steps]}')
        losses = [r['total_loss'] for r in read_metrics(resumed.save_dir) if 'total_loss' in r]
        if len(losses) != 3 or not all(np.isfinite(losses)):
            raise AssertionError(f'resume: total losses {losses}')
        log(f'train loop resumed at step 3 from checkpoint_epoch0, ended at step 6; total '
            f'losses {[round(x, 4) for x in losses]}')
        final = os.path.join(resumed.save_dir, 'checkpoint_final')
        del resumed

        # 3. one epoch of the combination, the label prewarp in the loader
        combo, _ = path_launches('train loop combination', lambda: train_cli.main(
            ['--config', BASELINE, *opts, 'EPOCHS', '1', *COMBO_TRAIN_OPTS]), LOOP_COMBO,
            absent=('bev_warp', 'bev_warp_backward', 'bev_warp_nearest'))
        combo_walls = loop_walls('train loop combination steps', combo)
        del combo

        # 4. the evaluation CLI on the final checkpoint, both trackers
        results = {}
        for matching, extra in ((False, []), (True, ['--device-matching'])):
            results[matching], _ = path_launches(
                f'evaluate{" --device-matching" if matching else ""}',
                lambda: evaluate_cli.main(['--checkpoint', final, '--max-batches', '2',
                                           *extra]),
                EVAL_KERNELS + (('segment_centroids', 'lap') if matching else ()),
                absent=() if matching else ('segment_centroids', 'lap'))
            if not all(np.isfinite(v) for v in results[matching].values()):
                raise AssertionError(f'evaluate: {results[matching]}')
        log('evaluate VPQ, device tracker against host tracker (2 val batches): '
            + json.dumps({k: [float(results[True][k]), float(results[False][k])]
                          for k in results[True]}))

        # the H2D copy of a batch: pinned (the loader's) against pageable, synchronised
        cfg = trainer.cfg
        train_loader, _ = prepare_dataloaders(cfg, device='cuda')
        pinned = train_loader.peek()
        pageable = {k: v.numpy().copy() for k, v in pinned.items()}
        nbytes = sum(v.numel() * v.element_size() for v in pinned.values())
        copy_ms = {}
        for label, batch in (('pinned', pinned), ('pageable', pageable), ('pinned', pinned),
                             ('pageable', pageable)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_card = trainer.to_device(batch)
            torch.cuda.synchronize()
            copy_ms.setdefault(label, []).append(1e3 * (time.perf_counter() - t0))
            del on_card
        log(f'H2D copy of a batch of 3 ({nbytes} bytes), synchronised host clock, ms: '
            f'{json.dumps({k: [round(x, 3) for x in v] for k, v in copy_ms.items()})}; '
            f'{nbytes / 1e6 / min(copy_ms["pinned"]):.1f} GB/s pinned')
        gen = step_generator(0, trainer.step, 'cuda')
        stages, _ = stage_times(trainer, pinned, gen, sync=True)
        log('train loop step stages from a pinned batch (host clock, synchronized between '
            'stages, ms): ' + json.dumps({k: round(v, 3) for k, v in stages.items()}))

        # the loader alone: batches a second at full width
        loader, _ = prepare_dataloaders(cfg, device='cuda')
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        dt = time.perf_counter() - t0
        log(f'loader alone: {n} batches of 3 in {dt:.3f} s, {n / dt:.3f} batches/s, '
            f'{1e3 * dt / n:.1f} ms a batch (one prefetch thread)')

        # the checkpoint's cost: sync, and async with a step while the write runs
        def timed_step(batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch, step_generator(0, trainer.step, 'cuda'))
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        plain_steps = [timed_step(pinned) for _ in range(2)]
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(log_dir, 'cost_sync'), trainer, cfg)
        sync_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        state_host = host_copy(trainer.state())
        t1 = time.perf_counter()
        serialise(state_host)
        copy_ms, serialise_ms = 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)
        del state_host
        t0 = time.perf_counter()
        save_checkpoint_async(os.path.join(log_dir, 'cost_async'), trainer, cfg)
        call_ms = 1e3 * (time.perf_counter() - t0)
        during = timed_step(pinned)
        t0 = time.perf_counter()
        wait_for_async_save()
        rest_ms = 1e3 * (time.perf_counter() - t0)
        size = os.path.getsize(os.path.join(log_dir, 'cost_sync', 'state', 'state.pt'))
        log(f'checkpoint ({size} bytes): sync save {sync_ms:.3f} ms; async call (host copy '
            f'and serialisation) '
            f'{call_ms:.3f} ms, a step during the write {during:.3f} ms against '
            f'{[round(x, 3) for x in plain_steps]} without, then {rest_ms:.3f} ms left to wait; '
            f'apart: host copy {copy_ms:.3f} ms, serialisation {serialise_ms:.3f} ms')

        # one profiled loop step from the pinned batch: its host-to-device copies
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            trace_lead_in()         # the copies open the step, where a trace can lose them
            trainer.train_step(pinned, step_generator(0, trainer.step, 'cuda'))
            torch.cuda.synchronize()
        copies = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and 'HtoD' in e.key]
        log('train loop profiled step, host-to-device copies: ' + json.dumps(
            {e.key: [e.count, round(e.self_device_time_total / 1e3, 4)] for e in copies})
            + f'; {smi_line()}')
        return {'dense': dense_walls, 'combo': combo_walls, 'copy_ms': copy_ms,
                'evaluate': results, 'profile': profile}
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


def check_profile(name, run, profile_dir):
    """The trace of ``python -m fiery_tpu_torch.train --profile-dir`` (a run of at
    least 5 steps): one file, holding the profiler's markers of the window's three
    steps (steps 3-5) and no other, and K10 launches equal to K10's counters over
    the window. Returns what the CLI recorded, with the trace's size and events."""
    rec = dict(run.profile or {})
    path = os.path.join(profile_dir, 'rank0.pt.trace.json')
    if rec.get('profile_trace') != path or rec.get('steps') != [3, 4, 5] \
            or os.listdir(profile_dir) != ['rank0.pt.trace.json']:
        raise AssertionError(f'{name}: recorded {rec}, files {os.listdir(profile_dir)}')
    with open(path) as f:
        events = json.load(f)['traceEvents']
    steps = sorted({e['name'] for e in events if e.get('name', '').startswith('ProfilerStep#')})
    kernels = sum(1 for e in events if e.get('cat') == 'kernel')
    k10 = rec['k10_launches']
    if steps != ['ProfilerStep#2', 'ProfilerStep#3', 'ProfilerStep#4'] or not k10['counted'] \
            or k10['trace'] != k10['counted'] or not kernels:
        raise AssertionError(f'{name}: markers {steps}, {kernels} kernels, K10 {k10}')
    rec.update(trace_bytes=os.path.getsize(path), trace_events=len(events), kernels=kernels)
    log(f'{name}: the trace of steps 3-5 ({rec["trace_bytes"]} bytes, {len(events)} events, '
        f'{kernels} kernels) holds {k10["trace"]} K10 launches, the counters '
        f'{k10["counted"]}; {smi_line()}')
    return rec


LYFT_BASELINE = os.path.join(os.path.dirname(BASELINE), 'lyft', 'baseline.yml')


def real_set_opts(tree, log_dir, name='nuscenes'):
    return ['DATASET.NAME', name, 'DATASET.VERSION', 'mini', 'DATASET.DATAROOT', tree,
            'LOGGING_INTERVAL', '1', 'LOG_DIR', log_dir]


class Trees:
    """The real-set trees, written in the background from the moment this is made
    (two processes of the writer's CLI, in a temporary directory), so that the
    writing overlaps the phases before the first that needs them: a nuScenes mini
    tree at 1600 x 900 (2 train scenes and 1 val scene of 12 samples) and a Lyft
    tree at lyft/baseline.yml's IMAGE.W x IMAGE.H (1 train and 1 val scene of 17
    samples, for its 15-frame windows). ``wait()`` returns (nuScenes dataroot, Lyft
    dataroot, {tree: s from the start}, the Lyft images' (w, h)); leaving the
    ``with`` block stops the writers and removes the trees."""

    def __init__(self):
        lyft_cfg = get_cfg(argparse.Namespace(config_file=LYFT_BASELINE, opts=[]))
        self.size = (lyft_cfg.IMAGE.W, lyft_cfg.IMAGE.H)
        self.root = tempfile.mkdtemp(prefix='fiery_trees_')
        self.nusc, self.lyft = os.path.join(self.root, 'nusc'), os.path.join(self.root, 'lyft')
        cmd = [sys.executable, '-m', 'fiery_tpu_torch.data.fake_nuscenes']
        cmds = {'nuscenes': cmd + [self.nusc],
                'lyft': cmd + [self.lyft, '--lyft', '--train-scenes', '1', '--val-scenes',
                               '1', '--samples', '17', '--width', str(self.size[0]),
                               '--height', str(self.size[1])]}
        self.t0 = time.perf_counter()
        self.procs = {k: subprocess.Popen(c, cwd=os.path.dirname(os.path.abspath(__file__)),
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
                      for k, c in cmds.items()}
        self.seconds = {}

    def __enter__(self):
        return self

    def wait(self):
        for k, proc in self.procs.items():
            if k in self.seconds:
                continue
            text, _ = proc.communicate(timeout=600)
            self.seconds[k] = time.perf_counter() - self.t0
            if proc.returncode != 0:
                raise RuntimeError(f'writing the {k} tree failed (rc={proc.returncode}):\n{text}')
        return self.nusc, self.lyft, self.seconds, self.size

    def __exit__(self, *exc):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.root, ignore_errors=True)


def tree_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def sample_breakdown(ds, i):
    """ms of one sample's pieces on this process's one core: the decode of its
    frames' JPEGs (with the calibrations), the rasterisation of its labels, and the
    label generation (centerness, offset, flow)."""
    recs = [ds.ixes[j] for j in ds.indices[i]]
    t0 = time.perf_counter()
    for rec in recs:
        ds.get_input_data(rec)
    t1 = time.perf_counter()
    instance_map, instances = {}, []
    for rec in recs:
        _, inst, _, instance_map, _ = ds.get_label_cached(rec, instance_map)
        instances.append(inst.astype(np.int32))
    t2 = time.perf_counter()
    ego = np.stack([ds.get_future_egomotion(rec, j).astype(np.float32)
                    for rec, j in zip(recs, ds.indices[i])])
    convert_instance_mask_to_center_and_offset_label(
        np.stack(instances), ego, num_instances=len(instance_map),
        ignore_index=ds.cfg.DATASET.IGNORE_INDEX, subtract_egomotion=True,
        spatial_extent=ds.spatial_extent)
    t3 = time.perf_counter()
    return {'decode_ms': 1e3 * (t1 - t0), 'rasterise_ms': 1e3 * (t2 - t1),
            'labels_ms': 1e3 * (t3 - t2), 'images': len(recs) * len(ds.cfg.IMAGE.NAMES)}


def loader_epochs(cfg):
    """Two epochs of the train loader that serves the card, its worker pool kept
    between them: {'batches' (an epoch's), 'pool_s' (the pool's start),
    'first_batch_s', 'rest_s' (the rest of the first epoch), 'epoch2_s'}, and the
    loader."""
    loader, _ = prepare_dataloaders(cfg, device='cuda')
    loader._get_pool()
    t0 = time.perf_counter()
    batches = iter(loader)
    next(batches)
    t1 = time.perf_counter()
    n = 1 + sum(1 for _ in batches)
    t2 = time.perf_counter()
    sum(1 for _ in loader)
    t3 = time.perf_counter()
    loader.shutdown()
    return {'batches': n, 'pool_s': loader.pool_start_s, 'first_batch_s': t1 - t0,
            'rest_s': t2 - t1, 'epoch2_s': t3 - t2}, loader


def check_decoders(name, counts, n_images=None, crop_leaves_image=False):
    """Every image went through the native pipe where it builds, else through PIL.
    Where the crop leaves the resized image (lyft/baseline.yml) the pipe refuses
    each call and PIL decodes it. n_images: the images expected, if known."""
    counts = dict(counts)
    n = counts.get('native', 0) + counts.get('pil', 0)
    if not image_pipe_available():
        want = {'pil': n}
    elif crop_leaves_image:
        want = {'native_refused': n, 'pil': n}
    else:
        want = {'native': n}
    if n == 0 or counts != want or (n_images is not None and n != n_images):
        raise AssertionError(f'{name}: decode counts {counts}, expected {want} '
                             f'({n_images} images)')
    return counts


def video_frames(run, n_frames, h, w):
    """The run's videos: n_frames frames of (h, w), each written as a GIF of that
    size; returns their file names."""
    from PIL import Image
    names = []
    for video in run.videos:
        with Image.open(video['path']) as gif:
            size = gif.size
        if tuple(video['shape']) != (1, n_frames, h, w, 3) or size != (w, h):
            raise AssertionError(f'{video["path"]}: frames {video["shape"]}, GIF {size}, '
                                 f'expected {n_frames} frames of {(h, w)}')
        names.append(os.path.basename(video['path']))
    return names


def finite_losses(name, run):
    losses = [r['total_loss'] for r in read_metrics(run.save_dir) if 'total_loss' in r]
    if len(losses) != len(run.steps) or not np.all(np.isfinite(losses)):
        raise AssertionError(f'{name}: total losses {losses} for {len(run.steps)} steps')
    return losses


def phase_real_set(trees):
    """The nuScenes and Lyft loader at full width on trees of real JPEGs that the
    port's writer makes (``Trees``: 1600 x 900, and lyft/baseline.yml's 1920 x
    1080): the
    loader alone (batches a second, a sample's decode, rasterisation and label
    generation, the decode counts, the prewarp in the workers), the training CLI on
    baseline.yml (PRECISION 16, batch 3, EPOCHS 1, VIS_INTERVAL 1: 3 steps, the
    launches of LOOP_DENSE, finite losses, the train and val videos), one epoch of
    the combination with the prewarp in the workers, the evaluation CLI with the
    device tracker, and one epoch of lyft/baseline.yml; the visualise CLI where
    matplotlib imports. Returns the numbers it printed."""
    from fiery_tpu_torch import evaluate as evaluate_cli
    from fiery_tpu_torch import train as train_cli
    from fiery_tpu_torch import visualise as visualise_cli
    from fiery_tpu_torch.data.nuscenes_dataset import build_real_datasets
    cores = len(os.sched_getaffinity(0))
    log(f'real set: native pipe {"built" if image_pipe_available() else "unavailable"} '
        f'({native_build_error()}); {cores} cores; {smi_line()}')
    root = tempfile.mkdtemp(prefix='fiery_real_set_')
    out = {}
    try:
        # 1. the trees
        nusc, lyft, seconds, lyft_size = trees.wait()
        out['trees'] = {'nuscenes_bytes': tree_bytes(nusc), 'lyft_bytes': tree_bytes(lyft),
                        'seconds': seconds}
        log(f'real set trees, written at once in the background: nuScenes mini 1600x900, 3 '
            f'scenes of 12 samples, {out["trees"]["nuscenes_bytes"]} bytes, done '
            f'{seconds["nuscenes"]:.3f} s after the start; Lyft {lyft_size[0]}x{lyft_size[1]}, '
            f'2 scenes of 17 samples, {out["trees"]["lyft_bytes"]} bytes, done '
            f'{seconds["lyft"]:.3f} s after the start')

        # 2. the loader alone, baseline.yml, batch 3, 7-frame windows
        log_dir = os.path.join(root, 'runs')
        cfg = get_cfg(argparse.Namespace(config_file=BASELINE,
                                         opts=real_set_opts(nusc, log_dir)))
        ds = build_real_datasets(cfg)[0]
        images = ds.sequence_length * len(cfg.IMAGE.NAMES)      # a sample's JPEGs
        parts = [sample_breakdown(ds, i) for i in range(3)]
        ds.take_decode_counts()
        log(f'real set sample (one core, {images} JPEGs): ' + json.dumps(
            [{k: round(v, 3) for k, v in p.items()} for p in parts]))
        if image_pipe_available():
            # the pipe's pixels against PIL's, on the tree's JPEGs at baseline's resize
            paths = [os.path.join(ds.dataroot, ds.nusc.get('sample_data', ds.ixes[0][
                'data'][cam])['filename']) for cam in cfg.IMAGE.NAMES]
            native_px = ds._load_images(paths)
            ds._native_images = False
            pil_px = ds._load_images(paths)
            ds._native_images = None
            diff = np.abs(native_px.astype(np.int16) - pil_px)
            if diff.max() > 1:
                raise AssertionError(f'native pipe vs PIL: {diff.max()} LSB')
            log(f'native pipe vs PIL on {len(paths)} JPEGs: {int((diff > 0).sum())} of '
                f'{diff.size} values differ by 1 LSB')
        rate, loader = loader_epochs(cfg)
        counts = check_decoders('loader alone', loader.decode_counts,
                                2 * rate['batches'] * cfg.BATCHSIZE * images)
        rate['batches_per_s'] = rate['batches'] / rate['epoch2_s']
        log(f'real set loader alone ({cfg.N_WORKERS} workers on {cores} cores, epochs of '
            f'{rate["batches"]} batches of {cfg.BATCHSIZE}): pool start '
            f'{rate["pool_s"]:.3f} s, first batch {rate["first_batch_s"]:.3f} s, the rest '
            f'of the epoch {rate["rest_s"]:.3f} s, a second epoch {rate["epoch2_s"]:.3f} s '
            f'({rate["batches_per_s"]:.3f} batches/s); decode counts {json.dumps(counts)}')
        out['loader'] = rate
        out['samples'] = parts
        # one core's ms a batch of 3
        batch_ms = cfg.BATCHSIZE * statistics.median(
            p['decode_ms'] + p['rasterise_ms'] + p['labels_ms'] for p in parts)

        # 3. training and evaluation at full width on the nuScenes tree
        opts = real_set_opts(nusc, log_dir) + ['EPOCHS', '1', 'VIS_INTERVAL', '1']
        run, _ = path_launches('real set train', lambda: train_cli.main(
            ['--config', BASELINE, *opts]), LOOP_DENSE)
        losses = finite_losses('real set train', run)
        if [r['step'] for r in run.steps] != [1, 2, 3]:
            raise AssertionError(f'real set train: steps {run.steps}')
        # a panel a frame from the present on: 5 rows of BEV maps, GT | prediction
        X, Y = (int(v) for v in ds.bev_dimension[:2])
        n_frames = cfg.N_FUTURE_FRAMES + 1
        names = video_frames(run, n_frames, 5 * X, 2 * Y)
        if sorted(names) != ['train_outputs_step1.gif', 'train_outputs_step2.gif',
                             'train_outputs_step3.gif', 'val_outputs_step3.gif']:
            raise AssertionError(f'real set videos: {names}')
        counts = [check_decoders(f'real set {k}', l.decode_counts)
                  for k, l in zip(('train', 'val'), run.loaders)]
        log(f'real set train: losses {[round(x, 4) for x in losses]}; videos {names} '
            f'({n_frames} frames of {2 * Y} x {5 * X}); decode counts train '
            f'{json.dumps(counts[0])}, val {json.dumps(counts[1])}')
        loop_walls('real set train steps', run)
        log(f'real set train: pool start {run.loaders[0].pool_start_s:.3f} s (train), '
            f'{run.loaders[1].pool_start_s:.3f} s (val)')
        out['train'] = run.steps
        step_ms = statistics.median(r['step_ms'] for r in run.steps[1:])
        waits = [round(r['loader_wait_ms'], 3) for r in run.steps]
        final = os.path.join(run.save_dir, 'checkpoint_final')
        del run

        combo, _ = path_launches('real set train combination', lambda: train_cli.main(
            ['--config', BASELINE, *real_set_opts(nusc, log_dir), 'EPOCHS', '1',
             *COMBO_TRAIN_OPTS]), LOOP_COMBO,
            absent=('bev_warp', 'bev_warp_backward', 'bev_warp_nearest'))
        finite_losses('real set train combination', combo)
        prewarps = combo.loaders[0].transform_ms
        if len(prewarps) < len(combo.steps):
            raise AssertionError(f'real set combination: prewarp ran {len(prewarps)} times')
        loop_walls('real set train combination steps', combo)
        # F4: the prewarp's share of a batch's work in a worker, and the pace
        prewarp_ms = statistics.median(prewarps)
        busy = min(cores, cfg.N_WORKERS, rate['batches'])
        log(f'real set pace (F4): the prewarp in the workers {[round(x, 3) for x in prewarps]} '
            f'ms a batch, median {prewarp_ms:.3f}, {100 * prewarp_ms / batch_ms:.1f}% of a '
            f'batch of {cfg.BATCHSIZE} on one core ({batch_ms:.3f} ms); the loader alone made '
            f'a batch each {1e3 / rate["batches_per_s"]:.3f} ms with {busy} workers busy, '
            f'against a dense step of {step_ms:.3f} ms (median of steps 2-3): the '
            f'{"loader" if 1e3 / rate["batches_per_s"] > step_ms else "step"} sets the pace; '
            f'the dense loop\'s waits {waits} ms')
        out['combo'] = {'steps': combo.steps, 'prewarp_ms': prewarps}
        out['pace'] = {'batch_ms': batch_ms, 'prewarp_ms': prewarp_ms, 'step_ms': step_ms}
        del combo

        # the evaluation CLI with the device tracker (phase_train_loop runs both)
        results, _ = path_launches(
            'real set evaluate --device-matching',
            lambda: evaluate_cli.main(['--checkpoint', final, '--max-batches', '2',
                                       '--device-matching']),
            EVAL_KERNELS + ('segment_centroids', 'lap'))
        if not all(np.isfinite(v) for v in results.values()):
            raise AssertionError(f'real set evaluate: {results}')
        log('real set evaluate --device-matching (2 val windows): ' + json.dumps(
            {k: float(v) for k, v in results.items()}))
        out['evaluate'] = results

        # 4. Lyft: one epoch of lyft/baseline.yml, 15 frames loaded, 8 kept
        lyft_opts = real_set_opts(lyft, log_dir, 'lyft') + ['EPOCHS', '1']
        lyft_ds = build_real_datasets(get_cfg(argparse.Namespace(
            config_file=LYFT_BASELINE, opts=lyft_opts)))[0]
        frames = lyft_ds[0]['image'].shape[0]
        if lyft_ds.sequence_length != 15 or frames != 8:
            raise AssertionError(f'lyft: {lyft_ds.sequence_length} frames loaded, {frames} kept')
        lrun, _ = path_launches('real set lyft train', lambda: train_cli.main(
            ['--config', LYFT_BASELINE, *lyft_opts]), LOOP_DENSE)
        finite_losses('real set lyft train', lrun)
        lcounts = [check_decoders(f'lyft {k}', l.decode_counts, crop_leaves_image=True)
                   for k, l in zip(('train', 'val'), lrun.loaders)]
        log(f'real set lyft: 15 frames loaded, 8 kept; decode counts train '
            f'{json.dumps(lcounts[0])}, val {json.dumps(lcounts[1])}')
        loop_walls('real set lyft steps', lrun)
        out['lyft'] = lrun.steps

        # 5. the visualise CLI, where matplotlib imports on this machine
        if importlib.util.find_spec('matplotlib') is None:
            log('real set visualise CLI: not run, no matplotlib on this machine (its '
                'figure is checked on the CPU, tests/test_torch_visualisation.py)')
        else:
            paths = visualise_cli.main(['--checkpoint', final, '--output-dir',
                                        os.path.join(root, 'vis')])
            log(f'real set visualise CLI: {len(paths)} figures')
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the parity runner's launches on the card: the served forward's (K1, K2, K10, K11)
# and, under --device-matching, the decode and the tracker's (K6-K9)
PARITY_KERNELS = ('bev_pool', 'bev_warp', 'batch_norm', 'spatial_gru', 'instance_centers',
                  'group_pixels', 'segment_centroids', 'lap')
STAGE_BOUND = 5e-3     # tests/test_parity.py's bound on each stage's relative difference


def parity_main(out, argv):
    """The fresh process of phase_parity (``chip_smoke.py --parity-out PATH ARGS``):
    ``fiery_tpu_torch.parity``'s main on ARGS with the counters reset before it;
    writes what it returned, the launches and the plain versions' calls to PATH."""
    from fiery_tpu_torch import parity
    reset_counters()
    t0 = time.perf_counter()
    result = parity.main(argv)
    seconds = time.perf_counter() - t0
    torch.save({'result': result, 'launches': {k: fn.launches for k, fn in COUNTERS.items()},
                'plain_calls': [fn.plain_calls for fn in PLAIN_COUNTED], 'seconds': seconds},
               out)


def phase_parity(trees):
    """The accuracy-parity runner on the card at the full width of baseline.yml, on
    the nuScenes mini tree of ``trees`` (the real-set phase's). The port's model,
    built after
    ``torch.manual_seed(0)`` (PyTorch's default initialisation), its BatchNorm
    statistics drawn as the reference-format test checkpoints draw them
    (``parity_probe.randomise_batchnorm``), is written as a reference Lightning
    checkpoint (``parity.write_reference_checkpoint``: through the twin's strict
    load) with baseline.yml's config on nuScenes mini (N_WORKERS 0: the few JPEGs
    decode in the process). Not ``calibrate_batchnorm``: on a few alike clips it
    gives the pyramid pooling's BatchNorms (one value a clip) variances of 1e-6 to
    1e-3, which multiply the reference's own f32 error in its avg_pool3d (a serial
    sum of 80,000 values on the card) past the bound (``python -m
    fiery_tpu_torch.parity_probe``; PERF.md). In a fresh process (this
    script with --parity-out), ``python -m fiery_tpu_torch.parity --stages
    --dataroot TREE --max-batches 2 --device-matching``: the twin loads the file
    strictly, every stage of the first val window (f32, TF32 off) lies below
    STAGE_BOUND relative, the counters show K1, K2, K10, K11 and K6-K9 launched and
    no plain version, and every row of the table is finite. Returns the record."""
    from fiery_tpu_torch import parity
    root = tempfile.mkdtemp(prefix='fiery_parity_')
    try:
        t0 = time.perf_counter()
        cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=[
            'DATASET.NAME', 'nuscenes', 'DATASET.VERSION', 'mini', 'N_WORKERS', '0']))
        torch.manual_seed(0)
        trainer = Trainer(cfg)
        randomise_batchnorm(trainer.model, seed=5)
        ckpt = parity.write_reference_checkpoint(os.path.join(root, 'fiery.ckpt'),
                                                 trainer.state(), cfg)
        del trainer
        torch.cuda.empty_cache()
        tree = trees.wait()[0]
        setup_s = time.perf_counter() - t0
        out = os.path.join(root, 'parity.pt')
        argv = ['--torch-checkpoint', ckpt, '--stages', '--dataroot', tree, '--max-batches',
                '2', '--device-matching']
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), '--parity-out', out,
                               *argv], capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f'parity: exit {proc.returncode}:\n{proc.stdout[-3000:]}\n'
                                 f'{proc.stderr[-3000:]}')
        got = torch.load(out, weights_only=False)
        report, rows = got['result']['stages'], got['result']['metrics']
        over = {k: v for k, v in report.items() if not (np.isfinite(v[1]) and v[1] < STAGE_BOUND)}
        missing = [k for k in PARITY_KERNELS if not got['launches'][k]]
        if over or len(report) != 9 or missing or any(got['plain_calls']) \
                or len(rows) != 6 or not all(np.isfinite(list(rows.values()))):
            raise AssertionError(f'parity: stages over {STAGE_BOUND} {over} of {report}; '
                                 f'kernels not launched {missing}; plain versions '
                                 f'{got["plain_calls"]}; rows {rows}\n{proc.stdout[-3000:]}')
        log(proc.stdout.strip())
        log(f'parity (main path, fresh process, {got["seconds"]:.1f} s in main, {wall:.1f} s '
            f'with the start): stages (max |d|, rel) ' + json.dumps(report)
            + ' launches ' + json.dumps({k: v for k, v in got['launches'].items() if v})
            + f' rows {json.dumps(rows)}; set-up {setup_s:.1f} s; {smi_line()}')
        return {'stages': report, 'rows': rows, 'launches': got['launches'],
                'seconds': got['seconds'], 'wall_s': wall, 'setup_s': setup_s}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_trace_whole(name, windows=4):
    """Profiled windows of REPS eval calls of K10 (one apply_kernel launch each),
    each opened by ``trace_lead_in``: every window must hold every launch."""
    dev = torch.device('cuda')
    x = torch.randn((3, 64, 50, 50), device=dev, dtype=torch.bfloat16).to(
        memory_format=torch.channels_last)
    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    rm, rv = torch.zeros(64, device=dev), torch.ones(64, device=dev)
    by_window = []
    for _ in range(windows):
        ms = pass_ms(lambda: batch_norm_forward(x, w, b, rm, rv, False, 0.1, BN_EPS),
                     lambda key: 'apply' if 'apply_kernel' in key else None, {'apply': 1},
                     warmup=1, attempts=1)
        by_window.append(ms['apply'])
    log(f'{name}: {windows} profiled windows of {REPS} K10 launches each, every launch '
        f'recorded after the lead-in; device ms a call {[round(v, 5) for v in by_window]}')


def planted_topk_depth(n_pix, D, dtype, device, seed):
    """(n_pix, D) softmax weights of seeded logits, with every fourth row planted with
    ties at the k-th value: three repeated levels, all +0.0, all ones, or -0.0
    beside +0.0."""
    g = torch.Generator(device=device).manual_seed(seed)
    depth = torch.softmax(torch.randn((n_pix, D), generator=g, device=device), -1)
    levels = torch.randint(0, 3, (n_pix, D), generator=g, device=device) / 4.0
    signed = torch.tensor([-0.0, 0.0, 0.25], device=device)[
        torch.randint(0, 3, (n_pix, D), generator=g, device=device)]
    depth[0::16], depth[4::16], depth[8::16] = levels[0::16], 0.0, 1.0
    depth[12::16] = signed[12::16]
    return depth.to(dtype)


def phase_topk_kernels(device, k=8):
    """K5 (the top-k depth select) and its backward against their plain versions at
    the combination's shapes: the select on the served request's 3 x 6 x 28 x 60
    pixels and on the training batch's 9 x 6 x 28 x 60, its backward at the training
    shape; bf16 (the path's dtype) and f32; the voxel ids of the seeded rig; planted
    ties. Both must equal their plain versions exactly, the backward also bit for
    bit at D = 28, 48 and 64, k = 1, 8 and D, on 1, 30,240 and 90,720 pixels and on
    56-byte bf16 rows. Times kernel, call, plain version and the library call
    (torch.topk and a gather of the ids; the backward's scatter_)."""
    _, feat_serve, ids_serve, num_bins, z = bev_pool_inputs(device)
    rec = {}
    for shape_name, reps in (('serve', 1), ('train', 3)):
        ids = ids_serve.repeat(reps, 1, 1, 1, 1).contiguous()
        D = ids.shape[-1]
        n_pix = ids.numel() // D
        for dtype in (torch.float32, torch.bfloat16):
            depth = planted_topk_depth(n_pix, D, dtype, device, seed=7).view(ids.shape)
            got = topk_select(depth, ids, k)
            want = topk_select_plain(depth, ids, k)
            torch.cuda.synchronize()
            for part, a, b in zip(('top_w', 'ids_k', 'idx'), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f'topk_select {shape_name} {dtype} {part}: kernel '
                                         f'!= plain at {int((a != b).sum())} values')
            es = depth.element_size()

            def library(depth=depth, ids=ids):
                top = torch.topk(depth, k, dim=-1)
                return top.values, ids.gather(-1, top.indices)

            nbytes = n_pix * (D * (es + 4) + k * (es + 4 + 1))
            # integer compares: D a bit of the key (16 bits bf16, 32 f32), a pixel
            rec[('topk_select', shape_name, dtype)] = dict(
                max_abs_err=0.0,
                ms=kernel_ms(lambda: topk_select(depth, ids, k), ['topk_select_kernel'], 1),
                call_ms=time_ms(lambda: topk_select(depth, ids, k)),
                plain_ms=time_ms(lambda: topk_select_plain(depth, ids, k)),
                library_ms=time_ms(library), bytes=nbytes, flops=float(n_pix * D * 8 * es))
            if shape_name == 'serve':
                # K1 on the selected bins, as the sparse splat runs it (D = k): equal
                # to the plain version on the host bit for bit, and timed
                top_w, ids_k = got[0].contiguous(), got[1].contiguous()
                feat = feat_serve.to(dtype)
                splat = bev_pool(top_w, feat, ids_k, num_bins, z)
                n_diff = bits_differ(splat.cpu(), bev_pool_plain(
                    top_w.cpu(), feat.cpu(), ids_k.cpu(), num_bins, z))
                log(f'  bev_pool at D = {k} {str(dtype)[6:]}: values whose bits differ from '
                    f'the plain version on the host {n_diff}')
                if n_diff:
                    raise AssertionError(f'bev_pool at D = {k} {dtype}: {n_diff} values differ '
                                         f'from the plain version on the host')
                k1, k1_stages = k1_ms(lambda: bev_pool(top_w, feat, ids_k, num_bins, z))
                rec[('topk_select', shape_name, dtype)].update(k1_at_k_ms=k1,
                                                               k1_at_k_pass_ms=k1_stages)
                continue
            idx = got[2]
            g = planted_topk_depth(n_pix, k, dtype, device, seed=8).view(idx.shape)
            got_b = topk_select_backward(g, idx, D)
            want_b = topk_select_backward_plain(g, idx, D)
            torch.cuda.synchronize()
            if not torch.equal(got_b, want_b):
                raise AssertionError(f'topk_select_backward {dtype}: kernel != plain at '
                                     f'{int((got_b != want_b).sum())} values')

            def library_b(g=g, idx=idx):
                return torch.zeros(idx.shape[:-1] + (D,), dtype=g.dtype,
                                   device=device).scatter_(-1, idx.long(), g)

            rec[('topk_select_backward', shape_name, dtype)] = dict(
                max_abs_err=0.0,
                ms=kernel_ms(lambda: topk_select_backward(g, idx, D),
                             ['topk_select_backward_kernel'], 1),
                call_ms=time_ms(lambda: topk_select_backward(g, idx, D)),
                plain_ms=time_ms(lambda: topk_select_backward_plain(g, idx, D)),
                library_ms=time_ms(library_b), bytes=n_pix * (k * (es + 1) + D * es),
                flops=0.0)
    # K5 backward alone, exactly: D = 28, 48, 64, k = 1, 8, D, f32 and bf16, on 1,
    # 30,240 and 90,720 pixels, and bf16 rows of 56 bytes (D = 28, k = 3); the idx
    # from K5 forward on planted ties
    cases = [(D, k_, dtype, n) for D in (28, 48, 64) for k_ in sorted({1, 8, D})
             for dtype in (torch.float32, torch.bfloat16) for n in (1, 30240, 90720)]
    cases += [(28, 3, torch.bfloat16, n) for n in (1, 129, 30240)]
    for D, k_, dtype, n in cases:
        depth = planted_topk_depth(n, D, dtype, device, seed=D + k_ + n)
        gen = torch.Generator(device=device).manual_seed(n)
        ids = torch.randint(0, 40001, (n, D), generator=gen, device=device, dtype=torch.int32)
        idx = topk_select(depth, ids, k_)[2]
        g = planted_topk_depth(n, k_, dtype, device, seed=n + 1)
        got, want = topk_select_backward(g, idx, D), topk_select_backward_plain(g, idx, D)
        torch.cuda.synchronize()
        if bits_differ(got, want):
            raise AssertionError(f'topk_select_backward D = {D} k = {k_} {dtype} {n} pixels: '
                                 f'kernel != plain in {bits_differ(got, want)} values')
    log(f'  topk_select_backward: equal to plain bit for bit in {len(cases)} cases (D = 28, '
        '48, 64; k = 1, 8, D; f32, bf16; 1, 30,240, 90,720 pixels; bf16 D = 28, k = 3)')
    for key, r in rec.items():
        r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['flops'])
        log(f'  {key[0]} {key[1]} {str(key[2])[6:]}: equal to plain; '
            + json.dumps({k_: v for k_, v in r.items() if k_ != 'max_abs_err'}))
    return rec


def phase_train_kernels(device):
    """K1 and K2 backward, K3 and K4 against their plain versions at the full-width
    training shapes (batch 3): K1 backward in f32 (1e-5 + 1e-5 |x|) and bf16 (one
    bf16 ulp), two calls bit for bit; K2 backward equal to the plain version on the
    host (given the card's theta) bit for bit, f32 and bf16, also at wide poses on
    200 x 200, 400 x 200, 320 x 193 and 320 x 192 grids, and to a second call, NaN in
    every value of a map with a NaN or infinite pose; K3's k-th value equal and its top-k mean
    within 1e-6 relative, K4 equal. Times kernel, call, plain version and library
    call; bounds from the shapes of this run."""
    rec = {}
    # K1 backward: 3 clips x 3 frames = 9 splat samples, each clip with the serve rig
    _, _, ids, num_bins, z = bev_pool_inputs(device)
    ids = ids.repeat(3, 1, 1, 1, 1).contiguous()
    S, N, h, w, D = ids.shape
    C = 64
    g_ = torch.Generator(device=device).manual_seed(5)
    depth32 = torch.softmax(torch.randn((S, N, h, w, D), generator=g_, device=device), -1)
    feat32 = torch.randn((S, N, h, w, C), generator=g_, device=device)
    grad32 = torch.randn((S, num_bins // z, C), generator=g_, device=device)
    valid = ids < num_bins
    n_valid = int(valid.sum())
    rows = torch.where(valid, ids.long() // z + (torch.arange(S, device=device) * (
        num_bins // z)).view(S, 1, 1, 1, 1), S * (num_bins // z)).view(-1)
    # the gradient rows in the order the kernel gathers them (pixel by pixel)
    grad_rows = rows[rows < S * (num_bins // z)].to(torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        depth, feat, g = depth32.to(dtype), feat32.to(dtype), grad32.to(dtype)
        got = bev_pool_backward(depth, feat, ids, g, num_bins, z)
        again = bev_pool_backward(depth, feat, ids, g, num_bins, z)
        want = bev_pool_backward_plain(depth, feat, ids, g, num_bins, z)
        torch.cuda.synchronize()
        err = max(check_close('bev_pool_backward d_depth', got[0], want[0], dtype),
                  check_close('bev_pool_backward d_feat', got[1], want[1], dtype))
        n_runs = bits_differ(got[0], again[0]) + bits_differ(got[1], again[1])
        log(f'  bev_pool_backward {str(dtype)[6:]}: values whose bits differ between two '
            f'calls {n_runs}')
        if n_runs:
            raise AssertionError(f'bev_pool_backward {dtype}: two calls differ in {n_runs} values')
        del got, want, again

        def library(depth=depth, feat=feat, g=g):
            r = torch.cat([g.view(-1, C), g.new_zeros((1, C))]).index_select(0, rows)
            r = r.view(S, N, h, w, D, C)
            return (torch.einsum('snhwc,snhwdc->snhwd', feat, r),
                    torch.einsum('snhwd,snhwdc->snhwc', depth, r))

        es = depth.element_size()
        nbytes = 2 * (depth.numel() + feat.numel()) * es + ids.numel() * 4 + g.numel() * es
        rec[('bev_pool_backward', dtype)] = dict(
            max_abs_err=err,
            ms=kernel_ms(lambda: bev_pool_backward(depth, feat, ids, g, num_bins, z),
                         ['::splat_backward_kernel'], 1),
            l2_floor_ms=gather_floor_ms(grad_rows, g, C * g.element_size()),
            call_ms=time_ms(lambda: bev_pool_backward(depth, feat, ids, g, num_bins, z)),
            plain_ms=time_ms(lambda: bev_pool_backward_plain(depth, feat, ids, g, num_bins,
                                                             z), reps=5, warmup=1),
            library_ms=time_ms(library, reps=5, warmup=1), bytes=nbytes,
            flops=4.0 * n_valid * C)

    # K2 backward: the 6 past frames (3 clips x 2) of 200 x 200 x 64, equal to the
    # plain version on the host bit for bit and to a second call; then wide poses
    # (angles over [-pi, pi], a map half out and one wholly out) on 200 x 200,
    # 400 x 200, 320 x 193 and 320 x 192 grids, bit for bit too
    B, H, W = 6, 200, 200
    extent = (50.0, 50.0)
    pose = torch.zeros((B, 6), device=device)
    pose[:, 0] = torch.rand(B, generator=g_, device=device) * 4.0 - 2.0
    pose[:, 1] = torch.rand(B, generator=g_, device=device) * 2.0 - 1.0
    pose[:, 5] = torch.rand(B, generator=g_, device=device) * 0.2 - 0.1
    gw32 = torch.randn((B, H, W, C), generator=g_, device=device)
    g_wide = torch.Generator(device=device).manual_seed(10)
    wide = torch.zeros((B, 6), device=device)
    wide[:, 5] = torch.linspace(-np.pi, np.pi, B, device=device)
    wide[:, :2] = torch.rand((B, 2), generator=g_wide, device=device) * 4.0 - 2.0
    wide[1, :2] = torch.tensor([27.0, -13.0], device=device)
    wide[2, :2] = torch.tensor([-130.0, 0.0], device=device)
    for dtype in (torch.float32, torch.bfloat16):
        g = gw32.to(dtype)
        cases = [('training shape', g, pose)] + [
            (f'wide poses {h2} x {w2}', torch.randn((B, h2, w2, C), generator=g_wide,
                                                    device=device).to(dtype), wide)
            for h2, w2 in ((200, 200), (400, 200), (320, 193), (320, 192))]
        for name, gc_, pc in cases:
            got = bev_warp_backward(gc_, pc, extent)
            again = bev_warp_backward(gc_, pc, extent)
            want = bev_warp_backward_plain(gc_.cpu(), pc.cpu(), extent,
                                           theta=card_theta(pc, extent, dtype).cpu())
            host, twice = bits_differ(got.cpu(), want), bits_differ(got, again)
            log(f'  bev_warp_backward {str(dtype)[6:]} {name}: values whose bits differ from '
                f'the plain version on the host {host}, between two calls {twice}')
            if host or twice:
                raise AssertionError(f'bev_warp_backward {dtype} {name}: {host} values differ '
                                     f'from the host, {twice} between two calls')
            del got, again, want
        # a NaN angle and an infinite translation: those maps NaN, the others as before
        bad = pose.clone()
        bad[1, 5], bad[2, 0] = float('nan'), float('inf')
        got, ref = bev_warp_backward(g, bad, extent), bev_warp_backward(g, pose, extent)
        keep = [0, 3, 4, 5]
        if not bool(got[1:3].float().isnan().all()) or bits_differ(got[keep], ref[keep]):
            raise AssertionError(f'bev_warp_backward {dtype}: a non-finite pose gave finite '
                                 'values or changed the other maps')
        log(f'  bev_warp_backward {str(dtype)[6:]}: NaN and infinite poses give NaN maps')
        del got, ref
        grid = _affine_grid(_warp_theta(pose, extent, dtype), H, W).to(dtype)
        gc, xc = g.permute(0, 3, 1, 2), torch.zeros_like(g).permute(0, 3, 1, 2)

        def library(gc=gc, xc=xc, grid=grid):
            return torch.ops.aten.grid_sampler_2d_backward(gc, xc, grid, 0, 0, False,
                                                           [True, False])

        rec[('bev_warp_backward', dtype)] = dict(
            max_abs_err=0.0,
            ms=kernel_ms(lambda: bev_warp_backward(g, pose, extent), ['::warp_gather_kernel'],
                         1),
            call_ms=time_ms(lambda: bev_warp_backward(g, pose, extent)),
            plain_ms=time_ms(lambda: bev_warp_backward_plain(g, pose, extent)),
            library_ms=time_ms(library), bytes=2 * g.numel() * g.element_size() + pose.numel() * 4,
            flops=8.0 * g.numel() + 30.0 * B * H * W)

    # K3: the segmentation loss's 15 rows (3 clips x 5 frames) of 200 x 200, k = 10,000:
    # random rows, and rows whose k-th value sits in ties (exact zeros, a repeated
    # value); both timed
    k = 10000
    x_rand = torch.rand((15, H * W), generator=g_, device=device) * 3.0
    x_ties = x_rand.clone()
    x_ties[::2, :30000] = 0.0
    x_ties[1::2, ::2] = 1.5
    k3 = {}
    for name, x in (('random', x_rand), ('ties', x_ties)):
        got, want = kth_largest(x, k), kth_largest_plain(x, k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f'kth_largest {name}: kernel != plain in '
                                 f'{int((got != want).sum())} rows')
        mean = float(_top_k_sum_from_threshold(x, got, k).sum() / (15 * k))
        ref = float(torch.topk(x.double(), k).values.mean())
        if abs(mean - ref) > 1e-6 * abs(ref):
            raise AssertionError(f'top-k mean {name}: {mean} vs {ref}')
        log(f'  kth_largest {name}: equal to plain; top-k mean {mean:.7f} vs topk {ref:.7f}')
        k3[name] = dict(ms=kernel_ms(lambda x=x: kth_largest(x, k), ['kth_largest_kernel'], 1),
                        call_ms=time_ms(lambda x=x: kth_largest(x, k)),
                        plain_ms=time_ms(lambda x=x: kth_largest_plain(x, k)),
                        library_ms=time_ms(lambda x=x: torch.topk(x, k)))
    # the ties rows are the record's (the kernels' first record timed only those); the
    # random rows beside; the launch on 8 blocks a row instead of the plan's; and the
    # kernel's latency floor, its chain of barriers alone (4 passes), and the launch
    # alone (0 passes)
    lib = _build.load('kth_largest')
    k3_fn, chain = lib.fiery_kth_largest, lib.fiery_kth_largest_barrier_chain
    k3_fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p]
    chain.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    k3_fn.restype = chain.restype = ctypes.c_int
    plan = kth_largest_plan(H * W)
    out8 = torch.empty((15, 1), device=device)

    def launch(fn, *args):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f'{fn.__name__}: CUDA error {rc}')

    launch(k3_fn, x_ties.data_ptr(), out8.data_ptr(), 15, H * W, k, 8)
    torch.cuda.synchronize()
    if not torch.equal(out8, kth_largest_plain(x_ties, k)):
        raise AssertionError('kth_largest on 8 blocks a row != plain')
    rec['kth_largest'] = dict(
        max_abs_err=0.0, **k3['ties'],
        **{f'random_{key}': v for key, v in k3['random'].items()},
        blocks_a_row=plan,
        ms_8_blocks_a_row=kernel_ms(lambda: launch(k3_fn, x_ties.data_ptr(), out8.data_ptr(),
                                                   15, H * W, k, 8), ['kth_largest_kernel'], 1),
        barrier_floor_ms=kernel_ms(lambda: launch(chain, 15, plan, 4), ['barrier_chain_kernel'],
                                   1),
        launch_floor_ms=kernel_ms(lambda: launch(chain, 15, plan, 0), ['barrier_chain_kernel'],
                                  1),
        bytes=x_ties.numel() * 4 + 15 * 4, flops=24.0 * x_ties.numel())
    log('  kth_largest: ' + json.dumps({key: rec['kth_largest'][key] for key in (
        'ms', 'random_ms', 'blocks_a_row', 'ms_8_blocks_a_row', 'barrier_floor_ms',
        'launch_floor_ms')}))

    # K4: the label stack, 12 future frames (3 clips x 4) of 200 x 200 x 7 f32
    labels = torch.randn((12, H, W, 7), generator=g_, device=device)
    labels[..., :2] = torch.randint(0, 3, (12, H, W, 2), generator=g_, device=device).float()
    labels[..., 3:] = torch.where(torch.rand((12, H, W, 1), generator=g_, device=device) < 0.7,
                                  255.0, labels[..., 3:])
    lpose = torch.zeros((12, 6), device=device)
    lpose[:, 0] = torch.rand(12, generator=g_, device=device) * 6.0 - 3.0
    lpose[:, 1] = torch.rand(12, generator=g_, device=device) * 2.0 - 1.0
    lpose[:, 5] = torch.rand(12, generator=g_, device=device) * 0.2 - 0.1
    got = bev_warp_nearest(labels, lpose, extent)
    want = bev_warp_nearest_plain(labels, lpose, extent)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f'bev_warp_nearest: kernel != plain at '
                             f'{int((got != want).any(-1).sum())} pixels')
    log('  bev_warp_nearest: equal to plain on the label stack')
    lc = labels.permute(0, 3, 1, 2)

    def nearest_library():
        """The same function in PyTorch calls: theta and the sampling grid from the
        poses, then grid_sample's nearest mode."""
        grid = _affine_grid(_warp_theta(lpose, extent, torch.float32), H, W)
        return F.grid_sample(lc, grid, mode='nearest', padding_mode='zeros',
                             align_corners=False)
    rec['bev_warp_nearest'] = dict(
        max_abs_err=0.0,
        ms=kernel_ms(lambda: bev_warp_nearest(labels, lpose, extent),
                     ['::nearest_warp_tile_kernel'], 1),
        call_ms=time_ms(lambda: bev_warp_nearest(labels, lpose, extent)),
        plain_ms=time_ms(lambda: bev_warp_nearest_plain(labels, lpose, extent)),
        library_ms=time_ms(nearest_library),
        bytes=2 * labels.numel() * 4 + lpose.numel() * 4, flops=30.0 * 12 * H * W)

    for key, r in rec.items():
        r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['flops'])
        log(f'  {key if isinstance(key, str) else key[0] + " " + str(key[1])[6:]}: '
            + json.dumps({k: v for k, v in r.items() if k != 'max_abs_err'}))
    return rec


# BatchNorm call sites of the full-width training step (batch 3), one per epilogue:
# channels-first shapes of channels-last memory
BN_SITES = {
    'swish': (54, 144, 112, 240),    # encoder: stage 2's expanded 1x1 (_bn0), the largest
    'add': (54, 32, 56, 120),        # encoder: an MBConv's projection and residual (_bn2)
    'none': (15, 128, 50, 50),       # decoder: layer2's projecting BasicBlock (bn2)
    'relu': (12, 32, 200, 200),      # future prediction: a Bottleneck's down-projection
    'add_relu': (15, 64, 100, 100),  # decoder: layer1's BasicBlock (bn2)
    'relu_add': (12, 64, 200, 200),  # future prediction: an identity Bottleneck
}
BN_SITE_5D = (3, 64, 3, 200, 200)    # temporal model: a block's projection (5-D)
BN_SERVED = (18, 144, 112, 240)      # the largest call of a request (eval)
BN_EPS = 1e-3


def rows(shape, dtype, gen, device, mean=0.0):
    """Seeded normals as a channels-first view of channels-last memory."""
    t = torch.randn(shape[:1] + shape[2:] + shape[1:2], generator=gen, device=device) + mean
    return t.to(dtype).movedim(-1, 1)


def bits_differ(got, want):
    """The number of values whose bits differ (two NaNs agree)."""
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    same = (got.contiguous().view(bits) == want.contiguous().view(bits)) | (
        torch.isnan(got) & torch.isnan(want))
    return int((~same).sum())


def rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def check_stats(name, got, want):
    """Within 1e-6 of the largest magnitude (relative)."""
    err = float((got - want).abs().max())
    if err > 1e-6 * float(want.abs().max()) + 1e-30:
        raise AssertionError(f'{name}: statistics differ by {err}')


def check_grads(name, got, want, dtype):
    """Relative L2 error within 1e-5 (f32) or 1e-2 (bf16), each output; returns the
    largest absolute error."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            continue
        err = rel_l2(a, b)
        if err > tol or not torch.isfinite(a).all():
            raise AssertionError(f'{name} output {i}: relative L2 error {err:.3e} > {tol}')
        worst = max(worst, float((a.float() - b.float()).abs().max()))
    return worst


def bn_case(shape, post, dtype, training, device, seed):
    """K10 forward and backward against their plain versions on one shape: y, the
    batch and running statistics, dx, dweight, dbias and dresidual. Returns the
    largest absolute errors of y and of the gradients."""
    gen = torch.Generator(device=device).manual_seed(seed)
    C = shape[1]
    x = rows(shape, dtype, gen, device, mean=0.5)
    res = rows(shape, dtype, gen, device) if post in ('add', 'add_relu', 'relu_add') else None
    dy = rows(shape, dtype, gen, device)
    w = torch.rand(C, generator=gen, device=device) + 0.5
    b = torch.randn(C, generator=gen, device=device)
    rm = torch.randn(C, generator=gen, device=device) * 0.1 + 0.5
    rv = torch.rand(C, generator=gen, device=device) + 0.5
    stats_k, stats_p = (rm.clone(), rv.clone()), (rm.clone(), rv.clone())
    got = batch_norm_forward(x, w, b, *stats_k, training, 0.1, BN_EPS, post, res)
    want = batch_norm_forward_plain(x, w, b, *stats_p, training, 0.1, BN_EPS, post, res)
    torch.cuda.synchronize()
    tag = f'batch_norm {post} {"train" if training else "eval"} {tuple(shape)}'
    if got[0].stride() != x.stride():
        raise AssertionError(f'{tag}: y in another layout than x')
    y_err = check_close(tag, got[0], want[0], dtype)
    n_diff = bits_differ(got[0], want[0])
    if n_diff:
        raise AssertionError(f'{tag}: {n_diff} values of y differ from the plain version\'s '
                             f'bits')
    if training:
        for label, a, c in zip(('mean', 'var', 'running mean', 'running var'),
                               got[1:3] + stats_k, want[1:3] + stats_p):
            check_stats(f'{tag} {label}', a, c)
    del want
    mean, var, clamp = got[1:]
    gk = batch_norm_backward(dy, x, w, b, mean, var, clamp, BN_EPS, post, res, training)
    gp = batch_norm_backward_plain(dy, x, w, b, mean, var, clamp, BN_EPS, post, res,
                                   training)
    torch.cuda.synchronize()
    return y_err, check_grads(f'{tag} backward', gk, gp, dtype)


def gru_case(B, Cx, dtype, device, seed, C=64, T=4, H=200, W=200):
    """K11's two launches and their backward against the plain versions at one
    rollout shape, with the state in slots of (B, T, C, H, W) buffers and the
    concat's gradient a channel slice, as the GRU runs them. Returns the inputs
    and the largest absolute errors forward and backward."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, T, H, W, Cx), generator=gen, device=device).to(dtype).permute(
        0, 1, 4, 2, 3)
    prev = gru_output(torch.empty((B, C, H, W), dtype=dtype, device=device), T)
    prev.copy_(torch.randn(prev.shape, generator=gen, device=device))
    h, x_t = prev[:, 1], x[:, 1]
    r_pre, u_pre, ht = (rows((B, C, H, W), dtype, gen, device) for _ in range(3))
    out = gru_output(h, T)
    tag = f'spatial_gru B={B} C_x={Cx}'
    err = max(check_close(f'{tag} reset_concat', reset_concat(x_t, r_pre, h),
                          reset_concat_plain(x_t, r_pre, h), dtype),
              check_close(f'{tag} state_update', state_update(u_pre, h, ht, out, 2),
                          state_update_plain(u_pre, h, ht), dtype))
    dcat = rows((B, Cx + C, H, W), dtype, gen, device)
    dout = prev[:, 3]
    got = reset_concat_backward(dcat[:, Cx:], r_pre, h) + state_update_backward(
        dout, u_pre, h, ht)
    want = reset_concat_backward_plain(dcat[:, Cx:], r_pre, h) \
        + state_update_backward_plain(dout, u_pre, h, ht)
    torch.cuda.synchronize()
    bwd_err = check_grads(f'{tag} backward', got, want, dtype)
    return dict(x_t=x_t, h=h, r_pre=r_pre, u_pre=u_pre, ht=ht, out=out, dcat=dcat,
                dout=dout), err, bwd_err


def card_tests():
    """tests/test_torch_norm_gru_gpu.py, the card tests of K10 and K11, as a module."""
    spec = importlib.util.spec_from_file_location(
        'test_torch_norm_gru_gpu', os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                'tests', 'test_torch_norm_gru_gpu.py'))
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)
    return card


def gru_exact_checks(device):
    """The card tests' K11 check (tests/test_torch_norm_gru_gpu.py gru_sweep): every
    bf16 bit pattern as r_pre and u_pre through both forward launches and both
    backward launches, at 16-, 4- and 2-byte accesses and at one channel: every
    output equal to the plain version in every bit."""
    card = card_tests()
    for C, offset in ((64, 0), (64, 2), (64, 1), (1, 0)):
        found = card.gru_sweep(device, C, offset)
        log(f'  spatial_gru every bf16 value, C={C}, channel offset {offset}: values whose '
            f'bits differ from the plain version ' + json.dumps(found))
        if any(found.values()):
            raise AssertionError(f'spatial_gru C={C} offset {offset}: {found}')


def bn_exact_checks(device):
    """The card tests' K10 checks (tests/test_torch_norm_gru_gpu.py): every bf16 bit
    pattern through every epilogue (y, dx, dres against the plain version, bit for
    bit but at the NaN inputs of the epilogues that take a max), the channel
    counts that are not multiples of 8, a dy slice at an odd row stride, and two
    runs that give the same bits."""
    card = card_tests()
    for post in POSTS:
        for C, seeded in ((64, False), (1, False), (64, True)):
            found = card.bf16_sweep(device, post, C, seeded)
            log(f'  batch_norm every bf16 value, {post}, C={C}'
                f'{", seeded constants" if seeded else ""}: values whose bits differ '
                f'from the plain version (of them at NaN inputs of a max) '
                + json.dumps({k: v[:2] for k, v in found.items()}))
            for name, (diff, excused, examples) in found.items():
                if diff != excused:
                    raise AssertionError(f'batch_norm {post} C={C} {name}: {diff - excused} '
                                         f'values differ from the plain version: {examples}')
    for C in (21, 23, 35):
        for post in ('none', 'swish', 'add_relu'):
            for training in (False, True):
                card.test_batch_norm_odd_channel_counts_match_plain(device, C, post, training)
    for dtype in (torch.float32, torch.bfloat16):
        card.test_batch_norm_backward_reads_a_dy_slice_at_an_odd_row_stride(device, dtype)
    card.test_batch_norm_is_deterministic_and_refuses_other_layouts(device)
    log('  batch_norm: C = 21, 23, 35 equal to plain (y bit for bit); a dy slice at row '
        'stride 99 read in place; two runs give the same bits')


def bn_timings(device):
    """K10's passes on their own at the largest training call (BN_SITES['swish'],
    forward and backward) and the largest served call (BN_SERVED, eval), bf16 and
    f32, with post none and swish (bytes against arithmetic): each pass's device
    ms, one call's ms (CUDA events), the library call's (F.batch_norm, + F.silu
    for swish; its autograd for the backward) and the bound (bytes: inputs read
    once, outputs written once). Returns the records, bf16 swish under the
    kernels line's keys."""
    rec = {}
    gen = torch.Generator(device=device).manual_seed(99)
    for dtype in (torch.bfloat16, torch.float32):
        for post in ('swish', 'none'):
            lib_post = F.silu if post == 'swish' else (lambda t: t)
            headline = dtype == torch.bfloat16 and post == 'swish'
            tag = f'{str(dtype)[6:]} {post}'
            for key, shape, training in (('batch_norm', BN_SITES['swish'], True),
                                         ('batch_norm eval', BN_SERVED, False)):
                x = rows(shape, dtype, gen, device)
                C, n, es = shape[1], x.numel(), x.element_size()
                w, b = torch.ones(C, device=device), torch.zeros(C, device=device)
                rm, rv = torch.zeros(C, device=device), torch.ones(C, device=device)
                args = (x, w, b, rm, rv, training, 0.1, BN_EPS, post)
                lib_stats = (rm.clone(), rv.clone())
                by_pass = pass_ms(lambda: batch_norm_forward(*args), k10_pass,
                                  {'stats': 1, 'apply': 1} if training else {'apply': 1})
                r = dict(ms=sum(by_pass.values()), pass_ms=by_pass,
                         call_ms=time_ms(lambda: batch_norm_forward(*args)),
                         library_ms=time_ms(lambda: lib_post(F.batch_norm(
                             x, *lib_stats, w, b, training, 0.1, BN_EPS))),
                         bytes=2 * n * es, flops=(12.0 if training else 9.0) * n, shape=shape)
                if headline:
                    r['plain_ms'] = time_ms(lambda: batch_norm_forward_plain(*args), reps=5,
                                            warmup=1)
                rec[key if headline else f'{key} {tag}'] = r
                if training:
                    _, mean, var, clamp = batch_norm_forward(*args)
                    dy = rows(shape, dtype, gen, device)
                    bargs = (dy, x, w, b, mean, var, clamp, BN_EPS, post, None, True)
                    xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, b))
                    yl = lib_post(F.batch_norm(xl, *lib_stats, wl, bl, True, 0.1, BN_EPS))
                    by_pass = pass_ms(lambda: batch_norm_backward(*bargs), k10_pass,
                                      {'backward_reduce': 1, 'backward_apply': 1})
                    r = dict(ms=sum(by_pass.values()), pass_ms=by_pass,
                             call_ms=time_ms(lambda: batch_norm_backward(*bargs)),
                             library_ms=time_ms(lambda: torch.autograd.grad(
                                 yl, (xl, wl, bl), dy, retain_graph=True)),
                             bytes=3 * n * es, flops=26.0 * n, shape=shape)
                    if headline:
                        r['plain_ms'] = time_ms(lambda: batch_norm_backward_plain(*bargs),
                                                reps=5, warmup=1)
                    rec['batch_norm_backward' if headline else f'batch_norm_backward {tag}'] = r
                    del yl, xl, dy, mean, var, clamp
                del x
                torch.cuda.empty_cache()
    log(f'  batch_norm timings: {smi_line()}')
    return rec


def phase_norm_gru_kernels(device):
    """K10 (BatchNorm with its epilogue) forward, eval and training, and backward
    against their plain versions: every epilogue at a call site of the training
    step that uses it (4-D) and at the temporal model's 5-D shape, f32 and bf16
    (y equal to the plain version in every bit, and within 1e-5 + 1e-5 |y| or one
    bf16 ulp; statistics 1e-6 relative, gradients 1e-5 or 1e-2 relative L2); the
    card tests' exact checks (bn_exact_checks); each K10 pass timed (bn_timings).
    K11 (the GRU's gate launches) forward and backward at B = 1 (served) and B = 3
    (trained), f32 and bf16, same tolerances, timed at the bf16 calls: kernel,
    call, plain version, the library ops they replace; bounds from this run's
    shapes."""
    errs = {'batch_norm': 0.0, 'batch_norm_backward': 0.0}
    seed = 0
    for post in POSTS:
        for shape in (BN_SITES[post], BN_SITE_5D):
            for dtype in (torch.float32, torch.bfloat16):
                for training in (False, True):
                    seed += 1
                    fwd, bwd = bn_case(shape, post, dtype, training, device, seed)
                    if dtype == torch.bfloat16:
                        errs['batch_norm'] = max(errs['batch_norm'], fwd)
                        errs['batch_norm_backward'] = max(errs['batch_norm_backward'], bwd)
        log(f'  batch_norm {post}: forward (eval, train) and backward equal to plain within '
            f'tolerance at {BN_SITES[post]} and {BN_SITE_5D}, f32 and bf16')
    bn_exact_checks(device)
    rec = bn_timings(device)

    gru_exact_checks(device)
    errs.update(spatial_gru=0.0, spatial_gru_backward=0.0)
    for B, Cx in ((1, 32), (3, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            t, fwd, bwd = gru_case(B, Cx, dtype, device, seed=B)
            if dtype == torch.bfloat16:
                errs['spatial_gru'] = max(errs['spatial_gru'], fwd)
                errs['spatial_gru_backward'] = max(errs['spatial_gru_backward'], bwd)
        log(f'  spatial_gru B={B} C_x={Cx}: both launches and their backward equal to plain '
            f'within tolerance, f32 and bf16')
        x_t, h, r_pre, u_pre, ht = (t[k] for k in ('x_t', 'h', 'r_pre', 'u_pre', 'ht'))
        out, dcat, dout = t['out'], t['dcat'], t['dout']
        n = h.numel()
        es = h.element_size()

        def old_step():
            """The torch ops the two launches replace (one step, the stack's share
            as one slot written)."""
            r = torch.sigmoid(r_pre)
            cat = torch.cat([x_t, (1.0 - r) * h], dim=1)
            u = torch.sigmoid(u_pre)
            return cat, torch.stack([(1.0 - u) * h + u * ht], dim=1)

        leaves = [v.detach().clone().requires_grad_() for v in (r_pre, h, u_pre, ht)]
        r_l, h_l, u_l, ht_l = leaves
        cat_l = torch.cat([x_t, (1.0 - torch.sigmoid(r_l)) * h_l], dim=1)
        u_s = torch.sigmoid(u_l)
        new_l = torch.stack([(1.0 - u_s) * h_l + u_s * ht_l], dim=1)
        rec[('spatial_gru', B)] = dict(
            ms=kernel_ms(lambda: (reset_concat(x_t, r_pre, h),
                                  state_update(u_pre, h, ht, out, 2)),
                         ['reset_concat_kernel', 'state_update_kernel'], 2),
            call_ms=time_ms(lambda: (reset_concat(x_t, r_pre, h),
                                     state_update(u_pre, h, ht, out, 2))),
            plain_ms=time_ms(lambda: (reset_concat_plain(x_t, r_pre, h),
                                      state_update_plain(u_pre, h, ht))),
            library_ms=time_ms(old_step),
            bytes=es * (x_t.numel() + 4 * n + (x_t.numel() + n) + n), flops=20.0 * n)
        rec[('spatial_gru_backward', B)] = dict(
            ms=kernel_ms(lambda: (reset_concat_backward(dcat[:, Cx:], r_pre, h),
                                  state_update_backward(dout, u_pre, h, ht)),
                         ['reset_concat_backward_kernel', 'state_update_backward_kernel'], 2),
            call_ms=time_ms(lambda: (reset_concat_backward(dcat[:, Cx:], r_pre, h),
                                     state_update_backward(dout, u_pre, h, ht))),
            plain_ms=time_ms(lambda: (reset_concat_backward_plain(dcat[:, Cx:], r_pre, h),
                                      state_update_backward_plain(dout, u_pre, h, ht))),
            library_ms=time_ms(lambda: torch.autograd.grad(
                (cat_l, new_l), leaves, (dcat, dout[:, None]), retain_graph=True)),
            # reads dcat's state half, dout, r_pre, u_pre, h and h_tilde; writes
            # dr_pre, du_pre, dh and dh_tilde (dh once, though the two launches
            # write it in two parts)
            bytes=es * 10 * n, flops=25.0 * n)
        # what autograd's sum of the two launches' dh parts costs (one add of two
        # maps), which a single write would save
        dh_a, dh_b = reset_concat_backward(dcat[:, Cx:], r_pre, h)[1], state_update_backward(
            dout, u_pre, h, ht)[1]
        rec[('spatial_gru_backward', B)]['dh_sum_ms'] = kernel_ms(lambda: dh_a + dh_b,
                                                                 ['add'], 1)
        del t, leaves, cat_l, new_l, u_s
    host = host_us_per_call()
    log('  host µs of one wrapper call (bf16, 64 channels, 8 x 8): ' + json.dumps(host))
    rec[('spatial_gru', 3)]['host_us'] = host['gru_reset_concat (K11)']
    for key, r in rec.items():
        r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['flops'])
        name = key if isinstance(key, str) else f'{key[0]} B={key[1]}'
        log(f'  {name}: ' + json.dumps({k: v for k, v in r.items()}))
    return rec, errs


def relative_l2_gradients(got, want, leaves_only=()):
    """Worst relative L2 error of the gradients over the top-level modules (but
    those in ``leaves_only``) and over the leaves (each leaf's norm floored at 1e-3
    of its module's)."""
    worst_module, worst_leaf = (0.0, ''), (0.0, '')
    for m in sorted({n.split('.')[0] for n in want}):
        names = [n for n in want if n.split('.')[0] == m]
        a = torch.cat([got[n].flatten() for n in names])
        b = torch.cat([want[n].flatten() for n in names])
        if m not in leaves_only:
            worst_module = max(worst_module, (float((a - b).norm() / b.norm()), m))
        for n in names:
            floor = max(float(want[n].norm()), 1e-3 * float(b.norm()))
            worst_leaf = max(worst_leaf, (float((got[n] - want[n]).norm()) / floor, n))
    return worst_module, worst_leaf


def module_errors(got, want):
    """{top-level module: relative L2 error of its gradients}."""
    out = {}
    for m in sorted({n.split('.')[0] for n in want}):
        names = [n for n in want if n.split('.')[0] == m]
        a = torch.cat([got[n].flatten() for n in names])
        b = torch.cat([want[n].flatten() for n in names])
        out[m] = float((a - b).norm() / b.norm())
    return out


def rounding_sensitivity(trainer, batch, noise, scale=2.0 ** -20):
    """How far rounding-sized changes move a step's gradients: {module: relative L2
    change of the trainer's gradients when every weight is scaled by (1 + scale
    N(0, 1)), seeded}. The weights are restored after."""
    def gradients():
        trainer.compute_gradients(batch, noise=noise.to(trainer.device))
        return {n: p.grad.double().cpu() for n, p in trainer.model.named_parameters()}

    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    want = gradients()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.mul_(1 + scale * torch.randn(p.shape, generator=gen).to(p.device))
    got = gradients()
    trainer.model.load_state_dict(state)
    return module_errors(got, want)


def phase_tiny_train_card_vs_cpu(overrides=TINY, name='tiny train', leaves_only=(),
                                 sensitivity=False):
    """One tiny training step (f32, TF32 off) on the card and on the CPU from the same
    weights, batch and noise, drop-connect off: the losses within rtol/atol 1e-3; the
    gradients within a relative L2 error of 1e-2 per module and 1e-1 per leaf, the
    criterion tests/test_torch_trainer.py holds the port to against JAX (f32 rounding
    alone moves some leaves' gradients by per cents). The modules in ``leaves_only``
    are held per leaf only, as tests/test_torch_levers.py holds the combination's
    future prediction and decoder (their f32 gradients move by per cents with the
    order of the sums alone). Under ``sensitivity`` each module is held to the larger
    of 1e-2 and twice the change that weights moved by 2^-20 make on the CPU alone
    (``rounding_sensitivity``): a step whose gradients a rounding-sized change moves
    by per cents (a branch of the step taken the other way) is held to that."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_cfg(cfg_dict={**overrides, 'BATCHSIZE': 2})
    trainers = {d: Trainer(cfg, device=d) for d in ('cpu', 'cuda')}
    init_params(trainers['cpu'].model, seed=3)
    trainers['cuda'].model.load_state_dict(trainers['cpu'].model.state_dict())
    for tr in trainers.values():
        for block in tr.model.encoder.backbone._blocks:
            block.drop_rate = 0.0
    batch = SyntheticFutureDataset(cfg, n_samples=2, n_instances=2, seed=4).get_batch([0, 1])
    if cfg.DATASET.PREWARP_LABELS:
        batch = make_prewarp_transform(cfg)(batch)
    noise = torch.from_numpy(np.random.RandomState(5).randn(
        2, 1, cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(np.float32))
    losses = {d: tr.compute_gradients(batch, noise=noise)[0] for d, tr in trainers.items()}
    torch.cuda.synchronize()
    for k, v in losses['cpu'].items():
        got = losses['cuda'][k].cpu()
        log(f'  {name} {k}: card {float(got):.6f} cpu {float(v):.6f}')
        torch.testing.assert_close(got, v, rtol=1e-3, atol=1e-3, msg=k)
    grads = {d: {n: p.grad.double().cpu() for n, p in tr.model.named_parameters()}
             for d, tr in trainers.items()}
    (module_err, module), (leaf_err, leaf) = relative_l2_gradients(
        grads['cuda'], grads['cpu'], leaves_only)
    log(f'  {name} gradients: worst module relative L2 error {module_err:.3e} ({module}), '
        f'worst leaf {leaf_err:.3e} ({leaf}), over {len(grads["cpu"])} leaves')
    over = {module: module_err} if module_err > 1e-2 else {}
    if sensitivity:
        errs = module_errors(grads['cuda'], grads['cpu'])
        floor = rounding_sensitivity(trainers['cpu'], batch, noise)
        log(f'  {name} gradients by module, card vs cpu and cpu vs cpu with the weights '
            f'moved 2^-20: ' + json.dumps({m: [errs[m], floor[m]] for m in errs}))
        over = {m: e for m, e in errs.items() if e > max(1e-2, 2 * floor[m])}
    if over or leaf_err > 1e-1:
        raise AssertionError(f'{name}: card and CPU gradients differ: modules {over}, '
                             f'worst leaf {leaf_err}')
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


ACC_STEPS = 150
ACC_MODES = ('dense', 'topk8_warpfree')
# the modes whose BASE request and training step are held card against the CPU: the
# phase's two, and topk8 (its IoU gap to JAX's r5 run is open, PERF.md §7)
ACC_CARD_VS_CPU = ('dense', 'topk8', 'topk8_warpfree')
# the steps of the study's train_mode whose launches are held to expected_launches
ACC_LAUNCH_STEPS = 2
# the heads' relative L2 error card against CPU at BASE (tests/test_torch_accuracy_ab.py
# holds the port's heads to JAX's by the same bound)
ACC_HEADS_REL_L2 = 1e-4
# the kernels of the study's path: training (K1-K5 and the backwards, K10, K11) and
# the evaluation's decode before the host tracker (K6, K7)
ACC_KERNELS = ('bev_pool', 'bev_pool_backward', 'bev_warp', 'bev_warp_backward', 'kth_largest',
               'bev_warp_nearest', 'topk_select', 'topk_select_backward', 'instance_centers',
               'group_pixels', 'batch_norm', 'batch_norm_backward', 'spatial_gru',
               'spatial_gru_backward')
JAX_TRAIN_REPORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'reports',
                                'accuracy_ab_train_r5.json')


def key_tree(x):
    """The keys of a JSON value and their nesting, without the values."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [key_tree(x[0])] if x and isinstance(x[0], (dict, list)) else []
    return None


def phase_accuracy(device):
    """The lever accuracy study (fiery_tpu_torch/accuracy_ab.py) at its full width
    (BASE) on the card, cut to one seed of ACC_STEPS steps of dense and
    topk8_warpfree: trained, evaluated matched, dense-parity and cross-served,
    then the activation study on the random and the trained states. Gates: finite
    losses whose last 25 steps' mean is below the first 25's; the JSONs' keys are
    the JAX harness's (reports/accuracy_ab_train_r5.json, the activation keys) plus
    ``device``, base_cfg holding BASE; every kernel of the path launched and no
    plain version ran; each mode's launches a step of train_mode those of
    expected_launches (K10's apart, which count BatchNorm calls); dense against
    dense differs nowhere (the study's path is deterministic); and, for each of
    ACC_CARD_VS_CPU at BASE, a request and a training step through the kernels
    equal to the CPU's plain path (phase_tiny_card_vs_cpu,
    phase_tiny_train_card_vs_cpu). Returns {kernel: launches} of the study."""
    from fiery_tpu_torch import accuracy_ab as ab
    with open(JAX_TRAIN_REPORT) as f:
        jax_train = key_tree(json.load(f))
    with tempfile.TemporaryDirectory() as tmp:
        train_json, act_json = os.path.join(tmp, 'train.json'), os.path.join(tmp, 'act.json')
        reset_counters()
        t0 = time.perf_counter()
        _, runs = ab.run_train_study(ACC_STEPS, train_json, seeds=(0,), device=device,
                                     modes=ACC_MODES)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ab.run_activation_study(ACC_STEPS, act_json, device=device)
        act_s = time.perf_counter() - t0
        launches = {k: COUNTERS[k].launches for k in COUNTERS}
        layout_report()
        with open(train_json) as f:
            train = json.load(f)
        with open(act_json) as f:
            act = json.load(f)
    missing = [k for k in ACC_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f'accuracy: kernels not launched {missing}: {launches}')
    log(f'accuracy study (main path) launches: '
        f'{json.dumps({k: v for k, v in launches.items() if v})}')
    for mode in ACC_MODES:
        losses, wall = runs[mode][0]['losses'], runs[mode][0]['wall_s']
        first, last = float(np.mean(losses[:25])), float(np.mean(losses[-25:]))
        if not np.isfinite(losses).all() or not last < first:
            raise AssertionError(f'accuracy: {mode}: losses finite {np.isfinite(losses).all()}, '
                                 f'mean of the last 25 steps {last} not below the first '
                                 f'25\'s {first}')
        log(f'accuracy: {mode}: {ACC_STEPS} steps in {wall:.3f} s '
            f'({ACC_STEPS / wall:.3f} steps/s); loss mean of the first 25 steps {first:.4f}, '
            f'of the last 25 {last:.4f}')
    for mode in ACC_MODES:
        cfg = ab._cfg(ab.MODES[mode])
        reset_counters()
        ab.train_mode(mode, ACC_LAUNCH_STEPS, log_every=ACC_LAUNCH_STEPS + 1, device=device)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in COUNTERS.items()}
        layout_report()
        want = expected_launches(FieryConfig.from_cfg(cfg), cfg,
                                 got['batch_norm'] / ACC_LAUNCH_STEPS,
                                 got['batch_norm_backward'] / (2 * ACC_LAUNCH_STEPS))
        check_launches(f'accuracy {mode} train_mode', got, want, ACC_LAUNCH_STEPS)
        log(f'accuracy: {mode}: launches a step '
            f'{json.dumps({k: v / ACC_LAUNCH_STEPS for k, v in got.items() if v})}')
    # base_cfg is the study's BASE (JAX's r5 file records its BASE after its _merge
    # had set TRIM_TRAIN in the nested dict that BASE shares; the port's copies)
    want = dict(jax_train, device=None, base_cfg=key_tree(json.loads(json.dumps(ab.BASE))))
    want['results'] = {k: jax_train['results'][k] for k in
                       ACC_MODES + ('dense_trained_cross_serving',)}
    if key_tree(train) != want:
        raise AssertionError(f'accuracy: the train JSON\'s keys {key_tree(train)} are not the '
                             f'JAX harness\'s plus device {want}')
    act_rows = {'depth_entropy_nats', 'top8_captured_mass'} | {
        f'bev_feature_rel_err_{lever}' for lever in ('topk8', 'warpfree', 'topk8_warpfree')} | {
        f'seg_logit_rel_err_{lever}' for lever in ('topk8', 'warpfree')}
    if (sorted(act) != ['device', 'random_init', 'trained']
            or any(set(act[tag]) != act_rows for tag in ('random_init', 'trained'))):
        raise AssertionError(f'accuracy: the activation JSON\'s keys {key_tree(act)}')
    # dense against dense: the same features and logits, bit for bit
    val = ab._to_device(SyntheticFutureDataset(ab._cfg({}), n_samples=2, n_instances=3,
                                               seed=1000).get_batch([0, 1]), device)
    trained = torch.load(ab._dense_cache_path(ACC_STEPS), map_location=device)
    same = {'bev': ab._err_percentiles(ab._bev_features(trained, ab.MODES['dense'], val),
                                       ab._bev_features(trained, ab.MODES['dense'], val)),
            'seg': ab._err_percentiles(
                ab._head_outputs(trained, ab.MODES['dense'], val)['segmentation'],
                ab._head_outputs(trained, ab.MODES['dense'], val)['segmentation'])}
    if any(v for errs in same.values() for v in errs.values()):
        raise AssertionError(f'accuracy: dense against dense differs: {same}')
    results = train['results']
    log('accuracy: ' + json.dumps({
        'device': train['device'], 'train_s': round(train_s, 3), 'activation_s': round(act_s, 3),
        'eval': {m: results[m]['per_seed'][0] for m in ACC_MODES},
        'cross_serving': results['dense_trained_cross_serving'],
        'trained_top8_mass_p50': act['trained']['top8_captured_mass']['p50'],
        'random_top8_mass_p50': act['random_init']['top8_captured_mass']['p50']}))
    # the study's kernels at its own shapes (D = 24, a 64 x 64 grid, 4 cameras of
    # 32 x 48) against the CPU's plain path: the heads at the relative L2 error that
    # tests/test_torch_accuracy_ab.py holds them to against JAX at BASE; the gradients
    # against the step's own sensitivity to rounding (at these weights topk8's
    # encoder, temporal model and present distribution move by 2 per cent on the CPU
    # alone when the weights move by 2^-20: tests/torch_init_evidence.py step)
    t0 = time.perf_counter()
    for mode in ACC_CARD_VS_CPU:
        overrides = ab._merge(ab.BASE, ab.MODES[mode])
        phase_tiny_card_vs_cpu(overrides, name=f'accuracy {mode}', yaw=0.2,
                               rel_l2=ACC_HEADS_REL_L2)
        phase_tiny_train_card_vs_cpu(overrides, name=f'accuracy {mode} train',
                                     sensitivity=True)
    log(f'accuracy: BASE card vs cpu, {", ".join(ACC_CARD_VS_CPU)}: ok '
        f'({time.perf_counter() - t0:.1f} s)')
    return launches


# the JAX package's model families beside baseline.yml (YAMLs that differ only in
# data flags build the same model; each is represented once) and the two
# architecture overrides no YAML sets, each with its own overrides, served and
# trained at full width and PRECISION 16 by phase_families
FAMILIES = [
    ('identity', 'single_timeframe.yml', ()),
    ('temporal', 'temporal_single_timeframe.yml', ()),
    ('static_pon', 'literature/static_pon_setting.yml', ()),
    ('pon', 'literature/pon_setting.yml', ()),
    ('fishing', 'literature/fishing_setting.yml', ()),
    ('fishing_topk8', 'literature/fishing_setting.yml', ('LIFT.TOPK', '8')),
    ('lyft', 'lyft/baseline.yml', ()),
    ('downsample_16', 'baseline.yml', ('MODEL.ENCODER.DOWNSAMPLE', '16')),
    ('inbetween_1', 'baseline.yml', ('MODEL.TEMPORAL_MODEL.INBETWEEN_LAYERS', '1')),
]
# the clip a loader hands the trainer under MODEL.SUBSAMPLE: 3 past and present and 5
# future frames of the subsampled clip (the synthetic set does not subsample)
SUBSAMPLED_CLIP = ('TIME_RECEPTIVE_FIELD', '3', 'N_FUTURE_FRAMES', '5')


def family_cfg(yaml, opts=()):
    """The config of a YAML under fiery_tpu_torch/configs/ at PRECISION 16."""
    path = os.path.join(os.path.dirname(BASELINE), yaml)
    return get_cfg(argparse.Namespace(config_file=path, opts=['PRECISION', '16', *opts]))


def family_serve(name, cfg, state_dict, n_requests=3):
    """Eager requests through predict_instances (the unfolded bf16 model of the seeded
    weights): output shapes and finite values, ids (1, frames, X, Y), the device
    tracker under set_sync_debug_mode('error'), each kernel's launches a request.
    Returns (the model's FieryConfig, the outputs, K10's launches a request, the
    launches a request, peak memory)."""
    model = build_fiery(cfg, state_dict=state_dict)
    mc = model.cfg
    _, _, bn_launches, _ = count_bn_calls(
        model, lambda: predict_instances(model, make_request(cfg, seed=9)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    outputs = [predict_instances(model, make_request(cfg, seed=10 + i))
               for i in range(n_requests)]
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    layout_report()
    peak = torch.cuda.max_memory_allocated()
    per_request = expected_launches(mc, cfg, bn_launches)
    check_launches(f'{name} serve', launches, per_request, n_requests)
    check_request_outputs(name, mc, outputs)
    torch.cuda.set_sync_debug_mode('error')
    try:
        for out, _ in outputs:
            device_consistent(out)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    del model
    return mc, [out for out, _ in outputs], bn_launches, per_request, peak


def family_graph(name, cfg, state_dict, k10_launches, reps=10):
    """The served form (``build_served``: folded, cast, captured): three requests
    through both graphs equal to the eager folded model bit for bit, ids too, with
    no wrapper called in a replay; the graph's and the eager folded
    predict_instances timed, ``reps`` each in turns; peak memory with the graphs'
    pool; the device busy of a profiled replay (its K10 launches all recorded)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    served = build_served(cfg, state_dict)
    eager = build_fiery(cfg, state_dict=state_dict, fold_bn=True)
    requests = [make_request(cfg, seed=10 + i) for i in range(3)]
    replays_match_eager(f'{name} graph', served, eager, requests)
    times = in_turns({'graph': served.predict_instances,
                      'eager folded': lambda r: predict_instances(eager, r)},
                     requests, reps, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    served.load(requests[0])
    kernels, _, busy, k10_ms = window_kernels(lambda: served.replay('predict_instances'),
                                              k10_launches)
    rec = {'graph_ms': statistics.median(times['graph']),
           'eager_folded_ms': statistics.median(times['eager folded']),
           'graph_spread_ms': [min(times['graph']), max(times['graph'])],
           'eager_folded_spread_ms': [min(times['eager folded']), max(times['eager folded'])],
           'replay_busy_ms': busy, 'replay_kernels': sum(kernels.values()),
           'replay_k10_ms': sum(k10_ms.values()), 'graph_peak_bytes': peak,
           'graph_peak_above_held_bytes': peak - held}
    del served, eager
    return rec


def family_train(name, cfg, n_steps=2):
    """A warm-up and ``n_steps`` training steps at the family's BATCHSIZE on one
    seeded synthetic batch (under MODEL.SUBSAMPLE the 8-frame subsampled clip):
    finite losses, parameters and BatchNorm statistics moved, each kernel's launches
    a step; the steps' host-clock ms and the peak memory."""
    cfg = cfg.clone()
    cfg.defrost()
    cfg.merge_from_list(['DATASET.NAME', 'synthetic'])
    trainer = Trainer(cfg)
    init_params(trainer.model, seed=0)
    calibrate_batchnorm(trainer.model, [make_request(cfg, seed=s) for s in (6, 7)])
    batch_cfg = cfg.clone()
    if cfg.MODEL.SUBSAMPLE:
        batch_cfg.merge_from_list(list(SUBSAMPLED_CLIP))
    b = cfg.BATCHSIZE
    batch = SyntheticFutureDataset(batch_cfg, n_samples=b, seed=0).get_batch(range(b))
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    _, bn_calls, bn_launches, _ = count_bn_calls(trainer.model,
                                                 lambda: trainer.train_step(batch, gen))
    torch.cuda.synchronize()
    m = trainer.model
    watched = {'stem conv': m.encoder.backbone._conv_stem.weight,
               'segmentation head': m.decoder.segmentation_head[3].weight,
               'segmentation uncertainty': trainer.uncertainty['segmentation_weight'],
               'stem BN running var': m.encoder.backbone._bn0.running_var,
               'decoder BN running mean': m.decoder.bn1.running_mean}
    before = {k: v.detach().clone() for k, v in watched.items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        step_losses, total = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append({'total': float(total), **{k: float(v) for k, v in step_losses.items()}})
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    layout_report()
    peak = torch.cuda.max_memory_allocated()
    check_launches(f'{name} train', launches,
                   expected_launches(m.cfg, cfg, bn_launches, bn_calls), n_steps)
    if not all(np.isfinite(v) for r in losses for v in r.values()):
        raise AssertionError(f'{name} train: non-finite losses {losses}')
    still = [k for k, v in watched.items() if torch.equal(v.detach(), before[k])]
    if still:
        raise AssertionError(f'{name} train: {still} did not change')
    del trainer
    return {'batch': b, 'step_ms': statistics.median(times), 'steps_ms': times,
            'train_peak_bytes': peak, 'losses': losses[-1],
            'train_launches': {k: n // n_steps for k, n in launches.items() if n}}


def phase_families(device):
    """Each of FAMILIES at full width, PRECISION 16, seeded weights with BatchNorm
    calibrated (``seeded_state_dict``): eager serving (``family_serve``), the served
    graphs (``family_graph``) and training (``family_train``); then K1, K2, K4, K5
    and K6-K8 against their plain versions at the families' shapes
    (``family_kernels``) and the export CLI with --validate for pon_setting.yml.
    Prints a line a family; returns (the records by family, the kernels' records)."""
    rec, heads = {}, {}
    for name, yaml, opts in FAMILIES:
        marks = [time.perf_counter()]
        cfg = family_cfg(yaml, opts)
        state_dict = seeded_state_dict(cfg, seed=0)
        marks.append(time.perf_counter())
        mc, outputs, k10, per_request, serve_peak = family_serve(name, cfg, state_dict)
        marks.append(time.perf_counter())
        if name in ('pon', 'fishing'):
            heads[name] = outputs[0]
        r = {'yaml': yaml, 'opts': list(opts), 'bev': list(mc.bev_size),
             'depth': mc.depth_channels, 'frames_in': mc.receptive_field,
             'frames_out': 1 + mc.n_future, 'request_launches': {
                 k: n for k, n in per_request.items() if n}, 'serve_peak_bytes': serve_peak}
        r.update(family_graph(name, cfg, state_dict, k10))
        marks.append(time.perf_counter())
        del state_dict, outputs
        r.update(family_train(name, cfg))
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
        r['seconds'] = dict(zip(('weights', 'serve', 'graph', 'train'),
                                np.diff(marks).round(2).tolist()))
        rec[name] = r
        log(f'family {name} ({yaml} {" ".join(opts)}): graph request median '
            f'{r["graph_ms"]:.3f} ms (eager folded {r["eager_folded_ms"]:.3f}), replay busy '
            f'{r["replay_busy_ms"]:.3f} ms, train step at batch {r["batch"]} median '
            f'{r["step_ms"]:.3f} ms, peak bytes serve {serve_peak} graph '
            f'{r["graph_peak_bytes"]} train {r["train_peak_bytes"]}; '
            f'{sum(r["seconds"].values()):.1f} s; {smi_line()}')
        log(f'family {name}: ' + json.dumps(r))
    kernels = family_kernels(heads, device)
    from fiery_tpu_torch import export as export_cli
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='fiery_export_') as tmp:
        export_cli.main(['--config', os.path.join(os.path.dirname(BASELINE), 'literature',
                                                  'pon_setting.yml'),
                         '--output', os.path.join(tmp, 'pon.fiery'), '--validate'])
    log(f'families: export --validate of pon_setting.yml at full width: ok '
        f'({time.perf_counter() - t0:.1f} s)')
    return rec, kernels


def family_voxel_ids(cfg, reps, device):
    """Voxel ids (S, N, h, w, D) of ``reps`` clips of a config's seeded rig
    (make_request's), with its number of bins and of height bins."""
    mc = FieryConfig.from_cfg(cfg)
    req = make_request(cfg, seed=0)
    frustum = torch.from_numpy(create_frustum(mc.final_dim, mc.encoder_downsample,
                                              mc.d_bound)).to(device)
    res, start, dim = mc.bev_parameters
    ids = voxel_ids(get_geometry(frustum, torch.from_numpy(req['intrinsics'][0]).to(device),
                                 torch.from_numpy(req['extrinsics'][0]).to(device)),
                    res, start, dim)
    ids = ids.permute(0, 1, 3, 4, 2).repeat(reps, 1, 1, 1, 1).contiguous()
    return ids, int(np.prod(dim)), int(dim[2])


def timed(fn, symbols, launches, plain, library, nbytes, flops, err, plain_reps=REPS):
    """A kernel's record: device ms (profiled), call, plain and library ms (CUDA
    events), the bound from the bytes and operations of this call."""
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(max_abs_err=err, ms=kernel_ms(fn, symbols, launches), call_ms=time_ms(fn),
                plain_ms=time_ms(plain, reps=plain_reps, warmup=1),
                library_ms=None if library is None else time_ms(library),
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)


def family_kernels(heads, device, k=8, C=64):
    """The kernels at the families' shapes against their plain versions, bf16 and
    f32, timed:
      fishing (D = 28, 320 x 192): K1 forward (3 samples, the request's) and
      backward (9, a step's), within tolerance of the plain version and the forward
      bit for bit to it on the host; K5 (3 and 9 samples, k = 8; bf16 rows of 56
      bytes, the per-weight loads) and its backward (9) equal to their plain
      versions;
      pon (400 x 200, extent (50, 25)): K2 forward (2 maps, a request's; 8, a step's
      at batch 4) equal to the plain version on the host given the card's theta,
      K2 backward (8) bit for bit to it, K4 (4 label maps of 5 channels) equal;
      K6, K7 and K8 on the pon and fishing heads of the eager requests, exactly (K8's
      flow centres within one f32 ulp)."""
    rec = {}
    fishing = family_cfg('literature/fishing_setting.yml')
    g = torch.Generator(device=device).manual_seed(21)
    for shape, reps in (('request', 1), ('step', 3)):
        ids, num_bins, z = family_voxel_ids(fishing, reps, device)
        S, N, h, w, D = ids.shape
        valid = int((ids < num_bins).sum())
        depth32 = torch.softmax(torch.randn(ids.shape, generator=g, device=device), -1)
        feat32 = torch.randn((S, N, h, w, C), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            es = 4 if dtype == torch.float32 else 2
            depth, feat = depth32.to(dtype), feat32.to(dtype)
            at = f'fishing D = {D} {shape}'
            key = f'{at} {str(dtype)[6:]}'
            if shape == 'request':
                got = bev_pool(depth, feat, ids, num_bins, z)
                err = check_close(f'bev_pool {at}', got, bev_pool_plain(depth, feat, ids,
                                                                        num_bins, z), dtype)
                n_host = bits_differ(got.cpu(), bev_pool_plain(depth.cpu(), feat.cpu(),
                                                               ids.cpu(), num_bins, z))
                if n_host:
                    raise AssertionError(f'bev_pool {key}: {n_host} values differ from the '
                                         'plain version on the host')
                flat = (ids.view(S, -1).long() + torch.arange(S, device=device)[:, None]
                        * (num_bins + 1)).view(-1)

                def library(depth=depth, feat=feat, flat=flat):
                    vol = depth[..., :, None] * feat[..., None, :]
                    return torch.zeros((S * (num_bins + 1), C), dtype=dtype,
                                       device=device).index_add_(0, flat, vol.view(-1, C))

                r = timed(lambda: bev_pool(depth, feat, ids, num_bins, z),
                          ['::splat_'], BEV_POOL_KERNELS,
                          lambda: bev_pool_plain(depth, feat, ids, num_bins, z), library,
                          depth.numel() * es + feat.numel() * es + ids.numel() * 4
                          + S * (num_bins // z) * C * es, 2.0 * valid * C, err, plain_reps=5)
                rec[('bev_pool', key)] = r
            else:
                grad = torch.randn((S, num_bins // z, C), generator=g, device=device).to(dtype)
                got = bev_pool_backward(depth, feat, ids, grad, num_bins, z)
                want = bev_pool_backward_plain(depth, feat, ids, grad, num_bins, z)
                err = max(check_close(f'bev_pool_backward {at} d_depth', got[0], want[0], dtype),
                          check_close(f'bev_pool_backward {at} d_feat', got[1], want[1], dtype))
                grad_rows = torch.where(ids < num_bins, ids.long() // z + (
                    torch.arange(S, device=device) * (num_bins // z)).view(S, 1, 1, 1, 1),
                    S * (num_bins // z)).view(-1)

                def library(depth=depth, feat=feat, grad=grad, grad_rows=grad_rows):
                    r_ = torch.cat([grad.view(-1, C), grad.new_zeros((1, C))]).index_select(
                        0, grad_rows).view(S, N, h, w, D, C)
                    return (torch.einsum('snhwc,snhwdc->snhwd', feat, r_),
                            torch.einsum('snhwd,snhwdc->snhwc', depth, r_))

                rec[('bev_pool_backward', key)] = timed(
                    lambda: bev_pool_backward(depth, feat, ids, grad, num_bins, z),
                    ['::splat_backward_kernel'], 1,
                    lambda: bev_pool_backward_plain(depth, feat, ids, grad, num_bins, z),
                    library, 2 * (depth.numel() + feat.numel()) * es + ids.numel() * 4
                    + grad.numel() * es, 4.0 * valid * C, err, plain_reps=5)
            # K5 at D = 28 (k = 8): the per-weight loads of rows whose bytes are not a
            # multiple of 16 in bf16; planted ties
            n_pix = ids.numel() // D
            tdepth = planted_topk_depth(n_pix, D, dtype, device, seed=D + reps).view(ids.shape)
            got = topk_select(tdepth, ids, k)
            want = topk_select_plain(tdepth, ids, k)
            torch.cuda.synchronize()
            for part, a, b in zip(('top_w', 'ids_k', 'idx'), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f'topk_select {key} {part}: kernel != plain at '
                                         f'{int((a != b).sum())} values')

            def topk_library(tdepth=tdepth):
                top = torch.topk(tdepth, k, dim=-1)
                return top.values, ids.gather(-1, top.indices)

            rec[('topk_select', key)] = timed(
                lambda: topk_select(tdepth, ids, k), ['topk_select_kernel'], 1,
                lambda: topk_select_plain(tdepth, ids, k), topk_library,
                n_pix * (D * (es + 4) + k * (es + 4 + 1)), float(n_pix * D * 8 * es), 0.0)
            if shape == 'step':
                idx = got[2]
                gk = planted_topk_depth(n_pix, k, dtype, device, seed=D + 1).view(idx.shape)
                got_b = topk_select_backward(gk, idx, D)
                if bits_differ(got_b, topk_select_backward_plain(gk, idx, D)):
                    raise AssertionError(f'topk_select_backward {key}: kernel != plain')

                def scatter_library(gk=gk, idx=idx):
                    return torch.zeros(idx.shape[:-1] + (D,), dtype=gk.dtype,
                                       device=device).scatter_(-1, idx.long(), gk)

                rec[('topk_select_backward', key)] = timed(
                    lambda: topk_select_backward(gk, idx, D), ['topk_select_backward_kernel'], 1,
                    lambda: topk_select_backward_plain(gk, idx, D), scatter_library,
                    n_pix * (k * (es + 1) + D * es), 0.0, 0.0)
    log('  families: K1 forward and backward, K5 and its backward at fishing\'s D = 28 '
        'equal to their plain versions (K1 within tolerance, its forward bit for bit on '
        'the host)')

    # K2 and K4 on pon's 400 x 200 maps of extent (50, 25)
    pon = FieryConfig.from_cfg(family_cfg('literature/pon_setting.yml'))
    (H, W), extent = pon.bev_size, pon.spatial_extent
    for shape, B in (('request', 2), ('step', 8)):
        x32 = torch.randn((B, H, W, C), generator=g, device=device)
        pose = torch.zeros((B, 6), device=device)
        pose[:, 0] = torch.rand(B, generator=g, device=device) * 4.0 - 2.0
        pose[:, 1] = torch.rand(B, generator=g, device=device) * 2.0 - 1.0
        pose[:, 5] = torch.rand(B, generator=g, device=device) * 0.2 - 0.1
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            at = f'pon {H} x {W} {shape}'
            key = f'{at} {str(dtype)[6:]}'
            theta = card_theta(pose, extent, dtype).cpu()
            got = bev_warp(x, pose, extent)
            err = check_close(f'bev_warp {at}', got, bev_warp_plain(x, pose, extent), dtype)
            host = int((got.cpu() != bev_warp_plain(x.cpu(), pose.cpu(), extent,
                                                    theta=theta)).sum())
            if host:
                raise AssertionError(f'bev_warp {key}: {host} values differ from the host')

            def warp_library(x=x, dtype=dtype):
                grid = _affine_grid(_warp_theta(pose, extent, dtype), H, W).to(dtype)
                return F.grid_sample(x.permute(0, 3, 1, 2), grid, mode='bilinear',
                                     padding_mode='zeros', align_corners=False)

            nbytes = 2 * x.numel() * x.element_size() + pose.numel() * 4
            rec[('bev_warp', key)] = timed(
                lambda: bev_warp(x, pose, extent), ['::bev_warp_tile_kernel'], 1,
                lambda: bev_warp_plain(x, pose, extent), warp_library, nbytes,
                7.0 * x.numel() + 30.0 * B * H * W, err)
            if shape == 'step':
                got = bev_warp_backward(x, pose, extent)
                n_host = bits_differ(got.cpu(), bev_warp_backward_plain(x.cpu(), pose.cpu(),
                                                                        extent, theta=theta))
                if n_host or bits_differ(got, bev_warp_backward(x, pose, extent)):
                    raise AssertionError(f'bev_warp_backward {key}: {n_host} values differ '
                                         'from the host, or two calls differ')
                grid = _affine_grid(_warp_theta(pose, extent, dtype), H, W).to(dtype)
                gc, xc = x.permute(0, 3, 1, 2), torch.zeros_like(x).permute(0, 3, 1, 2)

                def warp_b_library(gc=gc, xc=xc, grid=grid):
                    return torch.ops.aten.grid_sampler_2d_backward(gc, xc, grid, 0, 0, False,
                                                                   [True, False])

                rec[('bev_warp_backward', key)] = timed(
                    lambda: bev_warp_backward(x, pose, extent), ['::warp_gather_kernel'], 1,
                    lambda: bev_warp_backward_plain(x, pose, extent), warp_b_library, nbytes,
                    8.0 * x.numel() + 30.0 * B * H * W, 0.0)
    labels = torch.randn((4, H, W, 5), generator=g, device=device)
    labels[..., :2] = torch.randint(0, 3, (4, H, W, 2), generator=g, device=device).float()
    lpose = torch.zeros((4, 6), device=device)
    lpose[:, 0] = torch.rand(4, generator=g, device=device) * 6.0 - 3.0
    lpose[:, 5] = torch.rand(4, generator=g, device=device) * 0.2 - 0.1
    if not torch.equal(bev_warp_nearest(labels, lpose, extent),
                       bev_warp_nearest_plain(labels, lpose, extent)):
        raise AssertionError('bev_warp_nearest pon: kernel != plain')

    def nearest_library():
        grid = _affine_grid(_warp_theta(lpose, extent, torch.float32), H, W)
        return F.grid_sample(labels.permute(0, 3, 1, 2), grid, mode='nearest',
                             padding_mode='zeros', align_corners=False)

    rec[('bev_warp_nearest', f'pon {H} x {W} labels')] = timed(
        lambda: bev_warp_nearest(labels, lpose, extent), ['::nearest_warp_tile_kernel'], 1,
        lambda: bev_warp_nearest_plain(labels, lpose, extent), nearest_library,
        2 * labels.numel() * 4 + lpose.numel() * 4, 30.0 * 4 * H * W, 0.0)
    log(f'  families: K2 forward and backward and K4 at pon\'s {H} x {W}, extent {extent}, '
        'equal to their plain versions on the host')

    # K10 on the widths of the encoder at downsample 16 (1,632 and 2,688 channels,
    # two and three channel slices a call) and on 1,025 (a slice of 505 channels
    # that is no multiple of 8), at the served images' stride-32 map: forward and
    # backward, eval and training, against the plain version (y bit for bit)
    for C, post in ((1632, 'swish'), (2688, 'swish'), (1025, 'add_relu')):
        for dtype in (torch.float32, torch.bfloat16):
            for training in (False, True):
                bn_case((18, C, 7, 15), post, dtype, training, device, seed=C)
    gen = torch.Generator(device=device).manual_seed(5)
    xw = rows((18, 2688, 7, 15), torch.bfloat16, gen, device)
    pw = [torch.rand(2688, generator=gen, device=device) + 0.5 for _ in range(4)]
    rec[('batch_norm', 'downsample 16 2688 channels eval bfloat16')] = timed(
        lambda: batch_norm_forward(xw, *pw, False, 0.1, BN_EPS, 'swish'), ['::apply_kernel<'],
        len(channel_slices(2688)),
        lambda: batch_norm_forward_plain(xw, *pw, False, 0.1, BN_EPS, 'swish'),
        lambda: F.silu(F.batch_norm(xw, pw[2], pw[3], pw[0], pw[1], False, 0.1, BN_EPS)),
        2 * xw.numel() * 2, 10.0 * xw.numel(), 0.0)
    log('  families: K10 at 1,632, 2,688 and 1,025 channels (channel slices) equal to its '
        'plain version, forward and backward, eval and training, f32 and bf16')

    # K6, K7 and K8 on the served heads of pon (1 frame of 400 x 200, no flow) and
    # fishing (5 frames of 320 x 192)
    for name, out in heads.items():
        _, T, h, w, n_cls = out['segmentation'].shape
        center = out['instance_center'].reshape(T, h, w).contiguous()
        offset = out['instance_offset'].reshape(T, h, w, 2).contiguous()
        seg = out['segmentation'].reshape(T, h, w, n_cls).contiguous()
        ck, vk = find_instance_centers(center)
        cp, vp = find_instance_centers_plain(center)
        ik, ip = instance_ids(cp, vp, offset, seg), instance_ids_plain(cp, vp, offset, seg)
        torch.cuda.synchronize()
        if not (torch.equal(ck, cp) and torch.equal(vk, vp) and torch.equal(ik, ip)):
            raise AssertionError(f'instance_centers or group_pixels {name} {h} x {w}: '
                                 'kernel != plain')
        flow = out.get('instance_flow')
        flow = None if flow is None else flow.reshape(T, h, w, 2).contiguous()
        if flow is None:
            cg, vg = segment_centroids(ip, 101, None)
            cgp, vgp = segment_centroids_plain(ip.cpu(), 101, None)
            ok = not bits_differ(cg.cpu(), cgp) and torch.equal(vg.cpu(), vgp)
        else:
            got, want = segment_centroids_clip(ip, 101, flow), segment_centroids_clip_plain(
                ip.cpu(), 101, flow.cpu())
            ok = (not bits_differ(got[0].cpu(), want[0]) and torch.equal(got[2].cpu(), want[2])
                  and not bool(((got[1].cpu() - want[1]).abs() > ulp32(want[1])).any()))
        if not ok:
            raise AssertionError(f'segment_centroids {name} {h} x {w}: kernel != plain')
        key = f'{name} {T} x {h} x {w}'
        rec[('instance_centers', key)] = timed(
            lambda: find_instance_centers(center), ['::centers_cluster_kernel'], 1,
            lambda: find_instance_centers_plain(center), None,
            center.numel() * 4 + T * 100 * 9, 10.0 * center.numel(), 0.0)
        rec[('group_pixels', key)] = timed(
            lambda: instance_ids(cp, vp, offset, seg), ['::group_cluster_kernel'], 1,
            lambda: instance_ids_plain(cp, vp, offset, seg), None,
            offset.numel() * 4 + seg.numel() * 4 + cp.numel() * 4 + vp.numel() + T * h * w * 4,
            5.0 * float(((seg.argmax(-1) == 1).reshape(T, -1).sum(1) * vp.sum(1)).sum()), 0.0)
        log(f'  families: K6, K7 and K8 on the {name} heads ({T} x {h} x {w}) equal to their '
            f'plain versions; valid centres per frame {vp.sum(1).tolist()}')
    for (kernel, key), r in rec.items():
        log(f'  family kernel {kernel} {key}: ' + json.dumps(
            {k: v for k, v in r.items() if k not in ('bytes', 'flops')}))
    log(f'  family kernel timings: {smi_line()}')
    return rec


# ---- data-parallel training (parallel/mesh.py): K10's synchronised statistics ----

DP_SEED = 0


def dp_cfg(batch, opts=()):
    return get_cfg(argparse.Namespace(config_file=BASELINE, opts=[
        'DATASET.NAME', 'synthetic', 'BATCHSIZE', str(batch), *opts]))


def dp_trainer(cfg):
    """A full-width trainer with seeded weights and BatchNorm calibrated as
    phase_train's (the same on every rank and in every reference)."""
    trainer = Trainer(cfg)
    init_params(trainer.model, seed=DP_SEED)
    calibrate_batchnorm(trainer.model, [make_request(cfg, seed=s) for s in (6, 7)])
    return trainer


def dp_batch(cfg, n, seed=0):
    """n synthetic clips, numpy: the global batch of a data-parallel step."""
    return SyntheticFutureDataset(cfg, n_samples=n, seed=seed).get_batch(range(n))


def dp_step(trainer, batch, rank=0, world=1, step=0, camera=0, cameras=1):
    """One step of ``trainer`` from the step generator of (DP_SEED, step) on data
    shard ``rank`` of ``world`` and camera rank ``camera`` of ``cameras``: its
    losses, gradients, and new weights, running statistics and Adam moments, each
    by name (tensors on the card)."""
    losses, total = trainer.compute_gradients(
        batch, step_generator(DP_SEED, step, trainer.device, rank, world, camera, cameras))
    names = [n for n, _ in trainer.model.named_parameters()] + \
        ['uncertainty.' + k for k in trainer.uncertainty]
    grads = {n: p.grad.detach().clone() for n, p in zip(names, trainer.params)}
    trainer.apply_gradients()
    state = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    state.update({'uncertainty.' + k: p.detach().clone() for k, p in trainer.uncertainty.items()})
    moments = {n: trainer.optimizer.state[p]['exp_avg'].clone()
               for n, p in zip(names, trainer.params)}
    return {'losses': {**losses, 'total': total}, 'grads': grads, 'state': state,
            'exp_avg': moments}


# the two gloo ranks' comparison runs in f32 with TF32 off, the CPU test's arithmetic:
# under PRECISION 16 a batch of 3 and one of 6 take other cuDNN algorithms, whose bf16
# roundings move the losses by ~2e-3 (PERF.md, PR 19)
DP_F32 = ('PRECISION', '32')


@contextlib.contextmanager
def computed_in_groups(split, modules=None):
    """Every convolution of the port's layers (of the modules whose ids ``modules``
    holds, when given), and the squeeze-excitation blocks' spatial means, computed
    on groups of their input's rows (dim 0) apart and put back in place: the shapes
    that several ranks run, in one process. ``split(x)`` gives None (x computed
    whole) or (the groups, a function that puts their results back in place). Both
    pick their kernels (and so the order of their f32 sums) by the whole tensor's
    size; a batch of 6 moves the encoder's first means by ~1e-9, which the random
    full-width f32 step amplifies to 7.8% of the future prediction's gradients
    (PERF.md, PR 19). In groups, what is left to compare is the parallel step
    itself."""
    conv, tconv, mean = _InputDtype._conv_forward, ConvTranspose2d.forward, torch.Tensor.mean

    def in_groups(fn, x):
        how = split(x)
        if how is None:
            return None
        parts, join = how
        return join([fn(h) for h in parts])

    def conv_groups(self, x, weight, bias):
        if modules is None or id(self) in modules:
            out = in_groups(lambda h: conv(self, h, weight, bias), x)
            if out is not None:
                return self._out_layout(out)
        return conv(self, x, weight, bias)

    def tconv_groups(self, x):
        if modules is None or id(self) in modules:
            out = in_groups(lambda h: tconv(self, h), x)
            if out is not None:
                return self._out_layout(out)
        return tconv(self, x)

    def mean_groups(self, *args, **kwargs):
        if kwargs.get('dim', args[0] if args else None) == (-2, -1) and self.dim() == 4:
            out = in_groups(lambda h: mean(h, *args, **kwargs), self)
            if out is not None:
                return out
        return mean(self, *args, **kwargs)

    _InputDtype._conv_forward, ConvTranspose2d.forward = conv_groups, tconv_groups
    torch.Tensor.mean = mean_groups
    try:
        yield
    finally:
        _InputDtype._conv_forward, ConvTranspose2d.forward = conv, tconv
        torch.Tensor.mean = mean


def halves(x):
    """``computed_in_groups``'s split of the two ranks' samples: the two halves of
    the batch (dim 0), when it has an even number of rows."""
    return None if x.shape[0] % 2 else (x.chunk(2), torch.cat)


def f32_only():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def join_ranks(nccl):
    """A rank process of the phases' groups joins them: a gloo rank on card 0 (the
    one-card phases' ranks share it), or with ``nccl`` (phase_multi_card, the
    script's --nccl) an NCCL rank on cuda:LOCAL_RANK."""
    if nccl:
        maybe_initialize_distributed()
    else:
        maybe_initialize_distributed(device='cuda:0', backend='gloo')


def dp_rank_main(out, nccl=False):
    """One rank of phase_data_parallel's two-rank step (``chip_smoke.py --dp-out
    PATH`` with torchrun's variables set; a gloo rank on the one card, an NCCL rank
    under --nccl): the full-width step on its 3 clips of the 6 (f32, TF32 off),
    written to ``out`` (on the host)."""
    f32_only()
    join_ranks(nccl)
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        cfg = dp_cfg(3, DP_F32)
        trainer = make_parallel_trainer(dp_trainer(cfg))
        batch = {k: v[3 * rank:3 * (rank + 1)] for k, v in dp_batch(cfg, 3 * world).items()}
        reset_counters()
        sync_counters(reset=True)
        rec = dp_step(trainer, batch, rank, world)
        rec['launches'] = {**{k: fn.launches for k, fn in COUNTERS.items()}, **sync_counters()}
        rec['plain_calls'] = [fn.plain_calls for fn in PLAIN_COUNTED]
        torch.save(to_host(rec), out)
    finally:
        dist.destroy_process_group()


def to_host(tree):
    """Every tensor of a nested dict moved to the host."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


# the synchronised path's wrappers, by the name of their kernel
SYNC_COUNTERS = {'batch_norm_partials': batch_norm_partials_card,
                 'batch_norm_finalize': batch_norm_finalize_card,
                 'batch_norm_backward_partials': batch_norm_backward_partials_card,
                 'batch_norm_backward_finalize': batch_norm_backward_finalize_card,
                 'batch_norm_backward_apply': batch_norm_backward_apply_card}


def sync_counters(reset=False):
    if reset:
        for fn in SYNC_COUNTERS.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in SYNC_COUNTERS.items()}


def step_differences(got, want):
    """{kind: {name: values whose bits differ}} over the losses, gradients, state
    and Adam moments of two dp_step records, the differing names only."""
    out = {}
    for kind in ('losses', 'grads', 'state', 'exp_avg'):
        diff = {k: bits_differ(got[kind][k].float(), v.float()) for k, v in want[kind].items()
                if v.is_floating_point()}
        out[kind] = {k: n for k, n in diff.items() if n}
    return out


def summary(differ):
    """A step_differences result in counts: {kind: (names, values)}."""
    return {kind: (len(d), sum(d.values())) for kind, d in differ.items()}


def dp_matches_plain(name, got, runs, lr):
    """The one-rank step against runs of the unsynchronised step from the same
    weights, batch and generator. The forward repeats its bits, so the losses and
    the running statistics must equal the unsynchronised step's bit for bit. The
    backward does not repeat its own bits on the card (the bilinear upsamples' and
    the adaptive pooling's backward add with atomics; torch's
    use_deterministic_algorithms lists them; some modules' gradients jump by ~1.5%
    between runs), so the gradients and Adam moments are held to that step's own
    spread: each top-level module's relative L2 distance to the first run within
    twice the largest distance of another run to it, over every module (zero when
    the runs repeat their bits: then bit for bit), and the parameters within 2 lr."""
    differ = step_differences(got, runs[0])
    log(f'{name}: values whose bits differ ((names, values) by kind): the unsynchronised '
        f'step\'s runs against its first '
        + json.dumps([summary(step_differences(r, runs[0])) for r in runs[1:]])
        + f'; the one-rank step against it {json.dumps(summary(differ))}')
    stats = [k for k in differ['state'] if k.endswith(('running_mean', 'running_var'))]
    if differ['losses'] or stats:
        raise AssertionError(f'{name}: losses {differ["losses"]} or running statistics '
                             f'{stats} differ from the unsynchronised step\'s bits')
    for kind in ('grads', 'exp_avg'):
        own = [l2_by_module_and_leaf(r[kind], runs[0][kind])[0] for r in runs[1:]]
        spread = max(max(o.values()) for o in own)
        mine = l2_by_module_and_leaf(got[kind], runs[0][kind])[0]
        log(f'{name}: {kind} relative L2 to the first run, by module: the other runs '
            f'{json.dumps(own)}; the one-rank step {json.dumps(mine)}')
        over = {m: e for m, e in mine.items() if e > 2 * spread}
        if over:
            raise AssertionError(f'{name}: {kind} beyond twice the unsynchronised step\'s '
                                 f'largest run-to-run distance {spread}: {over}')
    moved = max(float((got['state'][k] - runs[0]['state'][k]).abs().max()) for k in got['grads'])
    if moved > 2 * lr + 1e-6:
        raise AssertionError(f'{name}: a parameter differs by {moved} > 2 lr')


def l2_by_module_and_leaf(got, want):
    """({module: relative L2}, {leaf: relative L2, its norm floored at 1e-3 of its
    module's}), as relative_l2_gradients measures them."""
    modules, leaves = {}, {}
    for m in sorted({n.split('.')[0] for n in want}):
        names = [n for n in want if n.split('.')[0] == m]
        a = torch.cat([got[n].double().flatten() for n in names])
        b = torch.cat([want[n].double().flatten() for n in names])
        modules[m] = float((a - b).norm() / b.norm().clamp_min(1e-30))
        for n in names:
            floor = max(float(want[n].double().norm()), 1e-3 * float(b.norm()), 1e-30)
            leaves[n] = float((got[n].double() - want[n].double()).norm()) / floor
    return modules, leaves


def dp_within_cpu_tolerances(name, got, want, lr):
    """A data-parallel step against one process on the whole batch, at
    tests/test_torch_parallel_step.py's tolerances: losses and running statistics
    1e-4 relative (1e-5 absolute), parameters within 2 lr, gradients and Adam
    moments as relative L2 errors, 1e-2 a top-level module and 1e-1 a leaf. Returns
    the worst of each against its bound."""
    worst = {}
    for k, v in want['losses'].items():
        err = abs(float(got['losses'][k]) - float(v))
        worst['loss'] = max(worst.get('loss', 0.0), err / (1e-5 + 1e-4 * abs(float(v))))
    stats = [k for k in want['state'] if k.endswith(('running_mean', 'running_var'))]
    params = [k for k in want['grads']]
    worst['stats'] = max(float(((got['state'][k] - want['state'][k]).abs()
                                / (1e-5 + 1e-4 * want['state'][k].abs())).max()) for k in stats)
    worst['params'] = max(float((got['state'][k] - want['state'][k]).abs().max())
                          for k in params) / (2 * lr + 1e-6)
    for kind in ('grads', 'exp_avg'):
        mod, leaf = l2_by_module_and_leaf(got[kind], want[kind])
        log(f'{name}: {kind} relative L2 by module: {json.dumps(mod)}')
        worst[kind] = max(max(mod.values()) / 1e-2, max(leaf.values()) / 1e-1)
    log(f'{name}: worst against its bound: ' + json.dumps(worst))
    if any(v > 1 for v in worst.values()):
        raise AssertionError(f'{name}: outside the tolerances: {worst}')
    return worst


def sync_kernel_case(shape, es, post, seed, group):
    """K10's synchronised kernels at one training call's shape against their plain
    versions: the rank's f64 sums (1e-12 relative), the statistics and running
    statistics (1e-6), y (check_close) and the backward's dx, dweight, dbias and
    dresidual (check_grads). Returns the largest absolute errors of y and of the
    gradients."""
    dtype = torch.bfloat16 if es == 2 else torch.float32
    gen = torch.Generator(device='cuda').manual_seed(seed)
    C = shape[1]
    x = rows(shape, dtype, gen, 'cuda', mean=0.5)
    res = rows(shape, dtype, gen, 'cuda') if post in ('add', 'add_relu', 'relu_add') else None
    w = torch.rand(C, generator=gen, device='cuda') + 0.5
    b = torch.randn(C, generator=gen, device='cuda')
    rm = torch.randn(C, generator=gen, device='cuda') * 0.1 + 0.5
    rv = torch.rand(C, generator=gen, device='cuda') + 0.5
    tag = f'batch_norm sync {post} {tuple(shape)} {str(dtype)[6:]}'
    sums = batch_norm_partials_card(x, res, post)
    want_sums = batch_norm_partials_plain(x)
    if rel_l2(sums, want_sums) > 1e-12:
        raise AssertionError(f'{tag}: the rank\'s sums differ: {rel_l2(sums, want_sums)}')
    gathered = gather_sums(sums, group)
    rk, rp = (rm.clone(), rv.clone()), (rm.clone(), rv.clone())
    stats = batch_norm_finalize_card(gathered, *rk, 0.1)
    want = batch_norm_finalize_plain(gathered, *rp, 0.1)
    for label, a, c in (('statistics', stats, want), ('running mean', rk[0], rp[0]),
                        ('running var', rk[1], rp[1])):
        check_stats(f'{tag} {label}', a, c)
    y, mean, var, clamp = batch_norm_sync_forward(x, w, b, rm.clone(), rv.clone(), 0.1, BN_EPS,
                                                  post, res, group)
    y_err = check_close(tag, y, batch_norm_plain(x, w, b, mean, var, BN_EPS, post, res), dtype)
    del y
    dy = rows(shape, dtype, gen, 'cuda')
    gk = batch_norm_backward_sync(dy, x, w, b, mean, var, clamp, BN_EPS, post, res, group)
    local, dres = batch_norm_backward_partials_plain(dy, x, w, b, mean, var, BN_EPS, post, res)
    dparams = batch_norm_backward_finalize_plain(local[None], 0, clamp)
    dx = batch_norm_backward_apply_plain(dy, x, w, b, mean, var, dparams, BN_EPS, post, res)
    g_err = check_grads(f'{tag} backward', gk, (dx, dparams[0], dparams[1], dres), dtype)
    return y_err, g_err


def sync_timings(group):
    """The synchronised forward and backward at the largest training call
    (BN_SITES['swish'], bf16, post swish) in a one-rank NCCL group: the device ms of
    their kernels (reduction, finalize, apply), a call's ms with the gather (CUDA
    events), the plain versions' ms, and the library's: torch.nn.SyncBatchNorm's
    function (its batch_norm_stats, all_gather, gather_stats_with_counts and
    batch_norm_elemt) at world size 1, + F.silu, and its autograd backward. The
    bound is the fused path's: bytes, inputs read once and outputs written once."""
    from torch.nn.modules._functions import SyncBatchNorm as SyncBatchNormFn
    shape, dtype, post = BN_SITES['swish'], torch.bfloat16, 'swish'
    gen = torch.Generator(device='cuda').manual_seed(98)
    x = rows(shape, dtype, gen, 'cuda')
    dy = rows(shape, dtype, gen, 'cuda')
    C, n, es = shape[1], x.numel(), x.element_size()
    w, b = torch.ones(C, device='cuda'), torch.zeros(C, device='cuda')
    rm, rv = torch.zeros(C, device='cuda'), torch.ones(C, device='cuda')
    fwd = lambda: batch_norm_sync_forward(x, w, b, rm, rv, 0.1, BN_EPS, post, None,  # noqa
                                          group)
    classify = lambda key: ('finalize' if '::finalize_' in key else k10_pass(key))  # noqa
    by_pass = pass_ms(fwd, classify, {'stats': 1, 'finalize': 1, 'apply': 1})
    _, mean, var, clamp = fwd()

    def fwd_plain():
        local = batch_norm_partials_plain(x)
        m, v, _ = batch_norm_finalize_plain(gather_sums(local, group), rm.clone(), rv.clone(),
                                            0.1)
        return batch_norm_plain(x, w, b, m, v, BN_EPS, post)

    def fwd_library():
        return F.silu(SyncBatchNormFn.apply(x, w, b, rm, rv, BN_EPS, 0.1, group, 1))

    rec = {'batch_norm_sync': dict(
        ms=sum(by_pass.values()), pass_ms=by_pass, call_ms=time_ms(fwd),
        plain_ms=time_ms(fwd_plain, reps=5, warmup=1), library_ms=time_ms(fwd_library),
        bytes=2 * n * es, flops=12.0 * n, shape=shape)}
    bwd = lambda: batch_norm_backward_sync(dy, x, w, b, mean, var, clamp, BN_EPS, post,  # noqa
                                           None, group)
    by_pass = pass_ms(bwd, lambda key: 'finalize' if '::finalize_' in key else k10_pass(key),
                      {'backward_reduce': 1, 'finalize': 1, 'backward_apply': 1})

    def bwd_plain():
        local, _ = batch_norm_backward_partials_plain(dy, x, w, b, mean, var, BN_EPS, post, None)
        dparams = batch_norm_backward_finalize_plain(gather_sums(local, group), 0, clamp)
        return batch_norm_backward_apply_plain(dy, x, w, b, mean, var, dparams, BN_EPS, post,
                                               None)

    xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, b))
    yl = F.silu(SyncBatchNormFn.apply(xl, wl, bl, rm.clone(), rv.clone(), BN_EPS, 0.1, group, 1))
    rec['batch_norm_sync_backward'] = dict(
        ms=sum(by_pass.values()), pass_ms=by_pass, call_ms=time_ms(bwd),
        plain_ms=time_ms(bwd_plain, reps=5, warmup=1),
        library_ms=time_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), dy,
                                                       retain_graph=True)),
        bytes=3 * n * es, flops=26.0 * n, shape=shape)
    for r in rec.values():
        r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['flops'])
    log('  synchronised K10 timings: ' + json.dumps(rec) + f'; {smi_line()}')
    return rec


def phase_data_parallel(device):
    """Data-parallel training on the one card (parallel/mesh.py). In a one-rank
    NCCL group: the full-width baseline.yml step at batch 3 (PRECISION 16) of a
    DistributedDataParallel trainer whose BatchNorms synchronise their statistics,
    against the unsynchronised step from the same weights, batch and generator, run
    three times (``dp_matches_plain``: the losses and running statistics bit for
    bit; the gradients and Adam moments within twice the unsynchronised step's own
    run-to-run spread, as its backward does not repeat its bits on the card), with
    the synchronised kernels' launches counted against the step's BatchNorm calls,
    no plain version run and, in a second step, no host synchronisation
    (set_sync_debug_mode('error')); the two steps timed in turns, with their peak
    memory; K10's synchronised kernels against their plain versions at every
    training call shape of the step, and timed beside torch.nn.SyncBatchNorm. Then
    two gloo ranks on the card (fresh processes, this script with --dp-out), each
    at batch 3, against one process at batch 6 from the same weights and
    generator, in f32 with TF32 off (DP_F32), its convolutions and
    squeeze-excitation means run on the two halves of its batch
    (``computed_in_groups(halves)``), at the CPU test's tolerances, their parameters
    equal bit for bit. Returns (the sync kernels' records, the launches of the main
    path)."""
    torch.cuda.empty_cache()      # the batch-6 f32 step below peaks at ~61 GB
    tmp = tempfile.mkdtemp(prefix='fiery_dp_')
    env = {**os.environ, 'NCCL_SOCKET_IFNAME': os.environ.get('NCCL_SOCKET_IFNAME', 'lo'),
           'GLOO_SOCKET_IFNAME': os.environ.get('GLOO_SOCKET_IFNAME', 'lo')}
    os.environ.update({k: env[k] for k in ('NCCL_SOCKET_IFNAME', 'GLOO_SOCKET_IFNAME')})
    try:
        dist.init_process_group('nccl', init_method=f'file://{tmp}/nccl', rank=0, world_size=1)
        try:
            records, launches = dp_one_rank(device, dist.group.WORLD)
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        dp_two_ranks(tmp, env)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches


def dp_one_rank(device, group):
    name = 'data parallel (one NCCL rank)'
    cfg = dp_cfg(3)
    batches = [dp_batch(cfg, 3, seed=s) for s in range(3)]
    plain = [dp_trainer(cfg) for _ in range(3)]
    runs = [dp_step(t, batches[0]) for t in plain]
    ddp = make_parallel_trainer(dp_trainer(cfg), group)
    reset_counters()
    sync_counters(reset=True)
    got = dp_step(ddp, batches[0])                # the main path
    launches = {**{k: fn.launches for k, fn in COUNTERS.items()}, **sync_counters()}
    plain_calls = [fn.plain_calls for fn in PLAIN_COUNTED]
    dp_matches_plain(name, got, runs, cfg.OPTIMIZER.LR)
    _, bn_calls, bn_launches, census = count_bn_calls(
        ddp.model, lambda: ddp.compute_gradients(batches[1], step_generator(DP_SEED, 1, device)))
    calls = [c for c in census if c[4]]
    slices = sum(len(channel_slices(c[0][1])) for c in calls)
    want = {'batch_norm': slices, 'batch_norm_backward': 0,
            'batch_norm_partials': slices, 'batch_norm_finalize': len(calls),
            'batch_norm_backward_partials': slices,
            'batch_norm_backward_finalize': len(calls), 'batch_norm_backward_apply': slices}
    got_launches = {k: launches[k] for k in want}
    if got_launches != want or any(plain_calls):
        raise AssertionError(f'{name}: launches {got_launches}, expected {want}; plain '
                             f'versions run {plain_calls}')
    missing = [k for k in TRAIN_KERNELS if k not in ('topk_select', 'topk_select_backward',
                                                     'batch_norm_backward')
               and not launches[k]]
    if missing:
        raise AssertionError(f'{name}: kernels not launched on the path: {missing}')
    log(f'{name} (main path) launches: ' + json.dumps({k: v for k, v in launches.items() if v}))

    on_card = ddp.to_device(batches[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        ddp.train_step(on_card, step_generator(DP_SEED, 2, device))
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    log(f'{name}: a step from the batch on the card ran under set_sync_debug_mode("error")')
    del on_card, runs

    times, peaks = {'plain': [], 'ddp': []}, {'plain': 0, 'ddp': 0}
    for i in range(3):
        for key, t in (('plain', plain[0]), ('ddp', ddp), ('ddp', ddp), ('plain', plain[0])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            t.train_step(batches[2], step_generator(DP_SEED, 3 + i, device))
            torch.cuda.synchronize()
            times[key].append(1e3 * (time.perf_counter() - t0))
            peaks[key] = max(peaks[key], torch.cuda.max_memory_allocated())
    log(f'{name}: steps in turns (ms) ' + json.dumps(
        {k: [round(x, 3) for x in v] for k, v in times.items()})
        + ' median ' + json.dumps({k: round(statistics.median(v), 3) for k, v in times.items()})
        + f' peak_mem_bytes {json.dumps(peaks)}; {smi_line()}')
    del plain, ddp, got
    torch.cuda.empty_cache()

    errs = [0.0, 0.0]
    shapes = sorted({(c[0], c[1], c[2]) for c in calls})
    for i, (shape, es, post) in enumerate(shapes):
        y_err, g_err = sync_kernel_case(shape, es, post, 1000 + i, group)
        if es == 2:
            errs = [max(errs[0], y_err), max(errs[1], g_err)]
        torch.cuda.empty_cache()
    log(f'{name}: the synchronised kernels equal to their plain versions within tolerance at '
        f'the step\'s {len(shapes)} training call shapes')
    records = sync_timings(group)
    records['batch_norm_sync']['max_abs_err'] = errs[0]
    records['batch_norm_sync_backward']['max_abs_err'] = errs[1]
    records['batch_norm_sync']['step_ms'] = {k: statistics.median(v) for k, v in times.items()}
    records['batch_norm_sync']['peak_bytes'] = peaks
    return records, launches


def dp_two_ranks(tmp, env, nccl=False):
    """Two gloo ranks on the one card (with ``nccl``, two NCCL ranks on cards 0 and
    1), batch 3 each, against one process at batch 6 (the same weights, clips and
    generator seed), in f32 with TF32 off (DP_F32). Returns the worst distances
    against their bounds."""
    name = f'data parallel (two {"NCCL" if nccl else "gloo"} ranks)'
    cfg = dp_cfg(6, DP_F32)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark)
    f32_only()
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = dp_trainer(cfg)        # calibrated as the ranks' are, whole
        with computed_in_groups(halves):
            want = to_host(dp_step(trainer, dp_batch(cfg, 6)))
        peak = torch.cuda.max_memory_allocated()
        del trainer
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = saved
    torch.cuda.empty_cache()
    outs = [os.path.join(tmp, f'rank{r}.pt') for r in range(2)]
    rendezvous = {'WORLD_SIZE': '2', 'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(free_port())}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), '--dp-out', outs[r],
                               *(['--nccl'] if nccl else [])],
                              env={**env, **rendezvous, 'RANK': str(r), 'LOCAL_RANK': str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f'{name}: rank {r} exited {p.returncode}:\n{logs[r][-4000:]}')
    got = [torch.load(o, weights_only=False) for o in outs]
    for r, g in enumerate(got):
        if any(g['plain_calls']) or not all(g['launches'][k] for k in SYNC_COUNTERS):
            raise AssertionError(f'{name}: rank {r} launches {g["launches"]}, plain versions '
                                 f'run {g["plain_calls"]}')
    differ = step_differences(got[1], got[0])
    if differ['state'] or differ['exp_avg']:
        raise AssertionError(f'{name}: the ranks\' weights or moments differ: {differ}')
    worst = dp_within_cpu_tolerances(f'{name} against one process at batch 6 (in halves)',
                                     got[0], want, cfg.OPTIMIZER.LR)
    log(f'{name}: both ranks hold the same weights, statistics and moments bit for bit; '
        f'within the CPU test\'s tolerances of the batch-6 step ({json.dumps(worst)}); the '
        f'batch-6 step\'s peak {peak} bytes; {smi_line()}')
    return worst


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


# ---- camera-parallel training (parallel/mesh.py): the encoder split over the cameras ----

CAMERAS = 2
# the camera- and BEV-parallel checks, held at the CPU tolerances: (batch, options).
# Both in f32: on random weights a bf16 step's roundings move the gradients by per
# cents under any change of cuDNN algorithm (PERF.md); the bf16 step runs on
# the ranks in cam_torchrun (the training CLI at PRECISION 16)
CAM_CASES = {'dense': (3, DP_F32), 'combo': (1, DP_F32 + COMBO_OPTS)}
# the kernels each rank's step must launch, besides K10's synchronised path: the dense
# step's (K10's backward counts under SYNC_COUNTERS), and the combination's (K5, no K2)
CAM_DENSE_KERNELS = ('bev_pool', 'bev_pool_backward', 'bev_warp', 'bev_warp_backward',
                     'kth_largest', 'bev_warp_nearest', 'batch_norm', 'spatial_gru',
                     'spatial_gru_backward')
CAM_COMBO_KERNELS = ('bev_pool', 'bev_pool_backward', 'topk_select', 'topk_select_backward',
                     'kth_largest', 'bev_warp_nearest', 'batch_norm', 'spatial_gru',
                     'spatial_gru_backward')


def camera_groups(n_images, n_cameras, cameras):
    """``computed_in_groups``'s split of a camera group's ranks' images: a tensor of
    the encoder's ``n_images`` images, (sample, frame, camera) with the camera minor,
    in ``cameras`` groups, each rank's images: strided blocks of n_cameras / cameras
    (``rank_rows``), each made contiguous in the input's layout."""
    def split(x):
        if x.shape[0] != n_images:
            return None
        fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
               and x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        blocks = x.unflatten(0, (-1, cameras, n_cameras // cameras))
        parts = [blocks[:, m].flatten(0, 1).contiguous(memory_format=fmt)
                 for m in range(cameras)]

        def join(outs):
            out = torch.stack([o.unflatten(0, (blocks.shape[0], -1)) for o in outs], dim=1)
            return out.flatten(0, 2).contiguous(memory_format=fmt)
        return parts, join
    return split


def footprint(trainer, fn):
    """fn() under hooks that read the card's allocated bytes before the step, as the
    encoder starts and ends its forward, and as the model ends its forward (the
    activations autograd then holds), and the step's peak: (fn's result, bytes)."""
    marks = {}

    def mark(key):
        def hook(*_):
            marks[key] = torch.cuda.memory_allocated()
        return hook
    handles = [trainer.model.encoder.register_forward_pre_hook(mark('encoder_start')),
               trainer.model.encoder.register_forward_hook(mark('encoder_end')),
               trainer.model.register_forward_hook(mark('forward_end'))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks['start'] = torch.cuda.memory_allocated()
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    marks['peak'] = torch.cuda.max_memory_allocated()
    marks['encoder_bytes'] = marks['encoder_end'] - marks['encoder_start']
    marks['forward_bytes'] = marks['forward_end'] - marks['start']
    marks['encoder_share'] = marks['encoder_bytes'] / marks['forward_bytes']
    return out, marks


def cam_cfg(key):
    batch, opts = CAM_CASES[key]
    return dp_cfg(batch, opts)


def cam_rank_main(out, bev=False, nccl=False):
    """One rank of phase_camera_parallel's camera group of two (``chip_smoke.py
    --cam-out PATH`` with torchrun's variables set; a gloo rank on the one card, an
    NCCL rank under --nccl): each case of CAM_CASES on the whole batch (one data
    shard), encoding its half of the 6 cameras, written to ``out`` (on the host)
    with its launches and memory. With ``bev`` (``--bev-out PATH``,
    phase_bev_parallel) also training its share of the BEV rows."""
    f32_only()
    join_ranks(nccl)
    rank = dist.get_rank()
    try:
        recs = {}
        for key in CAM_CASES:
            t0 = time.perf_counter()
            cfg = cam_cfg(key)
            trainer = make_parallel_trainer(dp_trainer(cfg), cameras=CAMERAS, bev_parallel=bev)
            batch = dp_batch(cfg, cfg.BATCHSIZE)
            reset_counters()
            sync_counters(reset=True)
            rec, rec['memory'] = footprint(trainer, lambda: dp_step(
                trainer, batch, camera=rank, cameras=CAMERAS))
            rec['launches'] = {**{k: fn.launches for k, fn in COUNTERS.items()},
                               **sync_counters()}
            rec['plain_calls'] = [fn.plain_calls for fn in PLAIN_COUNTED]
            rec['seconds'] = time.perf_counter() - t0
            recs[key] = to_host(rec)
            del trainer
            torch.cuda.empty_cache()
        torch.save(recs, out)
    finally:
        dist.destroy_process_group()


def gloo_env():
    """The environment of the phases' rank processes (sockets on the loopback), set
    in this process too."""
    env = {**os.environ, 'GLOO_SOCKET_IFNAME': os.environ.get('GLOO_SOCKET_IFNAME', 'lo'),
           'NCCL_SOCKET_IFNAME': os.environ.get('NCCL_SOCKET_IFNAME', 'lo')}
    os.environ.update({k: env[k] for k in ('NCCL_SOCKET_IFNAME', 'GLOO_SOCKET_IFNAME')})
    return env


@contextlib.contextmanager
def nccl_group_of_one(tmp):
    dist.init_process_group('nccl', init_method=f'file://{tmp}/nccl', rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def phase_camera_parallel(device):
    """Camera-parallel training on the one card (parallel/mesh.py, --camera-parallel):
    the camera gather's NCCL calls (all-gather, all-reduce) in a group of one rank
    (the identity both ways);
    two gloo ranks (this script with --cam-out, fresh processes sharing the card)
    form one camera group, each encoding 3 of the 6 cameras of the full-width
    baseline.yml step at batch 3, the encoder's depth and features gathered over
    the group before the splat, against one process on the same batch, weights and
    generator whose encoder runs each rank's cameras apart
    (``computed_in_groups(camera_groups(...))``): in f32 with TF32 off at the CPU
    test's tolerances, the ranks' weights equal bit for bit (the bf16 step's
    distances are phase_bev_parallel's); the same for one step at batch 1 of
    LIFT.TOPK 8 + LIFT.WARP_FREE (K5
    and the warp-free geometry on gathered cameras); each rank's launches (the
    dense step's training kernels, K10's synchronised path, K5 in the combination;
    no plain version) and peak memory against the one process's, with the bytes
    that the encoder's forward leaves for the backward; then ``fiery_tpu_torch.train
    --camera-parallel 2 --bev-parallel`` under ``torch.distributed.run`` on the card
    (gloo, ``cam_torchrun``) for 2 steps at batch 1. Returns the records."""
    name = 'camera parallel'
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix='fiery_cam_')
    env = gloo_env()
    # the gather's all_gather and all_reduce on NCCL in a group of one rank
    # (two NCCL ranks cannot share the card): the identity, both ways, bit for bit, at
    # the dense step's gathered depth and features (b s, 6, 28, 60, 48 + 64), bf16
    with nccl_group_of_one(tmp):
        x = torch.randn((9, 6, 28, 60, 112), device=device).to(torch.bfloat16)
        g = torch.randn_like(x)
        leaf = x.clone().requires_grad_(True)
        out = gather_cameras(leaf, dist.group.WORLD)
        out.backward(g)
        if not (torch.equal(out, x) and torch.equal(leaf.grad, g)):
            raise AssertionError(f'{name}: the NCCL gather of one rank is not the identity')
        log(f'{name}: NCCL gather and its adjoint in a group of one rank: the identity, '
            f'bit for bit')
    try:
        records = group_ranks_against_one_process(name, tmp, env, bev=False)
        cam_torchrun(tmp, env)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return records


def group_ranks_against_one_process(name, tmp, env, bev, nccl=False):
    """CAM_CASES' steps of one process (in camera groups, and with ``bev`` in row
    shares too), then of two gloo ranks of one camera group
    on the card (this script with --cam-out, or --bev-out with ``bev``; with
    ``nccl``, two NCCL ranks on cards 0 and 1), held against each other; the
    records of the phase."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    f32_only()
    want = {}
    groups = 'camera groups and row shares' if bev else 'camera groups'
    try:
        for key in CAM_CASES:
            t0 = time.perf_counter()
            cfg = cam_cfg(key)
            batch = dp_batch(cfg, cfg.BATCHSIZE)
            trainer = dp_trainer(cfg)
            n_cameras = len(cfg.IMAGE.NAMES)
            n_images = cfg.BATCHSIZE * trainer.model.cfg.receptive_field * n_cameras
            encoder = {id(m) for m in trainer.model.encoder.modules()}
            rows = rows_in_groups(row_plan(trainer.model.cfg.bev_size[0], CAMERAS),
                                  row_sharded(trainer.model)) if bev else \
                contextlib.nullcontext()
            with computed_in_groups(camera_groups(n_images, n_cameras, CAMERAS), encoder), rows:
                rec, rec['memory'] = footprint(trainer, lambda: dp_step(trainer, batch))
            want[key] = to_host(rec)
            del trainer
            torch.cuda.empty_cache()
            log(f'{name}: the one process\'s {key} step(s) in {time.perf_counter() - t0:.1f} s')
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    outs = [os.path.join(tmp, f'rank{r}.pt') for r in range(CAMERAS)]
    rendezvous = {'WORLD_SIZE': str(CAMERAS), 'MASTER_ADDR': '127.0.0.1',
                  'MASTER_PORT': str(free_port())}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               '--bev-out' if bev else '--cam-out', outs[r],
                               *(['--nccl'] if nccl else [])],
                              env={**env, **rendezvous, 'RANK': str(r),
                                   'LOCAL_RANK': str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(CAMERAS)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f'{name}: rank {r} exited {p.returncode}:\n'
                                 f'{logs[r][-4000:]}')
    log(f'{name}: the two ranks ran in {time.perf_counter() - t0:.1f} s')
    got = [torch.load(o, weights_only=False) for o in outs]
    records = {}
    for key in CAM_CASES:
        ranks = [g[key] for g in got]
        edges = row_plan(FieryConfig.from_cfg(cam_cfg(key)).bev_size[0], CAMERAS)
        label = (f'{name} ({key}, two {"NCCL" if nccl else "gloo"} ranks of 3 cameras'
                 + (f' and {edges[1]} or {edges[2] - edges[1]} BEV rows)' if bev else ')'))
        expect = CAM_DENSE_KERNELS if key == 'dense' else CAM_COMBO_KERNELS
        for r, g in enumerate(ranks):
            missing = [k for k in expect + tuple(SYNC_COUNTERS) if not g['launches'][k]]
            if missing or any(g['plain_calls']):
                raise AssertionError(f'{label}: rank {r} launched none of {missing}; plain '
                                     f'versions run {g["plain_calls"]}')
        differ = step_differences(ranks[1], ranks[0])
        if differ['state'] or differ['exp_avg']:
            raise AssertionError(f'{label}: the ranks\' weights or moments differ: {differ}')
        losses = {k: [float(ranks[0]['losses'][k]), float(want[key]['losses'][k])]
                  for k in want[key]['losses']}
        log(f'{label}: losses (ranks, one process in {groups}) {json.dumps(losses)}')
        rec = {'launches': {k: v for k, v in ranks[0]['launches'].items() if v},
               'rank_seconds': [g['seconds'] for g in ranks],
               'memory': {'ranks': [g['memory'] for g in ranks],
                          'one_process': want[key]['memory']},
               'worst': dp_within_cpu_tolerances(
                   f'{label} against one process in {groups}', ranks[0], want[key],
                   cam_cfg(key).OPTIMIZER.LR)}
        log(f'{label}: the ranks\' weights, statistics and moments equal bit for bit; '
            f'launches of rank 0 {json.dumps(rec["launches"])}; memory '
            f'{json.dumps(rec["memory"])}; {smi_line()}')
        records[key] = rec
    return records


# ---- BEV-parallel training (parallel/mesh.py): the BEV rows split over a camera group ----

def row_sharded(model):
    """The ids of the modules that run on a share of the BEV rows."""
    return {id(m) for name in ('temporal_model', 'future_prediction', 'decoder')
            if hasattr(model, name) for m in getattr(model, name).modules()}


@contextlib.contextmanager
def rows_in_groups(edges, modules):
    """The BEV axis's ranks' shapes in one process: every convolution of the modules
    whose ids ``modules`` holds computed on each share of the rows of ``edges``
    (``row_plan``) apart, as its rank computes it (the share's rows with those its
    kernel reads across the share's edges, zeros at the grid's true edges, only the
    columns padded; in its rank's memory layout), the outputs put back in place;
    and the pyramid pooling's spatial mean as the sum of the shares' f32 sums, in
    share order. cuDNN and the means pick their kernels by a tensor's size and
    layout (the ``computed_in_groups`` note)."""
    conv, pool = _InputDtype._conv_forward, temporal_layers._causal_avg_pool3d
    X = edges[-1]

    def shares(rows):
        s = X // rows
        return [(edges[m] // s, edges[m + 1] // s) for m in range(len(edges) - 1)]

    def conv_rows(self, x, weight, bias):
        rows = x.shape[-2]
        if id(self) not in modules or X % rows or X // rows > 8:
            return conv(self, x, weight, bias)
        k, st, p = self.kernel_size[-2], self.stride[-2], self.padding[-2]
        below = max(0, k - st - p) if not (p == 0 and k <= st) else 0
        above = p if not (p == 0 and k <= st) else 0
        outs = []
        for a, b in shares(rows):
            top = x[..., a - above:a, :] if a else x[..., :1, :].new_zeros(
                x.shape[:-2] + (p, x.shape[-1]))
            bottom = x[..., b:b + below, :] if b < rows else x[..., :1, :].new_zeros(
                x.shape[:-2] + (p, x.shape[-1]))
            # a rank's share has its whole tensor's layout; the halo's concatenation
            # takes it (exchange_rows), a share without a halo goes in as it is
            part = (_memory_like(torch.cat([top, x[..., a:b, :], bottom], dim=-2), x)
                    if top.shape[-2] or bottom.shape[-2] else x[..., a:b, :])
            fn = F.conv2d if x.dim() == 4 else F.conv3d
            outs.append(self._out_layout(fn(
                part, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                self.stride, (*self.padding[:-2], 0, self.padding[-1]), self.dilation,
                self.groups)))
        return self._out_layout(torch.cat(outs, dim=-2))

    def pool_rows(x, pool_size):
        H, W = x.shape[-2:]
        if tuple(pool_size[1:]) != (H, W) or X % H:
            return pool(x, pool_size)
        total = None
        for a, b in shares(H):
            part = _memory_like(x[..., a:b, :], x).float().sum(dim=(-2, -1), keepdim=True)
            total = part if total is None else total + part
        h = (total / (H * W)).to(x.dtype)
        return torch.cat([h[:, :, :1], (h[:, :, :-1] + h[:, :, 1:]) / 2.0], dim=2)

    _InputDtype._conv_forward, temporal_layers._causal_avg_pool3d = conv_rows, pool_rows
    try:
        yield
    finally:
        _InputDtype._conv_forward, temporal_layers._causal_avg_pool3d = conv, pool


def phase_bev_parallel(device):
    """BEV-parallel training on the one card (parallel/mesh.py, --bev-parallel): the
    row gather's and the row mean's NCCL calls in a group of one rank (the identity,
    and the mean, both ways); then CAM_CASES' steps on two gloo ranks of one camera
    group that also split the 200 BEV rows (104 + 96) after the splat (this script
    with --bev-out), against one process whose encoder runs each rank's cameras
    apart and whose modules after the splat run each rank's rows apart
    (``rows_in_groups``), at the CPU test's tolerances, their weights equal bit for
    bit; each rank's launches and peak memory, with the bytes that the forward holds
    before and after the encoder. Returns the records."""
    name = 'bev parallel'
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix='fiery_bev_')
    env = gloo_env()
    with nccl_group_of_one(tmp) as group:
        share = RowShare(group, 0, (0, 200))
        x = torch.randn((9, 64, 200, 200), device=device)
        leaf = x.clone().requires_grad_(True)
        out = gather_rows(leaf, -2, share)
        g = torch.randn_like(out)
        out.backward(g)
        mean_leaf = x.clone().requires_grad_(True)
        mean = group_row_mean(mean_leaf, share)
        mean.backward(torch.ones_like(mean))
        if not (torch.equal(out, x) and torch.equal(leaf.grad, g)
                and torch.equal(mean, x.sum(dim=(-2, -1), keepdim=True) / 40000)
                and torch.equal(mean_leaf.grad, torch.full_like(x, 1 / 40000))):
            raise AssertionError(f'{name}: the NCCL row gather or row mean of one rank is not '
                                 f'the identity or the mean')
        log(f'{name}: NCCL row gather and row mean with their adjoints in a group of one '
            f'rank: the identity and the mean, bit for bit')
    try:
        return group_ranks_against_one_process(name, tmp, env, bev=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cam_train_main(argv):
    """One rank of ``cam_torchrun`` (``chip_smoke.py --cam-train ARGS`` under torchrun):
    joins a gloo group on the one card (two NCCL ranks cannot share it), then runs
    the training CLI's ``main(ARGS)``, which takes the group as it finds it."""
    from fiery_tpu_torch.train import main as train_main
    maybe_initialize_distributed(device='cuda:0', backend='gloo')
    try:
        train_main(argv)
    finally:
        dist.destroy_process_group()


def cam_torchrun(tmp, env):
    """``fiery_tpu_torch.train --camera-parallel 2 --bev-parallel`` (the camera gather
    and the BEV rows both) under ``python -m
    torch.distributed.run --nproc_per_node 2`` for 2 steps at full width and batch 1
    on the synthetic clips (a batch of 3 costs the loader's one thread ~3 s), both
    ranks on the one card over gloo (``cam_train_main``): exit 0, one camera group,
    a final checkpoint at step 2."""
    name = 'camera parallel (torchrun, a camera group of two ranks)'
    log_dir = os.path.join(tmp, 'runs')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node', str(CAMERAS),
           '--master_addr', '127.0.0.1', '--master_port', str(free_port()),
           os.path.abspath(__file__), '--cam-train', '--config', BASELINE,
           '--device', 'cuda:0', '--camera-parallel', str(CAMERAS), '--bev-parallel',
           '--steps', '2',
           'DATASET.NAME', 'synthetic', 'BATCHSIZE', '1', 'EPOCHS', '1', 'LOG_DIR', log_dir]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f'{name}: exit {out.returncode}:\n{out.stdout[-3000:]}\n'
                             f'{out.stderr[-3000:]}')
    runs = os.listdir(log_dir)
    state, _ = load_checkpoint(os.path.join(log_dir, runs[0], 'checkpoint_final'))
    if (len(runs) != 1 or state['step'] != 2
            or f'x 1 data shard(s) of {CAMERAS} camera ranks, each training its share of '
               f'the BEV rows' not in out.stdout):
        raise AssertionError(f'{name}: runs {runs}, step {state["step"]}:\n{out.stdout[-2000:]}')
    log(f'{name}: exit 0 in {wall:.1f} s, checkpoint_final at step 2; '
        + ' | '.join(line for line in out.stdout.splitlines() if '"step"' in line))


# ---- the multi-card path on NCCL: phase_multi_card, one call on four cards ----

MULTI_CARDS = 4
# the four-card CLI run: 2 steps of batch 3 a data shard on the synthetic clips
MULTI_OPTS = ('DATASET.NAME', 'synthetic', 'BATCHSIZE', '3', 'DATASET.N_SYNTHETIC_SAMPLES',
              '12', 'EPOCHS', '1', 'LOGGING_INTERVAL', '1')


def tensor_digest(t):
    return hashlib.sha256(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
                          ).hexdigest()


def rank_train_main(argv):
    """One process of phase_multi_card's training runs (``chip_smoke.py --rank-train
    OUT ARGS``, under torchrun or alone): ``fiery_tpu_torch.train``'s main on ARGS,
    which joins the group that torchrun describes (NCCL, rank r on cuda:r) or runs
    alone on the card; writes OUT/rank<r>.pt: its step records, a digest of every
    tensor of its state (model, uncertainty weights, Adam moments) and its peak
    memory."""
    from fiery_tpu_torch.train import main as train_main
    out, argv = argv[0], argv[1:]
    try:
        run = train_main(argv)
        rank = dist.get_rank() if dist.is_initialized() else 0
        state = run.trainer.state()
        digests = {f'model.{k}': tensor_digest(v) for k, v in state['model'].items()}
        digests.update({f'uncertainty.{k}': tensor_digest(v)
                        for k, v in state['uncertainty'].items()})
        digests.update({f'adam.{i}.{k}': tensor_digest(v)
                        for i, st in state['optimizer']['state'].items()
                        for k, v in st.items() if isinstance(v, torch.Tensor)})
        torch.save({'rank': rank, 'steps': run.steps, 'digests': digests,
                    'peak_bytes': torch.cuda.max_memory_allocated(run.trainer.device)},
                   os.path.join(out, f'rank{rank}.pt'))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def step_walls(steps):
    """{'step_ms': [...], 'wall_ms': [...] (with the loader's wait), medians}."""
    ms = [r['step_ms'] for r in steps]
    walls = [r['step_ms'] + r['loader_wait_ms'] for r in steps]
    return {'step_ms': ms, 'wall_ms': walls, 'median_step_ms': statistics.median(ms),
            'median_wall_ms': statistics.median(walls)}


def multi_card_cli(tmp, env):
    """``python -m torch.distributed.run --nproc_per_node 4`` of the training CLI
    (``rank_train_main``, which calls its main) with ``--camera-parallel 2
    --bev-parallel`` on NCCL, a mesh of 2 data shards by 2 camera ranks, 2 steps at
    full width, batch 3 a data shard: exit 0, finite losses logged for both steps,
    the four ranks' weights, statistics and Adam moments equal bit for bit, one
    checkpoint_final at step 2. Then one process of the same CLI without the axes
    on one card, 2 steps of the same batch. Prints both runs' step walls (no
    gate) and each rank's peak memory; returns them."""
    name = 'multi card (torchrun, 2 data shards x 2 camera ranks, NCCL)'
    runs = {}
    for key, launcher, axes in (
            ('four_ranks', [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
                            str(MULTI_CARDS), '--master_addr', '127.0.0.1', '--master_port',
                            str(free_port())],
             ['--camera-parallel', '2', '--bev-parallel']),
            ('one_card', [sys.executable], [])):
        out, log_dir = os.path.join(tmp, key), os.path.join(tmp, key, 'runs')
        os.makedirs(out)
        cmd = [*launcher, os.path.abspath(__file__), '--rank-train', out, '--config', BASELINE,
               *axes, '--steps', '2', *MULTI_OPTS, 'LOG_DIR', log_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f'{name}: {key} exit {proc.returncode}:\n'
                                 f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
        losses = [json.loads(line) for line in proc.stdout.splitlines()
                  if line.startswith('{"epoch"')]
        ranks = [torch.load(os.path.join(out, f), weights_only=False)
                 for f in sorted(os.listdir(out)) if f.endswith('.pt')]
        dirs = os.listdir(log_dir)
        state, _ = load_checkpoint(os.path.join(log_dir, dirs[0], 'checkpoint_final'))
        want_ranks = MULTI_CARDS if axes else 1
        differ = sorted({k for r in ranks[1:] for k, v in r['digests'].items()
                         if v != ranks[0]['digests'][k]})
        if (len(ranks) != want_ranks or differ or len(dirs) != 1 or state['step'] != 2
                or [r['step'] for r in losses] != [1, 2]
                or not all(np.isfinite(r['total_loss']) for r in losses)
                or (axes and 'x 2 data shard(s) of 2 camera ranks, each training its share '
                             'of the BEV rows' not in proc.stdout)):
            raise AssertionError(f'{name}: {key}: {len(ranks)} ranks, tensors that differ '
                                 f'between them {differ[:10]}, runs {dirs}, step '
                                 f'{state["step"]}, losses {losses}\n{proc.stdout[-3000:]}')
        runs[key] = {'walls': [step_walls(r['steps']) for r in ranks],
                     'peak_bytes': [r['peak_bytes'] for r in ranks], 'losses': losses,
                     'run_s': wall}
        log(f'{name}: {key}: exit 0 in {wall:.1f} s, {len(ranks)} rank(s) with the same '
            f'{len(ranks[0]["digests"])} tensors bit for bit, checkpoint_final at step 2; '
            f'losses {json.dumps(losses)}; step walls {json.dumps(runs[key]["walls"])}; '
            f'peaks {runs[key]["peak_bytes"]}')
    log(f'{name}: median step ms, rank 0 of four '
        f'{runs["four_ranks"]["walls"][0]["median_step_ms"]:.3f} against one card\'s plain '
        f'step {runs["one_card"]["walls"][0]["median_step_ms"]:.3f} (host clock, each step '
        f'ended by the logged losses\' read; the first step included); {smi_line()}')
    return runs


def phase_multi_card():
    """The multi-card path on NCCL, on four cards (``--only multi_card``; refused on
    fewer). At world 2, on cards 0 and 1, the one-card phases' held checks with NCCL
    ranks in place of gloo ranks sharing a card: phase_data_parallel's two ranks
    against one process at batch 6 (``dp_two_ranks``), and the camera group of two
    ranks without and with the BEV rows (``group_ranks_against_one_process``),
    each against its one-process reference computed in the ranks' groups and shares,
    at those phases' tolerances, the ranks' weights equal bit for bit. Then the
    training CLI on the four cards (``multi_card_cli``). Returns the records."""
    n = torch.cuda.device_count()
    if n < MULTI_CARDS:
        raise SystemExit(f'chip_smoke: --only multi_card needs {MULTI_CARDS} cards, this '
                         f'machine has {n}')
    tmp = tempfile.mkdtemp(prefix='fiery_multi_')
    env = gloo_env()
    records = {}
    try:
        t0 = time.perf_counter()
        records['data_parallel'] = dp_two_ranks(tmp, env, nccl=True)
        log(f'multi card: data parallel at world 2: ok ({time.perf_counter() - t0:.1f} s)')
        for key, bev in (('camera_parallel', False), ('bev_parallel', True)):
            t0 = time.perf_counter()
            records[key] = group_ranks_against_one_process(
                f'{key.replace("_", " ")} (NCCL)', tmp, env, bev=bev, nccl=True)
            log(f'multi card: {key} at world 2: ok ({time.perf_counter() - t0:.1f} s)')
        t0 = time.perf_counter()
        records['cli'] = multi_card_cli(tmp, env)
        log(f'multi card: the CLI on four cards: ok ({time.perf_counter() - t0:.1f} s)')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--only', choices=['families', 'exported', 'real_set', 'data_parallel',
                                           'camera_parallel', 'bev_parallel', 'parity',
                                           'multi_card', 'accuracy'],
                        help='run only this phase (after the build); prints no result line')
    # one rank of phase_data_parallel's and phase_camera_parallel's gloo ranks (the
    # script starts them itself)
    parser.add_argument('--dp-out', help=argparse.SUPPRESS)
    parser.add_argument('--cam-out', help=argparse.SUPPRESS)
    parser.add_argument('--bev-out', help=argparse.SUPPRESS)
    # those ranks on NCCL, rank r on cuda:r (phase_multi_card)
    parser.add_argument('--nccl', action='store_true', help=argparse.SUPPRESS)
    # phase_parity's fresh process (OUT, then the runner's arguments), and a process
    # of phase_multi_card's training runs (OUT, then the CLI's arguments)
    parser.add_argument('--parity-out', nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    parser.add_argument('--rank-train', nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    # one rank of phase_camera_parallel's torchrun of the training CLI: the rest of
    # the command line is the CLI's
    parser.add_argument('--cam-train', nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        sys.exit(1)
    if args.dp_out is not None:
        dp_rank_main(args.dp_out, args.nccl)
        return
    if args.cam_out is not None:
        cam_rank_main(args.cam_out, nccl=args.nccl)
        return
    if args.bev_out is not None:
        cam_rank_main(args.bev_out, bev=True, nccl=args.nccl)
        return
    if args.parity_out is not None:
        parity_main(args.parity_out[0], args.parity_out[1:])
        return
    if args.rank_train is not None:
        rank_train_main(args.rank_train)
        return
    if args.cam_train is not None:
        cam_train_main(args.cam_train)
        return
    device = torch.device('cuda')
    log(smi_line())
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    _build.build_all()
    log(f'build: {time.perf_counter() - t0:.1f} s for {_build.kernel_names()}')
    if args.only == 'families':
        t0 = time.perf_counter()
        phase_families(device)
        log(f'config families: ok ({time.perf_counter() - t0:.1f} s); {smi_line()}')
        return
    if args.only == 'accuracy':
        t0 = time.perf_counter()
        phase_accuracy(device)
        log(f'accuracy study: ok ({time.perf_counter() - t0:.1f} s); {smi_line()}')
        return
    if args.only == 'parity':
        t0 = time.perf_counter()
        with Trees() as trees:
            phase_parity(trees)
        log(f'parity: ok ({time.perf_counter() - t0:.1f} s); {smi_line()}')
        return
    if args.only == 'multi_card':
        t0 = time.perf_counter()
        records = phase_multi_card()
        log('multi card: ' + json.dumps(records))
        log(f'multi card: ok ({time.perf_counter() - t0:.1f} s); {smi_line()}')
        return
    if args.only == 'real_set':
        t0 = time.perf_counter()
        with Trees() as trees:
            phase_real_set(trees)
        log(f'real set: ok ({time.perf_counter() - t0:.1f} s); {smi_line()}')
        return
    if args.only == 'data_parallel':
        t0 = time.perf_counter()
        records, _ = phase_data_parallel(device)
        log('data parallel: ' + json.dumps(records))
        log(f'data parallel: ok ({time.perf_counter() - t0:.1f} s); {smi_line()}')
        return
    if args.only == 'camera_parallel':
        t0 = time.perf_counter()
        records = phase_camera_parallel(device)
        log('camera parallel: ' + json.dumps(records))
        log(f'camera parallel: ok ({time.perf_counter() - t0:.1f} s); {smi_line()}')
        return
    if args.only == 'bev_parallel':
        t0 = time.perf_counter()
        records = phase_bev_parallel(device)
        log('bev parallel: ' + json.dumps(records))
        log(f'bev parallel: ok ({time.perf_counter() - t0:.1f} s); {smi_line()}')
        return
    if args.only == 'exported':
        t0 = time.perf_counter()
        exported = {name: phase_exported(opts, name) for name, opts in (
            ('exported', ()), ('exported combo', COMBO_OPTS))}
        program_fresh_process([(name, art, answers)
                               for name, (_, art, answers, _) in exported.items()])
        for _, _, _, profile in exported.values():
            profile()
        log('exported programs: ' + json.dumps({k: v[0] for k, v in exported.items()}))
        log(f'exported programs: ok ({time.perf_counter() - t0:.1f} s); {smi_line()}')
        return

    # the serve and the training first, so that their request and step times come
    # before torch.profiler (which times the kernels below) has hooked into the process
    t0 = time.perf_counter()
    launches, outputs, serve_profile = phase_serve()
    log(f'full-width serve: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    combo_launches, _, _ = phase_serve(opts=COMBO_OPTS, name='serve combo')
    log(f'full-width serve of the combination: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    graph_profiles = [phase_served_graph(),
                      phase_served_graph(COMBO_OPTS, 'served graph combo')]
    log(f'full-width served graphs, BatchNorm folded: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    exported = {name: phase_exported(opts, name) for name, opts in (
        ('exported', ()), ('exported combo', COMBO_OPTS))}
    program_fresh_process([(name, art, answers)
                           for name, (_, art, answers, _) in exported.items()])
    graph_profiles += [profile for _, _, _, profile in exported.values()]
    log(f'full-width exported programs, loaded in- and out of process: ok '
        f'({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    train_launches, train, dense_run = phase_train()
    log(f'full-width train: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    combo_train_launches, combo_train, combo_run = phase_train(
        kind='combo', opts=COMBO_TRAIN_OPTS)
    log(f'full-width train of the combination: ok ({time.perf_counter() - t0:.1f} s)')
    # the two configurations' steps in turns on this card, then one profiled step each
    t0 = time.perf_counter()
    turns = {'dense': [], 'combo': []}
    for _ in range(4):
        for key, run in (('dense', dense_run), ('combo', combo_run)):
            turns[key].append(run.step())
    for key, ms in turns.items():
        log(f'train in turns, {key}: step_ms={[round(x, 3) for x in ms]} '
            f'median_step_ms={statistics.median(ms):.3f}')
    dense_run.profile()
    combo_run.profile()
    serve_profile()
    for profile in graph_profiles:
        profile()
    del dense_run, combo_run, graph_profiles
    programs = {name: rec for name, (rec, _, _, _) in exported.items()}
    del exported
    log('exported programs: ' + json.dumps(programs))
    log(f'train steps in turns and profiled: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    topk = phase_topk_kernels(device)
    log(f'top-k select kernels vs plain: ok ({time.perf_counter() - t0:.1f} s)')
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
    t0 = time.perf_counter()
    train_kernels = phase_train_kernels(device)
    log(f'training kernels vs plain: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    phase_tiny_train_card_vs_cpu()
    log(f'tiny train step card vs cpu: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    norm_gru, norm_gru_errs = phase_norm_gru_kernels(device)
    log(f'BatchNorm and GRU kernels vs plain: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    phase_tiny_card_vs_cpu(TINY_COMBO, name='tiny combo', yaw=0.2)
    phase_tiny_train_card_vs_cpu({**TINY_COMBO, 'DATASET': {'PREWARP_LABELS': True}},
                                 name='tiny combo train',
                                 leaves_only=('future_prediction', 'decoder'))
    log(f'tiny combination card vs cpu: ok ({time.perf_counter() - t0:.1f} s)')
    # the real-set trees are written in the background from here, behind the
    # training loop; the parity and real-set phases read them
    with Trees() as trees:
        t0 = time.perf_counter()
        phase_train_loop()
        check_trace_whole('trace after the loop')
        log(f'train loop, resume, combination loop, evaluate and --profile-dir: ok '
            f'({time.perf_counter() - t0:.1f} s)')
        t0 = time.perf_counter()
        phase_parity(trees)
        log(f'parity runner, stages and table: ok ({time.perf_counter() - t0:.1f} s)')
        t0 = time.perf_counter()
        dp_records, dp_launches = phase_data_parallel(device)
        log(f'data parallel: one NCCL rank, two gloo ranks: ok '
            f'({time.perf_counter() - t0:.1f} s)')
        t0 = time.perf_counter()
        cam_records = phase_camera_parallel(device)
        log('camera parallel: ' + json.dumps(cam_records))
        log(f'camera parallel: two gloo ranks of a camera group, dense and combined, torchrun: '
            f'ok ({time.perf_counter() - t0:.1f} s)')
        t0 = time.perf_counter()
        bev_records = phase_bev_parallel(device)
        log('bev parallel: ' + json.dumps(bev_records))
        log(f'bev parallel: two gloo ranks of a camera group splitting the BEV rows, dense and '
            f'combined: ok ({time.perf_counter() - t0:.1f} s)')
        t0 = time.perf_counter()
        phase_real_set(trees)
        log(f'real set: nuScenes and Lyft trees trained, evaluated and drawn: ok '
            f'({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    accuracy_launches = phase_accuracy(device)
    log(f'accuracy study at BASE, dense and topk8_warpfree trained, evaluated and the '
        f'activation study: ok ({time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    families, family_records = phase_families(device)
    log(f'config families served, captured and trained, their kernels vs plain, the export: '
        f'ok ({time.perf_counter() - t0:.1f} s)')

    # bf16 is the dtype of the served and trained paths
    records = {'bev_pool': pool[('serve', torch.bfloat16)],
               'bev_warp': warp[('serve', torch.bfloat16)],
               **decode,
               'bev_pool_backward': train_kernels[('bev_pool_backward', torch.bfloat16)],
               'bev_warp_backward': train_kernels[('bev_warp_backward', torch.bfloat16)],
               'kth_largest': train_kernels['kth_largest'],
               'bev_warp_nearest': train_kernels['bev_warp_nearest'],
               'topk_select': topk[('topk_select', 'serve', torch.bfloat16)],
               'topk_select_backward': topk[('topk_select_backward', 'train', torch.bfloat16)],
               'batch_norm': norm_gru['batch_norm'],
               'batch_norm_backward': norm_gru['batch_norm_backward'],
               'spatial_gru': norm_gru[('spatial_gru', 3)],
               'spatial_gru_backward': norm_gru[('spatial_gru_backward', 3)]}
    for name, err in norm_gru_errs.items():
        records[name]['max_abs_err'] = err
    host = host_us_per_call()
    records['segment_centroids']['host_us'] = host['segment_centroids (K8)']
    records['bev_warp_backward']['host_us'] = host['bev_warp_backward (K2)']
    records['bev_warp']['host_us'] = host['bev_warp (K2)']
    records['instance_centers']['host_us'] = host['find_instance_centers (K6)']
    kernels = []
    for name, source, replaces in [
            ('bev_pool', 'bev_pool.cu', 'fiery_tpu/ops/lift_splat.py:104'),
            ('bev_pool_backward', 'bev_pool.cu', 'fiery_tpu/ops/lift_splat.py:123'),
            ('bev_warp', 'bev_warp.cu', 'fiery_tpu/ops/warp.py:71'),
            ('bev_warp_backward', 'bev_warp.cu', 'fiery_tpu/ops/warp.py:103'),
            ('kth_largest', 'kth_largest.cu', 'fiery_tpu/training/losses.py:15'),
            ('bev_warp_nearest', 'bev_warp.cu', 'fiery_tpu/ops/warp.py:85'),
            ('instance_centers', 'instance_centers.cu', 'fiery_tpu/postprocess/instance.py:73'),
            ('group_pixels', 'group_pixels.cu', 'fiery_tpu/postprocess/instance.py:98'),
            ('segment_centroids', 'segment_centroids.cu',
             'fiery_tpu/postprocess/instance.py:324'),
            ('lap', 'lap.cu', 'fiery_tpu/ops/lap.py:23'),
            ('topk_select', 'topk_select.cu', 'fiery_tpu/ops/lift_splat.py:226'),
            ('topk_select_backward', 'topk_select.cu', 'fiery_tpu/ops/lift_splat.py:226'),
            ('batch_norm', 'batch_norm.cu', 'fiery_tpu/models/layers.py:133'),
            ('batch_norm_backward', 'batch_norm.cu', 'fiery_tpu/models/layers.py:133'),
            ('spatial_gru', 'spatial_gru.cu', 'fiery_tpu/models/temporal_layers.py:372'),
            ('spatial_gru_backward', 'spatial_gru.cu',
             'fiery_tpu/models/temporal_layers.py:372')]:
        r = records[name]
        # launches: the serve path's count for its kernels, the training path's for
        # the training kernels (the splat and the warp run on both); K5's from the
        # combination's serve and training paths
        served, trained = ((combo_launches, combo_train_launches) if name.startswith('topk')
                           else (launches, train_launches))
        entry = {'name': name, 'route': 'cuda', 'source': 'fiery_tpu_torch/csrc/' + source,
                 'replaces': replaces,
                 'launches': (trained if name in TRAIN_ONLY else served)[name],
                 'max_abs_err': r['max_abs_err'], 'ms': r['ms'], 'plain_ms': r['plain_ms'],
                 'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
                 'library_ms': r['library_ms']}
        entry['call_ms'] = r['call_ms']
        # the launches of the accuracy study's phase (training and evaluation)
        entry['accuracy_launches'] = accuracy_launches[name]
        if name in ('bev_pool', 'bev_warp', 'topk_select', 'batch_norm', 'spatial_gru'):
            entry['train_launches'] = trained[name]
            # the launches of the exported program's forward (its operators), dense
            # and combined
            entry['program_launches'] = [programs[key]['program_launches'].get(name, 0)
                                         for key in ('exported', 'exported combo')]
        if name in ('bev_pool', 'batch_norm', 'batch_norm_backward', 'spatial_gru',
                    'spatial_gru_backward'):
            entry['combo_launches'] = combo_launches[name]
            entry['combo_train_launches'] = combo_train_launches[name]
        if name == 'bev_pool':
            # the training shape's call (9 samples), and the D = k call of the
            # combination (K5's output)
            train_k1 = pool[('train', torch.bfloat16)]
            entry.update({f'train_{k}': train_k1[k] for k in (
                'ms', 'pass_ms', 'call_ms', 'plain_ms', 'library_ms', 'bound_ms', 'l2_floor_ms',
                'red_probe_ms', 'red_probe_call_ms')})
            entry['at_k_ms'] = topk[('topk_select', 'serve', torch.bfloat16)]['k1_at_k_ms']
        if name == 'bev_warp':
            # the training shape's call (6 maps), launched once a dense step
            entry.update({f'train_{k}': warp[('train', torch.bfloat16)][k] for k in (
                'ms', 'call_ms', 'plain_ms', 'library_ms', 'bound_ms')})
        if name == 'topk_select':
            # f32 at the serve shape, and the training shape (9 samples) in both
            for label, key in (('f32_', ('serve', torch.float32)),
                               ('train_', ('train', torch.bfloat16)),
                               ('train_f32_', ('train', torch.float32))):
                entry.update({label + k: topk[('topk_select',) + key][k] for k in (
                    'ms', 'call_ms', 'plain_ms', 'library_ms', 'bound_ms')})
            entry['step_ms_combo'] = combo_train['k5_ms']
        if name == 'kth_largest':
            entry.update({k: r[k] for k in r if k.startswith('random_') or k in (
                'blocks_a_row', 'ms_8_blocks_a_row', 'barrier_floor_ms', 'launch_floor_ms')})
            entry.update(step_ms_dense=train['k3_ms'], step_ms_combo=combo_train['k3_ms'])
        if name == 'batch_norm':
            entry.update({f'eval_{k}': norm_gru['batch_norm eval'][k]
                          for k in ('ms', 'call_ms', 'plain_ms', 'library_ms', 'bound_ms')})
        # the kernel at the config families' shapes (phase_families), and its launches
        # a request and a step in each family
        entry['families'] = {key: {k: v for k, v in fr.items() if k not in ('bytes', 'flops')}
                             for (kernel, key), fr in family_records.items() if kernel == name}
        entry['family_launches'] = {
            fam: [f['request_launches'].get(name, 0), f['train_launches'].get(name, 0)]
            for fam, f in families.items()}
        entry.update({k: r[k] for k in ('scipy_ms', 'steps', 'warp_min_ns', 'latency_bound_ms',
                                        'latency_share', 'launch_us', 'row_us', 'step_us',
                                        'dh_sum_ms', 'host_us', 'pass_ms', 'l2_floor_ms',
                                        'red_probe_ms', 'red_probe_call_ms', 'launch_floor_ms',
                                        'ms_501_slots', 'ms_no_peak', 'ms_flat_plateau')
                      if k in r})
        kernels.append(entry)
    # K10's synchronised statistics (the data-parallel path): launches of the one-rank
    # NCCL step, the reduction and finalize launches (forward), and the backward's
    # reduction, finalize and apply launches; the apply pass forward is K10's eval launch
    for name, keys in (('batch_norm_sync', ('batch_norm_partials', 'batch_norm_finalize')),
                       ('batch_norm_sync_backward', ('batch_norm_backward_partials',
                                                     'batch_norm_backward_finalize',
                                                     'batch_norm_backward_apply'))):
        r = dp_records[name]
        kernels.append({'name': name, 'route': 'cuda',
                        'source': 'fiery_tpu_torch/csrc/batch_norm.cu',
                        'replaces': 'fiery_tpu/models/layers.py:157',
                        'launches': sum(dp_launches[k] for k in keys),
                        'max_abs_err': r['max_abs_err'], 'ms': r['ms'], 'plain_ms': r['plain_ms'],
                        'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
                        'library_ms': r['library_ms'], 'call_ms': r['call_ms'],
                        'pass_ms': r['pass_ms'],
                        'launches_by_kernel': {k: dp_launches[k] for k in keys}})
    for label, r in (('', train), (' of the combination', combo_train)):
        log(f'train step{label} (batch 3, full width): median_step_ms={r["step_ms"]:.3f} '
            f'peak_mem_bytes={r["peak_bytes"]} held_by_earlier_phases={r["held_bytes"]} '
            f'device_busy_ms={r["busy_ms"]:.3f} host_prewarp_ms={r["prewarp_ms"]} '
            f'k3_device_ms={r["k3_ms"]:.4f} k5_device_ms={r["k5_ms"]:.4f}')
    log(json.dumps({'kernels': kernels}))
    log(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
