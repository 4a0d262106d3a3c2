"""Accuracy cost of the approximation levers (counterpart of tools/accuracy_ab.py).

The levers ``LIFT.TOPK`` (the sparse top-k splat), ``LIFT.WARP_FREE`` (the ego-motion
folded into the lift geometry) and ``MODEL.TEMPORAL_MODEL.TRIM_TRAIN`` (the causal
trim in training, which changes the BatchNorms' batch statistics) approximate the
dense splat. Three studies on the learnable synthetic set bound what they cost:

``train`` -- every lever mode trained from the same data for ``--steps`` steps and
``--seeds`` seeds, then IoU and VPQ (zero-noise eval, host instance matching) under
the mode's own serving config and under the dense one; and the first seed's
dense-trained state served with each lever (the serving-only case).

``activation`` -- with a random (high depth entropy) and a trained (low entropy)
state, the BEV-feature and segmentation-logit errors of the levers against dense
on the same inputs, with the depth softmax's entropy and top-8 mass.

``curve`` -- dense only, IoU and VPQ every ``--eval-every`` steps.

Everything runs on the CUDA card unless ``--device cpu`` is given, through the
package's kernels: training launches K1-K4, K10 and K11 and their backwards (K5
and its backward under TOPK), every evaluation K6 and K7 (the decode before the
host tracker). The training set lives on the device and each step picks its batch
there; the initial weights are ``serve.init_params`` of the seed.

    python -m fiery_tpu_torch.accuracy_ab train --steps 1000 --seeds 3 --out train.json
    python -m fiery_tpu_torch.accuracy_ab activation --steps 1000 --out activation.json
    python -m fiery_tpu_torch.accuracy_ab curve --steps 4000 --eval-every 250 --out curve.json
    python -m fiery_tpu_torch.accuracy_report train.json activation.json

Each JSON holds the keys of the JAX harness's, plus ``device``: the card's name
and power limit as nvidia-smi gives them, or ``cpu``.
"""

import argparse
import copy
import hashlib
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.ops.warp import cumulative_warp_features
from fiery_tpu_torch.postprocess.instance import predict_instance_segmentation_and_trajectories
from fiery_tpu_torch.serve import init_params
from fiery_tpu_torch.training.metrics import IntersectionOverUnion, PanopticMetric
from fiery_tpu_torch.training.trainer import Trainer, step_generator
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.device import resolve_device

# enough depth bins (24) that keeping k = 8 is a real approximation (1/3 of the
# mass carriers), a ring of 4 cameras, a 64 x 64 BEV, 2 past + 2 future frames
BASE = {
    'TIME_RECEPTIVE_FIELD': 2, 'N_FUTURE_FRAMES': 2, 'PRECISION': 32,
    'BATCHSIZE': 4,
    'IMAGE': {'FINAL_DIM': (32, 48), 'NAMES': ['CAM_A', 'CAM_B', 'CAM_C',
                                               'CAM_D']},
    'LIFT': {'X_BOUND': [-12.0, 12.0, 0.375], 'Y_BOUND': [-12.0, 12.0, 0.375],
             'D_BOUND': [2.0, 26.0, 1.0]},
    'MODEL': {'ENCODER': {'NAME': 'efficientnet-b0', 'OUT_CHANNELS': 24},
              'TEMPORAL_MODEL': {'START_OUT_CHANNELS': 24},
              'DISTRIBUTION': {'LATENT_DIM': 8},
              'FUTURE_PRED': {'N_GRU_BLOCKS': 1, 'N_RES_LAYERS': 1},
              'BN_MOMENTUM': 0.05},
    'OPTIMIZER': {'LR': 1e-3},
}

MODES = {
    'dense': {},
    'topk8': {'LIFT': {'TOPK': 8}},
    'warpfree': {'LIFT': {'WARP_FREE': True}},
    'topk8_warpfree': {'LIFT': {'TOPK': 8, 'WARP_FREE': True}},
    'trimtrain': {'MODEL': {'TEMPORAL_MODEL': {'TRIM_TRAIN': True}}},
    'all': {'LIFT': {'TOPK': 8, 'WARP_FREE': True},
            'MODEL': {'TEMPORAL_MODEL': {'TRIM_TRAIN': True}}},
}

N_TRAIN, N_VAL = 16, 8


def _dense_cache_path(steps):
    """The file of the dense-trained state, fingerprinted by the settings that
    determine it (step count, BASE, training-set size), so that a state of other
    settings is never reused."""
    key = json.dumps({'steps': steps, 'base': BASE, 'n_train': N_TRAIN}, sort_keys=True)
    return os.path.join(tempfile.gettempdir(), 'acc_dense_state_torch_'
                        + hashlib.sha1(key.encode()).hexdigest()[:12] + '.pt')


def _merge(base, extra):
    """``base`` with ``extra``'s keys set, nested dicts merged key by key; neither
    argument is modified."""
    out = copy.deepcopy(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _cfg(mode_overrides):
    return get_cfg(cfg_dict=_merge(BASE, mode_overrides))


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _val_batches(cfg, device):
    """The N_VAL validation clips (seed 1000: scripted scenes disjoint from the
    training set's), one batch each, moved to the device once."""
    ds = SyntheticFutureDataset(cfg, n_samples=N_VAL, n_instances=3, seed=1000)
    return [_to_device(ds.get_batch([i]), device) for i in range(N_VAL)]


def device_label(device):
    """'cpu', or the card's name and power limit as nvidia-smi gives them."""
    device = torch.device(device)
    if device.type != 'cuda':
        return 'cpu'
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(['nvidia-smi', '-i', str(index), '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)


def train_indices(seed, steps, n_train, batch_size):
    """(steps, batch_size) int64: each step's training clips, drawn as the JAX
    harness draws them (a RandomState of 7 + 1000 seed, one choice a step)."""
    order = np.random.RandomState(7 + 1000 * seed)
    return np.stack([order.choice(n_train, size=batch_size, replace=False)
                     for _ in range(steps)]).astype(np.int64)


_TRAINERS = {}
_EVAL_TRAINERS = {}


def _cached(cache, overrides, device):
    """The Trainer of a config (BASE with ``overrides``) and device in ``cache``,
    built on the first call."""
    key = (json.dumps(_merge(BASE, overrides), sort_keys=True), str(device))
    if key not in cache:
        cache[key] = Trainer(_cfg(overrides), device=device)
    return cache[key]


def _trainer(mode, device):
    """One training Trainer a lever mode and device in the process, reset for
    every run."""
    return _cached(_TRAINERS, MODES[mode], device)


def _initialise(trainer, seed):
    """The trainer's weights seeded (``init_params``), running statistics and
    uncertainty weights at their initial values, no Adam state, step 0."""
    init_params(trainer.model, seed)
    with torch.no_grad():
        for p in trainer.uncertainty.values():
            p.zero_()
    trainer.optimizer.state.clear()
    trainer.step = 0


def _snapshot(trainer):
    """A copy of what the evaluation needs of a trainer's state: the weights and
    running statistics, the uncertainty weights and the step."""
    return {'model': {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            'uncertainty': {k: p.detach().clone() for k, p in trainer.uncertainty.items()},
            'step': trainer.step}


def train_mode(mode, steps, log_every=50, seed=0, eval_hook=None, eval_every=0, device=None):
    """Train one lever mode from the seeded weights; returns (state, losses).

    ``seed`` varies the weights, the batch order and the step's random stream (the
    training clips stay the same scripted scenes, so the spread over seeds is the
    run's noise, not the data's). ``eval_hook(state, step)`` runs every
    ``eval_every`` steps (the curve study)."""
    device = resolve_device(device)
    trainer = _trainer(mode, device)
    cfg = trainer.cfg
    _initialise(trainer, seed)
    ds = SyntheticFutureDataset(cfg, n_samples=N_TRAIN, n_instances=3, seed=0)
    # the training set and every step's batch indices on the device once: a step
    # picks its batch there and copies nothing from the host
    full = _to_device(ds.get_batch(list(range(N_TRAIN))), device)
    order = torch.from_numpy(train_indices(seed, steps, N_TRAIN, cfg.BATCHSIZE)).to(device)
    totals = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = {k: v[order[i]] for k, v in full.items()}
        _, total = trainer.train_step(batch, step_generator(1 + seed, i, device))
        totals.append(total)                 # a device scalar: no wait on the card
        if (i + 1) % log_every == 0:
            rate = (i + 1) / (time.perf_counter() - t0)
            print(f'[{mode} s{seed}] step {i + 1}/{steps} loss={float(totals[-1]):.4f} '
                  f'({rate:.2f} steps/s)', flush=True)
        if eval_hook is not None and eval_every and (i + 1) % eval_every == 0:
            eval_hook(_snapshot(trainer), i + 1)
    losses = torch.stack(totals).cpu().tolist() if totals else []
    wall = time.perf_counter() - t0
    evals = ', evaluations included' if eval_hook is not None and eval_every else ''
    print(f'[{mode} s{seed}] {steps} steps in {wall:.3f} s ({steps / max(wall, 1e-9):.3f} '
          f'steps/s{evals}) on {device_label(device)}', flush=True)
    return _snapshot(trainer), losses


def _loaded(state, serve_overrides, device):
    """The evaluation Trainer of a serving config (one a config and device in the
    process, apart from the training ones) with ``state`` loaded."""
    trainer = _cached(_EVAL_TRAINERS, serve_overrides, device)
    trainer.load_state({**state, 'optimizer': None})
    return trainer


def evaluate_state(state, serve_overrides, val_batches):
    """The evaluation under a serving config: the zero-noise eval forward, IoU of
    the vehicle class and VPQ with the host tracker over the whole grid."""
    device = val_batches[0]['image'].device
    trainer = _loaded(state, serve_overrides, device)
    iou = IntersectionOverUnion(2)
    pan = PanopticMetric(2)
    for b in val_batches:
        output, labels, _ = trainer.eval_step(b)
        # the argmax on the device, copied to the host as uint8
        seg_pred = output['segmentation'].argmax(-1).to(torch.uint8).cpu().numpy()
        seg_label = labels['segmentation'].to(torch.uint8).cpu().numpy()
        consistent = predict_instance_segmentation_and_trajectories(output)
        iou.update(seg_pred.astype(np.int32), seg_label.astype(np.int32))
        pan.update(np.asarray(consistent).astype(np.int32),
                   labels['instance'].to(torch.int16).cpu().numpy().astype(np.int32))
    return {'iou': float(iou.compute()[1]),
            'vpq': float(pan.compute()['pq'][1])}


def _write(out_path, payload):
    with open(out_path, 'w') as f:
        json.dump(payload, f, indent=1)


def run_train_study(steps, out_path, seeds=(0,), device=None, modes=tuple(MODES)):
    """Every mode of ``modes`` (all by default; dense among them) trained and
    evaluated for each seed. With three seeds or more the table gives mean and sd,
    so that a lever's difference can be read against the seeds' spread. Returns
    (the results written to the JSON, {mode: [{'seed', 'losses', 'wall_s'} a seed]}:
    each run's training losses and the host seconds of its train_mode call)."""
    if 'dense' not in modes:
        raise ValueError('the study cross-serves the dense-trained state: modes must '
                         'hold dense')
    device = resolve_device(device)
    results, runs = {}, {}
    val = _val_batches(_cfg({}), device)
    dense_state = None

    def report(results):
        _write(out_path, {'steps': steps, 'seeds': list(seeds), 'n_train': N_TRAIN,
                          'n_val': N_VAL, 'base_cfg': BASE, 'results': results,
                          'device': device_label(device)})

    for mode in modes:
        per_seed = []
        for seed in seeds:
            t0 = time.perf_counter()
            state, losses = train_mode(mode, steps, seed=seed, device=device)
            runs.setdefault(mode, []).append(
                {'seed': seed, 'losses': losses, 'wall_s': time.perf_counter() - t0})
            row = {
                'seed': seed,
                'final_loss_mean_last50': float(np.mean(losses[-50:])),
                'eval_matched': evaluate_state(state, MODES[mode], val),
                'eval_dense_parity': evaluate_state(state, MODES['dense'], val),
            }
            per_seed.append(row)
            print(f'== {mode} seed {seed}: {json.dumps(row)}', flush=True)
            if mode == 'dense' and seed == seeds[0]:
                dense_state = state
                # for run_activation_study, so that it need not train the dense
                # state again
                torch.save({k: v if k == 'step' else {n: t.cpu() for n, t in v.items()}
                            for k, v in state.items()}, _dense_cache_path(steps))

        def agg(path_a, path_b):
            vals = [r[path_a][path_b] for r in per_seed]
            return {'mean': round(float(np.mean(vals)), 4),
                    'sd': round(float(np.std(vals)), 4), 'values': vals}

        results[mode] = {
            'per_seed': per_seed,
            'iou_matched': agg('eval_matched', 'iou'),
            'vpq_matched': agg('eval_matched', 'vpq'),
            'iou_dense_parity': agg('eval_dense_parity', 'iou'),
            'vpq_dense_parity': agg('eval_dense_parity', 'vpq'),
        }
        print(f'== {mode} aggregate: iou {results[mode]["iou_matched"]} '
              f'vpq {results[mode]["vpq_matched"]}', flush=True)
        report(results)                  # the modes so far, should the run be cut

    # the serving-only levers on the first seed's dense-trained state
    cross = {}
    for serve in ['topk8', 'warpfree', 'topk8_warpfree']:
        cross[serve] = evaluate_state(dense_state, MODES[serve], val)
        print(f'== dense-trained, served {serve}: {json.dumps(cross[serve])}', flush=True)
    results['dense_trained_cross_serving'] = cross
    report(results)
    print(f'wrote {out_path}')
    return results, runs


def run_curve_study(max_steps, eval_every, out_path, seed=0, device=None):
    """Dense only: IoU and VPQ every ``eval_every`` steps, the first budget at which
    instance grouping emerges (VPQ > 0)."""
    device = resolve_device(device)
    val = _val_batches(_cfg({}), device)
    curve = []

    def hook(state, step_i):
        t0 = time.perf_counter()
        scores = evaluate_state(state, MODES['dense'], val)
        curve.append({'step': step_i, **scores})
        print(f'== curve step {step_i}: {json.dumps(scores)} '
              f'(eval {time.perf_counter() - t0:.1f}s)', flush=True)
        _write(out_path, {'max_steps': max_steps, 'eval_every': eval_every, 'seed': seed,
                          'n_train': N_TRAIN, 'curve': curve, 'device': device_label(device)})

    train_mode('dense', max_steps, seed=seed, eval_hook=hook, eval_every=eval_every,
               device=device)
    print(f'wrote {out_path}')
    return curve


# ---------------------------------------------------------------------------
def _normalise(model, image):
    """Raw uint8 images as the model's forward normalises them, in its dtype."""
    image = (image.float() / 255.0 - model.image_mean) / model.image_std
    return image.to(model.cfg.compute_dtype)


@torch.no_grad()
def _bev_features(state, overrides, batch):
    """(b, s, X, Y, C) present-frame BEV features under a serving config. The dense
    path's post-splat cumulative warp is applied, so that dense and warp-free
    features lie in the same (present) frame: the two branches of Fiery.forward."""
    model = _loaded(state, overrides, batch['image'].device).model.eval()
    c = model.cfg
    rf = c.receptive_field
    ego = batch['future_egomotion'][:, :rf].float()
    x = model.calculate_birds_eye_view_features(
        _normalise(model, batch['image'][:, :rf]), batch['intrinsics'][:, :rf].float(),
        batch['extrinsics'][:, :rf].float(), egomotion=ego if c.warp_free else None)
    if not c.warp_free:
        x = cumulative_warp_features(x, ego, mode='bilinear', spatial_extent=c.spatial_extent)
    return x


def _head_outputs(state, overrides, batch):
    output, _, _ = _loaded(state, overrides, batch['image'].device).eval_step(batch)
    return output


@torch.no_grad()
def _depth_stats(state, batch, k):
    """The depth softmax's entropy and top-k mass a pixel, from the model's own
    encoder on the receptive field's normalised images; f64 on the host."""
    model = _loaded(state, MODES['dense'], batch['image'].device).model.eval()
    img = batch['image'][:, :model.cfg.receptive_field]
    b, s, n = img.shape[:3]
    depth, _ = model.encoder(_normalise(model, img.reshape(b * s * n, *img.shape[3:])))
    depth = depth.double().cpu().numpy()                   # (bsn, h, w, D)
    entropy = -(depth * np.log(np.clip(depth, 1e-12, None))).sum(-1)
    topk_mass = np.sort(depth, axis=-1)[..., -k:].sum(-1)
    return entropy.ravel(), topk_mass.ravel()


def _err_percentiles(ref, approx):
    ref = np.asarray(torch.as_tensor(ref).double().cpu()).ravel()
    approx = np.asarray(torch.as_tensor(approx).double().cpu()).ravel()
    err = np.abs(approx - ref)
    scale = max(np.abs(ref).max(), 1e-12)
    rel = err / scale
    return {f'p{p}': float(np.percentile(rel, p)) for p in (50, 90, 99, 100)}


def run_activation_study(steps, out_path, device=None):
    """BEV-feature and head-output errors of topk8 and warp-free against dense,
    under a random (high-entropy) and a trained (low-entropy) depth head."""
    device = resolve_device(device)
    cfg = _cfg({})
    ds = SyntheticFutureDataset(cfg, n_samples=2, n_instances=3, seed=1000)
    batch = _to_device(ds.get_batch([0, 1]), device)

    trainer = _trainer('dense', device)
    _initialise(trainer, 0)
    random_state = _snapshot(trainer)
    path = _dense_cache_path(steps)
    if os.path.exists(path):
        trained_state = torch.load(path, map_location=device)
        print(f'loaded dense-trained state from the train study ({path})', flush=True)
    else:
        trained_state, _ = train_mode('dense', steps, device=device)

    report = {}
    for tag, state in [('random_init', random_state), ('trained', trained_state)]:
        entropy, mass = _depth_stats(state, batch, k=8)
        row = {
            'depth_entropy_nats': {
                'p50': float(np.percentile(entropy, 50)),
                'p90': float(np.percentile(entropy, 90)),
                'uniform_is': float(np.log(cfg.LIFT.D_BOUND[1] - cfg.LIFT.D_BOUND[0])),
            },
            'top8_captured_mass': {
                'p10': float(np.percentile(mass, 10)),
                'p50': float(np.percentile(mass, 50)),
            },
        }
        bev_dense = _bev_features(state, MODES['dense'], batch)
        for lever in ['topk8', 'warpfree', 'topk8_warpfree']:
            bev = _bev_features(state, MODES[lever], batch)
            row[f'bev_feature_rel_err_{lever}'] = _err_percentiles(bev_dense, bev)
        out_dense = _head_outputs(state, MODES['dense'], batch)
        for lever in ['topk8', 'warpfree']:
            out = _head_outputs(state, MODES[lever], batch)
            row[f'seg_logit_rel_err_{lever}'] = _err_percentiles(
                out_dense['segmentation'], out['segmentation'])
        report[tag] = row
        print(f'== {tag}: {json.dumps(row, indent=1)}', flush=True)

    _write(out_path, {**report, 'device': device_label(device)})
    print(f'wrote {out_path}')
    return report


def main(argv=None):
    global N_TRAIN
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('study', choices=['train', 'activation', 'curve'])
    parser.add_argument('--steps', type=int, default=400)
    parser.add_argument('--seeds', type=int, default=1,
                        help='train study: the number of seeds a mode')
    parser.add_argument('--eval-every', type=int, default=250,
                        help='curve study: the steps between evaluations')
    parser.add_argument('--n-train', type=int, default=None,
                        help='the training set\'s size (default 16)')
    parser.add_argument('--device', default=None,
                        help="the CUDA card by default; 'cpu' runs on the CPU")
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if args.n_train is not None:
        N_TRAIN = args.n_train
    device = resolve_device(args.device)
    out = args.out or os.path.join(tempfile.gettempdir(), f'accuracy_ab_{args.study}.json')
    t0 = time.perf_counter()
    if args.study == 'train':
        run_train_study(args.steps, out, seeds=tuple(range(args.seeds)), device=device)
    elif args.study == 'curve':
        run_curve_study(args.steps, args.eval_every, out, device=device)
    else:
        run_activation_study(args.steps, out, device=device)
    print(f'{args.study} study: {time.perf_counter() - t0:.3f} s on {device_label(device)}',
          flush=True)


if __name__ == '__main__':
    main()
