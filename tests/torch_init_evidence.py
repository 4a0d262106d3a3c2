"""Evidence for the lever accuracy study's open question (PERF.md §7): why do the
port's IoU means lie below the JAX harness's r5 run, topk8's most?

The investigation is open, so this script stays. It reaches into the study
(fiery_tpu_torch/accuracy_ab.py) in one place: ``train`` and ``compare`` replace
``accuracy_ab._initialise`` so that each run starts from the JAX Trainer's own
initial weights instead of ``serve.init_params`` (whose distributions are not the
JAX model's: a depthwise kernel's fan-out, the decoder blocks' zero-initialised
BatchNorm scales). Those weights are ``init_state(jax.random.key(seed), the first
batch)``, as tools/accuracy_ab.py ``train_mode`` draws them, carried into the port by
``state_dict_from_jax``. Everything else is the study's.

    JAX_PLATFORMS=cpu python tests/torch_init_evidence.py write DIR   # CPU, with JAX
    python3 tests/torch_init_evidence.py train DIR OUT.json [--steps 1000]
        [--seeds 0 1 2] [--modes dense topk8] [--device cpu]         # no JAX
    python3 -m fiery_tpu_torch.accuracy_report --against \\
        reports/accuracy_ab_train_r5.json OUT.json
    python3 tests/torch_init_evidence.py compare DIR OUT.json [--mode topk8]
        [--seeds 0 1] [--steps 1000] [--check-every 250] [--free-steps 100]
    python3 tests/torch_init_evidence.py step DIR OUT.json [--modes dense topk8]

``write`` leaves DIR/init_seed<s>.pt (the port's state_dict and the uncertainty
weights, ~17 MB a seed); ``train`` writes the train study's JSON for the modes
given (with dense among them; without it, each run's matched IoU and VPQ alone).
``compare`` asks whether the card trains ``--mode`` as the
CPU's plain path does, from those weights:

- free running: ``--free-steps`` steps of seed 0 on the card and on the CPU, from the
  same weights, batches (the study's draws) and latent noise, drop-connect off and
  TF32 off: each step's total loss on both, and the parameters' relative L2
  difference a module at the end (reported; rounding alone makes two runs drift);
- along the study's own run on the card (its draws, drop-connect on) of each seed,
  every ``--check-every`` steps and at step 0: the state loaded into a card and a CPU
  Trainer, each of which takes one step's gradients on the training set's first
  batch with fixed noise, drop-connect off, TF32 off. The losses within rtol/atol
  1e-3 and the gradients within a relative L2 error of 1e-2 a module and 1e-1 a leaf
  (the future prediction and the decoder per leaf only under a lever), the
  criterion of chip_smoke.py ``phase_tiny_train_card_vs_cpu``; then the run's IoU
  and VPQ (``evaluate_state``).

It writes OUT.json and exits 1 if a check along the runs failed. ``step`` takes
chip_smoke.py ``phase_accuracy``'s one BASE training step, card against CPU, from
the port's seeded weights and from JAX's, for each of ``--modes``, and reports each
module's gradient difference and, under TOPK, where in the top-k splat the two
devices part (``step_check``).
"""

import argparse
import contextlib
import json
import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (module_errors, relative_l2_gradients,  # noqa: E402
                        rounding_sensitivity)
from fiery_tpu_torch import accuracy_ab as ab  # noqa: E402
from fiery_tpu_torch.training.trainer import Trainer  # noqa: E402


def write(out_dir, seeds):
    """The JAX Trainer's initial state of each seed at BASE, in the port's layout."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import jax.numpy as jnp
    from fiery_tpu.training.trainer import Trainer as JaxTrainer
    from fiery_tpu.utils.config import get_cfg as jax_get_cfg
    from fiery_tpu_torch.models.fiery import FieryConfig
    from fiery_tpu_torch.utils.weight_import import state_dict_from_jax

    jcfg = jax_get_cfg(cfg_dict=ab._merge(ab.BASE, {}))
    trainer = JaxTrainer(jcfg)
    full = ab.SyntheticFutureDataset(ab._cfg({}), n_samples=ab.N_TRAIN, n_instances=3,
                                     seed=0).get_batch(list(range(ab.N_TRAIN)))
    first = {k: jnp.asarray(v[:jcfg.BATCHSIZE]) for k, v in full.items()}
    init = jax.jit(trainer.init_state)
    os.makedirs(out_dir, exist_ok=True)
    for seed in seeds:
        state = jax.tree.map(np.asarray, init(jax.random.key(seed), first))
        model = state_dict_from_jax({'params': state.params['model'],
                                     'batch_stats': state.batch_stats},
                                    FieryConfig.from_cfg(ab._cfg({})))
        uncertainty = {k: torch.tensor(np.asarray(v, np.float32))
                       for k, v in state.params['uncertainty'].items()}
        torch.save({'model': model, 'uncertainty': uncertainty},
                   os.path.join(out_dir, f'init_seed{seed}.pt'))
        print(f'wrote {out_dir}/init_seed{seed}.pt', flush=True)


def start_from_jax(in_dir):
    """Replace the study's initialisation by the seed's JAX initial state."""
    def from_jax(trainer, seed):
        state = torch.load(os.path.join(in_dir, f'init_seed{seed}.pt'))
        trainer.model.load_state_dict(state['model'], strict=True)
        with torch.no_grad():
            for k, p in trainer.uncertainty.items():
                p.copy_(state['uncertainty'][k])
        trainer.optimizer.state.clear()
        trainer.step = 0

    ab._initialise = from_jax
    return from_jax


def train(in_dir, out_path, steps, seeds, modes, device):
    """The train study for ``modes``, each run starting from the seed's JAX state.
    Without dense among the modes (nothing to cross-serve), each run's matched
    evaluation alone: {mode: [{'seed', 'final_loss_mean_last50', 'eval_matched'}]}."""
    start_from_jax(in_dir)
    if 'dense' in modes:
        ab.run_train_study(steps, out_path, seeds=seeds, device=device, modes=modes)
        return
    device = ab.resolve_device(device)
    val = ab._val_batches(ab._cfg({}), device)
    report = {'steps': steps, 'device': ab.device_label(device)}
    for mode in modes:
        for seed in seeds:
            state, losses = ab.train_mode(mode, steps, seed=seed, device=device)
            row = {'seed': seed, 'final_loss_mean_last50': float(np.mean(losses[-50:])),
                   'eval_matched': ab.evaluate_state(state, ab.MODES[mode], val)}
            report.setdefault(mode, []).append(row)
            print(f'== {mode} seed {seed}: {json.dumps(row)}', flush=True)
            with open(out_path, 'w') as f:
                json.dump(report, f, indent=1)


def no_drop_connect(trainer):
    for block in trainer.model.encoder.backbone._blocks:
        block.drop_rate = 0.0
    return trainer


@contextlib.contextmanager
def tf32_off():
    """TF32 off for convolutions and matmuls, the settings before restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def free_running(init, mode, seed, n_steps, device):
    """``n_steps`` steps on the card and on the CPU from the same weights, batches
    and noise: each step's total loss, and the parameters' worst relative L2
    difference at the end."""
    cfg = ab._cfg(ab.MODES[mode])
    trainers = {d: no_drop_connect(Trainer(cfg, device=dev))
                for d, dev in (('cpu', 'cpu'), ('card', device))}
    for tr in trainers.values():
        init(tr, seed)
    ds = ab.SyntheticFutureDataset(cfg, n_samples=ab.N_TRAIN, n_instances=3, seed=0)
    order = ab.train_indices(seed, n_steps, ab.N_TRAIN, cfg.BATCHSIZE)
    draws = np.random.RandomState(100 + seed)
    totals = {d: [] for d in trainers}
    with tf32_off():
        for i in range(n_steps):
            batch = ds.get_batch(list(order[i]))
            noise = torch.from_numpy(draws.randn(
                cfg.BATCHSIZE, 1, cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(np.float32))
            for d, tr in trainers.items():
                totals[d].append(float(tr.train_step(batch, noise=noise.to(tr.device))[1]))
    params = {d: {n: p.detach().double().cpu() for n, p in tr.model.named_parameters()}
              for d, tr in trainers.items()}
    (module_err, module), (leaf_err, leaf) = relative_l2_gradients(params['card'], params['cpu'])
    rel = [abs(a - b) / max(abs(b), 1e-6) for a, b in zip(totals['card'], totals['cpu'])]
    first_over = {f'{t:g}': next((i for i, r in enumerate(rel) if r > t), None)
                  for t in (1e-3, 1e-2, 1e-1)}
    out = {'seed': seed, 'steps': n_steps, 'loss_card': totals['card'], 'loss_cpu': totals['cpu'],
           'loss_rel_diff_max': max(rel), 'first_step_rel_diff_over': first_over,
           'mean_last10_card': float(np.mean(totals['card'][-10:])),
           'mean_last10_cpu': float(np.mean(totals['cpu'][-10:])),
           'param_worst_module_rel_l2': [module_err, module],
           'param_worst_leaf_rel_l2': [leaf_err, leaf]}
    print('== free running ' + json.dumps({k: v for k, v in out.items()
                                           if not k.startswith('loss_')}), flush=True)
    return out


def along_the_run(init, mode, seed, steps, check_every, device):
    """The study's run of ``mode`` and ``seed`` on the card, its gradients held
    against the CPU's every ``check_every`` steps; then its IoU and VPQ."""
    cfg = ab._cfg(ab.MODES[mode])
    leaves_only = ('future_prediction', 'decoder') if ab.MODES[mode] else ()
    checkers = {d: no_drop_connect(Trainer(cfg, device=dev))
                for d, dev in (('cpu', 'cpu'), ('card', device))}
    batch = ab.SyntheticFutureDataset(cfg, n_samples=cfg.BATCHSIZE, n_instances=3,
                                      seed=0).get_batch(list(range(cfg.BATCHSIZE)))
    noise = torch.from_numpy(np.random.RandomState(5).randn(
        cfg.BATCHSIZE, 1, cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(np.float32))
    checks = []

    def check(state, step):
        losses, grads = {}, {}
        with tf32_off():
            for d, tr in checkers.items():
                tr.load_state({**state, 'optimizer': None})
                losses[d] = {k: float(v) for k, v in
                             tr.compute_gradients(batch, noise=noise.to(tr.device))[0].items()}
                grads[d] = {n: p.grad.double().cpu() for n, p in tr.model.named_parameters()}
        loss_ok = all(abs(losses['card'][k] - v) <= 1e-3 + 1e-3 * abs(v)
                      for k, v in losses['cpu'].items())
        (module_err, module), (leaf_err, leaf) = relative_l2_gradients(
            grads['card'], grads['cpu'], leaves_only)
        rec = {'step': step, 'losses_card': losses['card'], 'losses_cpu': losses['cpu'],
               'grad_worst_module_rel_l2': [module_err, module],
               'grad_worst_leaf_rel_l2': [leaf_err, leaf],
               'ok': bool(loss_ok and module_err <= 1e-2 and leaf_err <= 1e-1)}
        checks.append(rec)
        print(f'== {mode} s{seed} check at step {step}: ' + json.dumps(
            {k: rec[k] for k in ('grad_worst_module_rel_l2', 'grad_worst_leaf_rel_l2', 'ok')}),
            flush=True)

    trainer = ab._trainer(mode, device)
    init(trainer, seed)
    check(ab._snapshot(trainer), 0)
    state, losses = ab.train_mode(mode, steps, seed=seed, eval_hook=check,
                                  eval_every=check_every, device=device)
    scores = ab.evaluate_state(state, ab.MODES[mode], ab._val_batches(ab._cfg({}), device))
    out = {'seed': seed, 'checks': checks, 'final_loss_mean_last50': float(np.mean(losses[-50:])),
           'eval_matched': scores}
    print(f'== {mode} s{seed} run: ' + json.dumps({k: out[k] for k in
                                                   ('final_loss_mean_last50', 'eval_matched')}),
          flush=True)
    return out


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _captured_step(trainer, batch, noise, forced=None):
    """compute_gradients with the top-k selection's inputs, its chosen bins and the
    gradients of its depth input, of the selected weights and of the splatted
    features captured; ``forced`` (the bins of another run, a call each) replaces
    the selection by a gather of those bins."""
    from fiery_tpu_torch.ops import lift_splat as ls
    rec = {'depth': [], 'ids': [], 'idx': [], 'd_depth': {}, 'd_top_w': {}, 'd_feat': {}}
    select, pool = ls.topk_select, ls.bev_pool

    def keep(name, i):
        def hook(g):
            rec[name][i] = g.detach().cpu()
        return hook

    def captured_select(depth, ids, k):
        i = len(rec['depth'])
        rec['depth'].append(depth.detach().cpu())
        rec['ids'].append(ids.cpu())
        if depth.requires_grad:
            depth.register_hook(keep('d_depth', i))
        if forced is None:
            out = select(depth, ids, k)
        else:
            idx = forced[i].to(depth.device).long()
            out = depth.gather(-1, idx), ids.gather(-1, idx), idx.to(torch.uint8)
        rec['idx'].append(out[2].cpu())
        return out

    def captured_pool(top_w, feat, *args):
        i = len(rec['d_feat'])
        if top_w.requires_grad:
            top_w.register_hook(keep('d_top_w', i))
        if feat.requires_grad:
            feat.register_hook(keep('d_feat', i))
        return pool(top_w, feat, *args)

    # the card's wrappers count their launches on the module's names
    captured_select.launches = captured_pool.launches = 0
    ls.topk_select, ls.bev_pool = captured_select, captured_pool
    try:
        losses = trainer.compute_gradients(batch, noise=noise.to(trainer.device))[0]
    finally:
        ls.topk_select, ls.bev_pool = select, pool
        select.launches += captured_select.launches
        pool.launches += captured_pool.launches
    grads = {n: p.grad.double().cpu() for n, p in trainer.model.named_parameters()}
    return {k: float(v) for k, v in losses.items()}, grads, rec


def step_check(in_dir, mode, init_from, device):
    """One training step at BASE (batch 2, drop-connect off, TF32 off) on the card and
    on the CPU, as chip_smoke.py phase_accuracy's check takes it (``init_from``
    'port': ``init_params`` of seed 3; 'jax': the JAX state of seed 0): each
    module's gradient difference; under TOPK, the bins the two select (and whether
    the plain selection on the card's own depth picks the card's), the smallest
    relative gap between the k-th and (k+1)-th depth weight, and the differences of
    the gradients at the selection's input, its output and the splatted features;
    then the CPU's step again with the card's bins forced, and its module
    differences."""
    from fiery_tpu_torch.ops.lift_splat import topk_select_plain
    from fiery_tpu_torch.serve import init_params
    cfg = ab._cfg({**ab.MODES[mode], 'BATCHSIZE': 2})
    trainers = {d: no_drop_connect(Trainer(cfg, device=dev))
                for d, dev in (('cpu', 'cpu'), ('card', device))}
    if init_from == 'jax':
        init = start_from_jax(in_dir)
        for tr in trainers.values():
            init(tr, 0)
    else:
        init_params(trainers['cpu'].model, seed=3)
        trainers['card'].model.load_state_dict(trainers['cpu'].model.state_dict())
    batch = ab.SyntheticFutureDataset(cfg, n_samples=2, n_instances=2, seed=4).get_batch([0, 1])
    noise = torch.from_numpy(np.random.RandomState(5).randn(
        2, 1, cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(np.float32))
    state = {k: v.clone() for k, v in trainers['cpu'].model.state_dict().items()}
    with tf32_off():
        runs = {d: _captured_step(tr, batch, noise) for d, tr in trainers.items()}
        out = {'mode': mode, 'init': init_from,
               'losses': {d: r[0] for d, r in runs.items()},
               'module_rel_l2': module_errors(runs['card'][1], runs['cpu'][1]),
               'cpu_module_rel_l2_weights_moved': {
                   f'2^{e}': rounding_sensitivity(trainers['cpu'], batch, noise, 2.0 ** e)
                   for e in (-23, -20)}}
        card, cpu = runs['card'][2], runs['cpu'][2]
        if card['idx']:
            k = card['idx'][0].shape[-1]
            sel = []
            for i in range(len(card['idx'])):
                ranked = torch.sort(cpu['depth'][i], dim=-1, descending=True).values
                gap = (ranked[..., k - 1] - ranked[..., k]) / ranked[..., k - 1]
                plain = topk_select_plain(card['depth'][i], card['ids'][i], k)[2]
                sel.append({
                    'pixels': int(card['idx'][i][..., 0].numel()),
                    'pixels_selected_differently': int(
                        (card['idx'][i] != cpu['idx'][i]).any(-1).sum()),
                    'plain_on_card_depth_equals_card': bool(torch.equal(plain, card['idx'][i])),
                    'min_rel_gap_kth': float(gap.min()),
                    'depth_rel_l2': _rel(card['depth'][i], cpu['depth'][i]),
                    'depth_max_abs_diff': float((card['depth'][i] - cpu['depth'][i]).abs().max()),
                    'd_depth_rel_l2': _rel(card['d_depth'][i], cpu['d_depth'][i]),
                    'd_top_w_rel_l2': _rel(card['d_top_w'][i], cpu['d_top_w'][i]),
                    'd_feat_rel_l2': _rel(card['d_feat'][i], cpu['d_feat'][i])})
            out['selection'] = sel
            trainers['cpu'].model.load_state_dict(state)
            _, grads, _ = _captured_step(trainers['cpu'], batch, noise, forced=card['idx'])
            out['module_rel_l2_card_bins_on_cpu'] = module_errors(runs['card'][1], grads)
    print('== step ' + json.dumps(out), flush=True)
    return out


def compare(in_dir, out_path, mode, seeds, steps, check_every, free_steps, device):
    """The card (``device``; the CPU against itself only to rehearse) against the
    CPU for ``mode`` from the JAX initial weights."""
    device = ab.resolve_device(device)
    init = start_from_jax(in_dir)
    report = {'mode': mode, 'device': ab.device_label(device)}
    if free_steps:
        report['free_running'] = free_running(init, mode, seeds[0], free_steps, device)
    report['runs'] = []
    for seed in seeds:
        report['runs'].append(along_the_run(init, mode, seed, steps, check_every, device))
        with open(out_path, 'w') as f:
            json.dump(report, f, indent=1)
    failed = [(r['seed'], c['step']) for r in report['runs'] for c in r['checks'] if not c['ok']]
    print(f'wrote {out_path}; checks failed (seed, step): {failed}', flush=True)
    if failed:
        sys.exit(1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('what', choices=['write', 'train', 'compare', 'step'])
    parser.add_argument('dir')
    parser.add_argument('out', nargs='?')
    parser.add_argument('--steps', type=int, default=1000)
    parser.add_argument('--seeds', type=int, nargs='+', default=None)
    parser.add_argument('--modes', nargs='+', default=['dense', 'topk8'])
    parser.add_argument('--mode', default='topk8', help='compare: the mode')
    parser.add_argument('--check-every', type=int, default=250)
    parser.add_argument('--free-steps', type=int, default=100)
    parser.add_argument('--device', default=None)
    args = parser.parse_args(argv)
    if args.what == 'write':
        write(args.dir, tuple(args.seeds or (0, 1, 2)))
    elif args.what == 'train':
        train(args.dir, args.out, args.steps, tuple(args.seeds or (0, 1, 2)),
              tuple(args.modes), args.device)
    elif args.what == 'compare':
        compare(args.dir, args.out, args.mode, tuple(args.seeds or (0, 1)), args.steps,
                args.check_every, args.free_steps, args.device)
    else:
        device = ab.resolve_device(args.device)
        report = [step_check(args.dir, mode, init_from, device) for mode in args.modes
                  for init_from in ('port', 'jax')]
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)


if __name__ == '__main__':
    main()
