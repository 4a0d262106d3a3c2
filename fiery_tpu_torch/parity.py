"""Accuracy parity against a released reference checkpoint (counterpart of
parity.py at the repository root).

Given a reference Lightning checkpoint (such as the released ``fiery.ckpt``) and a
nuScenes dataroot, one command evaluates the checkpoint through this package and
prints each metric of the reference README's table beside the published number:

    python -m fiery_tpu_torch.parity --torch-checkpoint fiery.ckpt \
        --dataroot /data/nuscenes [--version trainval] [--max-batches N] \
        [--device-matching] [--stages] [--device cpu]

With ``--stages`` it also runs one batch through the reference twin
(``golden.GoldenFiery``, plain torch modules under the reference's names) and
through the port, both loaded from the same checkpoint, and prints each stage's
largest activation difference (BEV features, temporal states, the present
distribution, the rollout, the heads), so that a metric gap can be traced to a
stage. Both run in f32 with TF32 off and zero noise. Without ``--dataroot`` that
batch comes from the synthetic set and the table is skipped. It runs on the CUDA
card unless given ``--device cpu``.
"""

import argparse
import contextlib
import dataclasses

import numpy as np
import torch

from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
from fiery_tpu_torch.data.synthetic import SyntheticFutureDataset
from fiery_tpu_torch.evaluate import eval_checkpoint
from fiery_tpu_torch.golden import GoldenFiery, prefixed_state_dict
from fiery_tpu_torch.models.fiery import FieryConfig
from fiery_tpu_torch.serve import build_fiery
from fiery_tpu_torch.utils.checkpoint import (UNCERTAINTY_KEYS, _torch_blob,
                                              load_torch_full_checkpoint)
from fiery_tpu_torch.utils.device import resolve_device

PUBLISHED = {  # the reference README's table (baseline.yml, nuScenes)
    'iou_100x100': 36.7, 'pq_100x100': 29.9,
}
# the table's rows, in the order the reference prints them
TABLE = ('iou_30x30', 'iou_100x100', 'pq_30x30', 'pq_100x100', 'sq_100x100', 'rq_100x100')
HEADS = ('segmentation', 'instance_center', 'instance_offset', 'instance_flow')
# the reference's preprocessing (ImageNet statistics)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def golden_fiery(model_cfg, device='cpu'):
    """The reference twin of a FieryConfig, on ``device``."""
    c = model_cfg
    return GoldenFiery(
        C=c.encoder_out_channels, D=c.depth_channels, final_dim=c.final_dim,
        downsample=c.encoder_downsample, d_bound=c.d_bound, x_bound=c.x_bound,
        y_bound=c.y_bound, z_bound=c.z_bound, receptive_field=c.receptive_field,
        n_future=c.n_future, latent_dim=c.latent_dim,
        start_out_channels=c.start_out_channels, n_gru_blocks=c.n_gru_blocks,
        n_res_layers=c.n_res_layers,
        future_in_channels=c.start_out_channels + c.n_future * c.probabilistic_future_dim,
        version=c.encoder_name.split('-')[1], device=device)


def load_reference(golden, sd):
    """Load a reference state_dict (Lightning names, ``model.`` prefix) into the
    twin, strictly: every entry of the twin's modules, and no other, except the
    reference's non-module entries (the uncertainty weights and the BEV constants)
    and BatchNorm's ``num_batches_tracked``, which eval does not read and which the
    twin keeps when the checkpoint has none. A missing or unexpected key raises."""
    entries = {}
    for k, v in sd.items():
        name = k[len('model.'):] if k.startswith('model.') else k
        if name not in UNCERTAINTY_KEYS and not name.startswith('bev_'):
            entries[name] = (v.detach().cpu() if isinstance(v, torch.Tensor)
                             else torch.as_tensor(np.asarray(v)))
    for k, v in golden.state_dict().items():
        if k.endswith('num_batches_tracked'):
            entries.setdefault(k, v)
    golden.load_state_dict(entries, strict=True)
    return golden


def write_reference_checkpoint(path, state, cfg):
    """Write ``state`` (``load_checkpoint``'s or ``Trainer.state()``'s: the model's
    state_dict and the uncertainty weights) as a reference Lightning checkpoint:
    the twin's state_dict under ``model.`` (the frustum included, as the reference
    saves it), the uncertainty weights, and the config in ``hyper_parameters``. The
    model's weights pass through the twin's strict load."""
    golden = golden_fiery(FieryConfig.from_cfg(cfg))
    load_reference(golden, {**state['model'], 'frustum': golden.frustum})
    sd = prefixed_state_dict(golden, 'model.')
    sd.update({f'model.{k}': np.asarray(v.detach().cpu(), np.float32)
               for k, v in state['uncertainty'].items()})
    torch.save({'state_dict': {k: torch.as_tensor(v) for k, v in sd.items()},
                'hyper_parameters': cfg.convert_to_dict()}, path)
    return path


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and products without TF32."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def stage_diffs(ckpt_path, state, cfg, batch, device=None):
    """Per-stage activation differences between the reference twin and the port,
    both loaded from the same checkpoint (the twin from ``ckpt_path``, the port
    from ``state``), on one batch (numpy), in f32 with TF32 off and zero noise.
    Prints a line a stage and returns {stage: (max |d|, max |d| / max |twin|)}."""
    device = resolve_device(device)
    model_cfg = dataclasses.replace(FieryConfig.from_cfg(cfg), precision=32)
    rf = model_cfg.receptive_field
    golden = load_reference(golden_fiery(model_cfg), _torch_blob(ckpt_path)[0]).to(device)
    golden.eval()
    f32_cfg = cfg.clone()
    f32_cfg.defrost()
    f32_cfg.PRECISION = 32
    f32_cfg.freeze()
    model = build_fiery(f32_cfg, device, state['model'])

    image = np.asarray(batch['image'], np.float32)
    if np.asarray(batch['image']).dtype != np.float32 or image.max() > 16.0:
        image = (image / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    intr = torch.as_tensor(np.asarray(batch['intrinsics'], np.float32)).to(device)
    extr = torch.as_tensor(np.asarray(batch['extrinsics'], np.float32)).to(device)
    ego = torch.as_tensor(np.asarray(batch['future_egomotion'], np.float32)).to(device)
    image = torch.as_tensor(image).to(device)

    ref, got = {}, {}

    def grab(stages, name):
        def hook(_module, _inputs, out):
            stages[name] = out
        return hook

    handles = [golden.temporal_model.register_forward_hook(grab(ref, 'temporal_states')),
               golden.future_prediction.register_forward_hook(grab(ref, 'future_states'))]
    handles += [getattr(model, name).register_forward_hook(grab(got, stage))
                for name, stage in (('temporal_model', 'temporal_states'),
                                    ('future_prediction', 'future_states'))
                if hasattr(model, name)]
    try:
        with torch.no_grad(), full_f32():
            # the twin, channels-first as the reference runs
            image_nchw = image.permute(0, 1, 2, 5, 3, 4).contiguous()
            b, _, n = image_nchw.shape[:3]
            feats = golden.encoder(image_nchw[:, :rf].reshape(b * rf * n,
                                                              *image_nchw.shape[3:]))
            feats = feats.view(b * rf, n, *feats.shape[1:])
            geometry = golden.get_geometry(intr[:, :rf].reshape(b * rf, n, 3, 3),
                                           extr[:, :rf].reshape(b * rf, n, 4, 4))
            ref['bev_features'] = golden.voxel_pool(feats, geometry)
            ref.update(golden(image_nchw, intr, extr, ego))
            # the port: its own splat's return, then the forward
            got['bev_features'] = model.calculate_birds_eye_view_features(
                image[:, :rf], intr[:, :rf], extr[:, :rf],
                egomotion=ego[:, :rf] if model_cfg.warp_free else None).flatten(0, 1)
            got.update(model(image, intr, extr, ego))
    finally:
        for h in handles:
            h.remove()

    def nhwc(t):
        return np.moveaxis(t.detach().float().cpu().numpy(), -3, -1)

    def host(t):
        return t.detach().float().cpu().numpy()

    pairs = {name: (nhwc(ref[name]), host(got[name]))
             for name in ('bev_features', 'temporal_states', 'future_states') if name in got}
    for name in ('present_mu', 'present_log_sigma'):
        if got.get(name) is not None:
            pairs[name] = (host(ref[name]), host(got[name]))
    for name in HEADS:
        if got.get(name) is not None:
            pairs[name] = (nhwc(ref[name]), host(got[name]))

    print('\nPer-stage activation diffs (torch reference twin vs fiery_tpu_torch, '
          'same checkpoint):')
    print(f'{"stage":>20} {"max|d|":>12} {"rel(max|d|/max|ref|)":>22}')
    report = {}
    for name, (want, have) in pairs.items():
        if want.shape != have.shape:
            print(f'{name:>20}  SHAPE MISMATCH twin {want.shape} vs port {have.shape}')
            report[name] = (np.inf, np.inf)
            continue
        d = float(np.abs(want.astype(np.float64) - have.astype(np.float64)).max())
        rel = d / max(float(np.abs(want).max()), 1e-12)
        print(f'{name:>20} {d:12.3e} {rel:22.3e}')
        report[name] = (d, rel)
    return report


def stage_batch(cfg, dataroot=None, version=None):
    """The stage comparison's batch (numpy): the first val batch of the dataroot at
    batch 1, or without one a synthetic clip."""
    if dataroot is None:
        return SyntheticFutureDataset(cfg, n_samples=1, n_instances=2, seed=0).get_batch([0])
    cfg = cfg.clone()
    cfg.defrost()
    cfg.BATCHSIZE = 1
    cfg.DATASET.DATAROOT = dataroot
    if version:
        cfg.DATASET.VERSION = version
    cfg.freeze()
    _, valloader = prepare_dataloaders(cfg)
    try:
        return {k: np.asarray(v) for k, v in numeric_batch(next(iter(valloader))).items()}
    finally:
        valloader.shutdown()


def print_table(results):
    """The metric table as the reference runner prints it: a row a metric of
    ``TABLE`` that ``results`` holds, in %, beside the published value and the
    difference. Returns the rows {metric: result}."""
    print('\nParity vs reference published metrics (reference README.md:62):')
    print(f'{"metric":>14} {"ours":>8} {"published":>10} {"delta":>8}')
    rows = {}
    for key in TABLE:
        if key not in results:
            continue
        rows[key] = float(results[key])
        ours = 100.0 * rows[key]
        pub = PUBLISHED.get(key)
        pub_s = f'{pub:10.1f}' if pub is not None else f'{"—":>10}'
        delta = f'{ours - pub:+8.2f}' if pub is not None else f'{"":>8}'
        print(f'{key:>14} {ours:8.2f} {pub_s} {delta}')
    return rows


def main(argv=None):
    """Returns {'stages': stage_diffs' report or None, 'metrics': the table's rows
    (print_table) or None}."""
    parser = argparse.ArgumentParser(description='fiery_tpu_torch accuracy parity')
    parser.add_argument('--torch-checkpoint', required=True, type=str,
                        help='reference Lightning checkpoint (e.g. fiery.ckpt)')
    parser.add_argument('--dataroot', default=None, type=str)
    parser.add_argument('--version', default=None, type=str)
    parser.add_argument('--max-batches', default=None, type=int)
    parser.add_argument('--device-matching', action='store_true')
    parser.add_argument('--stages', action='store_true',
                        help='also print per-stage activation diffs vs the torch '
                             'reference twin on one batch')
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    state, cfg = load_torch_full_checkpoint(args.torch_checkpoint)
    out = {'stages': None, 'metrics': None}
    if args.stages:
        out['stages'] = stage_diffs(args.torch_checkpoint, state, cfg,
                                    stage_batch(cfg, args.dataroot, args.version), device)
    if not args.dataroot:
        print('\nNo --dataroot given: skipping the metric table '
              '(nuScenes data required for IoU/VPQ).')
        return out
    results = eval_checkpoint('', args.dataroot, args.version, args.max_batches,
                              device_matching=args.device_matching, state_cfg=(state, cfg),
                              device=device)
    out['metrics'] = print_table(results)
    return out


if __name__ == '__main__':
    main()
