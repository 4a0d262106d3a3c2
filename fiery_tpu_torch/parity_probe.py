"""Why the parity runner's full-width card check draws its weights as it does:
python -m fiery_tpu_torch.parity_probe

On a fake nuScenes tree (1600 x 900, 1 + 1 scenes of 9 samples) it writes three
reference checkpoints of the port's baseline.yml model and prints, for each,
``parity.stage_diffs`` on the first val window (f32, TF32 off) and the twin's own
stage differences when its input moves by 1e-7 relative (seeded noise):
  * 'he_calibrated': ``serve.init_params`` (He normal) with BatchNorm calibrated
    on the tree's 3 train windows (``serve.calibrate_batchnorm``);
  * 'default_calibrated': PyTorch's default initialisation after
    ``torch.manual_seed(0)``, BatchNorm calibrated the same way;
  * 'default_randomised': the same initialisation with BatchNorm statistics drawn
    as the reference-format test checkpoints draw them (``chip_smoke.py``
    ``phase_parity``'s weights).
For each it also prints the pyramid pooling's BatchNorm variances, and, for the
first temporal block, the pooled means of the twin (the reference's
``nn.AvgPool3d``) and of the port (``models/temporal_layers._causal_avg_pool3d``)
against the same means in f64. Needs a CUDA card.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from fiery_tpu_torch import parity
from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
from fiery_tpu_torch.models.fiery import FieryConfig
from fiery_tpu_torch.models.temporal_layers import _causal_avg_pool3d
from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.serve import BASELINE, calibrate_batchnorm, init_params
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.checkpoint import _torch_blob, load_torch_full_checkpoint
from fiery_tpu_torch.utils.config import get_cfg

OPTS = ['DATASET.NAME', 'nuscenes', 'DATASET.VERSION', 'mini', 'N_WORKERS', '0']


def randomise_batchnorm(model, seed):
    """``golden.randomize_bn_stats``'s draws on every BatchNorm of the port's model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
    return model


def twin_run(golden, batch, perturb=0.0):
    """The twin's stages on ``batch`` (inputs times 1 + perturb N(0, 1), seeded),
    and its first pyramid pool's input and output."""
    device = next(golden.parameters()).device
    image = np.asarray(batch['image'], np.float32)
    image = (image / 255.0 - parity.IMAGENET_MEAN) / parity.IMAGENET_STD
    if perturb:
        rng = np.random.RandomState(0)
        image = image * (1 + perturb * rng.randn(*image.shape)).astype(np.float32)
    t = {k: torch.as_tensor(np.asarray(batch[k], np.float32)).to(device)
         for k in ('intrinsics', 'extrinsics', 'future_egomotion')}
    out, pool = {}, {}
    hooks = [golden.temporal_model.register_forward_hook(
                 lambda m, i, o: out.__setitem__('temporal_states', o)),
             golden.future_prediction.register_forward_hook(
                 lambda m, i, o: out.__setitem__('future_states', o)),
             golden.temporal_model.model[0].pyramid_pooling.features[0].avgpool
             .register_forward_hook(lambda m, i, o: pool.update(x=i[0], y=o))]
    try:
        with torch.no_grad(), parity.full_f32():
            out.update(golden(torch.as_tensor(image).to(device).permute(0, 1, 2, 5, 3, 4)
                              .contiguous(), t['intrinsics'], t['extrinsics'],
                              t['future_egomotion']))
    finally:
        for h in hooks:
            h.remove()
    return {k: v.double().cpu() for k, v in out.items() if v is not None}, pool


def rel(want, got):
    return float((want.double() - got.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def probe(name, trainer, cfg, batch, root, device='cuda'):
    ckpt = parity.write_reference_checkpoint(os.path.join(root, f'{name}.ckpt'),
                                             trainer.state(), cfg)
    state, cfg = load_torch_full_checkpoint(ckpt)
    print(f'=== {name}', flush=True)
    report = parity.stage_diffs(ckpt, state, cfg, batch, device)
    model_cfg = dataclasses.replace(FieryConfig.from_cfg(cfg), precision=32)
    golden = parity.load_reference(parity.golden_fiery(model_cfg, device),
                                   _torch_blob(ckpt)[0]).eval()
    clean, pool = twin_run(golden, batch)
    noisy, _ = twin_run(golden, batch, perturb=1e-7)
    x, twin_mean = pool['x'], pool['y'][:, :, :-1]
    size = (2, x.shape[-2], x.shape[-1])
    exact = _causal_avg_pool3d(x.double(), size)
    variances = {n: [float(m.running_var.min()), float(m.running_var.median())]
                 for n, m in trainer.model.named_modules()
                 if n.endswith('pyramid_pooling.features.0.conv_bn_relu.norm')}
    rec = {'stage_diffs': report,
           'twin_under_1e-7_input': {k: rel(clean[k], noisy[k]) for k in clean},
           'pooled_mean_vs_f64': {'twin_avg_pool3d': rel(exact, twin_mean),
                                  'port': rel(exact, _causal_avg_pool3d(x, size))},
           'pooled_batchnorm_var_min_median': variances}
    print(json.dumps({name: rec}), flush=True)
    return rec


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('parity_probe needs a CUDA card')
    _build.build_all()
    root = tempfile.mkdtemp(prefix='fiery_parity_probe_')
    try:
        tree = os.path.join(root, 'nusc')
        subprocess.run([sys.executable, '-m', 'fiery_tpu_torch.data.fake_nuscenes', tree,
                        '--train-scenes', '1', '--val-scenes', '1', '--samples', '9'],
                       check=True, capture_output=True, timeout=600)
        cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=OPTS))
        train_loader, _ = prepare_dataloaders(get_cfg(argparse.Namespace(
            config_file=BASELINE, opts=OPTS + ['DATASET.DATAROOT', tree])))
        windows = [numeric_batch(b) for b in train_loader]
        batch = parity.stage_batch(cfg, tree)
        for name in ('he_calibrated', 'default_calibrated', 'default_randomised'):
            torch.manual_seed(0)
            trainer = Trainer(cfg)
            if name == 'he_calibrated':
                init_params(trainer.model, seed=0)
            if name.endswith('calibrated'):
                calibrate_batchnorm(trainer.model, windows)
            else:
                randomise_batchnorm(trainer.model, seed=5)
            probe(name, trainer, cfg, batch, root)
            del trainer
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == '__main__':
    main()
