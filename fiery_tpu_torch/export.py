"""Export the served forward, BatchNorm folded, at a fixed batch (counterpart of
fiery_tpu/utils/export_lib.py and the root export.py).

    python -m fiery_tpu_torch.export --output model.fiery [--config FILE]
        [--checkpoint DIR] [--batch 1] [--validate] [--device cpu] [KEY VALUE ...]

Without --checkpoint the weights are the seeded ones the scripts serve
(``serve.seeded_state_dict``: ``init_params`` and ``calibrate_batchnorm``); with it,
the model of a checkpoint directory of ``utils/checkpoint.py``. Loading:

    served = load_exported('model.fiery')          # on the card: serve_graph.ServedFiery
    out, ids = served.predict_instances(request)   # one CUDA graph replay
    model = load_exported('model.fiery', device='cpu')   # the eager folded model
    out = serve.predict(model, request)

The artifact is one file: a magic string, then ``torch.save`` of {'config': the
config as JSON, 'batch', 'fold_bn', 'state_dict': the f32 weights, folded}. The JAX
package's artifact is a StableHLO program that runs without fiery_tpu. A CUDA graph
cannot be saved, so this artifact holds the weights and needs fiery_tpu_torch,
which rebuilds the model and captures it again when it loads.
"""

import argparse
import io
import json

import numpy as np
import torch

from fiery_tpu_torch.models.fiery import Fiery, FieryConfig
from fiery_tpu_torch.serve import (build_fiery, make_request, predict, predict_instances,
                                   seeded_state_dict)
from fiery_tpu_torch.serve_graph import ServedFiery
from fiery_tpu_torch.utils.bn_fold import fold_batchnorm
from fiery_tpu_torch.utils.checkpoint import load_checkpoint
from fiery_tpu_torch.utils.config import get_cfg

MAGIC = b'FIERYTORCH1'


def export_model(cfg, checkpoint='', batch=1, fold_bn=True, device=None):
    """(artifact bytes, the f32 state_dict it holds) for ``cfg`` at ``batch``:
    the checkpoint's model weights, or the seeded ones made on ``device``, with
    every BatchNorm folded into its conv under ``fold_bn``."""
    if checkpoint:
        state_dict = load_checkpoint(checkpoint)[0]['model']
    else:
        state_dict = seeded_state_dict(cfg, seed=0, device=device)
    state_dict = {k: v.detach().cpu() for k, v in state_dict.items()}
    if fold_bn:
        state_dict, _ = fold_batchnorm(state_dict, Fiery(FieryConfig.from_cfg(cfg)))
    buf = io.BytesIO()
    torch.save({'config': json.dumps(cfg.convert_to_dict()), 'batch': batch,
                'fold_bn': fold_bn, 'state_dict': state_dict}, buf)
    return MAGIC + buf.getvalue(), state_dict


def read_artifact(path):
    """{'config': CfgNode, 'batch', 'fold_bn', 'state_dict'} of an artifact; raises
    ValueError for a file that is not one."""
    with open(path, 'rb') as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise ValueError(f'{path} is not a fiery_tpu_torch export artifact')
    artifact = torch.load(io.BytesIO(data[len(MAGIC):]), map_location='cpu',
                          weights_only=True)
    artifact['config'] = get_cfg(cfg_dict=json.loads(artifact['config']))
    return artifact


def load_exported(path, device=None):
    """The model of an artifact on ``device`` (default: cuda): on the card, both
    requests captured as CUDA graphs at the artifact's batch (``ServedFiery``); on
    the CPU, the eager model (``serve.predict`` answers it)."""
    artifact = read_artifact(path)
    cfg = artifact['config']
    model = build_fiery(cfg, device, artifact['state_dict'])
    if next(model.parameters()).device.type == 'cuda':
        return ServedFiery(model, cfg, artifact['batch'])
    return model


def batch_request(cfg, batch):
    """``batch`` seeded requests (seeds 0, 1, ...) stacked into one."""
    requests = [make_request(cfg, seed=s) for s in range(batch)]
    return {k: np.concatenate([r[k] for r in requests]) for k in requests[0]}


def _assert_equal(got, want, name):
    if not torch.equal(got.cpu(), want.cpu()):
        err = (got.cpu().double() - want.cpu().double()).abs().max()
        raise AssertionError(f'{name}: the loaded model differs, max abs err {float(err)}')


def validate(path, cfg, state_dict, batch, device=None):
    """Hold the loaded artifact against the live model of ``state_dict`` (the eager
    forward) on one request, every output bit for bit; on the card the loaded
    model is the captured one, and both of its graphs are checked (the ids too)."""
    loaded = load_exported(path, device)
    live = build_fiery(cfg, device, state_dict)
    request = batch_request(cfg, batch)
    if isinstance(loaded, ServedFiery):
        want, want_ids = predict_instances(live, request)
        got, got_ids = loaded.predict_instances(request)
        _assert_equal(got_ids, want_ids, 'ids')
        for k, v in loaded.predict(request).items():
            _assert_equal(v, want[k], f'predict {k}')
    else:
        want, got = predict(live, request), predict(loaded, request)
    if sorted(got) != sorted(want):
        raise AssertionError(f'outputs {sorted(got)} != {sorted(want)}')
    for k in want:
        _assert_equal(got[k], want[k], k)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', default='', help='config YAML (default: the defaults)')
    parser.add_argument('--checkpoint', default='',
                        help='a checkpoint directory to export; seeded weights if empty')
    parser.add_argument('--output', required=True)
    parser.add_argument('--batch', default=1, type=int)
    parser.add_argument('--validate', action='store_true',
                        help='load the artifact and compare it with the live model')
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    parser.add_argument('opts', nargs=argparse.REMAINDER, default=[],
                        help='config KEY VALUE overrides')
    args = parser.parse_args(argv)
    cfg = get_cfg(argparse.Namespace(config_file=args.config, opts=args.opts))
    blob, state_dict = export_model(cfg, args.checkpoint, args.batch, device=args.device)
    with open(args.output, 'wb') as f:
        f.write(blob)
    print(f'wrote {args.output} ({len(blob) / 1e6:.1f} MB)')
    if args.validate:
        validate(args.output, cfg, state_dict, args.batch, args.device)
        print('validate ok: the exported artifact matches the live model')


if __name__ == '__main__':
    main()
