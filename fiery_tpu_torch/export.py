"""Export the served forward, BatchNorm folded, at a fixed batch as a program
(counterpart of fiery_tpu/utils/export_lib.py and the root export.py).

    python -m fiery_tpu_torch.export --output model.fiery [--config FILE]
        [--checkpoint DIR] [--batch 1] [--validate] [--device cpu] [KEY VALUE ...]

Without --checkpoint the weights are the seeded ones the scripts serve
(``serve.seeded_state_dict``: ``init_params`` and ``calibrate_batchnorm``); with it,
the model of a checkpoint directory of ``utils/checkpoint.py``. The eval forward
with zero noise (``serve.predict``'s) is traced by ``torch.export`` on the device
that is to run it, at the artifact's batch: its inputs are the request of
``serve_graph.request_spec`` (uint8 images, intrinsics, extrinsics, ego-motion),
its outputs ``predict``'s dict. The kernels stay in the program as the operators
of ``ops/library.py`` (``torch.ops.fiery_torch``), and the program holds its
weights, as the JAX package's StableHLO artifact does. Loading:

    served = load_exported('model.fiery')          # on the card: serve_graph.ServedFiery
    out, ids = served.predict_instances(request)   # one CUDA graph replay
    module = load_exported('model.fiery', device='cpu')   # the program's module
    out = serve.predict(module, request)

A program runs only on the device it was exported for; loading it on another
raises. Loading needs ``fiery_tpu_torch.ops.library`` (imported here) for the
operators, and nothing of ``fiery_tpu_torch.models``: the program replaces the
model's code. The decode and the device tracker after the forward
(``predict_instances``) are the package's, as the JAX package's decoding is.

The artifact is one file: the magic string, the length of a JSON header (8 bytes,
little-endian) and the header ({'config': the config, 'batch', 'fold_bn',
'device'}), then ``torch.export.save`` of the program.
"""

import argparse
import io
import json
import struct

import numpy as np
import torch

from fiery_tpu_torch.ops import library  # noqa: F401  (the operators a program calls)
from fiery_tpu_torch.serve_graph import ServedFiery, request_spec
from fiery_tpu_torch.utils.config import get_cfg
from fiery_tpu_torch.utils.device import resolve_device

MAGIC = b'FIERYTORCH2'


def _on(device):
    """``device`` with its index: the current card for a bare 'cuda'."""
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def export_program(model, cfg, batch):
    """``torch.export`` of ``model``'s forward (an eval model, its parameters
    frozen) at ``batch`` requests, on the model's device."""
    device = next(model.parameters()).device
    args = tuple(torch.zeros(shape, dtype=dtype, device=device)
                 for shape, dtype in request_spec(cfg, batch).values())
    model.requires_grad_(False)
    with torch.no_grad():
        return torch.export.export(model, args, strict=False)


def export_model(cfg, checkpoint='', batch=1, fold_bn=True, device=None, state_dict=None):
    """(artifact bytes, the f32 state_dict whose model it holds, the program) for
    ``cfg`` at ``batch`` on ``device`` (default: cuda): the weights of
    ``state_dict``, else of the checkpoint, else the seeded ones, with every
    BatchNorm folded into its conv under ``fold_bn``."""
    from fiery_tpu_torch.models.fiery import Fiery, FieryConfig
    from fiery_tpu_torch.serve import build_fiery, seeded_state_dict
    from fiery_tpu_torch.utils.bn_fold import fold_batchnorm
    from fiery_tpu_torch.utils.checkpoint import load_checkpoint

    device = _on(device)
    if state_dict is None and checkpoint:
        state_dict = load_checkpoint(checkpoint)[0]['model']
    elif state_dict is None:
        state_dict = seeded_state_dict(cfg, seed=0, device=device)
    state_dict = {k: v.detach().cpu() for k, v in state_dict.items()}
    if fold_bn:
        state_dict, _ = fold_batchnorm(state_dict, Fiery(FieryConfig.from_cfg(cfg)))
    program = export_program(build_fiery(cfg, device, state_dict), cfg, batch)
    header = json.dumps({'config': cfg.convert_to_dict(), 'batch': batch,
                         'fold_bn': fold_bn, 'device': str(device)}).encode()
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = MAGIC + struct.pack('<Q', len(header)) + header + buf.getvalue()
    return blob, state_dict, program


def read_artifact(path):
    """{'config': CfgNode, 'batch', 'fold_bn', 'device': torch.device, 'program':
    the saved program's bytes} of an artifact; raises ValueError for a file that
    is not one."""
    with open(path, 'rb') as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise ValueError(f'{path} is not a fiery_tpu_torch export artifact')
    n, = struct.unpack_from('<Q', data, len(MAGIC))
    start = len(MAGIC) + 8
    artifact = json.loads(data[start:start + n])
    artifact['config'] = get_cfg(cfg_dict=artifact['config'])
    artifact['device'] = torch.device(artifact['device'])
    artifact['program'] = bytearray(data[start + n:])     # writable, as torch.load wants
    return artifact


def load_exported(path, device=None):
    """The program of an artifact on ``device`` (default: cuda), which must be the
    device it was exported for: on the card, both requests captured as CUDA graphs
    at the artifact's batch (``ServedFiery``); on the CPU, the program's module
    (``serve.predict`` answers it)."""
    artifact = read_artifact(path)
    device = _on(device)
    if device != artifact['device']:
        raise ValueError(f'{path} holds a program exported for {artifact["device"]}; it '
                         f'does not run on {device}')
    module = torch.export.load(io.BytesIO(artifact['program'])).module()
    if device.type == 'cuda':
        return ServedFiery(module, artifact['config'], artifact['batch'])
    return module


def batch_request(cfg, batch):
    """``batch`` seeded requests (seeds 0, 1, ...) stacked into one."""
    from fiery_tpu_torch.serve import make_request

    requests = [make_request(cfg, seed=s) for s in range(batch)]
    return {k: np.concatenate([r[k] for r in requests]) for k in requests[0]}


def _assert_equal(got, want, name):
    if not torch.equal(got.cpu(), want.cpu()):
        err = (got.cpu().double() - want.cpu().double()).abs().max()
        raise AssertionError(f'{name}: the loaded program differs, max abs err {float(err)}')


def validate(path, cfg, state_dict, batch, device=None):
    """Hold the loaded program against the live eager model of ``state_dict`` (the
    folded f32 weights ``export_model`` returns) on one request, every output bit
    for bit; on the card the program is captured, and both of its graphs are
    checked (the ids too)."""
    from fiery_tpu_torch.serve import build_fiery, predict, predict_instances

    loaded = load_exported(path, device)
    live = build_fiery(cfg, _on(device), state_dict)
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
                        help='load the program and compare it with the live model')
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    parser.add_argument('opts', nargs=argparse.REMAINDER, default=[],
                        help='config KEY VALUE overrides')
    args = parser.parse_args(argv)
    cfg = get_cfg(argparse.Namespace(config_file=args.config, opts=args.opts))
    blob, state_dict, _ = export_model(cfg, args.checkpoint, args.batch, device=args.device)
    with open(args.output, 'wb') as f:
        f.write(blob)
    print(f'wrote {args.output} ({len(blob) / 1e6:.1f} MB)')
    if args.validate:
        validate(args.output, cfg, state_dict, args.batch, args.device)
        print('validate ok: the exported program matches the live model')


if __name__ == '__main__':
    main()
