"""Hold the BatchNorm kernel (K10) of two checkouts against each other, bit for bit:

    python -m fiery_tpu_torch.bn_bits PARENT_CHECKOUT .

Each checkout runs in a process of its own, from its root, through the functions
that both trees have (``ops.batch_norm.batch_norm_forward`` and
``batch_norm_backward``), on the same seeded inputs (bf16 and f32, 4-D and 5-D,
eval and training, every epilogue, 16-byte and one-channel widths) and on all
65,536 bf16 bit patterns as x in eval (mean 0, var + eps = 1, weight 1, bias 0,
so that z = x; the residual is x in reverse order; dy is 1). Prints, per output,
the number of values whose bits differ (two NaNs agree), and as its last line a
JSON summary: the differing values of y and of every output. y must agree in
every bit (the exit code is 1 when it does not); the statistics and the
gradients are sums taken in another order and may differ in their last bits.
Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

CHILD = r'''
import sys
import torch
from fiery_tpu_torch.ops import batch_norm as BN

POSTS = ('none', 'relu', 'swish', 'add', 'add_relu', 'relu_add')
RESIDUAL = ('add', 'add_relu', 'relu_add')
dev = torch.device('cuda')
out = {}


def rows(shape, dtype, gen, mean=0.0):
    t = torch.randn(shape[:1] + shape[2:] + shape[1:2], generator=gen, device=dev) + mean
    return t.to(dtype).movedim(-1, 1)


seed = 0
for post in POSTS:
    for shape in ((6, 144, 14, 30), (2, 35, 3, 20, 22), (4, 21, 9, 11)):
        for dtype in (torch.float32, torch.bfloat16):
            for training in (False, True):
                seed += 1
                gen = torch.Generator(device=dev).manual_seed(seed)
                C = shape[1]
                x = rows(shape, dtype, gen, 0.5)
                res = rows(shape, dtype, gen) if post in RESIDUAL else None
                dy = rows(shape, dtype, gen)
                w = torch.rand(C, generator=gen, device=dev) + 0.5
                b = torch.randn(C, generator=gen, device=dev)
                rm = torch.randn(C, generator=gen, device=dev) * 0.1 + 0.5
                rv = torch.rand(C, generator=gen, device=dev) + 0.5
                y, mean, var, clamp = BN.batch_norm_forward(x, w, b, rm, rv, training, 0.1,
                                                            1e-3, post, res)
                dx, dw, db, dres = BN.batch_norm_backward(dy, x, w, b, mean, var, clamp,
                                                          1e-3, post, res, training)
                key = f'{post} {tuple(shape)} {str(dtype)[6:]} {"train" if training else "eval"}'
                for name, t in (('y', y), ('mean', mean), ('var', var), ('running_mean', rm),
                                ('running_var', rv), ('dx', dx), ('dweight', dw),
                                ('dbias', db), ('dres', dres)):
                    if t is not None:
                        out[f'{key} {name}'] = t.detach().cpu().clone()
for post in POSTS:
    for C in (64, 1):
        x = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16).view(
            torch.bfloat16).view(65536 // C, 1, 1, C).movedim(-1, 1)
        res = x.flip(0) if post in RESIDUAL else None
        w, b = torch.ones(C, device=dev), torch.zeros(C, device=dev)
        mean, var = torch.zeros(C, device=dev), torch.full((C,), 0.75, device=dev)
        y = BN.batch_norm_forward(x, w, b, mean, var, False, 0.0, 0.25, post, res)[0]
        dx, _, _, dres = BN.batch_norm_backward(torch.ones_like(x), x, w, b, mean, var, None,
                                                0.25, post, res, False)
        for name, t in (('y', y), ('dx', dx), ('dres', dres)):
            if t is not None:
                out[f'{post} every bf16 C={C} {name}'] = t.cpu().clone()
torch.cuda.synchronize()
torch.save(out, sys.argv[1])
print('saved', len(out), flush=True)
'''


def run(tree, path):
    tree = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, '-c', CHILD, path], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f'{tree}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n'
                           f'{proc.stderr[-3000:]}')
    return torch.load(path)


def differing(a, b):
    """Values whose bits differ (two NaNs agree)."""
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    same = (a.contiguous().view(bits) == b.contiguous().view(bits)) | (
        torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('a', help='checkout A (e.g. the parent commit unpacked)')
    parser.add_argument('b', help='checkout B')
    args = parser.parse_args()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build')
    os.makedirs(build, exist_ok=True)
    got = [run(tree, os.path.join(build, f'bn_bits_{i}.pt'))
           for i, tree in enumerate((args.a, args.b))]
    if got[0].keys() != got[1].keys():
        raise AssertionError('the two checkouts returned different outputs')
    totals = {}
    for key in got[0]:
        n = differing(got[0][key], got[1][key])
        name = key.rsplit(' ', 1)[1]
        totals[name] = totals.get(name, 0) + n
        print(json.dumps({'output': key, 'values': got[0][key].numel(), 'differing': n}))
    print(f'device {torch.cuda.get_device_name(0)}')
    print(json.dumps({'differing_values': totals, 'outputs': len(got[0])}), flush=True)
    return 1 if totals.get('y') else 0


if __name__ == '__main__':
    sys.exit(main())
