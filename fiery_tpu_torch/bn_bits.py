"""Hold the BatchNorm kernel (K10) and the SpatialGRU gate kernels (K11) of two
checkouts against each other, bit for bit:

    python -m fiery_tpu_torch.bn_bits PARENT_CHECKOUT .

Each checkout runs in a process of its own, from its root, through the functions
that both trees have (``ops.batch_norm.batch_norm_forward`` and
``batch_norm_backward``), on the same seeded inputs (bf16 and f32, 4-D and 5-D,
eval and training, every epilogue, 16-byte and one-channel widths) and on all
65,536 bf16 bit patterns as x in eval (mean 0, var + eps = 1, weight 1, bias 0,
so that z = x; the residual is x in reverse order; dy is 1). K11 through
``ops.spatial_gru.reset_concat``, ``state_update`` and their backwards: one GRU
step at batch 1 and 3 (bf16 and f32), and all bf16 bit patterns as the gates'
pre-activations at 16-, 4- and 2-byte accesses and at one channel. Prints, per
output, the number of values whose bits differ (two NaNs agree), and as its last
line a JSON summary: the differing values of each kind of output. K10's y and
K11's forward outputs (cat, h_new) must agree in every bit (the exit code is 1
when they do not); K10's statistics and gradients are sums taken in another
order and may differ in their last bits, and K11's gradients agree where both
trees keep the f32 order. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

CHILD = r'''
import inspect
import sys
import torch
from fiery_tpu_torch.ops import batch_norm as BN
from fiery_tpu_torch.ops import spatial_gru as GRU


def state_update(u_pre, h, ht, slot):
    """GRU.state_update into ``slot``: of trees that take the slot, or the buffer
    and the slot's index (``torch.ops.fiery_torch.gru_state_update``)."""
    if 'slot' in inspect.signature(GRU.state_update).parameters:
        return GRU.state_update(u_pre, h, ht, slot)
    return GRU.state_update(u_pre, h, ht, slot[:, None], 0)

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

# K11: one GRU step's two launches and their backward, as the GRU runs them (the
# state in slots of (B, T, C, H, W) buffers, the concat's gradient a channel slice)
C, T, H, W = 64, 4, 50, 60
for B, Cx in ((1, 32), (3, 64)):
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(B)
        x = torch.randn((B, T, H, W, Cx), generator=gen, device=dev).to(dtype).permute(
            0, 1, 4, 2, 3)
        prev = GRU.gru_output(torch.empty((B, C, H, W), dtype=dtype, device=dev), T)
        prev.copy_(torch.randn(prev.shape, generator=gen, device=dev))
        h = prev[:, 1]
        r_pre, u_pre, ht = (rows((B, C, H, W), dtype, gen) for _ in range(3))
        dcat = rows((B, Cx + C, H, W), dtype, gen)
        slots = GRU.gru_output(h, T)
        state_update(u_pre, h, ht, slots[:, 2])
        key = f'gru B={B} {str(dtype)[6:]}'
        outs = (('cat', GRU.reset_concat(x[:, 1], r_pre, h)), ('h_new', slots[:, 2]))
        outs += tuple(zip(('dr_pre', 'dh_reset'),
                          GRU.reset_concat_backward(dcat[:, Cx:], r_pre, h)))
        outs += tuple(zip(('du_pre', 'dh_update', 'dh_tilde'),
                          GRU.state_update_backward(prev[:, 3], u_pre, h, ht)))
        for name, t in outs:
            out[f'{key} {name}'] = t.detach().cpu().clone()
# every bf16 value as r_pre and u_pre (h reversed, h_tilde rolled by one), at 16-, 4-
# and 2-byte accesses (each operand a channel slice at that offset) and one channel
every = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16).view(
    torch.bfloat16)
for C, offset in ((64, 0), (64, 2), (64, 1), (1, 0)):
    side = int((65536 // C) ** 0.5)

    def operand(values):
        t = torch.zeros((1, side, side, C + 2 * offset), dtype=torch.bfloat16, device=dev)
        t[..., offset:offset + C] = values.view(1, side, side, C)
        return t.movedim(-1, 1)[:, offset:offset + C]

    z, h, ht, g = operand(every), operand(every.flip(0)), operand(every.roll(1)), \
        operand(every.roll(7))
    slot = operand(torch.zeros_like(every))
    state_update(z, h, ht, slot)
    key = f'gru every bf16 C={C} offset={offset}'
    outs = (('cat', GRU.reset_concat(h, z, h)), ('h_new', slot))
    outs += tuple(zip(('dr_pre', 'dh_reset'), GRU.reset_concat_backward(g, z, h)))
    outs += tuple(zip(('du_pre', 'dh_update', 'dh_tilde'),
                      GRU.state_update_backward(g, z, h, ht)))
    for name, t in outs:
        out[f'{key} {name}'] = t.cpu().clone()
torch.cuda.synchronize()
torch.save(out, sys.argv[1])
print('saved', len(out), flush=True)
'''


# the outputs that must agree in every bit: K10's y and K11's forward outputs
FORWARD = ('y', 'cat', 'h_new')


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
    return 1 if any(totals.get(k) for k in FORWARD) else 0


if __name__ == '__main__':
    sys.exit(main())
