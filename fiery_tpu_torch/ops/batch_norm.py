"""BatchNorm with its fused epilogue (kernel K10, csrc/batch_norm.cu; counterpart of
fiery_tpu/models/layers.py ``_BNCore`` and ``_apply_post``).

Computes, over the channels (dim 1) of a 4-D or 5-D channels-first view:
  training: mean = E[x], var = max(E[x^2] - mean^2, 0) in f32 over every other
            dimension (the sums are taken in f64 and rounded once); the running
            statistics move to (1 - m) running + m batch, with the BIASED variance;
  eval:     mean, var = the running statistics;
  mul = weight * (1 / sqrt(var + eps)) in f32; then mean, mul and bias are rounded
  to x's dtype (bfloat16 under PRECISION 16, as ``_BNCore`` casts them), and
      y = post((x - mean) * mul + bias, residual)
  is formed in x's dtype with every operation rounded to it, as the JAX package's
  bfloat16 operations round on XLA's CPU (pinned bit for bit by
  tests/test_torch_batchnorm.py), with post one of ``POSTS``:
      none: z,  relu: max(z, 0),  swish: z * sigmoid(z),  add: z + r,
      add_relu: max(z + r, 0),  relu_add: max(z, 0) + r,
  where sigmoid(z) = 1 / (1 + exp(-z)), also one rounding per operation.
The backward recomputes z from x and the statistics (nothing but x is saved),
takes the epilogue's gradient dz (relu: dy where z > 0; swish: dy s (1 + z (1 - s))
with s = sigmoid(z); add_relu: dy where z + r > 0, which is also the residual's
gradient; add and relu_add pass dy to the residual unchanged), reduces
sum(dz) and sum(dz * xhat) per channel in f64 (the bias's and weight's gradients,
xhat = (x - mean) / sqrt(var + eps)), and forms
      training: dx = mul (dz - sum(dz) / M - c xhat sum(dz xhat) / M)
      eval:     dx = mul dz
with the unrounded f32 mul and c the derivative of the clamp max(., 0) at the
variance (1 above 0, 1/2 at 0, 0 below, as JAX differentiates jnp.maximum).

The kernels take the channels-first view of channels-last memory (4-D
``channels_last`` or 5-D ``channels_last_3d``) as M = numel / C rows of C
channels and raise on any other layout; the plain versions below take any layout.
A launch takes at most MAX_CHANNELS channels: a wider call (the encoder's expanded
layers at downsample 16, 1,632 and 2,688 channels) launches the kernels once a
channel slice (``channel_slices``), each slice's rows a whole row apart; the
channels are independent, so the slices give the bits of one launch.
A CPU tensor takes the plain versions; a CUDA tensor launches the kernels. The
forward is the operator ``torch.ops.fiery_torch.batch_norm`` (eval) or
``batch_norm_train`` (ops/library.py), whose CUDA implementation is
``batch_norm_card``.

Synchronised statistics (``group``, a ``torch.distributed`` process group: the
data-parallel training of parallel/mesh.py, the JAX package's BatchNorm over a
batch sharded on its ``data`` axis). A training call then takes its statistics
over the ranks' rows together:
  forward: each rank's f64 vector (S1, S2, M) = (sum x, sum x^2, its rows) per
    channel (``batch_norm_partials_card``), gathered into (world, 2 C + 1) in rank order
    (``gather_sums``: ``all_gather_into_tensor`` on NCCL, ``all_gather`` on gloo),
    summed in rank order in f64 and finalized as above over the global row count N
    (``batch_norm_finalize_card``: mean, var, clamp, the running statistics); then
    the apply pass, the eval operator on those statistics (``batch_norm_sync_forward``;
    each ``*_card`` has its ``*_plain`` version);
  backward: each rank's (S_dz, S_dzx, M) the same way (``batch_norm_backward_sync``);
    dx from the global sums and N; dweight and dbias from the rank's own sums.
Why the rank's own sums. Let L = (1 / W) sum_r L_r be the global loss, L_r the loss
that rank r computes on its rows (each of the W ranks a mean over an equal share of
the batch), and dz_r = dL_r / dz the gradient that autograd hands rank r's
BatchNorm, so that dL / dz = dz_r / W on rank r's rows. The one-process gradients
are then
    dweight = sum_all dL/dz xhat = (1 / W) sum_r S_dzx(r),   dbias = (1 / W) sum_r S_dz(r),
which is the average that DistributedDataParallel takes of the ranks' own S_dzx(r),
S_dz(r): so each rank hands back its own sums (``torch.nn.SyncBatchNorm``'s rule).
And rank r's dx must be W dL/dx on its rows, so that its upstream parameter
gradients, averaged in turn, are the global ones:
    W dL/dx_i = mul (dz_i - (1/N) sum_all dz - c xhat_i (1/N) sum_all dz xhat),
with the sums over every rank's local dz: the gathered sums and the global N.
Every rank sums the same gathered bits in the same order, so all ranks hold the
same statistics and coefficients whatever the collective's own order; with one
rank the sums are the fused launch's own, so the path gives its bits.
"""

import ctypes
import math
from collections import Counter

import torch
import torch.distributed as dist

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.utils.rounding import sqrt_rn

POSTS = ('none', 'relu', 'swish', 'add', 'add_relu', 'relu_add')
RESIDUAL_POSTS = ('add', 'add_relu', 'relu_add')
MAX_CHANNELS = 1024       # a launch keeps <= 1024 channels' constants in shared memory


def channel_slices(C):
    """[(c0, c1)]: the channel slices a call of C channels launches the kernels on:
    C itself up to MAX_CHANNELS; beyond it ceil(C / MAX_CHANNELS) slices of equal
    width rounded up to a multiple of 8 channels, so that each slice starts 16 bytes
    into the row in bf16 and f32 alike, and the last slice takes the rest."""
    if C <= MAX_CHANNELS:
        return [(0, C)]
    n = -(-C // MAX_CHANNELS)
    width = 8 * -(-C // (8 * n))
    return [(c0, min(C, c0 + width)) for c0 in range(0, C, width)]


def _reduce_dims(x):
    return [0] + list(range(2, x.dim()))


def _per_channel(v, x):
    """A (C,) vector shaped to broadcast over x's channels (dim 1)."""
    return v.view((1, -1) + (1,) * (x.dim() - 2))


def sigmoid(z):
    """1 / (1 + exp(-z)), each operation rounded to z's dtype (XLA's expansion of
    the logistic function)."""
    return 1.0 / (1.0 + torch.exp(-z))


def _epilogue_plain(z, post, residual):
    """The epilogue on the normalised value z, in z's dtype."""
    if post == 'none':
        return z
    if post == 'relu':
        return torch.clamp_min(z, 0.0)
    if post == 'swish':
        return z * sigmoid(z)
    if post == 'add':
        return z + residual
    if post == 'add_relu':
        return torch.clamp_min(z + residual, 0.0)
    if post == 'relu_add':
        return torch.clamp_min(z, 0.0) + residual
    raise ValueError(f'Invalid BN epilogue {post}')


def _normalise_plain(x, weight, bias, mean, var, eps):
    """z = (x - mean) * mul + bias in x's dtype, from the f32 constants rounded to
    it."""
    mul = weight * (1.0 / sqrt_rn(var + eps))
    mu, mul, b = (_per_channel(v.to(x.dtype), x) for v in (mean, mul, bias))
    return (x - mu) * mul + b


def _rows_vector(a, b, rows):
    """The (2 C + 1) f64 vector of a rank: the sums a and b per channel, its rows."""
    return torch.cat([a, b, a.new_full((1,), float(rows))])


def sum_ranks(gathered):
    """The (2 C + 1) sum of a (world, 2 C + 1) f64 gather, in rank order: slot 0,
    then each next slot added (the finalize kernels' order)."""
    total = gathered[0]
    for r in range(1, gathered.shape[0]):
        total = total + gathered[r]
    return total


def _stats_of_sums(total):
    """(mean, var, clamp) per channel, f32, from a vector (S1, S2, N)."""
    C = (total.numel() - 1) // 2
    n = total[2 * C]
    mean = (total[:C] / n).float()
    mean2 = (total[C:2 * C] / n).float()
    raw = mean2 - mean * mean
    clamp = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0)).float()
    return mean, torch.clamp_min(raw, 0.0), clamp


def batch_norm_partials_plain(x):
    """Plain version of the synchronised forward's reduction: the (2 C + 1) f64
    vector (sum x, sum x^2 over every dimension but 1, the row count)."""
    dims = _reduce_dims(x)
    xd = x.double()
    return _rows_vector(xd.sum(dims), (xd * xd).sum(dims), x.numel() // x.shape[1])


def batch_stats_plain(x):
    """(mean, var, clamp) per channel, f32: the f64 sums of x and x^2 over every
    dimension but 1, each divided by the row count and rounded to f32; var =
    max(E[x^2] - mean^2, 0) in f32; clamp the clamp's derivative (1, 1/2 or 0)."""
    return _stats_of_sums(batch_norm_partials_plain(x))


def batch_norm_finalize_plain(gathered, running_mean, running_var, momentum):
    """Plain version of the synchronised forward's finalize: the ranks' vectors
    summed in rank order, then (3, C) f32 mean, var and clamp as
    ``batch_stats_plain`` forms them; the running statistics updated in place."""
    mean, var, clamp = _stats_of_sums(sum_ranks(gathered))
    update_running_plain(running_mean, running_var, mean, var, momentum)
    return torch.stack([mean, var, clamp])


def update_running_plain(running_mean, running_var, mean, var, momentum):
    """running <- (1 - m) running + m batch, in place, f32."""
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(mean * momentum)
        running_var.mul_(1.0 - momentum).add_(var * momentum)


def batch_norm_plain(x, weight, bias, mean, var, eps, post='none', residual=None):
    """Plain version of K10's apply pass: y = post(z, residual) rounded to x's
    dtype, with the statistics (mean, var) given."""
    return _epilogue_plain(_normalise_plain(x, weight, bias, mean, var, eps), post,
                           residual)


def _backward_dz(dy, x, weight, bias, mean, var, eps, post, residual):
    """(dz, xhat, rstd, dresidual) of the backward, f32 (dresidual in dy's dtype,
    add_relu only)."""
    z = _normalise_plain(x, weight, bias, mean, var, eps).float()
    dz = dy.float()
    dres = None
    if post in ('relu', 'relu_add'):
        dz = torch.where(z > 0, dz, 0.0)
    elif post == 'swish':
        s = sigmoid(z)
        dz = dz * (s * (1.0 + z * (1.0 - s)))
    elif post == 'add_relu':
        dz = torch.where(z + residual.float() > 0, dz, 0.0)
        dres = dz.to(dy.dtype)
    rstd = 1.0 / sqrt_rn(var + eps)
    xhat = (x.float() - _per_channel(mean, x)) * _per_channel(rstd, x)
    return dz, xhat, rstd, dres


def _backward_sums(dz, xhat, x):
    """The (2 C + 1) f64 vector (sum dz, sum dz xhat, the row count)."""
    dims = _reduce_dims(x)
    dzd = dz.double()
    return _rows_vector(dzd.sum(dims), (dzd * xhat.double()).sum(dims),
                        x.numel() // x.shape[1])


def _dx_coefficients(total, clamp):
    """(2, C) f32: the dx coefficients S_dz / N and clamp S_dzx / N of a vector
    (S_dz, S_dzx, N)."""
    C = (total.numel() - 1) // 2
    n = total[2 * C]
    return torch.stack([(total[:C] / n).float(), clamp * (total[C:2 * C] / n).float()])


def _dx_plain(dz, xhat, rstd, weight, x, coefficients):
    """dx = mul ((dz - a) - xhat b), in x's dtype; coefficients (a, b) or None
    (eval: mul dz)."""
    mul = _per_channel(weight * rstd, x)
    if coefficients is None:
        return (mul * dz).to(x.dtype)
    a, b = (_per_channel(v, x) for v in coefficients)
    return (mul * ((dz - a) - xhat * b)).to(x.dtype)


def batch_norm_backward_plain(dy, x, weight, bias, mean, var, clamp, eps, post,
                              residual, training):
    """Plain version of K10's backward: (dx, dweight, dbias, dresidual); dresidual
    is computed for add_relu only (None otherwise: add and relu_add pass dy)."""
    dz, xhat, rstd, dres = _backward_dz(dy, x, weight, bias, mean, var, eps, post, residual)
    sums = _backward_sums(dz, xhat, x)
    C = x.shape[1]
    dx = _dx_plain(dz, xhat, rstd, weight, x,
                   _dx_coefficients(sums, clamp) if training else None)
    return dx, sums[C:2 * C].float(), sums[:C].float(), dres


def batch_norm_backward_partials_plain(dy, x, weight, bias, mean, var, eps, post, residual):
    """Plain version of the synchronised backward's reduction: (the rank's (2 C + 1)
    f64 vector (sum dz, sum dz xhat, its rows), dresidual as
    ``batch_norm_backward_plain`` gives it)."""
    dz, xhat, _, dres = _backward_dz(dy, x, weight, bias, mean, var, eps, post, residual)
    return _backward_sums(dz, xhat, x), dres


def batch_norm_backward_finalize_plain(gathered, rank, clamp):
    """Plain version of the synchronised backward's finalize: (4, C) f32 dweight and
    dbias of rank ``rank``'s own sums, and the dx coefficients of the sums over the
    ranks in rank order and the global row count."""
    own = gathered[rank]
    C = (own.numel() - 1) // 2
    return torch.cat([torch.stack([own[C:2 * C].float(), own[:C].float()]),
                      _dx_coefficients(sum_ranks(gathered), clamp)])


def batch_norm_backward_apply_plain(dy, x, weight, bias, mean, var, dparams, eps, post,
                                    residual):
    """Plain version of the synchronised backward's apply pass: dx from the
    coefficients dparams[2], dparams[3]."""
    dz, xhat, rstd, _ = _backward_dz(dy, x, weight, bias, mean, var, eps, post, residual)
    return _dx_plain(dz, xhat, rstd, weight, x, dparams[2:4])


# ---- the card ----

def rows_form(x):
    """'4d' or '5d' when x is a channels-first view of channels-last memory (the
    kernels' (M, C) rows), else None."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return '4d'
    if x.dim() == 5 and x.is_contiguous(memory_format=torch.channels_last_3d):
        return '5d'
    return None


def row_stride(t):
    """R when t (channels-first, 4-D or 5-D) keeps its M = numel / C rows of C
    channels R >= C elements apart in channels-last order (R = C: dense rows; R > C:
    a channel slice of wider rows, as the gradient of a concat is), else None."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        return None
    R, inner = None, 1
    for d in list(range(t.dim() - 1, 1, -1)) + [0]:
        if t.shape[d] > 1:
            if R is None:
                R, rem = divmod(t.stride(d), inner)
                if rem or R < t.shape[1]:
                    return None
            elif t.stride(d) != R * inner:
                return None
        inner *= t.shape[d]
    return t.shape[1] if R is None else R


BLOCK_THREADS = 512    # a block's threads (up to 1024 when a lane is one value)
ROWS_MIN = 4           # kernel rows a thread walks at the least, before the grid grows
GROUP = 8              # blocks whose partials the reductions' first level adds


def vector_width(C, itemsize, row_strides=(), align=0, rows=0):
    """(V, fold): V, the values a kernel thread moves with one access, the widest
    power of two with V * itemsize <= 16 bytes whose bytes divide ``align`` (the
    bitwise OR of the tensors' addresses, mod 16); the kernel's rows are ``fold``
    rows of C channels, so that fold C is a multiple of V. fold = 1 when V divides
    C and every row stride; otherwise fold = V / gcd(C, V) consecutive rows, which
    needs dense rows (every row stride C) and a row count ``rows`` that fold
    divides. 16 bytes (8 bf16, 4 f32) for every C that is a multiple of 8, and for
    the other C when their rows are dense and their count allows it."""
    V = 16 // itemsize
    while V > 1:
        if align % (V * itemsize) == 0:
            fold = V // math.gcd(C, V)
            if fold == 1 and all(r % V == 0 for r in row_strides):
                return V, 1
            if (fold > 1 and all(r == C for r in row_strides) and rows % fold == 0
                    and fold * C // V <= BLOCK_THREADS):
                return V, fold
        V //= 2
    return 1, 1


def grid(M, C, V, fold, sms):
    """(G, threads, R, blocks) of a call of M rows of C channels, V values a thread,
    fold rows a kernel row of W = fold C values: a block is G row groups of W / V
    lanes (a thread each, 512 threads or one row group); block b owns kernel rows
    [b R, (b + 1) R), R a multiple of G. The blocks are as many as the rows fill
    (each thread ROWS_MIN kernel rows or more), at most one per SM."""
    M //= fold
    L = fold * C // V
    G = max(1, BLOCK_THREADS // L)
    threads = -(-G * L // 32) * 32
    blocks = max(1, min(-(-M // (G * ROWS_MIN)), sms))
    R = -(-M // blocks)
    R = -(-R // G) * G
    return G, threads, R, -(-M // R)


def partial_slots(blocks):
    """The f64 partials of a reduction: one per block, then one per group of GROUP
    blocks (the first level of the last blocks' sum)."""
    return blocks + -(-blocks // GROUP)


def thread_rows(M, R, G, block, group, second_pass=False):
    """The rows that the kernel thread of row group ``group`` in ``block`` visits,
    in its order: ascending in a reduction (the first pass), descending in the
    apply pass that follows it, so that the rows read last are reread first (from
    L2)."""
    rows = range(block * R + group, min(M, (block + 1) * R), G)
    return rows[::-1] if second_pass else rows


def _check_card(name, x, residual, post):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name}: x must be float32 or bfloat16, got {x.dtype}')
    if rows_form(x) is None:
        raise ValueError(f'{name}: x {tuple(x.shape)} strides {x.stride()} is not a 4-D '
                         f'channels_last or 5-D channels_last_3d tensor')
    if post in RESIDUAL_POSTS:
        if (residual is None or residual.shape != x.shape or residual.dtype != x.dtype
                or rows_form(residual) != rows_form(x) or residual.device != x.device):
            raise ValueError(f'{name}: post {post!r} needs a residual of x\'s shape, '
                             f'dtype and layout')


_PLANS = {}
_SMS = {}


def _sms(dev):
    n = _SMS.get(dev)
    if n is None:
        n = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _plan(name, x, residual, post, align, dy=None, dy_align=0):
    """The launch plan of x's shape, strides, dtype and card (and the residual's and
    dy's) under ``post``, with ``align`` the OR of x's and the residual's addresses
    mod 16 (``dy_align`` dy's), checked and tiled at its first call: (M, C, the
    launches, one a channel slice: (c0, slice's C, V, fold, G, threads, R, blocks)
    each, dy's row stride or None when dy is to be copied to x's layout, form,
    is_bf16, post index, card index). Every later call of that key reuses it, so a
    call's host work is a dictionary lookup, the parameters' checks and the
    launches."""
    dev = x.get_device()
    key = (name, x.shape, x.stride(), x.dtype, dev, post, align, None if residual is None else
           (residual.shape, residual.stride(), residual.dtype, residual.get_device()),
           None if dy is None else (dy.shape, dy.stride(), dy.dtype, dy_align))
    plan = _PLANS.get(key)
    if plan is None:
        _check_card(name, x, residual, post)
        C = x.shape[1]
        M = x.numel() // C
        dy_rs = row_stride(dy) if dy is not None and dy.dtype == x.dtype else None
        if dy_rs is not None:        # dy read in place: its stride and address count
            strides, align = (dy_rs,), align | dy_align
        else:                        # no dy, or a copy of it in x's layout
            strides = ()
        slices = []
        for c0, c1 in channel_slices(C):
            # a slice of wider rows: its rows are C values apart
            wide = strides + ((C,) if c1 - c0 < C else ())
            V, fold = vector_width(c1 - c0, x.element_size(), wide, align, M)
            slices.append((c0, c1 - c0, V, fold, *grid(M, c1 - c0, V, fold, _sms(dev))))
        plan = _PLANS[key] = (M, C, tuple(slices), dy_rs, rows_form(x),
                              int(x.dtype == torch.bfloat16), POSTS.index(post), dev)
    return plan


def _check_params(name, dev, params):
    for p in params:
        if p.dtype is not torch.float32 or p.get_device() != dev or not p.is_contiguous():
            raise ValueError(f'{name}: weight, bias and statistics must be contiguous '
                             f'float32 on cuda:{dev}')


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PLAN = [_LL] + [_I] * 5 + [_LL, _I]     # M, C, V, fold, G, threads, R, blocks
_ARGTYPES = {
    'fiery_batch_norm_forward': [_P] * 11 + _PLAN + [_F] * 2 + [_I] * 3 + [_P, _LL],
    'fiery_batch_norm_backward': [_P, _LL] + [_P] * 11 + _PLAN + [_F] + [_I] * 3 + [_P, _LL],
    'fiery_batch_norm_partials': [_P, _P, _LL, _P, _P] + _PLAN + [_I, _P, _LL],
    'fiery_batch_norm_finalize': [_P, _I, _I] + [_P] * 5 + [_F, _P],
    'fiery_batch_norm_backward_partials': [_P, _LL] + [_P] * 8 + [_LL, _P, _P] + _PLAN
                                          + [_F, _I, _I, _P, _LL],
    'fiery_batch_norm_backward_finalize': [_P, _I, _I, _I, _P, _P, _P],
    'fiery_batch_norm_backward_apply': [_P, _LL] + [_P] * 8 + [_LL] + _PLAN
                                       + [_F, _I, _I, _P, _LL],
}
_FNS = {}


def _fn(name):
    """The ctypes function ``name`` of the batch_norm library, typed once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load('batch_norm'), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _ptr(t, offset=0):
    """t's address moved by ``offset`` bytes; null for no tensor."""
    return 0 if t is None else t.data_ptr() + offset


def _partial(slices, device):
    """The f64 partials of the reductions: a slot a block and a group of blocks of
    the largest slice, reused by each slice's launch in stream order."""
    return torch.empty((max(partial_slots(s[-1]) for s in slices), 2,
                        max(s[1] for s in slices)), dtype=torch.float64, device=device)


def batch_norm_forward_plain(x, weight, bias, running_mean, running_var, training,
                             momentum, eps, post='none', residual=None):
    """Plain version of K10's forward: (y, mean, var, clamp), the statistics it
    normalised with (the running ones in eval, clamp None); in training the running
    statistics are updated in place."""
    if training:
        mean, var, clamp = batch_stats_plain(x)
        update_running_plain(running_mean, running_var, mean, var, momentum)
    else:
        mean, var, clamp = running_mean, running_var, None
    return batch_norm_plain(x, weight, bias, mean, var, eps, post, residual), mean, var, clamp


def batch_norm_train_plain(x, weight, bias, running_mean, running_var, momentum, eps, post,
                           residual):
    """Plain version of K10's training forward as ``torch.ops.fiery_torch.batch_norm_train``
    returns it: (y, stats), stats (3, C) f32 the batch's mean, variance and clamp
    derivative; the running statistics are updated in place."""
    y, mean, var, clamp = batch_norm_forward_plain(x, weight, bias, running_mean, running_var,
                                                   True, momentum, eps, post, residual)
    return y, torch.stack([mean, var, clamp])


def batch_norm_card(x, weight, bias, running_mean, running_var, training, momentum, eps,
                    post, residual):
    """K10's forward on the card, the CUDA implementation of
    ``torch.ops.fiery_torch.batch_norm`` (eval) and ``batch_norm_train``: (y, stats)
    with stats (3, C) f32 as ``batch_norm_train_plain`` returns them in training
    (the running statistics updated in place), None in eval. Two launches in
    training (the statistics with their reduction and the running update, then
    apply), one in eval, each once a channel slice (``channel_slices``)."""
    xp, rp = x.data_ptr(), _ptr(residual)
    M, C, slices, _, form, bf16, post_i, dev = _plan(
        'batch_norm', x, residual, post, (xp | rp) & 15)
    _check_params('batch_norm', dev, (weight, bias, running_mean, running_var))
    y = torch.empty_like(x)
    if training:
        stats = torch.empty((3, C), dtype=torch.float32, device=x.device)
        mean, var, clamp = stats
        partial = _partial(slices, x.device)
    else:
        stats, mean, var, clamp, partial = None, running_mean, running_var, None, None
    fn, es = _fn('fiery_batch_norm_forward'), x.element_size()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    for c0, Cs, V, fold, G, threads, R, blocks in slices:
        o, o4 = c0 * es, c0 * 4
        rc = fn(xp + o, _ptr(residual, o), y.data_ptr() + o, mean.data_ptr() + o4,
                var.data_ptr() + o4, _ptr(clamp, o4), running_mean.data_ptr() + o4,
                running_var.data_ptr() + o4, weight.data_ptr() + o4, bias.data_ptr() + o4,
                _ptr(partial), M, Cs, V, fold, G, threads, R, blocks, eps, momentum,
                int(training), post_i, bf16, stream, C)
        if rc != 0:
            raise RuntimeError(f'batch_norm kernel launch failed: CUDA error {rc}')
    if M:
        batch_norm_forward.launches += (2 if training else 1) * len(slices)
    batch_norm_forward.forms[form] += 1
    return y, stats


def gather_sums(local, group):
    """(world, n) f64: every rank's (n,) vector ``local`` in rank order, gathered
    over ``group`` (``all_gather_into_tensor`` on NCCL, ``all_gather`` on gloo). No
    host synchronisation on NCCL."""
    world = dist.get_world_size(group)
    if dist.get_backend(group) == 'nccl':
        out = local.new_empty((world, local.numel()))
        dist.all_gather_into_tensor(out, local, group=group)
        return out
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=group)
    return torch.stack(parts)


def _check_gathered(name, gathered, C, dev):
    if (gathered.dtype != torch.float64 or gathered.dim() != 2
            or gathered.shape[1] != 2 * C + 1 or gathered.get_device() != dev
            or not gathered.is_contiguous()):
        raise ValueError(f'{name}: the gathered sums must be a contiguous (world, {2 * C + 1}) '
                         f'float64 tensor on cuda:{dev}, got {gathered.dtype} '
                         f'{tuple(gathered.shape)} on {gathered.device}')


def batch_norm_partials_card(x, residual, post):
    """The synchronised forward's reduction on the card: the rank's (2 C + 1) f64
    vector (S1, S2 per channel, the row count), one launch a channel slice. x is
    tiled as the fused training forward of (x, residual, post) tiles it (the same
    plan, so the same blocks and the same f64 partials)."""
    xp, rp = x.data_ptr(), _ptr(residual)
    M, C, slices, _, _, bf16, _, dev = _plan('batch_norm', x, residual, post, (xp | rp) & 15)
    sums = torch.empty(2 * C + 1, dtype=torch.float64, device=x.device)
    if M == 0:
        return sums.zero_()
    partial = _partial(slices, x.device)
    fn, es, sp = _fn('fiery_batch_norm_partials'), x.element_size(), sums.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    for c0, Cs, V, fold, G, threads, R, blocks in slices:
        rc = fn(xp + c0 * es, sp + 8 * c0, C, sp + 8 * 2 * C, partial.data_ptr(), M, Cs, V,
                fold, G, threads, R, blocks, bf16, stream, C)
        if rc != 0:
            raise RuntimeError(f'batch_norm_partials kernel launch failed: CUDA error {rc}')
    batch_norm_partials_card.launches += len(slices)
    return sums


batch_norm_partials_card.launches = 0


def batch_norm_finalize_card(gathered, running_mean, running_var, momentum):
    """The synchronised forward's finalize on the card: (3, C) f32 mean, var, clamp
    from the (world, 2 C + 1) gather, the running statistics updated in place; one
    launch."""
    C, dev = running_mean.numel(), running_mean.get_device()
    _check_gathered('batch_norm_finalize', gathered, C, dev)
    _check_params('batch_norm_finalize', dev, (running_mean, running_var))
    stats = torch.empty((3, C), dtype=torch.float32, device=gathered.device)
    rc = _fn('fiery_batch_norm_finalize')(
        gathered.data_ptr(), gathered.shape[0], C, stats[0].data_ptr(), stats[1].data_ptr(),
        stats[2].data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), momentum,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f'batch_norm_finalize kernel launch failed: CUDA error {rc}')
    batch_norm_finalize_card.launches += 1
    return stats


batch_norm_finalize_card.launches = 0


def batch_norm_sync_forward(x, weight, bias, running_mean, running_var, momentum, eps, post,
                            residual, group):
    """K10's training forward with the statistics taken over the ranks of ``group``:
    (y, mean, var, clamp), the running statistics updated in place. The rank's sums
    (``batch_norm_partials_card``), their gather (``gather_sums``), the finalize
    (``batch_norm_finalize_card``), then the apply pass (the eval operator on the
    batch statistics). CPU tensors take the plain versions."""
    if x.device.type == 'cpu':
        local = batch_norm_partials_plain(x)
        stats = batch_norm_finalize_plain(gather_sums(local, group), running_mean, running_var,
                                          momentum)
    else:
        local = batch_norm_partials_card(x, residual, post)
        stats = batch_norm_finalize_card(gather_sums(local, group), running_mean, running_var,
                                         momentum)
    mean, var, clamp = stats
    y = torch.ops.fiery_torch.batch_norm(x, weight, bias, mean, var, eps, post, residual)
    return y, mean, var, clamp


def batch_norm_forward(x, weight, bias, running_mean, running_var, training, momentum, eps,
                       post='none', residual=None):
    """K10's forward: (y, mean, var, clamp) as ``batch_norm_forward_plain`` returns
    them, without autograd, through ``torch.ops.fiery_torch.batch_norm`` in eval and
    ``batch_norm_train`` in training (ops/library.py). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels (``batch_norm_card``)."""
    if not training:
        y = torch.ops.fiery_torch.batch_norm(x, weight, bias, running_mean, running_var, eps,
                                             post, residual)
        return y, running_mean, running_var, None
    y, stats = torch.ops.fiery_torch.batch_norm_train(x, weight, bias, running_mean,
                                                      running_var, momentum, eps, post,
                                                      residual)
    mean, var, clamp = stats
    return y, mean, var, clamp


batch_norm_forward.launches = 0   # kernel launches (a slice: 2 a training call, 1 an eval call)
batch_norm_forward.plain_calls = 0     # calls that took the plain version (CPU tensors)
batch_norm_forward.forms = {'4d': 0, '5d': 0}    # the card calls by layout


def _forward(x, weight, bias, running_mean, running_var, training, momentum, eps, post,
             residual, group):
    if training and group is not None:
        return batch_norm_sync_forward(x, weight, bias, running_mean, running_var, momentum,
                                       eps, post, residual, group)
    return batch_norm_forward(x, weight, bias, running_mean, running_var, training, momentum,
                              eps, post, residual)


class _BatchNormFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var, training,
                momentum, eps, post, group):
        y, mean, var, clamp = _forward(x, weight, bias, running_mean, running_var, training,
                                       momentum, eps, post, residual, group)
        ctx.save_for_backward(x, weight, bias, mean, var, clamp,
                              residual if post == 'add_relu' else None)
        ctx.training, ctx.eps, ctx.post = training, eps, post
        ctx.group = group if training else None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, var, clamp, residual = ctx.saved_tensors
        if ctx.group is not None:
            dx, dweight, dbias, dres = batch_norm_backward_sync(
                dy, x, weight, bias, mean, var, clamp, ctx.eps, ctx.post, residual, ctx.group)
        else:
            dx, dweight, dbias, dres = batch_norm_backward(
                dy, x, weight, bias, mean, var, clamp, ctx.eps, ctx.post, residual,
                ctx.training)
        if ctx.post in ('add', 'relu_add'):
            dres = dy
        return dx, dweight, dbias, dres, None, None, None, None, None, None, None


def batch_norm(x, weight, bias, running_mean, running_var, training, momentum, eps,
               post='none', residual=None, group=None):
    """BatchNorm over dim 1 of x (4-D or 5-D, float32 or bfloat16) with the
    epilogue ``post`` (kernel K10, csrc/batch_norm.cu), differentiable in x,
    weight, bias and residual. weight, bias and the running statistics are f32
    (C,); in training the running statistics are updated in place with factor
    ``momentum``, and with a process ``group`` the statistics (and the backward's
    sums) are taken over its ranks (the module docstring). Returns y, same shape,
    dtype and layout as x."""
    if post not in POSTS:
        raise ValueError(f'Invalid BN epilogue {post}')
    if (residual is not None) != (post in RESIDUAL_POSTS):
        raise ValueError(f'post {post!r} and residual {type(residual).__name__} disagree')
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, residual))):
        # no graph to record (serving, calibration): the kernel without autograd
        return _forward(x, weight, bias, running_mean, running_var, training, momentum, eps,
                        post, residual, group)[0]
    return _BatchNormFn.apply(x, weight, bias, residual, running_mean, running_var,
                              training, momentum, eps, post, group)


def batch_norm_backward(dy, x, weight, bias, mean, var, clamp, eps, post, residual,
                        training):
    """Gradient of ``batch_norm`` (kernel K10 backward): (dx, dweight, dbias,
    dresidual), dresidual for add_relu only. mean and var are the statistics the
    forward normalised with; clamp (training only) the clamp's derivative. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernels, which read
    dy in x's row order at any row stride (``row_stride``); a dy in another layout
    is copied to x's first, and counted by its shape in ``grad_copies``."""
    if dy.device.type == 'cpu':
        batch_norm_backward.plain_calls += 1
        return batch_norm_backward_plain(dy, x, weight, bias, mean, var, clamp, eps, post,
                                         residual, training)
    plan, dy, dy_rs = _backward_plan(dy, x, residual, post, (weight, bias, mean, var))
    M, C, slices, _, form, bf16, post_i, dev = plan
    xp, dyp = x.data_ptr(), dy.data_ptr()
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if post == 'add_relu' else None
    # (4, slice's C) of f32 out a slice: dweight, dbias and the two dx coefficients
    dparams = torch.empty(4 * C, dtype=torch.float32, device=x.device)
    partial = _partial(slices, x.device)
    fn, es = _fn('fiery_batch_norm_backward'), x.element_size()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    for c0, Cs, V, fold, G, threads, R, blocks in slices:
        o, o4 = c0 * es, c0 * 4
        rc = fn(dyp + o, dy_rs, xp + o, _ptr(residual, o), dx.data_ptr() + o, _ptr(dres, o),
                mean.data_ptr() + o4, var.data_ptr() + o4, _ptr(clamp, o4),
                weight.data_ptr() + o4, bias.data_ptr() + o4, dparams.data_ptr() + 4 * o4,
                partial.data_ptr(), M, Cs, V, fold, G, threads, R, blocks, eps,
                int(training), POSTS.index(post), bf16, stream, C)
        if rc != 0:
            raise RuntimeError(f'batch_norm_backward kernel launch failed: CUDA error {rc}')
    parts = [dparams[4 * c0:4 * (c0 + Cs)].view(4, Cs) for c0, Cs, *_ in slices]
    if len(parts) == 1:
        dweight, dbias = parts[0][0], parts[0][1]
    else:
        dweight = torch.cat([p[0] for p in parts])
        dbias = torch.cat([p[1] for p in parts])
    if M:
        batch_norm_backward.launches += 2 * len(slices)
    return dx, dweight, dbias, dres


batch_norm_backward.launches = 0       # kernel launches (2 a call and slice: reduce, apply)
batch_norm_backward.plain_calls = 0
batch_norm_backward.grad_copies = Counter()


def _backward_plan(dy, x, residual, post, params):
    """(the backward's plan, dy, dy's row stride): dy copied to x's layout (and
    counted in ``batch_norm_backward.grad_copies``) when the kernels cannot read it
    in place."""
    xp, rp, dyp = x.data_ptr(), _ptr(residual), dy.data_ptr()
    plan = _plan('batch_norm_backward', x, residual, 'add_relu' if post == 'add_relu' else 'none',
                 (xp | rp) & 15, dy, dyp & 15)
    _check_params('batch_norm_backward', plan[-1], params)
    dy_rs = plan[3]
    if dy_rs is None:
        dy = dy.to(x.dtype).contiguous(
            memory_format=torch.channels_last if x.dim() == 4 else torch.channels_last_3d)
        batch_norm_backward.grad_copies[tuple(x.shape)] += 1
        dy_rs = plan[1]
    return plan, dy, dy_rs


def batch_norm_backward_partials_card(plan, dy, dy_rs, x, weight, bias, mean, var, eps,
                                      post, residual):
    """The synchronised backward's reduction on the card: (the rank's (2 C + 1) f64
    vector (S_dz, S_dzx per channel, the row count), dresidual for add_relu), one
    launch a channel slice, on the fused backward's plan (``_backward_plan``)."""
    M, C, slices, _, _, bf16, _, dev = plan
    xp, dyp, es = x.data_ptr(), dy.data_ptr(), x.element_size()
    dres = torch.empty_like(x) if post == 'add_relu' else None
    sums = torch.empty(2 * C + 1, dtype=torch.float64, device=x.device)
    if M == 0:
        return sums.zero_(), dres
    partial = _partial(slices, x.device)
    fn, sp = _fn('fiery_batch_norm_backward_partials'), sums.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    for c0, Cs, V, fold, G, threads, R, blocks in slices:
        o, o4 = c0 * es, c0 * 4
        rc = fn(dyp + o, dy_rs, xp + o, _ptr(residual, o), _ptr(dres, o), mean.data_ptr() + o4,
                var.data_ptr() + o4, weight.data_ptr() + o4, bias.data_ptr() + o4,
                sp + 8 * c0, C, sp + 8 * 2 * C, partial.data_ptr(), M, Cs, V, fold, G, threads,
                R, blocks, eps, POSTS.index(post), bf16, stream, C)
        if rc != 0:
            raise RuntimeError(f'batch_norm_backward_partials kernel launch failed: '
                               f'CUDA error {rc}')
    batch_norm_backward_partials_card.launches += len(slices)
    return sums, dres


batch_norm_backward_partials_card.launches = 0


def batch_norm_backward_finalize_card(gathered, rank, clamp):
    """The synchronised backward's finalize on the card: (4, C) f32, dweight and
    dbias of rank ``rank``'s own sums and the two dx coefficients of the sums over
    the ranks; one launch."""
    C, dev = clamp.numel(), clamp.get_device()
    _check_gathered('batch_norm_backward_finalize', gathered, C, dev)
    _check_params('batch_norm_backward_finalize', dev, (clamp,))
    dparams = torch.empty((4, C), dtype=torch.float32, device=clamp.device)
    rc = _fn('fiery_batch_norm_backward_finalize')(
        gathered.data_ptr(), gathered.shape[0], rank, C, clamp.data_ptr(), dparams.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f'batch_norm_backward_finalize kernel launch failed: CUDA error {rc}')
    batch_norm_backward_finalize_card.launches += 1
    return dparams


batch_norm_backward_finalize_card.launches = 0


def batch_norm_backward_apply_card(plan, dy, dy_rs, x, weight, bias, mean, var, dparams, eps,
                                   post, residual):
    """The synchronised backward's apply pass on the card: dx from the coefficients
    dparams[2], dparams[3] ((4, C) f32), one launch a channel slice."""
    M, C, slices, _, _, bf16, _, dev = plan
    _check_params('batch_norm_backward_apply', dev, (dparams,))
    dx = torch.empty_like(x)
    if M == 0:
        return dx
    xp, dyp, dp, es = x.data_ptr(), dy.data_ptr(), dparams.data_ptr(), x.element_size()
    fn, stream = _fn('fiery_batch_norm_backward_apply'), torch._C._cuda_getCurrentRawStream(dev)
    for c0, Cs, V, fold, G, threads, R, blocks in slices:
        o, o4 = c0 * es, c0 * 4
        rc = fn(dyp + o, dy_rs, xp + o, _ptr(residual, o), dx.data_ptr() + o,
                mean.data_ptr() + o4, var.data_ptr() + o4, weight.data_ptr() + o4,
                bias.data_ptr() + o4, dp + o4, C, M, Cs, V, fold, G, threads, R, blocks, eps,
                POSTS.index(post), bf16, stream, C)
        if rc != 0:
            raise RuntimeError(f'batch_norm_backward_apply kernel launch failed: CUDA error {rc}')
    batch_norm_backward_apply_card.launches += len(slices)
    return dx


batch_norm_backward_apply_card.launches = 0


def batch_norm_backward_sync(dy, x, weight, bias, mean, var, clamp, eps, post, residual,
                             group):
    """Gradient of a synchronised training ``batch_norm`` (the module docstring):
    (dx, dweight, dbias, dresidual), dresidual for add_relu only. The rank's sums of
    dz and dz xhat (``batch_norm_backward_partials_card``), their gather over
    ``group``, the finalize (``batch_norm_backward_finalize_card``: dweight and dbias
    of the rank's own sums, the dx coefficients of the global ones) and the apply
    pass (``batch_norm_backward_apply_card``). CPU tensors take the plain versions."""
    rank = dist.get_rank(group)
    if dy.device.type == 'cpu':
        batch_norm_backward.plain_calls += 1
        local, dres = batch_norm_backward_partials_plain(dy, x, weight, bias, mean, var, eps,
                                                         post, residual)
        dparams = batch_norm_backward_finalize_plain(gather_sums(local, group), rank, clamp)
        dx = batch_norm_backward_apply_plain(dy, x, weight, bias, mean, var, dparams, eps,
                                             post, residual)
        return dx, dparams[0], dparams[1], dres
    plan, dy, dy_rs = _backward_plan(dy, x, residual, post, (weight, bias, mean, var))
    local, dres = batch_norm_backward_partials_card(plan, dy, dy_rs, x, weight, bias, mean, var,
                                                    eps, post, residual)
    dparams = batch_norm_backward_finalize_card(gather_sums(local, group), rank, clamp)
    dx = batch_norm_backward_apply_card(plan, dy, dy_rs, x, weight, bias, mean, var, dparams,
                                        eps, post, residual)
    return dx, dparams[0], dparams[1], dres
