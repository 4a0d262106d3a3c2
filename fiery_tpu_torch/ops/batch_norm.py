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
A CPU tensor takes the plain versions; a CUDA tensor launches the kernels.
"""

import ctypes
from collections import Counter

import torch

from fiery_tpu_torch.ops import _build

POSTS = ('none', 'relu', 'swish', 'add', 'add_relu', 'relu_add')
RESIDUAL_POSTS = ('add', 'add_relu', 'relu_add')
MAX_CHANNELS = 1024       # the kernels hold a row group of <= 1024 lanes in one block


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
    mul = weight * (1.0 / torch.sqrt(var + eps))
    mu, mul, b = (_per_channel(v.to(x.dtype), x) for v in (mean, mul, bias))
    return (x - mu) * mul + b


def batch_stats_plain(x):
    """(mean, var, clamp) per channel, f32: the f64 sums of x and x^2 over every
    dimension but 1, each divided by the row count and rounded to f32; var =
    max(E[x^2] - mean^2, 0) in f32; clamp the clamp's derivative (1, 1/2 or 0)."""
    dims = _reduce_dims(x)
    rows = x.numel() // x.shape[1]
    xd = x.double()
    mean = (xd.sum(dims) / rows).float()
    mean2 = ((xd * xd).sum(dims) / rows).float()
    raw = mean2 - mean * mean
    clamp = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0)).float()
    return mean, torch.clamp_min(raw, 0.0), clamp


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


def batch_norm_backward_plain(dy, x, weight, bias, mean, var, clamp, eps, post,
                              residual, training):
    """Plain version of K10's backward: (dx, dweight, dbias, dresidual); dresidual
    is computed for add_relu only (None otherwise: add and relu_add pass dy)."""
    dims = _reduce_dims(x)
    rows = x.numel() // x.shape[1]
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
    rstd = 1.0 / torch.sqrt(var + eps)
    xhat = (x.float() - _per_channel(mean, x)) * _per_channel(rstd, x)
    sum_dz = dz.double().sum(dims)
    sum_dz_xhat = (dz.double() * xhat.double()).sum(dims)
    mul = _per_channel(weight * rstd, x)
    if training:
        a = _per_channel((sum_dz / rows).float(), x)
        b = _per_channel(clamp * (sum_dz_xhat / rows).float(), x)
        dx = mul * ((dz - a) - xhat * b)
    else:
        dx = mul * dz
    return dx.to(x.dtype), sum_dz_xhat.float(), sum_dz.float(), dres


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


def _tiling(x):
    """(rows M, channels C, rows per group G, blocks): a block's lanes are G whole
    rows (G C <= 1024 lanes, one per thread), so each thread keeps one channel; the
    grid is enough blocks to fill the card, each walking its row groups in a
    fixed order."""
    C = x.shape[1]
    M = x.numel() // C
    G = max(1, 256 // C)
    threads = (G * C + 31) // 32 * 32
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    groups = (M + G - 1) // G
    return M, C, G, max(1, min(groups, sms * max(1, 2048 // threads)))


def _check_card(name, x, residual, post):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name}: x must be float32 or bfloat16, got {x.dtype}')
    if x.shape[1] > MAX_CHANNELS:
        raise ValueError(f'{name}: {x.shape[1]} channels; the kernel takes at most '
                         f'{MAX_CHANNELS}')
    if rows_form(x) is None:
        raise ValueError(f'{name}: x {tuple(x.shape)} strides {x.stride()} is not a 4-D '
                         f'channels_last or 5-D channels_last_3d tensor')
    if post in RESIDUAL_POSTS:
        if (residual is None or residual.shape != x.shape or residual.dtype != x.dtype
                or rows_form(residual) != rows_form(x) or residual.device != x.device):
            raise ValueError(f'{name}: post {post!r} needs a residual of x\'s shape, '
                             f'dtype and layout')


_PLANS = {}


def _plan(name, x, residual, post):
    """The launch plan of x's shape, strides, dtype and card (and the residual's)
    under ``post``, checked and tiled at its first call: (M, C, G, blocks, form,
    is_bf16, post index, card index). Every later call of that key reuses it, so a
    call's host work is a dictionary lookup, the parameters' checks and the
    launch."""
    dev = x.get_device()
    key = (name, x.shape, x.stride(), x.dtype, dev, post, None if residual is None else
           (residual.shape, residual.stride(), residual.dtype, residual.get_device()))
    plan = _PLANS.get(key)
    if plan is None:
        _check_card(name, x, residual, post)
        plan = _PLANS[key] = (*_tiling(x), rows_form(x), int(x.dtype == torch.bfloat16),
                              POSTS.index(post), dev)
    return plan


def _check_params(name, dev, params):
    for p in params:
        if p.dtype is not torch.float32 or p.get_device() != dev or not p.is_contiguous():
            raise ValueError(f'{name}: weight, bias and statistics must be contiguous '
                             f'float32 on cuda:{dev}')


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    'fiery_batch_norm_forward': [_P] * 11 + [_LL] + [_I] * 3 + [_F] * 2 + [_I] * 3 + [_P],
    'fiery_batch_norm_backward': [_P, _LL] + [_P] * 11 + [_LL] + [_I] * 3 + [_F] + [_I] * 3
                                 + [_P],
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


def _ptr(t):
    return 0 if t is None else t.data_ptr()


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


def batch_norm_forward(x, weight, bias, running_mean, running_var, training, momentum, eps,
                       post='none', residual=None):
    """K10's forward (csrc/batch_norm.cu): (y, mean, var, clamp) as
    ``batch_norm_forward_plain`` returns them, without autograd. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernels (three in training:
    statistics, their reduction with the running update, apply; one in eval)."""
    if x.device.type == 'cpu':
        batch_norm_forward.plain_calls += 1
        return batch_norm_forward_plain(x, weight, bias, running_mean, running_var, training,
                                        momentum, eps, post, residual)
    M, C, G, blocks, form, bf16, post_i, dev = _plan('batch_norm', x, residual, post)
    _check_params('batch_norm', dev, (weight, bias, running_mean, running_var))
    y = torch.empty_like(x)
    if training:
        stats = torch.empty((3, C), dtype=torch.float32, device=x.device)
        mean, var, clamp = stats
        partial = torch.empty((blocks, 2, C), dtype=torch.float64, device=x.device)
    else:
        mean, var, clamp, partial = running_mean, running_var, None, None
    rc = _fn('fiery_batch_norm_forward')(
        x.data_ptr(), _ptr(residual), y.data_ptr(), mean.data_ptr(), var.data_ptr(),
        _ptr(clamp), running_mean.data_ptr(), running_var.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), _ptr(partial), M, C, G, blocks, eps, momentum, int(training),
        post_i, bf16, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f'batch_norm kernel launch failed: CUDA error {rc}')
    if M:
        batch_norm_forward.launches += 3 if training else 1
    batch_norm_forward.forms[form] += 1
    return y, mean, var, clamp


batch_norm_forward.launches = 0        # kernel launches (3 a training call, 1 an eval call)
batch_norm_forward.plain_calls = 0     # calls that took the plain version (CPU tensors)
batch_norm_forward.forms = {'4d': 0, '5d': 0}    # the card calls by layout


class _BatchNormFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var, training,
                momentum, eps, post):
        y, mean, var, clamp = batch_norm_forward(x, weight, bias, running_mean, running_var,
                                                 training, momentum, eps, post, residual)
        ctx.save_for_backward(x, weight, bias, mean, var, clamp,
                              residual if post == 'add_relu' else None)
        ctx.training, ctx.eps, ctx.post = training, eps, post
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, var, clamp, residual = ctx.saved_tensors
        dx, dweight, dbias, dres = batch_norm_backward(
            dy, x, weight, bias, mean, var, clamp, ctx.eps, ctx.post, residual,
            ctx.training)
        if ctx.post in ('add', 'relu_add'):
            dres = dy
        return dx, dweight, dbias, dres, None, None, None, None, None, None


def batch_norm(x, weight, bias, running_mean, running_var, training, momentum, eps,
               post='none', residual=None):
    """BatchNorm over dim 1 of x (4-D or 5-D, float32 or bfloat16) with the
    epilogue ``post`` (kernel K10, csrc/batch_norm.cu), differentiable in x,
    weight, bias and residual. weight, bias and the running statistics are f32
    (C,); in training the running statistics are updated in place with factor
    ``momentum``. Returns y, same shape, dtype and layout as x."""
    if post not in POSTS:
        raise ValueError(f'Invalid BN epilogue {post}')
    if (residual is not None) != (post in RESIDUAL_POSTS):
        raise ValueError(f'post {post!r} and residual {type(residual).__name__} disagree')
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, residual))):
        # no graph to record (serving, calibration): the kernel without autograd
        return batch_norm_forward(x, weight, bias, running_mean, running_var, training,
                                  momentum, eps, post, residual)[0]
    return _BatchNormFn.apply(x, weight, bias, residual, running_mean, running_var,
                              training, momentum, eps, post)


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
    M, C, G, blocks, form, bf16, post_i, dev = _plan(
        'batch_norm_backward', x, residual, 'add_relu' if post == 'add_relu' else 'none')
    _check_params('batch_norm_backward', dev, (weight, bias, mean, var))
    dy_rs = row_stride(dy) if dy.dtype == x.dtype else None
    if dy_rs is None:
        dy = dy.to(x.dtype).contiguous(
            memory_format=torch.channels_last if x.dim() == 4 else torch.channels_last_3d)
        batch_norm_backward.grad_copies[tuple(x.shape)] += 1
        dy_rs = x.shape[1]
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if post == 'add_relu' else None
    dparams = torch.empty((4, C), dtype=torch.float32, device=x.device)
    dweight, dbias = dparams[0], dparams[1]
    partial = torch.empty((blocks, 2, C), dtype=torch.float64, device=x.device)
    rc = _fn('fiery_batch_norm_backward')(
        dy.data_ptr(), dy_rs, x.data_ptr(), _ptr(residual), dx.data_ptr(), _ptr(dres),
        mean.data_ptr(), var.data_ptr(), _ptr(clamp), weight.data_ptr(), bias.data_ptr(),
        dparams.data_ptr(), partial.data_ptr(), M, C, G, blocks, eps, int(training),
        POSTS.index(post), bf16, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f'batch_norm_backward kernel launch failed: CUDA error {rc}')
    if M:
        batch_norm_backward.launches += 3
    return dx, dweight, dbias, dres


batch_norm_backward.launches = 0       # kernel launches (3 a call: reduce, finalize, apply)
batch_norm_backward.plain_calls = 0
batch_norm_backward.grad_copies = Counter()
