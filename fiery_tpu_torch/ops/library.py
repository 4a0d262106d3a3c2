"""The kernels of the served forward as PyTorch operators, ``torch.ops.fiery_torch``.

    bev_pool(depth, feat, ids, num_bins, z_bins) -> out              K1 forward
    topk_select(depth, ids, k) -> (top_w, ids_k, idx)                K5
    bev_warp(x, pose, extent_x, extent_y) -> out                     K2 forward
    batch_norm(x, weight, bias, running_mean, running_var, eps, post, residual?) -> y
                                                                     K10, eval
    batch_norm_train(x, weight, bias, running_mean!, running_var!, momentum, eps,
                     post, residual?) -> (y, stats (3, C))           K10, training
    gru_reset_concat(x_t, r_pre, h) -> cat                           K11, first launch
    gru_state_update(u_pre, h, h_tilde, out!, t) -> ()               K11, second launch

(``!``: written in place.) Each operator has two implementations: on CUDA tensors
the wrapper of ops/*.py that launches the hand-written kernel on
``torch.cuda.current_stream()`` (``*_card``), on CPU tensors the kernel's plain
version. No other device has one (no default or composite implementation), so a
tensor elsewhere raises; 'meta' and fake tensors take the shape functions below,
which give each output the shape, dtype and strides of both implementations'.
The operators have no autograd formula: the ``autograd.Function``s of ops/*.py
call them in their forward and keep their backward kernels, and the Python
wrappers (``bev_pool``, ``topk_select``, ``bev_warp``, ``batch_norm``,
``gru_reset_concat``, ``gru_state_update``) call them, with their checks, in
place of the kernels.

Through them ``torch.export`` keeps the kernels in the program it traces
(export.py): its graph holds ``fiery_torch`` nodes where the wrappers were called,
not their plain versions. Loading such a program (``torch.export.load``,
``export.load_exported``) needs this module imported first, which importing any
``fiery_tpu_torch.ops`` module does (ops/__init__.py), and nothing of
``fiery_tpu_torch.models``.
"""

import torch

from fiery_tpu_torch.ops import batch_norm as _bn
from fiery_tpu_torch.ops import lift_splat as _splat
from fiery_tpu_torch.ops import spatial_gru as _gru
from fiery_tpu_torch.ops import warp as _warp

NAMESPACE = 'fiery_torch'
_LIB = torch.library.Library(NAMESPACE, 'DEF')


def _register(schema, cpu, cuda, fake):
    name = schema.split('(', 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, _below_autograd(cpu), 'CPU')
    _LIB.impl(name, cuda, 'CUDA')
    torch.library.register_fake(f'{NAMESPACE}::{name}', fake, lib=_LIB)


def _below_autograd(plain):
    """The plain version as a backend kernel: its PyTorch ops record no autograd
    graph, as a kernel's launch records none."""
    def kernel(*args):
        with torch.no_grad():
            return plain(*args)
    return kernel


def _strided_as(like, y):
    """y in the strides ``torch.empty_like(like)`` has: the CUDA implementations'
    layout, which the shape functions promise."""
    out = torch.empty_like(like)
    return y if y.stride() == out.stride() else out.copy_(y)


# ---- K1 forward ----

def _bev_pool_fake(depth, feat, ids, num_bins, z_bins):
    return depth.new_empty((depth.shape[0], num_bins // z_bins, feat.shape[-1]))


_register('bev_pool(Tensor depth, Tensor feat, Tensor ids, int num_bins, int z_bins) -> Tensor',
          _splat.bev_pool_plain, _splat.bev_pool_card, _bev_pool_fake)


# ---- K5 ----

def _topk_select_cpu(depth, ids, k):
    return tuple(t.contiguous() for t in _splat.topk_select_plain(depth, ids, k))


def _topk_select_fake(depth, ids, k):
    shape = depth.shape[:-1] + (k,)
    return (depth.new_empty(shape), depth.new_empty(shape, dtype=torch.int32),
            depth.new_empty(shape, dtype=torch.uint8))


_register('topk_select(Tensor depth, Tensor ids, int k) -> (Tensor, Tensor, Tensor)',
          _topk_select_cpu, _splat.topk_select_card, _topk_select_fake)


# ---- K2 forward ----

def _bev_warp_cpu(x, pose, extent_x, extent_y):
    return _warp.bev_warp_plain(x, pose, (extent_x, extent_y)).contiguous()


def _bev_warp_fake(x, pose, extent_x, extent_y):
    return x.new_empty(x.shape)


_register('bev_warp(Tensor x, Tensor pose, float extent_x, float extent_y) -> Tensor',
          _bev_warp_cpu, _warp.bev_warp_card, _bev_warp_fake)


# ---- K10 ----

def _batch_norm_cpu(x, weight, bias, running_mean, running_var, eps, post, residual):
    _bn.batch_norm_forward.plain_calls += 1
    return _strided_as(x, _bn.batch_norm_plain(x, weight, bias, running_mean, running_var,
                                               eps, post, residual))


def _batch_norm_cuda(x, weight, bias, running_mean, running_var, eps, post, residual):
    return _bn.batch_norm_card(x, weight, bias, running_mean, running_var, False, 0.0, eps,
                               post, residual)[0]


def _batch_norm_fake(x, weight, bias, running_mean, running_var, eps, post, residual):
    return torch.empty_like(x)


_register('batch_norm(Tensor x, Tensor weight, Tensor bias, Tensor running_mean, '
          'Tensor running_var, float eps, str post, Tensor? residual) -> Tensor',
          _batch_norm_cpu, _batch_norm_cuda, _batch_norm_fake)


def _batch_norm_train_cpu(x, weight, bias, running_mean, running_var, momentum, eps, post,
                          residual):
    _bn.batch_norm_forward.plain_calls += 1
    y, stats = _bn.batch_norm_train_plain(x, weight, bias, running_mean, running_var,
                                          momentum, eps, post, residual)
    return _strided_as(x, y), stats


def _batch_norm_train_cuda(x, weight, bias, running_mean, running_var, momentum, eps, post,
                           residual):
    return _bn.batch_norm_card(x, weight, bias, running_mean, running_var, True, momentum,
                               eps, post, residual)


def _batch_norm_train_fake(x, weight, bias, running_mean, running_var, momentum, eps, post,
                           residual):
    return torch.empty_like(x), x.new_empty((3, x.shape[1]), dtype=torch.float32)


_register('batch_norm_train(Tensor x, Tensor weight, Tensor bias, Tensor(a!) running_mean, '
          'Tensor(b!) running_var, float momentum, float eps, str post, Tensor? residual) '
          '-> (Tensor, Tensor)',
          _batch_norm_train_cpu, _batch_norm_train_cuda, _batch_norm_train_fake)


# ---- K11 forward ----

def _gru_rows(x_t, h):
    B, C, H, W = h.shape
    return _gru._empty_rows(B, x_t.shape[1] + C, H, W, h)


def _gru_reset_concat_cpu(x_t, r_pre, h):
    _gru.spatial_gru.plain_calls += 1
    return _gru_rows(x_t, h).copy_(_gru.reset_concat_plain(x_t, r_pre, h))


def _gru_reset_concat_fake(x_t, r_pre, h):
    return _gru_rows(x_t, h)


_register('gru_reset_concat(Tensor x_t, Tensor r_pre, Tensor h) -> Tensor',
          _gru_reset_concat_cpu, _gru.reset_concat_card, _gru_reset_concat_fake)


def _gru_state_update_cpu(u_pre, h, h_tilde, out, t):
    _gru.spatial_gru.plain_calls += 1
    out[:, t].copy_(_gru.state_update_plain(u_pre, h, h_tilde))


def _gru_state_update_fake(u_pre, h, h_tilde, out, t):
    return None


_register('gru_state_update(Tensor u_pre, Tensor h, Tensor h_tilde, Tensor(a!) out, int t) '
          '-> ()', _gru_state_update_cpu, _gru.state_update_card, _gru_state_update_fake)
