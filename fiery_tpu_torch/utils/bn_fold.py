"""Eval BatchNorm folded into the convolution before it (counterpart of
fiery_tpu/utils/bn_fold.py ``fold_batchnorm``).

At eval a BatchNorm with running statistics is an affine map per channel, so it
folds exactly into the convolution that produces its input:

    BN(conv(x)) = conv'(x) + add,   conv' = conv with its weight (and bias) * mul,
    mul = scale * 1 / sqrt(var + eps),   add = bias - mean * mul

``fold_batchnorm`` rewrites each paired convolution and resets its BatchNorm to
weight 1, bias ``add``, running mean 0 and running variance 1 - eps, with the
arithmetic of the JAX package's numpy in the same order, so that both folds give
the same f32 bits. The folded model keeps its BatchNorm modules: kernel K10
(ops/batch_norm.py) then computes mul = 1 * (1 / sqrt((1 - eps) + eps)), which is
exactly 1.0 in f32 for eps = 1e-3 and 1e-5, and mean 0, so a folded BatchNorm is
exactly its bias add and its epilogue (ReLU, swish, the residual add).

Each BatchNorm's epsilon is the module's own (1e-3 in the EfficientNet backbone,
1e-5 elsewhere). A BatchNorm pairs with the nearest convolution registered before
it whose output channels match and that no other BatchNorm took: the port keeps
the reference's module order, in which each BatchNorm follows the convolution it
normalises (a ConvTranspose keeps its output channels in dim 1 of its weight).

Fold the f32 weights, before a cast to bf16 (``serve.build_fiery(...,
state_dict=..., fold_bn=True)``): the JAX package multiplies the f32 kernel and
rounds once, and folding bf16 weights would round twice.
"""

import torch
import torch.nn as nn

from fiery_tpu_torch.models.fiery import Fiery
from fiery_tpu_torch.utils.rounding import sqrt_rn
from fiery_tpu_torch.utils.weight_import import build_mapping


def bn_conv_pairs(model):
    """([(conv name, BatchNorm name)], [names of BatchNorms with no conv]) over
    ``model.named_modules()``."""
    pairs, unpaired, open_convs = [], [], []
    for name, m in model.named_modules():
        if isinstance(m, nn.modules.conv._ConvNd):
            open_convs.append((name, m))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            for i in range(len(open_convs) - 1, -1, -1):
                if open_convs[i][1].out_channels == m.num_features:
                    pairs.append((open_convs.pop(i)[0], name))
                    break
            else:
                unpaired.append(name)
    return pairs, unpaired


def _jax_batchnorm_of(model):
    """{BatchNorm name: the JAX BatchNorm it is a part of} for the BatchNorms that
    the JAX package fuses into one (each temporal block's three prologs, the
    decoder's heads), from the weight table."""
    if not isinstance(model, Fiery):
        return {}
    return {name[len('model.'):-len('.weight')]: path
            for path, names, _, _ in build_mapping(model.cfg)
            if isinstance(names, tuple) and path[-1] == 'scale' for name in names}


def _f32(state_dict, key):
    v = state_dict[key]
    if v.dtype != torch.float32:
        raise TypeError(f'fold_batchnorm folds f32 weights (before the bf16 cast); '
                        f'{key} is {v.dtype}')
    return v


def fold_batchnorm(state_dict, model, strict=True):
    """(folded state_dict, n_folded): every conv -> BatchNorm pair of ``model``
    folded in ``state_dict`` (f32, keyed as ``model.state_dict()``; not modified).

    n_folded counts the JAX package's BatchNorms, so it equals its
    ``fold_batchnorm``'s count for the same config: the port's BatchNorms that one
    fused JAX BatchNorm stands for count once. strict=True raises if a BatchNorm
    has no convolution to pair with."""
    pairs, unpaired = bn_conv_pairs(model)
    if unpaired and strict:
        raise ValueError(f'Unfoldable BatchNorms: {unpaired}')
    modules = dict(model.named_modules())
    out = dict(state_dict)
    for conv_name, bn_name in pairs:
        conv, eps = modules[conv_name], modules[bn_name].eps
        if conv.transposed and conv.groups != 1:
            raise NotImplementedError(f'{conv_name}: a grouped ConvTranspose')
        scale, bias, mean, var = (_f32(state_dict, f'{bn_name}.{k}') for k in
                                  ('weight', 'bias', 'running_mean', 'running_var'))
        # the root correctly rounded, as numpy's (utils/rounding.py)
        mul = scale * 1.0 / sqrt_rn(var + eps)
        add = bias - mean * mul
        weight = _f32(state_dict, f'{conv_name}.weight')
        shape = [1] * weight.dim()
        shape[1 if conv.transposed else 0] = -1
        out[f'{conv_name}.weight'] = weight * mul.view(shape)
        if conv.bias is not None:
            # BN(conv(x) + b) = conv'(x) + b * mul + add
            out[f'{conv_name}.bias'] = _f32(state_dict, f'{conv_name}.bias') * mul
        out[f'{bn_name}.weight'] = torch.ones_like(scale)
        out[f'{bn_name}.bias'] = add
        out[f'{bn_name}.running_mean'] = torch.zeros_like(mean)
        out[f'{bn_name}.running_var'] = torch.full_like(var, 1.0 - eps)
    fused = _jax_batchnorm_of(model)
    return out, len({fused.get(bn, bn) for _, bn in pairs})
