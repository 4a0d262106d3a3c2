"""Weights of the JAX package -> this package's state_dict.

The port's modules carry the reference torch parameter names, the names that
fiery_tpu/utils/weight_import.py maps onto the flax tree. This module keeps its
own copy of that table (built from the model config, so block counts, GRU blocks
and heads stay in sync) and applies it backwards:

  * conv kernels HWIO -> OIHW, 1x1 conv3d (1, 1, C, O) -> (O, C, 1, 1, 1);
  * causal-stacked 2D kernels (kh, kw, kt*C, O) -> Conv3d (O, C, kt, kh, kw);
  * fused entries are split into their equal parts: the temporal block's fused
    1x1x1 prologs, the SpatialGRU's ``conv_gates`` (update, then reset) and the
    decoder's ``heads/conv_fused`` with its BN (the four heads, in order).

Torch names in the table carry the reference's ``model.`` prefix; the returned
state_dict drops it, as this package's ``Fiery`` is the reference's ``model``.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch

from fiery_tpu_torch.models.efficientnet import block_specs, truncation_index

# (jax path, torch name or tuple of names, layout kind, collection)
Entry = Tuple[Tuple[str, ...], object, str, str]


def _bn(jax_prefix, torch_prefix) -> List[Entry]:
    inner = jax_prefix + ('BatchNorm_0',)
    return [(inner + ('scale',), torch_prefix + '.weight', 'id', 'params'),
            (inner + ('bias',), torch_prefix + '.bias', 'id', 'params'),
            (inner + ('mean',), torch_prefix + '.running_mean', 'id', 'batch_stats'),
            (inner + ('var',), torch_prefix + '.running_var', 'id', 'batch_stats')]


def _bn_fused(jax_prefix, torch_prefixes) -> List[Entry]:
    inner = jax_prefix + ('BatchNorm_0',)
    return [(inner + (leaf,), tuple(t + suffix for t in torch_prefixes), 'concat_id', coll)
            for leaf, suffix, coll in [('scale', '.weight', 'params'),
                                       ('bias', '.bias', 'params'),
                                       ('mean', '.running_mean', 'batch_stats'),
                                       ('var', '.running_var', 'batch_stats')]]


def _conv(jax_path, torch_name, bias=False, kind='conv2d') -> List[Entry]:
    out = [(jax_path + ('kernel',), torch_name + '.weight', kind, 'params')]
    if bias:
        out.append((jax_path + ('bias',), torch_name + '.bias', 'id', 'params'))
    return out


def _conv1x1x1_norm_act(jax_prefix, torch_prefix) -> List[Entry]:
    return (_conv(jax_prefix + ('Conv_0',), torch_prefix + '.conv', kind='conv3d_1x1')
            + _bn(jax_prefix + ('BatchNorm_0',), torch_prefix + '.norm'))


def _bottleneck2d(p, t, has_projection) -> List[Entry]:
    out = (_conv(p + ('Conv_0',), t + '.layers.conv_down_project')
           + _bn(p + ('BatchNorm_0',), t + '.layers.abn_down_project.0')
           + _conv(p + ('Conv_1',), t + '.layers.conv')
           + _bn(p + ('BatchNorm_1',), t + '.layers.abn.0')
           + _conv(p + ('Conv_2',), t + '.layers.conv_up_project')
           + _bn(p + ('BatchNorm_2',), t + '.layers.abn_up_project.0'))
    if has_projection:
        out += (_conv(p + ('Conv_3',), t + '.projection.conv_skip_proj')
                + _bn(p + ('BatchNorm_3',), t + '.projection.bn_skip_proj'))
    return out


def encoder_mapping(version='b4', downsample=8) -> List[Entry]:
    entries: List[Entry] = []
    base = ('bev_lift', 'encoder')
    fpn = base + ('EfficientNetFPN_0',)
    tb = 'model.encoder.backbone'
    entries += _conv(fpn + ('Conv_0',), tb + '._conv_stem')
    entries += _bn(fpn + ('BatchNorm_0',), tb + '._bn0')
    specs = block_specs(version)
    for i in range(truncation_index(version, downsample) + 1):
        _, _, expand, _, _, se = specs[i]
        fb = fpn + (f'MBConvBlock_{i}',)
        tblk = f'{tb}._blocks.{i}'
        ci = bi = 0
        if expand != 1:
            entries += _conv(fb + (f'Conv_{ci}',), tblk + '._expand_conv')
            entries += _bn(fb + (f'BatchNorm_{bi}',), tblk + '._bn0')
            ci, bi = ci + 1, bi + 1
        entries += _conv(fb + (f'Conv_{ci}',), tblk + '._depthwise_conv')
        entries += _bn(fb + (f'BatchNorm_{bi}',), tblk + '._bn1')
        ci, bi = ci + 1, bi + 1
        if se:
            entries += _conv(fb + (f'Conv_{ci}',), tblk + '._se_reduce', bias=True)
            entries += _conv(fb + (f'Conv_{ci + 1}',), tblk + '._se_expand', bias=True)
            ci += 2
        entries += _conv(fb + (f'Conv_{ci}',), tblk + '._project_conv')
        entries += _bn(fb + (f'BatchNorm_{bi}',), tblk + '._bn2')
    up = base + ('UpsamplingConcat_0',)
    tu = 'model.encoder.upsampling_layer'
    entries += _conv(up + ('Conv_0',), tu + '.conv.0')
    entries += _bn(up + ('BatchNorm_0',), tu + '.conv.1')
    entries += _conv(up + ('Conv_1',), tu + '.conv.3')
    entries += _bn(up + ('BatchNorm_1',), tu + '.conv.4')
    entries += _conv(base + ('depth_layer',), 'model.encoder.depth_layer', bias=True)
    return entries


def temporal_mapping(receptive_field=3, use_pyramid_pooling=True, in_channels=70,
                     start_out_channels=64) -> List[Entry]:
    entries: List[Entry] = []
    block_in, block_out = in_channels, start_out_channels
    for i in range(receptive_field - 1):
        fb = ('temporal_model', f'TemporalBlock_{i}')
        t = f'model.temporal_model.model.{i}'
        paths = [f'{t}.convolution_paths.0.0', f'{t}.convolution_paths.1.0',
                 f'{t}.convolution_paths.2']
        pf = fb + ('prolog_fused',)
        entries.append((pf + ('Conv_0', 'kernel'), tuple(p + '.conv.weight' for p in paths),
                        'concat_conv3d_1x1', 'params'))
        entries += _bn_fused(pf + ('BatchNorm_0',), [p + '.norm' for p in paths])
        for pi, kt in enumerate([2, 1]):
            entries += (_conv(fb + (f'CausalConv3d_{pi}', 'Conv_0'),
                              f'{t}.convolution_paths.{pi}.1.conv',
                              kind=f'conv3d_causal_kt{kt}')
                        + _bn(fb + (f'CausalConv3d_{pi}', 'BatchNorm_0'),
                              f'{t}.convolution_paths.{pi}.1.norm'))
        if use_pyramid_pooling:
            entries += _conv1x1x1_norm_act(
                fb + ('PyramidSpatioTemporalPooling_0', 'Conv1x1x1NormActivated_0'),
                f'{t}.pyramid_pooling.features.0.conv_bn_relu')
        entries += _conv1x1x1_norm_act(fb + ('Conv1x1x1NormActivated_0',),
                                       f'{t}.aggregation.0')
        if block_out != block_in:
            entries += _conv(fb + ('Conv_0',), f'{t}.projection.0', kind='conv3d_1x1')
            entries += _bn(fb + ('BatchNorm_0',), f'{t}.projection.1')
        block_in = block_out
    return entries


def distribution_mapping(which: str) -> List[Entry]:
    entries: List[Entry] = []
    fb = (f'{which}_distribution',)
    t = f'model.{which}_distribution'
    for i in range(4):
        entries += _bottleneck2d(fb + ('DistributionEncoder_0', f'Bottleneck_{i}'),
                                 f'{t}.encoder.model.{i}', has_projection=True)
    entries += _conv(fb + ('Conv_0',), f'{t}.last_conv.1', bias=True)
    return entries


def future_prediction_mapping(n_gru_blocks=3, n_res_layers=3) -> List[Entry]:
    entries: List[Entry] = []
    for i in range(n_gru_blocks):
        fg = ('future_prediction', f'SpatialGRU_{i}')
        t = f'model.future_prediction.spatial_grus.{i}'
        entries += [
            (fg + ('conv_gates', 'kernel'),
             (t + '.conv_update.weight', t + '.conv_reset.weight'), 'concat_conv2d', 'params'),
            (fg + ('conv_gates', 'bias'),
             (t + '.conv_update.bias', t + '.conv_reset.bias'), 'concat_id', 'params'),
        ]
        entries += (_conv(fg + ('conv_state_tilde', 'Conv_0'), t + '.conv_state_tilde.conv')
                    + _bn(fg + ('conv_state_tilde', 'BatchNorm_0'),
                          t + '.conv_state_tilde.norm'))
        for j in range(n_res_layers):
            entries += _bottleneck2d(
                ('future_prediction', f'Bottleneck_{i * n_res_layers + j}'),
                f'model.future_prediction.res_blocks.{i}.{j}', has_projection=False)
    return entries


def decoder_mapping(predict_future_flow=True) -> List[Entry]:
    entries: List[Entry] = []
    fb = ('decoder',)
    t = 'model.decoder'
    entries += _conv(fb + ('Conv_0',), t + '.first_conv')
    entries += _bn(fb + ('BatchNorm_0',), t + '.bn1')
    layer_specs = [('layer1', 0, False), ('layer1', 1, False),
                   ('layer2', 0, True), ('layer2', 1, False),
                   ('layer3', 0, True), ('layer3', 1, False)]
    for bi, (layer, j, has_down) in enumerate(layer_specs):
        fblk = fb + (f'BasicBlock_{bi}',)
        tblk = f'{t}.{layer}.{j}'
        entries += _conv(fblk + ('Conv_0',), tblk + '.conv1')
        entries += _bn(fblk + ('BatchNorm_0',), tblk + '.bn1')
        entries += _conv(fblk + ('Conv_1',), tblk + '.conv2')
        entries += _bn(fblk + ('BatchNorm_1',), tblk + '.bn2')
        if has_down:
            entries += _conv(fblk + ('Conv_2',), tblk + '.downsample.0')
            entries += _bn(fblk + ('BatchNorm_2',), tblk + '.downsample.1')
    for i, name in enumerate(['up3_skip', 'up2_skip', 'up1_skip']):
        fu = fb + (f'UpsamplingAdd_{i}',)
        entries += _conv(fu + ('Conv_0',), f'{t}.{name}.upsample_layer.1')
        entries += _bn(fu + ('BatchNorm_0',), f'{t}.{name}.upsample_layer.2')
    head_names = ['segmentation_head', 'instance_center_head', 'instance_offset_head']
    if predict_future_flow:
        head_names.append('instance_future_head')
    hf = fb + ('heads',)
    entries.append((hf + ('conv_fused', 'kernel'),
                    tuple(f'{t}.{h}.0.weight' for h in head_names), 'concat_conv2d',
                    'params'))
    entries += _bn_fused(hf + ('BatchNorm_0',), [f'{t}.{h}.1' for h in head_names])
    for i, h in enumerate(head_names):
        entries += _conv(hf + (f'out_{i}',), f'{t}.{h}.3', bias=True)
    return entries


def build_mapping(model_cfg) -> List[Entry]:
    """The full table for a FieryConfig."""
    if model_cfg.inbetween_layers:
        raise NotImplementedError('the weight table covers INBETWEEN_LAYERS = 0 only')
    entries = encoder_mapping(model_cfg.encoder_name.split('-')[1],
                              model_cfg.encoder_downsample)
    if model_cfg.temporal_name == 'temporal_block':
        in_ch = model_cfg.encoder_out_channels + (6 if model_cfg.input_egopose else 0)
        entries += temporal_mapping(model_cfg.receptive_field, model_cfg.pyramid_pooling,
                                    in_ch, model_cfg.start_out_channels)
    if model_cfg.n_future > 0:
        if model_cfg.probabilistic_enabled:
            entries += distribution_mapping('present')
            entries += distribution_mapping('future')
        entries += future_prediction_mapping(model_cfg.n_gru_blocks,
                                             model_cfg.n_res_layers)
    entries += decoder_mapping(model_cfg.instance_flow_enabled)
    return entries


def _to_torch_layout(v, kind):
    """One JAX leaf (numpy) in layout ``kind`` -> the torch tensor layout."""
    if kind == 'id':
        return v
    if kind == 'conv2d':                        # HWIO -> OIHW
        return np.transpose(v, (3, 2, 0, 1))
    if kind == 'conv3d_1x1':                    # (1, 1, C, O) -> (O, C, 1, 1, 1)
        return np.transpose(v, (3, 2, 0, 1))[..., None]
    if kind.startswith('conv3d_causal_kt'):     # (kh, kw, kt*C, O) -> (O, C, kt, kh, kw)
        kt = int(kind[len('conv3d_causal_kt'):])
        kh, kw, ktc, o = v.shape
        return np.transpose(v.reshape(kh, kw, kt, ktc // kt, o), (4, 3, 2, 0, 1))
    raise ValueError(f'unknown layout {kind}')


def state_dict_from_jax(variables_np: Dict, model_cfg) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` (numpy leaves) -> this package's Fiery
    state_dict (torch tensors, ready for ``load_state_dict(strict=True)``)."""
    out = {}
    for path, names, kind, collection in build_mapping(model_cfg):
        leaf = variables_np[collection]
        for key in path:
            leaf = leaf[key]
        leaf = np.asarray(leaf)
        if isinstance(names, tuple):
            base = kind[len('concat_'):]
            parts = np.split(leaf, len(names), axis=0 if base == 'id' else -1)
            pairs = [(n, _to_torch_layout(p, base)) for n, p in zip(names, parts)]
        else:
            pairs = [(names, _to_torch_layout(leaf, kind))]
        for name, value in pairs:
            out[name[len('model.'):]] = torch.tensor(value)
    for name in [k for k in out if k.endswith('.running_mean')]:
        out[name[:-len('running_mean')] + 'num_batches_tracked'] = torch.tensor(0)
    return out


def train_state_from_jax(params_np: Dict, batch_stats_np: Dict, model_cfg):
    """A JAX train state -> (this package's Fiery state_dict, uncertainty weights).

    params_np is the JAX TrainState's ``params`` in numpy: ``{'model': ...,
    'uncertainty': {'segmentation_weight': ..., ...}}``; batch_stats_np its
    ``batch_stats``. The future distribution and the running statistics are in the
    state_dict; the learned task weights, which live outside the model, come back as
    a dict of scalar tensors keyed as the JAX package keys them."""
    state_dict = state_dict_from_jax({'params': params_np['model'],
                                      'batch_stats': batch_stats_np}, model_cfg)
    uncertainty = {k: torch.tensor(np.asarray(v, np.float32))
                   for k, v in params_np['uncertainty'].items()}
    return state_dict, uncertainty


def _adam_state(opt_state):
    """The scale_by_adam entry (count, mu, nu) of an optax chain's state, as a
    tuple of namedtuples or as the dicts and lists a restore gives."""
    if hasattr(opt_state, 'mu') and hasattr(opt_state, 'nu'):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, dict):
        if {'mu', 'nu', 'count'} <= set(opt_state):
            return opt_state['count'], opt_state['mu'], opt_state['nu']
        opt_state = list(opt_state.values())
    if isinstance(opt_state, (list, tuple)):
        for entry in opt_state:
            found = _adam_state(entry)
            if found is not None:
                return found
    return None


def checkpoint_state_from_jax(state_np, trainer):
    """A JAX ``TrainState`` in numpy -> this package's checkpoint state for
    ``trainer`` (``Trainer.load_state``; its ``params`` give the order of the Adam
    state: the model's parameters, then the uncertainty weights).

    state_np: ``{'step', 'params', 'batch_stats', 'opt_state'}`` (the TrainState's
    fields, e.g. ``jax.tree.map(np.asarray, dataclasses.asdict(state))``). The optax
    chain's ``scale_by_adam`` state (mu, nu, count) becomes torch.optim.Adam's
    exp_avg, exp_avg_sq and step for every parameter and uncertainty weight: Adam
    with coupled weight decay keeps the same moments of the same clipped, decayed
    gradients as that chain, so the next port step is the next JAX step."""
    cfg = trainer.model.cfg
    state_dict, uncertainty = train_state_from_jax(state_np['params'],
                                                   state_np['batch_stats'], cfg)
    state = {'model': state_dict, 'uncertainty': uncertainty, 'optimizer': None,
             'step': int(np.asarray(state_np['step']))}
    adam = _adam_state(state_np['opt_state'])
    if adam is None:
        return state
    count, mu, nu = adam
    mu_sd, mu_uw = train_state_from_jax(mu, state_np['batch_stats'], cfg)
    nu_sd, nu_uw = train_state_from_jax(nu, state_np['batch_stats'], cfg)
    moments = [(mu_sd[n], nu_sd[n]) for n, _ in trainer.model.named_parameters()]
    moments += [(mu_uw[k], nu_uw[k]) for k in trainer.uncertainty]
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    state['optimizer'] = {'state': {
        i: {'step': step.clone(), 'exp_avg': m.clone(), 'exp_avg_sq': v.clone()}
        for i, (m, v) in enumerate(moments)}}
    return state
