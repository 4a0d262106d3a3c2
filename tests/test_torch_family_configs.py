"""The JAX package's config families in the port, with no JAX compile (CPU).

Every YAML of the JAX package has its copy under fiery_tpu_torch/configs/, and the
port's ``get_cfg`` and ``FieryConfig.from_cfg`` read it as the JAX package reads
its own; ``_BASE_`` resolves through two levels. For each model family at full
width (and the encoder at downsample 16, and 1 or 2 Bottleneck3Ds between the
temporal blocks), the weight table covers every leaf of the JAX model's variables
(their shapes from ``jax.eval_shape``: nothing is compiled) and
``state_dict_from_jax`` loads strictly. Under MODEL.SUBSAMPLE a request is the
subsampled clip of 3 frames, and the served graph refuses 5.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from fiery_tpu.models.fiery import Fiery as JaxFiery
from fiery_tpu.models.fiery import FieryConfig as JaxFieryConfig
from fiery_tpu_torch.models.fiery import Fiery, FieryConfig
from fiery_tpu_torch.serve import make_request
from fiery_tpu_torch.serve_graph import check_request, request_spec
from fiery_tpu_torch.utils.weight_import import build_mapping, state_dict_from_jax

import torch_family as tf
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


def test_every_jax_yaml_has_its_copy():
    assert len(tf.YAMLS) == 12
    ported = sorted(os.path.relpath(os.path.join(d, f), tf.PORT_CONFIGS)
                    for d, _, files in os.walk(tf.PORT_CONFIGS) for f in files
                    if f.endswith('.yml'))
    assert ported == tf.YAMLS
    for yaml in tf.YAMLS:
        with open(os.path.join(tf.PORT_CONFIGS, yaml)) as a, \
                open(os.path.join(tf.JAX_CONFIGS, yaml)) as b:
            assert a.read() == b.read(), yaml


@pytest.mark.parametrize('yaml', tf.YAMLS)
def test_config_equals_the_jax_config(yaml):
    """Key for key, and the FieryConfig field for field (the JAX one has one more,
    its encoder's rematerialisation), with the derived frames, grid and depth."""
    cfg, jcfg = tf.configs(yaml)
    assert cfg.convert_to_dict() == jcfg.convert_to_dict()
    mc, jmc = FieryConfig.from_cfg(cfg), JaxFieryConfig.from_cfg(jcfg)
    for f in dataclasses.fields(mc):
        assert getattr(mc, f.name) == getattr(jmc, f.name), f.name
    for prop in ('receptive_field', 'n_future', 'spatial_extent', 'bev_size',
                 'depth_channels'):
        assert getattr(mc, prop) == getattr(jmc, prop), prop


def test_base_chains_resolve_through_two_levels():
    cfg, _ = tf.configs('literature/static_pon_setting.yml')
    assert cfg.TAG == 'pyramid_occupancy_network_setting'
    assert cfg.LIFT.X_BOUND == [-50.0, 50.0, 0.25] and cfg.LIFT.Y_BOUND == [-25.0, 25.0, 0.25]
    assert not cfg.DATASET.FILTER_INVISIBLE_VEHICLES          # static_lss_setting.yml
    assert (cfg.TIME_RECEPTIVE_FIELD, cfg.N_FUTURE_FRAMES, cfg.BATCHSIZE) == (1, 0, 8)
    assert cfg.MODEL.TEMPORAL_MODEL.NAME == 'identity'          # single_timeframe.yml
    assert FieryConfig.from_cfg(cfg).bev_size == (400, 200)

    cfg, _ = tf.configs('lyft/debug_lyft.yml')
    assert (cfg.TAG, cfg.BATCHSIZE, cfg.N_WORKERS, cfg.VIS_INTERVAL) == ('debug', 1, 0, 4)
    assert cfg.MODEL.SUBSAMPLE and cfg.DATASET.NAME == 'lyft'   # lyft/baseline.yml
    assert (cfg.IMAGE.H, cfg.IMAGE.W, cfg.IMAGE.RESIZE_SCALE) == (1080, 1920, 0.25)
    assert cfg.PROBABILISTIC.ENABLED and cfg.MODEL.BN_MOMENTUM == 0.05   # baseline.yml
    mc = FieryConfig.from_cfg(cfg)
    assert (mc.receptive_field, mc.n_future) == (3, 5)

    mc = FieryConfig.from_cfg(tf.configs('literature/fishing_setting.yml')[0])
    assert (mc.bev_size, mc.depth_channels, mc.spatial_extent) == ((320, 192), 28, (16.0, 9.7))


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize('name', sorted(tf.FAMILIES))
def test_weight_table_loads_every_family_strictly(name):
    """Every leaf of the JAX model's params and batch_stats is in the table once, and
    ``state_dict_from_jax`` of seeded leaves loads into the port with
    ``strict=True`` and puts each value where the table says."""
    yaml, opts = tf.FAMILIES[name]
    cfg, jcfg = tf.configs(yaml, opts)
    mc = FieryConfig.from_cfg(cfg)
    shapes = tf.variable_shapes(JaxFiery(cfg=JaxFieryConfig.from_cfg(jcfg)), cfg, mc)
    mapped = [(coll,) + path for path, _, _, coll in build_mapping(mc)]
    leaves = [(coll,) + path for coll in ('params', 'batch_stats')
              for path in _leaf_paths(shapes[coll])]
    assert len(mapped) == len(set(mapped)) and sorted(mapped) == sorted(leaves)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape, np.float32), shapes)
    model = Fiery(mc)
    state_dict = state_dict_from_jax(variables, mc)
    model.load_state_dict(state_dict, strict=True)
    if mc.inbetween_layers:
        # the last Bottleneck3D of the first block: its causal conv (kt = 1)
        i = mc.inbetween_layers
        kernel = variables['params']['temporal_model'][f'Bottleneck3D_{i - 1}'][
            'CausalConv3d_0']['Conv_0']['kernel']
        got = state_dict[f'temporal_model.model.{i}.layers.conv.conv.weight'].numpy()
        np.testing.assert_array_equal(got[:, :, 0], np.transpose(kernel, (3, 2, 0, 1)))
        assert len(model.temporal_model.model) == (mc.receptive_field - 1) * (1 + i)


@pytest.mark.parametrize('yaml, frames', [('lyft/baseline.yml', 3), ('baseline.yml', 3),
                                          ('single_timeframe.yml', 1)])
def test_request_holds_the_frames_the_model_reads(yaml, frames):
    """Under MODEL.SUBSAMPLE (TIME_RECEPTIVE_FIELD 5) a request is the subsampled
    clip, 3 frames: ``request_spec`` and ``make_request`` give 3, and
    ``check_request`` refuses the 5 raw frames."""
    cfg, _ = tf.configs(yaml)
    spec = request_spec(cfg)
    n, (H, W) = len(cfg.IMAGE.NAMES), tuple(cfg.IMAGE.FINAL_DIM)
    assert spec['image'][0] == (1, frames, n, H, W, 3)
    assert spec['future_egomotion'][0] == (1, frames, 6)
    request = make_request(cfg, seed=0)
    assert request['image'].shape[1] == frames
    check_request(request, spec)
    raw = {k: np.concatenate([v, v[:, :2]], axis=1) for k, v in request.items()}
    with pytest.raises(ValueError, match='shape'):
        check_request(raw, spec)
