"""The temporal family without a future (temporal_single_timeframe.yml,
lift_splat_setting.yml, and pon_setting.yml, here on a rectangular grid as PON's
400 x 200) against the JAX package at tiny widths (CPU, f32): the temporal block
at receptive field 3 with the ego-pose input, no future frames, no distributions,
no flow, on a 64 x 32 grid of extent (8, 4), so that the bilinear warp (K2), the
splat (K1) and the decode run on a map whose sides differ. The eval forward and
one training step (the nearest label warp, K4, on that grid too) against JAX's,
in one jit, as tests/test_torch_trainer.py holds them.
"""

import pytest

import torch_family as tf
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

RECTANGLE = ('LIFT.X_BOUND', '[-8.0, 8.0, 0.25]', 'LIFT.Y_BOUND', '[-4.0, 4.0, 0.25]')


@pytest.fixture(scope='module')
def temporal():
    return tf.family('literature/pon_setting.yml', RECTANGLE)


def test_temporal_family_eval_forward_matches_jax(temporal):
    mc = temporal['trainer'].model.cfg
    assert (mc.temporal_name, mc.receptive_field, mc.n_future) == ('temporal_block', 3, 0)
    assert (mc.bev_size, mc.spatial_extent) == ((64, 32), (8.0, 4.0))
    assert temporal['served']['segmentation'].shape == (1, 1, 64, 32, 2)
    tf.assert_forward_matches(temporal['served'], temporal['want_served'])


def test_temporal_family_train_step_matches_jax(temporal):
    assert temporal['batch']['segmentation'].shape == (2, 3, 64, 32, 1)
    tf.assert_step_matches(temporal)


def test_every_batchnorm_call_meets_the_kernel_layout(temporal):
    """Without a future the decoder reads the last state of the training stack,
    (b, 3, X, Y, C)[:, -1:], and handed that strided view to K10 as the residual of
    its last skip: the kernel refused it on the card at batch 4 (its plain version
    on the CPU takes any layout). The decoder now takes its input contiguous."""
    assert tf.assert_batchnorm_layouts(temporal) > 50
