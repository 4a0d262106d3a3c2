"""The fishing family (literature/fishing_setting.yml: a 320 x 192 grid of 0.1 m
cells and 28 depth bins) against the JAX package at tiny widths (CPU, f32): a
non-square grid divisible by 8 (64 x 48, asymmetric y bounds as the config's) and
D = 14, not a multiple of 8, so that the splat (K1) and the top-k select (K5) run
rows of depth whose bytes are no multiple of 16. The eval forward against JAX's,
dense and under LIFT.TOPK 5 (k < D).
"""

import pytest

import torch_family as tf
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)

FISHING = ('LIFT.X_BOUND', '[-8.0, 8.0, 0.25]', 'LIFT.Y_BOUND', '[-5.75, 6.25, 0.25]',
           'LIFT.D_BOUND', '[2.0, 9.0, 0.5]', 'N_FUTURE_FRAMES', '2')


@pytest.mark.parametrize('topk', [0, 5])
def test_fishing_family_eval_forward_matches_jax(topk):
    fam = tf.family('literature/fishing_setting.yml', FISHING + ('LIFT.TOPK', str(topk)),
                    forward_only=True)
    mc = fam['trainer'].model.cfg
    assert (mc.bev_size, mc.depth_channels, mc.depth_topk) == ((64, 48), 14, topk)
    assert mc.spatial_extent == (8.0, 6.25)
    assert fam['served']['segmentation'].shape == (1, 3, 64, 48, 2)
    tf.assert_forward_matches(fam['served'], fam['want_served'])
