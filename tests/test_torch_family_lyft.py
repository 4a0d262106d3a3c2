"""The Lyft family (lyft/baseline.yml, lyft/debug_lyft.yml) against the JAX package
at tiny widths (CPU, f32): MODEL.SUBSAMPLE with TIME_RECEPTIVE_FIELD 5 and
N_FUTURE_FRAMES 10, which the model reads as 3 past and present and 5 future
frames of the subsampled clip: 6 output frames, a 30-channel future distribution
input and 5 GRU steps. The eval forward on a 3-frame request, and one training
step on the 8-frame clip that the loader hands the trainer (a synthetic batch made
at TIME_RECEPTIVE_FIELD 3 and N_FUTURE_FRAMES 5: the synthetic set does not
subsample, in either package), against JAX's in one jit, as
tests/test_torch_trainer.py holds them.
"""

import pytest

import torch_family as tf
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope='module')
def lyft():
    return tf.family('lyft/baseline.yml', batch_opts=tf.SUBSAMPLED_CLIP)


def test_lyft_family_eval_forward_matches_jax(lyft):
    mc = lyft['trainer'].model.cfg
    assert mc.subsample and (mc.receptive_field, mc.n_future) == (3, 5)
    assert lyft['request']['image'].shape[1] == 3
    assert lyft['served']['segmentation'].shape == (1, 6, 32, 32, 2)
    tf.assert_forward_matches(lyft['served'], lyft['want_served'])


def test_lyft_family_train_step_matches_jax(lyft):
    assert lyft['batch']['image'].shape[1] == 8
    model = lyft['trainer'].model
    assert model.future_distribution.encoder.model[0].layers.conv_down_project.in_channels \
        == 16 + 5 * 6
    tf.assert_step_matches(lyft)


def test_every_batchnorm_call_meets_the_kernel_layout(lyft):
    """The BatchNorm kernel's layout checks hold on every call of a training and an
    eval forward (tests/test_torch_family_temporal.py has the fault they found)."""
    assert tf.assert_batchnorm_layouts(lyft) > 50
