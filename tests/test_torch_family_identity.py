"""The single-frame family (single_timeframe.yml, static_lss_setting.yml, and
lyft/single_timeframe.yml, which differ from it only in data flags) and the encoder
at downsample 16, against the JAX package at tiny widths (CPU, f32).

The single-frame model: the identity temporal model at receptive field 1, no
future frames, no distributions, no flow; the decoder reads the last state. Its
eval forward and one training step against JAX's (one jit), as
tests/test_torch_trainer.py holds them; then both trackers of the port, device and
host, on its one-frame outputs without flow, against the JAX package's two, on the
network's heads and on heads planted from the labels. The encoder at
MODEL.ENCODER.DOWNSAMPLE 16 (no YAML sets it): the eval forward of a baseline.yml
model against JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiery_tpu.postprocess import instance as jax_instance
from fiery_tpu_torch.evaluate import device_consistent
from fiery_tpu_torch.postprocess.instance import (
    predict_instance_segmentation_and_trajectories)

import torch_family as tf
from torch_threads import few_threads  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope='module')
def identity():
    return tf.family('single_timeframe.yml')


def test_identity_family_eval_forward_matches_jax(identity):
    mc = identity['trainer'].model.cfg
    assert (mc.temporal_name, mc.receptive_field, mc.n_future) == ('identity', 1, 0)
    assert not (mc.probabilistic_enabled or mc.instance_flow_enabled)
    assert sorted(identity['served']) == ['instance_center', 'instance_offset',
                                          'segmentation']
    assert identity['served']['segmentation'].shape == (1, 1, 32, 32, 2)
    tf.assert_forward_matches(identity['served'], identity['want_served'])


def test_identity_family_train_step_matches_jax(identity):
    assert not {'instance_flow', 'probabilistic'} & set(identity['losses'])
    assert {'segmentation', 'instance_center', 'instance_offset'} <= set(identity['losses'])
    tf.assert_step_matches(identity)


def _planted(batch, trainer):
    """Heads from the present frame's labels: the true class as logits of 8 against
    0, the true centreness and offsets."""
    labels, _ = trainer.prepare_future_labels(trainer.to_device(batch))
    seg = torch.nn.functional.one_hot(labels['segmentation'], 2).float()
    return {'segmentation': 8.0 * seg, 'instance_center': labels['centerness'],
            'instance_offset': labels['offset']}


def test_both_trackers_match_jax_on_one_frame_without_flow(identity):
    """The device tracker (``device_consistent``) and the host tracker of the port
    against the JAX package's host tracker and its device tracker, on a one-frame
    clip with no flow output: every id equal, on the network's heads and on planted
    heads that hold several instances."""
    n_ids = []
    for heads in (identity['served'], _planted(identity['batch'], identity['trainer'])):
        heads = {k: v.detach() for k, v in heads.items()}
        assert 'instance_flow' not in heads and heads['segmentation'].shape[1] == 1
        jheads = {k: jnp.asarray(v.numpy()) for k, v in heads.items()}
        want = jax_instance.predict_instance_segmentation_and_trajectories(jheads)
        decoded = jax_instance.decode_instance_predictions(jheads)
        want_device = np.stack([np.asarray(
            jax_instance.make_instance_id_temporally_consistent_device(
                decoded[b], jnp.zeros(decoded.shape[1:] + (2,), jnp.float32)))
            for b in range(decoded.shape[0])])
        np.testing.assert_array_equal(want_device, want)
        with torch.inference_mode():
            got_device = device_consistent(heads)
            got_host = predict_instance_segmentation_and_trajectories(heads)
        assert got_device.dtype == torch.int32 and got_device.shape == want.shape
        np.testing.assert_array_equal(got_device.numpy(), want)
        np.testing.assert_array_equal(got_host, want)
        n_ids.append(int(want.max()))
    assert n_ids[1] >= 2, n_ids


def test_encoder_at_downsample_16_matches_jax():
    fam = tf.family('baseline.yml', ('MODEL.ENCODER.DOWNSAMPLE', '16', 'N_FUTURE_FRAMES', '2'),
                    forward_only=True)
    model = fam['trainer'].model
    assert model.cfg.encoder_downsample == 16 and tuple(model.frustum.shape[1:3]) == (4, 6)
    tf.assert_forward_matches(fam['served'], fam['want_served'])


def test_every_batchnorm_call_meets_the_kernel_layout(identity):
    """The BatchNorm kernel's layout checks hold on every call of a training and an
    eval forward (tests/test_torch_family_temporal.py has the fault they found)."""
    assert tf.assert_batchnorm_layouts(identity) > 50
