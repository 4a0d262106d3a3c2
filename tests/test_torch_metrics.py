"""fiery_tpu_torch.training.metrics and fiery_tpu_torch.evaluate against the JAX
package's metrics and evaluate.py's per-batch update, on the CPU: equal to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate as jax_evaluate
from fiery_tpu.postprocess.instance import predict_instance_segmentation_and_trajectories
from fiery_tpu.training import metrics as JM
from fiery_tpu_torch import evaluate as E
from fiery_tpu_torch.training import metrics as M


def instance_clip(rng, b=1, s=3, h=40, w=40, n=6, jitter=True):
    """(b, s, h, w) int64 ids of n boxes moving over s frames; with jitter, boxes
    drift, vanish or swap ids so that the metric sees TP, FP, FN and id switches."""
    out = np.zeros((b, s, h, w), np.int64)
    for bi in range(b):
        base = rng.randint(2, h - 10, size=(n, 2))
        for t in range(s):
            for k in range(n):
                if jitter and rng.rand() < 0.15:
                    continue
                x, y = base[k] + (rng.randint(-2, 3, 2) if jitter else 0)
                out[bi, t, max(x, 0):x + 6, max(y, 0):y + 6] = k + 1
            if jitter and rng.rand() < 0.3:
                ids = out[bi, t]
                out[bi, t] = np.where(ids == 1, 2, np.where(ids == 2, 1, ids))
    return out


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_panoptic_metric_equals_jax(seed):
    rng = np.random.RandomState(seed)
    gt = instance_clip(rng, b=2, jitter=False)
    pred = instance_clip(rng, b=2)
    for temporally_consistent in (True, False):
        want, got = (JM.PanopticMetric(3, temporally_consistent),
                     M.PanopticMetric(3, temporally_consistent))
        for _ in range(2):
            want.update(pred, gt)
            got.update(pred, gt)
        for k, v in want.compute().items():
            np.testing.assert_allclose(got.compute()[k], v, rtol=0, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(got.state(), want.state(), rtol=0, atol=1e-12)


def test_iou_metric_and_device_update_equal_jax():
    rng = np.random.RandomState(3)
    pred = rng.randint(0, 3, size=(2, 3, 20, 20))
    tgt = rng.randint(0, 3, size=(2, 3, 20, 20))
    got_state = M.iou_update(torch.from_numpy(pred), torch.from_numpy(tgt), 3)
    want_state = np.asarray(JM.iou_update_jnp(jnp.asarray(pred), jnp.asarray(tgt), 3))
    assert got_state.dtype == torch.float32
    np.testing.assert_array_equal(got_state.numpy(), want_state)
    for ignore_index in (None, 0):
        want, got = (JM.IntersectionOverUnion(3, ignore_index),
                     M.IntersectionOverUnion(3, ignore_index))
        want.update(pred, tgt)
        got.update(pred, tgt)
        np.testing.assert_allclose(got.compute(), want.compute(), rtol=0, atol=1e-12)
        got.load_state(got_state.numpy().astype(np.float64))
        np.testing.assert_allclose(got.compute(), want.compute(), rtol=0, atol=1e-12)


def test_scaled_ranges_equal_jax():
    for size in [(200, 200), (320, 192), (200, 100)]:
        assert E._scaled_ranges(size) == jax_evaluate._scaled_ranges(size)
    assert E.EVALUATION_RANGES == jax_evaluate.EVALUATION_RANGES


def planted_batch(rng, h=40, w=40, s=3):
    """An output dict whose heads decode to the boxes of an instance clip (offsets
    point at each box's centre, flow carries it to the next frame), and its labels."""
    inst = instance_clip(rng, s=s, h=h, w=w, jitter=False)
    seg = np.zeros((1, s, h, w, 2), np.float32)
    seg[..., 0] = 1.0
    center = np.zeros((1, s, h, w, 1), np.float32)
    offset = np.zeros((1, s, h, w, 2), np.float32)
    x, y = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                       indexing='ij')
    for t in range(s):
        for k in np.unique(inst[0, t])[1:]:
            m = inst[0, t] == k
            cx, cy = x[m].mean(), y[m].mean()
            seg[0, t][m] = [0.0, 1.0]
            center[0, t, ..., 0] = np.maximum(center[0, t, ..., 0],
                                              np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / 4))
            offset[0, t][m] = np.stack([cx - x[m], cy - y[m]], -1)
    labels = {'segmentation': (inst > 0).astype(np.int64), 'instance': inst}
    return {'segmentation': seg, 'instance_center': center, 'instance_offset': offset,
            'instance_flow': np.zeros_like(offset)}, labels


@pytest.mark.parametrize('device_matching', [True, False])
def test_update_metrics_equals_jax_val_step(device_matching):
    """Two batches through the port's update_metrics + summarise against the body of
    evaluate.py's validation loop (iou_update_jnp per crop, the device or host
    tracker, PanopticMetric per crop) and its summary."""
    rng = np.random.RandomState(4)
    ranges = E._scaled_ranges((40, 40))
    n_classes = 2
    port_pan = {k: M.PanopticMetric(n_classes) for k in ranges}
    jax_pan = {k: JM.PanopticMetric(n_classes) for k in ranges}
    port_iou = torch.zeros((len(ranges), 4, n_classes))
    jax_iou = jnp.zeros((len(ranges), 4, n_classes), jnp.float32)
    for _ in range(2):
        output, labels = planted_batch(rng)
        port_iou = E.update_metrics({k: torch.from_numpy(v) for k, v in output.items()},
                                    {k: torch.from_numpy(v) for k, v in labels.items()},
                                    port_iou, port_pan, ranges, n_classes, device_matching)
        jout = {k: jnp.asarray(v) for k, v in output.items()}
        seg_pred = jnp.argmax(jout['segmentation'], axis=-1)
        jax_iou = jnp.stack([jax_iou[k] + JM.iou_update_jnp(
            seg_pred[..., sx:ex, sy:ey], jnp.asarray(labels['segmentation'])[..., sx:ex, sy:ey],
            n_classes) for k, ((sx, ex), (sy, ey)) in enumerate(ranges.values())])
        if device_matching:
            consistent = np.asarray(jax.jit(lambda o: jax_evaluate._device_consistent.__wrapped__(
                o))(jout).astype(jnp.int16))
        else:
            consistent = predict_instance_segmentation_and_trajectories(jout)
        for key, ((sx, ex), (sy, ey)) in ranges.items():
            jax_pan[key].update(consistent[..., sx:ex, sy:ey],
                                labels['instance'].astype(np.int16)[..., sx:ex, sy:ey])
    got = E.summarise(port_iou, port_pan, n_classes)
    want = {}
    iou_np = np.asarray(jax_iou).astype(np.float64)
    for k, key in enumerate(ranges):
        iou = JM.IntersectionOverUnion(n_classes)
        iou.load_state(iou_np[k])
        want[f'iou_{key}'] = iou.compute()[1]
        for mk, v in jax_pan[key].compute().items():
            if mk != 'denominator':
                want[f'{mk}_{key}'] = v[1]
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12, err_msg=k)
    assert got['pq_100x100'] == pytest.approx(1.0)   # the planted boxes are found
