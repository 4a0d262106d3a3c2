"""Evaluation pieces that need no dataset: IoU and temporally consistent VPQ at two BEV
crops (counterpart of evaluate.py at the repository root).

Protocol: batch 1, zero-noise mean prediction, metrics at the 30x30 m ([70:130]) and
100x100 m ([0:200]) crops of the 200x200 BEV grid, scaled per axis to the grid.
``update_metrics`` is one batch of the validation loop: IoU accumulated on the device
per crop, then VPQ on the host ids, from the device tracker or from the host scipy
tracker. The loop over a dataset waits for the port of the data pipeline.
"""

import numpy as np
import torch

from fiery_tpu_torch.postprocess.instance import (
    decode_instance_predictions,
    make_instance_id_temporally_consistent_device,
    predict_instance_segmentation_and_trajectories,
)
from fiery_tpu_torch.training.metrics import IntersectionOverUnion, iou_update

EVALUATION_RANGES = {'30x30': (70, 130), '100x100': (0, 200)}


def _scaled_ranges(bev_size):
    """Scale the 200-grid crop windows to the configured grid, per axis, so that
    each crop stays the same metric fraction of a non-square grid."""
    X, Y = bev_size
    out = {}
    for key, (start, end) in EVALUATION_RANGES.items():
        out[key] = ((int(start * X / 200), int(end * X / 200)),
                    (int(start * Y / 200), int(end * Y / 200)))
    return out


def device_consistent(output):
    """Decode and track on the output's device: (b, s, h, w) int32 temporally
    consistent instance ids, with no host round trip (K6, K7, then per step two K8
    and one K9 launches)."""
    pred_inst = decode_instance_predictions(
        {k: output[k] for k in ['segmentation', 'instance_center', 'instance_offset']})
    flow = output.get('instance_flow')
    if flow is None:
        flow = torch.zeros_like(output['instance_offset'])
    return make_instance_id_temporally_consistent_device(pred_inst, flow)


def update_metrics(output, labels, iou_states, panoptic_metrics, ranges, n_classes,
                   device_matching=True):
    """One batch of the validation loop.

    output: the network's output dict; labels: 'segmentation' and 'instance',
    (b, s, h, w) int tensors on the output's device; iou_states: (len(ranges), 4,
    n_classes) float32 on that device; panoptic_metrics: {range key:
    PanopticMetric}. Returns the updated IoU states; the panoptic metrics are
    updated in place from int16 ids on the host.
    """
    seg_pred = output['segmentation'].argmax(dim=-1)
    seg_label = labels['segmentation']
    updated = []
    for k, ((sx, ex), (sy, ey)) in enumerate(ranges.values()):
        updated.append(iou_states[k] + iou_update(
            seg_pred[..., sx:ex, sy:ey], seg_label[..., sx:ex, sy:ey], n_classes))
    if device_matching:
        consistent = device_consistent(output).to(torch.int16).cpu().numpy()
    else:
        consistent = predict_instance_segmentation_and_trajectories(output)
    inst_label = labels['instance'].to(torch.int16).cpu().numpy()
    for key, ((sx, ex), (sy, ey)) in ranges.items():
        panoptic_metrics[key].update(consistent[..., sx:ex, sy:ey],
                                     inst_label[..., sx:ex, sy:ey])
    return torch.stack(updated)


def summarise(iou_states, panoptic_metrics, n_classes):
    """IoU, PQ, SQ and RQ of the vehicle class per crop, as the evaluation prints
    them: {'iou_30x30': ..., 'pq_30x30': ..., ...}."""
    iou_states_np = iou_states.cpu().numpy().astype(np.float64)
    results = {}
    for k, key in enumerate(panoptic_metrics):
        iou_metric = IntersectionOverUnion(n_classes)
        iou_metric.load_state(iou_states_np[k])
        panoptic = panoptic_metrics[key].compute()
        results[f'iou_{key}'] = iou_metric.compute()[1]
        for metric_key, value in panoptic.items():
            if metric_key != 'denominator':
                results[f'{metric_key}_{key}'] = value[1]
    return results
