"""Evaluation: IoU and temporally consistent VPQ at two BEV crops (counterpart of
evaluate.py at the repository root).

    python -m fiery_tpu_torch.evaluate --checkpoint RUN/checkpoint_final \
        [--torch-checkpoint FILE.ckpt] [--dataroot D] [--version V] \
        [--max-batches N] [--device-matching] [--device cpu]

Protocol: batch 1, zero-noise mean prediction, metrics at the 30x30 m ([70:130]) and
100x100 m ([0:200]) crops of the 200x200 BEV grid, scaled per axis to the grid.
``eval_checkpoint`` loads a checkpoint (a directory of ``utils/checkpoint.py``, or a
reference ``.ckpt``), runs the val loader through ``Trainer.eval_step`` and
``update_metrics`` (IoU accumulated on the device per crop, then VPQ on the host
from int16 ids, from the device tracker (K8, K9) under --device-matching, else
from the host scipy tracker) and ``summarise``. It runs on the CUDA card unless
given --device cpu.
"""

import argparse

import numpy as np
import torch

from fiery_tpu_torch.postprocess.instance import (
    decode_instance_predictions,
    make_instance_id_temporally_consistent_device,
    predict_instance_segmentation_and_trajectories,
)
from fiery_tpu_torch.data.dataset import numeric_batch, prepare_dataloaders
from fiery_tpu_torch.training.metrics import IntersectionOverUnion, PanopticMetric, iou_update
from fiery_tpu_torch.training.trainer import Trainer
from fiery_tpu_torch.utils.checkpoint import load_checkpoint, load_torch_full_checkpoint

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


def eval_checkpoint(checkpoint_path, dataroot=None, version=None, max_batches=None,
                    device_matching=False, state_cfg=None, device=None):
    """IoU, PQ, SQ and RQ of the vehicles at both crops over the val split:
    ``{'iou_30x30': ..., 'pq_30x30': ..., ...}``. ``state_cfg`` (state, cfg)
    stands in for a checkpoint. The model's weights load strictly."""
    if state_cfg is not None:
        state, cfg = state_cfg
    elif checkpoint_path.endswith(('.ckpt', '.pth', '.pt')):
        state, cfg = load_torch_full_checkpoint(checkpoint_path)
    else:
        state, cfg = load_checkpoint(checkpoint_path)
    cfg = cfg.clone()
    cfg.defrost()
    cfg.BATCHSIZE = 1
    if dataroot is not None:
        cfg.DATASET.DATAROOT = dataroot
    if version is not None:
        cfg.DATASET.VERSION = version
    cfg.freeze()

    trainer = Trainer(cfg, device=device)
    trainer.load_state({**state, 'optimizer': None}, strict=True)
    _, valloader = prepare_dataloaders(cfg, device=trainer.device)
    n_classes = trainer.model.cfg.n_classes
    ranges = _scaled_ranges(trainer.model.cfg.bev_size)
    panoptic_metrics = {key: PanopticMetric(n_classes) for key in ranges}
    iou_states = torch.zeros((len(ranges), 4, n_classes), dtype=torch.float32,
                             device=trainer.device)
    batches = iter(valloader)
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            batches.close()
            break
        output, labels, _ = trainer.eval_step(numeric_batch(batch))
        iou_states = update_metrics(output, labels, iou_states, panoptic_metrics, ranges,
                                    n_classes, device_matching=device_matching)
    valloader.shutdown()
    return summarise(iou_states, panoptic_metrics, n_classes)


def main(argv=None):
    parser = argparse.ArgumentParser(description='fiery_tpu_torch evaluation')
    parser.add_argument('--checkpoint', default='', type=str,
                        help='a checkpoint dir, or a reference torch .ckpt/.pth')
    parser.add_argument('--torch-checkpoint', default='', type=str,
                        help='a reference torch checkpoint (alias)')
    parser.add_argument('--dataroot', default=None, type=str)
    parser.add_argument('--version', default=None, type=str)
    parser.add_argument('--max-batches', default=None, type=int)
    parser.add_argument('--device-matching', action='store_true',
                        help='track on the device (K8, K9) instead of the host scipy '
                             'tracker')
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = parser.parse_args(argv)
    checkpoint = args.torch_checkpoint or args.checkpoint
    if not checkpoint:
        parser.error('--checkpoint (or --torch-checkpoint) is required')
    results = eval_checkpoint(checkpoint, args.dataroot, args.version, args.max_batches,
                              device_matching=args.device_matching, device=args.device)
    for panoptic_key in ['iou', 'pq', 'sq', 'rq']:
        print(panoptic_key)
        print('    '.join([f'{k}: {v:.4f}' for k, v in results.items()
                           if k.startswith(panoptic_key)]))
    return results


if __name__ == '__main__':
    main()
