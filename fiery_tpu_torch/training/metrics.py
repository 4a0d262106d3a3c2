"""Evaluation metrics: per-class IoU and (video) Panoptic Quality.

Counterpart of fiery_tpu/training/metrics.py. The IoU update is a vectorised torch
computation that accumulates on the device; the panoptic matching (bincount
confusion, IoU > 0.5 matching and the sequential cross-frame consistency mapping)
runs on the host in numpy. Metric states are plain arrays; under data-parallel
evaluation, sum the states across processes before compute().
"""

from typing import Optional

import numpy as np
import torch


class IntersectionOverUnion:
    """Accumulated per-class IoU. Reference: metrics.py:9-65."""

    def __init__(self, n_classes: int, ignore_index: Optional[int] = None,
                 absent_score: float = 0.0):
        self.n_classes = n_classes
        self.ignore_index = ignore_index
        self.absent_score = absent_score
        self.reset()

    def reset(self):
        self.true_positive = np.zeros(self.n_classes)
        self.false_positive = np.zeros(self.n_classes)
        self.false_negative = np.zeros(self.n_classes)
        self.support = np.zeros(self.n_classes)

    def update(self, prediction, target):
        prediction = np.asarray(prediction).reshape(-1)
        target = np.asarray(target).reshape(-1)
        for c in range(self.n_classes):
            pred_c = prediction == c
            tgt_c = target == c
            self.true_positive[c] += np.sum(pred_c & tgt_c)
            self.false_positive[c] += np.sum(pred_c & ~tgt_c)
            self.false_negative[c] += np.sum(~pred_c & tgt_c)
            self.support[c] += np.sum(tgt_c)

    def state(self):
        return np.stack([self.true_positive, self.false_positive,
                         self.false_negative, self.support])

    def load_state(self, state):
        self.true_positive, self.false_positive, self.false_negative, self.support = state

    def compute(self):
        scores = np.zeros(self.n_classes)
        for c in range(self.n_classes):
            if c == self.ignore_index:
                continue
            tp, fp, fn = self.true_positive[c], self.false_positive[c], self.false_negative[c]
            sup = self.support[c]
            if sup + tp + fp == 0:
                scores[c] = self.absent_score
                continue
            scores[c] = tp / (tp + fp + fn)
        if self.ignore_index is not None and 0 <= self.ignore_index < self.n_classes:
            scores = np.concatenate([scores[:self.ignore_index],
                                     scores[self.ignore_index + 1:]])
        return scores


class PanopticMetric:
    """Video panoptic quality with temporal-consistency penalty.

    Reference: metrics.py:68-255.
    """

    def __init__(self, n_classes: int, temporally_consistent: bool = True,
                 vehicles_id: int = 1):
        self.n_classes = n_classes
        self.temporally_consistent = temporally_consistent
        self.vehicles_id = vehicles_id
        self.reset()

    def reset(self):
        self.iou = np.zeros(self.n_classes)
        self.true_positive = np.zeros(self.n_classes)
        self.false_positive = np.zeros(self.n_classes)
        self.false_negative = np.zeros(self.n_classes)

    def state(self):
        return np.stack([self.iou, self.true_positive, self.false_positive,
                         self.false_negative])

    def load_state(self, state):
        self.iou, self.true_positive, self.false_positive, self.false_negative = state

    def update(self, pred_instance, gt_instance):
        """pred_instance/gt_instance: (b, s, h, w) int arrays; id 0 = background."""
        pred_instance = np.asarray(pred_instance)
        gt_instance = np.asarray(gt_instance)
        batch_size, sequence_length = gt_instance.shape[:2]
        assert gt_instance.min() == 0, 'ID 0 of gt_instance must be background'

        pred_segmentation = (pred_instance > 0).astype(np.int64)
        gt_segmentation = (gt_instance > 0).astype(np.int64)

        for b in range(batch_size):
            unique_id_mapping = {}
            for t in range(sequence_length):
                result = self._panoptic_metrics(
                    pred_segmentation[b, t], pred_instance[b, t],
                    gt_segmentation[b, t], gt_instance[b, t], unique_id_mapping)
                self.iou += result['iou']
                self.true_positive += result['true_positive']
                self.false_positive += result['false_positive']
                self.false_negative += result['false_negative']

    def compute(self):
        denominator = np.maximum(
            self.true_positive + self.false_positive / 2 + self.false_negative / 2, 1.0)
        pq = self.iou / denominator
        sq = self.iou / np.maximum(self.true_positive, 1.0)
        rq = self.true_positive / denominator
        return {
            'pq': pq, 'sq': sq, 'rq': rq,
            'denominator': (self.true_positive + self.false_positive / 2
                            + self.false_negative / 2),
        }

    def _panoptic_metrics(self, pred_segmentation, pred_instance, gt_segmentation,
                          gt_instance, unique_id_mapping):
        """Single-frame PQ statistics, fully vectorised.

        Segment-id space: every pixel gets one combined id — 0 for void, 1..K for
        the K stuff/class segments, K+i for thing instance i. All pair statistics
        come from one joint bincount; matching, FN and FP are mask reductions
        (no per-segment Python loops). Semantics match reference metrics.py:137-222
        (pinned by tests/test_postprocess.py), including the quirk that a thing
        segment matched to a *stuff* segment of the same class still counts as
        unmatched in the FN/FP sweeps.
        """
        K = self.n_classes
        n_seg = K + int(max(pred_instance.max(), gt_instance.max()))

        gt_px, gt_cls = self._segment_labels(gt_segmentation, gt_instance, K, n_seg)
        pr_px, pr_cls = self._segment_labels(pred_segmentation, pred_instance, K,
                                             n_seg)

        # pairwise overlap areas over the full id space, then drop the void slot
        pair = np.bincount(gt_px * (n_seg + 1) + pr_px,
                           minlength=(n_seg + 1) ** 2)
        overlap = pair.reshape(n_seg + 1, n_seg + 1)[1:, 1:].astype(np.float64)
        area_union = overlap.sum(1, keepdims=True) + overlap.sum(0) - overlap
        iou = np.divide(overlap + 1e-9, area_union + 1e-9,
                        out=np.zeros_like(overlap), where=area_union > 0)

        # a pair is a match when IoU > 0.5 and the classes agree; IoU > 0.5 makes
        # matches unique per row and per column, so order never matters
        matched = (iou > 0.5) & (gt_cls[:, None] == pr_cls[None, :])
        gt_idx, pr_idx = np.nonzero(matched)

        result = {key: np.zeros(K) for key in
                  ['iou', 'true_positive', 'false_positive', 'false_negative']}
        match_cls = pr_cls[pr_idx]

        # temporal consistency: a tracked GT id that switches predicted id is a
        # FN+FP instead of a TP (vehicles class only)
        prev = np.array([unique_id_mapping.get(g, -1) for g in gt_idx], dtype=np.int64)
        switched = (self.temporally_consistent & (match_cls == self.vehicles_id)
                    & (prev >= 0) & (prev != pr_idx))
        ok = ~switched
        np.add.at(result['true_positive'], match_cls[ok], 1)
        np.add.at(result['iou'], match_cls[ok], iou[gt_idx[ok], pr_idx[ok]])
        np.add.at(result['false_negative'], gt_cls[gt_idx[switched]], 1)
        np.add.at(result['false_positive'], match_cls[switched], 1)
        for g, p in zip(gt_idx, pr_idx):
            unique_id_mapping[g] = p

        # unmatched things: FN for GT segments, FP for predicted segments that
        # overlap anything (only thing-vs-thing matches count as "matched" here)
        thing = np.zeros(n_seg, dtype=bool)
        thing[K:] = True
        gt_unmatched = thing & (gt_cls >= 0) & ~matched[:, K:].any(1)
        np.add.at(result['false_negative'], gt_cls[gt_unmatched], 1)
        pr_unmatched = (thing & (pr_cls >= 0) & ~matched[K:, :].any(0)
                        & (overlap > 0).any(0))
        np.add.at(result['false_positive'], pr_cls[pr_unmatched], 1)
        return result

    @staticmethod
    def _segment_labels(segmentation, instance, n_classes, n_seg):
        """Per-pixel combined segment ids plus the segment->class lookup.

        Ids: 0 void (class >= n_classes), 1..K stuff classes, K+i thing instance i.
        The lookup covers ids 1..n_seg (index 0 = id 1); thing entries take the
        class of their last pixel in scan order, absent segments get -1.
        """
        seg = segmentation.reshape(-1).astype(np.int64)
        inst = instance.reshape(-1).astype(np.int64)
        valid = seg < n_classes
        px = np.where(inst > 0, inst + n_classes, seg + 1)
        px = np.where(valid, px, 0)

        cls_of = np.full(n_seg, -1, dtype=np.int64)
        cls_of[:n_classes] = np.arange(n_classes)
        sel = (inst > 0) & valid
        cls_of[inst[sel] + n_classes - 1] = seg[sel]
        return px, cls_of


def iou_update(prediction, target, n_classes):
    """Per-class (tp, fp, fn, support) as a (4, n_classes) float32 tensor on the
    inputs' device, for accumulating on the device."""
    prediction = prediction.reshape(-1)
    target = target.reshape(-1)
    classes = torch.arange(n_classes, device=prediction.device)
    pred_c = prediction[None, :] == classes[:, None]
    tgt_c = target[None, :] == classes[:, None]
    tp = (pred_c & tgt_c).sum(dim=1)
    fp = (pred_c & ~tgt_c).sum(dim=1)
    fn = (~pred_c & tgt_c).sum(dim=1)
    sup = tgt_c.sum(dim=1)
    return torch.stack([tp, fp, fn, sup]).to(torch.float32)
