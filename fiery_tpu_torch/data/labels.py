"""Instance-label generation: centerness / offset / future-flow maps from instance ids
(a copy of fiery_tpu/data/labels.py).

A Gaussian centerness heatmap (sigma 3, max-combined over instances), per-pixel
offsets to the (rounded) instance centroid, and a future-flow map that writes each
persisting instance's ego-compensated centroid displacement at frame t into its
frame t-1 footprint. Table-driven: one bincount pass builds the (frame, instance)
centroid tables, and every map is a lookup through the instance image. Pure numpy.
"""

import numpy as np

from fiery_tpu_torch.data.label_warp import (
    _invert_pose, _mat2pose_vec, _pose_vec2mat, _warp_nearest)


def _centroid_table(frames, n_ids):
    """(S, h, w) int frames -> rounded centroid tables.

    Returns (cx, cy, valid): each (S, n_ids + 1), where cx[t, i] is the rounded
    mean row coordinate of id i in frame t and valid[t, i] marks ids with pixels.
    Row 0 (background) is never valid.
    """
    S, h, w = frames.shape
    rows = np.repeat(np.arange(h, dtype=np.float64), w)
    cols = np.tile(np.arange(w, dtype=np.float64), h)
    cx = np.zeros((S, n_ids + 1))
    cy = np.zeros((S, n_ids + 1))
    valid = np.zeros((S, n_ids + 1), dtype=bool)
    for t in range(S):
        flat = frames[t].ravel()
        counts = np.bincount(flat, minlength=n_ids + 1)[:n_ids + 1]
        present = counts > 0
        present[0] = False
        denom = np.maximum(counts, 1)
        cx[t] = np.round(np.bincount(flat, weights=rows,
                                     minlength=n_ids + 1)[:n_ids + 1] / denom)
        cy[t] = np.round(np.bincount(flat, weights=cols,
                                     minlength=n_ids + 1)[:n_ids + 1] / denom)
        valid[t] = present
    return cx, cy, valid


def convert_instance_mask_to_center_and_offset_label(
        instance_img, future_egomotion, num_instances, ignore_index=255,
        subtract_egomotion=True, sigma=3.0, spatial_extent=None):
    """instance_img: (seq_len, h, w) int; future_egomotion: (seq_len, 6).

    Returns (center (s, h, w, 1), offset (s, h, w, 2), future_flow (s, h, w, 2)),
    channels-last. Offset/flow channel 0 is the vertical (h/x) displacement,
    channel 1 horizontal (w/y), matching the reference.
    """
    instance_img = np.asarray(instance_img)
    seq_len, h, w = instance_img.shape
    n = int(num_instances)
    x = np.arange(h, dtype=np.float32)[:, None]
    y = np.arange(w, dtype=np.float32)[None, :]

    # ego-compensated view of frames 1..S-1, so centroid displacement measures
    # object motion rather than ego motion
    warped = np.zeros_like(instance_img)
    if seq_len > 1:
        if subtract_egomotion:
            ego_inv = _mat2pose_vec(_invert_pose(_pose_vec2mat(
                np.asarray(future_egomotion, np.float32))))
            poses = ego_inv[:seq_len - 1].astype(np.float32)
        else:
            poses = np.zeros((seq_len - 1, 6), np.float32)
        moved = _warp_nearest(
            instance_img[1:].astype(np.float32)[..., None],
            poses, spatial_extent)
        warped[1:] = moved[..., 0]

    # table sized to the largest id present, but ids beyond num_instances are
    # treated as absent (the reference only iterates ids 1..num_instances)
    n_table = max(n, int(instance_img.max(initial=0)))
    cx, cy, valid = _centroid_table(instance_img, n_table)
    wx, wy, wvalid = _centroid_table(warped, n_table)
    valid[:, n + 1:] = False

    center_label = np.zeros((seq_len, h, w, 1), dtype=np.float32)
    offset_label = np.full((seq_len, h, w, 2), ignore_index, dtype=np.float32)
    flow_label = np.full((seq_len, h, w, 2), ignore_index, dtype=np.float32)

    for t in range(seq_len):
        ids = np.nonzero(valid[t])[0]
        if len(ids) == 0:
            continue
        # centerness: max over per-instance Gaussians around the rounded centroids
        dx = cx[t, ids, None, None].astype(np.float32) - x[None]
        dy = cy[t, ids, None, None].astype(np.float32) - y[None]
        center_label[t, :, :, 0] = np.exp(
            -(dx ** 2 + dy ** 2) / sigma ** 2).max(axis=0)

        # offset: every instance pixel points at its own centroid
        frame = instance_img[t]
        fg = valid[t][frame]
        offset_label[t, :, :, 0] = np.where(fg, cx[t][frame] - x, ignore_index)
        offset_label[t, :, :, 1] = np.where(fg, cy[t][frame] - y, ignore_index)

        # flow at t-1: displacement of instances present in BOTH frames (and
        # surviving the warp), written over their t-1 footprint
        if t > 0:
            persists = valid[t - 1] & valid[t] & wvalid[t]
            prev = instance_img[t - 1]
            mask = persists[prev]
            flow_label[t - 1, :, :, 0][mask] = (wx[t] - cx[t - 1])[prev][mask]
            flow_label[t - 1, :, :, 1][mask] = (wy[t] - cy[t - 1])[prev][mask]

    return center_label, offset_label, flow_label
