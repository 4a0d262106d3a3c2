"""Instance decoding and temporal ID tracking (counterpart of
fiery_tpu/postprocess/instance.py), channels-last, with a batch dimension in place of
the JAX package's vmap.

The decode of each frame is centre NMS and an exact top-100 (kernel K6,
csrc/instance_centers.cu), then pixel grouping, the vehicle foreground and the
consecutive relabel (kernel K7, csrc/group_pixels.cu); each kernel takes every
frame of a call in one launch. The device tracker matches each
frame's instances to the previous frame's flow-advected ones: centroids by kernel K8
(csrc/segment_centroids.cu), the assignment by kernel K9 (ops/lap.py, csrc/lap.cu),
and plain tensor ops in between that never wait on the host. Each kernel wrapper
takes its plain version for a CPU tensor and launches the kernel for a CUDA tensor.
The host tracker (scipy's Hungarian solver on numpy ids) is kept as in the JAX
package.
"""

import ctypes
import functools
from typing import Dict

import numpy as np
import scipy.optimize
import torch
import torch.nn.functional as F

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.ops.lap import linear_sum_assignment
from fiery_tpu_torch.utils.rounding import sqrt_rn

MAX_INSTANCES = 100  # the reference caps detected centres at 100 per frame


def _launch_checks(name, tensors, dtypes):
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype, all on
    one device."""
    device = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != device:
            raise ValueError(f'{name}: inputs on {device} and {t.device}')
        if t.dtype != dt:
            raise TypeError(f'{name}: expected {dt}, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous')
    if device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {device}')


def _check_rc(name, rc):
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')


# ---------------------------------------------------------------------------
# K6: centre NMS + exact top-k
# ---------------------------------------------------------------------------

def find_instance_centers_plain(center, conf_threshold=0.1, nms_kernel_size=3,
                                max_instances=MAX_INSTANCES):
    """Plain version of ``find_instance_centers``: max_pool2d (-inf padding), then a
    stable descending sort of the flattened scores, which is lax.top_k's order."""
    B, h, w = center.shape
    x = torch.where(center >= conf_threshold, center, -1.0)
    p = (nms_kernel_size - 1) // 2
    pooled = F.max_pool2d(x[:, None], nms_kernel_size, stride=1, padding=p)[:, 0]
    scores = torch.where((x == pooled) & (x > 0), x, -float('inf')).reshape(B, h * w)
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :max_instances], top_idx[:, :max_instances]
    centers = torch.stack([top_idx // w, top_idx % w], dim=-1).to(torch.int32)
    return centers, top_scores > 0


@functools.cache
def _centers_kernel():
    """fiery_instance_centers of csrc/instance_centers.cu, its argument types set
    once."""
    fn = _build.load('instance_centers').fiery_instance_centers
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _centers_shared_bytes(h, w, pad):
    """Shared memory a K6 block takes for (h, w) frames and a (2 pad + 1)^2 window;
    0 beyond what it holds."""
    fn = _build.load('instance_centers').fiery_instance_centers_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return fn(h, w, pad)


def find_instance_centers(center, conf_threshold=0.1, nms_kernel_size=3,
                          max_instances=MAX_INSTANCES):
    """(B, h, w) float32 heatmaps -> centres (B, max_instances, 2) int32 (row, column)
    and valid (B, max_instances) bool (kernel K6).

    Threshold, (nms_kernel_size)^2 max-pool NMS, and the max_instances highest peaks
    in descending score, ties by lowest pixel index; slots past the peaks are
    invalid padding. A CPU tensor takes the plain version.
    """
    if center.dim() != 3:
        raise ValueError(f'find_instance_centers: center {tuple(center.shape)} must be '
                         '(B, h, w)')
    if nms_kernel_size % 2 != 1:
        raise ValueError(f'find_instance_centers: nms_kernel_size {nms_kernel_size} '
                         'must be odd')
    if center.device.type == 'cpu':
        return find_instance_centers_plain(center, conf_threshold, nms_kernel_size,
                                           max_instances)
    _launch_checks('find_instance_centers', [center], [torch.float32])
    B, h, w = center.shape
    if not 1 <= max_instances <= min(1024, h * w):
        raise ValueError(f'find_instance_centers: max_instances {max_instances} must be '
                         f'in [1, min(1024, {h * w})]')
    pad = (nms_kernel_size - 1) // 2
    if not _centers_shared_bytes(h, w, pad):
        raise ValueError(f'find_instance_centers: a {h} x {w} frame is more than the '
                         'kernel holds in shared memory')
    centers = torch.empty((B, max_instances, 2), dtype=torch.int32, device=center.device)
    valid = torch.empty((B, max_instances), dtype=torch.bool, device=center.device)
    _check_rc('instance_centers', _centers_kernel()(
        center.data_ptr(), centers.data_ptr(), valid.data_ptr(), B, h, w, conf_threshold,
        pad, max_instances,
        torch._C._cuda_getCurrentRawStream(center.get_device())))
    find_instance_centers.launches += 1
    return centers, valid


find_instance_centers.launches = 0


# ---------------------------------------------------------------------------
# K7: pixel grouping + foreground + consecutive relabel
# ---------------------------------------------------------------------------

def group_pixels(centers, valid, offset):
    """Plain nearest-valid-centre id of every pixel: centres (B, K, 2), valid (B, K),
    offsets (B, h, w, 2) [row, column] -> (B, h, w) int32 ids in [1, K]. The main
    path runs this fused with the foreground and the relabel in ``instance_ids``."""
    B, h, w, _ = offset.shape
    xg = torch.arange(h, dtype=offset.dtype, device=offset.device)[:, None]
    yg = torch.arange(w, dtype=offset.dtype, device=offset.device)[None, :]
    px = xg + offset[..., 0]
    py = yg + offset[..., 1]
    dx = centers[:, :, 0, None, None].to(px.dtype) - px[:, None]
    dy = centers[:, :, 1, None, None].to(py.dtype) - py[:, None]
    dist = dx * dx + dy * dy
    dist = torch.where(valid[:, :, None, None], dist, float('inf'))
    return dist.argmin(dim=1).to(torch.int32) + 1


def make_instance_seg_consecutive(instance_seg, max_ids=MAX_INSTANCES + 1):
    """Plain relabel of (B, h, w) ids in [0, max_ids) to consecutive ids per frame,
    background 0 staying 0."""
    B = instance_seg.shape[0]
    flat = instance_seg.reshape(B, -1).long()
    present = torch.zeros((B, max_ids), dtype=torch.int64, device=flat.device)
    present.scatter_(1, flat, 1)
    present[:, 0] = 1
    mapping = present.cumsum(dim=1) - 1
    return mapping.gather(1, flat).view(instance_seg.shape).to(torch.int32)


def instance_ids_plain(centers, valid, offset, segmentation, vehicles_id=1):
    """Plain version of ``instance_ids``."""
    ids = group_pixels(centers, valid, offset)
    keep = (segmentation.argmax(dim=-1) == vehicles_id) & valid.any(dim=1)[:, None, None]
    ids = torch.where(keep, ids, 0)
    return make_instance_seg_consecutive(ids, centers.shape[1] + 1)


@functools.cache
def _group_kernel():
    """fiery_group_pixels of csrc/group_pixels.cu, its argument types set once."""
    fn = _build.load('group_pixels').fiery_group_pixels
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _group_shared_bytes(h, w):
    """Shared memory a K7 block takes for (h, w) frames; 0 beyond what it holds."""
    fn = _build.load('group_pixels').fiery_group_pixels_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    return fn(h, w)


def instance_ids(centers, valid, offset, segmentation, vehicles_id=1):
    """Consecutive instance ids (B, h, w) int32 of decoded frames (kernel K7, one
    launch for every frame).

    centres (B, K, 2) int32 and valid (B, K) bool from ``find_instance_centers``;
    offset (B, h, w, 2) float32; segmentation (B, h, w, C) float32 logits. A pixel
    takes the id of its nearest valid centre after the offset if argmax_c of its
    logits is ``vehicles_id`` and the frame has a valid centre, else 0; the ids are
    then relabelled 1.. in order. A CPU tensor takes the plain version.
    """
    B, K = valid.shape
    h, w = offset.shape[1:3]
    if (centers.shape != (B, K, 2) or offset.shape != (B, h, w, 2)
            or segmentation.shape[:3] != (B, h, w)):
        raise ValueError(f'instance_ids: shapes centers {tuple(centers.shape)}, valid '
                         f'{tuple(valid.shape)}, offset {tuple(offset.shape)}, '
                         f'segmentation {tuple(segmentation.shape)} do not agree')
    if offset.device.type == 'cpu':
        return instance_ids_plain(centers, valid, offset, segmentation, vehicles_id)
    _launch_checks('instance_ids', [centers, valid, offset, segmentation],
                   [torch.int32, torch.bool, torch.float32, torch.float32])
    if not 1 <= K <= 1024:
        raise ValueError(f'instance_ids: {K} centres, the kernel takes 1 to 1024')
    if h * w and not _group_shared_bytes(h, w):
        raise ValueError(f'instance_ids: a {h} x {w} frame is more than the kernel holds '
                         'in shared memory')
    ids = torch.empty((B, h, w), dtype=torch.int32, device=offset.device)
    _check_rc('group_pixels', _group_kernel()(
        centers.data_ptr(), valid.data_ptr(), offset.data_ptr(), segmentation.data_ptr(),
        ids.data_ptr(), B, h, w, K, segmentation.shape[-1], vehicles_id,
        torch._C._cuda_getCurrentRawStream(offset.get_device())))
    instance_ids.launches += 1
    return ids


instance_ids.launches = 0


def get_instance_segmentation_and_centers(center, offset, foreground, conf_threshold=0.1,
                                          nms_kernel_size=3, max_instances=MAX_INSTANCES):
    """Decode of frames: center (B, h, w, 1), offset (B, h, w, 2), foreground (B, h, w)
    bool -> (instance_seg (B, h, w) int32 consecutive ids, centres (B, K, 2),
    valid (B, K)). The mask enters K7 as two-class logits whose class 1 is the
    foreground."""
    centers, valid = find_instance_centers(center[..., 0].contiguous(), conf_threshold,
                                           nms_kernel_size, max_instances)
    logits = torch.stack([~foreground, foreground], dim=-1).float()
    seg = instance_ids(centers, valid, offset.contiguous(), logits, vehicles_id=1)
    return seg, centers, valid


def decode_instance_predictions(output: Dict[str, torch.Tensor], conf_threshold=0.1,
                                nms_kernel_size=3, max_instances=MAX_INSTANCES,
                                vehicles_id=1):
    """Network output dict (channels-last) -> (b, s, h, w) int32 consecutive
    instance ids per frame, on the output's device: one K6 and one K7 call over all
    b * s frames."""
    seg = output['segmentation']
    b, s, h, w, C = seg.shape
    center = output['instance_center'].float().reshape(b * s, h, w).contiguous()
    centers, valid = find_instance_centers(center, conf_threshold, nms_kernel_size,
                                           max_instances)
    ids = instance_ids(centers, valid,
                       output['instance_offset'].float().reshape(b * s, h, w, 2).contiguous(),
                       seg.float().reshape(b * s, h, w, C).contiguous(), vehicles_id)
    return ids.view(b, s, h, w)


# ---------------------------------------------------------------------------
# K8: per-id centroids
# ---------------------------------------------------------------------------

def segment_centroids_plain(labels, num_slots, flow=None):
    """Plain version of ``segment_centroids``: f64 index_add_ sums in index order."""
    B, h, w = labels.shape
    dev = labels.device
    x = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    y = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    if flow is None:
        x, y = x.expand(B, h, w), y.expand(B, h, w)
    else:
        x, y = x + flow[..., 0], y + flow[..., 1]
    lab = labels.reshape(B, -1).long()
    lab = torch.where((lab >= 0) & (lab < num_slots), lab, num_slots)
    rows = (lab + torch.arange(B, device=dev)[:, None] * (num_slots + 1)).reshape(-1)
    vals = torch.stack([torch.ones_like(x), x, y], dim=-1).double().reshape(-1, 3)
    acc = torch.zeros((B * (num_slots + 1), 3), dtype=torch.float64, device=dev)
    acc.index_add_(0, rows, vals)
    acc = acc.view(B, num_slots + 1, 3)[:, :num_slots]
    counts = acc[..., :1]
    centers = (acc[..., 1:] / counts.clamp_min(1.0)).float()
    return centers, counts[..., 0] > 0


def segment_centroids_clip_plain(labels, num_slots, flow):
    """Plain version of ``segment_centroids_clip``: the counts, the grid coordinates
    and the flow-advected ones of every frame summed by one f64 index_add_ (rows in
    index order), as ``segment_centroids_plain`` sums each kind."""
    N, h, w = labels.shape
    dev = labels.device
    gx = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(N, h, w)
    gy = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(N, h, w)
    lab = labels.reshape(N, -1).long()
    lab = torch.where((lab >= 0) & (lab < num_slots), lab, num_slots)
    rows = (lab + torch.arange(N, device=dev)[:, None] * (num_slots + 1)).reshape(-1)
    vals = torch.stack([torch.ones_like(gx), gx, gy, gx + flow[..., 0], gy + flow[..., 1]],
                       dim=-1).double().reshape(-1, 5)
    acc = torch.zeros((N * (num_slots + 1), 5), dtype=torch.float64, device=dev)
    acc.index_add_(0, rows, vals)
    acc = acc.view(N, num_slots + 1, 5)[:, :num_slots]
    denom = acc[..., :1].clamp_min(1.0)
    return ((acc[..., 1:3] / denom).float(), (acc[..., 3:5] / denom).float(),
            acc[..., 0] > 0)


@functools.lru_cache(maxsize=None)
def _centroid_kernel():
    """K8's entry with its argument types set once, and the most slots a call takes
    without and with flow."""
    lib = _build.load('segment_centroids')
    fn = lib.fiery_segment_centroids_clip
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    limit = lib.fiery_segment_centroids_max_slots
    limit.argtypes = [ctypes.c_int]
    limit.restype = ctypes.c_int
    return fn, limit(0), limit(1)


def _launch_centroids(name, labels, num_slots, flow, with_grid):
    """One K8 launch over every frame of labels (N, h, w): (grid centres or None,
    flow centres or None, valid), allocated here and written whole by the kernel."""
    _launch_checks(name, [labels] + ([] if flow is None else [flow]),
                   [torch.int32, torch.float32])
    N, h, w = labels.shape
    fn, max_grid, max_flow = _centroid_kernel()
    limit = max_grid if flow is None else max_flow
    if not 1 <= num_slots <= limit or N > 65535:
        raise ValueError(f'{name}: {num_slots} slots over {N} frames; the kernel takes 1 to '
                         f'{limit} slots and at most 65535 frames')
    dev = labels.device
    grid = torch.empty((N, num_slots, 2), dtype=torch.float32, device=dev) if with_grid else None
    adv = None if flow is None else torch.empty((N, num_slots, 2), dtype=torch.float32,
                                                device=dev)
    valid = torch.empty((N, num_slots), dtype=torch.bool, device=dev)
    vec = (h * w) % 8 == 0 and labels.data_ptr() % 16 == 0 and (
        flow is None or flow.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check_rc(name, fn(labels.data_ptr(), None if flow is None else flow.data_ptr(),
                       None if grid is None else grid.data_ptr(),
                       None if adv is None else adv.data_ptr(), valid.data_ptr(), N, h, w,
                       num_slots, int(vec), stream))
    segment_centroids.launches += 1
    return grid, adv, valid


def segment_centroids(labels, num_slots, flow=None):
    """Count and mean coordinate of ids 0..num_slots-1 in each (h, w) frame of labels
    (B, h, w) int32, over the pixel grid (row, column), or over the grid plus flow
    (B, h, w, 2) float32 (kernel K8). Returns centres (B, num_slots, 2) float32 and
    valid (B, num_slots) bool (count > 0); ids outside [0, num_slots) are dropped.
    Sums are f64. A CPU tensor takes the plain version. ``segment_centroids.launches``
    counts every K8 launch, this entry's and ``segment_centroids_clip``'s."""
    if labels.dim() != 3 or (flow is not None and flow.shape != labels.shape + (2,)):
        raise ValueError(f'segment_centroids: labels {tuple(labels.shape)} must be '
                         f'(B, h, w) and flow (B, h, w, 2)')
    if labels.device.type == 'cpu':
        return segment_centroids_plain(labels, num_slots, flow)
    grid, adv, valid = _launch_centroids('segment_centroids', labels, num_slots, flow,
                                         with_grid=flow is None)
    return (grid if flow is None else adv), valid


segment_centroids.launches = 0


def segment_centroids_clip(labels, num_slots, flow):
    """Both kinds of centroid of every frame in one K8 launch: labels (N, h, w) int32,
    flow (N, h, w, 2) float32 -> (grid centres (N, num_slots, 2), flow-advected
    centres (N, num_slots, 2), valid (N, num_slots)), each kind as
    ``segment_centroids`` computes it. A CPU tensor takes the plain version."""
    if labels.dim() != 3 or flow.shape != labels.shape + (2,):
        raise ValueError(f'segment_centroids_clip: labels {tuple(labels.shape)} must be '
                         f'(N, h, w) and flow {tuple(flow.shape)} (N, h, w, 2)')
    if labels.device.type == 'cpu':
        return segment_centroids_clip_plain(labels, num_slots, flow)
    return _launch_centroids('segment_centroids_clip', labels, num_slots, flow,
                             with_grid=True)


# ---------------------------------------------------------------------------
# Device temporal consistency (exact optimal assignment, no host round trip)
# ---------------------------------------------------------------------------

def make_instance_id_temporally_consistent_device(pred_inst, future_flow,
                                                  matching_threshold=3.0,
                                                  max_instances=MAX_INSTANCES):
    """pred_inst (b, s, h, w) int consecutive per-frame ids in [0, max_instances],
    future_flow (b, s, h, w, 2) -> (b, s, h, w) int32 ids consistent across time.

    The JAX package's device tracker, vmapped over b: each frame's centroids are
    matched to the previous frame's flow-advected centroids by an exact assignment
    on a (max_instances + 1)^2 padded cost (distances clipped at 10x the threshold,
    invalid pairs at 1e4, only the live previous tracks augmented); a match is
    accepted under ``matching_threshold`` and every other instance takes a fresh id.
    Cumulative ids live in s * max_instances + 1 slots.

    Each frame's consistent ids are an injective relabelling of its per-frame ids
    (frame 0 as it is, then each step's ``lut``), so a track's pixels are the pixels
    of one per-frame id. One K8 launch therefore gives every frame's per-id counts,
    grid centroids and advected centroids, and each step scatters the previous
    frame's advected centroids through its ``lut`` into the track slots. A step is
    then one K9 launch and tensor ops that never read a value on the host.
    Centroid sums are f64 (the JAX device path sums in f32), so centroids differ
    from it by f32 rounding only.
    """
    b, s, h, w = pred_inst.shape
    dev = pred_inst.device
    K = max_instances + 1
    K_total = s * max_instances + 1
    pred_inst = pred_inst.to(torch.int32)
    frames = [pred_inst[:, 0]]
    slot_ids = torch.arange(K, device=dev)
    if s > 1:
        grid_c, adv_c, valid = segment_centroids_clip(
            pred_inst.reshape(b * s, h, w).contiguous(), K,
            future_flow.float().reshape(b * s, h, w, 2).contiguous())
        grid_c, valid = grid_c.view(b, s, K, 2), valid.view(b, s, K)
        # each id's advected centroid and whether it is a track (not background,
        # not empty), and the track slots they scatter into, one frame a step
        live_ids = valid & (slot_ids > 0)
        tracked = torch.cat([adv_c.view(b, s, K, 2), live_ids[..., None].float()], dim=-1)
        tracks = torch.zeros((b, s, K_total + 1, 3), dtype=torch.float32, device=dev)
    track_ids = torch.arange(K_total, device=dev).expand(b, K_total)
    lut = slot_ids.expand(b, K)        # frame 0's ids are its track ids
    next_free = pred_inst[:, 0].reshape(b, -1).amax(dim=1).long() + 1
    for t in range(1, s):
        cur = pred_inst[:, t]
        # the previous frame's tracks: its ids' advected centroids through its lut;
        # background and ids without pixels go to the dropped column K_total
        cols = torch.where(live_ids[:, t - 1], lut, K_total)
        prev = tracks[:, t - 1].scatter_(1, cols[..., None].expand(b, K, 3),
                                         tracked[:, t - 1])[:, :K_total]
        prev_centers_all, prev_valid_all = prev[..., :2], prev[..., 2] > 0
        cur_centers, cur_valid = grid_c[:, t], valid[:, t]

        # compact the live previous ids into slots 1..K-1; slot 0 stays background
        rank = prev_valid_all.long().cumsum(dim=1) - 1
        slot = torch.where(prev_valid_all & (rank < K - 1), rank + 1, K)
        prev_slot_ids = torch.zeros((b, K + 1), dtype=torch.int64, device=dev).scatter_(
            1, slot, track_ids)[:, :K]
        prev_centers = prev_centers_all.gather(1, prev_slot_ids[..., None].expand(b, K, 2))
        prev_valid = prev_valid_all.gather(1, prev_slot_ids) & (prev_slot_ids > 0)

        diff = prev_centers[:, :, None] - cur_centers[:, None, :]
        dist = sqrt_rn((diff * diff).sum(dim=-1))
        valid_pair = prev_valid[:, :, None] & cur_valid[:, None, :]
        valid_pair[:, :, 0] = False
        valid_pair[:, 0, :] = False
        dist = torch.where(valid_pair, dist, float('inf'))
        cost = torch.where(valid_pair, dist.clamp(max=10.0 * matching_threshold), 1e4)
        n_rows = prev_valid.sum(dim=1, dtype=torch.int32) + 1
        col4row = linear_sum_assignment(cost.contiguous(), n_rows=n_rows)

        # skipped rows (-1) scatter into the dropped column K
        cols = torch.where(col4row < 0, K, col4row).long()
        row4col = torch.zeros((b, K + 1), dtype=torch.int64, device=dev).scatter_(
            1, cols, slot_ids.expand(b, K))[:, :K]
        best_prev = prev_slot_ids.gather(1, row4col)
        dsel = dist.gather(1, row4col[:, None, :])[:, 0]
        matched = (dsel < matching_threshold) & cur_valid
        unmatched = cur_valid & ~matched & (slot_ids > 0)
        new_rank = unmatched.long().cumsum(dim=1) - 1
        lut = torch.where(matched, best_prev, next_free[:, None] + new_rank)
        lut[:, 0] = 0
        lut = torch.where(cur_valid | (slot_ids == 0), lut, 0)
        frames.append(lut.gather(1, cur.reshape(b, -1).long()).view(b, h, w).to(torch.int32))
        next_free = next_free + unmatched.sum(dim=1)
    return torch.stack(frames, dim=1)


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


# ---------------------------------------------------------------------------
# Host temporal consistency (scipy Hungarian on numpy ids)
# ---------------------------------------------------------------------------

def _segment_centroids(labels, coord_maps, ids):
    """Mean coordinate of each id in ``ids`` under per-pixel coordinate fields
    (f64 bincounts). Returns (len(ids), len(coord_maps))."""
    flat = labels.ravel()
    size = int(ids.max()) + 1
    counts = np.bincount(flat, minlength=size)[ids].astype(np.float64)
    sums = [np.bincount(flat, weights=c.ravel().astype(np.float64),
                        minlength=size)[ids] for c in coord_maps]
    return np.stack(sums, axis=-1) / counts[:, None]


def make_instance_id_temporally_consistent(pred_inst, future_flow,
                                           matching_threshold=3.0):
    """pred_inst: (1, s, h, w) int numpy; future_flow: (1, s, h, w, 2) numpy.

    Returns (1, s, h, w) with ids consistent across time: each frame's centroids
    are matched against the previous frame's flow-advected centroids (Hungarian
    optimum, accepted under the distance threshold), and unmatched detections get
    fresh ids. Assumes per-frame ids are consecutive 1..N.
    """
    pred_inst = np.asarray(pred_inst)
    future_flow = np.asarray(future_flow)
    assert pred_inst.shape[0] == 1, 'Assumes batch size = 1'
    seq = pred_inst[0]
    seq_len, h, w = seq.shape
    pixel_grid = np.stack(np.meshgrid(np.arange(h, dtype=np.float32),
                                      np.arange(w, dtype=np.float32),
                                      indexing='ij'))

    tracked = [seq[0]]
    next_fresh_id = int(seq[0].max()) + 1

    for t in range(1, seq_len):
        prev_frame, cur_frame = tracked[-1], seq[t]
        prev_ids = np.unique(prev_frame)[1:]
        cur_ids = np.unique(cur_frame)[1:]
        if len(prev_ids) == 0 or len(cur_ids) == 0:
            tracked.append(cur_frame)
            continue

        # where the previous instances should be now, according to the flow
        advected = pixel_grid + np.moveaxis(future_flow[0, t - 1], -1, 0)
        prev_pos = _segment_centroids(prev_frame, advected, prev_ids)
        cur_pos = _segment_centroids(cur_frame, pixel_grid, cur_ids)

        cost = np.linalg.norm(prev_pos[:, None] - cur_pos[None, :], axis=-1)
        rows, cols = scipy.optimize.linear_sum_assignment(cost)
        accepted = cost[rows, cols] < matching_threshold

        relabel = np.zeros(int(cur_ids.max()) + 1, dtype=seq.dtype)
        relabel[cur_ids[cols[accepted]]] = prev_ids[rows[accepted]]
        unmatched = np.setdiff1d(cur_ids, cur_ids[cols[accepted]])
        relabel[unmatched] = next_fresh_id + np.arange(len(unmatched))
        next_fresh_id += len(unmatched)
        tracked.append(relabel[cur_frame])

    return np.stack(tracked)[None]


def predict_instance_segmentation_and_trajectories(
        output, compute_matched_centers=False, make_consistent=True, vehicles_id=1):
    """Postprocessing with the host tracker: decode on the output's device, ids to the
    host as int16 and the flow rounded to f16 (the JAX package's cast points), then
    the scipy tracker. Returns numpy (b, s, h, w) consistent ids, optionally with
    matched centre trajectories {id: (T, 2) array in (y, x)}."""
    decode_in = {k: output[k] for k in
                 ['segmentation', 'instance_center', 'instance_offset']}
    pred_inst = decode_instance_predictions(decode_in, vehicles_id=vehicles_id).to(
        torch.int16).cpu().numpy()
    batch_size, seq_len = pred_inst.shape[:2]

    if make_consistent:
        flow = output.get('instance_flow')
        if flow is None:
            flow = torch.zeros_like(output['instance_offset'])
        flow = flow.to(torch.float16).cpu().numpy().astype(np.float32)
        consistent = np.concatenate([
            make_instance_id_temporally_consistent(pred_inst[b:b + 1], flow[b:b + 1])
            for b in range(batch_size)], axis=0)
    else:
        consistent = pred_inst

    if compute_matched_centers:
        assert batch_size == 1
        matched_centers = {}
        h, w = consistent.shape[-2:]
        grid = np.stack(np.meshgrid(np.arange(h, dtype=np.float32),
                                    np.arange(w, dtype=np.float32), indexing='ij'))
        for instance_id in np.unique(consistent[0, 0])[1:]:
            for t in range(seq_len):
                mask = consistent[0, t] == instance_id
                if mask.sum() > 0:
                    matched_centers.setdefault(instance_id, []).append(
                        grid[:, mask].mean(axis=-1))
        matched_centers = {k: np.stack(v)[:, ::-1] for k, v in matched_centers.items()}
        return consistent, matched_centers

    return consistent
