"""Visualisation: the flow colour wheel, heatmaps, instance maps and the
ground-truth-against-prediction video panels (the port's copy of
fiery_tpu/utils/visualisation.py, in numpy alone).

Arrays are channels-last; panels come back as (1, T, H, W, 3) uint8. The heatmaps'
colour map is matplotlib's ``jet``, carried here as its segment data and the
256-entry lookup table that matplotlib builds from it (``JET_LUT``), applied as
``matplotlib.colors.Colormap.__call__`` does, so that no matplotlib is needed
(tests/test_torch_visualisation.py holds both against matplotlib's).
"""

import colorsys

import numpy as np

# matplotlib's _cm._jet_data: (x, y0, y1) rows of a piecewise-linear map a channel
JET_SEGMENTS = {
    'red': ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    'green': ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    'blue': ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
JET_N = 256


def _lookup_table(n, segments):
    """matplotlib.colors._create_lookup_table at gamma 1: the segments sampled at n
    equidistant points of [0, 1]."""
    data = np.array(segments, dtype=np.float64)
    x = data[:, 0] * (n - 1)
    y0, y1 = data[:, 1], data[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _jet_lut():
    """(JET_N + 3, 4) RGBA: the JET_N colours, then under (the first colour), over
    (the last) and bad (transparent black), as matplotlib's Colormap._init and
    _set_extremes lay them out."""
    lut = np.ones((JET_N + 3, 4), dtype=np.float64)
    for c, name in enumerate(('red', 'green', 'blue')):
        lut[:JET_N, c] = _lookup_table(JET_N, JET_SEGMENTS[name])
    lut[JET_N] = lut[0]
    lut[JET_N + 1] = lut[JET_N - 1]
    lut[JET_N + 2] = 0.0
    return lut


JET_LUT = _jet_lut()


def jet(values):
    """matplotlib.cm.jet(values) for float or integer arrays: (..., 4) float64 RGBA.
    A float in [0, 1] picks entry floor(x * 256) (1.0 the last), an integer its
    entry; below the range the under colour, above it the over colour, NaN the
    bad one."""
    xa = np.array(values, copy=True)
    if xa.dtype.kind == 'f':
        xa *= JET_N
        xa[xa == JET_N] = JET_N - 1
    mask_under = xa < 0
    mask_over = xa >= JET_N
    mask_bad = np.isnan(xa)
    with np.errstate(invalid='ignore'):
        xa = xa.astype(int)
    xa[mask_under] = JET_N
    xa[mask_over] = JET_N + 1
    xa[mask_bad] = JET_N + 2
    return JET_LUT.take(xa, axis=0, mode='clip')


DEFAULT_COLORMAP = jet


def _make_colorwheel():
    """Baker et al. (ICCV 2007) optical-flow colour wheel: 55 hues interpolated
    along the 6 primary-colour transitions R->Y->G->C->B->M->R with the standard
    per-segment lengths (each segment changes one RGB channel, in steps of
    floor(255*i/len)/255 as the Middlebury flow code quantises them)."""
    seg_lens = np.array([15, 6, 4, 11, 13, 6])
    anchors = np.array([[255, 0, 0], [255, 255, 0], [0, 255, 0], [0, 255, 255],
                        [0, 0, 255], [255, 0, 255], [255, 0, 0]], dtype=np.float64)
    seg_id = np.repeat(np.arange(len(seg_lens)), seg_lens)
    seg_start = np.repeat(np.cumsum(seg_lens) - seg_lens, seg_lens)
    pos = np.arange(seg_lens.sum()) - seg_start
    frac = np.floor(255 * pos / np.repeat(seg_lens, seg_lens)) / 255
    return anchors[seg_id] + frac[:, None] * (anchors[seg_id + 1] - anchors[seg_id])


_COLORWHEEL = _make_colorwheel()


def compute_color(u, v):
    """Map (u, v) flow components to RGB in [0, 1] through the colour wheel.

    The flow's angle picks a hue (linearly between wheel entries, wrapping);
    a radius <= 1 blends towards white, a radius > 1 is dimmed to 75%
    (Middlebury's convention)."""
    nan_mask = np.isnan(u) | np.isnan(v)
    u = np.where(nan_mask, 0.0, u)
    v = np.where(nan_mask, 0.0, v)

    ncols = _COLORWHEEL.shape[0]
    rad = np.sqrt(u * u + v * v)[..., None]
    pos = (np.arctan2(-v, -u) / np.pi + 1) / 2 * (ncols - 1)   # [0, ncols-1]
    k0 = np.floor(pos).astype(int)
    f = (pos - k0)[..., None]
    col = ((1 - f) * _COLORWHEEL[k0] + f * _COLORWHEEL[(k0 + 1) % ncols]) / 255
    col = np.where(rad <= 1, 1 - rad * (1 - col), 0.75 * col)
    return col * ~nan_mask[..., None]


def flow_to_image(flow, autoscale=False):
    """(h, w, 2) flow -> (h, w, 3) uint8 colour image."""
    u = np.array(flow[..., 0], dtype=np.float64)
    v = np.array(flow[..., 1], dtype=np.float64)
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = np.max(rad) if rad.size else 1.0
    if autoscale:
        u = u / (maxrad + np.finfo(float).eps)
        v = v / (maxrad + np.finfo(float).eps)
    return np.uint8(compute_color(u, v) * 255)


def _normalise(image):
    lower = np.min(image)
    delta = np.max(image) - lower
    if delta == 0:
        delta = 1
    return (image.astype(np.float32) - lower) / delta


def heatmap_image(image, cmap=DEFAULT_COLORMAP, autoscale=True):
    """(h, w) float -> (h, w, 3) uint8 colourised heatmap."""
    if autoscale:
        image = _normalise(image)
    return np.uint8(cmap(image)[..., :3] * 255)


def make_contour(img, colour=(0, 0, 0), double_line=False):
    """Draw a 1 (or 2) pixel frame around an (h, w, 3) image."""
    out = img.copy()
    out[0, :] = colour
    out[-1, :] = colour
    out[:, 0] = colour
    out[:, -1] = colour
    if double_line:
        out[1, :] = colour
        out[-2, :] = colour
        out[:, 1] = colour
        out[:, -2] = colour
    return out


def generate_instance_colours(instance_map):
    """Distinct colours per instance id: golden-ratio hue walk in HSV."""
    colours = {}
    for instance_id, global_id in instance_map.items():
        if global_id == 0:
            colours[instance_id] = np.array([0, 0, 0], dtype=np.uint8)
            continue
        hue = (global_id * 0.61803398875) % 1.0
        sat = 0.65 + 0.35 * ((global_id * 7) % 3) / 2.0
        val = 0.75 + 0.25 * ((global_id * 5) % 2)
        rgb = colorsys.hsv_to_rgb(hue, sat, val)
        colours[instance_id] = np.uint8(np.asarray(rgb) * 255)
    return colours


def plot_instance_map(instance_image, instance_map, instance_colours=None,
                      bg_image=None):
    """(h, w) int instance ids -> (h, w, 3) uint8 image (white background)."""
    instance_image = np.asarray(instance_image)
    if instance_colours is None:
        instance_colours = generate_instance_colours(instance_map)
    if bg_image is None:
        plot_image = 255 * np.ones((*instance_image.shape, 3), dtype=np.uint8)
    else:
        plot_image = bg_image.copy()
    for key, value in instance_colours.items():
        plot_image[instance_image == key] = value
    return plot_image


def to_host(x):
    """A tensor (on any device) or array -> numpy array."""
    if hasattr(x, 'detach'):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def visualise_output(labels, output, cfg):
    """Ground truth against prediction, a 5-row panel a frame: (1, T, H_total,
    W_total, 3) uint8. Rows: instances, future flow, semantic segmentation,
    centerness, offset; columns: ground truth | prediction.

    labels and output are the dicts of ``Trainer.eval_step`` (tensors on any
    device, or numpy arrays). The instances are decoded where the output lies and
    tracked on the host (``predict_instance_segmentation_and_trajectories``); the
    rest is drawn on the host from the first sample of the batch.
    """
    from fiery_tpu_torch.postprocess.instance import (
        predict_instance_segmentation_and_trajectories)

    semantic_colours = np.array([[255, 255, 255], [0, 0, 0]], dtype=np.uint8)
    consistent_instance_seg = predict_instance_segmentation_and_trajectories(
        output, compute_matched_centers=False)

    sequence_length = consistent_instance_seg.shape[1]
    b = 0
    video = []

    def panel(instance_t, seg_t, flow_t, center_t, offset_t):
        unique_ids = np.unique(instance_t)[1:]
        instance_map = dict(zip(unique_ids, unique_ids))
        instance_plot = make_contour(
            plot_instance_map(instance_t, instance_map)[::-1, ::-1])
        semantic_plot = make_contour(semantic_colours[seg_t[::-1, ::-1]])
        if flow_t is not None:
            flow_masked = np.where((seg_t == 1)[..., None], flow_t, 0.0)
            flow_plot = make_contour(flow_to_image(flow_masked)[::-1, ::-1])
        else:
            flow_plot = np.zeros_like(semantic_plot)
        center_plot = make_contour(heatmap_image(center_t)[::-1, ::-1])
        offset_masked = np.where((seg_t == 1)[..., None], offset_t, 0.0)
        offset_plot = make_contour(flow_to_image(offset_masked)[::-1, ::-1])
        return np.concatenate(
            [instance_plot, flow_plot, semantic_plot, center_plot, offset_plot], axis=0)

    flow_enabled = cfg.INSTANCE_FLOW.ENABLED
    keys = ['instance', 'segmentation', 'centerness', 'offset'] + (
        ['flow'] if flow_enabled else [])
    gt = {k: to_host(labels[k][b]) for k in keys}
    pred = {k: to_host(output[k][b]) for k in
            ['instance_center', 'instance_offset'] + (
                ['instance_flow'] if flow_enabled else [])}
    seg_pred = to_host(output['segmentation'][b].argmax(-1))

    for t in range(sequence_length):
        gt_panel = panel(
            gt['instance'][t],
            gt['segmentation'][t],
            gt['flow'][t] if flow_enabled else None,
            gt['centerness'][t, :, :, 0],
            gt['offset'][t])
        pred_panel = panel(
            consistent_instance_seg[b, t],
            seg_pred[t],
            pred['instance_flow'][t] if flow_enabled else None,
            pred['instance_center'][t, :, :, 0],
            pred['instance_offset'][t])
        video.append(np.concatenate([gt_panel, pred_panel], axis=1))

    return np.stack(video)[None]  # (1, T, H, W, 3)


def convert_figure_numpy(figure):
    """A matplotlib figure -> (h, w, 3) uint8 numpy image."""
    figure.canvas.draw()
    buf = np.asarray(figure.canvas.buffer_rgba())
    return buf[..., :3].copy()
