"""Training losses, channels-last (counterpart of fiery_tpu/training/losses.py).

Top-k hardest-pixel weighted cross-entropy for the segmentation, L1/L2 spatial
regression with ignore masks and a per-frame future discount, the closed-form KL
between diagonal Gaussians, and learned homoscedastic task weights. The top-k mean
takes the exact k-th largest value of each row from the ``kth_largest`` kernel
(csrc/kth_largest.cu) and spreads its gradient over every entry >= that value, as
the JAX package's custom VJP does.
"""

import ctypes

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.parallel.mesh import gather_rows
from fiery_tpu_torch.utils.device import device_constant


def kth_largest_plain(x, k):
    """Plain version of ``kth_largest``."""
    return torch.topk(x, k, dim=-1).values[..., -1:]


# K3's launch (csrc/kth_largest.cu): a row is split over a cluster of blocks, each of
# which holds 16,384 keys in registers and reads any more from memory in every pass
KTH_KEYS_PER_BLOCK = 16384


def kth_largest_plan(n):
    """The blocks a row of n keys of K3's launch: 4, or 8 when 4 would not hold the
    row in registers (``chip_smoke.py`` times the loss's rows on 8 beside 4)."""
    return 4 if n <= 4 * KTH_KEYS_PER_BLOCK else 8


def kth_largest(x, k):
    """Exact k-th largest value along the last axis (kernel K3,
    csrc/kth_largest.cu): x (..., n) float32 -> (..., 1), ties counted with
    multiplicity. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    n = x.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f'kth_largest: k = {k} outside [1, {n}]')
    if x.device.type == 'cpu':
        return kth_largest_plain(x, k)
    if x.device.type != 'cuda' or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f'kth_largest: x must be a contiguous float32 CUDA tensor, got '
                         f'{x.dtype} on {x.device}')
    rows = x.numel() // n
    cluster = kth_largest_plan(n)
    if rows * cluster >= 2 ** 31:
        raise ValueError(f'kth_largest: {rows} rows of {n} need more than 2^31 blocks')
    fn = _build.load('kth_largest').fiery_kth_largest
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), out.data_ptr(), rows, n, k, cluster, stream)
    if rc != 0:
        raise RuntimeError(f'kth_largest kernel launch failed: CUDA error {rc}')
    kth_largest.launches += 1
    return out


kth_largest.launches = 0


def _top_k_sum_from_threshold(loss, kth, k):
    """Sum of the k largest entries of each row given the exact k-th value: the
    entries strictly above it plus the right multiplicity of the value itself
    (exact under ties)."""
    gt = (loss > kth).to(loss.dtype)
    return (loss * gt).sum(-1) + (k - gt.sum(-1)) * kth[..., 0]


class _TopKMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loss, k):
        kth = kth_largest(loss.contiguous(), k)
        ctx.save_for_backward(loss, kth)
        ctx.k = k
        n_rows = loss.numel() // loss.shape[-1]
        return _top_k_sum_from_threshold(loss, kth, k).sum() / (n_rows * k)

    @staticmethod
    def backward(ctx, g):
        loss, kth = ctx.saved_tensors
        k = ctx.k
        mask = (loss >= kth).to(loss.dtype)
        count = mask.sum(-1, keepdim=True).clamp_min(1.0)
        n_rows = loss.numel() // loss.shape[-1]
        # each row's total gradient g / n_rows, spread over the entries >= kth
        return g * mask * (k / count) / (n_rows * k), None


def top_k_mean(loss, k):
    """Mean of the k largest entries along the last axis, averaged over the rows.

    The forward equals the mean of torch.topk(loss, k).values. The backward is the
    JAX package's threshold mask: each row's gradient is spread evenly over every
    entry >= the k-th value, so with ties at the k-th value more than k entries
    share it (a valid subgradient; torch.topk's autograd would pick exactly k).
    """
    return _TopKMean.apply(loss, k)


def spatial_regression_loss(prediction, target, norm, ignore_index=255,
                            future_discount=1.0, group=None):
    """L1 (norm 1) or L2 (norm 2) regression of (b, s, h, w, c) maps, summed over
    channels, discounted by future_discount ** t, averaged over the pixels whose
    first target channel is not ignore_index (0 when there are none).

    With a process ``group`` (data-parallel, W ranks) the count is the global
    batch's (all-reduced), and the rank's sum is scaled by W: the ranks' average of
    their values (and of their gradients, as DDP takes it) is then the global
    batch's loss, which a per-rank ratio averaged would not be. Under the BEV
    spatial axis the group is the world, whose ranks hold every sample's rows once."""
    if prediction.dim() != 5:
        raise ValueError(f'spatial_regression_loss: expected (b, s, h, w, c), got '
                         f'{tuple(prediction.shape)}')
    mask = (target[..., :1] != ignore_index).to(prediction.dtype)
    if norm == 1:
        loss = (prediction - target).abs()
    elif norm == 2:
        loss = (prediction - target) ** 2
    else:
        raise ValueError(f'Expected norm 1 or 2, got {norm}')
    loss = loss.sum(-1, keepdim=True)
    s = loss.shape[1]
    discounts = future_discount ** torch.arange(s, dtype=loss.dtype, device=loss.device)
    loss = loss * discounts[None, :, None, None, None]
    denom = mask.sum()
    total = (loss * mask).sum()
    if group is not None:
        dist.all_reduce(denom, group=group)
        total = total * dist.get_world_size(group)
    return torch.where(denom > 0, total / denom.clamp_min(1.0), torch.zeros_like(denom))


def segmentation_loss(prediction, target, class_weights, ignore_index=255,
                      use_top_k=False, top_k_ratio=1.0, future_discount=1.0, rows=None):
    """Class-weighted cross-entropy of (b, s, h, w, n_classes) logits against
    (b, s, h, w) labels, zero at ignored pixels (which stay in the denominator),
    discounted per frame, then the mean of each frame's int(top_k_ratio * h * w)
    largest pixels (use_top_k) or of all of them. ``rows``: the RowShare whose rows
    the maps hold (the BEV spatial axis); the pixels' losses are then gathered over
    its group, and the mean and k are the whole grid's, on every rank."""
    b, s, h, w, n = prediction.shape
    class_weights = device_constant(class_weights, prediction.dtype, prediction.device)
    logp = F.log_softmax(prediction, dim=-1)
    tgt = target.clamp(0, n - 1).long()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    loss = torch.where(target != ignore_index, nll * class_weights[tgt],
                       torch.zeros_like(nll))
    discounts = future_discount ** torch.arange(s, dtype=loss.dtype, device=loss.device)
    loss = loss * discounts[None, :, None, None]
    if rows is not None:
        loss = gather_rows(loss, 2, rows)
        h = loss.shape[2]
    loss = loss.reshape(b, s, h * w)
    if use_top_k:
        return top_k_mean(loss, int(top_k_ratio * h * w))
    return loss.mean()


def probabilistic_loss(output):
    """KL(future || present) of diagonal Gaussians, summed over the latent dim and
    averaged over the batch."""
    present_mu, present_log_sigma = output['present_mu'], output['present_log_sigma']
    future_mu, future_log_sigma = output['future_mu'], output['future_log_sigma']
    var_future = torch.exp(2.0 * future_log_sigma)
    var_present = torch.exp(2.0 * present_log_sigma)
    kl_div = (present_log_sigma - future_log_sigma - 0.5
              + (var_future + (future_mu - present_mu) ** 2) / (2.0 * var_present))
    return kl_div.sum(-1).mean()


def init_uncertainty_weights(instance_flow_enabled=True):
    """The learned log-variance task weights, zero-initialised scalars."""
    names = ['segmentation_weight', 'centerness_weight', 'offset_weight']
    if instance_flow_enabled:
        names.append('flow_weight')
    return nn.ParameterDict({n: nn.Parameter(torch.zeros(())) for n in names})


def compute_losses(output, labels, uncertainty_weights, cfg, group=None, rows=None):
    """The loss dict of a training step: each task loss scaled by its learned
    uncertainty weight, with the weights' own regularisers, and the weighted KL.
    ``group``: the process group of a data-parallel step (the regression losses'
    global count, ``spatial_regression_loss``), or None. ``rows``: the RowShare
    of the BEV spatial axis, whose rows the outputs and labels hold, or None.

    labels: 'segmentation' (b, s, h, w) int, 'centerness' (b, s, h, w, 1),
    'offset' (b, s, h, w, 2) and, with instance flow, 'flow' (b, s, h, w, 2).
    """
    uw = uncertainty_weights
    ignore, discount = cfg.DATASET.IGNORE_INDEX, cfg.FUTURE_DISCOUNT
    loss = {}
    loss['segmentation'] = 1.0 / torch.exp(uw['segmentation_weight']) * segmentation_loss(
        output['segmentation'], labels['segmentation'],
        class_weights=cfg.SEMANTIC_SEG.WEIGHTS, ignore_index=ignore,
        use_top_k=cfg.SEMANTIC_SEG.USE_TOP_K, top_k_ratio=cfg.SEMANTIC_SEG.TOP_K_RATIO,
        future_discount=discount, rows=rows)
    loss['segmentation_uncertainty'] = 0.5 * uw['segmentation_weight']

    loss['instance_center'] = 1.0 / (2.0 * torch.exp(uw['centerness_weight'])) * \
        spatial_regression_loss(output['instance_center'], labels['centerness'], norm=2,
                                future_discount=discount, group=group)
    loss['centerness_uncertainty'] = 0.5 * uw['centerness_weight']

    loss['instance_offset'] = 1.0 / (2.0 * torch.exp(uw['offset_weight'])) * \
        spatial_regression_loss(output['instance_offset'], labels['offset'], norm=1,
                                ignore_index=ignore, future_discount=discount, group=group)
    loss['offset_uncertainty'] = 0.5 * uw['offset_weight']

    if cfg.INSTANCE_FLOW.ENABLED:
        loss['instance_flow'] = 1.0 / (2.0 * torch.exp(uw['flow_weight'])) * \
            spatial_regression_loss(output['instance_flow'], labels['flow'], norm=1,
                                    ignore_index=ignore, future_discount=discount, group=group)
        loss['flow_uncertainty'] = 0.5 * uw['flow_weight']

    if cfg.PROBABILISTIC.ENABLED:
        loss['probabilistic'] = cfg.PROBABILISTIC.WEIGHT * probabilistic_loss(output)
    return loss
