"""Serving entry points: build the model, give it weights, answer a request.

A request is one clip: the past and present frames of every camera with their
calibration and ego-motion. The entry points run on the CUDA card unless the
caller passes ``device='cpu'``; without a card they raise rather than quietly
running on the CPU.

    cfg = get_cfg(argparse.Namespace(config_file=BASELINE, opts=[]))
    model = build_fiery(cfg)                  # on cuda
    init_params(model, seed=0)                # or load_state_dict(state_dict_from_jax(...))
    calibrate_batchnorm(model, [make_request(cfg, seed=s) for s in (6, 7)])
    out = predict(model, make_request(cfg, seed=1))
    out, ids = predict_instances(model, make_request(cfg, seed=1))  # + (1, 5, 200, 200) ids

The served form, as the JAX package serves it: every BatchNorm folded into its conv
in f32 before the bf16 cast (``utils/bn_fold.py``), and both requests captured as
CUDA graphs at a fixed batch (``serve_graph.py``), each answered by one replay:

    state_dict = seeded_state_dict(cfg, seed=0)   # or a checkpoint's f32 weights
    served = build_served(cfg, state_dict)        # fold, cast, capture
    out = served.predict(make_request(cfg, seed=1))
    out, ids = served.predict_instances(make_request(cfg, seed=1))
    folded = build_fiery(cfg, state_dict=state_dict, fold_bn=True)   # the same, eager

The levers come as overrides, e.g. the sparse, warp-free combination:
    cfg = get_cfg(argparse.Namespace(config_file=BASELINE,
                                     opts=['LIFT.TOPK', '8', 'LIFT.WARP_FREE', 'True']))
"""

import math
import os

import numpy as np
import torch

from fiery_tpu_torch.evaluate import device_consistent
from fiery_tpu_torch.models.fiery import Fiery, FieryConfig
from fiery_tpu_torch.postprocess.instance import predict_instance_segmentation_and_trajectories
from fiery_tpu_torch.serve_graph import ServedFiery
from fiery_tpu_torch.utils.bn_fold import fold_batchnorm
from fiery_tpu_torch.utils.device import resolve_device

BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'configs',
                        'baseline.yml')


def build_fiery(cfg, device=None, state_dict=None, fold_bn=False):
    """Eval-mode Fiery for a CfgNode on ``device`` (default: cuda, which must then
    exist). With PRECISION 16 the convolution weights are bf16; BatchNorm and the
    buffers stay f32. ``state_dict`` (f32) is loaded before that cast, with every
    BatchNorm folded into its conv first under ``fold_bn``."""
    device = resolve_device(device)
    model = Fiery(FieryConfig.from_cfg(cfg)).eval()
    if state_dict is not None:
        if fold_bn:
            state_dict, _ = fold_batchnorm(state_dict, model)
        model.load_state_dict(state_dict)
    elif fold_bn:
        raise ValueError('fold_bn folds the weights of a state_dict: pass one')
    model.to(device)
    dtype = model.cfg.compute_dtype
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dtype)
    return model


def init_params(model, seed):
    """Seeded random weights, drawn on the CPU so every device gets the same ones:
    He (fan_out) normal conv kernels, zero biases, identity BatchNorm."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
            elif isinstance(m, torch.nn.modules.conv._ConvNd):
                fan_out = m.out_channels * math.prod(m.kernel_size) // m.groups
                w = torch.randn(m.weight.shape, generator=g) * math.sqrt(2.0 / fan_out)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def seeded_state_dict(cfg, seed=0, device=None):
    """The f32 state_dict of ``init_params(seed)`` with ``calibrate_batchnorm`` on
    the requests of seeds 6 and 7 (on ``device``): the random weights that the
    scripts serve, with the conv weights left f32. The statistics are those of the
    bf16 model of the same seed, as the convolutions compute in the activations'
    dtype whatever their weights' dtype."""
    model = Fiery(FieryConfig.from_cfg(cfg)).eval().to(resolve_device(device))
    init_params(model, seed)
    calibrate_batchnorm(model, [make_request(cfg, seed=s) for s in (6, 7)])
    return model.state_dict()


def build_served(cfg, state_dict, device=None, batch=1):
    """The served form on the card: ``state_dict`` (f32) folded, cast and captured
    as CUDA graphs at ``batch`` (``serve_graph.ServedFiery``); raises on the CPU."""
    return ServedFiery(build_fiery(cfg, device, state_dict, fold_bn=True), cfg, batch)


def calibrate_batchnorm(model, requests):
    """Set every BatchNorm's running statistics to the batch statistics of a few
    requests batched together (the pooled BatchNorms see one value per clip), so
    that random weights give unit-scale activations, as trained weights do (with
    identity statistics a deep random net grows them to 1e5). The model runs its
    eval path (the trimmed temporal model) with only the BatchNorms in training
    mode."""
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None          # cumulative average: one batch sets the statistics
    device = next(model.parameters()).device
    args = [torch.as_tensor(np.concatenate([r[k] for r in requests])).to(device)
            for k in ('image', 'intrinsics', 'extrinsics', 'future_egomotion')]
    training = model.training
    model.eval()
    for m in bns:
        m.train()
    with torch.no_grad():
        model(*args)
    model.train(training)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    return model


def make_request(cfg, seed):
    """A seeded clip for ``cfg``: uint8 images (1, rf, n, H, W, 3), a rig of cameras
    looking outwards (intrinsics (1, rf, n, 3, 3), extrinsics (1, rf, n, 4, 4)) and
    a small forward ego-motion with a slight yaw (1, rf, 6). Numpy arrays."""
    rng = np.random.RandomState(seed)
    s, n = cfg.TIME_RECEPTIVE_FIELD, len(cfg.IMAGE.NAMES)
    H, W = cfg.IMAGE.FINAL_DIM
    fx = 0.5 * W
    K = np.array([[fx, 0.0, W / 2.0], [0.0, fx, H / 2.0], [0.0, 0.0, 1.0]], np.float32)
    extrinsics = []
    for i in range(n):
        yaw = 2.0 * np.pi * i / n
        c, sn = np.cos(yaw), np.sin(yaw)
        # camera +z (view direction) along ego (c, s, 0); +x right; +y down
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = [[-sn, 0.0, c], [c, 0.0, sn], [0.0, -1.0, 0.0]]
        E[:3, 3] = [0.0, 0.0, 1.6]
        extrinsics.append(E)
    ego = np.zeros(6, np.float32)
    ego[0] = rng.uniform(0.2, 0.8)
    ego[5] = rng.uniform(-0.01, 0.01)
    return {
        'image': rng.randint(0, 256, (1, s, n, H, W, 3), dtype=np.uint8),
        'intrinsics': np.broadcast_to(K, (1, s, n, 3, 3)).copy(),
        'extrinsics': np.broadcast_to(np.stack(extrinsics), (1, s, n, 4, 4)).copy(),
        'future_egomotion': np.broadcast_to(ego, (1, s, 6)).copy(),
    }


def predict(model, request):
    """Answer one request (numpy arrays or tensors) on the model's device: a dict of
    f32 tensors (segmentation, instance_center, instance_offset, instance_flow,
    present_mu, present_log_sigma)."""
    device = next(model.parameters()).device
    args = [torch.as_tensor(request[k]).to(device, non_blocking=True)
            for k in ('image', 'intrinsics', 'extrinsics', 'future_egomotion')]
    with torch.inference_mode():
        return model(*args)


def predict_instances(model, request, device_matching=True):
    """Answer one request with future instances: ``predict``, then the decode and
    the temporal ID tracking. Returns (output dict, ids): ids are (b, s, h, w) int32
    instance ids that stay the same across the s frames. With device_matching (the
    default) everything runs on the model's device and ids stay there; otherwise the
    ids go to the host for the scipy tracker and come back as a CPU tensor."""
    output = predict(model, request)
    with torch.inference_mode():
        if device_matching:
            return output, device_consistent(output)
        return output, torch.from_numpy(
            predict_instance_segmentation_and_trajectories(output).astype(np.int32))
