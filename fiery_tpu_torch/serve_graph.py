"""The served forward and the device tracker captured as CUDA graphs (counterpart
of the JAX package's ``make_serving_fn`` under ``jax.jit``: one executable at a
fixed batch).

    served = ServedFiery(model, cfg, batch=1)   # an eval model on the card, BN folded,
                                                # or an exported program's module
    out = served.predict(request)             # the forward: one graph replay
    out, ids = served.predict_instances(request)   # + decode and tracking, one replay

An eager request launches ~1,200 kernels and copies from Python; a replay launches
the same kernels from one host call. The object holds static input buffers at the
model's request shapes (``request_spec``) and pinned host staging for them. A
request is checked (``check_request``) before anything is copied, then copied into
the staging and on to the card on the current stream, and the graph replays on
that stream; the caller gets copies of the graph's outputs, which the next replay
cannot overwrite. Both graphs share one memory pool and read the same inputs.

Before its capture each path runs ``WARMUP`` times on the side stream that
captures it, so that the work of a first call happens outside the capture: the
kernels' builds, their ``cudaFuncSetAttribute`` calls, the plans in
``lru_cache``, the constants of ``utils/device.py`` and the libraries' handles and
workspaces for that stream. Every kernel wrapper launches on
``torch.cuda.current_stream()``, the capturing stream. There is no fallback: on
the CPU the constructor raises, and a failed capture raises. The Python launch
counters (``fn.launches``) count the capture's launches, not a replay's.
"""

import numpy as np
import torch

from fiery_tpu_torch.postprocess.instance import device_consistent

INPUTS = ('image', 'intrinsics', 'extrinsics', 'future_egomotion')
WARMUP = 2          # eager runs of each path on the capturing stream before its capture


def request_spec(cfg, batch=1):
    """{input: (shape, torch dtype)} of a request for the config ``cfg`` at ``batch``
    (the arrays of ``serve.make_request``): uint8 images (B, s, n, H, W, 3) and f32
    calibration and ego-motion of the s past and present frames of the n cameras
    that the model reads, s = ``FieryConfig.receptive_field``. Under MODEL.SUBSAMPLE
    that is 3 of TIME_RECEPTIVE_FIELD 5: the request is the subsampled clip, every
    other frame with the ego-motion of each kept frame composed over the two steps
    to the next, as the JAX package's loader hands the model."""
    s = 3 if cfg.MODEL.SUBSAMPLE else cfg.TIME_RECEPTIVE_FIELD   # FieryConfig's rule
    n = len(cfg.IMAGE.NAMES)
    H, W = cfg.IMAGE.FINAL_DIM
    return {'image': ((batch, s, n, H, W, 3), torch.uint8),
            'intrinsics': ((batch, s, n, 3, 3), torch.float32),
            'extrinsics': ((batch, s, n, 4, 4), torch.float32),
            'future_egomotion': ((batch, s, 6), torch.float32)}


def _dtype_of(value):
    if isinstance(value, torch.Tensor):
        return value.dtype
    return torch.from_numpy(np.empty(0, dtype=np.asarray(value).dtype)).dtype


def check_request(request, spec):
    """Raise unless ``request`` holds every input of ``spec`` at its shape (ValueError)
    and dtype (TypeError)."""
    for key, (shape, dtype) in spec.items():
        if key not in request:
            raise ValueError(f'the request has no {key}')
        value = request[key]
        if tuple(value.shape) != shape:
            raise ValueError(f'{key}: shape {tuple(value.shape)}, the graph takes {shape}')
        if _dtype_of(value) != dtype:
            raise TypeError(f'{key}: dtype {_dtype_of(value)}, the graph takes {dtype}')


def is_eval_forward(model):
    """Whether ``model`` computes the eval forward: an ``nn.Module`` in eval mode, or
    the module of an exported program (which keeps the mode it was traced in and may
    refuse ``.eval()``) that updates no BatchNorm statistics, i.e. holds no
    ``fiery_torch.batch_norm_train`` node."""
    if isinstance(model, torch.fx.GraphModule):
        train = torch.ops.fiery_torch.batch_norm_train.default
        return not any(node.target is train for node in model.graph.nodes)
    return not model.training


class ServedFiery:
    """``serve.predict`` and ``serve.predict_instances`` of an eval model on the card
    at a fixed batch, each captured as one CUDA graph; ``cfg`` is the model's
    config. ``model`` is an ``nn.Module`` in eval mode or the module of an exported
    program (``torch.export``) of the eval forward."""

    def __init__(self, model, cfg, batch=1):
        device = next(model.parameters()).device
        if device.type != 'cuda':
            raise RuntimeError(f'a CUDA graph needs the model on a CUDA device, not {device}')
        if not is_eval_forward(model):
            raise ValueError('the served graph captures the eval forward: call model.eval(), '
                             'or export the eval model')
        self.model = model
        self.spec = request_spec(cfg, batch)
        self.static = {k: torch.zeros(shape, dtype=dtype, device=device)
                       for k, (shape, dtype) in self.spec.items()}
        eye = torch.eye(4, device=device)
        self.static['intrinsics'].copy_(eye[:3, :3].expand_as(self.static['intrinsics']))
        self.static['extrinsics'].copy_(eye.expand_as(self.static['extrinsics']))
        self.staging = {k: torch.empty(shape, dtype=dtype, pin_memory=True)
                        for k, (shape, dtype) in self.spec.items()}
        self._staged = None        # the event after the last copy out of the staging
        pool = torch.cuda.graph_pool_handle()
        self.graphs, self.outputs = {}, {}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        for name, fn in (('predict', self._forward), ('predict_instances', self._instances)):
            with torch.cuda.stream(side), torch.inference_mode():
                for _ in range(WARMUP):
                    fn()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side), torch.inference_mode():
                self.outputs[name] = fn()
            self.graphs[name] = graph
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)

    def _forward(self):
        return self.model(*(self.static[k] for k in INPUTS))

    def _instances(self):
        output = self._forward()
        return output, device_consistent(output)

    def load(self, request):
        """Check ``request`` and copy it into the static inputs on the current stream:
        a CUDA tensor directly, anything else through the pinned staging."""
        check_request(request, self.spec)
        if self._staged is not None:
            self._staged.synchronize()       # the last request's copies left the staging
        for key in INPUTS:
            value = request[key]
            if isinstance(value, torch.Tensor) and value.is_cuda:
                self.static[key].copy_(value)
                continue
            self.staging[key].copy_(torch.as_tensor(value))
            self.static[key].copy_(self.staging[key], non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()

    def replay(self, name):
        """Replay one graph on the inputs loaded last; its outputs are overwritten by
        the next replay."""
        self.graphs[name].replay()
        return self.outputs[name]

    def predict(self, request):
        """``serve.predict``: a dict of f32 tensors on the card, the caller's own."""
        self.load(request)
        with torch.inference_mode():
            return {k: v.clone() for k, v in self.replay('predict').items()}

    def predict_instances(self, request):
        """``serve.predict_instances`` with the device tracker: (output dict, (b, s, h,
        w) int32 ids), the caller's own."""
        self.load(request)
        output, ids = self.replay('predict_instances')
        with torch.inference_mode():
            return {k: v.clone() for k, v in output.items()}, ids.clone()
