"""The SpatialGRU's gate arithmetic (kernel K11, csrc/spatial_gru.cu; counterpart of
the gate math of fiery_tpu/models/temporal_layers.py ``SpatialGRU.__call__``).

One step t of the GRU, around its three convolutions (which stay cuDNN's):
    u_pre, r_pre = conv_update([x_t, h]), conv_reset([x_t, h])
    cat = [x_t, (1 - sigmoid(r_pre)) h]                  <- ``gru_reset_concat``
    h_tilde = conv_state_tilde(cat)     (conv + BatchNorm with the ReLU folded in)
    h' = (1 - u) h + u h_tilde,  u = sigmoid(u_pre)      <- ``gru_state_update``
``gru_reset_concat`` writes the input of conv_state_tilde directly (no torch.cat);
``gru_state_update`` writes h' into slot t of the (B, T, C, H, W) output that
``gru_output`` allocates (no torch.stack), and ``gru_stack`` ties the slots together
for autograd. These are the autograd entries; ``reset_concat``, ``state_update`` and
their ``*_backward`` are the kernels' wrappers, with the launch counters
``spatial_gru`` and ``spatial_gru_backward``. Every operation rounds to the tensors' dtype, as the JAX package's
bfloat16 operations round on XLA's CPU, with sigmoid(z) = 1 / (1 + exp(-z));
the backward computes in f32 and rounds once.

Operands are channels-first views (B, C, H, W) whose channels are contiguous; the
kernels take any other strides (a slot of the output, a frame of the input
sequence, the latent broadcast over the map, a channel slice of a gradient). A
CPU tensor takes the plain versions; a CUDA tensor launches the kernels.
"""

import ctypes
import types

import torch

from fiery_tpu_torch.ops import _build
from fiery_tpu_torch.ops.batch_norm import sigmoid

# the launch counters of the forward kernels (two a step) and of the backward ones
spatial_gru = types.SimpleNamespace(launches=0, plain_calls=0)
spatial_gru_backward = types.SimpleNamespace(launches=0, plain_calls=0)


def reset_concat_plain(x_t, r_pre, h):
    """[x_t, (1 - sigmoid(r_pre)) h] along the channels, in the inputs' dtype."""
    return torch.cat([x_t, (1.0 - sigmoid(r_pre)) * h], dim=1)


def state_update_plain(u_pre, h, h_tilde):
    """(1 - u) h + u h_tilde with u = sigmoid(u_pre), in the inputs' dtype."""
    u = sigmoid(u_pre)
    return (1.0 - u) * h + u * h_tilde


def reset_concat_backward_plain(dcat, r_pre, h):
    """(d r_pre, d h) of ``reset_concat_plain`` from the gradient of the concat's
    state half, dcat (B, C, H, W); f32, rounded once."""
    r = sigmoid(r_pre.float())
    g = dcat.float()
    one_minus = 1.0 - r
    dr = (-(g * h.float())) * (r * one_minus)
    return dr.to(h.dtype), (g * one_minus).to(h.dtype)


def state_update_backward_plain(dout, u_pre, h, h_tilde):
    """(d u_pre, d h, d h_tilde) of ``state_update_plain``; f32, rounded once."""
    u = sigmoid(u_pre.float())
    g = dout.float()
    one_minus = 1.0 - u
    du = (g * (h_tilde.float() - h.float())) * (u * one_minus)
    dt = h.dtype
    return du.to(dt), (g * one_minus).to(dt), (g * u).to(dt)


# ---- the card ----

def _is_rows(t):
    """Whether t is a (B, C, H, W) view whose channels are contiguous (its other
    strides may be anything: a slot of a sequence, a channel slice of wider rows, a
    map broadcast with zero strides)."""
    return t.dim() == 4 and (t.stride(1) == 1 or t.shape[1] == 1)


def _strides(name, t):
    """(batch, row, column) strides of a view with contiguous channels."""
    if not _is_rows(t):
        raise ValueError(f'{name}: {tuple(t.shape)} strides {t.stride()} does not keep '
                         f'its channels contiguous')
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(2), t.stride(3))


def _empty_rows(B, C, H, W, like):
    return torch.empty((B, H, W, C), dtype=like.dtype, device=like.device).permute(0, 3, 1, 2)


def _check_card(name, ref, *tensors):
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name}: float32 or bfloat16 only, got {ref.dtype}')
    for t in tensors:
        if t.device != ref.device or t.dtype != ref.dtype or t.shape[2:] != ref.shape[2:] \
                or t.shape[0] != ref.shape[0]:
            raise ValueError(f'{name}: every operand must be on {ref.device}, '
                             f'{ref.dtype}, of batch and map size {tuple(ref.shape[2:])}')


_FNS = {}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _launch(name, operands, *ints):
    """Call fiery_<name> with each (label, tensor) operand as its pointer and
    strides, then the ints (B, H, W, channels..., is_bf16), then the stream."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load('spatial_gru'), 'fiery_' + name)
        fn.argtypes = [_P, _P] * len(operands) + [_I] * len(ints) + [_P]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    args = []
    for label, t in operands:
        args += [t.data_ptr(), _strides(f'{name} {label}', t)]
    rc = fn(*args, *ints, torch._C._cuda_getCurrentRawStream(operands[0][1].get_device()))
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')


def reset_concat(x_t, r_pre, h):
    """K11's first launch of a step: ``reset_concat_plain`` into a new channels-last
    (B, C_x + C, H, W) tensor, without autograd. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if h.device.type == 'cpu':
        spatial_gru.plain_calls += 1
        return reset_concat_plain(x_t, r_pre, h)
    _check_card('gru_reset_concat', h, x_t, r_pre)
    B, C, H, W = h.shape
    cx = x_t.shape[1]
    cat = _empty_rows(B, cx + C, H, W, h)
    _launch('gru_reset_concat', (('x_t', x_t), ('r_pre', r_pre), ('h', h), ('out', cat)),
            B, H, W, cx, C, int(h.dtype == torch.bfloat16))
    spatial_gru.launches += 1
    return cat


def state_update(u_pre, h, h_tilde, slot):
    """K11's second launch of a step: ``state_update_plain`` written into ``slot``
    (a (B, C, H, W) view of channels-last rows, e.g. out[:, t]) through its
    storage, without autograd. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if h.device.type == 'cpu':
        spatial_gru.plain_calls += 1
        # .data: written as the kernel writes it, without bumping the version of
        # the buffer that autograd tracks
        slot.data.copy_(state_update_plain(u_pre, h, h_tilde))
        return slot
    _check_card('gru_state_update', h, u_pre, h_tilde, slot)
    B, C, H, W = h.shape
    _launch('gru_state_update', (('u_pre', u_pre), ('h', h), ('h_tilde', h_tilde),
                                 ('out', slot)),
            B, H, W, C, int(h.dtype == torch.bfloat16))
    spatial_gru.launches += 1
    return slot


def reset_concat_backward(dstate, r_pre, h):
    """K11 backward of ``reset_concat``: (d r_pre, d h) from the gradient of the
    concat's state half. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if h.device.type == 'cpu':
        spatial_gru_backward.plain_calls += 1
        return reset_concat_backward_plain(dstate, r_pre, h)
    dstate = _as_rows(dstate, h.dtype)
    _check_card('gru_reset_concat_backward', h, dstate, r_pre)
    B, C, H, W = h.shape
    dr, dh = _empty_rows(B, C, H, W, h), _empty_rows(B, C, H, W, h)
    _launch('gru_reset_concat_backward', (('dcat', dstate), ('r_pre', r_pre), ('h', h),
                                          ('dr_pre', dr), ('dh', dh)),
            B, H, W, C, int(h.dtype == torch.bfloat16))
    spatial_gru_backward.launches += 1
    return dr, dh


def state_update_backward(dout, u_pre, h, h_tilde):
    """K11 backward of ``state_update``: (d u_pre, d h, d h_tilde). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if h.device.type == 'cpu':
        spatial_gru_backward.plain_calls += 1
        return state_update_backward_plain(dout, u_pre, h, h_tilde)
    dout = _as_rows(dout, h.dtype)
    _check_card('gru_state_update_backward', h, dout, u_pre, h_tilde)
    B, C, H, W = h.shape
    du, dh, dht = (_empty_rows(B, C, H, W, h) for _ in range(3))
    _launch('gru_state_update_backward', (('dout', dout), ('u_pre', u_pre), ('h', h),
                                          ('h_tilde', h_tilde), ('du_pre', du), ('dh', dh),
                                          ('dh_tilde', dht)),
            B, H, W, C, int(h.dtype == torch.bfloat16))
    spatial_gru_backward.launches += 1
    return du, dh, dht


def _as_rows(g, dtype):
    """A gradient as channels-last rows of ``dtype``: itself when it is one."""
    if g.dtype == dtype and _is_rows(g):
        return g
    return g.to(dtype).contiguous(memory_format=torch.channels_last)


class _ResetConcat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_t, r_pre, h):
        ctx.save_for_backward(r_pre, h)
        ctx.cx = x_t.shape[1]
        return reset_concat(x_t, r_pre, h)

    @staticmethod
    def backward(ctx, dcat):
        r_pre, h = ctx.saved_tensors
        return (dcat[:, :ctx.cx], *reset_concat_backward(dcat[:, ctx.cx:], r_pre, h))


class _StateUpdate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u_pre, h, h_tilde, out, t):
        ctx.save_for_backward(u_pre, h, h_tilde)
        return state_update(u_pre, h, h_tilde, out[:, t])

    @staticmethod
    def backward(ctx, dout):
        return (*state_update_backward(dout, *ctx.saved_tensors), None, None)


class _Frames(torch.autograd.Function):
    """The T frames of x (B, T, C, H, W) as views; the backward writes their
    gradients into one buffer in channels-last memory (indexing's backward would
    sum T zero-filled tensors of the standard layout)."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        return tuple(x[:, t] for t in range(x.shape[1]))

    @staticmethod
    def backward(ctx, *grads):
        B, T, C, H, W = ctx.shape
        g = torch.empty((B, T, H, W, C), dtype=ctx.dtype, device=ctx.device).permute(
            0, 1, 4, 2, 3)
        for t, gt in enumerate(grads):
            if gt is None:
                g[:, t].zero_()
            else:
                g[:, t].copy_(gt)
        return g


class _Stack(torch.autograd.Function):
    """The filled output buffer, whose slot t's gradient flows to step t."""

    @staticmethod
    def forward(ctx, out, *states):
        ctx.n = len(states)
        return out

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(g[:, t] for t in range(ctx.n))


def _recording(*tensors):
    """Whether autograd records a graph through these tensors (not when serving)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gru_frames(x):
    """The frames x[:, t] of the GRU's input sequence x (B, T, C, H, W), with a
    backward that keeps the input's channels-last layout."""
    if not _recording(x):
        return x.unbind(1)
    return _Frames.apply(x)


def gru_reset_concat(x_t, r_pre, h):
    """[x_t, (1 - sigmoid(r_pre)) h] (B, C_x + C, H, W), channels-last: the input of
    the GRU's state conv (kernel K11, first launch of a step). x_t (B, C_x, H, W),
    r_pre and h (B, C, H, W), one dtype; differentiable in all three."""
    if not _recording(x_t, r_pre, h):
        return reset_concat(x_t, r_pre, h)
    return _ResetConcat.apply(x_t, r_pre, h)


def gru_output(h, steps):
    """The (B, T, C, H, W) buffer (channels-last memory) whose slots
    ``gru_state_update`` fills."""
    B, C, H, W = h.shape
    return torch.empty((B, steps, H, W, C), dtype=h.dtype,
                       device=h.device).permute(0, 1, 4, 2, 3)


def gru_state_update(u_pre, h, h_tilde, out, t):
    """h' = (1 - u) h + u h_tilde, u = sigmoid(u_pre), written into out[:, t] (kernel
    K11, second launch of a step); returns that slot, differentiable in u_pre, h and
    h_tilde."""
    if not _recording(u_pre, h, h_tilde):
        return state_update(u_pre, h, h_tilde, out[:, t])
    return _StateUpdate.apply(u_pre, h, h_tilde, out, t)


def gru_stack(out, states):
    """``out`` once every slot is written by ``gru_state_update``: the GRU's
    (B, T, C, H, W) output, through which each slot's gradient reaches its step."""
    if not _recording(*states):
        return out
    return _Stack.apply(out, *states)
