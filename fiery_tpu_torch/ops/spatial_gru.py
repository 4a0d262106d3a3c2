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
``spatial_gru`` and ``spatial_gru_backward``. Every operation rounds to the
tensors' dtype, as the JAX package's bfloat16 operations round on XLA's CPU, with
sigmoid(z) = 1 / (1 + exp(-z)); the backward computes in f32 and rounds once.

Operands are channels-first views (B, C, H, W) whose channels are contiguous and
whose pixels i W + j lie evenly spaced (``pixel_strides``): a slot of the output,
a frame of the input sequence, the latent broadcast over the map, a channel slice
of a gradient. A gradient laid out otherwise is copied; another operand raises.
Each wrapper checks and plans a shape once (``_plan``): the access width (16
bytes where the addresses, strides and channel counts allow it) and the grid. A
CPU tensor takes the plain versions; a CUDA tensor launches the kernels. The
forward launches are the operators ``torch.ops.fiery_torch.gru_reset_concat`` and
``gru_state_update`` (ops/library.py; CUDA implementations ``*_card``).
"""

import ctypes
import functools
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

THREADS = 256          # a block's threads: G vectors a pixel x PIX = 256 // G pixels
MAX_OPERANDS = 7
# the kernels of csrc/spatial_gru.cu, by the index its plan's first field holds
KINDS = ('gru_reset_concat', 'gru_state_update', 'gru_reset_concat_backward',
         'gru_state_update_backward')


def pixel_strides(t):
    """(batch, pixel) strides in elements of a (B, C, H, W) view whose channels are
    contiguous and whose pixels p = i W + j lie evenly spaced (a row stride of W
    pixel strides), else None. The strides of a dimension of size 1 count as 0.
    Slots of a (B, T, H, W, C) sequence, channel slices of wider rows and maps
    broadcast over the pixels (stride 0) all qualify."""
    if t.dim() != 4:
        return None
    B, C, H, W = t.shape
    if C > 1 and t.stride(1) != 1:
        return None
    hs, ws = (t.stride(2) if H > 1 else 0), (t.stride(3) if W > 1 else 0)
    if H > 1 and W > 1 and hs != W * ws:
        return None
    return (t.stride(0) if B > 1 else 0), (ws if W > 1 else hs)


def vector_width(channels, strides, itemsize, align):
    """V, the channels a thread moves with one access: the widest power of two with
    V * itemsize <= 16 bytes that divides every channel count and every stride, and
    whose bytes divide ``align`` (the OR of the operands' addresses, mod 16)."""
    V = 16 // itemsize
    while V > 1 and (align % (V * itemsize) or any(c % V for c in channels)
                     or any(s % V for s in strides)):
        V //= 2
    return V


def launch_grid(P, G):
    """(PIX, tiles): a block of G x PIX threads covers PIX consecutive pixels, one
    vector of G a thread; the grid's x covers the P pixels of a map in tiles."""
    pix = max(1, THREADS // G)
    return pix, -(-P // pix)


_PLANS = {}


def _plan(kind, operands, align):
    """The launch plan of kernel ``kind`` on ``operands`` (tensors, in the kernel's
    order), with ``align`` the OR of their addresses mod 16, checked and computed
    at its first call: a ctypes array of csrc/spatial_gru.cu's ``Plan``. Every
    later call of that key reuses it, so a call's host work is this lookup and the
    launch."""
    key = (kind, align) + tuple((t.shape, t.stride(), t.dtype, t.get_device())
                                for t in operands)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _make_plan(kind, operands, align)
    return plan


def _make_plan(kind, operands, align):
    name = KINDS[kind]
    ref = operands[2]            # h, in every kernel's operands
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name}: float32 or bfloat16 only, got {ref.dtype}')
    B, C, H, W = ref.shape
    for t in operands:
        if (t.dim() != 4 or t.device != ref.device or t.dtype != ref.dtype
                or t.shape[0] != B or t.shape[2:] != ref.shape[2:]):
            raise ValueError(f'{name}: every operand must be on {ref.device}, {ref.dtype}, '
                             f'of batch {B} and map size {tuple(ref.shape[2:])}')
    strides = []
    for t in operands:
        st = pixel_strides(t)
        if st is None:
            raise ValueError(f'{name}: {tuple(t.shape)} strides {t.stride()} does not keep '
                             f'its channels contiguous and its pixels evenly spaced')
        strides.append(st)
    cx = operands[0].shape[1] if kind == 0 else 0
    width = cx + C if kind == 0 else C
    if kind == 0 and operands[3].shape[1] != width:
        raise ValueError(f'{name}: the concat must have {width} channels')
    if any(t.shape[1] != C for t in (operands[1:3] if kind == 0 else operands)):
        raise ValueError(f'{name}: r_pre, u_pre, h and h_tilde must have {C} channels')
    V = vector_width((cx, C), [s for st in strides for s in st], ref.element_size(), align)
    G = width // V
    if G > 1024 or B > 65535:
        raise ValueError(f'{name}: {width} channels of {B} maps; the kernel takes at most '
                         f'{1024 * V} channels and 65,535 maps')
    pix, tiles = launch_grid(H * W, G)
    fields = [kind, int(ref.dtype == torch.bfloat16), V, H * W, B, G, pix, tiles, cx]
    for st in strides + [(0, 0)] * (MAX_OPERANDS - len(strides)):
        fields += st
    return (ctypes.c_longlong * len(fields))(*fields)


@functools.cache
def _fn():
    """fiery_gru of the spatial_gru library, typed once."""
    fn = _build.load('spatial_gru').fiery_gru
    fn.argtypes = [ctypes.c_void_p] * (MAX_OPERANDS + 2)
    fn.restype = ctypes.c_int
    return fn


def _launch(kind, operands):
    """One launch of kernel ``kind`` (an index of KINDS) on ``operands``."""
    ptrs = [t.data_ptr() for t in operands]
    align = 0
    for p in ptrs:
        align |= p
    plan = _plan(kind, operands, align & 15)
    ptrs += [None] * (MAX_OPERANDS - len(ptrs))
    rc = _fn()(plan, *ptrs, torch._C._cuda_getCurrentRawStream(operands[2].get_device()))
    if rc != 0:
        raise RuntimeError(f'{KINDS[kind]} kernel launch failed: CUDA error {rc}')


def _empty_rows(B, C, H, W, like):
    return torch.empty((B, H, W, C), dtype=like.dtype, device=like.device).permute(0, 3, 1, 2)


def reset_concat_card(x_t, r_pre, h):
    """K11's first launch of a step on the card, the CUDA implementation of
    ``torch.ops.fiery_torch.gru_reset_concat``: ``reset_concat_plain`` into a new
    channels-last (B, C_x + C, H, W) tensor."""
    B, C, H, W = h.shape
    cat = _empty_rows(B, x_t.shape[1] + C, H, W, h)
    _launch(0, (x_t, r_pre, h, cat))
    spatial_gru.launches += 1
    return cat


def state_update_card(u_pre, h, h_tilde, out, t):
    """K11's second launch of a step on the card, the CUDA implementation of
    ``torch.ops.fiery_torch.gru_state_update``: ``state_update_plain`` written into
    slot t of ``out``, (B, T, C, H, W), whose slots are channels-last rows."""
    _launch(1, (u_pre, h, h_tilde, out[:, t]))
    spatial_gru.launches += 1


def reset_concat(x_t, r_pre, h):
    """K11's first launch of a step: ``reset_concat_plain`` into a new channels-last
    (B, C_x + C, H, W) tensor, without autograd, through
    ``torch.ops.fiery_torch.gru_reset_concat`` (ops/library.py). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel."""
    return torch.ops.fiery_torch.gru_reset_concat(x_t, r_pre, h)


def state_update(u_pre, h, h_tilde, out, t):
    """K11's second launch of a step: ``state_update_plain`` written into slot t of
    ``out`` (B, T, C, H, W) (``gru_output``'s buffer, or any whose slot t is a view
    the kernel takes, ``pixel_strides``), without autograd, through
    ``torch.ops.fiery_torch.gru_state_update``, which declares its write of the
    whole buffer; returns the slot out[:, t]. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel."""
    torch.ops.fiery_torch.gru_state_update(u_pre, h, h_tilde, out, t)
    return out[:, t]


def reset_concat_backward(dstate, r_pre, h):
    """K11 backward of ``reset_concat``: (d r_pre, d h) from the gradient of the
    concat's state half. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if h.device.type == 'cpu':
        spatial_gru_backward.plain_calls += 1
        return reset_concat_backward_plain(dstate, r_pre, h)
    B, C, H, W = h.shape
    dr, dh = _empty_rows(B, C, H, W, h), _empty_rows(B, C, H, W, h)
    _launch(2, (_as_rows(dstate, h.dtype), r_pre, h, dr, dh))
    spatial_gru_backward.launches += 1
    return dr, dh


def state_update_backward(dout, u_pre, h, h_tilde):
    """K11 backward of ``state_update``: (d u_pre, d h, d h_tilde). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if h.device.type == 'cpu':
        spatial_gru_backward.plain_calls += 1
        return state_update_backward_plain(dout, u_pre, h, h_tilde)
    B, C, H, W = h.shape
    du, dh, dht = (_empty_rows(B, C, H, W, h) for _ in range(3))
    _launch(3, (_as_rows(dout, h.dtype), u_pre, h, h_tilde, du, dh, dht))
    spatial_gru_backward.launches += 1
    return du, dh, dht


def _as_rows(g, dtype):
    """A gradient as the kernels read it (``pixel_strides``) in ``dtype``: itself
    when it is one, else a channels-last copy."""
    if g.dtype == dtype and pixel_strides(g) is not None:
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
        # through .data: the slots of earlier steps are saved for their backward, and
        # a write of the buffer must not move the version autograd checks them by
        torch.ops.fiery_torch.gru_state_update(u_pre, h, h_tilde, out.data, t)
        return out[:, t]

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
        return state_update(u_pre, h, h_tilde, out, t)
    return _StateUpdate.apply(u_pre, h, h_tilde, out, t)


def gru_stack(out, states):
    """``out`` once every slot is written by ``gru_state_update``: the GRU's
    (B, T, C, H, W) output, through which each slot's gradient reaches its step."""
    if not _recording(*states):
        return out
    return _Stack.apply(out, *states)
