"""Small constant tensors on a device, made once per value, dtype and device.

Copying a Python list to the card waits for the card, so the training step takes
the constants it needs (bin sizes, class weights) from here: the first call of
a run copies them, and every later call reuses them without a host sync.
"""

import functools

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device):
    # a normal tensor even when first asked for under inference_mode, so that a
    # training step may use it too
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype, device):
    """torch.tensor(values, dtype=dtype, device=device), made on the first call for
    these values and reused after; callers must not modify it. Under
    ``torch.export`` it is made outside the trace's fake tensors, so that the cache
    holds a real tensor that later calls may use, and the program takes it as a
    constant, as an eager call does (a tensor made in the trace would be copied
    anew at every call of the program)."""
    values = tuple(v.item() if hasattr(v, 'item') else v for v in values)
    if torch.compiler.is_exporting():
        with unset_fake_temporarily():
            return _constant(values, dtype, torch.device(device))
    return _constant(values, dtype, torch.device(device))


def resolve_device(device=None):
    """torch.device(device), the CUDA card when None; raises when that is a CUDA
    device and none is available, rather than running on the CPU unasked."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('fiery_tpu_torch runs on a CUDA device and none is available; '
                           'pass device="cpu" (--device cpu) to run on the CPU')
    return device
