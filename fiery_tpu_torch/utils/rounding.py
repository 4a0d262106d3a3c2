"""Square roots rounded as the card and the JAX package round them, on any host.

PyTorch's vectorised float32 ``sqrt`` on the CPU is not correctly rounded on every
host: on an AVX-512 host about a fifth of the values in [0.5, 1.5) come out one ulp
off the root rounded to float32, where numpy's, XLA's and the card's ``sqrtf`` are
exact. The plain versions of the kernels, which the CPU tests hold to JAX bit for
bit, take their roots here.
"""

import torch


def sqrt_rn(t):
    """sqrt(t), correctly rounded: for a float32 tensor on the CPU the float64 root
    rounded once to float32 (exact, as float64 keeps more than 2 x 24 + 2 bits); on
    the card ``torch.sqrt``, which rounds correctly already."""
    if t.dtype == torch.float32 and t.device.type == 'cpu':
        return torch.sqrt(t.double()).float()
    return torch.sqrt(t)
