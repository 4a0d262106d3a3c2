# The kernels' operators, torch.ops.fiery_torch, registered with the package.
from fiery_tpu_torch.ops import library  # noqa: F401
