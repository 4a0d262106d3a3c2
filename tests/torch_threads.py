"""Thread counts of the port's CPU tests (no JAX here, so that card tests run with
--noconftest may import it too).

The suite runs its files in six parallel processes on an 8-core host, and PyTorch
takes every core for its intra-op threads in each of them: a tiny model's step
then takes 10-60x its time alone (tests/test_torch_repairs.py's drop-connect draws
0.9 s alone, 56.8 s in the suite). Every port test file takes ``few_threads``, and
a process a test starts takes ``THREAD_ENV``.

    from torch_threads import few_threads  # noqa: F401  (an autouse fixture)
"""

import pytest
import torch

THREADS = 2
# the environment of a subprocess that runs the port: its intra-op threads
THREAD_ENV = {'OMP_NUM_THREADS': str(THREADS), 'MKL_NUM_THREADS': str(THREADS)}


@pytest.fixture(autouse=True, scope='module')
def few_threads():
    """Two intra-op threads for the module's tests, the process's count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)
