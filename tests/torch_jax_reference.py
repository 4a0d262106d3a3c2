"""Run a JAX reference computation of the port's tests in a fresh process whose
XLA CPU code is capped at one instruction set:

    want = jax_reference('test_torch_trainer:jax_train_step', tmp_path)
    reference = start_jax_reference(...)    # the same, in the background
    ...
    want = reference.result()

calls the named function (module:function, importable from tests/) with no
arguments in a process started with conftest's flags plus
``--xla_cpu_max_isa=REFERENCE_ISA``, and returns what it returned (pickled
through ``torch.save``; numpy arrays and torch tensors).

Why: XLA's CPU compiler picks the vector width of a reduction from the host.
Under AVX-512 its f32 sums take another order than under AVX2, and on the tiny
training step that moves the reference by about the tests' bounds: the batch
variance of the future distribution's first down-projection BatchNorm (the JAX
BatchNorm's f32 means of x and x^2, whose difference cancels 18-fold there) misses
its f64 value by 9.9e-5 relative under AVX-512 (the bound is 1e-4), by 5.8e-6 under
AVX2, and the port's by 7.3e-7, on an AVX-512 host (``tests/torch_isa_evidence.py``
prints these). The port's numbers do not move with the host; the reference's do.
So the references are computed with the instruction set fixed, which costs no
extra compile (each step compiles once, here instead of in the test process). An
xdist worker cannot change ``XLA_FLAGS`` once JAX has started, hence the process.
"""

import os
import subprocess
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
REFERENCE_ISA = 'AVX2'


def reference_env(isa=REFERENCE_ISA):
    """The environment of a reference process: the caller's, with conftest's
    virtual device count and the instruction-set cap in XLA_FLAGS."""
    flags = [f for f in os.environ.get('XLA_FLAGS', '').split()
             if not f.startswith('--xla_cpu_max_isa')]
    if not any(f.startswith('--xla_force_host_platform_device_count') for f in flags):
        flags.append('--xla_force_host_platform_device_count=8')
    flags.append(f'--xla_cpu_max_isa={isa}')
    return {**os.environ, 'XLA_FLAGS': ' '.join(flags), 'JAX_PLATFORMS': 'cpu',
            'PYTHONPATH': os.pathsep.join([TESTS, REPO])}


class Reference:
    """A reference process started in the background (``start_jax_reference``), so
    that a test module's own work runs beside its compile; ``result()`` waits."""

    def __init__(self, target, tmp_path, isa=REFERENCE_ISA, timeout=900):
        self.target, self.isa, self.timeout = target, isa, timeout
        self.out = os.path.join(str(tmp_path), target.replace(':', '.') + f'.{isa}.pt')
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), target,
                                      self.out], cwd=REPO, env=reference_env(isa),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
        self.value = None

    def result(self):
        """The target's result. Raises with the process's output when it fails."""
        if self.value is None:
            import torch
            try:
                log, _ = self.proc.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                self.stop()
                raise
            if self.proc.returncode != 0:
                raise AssertionError(f'{self.target} under --xla_cpu_max_isa={self.isa} '
                                     f'exited {self.proc.returncode}:\n{log[-4000:]}')
            self.value = torch.load(self.out, weights_only=False)
        return self.value

    def stop(self):
        """End the process if no test waited for it."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def start_jax_reference(target, tmp_path, isa=REFERENCE_ISA, timeout=900):
    """``target`` ('module:function') started in a reference process; a Reference."""
    return Reference(target, tmp_path, isa, timeout)


def jax_reference(target, tmp_path, isa=REFERENCE_ISA, timeout=900):
    """``target`` ('module:function') called in a reference process; its result.
    Raises with the process's output when it fails."""
    return start_jax_reference(target, tmp_path, isa, timeout).result()


def main(argv):
    target, out = argv
    sys.path[:0] = [TESTS, REPO]
    import conftest  # noqa: F401  (the test session's JAX settings)
    import importlib

    import torch
    module, name = target.split(':')
    torch.save(getattr(importlib.import_module(module), name)(), out)


if __name__ == '__main__':
    main(sys.argv[1:])
