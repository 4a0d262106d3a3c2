"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with ``nvcc``
for Hopper (``sm_90a``) into its own shared library under ``fiery_tpu_torch/build/``
and loaded with ctypes. Library names carry a hash of their source, so an edited
source is rebuilt and a stale library is never loaded. Building happens at first
use; ``build_all`` compiles every source at once, one ``nvcc`` process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD = os.path.join(_PKG, 'build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

_lock = threading.Lock()
_libs = {}


def _nvcc():
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and os.path.exists(os.path.join(cand, 'bin', 'nvcc')):
            return os.path.join(cand, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit '
                           '(set CUDA_HOME or put nvcc on PATH)')
    return found


def _lib_path(name):
    with open(os.path.join(CSRC, name + '.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD, f'lib{name}-{digest[:16]}.so')


def kernel_names():
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith('.cu'))


def build_all(names=None):
    """Compile every (or the named) kernel source that has no current library,
    all nvcc processes at once. Returns {name: library path}."""
    names = kernel_names() if names is None else list(names)
    os.makedirs(BUILD, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n] + f'.{os.getpid()}.tmp'
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC, n + '.cu')]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f'nvcc failed for {n}.cu (rc={proc.returncode}):\n{log}')
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError('\n'.join(errors))
    return paths


def load(name):
    """The ctypes library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
