"""The host image pipe (``image_pipe.cpp``), called through ctypes (the port's copy
of fiery_tpu/native).

``decode_resize_crop_normalize``: a batch of JPEGs -> libjpeg decode -> Pillow's
antialiased bilinear resize -> crop -> normalisation, on a pool of threads. The
data loader's ``FuturePredictionDataset`` decodes its 6 cameras a frame through it
when it is available, and through PIL otherwise; both give the same pixels within
1 LSB, and the uint8 images the dataset returns are held bit for bit against the
JAX package's in ``tests/test_torch_image_pipe.py``.

The library is built with ``g++ ... -ljpeg`` at first use into
``fiery_tpu_torch/build/`` (beside the CUDA kernels), under a name that carries a
hash of the source, so that an edited source is rebuilt. Where g++ or libjpeg's
headers or library are missing, the build fails once a process,
``image_pipe_available()`` is False and ``build_error()`` says why.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, 'image_pipe.cpp')
BUILD = os.path.join(os.path.dirname(_DIR), 'build')
GXX_FLAGS = ['-O3', '-shared', '-fPIC']
LIBS = ['-ljpeg', '-lpthread']

_lock = threading.Lock()
_state = {'lib': None, 'tried': False, 'error': None}


def library_path():
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(GXX_FLAGS + LIBS).encode()).hexdigest()
    return os.path.join(BUILD, f'libimage_pipe-{digest[:16]}.so')


def _build(path):
    os.makedirs(BUILD, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    out = subprocess.run(['g++', *GXX_FLAGS, SOURCE, '-o', tmp, *LIBS],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f'g++ failed (rc={out.returncode}): {out.stderr.strip()}')
    os.replace(tmp, path)


def _load():
    with _lock:
        if _state['tried']:
            return _state['lib']
        _state['tried'] = True
        path = library_path()
        try:
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError) as e:      # no g++, no libjpeg, a bad library
            _state['error'] = f'{type(e).__name__}: {e}'
            return None
        lib.fp_decode_batch.restype = ctypes.c_int
        lib.fp_decode_batch.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ]
        _state['lib'] = lib
        return lib


def image_pipe_available():
    """True when the pipe built (or was built) and loaded in this process."""
    return _load() is not None


def build_error():
    """Why the pipe is unavailable in this process (None when it loaded or was not
    tried)."""
    return _state['error']


def decode_resize_crop_normalize(jpeg_blobs, resize_dims, crop, mean, std,
                                 n_threads=0, fast_scale=False):
    """A batch of JPEGs -> normalised float32 images, as the PIL path makes them.

    jpeg_blobs: list of ``bytes``; resize_dims: (width, height) as PIL takes them;
    crop: (left, top, right, bottom) as PIL's Image.crop; mean, std: (3,) floats.
    Returns (n, crop_h, crop_w, 3) float32. Raises RuntimeError if an image does not
    decode or the crop leaves the resized image.

    fast_scale=True (DATASET.FAST_DECODE) decodes in the DCT domain at the
    smallest M/8 scale that still covers resize_dims, before the resize: up to
    ~4x less IDCT and pixel work for nuScenes' 1600x900 -> 480x270. Its pixels
    differ from the full decode's, as PIL's Image.draft does.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f'the native image pipe is unavailable: {build_error()}')
    n = len(jpeg_blobs)
    left, top, right, bottom = crop
    crop_w, crop_h = right - left, bottom - top
    out = np.empty((n, crop_h, crop_w, 3), dtype=np.float32)
    blob_ptrs = (ctypes.c_char_p * n)(*jpeg_blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in jpeg_blobs])
    mean_arr = (ctypes.c_float * 3)(*[float(m) for m in np.ravel(mean)])
    std_arr = (ctypes.c_float * 3)(*[float(s) for s in np.ravel(std)])
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    failures = lib.fp_decode_batch(
        n, ctypes.cast(blob_ptrs, ctypes.POINTER(ctypes.c_char_p)), lens,
        int(resize_dims[0]), int(resize_dims[1]), int(left), int(top),
        int(crop_w), int(crop_h), mean_arr, std_arr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n_threads),
        1 if fast_scale else 0)
    if failures:
        raise RuntimeError(f'{failures}/{n} JPEGs failed to decode')
    return out
