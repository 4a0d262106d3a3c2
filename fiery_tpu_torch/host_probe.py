"""What the host offers the data loader and the visualisation: one JSON line.

    python3 -m fiery_tpu_torch.host_probe

Prints the versions of PIL and cv2 (null where one does not import) and of
matplotlib (null where it is not installed; not imported), whether g++ compiles
and links a program against libjpeg (``jpeglib.h``, ``-ljpeg``; the native image
pipe needs both), whether the port's native pipe loaded and why not, the CPU
cores this process may use, and the card's name and power limit as nvidia-smi
gives them (null without one). The real-set loader decodes with PIL where the
native pipe does not build.
"""

import importlib
import importlib.metadata
import importlib.util
import json
import os
import subprocess
import tempfile

JPEG_PROGRAM = r'''
#include <cstdio>
#include <jpeglib.h>
int main() {
  jpeg_decompress_struct c; jpeg_error_mgr e; c.err = jpeg_std_error(&e);
  jpeg_create_decompress(&c); jpeg_destroy_decompress(&c);
  std::printf("%d\n", JPEG_LIB_VERSION); return 0;
}
'''


def version(name):
    """The module's version if it imports, else None."""
    try:
        return importlib.import_module(name).__version__
    except ImportError:
        return None


def installed_version(module, dist):
    """The installed distribution's version where the module is found, else None,
    without importing it (only the visualise CLI imports matplotlib)."""
    if importlib.util.find_spec(module) is None:
        return None
    return importlib.metadata.version(dist)


def libjpeg_links():
    """(True, libjpeg's version) if g++ builds and runs a program against libjpeg,
    else (False, the compiler's or loader's last line)."""
    with tempfile.TemporaryDirectory() as d:
        src, exe = os.path.join(d, 'j.cpp'), os.path.join(d, 'j')
        with open(src, 'w') as f:
            f.write(JPEG_PROGRAM)
        try:
            out = subprocess.run(['g++', '-O1', src, '-o', exe, '-ljpeg'],
                                 capture_output=True, text=True, timeout=120)
        except FileNotFoundError:
            return False, 'no g++'
        if out.returncode != 0:
            errors = [line for line in out.stderr.splitlines() if 'error' in line]
            return False, (errors or out.stderr.strip().splitlines() or ['g++ failed'])[0]
        run = subprocess.run([exe], capture_output=True, text=True, timeout=60)
        if run.returncode != 0:
            return False, (run.stderr.strip().splitlines() or ['failed to run'])[-1]
        return True, run.stdout.strip()


def card():
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=60)
    except FileNotFoundError:
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def main():
    from fiery_tpu_torch import native
    links, detail = libjpeg_links()
    print(json.dumps({
        'PIL': version('PIL'), 'cv2': version('cv2'), 'matplotlib': installed_version('matplotlib', 'matplotlib'),
        'libjpeg_links': links, 'libjpeg': detail,
        'native_pipe': native.image_pipe_available(), 'native_pipe_error': native.build_error(),
        'cores': len(os.sched_getaffinity(0)), 'card': card()}), flush=True)


if __name__ == '__main__':
    main()
