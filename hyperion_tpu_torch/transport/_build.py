"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for sm_90a into a shared
library with a plain C interface and loaded with ``ctypes``. The library
goes into ``hyperion_tpu_torch/_build/`` under a name that carries the hash
of the source and flags, so an edited source is rebuilt at its next use.
Nothing is built at import time."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_loaded = {}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under %s/bin: the CUDA "
                       "kernels cannot be built" % cuda_home)


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    src = (CSRC / ('%s.cu' % name)).read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ('lib%s_%s.so' % (name, digest[:16]))


def build(name):
    """Compile ``csrc/<name>.cu`` unless its current build exists; returns
    the library path. Raises with nvcc's output when the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc] + NVCC_FLAGS + ['-o', tmp, str(CSRC / ('%s.cu' % name))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d) building %s:\n%s\n%s"
                               % (proc.returncode, name, ' '.join(cmd),
                                  proc.stderr))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name):
    """The loaded ctypes library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
