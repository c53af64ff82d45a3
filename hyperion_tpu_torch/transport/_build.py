"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for sm_90a into a shared
library with a plain C interface and loaded with ``ctypes``. The library
goes into ``hyperion_tpu_torch/_build/`` under a name that carries the hash
of the source and flags, so an edited source is rebuilt at its next use.
Nothing is built at import time."""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']
# flags of one source on top of NVCC_FLAGS: escape_tau, voronoi_locate and
# octree_locate keep a*b + c as two roundings, as PyTorch's element-wise
# kernels do (see their source notes); ptxas reports each kernel's
# registers and spills (ptxas_log)
EXTRA_FLAGS = {'escape_tau': ['-fmad=false', '-Xptxas', '-v'],
               'voronoi_locate': ['-fmad=false', '-Xptxas', '-v'],
               'octree_locate': ['-fmad=false', '-Xptxas', '-v']}

_loaded = {}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under %s/bin: the CUDA "
                       "kernels cannot be built" % cuda_home)


def _flags(name):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    src = (CSRC / ('%s.cu' % name)).read_bytes()
    digest = hashlib.sha256(src + ' '.join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / ('lib%s_%s.so' % (name, digest[:16]))


def ptxas_log(name):
    """What nvcc printed while building the current library of
    ``csrc/<name>.cu`` ('' where it printed nothing or was built
    elsewhere)."""
    log = library_path(name).with_suffix('.txt')
    return log.read_text() if log.exists() else ''


def ptxas_resources(text):
    """{kernel's mangled name: (registers, spill store bytes)} of each
    entry function in ptxas's -v output ``text``."""
    out, name, spill = {}, None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r'(\d+) bytes spill stores', line)
        if m:
            spill = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


def build(*names):
    """Compile each ``csrc/<name>.cu`` whose current build does not exist,
    one ``nvcc`` per source, all running at once, keeping what nvcc prints
    beside the library (:func:`ptxas_log`); returns the library paths.
    Raises with nvcc's output when a build fails."""
    outs = [library_path(name) for name in names]
    jobs = []
    try:
        for name, out in zip(names, outs):
            if out.exists():
                continue
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # compile to a private name, then rename: concurrent builders
            # never see a half-written library
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc] + _flags(name) + [
                '-o', tmp, str(CSRC / ('%s.cu' % name))]
            jobs.append((name, out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for name, out, tmp, cmd, proc in jobs:
            log, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed (%d) building %s:\n%s\n%s"
                                   % (proc.returncode, name, ' '.join(cmd),
                                      err))
            out.with_suffix('.txt').write_text(log + err)
            os.replace(tmp, out)
    finally:
        for _, _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def load(name):
    """The loaded ctypes library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[0]))
        _loaded[name] = lib
    return lib
