"""Native host kernels of the port: an on-demand g++ build and ctypes
bindings (a copy of ``hyperion_tpu/native/__init__.py``).

The shared library is compiled from ``native.cpp`` the first time it is
needed, into ``hyperion_tpu_torch/_build/`` under a name that carries the
hash of the source and flags (as the CUDA kernels are, see
``transport/_build.py``), so an edited source is rebuilt at its next use and
nothing is written beside the source. Everything has a pure-numpy fallback,
so a missing compiler only costs speed: ``available()`` reports which path
is active."""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / 'native.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
# the JAX package's flags, so that both libraries compute the same bits
FLAGS = ['-O3', '-march=native', '-shared', '-fPIC', '-std=c++17']

_lib = None
_tried = False


def library_path():
    """Where the library of ``native.cpp`` is (or will be) built."""
    digest = hashlib.sha256(SRC.read_bytes() +
                            ' '.join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / ('libhyperion_native_%s.so' % digest[:16])


def _build(out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(['g++'] + FLAGS + [str(SRC), '-o', tmp], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except Exception:
        _lib = None
        return None

    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    p = np.ctypeslib.ndpointer(dtype=np.float64, flags='C_CONTIGUOUS')

    lib.hyp_discretize_sph.restype = None
    lib.hyp_discretize_sph.argtypes = [i64, p, p, p, p, p, p,
                                       i64, p, p, p, p, p, f64, p]
    lib.hyp_integrate_loglog.restype = f64
    lib.hyp_integrate_loglog.argtypes = [i64, p, p]
    lib.hyp_interp_loglog.restype = None
    lib.hyp_interp_loglog.argtypes = [i64, p, p, i64, p, p]
    _lib = lib
    return lib


def available():
    """True when the compiled library is (or can be) loaded."""
    return _load() is not None


def _c(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def discretize_sph(xmin, xmax, ymin, ymax, zmin, zmax,
                   mux, muy, muz, sigma, mass, cull=5.0):
    """Exact Gaussian-kernel SPH mass per cell (ref _discretize_sph.c).

    Falls back to a chunked vectorized numpy/scipy implementation."""
    lib = _load()
    xmin, xmax = _c(xmin), _c(xmax)
    ymin, ymax = _c(ymin), _c(ymax)
    zmin, zmax = _c(zmin), _c(zmax)
    mux, muy, muz = _c(mux), _c(muy), _c(muz)
    sigma, mass = _c(sigma), _c(mass)
    n_cells = len(xmin)
    n_part = len(mux)
    if lib is not None:
        out = np.zeros(n_cells)
        lib.hyp_discretize_sph(n_cells, xmin, xmax, ymin, ymax, zmin, zmax,
                               n_part, mux, muy, muz, sigma, mass,
                               float(cull), out)
        return out
    # numpy fallback: cell-chunked erf products
    from scipy.special import erf
    out = np.zeros(n_cells)
    norm = 1.0 / (np.sqrt(2.0) * sigma)
    chunk = max(1, int(2e7) // max(n_part, 1))
    for s in range(0, n_cells, chunk):
        e = min(s + chunk, n_cells)
        fx = erf((xmax[s:e, None] - mux) * norm) - \
            erf((xmin[s:e, None] - mux) * norm)
        fy = erf((ymax[s:e, None] - muy) * norm) - \
            erf((ymin[s:e, None] - muy) * norm)
        fz = erf((zmax[s:e, None] - muz) * norm) - \
            erf((zmin[s:e, None] - muz) * norm)
        out[s:e] = (np.abs(fx * fy * fz) * 0.125 * mass).sum(axis=1)
    return out


def integrate_loglog_native(x, y):
    """Native piecewise power-law integral; None when the library is
    unavailable (callers keep their numpy path)."""
    lib = _load()
    if lib is None:
        return None
    x, y = _c(x), _c(y)
    return float(lib.hyp_integrate_loglog(len(x), x, y))


def interp_loglog_native(x_t, y_t, xq):
    """Native batched log-log interpolation; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    x_t, y_t, xq = _c(x_t), _c(y_t), _c(xq)
    out = np.zeros(len(xq))
    lib.hyp_interp_loglog(len(x_t), x_t, y_t, len(xq), xq, out)
    return out
