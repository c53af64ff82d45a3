"""Fast 1-D interpolation in lin/log space combinations.

Vectorized NumPy replacements for the reference's C extension
(ref: hyperion/util/interpolate.py + hyperion/util/_interpolate_core.c).
All functions accept scalar or array ``xval`` and assume ``x`` is sorted
ascending. Values outside the range are linearly extrapolated from the edge
segment (matching the reference's 'fast' variants, which do no bounds checks).
"""

import numpy as np

__all__ = ['interp1d_fast', 'interp1d_fast_loglin', 'interp1d_fast_linlog',
           'interp1d_fast_loglog', 'interp2d_fast']


def _segment(x, xval):
    """Index i of the segment [x[i], x[i+1]] containing each xval."""
    i = np.searchsorted(x, xval, side='right') - 1
    return np.clip(i, 0, len(x) - 2)


def interp1d_fast(x, y, xval):
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    i = _segment(x, xval)
    frac = (xval - x[i]) / (x[i + 1] - x[i])
    return y[i] + frac * (y[i + 1] - y[i])


def interp1d_fast_loglin(x, y, xval):
    """Linear in (log x, y)."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    i = _segment(x, xval)
    with np.errstate(divide='ignore', invalid='ignore'):
        frac = np.log10(xval / x[i]) / np.log10(x[i + 1] / x[i])
    return y[i] + frac * (y[i + 1] - y[i])


def interp1d_fast_linlog(x, y, xval):
    """Linear in (x, log y). Zero y values propagate to zero results."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    i = _segment(x, xval)
    frac = (xval - x[i]) / (x[i + 1] - x[i])
    with np.errstate(divide='ignore', invalid='ignore'):
        out = y[i] * (y[i + 1] / y[i]) ** frac
    out = np.where((y[i] == 0.) | (y[i + 1] == 0.), 0.0, out)
    return out


def interp1d_fast_loglog(x, y, xval):
    """Linear in (log x, log y). Zero y values propagate to zero results."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    i = _segment(x, xval)
    with np.errstate(divide='ignore', invalid='ignore'):
        frac = np.log10(xval / x[i]) / np.log10(x[i + 1] / x[i])
        out = y[i] * (y[i + 1] / y[i]) ** frac
    out = np.where((y[i] == 0.) | (y[i + 1] == 0.), 0.0, out)
    return out


def interp2d_fast(x, y, z, xval, yval):
    """Bilinear interpolation of z(x, y) on a rectilinear grid.

    ``z`` has shape (len(x), len(y)); xval/yval broadcast together.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    z = np.asarray(z, dtype=float)
    i = _segment(x, xval)
    j = _segment(y, yval)
    fx = (xval - x[i]) / (x[i + 1] - x[i])
    fy = (yval - y[j]) / (y[j + 1] - y[j])
    return (z[i, j] * (1 - fx) * (1 - fy) + z[i + 1, j] * fx * (1 - fy) +
            z[i, j + 1] * (1 - fx) * fy + z[i + 1, j + 1] * fx * fy)
