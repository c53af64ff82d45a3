"""Trapezium-style integration assuming piecewise lin/log behaviour.

Vectorized NumPy replacements for the reference's C extension
(ref: hyperion/util/integrate.py + hyperion/util/_integrate_core.c).
Each ``integrate_*`` function integrates samples (x, y) over the full range,
modelling the function between samples as linear in the corresponding
lin/log space. Segments with a zero log-space endpoint contribute zero.
"""

import numpy as np

from .interpolate import (interp1d_fast, interp1d_fast_loglin,
                          interp1d_fast_linlog, interp1d_fast_loglog)

__all__ = ['integrate', 'integrate_loglin', 'integrate_linlog',
           'integrate_loglog', 'integrate_subset', 'integrate_loglin_subset',
           'integrate_linlog_subset', 'integrate_loglog_subset',
           'integrate_powerlaw']


def _prep(x, y):
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if x.ndim != 1 or x.shape != y.shape:
        raise ValueError("x and y should be matching 1-D arrays")
    if x[-1] < x[0]:
        x, y = x[::-1], y[::-1]
    return x, y


def integrate(x, y):
    """Plain trapezium rule (linear-linear)."""
    x, y = _prep(x, y)
    return float(np.trapezoid(y, x))


def integrate_loglin(x, y):
    """y piecewise-linear in (log x, y)."""
    x, y = _prep(x, y)
    x1, x2 = x[:-1], x[1:]
    y1, y2 = y[:-1], y[1:]
    with np.errstate(divide='ignore', invalid='ignore'):
        lnr = np.log(x2 / x1)
        m = (y2 - y1) / lnr
        seg = y1 * (x2 - x1) + m * (x2 * lnr - (x2 - x1))
    seg = np.where(lnr == 0.0, 0.0, seg)
    return float(np.sum(seg))


def integrate_linlog(x, y):
    """y piecewise-exponential: linear in (x, log y)."""
    x, y = _prep(x, y)
    x1, x2 = x[:-1], x[1:]
    y1, y2 = y[:-1], y[1:]
    with np.errstate(divide='ignore', invalid='ignore'):
        a = np.log(y2 / y1) / (x2 - x1)
        seg = (y2 - y1) / a
    same = y1 == y2
    seg = np.where(same, y1 * (x2 - x1), seg)
    seg = np.where((y1 == 0.0) | (y2 == 0.0), 0.0, seg)
    return float(np.sum(seg))


def integrate_loglog(x, y):
    """y piecewise power-law: linear in (log x, log y)."""
    x, y = _prep(x, y)
    x1, x2 = x[:-1], x[1:]
    y1, y2 = y[:-1], y[1:]
    with np.errstate(divide='ignore', invalid='ignore'):
        b = np.log10(y2 / y1) / np.log10(x2 / x1)
        powlaw = y1 * x1 / (b + 1.0) * ((x2 / x1) ** (b + 1.0) - 1.0)
        logcase = x1 * y1 * np.log(x2 / x1)
    seg = np.where(np.abs(b + 1.0) < 1e-10, logcase, powlaw)
    seg = np.where((y1 == 0.0) | (y2 == 0.0), 0.0, seg)
    return float(np.sum(seg))


def _subset(x, y, xmin, xmax, interp):
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if x[-1] < x[0]:
        x, y = x[::-1], y[::-1]
    if xmin > xmax:
        xmin, xmax = xmax, xmin
    elif xmin == xmax:
        return None
    if xmin == x[0]:
        i1, ymin = 1, y[0]
    else:
        i1 = int(np.searchsorted(x, xmin))
        if xmin == x[i1]:
            i1 += 1
        ymin = interp(x[i1 - 1:i1 + 1], y[i1 - 1:i1 + 1], xmin)
    if xmax == x[-1]:
        i2, ymax = len(x) - 1, y[-1]
    else:
        i2 = int(np.searchsorted(x, xmax))
        ymax = interp(x[i2 - 1:i2 + 1], y[i2 - 1:i2 + 1], xmax)
    xs = np.hstack([xmin, x[i1:i2], xmax])
    ys = np.hstack([ymin, y[i1:i2], ymax])
    return xs, ys


def integrate_subset(x, y, xmin, xmax):
    sub = _subset(x, y, xmin, xmax, interp1d_fast)
    return 0.0 if sub is None else integrate(*sub)


def integrate_loglin_subset(x, y, xmin, xmax):
    sub = _subset(x, y, xmin, xmax, interp1d_fast_loglin)
    return 0.0 if sub is None else integrate_loglin(*sub)


def integrate_linlog_subset(x, y, xmin, xmax):
    sub = _subset(x, y, xmin, xmax, interp1d_fast_linlog)
    return 0.0 if sub is None else integrate_linlog(*sub)


def integrate_loglog_subset(x, y, xmin, xmax):
    sub = _subset(x, y, xmin, xmax, interp1d_fast_loglog)
    return 0.0 if sub is None else integrate_loglog(*sub)


def integrate_loglog2d(x, y):
    """Row-wise ``integrate_loglog``: y has shape (n_rows, len(x)).

    Vectorized over rows — used for e.g. Planck-mean opacities over a
    temperature grid without a Python loop.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    x1, x2 = x[:-1], x[1:]
    y1, y2 = y[:, :-1], y[:, 1:]
    with np.errstate(divide='ignore', invalid='ignore'):
        b = np.log10(y2 / y1) / np.log10(x2 / x1)
        powlaw = y1 * x1 / (b + 1.0) * ((x2 / x1) ** (b + 1.0) - 1.0)
        logcase = x1 * y1 * np.log(x2 / x1)
    seg = np.where(np.abs(b + 1.0) < 1e-10, logcase, powlaw)
    seg = np.where((y1 == 0.0) | (y2 == 0.0), 0.0, seg)
    return np.sum(seg, axis=1)


def integrate_powerlaw(xmin, xmax, power):
    """Integral of x^power dx between xmin and xmax."""
    if power == -1.0:
        return np.log(xmax / xmin)
    return (xmax ** (power + 1.0) - xmin ** (power + 1.0)) / (power + 1.0)
