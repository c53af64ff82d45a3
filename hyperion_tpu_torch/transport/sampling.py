"""Sampling primitives of the transport engine (counterpart of
``hyperion_tpu/transport/sampling.py``).

The physics functions take their uniforms as tensors instead of drawing
them, so the engine draws every random number of a step in one place and
the tests can hand the JAX functions' own uniforms to these. The JAX
module's TPU gather workarounds (``select_small``, ``gather_rows_matmul``,
``scatter_add_matmul`` and the compare-sum searches) are written here as
the plain gathers and ``torch.searchsorted`` calls they stand for."""

import math

import numpy as np
import torch


def quantile_grid(n_quantiles):
    """The cosine-warped CDF knot positions used by the quantile tables."""
    return 0.5 * (1.0 - np.cos(np.pi * np.linspace(0.0, 1.0, n_quantiles)))


def quantile_table(x, cdf_rows, n_quantiles, log2=False):
    """Host-side inverse-CDF resampling: returns (n_rows, n_quantiles) with
    row r holding x (or log2 x) at the cosine-warped CDF knots of
    :func:`quantile_grid` evaluated on cdf_rows[r].

    ``cdf_rows`` must be non-decreasing per row with cdf[:, -1] == 1."""
    x = np.asarray(x, float)
    cdf_rows = np.asarray(cdf_rows, float)
    if x.ndim == 1:
        x = np.broadcast_to(x, cdf_rows.shape)
    u = quantile_grid(n_quantiles)
    xs = np.log2(np.maximum(x, 1e-300)) if log2 else x
    out = np.empty((cdf_rows.shape[0], n_quantiles))
    for r in range(cdf_rows.shape[0]):
        c = cdf_rows[r]
        # break exact ties so np.interp picks a deterministic side in
        # zero-probability (flat-CDF) regions
        c = np.maximum.accumulate(c + np.arange(len(c)) * 1e-15)
        out[r] = np.interp(u, c, xs[r])
    return out


def searchsorted_right(table, x):
    """Index j with table[j-1] <= x < table[j] (``side='right'``)."""
    return torch.searchsorted(table, x.contiguous(), right=True)


def searchsorted_rows(table, rows, x):
    """For each lane i, the index j with table[rows[i], j-1] <= x[i] <
    table[rows[i], j] (``side='right'``; each row ascending), in [0, n_cols].

    The rows are searched in place, one ``torch.searchsorted`` of all lanes
    per row, and each lane keeps its own row's answer: no (B, n_cols) copy
    of the table is gathered. The tables searched this way have one row per
    dust type, so the rows are few."""
    x = x.contiguous()
    out = torch.searchsorted(table[0], x, right=True)
    for r in range(1, table.shape[0]):
        out = torch.where(rows == r, torch.searchsorted(table[r], x,
                                                        right=True), out)
    return out


def _bracket(x_table, x):
    n = x_table.shape[0]
    j = searchsorted_right(x_table, x).clamp(1, n - 1)
    return j - 1, j


def interp_loglog(x_table, y_table, x):
    """Log-log interpolation of y_table(x_table) at x (clipped)."""
    j0, j1 = _bracket(x_table, x)
    x0, x1 = x_table[j0], x_table[j1]
    y0, y1 = y_table[j0], y_table[j1]
    frac = (torch.log(x / x0) / torch.log(x1 / x0)).clamp(0.0, 1.0)
    out = y0 * (y1 / y0) ** frac
    return torch.where((y0 <= 0.0) | (y1 <= 0.0), torch.zeros_like(out), out)


def interp_linear(x_table, y_table, x):
    """Linear interpolation (clipped to the table's range)."""
    j0, j1 = _bracket(x_table, x)
    x0, x1 = x_table[j0], x_table[j1]
    y0, y1 = y_table[j0], y_table[j1]
    frac = ((x - x0) / (x1 - x0)).clamp(0.0, 1.0)
    return y0 + frac * (y1 - y0)


def sample_quantile_rows(qtab, rows, xi, exp2=False):
    """O(1) per-row CDF inversion from a cosine-warped quantile table
    (n_rows, K) where qtab[r, k] = x at CDF = (1 - cos(pi k/(K-1)))/2.
    With ``exp2`` the table holds log2(x) and the interpolation is
    log-linear."""
    K = qtab.shape[1]
    t = torch.arccos((1.0 - 2.0 * xi).clamp(-1.0, 1.0)) * (1.0 / math.pi)
    pos = t * (K - 1)
    j = pos.long().clamp(0, K - 2)
    frac = pos - j.to(xi.dtype)
    rows = rows.long()
    q0 = qtab[rows, j]
    q1 = qtab[rows, j + 1]
    v = q0 + frac * (q1 - q0)
    return torch.exp2(v) if exp2 else v


def isotropic_direction(u_mu, u_phi):
    """Uniform unit vectors (kx, ky, kz) from two uniforms in [0, 1)."""
    mu = u_mu * 2.0 - 1.0
    phi = u_phi * (2.0 * math.pi)
    st = torch.sqrt((1.0 - mu * mu).clamp_min(0.0))
    return st * torch.cos(phi), st * torch.sin(phi), mu


def random_exp(u):
    """Exponentially distributed optical depths (mean 1) from uniforms."""
    return -torch.log(u.clamp_min(torch.finfo(u.dtype).tiny))


def rotate_direction(kx, ky, kz, cos_theta, phi):
    """Deflect unit vectors by the angle theta about the azimuth phi, in the
    frame u = (ky, -kx, 0)/st, v = k x u (x_hat, y_hat near the poles)."""
    sin_theta = torch.sqrt((1.0 - cos_theta ** 2).clamp_min(0.0))
    cp = torch.cos(phi)
    sp = torch.sin(phi)
    st = torch.sqrt((kx * kx + ky * ky).clamp_min(0.0))
    safe = st > 1e-12
    one = torch.ones_like(st)
    zero = torch.zeros_like(st)
    inv_st = torch.where(safe, 1.0 / torch.where(safe, st, one), zero)
    ux = torch.where(safe, ky * inv_st, one)
    uy = torch.where(safe, -kx * inv_st, zero)
    vx = torch.where(safe, kz * kx * inv_st, zero)
    vy = torch.where(safe, kz * ky * inv_st, one)
    vz = torch.where(safe, -st, zero)
    nx = sin_theta * (cp * ux + sp * vx) + cos_theta * kx
    ny = sin_theta * (cp * uy + sp * vy) + cos_theta * ky
    nz = sin_theta * sp * vz + cos_theta * kz
    # renormalize against float32 drift
    norm = torch.rsqrt(nx * nx + ny * ny + nz * nz)
    return nx * norm, ny * norm, nz * norm
