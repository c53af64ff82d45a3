"""Modified Random Walk (Min et al. 2009) of the port (counterpart of
``hyperion_tpu/transport/mrw.py``; ref grid_mrw_3d.f90:29-204).

A packet deeper than ``gamma`` reciprocal-Planck optical depths from the
nearest wall (alpha_inv_planck * d_closest_wall > gamma) makes one MRW
step instead of many scatterings: it jumps to a random point on the sphere
of radius d_closest_wall, deposits the diffusion path length
ct * kappa_planck * E, and leaves in an isotropic direction at a frequency
drawn from the local b_nu. The engine's step does the move
(``engine.mrw_jump_update``); this module holds its tables.

The cumulative of Min+09 eq. (6), P(y) = 2 sum_n (-1)^(n+1) y^(n^2), is
tabulated on the host (a copy of the JAX module's numpy) and inverted onto
a uniform grid, so a draw is a direct index and a lerp. The JAX module's
overlapping ``x_rows`` layout is a TPU gather workaround and is not
kept."""

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .sampling import interp_loglog

N_INVERSE = 4096


@dataclass
class MRWTables:
    # per-cell reciprocal-Planck extinction, engine units (1/length)
    alpha_inv_planck: torch.Tensor   # (n_cells,)
    # per-(dust, cell) Planck-mean absorption at the cell's specific energy
    kappa_planck: torch.Tensor       # (n_dust, n_cells)
    # the Min+09 diffusion-time distribution inverted on the uniform grid
    # u = j / (N_INVERSE - 1)
    x_grid: torch.Tensor             # (N_INVERSE,) y at u
    gamma: float                     # the trigger threshold


def _min09_cumulative(n=10000):
    """Tabulate P(y) = 2 sum_{n>=1} (-1)^(n+1) y^(n^2) on y in [0, 1]."""
    x = np.linspace(0.0, 1.0, n)
    P = np.zeros(n)
    for i, y in enumerate(x):
        if y >= 1.0:
            P[i] = 0.5
            continue
        total, j = 0.0, 0
        while True:
            j += 1
            term = y ** (j * j)
            if term == 0.0 or j > 10000:
                break
            total += term if j % 2 == 1 else -term
        P[i] = total
    P *= 2.0
    P[-1] = 1.0
    # the alternating series leaves ~1e-15 noise near y = 1: a clean
    # monotone CDF for the inversion
    P = np.maximum.accumulate(np.clip(P, 0.0, 1.0))
    return x, P


@functools.lru_cache(maxsize=1)
def min09_cumulative():
    """(y, P(y)) of the Min+09 cumulative, tabulated once per process (the
    arrays are read-only)."""
    x, P = _min09_cumulative()
    x.flags.writeable = False
    P.flags.writeable = False
    return x, P


def prepare_mrw_tables(dt, density, specific_energy, gamma):
    """The MRW tables of an iteration from its current specific energy
    (ref prepare_mrw + update_alpha_inv_planck, grid_mrw_3d.f90:29-54).
    ``density`` and ``specific_energy`` are (n_dust, n_cells) in engine
    units, on the engine's device and dtype."""
    alpha = torch.zeros_like(density[0])
    kps = []
    for d in range(dt.n_dust):
        se_tab = dt.me_specific_energy[d]
        e = specific_energy[d].clamp(se_tab[0], se_tab[-1])
        alpha = alpha + density[d] * interp_loglog(
            se_tab, dt.me_chi_inv_planck[d], e)
        kps.append(interp_loglog(se_tab, dt.me_kappa_planck[d], e))
    x, P = min09_cumulative()
    u_grid = np.linspace(0.0, 1.0, N_INVERSE)

    def f(a):
        return torch.as_tensor(a, dtype=density.dtype, device=density.device)

    return MRWTables(alpha_inv_planck=alpha, kappa_planck=torch.stack(kps),
                     x_grid=f(np.interp(u_grid, P, x)),
                     gamma=float(gamma))


def sample_min09(tables, u):
    """y from the Min+09 distribution for uniforms ``u``: a direct index
    into the uniform-u inverse table and a lerp."""
    n = tables.x_grid.shape[0]
    pos = u * (n - 1)
    j = pos.long().clamp(0, n - 2)
    frac = pos - j.to(u.dtype)
    x0 = tables.x_grid[j]
    return x0 + frac * (tables.x_grid[j + 1] - x0)
