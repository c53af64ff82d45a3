"""Partial Diffusion Approximation (PDA) for photon-starved cells, in the
port (a copy of ``hyperion_tpu/transport/pda.py``: the file is JAX-free
numpy and scipy, but importing any ``hyperion_tpu.transport`` module loads
JAX; the copy builds its tables from the port's grid classes and reads the
port's dust tables, which may lie on the card).

Re-design of the reference's PDA solver (ref: src/grid/grid_pda_3d.f90:84-327
+ per-geometry factors in grid_pda_{cartesian,spherical,cylindrical}_3d.f90):
cells visited by fewer than max(30, 0.005 * mean) photons get their specific
energy replaced by the solution of a Rosseland-mean diffusion equation whose
boundary values are the Monte-Carlo energies of the well-sampled neighbors.

Design differences from the reference:

* the coupling topology is a uniform EDGE LIST (cell i, neighbor j, widths,
  geometric factor) instead of per-geometry index arithmetic, which lets the
  same solver run on octree and Voronoi grids (the reference only supports
  car/cyl/sph, grid_pda_*_3d.f90) and on each AMR fab's interior;
* small systems (< 10^4 PDA cells) are solved EXACTLY with a sparse direct
  factorization (the analog of the reference's dense Gauss elimination,
  grid_pda_3d.f90:185 solve_pda_indiv_exact); larger ones fall back to the
  vectorized Jacobi relaxation (ref :258), which converges to the same fixed
  point because the coupling matrix is strictly diagonally dominant.

Runs host-side between Lucy iterations (numpy float64), mirroring the
reference's rank-0 placement (iter_lucy.f90:228).
"""

import numpy as np

THRESHOLD_PDA = 0.005
TOL_ITER = 1.e-4
TOL_EXACT = 1.e-5
N_EXACT_MAX = 10000


class PDATables:
    """Diffusion-coupling graph: directed edges (i -> j) with per-edge cell
    widths along the face normal and a geometric factor.

    edge_i/edge_j: (E,) int cell indices; w_i/w_j: (E,) widths of cells i/j
    along the edge direction; g: (E,) geometric factor of the face as seen
    from i; allowed: (n_cells,) bool — cells where the PDA may be applied
    (ref check_allowed_pda: excludes grid-boundary cells).
    """

    def __init__(self, edge_i, edge_j, w_i, w_j, g, allowed, n_cells):
        self.edge_i = np.asarray(edge_i, np.int64)
        self.edge_j = np.asarray(edge_j, np.int64)
        self.w_i = np.asarray(w_i, float)
        self.w_j = np.asarray(w_j, float)
        self.g = np.asarray(g, float)
        self.allowed = np.asarray(allowed, bool)
        self.n_cells = n_cells


def _structured_tables(w1, w2, w3, kind, cell_offset=0, n_cells_total=None):
    """Edge tables for one structured block (a whole car/cyl/sph grid, or
    one AMR fab with ``cell_offset`` into the global flat index space)."""
    n1, n2, n3 = len(w1) - 1, len(w2) - 1, len(w3) - 1
    n_cells = n1 * n2 * n3
    # flat index matching the transport tables: ic = (i3*n2 + i2)*n1 + i1
    i3f, i2f, i1f = np.unravel_index(np.arange(n_cells), (n3, n2, n1))
    enc = lambda a, b, c: (c * n2 + b) * n1 + a

    d1, d2, d3 = np.diff(w1), np.diff(w2), np.diff(w3)
    c1 = 0.5 * (w1[:-1] + w1[1:])
    c2 = 0.5 * (w2[:-1] + w2[1:])

    if kind == 'car':
        widths = [d1[i1f], d2[i2f], d3[i3f]]
    elif kind == 'sph':
        # ref cell_width spherical: dr; r dtheta; r sin(theta) dphi
        widths = [d1[i1f], c1[i1f] * d2[i2f],
                  c1[i1f] * np.sin(c2[i2f]) * d3[i3f]]
    else:
        widths = [d1[i1f], d2[i2f], c1[i1f] * d3[i3f]]

    ones = np.ones(n_cells)
    if kind == 'sph':
        # ref grid_pda_spherical_3d.f90 geometrical_factor
        rsum2 = (w1[i1f] + w1[i1f + 1]) ** 2
        g1m = 4.0 * w1[i1f] ** 2 / rsum2
        g1p = 4.0 * w1[i1f + 1] ** 2 / rsum2
        wsint = np.sin(w2)
        ssum = wsint[i2f] + wsint[i2f + 1]
        with np.errstate(divide='ignore', invalid='ignore'):
            g2m = np.where(ssum > 0, 2.0 * wsint[i2f] / ssum, 1.0)
            g2p = np.where(ssum > 0, 2.0 * wsint[i2f + 1] / ssum, 1.0)
        gf = [g1m, g1p, g2m, g2p, ones, ones]
    elif kind == 'cyl':
        wsum = w1[i1f] + w1[i1f + 1]
        g1m = 2.0 * w1[i1f] / np.maximum(wsum, 1e-300)
        g1p = 2.0 * w1[i1f + 1] / np.maximum(wsum, 1e-300)
        gf = [g1m, g1p, ones, ones, ones, ones]
    else:
        gf = [ones] * 6

    periodic3 = kind in ('sph', 'cyl') and \
        abs((w3[-1] - w3[0]) - 2 * np.pi) < 1e-8

    ei, ej, wi, wj, gg = [], [], [], [], []
    axes = [(i1f, n1, 0), (i2f, n2, 1), (i3f, n3, 2)]
    for idx, n, direction in axes:
        if n == 1:
            continue
        for side in (0, 1):
            nb = idx + (1 if side else -1)
            if direction == 2 and periodic3:
                nb = nb % n
            valid = (nb >= 0) & (nb < n)
            nb_c = np.clip(nb, 0, n - 1)
            parts = [i1f, i2f, i3f]
            parts[direction] = nb_c
            nb_flat = enc(*parts)
            w_dir = widths[direction]
            sel = np.where(valid)[0]
            ei.append(sel)
            ej.append(nb_flat[sel])
            wi.append(w_dir[sel])
            wj.append(w_dir[nb_flat[sel]])
            gg.append(gf[2 * direction + side][sel])

    # allowed cells: exclude grid-boundary cells on non-periodic axes
    # (ref check_allowed_pda in each geometry module)
    allowed = np.ones(n_cells, dtype=bool)
    if n1 > 1:
        allowed &= (i1f != 0) & (i1f != n1 - 1)
    if n2 > 1:
        allowed &= (i2f != 0) & (i2f != n2 - 1)
    if n3 > 1 and not periodic3:
        allowed &= (i3f != 0) & (i3f != n3 - 1)

    off = cell_offset
    return PDATables(np.concatenate(ei) + off, np.concatenate(ej) + off,
                     np.concatenate(wi), np.concatenate(wj),
                     np.concatenate(gg), allowed,
                     n_cells_total if n_cells_total is not None else n_cells)


def _octree_tables(grid):
    """Face-neighbor graph over octree leaves.

    Neighbors are found by point location: for each leaf face, descend the
    tree to the leaf containing a probe point just across the face center.
    When the neighbor is larger than the cell the single probe hits the
    correct (unique) neighbor; when it is smaller the probe hits one of the
    touching finer leaves — adequate for the diffusion stencil (the
    reference has no octree PDA at all). Non-leaf nodes are never allowed.
    """
    centers, halves, children = grid.tree_tables()
    refined = np.asarray(grid.refined, bool)
    n_nodes = len(centers)

    def locate(p):
        node = 0
        while refined[node]:
            octant = (int(p[0] > centers[node, 0]) +
                      2 * int(p[1] > centers[node, 1]) +
                      4 * int(p[2] > centers[node, 2]))
            node = children[node, octant]
        return node

    leaves = np.where(~refined)[0]
    ei, ej, wi, wj = [], [], [], []
    allowed = np.zeros(n_nodes, dtype=bool)
    root_lo = centers[0] - halves[0]
    root_hi = centers[0] + halves[0]
    for leaf in leaves:
        c, h = centers[leaf], halves[leaf]
        interior = True
        for ax in range(3):
            for sgn in (-1.0, 1.0):
                probe = c.copy()
                probe[ax] += sgn * h[ax] * 1.001
                if probe[ax] <= root_lo[ax] or probe[ax] >= root_hi[ax]:
                    interior = False
                    continue
                nb = locate(probe)
                if nb == leaf:
                    continue
                ei.append(leaf)
                ej.append(nb)
                wi.append(2.0 * h[ax])
                wj.append(2.0 * halves[nb, ax])
        allowed[leaf] = interior
    e = len(ei)
    return PDATables(ei, ej, wi, wj, np.ones(e), allowed, n_nodes)


def _voronoi_tables(grid):
    """Site-neighbor graph for Voronoi grids: widths are the half
    site-to-site distances; faces are weighted uniformly (face areas are
    not tabulated — an isotropic-stencil approximation)."""
    sites = np.transpose([np.asarray(grid.x, float),
                          np.asarray(grid.y, float),
                          np.asarray(grid.z, float)])
    n = len(sites)
    sparse, idx = grid.sparse_neighbors
    ei, ej = [], []
    allowed = np.ones(n, dtype=bool)
    for p in range(n):
        for q in sparse[idx[p]:idx[p + 1]]:
            if q < 0:
                allowed[p] = False  # touches a domain wall
            else:
                ei.append(p)
                ej.append(int(q))
    ei = np.asarray(ei, np.int64)
    ej = np.asarray(ej, np.int64)
    d = np.linalg.norm(sites[ei] - sites[ej], axis=1)
    return PDATables(ei, ej, 0.5 * d, 0.5 * d, np.ones(len(ei)), allowed, n)


def build_pda_tables(grid):
    """Build PDATables from a grid (physical/cgs units)."""
    from ..grid import (CartesianGrid, SphericalPolarGrid,
                        CylindricalPolarGrid, OctreeGrid, VoronoiGrid,
                        AMRGrid)

    if isinstance(grid, CartesianGrid):
        return _structured_tables(np.asarray(grid.x_wall, float),
                                  np.asarray(grid.y_wall, float),
                                  np.asarray(grid.z_wall, float), 'car')
    if isinstance(grid, SphericalPolarGrid):
        return _structured_tables(np.asarray(grid.r_wall, float),
                                  np.asarray(grid.t_wall, float),
                                  np.asarray(grid.p_wall, float), 'sph')
    if isinstance(grid, CylindricalPolarGrid):
        return _structured_tables(np.asarray(grid.w_wall, float),
                                  np.asarray(grid.z_wall, float),
                                  np.asarray(grid.p_wall, float), 'cyl')
    if isinstance(grid, OctreeGrid):
        return _octree_tables(grid)
    if isinstance(grid, VoronoiGrid):
        return _voronoi_tables(grid)
    if isinstance(grid, AMRGrid):
        # per-fab interior diffusion: each fab is a cartesian block in the
        # fab-major global flat index space (gtable_amr.build_amr_geometry);
        # fab-boundary cells act as Dirichlet boundaries
        n_total = sum(g.nx * g.ny * g.nz
                      for level in grid.levels for g in level.grids)
        tables = []
        offset = 0
        for level in grid.levels:
            for g in level.grids:
                xw = np.linspace(g.xmin, g.xmax, g.nx + 1)
                yw = np.linspace(g.ymin, g.ymax, g.ny + 1)
                zw = np.linspace(g.zmin, g.zmax, g.nz + 1)
                tables.append(_structured_tables(
                    xw, yw, zw, 'car', cell_offset=offset,
                    n_cells_total=n_total))
                offset += g.nx * g.ny * g.nz
        return PDATables(
            np.concatenate([t.edge_i for t in tables]),
            np.concatenate([t.edge_j for t in tables]),
            np.concatenate([t.w_i for t in tables]),
            np.concatenate([t.w_j for t in tables]),
            np.concatenate([t.g for t in tables]),
            np.concatenate([t.allowed for t in tables]), n_total)
    raise NotImplementedError("PDA tables not available for %s" % type(grid))


def _interp_loglog(x_t, y_t, x):
    lx = np.log10(np.maximum(x, 1e-300))
    return 10.0 ** np.interp(lx, np.log10(x_t), np.log10(np.maximum(y_t,
                                                                    1e-300)))


class DustMeanOpacities:
    """Host-side kappa_planck / chi_rosseland lookups per dust."""

    def __init__(self, dt):
        def host(t):
            return t.cpu().numpy().astype(float)

        self.se = host(dt.me_specific_energy)
        self.kp = host(dt.me_kappa_planck)
        self.cr = host(dt.me_chi_rosseland)
        self.n_dust = self.se.shape[0]

    def kappa_planck(self, d, s):
        return _interp_loglog(self.se[d], self.kp[d], s)

    def chi_rosseland(self, d, s):
        return _interp_loglog(self.se[d], self.cr[d], s)


def _solve_exact(col_of, n_pda, ei, ej, coeff, e):
    """Direct sparse solve of the diffusion system over the PDA cells
    (exact analog of ref solve_pda_indiv_exact, grid_pda_3d.f90:185):
    for each PDA cell i: sum_j coeff_ij (e_j - e_i) = 0, with non-PDA
    neighbors contributing Dirichlet terms to the right-hand side."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import spsolve

    ri = col_of[ei]
    rj = col_of[ej]
    interior = rj >= 0

    # diagonal: sum of all couplings of each PDA cell
    diag = np.zeros(n_pda)
    np.add.at(diag, ri, coeff)
    rhs = np.zeros(n_pda)
    np.add.at(rhs, ri[~interior], coeff[~interior] * e[ej[~interior]])

    rows = np.concatenate([np.arange(n_pda), ri[interior]])
    cols = np.concatenate([np.arange(n_pda), rj[interior]])
    vals = np.concatenate([diag, -coeff[interior]])
    A = coo_matrix((vals, (rows, cols)), shape=(n_pda, n_pda)).tocsr()
    return spsolve(A, rhs)


def _solve_jacobi(col_of, n_pda, ei, ej, coeff, e, pda):
    """Vectorized Jacobi relaxation (ref grid_pda_3d.f90:258)."""
    ri = col_of[ei]
    for _ in range(10000):
        num = np.zeros(n_pda)
        den = np.zeros(n_pda)
        np.add.at(num, ri, coeff * e[ej])
        np.add.at(den, ri, coeff)
        e_new = num / np.maximum(den, 1e-300)
        diff = np.max(np.abs(e_new - e[pda]) /
                      np.maximum(np.abs(e[pda]), 1e-300))
        e[pda] = e_new
        if diff < TOL_ITER:
            break
    return e[pda]


def solve_pda(tables, dt, density, specific_energy, n_photons_cell,
              verbose=False):
    """Solve the PDA and return the corrected specific energy.

    density/specific_energy: (n_dust, n_cells) PHYSICAL (cgs) arrays.
    n_photons_cell: (n_cells,) photon visit counts from the MC pass.
    """
    ops = DustMeanOpacities(dt)
    density = np.asarray(density, float)
    se = np.array(specific_energy, float)
    n_phot = np.asarray(n_photons_cell, float)
    n_dust, n_cells = density.shape

    rho_tot = density.sum(axis=0)
    mean_n = n_phot.mean()
    do_pda = (n_phot < max(30, int(np.ceil(THRESHOLD_PDA * mean_n)))) & \
        (rho_tot > 0) & tables.allowed
    if not do_pda.any():
        return se, 0

    n_pda = int(do_pda.sum())
    pda = np.where(do_pda)[0]
    exact = n_pda < N_EXACT_MAX
    tol = TOL_EXACT if exact else TOL_ITER

    # edges whose source cell is in the PDA set
    sel = do_pda[tables.edge_i]
    ei, ej = tables.edge_i[sel], tables.edge_j[sel]
    w_i, w_j, g = tables.w_i[sel], tables.w_j[sel], tables.g[sel]
    col_of = np.full(n_cells, -1, np.int64)
    col_of[pda] = np.arange(n_pda)

    def e_mean_of(se_):
        """Mean radiation-field energy density proxy per cell
        (ref update_e_mean: sum rho_d se_d / kappa_planck_d / sum rho)."""
        num = np.zeros(n_cells)
        for d in range(n_dust):
            kp = ops.kappa_planck(d, np.maximum(se_[d], 1e-300))
            num += density[d] * se_[d] / np.maximum(kp, 1e-300)
        return np.where(rho_tot > 0, num / np.maximum(rho_tot, 1e-300), 0.0)

    def alpha_of(se_):
        """Rosseland extinction per cell."""
        alpha = np.zeros(n_cells)
        for d in range(n_dust):
            alpha += density[d] * ops.chi_rosseland(d, np.maximum(se_[d],
                                                                  1e-300))
        return alpha

    for outer in range(100):
        se_prev = se.copy()
        e = e_mean_of(se)
        alpha = alpha_of(se)

        dtau = np.maximum(alpha[ei] * w_i + alpha[ej] * w_j, 1e-100)
        coeff = g / (dtau * np.maximum(w_i, 1e-300))

        if exact:
            e[pda] = _solve_exact(col_of, n_pda, ei, ej, coeff, e)
        else:
            e[pda] = _solve_jacobi(col_of, n_pda, ei, ej, coeff, e, pda)

        # specific energy from e_mean: fixed point s = e * kappa_planck(s)
        # (ref update_specific_energy)
        for d in range(n_dust):
            s = np.maximum(se[d, pda], 1e-300)
            smin, smax = ops.se[d, 0], ops.se[d, -1]
            target = e[pda]
            for _ in range(50):
                s = np.clip(target * np.maximum(
                    ops.kappa_planck(d, s), 1e-300), smin, smax)
            se[d, pda] = s

        md_prev = np.maximum(np.abs(se_prev[:, pda]), 1e-300)
        maxdiff = np.max(np.abs(se[:, pda] - se_prev[:, pda]) / md_prev)
        if verbose:
            print("[pda] outer %d: maxdiff %.2e" % (outer + 1, maxdiff))
        if maxdiff < tol:
            break

    return se, n_pda
