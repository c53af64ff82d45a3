"""SPH particle -> octree importer of the port (a copy of
``hyperion_tpu/importers/sph.py``; ref: hyperion/importers/sph.py:4-229).

``construct_octree`` recursively refines cells containing more than
``n_ref`` particles (reference stopping criterion), then discretizes the
particle masses onto the leaves. The default discretization is the exact
separable-Gaussian kernel overlap of the reference's C module
(_discretize_sph.c), served by the native C++ kernel in
hyperion_tpu_torch/native (numpy fallback when no compiler is available);
``method='mc'`` keeps the Monte-Carlo sampling variant for
cross-validation.
"""

import numpy as np

from ..grid import OctreeGrid


def construct_octree(x, y, z, dx, dy, dz, px, py, pz, sigma, mass,
                     n_ref=64, max_level=20, mc_samples=16, seed=1234,
                     method='exact'):
    """Build an OctreeGrid refined on SPH particles and a density quantity.

    Parameters mirror the reference: (x, y, z) root center, (dx, dy, dz)
    root half-widths, particle positions (px, py, pz), smoothing lengths
    ``sigma`` and particle ``mass``. Returns an OctreeGrid with a 'density'
    quantity attached.
    """
    px = np.asarray(px, float)
    py = np.asarray(py, float)
    pz = np.asarray(pz, float)
    sigma = np.asarray(sigma, float)
    mass = np.asarray(mass, float)

    refined = []
    node_particles = []

    def build(cx, cy, cz, hx, hy, hz, idx, level):
        inside = idx
        if len(inside) > n_ref and level < max_level:
            refined.append(True)
            node_particles.append(inside)
            for oz in (-0.5, 0.5):
                for oy in (-0.5, 0.5):
                    for ox in (-0.5, 0.5):
                        ncx, ncy, ncz = cx + ox * hx, cy + oy * hy, cz + oz * hz
                        nhx, nhy, nhz = hx / 2, hy / 2, hz / 2
                        sub = inside[(np.abs(px[inside] - ncx) <= nhx) &
                                     (np.abs(py[inside] - ncy) <= nhy) &
                                     (np.abs(pz[inside] - ncz) <= nhz)]
                        build(ncx, ncy, ncz, nhx, nhy, nhz, sub, level + 1)
        else:
            refined.append(False)
            node_particles.append(inside)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        all_idx = np.arange(len(px))
        inside_root = all_idx[(np.abs(px - x) <= dx) & (np.abs(py - y) <= dy) &
                              (np.abs(pz - z) <= dz)]
        build(x, y, z, dx, dy, dz, inside_root, 0)
    finally:
        sys.setrecursionlimit(old)

    refined = np.array(refined, dtype=bool)
    grid = OctreeGrid(x, y, z, dx, dy, dz, refined)

    centers, halves, children = grid.tree_tables()
    n_nodes = len(refined)
    cell_mass = np.zeros(n_nodes)

    if method == 'exact':
        # exact separable-Gaussian kernel overlap per leaf (the reference's
        # _discretize_sph.c math; native C++ kernel with numpy fallback)
        from ..native import discretize_sph
        leaves = np.where(~refined)[0]
        lo = centers[leaves] - halves[leaves]
        hi = centers[leaves] + halves[leaves]
        cell_mass[leaves] = discretize_sph(
            lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1], lo[:, 2], hi[:, 2],
            px, py, pz, sigma, mass)
    else:
        # Monte-Carlo Gaussian-kernel samples per particle (converges to
        # the exact discretization; kept for cross-validation)
        rng = np.random.RandomState(seed)
        n_p = len(px)
        for s in range(mc_samples):
            sx = px + sigma * rng.randn(n_p)
            sy = py + sigma * rng.randn(n_p)
            sz = pz + sigma * rng.randn(n_p)
            leaf = _locate(centers, halves, children, refined, sx, sy, sz)
            ok = leaf >= 0
            np.add.at(cell_mass, leaf[ok], mass[ok] / mc_samples)

    volumes = 8.0 * halves[:, 0] * halves[:, 1] * halves[:, 2]
    density = np.where(refined, 0.0, cell_mass / volumes)

    grid['density'] = []
    grid['density'].append(density)
    return grid


def _locate(centers, halves, children, refined, x, y, z):
    """Vectorized point location through the flattened octree."""
    n = len(x)
    node = np.zeros(n, dtype=np.int64)
    inside = (np.abs(x - centers[0, 0]) <= halves[0, 0]) & \
             (np.abs(y - centers[0, 1]) <= halves[0, 1]) & \
             (np.abs(z - centers[0, 2]) <= halves[0, 2])
    active = inside & refined[node]
    while np.any(active):
        c = centers[node[active]]
        octant = ((x[active] >= c[:, 0]).astype(int) +
                  2 * (y[active] >= c[:, 1]).astype(int) +
                  4 * (z[active] >= c[:, 2]).astype(int))
        node[active] = children[node[active], octant]
        active = inside & refined[node]
    return np.where(inside, node, -1)
