"""Voronoi grid geometry of the port (counterpart of
``hyperion_tpu/transport/gtable_voronoi.py``; ref
src/grid/grid_geometry_voronoi.f90:150-453).

The sparse neighbour lists become a dense (n_cells, K) table padded with -1,
the neighbours of each cell at the front of its row. A point is located by
a lattice start (a host-built (m, m, m) table of the nearest site to each
lattice cell's centre) and the owner walk over the neighbour graph: each
step moves to the neighbour nearest the point if it is nearer than the
current site, which ends at the site nearest the point, the owner of its
Voronoi cell. A wall crossing is the nearest bisector plane ahead, or the
box plane, whose crossing escapes; the next cell is the neighbour's index
(no locate and no snap).

On CUDA tensors :meth:`VoronoiGeometry.find_cell` and
:meth:`VoronoiGeometry.position_in_cell` run the owner walk in the
hand-written kernel of ``csrc/voronoi_locate.cu``
(:mod:`.voronoi_locate`); on CPU tensors its plain version
:func:`.voronoi_locate.locate_reference`, which copies the JAX package's
arithmetic. The rest is plain PyTorch, the JAX package's operations in the
same order. Both kernels (the owner walk, and the walk of
``csrc/escape_tau.cu``) read the rows packed end to end
(:attr:`VoronoiGeometry.packed_rows`), which the geometry derives from its
own tables."""

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .gtable import ESCAPED
from .voronoi_locate import ROW_PAD, VoronoiLocate

# the bounding-box trials of a position in a cell (the JAX package's
# random_position_in_cell), each taking three uniforms
POSITION_TRIALS = 4


@dataclass
class PackedRows:
    """The neighbour rows packed end to end (CSR), each row's entries in
    the neighbour table's order: what the kernels read a row from, in one
    run of entries with no read that waits on an id."""
    off: torch.Tensor    # (n + 1,) int32: row i is entries off[i]..off[i + 1]
    meta: torch.Tensor   # (E + ROW_PAD, 2) int32: each entry's neighbour
    #                      and that neighbour's row offset
    sites: torch.Tensor  # (E + ROW_PAD, 3): each entry's neighbour's site,
    #                      in the sites' type

    @property
    def degrees(self):
        """(n,) int32: each cell's neighbours."""
        return self.off[1:] - self.off[:-1]


@dataclass
class VoronoiGeometry:
    # the uniforms a position in one of its cells takes (position_uniforms)
    POSITION_ROWS = 3 * POSITION_TRIALS

    sites: torch.Tensor     # (n, 3) engine units
    neigh: torch.Tensor     # (n, K) int32, the neighbours first, -1 padded
    volumes: torch.Tensor   # (n,) / L^3
    box_lo: torch.Tensor    # (3,)
    box_hi: torch.Tensor    # (3,)
    bbox_lo: torch.Tensor   # (n, 3) per-cell bounding boxes (sampling)
    bbox_hi: torch.Tensor   # (n, 3)
    lookup: torch.Tensor    # (m*m*m,) int32 nearest-site lattice
    lookup_n: int
    walk_steps: int
    n_sites: int
    length_scale: float

    @cached_property
    def locator(self):
        """The owner walk of these tables, made at the first locate (on
        the card it reads the box once): tables that never locate, such as
        the float64 copy a walk kernel binds, load no kernel."""
        return VoronoiLocate(self)

    @cached_property
    def packed_rows(self):
        """The neighbour rows packed (:class:`PackedRows`), built once from
        these tables on their device: each cell's degree is its row's
        entries before the first -1, entry e of cell i holds ``neigh[i,
        e]``, its row offset and its site to the bit, and ROW_PAD zero
        entries follow the last. The walk kernel reads the float64
        geometry's, the locate kernel those of the lanes' type."""
        nb = self.neigh.long()
        front = (nb >= 0).to(torch.int32).cumprod(dim=1).bool()
        deg = front.sum(dim=1)
        off = torch.zeros(nb.shape[0] + 1, dtype=torch.int64,
                          device=nb.device)
        off[1:] = torch.cumsum(deg, 0)
        if int(off[-1]) + ROW_PAD >= 2 ** 31:
            raise ValueError("voronoi: %d neighbour entries are too many "
                             "for int32 offsets" % int(off[-1]))
        ids = nb[front]
        meta = torch.stack([ids, off[ids]], dim=1).to(torch.int32)
        sites = self.sites[ids]
        return PackedRows(
            off=off.to(torch.int32),
            meta=torch.cat([meta, meta.new_zeros(ROW_PAD, 2)]),
            sites=torch.cat([sites, sites.new_zeros(ROW_PAD, 3)]))

    @property
    def n_cells(self):
        return self.n_sites

    def find_cell(self, x, y, z, kx, ky, kz):
        """The cell that owns each point: the lattice start, then the owner
        walk; ESCAPED outside the closed box. The direction is not used."""
        return self.locator.locate(x.contiguous(), y.contiguous(),
                                   z.contiguous())

    def _planes(self, cell, x, y, z):
        """Each lane's neighbour planes: (valid, neighbour index, normal
        s_j - s_i and midpoint per axis, and the numerator (m - p) . n of
        the signed distance), all (B, K)."""
        si = self.sites[cell]
        nb = self.neigh[cell]
        valid = nb >= 0
        nb_safe = torch.where(valid, nb, 0).long()
        sj = self.sites[nb_safe]
        nvx = sj[..., 0] - si[:, None, 0]
        nvy = sj[..., 1] - si[:, None, 1]
        nvz = sj[..., 2] - si[:, None, 2]
        mx = 0.5 * (sj[..., 0] + si[:, None, 0])
        my = 0.5 * (sj[..., 1] + si[:, None, 1])
        mz = 0.5 * (sj[..., 2] + si[:, None, 2])
        numer = (mx - x[:, None]) * nvx + (my - y[:, None]) * nvy + \
            (mz - z[:, None]) * nvz
        return valid, nb_safe, nvx, nvy, nvz, numer

    def facing_neighbours(self, cell, kx, ky, kz):
        """Each lane's count of neighbours whose bisector plane faces its
        direction (k . (s_j - s_i) > 0): those whose crossing distance
        :meth:`find_wall` computes. Positions do not enter it."""
        si = self.sites[cell]
        nb = self.neigh[cell]
        valid = nb >= 0
        sj = self.sites[torch.where(valid, nb, 0).long()]
        denom = kx[:, None] * (sj[..., 0] - si[:, None, 0]) + \
            ky[:, None] * (sj[..., 1] - si[:, None, 1]) + \
            kz[:, None] * (sj[..., 2] - si[:, None, 2])
        return (valid & (denom > 0.0)).sum(dim=-1)

    def find_wall(self, cell, x, y, z, kx, ky, kz):
        """The nearest bisector-plane or box-plane crossing ahead of each
        lane (ref find_wall, grid_geometry_voronoi.f90:322-397).

        Returns (t, next_cell, axis, wall_coord): the distance (clamped at
        >= 0, so that a lane on its own cell's wall never drifts
        backwards), the neighbour beyond the nearest bisector (ESCAPED when
        a box plane is as near), 0, and t (no snap)."""
        big = torch.finfo(x.dtype).max / 8
        valid, nb_safe, nvx, nvy, nvz, numer = self._planes(cell, x, y, z)
        denom = kx[:, None] * nvx + ky[:, None] * nvy + kz[:, None] * nvz
        t_nb = torch.where(valid & (denom > 0.0),
                           (numer / denom).clamp_min(0.0), big)
        j = torch.argmin(t_nb, dim=-1, keepdim=True)
        t_best = t_nb.gather(-1, j)[:, 0]
        nb_best = nb_safe.gather(-1, j)[:, 0]

        def axis(p, k, lo, hi):
            wall = torch.where(k > 0, hi, lo)
            return torch.where(k != 0.0, ((wall - p) / k).clamp_min(0.0), big)

        tb = torch.minimum(torch.minimum(
            axis(x, kx, self.box_lo[0], self.box_hi[0]),
            axis(y, ky, self.box_lo[1], self.box_hi[1])),
            axis(z, kz, self.box_lo[2], self.box_hi[2]))
        escapes = tb <= t_best
        t = torch.where(escapes, tb, t_best)
        next_cell = torch.where(escapes, ESCAPED, nb_best)
        return t, next_cell, torch.zeros_like(next_cell), t

    def _signed_distances(self, cell, x, y, z):
        """(d, norm): each lane's signed distance to each neighbour's
        bisector (positive on its own side; +inf on padding) and the
        normals' lengths."""
        valid, _, nvx, nvy, nvz, numer = self._planes(cell, x, y, z)
        norm = torch.sqrt(nvx ** 2 + nvy ** 2 + nvz ** 2)
        d = torch.where(valid, numer / norm.clamp_min(1e-300), torch.inf)
        return valid, d, norm

    def closest_wall_distance(self, cell, x, y, z):
        """The distance to the nearest bisector plane or box wall (the MRW
        trigger)."""
        _, d, _ = self._signed_distances(cell, x, y, z)
        d_nb = d.min(dim=-1).values
        d_box = torch.minimum(
            torch.minimum(torch.minimum(x - self.box_lo[0],
                                        self.box_hi[0] - x),
                          torch.minimum(y - self.box_lo[1],
                                        self.box_hi[1] - y)),
            torch.minimum(z - self.box_lo[2], self.box_hi[2] - z))
        return torch.minimum(d_nb, d_box).clamp_min(0.0)

    def in_cell_tol(self, cell, x, y, z, tol=0.01):
        """Membership oracle: the point is not beyond any neighbour's
        bisector plane by more than ``tol`` of half the nearest site
        separation (the definition of a Voronoi cell, with tolerance)."""
        valid, d, norm = self._signed_distances(cell, x, y, z)
        margin = tol * 0.5 * torch.where(valid, norm, torch.inf).min(
            dim=-1).values
        return d.min(dim=-1).values >= -margin

    def snap(self, x, y, z, ax, wall_coord, crossed):
        return x, y, z

    def position_in_cell(self, cell, u):
        """Positions in the cells from uniforms ``u`` (POSITION_ROWS, B) in
        [0, 1): for trials 0-3, the point lo + u[3t:3t + 3] (hi - lo) of the
        cell's bounding box, kept at the first trial whose owner walk from
        the cell stays there, else the site (ref random_position_cell,
        grid_geometry_voronoi.f90:132-148; the JAX package's
        random_position_in_cell with its draws of trial t in rows 3t to
        3t + 2). One owner walk runs the four trials at once."""
        si = self.sites[cell]
        lo = self.bbox_lo[cell]
        hi = self.bbox_hi[cell]
        cand = [torch.stack([lo[:, a] + u[3 * t + a] * (hi[:, a] - lo[:, a])
                             for t in range(POSITION_TRIALS)])
                for a in range(3)]
        owner = self.locator.walk_from(
            cell.repeat(POSITION_TRIALS), *(c.reshape(-1) for c in cand))
        owner = owner.reshape(POSITION_TRIALS, -1)
        x, y, z = si[:, 0], si[:, 1], si[:, 2]
        accepted = torch.zeros_like(cell, dtype=torch.bool)
        for t in range(POSITION_TRIALS):
            ok = ~accepted & (owner[t] == cell)
            x = torch.where(ok, cand[0][t], x)
            y = torch.where(ok, cand[1][t], y)
            z = torch.where(ok, cand[2][t], z)
            accepted = accepted | ok
        return x, y, z


def dense_neighbours(grid):
    """(neigh (n, K) int32 with each cell's neighbours at the front of its
    row in the sparse lists' order and -1 after them, the count of each
    row's neighbours): the domain-wall sentinels dropped, as the JAX
    package's build."""
    n = grid.n_cells
    sparse, idx = grid.sparse_neighbors
    sparse = np.asarray(sparse)
    row = np.repeat(np.arange(n), np.diff(idx))
    keep = sparse >= 0
    row, nb = row[keep], sparse[keep]
    counts = np.bincount(row, minlength=n)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(len(row)) - first[row]
    neigh = np.full((n, max(1, int(counts.max(initial=0)))), -1, np.int32)
    neigh[row, col] = nb
    return neigh, counts


def build_voronoi_geometry(grid, device, dtype, lookup_n=None):
    """Build the geometry tables of a VoronoiGrid in engine units (lengths
    over the largest |bound|), the JAX package's host build
    (``hyperion_tpu/transport/gtable_voronoi.py:214-280``) with the
    per-cell loops written over whole arrays: the same values."""
    from scipy.spatial import cKDTree

    n = grid.n_cells
    volumes = np.asarray(grid.volumes, float)
    lo = np.array([grid.xmin, grid.ymin, grid.zmin], float)
    hi = np.array([grid.xmax, grid.ymax, grid.zmax], float)
    L = float(np.abs(np.concatenate([lo, hi])).max())
    neigh, counts = dense_neighbours(grid)
    sites = np.stack([grid.x, grid.y, grid.z], axis=1).astype(float)

    # per-cell bounding boxes for position sampling: the cell lies in the
    # box of the midpoints to its neighbours reflected about the site
    # (conservative; exact boxes would need the region's vertices)
    row, col = np.nonzero(neigh >= 0)
    mids = 0.5 * (sites[row] + sites[neigh[row, col]])
    lo_i, hi_i = sites.copy(), sites.copy()
    np.minimum.at(lo_i, row, mids)
    np.maximum.at(hi_i, row, mids)
    span = np.maximum(hi_i - sites, sites - lo_i)
    has = counts[:, None] > 0
    bbox_lo = np.where(has, np.maximum(sites - span, lo), lo)
    bbox_hi = np.where(has, np.minimum(sites + span, hi), hi)

    # the nearest-site lattice that seeds the owner walk
    if lookup_n is None:
        lookup_n = int(min(64, max(4, round(n ** (1.0 / 3.0) * 2))))
    m = lookup_n
    ax = [np.linspace(lo[d], hi[d], m + 1) for d in range(3)]
    cx = [(a[:-1] + a[1:]) / 2 for a in ax]
    gx, gy, gz = np.meshgrid(cx[0], cx[1], cx[2], indexing='ij')
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    _, owner = cKDTree(sites).query(pts)
    # lattice flat order is (k * m + j) * m + i
    lookup = owner.reshape(m, m, m).transpose(2, 1, 0).reshape(-1)
    # the walk's cap: the JAX package's formula and cap
    walk_steps = int(min(64, max(8, 4 * round(n ** (1.0 / 3.0) / m) + 12)))

    np_dtype = np.float32 if dtype == torch.float32 else np.float64

    def f(a):
        return torch.as_tensor(np.asarray(a, float).astype(np_dtype),
                               device=device)

    return VoronoiGeometry(
        sites=f(sites / L), neigh=torch.as_tensor(neigh, device=device),
        volumes=f(np.maximum(volumes, 0.0) / L ** 3), box_lo=f(lo / L),
        box_hi=f(hi / L), bbox_lo=f(bbox_lo / L), bbox_hi=f(bbox_hi / L),
        lookup=torch.as_tensor(lookup.astype(np.int32), device=device),
        lookup_n=m, walk_steps=walk_steps, n_sites=n, length_scale=L)
