"""AMR grid geometry of the port (counterpart of
``hyperion_tpu/transport/gtable_amr.py``; ref
src/grid/grid_geometry_amr.f90:98-873).

The levels -> grids (fabs) -> cells hierarchy is flattened to per-fab
tables (bounds, cell counts, cell sizes, flat cell offsets, level). A point
is located by a point-in-fab test over every fab, the finest level winning
(the reference's per-level locate_grid/find_position_in_grid recursion), and
a wall crossing exits the cell's box, probes half a finest cell past the
crossed wall and locates the probe, as in the JAX package. Coarse cells
covered by finer fabs are never entered.

Flat cell index: fab_offset + (k * ny + j) * nx + i, fabs ordered
level-major (level 1 first), the on-disk level_*/grid_* layout. Wall
positions are always ``lo + i * dx``, the same expression in the locate,
the cell bounds and the snap, so that the on-wall test is exact."""

from dataclasses import dataclass

import numpy as np
import torch

from .gtable import ESCAPED


@dataclass
class AMRGeometry:
    # the uniforms a position in one of its cells takes (position_uniforms)
    POSITION_ROWS = 3

    fab_lo: torch.Tensor      # (F, 3) engine units
    fab_hi: torch.Tensor      # (F, 3)
    fab_n: torch.Tensor       # (F, 3) int32 cells per axis
    fab_dx: torch.Tensor      # (F, 3) cell sizes
    fab_level: torch.Tensor   # (F,) int32
    fab_offset: torch.Tensor  # (F + 1,) int64 flat cell offsets
    volumes: torch.Tensor     # (n_cells,) / L^3
    min_dx: torch.Tensor      # (3,) finest cell size per axis (probe scale)
    n_fabs: int
    n_cells_total: int
    length_scale: float

    @property
    def n_cells(self):
        return self.n_cells_total

    def _axis_index(self, p, k, a):
        """(B, F) index along axis ``a`` of each point in each fab, a point
        exactly on a cell wall belonging to the lower cell when its
        direction is -ve (the reference's adjust_wall across fabs), and
        whether it lies in the fab along that axis."""
        lo = self.fab_lo[None, :, a]
        dx = self.fab_dx[None, :, a]
        i = torch.floor((p[:, None] - lo) / dx).to(torch.int32)
        on_wall = (lo + i * dx) == p[:, None]
        i = torch.where(on_wall & (k[:, None] < 0), i - 1, i)
        ok = (i >= 0) & (i < self.fab_n[None, :, a])
        return i, ok

    def _locate(self, x, y, z, kx, ky, kz):
        """The finest fab that holds each point and the flat cell id there:
        the argmax of the fabs' levels over the fabs that hold the point,
        the first such fab on a tie (ESCAPED where none does)."""
        ix, okx = self._axis_index(x, kx, 0)
        iy, oky = self._axis_index(y, ky, 1)
        iz, okz = self._axis_index(z, kz, 2)
        inside = okx & oky & okz
        score = torch.where(inside, self.fab_level[None, :], -1)
        best, fab = score.max(dim=-1)
        # torch's max may pick any of tied maxima: take the first
        fab = (score == best[:, None]).to(torch.int8).argmax(dim=-1)
        found = best >= 0

        def pick(arr, a):
            n = self.fab_n[fab, a]
            v = arr.gather(1, fab[:, None])[:, 0]
            return torch.minimum(torch.maximum(v, torch.zeros_like(v)),
                                 n - 1)

        i, j, k = pick(ix, 0), pick(iy, 1), pick(iz, 2)
        nf = self.fab_n[fab]
        cell = self.fab_offset[fab] + (
            (k * nf[:, 1] + j) * nf[:, 0] + i).long()
        return torch.where(found, cell, torch.full_like(cell, ESCAPED))

    def decode(self, cell):
        """Flat cell id -> (fab, i, j, k)."""
        fab = torch.searchsorted(self.fab_offset, cell, right=True) - 1
        fab = fab.clamp(0, self.n_fabs - 1)
        local = cell - self.fab_offset[fab]
        nf = self.fab_n[fab].long()
        i = local % nf[:, 0]
        j = (local // nf[:, 0]) % nf[:, 1]
        k = local // (nf[:, 0] * nf[:, 1])
        return fab, i, j, k

    def _cell_bounds(self, cell):
        fab, i, j, k = self.decode(cell)
        lo = self.fab_lo[fab]
        dx = self.fab_dx[fab]
        # walls as lo + index * dx, the locate's on-wall expression
        x0 = lo[:, 0] + i * dx[:, 0]
        x1 = lo[:, 0] + (i + 1) * dx[:, 0]
        y0 = lo[:, 1] + j * dx[:, 1]
        y1 = lo[:, 1] + (j + 1) * dx[:, 1]
        z0 = lo[:, 2] + k * dx[:, 2]
        z1 = lo[:, 2] + (k + 1) * dx[:, 2]
        return x0, x1, y0, y1, z0, z1, dx

    def find_cell(self, x, y, z, kx, ky, kz):
        return self._locate(x, y, z, kx, ky, kz)

    def find_wall(self, cell, x, y, z, kx, ky, kz):
        """The exit from the cell's box, and the cell of a probe half a
        finest cell past the crossed wall along the crossing axis (small
        enough never to skip a cell of any level, large enough that the
        locate's division resolves it in float32). A probe that finds the
        same cell ends the walk (ESCAPED), as in the JAX package.

        Returns (t, next_cell, axis, wall_coord)."""
        big = torch.finfo(x.dtype).max / 8
        x0, x1, y0, y1, z0, z1, _ = self._cell_bounds(cell)

        def axis(p, k, lo, hi):
            wall = torch.where(k > 0, hi, lo)
            t = torch.where(k != 0.0, ((wall - p) / k).clamp_min(0.0), big)
            return t, wall

        t1, w1 = axis(x, kx, x0, x1)
        t2, w2 = axis(y, ky, y0, y1)
        t3, w3 = axis(z, kz, z0, z1)
        t = torch.minimum(torch.minimum(t1, t2), t3)
        ax = torch.where(t == t1, 0, torch.where(t == t2, 1, 2))

        xe = x + t * kx
        ye = y + t * ky
        ze = z + t * kz

        def sgn(k):
            return torch.where(k > 0, 1.0, -1.0).to(x.dtype)

        xp = torch.where(ax == 0, w1 + 0.5 * self.min_dx[0] * sgn(kx), xe)
        yp = torch.where(ax == 1, w2 + 0.5 * self.min_dx[1] * sgn(ky), ye)
        zp = torch.where(ax == 2, w3 + 0.5 * self.min_dx[2] * sgn(kz), ze)
        next_cell = self._locate(xp, yp, zp, kx, ky, kz)
        next_cell = torch.where(next_cell == cell,
                                torch.full_like(next_cell, ESCAPED), next_cell)
        wall_coord = torch.where(ax == 0, w1, torch.where(ax == 1, w2, w3))
        return t, next_cell, ax, wall_coord

    def closest_wall_distance(self, cell, x, y, z):
        x0, x1, y0, y1, z0, z1, _ = self._cell_bounds(cell)
        d = torch.minimum(torch.minimum(torch.minimum(x - x0, x1 - x),
                                        torch.minimum(y - y0, y1 - y)),
                          torch.minimum(z - z0, z1 - z))
        return d.clamp_min(0.0)

    def snap(self, x, y, z, ax, wall_coord, crossed):
        """Place crossed packets exactly on the crossed wall."""
        x = torch.where(crossed & (ax == 0), wall_coord, x)
        y = torch.where(crossed & (ax == 1), wall_coord, y)
        z = torch.where(crossed & (ax == 2), wall_coord, z)
        return x, y, z

    def in_cell_tol(self, cell, x, y, z, tol=0.01):
        """Bounds-with-tolerance membership (the geometry self-check oracle;
        ref in_correct_cell, grid_geometry_amr.f90)."""
        x0, x1, y0, y1, z0, z1, dx = self._cell_bounds(cell)
        return (x >= x0 - tol * dx[:, 0]) & (x <= x1 + tol * dx[:, 0]) & \
            (y >= y0 - tol * dx[:, 1]) & (y <= y1 + tol * dx[:, 1]) & \
            (z >= z0 - tol * dx[:, 2]) & (z <= z1 + tol * dx[:, 2])

    def position_in_cell(self, cell, u):
        """Uniform positions in the cells from uniforms ``u`` (3, B) in
        [0, 1), as the JAX package's ``random_position_in_cell``."""
        x0, x1, y0, y1, z0, z1, _ = self._cell_bounds(cell)
        return (x0 + u[0] * (x1 - x0), y0 + u[1] * (y1 - y0),
                z0 + u[2] * (z1 - z0))

    def search_order(self):
        """The fabs in the order of the finest-first search: levels from the
        finest down, each level's fabs in index order. The first fab in
        this order that holds a point is the one :meth:`_locate`'s argmax
        picks (the highest level, and the first fab of it on a tie), so a
        search that stops there gives the same cell (csrc/escape_tau.cu's
        AMR crossing searches so)."""
        level = self.fab_level.cpu().numpy()
        return np.lexsort((np.arange(len(level)), -level)).astype(np.int32)


def build_amr_geometry(grid, device, dtype):
    """Build the geometry tables of an AMRGrid in engine units (lengths
    divided by the largest absolute fab bound, as the JAX package)."""
    fab_lo, fab_hi, fab_n, fab_level = [], [], [], []
    for ilevel, level in enumerate(grid.levels):
        for g in level.grids:
            fab_lo.append([g.xmin, g.ymin, g.zmin])
            fab_hi.append([g.xmax, g.ymax, g.zmax])
            fab_n.append([g.nx, g.ny, g.nz])
            fab_level.append(ilevel)
    fab_lo = np.asarray(fab_lo, float)
    fab_hi = np.asarray(fab_hi, float)
    fab_n = np.asarray(fab_n, np.int32)
    fab_level = np.asarray(fab_level, np.int32)
    fab_dx = (fab_hi - fab_lo) / fab_n
    counts = fab_n.astype(np.int64).prod(axis=1)
    offsets = np.concatenate([[0], np.cumsum(counts)])

    L = float(np.abs(np.concatenate([fab_lo, fab_hi])).max())
    volumes = np.concatenate([
        np.full(int(c), float(d.prod()))
        for c, d in zip(counts, fab_dx)]) / L ** 3

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    return AMRGeometry(
        fab_lo=f(fab_lo / L), fab_hi=f(fab_hi / L),
        fab_n=torch.as_tensor(fab_n, device=device),
        fab_dx=f(fab_dx / L),
        fab_level=torch.as_tensor(fab_level, device=device),
        fab_offset=torch.as_tensor(offsets, dtype=torch.int64, device=device),
        volumes=f(volumes), min_dx=f(fab_dx.min(axis=0) / L),
        n_fabs=len(fab_lo), n_cells_total=int(counts.sum()),
        length_scale=L)
