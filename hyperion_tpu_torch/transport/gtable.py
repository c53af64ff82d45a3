"""Cartesian grid geometry of the port (counterpart of
``hyperion_tpu/transport/gtable.py``).

Lengths are in ENGINE UNITS, divided by ``length_scale`` (the grid's largest
extent), so positions are O(1) in float32. On a wall crossing the packet is
snapped exactly onto the crossed wall and its cell index is stepped
directly: the index, not the floating position, says which cell a packet is
in. Flat cell index: ic = (i3 * n2 + i2) * n1 + i1; ESCAPED (-1) outside.
The JAX module's packed-row twins (``wall_columns``, ``*_rows``) are a TPU
gather workaround and have no counterpart here."""

from dataclasses import dataclass

import numpy as np
import torch

from .sampling import searchsorted_right

ESCAPED = -1


def position_uniforms(geometry, first, rest):
    """The (geometry.POSITION_ROWS, B) uniforms of a position in one of the
    geometry's cells: the three rows ``first``, then, on a grid that takes
    more (the Voronoi grid's rejection trials), the rows it needs from the
    front of ``rest``."""
    n_more = geometry.POSITION_ROWS - 3
    return torch.cat([first, rest[:n_more]]) if n_more else first


@dataclass
class CartesianGeometry:
    # the uniforms a position in one of its cells takes (position_uniforms)
    POSITION_ROWS = 3

    xw: torch.Tensor
    yw: torch.Tensor
    zw: torch.Tensor
    volumes: torch.Tensor  # (n_cells,), = volumes_cgs / length_scale^3
    n1: int
    n2: int
    n3: int
    length_scale: float

    @property
    def n_cells(self):
        return self.n1 * self.n2 * self.n3

    def decode(self, cell):
        i1 = cell % self.n1
        i2 = (cell // self.n1) % self.n2
        i3 = cell // (self.n1 * self.n2)
        return i1, i2, i3

    def encode(self, i1, i2, i3):
        return (i3 * self.n2 + i2) * self.n1 + i1

    def find_cell(self, x, y, z, kx, ky, kz):
        """Locate packets; a packet exactly on a wall and moving in the -ve
        direction belongs to the lower cell (ref adjust_wall,
        grid_geometry_cartesian_3d.f90:169-230)."""
        def axis(w, p, k, n):
            i = searchsorted_right(w, p) - 1
            on_wall = p == w[i.clamp(0, n)]
            i = torch.where(on_wall & (k < 0), i - 1, i)
            return i, (i >= 0) & (i < n)

        i1, in1 = axis(self.xw, x, kx, self.n1)
        i2, in2 = axis(self.yw, y, ky, self.n2)
        i3, in3 = axis(self.zw, z, kz, self.n3)
        inside = in1 & in2 & in3
        return torch.where(inside, self.encode(i1, i2, i3),
                           torch.full_like(i1, ESCAPED))

    def find_wall(self, cell, x, y, z, kx, ky, kz):
        """Distance to the next wall along each ray.

        Returns (t, next_cell, axis, wall_coord): the distance, the flat
        index of the neighbouring cell (ESCAPED if the ray leaves the grid),
        the crossing axis (0/1/2) and the wall coordinate to snap onto."""
        i1, i2, i3 = self.decode(cell)
        big = torch.full_like(x, torch.finfo(x.dtype).max)

        def axis(w, p, k, i):
            wall = w[(i + (k > 0).long()).clamp(0, w.shape[0] - 1)]
            # rounding can leave p a hair past the target wall after a
            # diagonal move: clamp to an immediate zero-distance crossing so
            # the cell index never drifts from the position
            t = torch.where(k != 0.0, ((wall - p) / k).clamp_min(0.0), big)
            return t, wall

        t1, w1 = axis(self.xw, x, kx, i1)
        t2, w2 = axis(self.yw, y, ky, i2)
        t3, w3 = axis(self.zw, z, kz, i3)
        t = torch.minimum(torch.minimum(t1, t2), t3)
        ax = torch.where(t == t1, 0, torch.where(t == t2, 1, 2))

        j1 = torch.where(ax == 0, i1 + torch.where(kx > 0, 1, -1), i1)
        j2 = torch.where(ax == 1, i2 + torch.where(ky > 0, 1, -1), i2)
        j3 = torch.where(ax == 2, i3 + torch.where(kz > 0, 1, -1), i3)
        inside = (j1 >= 0) & (j1 < self.n1) & (j2 >= 0) & (j2 < self.n2) & \
                 (j3 >= 0) & (j3 < self.n3)
        next_cell = torch.where(inside, self.encode(j1, j2, j3),
                                torch.full_like(j1, ESCAPED))
        wall_coord = torch.where(ax == 0, w1, torch.where(ax == 1, w2, w3))
        return t, next_cell, ax, wall_coord

    def closest_wall_distance(self, cell, x, y, z):
        """Perpendicular distance to the nearest wall of the cell (the MRW
        trigger, ref distance_to_closest_wall)."""
        i1, i2, i3 = self.decode(cell)
        d1 = torch.minimum(x - self.xw[i1], self.xw[i1 + 1] - x)
        d2 = torch.minimum(y - self.yw[i2], self.yw[i2 + 1] - y)
        d3 = torch.minimum(z - self.zw[i3], self.zw[i3 + 1] - z)
        return torch.minimum(torch.minimum(d1, d2), d3).clamp_min(0.0)

    def in_cell_tol(self, cell, x, y, z, tol=0.01):
        """Is the position inside the cell's bounds within a ``tol``
        fraction of the cell extent? The geometry self-check oracle (ref
        in_correct_cell): bounds-based, so on-wall positions pass."""
        i1, i2, i3 = self.decode(cell)

        def ax(w, i, p):
            lo = w[i]
            hi = w[i + 1]
            m = tol * (hi - lo)
            return (p >= lo - m) & (p <= hi + m)

        return ax(self.xw, i1, x) & ax(self.yw, i2, y) & ax(self.zw, i3, z)

    def snap(self, x, y, z, ax, wall_coord, crossed):
        """Place crossed packets exactly on the crossed wall coordinate."""
        x = torch.where(crossed & (ax == 0), wall_coord, x)
        y = torch.where(crossed & (ax == 1), wall_coord, y)
        z = torch.where(crossed & (ax == 2), wall_coord, z)
        return x, y, z


def build_cartesian_geometry(grid, device, dtype):
    """Build the geometry tables of a CartesianGrid in engine units."""
    xw = np.asarray(grid.x_wall, float)
    yw = np.asarray(grid.y_wall, float)
    zw = np.asarray(grid.z_wall, float)
    L = float(max(np.abs(xw).max(), np.abs(yw).max(), np.abs(zw).max()))

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return CartesianGeometry(
        xw=f(xw / L), yw=f(yw / L), zw=f(zw / L),
        volumes=f(grid.volumes.reshape(-1) / L ** 3),
        n1=len(xw) - 1, n2=len(yw) - 1, n3=len(zw) - 1,
        length_scale=L)
