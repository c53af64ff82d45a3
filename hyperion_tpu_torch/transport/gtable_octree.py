"""Octree grid geometry of the port (counterpart of
``hyperion_tpu/transport/gtable_octree.py``; ref
src/grid/grid_geometry_octree.f90:98-539).

'Cells' are preorder node ids (leaves are physical); density and energy
arrays are indexed by node id, as in the JAX package. A point is located by
a descend from the root over the flattened ``children`` table, and a wall
crossing exits the leaf's box and relocates from the root at the exit
point.

The relocation is not the JAX package's. There the exit point is nudged by
``t_eps * h`` along the ray before the descend, and in float32 that nudge is
below one ulp of the position for leaves a few levels deep: the descend
finds the same leaf again and the walk stalls until the step cap (86% of
the crossings of a 12,409-node SPH tree, ``tests/test_torch_octree.py``).
The port relocates as the JAX AMR module does: :meth:`find_wall` returns the
crossing axis and the wall, :meth:`snap` puts the crossed coordinate exactly
on the wall, and the descend sends a point that lies exactly on a node's
centre plane to the side the ray moves towards. For that equality to hold,
a leaf's walls are the very values that the descend compares against: each
node's ``lo`` and ``hi`` are built on the host from its parent's centre and
bounds in the tables' type, never as ``c +- h`` on the device."""

from dataclasses import dataclass

import numpy as np
import torch

from .gtable import ESCAPED


@dataclass
class OctreeGeometry:
    # the uniforms a position in one of its cells takes (position_uniforms)
    POSITION_ROWS = 3

    centers: torch.Tensor   # (n_nodes, 3) engine units
    halves: torch.Tensor    # (n_nodes, 3)
    lo: torch.Tensor        # (n_nodes, 3) lower walls: a parent's centre or
    hi: torch.Tensor        # (n_nodes, 3) upper walls   bound, or the root's
    children: torch.Tensor  # (n_nodes, 8) int64, -1 for leaves
    refined: torch.Tensor   # (n_nodes,) bool
    volumes: torch.Tensor   # (n_nodes,) / L^3
    max_depth: int          # refinement levels below the root
    n_nodes: int
    length_scale: float

    @property
    def n_cells(self):
        return self.n_nodes

    def _descend(self, x, y, z, kx, ky, kz):
        """The leaf that holds each point, from the root: at each refined
        node the octant by the node's centre planes, a point on a plane
        going to the side its direction moves towards (the upper one for a
        direction along the plane, as the JAX package's ``>=``)."""
        node = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
        for _ in range(self.max_depth):
            c = self.centers[node]
            octant = (torch.where(kx < 0, x > c[:, 0], x >= c[:, 0]).long() +
                      2 * torch.where(ky < 0, y > c[:, 1], y >= c[:, 1]).long()
                      + 4 * torch.where(kz < 0, z > c[:, 2], z >= c[:, 2]).long())
            child = self.children[node, octant]
            node = torch.where(self.refined[node], child, node)
        return node

    def _inside(self, x, y, z, kx, ky, kz):
        """Inside the root box, a point on a face belonging to the grid
        unless its direction leaves through that face."""
        lo, hi = self.lo[0], self.hi[0]

        def axis(p, k, a):
            return torch.where(k > 0, p < hi[a], p <= hi[a]) & \
                torch.where(k < 0, p > lo[a], p >= lo[a])

        return axis(x, kx, 0) & axis(y, ky, 1) & axis(z, kz, 2)

    def find_cell(self, x, y, z, kx, ky, kz):
        """The leaf of each point (ESCAPED outside the root box); a point on
        a wall belongs to the side its direction moves towards (ref
        adjust_wall)."""
        leaf = self._descend(x, y, z, kx, ky, kz)
        return torch.where(self._inside(x, y, z, kx, ky, kz), leaf,
                           torch.full_like(leaf, ESCAPED))

    def find_wall(self, cell, x, y, z, kx, ky, kz):
        """The exit from the leaf's box and the leaf beyond it (ref
        find_wall, grid_geometry_octree.f90:438-539).

        Returns (t, next_cell, axis, wall_coord): the distance, the leaf
        that holds the exit point snapped onto the crossed wall (found from
        the root by :meth:`find_cell`, ESCAPED outside the grid), the
        crossing axis (0/1/2) and the wall coordinate to snap onto."""
        big = torch.finfo(x.dtype).max / 8
        lo = self.lo[cell]
        hi = self.hi[cell]

        def axis(p, k, a):
            wall = torch.where(k > 0, hi[:, a], lo[:, a])
            # a point a hair past the wall it moves to (rounding after a
            # diagonal move) crosses it at once
            t = torch.where(k != 0.0, ((wall - p) / k).clamp_min(0.0), big)
            return t, wall

        t1, w1 = axis(x, kx, 0)
        t2, w2 = axis(y, ky, 1)
        t3, w3 = axis(z, kz, 2)
        t = torch.minimum(torch.minimum(t1, t2), t3)
        ax = torch.where(t == t1, 0, torch.where(t == t2, 1, 2))
        wall_coord = torch.where(ax == 0, w1, torch.where(ax == 1, w2, w3))
        xe, ye, ze = self.snap(x + t * kx, y + t * ky, z + t * kz, ax,
                               wall_coord, torch.ones_like(cell, dtype=bool))
        next_cell = self.find_cell(xe, ye, ze, kx, ky, kz)
        return t, next_cell, ax, wall_coord

    def closest_wall_distance(self, cell, x, y, z):
        """Perpendicular distance to the nearest wall of the leaf (the MRW
        trigger)."""
        lo = self.lo[cell]
        hi = self.hi[cell]
        d1 = torch.minimum(x - lo[:, 0], hi[:, 0] - x)
        d2 = torch.minimum(y - lo[:, 1], hi[:, 1] - y)
        d3 = torch.minimum(z - lo[:, 2], hi[:, 2] - z)
        return torch.minimum(torch.minimum(d1, d2), d3).clamp_min(0.0)

    def snap(self, x, y, z, ax, wall_coord, crossed):
        """Place crossed packets exactly on the crossed wall."""
        x = torch.where(crossed & (ax == 0), wall_coord, x)
        y = torch.where(crossed & (ax == 1), wall_coord, y)
        z = torch.where(crossed & (ax == 2), wall_coord, z)
        return x, y, z

    def in_cell_tol(self, cell, x, y, z, tol=0.01):
        """Is the position inside the leaf's box within a ``tol`` fraction
        of its half-width? The geometry self-check oracle (ref
        in_correct_cell, grid_geometry_octree.f90)."""
        c = self.centers[cell]
        h = self.halves[cell]
        return ((x - c[:, 0]).abs() <= h[:, 0] * (1.0 + tol)) & \
            ((y - c[:, 1]).abs() <= h[:, 1] * (1.0 + tol)) & \
            ((z - c[:, 2]).abs() <= h[:, 2] * (1.0 + tol))

    def position_in_cell(self, cell, u):
        """Uniform positions in the leaves from uniforms ``u`` (3, B) in
        [0, 1): the centre plus (2u - 1) times the half-width, the JAX
        package's ``random_position_in_cell`` with its [-1, 1) draws."""
        c = self.centers[cell]
        h = self.halves[cell]
        return (c[:, 0] + (u[0] * 2.0 - 1.0) * h[:, 0],
                c[:, 1] + (u[1] * 2.0 - 1.0) * h[:, 1],
                c[:, 2] + (u[2] * 2.0 - 1.0) * h[:, 2])


def node_bounds(centers, children, refined, root_lo, root_hi):
    """Each node's (lo, hi) (n_nodes, 3): the root's given bounds, and a
    child's the parent's lower bound and centre, or centre and upper bound,
    by its octant (bit 0 x, 1 y, 2 z, as ``OctreeGrid.tree_tables``). The
    values are copies of the parents' centres and of the root's bounds, so
    they are exact in the type of ``centers``."""
    n = len(refined)
    lo = np.empty((n, 3), centers.dtype)
    hi = np.empty((n, 3), centers.dtype)
    lo[0], hi[0] = root_lo, root_hi
    frontier = np.array([0])
    while len(frontier):
        parents = frontier[refined[frontier]]
        if not len(parents):
            break
        kids = children[parents]
        for k in range(8):
            bits = np.array([k & 1, (k >> 1) & 1, (k >> 2) & 1], bool)
            ch = kids[:, k]
            lo[ch] = np.where(bits, centers[parents], lo[parents])
            hi[ch] = np.where(bits, hi[parents], centers[parents])
        frontier = kids.reshape(-1)
    return lo, hi


def tree_depth(children, refined):
    """The number of refinement levels below the root (0 for one leaf)."""
    depth = 0
    frontier = np.array([0])
    while True:
        parents = frontier[refined[frontier]]
        if not len(parents):
            return depth
        frontier = children[parents].reshape(-1)
        depth += 1


def build_octree_geometry(grid, device, dtype):
    """Build the geometry tables of an OctreeGrid in engine units (lengths
    divided by the root's largest width, as the JAX package)."""
    centers, halves, children = grid.tree_tables()
    refined = np.asarray(grid.refined, dtype=bool)
    L = float(max(grid.dx, grid.dy, grid.dz) * 2.0)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    c = (centers / L).astype(np_dtype)
    root_lo = ((centers[0] - halves[0]) / L).astype(np_dtype)
    root_hi = ((centers[0] + halves[0]) / L).astype(np_dtype)
    lo, hi = node_bounds(c, children, refined, root_lo, root_hi)
    volumes = 8.0 * halves[:, 0] * halves[:, 1] * halves[:, 2] / L ** 3

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return OctreeGeometry(
        centers=f(c), halves=f(halves / L), lo=f(lo), hi=f(hi),
        children=torch.as_tensor(children.astype(np.int64), device=device),
        refined=torch.as_tensor(refined, device=device),
        volumes=f(volumes), max_depth=tree_depth(children, refined),
        n_nodes=len(refined), length_scale=L)
