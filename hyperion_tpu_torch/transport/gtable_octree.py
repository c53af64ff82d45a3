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
bounds in the tables' type, never as ``c +- h`` on the device.

On CUDA tensors :meth:`OctreeGeometry.find_cell` and
:meth:`OctreeGeometry.find_wall` run in the hand-written kernel of
``csrc/octree_locate.cu`` (:mod:`.octree_locate`), which descends from the
root over the node records (:attr:`OctreeGeometry.node_records`); on CPU
tensors their plain versions :func:`.octree_locate.find_cell_reference`
and :func:`.octree_locate.find_wall_reference`, the descend of
:meth:`OctreeGeometry._descend`.

The walk kernel (``csrc/escape_tau.cu``) finds the same leaf another way:
it walks up from the leaf it leaves to the first ancestor that holds the
landing point under the descend's own side rule (:meth:`OctreeGeometry.
holds`), and descends from there, reading one node record a level.
:meth:`OctreeGeometry.locate_from` is the host copy of that walk, for the
tests."""

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch


# A node record of the walk kernel (csrc/escape_tau.cu kRecordWords): 16
# float64 words, 128 bytes, one L2 line of four 32-byte sectors. Words 0-2:
# the centre; word 3 as int32: the parent (-1 for the root) and the mask of
# the children that are leaves (bit o for child o); words 4-7 as int32: the
# 8 children (-1 for a leaf's); words 8-13: lo (x, y, z), hi (x, y, z);
# words 14-15: a pad.
RECORD_WORDS = 16
RECORD_PARENT = 6     # int32 words
RECORD_LEAVES = 7
RECORD_CHILDREN = 8
RECORD_WALLS = 8      # float64 words


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

    @cached_property
    def parents(self):
        """(n_nodes,) int64: each node's parent, -1 for the root."""
        parent = torch.full((self.n_nodes,), -1, dtype=torch.int64,
                            device=self.children.device)
        kids = self.children[self.refined]
        parent[kids.reshape(-1)] = torch.nonzero(
            self.refined)[:, 0].repeat_interleave(8)
        return parent

    @cached_property
    def depths(self):
        """(n_nodes,) int64: each node's levels below the root."""
        depth = torch.zeros(self.n_nodes, dtype=torch.int64,
                            device=self.children.device)
        for _ in range(self.max_depth):
            depth = torch.where(self.parents >= 0,
                                depth[self.parents.clamp_min(0)] + 1, depth)
        return depth

    @cached_property
    def node_records(self):
        """The walk kernel's node records, (n_nodes, RECORD_WORDS) float64
        built once from these tables on their device (the layout above
        RECORD_WORDS): each node's centre, parent, leaf-children mask,
        children and walls, the centre and walls to the bit (widened from
        float32 tables, which float64 holds exactly)."""
        n = self.n_nodes
        rec = torch.zeros((n, RECORD_WORDS), dtype=torch.float64,
                          device=self.lo.device)
        rec[:, 0:3] = self.centers
        rec[:, RECORD_WALLS:RECORD_WALLS + 3] = self.lo
        rec[:, RECORD_WALLS + 3:RECORD_WALLS + 6] = self.hi
        words = rec.view(torch.int32)
        words[:, RECORD_PARENT] = self.parents.to(torch.int32)
        kids = self.children
        leaf = (kids >= 0) & ~self.refined[kids.clamp_min(0)]
        octants = torch.arange(8, device=kids.device)
        words[:, RECORD_LEAVES] = (leaf.long() << octants).sum(dim=1).to(
            torch.int32)
        words[:, RECORD_CHILDREN:RECORD_CHILDREN + 8] = kids.to(torch.int32)
        return rec

    def holds(self, node, x, y, z, kx, ky, kz):
        """Whether each point lies in the node's box under the descend's
        side rule (:func:`upper`): at or past ``lo`` and before ``hi`` on
        every axis, a point on a wall taking the side its direction moves
        towards (the upper one along the wall). A node that holds the
        point is one the descend from the root passes through (the walls
        are copies of the ancestors' centres), unless a wall is a root
        face, which only sends the walk further up."""
        lo, hi = self.lo[node], self.hi[node]
        ok = torch.ones_like(node, dtype=torch.bool)
        for a, (p, k) in enumerate(((x, kx), (y, ky), (z, kz))):
            ok = ok & upper(p, lo[:, a], k) & ~upper(p, hi[:, a], k)
        return ok

    def locate_from(self, leaf, x, y, z, kx, ky, kz):
        """The leaf that holds each landing point of a crossing out of
        ``leaf``, found as the walk kernel finds it. The walls of the leaf
        that the point lies on and moves onto or along (the crossed one
        among them) are each a copy of the centre of the ancestor that set
        it, or a root face; the first ancestor that :meth:`holds` the point
        is the one where, climbing from the leaf's parent, the centres
        read account for all of them (the root at most). The descend from
        it gives the leaf of the descend from the root (:meth:`_descend`).
        A point off the leaf's box on an axis it does not cross (by
        rounding) is located from the root. Returns (leaf, the levels
        climbed from the leaf, the levels descended)."""
        parent = self.parents
        lo, hi = self.lo[leaf], self.hi[leaf]
        off = torch.zeros_like(leaf, dtype=torch.bool)
        walls, left = [], []
        for a, (p, k) in enumerate(((x, kx), (y, ky), (z, kz))):
            on_hi = (k >= 0) & (p >= hi[:, a])
            on_lo = (k < 0) & (p <= lo[:, a])
            off = off | (p > hi[:, a]) | (p < lo[:, a])
            walls.append(torch.where(on_hi, hi[:, a], lo[:, a]))
            left.append(on_hi | on_lo)
        node = parent[leaf].clamp_min(0)
        up = torch.ones_like(leaf)
        while True:
            c = self.centers[node]
            left = [w & (c[:, a] != walls[a]) for a, w in enumerate(left)]
            climb = (left[0] | left[1] | left[2]) & (parent[node] >= 0) & \
                ~off
            if not bool(climb.any()):
                break
            node = torch.where(climb, parent[node], node)
            up = up + climb.long()
        node = torch.where(off, 0, node)
        up = torch.where(off, self.depths[leaf], up)
        found = self._descend_from(node, x, y, z, kx, ky, kz)
        return found, up, self.depths[found] - self.depths[node]

    def _descend_from(self, node, x, y, z, kx, ky, kz):
        """The descend from each ``node`` to the leaf that holds the
        point."""
        for _ in range(self.max_depth):
            c = self.centers[node]
            octant = (upper(x, c[:, 0], kx).long() +
                      2 * upper(y, c[:, 1], ky).long() +
                      4 * upper(z, c[:, 2], kz).long())
            child = self.children[node, octant]
            node = torch.where(self.refined[node], child, node)
        return node

    def _descend(self, x, y, z, kx, ky, kz):
        """The leaf that holds each point, from the root: at each refined
        node the octant by the node's centre planes, a point on a plane
        going to the side its direction moves towards (the upper one for a
        direction along the plane, as the JAX package's ``>=``)."""
        root = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
        return self._descend_from(root, x, y, z, kx, ky, kz)

    def _inside(self, x, y, z, kx, ky, kz):
        """Inside the root box, a point on a face belonging to the grid
        unless its direction leaves through that face."""
        lo, hi = self.lo[0], self.hi[0]

        def axis(p, k, a):
            return torch.where(k > 0, p < hi[a], p <= hi[a]) & \
                torch.where(k < 0, p > lo[a], p >= lo[a])

        return axis(x, kx, 0) & axis(y, ky, 1) & axis(z, kz, 2)

    @cached_property
    def locator(self):
        """The locate of these tables (:class:`.octree_locate.OctreeLocate`),
        made at the first locate: tables that never locate, such as the
        float64 copy a walk kernel binds, load no kernel."""
        from .octree_locate import OctreeLocate
        return OctreeLocate(self)

    def find_cell(self, x, y, z, kx, ky, kz):
        """The leaf of each point (ESCAPED outside the root box); a point on
        a wall belongs to the side its direction moves towards (ref
        adjust_wall). The octree_locate kernel on CUDA tensors, its plain
        version :func:`.octree_locate.find_cell_reference` on CPU ones."""
        return self.locator.find_cell(*(a.contiguous() for a in
                                        (x, y, z, kx, ky, kz)))

    def find_wall(self, cell, x, y, z, kx, ky, kz):
        """The exit from the leaf's box and the leaf beyond it (ref
        find_wall, grid_geometry_octree.f90:438-539).

        Returns (t, next_cell, axis, wall_coord): the distance, the leaf
        that holds the exit point snapped onto the crossed wall (found from
        the root as :meth:`find_cell` finds it, ESCAPED outside the grid),
        the crossing axis (0/1/2) and the wall coordinate to snap onto. The
        octree_locate kernel on CUDA tensors, its plain version
        :func:`.octree_locate.find_wall_reference` on CPU ones."""
        return self.locator.find_wall(*(a.contiguous() for a in
                                        (cell, x, y, z, kx, ky, kz)))

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


def upper(p, c, k):
    """The side of a centre plane or wall ``c`` that the point ``p`` with
    direction ``k`` belongs to: above it, or on it moving up or along it
    (the descend's rule; the kernel's ``upper``)."""
    return torch.where(k < 0, p > c, p >= c)


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
