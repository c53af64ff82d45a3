"""AMR grid geometry of the port (counterpart of
``hyperion_tpu/transport/gtable_amr.py``; ref
src/grid/grid_geometry_amr.f90:98-873).

The levels -> grids (fabs) -> cells hierarchy is flattened to per-fab
tables (bounds, cell counts, cell sizes, flat cell offsets, level). A point
is located by a point-in-fab test over every fab, the finest level winning
(the reference's per-level locate_grid/find_position_in_grid recursion), and
a wall crossing exits the cell's box, probes half a finest cell past the
crossed wall and locates the probe, as in the JAX package. Coarse cells
covered by finer fabs are never entered. The walk kernel locates through
an index per level instead (``level_index``, built on the host from these
tables), whose plain version ``locate_indexed`` gives ``_locate``'s cell.

Flat cell index: fab_offset + (k * ny + j) * nx + i, fabs ordered
level-major (level 1 first), the on-disk level_*/grid_* layout. Wall
positions are always ``lo + i * dx``, the same expression in the locate,
the cell bounds and the snap, so that the on-wall test is exact."""

from dataclasses import dataclass

import numpy as np
import torch

from .gtable import ESCAPED

# the indexed locate (AMRGeometry.level_index): at most this many bins an
# axis on a level's lattice, and the least margin, in bin widths, within
# which a point near a bin's edge takes the level's fringe list
LEVEL_BINS = 8
LEVEL_MARGIN = 1e-9


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

    def level_index(self):
        """The index of the fabs by level that the indexed locate walks
        (:meth:`locate_indexed`, and csrc/escape_tau.cu's AMR crossing),
        built on the host from the geometry's own tables. Each level, from
        the finest down, gets the box of its fabs and a uniform lattice of
        at most LEVEL_BINS bins an axis (about one bin per fab across);
        each bin the level's fabs that reach more than half the margin into
        it, in index order (its core list); and the level the list of all
        its fabs in index order (its fringe list). A point more than the
        margin inside a bin can be held only by a fab of that bin's core
        list; a point within the margin of a bin's edge or of the level's
        box takes the fringe list; a point farther out than the margin is
        held by no fab of the level. The margin, in bin widths, is far
        above the rounding of the point's bin and of the fab test's
        quotient, so the first fab of the list that holds the point is the
        one that :meth:`_locate`'s argmax picks.

        Returns (levels (L, 8) float64: the box's low corner, the inverse
        bin widths and the margin in bin widths per level; ints (int32): per
        level the bins an axis, where its bins' list starts are, where its
        fringe list starts and ends (8 words, the offsets into ``ints``);
        then each level's list starts (its bins' + 1, offsets into
        ``ints``), the core lists and the fringe lists)."""
        lo = self.fab_lo.double().cpu().numpy()
        dx = self.fab_dx.double().cpu().numpy()
        n = self.fab_n.cpu().numpy().astype(np.float64)
        # a fab's extent as the fab test sees it (lo + n dx) and as given
        hi = np.maximum(self.fab_hi.double().cpu().numpy(), lo + n * dx)
        level = self.fab_level.cpu().numpy()
        eps = float(torch.finfo(self.fab_lo.dtype).eps)
        scale = max(float(np.abs(lo).max()), float(np.abs(hi).max()), 1.0)
        levels = sorted(set(level.tolist()), reverse=True)
        L = len(levels)
        head = np.zeros((L, 8), np.int64)
        floats = np.zeros((L, 8), np.float64)
        starts, core, fringe = [], [], []
        for li, lev in enumerate(levels):
            fabs = np.nonzero(level == lev)[0]
            box_lo, box_hi = lo[fabs].min(axis=0), hi[fabs].max(axis=0)
            extent = box_hi - box_lo
            smallest = (hi[fabs] - lo[fabs]).min(axis=0)
            nb = np.clip(np.rint(extent / smallest), 1, LEVEL_BINS) \
                .astype(np.int64)
            width = extent / nb
            margin = max(LEVEL_MARGIN, 64.0 * eps * scale / width.min())
            floats[li, :3] = box_lo
            floats[li, 3:6] = 1.0 / width
            floats[li, 6] = margin
            head[li, :3] = nb
            head[li, 3] = len(starts)
            # the fabs that reach more than half the margin into each bin
            shrink = 0.5 * margin * width
            ib = np.stack(np.meshgrid(*[np.arange(m) for m in nb[::-1]],
                                      indexing='ij')[::-1], -1).reshape(-1, 3)
            b_lo = box_lo + ib * width + shrink
            b_hi = box_lo + (ib + 1) * width - shrink
            inside = ((lo[fabs][None] < b_hi[:, None]) &
                      (hi[fabs][None] > b_lo[:, None])).all(axis=-1)
            for row in inside:
                starts.append(len(core))
                core.extend(fabs[row].tolist())
            starts.append(len(core))
            head[li, 4] = len(fringe)
            fringe.extend(fabs.tolist())
            head[li, 5] = len(fringe)
        # offsets into the one int32 table: the heads, the starts, the core
        # lists, the fringe lists
        at_starts = 8 * L
        at_core = at_starts + len(starts)
        at_fringe = at_core + len(core)
        head[:, 3] += at_starts
        head[:, 4:6] += at_fringe
        ints = np.concatenate([head.reshape(-1),
                               np.asarray(starts, np.int64) + at_core,
                               np.asarray(core, np.int64),
                               np.asarray(fringe, np.int64)]).astype(np.int32)
        return floats, ints

    def locate_indexed(self, x, y, z, kx, ky, kz):
        """The plain version of the kernel's indexed locate: the levels from
        the finest down (:meth:`level_index`), at each the point's bin and
        its list, the fabs of the list tested in order with the fab test of
        :meth:`_axis_index` and the first that holds the point taken.
        Returns the flat cell ids (ESCAPED where no fab holds the point),
        those of :meth:`_locate`."""
        floats, ints = self.level_index()
        dev = x.device
        floats = torch.as_tensor(floats, dtype=x.dtype, device=dev)
        ints = torch.as_tensor(ints, dtype=torch.int64, device=dev)
        nf = self.fab_n.long()
        p, k = (x, y, z), (kx, ky, kz)
        cell = torch.full(x.shape, ESCAPED, dtype=torch.int64, device=dev)
        done = torch.zeros(x.shape, dtype=torch.bool, device=dev)
        for li in range(floats.shape[0]):
            head = ints[8 * li:8 * li + 8]
            margin = floats[li, 6]
            far = torch.zeros_like(done)
            near = torch.zeros_like(done)
            b = []
            for a in range(3):
                u = (p[a] - floats[li, a]) * floats[li, 3 + a]
                nb = head[a]
                far = far | (u < -margin) | (u > nb + margin)
                fl = torch.floor(u)
                fr = u - fl
                near = near | (fr <= margin) | (fr >= 1.0 - margin) | \
                    (fl < 0) | (fl >= nb)
                b.append(fl.clamp(0, int(nb) - 1).long())
            look = ~done & ~far
            binid = (b[2] * head[1] + b[1]) * head[0] + b[0]
            first = torch.where(near, head[4], ints[head[3] + binid])
            last = torch.where(near, head[5], ints[head[3] + binid + 1])
            for e in range(int((last - first).max()) if look.any() else 0):
                try_ = look & (first + e < last)
                fab = torch.where(try_, ints[torch.where(try_, first + e,
                                                         0)], 0)
                idx, ok = [], try_
                for a in range(3):
                    lo_a = self.fab_lo[fab, a]
                    dx_a = self.fab_dx[fab, a]
                    i = torch.floor((p[a] - lo_a) / dx_a).to(torch.int32)
                    on_wall = (lo_a + i * dx_a) == p[a]
                    i = torch.where(on_wall & (k[a] < 0), i - 1, i)
                    ok = ok & (i >= 0) & (i < self.fab_n[fab, a])
                    idx.append(i.long())
                c = self.fab_offset[fab] + (idx[2] * nf[fab, 1] + idx[1]) * \
                    nf[fab, 0] + idx[0]
                cell = torch.where(ok, c, cell)
                done = done | ok
                look = look & ~ok
        return cell


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
