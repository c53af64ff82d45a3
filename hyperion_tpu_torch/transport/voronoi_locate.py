"""The owner walk of a Voronoi grid: the cell that owns each point
(counterpart of ``VoronoiGeometry._owner_walk`` and ``_lattice_start``,
``hyperion_tpu/transport/gtable_voronoi.py:49-82``, an XLA ``fori_loop`` of
``walk_steps`` steps over the whole batch).

:class:`VoronoiLocate` holds one grid's tables. On CUDA tensors its two
calls launch the hand-written kernel in ``csrc/voronoi_locate.cu`` over the
grid's packed rows (:func:`locate_tables`), four threads a lane; on CPU tensors they run the plain PyTorch version
:func:`locate_reference` / :func:`owner_walk_reference`. Nothing falls back
from one to the other.

- ``locate(x, y, z)``: the lattice start ``lookup[(k m + j) m + i]`` with
  each index ``((p - lo) / (hi - lo) * m)`` truncated and clipped to [0, m),
  then the owner walk; ESCAPED outside the closed box.
- ``walk_from(start, x, y, z)``: the owner walk from given cells (the
  trials of a position in a cell).

A step of the walk computes d2 = (s_x - x)^2 + (s_y - y)^2 + (s_z - z)^2 in
the lanes' type for each neighbour of the current cell, takes the nearest
(the first index among equals) and moves there only if it is strictly
nearer than the current site. A step that does not move leaves the state as
it was, so the kernel stops a lane there; the cap is ``walk_steps``, the
JAX package's. The count of lanes whose last allowed step still moved (the
walk may have stopped short of the owner) is kept on the device
(:meth:`VoronoiLocate.lanes_at_cap`)."""

import ctypes

import torch

from . import _build
from .gtable import ESCAPED

# zero entries after the packed rows' last (gtable_voronoi.py
# VoronoiGeometry.packed_rows): the kernels load a row's first entries
# before they know its length (csrc/escape_tau.cu kVorChunk,
# csrc/voronoi_locate.cu kChunk, each at most the libraries' kRowPad,
# which their wrappers check against this)
ROW_PAD = 16

# kernel launches since the last reset; chip_smoke.py reads it to show that
# the main path ran the kernel
launches = 0


def locate_tables(geo):
    """The tables that the kernel binds, in the order of its arguments, on
    the geometry's device: (sites (n, 3) and the packed rows' sites (E +
    ROW_PAD, 3) in the sites' type, their (neighbour, offset) entries (E +
    ROW_PAD, 2) int32, the rows' offsets (n + 1,) int32, the lattice (m^3,)
    int32)."""
    rows = geo.packed_rows
    return geo.sites, rows.sites, rows.meta, rows.off, geo.lookup


def _d2(sites, c, x, y, z):
    return (sites[c, 0] - x) ** 2 + (sites[c, 1] - y) ** 2 + \
        (sites[c, 2] - z) ** 2


def owner_walk_reference(sites, neigh, start, x, y, z, walk_steps,
                         visits=None):
    """The plain owner walk from ``start`` (B,) for at most ``walk_steps``
    steps: (owner (B,) int64, at_cap (B,) bool, whether the last allowed
    step still moved). ``visits``, an int64 (n_cells,) tensor or None,
    gets one added at the current cell for every neighbour row read (a
    lane reads rows until a step does not move, as the kernel does).
    Stops once no lane moves (the state is then final)."""
    cur = start.long()
    d2c = _d2(sites, cur, x, y, z)
    moving = torch.ones_like(cur, dtype=torch.bool)
    better = torch.zeros_like(moving)
    for _ in range(walk_steps):
        if visits is not None:
            visits.index_add_(0, cur[moving], torch.ones_like(
                cur[moving]))
        nb = neigh[cur]
        valid = nb >= 0
        nb_safe = torch.where(valid, nb, 0).long()
        s = sites[nb_safe]
        d2 = (s[..., 0] - x[:, None]) ** 2 + (s[..., 1] - y[:, None]) ** 2 + \
            (s[..., 2] - z[:, None]) ** 2
        d2 = torch.where(valid, d2, torch.inf)
        j = torch.argmin(d2, dim=-1, keepdim=True)
        d2_best = d2.gather(-1, j)[:, 0]
        better = d2_best < d2c
        cur = torch.where(better, nb_safe.gather(-1, j)[:, 0], cur)
        d2c = torch.where(better, d2_best, d2c)
        moving = moving & better
        if not bool(better.any()):
            break
    return cur, better


def lattice_index(geo, x, y, z):
    """The flat index (k m + j) m + i of each point's lattice cell, each
    index truncated and clipped into the lattice."""
    m = geo.lookup_n

    def f(p, a):
        lo, hi = geo.box_lo[a], geo.box_hi[a]
        return ((p - lo) / (hi - lo) * m).to(torch.int32).clamp(0, m - 1)

    i, j, k = f(x, 0), f(y, 1), f(z, 2)
    return ((k * m + j) * m + i).long()


def lattice_start(geo, x, y, z):
    """The lattice cell's nearest site of each point."""
    return geo.lookup[lattice_index(geo, x, y, z)]


def inside_box(geo, x, y, z):
    lo, hi = geo.box_lo, geo.box_hi
    return (x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1]) & \
        (z >= lo[2]) & (z <= hi[2])


def locate_reference(geo, x, y, z, visits=None, at_cap=False):
    """The plain locate of :class:`VoronoiLocate`: the cells (B,) int64,
    and with ``at_cap`` also the lanes whose last allowed step moved."""
    owner, cap = owner_walk_reference(geo.sites, geo.neigh,
                                      lattice_start(geo, x, y, z), x, y, z,
                                      geo.walk_steps, visits)
    inside = inside_box(geo, x, y, z)
    cell = torch.where(inside, owner, ESCAPED)
    return (cell, cap & inside) if at_cap else cell


def _lane_error(name, t, dtype, shape, device):
    return ValueError(
        "voronoi_locate: %s must be a contiguous %s tensor of shape %s on "
        "%s; got %s %s on %s (contiguous=%s)"
        % (name, dtype, shape, device, t.dtype, tuple(t.shape), t.device,
           t.is_contiguous()))


class VoronoiLocate:
    """One Voronoi grid's owner walk: ``locate(x, y, z)`` and
    ``walk_from(start, x, y, z)`` return the owning cells (B,) int64 of
    positions in the tables' type.

    On CUDA the tables (:func:`locate_tables`: the sites, the packed rows
    and the lattice) are checked and kept, the box read once, and a device
    counter of the lanes at the cap made: a call checks its lanes,
    allocates the cells and launches once on the current stream without
    synchronising. On the CPU the plain version runs, counting its lanes
    at the cap on the host."""

    def __init__(self, geo):
        self.geo = geo
        self.device = geo.sites.device
        self.dtype = geo.sites.dtype
        self._cuda = self.device.type == 'cuda'
        self._device_index = -1
        self._plain_at_cap = 0
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError("voronoi_locate takes float32 or float64 sites, "
                             "not %s" % self.dtype)
        if not self._cuda:
            if self.device.type != 'cpu':
                raise ValueError("voronoi_locate runs on CPU or CUDA tensors, "
                                 "not %s" % self.device)
            return
        n = geo.neigh.shape[0]
        tables = locate_tables(geo)
        entries = tables[1].shape[0]
        for name, t, dtype, shape in zip(
                ('sites', 'row_sites', 'meta', 'off', 'lookup'), tables,
                (self.dtype, self.dtype, torch.int32, torch.int32,
                 torch.int32),
                ((n, 3), (entries, 3), (entries, 2), (n + 1,),
                 (geo.lookup_n ** 3,))):
            if t.dtype != dtype or t.device != self.device or \
                    t.shape != shape or not t.is_contiguous():
                raise _lane_error(name, t, dtype, shape, self.device)
        self._tables = tables
        self._device_index = self.device.index
        self._box = [float(v) for v in torch.cat([geo.box_lo, geo.box_hi])]
        self._at_cap = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._stream = torch._C._cuda_getCurrentRawStream
        with torch.cuda.device(self._device_index):
            self._fn = _kernel()

    def locate(self, x, y, z):
        """The owner of each point (ESCAPED outside the box)."""
        if not self._cuda:
            cell, cap = locate_reference(self.geo, x, y, z, at_cap=True)
            self._plain_at_cap += int(cap.sum())
            return cell
        return self._launch(None, x, y, z)

    def walk_from(self, start, x, y, z):
        """The owner walk of each point from ``start`` (B,) int64."""
        if not self._cuda:
            owner, cap = owner_walk_reference(
                self.geo.sites, self.geo.neigh, start, x, y, z,
                self.geo.walk_steps)
            self._plain_at_cap += int(cap.sum())
            return owner
        return self._launch(start, x, y, z)

    def lanes_at_cap(self):
        """The lanes of this object's calls whose walk still moved at its
        last allowed step (reads the device counter on the card)."""
        if not self._cuda:
            return self._plain_at_cap
        return int(self._at_cap.item())

    def _check(self, name, t, dtype, shape):
        # get_device() is the card's index, or -1 on the CPU
        if t.dtype != dtype or t.get_device() != self._device_index or \
                t.shape != shape or not t.is_contiguous():
            raise _lane_error(name, t, dtype, shape, self.device)

    def _launch(self, start, x, y, z):
        global launches
        B = x.shape[0]
        for name, t in (('x', x), ('y', y), ('z', z)):
            self._check(name, t, self.dtype, (B,))
        if start is not None:
            self._check('start', start, torch.int64, (B,))
        out = torch.empty(B, dtype=torch.int64, device=self.device)
        if B == 0:
            return out
        if B >= 2 ** 31:
            raise ValueError("voronoi_locate: %d lanes is too many for one "
                             "call" % B)
        geo = self.geo
        err = self._fn(int(self.dtype == torch.float64),
                       *(t.data_ptr() for t in self._tables), geo.lookup_n,
                       *self._box, geo.walk_steps,
                       x.data_ptr(), y.data_ptr(), z.data_ptr(),
                       0 if start is None else start.data_ptr(),
                       out.data_ptr(), self._at_cap.data_ptr(), B,
                       self._stream(self._device_index))
        if err != 0:
            raise RuntimeError("voronoi_locate kernel launch failed: "
                               "cudaError %d" % err)
        launches += 1
        return out


def _kernel():
    lib = _build.load('voronoi_locate')
    if lib.voronoi_locate_row_pad() != ROW_PAD:
        raise RuntimeError("voronoi_locate: the library's row pad is %d, the "
                           "tables' %d" % (lib.voronoi_locate_row_pad(),
                                           ROW_PAD))
    fn = lib.voronoi_locate
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 +
                       [ctypes.c_int] + [ctypes.c_double] * 6 +
                       [ctypes.c_int] + [ctypes.c_void_p] * 6 +
                       [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
