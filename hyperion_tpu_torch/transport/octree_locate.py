"""The leaf of an octree grid that holds each point, and the exit from a
leaf's box (counterpart of ``OctreeGeometry._descend``, ``find_cell`` and
``find_wall``, ``hyperion_tpu/transport/gtable_octree.py:42-107``, whose
descend is an XLA ``fori_loop`` of ``max_depth`` steps over the whole
batch).

:class:`OctreeLocate` holds one tree's node records
(:attr:`~.gtable_octree.OctreeGeometry.node_records`). On CUDA tensors its
two calls launch the hand-written kernel in ``csrc/octree_locate.cu``, one
thread a lane; on CPU tensors they run the plain PyTorch version
:func:`find_cell_reference` / :func:`find_wall_reference`. Nothing falls
back from one to the other.

- ``find_cell(x, y, z, kx, ky, kz)``: ESCAPED outside the root's box, else
  the descend from the root by the side rule of
  :func:`~.gtable_octree.upper`; int64 leaf ids.
- ``find_wall(cell, x, y, z, kx, ky, kz)``: (t, next_cell, axis,
  wall_coord), the exit from the leaf's box, the leaf that holds the landing
  point snapped onto the crossed wall (ESCAPED outside the grid), the
  crossing axis (int64 0/1/2) and the wall coordinate.

On the card the lanes are in the tables' type (float32 in the steps,
float64 for the plain walk's tables), and both calls return what the plain
versions return, bit for bit."""

import ctypes

import torch

from . import _build
from .gtable import ESCAPED

# kernel launches since the last reset; chip_smoke.py reads it to show that
# the main path ran the kernel
launches = 0


def find_cell_reference(geo, x, y, z, kx, ky, kz):
    """The leaf of each point (ESCAPED outside the root box); a point on
    a wall belongs to the side its direction moves towards (ref
    adjust_wall)."""
    leaf = geo._descend(x, y, z, kx, ky, kz)
    return torch.where(geo._inside(x, y, z, kx, ky, kz), leaf,
                       torch.full_like(leaf, ESCAPED))


def find_wall_reference(geo, cell, x, y, z, kx, ky, kz):
    """The exit from the leaf's box and the leaf beyond it (ref
    find_wall, grid_geometry_octree.f90:438-539).

    Returns (t, next_cell, axis, wall_coord): the distance, the leaf
    that holds the exit point snapped onto the crossed wall (found from
    the root by :func:`find_cell_reference`, ESCAPED outside the grid), the
    crossing axis (0/1/2) and the wall coordinate to snap onto."""
    big = torch.finfo(x.dtype).max / 8
    lo = geo.lo[cell]
    hi = geo.hi[cell]

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
    xe, ye, ze = geo.snap(x + t * kx, y + t * ky, z + t * kz, ax,
                          wall_coord, torch.ones_like(cell, dtype=bool))
    next_cell = find_cell_reference(geo, xe, ye, ze, kx, ky, kz)
    return t, next_cell, ax, wall_coord


def _lane_error(name, t, what):
    return ValueError(
        "octree_locate: %s must be %s; got %s %s on %s (contiguous=%s)"
        % (name, what, t.dtype, tuple(t.shape), t.device, t.is_contiguous()))


class OctreeLocate:
    """One octree's locate: ``find_cell`` and ``find_wall`` on lanes of
    positions and directions in the tables' type, float32 or float64.

    On CUDA the node records are checked and kept and the library loaded: a
    call checks its lanes, allocates its outputs and launches once on the
    current stream without synchronising (so it captures in a CUDA graph
    and in a conditional node's body). On CPU tensors the plain version
    runs."""

    def __init__(self, geo):
        self.geo = geo
        self.device = geo.centers.device
        self.dtype = geo.centers.dtype
        self._cuda = self.device.type == 'cuda'
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError("octree_locate takes float32 or float64 tables, "
                             "not %s" % self.dtype)
        if not self._cuda:
            return
        rec = geo.node_records
        if rec.dtype != torch.float64 or rec.device != self.device or \
                rec.dim() != 2 or rec.shape[0] != geo.n_nodes or \
                not rec.is_contiguous():
            raise _lane_error('node_records', rec, 'a contiguous float64 '
                              '(%d, words) tensor on %s'
                              % (geo.n_nodes, self.device))
        self._records = rec
        self._device_index = self.device.index
        self._stream = torch._C._cuda_getCurrentRawStream
        with torch.cuda.device(self._device_index):
            self._fn = _kernel(rec.shape[1])

    def find_cell(self, x, y, z, kx, ky, kz):
        """The leaf of each point, int64 (ESCAPED outside the root box)."""
        if x.device.type == 'cpu':
            return find_cell_reference(self.geo, x, y, z, kx, ky, kz)
        return self._launch(None, x, y, z, kx, ky, kz)

    def find_wall(self, cell, x, y, z, kx, ky, kz):
        """(t, next_cell, axis, wall_coord) of each lane's crossing out of
        the leaf ``cell`` (B,) int64."""
        if x.device.type == 'cpu':
            return find_wall_reference(self.geo, cell, x, y, z, kx, ky, kz)
        return self._launch(cell, x, y, z, kx, ky, kz)

    def _launch(self, cell, *lanes):
        """One launch: next_cell, and for find_wall (t, next_cell, axis,
        wall_coord)."""
        global launches
        if not self._cuda:
            raise ValueError("octree_locate: the tables lie on %s, the lanes "
                             "on %s" % (self.device, lanes[0].device))
        B = lanes[0].shape[0]
        for name, t in zip(('x', 'y', 'z', 'kx', 'ky', 'kz'), lanes):
            if t.dtype != self.dtype or t.get_device() != \
                    self._device_index or t.shape != (B,) or \
                    not t.is_contiguous():
                raise _lane_error(name, t, 'a contiguous %s (%d,) tensor on '
                                  '%s, the tables\' type'
                                  % (self.dtype, B, self.device))
        if cell is not None and (
                cell.dtype != torch.int64 or cell.shape != (B,) or
                cell.get_device() != self._device_index or
                not cell.is_contiguous()):
            raise _lane_error('cell', cell, 'a contiguous int64 (%d,) tensor '
                              'on %s' % (B, self.device))
        if B >= 2 ** 31:
            raise ValueError("octree_locate: %d lanes is too many for one "
                             "call" % B)
        dtype, dev = self.dtype, self.device
        nxt = torch.empty(B, dtype=torch.int64, device=dev)
        t = ax = wall = None
        if cell is not None:
            t = torch.empty(B, dtype=dtype, device=dev)
            ax = torch.empty(B, dtype=torch.int64, device=dev)
            wall = torch.empty(B, dtype=dtype, device=dev)
        if B:
            err = self._fn(int(dtype == torch.float64),
                           self._records.data_ptr(), self.geo.n_nodes,
                           self.geo.max_depth,
                           *(a.data_ptr() for a in lanes),
                           *(0 if a is None else a.data_ptr()
                             for a in (cell, nxt, t, ax, wall)),
                           B, self._stream(self._device_index))
            if err != 0:
                raise RuntimeError("octree_locate kernel launch failed: "
                                   "cudaError %d" % err)
            launches += 1
        return nxt if cell is None else (t, nxt, ax, wall)


def _kernel(record_words):
    lib = _build.load('octree_locate')
    if lib.octree_locate_record_words() != record_words:
        raise RuntimeError("octree_locate: the library's records have %d "
                           "words, the tables' %d"
                           % (lib.octree_locate_record_words(), record_words))
    fn = lib.octree_locate
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int] + [ctypes.c_void_p] * 11 +
                       [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
