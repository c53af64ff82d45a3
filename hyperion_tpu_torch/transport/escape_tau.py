"""The optical depth to the grid's edge along fixed rays (counterpart of
``hyperion_tpu/transport/imaging.py:escape_tau_walk``, an XLA while loop;
ref grid_escape_tau, src/grid/grid_propagate_3d.f90:377-480).

:class:`EscapeTau` holds one grid's walls and density. On CUDA tensors a
call launches the hand-written kernel in ``csrc/escape_tau.cu``, one thread
per lane walking its ray to the edge on the device; on CPU tensors it runs
the plain PyTorch version :func:`escape_tau_reference`. Nothing falls back
from one to the other.

For each active lane, from its cell: the wall ahead, tau += (Σ_d chi[i, d]
rho[d, cell]) × the segment (limited by the distance left when ``t_max``
is given: an inside observer), the move (snapped onto a crossed cartesian
wall), until the ray escapes, the distance is used up, or ``max_steps``
crossings. Lanes that are not active get 0.

The walk runs in float64 on the grid's float64 walls whatever the type of
the lanes: float32 lanes, chi rows and density (the engine's type on the
card) are widened, and tau rounded back once. A float32 walk's on-wall
exclusion (3e-6 of the radius) is wider than a YSO grid's innermost shells
(~1e-7 of the radius), and it lays segments in the wrong cells there (see
``csrc/escape_tau.cu``)."""

import ctypes

import torch

from . import _build
from .gtable import ESCAPED, CartesianGeometry
from .gtable_spherical import SphericalGeometry

# kernel launches since the last reset; chip_smoke.py reads it to show that
# the main path ran the kernel
launches = 0


def escape_tau_reference(geometry, rho_t, chi_rows, x, y, z, kx, ky, kz,
                         cell, active, max_steps=100000, t_max=None,
                         crossings=False):
    """The plain PyTorch walk, the JAX loop with the port's geometry (its
    float64 tables): ``rho_t`` (n_cells, n_dust), ``chi_rows`` (B, n_dust),
    ``cell`` (B,) int64, ``active`` (B,) bool, ``t_max`` (B,) or None.
    Float32 inputs are widened to float64 for the walk. Returns tau (B,) in
    the lanes' type, and with ``crossings`` also the (B,) int64 count of
    cells each lane walked through. Reads ``any(active)`` on the host once
    per crossing."""
    dtype = x.dtype
    rho_t, chi_rows, x, y, z, kx, ky, kz = (
        a.to(torch.float64) for a in (rho_t, chi_rows, x, y, z, kx, ky, kz))
    limited = t_max is not None
    if limited:
        t_max = t_max.to(torch.float64)
    tau = torch.zeros_like(x)
    n_cross = torch.zeros_like(cell)
    remaining = t_max if limited else None
    i = 0
    while i < max_steps and bool(active.any()):
        n_cross += active
        cell_safe = cell.clamp_min(0)
        t_wall, next_cell, ax, wall_coord = geometry.find_wall(
            cell_safe, x, y, z, kx, ky, kz)
        chi_rho = (chi_rows * rho_t[cell_safe]).sum(dim=-1)
        seg = t_wall
        if limited:
            seg = torch.minimum(t_wall, remaining)
            remaining = remaining - t_wall
        tau = tau + torch.where(active, chi_rho * seg, 0.0)
        x2, y2, z2 = geometry.snap(x + t_wall * kx, y + t_wall * ky,
                                   z + t_wall * kz, ax, wall_coord, active)
        x = torch.where(active, x2, x)
        y = torch.where(active, y2, y)
        z = torch.where(active, z2, z)
        cell = torch.where(active, next_cell, cell)
        active = active & (cell != ESCAPED)
        if limited:
            active = active & (remaining > 0.0)
        i += 1
    tau = tau.to(dtype)
    return (tau, n_cross) if crossings else tau


def _lane_error(name, t, dtype, shape, device):
    return ValueError(
        "escape_tau: %s must be a contiguous %s tensor of shape %s on %s; "
        "got %s %s on %s (contiguous=%s)"
        % (name, dtype, shape, device, t.dtype, tuple(t.shape), t.device,
           t.is_contiguous()))


class EscapeTau:
    """One grid's escape-tau walk: ``walk(chi_rows, x, y, z, kx, ky, kz,
    cell, active, t_max=None)`` returns tau (B,).

    ``geometry`` is a CartesianGeometry or SphericalGeometry of float64
    tables (``build_geometry_tables(grid, device, torch.float64)``) and
    ``rho_t`` the (n_cells, n_dust) density the step keeps, float32 or
    float64, on one device; the lanes take the density's type. On CUDA the
    tables are checked and their pointers cached here, once; a call checks
    its lane tensors, allocates tau and launches once on the current
    stream, without synchronising."""

    def __init__(self, geometry, rho_t, max_steps=100000):
        self.geometry, self.rho_t = geometry, rho_t
        self.max_steps = int(max_steps)
        self.device = rho_t.device
        self.dtype = rho_t.dtype
        self.n_dust = rho_t.shape[1]
        self._cuda = self.device.type == 'cuda'
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError("escape_tau takes float32 or float64, not %s"
                             % self.dtype)
        first_wall = geometry.rw if isinstance(geometry, SphericalGeometry) \
            else geometry.xw if isinstance(geometry, CartesianGeometry) \
            else None
        if first_wall is not None and first_wall.dtype != torch.float64:
            raise ValueError("escape_tau walks in float64: give it the grid's "
                             "float64 tables, not %s ones" % first_wall.dtype)
        if not self._cuda:
            if self.device.type != 'cpu':
                raise ValueError("escape_tau runs on CPU or CUDA tensors, "
                                 "not %s" % self.device)
            return
        if isinstance(geometry, SphericalGeometry):
            kind = 1
            walls = [geometry.rw, geometry.rw2, geometry.cos_tw,
                     -geometry.cos_tw, geometry.cos2_tw, geometry.sin_pw,
                     geometry.cos_pw, geometry.phi_w]
            theta_kind = geometry.theta_kind.to(torch.int64).contiguous()
            t_eps = float(geometry.t_eps)
        elif isinstance(geometry, CartesianGeometry):
            kind = 0
            walls = [geometry.xw, geometry.yw, geometry.zw]
            theta_kind, t_eps = None, 0.0
        else:
            raise NotImplementedError(
                "escape_tau walks cartesian and spherical-polar grids, not "
                "%s: ROADMAP.md queue 1 item 11" % type(geometry).__name__)
        walls = [w.contiguous() for w in walls]
        for w in walls:
            if w.device != self.device:
                raise ValueError("escape_tau: the grid's walls are on %s, the "
                                 "density on %s" % (w.device, self.device))
        if not rho_t.is_contiguous():
            raise ValueError("escape_tau: rho_t must be contiguous")
        # keep the tables alive while the kernel may read them
        self._tables = walls + [theta_kind]
        ptrs = [w.data_ptr() for w in walls] + [0] * (8 - len(walls))
        self._walls = (ctypes.c_void_p * 8)(*ptrs)
        self._args = (int(self.dtype == torch.float64), kind,
                      self._walls,
                      0 if theta_kind is None else theta_kind.data_ptr(),
                      t_eps, geometry.n1, geometry.n2, geometry.n3,
                      rho_t.data_ptr(), self.n_dust)
        self._fn = _kernel()
        self._stream = torch._C._cuda_getCurrentRawStream
        index = self.device.index
        self._index = torch.cuda.current_device() if index is None else index

    def __call__(self, chi_rows, x, y, z, kx, ky, kz, cell, active,
                 t_max=None):
        # the same checks on either device, so that the CPU tests hold the
        # callers to what the kernel takes
        B = x.shape[0]
        lanes = [x, y, z, kx, ky, kz] + ([] if t_max is None else [t_max])
        for name, t in zip(('x', 'y', 'z', 'kx', 'ky', 'kz', 't_max'), lanes):
            self._check(name, t, self.dtype, (B,))
        self._check('chi_rows', chi_rows, self.dtype, (B, self.n_dust))
        self._check('cell', cell, torch.int64, (B,))
        self._check('active', active, torch.bool, (B,))
        if not self._cuda:
            return escape_tau_reference(self.geometry, self.rho_t, chi_rows,
                                        x, y, z, kx, ky, kz, cell, active,
                                        self.max_steps, t_max)
        global launches
        tau = torch.empty(B, dtype=self.dtype, device=self.device)
        lane_ptrs = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in lanes[:6]])
        err = self._fn(*self._args, chi_rows.data_ptr(), lane_ptrs,
                       cell.data_ptr(), active.data_ptr(),
                       0 if t_max is None else t_max.data_ptr(),
                       self.max_steps, tau.data_ptr(), B,
                       self._stream(self._index))
        if err != 0:
            raise RuntimeError("escape_tau kernel launch failed: cudaError %d"
                               % err)
        launches += 1
        return tau

    def _check(self, name, t, dtype, shape):
        if self._cuda:
            wrong_device = t.device.type != 'cuda' or \
                t.device.index not in (None, self._index)
        else:
            wrong_device = t.device.type != 'cpu'
        if t.dtype != dtype or wrong_device or t.shape != shape or \
                not t.is_contiguous():
            raise _lane_error(name, t, dtype, shape, self.device)


def _kernel():
    fn = _build.load('escape_tau').escape_tau
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
