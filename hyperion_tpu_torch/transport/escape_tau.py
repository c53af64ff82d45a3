"""The optical depth to the grid's edge along fixed rays (counterpart of
``hyperion_tpu/transport/imaging.py:escape_tau_walk``, an XLA while loop;
ref grid_escape_tau, src/grid/grid_propagate_3d.f90:377-480).

:class:`EscapeTau` holds one grid's walls and density. A call walks the
lanes of one event along V directions at once (a peel event's lines of
sight): positions, cells, chi rows and the active mask are (B,), the
directions and the distance limits (V, B), tau comes out (V, B). On CUDA
tensors it launches the hand-written kernel in ``csrc/escape_tau.cu`` once,
whose threads fetch the live rays on the device; on CPU tensors it runs the
plain PyTorch version :func:`escape_tau_reference`. Nothing falls back from
one to the other.

For each ray of an active lane, from the lane's cell: the wall ahead, tau
+= (Σ_d chi[i, d] rho[d, cell]) × the segment (limited by the distance left
when ``t_max`` is given: an inside observer; +inf walks to the edge), the
move (snapped onto a crossed cartesian wall), until the ray escapes, the
distance is used up, or ``max_steps`` crossings. Rays of lanes that are
not active get 0.

:meth:`EscapeTau.columns` is the same walk's column mode, the counterpart
of ``hyperion_tpu/transport/raytrace.py:escape_column_walk`` (ref
grid_escape_column_density, grid_propagate_3d.f90:482-584): no chi rows,
and the per-dust column density Σ rho ds of each ray, (V, B, n_dust), which
raytracing attenuates a whole spectrum by. Its plain version is
:func:`escape_column_reference`. On the card the column mode shares its
rays out in small chunks, a spherical grid's deep lanes first
(:func:`column_split`).

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
from .gtable_cylindrical import CylindricalGeometry
from .gtable_spherical import SphericalGeometry

# kernel launches since the last reset, of the tau walk and of the column
# mode; chip_smoke.py reads them to show that the main path ran the kernel
launches = 0
column_launches = 0

# the kernel's argument block, int64 words in the order of csrc/escape_tau.cu's
# enum Arg: the grid's part (filled once, the plan by escape_tau_plan, the
# clock by EscapeTau.block_clock), then the lanes' part (filled at every call)
_ARGS = ('is_double', 'kind', 'w0', 'w1', 'w2', 'w3', 'w4', 'w5', 'w6', 'w7',
         'theta_kind', 'n1', 'n2', 'n3', 'rho', 'n_dust', 'smem',
         'walls_shared', 'rho_shared', 'smem_col', 'rho_shared_col',
         'big_col', 'max_blocks', 'max_blocks_col', 'counter', 'max_steps',
         'split', 'clock', 'chi', 'x', 'y', 'z', 'kx', 'ky', 'kz', 'cell',
         'active', 't_max', 'tau', 'acc', 'B', 'V')
_LANES = _ARGS.index('chi')
_CLOCK = _ARGS.index('clock')
# csrc/escape_tau.cu's kChiRegs: the column mode sums up to this many dusts
# in registers, more in a float64 scratch row
KCHI_REGS = 4
# csrc/escape_tau.cu's kCounterWords
COUNTER_WORDS = 3
# The column mode on a spherical grid hands out first the lanes whose rays
# cross at least this many radial walls to the edge (those starting in the
# inner n1 - DEEP_WALLS shells), so that the long walks start early: a
# walk's length follows its start's depth. Measured on class2's 96 shells
# (PERF.md, section 6): 24, against 12, 18, 30, 36, 48 and none.
DEEP_WALLS = 24


def column_split(geometry):
    """The radial index below which the column mode hands a lane out in
    its first sweep: spherical grids with more than DEEP_WALLS shells, else
    0 (one sweep, in lane order; cartesian and cylindrical grids)."""
    if isinstance(geometry, SphericalGeometry):
        return max(0, geometry.n1 - DEEP_WALLS)
    return 0


def _walk(geometry, rho_t, chi_rows, x, y, z, kx, ky, kz, cell, active,
          max_steps, t_max):
    """One view of the plain walk, on float64 tensors: (tau, crossings);
    with ``chi_rows`` None, (the per-dust columns (B, n_dust), crossings)."""
    limited = t_max is not None
    columns = chi_rows is None
    tau = torch.zeros((x.shape[0], rho_t.shape[1]) if columns else x.shape,
                      dtype=x.dtype, device=x.device)
    n_cross = torch.zeros_like(cell)
    remaining = t_max
    i = 0
    while i < max_steps and bool(active.any()):
        n_cross += active
        cell_safe = cell.clamp_min(0)
        t_wall, next_cell, ax, wall_coord = geometry.find_wall(
            cell_safe, x, y, z, kx, ky, kz)
        rho_rows = rho_t[cell_safe]
        seg = t_wall
        if limited:
            seg = torch.minimum(t_wall, remaining)
            remaining = remaining - t_wall
        if columns:
            tau = tau + torch.where(active[:, None], rho_rows * seg[:, None],
                                    0.0)
        else:
            chi_rho = (chi_rows * rho_rows).sum(dim=-1)
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
    return tau, n_cross


def _reference(geometry, rho_t, chi_rows, x, y, z, kx, ky, kz, cell,
               active, max_steps, t_max, crossings):
    """The plain walk of every view in turn, widened to float64 (tau, or
    the columns with ``chi_rows`` None)."""
    dtype, V, B = x.dtype, kx.shape[0], x.shape[0]
    rho_t, x, y, z, kx, ky, kz = (
        a.to(torch.float64) for a in (rho_t, x, y, z, kx, ky, kz))
    if chi_rows is not None:
        chi_rows = chi_rows.to(torch.float64)
    if t_max is not None:
        t_max = t_max.to(torch.float64)
    walks = [_walk(geometry, rho_t, chi_rows, x, y, z, kx[v], ky[v], kz[v],
                   cell, active, max_steps,
                   None if t_max is None else t_max[v]) for v in range(V)]
    if not walks:
        shape = (0, B) if chi_rows is not None else (0, B, rho_t.shape[1])
        out = torch.empty(shape, dtype=dtype, device=x.device)
        n_cross = torch.empty((0, B), dtype=torch.int64, device=x.device)
    else:
        out = torch.stack([w[0] for w in walks]).to(dtype)
        n_cross = torch.stack([w[1] for w in walks])
    return (out, n_cross) if crossings else out


def escape_tau_reference(geometry, rho_t, chi_rows, x, y, z, kx, ky, kz,
                         cell, active, max_steps=100000, t_max=None,
                         crossings=False):
    """The plain PyTorch walk, the JAX loop with the port's geometry (its
    float64 tables), one view after another: ``rho_t`` (n_cells, n_dust),
    ``chi_rows`` (B, n_dust), ``x``, ``y``, ``z``, ``cell`` (B,) int64,
    ``active`` (B,) bool, ``kx``, ``ky``, ``kz`` (V, B), ``t_max`` (V, B)
    or None. Float32 inputs are widened to float64 for the walk. Returns
    tau (V, B) in the lanes' type, and with ``crossings`` also the (V, B)
    int64 count of cells each ray walked through. Reads ``any(active)`` on
    the host once per crossing."""
    return _reference(geometry, rho_t, chi_rows, x, y, z, kx, ky, kz, cell,
                      active, max_steps, t_max, crossings)


def escape_column_reference(geometry, rho_t, x, y, z, kx, ky, kz, cell,
                            active, max_steps=100000, t_max=None,
                            crossings=False):
    """The plain PyTorch column walk, the JAX package's
    ``escape_column_walk`` (``hyperion_tpu/transport/raytrace.py:25``) with
    the port's geometry: the per-dust column density Σ rho[cell, d] × the
    segment along each ray, on the same crossings as
    :func:`escape_tau_reference` (whose arguments it takes, without chi
    rows). Returns (V, B, n_dust) in the lanes' type, and with
    ``crossings`` also the (V, B) int64 crossing counts."""
    return _reference(geometry, rho_t, None, x, y, z, kx, ky, kz, cell,
                      active, max_steps, t_max, crossings)


def _lane_error(name, t, dtype, shape, device):
    return ValueError(
        "escape_tau: %s must be a contiguous %s tensor of shape %s on %s; "
        "got %s %s on %s (contiguous=%s)"
        % (name, dtype, shape, device, t.dtype, tuple(t.shape), t.device,
           t.is_contiguous()))


class EscapeTau:
    """One grid's escape-tau walk: ``walk(chi_rows, x, y, z, kx, ky, kz,
    cell, active, t_max=None)`` returns tau (V, B) for directions and
    ``t_max`` of shape (V, B) (an unlimited view in a limited call takes
    +inf).

    ``geometry`` is a CartesianGeometry, SphericalGeometry or
    CylindricalGeometry of float64 tables (``build_geometry_tables(grid, device, torch.float64)``) and
    ``rho_t`` the (n_cells, n_dust) density the step keeps, float32 or
    float64, on one device; the lanes take the density's type. On CUDA the
    tables are checked, the kernel's plan made (shared memory, resident
    blocks) and its argument block filled here, once, beside a device
    counter that the kernel resets itself: a call checks each lane tensor
    once, allocates tau, fills the block's lane words and launches once on
    the current stream, without synchronising, so it can be captured in a
    CUDA graph. Calls of one object run in stream order (they share the
    counter)."""

    def __init__(self, geometry, rho_t, max_steps=100000):
        self.geometry, self.rho_t = geometry, rho_t
        self.max_steps = int(max_steps)
        self.device = rho_t.device
        self.dtype = rho_t.dtype
        self.n_dust = rho_t.shape[1]
        self._cuda = self.device.type == 'cuda'
        self._device_index = -1
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError("escape_tau takes float32 or float64, not %s"
                             % self.dtype)
        if self.max_steps < 1:
            raise ValueError("escape_tau: max_steps must be >= 1, not %d"
                             % self.max_steps)
        first_wall = geometry.rw if isinstance(geometry, SphericalGeometry) \
            else geometry.xw if isinstance(geometry, CartesianGeometry) \
            else geometry.ww if isinstance(geometry, CylindricalGeometry) \
            else None
        if first_wall is not None and first_wall.dtype != torch.float64:
            raise ValueError("escape_tau walks in float64: give it the grid's "
                             "float64 tables, not %s ones" % first_wall.dtype)
        if not self._cuda:
            if self.device.type != 'cpu':
                raise ValueError("escape_tau runs on CPU or CUDA tensors, "
                                 "not %s" % self.device)
            return
        index = self.device.index
        self._index = torch.cuda.current_device() if index is None else index
        self._device_index = self._index
        self._stream = torch._C._cuda_getCurrentRawStream
        with torch.cuda.device(self._index):
            self._bind(_build.load('escape_tau'))

    def _bind(self, lib):
        """Check the grid's tables, keep them alive, fill the grid's part of
        the argument block and make the kernel's plan with ``lib``."""
        geometry, rho_t = self.geometry, self.rho_t
        if isinstance(geometry, SphericalGeometry):
            kind = 1
            walls = [geometry.rw, geometry.rw2, geometry.cos_tw,
                     -geometry.cos_tw, geometry.cos2_tw, geometry.sin_pw,
                     geometry.cos_pw, geometry.phi_w]
            theta_kind = geometry.theta_kind.to(torch.int32).contiguous()
            t_eps, rw1 = float(geometry.t_eps), float(geometry.rw[1])
        elif isinstance(geometry, CylindricalGeometry):
            # (csrc/escape_tau.cu's wall_len: w[3] and w[4] unused; the
            # exclusion's second term, eps_floor, rides in rw1's place)
            kind = 2
            walls = [geometry.ww, geometry.ww2, geometry.zw, None, None,
                     geometry.sin_pw, geometry.cos_pw, geometry.phi_w]
            theta_kind = None
            t_eps, rw1 = float(geometry.t_eps), float(geometry.eps_floor)
        elif isinstance(geometry, CartesianGeometry):
            kind = 0
            walls = [geometry.xw, geometry.yw, geometry.zw]
            theta_kind, t_eps, rw1 = None, 0.0, 0.0
        else:
            raise NotImplementedError(
                "escape_tau walks cartesian, spherical-polar and "
                "cylindrical-polar grids, not %s: ROADMAP.md queue 1 item 11"
                % type(geometry).__name__)
        walls = [None if w is None else w.contiguous() for w in walls]
        walls += [None] * (8 - len(walls))
        for w in (w for w in walls if w is not None):
            if w.device != self.device:
                raise ValueError("escape_tau: the grid's walls are on %s, the "
                                 "density on %s" % (w.device, self.device))
        if not rho_t.is_contiguous():
            raise ValueError("escape_tau: rho_t must be contiguous")
        if geometry.n_cells * self.n_dust >= 2 ** 31:
            raise ValueError("escape_tau: the density must have fewer than "
                             "2^31 entries")
        # the device counter (csrc/escape_tau.cu's enum Counter)
        self._counter = torch.zeros(COUNTER_WORDS, dtype=torch.int32,
                                    device=self.device)
        # keep the tables alive while the kernel may read them
        self._tables = walls + [theta_kind]
        fn, fn_col = lib.escape_tau, lib.escape_column
        if fn.argtypes is None:
            lib.escape_tau_plan.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
            lib.escape_tau_plan.restype = ctypes.c_int
            for f in (fn, fn_col):
                f.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_double, ctypes.c_double,
                              ctypes.c_void_p]
                f.restype = ctypes.c_int
        for what, ours in (('n_args', len(_ARGS)),
                           ('counter_words', COUNTER_WORDS)):
            theirs = getattr(lib, 'escape_tau_' + what)()
            if theirs != ours:
                raise RuntimeError("escape_tau: the library's %s is %d, the "
                                   "wrapper's %d" % (what, theirs, ours))
        ptrs = [0 if w is None else w.data_ptr() for w in walls]
        grid = dict(is_double=int(self.dtype == torch.float64), kind=kind,
                    theta_kind=0 if theta_kind is None else
                    theta_kind.data_ptr(), n1=geometry.n1, n2=geometry.n2,
                    n3=geometry.n3, rho=rho_t.data_ptr(), n_dust=self.n_dust,
                    counter=self._counter.data_ptr(),
                    max_steps=self.max_steps, split=column_split(geometry),
                    **{'w%d' % k: p for k, p in enumerate(ptrs)})
        self._args = (ctypes.c_longlong * len(_ARGS))(
            *[grid.get(name, 0) for name in _ARGS])
        err = lib.escape_tau_plan(self._args)
        blocks = self.plan['resident_blocks']
        if err != 0 or min(blocks.values()) <= 0:
            raise RuntimeError("escape_tau: no plan for the kernel (cudaError "
                               "%d, resident blocks %s)" % (err, blocks))
        self._t_eps, self._rw1 = t_eps, rw1
        self._fn, self._fn_col = fn, fn_col
        self._block_clock = None

    @property
    def plan(self):
        """The kernel's plan (CUDA only): shared-memory bytes of a block and
        what lives there, for the tau walk and for the column mode
        (``big_col``: its blocks of kBigBlock threads with the density past
        48 KB), and the resident blocks of each mode's kernel."""
        a = {k: int(self._args[_ARGS.index(k)]) for k in _ARGS[:_LANES]}
        return dict(
            smem=a['smem'], walls_shared=bool(a['walls_shared']),
            rho_shared=bool(a['rho_shared']), smem_col=a['smem_col'],
            rho_shared_col=bool(a['rho_shared_col']),
            big_col=bool(a['big_col']), split=a['split'],
            resident_blocks={k: a[k] for k in ('max_blocks',
                                               'max_blocks_col')})

    def clock_words(self):
        """The int64 words that ``block_clock`` needs: [start, end] of each
        resident block of either mode's kernel."""
        blocks = self.plan['resident_blocks']
        return 2 * max(blocks.values())

    @property
    def block_clock(self):
        """None, or an int64 tensor of at least ``clock_words()`` words on
        the card into which each block of the next calls writes its [start,
        end] (``%globaltimer``, ns; a block's words are left as they were
        where fewer blocks run). Set once: the calls read nothing of it."""
        return self._block_clock

    @block_clock.setter
    def block_clock(self, clock):
        if not self._cuda:
            raise ValueError("escape_tau: block_clock times the kernel's "
                             "blocks, on the card only")
        if clock is not None and (
                clock.dtype != torch.int64 or not clock.is_contiguous() or
                clock.numel() < self.clock_words() or
                clock.get_device() != self._device_index):
            raise ValueError("escape_tau: block_clock must be a contiguous "
                             "int64 tensor of %d words on %s"
                             % (self.clock_words(), self.device))
        self._block_clock = clock
        self._args[_CLOCK] = 0 if clock is None else clock.data_ptr()

    def __call__(self, chi_rows, x, y, z, kx, ky, kz, cell, active,
                 t_max=None):
        V, B = self._check_lanes(x, y, z, kx, ky, kz, cell, active, t_max)
        self._check('chi_rows', chi_rows, self.dtype, (B, self.n_dust))
        if not self._cuda:
            return escape_tau_reference(self.geometry, self.rho_t, chi_rows,
                                        x, y, z, kx, ky, kz, cell, active,
                                        self.max_steps, t_max)
        global launches
        tau = torch.empty((V, B), dtype=self.dtype, device=self.device)
        if V * B == 0:
            return tau
        self._launch(self._fn, chi_rows.data_ptr(), x, y, z, kx, ky, kz,
                     cell, active, t_max, tau, 0)
        launches += 1
        return tau

    def columns(self, x, y, z, kx, ky, kz, cell, active, t_max=None):
        """The column mode: the per-dust column density Σ rho ds of each
        ray, (V, B, n_dust) in the lanes' type, on the crossings of the
        tau walk (the lanes as in a call, without chi rows). On CUDA one
        launch of the kernel's column mode on the current stream, sharing
        this object's tables, plan and counter; on the CPU
        :func:`escape_column_reference`."""
        V, B = self._check_lanes(x, y, z, kx, ky, kz, cell, active, t_max)
        if not self._cuda:
            return escape_column_reference(self.geometry, self.rho_t, x, y, z,
                                           kx, ky, kz, cell, active,
                                           self.max_steps, t_max)
        global column_launches
        col = torch.empty((V, B, self.n_dust), dtype=self.dtype,
                          device=self.device)
        if V * B == 0:
            return col
        # more dusts than the kernel keeps in registers: float64 sums in a
        # scratch row of each ray (the columns themselves in float64), held
        # until the launch is queued: freed before it, its memory could go
        # to another tensor first
        acc = None
        if self.n_dust > KCHI_REGS:
            acc = col if self.dtype == torch.float64 else torch.empty(
                (V, B, self.n_dust), dtype=torch.float64, device=self.device)
        self._launch(self._fn_col, 0, x, y, z, kx, ky, kz, cell, active,
                     t_max, col, 0 if acc is None else acc.data_ptr())
        column_launches += 1
        return col

    def _check_lanes(self, x, y, z, kx, ky, kz, cell, active, t_max):
        """The same checks on either device, so that the CPU tests hold the
        callers to what the kernel takes; returns (V, B)."""
        if kx.dim() != 2:
            raise _lane_error('kx', kx, self.dtype, '(V, B)', self.device)
        V, B = kx.shape
        if V * B * max(self.n_dust, 1) >= 2 ** 31 - 2 ** 20:
            raise ValueError("escape_tau: %d x %d rays is too many for one "
                             "call" % (V, B))
        for name, t, shape in (('x', x, (B,)), ('y', y, (B,)), ('z', z, (B,)),
                               ('kx', kx, (V, B)), ('ky', ky, (V, B)),
                               ('kz', kz, (V, B))):
            self._check(name, t, self.dtype, shape)
        if t_max is not None:
            self._check('t_max', t_max, self.dtype, (V, B))
        self._check('cell', cell, torch.int64, (B,))
        self._check('active', active, torch.bool, (B,))
        return V, B

    def _launch(self, fn, chi, x, y, z, kx, ky, kz, cell, active, t_max, out,
                acc):
        V, B = kx.shape
        self._args[_LANES:] = [
            chi, x.data_ptr(), y.data_ptr(), z.data_ptr(), kx.data_ptr(),
            ky.data_ptr(), kz.data_ptr(), cell.data_ptr(), active.data_ptr(),
            0 if t_max is None else t_max.data_ptr(), out.data_ptr(), acc, B,
            V]
        err = fn(self._args, self._t_eps, self._rw1,
                 self._stream(self._index))
        if err != 0:
            raise RuntimeError("escape_tau kernel launch failed: cudaError %d"
                               % err)

    def _check(self, name, t, dtype, shape):
        # get_device() is the card's index, or -1 on the CPU
        if t.dtype != dtype or t.get_device() != self._device_index or \
                t.shape != shape or not t.is_contiguous():
            raise _lane_error(name, t, dtype, shape, self.device)
