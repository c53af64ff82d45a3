"""Per-cell statistics of one transport step: energy deposits and
unique-photon visit counts (counterpart of the Pallas kernel
``hyperion_tpu/transport/pallas_ops.py::deposit_visit``).

:class:`DepositVisit` holds an iteration's tables. On CUDA tables a call
launches the hand-written kernel in ``csrc/deposit_visit.cu``; on CPU tables
it runs the plain PyTorch version :func:`deposit_visit_reference`. Nothing
falls back from one to the other. Both update the tables IN PLACE.

Semantics, for a call of B lanes (``enter == n_cells`` is the drop slot):

    energy_sum[d, cell_dep[i]] += dep[i, d]
    fresh[i] = last_uid[enter[i]] != uid[i]           (table before the call)
    n_photons_cell[enter[i]] += fresh[i]              (enter[i] < n_cells)
    last_uid[c] = max{uid[i] : enter[i] == c}         (cells entered this call)

The last-uid update overwrites: a cell entered by uids 5, 3, 5 in three
calls ends at 5 with a count of 3 (the JAX kernel and
``engine.visit_update`` agree). The drop slot ``last_uid[n_cells]`` is
never read for counting, and neither version writes it."""

import ctypes

import torch

from . import _build

INT_MIN = -2 ** 31

# kernel launches since the last reset; chip_smoke.py reads it to show that
# the main path ran the kernel
launches = 0


def deposit_visit_reference(energy_sum, n_photons_cell, last_uid, cell_dep,
                            dep, enter, uid):
    """The plain PyTorch version of the kernel, on any device. ``dep`` is
    (B, n_dust), or None for visits only (``cell_dep`` is then unused)."""
    n_cells = n_photons_cell.shape[0]
    if dep is not None and dep.shape[1]:
        energy_sum.index_add_(1, cell_dep, dep.T)
    uid = uid.to(last_uid.dtype)
    fresh = (last_uid[enter] != uid) & (enter < n_cells)
    n_photons_cell.index_add_(0, enter[fresh], torch.ones_like(
        enter[fresh], dtype=n_photons_cell.dtype))
    win = torch.full_like(last_uid, INT_MIN)
    win.scatter_reduce_(0, enter, uid, 'amax')
    head = win[:n_cells]
    last_uid[:n_cells] = torch.where(head != INT_MIN, head,
                                     last_uid[:n_cells])


def _lane_error(name, t, dtype, shape, device):
    return ValueError(
        "deposit_visit: %s must be a contiguous %s tensor of shape %s on %s; "
        "got %s %s on %s (contiguous=%s)"
        % (name, dtype, shape, device, t.dtype, tuple(t.shape), t.device,
           t.is_contiguous()))


class DepositVisit:
    """One iteration's deposit and visit tables, and the call that updates
    them: ``stats(cell_dep, dep, enter, uid)``.

    ``energy_sum`` (n_dust, n_cells) and ``n_photons_cell`` (n_cells,) int64
    start at 0, ``last_uid`` (n_cells + 1,) int32 at -2. On CUDA the tables
    are float32 energies, the kernel's three scratch tables and its turn
    (kept on the device, advanced by the kernel) are allocated here, and
    the tables' pointers are checked and cached once: a call checks only
    its lane tensors, launches once, allocates nothing and does not
    synchronise, so it can be captured in a CUDA graph, and a graph of any
    number of calls replays exactly. There ``last_uid`` lags one call
    behind until :meth:`flush`; the counts and energies are exact after
    every call."""

    def __init__(self, n_dust, n_cells, device, dtype):
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        self.n_dust, self.n_cells, self.device = n_dust, n_cells, device
        self.energy_sum = torch.zeros((n_dust, n_cells), dtype=dtype,
                                      device=device)
        self.n_photons_cell = torch.zeros(n_cells, dtype=torch.int64,
                                          device=device)
        self.last_uid = torch.full((n_cells + 1,), -2, dtype=torch.int32,
                                   device=device)
        self._cuda = device.type == 'cuda'
        if not self._cuda:
            if device.type != 'cpu':
                raise ValueError("deposit_visit runs on CPU or CUDA tensors, "
                                 "not %s" % device)
            return
        if dtype != torch.float32:
            raise ValueError("deposit_visit on CUDA takes float32 energies, "
                             "not %s" % dtype)
        self._win = torch.full((3, n_cells + 1), INT_MIN, dtype=torch.int32,
                               device=device)
        # the turn (which scratch table takes this call's maxima) and the
        # count of the launch's blocks that have read it
        self._state = torch.zeros(2, dtype=torch.int32, device=device)
        self._ptrs = (self.energy_sum.data_ptr(),
                      self.n_photons_cell.data_ptr(), self.last_uid.data_ptr(),
                      self._win.data_ptr(), self._state.data_ptr())
        self._fn = _kernel()
        # the current stream's raw handle as an int, without building a
        # torch.cuda.Stream object (a captured graph runs on a side stream)
        self._stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, cell_dep, dep, enter, uid):
        """Apply one call's deposits and visits. ``cell_dep``, ``enter``
        (B,) int64; ``dep`` (B, n_dust) or None for visits only (then
        ``cell_dep`` is unused); ``uid`` (B,) int32."""
        if not self._cuda:
            deposit_visit_reference(self.energy_sum, self.n_photons_cell,
                                    self.last_uid, cell_dep, dep, enter, uid)
            return
        B = enter.shape[0]
        self._check_lane('enter', enter, torch.int64, (B,))
        self._check_lane('uid', uid, torch.int32, (B,))
        if dep is None:
            n_dust, cell_dep = 0, enter
        else:
            n_dust = self.n_dust
            self._check_lane('cell_dep', cell_dep, torch.int64, (B,))
            self._check_lane('dep', dep, torch.float32, (B, n_dust))
        self._launch(cell_dep.data_ptr(), 0 if dep is None else
                     dep.data_ptr(), enter.data_ptr(), uid.data_ptr(),
                     n_dust, B)

    def flush(self):
        """Bring ``last_uid`` up to date (on CUDA, the kernel with no lanes
        commits the pending maxima); a no-op on the CPU."""
        if self._cuda:
            self._launch(0, 0, 0, 0, 0, 0)

    def _check_lane(self, name, t, dtype, shape):
        if t.dtype != dtype or t.device != self.device or \
                t.shape != shape or not t.is_contiguous():
            raise _lane_error(name, t, dtype, shape, self.device)

    def _launch(self, cell_dep, dep, enter, uid, n_dust, B):
        global launches
        err = self._fn(*self._ptrs, cell_dep, dep, enter, uid, n_dust,
                       self.n_cells, B, self._stream(self.device.index))
        if err != 0:
            raise RuntimeError("deposit_visit kernel launch failed: "
                               "cudaError %d" % err)
        launches += 1


def _kernel():
    fn = _build.load('deposit_visit').deposit_visit
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
