"""Per-cell statistics of one transport step: energy deposits and
unique-photon visit counts (counterpart of the Pallas kernel
``hyperion_tpu/transport/pallas_ops.py::deposit_visit``).

On a CUDA tensor :func:`deposit_visit` launches the hand-written kernel in
``csrc/deposit_visit.cu``; on a CPU tensor it runs the plain PyTorch
version :func:`deposit_visit_reference`. Nothing falls back from one to the
other. Both update their tables IN PLACE.

Semantics, for a step of B lanes (``enter == n_cells`` is the drop slot):

    energy_sum[d, cell_dep[i]] += dep_rows[d, i]
    fresh[i] = last_uid[enter[i]] != uid[i]           (table before the step)
    n_photons_cell[enter[i]] += fresh[i]              (enter[i] < n_cells)
    last_uid[c] = max{uid[i] : enter[i] == c}         (cells entered this step)

The last-uid update overwrites: a cell entered by uids 5, 3, 5 in three
steps ends at 5 with a count of 3 (the JAX kernel and
``engine.visit_update`` agree). The drop slot ``last_uid[n_cells]`` is
never read for counting, and neither version writes it."""

import ctypes

import torch

from . import _build

INT_MIN = -2 ** 31

# kernel calls since the last reset; chip_smoke.py reads it to show that the
# main path ran the kernel
launches = 0


def new_visit_scratch(n_cells, device):
    """The kernel's scratch table of per-cell step maxima, held at INT_MIN
    between calls; allocate one per iteration."""
    return torch.full((n_cells + 1,), INT_MIN, dtype=torch.int32,
                      device=device)


def deposit_visit_reference(energy_sum, n_photons_cell, last_uid, cell_dep,
                            dep_rows, enter, uid):
    """The plain PyTorch version of the kernel, on any device."""
    n_cells = n_photons_cell.shape[0]
    if dep_rows.shape[0]:
        energy_sum.index_add_(1, cell_dep.long(), dep_rows)
    enter = enter.long()
    uid = uid.to(last_uid.dtype)
    fresh = (last_uid[enter] != uid) & (enter < n_cells)
    n_photons_cell.index_add_(0, enter[fresh], torch.ones_like(
        enter[fresh], dtype=n_photons_cell.dtype))
    win = torch.full_like(last_uid, INT_MIN)
    win.scatter_reduce_(0, enter, uid, 'amax')
    head = win[:n_cells]
    last_uid[:n_cells] = torch.where(head != INT_MIN, head,
                                     last_uid[:n_cells])


def _check(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            "deposit_visit: %s must be a contiguous %s tensor of shape %s on "
            "%s; got %s %s on %s (contiguous=%s)"
            % (name, dtype, shape, device, t.dtype, tuple(t.shape), t.device,
               t.is_contiguous()))


def deposit_visit(energy_sum, n_photons_cell, last_uid, win, cell_dep,
                  dep_rows, enter, uid):
    """Apply one step's deposits and visit counts in place.

    ``energy_sum`` (n_dust, n_cells); ``n_photons_cell`` (n_cells,);
    ``last_uid`` and ``win`` (n_cells + 1,) int32, ``win`` from
    :func:`new_visit_scratch`; ``cell_dep``, ``enter``, ``uid`` (B,);
    ``dep_rows`` (n_dust, B), where n_dust may be 0 (visits only).
    On CUDA: float32 energies, int64 counts, int32 indices and uids."""
    global launches
    device = energy_sum.device
    if device.type == 'cpu':
        deposit_visit_reference(energy_sum, n_photons_cell, last_uid,
                                cell_dep, dep_rows, enter, uid)
        return
    if device.type != 'cuda':
        raise ValueError("deposit_visit runs on CPU or CUDA tensors, not %s"
                         % device)
    n_dust, n_cells = energy_sum.shape
    B = cell_dep.shape[0]
    _check(energy_sum, 'energy_sum', torch.float32, (n_dust, n_cells), device)
    _check(n_photons_cell, 'n_photons_cell', torch.int64, (n_cells,), device)
    _check(last_uid, 'last_uid', torch.int32, (n_cells + 1,), device)
    _check(win, 'win', torch.int32, (n_cells + 1,), device)
    _check(cell_dep, 'cell_dep', torch.int32, (B,), device)
    _check(dep_rows, 'dep_rows', torch.float32, (n_dust, B), device)
    _check(enter, 'enter', torch.int32, (B,), device)
    _check(uid, 'uid', torch.int32, (B,), device)
    fn = _kernel()
    err = fn(energy_sum.data_ptr(), n_photons_cell.data_ptr(),
             last_uid.data_ptr(), win.data_ptr(), cell_dep.data_ptr(),
             dep_rows.data_ptr(), enter.data_ptr(), uid.data_ptr(),
             n_dust, n_cells, B,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("deposit_visit kernel launch failed: cudaError %d"
                           % err)
    launches += 1


def _kernel():
    fn = _build.load('deposit_visit').deposit_visit
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
