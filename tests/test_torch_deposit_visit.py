"""deposit_visit of the port against the JAX package's semantics.

On the CPU a DepositVisit runs the plain PyTorch version. It must equal,
over multi-step sequences with carried tables, the JAX Pallas kernel in
interpret mode (as tests/test_pallas_ops.py runs it), ``engine.visit_update``
on its compare-sum path, and the numpy model of tests/test_pallas_ops.py.
The port takes the step's own tensors (int64 cells, deposit rows (B,
n_dust)); the JAX functions take int32 cells and (n_dust, B) rows, so the
test converts at that boundary. The sequences hold the 5 -> 3 -> 5
overwrite case, heavy collisions in one cell, one hot cell that every lane
deposits into and enters, warps whose lanes form groups of 1, 2, 31 and 32
equal cells with repeated and tied uids, drop-slot lanes, and a refill's
visits-only calls (``dep`` None; the JAX functions get zero deposits
there) between step calls. Counts and
uids must be equal, and float32 energies match to rtol 1e-5 (the sums run
in another order). The drop slot ``last_uid[n_cells]`` is never read for
counting; the port leaves it untouched, so uids are compared over the
n_cells real slots. The kernel itself runs only on a card: the test marked
``cuda`` holds it to the plain version on the same sequences."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperion_tpu.transport.engine import visit_update
from hyperion_tpu.transport.pallas_ops import (deposit_visit as j_kernel,
                                               pad_cells_for_visit)
from hyperion_tpu_torch.convert import visit_state_from_numpy
from hyperion_tpu_torch.transport import _build
from hyperion_tpu_torch.transport import deposit_visit as dv
from test_pallas_ops import _reference

torch.set_num_threads(1)
B = 512
HOT = 7      # the cell of the 5 -> 3 -> 5 sequence
CPU = torch.device('cpu')


def _lanes(cell_dep, dep, enter, uid):
    return (cell_dep.astype(np.int64), dep.astype(np.float32),
            enter.astype(np.int64), uid.astype(np.int32))


def _steps(n_dust, n_cells, n_steps=5, seed=31):
    """Per step (cell_dep, dep (B, n_dust), enter, uid) as numpy arrays.
    Lane 0 enters cell HOT with uids 5, 3, 5 in steps 0-2 and nothing else
    enters it then; about 30% of the lanes share one busy cell (a refill), a
    third sit in the drop slot, uids repeat across steps, and a fifth of the
    deposits are masked to 0."""
    rng = np.random.default_rng(seed)
    busy = n_cells // 2
    out = []
    for s in range(n_steps):
        enter = rng.integers(0, n_cells, B)
        r = rng.random(B)
        enter[r < 0.3] = busy
        enter[(r >= 0.3) & (r < 0.6)] = n_cells
        uid = rng.integers(0, 300, B)
        if s < 3:
            enter[enter == HOT] = HOT + 1
            enter[0], uid[0] = HOT, (5, 3, 5)[s]
        cell_dep = rng.integers(0, n_cells, B)
        cell_dep[rng.random(B) < 0.3] = busy
        dep = rng.random((B, n_dust))
        dep[rng.random(B) < 0.2] = 0.0
        out.append(_lanes(cell_dep, dep, enter, uid))
    return out


def _hot_cell_steps(n_dust, n_cells, n_steps=4, seed=5):
    """Every lane deposits into and enters one cell; uids from a pool of
    40, so they tie within a step and repeat the cell's last uid."""
    rng = np.random.default_rng(seed)
    hot = n_cells - 1
    return [_lanes(np.full(B, hot), rng.random((B, n_dust)),
                   np.full(B, hot), rng.integers(0, 40, B))
            for _ in range(n_steps)]


def _warp_group_steps(n_dust, n_cells, n_steps=4, seed=6):
    """Warps of 32 lanes whose cells form groups of 1, 2, 31 and 32 equal
    lanes, contiguous and interleaved, with drop-slot lanes among them;
    uids from a small pool, so groups hold repeated and tied uids."""
    rng = np.random.default_rng(seed)
    lane = np.arange(32)
    patterns = [
        np.zeros(32, int),                   # one group of 32
        np.where(lane == 13, 1, 0),          # 31 and 1
        lane // 2,                           # 16 groups of 2
        lane,                                # 32 groups of 1
        lane % 2,                            # two interleaved groups of 16
        np.where(lane % 3 == 0, 0, 1 + lane),   # 11 of one cell, 21 singles
    ]
    out = []
    for s in range(n_steps):
        cells = []
        for w in range(B // 32):
            p = patterns[(w + s) % len(patterns)]
            base = rng.integers(0, n_cells - 40)
            cells.append(base + p)
        enter = np.concatenate(cells)
        cell_dep = np.roll(enter, 32 * (s + 1))
        enter[rng.random(B) < 0.1] = n_cells            # drop slot
        uid = rng.integers(0, 6, B)
        dep = rng.random((B, n_dust))
        dep[rng.random(B) < 0.2] = 0.0
        out.append(_lanes(cell_dep, dep, enter, uid))
    return out


def _refill_steps(n_dust, n_cells, n_steps=6, seed=41):
    """A refill's visits-only call (cell_dep and dep None) before each step
    call, as the engine makes them; the two draw their lanes alike."""
    calls = _steps(n_dust, n_cells, n_steps, seed)
    return [(None, None) + c[2:] if k % 2 == 0 else c
            for k, c in enumerate(calls)]


def _run_references(steps, n_dust, n_cells):
    """The JAX kernel (interpret mode), visit_update and the numpy model
    over the steps; yields their tables after each step."""
    NP = pad_cells_for_visit(n_cells)
    j_es = jnp.zeros((n_dust, n_cells), jnp.float32)
    j_npc = jnp.zeros((n_cells,), jnp.int32)
    j_luid = jnp.full((NP,), -2, jnp.int32)
    m_luid = jnp.full((n_cells + 1,), -2, jnp.int32)
    m_npc = jnp.zeros((n_cells,), jnp.int64)
    r_es = np.zeros((n_dust, n_cells))
    r_npc = np.zeros(n_cells, np.int64)
    r_luid = np.full(n_cells + 1, -2, np.int64)
    for cell_dep, dep, enter, uid in steps:
        # the JAX functions' layout: int32 cells, (n_dust, B) rows; a
        # visits-only call deposits zeros
        en32 = enter.astype(np.int32)
        if dep is None:
            cd32 = np.zeros_like(en32)
            dep_rows = np.zeros((n_dust, len(en32)), np.float32)
        else:
            cd32 = cell_dep.astype(np.int32)
            dep_rows = np.ascontiguousarray(dep.T)
        j_es, j_npc, j_luid = j_kernel(
            j_es, j_npc, j_luid, jnp.asarray(cd32), jnp.asarray(dep_rows),
            jnp.asarray(en32), jnp.asarray(uid), interpret=True)
        m_luid, m_npc = visit_update(m_luid, m_npc, jnp.asarray(en32),
                                     jnp.asarray(uid), use_matmul=True)
        r_es, r_npc, r_luid = _reference(r_es, r_npc, r_luid, cd32, dep_rows,
                                         en32, uid)
        yield (j_es, j_npc, j_luid), (m_npc, m_luid), (r_es, r_npc, r_luid)


def _check_plain_against_jax(steps, n_dust, n_cells):
    stats = dv.DepositVisit(n_dust, n_cells, CPU, torch.float32)
    # the port's table from the JAX kernel's padded initial table
    stats.last_uid.copy_(visit_state_from_numpy(
        np.full(pad_cells_for_visit(n_cells), -2, np.int32), n_cells))
    launches = dv.launches
    refs = _run_references(steps, n_dust, n_cells)
    for (cell_dep, dep, enter, uid), (j, m, r) in zip(steps, refs):
        stats(*(None if a is None else torch.as_tensor(a)
                for a in (cell_dep, dep, enter, uid)))
        for ref_npc in (j[1], m[0], r[1]):
            np.testing.assert_array_equal(stats.n_photons_cell.numpy(),
                                          np.asarray(ref_npc))
        for ref_luid in (j[2], m[1], r[2]):
            np.testing.assert_array_equal(stats.last_uid[:n_cells].numpy(),
                                          np.asarray(ref_luid)[:n_cells])
        for ref_es in (j[0], r[0]):
            np.testing.assert_allclose(stats.energy_sum.numpy(),
                                       np.asarray(ref_es), rtol=1e-5)
    assert dv.launches == launches          # no kernel ran on the CPU
    assert stats.last_uid[n_cells] == -2    # the drop slot is never written
    return stats


@pytest.mark.parametrize('n_dust', [1, 2])
@pytest.mark.parametrize('n_cells', [96, 1000])
def test_plain_version_matches_jax_multi_step(n_dust, n_cells):
    steps = _steps(n_dust, n_cells)
    _check_plain_against_jax(steps, n_dust, n_cells)
    # the overwrite trap: 5, 3, 5 counts three times and ends at 5
    hot_uids = [s[3][s[2] == HOT] for s in steps[:3]]
    assert [list(u) for u in hot_uids] == [[5], [3], [5]]
    stats = _check_plain_against_jax(steps[:3], n_dust, n_cells)
    assert (int(stats.n_photons_cell[HOT]), int(stats.last_uid[HOT])) == \
        (3, 5)


@pytest.mark.parametrize('n_dust', [1, 2])
@pytest.mark.parametrize('case', ['hot_cell', 'warp_groups', 'refills'])
def test_plain_version_matches_jax_contention(case, n_dust):
    make = {'hot_cell': _hot_cell_steps, 'warp_groups': _warp_group_steps,
            'refills': _refill_steps}
    stats = _check_plain_against_jax(make[case](n_dust, 300), n_dust, 300)
    assert int(stats.n_photons_cell.sum()) > 0


def test_overwrite_not_running_max():
    """uids 5, 3, 5 into one cell in three calls: count 3, last uid 5 (a
    running maximum would keep 5 after the second call and count 2)."""
    stats = dv.DepositVisit(1, 4, CPU, torch.float32)
    cell = torch.tensor([2])
    seen = []
    for u in (5, 3, 5):
        stats(cell, torch.ones((1, 1)), cell,
              torch.tensor([u], dtype=torch.int32))
        stats.flush()
        seen.append((int(stats.n_photons_cell[2]), int(stats.last_uid[2])))
    assert seen == [(1, 5), (2, 3), (3, 5)]
    assert float(stats.energy_sum[0, 2]) == 3.0


def test_visits_only_call_leaves_energies():
    """The refill's call: dep None counts visits and deposits nothing."""
    stats = dv.DepositVisit(2, 5, CPU, torch.float64)
    stats(None, None, torch.tensor([1, 1, 5, 3]),
          torch.tensor([4, 9, 2, 4], dtype=torch.int32))
    assert stats.n_photons_cell.tolist() == [0, 2, 0, 1, 0]
    assert stats.last_uid.tolist() == [-2, 9, -2, 4, -2, -2]
    assert not stats.energy_sum.any()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setattr(_build, 'library_path',
                        lambda name: tmp_path / 'missing.so')
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.build('deposit_visit')


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device('cuda')


def _assert_tables_equal(stats, r_es, r_npc, r_luid):
    stats.flush()
    torch.cuda.synchronize()
    assert torch.equal(stats.n_photons_cell, r_npc)
    assert torch.equal(stats.last_uid, r_luid)
    torch.testing.assert_close(stats.energy_sum.double(), r_es, rtol=1e-5,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['mixed', 'hot_cell', 'warp_groups',
                                  'refills'])
def test_kernel_matches_plain_version_on_card(case, cuda_device):
    """The kernel against the plain version in float64, call by call; then
    the same calls through CUDA graphs of one call each (one per call form)
    on static lane buffers, replayed once per call, as a graph of the step
    would be."""
    n_dust, n_cells = 2, 1000
    make = {'mixed': _steps, 'hot_cell': _hot_cell_steps,
            'warp_groups': _warp_group_steps, 'refills': _refill_steps}[case]
    steps = [[None if a is None else torch.as_tensor(a, device=cuda_device)
              for a in s] for s in make(n_dust, n_cells)]
    stats = dv.DepositVisit(n_dust, n_cells, cuda_device, torch.float32)
    plain = dv.DepositVisit(n_dust, n_cells, 'cpu', torch.float64)
    r_es, r_npc, r_luid = (t.to(cuda_device) for t in (
        plain.energy_sum, plain.n_photons_cell, plain.last_uid))
    launches = dv.launches
    for t in steps:
        stats(*t)
        dv.deposit_visit_reference(r_es, r_npc, r_luid, t[0],
                                   None if t[1] is None else t[1].double(),
                                   t[2], t[3])
        torch.cuda.synchronize()
        assert torch.equal(stats.n_photons_cell, r_npc)
    assert dv.launches == launches + len(steps)
    _assert_tables_equal(stats, r_es, r_npc, r_luid)
    if case == 'mixed':
        assert int(stats.last_uid[HOT]) == 5

    # one graph per call form, each of one call: the kernel keeps its turn
    # on the device, so replays of any count are exact
    graph_stats = dv.DepositVisit(n_dust, n_cells, cuda_device,
                                  torch.float32)
    full = next(t for t in steps if t[1] is not None)
    static = [torch.empty_like(a) for a in full]
    graphs = {}
    for form, args in (('deposits', static),
                       ('visits', [None, None] + static[2:])):
        graphs[form] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[form]):
            graph_stats(*args)
    for t in steps:
        for buf, a in zip(static, t):
            if a is not None:
                buf.copy_(a)
        graphs['visits' if t[1] is None else 'deposits'].replay()
    _assert_tables_equal(graph_stats, r_es, r_npc, r_luid)
