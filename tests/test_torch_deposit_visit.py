"""deposit_visit of the port against the JAX package's semantics.

On the CPU the wrapper runs the plain PyTorch version. It must equal, over
multi-step sequences with carried tables, the JAX Pallas kernel in interpret
mode (as tests/test_pallas_ops.py runs it), ``engine.visit_update`` on its
compare-sum path, and the numpy model of tests/test_pallas_ops.py. The
sequences hold the 5 -> 3 -> 5 overwrite case, heavy collisions in one
cell and drop-slot lanes. Counts and uids must be equal, and float32
energies match to rtol 1e-5 (the sums run in another order). The drop slot
``last_uid[n_cells]`` is never read for counting; the port leaves it
untouched, so uids are compared over the n_cells real slots."""

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


def _steps(n_dust, n_cells, n_steps=5, seed=31):
    """Per step (cell_dep, dep_rows, enter, uid) as numpy arrays. Lane 0
    enters cell HOT with uids 5, 3, 5 in steps 0-2 and nothing else enters
    it then; about 30% of the lanes share one busy cell (a refill), a third
    sit in the drop slot, uids repeat across steps, and a fifth of the
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
        dep = rng.random((n_dust, B)).astype(np.float32)
        dep[:, rng.random(B) < 0.2] = 0.0
        out.append((cell_dep.astype(np.int32), dep, enter.astype(np.int32),
                    uid.astype(np.int32)))
    return out


@pytest.mark.parametrize('n_dust', [1, 2])
@pytest.mark.parametrize('n_cells', [96, 1000])
def test_plain_version_matches_jax_multi_step(n_dust, n_cells):
    NP = pad_cells_for_visit(n_cells)
    # JAX Pallas kernel (interpret mode), padded last-uid layout
    j_es = jnp.zeros((n_dust, n_cells), jnp.float32)
    j_npc = jnp.zeros((n_cells,), jnp.int32)
    j_luid = jnp.full((NP,), -2, jnp.int32)
    # JAX compare-sum visit path, (n_cells + 1,) layout
    m_luid = jnp.full((n_cells + 1,), -2, jnp.int32)
    m_npc = jnp.zeros((n_cells,), jnp.int64)
    # numpy model
    r_es = np.zeros((n_dust, n_cells))
    r_npc = np.zeros(n_cells, np.int64)
    r_luid = np.full(n_cells + 1, -2, np.int64)
    # the port, through its wrapper (CPU tensors: the plain version), from
    # the JAX kernel's padded initial table
    es = torch.zeros((n_dust, n_cells), dtype=torch.float32)
    npc = torch.zeros(n_cells, dtype=torch.int64)
    luid = visit_state_from_numpy(np.asarray(j_luid), n_cells)
    assert luid.shape == (n_cells + 1,) and luid.dtype == torch.int32
    win = dv.new_visit_scratch(n_cells, torch.device('cpu'))
    launches = dv.launches

    for cell_dep, dep, enter, uid in _steps(n_dust, n_cells):
        j_es, j_npc, j_luid = j_kernel(
            j_es, j_npc, j_luid, jnp.asarray(cell_dep), jnp.asarray(dep),
            jnp.asarray(enter), jnp.asarray(uid), interpret=True)
        m_luid, m_npc = visit_update(m_luid, m_npc, jnp.asarray(enter),
                                     jnp.asarray(uid), use_matmul=True)
        r_es, r_npc, r_luid = _reference(r_es, r_npc, r_luid, cell_dep, dep,
                                         enter, uid)
        dv.deposit_visit(es, npc, luid, win, torch.as_tensor(cell_dep),
                         torch.as_tensor(dep), torch.as_tensor(enter),
                         torch.as_tensor(uid))

        for ref_npc in (j_npc, m_npc, r_npc):
            np.testing.assert_array_equal(npc.numpy(), np.asarray(ref_npc))
        for ref_luid in (j_luid, m_luid, r_luid):
            np.testing.assert_array_equal(luid[:n_cells].numpy(),
                                          np.asarray(ref_luid)[:n_cells])
        for ref_es in (j_es, r_es):
            np.testing.assert_allclose(es.numpy(), np.asarray(ref_es),
                                       rtol=1e-5)

    # the overwrite trap: 5, 3, 5 counts three times and ends at 5
    assert luid[HOT] == np.asarray(j_luid)[HOT]
    hot_uids = [s[3][s[2] == HOT] for s in _steps(n_dust, n_cells)[:3]]
    assert [list(u) for u in hot_uids] == [[5], [3], [5]]
    assert dv.launches == launches          # no kernel ran on the CPU
    assert luid[n_cells] == -2              # the drop slot is never written
    assert int(win.min()) == int(win.max()) == dv.INT_MIN


def test_overwrite_not_running_max():
    """uids 5, 3, 5 into one cell in three calls: count 3, last uid 5 (a
    running maximum would keep 5 after the second call and count 2)."""
    es = torch.zeros((1, 4))
    npc = torch.zeros(4, dtype=torch.int64)
    luid = torch.full((5,), -2, dtype=torch.int32)
    win = dv.new_visit_scratch(4, torch.device('cpu'))
    cell = torch.tensor([2], dtype=torch.int32)
    seen = []
    for u in (5, 3, 5):
        dv.deposit_visit(es, npc, luid, win, cell, torch.ones((1, 1)), cell,
                         torch.tensor([u], dtype=torch.int32))
        seen.append((int(npc[2]), int(luid[2])))
    assert seen == [(1, 5), (2, 3), (3, 5)]
    assert float(es[0, 2]) == 3.0


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


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    n_dust, n_cells = 2, 1000
    es = torch.zeros((n_dust, n_cells), device=cuda_device)
    npc = torch.zeros(n_cells, dtype=torch.int64, device=cuda_device)
    luid = torch.full((n_cells + 1,), -2, dtype=torch.int32,
                      device=cuda_device)
    win = dv.new_visit_scratch(n_cells, cuda_device)
    r_es, r_npc, r_luid = es.double(), npc.clone(), luid.clone()
    launches = dv.launches
    for cell_dep, dep, enter, uid in _steps(n_dust, n_cells):
        t = [torch.as_tensor(a, device=cuda_device)
             for a in (cell_dep, dep, enter, uid)]
        dv.deposit_visit(es, npc, luid, win, *t)
        dv.deposit_visit_reference(r_es, r_npc, r_luid, t[0], t[1].double(),
                                   t[2], t[3])
    torch.cuda.synchronize()
    assert dv.launches == launches + 5
    assert torch.equal(npc, r_npc)
    assert torch.equal(luid, r_luid)
    torch.testing.assert_close(es.double(), r_es, rtol=1e-5, atol=0)
