"""The port's Lucy iteration with the grid cut into slabs over the ranks
(hyperion_tpu_torch/parallel/spatial.py) against the JAX package's
run_lucy_iteration_spatial on a mesh of as many CPU devices, on
tests/test_parallel_spatial.py's three cases (plain, a cell count that
does not divide the world, MRW with re-absorption at a spherical source)
and __graft_entry__.dryrun_multichip's thick 8^3 MRW case, at world 2
(gloo ranks on the CPU; world 4 in tests/test_torch_parallel_spatial4.py,
which takes its checks from here); and rank_match_move against JAX's
_rank_match_move.

Both sides take the same tables (the JAX ones, through
convert.tables_from_numpy) and the same photon counts and batches; their
generators differ, so the deposits are held to the JAX tests' own bounds:
energy exact, nothing killed, every slab with deposits. The ranks import
this module, so JAX and hyperion_tpu are imported inside the tests only."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst

from hyperion_tpu_torch.convert import tables_from_numpy
from hyperion_tpu_torch.parallel import mesh
from hyperion_tpu_torch.parallel.launch import launch
from hyperion_tpu_torch.parallel.spatial import (rank_match_move,
                                                 run_lucy_iteration_spatial)
from hyperion_tpu_torch.transport.lucy import compute_jnu_var
from hyperion_tpu_torch.transport.mrw import prepare_mrw_tables

torch.set_num_threads(1)
CPU, F64 = torch.device('cpu'), torch.float64
# tests/test_parallel_spatial.py's configurations
CONFIG = (('n_inter_max', 100000), ('kill_on_scatter', False),
          ('kill_on_absorb', False), ('max_steps', 100000))
MRW_CONFIG = CONFIG + (('source_intersect', True), ('n_reabs_max', 50),
                       ('n_mrw_max', 100000))
# __graft_entry__.py's _CONFIG with the dryrun's additions
DRYRUN_CONFIG = (('n_inter_max', 1000), ('kill_on_scatter', False),
                 ('kill_on_absorb', False), ('max_steps', 5000),
                 ('n_reabs_max', 0), ('n_mrw_max', 100000))
# case: (JAX setup, photons, batch a rank, config, initial specific energy
# (None: zero), MRW gamma, JAX key; bounds: total, median of the per-cell
# ratio above the 60th percentile) as the JAX tests hold them; the MRW
# case at half their photons in four times their lanes, for the time (its
# diffusion tail sets the steps, ~1,650 at theirs)
CASES = {
    'plain': ('setup8', 20000, 512, CONFIG, None, None, 3, 0.02, 0.05),
    'padded': ('setup5', 5000, 512, CONFIG, None, None, 0, 0.05, None),
    'mrw_reabs': ('thick_shell', 10000, 2048, MRW_CONFIG, 1e-2, 2.0, 7,
                  0.03, 0.08),
}


def _numpy_fields(obj):
    items = obj._asdict().items() if hasattr(obj, '_asdict') else \
        ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return {k: np.asarray(v) for k, v in items}


def _jax_setup(name):
    """(grid, geometry, dt, st, density) of the JAX tests, float64."""
    import jax.numpy as jnp
    import test_parallel_spatial as J
    if name == 'thick_shell':
        return J._thick_shell_setup()
    if name.startswith('setup'):
        return J.setup(n=int(name[5:]))
    # __graft_entry__.dryrun_multichip's thick 8^3 grid, its toy dust and
    # source
    from __graft_entry__ import _toy_tables
    from hyperion_tpu.grid import CartesianGrid
    from hyperion_tpu.transport import build_cartesian_geometry
    _, dt, st, _, _, _ = _toy_tables(jnp.float64)
    grid = CartesianGrid(*[np.linspace(-1, 1, 9)] * 3)
    geometry = build_cartesian_geometry(grid, dtype=jnp.float64)
    return grid, geometry, dt, st, jnp.full((1, grid.n_cells), 4.0,
                                            dtype=jnp.float64)


def _port_case(name, n_photons, batch, config, se0, gamma):
    """The port's arguments for one case, from the JAX tables."""
    _, jg, jt, js, jrho = _jax_setup(name)
    dt, st, geometry = tables_from_numpy(_numpy_fields(jt), _numpy_fields(js),
                                         _numpy_fields(jg), CPU, F64)
    density = torch.tensor(np.asarray(jrho))
    se = torch.zeros_like(density) if se0 is None else \
        torch.full_like(density, se0)
    jid, jfrac = compute_jnu_var(dt, se)
    mrw = None if gamma is None else prepare_mrw_tables(dt, density, se,
                                                        gamma)
    return dict(tables=(geometry, dt, st, density, jid, jfrac),
                n_photons=n_photons, batch=batch, config=dict(config),
                mrw=mrw)


def run_cases(cases, seed):
    """Rank side: each case's slab-sharded iteration, as numpy."""
    group = mesh.active_group()
    out = []
    for c in cases:
        gen = torch.Generator().manual_seed(seed + group.rank)
        res = run_lucy_iteration_spatial(
            group, *c['tables'], gen, c['n_photons'], c['batch'],
            c['config'], mrw=c['mrw'])
        out.append([np.asarray(r) if torch.is_tensor(r) else r
                    for r in res])
    return out


_RUNS = {}


def port_runs(world):
    """{case: the port's outputs} at ``world`` ranks, from one launch."""
    if world not in _RUNS:
        names = list(CASES) + ['dryrun']
        cases = [_port_case(*CASES[n][:4], *CASES[n][4:6]) for n in
                 CASES] + [_port_case('dryrun', world * 256, 128,
                                      DRYRUN_CONFIG, 1e-2, 2.0)]
        group = mesh.Group(world=world, backend='gloo', device_type='cpu')
        out = launch(group, 'test_torch_parallel_spatial:run_cases',
                     (cases, 11))
        _RUNS[world] = dict(zip(names, out))
    return _RUNS[world]


def _slabs(energy_sum, world):
    """Each slab's total deposit (the padded cell axis cut as the ranks
    cut it)."""
    n_cells = energy_sum.shape[1]
    n_pad = n_cells + (-n_cells) % world
    e = np.zeros(n_pad)
    e[:n_cells] = energy_sum.sum(axis=0)
    return e.reshape(world, -1).sum(axis=1)


def check_spatial_against_jax(world, case):
    """One of the JAX tests' cases at ``world`` ranks against JAX's
    run_lucy_iteration_spatial on a mesh of ``world`` devices: energy
    exact, nothing killed, every slab with deposits, the deposits within
    the JAX tests' bounds."""
    import jax
    from hyperion_tpu.parallel import make_mesh
    from hyperion_tpu.parallel.spatial import run_lucy_iteration_spatial as j
    from hyperion_tpu.transport.lucy import compute_jnu_var as j_jnu
    from hyperion_tpu.transport.mrw import prepare_mrw_tables as j_mrw
    import jax.numpy as jnp

    setup, n_photons, batch, config, se0, gamma, key, total_tol, \
        median_tol = CASES[case]
    energy_sum, energy_current, npc, killed, n_steps, _ = \
        port_runs(world)[case]
    grid, jg, jt, js, jrho = _jax_setup(setup)
    assert energy_sum.shape == (1, grid.n_cells)
    assert npc.shape == (grid.n_cells,)
    assert energy_current == n_photons
    assert killed == 0 and n_steps > 0
    assert (_slabs(energy_sum, world) > 0).all()

    se = jnp.zeros_like(jrho) if se0 is None else jnp.full_like(jrho, se0)
    jid, jfrac = j_jnu(jt, se)
    mrw = None if gamma is None else j_mrw(jt, jrho, se, gamma, jnp.float64)
    ref = j(make_mesh(jax.devices()[:world]), jg, jt, js, jrho, jid, jfrac,
            jax.random.PRNGKey(key), n_photons, batch, config, mrw=mrw)
    es_ref = np.asarray(ref[0])
    assert float(ref[1]) == n_photons and int(ref[3]) == 0
    assert abs(energy_sum.sum() / es_ref.sum() - 1.0) < total_tol
    if median_tol is not None:
        sel = es_ref > np.percentile(es_ref, 60)
        ratio = energy_sum[sel] / es_ref[sel]
        assert abs(np.median(ratio) - 1.0) < median_tol


def check_dryrun_thick_mrw(world):
    """__graft_entry__.dryrun_multichip's sharded-grid check: the thick 8^3
    MRW workload, world * 256 photons at 128 lanes a rank, every photon
    emitted and every slab with deposits."""
    energy_sum, energy_current, _, _, _, _ = port_runs(world)['dryrun']
    assert energy_current == world * 256
    assert energy_sum.sum() > 0
    assert (_slabs(energy_sum, world) > 0).all()


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('world', [2])
def test_spatial_against_jax(world, case):
    check_spatial_against_jax(world, case)


@pytest.mark.parametrize('world', [2])
def test_dryrun_thick_mrw_every_slab(world):
    check_dryrun_thick_mrw(world)


@settings(max_examples=100, deadline=None)
@given(hst.lists(hst.tuples(hst.booleans(), hst.booleans()), min_size=64,
                 max_size=64))
def test_rank_match_move_equals_jax(masks):
    """Random masks of 64 lanes (one shape: JAX compiles once)."""
    import jax
    import jax.numpy as jnp
    from hyperion_tpu.parallel.spatial import _rank_match_move
    src = np.array([a for a, _ in masks])
    dst = np.array([b for _, b in masks])
    ok, idx = rank_match_move(torch.as_tensor(src), torch.as_tensor(dst))
    j_ok, j_idx = jax.jit(_rank_match_move)(jnp.asarray(src),
                                            jnp.asarray(dst))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
