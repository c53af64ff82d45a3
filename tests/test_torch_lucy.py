"""The port's Lucy iterations: the analytic checks of
tests/test_engine_lucy.py, and one iteration against the JAX run_lucy on
the very same tables. The generators differ (Philox against threefry), so
whole runs agree only statistically: JAX against the port may differ per
cell by at most 1.5 times what two port runs with different seeds do."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperion_tpu.transport import (build_cartesian_geometry as j_geometry,
                                    build_dust_tables as j_dust,
                                    build_source_tables as j_sources,
                                    run_lucy as j_run_lucy)
from hyperion_tpu_torch.convert import tables_from_numpy
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.engine import run_lucy_iteration
from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
from hyperion_tpu_torch.transport.lucy import compute_jnu_var, run_lucy
from hyperion_tpu_torch.transport.stable import build_source_tables
from test_torch_frontend import frontend

torch.set_num_threads(1)
J, P = frontend('jax'), frontend('port')
CPU = torch.device('cpu')
F64 = torch.float64


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def setup_point_model(n=15, half=1.0, rho=1e-4, chi=1.0, albedo=0.0,
                      luminosity=1.0):
    """tests/test_engine_lucy.py:setup_point_model on the port."""
    grid = P.CartesianGrid(*[np.linspace(-half, half, n + 1)] * 3)
    nu = np.logspace(5, 18, 20)
    dust = P.IsotropicDust(nu, np.repeat(albedo, 20), np.repeat(chi, 20))
    geometry = build_cartesian_geometry(grid, CPU, F64)
    dt = build_dust_tables([dust], CPU, F64)
    st = build_source_tables([P.PointSource(luminosity=luminosity,
                                            temperature=5000.0)], CPU, F64,
                             length_scale=geometry.length_scale)
    density = torch.full((1, grid.n_cells), rho * geometry.length_scale,
                         dtype=F64)
    return grid, geometry, dt, st, density


def test_optically_thin_inverse_square():
    """E(r) = kappa L / (4 pi r^2) for optically thin dust around a point
    source, with the criteria of test_engine_lucy.py:37."""
    grid, geometry, dt, st, density = setup_point_model()
    res = run_lucy(geometry, dt, st, density, _gen(7), n_photons=200000,
                   n_iterations=1, batch_size=8192, verbose=False)
    se = res.specific_energy[0].reshape(grid.shape)
    r = np.sqrt(grid.gx ** 2 + grid.gy ** 2 + grid.gz ** 2)
    sel = (r > 0.35) & (r < 0.75)
    ratio = se[sel] / (1.0 / (4 * np.pi * r[sel] ** 2))
    assert res.killed_geo == 0
    assert abs(np.median(ratio) - 1.0) < 0.05
    assert np.std(ratio) < 0.25


def test_energy_current_counts_photons():
    grid, geometry, dt, st, density = setup_point_model(n=7)
    res = run_lucy(geometry, dt, st, density, _gen(0), n_photons=5000,
                   n_iterations=1, batch_size=2048, verbose=False)
    assert res.energy_current == 5000.0
    assert res.killed_int == 0
    assert res.killed_geo == 0


def test_n_photons_cell_unique_photon_dedup():
    """One photon counts each cell at most once, however often it re-enters
    (test_engine_lucy.py:114; ref grid_propagate_3d.f90:91-97)."""
    nu = np.logspace(5, 18, 16)
    dust = P.IsotropicDust(nu, np.repeat(0.999, 16), np.repeat(1.0, 16))
    grid = P.CartesianGrid(*[np.linspace(-1, 1, 5)] * 3)
    geometry = build_cartesian_geometry(grid, CPU, F64)
    dt = build_dust_tables([dust], CPU, F64)
    st = build_source_tables([P.PointSource(luminosity=1.0,
                                            temperature=5000.0)], CPU, F64)
    density = torch.full((1, grid.n_cells), 3.0, dtype=F64)
    jid, jfrac = compute_jnu_var(dt, torch.zeros_like(density))
    config = dict(n_inter_max=100000, kill_on_scatter=False,
                  kill_on_absorb=False, max_steps=100000)
    out = run_lucy_iteration(geometry, dt, st, density, jid, jfrac, _gen(7),
                             1, 64, config)
    npc = out[2].numpy()
    assert npc.sum() >= 3          # it traversed several cells...
    assert npc.max() <= 1          # ...but never recounted one


def test_photon_budget_guard():
    grid, geometry, dt, st, density = setup_point_model(n=3)
    with pytest.raises(ValueError, match='int32'):
        run_lucy(geometry, dt, st, density, _gen(0), n_photons=2 ** 31,
                 n_iterations=1, verbose=False)


@pytest.fixture(scope='module')
def jax_and_port_runs():
    """One iteration of a 9^3 point-source model, 20k photons, B = 2048:
    the JAX run_lucy and the port on the same tables (through
    convert.tables_from_numpy), the port twice with different seeds."""
    grid = J.CartesianGrid(*[np.linspace(-1, 1, 10)] * 3)
    dust = J.IsotropicDust(np.logspace(5, 18, 20), np.repeat(0.5, 20),
                           np.repeat(1.0, 20))
    jg = j_geometry(grid, dtype=jnp.float64)
    jt = j_dust([dust], dtype=jnp.float64)
    js = j_sources([J.PointSource(luminosity=1.0, temperature=5000.0,
                                  position=(0.05, -0.1, 0.02))],
                   dtype=jnp.float64, length_scale=jg.length_scale)
    rho = np.full((1, grid.n_cells), 0.3 * jg.length_scale)
    kw = dict(n_photons=20000, n_iterations=1, batch_size=2048,
              check_frequency=0.001, verbose=False)
    ref = j_run_lucy(jg, jt, js, jnp.asarray(rho), jax.random.PRNGKey(1),
                     **kw)

    def numpy_fields(obj):
        items = obj._asdict().items() if hasattr(obj, '_asdict') else \
            ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
        return {k: np.asarray(v) for k, v in items}

    pt, ps, pg = tables_from_numpy(numpy_fields(jt), numpy_fields(js),
                                   numpy_fields(jg), CPU, F64)
    port = [run_lucy(pg, pt, ps, torch.as_tensor(rho), _gen(seed), **kw)
            for seed in (1, 2)]
    return ref, port


def test_lucy_iteration_matches_jax(jax_and_port_runs):
    ref, (a, b) = jax_and_port_runs
    assert a.energy_current == ref.energy_current == 20000.0
    assert (a.killed_int, a.killed_geo) == (0, 0)
    assert (ref.killed_int, ref.killed_geo) == (0, 0)
    se_ref = ref.specific_energy.sum()
    assert abs(a.specific_energy.sum() / se_ref - 1.0) < 0.02

    def rms_rel(t1, t2):
        ok = (t1 > 0) & (t2 > 0)
        return np.sqrt(np.mean((t1[ok] / t2[ok] - 1.0) ** 2))

    noise = rms_rel(a.temperature, b.temperature)
    assert noise > 0
    assert rms_rel(a.temperature, ref.temperature) <= 1.5 * noise
    np.testing.assert_array_equal(a.n_photons_cell > 0,
                                  ref.n_photons_cell > 0)
