"""The port's JAX-free host modules held to the JAX package's copies on the
same seeded inputs: the native C++ library (``hyperion_tpu_torch.native``),
the SPH -> octree importer and the Orion/BoxLib plotfile importer.

- The port's library is built with g++ into ``hyperion_tpu_torch/_build/``
  (never beside its source) and its ``discretize_sph``,
  ``integrate_loglog_native`` and ``interp_loglog_native`` equal the JAX
  package's native functions to the bit (the cases of
  tests/test_native.py:14-60); its numpy fallback is within rtol 1e-10
  (atol 1e-13) of the library.
- ``construct_octree`` gives the JAX importer's ``refined`` array exactly
  and its density within rtol 1e-12, with the exact and the Monte-Carlo
  discretization (the same seed), on a 4,000-particle cloud.
- ``parse_orion`` reads tests/test_orion_importer.py's fixture plotfile
  into the JAX importer's levels, fabs, quantities (equal) and stars; the
  imported grid runs through the port's run_lucy_model."""

import numpy as np
import pytest
import torch

from hyperion_tpu_torch import native
from hyperion_tpu_torch.importers import (OrionStar, construct_octree,
                                          parse_orion)
from test_orion_importer import plotfile  # noqa: F401
from test_torch_octree import cloud

torch.set_num_threads(1)


def _jax_native():
    from hyperion_tpu import native as j_native
    assert j_native.available()
    return j_native


def test_native_builds_into_the_build_directory():
    """The library is built at first use under a name that carries the
    hash of its source and flags, in hyperion_tpu_torch/_build/, and
    nothing is written beside the source."""
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == '_build'
    assert path.parent.parent.name == 'hyperion_tpu_torch'
    assert sorted(p.name for p in native.SRC.parent.iterdir()
                  if not p.name.startswith('__pycache__')) == \
        ['__init__.py', 'native.cpp']


def _discretize_case():
    rng = np.random.default_rng(3)
    n_cells, n_part = 60, 300
    lo = rng.uniform(-1, 0.8, (n_cells, 3))
    hi = lo + rng.uniform(0.05, 0.3, (n_cells, 3))
    mu = rng.uniform(-1, 1, (n_part, 3))
    sigma = rng.uniform(0.02, 0.2, n_part)
    mass = rng.uniform(0.5, 2.0, n_part)
    return (lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1], lo[:, 2], hi[:, 2],
            mu[:, 0], mu[:, 1], mu[:, 2], sigma, mass)


@pytest.mark.parametrize('cull', [5.0, 50.0])
def test_native_discretize_equals_jax(cull):
    args = _discretize_case()
    np.testing.assert_array_equal(
        native.discretize_sph(*args, cull=cull),
        _jax_native().discretize_sph(*args, cull=cull))


def test_native_integrate_and_interp_equal_jax():
    j_native = _jax_native()
    rng = np.random.default_rng(1)
    x = np.logspace(0, 5, 200)
    y = np.abs(rng.lognormal(0, 1, 200))
    y[40:50] = 0.0  # zero segments contribute nothing
    assert native.integrate_loglog_native(x, y) == \
        j_native.integrate_loglog_native(x, y)
    rng = np.random.default_rng(2)
    xt = np.logspace(0, 4, 50)
    yt = np.abs(rng.lognormal(0, 1, 50))
    q = np.sort(rng.uniform(0.5, 2e4, 1000))
    np.testing.assert_array_equal(native.interp_loglog_native(xt, yt, q),
                                  j_native.interp_loglog_native(xt, yt, q))


def test_native_fallback_matches_library(monkeypatch):
    """Without the library: discretize_sph's numpy path within rtol 1e-10
    of the library (which the JAX package's own test holds to its numpy
    path), and the other two return None, as in the JAX package."""
    args = _discretize_case()
    lib = native.discretize_sph(*args, cull=50.0)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_tried', True)
    assert not native.available()
    np.testing.assert_allclose(native.discretize_sph(*args), lib,
                               rtol=1e-10, atol=1e-13)
    x = np.logspace(0, 1, 5)
    assert native.integrate_loglog_native(x, x) is None
    assert native.interp_loglog_native(x, x, x) is None


@pytest.mark.parametrize('method', ['exact', 'mc'])
def test_construct_octree_equals_jax(method):
    from hyperion_tpu.importers import construct_octree as j_construct
    p = cloud(4000, 21)
    sigma = np.full(p.shape[1], 0.02)
    mass = np.random.default_rng(22).uniform(0.5, 1.5, p.shape[1])
    kw = dict(n_ref=32, method=method, mc_samples=8, seed=99)
    grids = [build(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, *p, sigma, mass, **kw)
             for build in (construct_octree, j_construct)]
    refined = [np.asarray(g.refined) for g in grids]
    np.testing.assert_array_equal(refined[0], refined[1])
    assert refined[0].sum() > 50
    rho = [np.asarray(g['density'][0].array) for g in grids]
    np.testing.assert_allclose(rho[0], rho[1], rtol=1e-12, atol=0)
    assert (rho[0][~refined[0]] > 0).mean() > 0.5
    assert (rho[0][refined[0]] == 0).all()


@pytest.mark.parametrize('quantities,max_level', [
    ('density', None), (['density', 'temperature'], None), ('all', 1)])
def test_parse_orion_equals_jax(plotfile, quantities, max_level):  # noqa: F811
    from hyperion_tpu.importers.orion import parse_orion as j_parse
    d, _, _ = plotfile
    amr, stars = parse_orion(d, quantities=quantities, max_level=max_level)
    j_amr, j_stars = j_parse(d, quantities=quantities, max_level=max_level)
    assert len(amr.levels) == len(j_amr.levels)
    for level, j_level in zip(amr.levels, j_amr.levels):
        assert len(level.grids) == len(j_level.grids)
        for g, jg in zip(level.grids, j_level.grids):
            for a in ('xmin', 'xmax', 'ymin', 'ymax', 'zmin', 'zmax', 'nx',
                      'ny', 'nz'):
                assert getattr(g, a) == getattr(jg, a), a
            assert sorted(g.quantities) == sorted(jg.quantities)
            for q in g.quantities:
                np.testing.assert_array_equal(g.quantities[q],
                                              jg.quantities[q])
    assert [vars(s) for s in stars] == [vars(s) for s in j_stars]
    assert all(isinstance(s, OrionStar) for s in stars)


def test_parse_orion_refuses_what_the_jax_importer_refuses(plotfile):  # noqa: F811
    d, _, _ = plotfile
    with pytest.raises(ValueError, match='not in plotfile'):
        parse_orion(d, quantities='pressure')


def test_orion_grid_runs_through_the_port(plotfile):  # noqa: F811
    """The imported AMRGrid runs through the port's run_lucy_model on the
    CPU (tests/test_orion_importer.py's model run, without the file)."""
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.model import Model, run_lucy_model
    d, _, _ = plotfile
    amr, _ = parse_orion(d, quantities='density')
    nu = np.logspace(5, 18, 16)
    m = Model()
    m.set_amr_grid(amr)
    m.add_density_grid(amr['density'],
                       IsotropicDust(nu, np.repeat(0.4, 16),
                                     np.repeat(1.0, 16)))
    s = m.add_point_source()
    s.position = (0.5, 0.5, 0.5)
    s.luminosity = 1.0
    s.temperature = 5000.0
    m.set_n_photons(initial=500, imaging=0)
    m.set_n_initial_iterations(1)
    run = run_lucy_model(m, device='cpu', batch_size=256)
    assert run.result.energy_current == 500.0
    assert run.result.killed_geo == 0 and run.result.killed_int == 0
    assert run.result.specific_energy.shape == (1, 128 + 64 + 48)
