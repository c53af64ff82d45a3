"""The port's host table builders against the JAX package's: the host code
is the same numpy, so every table the port builds from its own front end's
objects must equal the one the JAX package builds from the same objects of
its front end, exactly (JAX in x64, torch in float64)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperion_tpu.transport import (build_cartesian_geometry as j_geometry,
                                    build_dust_tables as j_dust,
                                    build_source_tables as j_sources)
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
from hyperion_tpu_torch.transport.stable import build_source_tables
from hyperion_tpu_torch.util.constants import au, lsun
from test_torch_frontend import frontend, lte_dust

torch.set_num_threads(1)
CPU = torch.device('cpu')
F64 = torch.float64


def _tutorial_dust(package):
    # examples/quickstart.py
    nu = np.logspace(8, 17, 32)
    return frontend(package).IsotropicDust(nu, np.repeat(0.4, 32),
                                           np.repeat(100.0, 32))


def _assert_fields_equal(port, ref):
    for f in dataclasses.fields(port):
        mine = getattr(port, f.name)
        theirs = getattr(ref, f.name)
        if isinstance(mine, torch.Tensor):
            mine = mine.numpy()
        np.testing.assert_array_equal(mine, np.asarray(theirs),
                                      err_msg=f.name)


def _dust_iso_wide(package):
    # more frequencies than the selfreg dust on the same emissivity grid:
    # the JAX builder pads frequency tables but fails on fewer emissivity
    # rows
    return lte_dust(package, albedo=np.linspace(0.1, 0.7, 30),
                    chi=np.geomspace(5, 500, 30), n_nu=30, nu_lo=1e10)


@pytest.mark.parametrize('make', [
    lambda pkg: [_tutorial_dust(pkg)],
    # tests/test_self_regression.py:_dust_iso
    lambda pkg: [lte_dust(pkg)],
    # two dusts of different table sizes exercise the padding
    lambda pkg: [lte_dust(pkg), _dust_iso_wide(pkg)],
], ids=['tutorial', 'selfreg_iso', 'two_dusts'])
def test_dust_tables_equal_jax(make):
    ref = j_dust(make('jax'), dtype=jnp.float64)
    _assert_fields_equal(build_dust_tables(make('port'), CPU, F64), ref)


def _tutorial_source(package):
    return [frontend(package).PointSource(luminosity=lsun,
                                          temperature=6000.0)]


def _collection_and_point(package):
    F = frontend(package)
    c = F.PointSourceCollection()
    c.luminosity = np.array([1.0, 2.0, 0.5]) * lsun
    c.position = np.array([[0.0, 0.0, 0.0], [10 * au, 0.0, -5 * au],
                           [-3 * au, 4 * au, 1 * au]])
    c.temperature = 4000.0
    s = F.PointSource(luminosity=3 * lsun, temperature=9000.0,
                      position=(1 * au, 2 * au, 3 * au))
    return [c, s]


def star_with_spots(package, limb=True):
    """A limb-darkened 2 Rsun star with two spots of their own spectra,
    beside a point source (the spots' rows share the star's group)."""
    F = frontend(package)
    star = F.SphericalSource(luminosity=lsun, temperature=4300.0,
                             radius=2 * F.rsun, limb=limb,
                             position=(0.5 * au, 0.0, -0.2 * au))
    for lon, lat, size, temp in ((30.0, 10.0, 20.0, 8000.0),
                                 (200.0, -45.0, 5.0, 9000.0)):
        spot = star.add_spot()
        spot.longitude, spot.latitude, spot.radius = lon, lat, size
        spot.luminosity = 0.1 * lsun
        spot.temperature = temp
    return [star, F.PointSource(luminosity=2 * lsun, temperature=6000.0)]


@pytest.mark.parametrize('make,evenly', [
    (_tutorial_source, False),
    (_collection_and_point, False),
    (_collection_and_point, True),
    (star_with_spots, False),
    (star_with_spots, True),
])
def test_source_tables_equal_jax(make, evenly):
    L = 50 * au
    ref = j_sources(make('jax'), dtype=jnp.float64, length_scale=L,
                    sample_evenly=evenly)
    _assert_fields_equal(build_source_tables(make('port'), CPU, F64,
                                             length_scale=L,
                                             sample_evenly=evenly), ref)


@pytest.mark.parametrize('kind,evenly', [
    ('external_sphere', False), ('external_box', False),
    ('plane_parallel', False), ('map', False), ('map_lte', False),
    ('mixed', True)])
@pytest.mark.parametrize('grid_kind', ['cartesian', 'cylindrical'])
def test_source_tables_of_the_other_sources_equal_jax(kind, evenly,
                                                      grid_kind):
    """Maps (a blackbody and an LTE spectrum; their CDFs over the grid's
    cells), external spheres and boxes and plane-parallel beams, alone and
    mixed with a point source and a star, on a cartesian and a
    cylindrical-polar grid."""
    from test_torch_sources import other_sources, source_grid
    L = 10 * au
    grids = {p: source_grid(p, grid_kind) for p in ('jax', 'port')}
    ref = j_sources(other_sources('jax', kind, grids['jax']),
                    dtype=jnp.float64, length_scale=L, sample_evenly=evenly,
                    grid=grids['jax'])
    _assert_fields_equal(build_source_tables(
        other_sources('port', kind, grids['port']), CPU, F64, length_scale=L,
        sample_evenly=evenly, grid=grids['port']), ref)


@pytest.mark.parametrize('walls', [
    [np.linspace(-50 * au, 50 * au, 33)] * 3,
    [np.linspace(-1.0, 2.0, 6), np.geomspace(0.1, 3.0, 4) - 1.0,
     np.array([-0.5, 0.0, 0.2, 0.9])],
], ids=['tutorial', 'nonuniform'])
def test_geometry_tables_equal_jax(walls):
    ref = j_geometry(frontend('jax').CartesianGrid(*walls),
                     dtype=jnp.float64)
    _assert_fields_equal(build_cartesian_geometry(
        frontend('port').CartesianGrid(*walls), CPU, F64), ref)


def test_tables_from_numpy_carry_the_yso_tables():
    """convert.tables_from_numpy carries the JAX dust, spherical-source and
    spherical-polar geometry tables into the port's, equal to the port's
    own builds."""
    from hyperion_tpu.transport.gtable_spherical import \
        build_spherical_geometry as j_spherical
    from hyperion_tpu_torch.convert import tables_from_numpy
    from hyperion_tpu_torch.transport.gtable_spherical import \
        build_spherical_geometry

    def grid(package):
        return frontend(package).SphericalPolarGrid(
            np.hstack([0.0, np.geomspace(au, 100 * au, 9)]),
            np.linspace(0.0, np.pi, 7), np.linspace(0.0, 2 * np.pi, 3))

    jg = j_spherical(grid('jax'), dtype=jnp.float64)
    L = jg.length_scale
    jax_tables = [j_dust([lte_dust('jax')], dtype=jnp.float64),
                  j_sources(star_with_spots('jax'), dtype=jnp.float64,
                            length_scale=L), jg]

    def fields(t):
        items = t._asdict().items() if hasattr(t, '_asdict') else \
            ((f.name, getattr(t, f.name)) for f in dataclasses.fields(t))
        return {k: np.asarray(v) for k, v in items}

    carried = tables_from_numpy(*map(fields, jax_tables), CPU, F64)
    built = (build_dust_tables([lte_dust('port')], CPU, F64),
             build_source_tables(star_with_spots('port'), CPU, F64,
                                 length_scale=L),
             build_spherical_geometry(grid('port'), CPU, F64))
    for mine, theirs in zip(built, carried):
        assert type(mine) is type(theirs)
        _assert_fields_equal(mine, theirs)
