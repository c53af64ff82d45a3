"""The port's remaining source rows against the JAX package's: luminosity
maps (with a blackbody or an LTE spectrum), external spheres and boxes and
plane-parallel beams, beside a point source and a star.

``emit_packets`` is fed the uniforms JAX's ``emit_packets`` draws from its
key (following its split sequence) and must give the same packets to rtol
1e-12 (float64), on a cartesian and a cylindrical-polar grid for the map's
cells; ``source_mono_energies`` gives the same rows (rtol 1e-12) and both
packages refuse an LTE spectrum there. Then the map source through the
port's Lucy iterations (tests/test_sources_engine.py's cases), photons of
an external sphere inscribed in a cylindrical grid, which must all start
inside it, and a box larger than the grid, whose photons outside it escape
at once."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperion_tpu.transport import build_dust_tables as j_dust
from hyperion_tpu.transport import build_source_tables as j_sources
from hyperion_tpu.transport.lucy import compute_jnu_var as j_jnu_var
from hyperion_tpu.transport.mono import \
    source_mono_energies as j_mono_energies
from hyperion_tpu.transport.stable import emit_packets as j_emit
from hyperion_tpu_torch.model.run import build_geometry_tables
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.gtable import ESCAPED
from hyperion_tpu_torch.transport.lucy import run_lucy
from hyperion_tpu_torch.transport.mono import source_mono_energies
from hyperion_tpu_torch.transport.stable import (
    E_BOX_X, E_BOX_Y, E_BOX_Z, E_LTE_BIN, E_LTE_DUST, E_LTE_XI, E_MAP,
    E_MAP_X, E_MAP_Y, E_MAP_Z, E_PP_PHI, E_PP_R, MAP, N_EMIT_EXTRA,
    build_source_tables, emit_packets)
from hyperion_tpu_torch.util.constants import au, lsun
from test_torch_frontend import frontend, lte_dust

torch.set_num_threads(1)
CPU = torch.device('cpu')
F64 = torch.float64
RTOL = 1e-12
B = 3000


def source_grid(package, kind):
    """A small cartesian or cylindrical-polar grid of +-10 au."""
    F = frontend(package)
    if kind == 'cartesian':
        return F.CartesianGrid(np.linspace(-10, 10, 6) * au,
                               np.linspace(-10, 10, 5) * au,
                               np.array([-10.0, -2.0, 0.0, 3.0, 10.0]) * au)
    return F.CylindricalPolarGrid(
        np.hstack([0.0, np.geomspace(0.5, 10.0, 5)]) * au,
        np.linspace(-10, 10, 5) * au, np.linspace(0.0, 2 * np.pi, 4))


def other_sources(package, kind, grid=None):
    """The sources of one ``kind``: 'external_sphere', 'external_box',
    'plane_parallel', 'map' (a blackbody), 'map_lte', or 'mixed' (each of
    them beside a point source and a star)."""
    F = frontend(package)
    out = []
    if kind in ('external_sphere', 'mixed'):
        out.append(F.ExternalSphericalSource(
            luminosity=0.3 * lsun, temperature=5000.0, radius=9.0 * au,
            position=(0.5 * au, -0.2 * au, 0.1 * au)))
    if kind in ('external_box', 'mixed'):
        s = F.ExternalBoxSource(luminosity=0.2 * lsun, temperature=7000.0)
        s.bounds = [(-9 * au, 8 * au), (-7 * au, 9 * au), (-3 * au, 6 * au)]
        out.append(s)
    if kind in ('plane_parallel', 'mixed'):
        out.append(F.PlaneParallelSource(
            luminosity=0.5 * lsun, temperature=9000.0, radius=4.0 * au,
            position=(1.0 * au, 2.0 * au, -3.0 * au), direction=(35.0, 70.0)))
    if kind in ('map', 'map_lte', 'mixed'):
        lum = np.random.default_rng(3).uniform(0.0, 1.0, grid.shape)
        lum[lum < 0.3] = 0.0
        kw = {} if kind == 'map_lte' else dict(temperature=3000.0)
        out.append(F.MapSource(luminosity=0.4 * lsun, map=lum, **kw))
    if kind == 'mixed':
        out.append(F.PointSource(luminosity=lsun, temperature=6000.0,
                                 position=(1 * au, 0.0, 0.0)))
        out.append(F.SphericalSource(luminosity=0.7 * lsun,
                                     temperature=4000.0, radius=0.5 * au,
                                     position=(-2 * au, 1 * au, 0.5 * au)))
    return out


def _t(a):
    return torch.as_tensor(np.array(a))


def _uniform(key, shape=(B,)):
    return np.asarray(jax.random.uniform(key, shape, dtype=jnp.float64))


def jax_emit_uniforms(key, n=B):
    """The uniforms JAX's emit_packets draws from ``key``, in the port's
    order: (u_src, u_nu, u_mu, u_phi), u_sphere (u_cap, u_cap_phi, u_out,
    u_out_phi) and u_extra, the (N_EMIT_EXTRA, n) rows of stable.E_*."""
    k_src, k_nu, k_dir, k_pos, k_pos2 = jax.random.split(key, 5)
    k_cap1, k_cap2 = jax.random.split(k_pos)
    k1, k2 = jax.random.split(k_dir)
    k_mu, k_phi = jax.random.split(k1)
    k_l1, k_l2 = jax.random.split(jax.random.fold_in(k_nu, 13))
    k_bin, k_xi = jax.random.split(k_l2)
    extra = np.empty((N_EMIT_EXTRA, n))
    extra[E_MAP] = _uniform(jax.random.fold_in(k_pos2, 11), (n,))
    extra[E_MAP_X:E_MAP_Z + 1] = _uniform(jax.random.fold_in(k_pos2, 12),
                                          (3, n))
    extra[E_BOX_X:E_BOX_Z + 1] = _uniform(k_pos2, (n, 3)).T
    extra[E_PP_R] = _uniform(jax.random.fold_in(k_pos, 2), (n,))
    extra[E_PP_PHI] = _uniform(jax.random.fold_in(k_pos, 3), (n,))
    extra[E_LTE_DUST] = _uniform(k_l1, (n,))
    extra[E_LTE_BIN] = _uniform(k_bin, (n,))
    extra[E_LTE_XI] = _uniform(k_xi, (n,))
    u = [_t(_uniform(k, (n,))) for k in (k_src, k_nu, k_mu, k_phi)]
    u_sphere = tuple(_t(_uniform(k, (n,))) for k in (
        k_cap1, k_cap2, k2, jax.random.fold_in(k2, 1)))
    return u, u_sphere, _t(extra)


def _dusts(package):
    return [lte_dust(package), lte_dust(package, albedo=0.6, chi=20.0)]


@pytest.mark.parametrize('grid_kind', ['cartesian', 'cylindrical'])
def test_emit_packets_matches_jax(grid_kind):
    """Every row type at once, the map with an LTE spectrum and a random
    specific energy (its dust picked ∝ specific energy x density, one
    cell's all zero for the uniform pick): positions, directions,
    frequencies, energies, rows and the surface context, rtol 1e-12."""
    from hyperion_tpu.model.run import build_geometry_tables as j_geometry
    grids = {p: source_grid(p, grid_kind) for p in ('jax', 'port')}
    L = 10 * au
    jst = j_sources(other_sources('jax', 'mixed', grids['jax']) +
                    other_sources('jax', 'map_lte', grids['jax']),
                    dtype=jnp.float64, length_scale=L, grid=grids['jax'])
    pst = build_source_tables(other_sources('port', 'mixed', grids['port']) +
                              other_sources('port', 'map_lte', grids['port']),
                              CPU, F64, length_scale=L, grid=grids['port'])
    assert pst.has_map and pst.has_lte and pst.has_sphere and pst.has_extra
    jg = j_geometry(grids['jax'], jnp.float64)
    pg = build_geometry_tables(grids['port'], CPU, F64)
    jdt = j_dust(_dusts('jax'), dtype=jnp.float64)
    pdt = build_dust_tables(_dusts('port'), CPU, F64)
    n_cells = pg.n_cells
    rng = np.random.default_rng(5)
    se = 10 ** rng.uniform(-2, 4, (2, n_cells))
    rho = rng.uniform(0.0, 1.0, (2, n_cells))
    rho[:, 0] = 0.0
    vid, vfrac = j_jnu_var(jdt, jnp.asarray(se))
    key = jax.random.PRNGKey(9)
    ref = j_emit(jst, key, B, jnp.float64, geometry=jg,
                 lte_ctx=(jdt, vid, vfrac, jnp.asarray(se * rho)))
    u, u_sphere, extra = jax_emit_uniforms(key)
    port = emit_packets(pst, *u, u_sphere, u_extra=extra, geometry=pg,
                        lte_ctx=(pdt, _t(vid), _t(vfrac), _t(se * rho)))
    for k in ('x', 'y', 'z', 'kx', 'ky', 'kz', 'nu', 'energy', 'snx', 'sny',
              'snz'):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=1e-15, err_msg=k)
    for k in ('source', 'surf', 'limb'):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    rows = port['source'].numpy()
    assert len(np.unique(rows)) == pst.n_sources
    # the maps' photons start in cells of positive luminosity (both maps
    # are the same), binned by their position alone (find_cell's nudge of
    # 1% of the finest wall spacing can carry a point near the axis into
    # the next phi cell)
    on_map = pst.type_code.numpy()[rows] == MAP
    lum = other_sources('port', 'map', grids['port'])[0].map
    idx = _bin(grids['port'], *(port[c].numpy() * L for c in 'xyz'))
    assert on_map.sum() > 200 and (lum[idx][on_map] > 0).all()


def _bin(grid, x, y, z):
    """The (i3, i2, i1) cell index of positions, by their coordinates."""
    if hasattr(grid, 'x_wall'):
        coords = (z, y, x)
        walls = (grid.z_wall, grid.y_wall, grid.x_wall)
    else:
        coords = (np.arctan2(y, x) % (2 * np.pi), z, np.hypot(x, y))
        walls = (grid.p_wall, grid.z_wall, grid.w_wall)
    return tuple(np.clip(np.searchsorted(w, c, side='right') - 1, 0,
                         len(w) - 2) for c, w in zip(coords, walls))


@pytest.mark.parametrize('kind', ['external_sphere', 'external_box',
                                  'plane_parallel', 'map', 'mixed'])
def test_source_mono_energies_match_jax(kind):
    """Each row's spectral density at the monochromatic frequencies, rtol
    1e-12; an LTE spectrum is refused by both packages."""
    nu = np.geomspace(1e11, 3e15, 17)
    grids = {p: source_grid(p, 'cartesian') for p in ('jax', 'port')}
    ref = j_mono_energies(other_sources('jax', kind, grids['jax']), nu)
    port = source_mono_energies(other_sources('port', kind, grids['port']),
                                nu)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0)
    for pkg, fn in (('jax', j_mono_energies), ('port', source_mono_energies)):
        with pytest.raises(ValueError, match='LTE'):
            fn(other_sources(pkg, 'map_lte', grids[pkg]), nu)


def _map_setup(n=5, half=10.0, hot=None, lte=False):
    """tests/test_sources_engine.py's map models on the port."""
    F = frontend('port')
    w = np.linspace(-half, half, n + 1)
    grid = F.CartesianGrid(w, w, w)
    geo = build_geometry_tables(grid, CPU, F64)
    nu = np.geomspace(1e8, 1e17, 32)
    dt = build_dust_tables([F.IsotropicDust(nu, np.full_like(nu, 0.5),
                                            np.full_like(nu, 2.0))], CPU, F64)
    m = np.ones((n, n, n))
    if hot is not None:
        m = np.zeros((n, n, n))
        m[hot] = 1.0
    kw = {} if lte else dict(temperature=100.0)
    src = F.MapSource(luminosity=3.8e33 if lte else 1.0, map=m, **kw)
    st = build_source_tables([src], CPU, F64, grid=grid,
                             length_scale=geo.length_scale)
    return grid, geo, dt, st


def test_map_source_emission():
    """A single hot cell emits every photon (in its cell); an LTE map
    spreads its frequencies over the dust's emissivity grid."""
    _, geo, dt, st = _map_setup(hot=(2, 2, 2))
    assert st.has_map and not st.has_lte
    g = torch.Generator().manual_seed(1)
    u = torch.rand((4 + N_EMIT_EXTRA, 2048), generator=g, dtype=F64)
    new = emit_packets(st, *u[:4], u_extra=u[4:], geometry=geo)
    cell = geo.find_cell(new['x'], new['y'], new['z'], new['kx'],
                         new['ky'], new['kz'])
    assert (cell == np.ravel_multi_index((2, 2, 2), (5, 5, 5))).all()

    _, geo, dt, st = _map_setup(n=3, lte=True)
    assert st.has_lte
    ctx = (dt, torch.zeros((1, 27), dtype=torch.int64),
           torch.zeros((1, 27), dtype=F64), torch.ones((1, 27), dtype=F64))
    new = emit_packets(st, *u[:4], u_extra=u[4:], geometry=geo,
                       lte_ctx=ctx)
    nu = new['nu'].numpy()
    e_nu = dt.emiss_nu[0].numpy()
    assert (nu >= e_nu[0] * 0.999).all() and (nu <= e_nu[-1] * 1.001).all()
    assert np.unique(nu).size > 100


def test_map_source_through_lucy():
    """An LTE map source through two Lucy iterations (the second draws its
    dust from the first's specific energy): every cell heated, nothing
    killed, every photon counted."""
    _, geo, dt, st = _map_setup(n=4, half=5.0, lte=True)
    density = torch.full((1, 64), 1e-19 * geo.length_scale, dtype=F64)
    res = run_lucy(geo, dt, st, density, torch.Generator().manual_seed(3),
                   n_photons=2000, n_iterations=2, batch_size=512,
                   verbose=False)
    assert res.specific_energy.min() > 0.0
    assert res.killed_int == 0 and res.killed_geo == 0
    assert res.energy_current == 2000.0


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_inscribed_external_sphere_starts_inside(dtype):
    """An external sphere inscribed in a cylindrical grid (its poles and
    equator touch the grid's faces): every inward photon is found inside
    the grid, in float64 and float32."""
    F = frontend('port')
    grid = F.CylindricalPolarGrid(np.hstack([0.0, np.geomspace(1, 100, 20)]),
                                  np.linspace(-100, 100, 21), [0, 2 * np.pi])
    geo = build_geometry_tables(grid, CPU, dtype)
    st = build_source_tables([F.ExternalSphericalSource(
        luminosity=1.0, temperature=5000.0, radius=100.0)], CPU, dtype,
        length_scale=geo.length_scale)
    g = torch.Generator().manual_seed(7)
    u = torch.rand((8, 100000), generator=g, dtype=dtype)
    # the poles and the equator themselves
    u[4, :200] = torch.tensor([0.0, 1.0]).repeat(100).to(dtype)
    u[4, 200:300] = 0.5
    new = emit_packets(st, *u[:4], tuple(u[4:]))
    r = torch.sqrt(new['x'] ** 2 + new['y'] ** 2 + new['z'] ** 2)
    assert torch.allclose(r, torch.ones_like(r), rtol=1e-5)
    assert ((new['x'] * new['kx'] + new['y'] * new['ky'] +
             new['z'] * new['kz']) <= 1e-6).all()       # inward
    cell = geo.find_cell(new['x'], new['y'], new['z'], new['kx'],
                         new['ky'], new['kz'])
    assert (cell != ESCAPED).all()


def test_box_larger_than_the_grid():
    """A box source reaching outside the grid: its photons emitted outside
    escape at once (the JAX package's rule), are counted in the energy
    emitted, and kill nothing."""
    F = frontend('port')
    grid = F.CartesianGrid(*[np.linspace(-1.0, 1.0, 5)] * 3)
    geo = build_geometry_tables(grid, CPU, F64)
    nu = np.geomspace(1e8, 1e17, 32)
    dt = build_dust_tables([F.IsotropicDust(nu, np.full_like(nu, 0.5),
                                            np.full_like(nu, 2.0))], CPU, F64)
    s = F.ExternalBoxSource(luminosity=1.0, temperature=5000.0)
    s.bounds = [(-2.0, 2.0)] * 3
    st = build_source_tables([s], CPU, F64, length_scale=geo.length_scale)
    density = torch.full((1, 64), 0.5 * geo.length_scale, dtype=F64)
    res = run_lucy(geo, dt, st, density, torch.Generator().manual_seed(4),
                   n_photons=8000, n_iterations=1, batch_size=2048,
                   check_frequency=0.1, verbose=False)
    assert res.energy_current == 8000.0
    assert res.killed_int == 0 and res.killed_geo == 0
    # about 1/8 of the box lies in the grid
    assert 0.08 < res.n_photons_cell.sum() / 8000 < 0.6
