"""The port's raytracing pass against the JAX package's (JAX x64, torch
float64, the same numpy inputs from a seed).

- The column walk: ``escape_column_reference`` (what ``EscapeTau.columns``
  runs on the CPU) against JAX ``escape_column_walk``, on the grids of
  tests/test_torch_escape_tau.py, to the edge and to ``t_max``, with one
  and three dust types. Cartesian and spherical rays to rtol 1e-12 (on the
  spherical grid the rays through the z axis are left out, as there);
  the thin shells, whose walks torch's CPU float64 sqrt (one ulp off on
  ~0.7% of inputs) can move by one thin-shell segment, with the atol 5e-10
  of test_thin_shells_match_jax.
- The host tables (plain and filter groups, exact frequencies) to 1e-12,
  on dusts whose emissivities have 60 var rows and on dusts with the
  default 1,200 rows, which both packages resample onto 60.
- The batch pieces: positions in cells from the same uniforms, and one
  view's attenuation and binning (a plane and an inside observer) on the
  same positions and spectra, to rounding.
- Whole runs through each package's ``run_model``, the .rtout read by both
  ``ModelOutput``s: a point source seen through dust of albedo 0 with
  raytracing sources only, where every photon gives the same contribution
  (to 1e-9 whatever the random streams); and a cartesian model with
  raytraced sources and dust from a given specific energy, within their
  noise (the class2 YSO's raytracing, at exact wavelengths, is in
  tests/test_torch_mono.py)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperion_tpu.model.run import run_model as j_run_model
from hyperion_tpu.transport import raytrace as jrt
from hyperion_tpu.transport.imaging import build_peel_group as j_peel_group
from hyperion_tpu_torch.model.run import run_model
from hyperion_tpu_torch.transport import escape_tau as et
from hyperion_tpu_torch.transport import raytrace as rt
from hyperion_tpu_torch.transport.imaging import Provenance, origin_index
from hyperion_tpu_torch.transport.imaging import build_peel_group
from test_torch_escape_tau import (_jax_geometry, _port_args,
                                   _shared_setup)
from test_torch_frontend import class2_model, frontend

torch.set_num_threads(1)
CPU = torch.device('cpu')
J = jnp.asarray


# one compilation per test for its views
_j_columns = jax.jit(jrt.escape_column_walk, static_argnames=('max_steps',))


def _densities(n_dust, n_cells, seed, thin=None):
    """(n_dust, n_cells) densities, a fifth of the entries 0; ``thin`` (the
    radial cell counts n1) makes the 11 thin shells 1e3 times denser."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.0, 3.0, (n_dust, n_cells))
    rho[rng.random(rho.shape) < 0.2] = 0.0
    if thin is not None:
        rho[:, (np.arange(n_cells) % thin) < 11] *= 1e3
    return rho


@pytest.mark.parametrize('n_dust', [1, 3])
@pytest.mark.parametrize('limited', [False, True], ids=['edge', 't_max'])
@pytest.mark.parametrize('kind', ['cartesian', 'spherical', 'thin_shells'])
def test_column_walk_matches_jax(kind, limited, n_dust):
    n = {'cartesian': 1000, 'spherical': 2000, 'thin_shells': 1000}[kind]
    pg, pos, k, cell, active, _, chi, t_max = _shared_setup(kind, n)
    rho = _densities(n_dust, pg.n_cells, 7 + n_dust,
                     pg.n1 if kind == 'thin_shells' else None)
    geo = _jax_geometry(kind)
    ref = np.stack([np.asarray(_j_columns(
        geo, J(rho), *[J(a) for a in pos], *[J(k[c, v]) for c in range(3)],
        J(cell), J(active), t_max=J(t_max[v]) if limited else None))
        for v in range(k.shape[1])])
    walk = et.EscapeTau(pg, torch.as_tensor(rho.T.copy()))
    launches = et.column_launches
    col = walk.columns(*_port_args(pos, k, cell, active, chi)[1:],
                       t_max=torch.as_tensor(t_max) if limited else None)
    assert et.column_launches == launches    # the CPU runs the plain version
    assert col.shape == (k.shape[1], n, n_dust)
    atol = 5e-10 if kind == 'thin_shells' else 1e-300
    np.testing.assert_allclose(col.numpy(), ref, rtol=1e-12, atol=atol)
    assert (col.numpy()[:, ~active] == 0).all()
    assert (col.numpy()[:, active].sum(axis=-1) > 0).mean() > 0.8


# ------------------------------------------------------------ host tables --

def _filter(F, pkg, group, wav):
    """A top-hat filter around ``wav`` micron on the peeled group."""
    from hyperion_tpu_torch.util.constants import c
    nu0 = c / (wav * 1e-4)
    f = group.add_filter()
    f.name = 'F%g' % wav
    f.nu = np.linspace(0.8 * nu0, 1.2 * nu0, 40)
    f.transmission = np.ones(40)
    f.central_nu = nu0
    f.alpha = 1.0
    f.detector_type = 'energy'


def _table_inputs(pkg, filters=False, n_temp=60):
    """(dusts, sources, peeled conf) of a model with a point source, a
    spotted limb-darkened star and two dusts (one with filters), whose LTE
    emissivities have ``n_temp`` var rows (1,200 by default, resampled onto
    60 by the tables; 60 taken as they are)."""
    F = frontend(pkg)
    nu = np.logspace(8, 17, 40)
    dusts = [F.IsotropicDust(nu, np.repeat(0.3, 40),
                             np.geomspace(500.0, 5.0, 40)),
             F.HenyeyGreensteinDust(nu, np.repeat(0.6, 40),
                                    np.repeat(80.0, 40), np.repeat(0.3, 40),
                                    np.repeat(0.5, 40))][:1 if filters else 2]
    for d in dusts:
        d.set_lte_emissivities(n_temp=n_temp)
    m = F.Model()
    w = np.linspace(-F.au, F.au, 4)
    m.set_cartesian_grid(w, w, w)
    for d in dusts:
        m.add_density_grid(np.full(m.grid.shape, 1e-18), d)
    p = m.add_point_source()
    p.luminosity, p.temperature = F.lsun, 5000.0
    s = m.add_spherical_source()
    s.luminosity, s.temperature, s.radius = 2 * F.lsun, 4000.0, F.rsun
    s.limb = True
    spot = s.add_spot()
    spot.longitude, spot.latitude, spot.radius = 20.0, 10.0, 15.0
    spot.luminosity, spot.temperature = 0.1 * F.lsun, 8000.0
    g = m.add_peeled_images(sed=True, image=not filters)
    g.set_viewing_angles([30.0], [10.0])
    if filters:
        for wav in (1.0, 10.0, 100.0):
            _filter(F, pkg, g, wav)
    else:
        g.set_image_size(4, 4)
        g.set_image_limits(-F.au, F.au, -F.au, F.au)
        g.set_wavelength_range(25, 0.2, 500.0)
    return dusts, m.sources, g


def _grid_arrays(n_dust=2, n_cells=27, seed=3):
    """(specific_energy, density, volumes) numpy inputs of the tables."""
    rng = np.random.default_rng(seed)
    return (10.0 ** rng.uniform(-3.0, 3.0, (n_dust, n_cells)),
            rng.uniform(0.0, 2.0, (n_dust, n_cells)),
            rng.uniform(0.5, 1.5, n_cells))


def _same(port, ref, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=0)


VAR_ROWS = pytest.mark.parametrize('n_temp', [60, 1200],
                                   ids=['var60', 'var1200'])


@VAR_ROWS
@pytest.mark.parametrize('filters', [False, True], ids=['bins', 'filters'])
def test_raytrace_tables_match_jax(filters, n_temp):
    """build_raytrace_tables on a plain and a filter group. The JAX package
    keeps one source spectrum per source object and the port one per
    emission row (a spotted star is a row per spot): the rows of the point
    source and of the star's photosphere must agree. The filter groups'
    shared sampling grid is cut from 512 to 64 samples in both (the
    tables' build loops over every sample, var row and dust)."""
    dusts_j, sources_j, conf_j = _table_inputs('jax', filters, n_temp)
    dusts_p, sources_p, conf_p = _table_inputs('port', filters, n_temp)
    se, rho, vol = _grid_arrays(len(dusts_j))
    jg = j_peel_group(conf_j, jnp.float64, length_scale=2.0)
    pg = build_peel_group(conf_p, CPU, torch.float64, length_scale=2.0)
    if filters:
        jg = dataclasses.replace(jg, filter_lognu=jg.filter_lognu[::8],
                                 filter_tn=jg.filter_tn[:, ::8])
        pg.filter_lognu = pg.filter_lognu[::8]
        pg.filter_tn = pg.filter_tn[:, ::8]
    ref, vg_j, edges_j = jrt.build_raytrace_tables(
        dusts_j, sources_j, None, None, jg, se, rho, vol, jnp.float64,
        length_scale=2.0)
    got, vg_p, edges_p = rt.build_raytrace_tables(
        dusts_p, sources_p, pg, se, rho, vol, CPU, torch.float64,
        length_scale=2.0)
    _same(edges_p, edges_j)
    _same(np.array(vg_p), np.array(vg_j))
    assert got.dust_spec.shape[0] == len(dusts_p) * rt.N_VAR_EFF
    for name in ('dust_spec', 'chi_nu', 'cell_lum', 'cell_cdf'):
        _same(getattr(got, name), getattr(ref, name))
    _same(got.total_grid_luminosity, ref.total_grid_luminosity)
    _same(got.source_spec[:2], ref.source_spec[:2])
    assert got.source_spec.shape[0] == 3      # the spot's own row
    assert (got.fold is None) == (not filters)
    if filters:
        _same(got.fold, ref.fold)


@VAR_ROWS
def test_mono_tables_match_jax(n_temp):
    """build_raytrace_tables_mono and source_mono_energies at exact
    frequencies (some outside the dusts' emissivity tables)."""
    from hyperion_tpu.transport.mono import source_mono_energies as j_energies
    from hyperion_tpu_torch.transport.mono import source_mono_energies
    freqs = np.array([3e9, 1e12, 3e13, 3e14, 1e15, 3e17])
    dusts_j, sources_j, _ = _table_inputs('jax', n_temp=n_temp)
    dusts_p, sources_p, _ = _table_inputs('port', n_temp=n_temp)
    se, rho, vol = _grid_arrays()
    ref, vg_j = jrt.build_raytrace_tables_mono(
        dusts_j, sources_j[:1], None, None, freqs, se, rho, vol, jnp.float64,
        length_scale=3.0)
    got, vg_p = rt.build_raytrace_tables_mono(
        dusts_p, sources_p[:1], freqs, se, rho, vol, CPU, torch.float64,
        length_scale=3.0)
    for name in ('source_spec', 'dust_spec', 'chi_nu', 'cell_lum',
                 'cell_cdf'):
        _same(getattr(got, name), getattr(ref, name))
    _same(got.total_grid_luminosity, ref.total_grid_luminosity)
    _same(np.array(vg_p), np.array(vg_j))
    # with the star's photosphere row: the JAX package has no spot rows
    _same(source_mono_energies(sources_p, freqs)[:2],
          j_energies(sources_j, freqs)[:2])
    assert source_mono_energies(sources_p, freqs).shape == (3, len(freqs))


# ----------------------------------------------------------- batch pieces --

def _geometries(kind):
    """(JAX geometry, port float64 geometry) of a test grid."""
    from test_torch_escape_tau import GRIDS
    make, build, _, _ = GRIDS[kind]
    return _jax_geometry(kind), build(make('port'), CPU, torch.float64)


@pytest.mark.parametrize('kind', ['cartesian', 'spherical'])
def test_position_in_cell_matches_jax(kind):
    """The same uniforms (JAX's draw from its key) give the same points."""
    jgeo, pgeo = _geometries(kind)
    cell = np.random.default_rng(4).integers(0, pgeo.n_cells, 5000)
    key = jax.random.PRNGKey(9)
    ref = jrt.sample_position_in_cell(jgeo, J(cell), key, jnp.float64)
    u = np.asarray(jax.random.uniform(key, (3, 5000), dtype=jnp.float64))
    got = rt.sample_position_in_cell(pgeo, torch.as_tensor(cell),
                                     torch.as_tensor(u))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13,
                                   atol=1e-15)
    # inside its cell
    back = pgeo.find_cell(*got, *[torch.zeros(5000)] * 2, torch.ones(5000))
    assert (back.numpy() == cell).mean() > 0.99


def _peel_inputs(seed=21, n=3000, n_int=25):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 2.0, n_int * 2).reshape(2, n_int),
            rng.uniform(0.0, 1.0, (n, n_int)), rng.random(n) < 0.9,
            rng.integers(0, 2, n))


@pytest.mark.parametrize('inside', [False, True], ids=['plane', 'inside'])
def test_peel_view_bin_matches_jax(inside):
    """One view's column walk, attenuation and binning, for a plane
    observer (two views, three apertures, an image, track_origin detailed)
    and an inside observer (sky angles, 1/(4 pi d^2)), on the same
    positions and spectra (a stellar-surface weight on the plane views)."""
    F = {p: frontend(p) for p in ('jax', 'port')}

    def conf(pkg):
        m = F[pkg].Model()
        g = m.add_peeled_images(sed=True, image=True)
        if inside:
            g.set_inside_observer((0.2, -0.1, 0.05))
            g.set_viewing_angles([90.0, 60.0], [0.0, 30.0])
            g.set_image_limits(180.0, -180.0, -90.0, 90.0)
        else:
            g.set_viewing_angles([30.0, 75.0], [10.0, 200.0])
            g.set_image_limits(-0.8, 0.8, -0.8, 0.8)
            g.set_aperture_radii(3, 0.1, 1.0)
        g.set_image_size(7, 5)
        g.set_wavelength_range(25, 0.2, 500.0)
        g.set_track_origin('detailed')
        return g

    jgeo, pgeo = _geometries('cartesian')
    jg = j_peel_group(conf('jax'), jnp.float64, n_sources=1, n_dust=2)
    pg = build_peel_group(conf('port'), CPU, torch.float64, n_sources=1,
                          n_dust=2)
    chi_nu, spec, active, dust = _peel_inputs()
    _, pos, _, cell, _, _, _, _ = _shared_setup('cartesian', len(active))
    active = active & (cell >= 0)
    rho = _densities(2, pgeo.n_cells, 5)
    n = len(active)
    rng = np.random.default_rng(8)
    snx = rng.normal(size=(3, n))
    snx /= np.linalg.norm(snx, axis=0)
    surf = rng.random(n) < 0.5

    def weight(nx, vdx, vdy, vdz, where):
        mu = np.maximum(nx[0] * vdx + nx[1] * vdy + nx[2] * vdz, 0.0)
        return where(J(surf) if where is jnp.where else torch.as_tensor(surf),
                     4.0 * mu, 1.0)

    tables = dict(source_spec=spec[:1], dust_spec=spec[:2], chi_nu=chi_nu,
                  cell_lum=spec[0], cell_cdf=spec[0],
                  total_grid_luminosity=1.0)
    jt = jrt.RaytraceTables(**{k: J(v) for k, v in tables.items()})
    pt = rt.RaytraceTables(**{k: torch.as_tensor(v) if k != 'total_grid_'
                              'luminosity' else v for k, v in tables.items()})
    jprov_id = J(dust)
    from hyperion_tpu.transport.imaging import Provenance as JProv
    from hyperion_tpu.transport.imaging import origin_index as j_origin
    zb = jnp.zeros(n, bool)
    zi = jnp.zeros(n, jnp.int64)
    j_io = jnp.clip(j_origin(jg, JProv(scattered=zb, reprocessed=~zb,
                                       source_id=zi, dust_id=jprov_id,
                                       n_scat=zi)), 0, jg.n_orig - 1)
    tb = torch.zeros(n, dtype=torch.bool)
    ti = torch.zeros(n, dtype=torch.int64)
    p_io = origin_index(pg, Provenance(scattered=tb, reprocessed=~tb,
                                       source_id=ti,
                                       dust_id=torch.as_tensor(dust),
                                       n_scat=ti)).clamp(0, pg.n_orig - 1)
    x, y, z = (torch.as_tensor(a.copy()) for a in pos)
    walk = et.EscapeTau(pgeo, torch.as_tensor(rho.T.copy()))
    k, t_max, d_obs = rt._sights(pg, x, y, z)
    col = walk.columns(x, y, z, *k, torch.as_tensor(cell),
                       torch.as_tensor(active), t_max=t_max)
    acc = rt.RaytraceAccum(pg, CPU)
    sed = jnp.zeros((jg.n_view, jg.n_ap, jg.n_nu, jg.n_orig))
    img = jnp.zeros((jg.n_view, jg.n_y, jg.n_x, jg.n_nu, jg.n_orig))
    for iv in range(pg.n_view):
        j = 0 if inside else iv
        wp = wj = None
        if not inside:
            def wj(vdx, vdy, vdz):
                return weight(snx, vdx, vdy, vdz, jnp.where)

            def wp(vdx, vdy, vdz):
                return weight(torch.as_tensor(snx), vdx, vdy, vdz,
                              torch.where)
        sed, img = jrt._peel_view_bin(
            jgeo, J(rho), jt, jg, iv, *[J(a) for a in pos], J(cell),
            J(active), J(spec), sed, img, j_io, weight_fn=wj)
        rt._peel_view_bin(pg, pt, iv, x, y, z, tuple(a[j] for a in k),
                          d_obs, col[j], torch.as_tensor(active),
                          torch.as_tensor(spec), acc, p_io, weight_fn=wp)
    for got, ref in ((acc.sed, sed), (acc.img, img)):
        ref = np.asarray(ref)
        assert ref.sum() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-11,
                                   atol=1e-12 * np.abs(ref).max())


def test_dust_batch_matches_jax():
    """A batch of thermal photons from the same uniforms (JAX's draws from
    its key) on the spherical-polar grid: the (dust, cell) picks on the
    luminosity CDF, the positions, the emissivity spectra interpolated
    between var rows, the walks and the binning give the JAX package's
    cubes to rounding (two dusts, two views, three apertures, an image,
    track_origin detailed, 100 masked lanes)."""
    jgeo, pgeo = _geometries('spherical')
    F = {p: frontend(p) for p in ('jax', 'port')}
    rng = np.random.default_rng(31)
    se = 10.0 ** rng.uniform(-2.0, 4.0, (2, pgeo.n_cells))
    rho = _densities(2, pgeo.n_cells, 12)
    vol = pgeo.volumes.numpy()

    def conf(pkg):
        g = F[pkg].Model().add_peeled_images(sed=True, image=True)
        g.set_viewing_angles([30.0, 75.0], [10.0, 200.0])
        g.set_image_limits(-0.8, 0.8, -0.8, 0.8)
        g.set_aperture_radii(3, 0.1, 1.0)
        g.set_image_size(7, 5)
        g.set_wavelength_range(25, 0.2, 500.0)
        g.set_track_origin('detailed')
        return g

    jg = j_peel_group(conf('jax'), jnp.float64, n_sources=1, n_dust=2)
    pg = build_peel_group(conf('port'), CPU, torch.float64, n_sources=1,
                          n_dust=2)
    dusts_j, sources_j, _ = _table_inputs('jax')
    dusts_p, sources_p, _ = _table_inputs('port')
    jt, vg, _ = jrt.build_raytrace_tables(dusts_j, sources_j, None, None, jg,
                                          se, rho, vol, jnp.float64)
    pt, vg_p, _ = rt.build_raytrace_tables(dusts_p, sources_p, pg, se, rho,
                                           vol, CPU, torch.float64)
    B, key = 3000, jax.random.PRNGKey(17)
    (sed, img), = jrt._raytrace_dust_batch(jgeo, None, jt, vg, [jg], J(rho),
                                           J(se), key, B, B - 100)
    k_cell, k_pos, _ = jax.random.split(key, 3)
    u = np.vstack([np.asarray(jax.random.uniform(k_cell, (B,),
                                                 dtype=jnp.float64)),
                   np.asarray(jax.random.uniform(k_pos, (3, B),
                                                 dtype=jnp.float64))])
    acc = rt.RaytraceAccum(pg, CPU)
    var_log = torch.log10(torch.as_tensor(np.array(vg_p)))
    rt.raytrace_dust_batch(et.EscapeTau(pgeo, torch.as_tensor(rho.T.copy())),
                           pgeo, pt, var_log, [pg], [acc],
                           torch.as_tensor(se), torch.as_tensor(u), B - 100,
                           1.0)
    for got, ref in ((acc.sed, sed), (acc.img, img)):
        ref = np.asarray(ref)
        assert ref.sum() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                                   atol=1e-12 * np.abs(ref).max())


def _jax_uniforms(key, B, source):
    """The uniforms the JAX package draws for one raytracing batch from
    ``key``, in the port's row order: a source batch's eight rows (the key
    splits of ``stable.emit_packets``) or a dust batch's four (those of
    ``raytrace_dust_batch_impl``)."""
    split, f64 = jax.random.split, jnp.float64

    def u(k, shape=(B,)):
        return np.asarray(jax.random.uniform(k, shape, dtype=f64))

    if not source:
        k_cell, k_pos, _ = split(key, 3)
        return np.vstack([u(k_cell), u(k_pos, (3, B))])
    k_src, k_nu, k_dir, k_pos, _ = split(key, 5)
    k_cap1, k_cap2 = split(k_pos)
    k1, k2 = split(k_dir)
    k_mu, k_phi = split(k1)
    return np.stack([u(k_src), u(k_nu), u(k_mu), u(k_phi), u(k_cap1),
                     u(k_cap2), u(k2), u(jax.random.fold_in(k2, 1))])


class JaxDraws:
    """Stands in for ``torch`` in the port's raytrace module: its
    ``torch.rand`` gives, call by call, the uniforms the JAX package's
    ``run_raytracing`` draws from ``key`` for ``n_src`` source and
    ``n_dust`` dust photons in batches of ``B`` (its key chain: one split
    per batch); everything else is torch's."""

    def __init__(self, key, B, n_src, n_dust):
        self.draws = []
        for n, source in ((n_src, True), (n_dust, False)):
            for _ in range(-(-n // B)):
                key, k_e = jax.random.split(key)
                self.draws.append(torch.as_tensor(_jax_uniforms(k_e, B,
                                                                source)))

    def __getattr__(self, name):
        return getattr(torch, name)

    def rand(self, shape, generator=None, device=None, dtype=None):
        u = self.draws.pop(0)
        assert tuple(shape) == tuple(u.shape)
        return u.to(device=device, dtype=dtype)


def _class2_tables(pkg, inside):
    """The class2 YSO at 24 x 8 cells with a given specific energy (a 300 K
    (r / 1 au)^-0.5 profile) and one peeled group (its three views and 120
    bands, or an inside observer's 6 x 4 image at 30 au in the disk's
    plane): (model, geometry, sources, density, group, tables, var_grids,
    specific_energy) of ``pkg``, float64 on the CPU."""
    F = frontend(pkg)
    m = class2_model(pkg, 24, 8, 0)
    g = m.add_peeled_images(sed=not inside, image=inside)
    if inside:
        g.set_inside_observer((30.0 * F.au, 0.0, 0.0))
        g.set_viewing_angles([90.0], [180.0])
        g.set_image_limits(60.0, -60.0, -40.0, 40.0)
        g.set_image_size(6, 4)
        g.set_wavelength_range(12, 1.0, 2000.0)
    else:
        g.set_viewing_angles([20.0, 45.0, 80.0], [0.0, 0.0, 0.0])
        g.set_aperture_radii(1, 400 * F.au, 400 * F.au)
        g.set_wavelength_range(120, 0.3, 2000.0)
    m.evaluate_optically_thin_radii()
    mm = m.to_model()
    grid = mm.grid
    r = 0.5 * (grid.r_wall[1:] + grid.r_wall[:-1])
    temp = np.broadcast_to(np.clip(300.0 * (r / F.au) ** -0.5, 10.0,
                                   1500.0)[None, None, :], grid.shape)
    dusts = mm._dust_objects()
    for d in dusts:
        # the LTE emissivities Model.write would tabulate (1,200 var rows)
        d._compute_mean_opacities()
        d.emissivities.set_lte(d.optical_properties, d.mean_opacities)
    se = np.array([d.temperature2specific_energy(temp).reshape(-1)
                   for d in dusts])
    conf = mm.peeled_output[0]
    if pkg == 'jax':
        from hyperion_tpu.model import run as jrun
        from hyperion_tpu.transport.stable import build_source_tables
        geo = jrun.build_geometry_tables(grid, jnp.float64)
        L = geo.length_scale
        st = build_source_tables(mm.sources, dtype=jnp.float64,
                                 length_scale=L, grid=grid)
        rho = jrun._density_array(mm, jnp.float64, L)
        group = j_peel_group(conf, jnp.float64, length_scale=L)
        tables, vg, _ = jrt.build_raytrace_tables(
            dusts, mm.sources, None, st, group, se, rho, geo.volumes,
            jnp.float64, length_scale=L)
        return mm, geo, st, rho, group, tables, vg, J(se)
    from hyperion_tpu_torch.model import run as prun
    from hyperion_tpu_torch.transport.stable import build_source_tables
    geo = prun.build_geometry_tables(grid, CPU, torch.float64)
    L = geo.length_scale
    st = build_source_tables(mm.sources, CPU, torch.float64, length_scale=L)
    rho = prun._density_array(mm, L, CPU, torch.float64)
    group = build_peel_group(conf, CPU, torch.float64, length_scale=L)
    tables, vg, _ = rt.build_raytrace_tables(
        dusts, mm.sources, group, se, rho, geo.volumes, CPU, torch.float64,
        length_scale=L)
    return mm, geo, st, rho, group, tables, vg, torch.as_tensor(se)


@pytest.mark.parametrize('inside', [False, True], ids=['views', 'inside'])
def test_class2_raytracing_pass_matches_jax(inside, monkeypatch):
    """The whole raytracing pass on the class2 YSO (the spherical star and
    its surface's peel weight, the thick disk's thermal emission on the
    default dust's emissivities, 24 x 8 cells), each package's
    ``run_raytracing`` fed the same uniforms: the port's draws replaced by
    the JAX package's, batch by batch down its key chain. Source and dust
    batches, the last of each partial: the summed cubes to rounding, and
    no photon outside the grid or its cell."""
    B, n_src, n_dust = 1024, 1500, 2500
    key = jax.random.PRNGKey(5)
    _, jgeo, jst, jrho, jg, jt, jvg, jse = _class2_tables('jax', inside)
    (sed,), (img,) = jrt.run_raytracing(
        jgeo, None, jst, jt, jvg, [jg], jrho, key, n_src, n_dust, B,
        jnp.float64, specific_energy=jse)
    _, pgeo, pst, prho, pg, pt, pvg, pse = _class2_tables('port', inside)
    draws = JaxDraws(key, B, n_src, n_dust)
    monkeypatch.setattr(rt, 'torch', draws)
    walk = et.EscapeTau(pgeo, prho.T.contiguous())
    (psed,), (pimg,), stats = rt.run_raytracing(
        walk, pgeo, pst, pt, pvg, [pg], pse, None, n_src, n_dust, B)
    assert not draws.draws and stats == dict(batches=5, outside=0)
    for got, ref, on in ((psed, sed, pg.compute_sed),
                         (pimg, img, pg.compute_image)):
        ref = np.asarray(ref)
        assert (ref > 0).mean() > 0.3 if on else (ref == 0).all()
        np.testing.assert_allclose(got, ref, rtol=1e-9,
                                   atol=1e-12 * np.abs(ref).max())


def test_photons_outside_the_grid_are_counted():
    """Source photons emitted outside the grid peel nothing and are
    counted in ``outside``; thermal photons inside their cells are not."""
    pgeo = _geometries('cartesian')[1]
    F = frontend('port')
    from hyperion_tpu_torch.transport.stable import build_source_tables
    s = F.PointSource()
    s.luminosity, s.temperature = F.lsun, 5000.0
    s.position = (1e3, 0.0, 0.0)
    st = build_source_tables([s], CPU, torch.float64)
    g = F.Model().add_peeled_images(sed=True, image=False)
    g.set_viewing_angles([30.0], [10.0])
    g.set_wavelength_range(5, 0.2, 500.0)
    pg = build_peel_group(g, CPU, torch.float64)
    rho = _densities(1, pgeo.n_cells, 3)
    se = np.full((1, pgeo.n_cells), 1e2)
    dusts, _, _ = _table_inputs('port')
    tables, vg, _ = rt.build_raytrace_tables(
        dusts[:1], [s], pg, se, rho, pgeo.volumes, CPU, torch.float64)
    gen = torch.Generator().manual_seed(3)
    sed, _, stats = rt.run_raytracing(
        et.EscapeTau(pgeo, torch.as_tensor(rho.T.copy())), pgeo, st, tables,
        vg, [pg], torch.as_tensor(se), gen, 300, 0, 128)
    assert stats == dict(batches=3, outside=300) and (sed[0] == 0).all()
    sed, _, stats = rt.run_raytracing(
        et.EscapeTau(pgeo, torch.as_tensor(rho.T.copy())), pgeo, st, tables,
        vg, [pg], torch.as_tensor(se), gen, 0, 300, 128)
    assert stats == dict(batches=3, outside=0) and sed[0].sum() > 0


# ------------------------------------------------------------- whole runs --

def _point_model(pkg, mono, thermal=False):
    """A point source off the walls of 8^3 cells of dust of albedo 0 (no
    scattered light) seen at two views, an SED and a 9 x 9 image,
    raytracing sources only; with ``mono`` at three exact wavelengths.
    ``thermal``: albedo 0.3, a given specific energy (a 300 K (r / 3
    au)^-0.5 profile, no Lucy iteration), 2,000 imaging photons (scattered
    light only) and 20,000 raytraced dust photons: the same shapes, so that
    the JAX package compiles its imaging step once for both."""
    F = frontend(pkg)
    nu = np.logspace(5, 18, 30)
    m = F.Model()
    lim = 3 * F.au
    w = np.linspace(-lim, lim, 9)
    m.set_cartesian_grid(w, w, w)
    dust = F.IsotropicDust(nu, np.repeat(0.3 if thermal else 0.0, 30),
                           np.geomspace(20.0, 0.2, 30))
    se = None
    if thermal:
        c = 0.5 * (w[1:] + w[:-1])
        r = np.sqrt(sum(a ** 2 for a in np.meshgrid(c, c, c, indexing='ij')))
        se = dust.temperature2specific_energy(300.0 * (r / lim) ** -0.5)
    m.add_density_grid(np.full(m.grid.shape, 1e-15), dust,
                       specific_energy=se)
    s = m.add_point_source()
    s.luminosity, s.temperature = F.lsun, 6000.0
    s.position = (0.1 * F.au, 0.2 * F.au, -0.3 * F.au)
    g = m.add_peeled_images(sed=True, image=True)
    g.set_viewing_angles([30.0, 70.0], [0.0, 45.0])
    g.set_image_size(9, 9)
    g.set_image_limits(-lim, lim, -lim, lim)
    g.set_uncertainties(True)
    if mono:
        m.set_monochromatic(True, wavelengths=[0.3, 1.0, 3.0])
        g.set_wavelength_index_range(0, 2)
        m.set_n_photons(initial=0, imaging_sources=0, imaging_dust=0,
                        raytracing_sources=1000, raytracing_dust=0)
    else:
        g.set_wavelength_range(20, 0.1, 100.0)
        # (imaging photons that absorb and never scatter peel nothing)
        m.set_n_photons(initial=0, imaging=2000 if thermal else 100,
                        raytracing_sources=1000,
                        raytracing_dust=20000 if thermal else 0)
    m.set_raytracing(True)
    m.set_n_initial_iterations(0)
    return m


def _run_both(make, tmp_path, name, batch_size=512):
    """Run ``make(pkg)`` through both packages; the two files read by both
    ModelOutputs: {(writer, reader): ModelOutput}."""
    out = {}
    for pkg in ('jax', 'port'):
        m = make(pkg)
        m.write(str(tmp_path / ('%s_%s.rtin' % (name, pkg))))
        path = str(tmp_path / ('%s_%s.rtout' % (name, pkg)))
        if pkg == 'jax':
            j_run_model(m, path, batch_size=batch_size)
        else:
            run_model(m, path, device='cpu', batch_size=batch_size)
        for reader in ('jax', 'port'):
            out[pkg, reader] = frontend(reader).ModelOutput(path)
    return out


@pytest.mark.parametrize('mono', [False, True], ids=['binned', 'mono'])
def test_point_source_raytracing_equals_jax(mono, tmp_path):
    """Every raytraced photon of a point source gives the same
    contribution, so the SEDs and images equal the JAX package's to 1e-9
    whatever the random streams."""
    outs = _run_both(lambda pkg: _point_model(pkg, mono), tmp_path,
                     'point%d' % mono)
    for reader in ('jax', 'port'):
        j, p = outs['jax', reader], outs['port', reader]
        for inc in (0, 1):
            sj = j.get_sed(inclination=inc, aperture=-1)
            sp = p.get_sed(inclination=inc, aperture=-1)
            np.testing.assert_allclose(sp.nu, sj.nu, rtol=1e-14)
            assert (sj.val > 0).sum() >= 3
            np.testing.assert_allclose(sp.val, sj.val, rtol=1e-9, atol=0)
            ij = j.get_image(inclination=inc).val
            ip = p.get_image(inclination=inc).val
            np.testing.assert_allclose(ip, ij, rtol=1e-9,
                                       atol=1e-12 * ij.max())


def _noise_close(outs, n_sigma, rtol):
    """The port's SED against the JAX package's at every view and
    wavelength within n_sigma of both runs' Monte-Carlo uncertainty plus
    rtol of the larger, for the raytraced part's sampling noise, which the
    uncertainties do not hold (the dust photons sample cells by luminosity,
    so few come from the cool cells that make the longest wavelengths),
    plus 1e-6 of the view's brightest bin: light attenuated by tens of
    optical depths (a star behind a disk) comes from a few rays."""
    for reader in ('jax', 'port'):
        j, p = outs['jax', reader], outs['port', reader]
        n_inc = len(j.get_sed(inclination='all', aperture=-1).val)
        for inc in range(n_inc):
            sj = j.get_sed(inclination=inc, aperture=-1, uncertainties=True)
            sp = p.get_sed(inclination=inc, aperture=-1, uncertainties=True)
            assert np.isfinite(sp.val).all() and (sp.val >= 0).all()
            assert (sp.val > 0).sum() > 0.8 * len(sp.val)
            tol = n_sigma * np.hypot(sj.unc, sp.unc) + \
                rtol * np.maximum(sj.val, sp.val) + 1e-6 * sj.val.max()
            assert (np.abs(sp.val - sj.val) <= tol).all(), \
                (inc, sp.val / sj.val)


def test_thermal_raytracing_within_noise_of_jax(tmp_path):
    _noise_close(_run_both(lambda pkg: _point_model(pkg, False, True),
                           tmp_path, 'thermal'), 5.0, 0.05)
