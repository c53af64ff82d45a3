"""The imaging iteration's deterministic pieces against the JAX package's,
on the same inputs and uniforms (JAX x64, torch float64), to rounding: the
scattering-matrix dust tables (exactly), the per-lane row search, the
polarized scattering and peel of ``stokes.py``, the forced first
interaction, ``bin_escaped`` and ``peel_and_bin`` on groups covering SEDs
and images, three apertures, each track_origin mode, Stokes, filters, depth
cuts, an inside observer, ``ignore_optical_depth``, a stellar surface's
cosine law, and all three kinds of group in one event (one walk call). The
groups come from each package's own front end, and the port's builders
give the group the JAX one carries over
(``convert.peel_group_from_numpy``)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperion_tpu.transport import build_cartesian_geometry as j_geometry
from hyperion_tpu.transport import build_dust_tables as j_dust
from hyperion_tpu.transport import ffi as j_ffi
from hyperion_tpu.transport import imaging as j_img
from hyperion_tpu.transport import stokes as j_stokes
from hyperion_tpu.transport.sampling import searchsorted_rows as j_rows
from hyperion_tpu_torch.convert import peel_group_from_numpy
from hyperion_tpu_torch.transport import ffi, stokes
from hyperion_tpu_torch.transport import imaging as img
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.escape_tau import EscapeTau
from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
from hyperion_tpu_torch.transport.sampling import searchsorted_rows
from test_torch_frontend import frontend
from test_torch_tables import _assert_fields_equal

torch.set_num_threads(1)
CPU = torch.device('cpu')
F64 = torch.float64
RTOL = 1e-10


def _hg_dust(package, n_nu=40):
    """examples/class2_sed.py's HG dust with a linear polarization of 0.8,
    on fewer frequencies."""
    nu = np.logspace(8, 17, n_nu)
    return frontend(package).HenyeyGreensteinDust(
        nu, np.linspace(0.3, 0.7, n_nu), np.geomspace(50.0, 500.0, n_nu),
        np.linspace(0.2, 0.6, n_nu), np.repeat(0.8, n_nu))


def _iso_dust(package, n_nu=24):
    nu = np.logspace(8.5, 17, n_nu)
    return frontend(package).IsotropicDust(nu, np.repeat(0.4, n_nu),
                                           np.geomspace(20.0, 300.0, n_nu))


def _dusts(package):
    # both with the default LTE emissivities: the JAX builder fails on two
    # dusts of unequal emissivity grids (ROADMAP.md section 3)
    return [_hg_dust(package), _iso_dust(package)]


@pytest.fixture(scope='module')
def tables():
    return (j_dust(_dusts('jax'), dtype=jnp.float64),
            build_dust_tables(_dusts('port'), CPU, F64))


def t(a):
    return torch.as_tensor(np.array(a))


def _close(mine, ref, rtol=RTOL, atol=1e-14):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize('make', [
    lambda pkg: [_hg_dust(pkg)],
    lambda pkg: [_hg_dust(pkg), _iso_dust(pkg)],
    lambda pkg: [_iso_dust(pkg), _hg_dust(pkg, 25)],
], ids=['hg', 'hg_then_iso', 'iso_then_hg'])
def test_scattering_tables_equal_jax(make):
    """mu, P1..P4_peel and the P1 and P2 cumulatives, padded alike."""
    _assert_fields_equal(build_dust_tables(make('port'), CPU, F64),
                         j_dust(make('jax'), dtype=jnp.float64))


@pytest.mark.parametrize('n_cols', [40, 300], ids=['short', 'long'])
def test_searchsorted_rows_matches_jax(n_cols):
    rng = np.random.default_rng(n_cols)
    table = np.sort(rng.uniform(0, 1, (3, n_cols)), axis=1)
    rows = rng.integers(0, 3, 4000)
    x = rng.uniform(-0.1, 1.1, 4000)
    x[:500] = table[rows[:500], rng.integers(0, n_cols, 500)]  # exact ties
    ref = np.asarray(j_rows(jnp.asarray(table), jnp.asarray(rows),
                            jnp.asarray(x)))
    mine = searchsorted_rows(t(table), t(rows), t(x)).numpy()
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(
        mine, [np.searchsorted(table[r], v, side='right')
               for r, v in zip(rows, x)])


def _lanes(n, seed, polarized=True):
    """Unit directions k, Stokes (q, u, v) with q^2 + u^2 + v^2 <= 1, and
    a few lanes along the poles."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(3, n))
    k[:, :20] = [[0.0], [0.0], [1.0]]
    k[:, 20:40] = [[0.0], [0.0], [-1.0]]
    k /= np.linalg.norm(k, axis=0)
    s = rng.normal(size=(3, n))
    s *= rng.uniform(0, 1, n) / np.linalg.norm(s, axis=0)
    if not polarized:
        s[:] = 0.0
    return rng, k, s


def test_meridian_frame_matches_jax():
    _, k, _ = _lanes(2000, 1)
    ref = j_stokes.meridian_frame(*[jnp.asarray(a) for a in k])
    mine = stokes.meridian_frame(*[t(a) for a in k])
    for r3, m3 in zip(ref, mine):
        for r, m in zip(r3, m3):
            _close(m.numpy() if isinstance(m, torch.Tensor) else m, r)


@pytest.mark.parametrize('polarized', [False, True], ids=['I', 'IQUV'])
def test_sample_scatter_stokes_matches_jax(tables, polarized):
    jt, pt = tables
    rng, k, s = _lanes(3000, 2, polarized)
    nu = 10.0 ** rng.uniform(9.0, 16.5, k.shape[1])
    dust = rng.integers(0, 2, k.shape[1])
    key = jax.random.PRNGKey(5)
    ref = j_stokes.sample_scatter_stokes(
        jt, jnp.asarray(dust), jnp.asarray(nu), key,
        *[jnp.asarray(a) for a in k], *[jnp.asarray(a) for a in s])
    # the JAX function's own uniforms: phi from k_phi, the angle from k_mu
    k_phi, k_mu = jax.random.split(key)
    u_phi = np.asarray(jax.random.uniform(k_phi, nu.shape, dtype=jnp.float64))
    u_mu = np.asarray(jax.random.uniform(k_mu, nu.shape, dtype=jnp.float64))
    mine = stokes.sample_scatter_stokes(pt, t(dust), t(nu), t(u_phi),
                                        t(u_mu), *[t(a) for a in k],
                                        *[t(a) for a in s])
    for m, r in zip(mine, ref):
        _close(m.numpy(), r, atol=1e-12)
    # unit directions, and |P| <= 1
    n = np.sqrt(sum(m.numpy() ** 2 for m in mine[:3]))
    _close(n, np.ones_like(n))
    assert (sum(m.numpy() ** 2 for m in mine[3:]) <= 1 + 1e-9).all()


def test_peel_scatter_stokes_matches_jax(tables):
    jt, pt = tables
    rng, k, s = _lanes(3000, 3)
    _, r, _ = _lanes(3000, 4)
    r[:, 40:60] = k[:, 40:60]            # forward peels
    r[:, 60:80] = -k[:, 60:80]           # backward peels
    nu = 10.0 ** rng.uniform(9.0, 16.5, k.shape[1])
    dust = rng.integers(0, 2, k.shape[1])
    ref = j_stokes.peel_scatter_stokes(
        jt, jnp.asarray(dust), jnp.asarray(nu), *[jnp.asarray(a) for a in k],
        *[jnp.asarray(a) for a in s], *[jnp.asarray(a) for a in r])
    mine = stokes.peel_scatter_stokes(pt, t(dust), t(nu), *[t(a) for a in k],
                                      *[t(a) for a in s], *[t(a) for a in r])
    for m, want in zip(mine, ref):
        _close(m.numpy(), want, atol=1e-12)
    # the unpolarized weight is the phase function
    j_p1 = j_img.eval_phase_peel(jt, jnp.asarray(dust), jnp.asarray(nu),
                                 jnp.asarray((k * r).sum(axis=0)))
    _close(stokes.eval_phase_peel(pt, t(dust), t(nu),
                                  t((k * r).sum(axis=0))).numpy(), j_p1)


def _tau_escape(n=4000):
    rng = np.random.default_rng(6)
    tau = 10.0 ** rng.uniform(-12, 2, n)
    tau[:50] = 0.0
    return tau


def test_wr99_and_baes16_match_jax():
    tau = _tau_escape()
    key = jax.random.PRNGKey(9)
    u = np.asarray(jax.random.uniform(key, tau.shape, dtype=jnp.float64))
    ref = j_ffi.forced_interaction_wr99(key, jnp.asarray(tau), jnp.float64)
    mine = ffi.forced_interaction_wr99(t(u), t(tau))
    for m, r in zip(mine, ref):
        _close(m.numpy(), r, atol=0)
    for xi in (0.0, 0.5, 1.0):
        ref = j_ffi.forced_interaction_baes16(key, jnp.asarray(tau), xi,
                                              jnp.float64)
        mine = ffi.forced_interaction_baes16(t(u), t(tau), xi)
        for m, r in zip(mine, ref):
            _close(m.numpy(), r, atol=0)
    # the drawn depth lies inside the escape depth
    assert (mine[0].numpy() <= tau * (1 + 1e-12)).all()


@pytest.mark.parametrize('algorithm', ['wr99', 'baes16'])
def test_sample_first_interaction_matches_jax(algorithm):
    tau = _tau_escape()
    applies = (tau > 1e-10) & (np.arange(tau.size) % 5 != 0)
    key = jax.random.PRNGKey(11)
    ref = j_ffi.sample_first_interaction(key, jnp.asarray(tau),
                                         jnp.asarray(applies), algorithm,
                                         0.5, jnp.float64)
    k_f, k_e = jax.random.split(key)
    u_f = np.asarray(jax.random.uniform(k_f, tau.shape, dtype=jnp.float64))
    u_e = np.asarray(jax.random.uniform(
        k_e, tau.shape, dtype=jnp.float64,
        minval=jnp.finfo(jnp.float64).tiny, maxval=1.0))
    mine = ffi.sample_first_interaction(t(u_f), t(u_e), t(tau), t(applies),
                                        algorithm, 0.5)
    for m, r in zip(mine, ref):
        _close(m.numpy(), r, atol=0)


# ------------------------------------------------------------ binning --

L = 2.0e14


def _grid(package):
    return frontend(package).CartesianGrid(
        np.linspace(-L, L, 7), np.linspace(-L, 0.5 * L, 6),
        np.concatenate([[-L], np.geomspace(0.05, 1.0, 4) * L]))


def _filters(conf):
    for i, (lo, hi) in enumerate(((1e13, 1e14), (3e14, 3e15))):
        f = conf.add_filter()
        f.name = 'f%d' % i
        f.nu = np.logspace(np.log10(lo), np.log10(hi), 30)
        f.transmission = np.hanning(32)[1:-1]
        f.central_nu = np.sqrt(lo * hi)
        f.alpha = -1.0
        f.detector_type = 'energy'


def _peeled_confs(package, case):
    """The peeled groups of one case, built by ``package``'s front end."""
    m = frontend(package).Model()
    lim = L

    def group(sed=True, image=True, angles=((30.0, 10.0), (120.0, 200.0))):
        c = m.add_peeled_images(sed=sed, image=image)
        c.set_viewing_angles([a[0] for a in angles], [a[1] for a in angles])
        c.set_wavelength_range(7, 0.1, 1000.0)
        if image:
            c.set_image_size(5, 4)
            c.set_image_limits(-lim, lim, -0.8 * lim, 0.8 * lim)
        if sed:
            c.set_aperture_radii(3, 0.1 * lim, 1.5 * lim)
        return c

    if case == 'sed_image_3ap':
        group().set_uncertainties(True)
    elif case == 'basic_stokes':
        c = group()
        c.set_stokes(True)
        c.set_track_origin('basic')
        c.set_uncertainties(True)
        g2 = group(image=False)                 # unpolarized beside it
        g2.set_peeloff_origin((0.1 * L, -0.2 * L, 0.05 * L))
    elif case == 'detailed':
        group().set_track_origin('detailed')
    elif case == 'scatterings':
        group().set_track_origin('scatterings', n_scat=2)
    elif case == 'filters':
        c = group(image=False)
        c.set_uncertainties(True)
        _filters(c)
        c.n_wav = 2
    elif case == 'depth':
        group().set_depth(-0.2 * L, 0.6 * L)
    elif case == 'inside':
        c = group(angles=((90.0, 0.0), (60.0, 45.0)))
        c.set_inside_observer((0.3 * L, -0.1 * L, 0.2 * L))
        c.set_image_limits(180.0, -180.0, -90.0, 90.0)
        c.set_aperture_radii(1, 0.0, np.inf)
        c.set_track_origin('basic')
    elif case == 'ignore_tau':
        group().set_ignore_optical_depth(True)
    elif case == 'surface':
        group().set_track_origin('basic')
    elif case == 'one_event':
        # one event's three kinds of sight in one walk: three outside
        # views, an inside observer, and a group that ignores the depth
        group(angles=((30.0, 10.0), (120.0, 200.0), (80.0, 45.0)))
        c = group(image=False, angles=((90.0, 0.0), (60.0, 45.0)))
        c.set_inside_observer((0.3 * L, -0.1 * L, 0.2 * L))
        c.set_aperture_radii(1, 0.0, np.inf)
        group(image=False).set_ignore_optical_depth(True)
    return m.peeled_output


def _state(n, seed=21):
    """A lane batch inside the grid: positions, directions, Stokes, peel
    fields and provenance."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-0.99, 0.99, n), rng.uniform(-0.99, 0.49, n),
                    rng.uniform(-0.99, 0.99, n)])
    _, k, s = _lanes(n, seed + 1)
    _, sn, _ = _lanes(n, seed + 2)
    return dict(
        pos=pos, k=k, s=s, surf_n=sn,
        nu=10.0 ** rng.uniform(11.0, 15.8, n),
        energy=rng.uniform(0.5, 2.0, n),
        is_scatter=rng.random(n) < 0.5, dust=rng.integers(0, 2, n),
        chi=rng.uniform(0.5, 3.0, (n, 2)),
        active=rng.random(n) < 0.85,
        surf=rng.random(n) < 0.5, limb=rng.random(n) < 0.5,
        prov=dict(scattered=rng.random(n) < 0.5,
                  reprocessed=rng.random(n) < 0.5,
                  source_id=rng.integers(0, 3, n),
                  dust_id=rng.integers(0, 2, n),
                  n_scat=rng.integers(0, 5, n)))


def _groups_both(confs_j, confs_p, builder_j, builder_p, L_eng):
    kw = dict(length_scale=L_eng, n_sources=3, n_dust=2)
    jg = [builder_j(c, dtype=jnp.float64, **kw) for c in confs_j]
    pg = [builder_p(c, CPU, F64, **kw) for c in confs_p]
    for j, p in zip(jg, pg):
        carried = peel_group_from_numpy(
            {f.name: getattr(j, f.name) for f in dataclasses.fields(j)},
            CPU, F64)
        for f in dataclasses.fields(p):
            if f.name.startswith('_'):
                continue
            mine, theirs = getattr(p, f.name), getattr(carried, f.name)
            if isinstance(mine, torch.Tensor):
                mine, theirs = mine.numpy(), theirs.numpy()
            np.testing.assert_array_equal(mine, theirs, err_msg=f.name)
    return jg, pg


def _assert_accums_equal(j_acc, p_acc, rtol=1e-9):
    cubes = p_acc.cubes()
    for name in ('sed', 'sed2', 'sedn', 'img', 'img2', 'imgn'):
        ref = np.asarray(getattr(j_acc, name))
        mine = cubes[name].numpy()
        assert mine.shape == ref.shape, name
        np.testing.assert_allclose(mine, ref, rtol=rtol,
                                   atol=1e-12 * max(np.abs(ref).max(), 1e-300),
                                   err_msg=name)


CASES = ['sed_image_3ap', 'basic_stokes', 'detailed', 'scatterings',
         'filters', 'depth', 'inside', 'ignore_tau', 'surface', 'one_event']


@pytest.mark.parametrize('case', CASES)
def test_peel_and_bin_matches_jax(tables, case):
    jt, pt = tables
    jgeo = j_geometry(_grid('jax'), dtype=jnp.float64)
    pgeo = build_cartesian_geometry(_grid('port'), CPU, F64)
    jg, pg = _groups_both(_peeled_confs('jax', case),
                          _peeled_confs('port', case), j_img.build_peel_group,
                          img.build_peel_group, jgeo.length_scale)
    n = 1500
    st = _state(n)
    pos = st['pos'] * pgeo.length_scale / jgeo.length_scale
    cell = np.asarray(jgeo.find_cell(*[jnp.asarray(a) for a in pos],
                                     *[jnp.asarray(a) for a in st['k']]))
    cell = cell.astype(np.int64)      # the port's cells are int64
    assert (cell >= 0).all()
    density = np.random.default_rng(8).uniform(0.0, 2.0, (2, pgeo.n_cells))
    surface = case == 'surface'

    J = jnp.asarray
    jprov = j_img.Provenance(**{k: J(v) for k, v in st['prov'].items()})
    j_sur = (J(st['surf']), *[J(a) for a in st['surf_n']], J(st['limb'])) \
        if surface else None
    j_acc = j_img.peel_and_bin(
        jgeo, jt, J(density), jg,
        [j_img.init_peel_accum(g, jnp.float64) for g in jg],
        *[J(a) for a in pos], J(st['chi']), J(cell), J(st['nu']),
        J(st['energy']), jnp.ones(n), J(st['is_scatter']), J(st['dust']),
        *[J(a) for a in st['k']], jprov, J(st['active']), jnp.float64,
        stokes_in=tuple(J(a) for a in st['s']), surface=j_sur)

    pprov = img.Provenance(**{k: t(v) for k, v in st['prov'].items()})
    p_sur = (t(st['surf']), *[t(a) for a in st['surf_n']], t(st['limb'])) \
        if surface else None
    p_acc = [img.PeelAccum(g, CPU, F64) for g in pg]
    walk = EscapeTau(pgeo, t(density.T.copy()))
    views = []        # the lines of sight of each walk call

    def walk_once(*args, **kw):
        views.append(args[4].shape[0])
        return walk(*args, **kw)

    img.peel_and_bin(
        walk_once, pt, pg, p_acc,
        *[t(a) for a in pos], t(st['chi']), t(cell), t(st['nu']),
        t(st['energy']), 1.0, t(st['is_scatter']), t(st['dust']),
        *[t(a) for a in st['k']], pprov, t(st['active']),
        stokes_in=tuple(t(a) for a in st['s']), surface=p_sur)
    for ja, pa in zip(j_acc, p_acc):
        _assert_accums_equal(ja, pa)
        assert pa.cubes()['sed'].sum() > 0 or not jg[0].compute_sed
    # one walk for the event: a line of sight per outside view, one per
    # inside observer
    walked = [g for g in pg if not g.ignore_optical_depth]
    assert views == ([sum(1 if g.inside else g.n_view for g in walked)]
                     if walked else [])


@pytest.mark.parametrize('case', ['sed_image_3ap', 'one_event',
                                  'ignore_tau'])
def test_peel_and_bin_walks_the_emission_rays(tables, case):
    """``extra``: the emission rays of a forced first interaction walk in
    the peel's own call. Their tau is a walk of its own (0 outside the
    mask), and the peel's cubes are those of a call without them."""
    _, pt = tables
    pgeo = build_cartesian_geometry(_grid('port'), CPU, F64)
    n = 1200
    st = _state(n, seed=41)
    pos = [t(a) for a in st['pos']]
    k = [t(a) for a in st['k']]
    cell = pgeo.find_cell(*pos, *k)
    density = t(np.random.default_rng(9).uniform(0.0, 2.0,
                                                 (pgeo.n_cells, 2)))
    walk = EscapeTau(pgeo, density)
    calls = []

    def counted(*args, **kw):
        calls.append(args[4].shape[0])
        return walk(*args, **kw)

    active = t(st['active'])
    # the forced lanes: most of the peeled ones, and some that do not peel
    forced = (active & t(np.arange(n) % 7 != 0)) | t(np.arange(n) % 11 == 0)
    accs = []
    for extra in (None, tuple(k) + (forced,)):
        groups = [img.build_peel_group(c, CPU, F64,
                                       length_scale=pgeo.length_scale,
                                       n_sources=3, n_dust=2)
                  for c in _peeled_confs('port', case)]
        accs.append([img.PeelAccum(g, CPU, F64) for g in groups])
        tau = img.peel_and_bin(
            counted, pt, groups, accs[-1], *pos, t(st['chi']), cell,
            t(st['nu']), t(st['energy']), 1.0, t(st['is_scatter']),
            t(st['dust']), *k,
            img.Provenance(**{a: t(v) for a, v in st['prov'].items()}),
            active, stokes_in=tuple(t(a) for a in st['s']), extra=extra)
    # one call each: the event's lines of sight, then those and the
    # emission rays
    n_rows = sum(1 if g.inside else g.n_view for g in groups
                 if not g.ignore_optical_depth)
    assert calls == ([n_rows] if n_rows else []) + [n_rows + 1]
    alone = walk(t(st['chi']), *pos, *[a[None] for a in k], cell,
                 forced)[0]
    np.testing.assert_array_equal(tau.numpy(), alone.numpy())
    assert (tau[forced] > 0).all() and (tau[~(forced | active)] == 0).all()
    for a, b in zip(*accs):
        for name, cube in a.cubes().items():
            np.testing.assert_array_equal(cube.numpy(),
                                          b.cubes()[name].numpy(), name)


@pytest.mark.parametrize('case', ['sed_basic', 'image_stokes'])
def test_bin_escaped_matches_jax(case):
    """Escaping photons binned by exit direction (ref
    images_binned.f90:57-95), same provenance and Stokes."""
    def conf(package):
        m = frontend(package).Model()
        c = m.add_binned_images(sed=case == 'sed_basic',
                                image=case == 'image_stokes')
        c.set_viewing_bins(4, 3)
        c.set_wavelength_range(9, 0.1, 1500.0)
        if case == 'sed_basic':
            c.set_aperture_radii(3, 0.1 * L, 2 * L)
            c.set_track_origin('basic')
            c.set_uncertainties(True)
        else:
            c.set_image_size(6, 5)
            c.set_image_limits(-L, L, -L, L)
            c.set_stokes(True)
        return c

    (jg,), (pg,) = _groups_both([conf('jax')], [conf('port')],
                                j_img.build_binned_group,
                                img.build_binned_group, L)
    n = 3000
    st = _state(n, seed=31)
    escaped = st['active']
    J = jnp.asarray
    j_acc = j_img.bin_escaped(
        jg, 4, 3, j_img.init_peel_accum(jg, jnp.float64),
        *[J(a) for a in st['pos']], *[J(a) for a in st['k']], J(st['nu']),
        J(st['energy']),
        j_img.Provenance(**{k: J(v) for k, v in st['prov'].items()}),
        J(escaped), jnp.float64, stokes_in=tuple(J(a) for a in st['s']))
    p_acc = img.PeelAccum(pg, CPU, F64)
    img.bin_escaped(
        pg, 4, 3, p_acc, *[t(a) for a in st['pos']], *[t(a) for a in st['k']],
        t(st['nu']), t(st['energy']),
        img.Provenance(**{k: t(v) for k, v in st['prov'].items()}),
        t(escaped), stokes_in=tuple(t(a) for a in st['s']))
    _assert_accums_equal(j_acc, p_acc)
    total = p_acc.cubes()['sed' if case == 'sed_basic' else 'img']
    assert total.sum() > 0
