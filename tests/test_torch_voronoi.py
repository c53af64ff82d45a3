"""The port's Voronoi grid against the JAX package's on the same seeded
inputs (JAX x64, torch float64 unless stated).

- The tables (sites, the padded neighbour table, volumes, bounding boxes,
  lattice, walk cap) equal the JAX tables to the bit, on a uniform mesh
  and on a clustered one (a Plummer sphere and clumps, as chip_smoke.py's
  config 4 particles), 2,000 sites each.
- ``find_cell`` equals the JAX function and scipy's nearest site on every
  point; ``find_wall``'s distance to rtol 1e-12 and its next cell equal
  on seeded rays from random points (none rides a bisector);
  ``closest_wall_distance`` to 1e-15 absolute and ``in_cell_tol`` equal.
- The plain owner walk after 1 to walk_steps steps equals the JAX
  ``_owner_walk`` with that many steps, on a lattice mesh whose points sit
  on faces, edges and corners between sites (ties among neighbours and
  with the current site).
- ``position_in_cell`` from the JAX package's own draws (``uniform(
  fold_in(key, t), (3, B))`` for trials 0-3) equals
  ``random_position_in_cell``, and every position is owned by its cell.
- The plain tau and column walks against JAX's ``escape_tau_walk`` and
  ``escape_column_walk`` at rtol 1e-12, and the chord oracle of
  tests/test_voronoi_transport.py (uniform density) at rtol 1e-6.
- The plain walk's count of the neighbours that face each ray (the work
  that the walk kernel's bound counts) against a count in numpy.
- The lattice oracle on the port alone: a Voronoi grid on the centres of
  an 8^3 lattice against the port's cartesian 8^3 grid, one Lucy iteration
  each (the totals within 0.02, the 95th percentile of |log10 ratio|
  below 0.08).
- A luminosity map on a Voronoi grid: its source tables equal the JAX
  package's, and every packet starts in a cell of the map, from the 12
  uniforms of a Voronoi position (N_EMIT_EXTRA rows and 9 more).
- One Lucy iteration through both packages' run_lucy on the very same
  tables (``convert.tables_from_numpy``), the 200-site model of
  tests/test_model_e2e_amr_voronoi.py: the specific energies within noise.
- ``Model.run(device='cpu')`` with a peeled SED, raytracing and a
  monochromatic wavelength on a Voronoi grid: nothing killed, and both
  packages' ModelOutput read the .rtout alike.
- The kernels on the card are held to these plain versions in
  tests/test_torch_voronoi_cuda.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from hyperion_tpu.grid import VoronoiGrid as JaxVoronoiGrid
from hyperion_tpu.transport.gtable_voronoi import \
    build_voronoi_geometry as j_geometry
from hyperion_tpu.transport.imaging import escape_tau_walk as j_tau_walk
from hyperion_tpu.transport.raytrace import \
    escape_column_walk as j_column_walk
from hyperion_tpu_torch.convert import tables_from_numpy
from hyperion_tpu_torch.grid import CartesianGrid, VoronoiGrid
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.escape_tau import (
    EscapeTau, escape_column_reference, escape_tau_reference)
from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
from hyperion_tpu_torch.transport.gtable_voronoi import (
    VoronoiGeometry, build_voronoi_geometry)
from hyperion_tpu_torch.transport.lucy import run_lucy
from hyperion_tpu_torch.transport.stable import build_source_tables
from hyperion_tpu_torch.transport.voronoi_locate import (
    VoronoiLocate, owner_walk_reference)
from test_torch_frontend import PACKAGES, frontend
from test_torch_voronoi_cuda import clustered, lattice_sites, walk_inputs

torch.set_num_threads(1)
CPU = torch.device('cpu')
F64 = torch.float64
RTOL = 1e-12


@functools.lru_cache(maxsize=None)
def mesh(kind, n=2000):
    """(port VoronoiGrid, JAX VoronoiGrid) of the same sites in [-1, 1]^3,
    tessellated once per test process."""
    if kind == 'uniform':
        pts = np.random.RandomState(42).uniform(-1, 1, (3, n))
    elif kind == 'clustered':
        pts = clustered(n, 5)
    else:
        pts = lattice_sites(n)[0]
    box = dict(xmin=-1., xmax=1., ymin=-1., ymax=1., zmin=-1., zmax=1.)
    grids = VoronoiGrid(*pts, **box), JaxVoronoiGrid(*pts, **box)
    for g in grids:
        g.sparse_neighbors
    return grids


@functools.lru_cache(maxsize=None)
def pair(kind, n=2000, precision=64):
    """(port geometry on the CPU, JAX geometry) of :func:`mesh`."""
    pg, jg = mesh(kind, n)
    return (build_voronoi_geometry(pg, CPU, F64 if precision == 64
                                   else torch.float32),
            j_geometry(jg, dtype=jnp.float64 if precision == 64
                       else jnp.float32))


def t(a, dtype=F64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def j(a, dtype=jnp.float64):
    return jnp.asarray(np.ascontiguousarray(a), dtype=dtype)


def rays(n, seed, lim=0.99):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-lim, lim, (3, n))
    k = rng.normal(size=(3, n))
    return pos, k / np.linalg.norm(k, axis=0)


@pytest.mark.parametrize('kind,precision', [('uniform', 64),
                                            ('clustered', 64),
                                            ('clustered', 32)])
def test_voronoi_tables_equal_jax(kind, precision):
    geo, jgeo = pair(kind, precision=precision)
    for f in ('sites', 'neigh', 'volumes', 'box_lo', 'box_hi', 'bbox_lo',
              'bbox_hi', 'lookup'):
        np.testing.assert_array_equal(getattr(geo, f).numpy(),
                                      np.asarray(getattr(jgeo, f)),
                                      err_msg=f)
    for f in ('lookup_n', 'walk_steps', 'n_sites', 'length_scale'):
        assert getattr(geo, f) == getattr(jgeo, f), f
    # the neighbours at the front of each row
    valid = geo.neigh.numpy() >= 0
    assert (valid[:, :-1] >= valid[:, 1:]).all()


@pytest.mark.parametrize('kind', ['uniform', 'clustered'])
def test_voronoi_geometry_matches_jax(kind):
    """find_cell against JAX and the nearest site; find_wall,
    closest_wall_distance and in_cell_tol against JAX."""
    from scipy.spatial import cKDTree
    geo, jgeo = pair(kind)
    pos, k = rays(6000, 1)
    if kind == 'clustered':
        # half of the points in the Plummer core
        pos[:, ::2] *= 0.1
    zero = np.zeros(pos.shape[1])
    cell = geo.find_cell(*t(pos), *t([zero, zero, zero + 1]))
    jcell = np.asarray(jgeo.find_cell(*j(pos), *j([zero, zero, zero + 1])))
    _, owner = cKDTree(geo.sites.numpy()).query(pos.T / geo.length_scale)
    np.testing.assert_array_equal(cell.numpy(), jcell)
    np.testing.assert_array_equal(cell.numpy(), owner)
    # outside the closed box: escaped
    out = geo.find_cell(*t([[1.5, 0.0], [0.0, -1.01], [0.0, 0.0]]),
                        *t([[0.0] * 2] * 3))
    assert (out.numpy() == -1).all()

    tw, nw, ax, wc = geo.find_wall(cell, *t(pos), *t(k))
    jt, jn, _, _ = jgeo.find_wall(j(jcell, jnp.int32), *j(pos), *j(k))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jt), rtol=RTOL, atol=0)
    np.testing.assert_array_equal(nw.numpy(), np.asarray(jn))
    assert (ax.numpy() == 0).all() and (wc.numpy() == tw.numpy()).all()
    assert (nw.numpy() == -1).any() and (nw.numpy() >= 0).any()
    d = geo.closest_wall_distance(cell, *t(pos)).numpy()
    jd = np.asarray(jgeo.closest_wall_distance(j(jcell, jnp.int32), *j(pos)))
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-15)
    assert (d > 0).all()
    # each point in its own cell, and tested against another cell
    inside = []
    for c in (jcell, np.roll(jcell, 1)):
        ok = geo.in_cell_tol(t(c, torch.int64), *t(pos)).numpy()
        jok = np.asarray(jgeo.in_cell_tol(j(c, jnp.int32), *j(pos)))
        np.testing.assert_array_equal(ok, jok)
        inside.append(ok.mean())
    assert inside[0] == 1.0 and inside[1] < 0.5


def test_owner_walk_step_by_step_with_ties():
    """The plain owner walk against JAX's ``_owner_walk`` after each number
    of steps, from random starts, on the 8^3 lattice mesh with points on
    the faces, edges and corners between sites (d2 ties among neighbours
    and with the current site) or anywhere. Every coordinate is a multiple
    of 2^-10, so each d2 is exact and a tie is a tie in either package
    (the JAX loop, compiled, may fuse a multiply-add where the port rounds
    twice)."""
    geo, jgeo = pair('lattice', 8)
    assert geo.length_scale == 1.0
    walls = np.linspace(-1.0, 1.0, 9)
    c = 0.5 * (walls[1:] + walls[:-1])
    rng = np.random.RandomState(3)
    n = 3000
    # each coordinate on a wall (a tie), at a centre, or anywhere
    choice = rng.randint(0, 3, (3, n))
    pick = np.where(choice == 0, rng.choice(walls[1:-1], (3, n)),
                    np.where(choice == 1, rng.choice(c, (3, n)),
                             rng.randint(-1000, 1001, (3, n)) / 1024.0))
    start = rng.randint(0, geo.n_cells, n)
    steps_needed = []
    for steps in range(1, jgeo.walk_steps + 1):
        jg = dataclasses.replace(jgeo, walk_steps=steps)
        want = np.asarray(jg._owner_walk(j(start, jnp.int32), *j(pick)))
        got, cap = owner_walk_reference(geo.sites, geo.neigh,
                                        t(start, torch.int64), *t(pick),
                                        steps)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=steps)
        steps_needed.append(int(cap.sum()))
    # most walks from far starts still moved at their first step's end
    assert steps_needed[0] > n // 2
    ties = (choice == 0).sum(axis=0) > 0
    assert ties.sum() > n // 2
    # the locate, its counter of lanes at the cap, and the owner
    loc = VoronoiLocate(geo)
    cell = loc.locate(*t(pick))
    np.testing.assert_array_equal(
        cell.numpy(), np.asarray(jgeo.find_cell(*j(pick), *j(pick))))
    assert loc.lanes_at_cap() == 0


def test_position_in_cell_from_jax_draws():
    """The port's positions from the JAX package's own uniforms of trials
    0-3 equal ``random_position_in_cell``'s, and each lies in its cell (the
    check of tests/test_voronoi_transport.py); the Voronoi grid's uniform
    rows through raytrace.sample_position_in_cell."""
    from hyperion_tpu_torch.transport.gtable import position_uniforms
    from hyperion_tpu_torch.transport.raytrace import sample_position_in_cell
    geo, jgeo = pair('clustered')
    cell = np.arange(geo.n_cells)
    key = jax.random.PRNGKey(0)
    jx = jgeo.random_position_in_cell(j(cell, jnp.int32), key, jnp.float64)
    u = np.concatenate([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, trial), (3, len(cell)), dtype=jnp.float64))
        for trial in range(4)])
    assert geo.POSITION_ROWS == u.shape[0] == 12
    px = sample_position_in_cell(geo, t(cell, torch.int64),
                                 position_uniforms(geo, t(u[:3]), t(u[3:])))
    for a, b in zip(px, jx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    owner = geo.find_cell(*px, *px)
    np.testing.assert_array_equal(owner.numpy(), cell)
    # most cells take a point of their box, not the site
    sites = geo.sites.numpy()
    moved = (np.stack([a.numpy() for a in px], axis=1) != sites).any(axis=1)
    assert moved.mean() > 0.5


@pytest.mark.parametrize('limited', [False, True],
                         ids=['to_edge', 'limited'])
def test_plain_walks_match_jax(limited):
    """The plain tau and column walks (the CPU path of EscapeTau) against
    the JAX package's loops on the same rays at rtol 1e-12."""
    geo, jgeo = pair('clustered')
    pos, k, cell, active, density, chi, t_max = walk_inputs(geo)
    rho_t = t(density.T)
    walk = EscapeTau(geo, rho_t)
    lanes = [t(a) for a in pos] + [t(a)[None] for a in k]
    tm = t(t_max)[None] if limited else None
    kw = dict(t_max=j(t_max)) if limited else {}
    tau = walk(t(chi), *lanes, t(cell, torch.int64), t(active, torch.bool),
               t_max=tm)[0].numpy()
    jtau = np.asarray(j_tau_walk(jgeo, j(density), j(chi), *j(pos), *j(k),
                                 j(cell, jnp.int32), j(active, bool), **kw))
    np.testing.assert_allclose(tau, jtau, rtol=RTOL, atol=0)
    col = walk.columns(*lanes, t(cell, torch.int64), t(active, torch.bool),
                       t_max=tm)[0].numpy()
    jcol = np.asarray(j_column_walk(jgeo, j(density), *j(pos), *j(k),
                                    j(cell, jnp.int32), j(active, bool),
                                    **kw))
    np.testing.assert_allclose(col, jcol, rtol=RTOL, atol=0)
    assert (tau[active] > 0).mean() > 0.9


def test_uniform_density_chord_oracle():
    """tests/test_voronoi_transport.py's oracle: on a uniform density, tau
    from each point to the box is chi rho times the chord (rtol 1e-6)."""
    geo, _ = pair('uniform')
    rho_phys, chi = 0.9, 1.1
    pos, k = rays(800, 3, 0.9)
    pos = pos / geo.length_scale
    cell = geo.find_cell(*t(pos), *t(k))
    assert (cell >= 0).all()
    rho_t = torch.full((geo.n_cells, 1), rho_phys * geo.length_scale,
                       dtype=F64)
    tau = escape_tau_reference(geo, rho_t, torch.full((800, 1), chi,
                                                      dtype=F64),
                               *t(pos), *(t(a)[None] for a in k), cell,
                               torch.ones(800, dtype=torch.bool))[0]
    half = 1.0 / geo.length_scale
    with np.errstate(divide='ignore'):
        ts = [np.where(k[a] > 0, (half - pos[a]) / k[a],
                       np.where(k[a] < 0, (-half - pos[a]) / k[a], np.inf))
              for a in range(3)]
    chord = np.min(ts, axis=0)
    np.testing.assert_allclose(tau.numpy(),
                               chi * rho_phys * geo.length_scale * chord,
                               rtol=1e-6)


def test_plain_walk_counts_facing_neighbours():
    """The plain walk's ``facing`` count (the work the walk kernel's bound
    counts): on one crossing, the neighbours s_j of each ray's cell with
    k . (s_j - s_i) > 0, counted in numpy; over whole walks, those of
    every crossing, about half of the neighbours read."""
    geo, _ = pair('uniform')
    pos, k = rays(500, 5, 0.9)
    pos = pos / geo.length_scale
    cell = geo.find_cell(*t(pos), *t(k))
    rho_t = torch.ones((geo.n_cells, 1), dtype=F64)
    on = torch.ones(500, dtype=torch.bool)
    sites, neigh = geo.sites.numpy(), geo.neigh.numpy()
    nb = neigh[cell.numpy()]
    nv = sites[np.where(nb >= 0, nb, 0)] - sites[cell.numpy()][:, None]
    denom = (k.T[:, None, :] * nv).sum(axis=-1)
    facing = torch.zeros((), dtype=torch.int64)
    escape_column_reference(geo, rho_t, *t(pos), *(t(a)[None] for a in k),
                            cell, on, max_steps=1, facing=facing)
    assert int(facing) == int(((nb >= 0) & (denom > 0)).sum())
    visits = torch.zeros(geo.n_cells, dtype=torch.int64)
    facing.zero_()
    escape_column_reference(geo, rho_t, *t(pos), *(t(a)[None] for a in k),
                            cell, on, visits=visits, facing=facing)
    read = int((visits * (geo.neigh >= 0).sum(dim=1)).sum())
    assert 0.4 < int(facing) / read < 0.6


def _carried_geometry():
    """The clustered mesh's JAX geometry carried into the port (the fields
    as convert.tables_from_numpy takes them)."""
    from hyperion_tpu_torch.convert import _build
    _, jgeo = pair('clustered')
    return _build(VoronoiGeometry, {f.name: np.asarray(getattr(jgeo, f.name))
                                    for f in dataclasses.fields(jgeo)},
                  CPU, F64)


@pytest.mark.parametrize('kind,precision', [
    ('uniform', 64), ('clustered', 64), ('clustered', 32), ('carried', 64)])
def test_packed_rows(kind, precision):
    """The packed rows that both kernels read, as kernel_tables and the
    locator bind them: each cell's degree the count of its row's entries
    before the first -1; the offsets the cumulative degrees; the entries of
    cell i neigh[i, :deg] in row order, each with its neighbour's offset
    and its site, to the bit, in the sites' type (float32 for the locate of
    float32 lanes); ROW_PAD zero entries after the last; the libraries'
    kRowPad equal to ROW_PAD, the chunk they read before a row's length is
    known within it. On a geometry carried across from the JAX package's
    tables too."""
    import re
    from pathlib import Path
    from hyperion_tpu_torch.transport import escape_tau as et
    from hyperion_tpu_torch.transport.voronoi_locate import (ROW_PAD,
                                                             locate_tables)
    geo = _carried_geometry() if kind == 'carried' else \
        pair(kind, precision=precision)[0]
    neigh, sites = geo.neigh.numpy(), geo.sites.numpy()
    n = geo.n_cells
    deg = np.array([np.argmin(np.append(row, -1) >= 0) for row in neigh])
    off = np.concatenate([[0], np.cumsum(deg)])
    ids = np.concatenate([row[:d] for row, d in zip(neigh, deg)])
    E = int(off[-1])
    kind5, walls, ints, sizes, *_ = et.kernel_tables(geo)
    tables = locate_tables(geo)
    assert kind5 == 5 and sizes == (n, 1, 1)
    ints = ints.numpy()
    at = (n + 2) & ~1
    meta = ints[at:].reshape(-1, 2)
    for got_off, got_meta, got_sites in ((ints[:n + 1], meta, walls[2]),
                                         (tables[3], tables[2], tables[1])):
        got_off, got_meta = np.asarray(got_off), np.asarray(got_meta)
        got_sites = got_sites.numpy()
        assert got_sites.dtype == sites.dtype
        np.testing.assert_array_equal(got_off, off)
        np.testing.assert_array_equal(np.diff(got_off),
                                      geo.packed_rows.degrees.numpy())
        assert got_meta.shape == (E + ROW_PAD, 2)
        assert got_sites.shape == (E + ROW_PAD, 3)
        np.testing.assert_array_equal(got_meta[:E, 0], ids)
        np.testing.assert_array_equal(got_meta[:E, 1], off[ids])
        assert got_sites[:E].tobytes() == sites[ids].tobytes()
        assert not got_meta[E:].any() and not got_sites[E:].any()
    assert (deg == (neigh >= 0).sum(axis=1)).all()
    for name, chunk in (('escape_tau', 'kVorChunk'),
                        ('voronoi_locate', 'kChunk')):
        src = (Path(et.__file__).parent / 'csrc' / (name + '.cu')).read_text()
        consts = dict(re.findall(r'constexpr int (k\w+) = (\d+);', src))
        assert int(consts['kRowPad']) == ROW_PAD
        assert int(consts[chunk]) <= ROW_PAD


# the skip rule of the walk kernel's Voronoi crossing (csrc/escape_tau.cu
# vor_cross), as the kernel states it: no division where numer >=
# fl(fl(t_best denom) (1 + 2^-50)) and fl(t_best denom) is a normal number
SKIP = 1.0 + 2.0 ** -50
DBL_MIN = float(np.finfo(np.float64).tiny)
DBL_MAX = float(np.finfo(np.float64).max)


def _skipped(numer, denom, t_best):
    with np.errstate(over='ignore', under='ignore'):
        prod = np.float64(t_best) * np.float64(denom)
        return bool(DBL_MIN <= prod <= DBL_MAX and
                    np.float64(numer) >= prod * np.float64(SKIP))


@st.composite
def _skip_cases(draw):
    """(numer, denom > 0, t_best): t_best 0, DBL_MAX / 8, tiny, or any in
    between; numer near t_best denom (up to 8 ulp either side, across the
    rule's margin of 2^-50), negative, or any."""
    denom = draw(st.one_of(
        st.floats(min_value=5e-324, max_value=1e-300),
        st.floats(min_value=1e-300, max_value=1e300),
        st.floats(min_value=1e-3, max_value=4.0)))
    t_best = draw(st.one_of(
        st.just(0.0), st.just(DBL_MAX / 8.0),
        st.floats(min_value=0.0, max_value=1e-300),
        st.floats(min_value=0.0, max_value=DBL_MAX / 8.0),
        st.floats(min_value=0.0, max_value=4.0)))
    with np.errstate(over='ignore', under='ignore'):
        exact = np.float64(t_best) * np.float64(denom)
    ulps = draw(st.integers(min_value=-8, max_value=8))
    near = exact
    for _ in range(abs(ulps)):
        near = np.nextafter(near, np.inf if ulps > 0 else -np.inf)
    numer = draw(st.one_of(
        st.just(float(near)),
        st.floats(max_value=0.0, allow_nan=False, allow_infinity=False),
        st.floats(allow_nan=False, allow_infinity=False)))
    return numer, denom, t_best


@settings(max_examples=1000, deadline=None, database=None)
@given(_skip_cases())
def test_division_skip_rule_never_drops_a_winner(case):
    """A neighbour that the walk kernel's Voronoi crossing skips without
    its division could not have become the best: its clamped quotient
    max(numer / denom, 0) is never below t_best."""
    numer, denom, t_best = case
    if _skipped(numer, denom, t_best):
        with np.errstate(over='ignore', under='ignore'):
            tn = np.float64(numer) / np.float64(denom)
        assert max(tn, 0.0) >= t_best


def test_division_skip_rule_spares_far_planes():
    """The skip rule spares the division of a plane clearly beyond the best
    and keeps it at near-ties, at t_best 0 and for a subnormal product."""
    assert _skipped(2.0, 1.0, 1.0)
    assert not _skipped(np.nextafter(1.0, 2.0), 1.0, 1.0)
    assert not _skipped(1.0, 1.0, 0.0)
    assert not _skipped(1.0, 1e-300, 1e-10)
    assert not _skipped(1.0, 1.0, DBL_MAX / 8.0)


def _gray_dust(F, chi=1.0):
    return F.IsotropicDust(np.logspace(5, 18, 16), np.repeat(0.4, 16),
                           np.repeat(chi, 16))


def test_lattice_matches_cartesian_engine():
    """The Voronoi grid on the centres of an 8^3 lattice has the cartesian
    8^3 grid's cells: one Lucy iteration of the port on each, the same
    absorbing medium and source, gives the same specific energy within
    Monte-Carlo noise (tests/test_voronoi_transport.py's tolerances)."""
    F = frontend('port')
    pts, walls = lattice_sites(8)
    vgrid, _ = mesh('lattice', 8)
    dt = build_dust_tables([_gray_dust(F)], CPU, F64)
    src = F.PointSource(luminosity=1.0, temperature=4000.0,
                        position=(0.07, -0.03, 0.02))
    fields = {}
    for name, geo in (
            ('vor', build_voronoi_geometry(vgrid, CPU, F64)),
            ('car', build_cartesian_geometry(CartesianGrid(walls, walls,
                                                           walls), CPU,
                                             F64))):
        st = build_source_tables([src], CPU, F64,
                                 length_scale=geo.length_scale)
        density = torch.full((1, geo.n_cells), 1.2 * geo.length_scale,
                             dtype=F64)
        gen = torch.Generator().manual_seed(3)
        res = run_lucy(geo, dt, st, density, gen, n_photons=60000,
                       n_iterations=1, batch_size=8192)
        assert res.killed_geo == 0 and res.killed_int == 0
        fields[name] = np.asarray(res.specific_energy[0])
    i, jj, kk = (np.clip(np.searchsorted(walls, p) - 1, 0, 7) for p in pts)
    vse = np.zeros(8 ** 3)
    vse[(kk * 8 + jj) * 8 + i] = fields['vor']
    cse = fields['car']
    assert (vse > 0).all() and (cse > 0).all()
    assert abs(vse.sum() / cse.sum() - 1) < 0.02
    assert np.percentile(np.abs(np.log10(vse / cse)), 95) < 0.08


def test_lucy_within_noise_of_jax():
    """One Lucy iteration of the 200-site model of
    tests/test_model_e2e_amr_voronoi.py through both packages' run_lucy on
    the very same tables (the JAX tables carried across by
    convert.tables_from_numpy): the specific energy of each cell within 5
    sigma of both runs' noise (its photon visits) plus 3%."""
    from hyperion_tpu.transport import (build_dust_tables as j_dust,
                                        build_source_tables as j_sources,
                                        run_lucy as j_run_lucy)
    from hyperion_tpu.util.constants import au, lsun
    lim = 3 * au
    rng = np.random.RandomState(11)
    n = 200
    pts = [rng.uniform(-lim, lim, n) for _ in range(3)]
    jgrid = JaxVoronoiGrid(*pts, xmin=-lim, xmax=lim, ymin=-lim, ymax=lim,
                           zmin=-lim, zmax=lim)
    jgeo = j_geometry(jgrid, dtype=jnp.float64)
    JF = frontend('jax')
    nu = np.logspace(5, 18, 30)
    dust = JF.IsotropicDust(nu, np.repeat(0.4, 30), np.repeat(2.0, 30))
    src = JF.PointSource(luminosity=lsun, temperature=6000.0)
    jdt = j_dust([dust], dtype=jnp.float64)
    jst = j_sources([src], dtype=jnp.float64,
                    length_scale=jgeo.length_scale)
    density = np.full((1, n), 1e-16 * jgeo.length_scale)
    n_photons = 20000
    jres = j_run_lucy(jgeo, jdt, jst, jnp.asarray(density),
                      jax.random.PRNGKey(7), n_photons=n_photons,
                      n_iterations=1, batch_size=4096, verbose=False)

    def fields(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    dt, st, geo = tables_from_numpy(
        {k: np.asarray(v) for k, v in jdt._asdict().items()},
        {k: np.asarray(v) for k, v in jst._asdict().items()},
        fields(jgeo), CPU, F64)
    assert geo.walk_steps == jgeo.walk_steps
    np.testing.assert_array_equal(geo.neigh.numpy(), np.asarray(jgeo.neigh))
    res = run_lucy(geo, dt, st, t(density), torch.Generator().manual_seed(7),
                   n_photons=n_photons, n_iterations=1, batch_size=4096)
    assert res.killed_geo == 0 and res.killed_int == 0
    assert jres.killed_geo == 0 and jres.killed_int == 0
    se_p, se_j = res.specific_energy[0], np.asarray(jres.specific_energy[0])
    n_p = np.asarray(res.n_photons_cell)
    n_j = np.asarray(jres.n_photons_cell)
    lit = (n_p > 30) & (n_j > 30)
    assert lit.sum() > 100
    rel = 1.0 / np.sqrt(np.minimum(n_p, n_j)[lit])
    ratio = se_p[lit] / se_j[lit]
    assert (np.abs(ratio - 1.0) < 5.0 * np.sqrt(2.0) * rel + 0.03).all()


def test_map_source_positions_in_voronoi_cells():
    """A luminosity map over 20 cells of a Voronoi grid: emit_packets
    draws stable.emit_extra_rows rows (N_EMIT_EXTRA and 9 more), and every
    packet starts inside a cell of the map, at a point of the cell (not
    its site) for most of them; the source tables equal the JAX
    package's."""
    from hyperion_tpu.transport.stable import build_source_tables as j_src
    from hyperion_tpu_torch.transport.stable import (N_EMIT_EXTRA,
                                                     emit_extra_rows,
                                                     emit_packets)
    from test_torch_tables import _assert_fields_equal
    geo, _ = pair('clustered')
    lit = np.arange(0, 2000, 100)
    tables = []
    for package in ('jax', 'port'):
        F = frontend(package)
        grid = mesh('clustered')[package == 'jax']
        s = F.MapSource(luminosity=F.lsun, temperature=4000.0)
        lum = np.zeros(grid.n_cells)
        lum[lit] = np.arange(1.0, 21.0)
        s.map = lum
        if package == 'jax':
            tables.append(j_src([s], dtype=jnp.float64, length_scale=1.0,
                                grid=grid))
        else:
            tables.append(build_source_tables([s], CPU, F64,
                                              length_scale=1.0, grid=grid))
    _assert_fields_equal(tables[1], tables[0])
    st = tables[1]
    n_rows = emit_extra_rows(st, geo)
    assert n_rows == N_EMIT_EXTRA + 9
    n = 4000
    u = torch.rand((4 + n_rows, n), generator=torch.Generator().manual_seed(2),
                   dtype=F64)
    new = emit_packets(st, u[0], u[1], u[2], u[3], u_extra=u[4:],
                       geometry=geo)
    cell = geo.find_cell(new['x'], new['y'], new['z'], new['kx'],
                         new['ky'], new['kz']).numpy()
    assert np.isin(cell, lit).all()
    at_site = (geo.sites.numpy()[cell] == np.stack(
        [new[c].numpy() for c in 'xyz'], axis=1)).all(axis=1)
    assert at_site.mean() < 0.5


def voronoi_model(package, n=300, n_photons=3000):
    """A point source in a clustered cloud on a Voronoi grid, gray dust at
    tau ~ 1, one Lucy iteration, then a peeled SED at two views and
    raytracing; ``monochromatic``: one wavelength instead."""
    F = frontend(package)
    scale = 50.0 * F.au
    pts = clustered(n, 9) * scale
    m = F.Model()
    m.set_voronoi_grid(*pts, xmin=-scale, xmax=scale, ymin=-scale,
                       ymax=scale, zmin=-scale, zmax=scale)
    r = np.sqrt((pts ** 2).sum(axis=0))
    m.add_density_grid(1e-17 / (1.0 + (r / (0.2 * scale)) ** 2),
                       _gray_dust(F, 2.0))
    s = m.add_point_source()
    s.luminosity, s.temperature = F.lsun, 6000.0
    s.position = (0.05 * scale, -0.02 * scale, 0.01 * scale)
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([0.0, 60.0], [0.0, 30.0])
    sed.set_wavelength_range(6, 0.3, 1000.0)
    m.set_n_initial_iterations(1)
    m.set_raytracing(True)
    m.set_n_photons(initial=n_photons, imaging=1500,
                    raytracing_sources=200, raytracing_dust=1500)
    m.set_seed(20261017)
    return m


def test_model_run_on_a_voronoi_grid(tmp_path):
    """The port's Model.run on the CPU on a Voronoi grid: a Lucy
    iteration, the imaging iteration's peeled SED and raytracing, nothing
    killed and no raytraced photon outside its cell; then the same model
    monochromatic at 100 um (source and dust photons, the dust photons at
    positions in their cells from 12 uniforms). Both packages'
    ModelOutput read each .rtout alike."""
    from hyperion_tpu_torch.model import run_lucy_model
    m = voronoi_model('port')
    m.write(str(tmp_path / 'v.rtin'))
    m.run(device='cpu', batch_size=1024)
    readers = [frontend(pkg).ModelOutput(str(tmp_path / 'v.rtout'))
               for pkg in PACKAGES]
    grids = [r.get_quantities() for r in readers]
    assert sorted(grids[0].quantities) == sorted(grids[1].quantities)
    a, b = (np.asarray(g['temperature'].array) for g in grids)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, m.grid.n_cells) and (a > 0).all()
    seds = [r.get_sed(inclination=1, aperture=-1).val for r in readers]
    np.testing.assert_array_equal(seds[0], seds[1])
    assert np.isfinite(seds[0]).all() and (seds[0] > 0).any()
    import h5py
    with h5py.File(str(tmp_path / 'v.rtout'), 'r') as f:
        assert f['iteration_00001'].attrs['killed_photons_geo'] == 0
        assert f['iteration_00001'].attrs['killed_photons_int'] == 0
        assert f.attrs['killed_photons_int_final'] == 0
        assert 'date_ended' in f.attrs

    # monochromatic from the specific energy found
    se = np.asarray(grids[0]['specific_energy'].array)[0]
    m.grid.quantities['specific_energy'] = [se]
    m.set_n_initial_iterations(0)
    m.set_monochromatic(True, wavelengths=[100.0])
    m.peeled_output[0].set_wavelength_index_range(0, 0)
    m.set_n_photons(initial=0, imaging_sources=500, imaging_dust=500,
                    raytracing_sources=100, raytracing_dust=1000)
    mono = run_lucy_model(m, device='cpu', batch_size=1024)
    assert mono.imaging.killed_int == 0
    assert mono.imaging.raytrace['outside'] == 0
    seds = mono.imaging.peeled[0]['datasets']['seds'][0]
    assert np.isfinite(seds).all() and (seds >= 0).all() and seds.sum() > 0
