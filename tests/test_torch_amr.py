"""The port's AMR geometry against the JAX package's on the same seeded
inputs (JAX x64, torch float64 unless stated), on the two-level fixture of
tests/test_amr_transport.py:18-33 and on a three-level grid of 8 fabs
whose fabs of one level share faces.

- The tables equal the JAX tables.
- On seeded rays, a third of them starting on cell walls, fab faces or
  cell corners, with directions along an axis, parallel to a face and
  along a diagonal: ``find_cell``, ``in_cell_tol`` and ``find_wall``'s next
  cell equal the JAX functions, its distance and ``closest_wall_distance``
  to rtol 1e-12.
- The fab searches of the kernel (the finest-first search,
  :func:`locate_finest_first` here, and the indexed locate of
  AMRGeometry.locate_indexed) equal the locate's argmax and the JAX
  package's find_cell on every point of those rays (and of rays on the
  index's bin edges) and of their wall probes, also on grids whose levels
  leave gaps and whose fabs of one level overlap.
- The uniform-density chord oracle of tests/test_amr_transport.py at rtol
  1e-8; the plain tau and column walks against JAX's ``escape_tau_walk``
  and ``escape_column_walk`` at rtol 1e-12.
- A float32 walk with no early escape: every ray leaves through the grid's
  outer faces.
- The zero-killed placements of tests/test_propagation.py through the
  port's run_lucy.
- A Lucy iteration with MRW and an imaging iteration with forced first
  interaction through both packages' run_model: specific energies and
  SEDs within 5 sigma of both runs' noise (plus 5% of the larger), the
  same .rtout layout (the per-fab level_*/grid_* datasets).
- The kernel's AMR crossing (``kKind = 4``) against the plain walk on the
  card (marked cuda, skipped here)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperion_tpu.transport.gtable_amr import build_amr_geometry as j_geometry
from hyperion_tpu.transport.imaging import escape_tau_walk as j_tau_walk
from hyperion_tpu.transport.raytrace import \
    escape_column_walk as j_column_walk
from hyperion_tpu_torch.grid import AMRGrid
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.escape_tau import (EscapeTau,
                                                     escape_column_reference,
                                                     escape_tau_reference)
from hyperion_tpu_torch.transport.gtable import ESCAPED
from hyperion_tpu_torch.transport.gtable_amr import build_amr_geometry
from hyperion_tpu_torch.transport.lucy import run_lucy
from hyperion_tpu_torch.transport.stable import build_source_tables
from test_torch_frontend import frontend
from test_torch_octree import assert_within_noise, cells_walked, run_both

torch.set_num_threads(1)
CPU = torch.device('cpu')
F64 = torch.float64
RTOL = 1e-12

# (level, bounds (x0, x1, y0, y1, z0, z1), cells (nx, ny, nz)) of each fab
TWO_LEVEL = [(0, (-1.0, 1.0) * 3, (8, 8, 8)),
             (1, (-0.5, 0.5) * 3, (8, 8, 8))]
THREE_LEVEL = [
    (0, (-1.0, 0.0, -1.0, 1.0, -1.0, 1.0), (4, 8, 8)),
    (0, (0.0, 1.0, -1.0, 1.0, -1.0, 1.0), (4, 8, 8)),
    (1, (-0.5, 0.0, -0.5, 0.0, -0.5, 0.5), (4, 4, 8)),
    (1, (0.0, 0.5, -0.5, 0.0, -0.5, 0.5), (4, 4, 8)),
    (1, (-0.5, 0.0, 0.0, 0.5, -0.5, 0.5), (4, 4, 8)),
    (1, (0.0, 0.5, 0.0, 0.5, -0.5, 0.5), (4, 4, 8)),
    (2, (-0.25, 0.25, -0.25, 0.25, -0.25, 0.0), (8, 8, 4)),
    (2, (-0.25, 0.25, -0.25, 0.25, 0.0, 0.25), (8, 8, 4))]
GRIDS = {'two_level': TWO_LEVEL, 'three_level': THREE_LEVEL}
# a level whose fabs leave a gap between them (and miss part of its box),
# with a finer fab inside one of them
GAPS = [(0, (-1.0, 1.0) * 3, (8, 8, 8)),
        (1, (-0.75, -0.25, -0.5, 0.5, -0.5, 0.5), (4, 8, 8)),
        (1, (0.25, 0.75, -0.5, 0.5, -0.5, 0.5), (4, 8, 8)),
        (2, (0.375, 0.625, -0.125, 0.125, -0.125, 0.125), (4, 4, 4))]
# two fabs of one level that overlap, with cells that do not line up: the
# first in index order holds the points they share
OVERLAP = [(0, (-1.0, 1.0) * 3, (8, 8, 8)),
           (1, (-0.5, 0.25, -0.5, 0.5, -0.5, 0.5), (6, 8, 8)),
           (1, (-0.25, 0.5, -0.5, 0.25, -0.375, 0.5), (5, 6, 7))]
LOCATE_GRIDS = dict(GRIDS, gaps=GAPS, overlap=OVERLAP)


def amr_grid(fabs, package='port', scale=1.0, density=None):
    """An AMRGrid of either package with the given fabs (lengths times
    ``scale``), and a density quantity ``density(x, y, z)`` of the cell
    centres when given."""
    if package == 'jax':
        from hyperion_tpu.grid import AMRGrid as Grid
    else:
        Grid = AMRGrid
    amr = Grid()
    for level, b, n in fabs:
        while len(amr.levels) <= level:
            amr.add_level()
        g = amr.levels[level].add_grid()
        g.xmin, g.xmax, g.ymin, g.ymax, g.zmin, g.zmax = \
            (v * scale for v in b)
        g.nx, g.ny, g.nz = n
        if density is not None:
            c = [g.xmin + (np.arange(m) + 0.5) * (hi - lo) / m
                 for lo, hi, m in ((g.xmin, g.xmax, g.nx),
                                   (g.ymin, g.ymax, g.ny),
                                   (g.zmin, g.zmax, g.nz))]
            z, y, x = np.meshgrid(c[2], c[1], c[0], indexing='ij')
            g.quantities['density'] = density(x, y, z)
    return amr


def _pair(name, dtype=64):
    jdt, tdt = (jnp.float64, F64) if dtype == 64 else \
        (jnp.float32, torch.float32)
    return (j_geometry(amr_grid(GRIDS[name], 'jax'), dtype=jdt),
            build_amr_geometry(amr_grid(GRIDS[name]), CPU, tdt))


def _walls(pg):
    """Every cell wall coordinate of every fab, per axis."""
    lo, dx, n = (a.numpy() for a in (pg.fab_lo, pg.fab_dx, pg.fab_n))
    return [np.unique(np.concatenate([lo[f, a] + np.arange(n[f, a] + 1) *
                                      dx[f, a] for f in range(len(lo))]))
            for a in range(3)]


def _bin_edges(pg):
    """Every bin edge of every level's lattice of the indexed locate
    (AMRGeometry.level_index), per axis."""
    floats, ints = pg.level_index()
    return [np.unique(np.concatenate([
        floats[li, a] + np.arange(ints[8 * li + a] + 1) / floats[li, 3 + a]
        for li in range(len(floats))])) for a in range(3)]


def _rays(pg, n=8000, seed=41, bins=False):
    """Positions (3, n) and unit directions (3, n) in engine units on the
    port's CPU float64 geometry: a third of the points with one coordinate
    on a cell wall of some fab (fab faces among them), a ninth at a
    corner of walls, the rest anywhere in [-1, 1]^3 of the grid; directions
    along an axis, parallel to a face (one component 0), along a diagonal,
    or any. With ``bins``, a fifth of the points then get one coordinate on
    a bin edge of the indexed locate's lattices, and a tenth all three."""
    rng = np.random.default_rng(seed)
    walls = _walls(pg)
    top = float(pg.fab_hi.max())
    pos = rng.uniform(-top, top, (3, n))
    kind = rng.integers(0, 9, n)
    axis = rng.integers(0, 3, n)
    for a in range(3):
        w = rng.choice(walls[a], n)
        pos[a] = np.where(((kind <= 2) & (axis == a)) | (kind == 3), w,
                          pos[a])
    if bins:
        on_bin = rng.integers(0, 10, n)
        for a, edges in enumerate(_bin_edges(pg)):
            e = rng.choice(edges, n)
            pos[a] = np.where(((on_bin <= 1) & (axis == a)) | (on_bin == 2),
                              e, pos[a])
    k = rng.normal(size=(3, n))
    style = rng.integers(0, 8, n)
    for a in range(3):
        along = np.zeros((3, 1))
        along[a] = 1.0
        sel = (style == 0) & (axis == a)
        k[:, sel] = along * rng.choice([-1.0, 1.0], sel.sum())
        k[a, (style == 1) & (axis == a)] = 0.0
    diag = style == 2
    k[:, diag] = rng.choice([-1.0, 1.0], (3, diag.sum()))
    k /= np.linalg.norm(k, axis=0)
    return pos, k


@pytest.mark.parametrize('name', sorted(GRIDS))
def test_amr_tables_equal_jax(name):
    jg, pg = _pair(name)
    for f in ('fab_lo', 'fab_hi', 'fab_n', 'fab_dx', 'fab_level',
              'fab_offset', 'volumes', 'min_dx'):
        np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert (pg.n_fabs, pg.n_cells, pg.length_scale) == \
        (jg.n_fabs, jg.n_cells, jg.length_scale)


@pytest.mark.parametrize('name', sorted(GRIDS))
def test_amr_geometry_matches_jax(name):
    """find_cell, find_wall (distance, next cell, axis, wall),
    closest_wall_distance and in_cell_tol on the same rays; decode inverts
    the flat index."""
    jg, pg = _pair(name)
    pos, k = _rays(pg)
    jpos, jk = [jnp.asarray(a) for a in pos], [jnp.asarray(a) for a in k]
    tpos, tk = [torch.as_tensor(a) for a in pos], [torch.as_tensor(a)
                                                   for a in k]
    cell_j = np.asarray(jg.find_cell(*jpos, *jk))
    cell_p = pg.find_cell(*tpos, *tk)
    np.testing.assert_array_equal(cell_p.numpy(), cell_j)
    inside = cell_j >= 0
    assert inside.sum() > 7000
    sel = np.where(inside)[0]
    args_j = [a[sel] for a in jpos] + [a[sel] for a in jk]
    args_p = [a[sel] for a in tpos] + [a[sel] for a in tk]
    cj, cp = jnp.asarray(cell_j[sel]), cell_p[sel]
    fab, i, j, kk = pg.decode(cp)
    nf = pg.fab_n.numpy()[fab.numpy()]
    flat = pg.fab_offset.numpy()[fab.numpy()] + \
        (kk.numpy() * nf[:, 1] + j.numpy()) * nf[:, 0] + i.numpy()
    np.testing.assert_array_equal(flat, cp.numpy())
    out_j = jg.find_wall(cj, *args_j)
    out_p = pg.find_wall(cp, *args_p)
    np.testing.assert_allclose(out_p[0].numpy(), np.asarray(out_j[0]),
                               rtol=RTOL, atol=0)
    for a, b in zip(out_p[1:], out_j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (out_p[1].numpy() < 0).sum() > 100
    np.testing.assert_allclose(
        pg.closest_wall_distance(cp, *args_p[:3]).numpy(),
        np.asarray(jg.closest_wall_distance(cj, *args_j[:3])), rtol=RTOL,
        atol=0)
    np.testing.assert_array_equal(
        pg.in_cell_tol(cp, *args_p[:3]).numpy(),
        np.asarray(jg.in_cell_tol(cj, *args_j[:3])))


def search_order(geo):
    """The fabs in the order of the finest-first search: levels from the
    finest down, each level's fabs in index order. The first fab in this
    order that holds a point is the one the locate's argmax picks (the
    highest level, and the first fab of it on a tie)."""
    level = geo.fab_level.cpu().numpy()
    return np.lexsort((np.arange(len(level)), -level)).astype(np.int32)


def locate_finest_first(geo, x, y, z, kx, ky, kz):
    """The plain version of a finest-first fab search: fabs in
    ``search_order(geo)``, each lane stopping at the first that holds it.
    Returns the flat cell ids (ESCAPED where no fab does)."""
    ix, okx = geo._axis_index(x, kx, 0)
    iy, oky = geo._axis_index(y, ky, 1)
    iz, okz = geo._axis_index(z, kz, 2)
    inside = okx & oky & okz
    cell = torch.full(x.shape, ESCAPED, dtype=torch.int64)
    done = torch.zeros(x.shape, dtype=torch.bool)
    nf = geo.fab_n.long()
    for f in search_order(geo).tolist():
        hit = inside[:, f] & ~done
        c = geo.fab_offset[f] + (iz[:, f].long() * nf[f, 1] +
                                 iy[:, f].long()) * nf[f, 0] + ix[:, f].long()
        cell = torch.where(hit, c, cell)
        done = done | hit
    return cell


def locate_indexed(geo, x, y, z, kx, ky, kz):
    """The plain version of the kernel's indexed locate."""
    return geo.locate_indexed(x, y, z, kx, ky, kz)


SEARCHES = {'finest_first': locate_finest_first, 'indexed': locate_indexed}


@pytest.mark.parametrize('name', sorted(LOCATE_GRIDS))
@pytest.mark.parametrize('search', sorted(SEARCHES))
def test_finest_first_search_equals_argmax(search, name):
    """The kernel's fab searches (the finest-first search over every fab,
    and the indexed locate: each level's lattice of bins from the finest
    level down) pick the locate's argmax cell on every point: the rays'
    starts, with the direction rule on walls, fab faces and bin edges, and
    their wall probes; and the JAX package's find_cell on the starts. On
    grids whose levels leave gaps and whose fabs of one level overlap."""
    fabs = LOCATE_GRIDS[name]
    pg = build_amr_geometry(amr_grid(fabs), CPU, F64)
    pos, k = _rays(pg, n=20000, seed=9, bins=True)
    t = [torch.as_tensor(a) for a in (*pos, *k)]
    ref = pg.find_cell(*t)
    np.testing.assert_array_equal(SEARCHES[search](pg, *t).numpy(),
                                  ref.numpy())
    jg = j_geometry(amr_grid(fabs, 'jax'), dtype=jnp.float64)
    np.testing.assert_array_equal(
        ref.numpy(), np.asarray(jg.find_cell(*[jnp.asarray(a)
                                               for a in (*pos, *k)])))
    # the probes half a finest cell past each crossed wall
    inside = ref >= 0
    assert inside.sum() > 15000
    tt, _, ax, wall = pg.find_wall(ref[inside], *[a[inside] for a in t])
    sgn = [torch.where(a[inside] > 0, 1.0, -1.0).double() for a in t[3:]]
    probe = [torch.where(ax == a, wall + 0.5 * pg.min_dx[a] * sgn[a],
                         t[a][inside] + tt * t[3 + a][inside])
             for a in range(3)]
    np.testing.assert_array_equal(
        SEARCHES[search](pg, *probe, *[a[inside] for a in t[3:]]).numpy(),
        pg.find_cell(*probe, *[a[inside] for a in t[3:]]).numpy())
    order = search_order(pg)
    levels = pg.fab_level.numpy()[order]
    assert (np.diff(levels) <= 0).all()


def test_kernel_tables_carry_the_level_index():
    """What EscapeTau binds on an AMR grid (escape_tau.kernel_tables): the
    levels' lattices as the fourth wall table, and the fabs' cell counts,
    offsets and the level index as one int32 table of 4 x fabs + 1 +
    index_len words (csrc/escape_tau.cu's ints_len)."""
    from hyperion_tpu_torch.transport.escape_tau import kernel_tables
    pg = build_amr_geometry(amr_grid(GAPS), CPU, F64)
    kind, walls, ints, sizes, aux, levels, index_len, _, _ = \
        kernel_tables(pg)
    floats, index = pg.level_index()
    assert (kind, aux, levels, index_len) == (4, 4, 3, len(index))
    assert sizes == (pg.n_cells, 1, 1)
    assert walls[3].dtype == F64 and walls[3].shape == (3, 8)
    np.testing.assert_array_equal(walls[3].numpy(), floats)
    assert ints.dtype == torch.int32 and len(ints) == 4 * aux + 1 + index_len
    np.testing.assert_array_equal(ints[4 * aux + 1:].numpy(), index)
    np.testing.assert_array_equal(ints[3 * aux:4 * aux + 1].numpy(),
                                  pg.fab_offset.numpy())


def test_level_index_tables():
    """The indexed locate's tables: on the three-level grid, whose levels
    each tile a box, one fab in every bin's core list, the levels from the
    finest down, each fringe list the level's fabs in index order; on the
    gap grid, empty core lists in the gap."""
    pg = build_amr_geometry(amr_grid(THREE_LEVEL), CPU, F64)
    floats, ints = pg.level_index()
    level = pg.fab_level.numpy()
    assert len(floats) == 3
    for li, lev in enumerate((2, 1, 0)):
        head = ints[8 * li:8 * li + 8]
        n_bins = int(np.prod(head[:3]))
        starts = ints[head[3]:head[3] + n_bins + 1]
        assert (np.diff(starts) == 1).all()
        assert ints[head[4]:head[5]].tolist() == \
            np.nonzero(level == lev)[0].tolist()
    pg = build_amr_geometry(amr_grid(GAPS), CPU, F64)
    floats, ints = pg.level_index()
    head = ints[8:16]          # level 1: two fabs with a gap between
    assert head[:3].tolist() == [3, 1, 1]
    starts = ints[head[3]:head[3] + 4]
    assert np.diff(starts).tolist() == [1, 0, 1]


def test_uniform_density_chord_oracle():
    """tests/test_amr_transport.py:test_amr_escape_tau on the port's plain
    walk, from the rays of :func:`_rays` too: tau = chi rho times the chord
    to the grid's faces, rtol 1e-8, whatever fabs the ray crosses."""
    _, pg = _pair('three_level')
    rng = np.random.RandomState(3)
    n = 1000
    pts = rng.uniform(-0.9, 0.9, (3, n)) / pg.length_scale
    dirs = rng.normal(size=(3, n))
    dirs /= np.linalg.norm(dirs, axis=0)
    more, kmore = _rays(pg, n=3000, seed=5)
    pts, dirs = np.hstack([pts, more]), np.hstack([dirs, kmore])
    t = [torch.as_tensor(a) for a in (*pts, *dirs)]
    cell = pg.find_cell(*t)
    inside = (cell >= 0).numpy()
    assert inside[:n].all() and inside.sum() > 3500
    density = np.full((pg.n_cells, 1), 0.7 * pg.length_scale)
    tau = escape_tau_reference(
        pg, torch.as_tensor(density), torch.full((pts.shape[1], 1), 1.3,
                                                 dtype=F64),
        *t[:3], *[a[None] for a in t[3:]], cell.clamp_min(0),
        torch.as_tensor(inside))[0].numpy()
    ts = []
    for a in range(3):
        with np.errstate(divide='ignore', invalid='ignore'):
            ts.append(np.where(dirs[a] > 0, (1.0 - pts[a]) / dirs[a],
                               np.where(dirs[a] < 0,
                                        (-1.0 - pts[a]) / dirs[a], np.inf)))
    chord = np.min(ts, axis=0)
    expected = 1.3 * 0.7 * pg.length_scale * chord
    np.testing.assert_allclose(tau[inside], expected[inside], rtol=1e-8,
                               atol=1e-12)


def _walk_inputs(pg, n=3000, n_dust=2, seed=43, generic=False):
    """Rays of :func:`_rays` (or with ``generic`` any points and
    directions) on the port's CPU float64 geometry, their cells, lanes and
    a density: made with the port alone (the card's machine has no h5py,
    which the JAX package's front end imports)."""
    rng = np.random.default_rng(seed + 1)
    if generic:
        pos = rng.uniform(-1.0, 1.0, (3, n)) * float(pg.fab_hi.max())
        k = rng.normal(size=(3, n))
        k /= np.linalg.norm(k, axis=0)
    else:
        pos, k = _rays(pg, n=n, seed=seed)
    cell = pg.find_cell(*[torch.as_tensor(a) for a in (*pos, *k)]).numpy()
    active = (cell >= 0) & (rng.random(n) < 0.9)
    density = rng.uniform(0.0, 3.0, (n_dust, pg.n_cells))
    density[:, rng.random(pg.n_cells) < 0.1] = 0.0
    chi = rng.uniform(0.5, 2.0, (n, n_dust))
    t_max = np.where(rng.random(n) < 0.3, rng.uniform(0.0, 1.0, n), np.inf)
    return pos, k, np.maximum(cell, 0), active, density, chi, t_max


@pytest.mark.parametrize('name,limited', [('two_level', False),
                                          ('three_level', True)])
def test_plain_walks_match_jax(name, limited):
    """The port's plain tau and column walks against JAX's
    ``escape_tau_walk`` and ``escape_column_walk`` on the same rays (any
    points and directions: on rays that ride a wall, the compiled JAX loop
    breaks ties by fused multiply-adds; the kernel test on the card keeps
    them), float64 to rtol 1e-12, with and without a distance limit."""
    jg, pg = _pair(name)
    pos, k, cell, active, density, chi, t_max = _walk_inputs(pg,
                                                             generic=True)
    assert active.sum() > 2400
    tm = t_max if limited else None
    jargs = [jnp.asarray(a) for a in (*pos, *k)]
    tau_j = np.asarray(j_tau_walk(
        jg, jnp.asarray(density), jnp.asarray(chi), *jargs,
        jnp.asarray(cell), jnp.asarray(active),
        t_max=None if tm is None else jnp.asarray(tm)))
    col_j = np.asarray(j_column_walk(
        jg, jnp.asarray(density), *jargs, jnp.asarray(cell),
        jnp.asarray(active), t_max=None if tm is None else jnp.asarray(tm)))
    t = [torch.as_tensor(a) for a in (*pos, *k)]
    rho_t = torch.as_tensor(density.T.copy())
    lanes = dict(cell=torch.as_tensor(cell), active=torch.as_tensor(active),
                 t_max=None if tm is None else torch.as_tensor(tm)[None])
    tau_p = escape_tau_reference(pg, rho_t, torch.as_tensor(chi), *t[:3],
                                 *[a[None] for a in t[3:]], **lanes)[0]
    col_p = escape_column_reference(pg, rho_t, *t[:3],
                                    *[a[None] for a in t[3:]], **lanes)[0]
    assert (tau_j > 0).sum() > 2000
    np.testing.assert_allclose(tau_p.numpy(), tau_j, rtol=RTOL, atol=0)
    np.testing.assert_allclose(col_p.numpy(), col_j, rtol=RTOL, atol=0)


@pytest.mark.parametrize('name,limited', [('two_level', False),
                                          ('three_level', True)])
def test_reference_visits_count_the_cells_walked(name, limited):
    """The plain walks' ``visits`` (what chip_smoke.py's bounds count the
    locates from): each crossing adds one at the cell it walks through,
    the same in the tau and the column walk, as many as the crossings."""
    _, pg = _pair(name)
    pos, k, cell, active, density, chi, t_max = _walk_inputs(pg, n=600)
    t = [torch.as_tensor(a) for a in (*pos, *k)]
    rho_t = torch.as_tensor(density.T.copy())
    tm = torch.as_tensor(t_max) if limited else None
    lanes = dict(cell=torch.as_tensor(cell), active=torch.as_tensor(active),
                 t_max=None if tm is None else tm[None])
    v_tau = torch.zeros(pg.n_cells, dtype=torch.int64)
    v_col = torch.zeros(pg.n_cells, dtype=torch.int64)
    _, n_cross = escape_tau_reference(
        pg, rho_t, torch.as_tensor(chi), *t[:3], *[a[None] for a in t[3:]],
        **lanes, crossings=True, visits=v_tau)
    escape_column_reference(pg, rho_t, *t[:3], *[a[None] for a in t[3:]],
                            **lanes, visits=v_col)
    ref = cells_walked(pg, *t, torch.as_tensor(cell),
                       torch.as_tensor(active), tm)
    assert int(v_tau.sum()) == int(n_cross.sum()) > 600
    np.testing.assert_array_equal(v_tau.numpy(), ref.numpy())
    np.testing.assert_array_equal(v_col.numpy(), ref.numpy())


def test_float32_walk_has_no_early_escape():
    """On the three-level grid in float32, 20,000 rays from anywhere in
    the grid walk with the port's find_wall and snap: every ray ends within
    500 crossings, through the grid's outer faces (never by a probe that
    finds its own cell or no fab inside the grid)."""
    _, pg = _pair('three_level', dtype=32)
    n = 20000
    pos, k = _rays(build_amr_geometry(amr_grid(THREE_LEVEL), CPU, F64), n=n,
                   seed=12)
    x, y, z = (torch.as_tensor(a.astype(np.float32)) for a in pos)
    kx, ky, kz = (torch.as_tensor(a.astype(np.float32)) for a in k)
    cell = pg.find_cell(x, y, z, kx, ky, kz)
    active = cell >= 0
    assert active.sum() > 18000
    crossings = 0
    for _ in range(500):
        t, nxt, ax, wall = pg.find_wall(cell.clamp_min(0), x, y, z, kx, ky,
                                        kz)
        crossings += int(active.sum())
        x, y, z = pg.snap(x + t * kx, y + t * ky, z + t * kz, ax, wall,
                          active)
        cell = torch.where(active, nxt, cell)
        active = active & (cell >= 0)
        if not active.any():
            break
    assert not active.any() and crossings > 100000
    edge = torch.stack([x, y, z]).abs().max(dim=0).values
    np.testing.assert_allclose(edge.numpy()[(cell < 0).numpy()], 1.0,
                               rtol=0, atol=1e-6)


AMR_POSITIONS = [
    (0.0, 0.0, 0.0),           # a corner of fabs of every level
    (0.5, 0.5, 0.5),           # the corner of the fine fab
    (0.25, 0.0, -0.1),         # on the finest fabs' face
    (0.3, 0.21, -0.47),        # generic
]


@pytest.mark.parametrize('position', AMR_POSITIONS)
def test_amr_robustness(position):
    """tests/test_propagation.py's zero-killed placements on the
    three-level grid through the port's run_lucy with the geometry
    self-check on: no photon killed."""
    P = frontend('port')
    geo = build_amr_geometry(amr_grid(THREE_LEVEL), CPU, F64)
    dust = P.IsotropicDust(np.logspace(5, 18, 16), np.repeat(0.5, 16),
                           np.repeat(1.0, 16))
    dt = build_dust_tables([dust], CPU, F64)
    src = P.PointSource(luminosity=1.0, temperature=5000.0,
                        position=position)
    st = build_source_tables([src], CPU, F64, length_scale=geo.length_scale)
    density = torch.full((1, geo.n_cells), 0.5 * geo.length_scale,
                         dtype=F64)
    res = run_lucy(geo, dt, st, density, torch.Generator().manual_seed(0),
                   n_photons=10000, n_iterations=1, batch_size=4096,
                   check_frequency=0.1, verbose=False)
    assert res.killed_geo == 0
    assert res.killed_int == 0
    assert res.energy_current == 10000.0


# ---- whole runs through both packages ----

def core_model(package, n_photons=3000, n_imaging=2000,
               seed=20261017):
    """A point source in a dense core on the three-level grid (100 au to
    the faces), rho_c / (1 + (r / r_c)^2), tau ~ 7 from the centre to the
    faces and ~ 2 across a central finest cell, so that MRW jumps; 1 Lucy
    iteration with MRW (gamma 1), then the imaging iteration with forced
    first interaction into SEDs at 10 and 80 degrees with
    uncertainties."""
    F = frontend(package)
    scale = 100.0 * F.au
    r_c = 5.0 * F.au

    def density(x, y, z):
        r2 = x ** 2 + y ** 2 + z ** 2
        return 3e-16 / (1.0 + r2 / r_c ** 2)

    amr = amr_grid(THREE_LEVEL, package, scale, density)
    nu = np.logspace(8, 17, 40)
    dust = F.HenyeyGreensteinDust(nu, np.repeat(0.5, 40),
                                  np.repeat(200.0, 40), np.repeat(0.4, 40),
                                  np.repeat(0.8, 40))
    m = F.Model()
    m.set_amr_grid(amr)
    m.add_density_grid(amr['density'], dust)
    s = m.add_point_source()
    s.luminosity, s.temperature = F.lsun, 6000.0
    s.position = (0.01 * scale, -0.02 * scale, 0.03 * scale)
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([10.0, 80.0], [0.0, 30.0])
    sed.set_wavelength_range(12, 0.3, 1000.0)
    sed.set_uncertainties(True)
    m.set_mrw(True, gamma=1.0)
    m.set_forced_first_interaction(True)
    m.set_n_initial_iterations(1)
    m.conf.output.output_n_photons = 'last'
    m.set_n_photons(initial=n_photons, imaging=n_imaging)
    m.set_seed(seed)
    return m


def test_lucy_mrw_and_forced_imaging_within_noise_of_jax(tmp_path,
                                                        monkeypatch):
    """A Lucy iteration with MRW and the imaging iteration with forced
    first interaction on the three-level grid through both packages'
    run_model (:func:`core_model`): within noise of each other, the same
    per-fab .rtout layout (test_torch_octree.assert_within_noise); the
    port's Lucy iteration made MRW jumps."""
    from hyperion_tpu_torch.transport import engine
    jumps = []
    inner = engine.mrw_jump_update

    def counted(dt, mrw, u, mrw_now, *args):
        jumps.append(int(mrw_now.sum()))
        return inner(dt, mrw, u, mrw_now, *args)

    monkeypatch.setattr(engine, 'mrw_jump_update', counted)
    assert_within_noise(run_both(core_model, tmp_path))
    assert sum(jumps) > 10


def test_pda_and_monochromatic_run_on_the_amr_grid():
    """The PDA (its per-fab tables), the Lucy steps with MRW and the
    monochromatic iteration, dust photons placed by the cells' positions,
    on :func:`core_model`'s dense core
    (test_torch_octree.pda_then_monochromatic)."""
    from test_torch_octree import pda_then_monochromatic
    m = core_model('port', n_photons=1000, n_imaging=0)
    pda_then_monochromatic(m)


# ---- the kernel on the card (marked cuda: skipped without one) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('name,limited,dtype', [
    ('three_level', False, torch.float64), ('two_level', True, torch.float64),
    ('three_level', False, torch.float32),
    ('three_level', True, torch.float32), ('gaps', False, torch.float64),
    ('overlap', True, torch.float64), ('gaps', True, torch.float32)],
    ids=['three_level', 'two_level_limited', 'three_level_f32',
         'three_level_limited_f32', 'gaps', 'overlap_limited',
         'gaps_limited_f32'])
def test_kernel_matches_plain_walk_on_card(name, limited, dtype,
                                           cuda_device):
    """The AMR crossing of escape_tau.cu (tau and column modes, the fab
    and level tables in shared memory, the fab carried with the lane, the
    indexed locate) against the plain walk on the same rays (on walls, fab
    faces and corners, along axes, parallel to faces and along diagonals),
    also on a grid whose levels leave gaps and one whose fabs of a level
    overlap: float64 tau to rtol 1e-10 and columns to 0; float32 lanes
    equal to their own plain walk."""
    pos, k, cell, active, density, chi, t_max = _walk_inputs(
        build_amr_geometry(amr_grid(LOCATE_GRIDS[name]), CPU, F64), n=20000)
    pg = build_amr_geometry(amr_grid(LOCATE_GRIDS[name]), cuda_device, F64)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(cuda_device, dt)

    rho_t = dev(density.T)
    walk = EscapeTau(pg, rho_t)
    lanes = [dev(a) for a in pos] + [dev(a)[None] for a in k]
    cellt = dev(cell, torch.int64)
    act = dev(active, torch.bool)
    tm = dev(t_max)[None] if limited else None
    tau = walk(dev(chi), *lanes, cellt, act, t_max=tm)
    col = walk.columns(*lanes, cellt, act, t_max=tm)
    torch.cuda.synchronize()
    ref_tau = escape_tau_reference(pg, rho_t, dev(chi), *lanes, cellt, act,
                                   t_max=tm)
    ref_col = escape_column_reference(pg, rho_t, *lanes, cellt, act,
                                      t_max=tm)
    assert (ref_tau > 0).sum() > 10000
    if dtype == torch.float64:
        np.testing.assert_allclose(tau.cpu().numpy(), ref_tau.cpu().numpy(),
                                   rtol=1e-10, atol=0)
    else:
        np.testing.assert_array_equal(tau.cpu().numpy(),
                                      ref_tau.cpu().numpy())
    np.testing.assert_array_equal(col.cpu().numpy(), ref_col.cpu().numpy())


# ---- the tables carried from the JAX package, and maps over the cells ----

def _box_grids(package):
    """The three-level AMR grid with a density, and the octree of
    test_torch_octree.sph_tree, of either package."""
    from test_torch_octree import sph_tree
    return dict(
        amr=amr_grid(THREE_LEVEL, package,
                     density=lambda x, y, z: 1.0 + x ** 2 + y * z),
        octree=sph_tree(package))


@pytest.mark.parametrize('kind', ['octree', 'amr'])
def test_tables_from_numpy_carry_box_geometries(kind):
    """convert.tables_from_numpy makes the port's octree (told apart by
    ``children``, its walls from the centres and half-widths) and AMR
    geometry (by ``fab_lo``) from the JAX tables' fields, equal to the
    port's own builds."""
    import dataclasses
    from hyperion_tpu.transport.gtable_octree import \
        build_octree_geometry as j_octree
    from hyperion_tpu_torch.convert import _octree_from_numpy
    from hyperion_tpu_torch.convert import tables_from_numpy
    from hyperion_tpu_torch.transport.gtable_octree import \
        build_octree_geometry
    from test_torch_tables import _assert_fields_equal, _tutorial_dust
    grid_j, grid_p = _box_grids('jax')[kind], _box_grids('port')[kind]
    if kind == 'octree':
        jg = j_octree(grid_j, dtype=jnp.float64)
        built = build_octree_geometry(grid_p, CPU, F64)
    else:
        jg = j_geometry(grid_j, dtype=jnp.float64)
        built = build_amr_geometry(grid_p, CPU, F64)
    fields = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg)}
    j_dt = __import__('hyperion_tpu.transport', fromlist=['x'])
    dust = j_dt.build_dust_tables([_tutorial_dust('jax')], dtype=jnp.float64)
    src = j_dt.build_source_tables(
        [frontend('jax').PointSource(luminosity=1.0, temperature=5000.0)],
        dtype=jnp.float64, length_scale=jg.length_scale)
    as_dict = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}
    carried = tables_from_numpy(as_dict(dust), as_dict(src), fields, CPU,
                                F64)[2]
    assert type(carried) is type(built)
    _assert_fields_equal(built, carried)
    if kind == 'amr':
        # the indexed locate's tables, built from the carried tables
        for a, b in zip(built.level_index(), carried.level_index()):
            np.testing.assert_array_equal(a, b)
    if kind == 'octree':
        # and from the JAX float32 tables, the walls exact in float32
        j32 = j_octree(grid_j, dtype=jnp.float32)
        c32 = _octree_from_numpy({f.name: np.asarray(getattr(j32, f.name))
                                  for f in dataclasses.fields(j32)}, CPU,
                                 torch.float32)
        _assert_fields_equal(build_octree_geometry(grid_p, CPU,
                                                   torch.float32), c32)


@pytest.mark.parametrize('kind', ['octree', 'amr'])
def test_map_source_tables_equal_jax(kind):
    """A luminosity map over the octree's nodes or the AMR grid's cells
    (the fabs flattened level-major): the port's source tables, the map's
    CDF over the flat cells included, equal the JAX package's."""
    from hyperion_tpu.transport.stable import build_source_tables as j_src
    from test_torch_tables import _assert_fields_equal
    tables = []
    for package in ('jax', 'port'):
        F = frontend(package)
        grid = _box_grids(package)[kind]
        s = F.MapSource(luminosity=F.lsun, temperature=4000.0)
        if kind == 'amr':
            s.map = np.concatenate([
                np.asarray(g.quantities['density']).reshape(-1)
                for level in grid.levels for g in level.grids])
        else:
            s.map = np.where(np.asarray(grid.refined), 0.0,
                             np.asarray(grid['density'][0].array))
        if package == 'jax':
            tables.append(j_src([s], dtype=jnp.float64, length_scale=1.0,
                                grid=grid))
        else:
            tables.append(build_source_tables([s], CPU, F64,
                                              length_scale=1.0, grid=grid))
    _assert_fields_equal(tables[1], tables[0])
    assert tables[1].map_cdf.shape[1] == \
        (len(grid.refined) if kind == 'octree' else
         sum(g.nx * g.ny * g.nz for level in grid.levels
             for g in level.grids))
