"""The port's cartesian geometry against the JAX package's on the same
rays (JAX x64, torch float64): seeded rays, rays exactly on walls, edges and
vertices, and rays with zero direction components. Cells and axes must be
equal, wall distances match to rtol 1e-14 and closest-wall distances are
equal. Then the zero-killed placement
cases of tests/test_propagation.py through the port's run_lucy."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperion_tpu.transport import build_cartesian_geometry as j_geometry
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
from hyperion_tpu_torch.transport.lucy import run_lucy
from hyperion_tpu_torch.transport.stable import build_source_tables
from test_torch_frontend import frontend

torch.set_num_threads(1)
CPU = torch.device('cpu')
F64 = torch.float64


def _grid(package):
    return frontend(package).CartesianGrid(np.array([-1.0, -0.6, -0.1, 0.0, 0.3, 1.0]),
                         np.linspace(-1.0, 1.0, 5),
                         np.array([-0.5, 0.0, 0.2, 0.9]))


def _rays(jg, n=3000, seed=21):
    """Seeded rays inside (and a little outside) the grid; a third of them
    are moved exactly onto walls (one, two or three axes: faces, edges,
    vertices); some direction components are exactly zero."""
    rng = np.random.default_rng(seed)
    walls = [np.asarray(jg.xw), np.asarray(jg.yw), np.asarray(jg.zw)]
    pos = np.stack([rng.uniform(w[0] - 0.05, w[-1] + 0.05, n) for w in walls])
    for a, w in enumerate(walls):
        on = rng.random(n) < 0.35
        pos[a, on] = rng.choice(w, on.sum())
    mu = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    st = np.sqrt(1 - mu ** 2)
    k = np.stack([st * np.cos(phi), st * np.sin(phi), mu])
    # one zero component (in a wall plane) or two (along an axis)
    keep = rng.integers(0, 3, n)
    for a in range(3):
        k[a, (rng.random(n) < 0.1) & (keep != a)] = 0.0
    k /= np.linalg.norm(k, axis=0)
    return pos, k


def test_find_cell_find_wall_snap_in_cell():
    jg = j_geometry(_grid('jax'), dtype=jnp.float64)
    pg = build_cartesian_geometry(_grid('port'), CPU, F64)
    pos, k = _rays(jg)
    jpos, jk = [jnp.asarray(a) for a in pos], [jnp.asarray(a) for a in k]
    tpos, tk = [torch.as_tensor(a) for a in pos], [torch.as_tensor(a)
                                                   for a in k]

    cell_j = np.asarray(jg.find_cell(*jpos, *jk))
    cell_p = pg.find_cell(*tpos, *tk)
    np.testing.assert_array_equal(cell_p.numpy(), cell_j)
    inside = cell_j >= 0
    assert inside.sum() > 1000 and (~inside).sum() > 50

    # walls from inside cells only (the engine's invariant)
    sel = np.where(inside)[0]
    cj = jnp.asarray(cell_j[sel])
    args_j = [a[sel] for a in jpos] + [a[sel] for a in jk]
    args_p = [a[sel] for a in tpos] + [a[sel] for a in tk]
    t_j, next_j, ax_j, wc_j = jg.find_wall(cj, *args_j)
    t_p, next_p, ax_p, wc_p = pg.find_wall(cell_p[sel], *args_p)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=1e-14,
                               atol=0)
    np.testing.assert_array_equal(next_p.numpy(), np.asarray(next_j))
    np.testing.assert_array_equal(ax_p.numpy(), np.asarray(ax_j))
    np.testing.assert_array_equal(wc_p.numpy(), np.asarray(wc_j))

    # the MRW trigger's distance
    np.testing.assert_array_equal(
        pg.closest_wall_distance(cell_p[sel], *args_p[:3]).numpy(),
        np.asarray(jg.closest_wall_distance(cj, *args_j[:3])))

    crossed = np.random.default_rng(22).random(len(sel)) < 0.5
    snap_j = jg.snap(*args_j[:3], ax_j, wc_j, jnp.asarray(crossed))
    snap_p = pg.snap(*args_p[:3], ax_p, wc_p, torch.as_tensor(crossed))
    for a, b in zip(snap_p, snap_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # the self-check oracle, on positions moved off their cells a little
    jit = np.random.default_rng(23).normal(0, 0.02, (3, len(sel)))
    moved = [p[sel] + d for p, d in zip(pos, jit)]
    ok_j = jg.in_cell_tol(cj, *[jnp.asarray(m) for m in moved])
    ok_p = pg.in_cell_tol(cell_p[sel], *[torch.as_tensor(m) for m in moved])
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    assert 0 < np.asarray(ok_j).sum() < len(sel)


CAR_POSITIONS = [
    (0.0, 0.0, 0.0),          # grid center, on walls of 8 cells
    (-1.0, -1.0, -1.0),       # corner of the grid
    (0.0, 0.0, 1.0),          # on the top face
    (0.25, 0.0, 0.0),         # on two walls
    (1. / 3., 1. / 3., 1. / 3.),  # generic interior point
]


@pytest.mark.parametrize("position", CAR_POSITIONS)
def test_cartesian_robustness(position):
    """tests/test_propagation.py:test_cartesian_robustness on the port."""
    P = frontend('port')
    grid = P.CartesianGrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 9),
                           np.linspace(-1, 1, 9))
    geo = build_cartesian_geometry(grid, CPU, F64)
    dust = P.IsotropicDust(np.logspace(5, 18, 16), np.repeat(0.5, 16),
                           np.repeat(1.0, 16))
    dt = build_dust_tables([dust], CPU, F64)
    src = P.PointSource(luminosity=1.0, temperature=5000.0,
                        position=position)
    st = build_source_tables([src], CPU, F64, length_scale=geo.length_scale)
    density = torch.full((1, geo.n_cells), 0.5 * geo.length_scale,
                         dtype=F64)
    res = run_lucy(geo, dt, st, density, torch.Generator().manual_seed(0),
                   n_photons=20000, n_iterations=1, batch_size=4096,
                   check_frequency=0.1, verbose=False)
    assert res.killed_geo == 0
    assert res.killed_int == 0
    assert res.energy_current == 20000.0
