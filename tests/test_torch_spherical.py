"""The port's spherical-polar geometry against the JAX package's on the same
rays (JAX x64, torch float64): ~10^4 seeded rays per grid, a third of them
moved exactly onto radial, theta or phi walls, others onto the poles' axis
or the midplane, with directions along the axis, in the midplane and
radial. Cells and the self-check are equal; wall distances and the
closest-wall distance match to rtol 1e-12. Grids with one and four phi
cells, an inner wall at 0 and one above it."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperion_tpu.transport.gtable_spherical import \
    build_spherical_geometry as j_geometry
from hyperion_tpu_torch.transport.gtable_spherical import \
    build_spherical_geometry
from test_torch_frontend import frontend

torch.set_num_threads(1)
CPU = torch.device('cpu')
RTOL = 1e-12


def _grid(package, n3, r0):
    rw = np.logspace(np.log10(0.02), 0.0, 9)
    rw = np.hstack([0.0, rw]) if r0 == 0.0 else rw * r0 / 0.02
    # theta walls crowded toward the midplane (a midplane wall with an
    # even count), as the YSO model's auto grid makes them
    t = np.linspace(0.0, np.pi, 9)
    tw = t + np.sin(2.0 * t) / 6.0
    pw = np.linspace(0.0, 2.0 * np.pi, n3 + 1)
    return frontend(package).SphericalPolarGrid(rw, tw, pw)


def _rays(jg, n=10000, seed=31):
    """Positions (3, n) and unit directions (3, n)."""
    rng = np.random.default_rng(seed)
    rw = np.asarray(jg.rw)
    tw = np.arccos(np.clip(np.asarray(jg.cos_tw), -1, 1))
    pw = np.asarray(jg.phi_w)
    r = rng.uniform(0.0, 1.04, n) ** 1.5
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    kind = rng.integers(0, 8, n)
    r = np.where(kind == 0, rng.choice(rw, n), r)            # on a sphere
    theta = np.where(kind == 1, rng.choice(tw, n), theta)    # on a cone
    phi = np.where(kind == 2, rng.choice(pw, n), phi)        # on a half-plane
    theta = np.where(kind == 3, np.pi / 2, theta)            # in the midplane
    theta = np.where(kind == 4, rng.choice([0.0, np.pi], n), theta)  # axis
    pos = np.stack([r * np.sin(theta) * np.cos(phi),
                    r * np.sin(theta) * np.sin(phi), r * np.cos(theta)])
    mu = rng.uniform(-1, 1, n)
    az = rng.uniform(0, 2 * np.pi, n)
    k = np.stack([np.sqrt(1 - mu ** 2) * np.cos(az),
                  np.sqrt(1 - mu ** 2) * np.sin(az), mu])
    style = rng.integers(0, 6, n)
    k[:, style == 0] = [[0.0], [0.0], [1.0]]                 # along the axis
    k[:, style == 1] = [[0.0], [0.0], [-1.0]]
    k[2, style == 2] = 0.0                                   # in a z plane
    radial = pos / np.maximum(np.linalg.norm(pos, axis=0), 1e-300)
    k[:, style == 3] = radial[:, style == 3] * \
        rng.choice([-1.0, 1.0], (style == 3).sum())          # radial
    # through the pole's axis: aim at a point on it
    aim = np.stack([np.zeros(n), np.zeros(n), rng.uniform(-0.5, 0.5, n)])
    k[:, style == 4] = (aim - pos)[:, style == 4]
    k /= np.maximum(np.linalg.norm(k, axis=0), 1e-300)
    return pos, k


@pytest.mark.parametrize('n3,r0', [(1, 0.0), (4, 0.0), (4, 0.05)],
                         ids=['n3=1', 'n3=4', 'n3=4_inner_wall'])
def test_spherical_geometry_matches_jax(n3, r0):
    jg = j_geometry(_grid('jax', n3, r0), dtype=jnp.float64)
    pg = build_spherical_geometry(_grid('port', n3, r0), CPU, torch.float64)
    for f in dataclasses.fields(pg):
        np.testing.assert_array_equal(np.asarray(getattr(pg, f.name)),
                                      np.asarray(getattr(jg, f.name)),
                                      err_msg=f.name)
    pos, k = _rays(jg)
    jpos, jk = [jnp.asarray(a) for a in pos], [jnp.asarray(a) for a in k]
    tpos, tk = [torch.as_tensor(a) for a in pos], [torch.as_tensor(a)
                                                   for a in k]

    cell_j = np.asarray(jg.find_cell(*jpos, *jk))
    cell_p = pg.find_cell(*tpos, *tk)
    np.testing.assert_array_equal(cell_p.numpy(), cell_j)
    inside = cell_j >= 0
    assert inside.sum() > 8000 and (~inside).sum() > 50

    # from inside cells (the engine's invariant)
    sel = np.where(inside)[0]
    args_j = [a[sel] for a in jpos] + [a[sel] for a in jk]
    args_p = [a[sel] for a in tpos] + [a[sel] for a in tk]
    cj = jnp.asarray(cell_j[sel])
    cp = cell_p[sel]
    t_j, next_j, _, _ = jg.find_wall(cj, *args_j)
    t_p, next_p, _, _ = pg.find_wall(cp, *args_p)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=RTOL,
                               atol=0)
    np.testing.assert_array_equal(next_p.numpy(), np.asarray(next_j))
    assert (np.asarray(next_j) == -1).sum() > 100     # rays that escape
    assert (np.asarray(t_j) > 0).all()

    d_j = jg.closest_wall_distance(cj, *args_j[:3])
    d_p = pg.closest_wall_distance(cp, *args_p[:3])
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=RTOL,
                               atol=1e-15)

    # the self-check oracle, on positions moved off their cells a little
    jit = np.random.default_rng(32).normal(0, 0.01, (3, len(sel)))
    moved = [p[sel] + d for p, d in zip(pos, jit)]
    ok_j = np.asarray(jg.in_cell_tol(cj, *[jnp.asarray(m) for m in moved]))
    ok_p = pg.in_cell_tol(cp, *[torch.as_tensor(m) for m in moved])
    np.testing.assert_array_equal(ok_p.numpy(), ok_j)
    assert 0 < ok_j.sum() < len(sel)
