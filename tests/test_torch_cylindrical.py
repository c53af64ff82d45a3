"""The port's cylindrical-polar geometry against the JAX package's on the
same seeded rays (JAX x64, torch float64; JAX float32 against torch
float32 too): the tables are equal; cells and the self-check equal; wall
distances and the closest-wall distance match to rtol 1e-12 in float64
(rtol 1e-5 and atol 1e-7, an engine-unit float32 ulp, in float32, with the
cells equal). A third of the rays start on a
wall, others on the axis; directions along the axis, in a z plane, radial
in w, and tangent to a cylinder (grazing rays, both roots of the
quadratic). The self-check accepts all that the JAX package's accepts,
and more only within twice the on-wall nudge of a thin cell's bounds
(its margin's floor). Then the plain tau and column walks against JAX's
``escape_tau_walk`` and ``escape_column_walk`` (rtol 1e-12), the
uniform-cylinder tau oracle of tests/test_cylindrical_geometry.py, the
positions in cells from the same uniforms, and the zero-killed placement
cases of tests/test_propagation.py through the port's run_lucy. The
kernel's cylindrical crossing is held to the plain walk on the card
(marked cuda, skipped here)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperion_tpu.transport.gtable_cylindrical import \
    build_cylindrical_geometry as j_geometry
from hyperion_tpu.transport.imaging import escape_tau_walk as j_tau_walk
from hyperion_tpu.transport.raytrace import \
    escape_column_walk as j_column_walk
from hyperion_tpu.transport.raytrace import \
    sample_position_in_cell as j_position
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.escape_tau import (EscapeTau,
                                                     escape_column_reference,
                                                     escape_tau_reference)
from hyperion_tpu_torch.transport.gtable_cylindrical import \
    build_cylindrical_geometry
from hyperion_tpu_torch.transport.lucy import run_lucy
from hyperion_tpu_torch.transport.raytrace import sample_position_in_cell
from hyperion_tpu_torch.transport.stable import build_source_tables
from test_torch_frontend import frontend

torch.set_num_threads(1)
CPU = torch.device('cpu')
F64 = torch.float64
RTOL = 1e-12


def _grid(package, n3, w0=0.0):
    """Log-spaced shells from the axis (or from an inner hole at w0),
    z walls crowded toward the midplane, n3 phi cells."""
    ww = np.logspace(-2, 0, 9)
    ww = np.hstack([0.0, ww]) if w0 == 0.0 else np.hstack([w0, ww[ww > w0]])
    t = np.linspace(-1.0, 1.0, 9)
    zw = t * np.abs(t) * 0.8
    pw = np.linspace(0.0, 2.0 * np.pi, n3 + 1)
    return frontend(package).CylindricalPolarGrid(ww, zw, pw)


def _rays(g, n=10000, seed=41):
    """Positions (3, n) and unit directions (3, n) on either package's
    geometry ``g``."""
    rng = np.random.default_rng(seed)
    ww, zw, pw = (np.asarray(a, float) for a in (g.ww, g.zw, g.phi_w))
    w = rng.uniform(0.0, 1.04, n) ** 1.5
    z = rng.uniform(zw[0] * 1.04, zw[-1] * 1.04, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    kind = rng.integers(0, 7, n)
    w = np.where(kind == 0, rng.choice(ww, n), w)            # on a cylinder
    z = np.where(kind == 1, rng.choice(zw, n), z)            # on a z plane
    phi = np.where(kind == 2, rng.choice(pw, n), phi)        # on a half-plane
    w = np.where(kind == 3, 0.0, w)                          # on the axis
    z = np.where(kind == 4, 0.0, z)                          # the midplane
    pos = np.stack([w * np.cos(phi), w * np.sin(phi), z])
    mu = rng.uniform(-1, 1, n)
    az = rng.uniform(0, 2 * np.pi, n)
    k = np.stack([np.sqrt(1 - mu ** 2) * np.cos(az),
                  np.sqrt(1 - mu ** 2) * np.sin(az), mu])
    style = rng.integers(0, 7, n)
    k[:, style == 0] = [[0.0], [0.0], [1.0]]                 # along the axis
    k[:, style == 1] = [[0.0], [0.0], [-1.0]]
    k[2, style == 2] = 0.0                                   # in a z plane
    radial = np.stack([np.cos(phi), np.sin(phi), np.zeros(n)])
    k[:, style == 3] = radial[:, style == 3] * \
        rng.choice([-1.0, 1.0], (style == 3).sum())          # radial in w
    # tangent to the cylinder through the point (grazing), tilted in z
    tangent = np.stack([-np.sin(phi), np.cos(phi),
                        rng.choice([0.0, 0.3], n)])
    k[:, style == 4] = tangent[:, style == 4]
    k /= np.maximum(np.linalg.norm(k, axis=0), 1e-300)
    return pos, k


def _pair(n3, w0, jdtype, tdtype):
    return (j_geometry(_grid('jax', n3, w0), dtype=jdtype),
            build_cylindrical_geometry(_grid('port', n3, w0), CPU, tdtype))


@pytest.mark.parametrize('n3,w0,precision', [
    (1, 0.0, 64), (6, 0.0, 64), (6, 0.05, 64), (1, 0.0, 32), (6, 0.0, 32)],
    ids=['n3=1', 'n3=6', 'n3=6_inner_hole', 'n3=1_f32', 'n3=6_f32'])
def test_cylindrical_geometry_matches_jax(n3, w0, precision):
    """Tables, find_cell, find_wall (t and the next cell),
    closest_wall_distance and in_cell_tol on the same rays: float64 to rtol
    1e-12; float32 to rtol 1e-5 for the distances, the cells equal."""
    jdt, tdt = (jnp.float64, F64) if precision == 64 else \
        (jnp.float32, torch.float32)
    rtol = RTOL if precision == 64 else 1e-5
    jg, pg = _pair(n3, w0, jdt, tdt)
    for f in dataclasses.fields(pg):
        np.testing.assert_array_equal(np.asarray(getattr(pg, f.name)),
                                      np.asarray(getattr(jg, f.name)),
                                      err_msg=f.name)
    pos, k = _rays(jg)
    pos, k = pos.astype(np.dtype('f%d' % (precision // 8))), \
        k.astype(np.dtype('f%d' % (precision // 8)))
    jpos, jk = [jnp.asarray(a) for a in pos], [jnp.asarray(a) for a in k]
    tpos, tk = [torch.as_tensor(a) for a in pos], [torch.as_tensor(a)
                                                   for a in k]
    cell_j = np.asarray(jg.find_cell(*jpos, *jk))
    cell_p = pg.find_cell(*tpos, *tk)
    np.testing.assert_array_equal(cell_p.numpy(), cell_j)
    inside = cell_j >= 0
    assert inside.sum() > 6000 and (~inside).sum() > 50

    sel = np.where(inside)[0]
    args_j = [a[sel] for a in jpos] + [a[sel] for a in jk]
    args_p = [a[sel] for a in tpos] + [a[sel] for a in tk]
    cj = jnp.asarray(cell_j[sel])
    cp = cell_p[sel]
    t_j, next_j, _, _ = jg.find_wall(cj, *args_j)
    t_p, next_p, _, _ = pg.find_wall(cp, *args_p)
    # (float32: XLA and torch may round a short distance's last bit apart)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=rtol,
                               atol=0 if precision == 64 else 1e-7)
    # every next cell in float64; in float32 those of the rays that do not
    # ride a wall (see _riding)
    same = next_p.numpy() == np.asarray(next_j)
    if precision == 32:
        same |= _riding(jg, pos[:, sel], k[:, sel])
    assert same.all()
    assert (np.asarray(next_j) == -1).sum() > 100     # rays that escape
    if precision == 64:
        assert (np.asarray(t_j) > 0).all()

    d_j = jg.closest_wall_distance(cj, *args_j[:3])
    d_p = pg.closest_wall_distance(cp, *args_p[:3])
    # (float32: a few ulps of the unit coordinates, where the phi walls'
    # distance w |sin(phi - phi_w)| takes XLA's float32 atan2 and sin)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=rtol,
                               atol=1e-15 if precision == 64 else 1e-6)

    jit = np.random.default_rng(42).normal(0, 0.01, (3, len(sel)))
    moved = [(p[sel] + d).astype(pos.dtype) for p, d in zip(pos, jit)]
    ok_j = np.asarray(jg.in_cell_tol(cj, *[jnp.asarray(m) for m in moved]))
    ok_p = pg.in_cell_tol(cp, *[torch.as_tensor(m) for m in moved]).numpy()
    # the port's w and z margins are at least twice the nudge _eps (the
    # JAX function's are 1% of the cell, which kills packets on float32
    # thin shells): it accepts all that the JAX function accepts, and more
    # only within that band
    assert (ok_p | ~ok_j).all()
    extra = ok_p & ~ok_j
    assert extra.mean() < 0.01
    w = np.hypot(moved[0], moved[1]).astype(float)
    zz = moved[2].astype(float)
    eps = 2.0 * (pg.t_eps * (w + np.abs(zz)) + pg.eps_floor)
    i1, i2 = cell_j[sel] % pg.n1, (cell_j[sel] // pg.n1) % pg.n2
    ww, zw = pg.ww.numpy().astype(float), pg.zw.numpy().astype(float)
    # where a coordinate lies beyond the JAX margin, it lies within 2 eps
    for v, lo, hi in ((w, ww[i1], ww[i1 + 1]), (zz, zw[i2], zw[i2 + 1])):
        out = np.maximum(np.maximum(lo - v, v - hi), 0.0)
        beyond = out > 0.01 * (hi - lo)
        assert (out[extra & beyond] <= eps[extra & beyond]).all()
    assert 0 < ok_j.sum() < len(sel)
    # snap is a no-op
    assert pg.snap(*args_p[:3], None, None, None)[0] is args_p[0]


def _riding(g, pos, k):
    """Rays that ride a wall: on a cylinder and parallel to the axis, on a
    z plane with kz = 0, or on a phi half-plane and in it. Which cell such
    a ray enters next is a tie, which the JAX package's compiled loop
    (contracting products into fused multiply-adds) and its float32 atan2
    (a polynomial) at times break the other way than torch's arithmetic."""
    ww2, zw, sw, cw = (np.asarray(a, float) for a in (
        g.ww2, g.zw, g.sin_pw, g.cos_pw))
    pos, k = np.asarray(pos, float), np.asarray(k, float)
    tol = 1e-12 if np.asarray(g.ww).dtype == np.float64 else 1e-6

    def near(v, walls):
        return np.abs(v[:, None] - walls[None, :]).min(axis=1) < tol

    riding = (near(pos[0] ** 2 + pos[1] ** 2, ww2) &
              (k[0] ** 2 + k[1] ** 2 < tol ** 2)) | \
        (near(pos[2], zw) & (k[2] == 0.0))
    if g.n3 > 1:
        on_phi = np.abs(-sw[None, :] * pos[0][:, None] +
                        cw[None, :] * pos[1][:, None]) < tol
        in_phi = np.abs(-sw[None, :] * k[0][:, None] +
                        cw[None, :] * k[1][:, None]) < tol
        riding |= (on_phi & in_phi).any(axis=1)
    return riding


def _walk_inputs(pg, n=3000, n_dust=2, seed=43):
    """Rays on the port's CPU float64 geometry ``pg``, their cells, lanes
    and a density: made with the port alone (the card's machine has no
    h5py, which the JAX package's front end imports)."""
    pos, k = _rays(pg, n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    cell = pg.find_cell(*[torch.as_tensor(a) for a in (*pos, *k)]).numpy()
    active = (cell >= 0) & (rng.random(n) < 0.9)
    density = rng.uniform(0.0, 3.0, (n_dust, pg.n_cells))
    density[:, rng.random(pg.n_cells) < 0.1] = 0.0
    chi = rng.uniform(0.5, 2.0, (n, n_dust))
    t_max = np.where(rng.random(n) < 0.3, rng.uniform(0.0, 1.0, n), np.inf)
    return pos, k, np.maximum(cell, 0), active, density, chi, t_max


def _through_axis(pos, k):
    """Rays whose line meets the z axis (within 1e-7; as
    tests/test_torch_escape_tau.py leaves them out of its spherical
    parity): there every phi wall meets, and the compiled JAX loop (which
    may fuse a multiply-add) and eager arithmetic can round the landing
    point onto different sides of a wall."""
    kxy = np.hypot(k[0], k[1])
    b = np.abs(pos[0] * k[1] - pos[1] * k[0]) / np.maximum(kxy, 1e-300)
    return np.where(kxy > 1e-9, b < 1e-7, np.hypot(pos[0], pos[1]) < 1e-7)


@pytest.mark.parametrize('n3,limited', [(1, False), (6, False), (6, True)],
                         ids=['n3=1', 'n3=6', 'n3=6_limited'])
def test_plain_walks_match_jax(n3, limited):
    """The port's plain tau walk and column walk against JAX's
    ``escape_tau_walk`` and ``escape_column_walk`` on the same rays, float64
    to rtol 1e-12, with and without a distance limit. The lanes whose ray
    rides a wall (:func:`_riding`) or, with phi walls, runs through the
    axis (:func:`_through_axis`) are left out: there the compiled JAX
    loop breaks ties by its own rounding; the kernel test on the card
    keeps them all."""
    jg, pg = _pair(n3, 0.0, jnp.float64, F64)
    pos, k, cell, active, density, chi, t_max = _walk_inputs(pg)
    active = active & ~_riding(pg, pos, k)
    if n3 > 1:
        active = active & ~_through_axis(pos, k)
    assert active.sum() > 1200
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
                                 *(a[None] for a in t[3:]), **lanes)
    col_p = escape_column_reference(pg, rho_t, *t[:3],
                                    *(a[None] for a in t[3:]), **lanes)
    np.testing.assert_allclose(tau_p[0].numpy(), tau_j, rtol=RTOL,
                               atol=1e-300)
    np.testing.assert_allclose(col_p[0].numpy(), col_j.reshape(
        col_p[0].shape), rtol=RTOL, atol=1e-300)
    assert (tau_j[active] > 0).mean() > 0.8
    assert (tau_j[~active] == 0).all()


def test_uniform_cylinder_tau_oracle():
    """tests/test_cylindrical_geometry.py:21 on the port: tau to the edge of
    a uniform cylinder is chi rho times the analytic chord, rtol 1e-10."""
    P = frontend('port')
    grid = P.CylindricalPolarGrid(np.hstack([0.0, np.logspace(-2, 0, 10)]),
                                  np.linspace(-1.0, 1.0, 9),
                                  np.linspace(0.0, 2 * np.pi, 7))
    geo = build_cylindrical_geometry(grid, CPU, F64)
    rho_phys, chi = 0.6, 1.1
    rho_t = torch.full((geo.n_cells, 1), rho_phys * geo.length_scale,
                       dtype=F64)
    rng = np.random.RandomState(7)
    n = 2000
    pts = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(-0.8, 0.8, n)])
    dirs = rng.normal(size=(3, n))
    dirs /= np.linalg.norm(dirs, axis=0)
    x, y, z, kx, ky, kz = (torch.as_tensor(a) for a in (*pts, *dirs))
    cell = geo.find_cell(x, y, z, kx, ky, kz)
    assert int((cell < 0).sum()) == 0
    walk = EscapeTau(geo, rho_t)
    tau = walk(torch.full((n, 1), chi, dtype=F64), x, y, z, kx[None],
               ky[None], kz[None], cell, torch.ones(n, dtype=torch.bool))
    a = dirs[0] ** 2 + dirs[1] ** 2
    b = pts[0] * dirs[0] + pts[1] * dirs[1]
    c = pts[0] ** 2 + pts[1] ** 2 - 1.0
    with np.errstate(invalid='ignore', divide='ignore'):
        t_cyl = (-b + np.sqrt(b * b - a * c)) / a
    t_cyl[a < 1e-12] = np.inf
    t_z = np.where(dirs[2] > 0, (1.0 - pts[2]) / dirs[2],
                   np.where(dirs[2] < 0, (-1.0 - pts[2]) / dirs[2], np.inf))
    expected = chi * rho_phys * geo.length_scale * np.minimum(t_cyl, t_z)
    np.testing.assert_allclose(tau[0].numpy(), expected, rtol=1e-10)


@pytest.mark.parametrize('n3', [1, 6])
def test_position_in_cell_matches_jax(n3):
    """Uniform in w^2, z and phi from the uniforms JAX draws from its key,
    rtol 1e-12; every position lies in its cell."""
    jg, pg = _pair(n3, 0.05, jnp.float64, F64)
    cell = np.random.default_rng(44).integers(0, pg.n_cells, 4000)
    key = jax.random.PRNGKey(45)
    ref = j_position(jg, jnp.asarray(cell), key, jnp.float64)
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, (3, 4000),
                                                      dtype=jnp.float64)))
    port = sample_position_in_cell(pg, torch.as_tensor(cell), u)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-15)
    assert pg.in_cell_tol(torch.as_tensor(cell), *port, tol=1e-9).all()


CYL_POSITIONS = [
    (0.0, 0.0, 0.0),          # on the axis
    (0.5, 0.0, 0.0),          # on a phi wall
    (0.0, 0.0, 0.5),          # on the axis, above the midplane
    (0.3, 0.2, -0.4),         # generic
    (0.0, 0.0, 1.0),          # on the axis, on the top face
    (1.0, 0.0, 0.0),          # on the outer cylinder and a phi wall
]


@pytest.mark.parametrize('position', CYL_POSITIONS)
def test_cylindrical_robustness(position):
    """tests/test_propagation.py:test_cylindrical_robustness on the port,
    with the top face and the outer cylinder's edge: no photon killed."""
    P = frontend('port')
    grid = P.CylindricalPolarGrid(np.hstack([0.0, np.logspace(-2, 0, 8)]),
                                  np.linspace(-1, 1, 7),
                                  np.linspace(0, 2 * np.pi, 6))
    geo = build_cylindrical_geometry(grid, CPU, F64)
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


# ---- the kernel on the card (marked cuda: skipped without one) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('n3,limited,dtype', [
    (1, False, torch.float64), (6, True, torch.float64),
    (6, False, torch.float32)], ids=['n3=1', 'n3=6_limited', 'n3=6_f32'])
def test_kernel_matches_plain_walk_on_card(n3, limited, dtype, cuda_device):
    """The cylindrical crossing of escape_tau.cu (tau and column modes)
    against the plain walk on the same rays (grazing, axial, on walls):
    float64 tau to rtol 1e-10 and columns to 0; float32 lanes equal to
    their own plain walk."""
    pos, k, cell, active, density, chi, t_max = _walk_inputs(
        build_cylindrical_geometry(_grid('port', n3), CPU, F64), n=20000)
    pg = build_cylindrical_geometry(_grid('port', n3), cuda_device, F64)

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
    if dtype == torch.float64:
        np.testing.assert_allclose(tau.cpu().numpy(), ref_tau.cpu().numpy(),
                                   rtol=1e-10, atol=0)
    else:
        np.testing.assert_array_equal(tau.cpu().numpy(),
                                      ref_tau.cpu().numpy())
    np.testing.assert_array_equal(col.cpu().numpy(), ref_col.cpu().numpy())


# ---- the PDA, run_with_vertical_hseq and BASELINE config 3 at small size ----

def _pda_grid(package):
    return frontend(package).CylindricalPolarGrid(
        np.hstack([0.0, np.geomspace(1e12, 1e14, 12)]),
        np.linspace(-1e14, 1e14, 9), np.linspace(0.0, 2 * np.pi, 4))


@pytest.mark.parametrize('n_cells_starved', [12, 30])
def test_solve_pda_matches_jax(n_cells_starved):
    """The same fields into both copies of the PDA on a cylindrical-polar
    grid (tests/test_torch_engine_units.py:test_solve_pda's spherical
    case): the tables are equal and the starved cells' specific energies
    match to rtol 1e-12."""
    from hyperion_tpu.transport import build_dust_tables as j_dust
    from hyperion_tpu.transport.pda import build_pda_tables as j_tables
    from hyperion_tpu.transport.pda import solve_pda as j_solve
    from hyperion_tpu_torch.transport.pda import build_pda_tables, solve_pda
    from test_torch_frontend import lte_dust
    jt = j_dust([lte_dust('jax'), lte_dust('jax', 0.6, 20.0)],
                dtype=jnp.float64)
    pt = build_dust_tables([lte_dust('port'), lte_dust('port', 0.6, 20.0)],
                           CPU, F64)
    rng = np.random.default_rng(13)
    n_cells = 12 * 8 * 3
    density = rng.uniform(1e-19, 1e-17, (2, n_cells))
    se = 10 ** rng.uniform(-2, 3, (2, n_cells))
    n_phot = rng.integers(40, 400, n_cells)
    n_phot[rng.choice(n_cells, n_cells_starved, replace=False)] = 3
    jtab, ptab = j_tables(_pda_grid('jax')), build_pda_tables(_pda_grid('port'))
    for f in ('edge_i', 'edge_j', 'w_i', 'w_j', 'g', 'allowed'):
        np.testing.assert_array_equal(getattr(ptab, f), getattr(jtab, f),
                                      err_msg=f)
    ref, n_ref = j_solve(jtab, jt, density, se, n_phot)
    port, n_port = solve_pda(ptab, pt, density, se, n_phot)
    assert n_port == n_ref > 0
    np.testing.assert_allclose(port, ref, rtol=RTOL)


def test_pda_runs_through_lucy(monkeypatch):
    """The port's Lucy iterations with the PDA on a cylindrical-polar grid
    that 3,000 photons leave starved (fewer than 30 visits) in its far
    and its small cells: the PDA fills them, and the result is finite and
    positive."""
    from hyperion_tpu_torch.transport import lucy
    from hyperion_tpu_torch.transport.pda import build_pda_tables
    from test_torch_frontend import lte_dust
    grid = _pda_grid('port')
    geo = build_cylindrical_geometry(grid, CPU, F64)
    dt = build_dust_tables([lte_dust('port')], CPU, F64)
    st = build_source_tables([frontend('port').PointSource(
        luminosity=3.8e33, temperature=5000.0)], CPU, F64,
        length_scale=geo.length_scale)
    rho = np.full((1, int(np.prod(grid.shape))), 1e-17)
    solved = []
    inner = lucy.solve_pda

    def counted(*args, **kw):
        out = inner(*args, **kw)
        solved.append(out[1])
        return out

    monkeypatch.setattr(lucy, 'solve_pda', counted)
    res = run_lucy(geo, dt, st, torch.as_tensor(rho * geo.length_scale),
                   torch.Generator().manual_seed(2), n_photons=3000,
                   n_iterations=2, batch_size=1024, use_pda=True,
                   pda_tables=build_pda_tables(grid), verbose=False)
    assert len(solved) == 2 and max(solved) > 0
    assert np.isfinite(res.specific_energy).all()
    assert (res.specific_energy > 0).all()
    assert res.killed_geo == 0


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def class1_cyl(package, n=24, n_photons=3000, n_imaging=0):
    """chip_smoke.py's BASELINE config 3 model, built by ``package``'s
    front end on an n x n grid, without raytracing and 16 x 16 pixels."""
    return _chip_smoke().class1_cyl_model(
        n_w=n, n_z=n, n_photons=n_photons, n_iterations=1,
        n_imaging=n_imaging, raytracing=None, n_pix=16,
        frontend=frontend(package))


def test_class1_cyl_tables_match_jax():
    """config 3 built by both front ends at 24 x 24 cells: the same
    cylindrical walls, densities (the disk, the Ulrich envelope and its
    bipolar cavity) and source rows (the star and the ISRF sphere), and
    its engine tables equal; a short Lucy run on the port (50 steps at B =
    2,048, float32 as on the card) kills nothing by geometry and counts
    every photon."""
    from hyperion_tpu.model.run import _flatten_quantity as j_flatten
    from hyperion_tpu_torch.model.run import _flatten_quantity
    from test_torch_tables import _assert_fields_equal
    mj, mp = class1_cyl('jax'), class1_cyl('port')
    for f in ('w_wall', 'z_wall', 'p_wall'):
        np.testing.assert_array_equal(getattr(mp.grid, f),
                                      getattr(mj.grid, f), err_msg=f)
    np.testing.assert_allclose(_flatten_quantity(mp.grid, 'density'),
                               j_flatten(mj.grid, 'density'), rtol=1e-12,
                               atol=0)
    L = build_cylindrical_geometry(mp.grid, CPU, F64).length_scale
    from hyperion_tpu.transport import build_source_tables as j_sources
    _assert_fields_equal(
        build_source_tables(mp.sources, CPU, F64, length_scale=L,
                            grid=mp.grid),
        j_sources(mj.sources, dtype=jnp.float64, length_scale=L,
                  grid=mj.grid))
    from hyperion_tpu_torch.model.run import run_lucy_model
    run = run_lucy_model(mp, device='cpu', dtype=torch.float32,
                         batch_size=2048, max_steps=50)
    assert run.result.killed_geo == 0
    assert run.result.energy_current == 3000.0
    assert np.isfinite(run.result.temperature).all()


def test_rim_crossings_float32_against_float64():
    """config 3's full 200 x 199 grid, whose 27 rim shells span 7.6e-11 of
    the grid (about one float32 nudge): rays from the rim's float32-thin
    shells, crossed once with the float32 tables (the Lucy and imaging
    steps') and once with the float64 ones (the walks'). The float32 step
    lands in a cell that holds its own landing point within the
    self-check's margin, so no photon is killed there; on most of these
    rays (95%) it lands in another cell than the float64 step
    (ROADMAP.md F1b)."""
    m = class1_cyl('port', n=200)
    g32 = build_cylindrical_geometry(m.grid, CPU, torch.float32)
    g64 = build_cylindrical_geometry(m.grid, CPU, F64)
    rng = np.random.default_rng(47)
    n = 20000
    ww = g64.ww.numpy()
    w = ww[1] + rng.uniform(0.0, 1.2, n) * (ww[28] - ww[1])
    phi = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-3, 3, n) * g64.zw.numpy()[g64.n2 // 2 + 1]
    mu = rng.uniform(-1, 1, n)
    az = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack([w * np.cos(phi), w * np.sin(phi), z])
    k = np.stack([np.sqrt(1 - mu ** 2) * np.cos(az),
                  np.sqrt(1 - mu ** 2) * np.sin(az), mu])
    out = {}
    for g, dt in ((g32, torch.float32), (g64, F64)):
        args = [torch.as_tensor(a, dtype=dt) for a in (*pos, *k)]
        cell = g.find_cell(*args)
        t, nxt, _, _ = g.find_wall(cell.clamp_min(0), *args)
        land = [p + t * d for p, d in zip(args[:3], args[3:])]
        out[dt] = (cell, nxt, land)
    cell32, next32, land32 = out[torch.float32]
    _, next64, land64 = out[F64]
    ok = (cell32 >= 0) & (next32 >= 0) & (next64 >= 0)
    assert ok.sum() > 0.9 * n
    # the float32 landing lies in its own next cell within the self-check's
    # margin: the Lucy step kills nothing here
    assert g32.in_cell_tol(next32[ok], *(a[ok] for a in land32)).all()
    # F1b: the float32 step lands in another cell than the float64 one on
    # most of these rays (it steps over shells and z cells thinner than its
    # exclusion)
    differ = (next32 != next64) & ok
    assert differ.double().mean() > 0.5


@pytest.mark.slow
def test_class1_cyl_within_noise_of_jax(tmp_path):
    """config 3 at 24 x 24 cells through both packages (one Lucy iteration
    of 10,000 photons and 1,000 imaging photons, float64): the temperatures
    of the cells that both visit with >= 100 photons agree in the median
    to 3%, and the peeled SEDs (summed over wavelength, per view) within
    5 sigma of both runs' uncertainties plus 5%. The disk's diffusion tail
    sets the steps, and the port's plain walk per peel event on the CPU
    makes its imaging slow (~15 minutes in all)."""
    from hyperion_tpu.model.run import run_model as j_run_model
    from hyperion_tpu_torch.model.run import run_model
    outs = {}
    for pkg in ('jax', 'port'):
        m = class1_cyl(pkg, n_photons=10000, n_imaging=1000)
        m.conf.output.output_n_photons = 'last'
        path = str(tmp_path / ('c1_%s.rtout' % pkg))
        m.write(path.replace('.rtout', '.rtin'))
        if pkg == 'jax':
            j_run_model(m, path, batch_size=4096)
        else:
            run_model(m, path, device='cpu', batch_size=4096)
        outs[pkg] = frontend('jax').ModelOutput(path)
    q = {p: o.get_quantities() for p, o in outs.items()}
    tj, tp = (np.asarray(q[p]['temperature'][0].array) for p in
              ('jax', 'port'))
    nj, np_ = (np.asarray(q[p]['n_photons'].array) for p in ('jax', 'port'))
    sel = (nj >= 100) & (np_ >= 100)
    assert sel.sum() > 50
    assert abs(np.median(tp[sel] / tj[sel]) - 1.0) < 0.03
    for inc in range(3):
        sj, sp = (outs[p].get_sed(inclination=inc, aperture=-1,
                                  uncertainties=True) for p in ('jax',
                                                                'port'))
        a, b = sj.val.sum(), sp.val.sum()
        sigma = np.hypot(np.sqrt((sj.unc ** 2).sum()),
                         np.sqrt((sp.unc ** 2).sum()))
        assert abs(a - b) <= 5 * sigma + 0.05 * max(a, b), (inc, a, b)


def _hseq_model(package):
    """A small cylindrical AnalyticalYSOModel for run_with_vertical_hseq:
    chip_smoke.s config 3 star and disk on 16 x 23 cells, no envelope."""
    F = frontend(package)
    nu = np.logspace(8, 17, 64)
    dust = F.HenyeyGreensteinDust(nu, np.repeat(0.5, 64),
                                  np.repeat(400.0, 64), np.repeat(0.4, 64),
                                  np.repeat(0.8, 64))
    m = F.AnalyticalYSOModel()
    m.star.luminosity = F.lsun
    m.star.radius = 2.0 * F.rsun
    m.star.temperature = 4300.0
    m.star.mass = 0.5 * F.msun
    disk = m.add_flared_disk()
    disk.mass = 1e-8 * F.msun
    disk.rmin = 1.0 * F.au
    disk.rmax = 100.0 * F.au
    disk.r_0 = 10.0 * F.au
    disk.h_0 = 1.0 * F.au
    disk.p = -1.0
    disk.beta = 1.25
    disk.dust = dust
    m.set_cylindrical_polar_grid_auto(16, 24, 1)
    # the helper reads each run's density and temperature back
    m.conf.output.output_density = 'last'
    m.conf.output.output_specific_energy = 'last'
    m.set_n_initial_iterations(1)
    m.set_n_photons(initial=4000, imaging=0)
    m.set_seed(-21)
    return m


def test_run_with_vertical_hseq_within_noise_of_jax(tmp_path):
    """Two hydrostatic-equilibrium iterations of a thin disk on 16 x 23
    cells. The JAX package's helper runs its first RT run and then raises
    at its first iteration (``grid['density'] = [arrays]``, which its grid
    refuses); the port's runs on. Against the JAX package's first run: the
    port's first temperatures agree in the median of the cells both visit
    >= 100 times to 3%, and its first iteration's densities, from its own
    temperatures, match the JAX hseq_profile of the JAX temperatures in
    each column's mean height above the midplane to 10% in the median;
    every column keeps its surface density."""
    from hyperion_tpu.model.helpers import hseq_profile as j_profile
    from hyperion_tpu.model.helpers import run_with_vertical_hseq as j_hseq
    from hyperion_tpu_torch.model.helpers import run_with_vertical_hseq
    with pytest.raises(ValueError, match='GridView'):
        j_hseq(str(tmp_path / 'j'), _hseq_model('jax'), n_iter=2)
    last = run_with_vertical_hseq(str(tmp_path / 'p'), _hseq_model('port'),
                                  n_iter=2, device='cpu', batch_size=2048)
    read = frontend('jax').ModelOutput
    gj = read(str(tmp_path / 'j_00000.rtout')).get_quantities()
    gp0 = read(str(tmp_path / 'p_00000.rtout')).get_quantities()
    gp1 = read(str(tmp_path / 'p_00001.rtout')).get_quantities()
    assert read(last).get_quantities() is not None
    tj = np.asarray(gj['temperature'][0].array)[0]
    tp = np.asarray(gp0['temperature'][0].array)[0]
    seen = (tj > 1.0) & (tp > 1.0)
    assert abs(np.median(tp[seen] / tj[seen]) - 1.0) < 0.03
    z, w = gj.z, gj.w
    rho0 = np.asarray(gj['density'][0].array)[0]
    rho1 = np.asarray(gp1['density'][0].array)[0]
    sigma0 = np.trapezoid(rho0, z, axis=0)
    np.testing.assert_allclose(np.trapezoid(rho1, z, axis=0), sigma0,
                               rtol=1e-6)
    tj = np.where(tj < 1.0, tj.max(axis=0, keepdims=True), tj)
    ref = np.stack([sigma0[i] * j_profile(w[i], z, tj[:, i], 0.5 * 1.989e33)
                    if sigma0[i] > 0 else np.zeros_like(z)
                    for i in range(len(w))], axis=1)
    upper = z > 0

    def height(rho):
        return (rho[upper] * z[upper, None]).sum(axis=0) / \
            np.maximum(rho[upper].sum(axis=0), 1e-300)

    ok = sigma0 > 0
    assert abs(np.median(height(rho1)[ok] / height(ref)[ok]) - 1.0) < 0.1


def test_run_with_vertical_hseq_on_the_port(tmp_path):
    """One hydrostatic-equilibrium iteration of the port alone on 16 x 23
    cells: each column keeps its surface density, its profile is
    hseq_profile of the first run's temperatures, and a non-cylindrical or
    massless-star model is refused."""
    from hyperion_tpu_torch.model.helpers import (hseq_profile,
                                                  run_with_vertical_hseq)
    m = _hseq_model('port')
    m.set_n_photons(initial=1000, imaging=0)
    path = run_with_vertical_hseq(str(tmp_path / 'p'), m, n_iter=1,
                                  device='cpu', batch_size=1024)
    out = frontend('port').ModelOutput
    g0 = out(str(tmp_path / 'p_00000.rtout')).get_quantities()
    g1 = out(path).get_quantities()
    rho0 = np.asarray(g0['density'][0].array)[0]
    rho1 = np.asarray(g1['density'][0].array)[0]
    z = g1.z
    np.testing.assert_allclose(np.trapezoid(rho1, z, axis=0),
                               np.trapezoid(rho0, z, axis=0), rtol=1e-6)
    t0 = np.asarray(g0['temperature'][0].array)[0]
    t0 = np.where(t0 < 1.0, t0.max(axis=0, keepdims=True), t0)
    i = int(np.argmax(np.trapezoid(rho0, z, axis=0)))
    prof = hseq_profile(g1.w[i], z, t0[:, i], m.star.mass)
    np.testing.assert_allclose(rho1[:, i], np.trapezoid(rho0[:, i], z) *
                               prof, rtol=1e-6, atol=1e-12 * rho1.max())
    m2 = _hseq_model('port')
    m2.star.mass = None
    with pytest.raises(ValueError, match='mass'):
        run_with_vertical_hseq(str(tmp_path / 'q'), m2, n_iter=1,
                               device='cpu')
