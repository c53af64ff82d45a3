"""The port's per-event physics against the JAX engine's, fed the same
uniforms: each JAX function draws from its key, and the test draws the same
uniforms from that key, following the function's own split sequence, and
hands them to the port. Floats match to rtol 1e-12; integer outputs and
masks are equal. The YSO path's pieces too: sphere, limb and spot
emission, source intersections, the MRW tables and move, and the host
copies of the spectrum-bin fractions and the PDA solver."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperion_tpu.transport import build_dust_tables as j_dust
from hyperion_tpu.transport import build_source_tables as j_sources
from hyperion_tpu.transport import engine as je
from hyperion_tpu.transport.stable import emit_packets as j_emit
from hyperion_tpu_torch.transport import engine as te
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.stable import (build_source_tables,
                                                 emit_packets)
from hyperion_tpu_torch.util.constants import au, lsun
from test_torch_frontend import frontend, point_sources

torch.set_num_threads(1)
RTOL = 1e-12
F64 = jnp.float64
B = 2000


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-300)


def _uniform(key, n=B):
    return jax.random.uniform(key, (n,), dtype=F64)


def _dusts(package):
    out = []
    for alb, chi in [(0.4, 60.0), (0.7, 20.0)]:
        nu = np.logspace(np.log10(3e10), np.log10(5e16), 24)
        d = frontend(package).IsotropicDust(
            nu, np.linspace(alb - 0.3, alb + 0.2, 24),
            np.geomspace(chi, chi * 30, 24))
        d.set_lte_emissivities(n_temp=40, temp_min=0.1, temp_max=1600.)
        out.append(d)
    return out


@pytest.fixture(scope='module')
def setup():
    """JAX and port tables of two dusts, and one batch of lane state."""
    jt = j_dust(_dusts('jax'), dtype=F64)
    pt = build_dust_tables(_dusts('port'), torch.device('cpu'),
                           torch.float64)
    rng = np.random.default_rng(11)
    nu_tab = np.asarray(jt.nu)
    nu = 10 ** rng.uniform(np.log10(nu_tab.min()), np.log10(nu_tab.max()), B)
    mu = rng.uniform(-1, 1, B)
    phi = rng.uniform(0, 2 * np.pi, B)
    st = np.sqrt(1 - mu ** 2)
    lanes = dict(
        nu=nu, kx=st * np.cos(phi), ky=st * np.sin(phi), kz=mu,
        rho_rows=rng.uniform(0.0, 1.0, (B, 2)),
        vid_rows=rng.integers(0, jt.n_var - 1, (B, 2)),
        vfrac_rows=rng.random((B, 2)),
        interacting=rng.random(B) < 0.6)
    lanes['rho_rows'][:50, 1] = 0.0
    return jt, pt, lanes


def test_update_optical_constants(setup):
    jt, pt, lanes = setup
    for a, b in zip(te.update_optical_constants(pt, _t(lanes['nu'])),
                    je.update_optical_constants(jt, jnp.asarray(lanes['nu']))):
        _close(a, b)


def test_select_dust(setup):
    jt, pt, lanes = setup
    chi = je.update_optical_constants(jt, jnp.asarray(lanes['nu']))[0]
    key = jax.random.PRNGKey(1)
    ref = je.select_dust(key, chi, jnp.asarray(lanes['rho_rows']))
    port = te.select_dust(_t(_uniform(key)), _t(chi), _t(lanes['rho_rows']))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_sample_emission_nu(setup):
    jt, pt, lanes = setup
    rng = np.random.default_rng(12)
    d = rng.integers(0, 2, B)
    vid = rng.integers(0, jt.n_var - 1, B)
    vfrac = rng.random(B)
    key = jax.random.PRNGKey(2)
    ref = je.sample_emission_nu(jt, jnp.asarray(d), jnp.asarray(vid),
                                jnp.asarray(vfrac), key)
    k_bin, k_xi = jax.random.split(key)
    port = te.sample_emission_nu(pt, _t(d), _t(vid), _t(vfrac),
                                 _t(_uniform(k_bin)), _t(_uniform(k_xi)))
    _close(port, ref)


def test_sample_scattering_mu(setup):
    jt, pt, lanes = setup
    d = np.random.default_rng(13).integers(0, 2, B)
    key = jax.random.PRNGKey(3)
    ref = je.sample_scattering_mu(jt, jnp.asarray(d),
                                  jnp.asarray(lanes['nu']), key)
    port = te.sample_scattering_mu(pt, _t(d), _t(lanes['nu']),
                                   _t(_uniform(key)))
    _close(port, ref)


def test_interaction_update(setup):
    jt, pt, lanes = setup
    chi, kappa, albedo = je.update_optical_constants(
        jt, jnp.asarray(lanes['nu']))
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    k_dust, k_coin, k_nu, k_dir, k_mu, k_phi = keys
    names = ('nu', 'kx', 'ky', 'kz')
    ref = je.interaction_update(
        jt, tuple(keys), jnp.asarray(lanes['interacting']),
        *(jnp.asarray(lanes[n]) for n in names), chi, albedo,
        jnp.asarray(lanes['rho_rows']), jnp.asarray(lanes['vid_rows']),
        jnp.asarray(lanes['vfrac_rows']), F64, fused_sampler=None)
    k_bin, k_xi = jax.random.split(k_nu)
    k_dir_mu, k_dir_phi = jax.random.split(k_dir)
    u = tuple(_t(_uniform(k)) for k in (k_dust, k_coin, k_bin, k_xi,
                                        k_dir_mu, k_dir_phi, k_mu, k_phi))
    port = te.interaction_update(
        pt, u, _t(lanes['interacting']), *(_t(lanes[n]) for n in names),
        _t(chi), _t(albedo), _t(lanes['rho_rows']), _t(lanes['vid_rows']),
        _t(lanes['vfrac_rows']))
    assert np.asarray(ref['absorbed']).any()
    assert np.asarray(ref['scattered']).any()
    for k in ('d_sel', 'absorbed', 'scattered'):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ('nu', 'kx', 'ky', 'kz', 'chi', 'kappa_abs', 'albedo_abs'):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=1e-14, err_msg=k)


def test_emit_packets_point_sources():
    jst = j_sources(point_sources('jax'), dtype=F64, sample_evenly=True)
    pst = build_source_tables(point_sources('port'), torch.device('cpu'),
                              torch.float64, sample_evenly=True)
    key = jax.random.PRNGKey(5)
    ref = j_emit(jst, key, B, F64)
    k_src, k_nu, k_dir, _, _ = jax.random.split(key, 5)
    k1, _ = jax.random.split(k_dir)
    k_mu, k_phi = jax.random.split(k1)
    port = emit_packets(pst, *(_t(_uniform(k))
                               for k in (k_src, k_nu, k_mu, k_phi)))
    for k in ('x', 'y', 'z', 'kx', 'ky', 'kz', 'nu', 'energy'):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=1e-15, err_msg=k)


# ---- the YSO path: spherical sources, MRW, spectrum bins, PDA ----

def _sphere_sources(package):
    from test_torch_tables import star_with_spots
    star, point = star_with_spots(package)
    plain = frontend(package).SphericalSource(
        luminosity=0.5 * lsun, temperature=3000.0, radius=1e12,
        position=(-0.3 * au, 0.2 * au, 0.1 * au))
    return [star, point, plain]


@pytest.fixture(scope='module')
def spheres():
    kw = dict(length_scale=au, sample_evenly=False)
    jst = j_sources(_sphere_sources('jax'), dtype=F64, **kw)
    pst = build_source_tables(_sphere_sources('port'), torch.device('cpu'),
                              torch.float64, **kw)
    return jst, pst


def _emit_uniforms(key):
    """The uniforms JAX's emit_packets draws from ``key``, in the port's
    order: (u_src, u_nu, u_mu, u_phi), (u_cap, u_cap_phi, u_out,
    u_out_phi)."""
    k_src, k_nu, k_dir, k_pos, _ = jax.random.split(key, 5)
    k_cap1, k_cap2 = jax.random.split(k_pos)
    k1, k2 = jax.random.split(k_dir)
    k_mu, k_phi = jax.random.split(k1)
    u = [_t(_uniform(k)) for k in (k_src, k_nu, k_mu, k_phi)]
    return u, tuple(_t(_uniform(k)) for k in (
        k_cap1, k_cap2, k2, jax.random.fold_in(k2, 1)))


@pytest.mark.parametrize('reemit', [False, True])
def test_emit_packets_spheres_limb_spots(spheres, reemit):
    """Point, limb-darkened spotted and plain sphere rows: surface points
    (on the spots' caps), outward cosine-law or limb-darkened directions;
    with ``src`` given, the re-emission from those rows."""
    jst, pst = spheres
    key = jax.random.PRNGKey(6)
    src = np.random.default_rng(7).integers(0, pst.n_sources, B) \
        if reemit else None
    ref = j_emit(jst, key, B, F64,
                 src=None if src is None else jnp.asarray(src))
    u, u_sphere = _emit_uniforms(key)
    port = emit_packets(pst, *u, u_sphere,
                        src=None if src is None else _t(src))
    for k in ('x', 'y', 'z', 'kx', 'ky', 'kz', 'nu', 'energy'):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=1e-15, err_msg=k)
    # every row was drawn, and sphere photons leave their surface outward
    rows = np.asarray(ref['source'])
    assert len(np.unique(rows)) == pst.n_sources
    pos = np.stack([port[k].numpy() for k in 'xyz'])
    k = np.stack([port[k].numpy() for k in ('kx', 'ky', 'kz')])
    normal = pos - pst.position.numpy()[rows].T
    sphere = pst.type_code.numpy()[rows] == 2
    assert (np.einsum('ij,ij->j', normal, k)[sphere] >= 0).all()


def test_nearest_source_intersection(spheres):
    """Rays from around the spheres, from their surfaces (the 1e-3 radius
    exclusion) and from far away, toward and away from them."""
    from hyperion_tpu.transport.stable import \
        nearest_source_intersection as j_near
    from hyperion_tpu_torch.transport.stable import \
        nearest_source_intersection
    jst, pst = spheres
    rng = np.random.default_rng(8)
    rows = rng.choice(np.where(pst.intersect.numpy())[0], B)
    centre = pst.position.numpy()[rows]
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    dist = pst.radius.numpy()[rows] * np.where(rng.random(B) < 0.3, 1.0,
                                               rng.uniform(1.0, 30.0, B))
    pos = centre + d * dist[:, None]
    k = -d + rng.normal(scale=0.3, size=(B, 3))
    k[rng.random(B) < 0.3] *= -1.0
    k /= np.linalg.norm(k, axis=1)[:, None]
    t_j, row_j = j_near(jst, *(jnp.asarray(a) for a in (*pos.T, *k.T)))
    t_p, row_p = nearest_source_intersection(pst, *(_t(a)
                                                    for a in (*pos.T, *k.T)))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=RTOL)
    hit = np.asarray(t_j) < 1e300
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(row_p.numpy()[hit], np.asarray(row_j)[hit])


@pytest.fixture(scope='module')
def mrw_tables(setup):
    from hyperion_tpu.transport.mrw import prepare_mrw_tables as j_prepare
    from hyperion_tpu_torch.convert import mrw_tables_from_numpy
    from hyperion_tpu_torch.transport.mrw import prepare_mrw_tables
    jt, pt, _ = setup
    rng = np.random.default_rng(9)
    density = rng.uniform(0.0, 50.0, (2, 300))
    density[:, :20] = 0.0
    se = 10 ** rng.uniform(-4, 6, (2, 300))
    ref = j_prepare(jt, jnp.asarray(density), jnp.asarray(se), 1.5, F64)
    port = prepare_mrw_tables(pt, _t(density), _t(se), 1.5)
    return ref, port, mrw_tables_from_numpy(
        {k: np.asarray(v) for k, v in ref._asdict().items()},
        torch.device('cpu'), torch.float64)


def test_prepare_mrw_tables_and_sample_min09(mrw_tables):
    from hyperion_tpu.transport.mrw import sample_min09 as j_sample
    from hyperion_tpu_torch.transport.mrw import sample_min09
    ref, port, carried = mrw_tables
    for k in ('alpha_inv_planck', 'kappa_planck', 'x_grid'):
        _close(getattr(port, k), getattr(ref, k))
        np.testing.assert_array_equal(getattr(carried, k).numpy(),
                                      np.asarray(getattr(ref, k)))
    assert port.gamma == carried.gamma == 1.5
    key = jax.random.PRNGKey(10)
    _close(sample_min09(port, _t(_uniform(key))),
           j_sample(ref, key, (B,), F64))


def test_mrw_jump_update(setup, mrw_tables):
    jt, pt, lanes = setup
    ref_t, _, port_t = mrw_tables
    rng = np.random.default_rng(11)
    chi = je.update_optical_constants(jt, jnp.asarray(lanes['nu']))[0]
    cell = rng.integers(0, 300, B)
    args = dict(
        mrw_now=rng.random(B) < 0.5, x=rng.normal(size=B),
        y=rng.normal(size=B), z=rng.normal(size=B),
        energy=rng.uniform(0.5, 2.0, B), d_close=rng.uniform(0, 0.1, B),
        alpha_inv=np.asarray(ref_t.alpha_inv_planck)[cell],
        kappa_p_rows=np.asarray(ref_t.kappa_planck).T[cell])
    keys = jax.random.split(jax.random.PRNGKey(12), 5)
    rows = [lanes[k] for k in ('rho_rows', 'vid_rows', 'vfrac_rows')]
    ref = je.mrw_jump_update(
        jt, ref_t, tuple(keys), jnp.asarray(args['mrw_now']),
        *(jnp.asarray(args[k]) for k in ('x', 'y', 'z', 'energy')), chi,
        *(jnp.asarray(args[k]) for k in ('d_close', 'alpha_inv',
                                           'kappa_p_rows')),
        *(jnp.asarray(r) for r in rows), F64)
    k1, k2, k3, k4, k5 = keys
    u = [_uniform(k1), *(_uniform(k) for k in jax.random.split(k2)),
         *(_uniform(k) for k in jax.random.split(k3)), _uniform(k4),
         *(_uniform(k) for k in jax.random.split(k5))]
    port = te.mrw_jump_update(
        pt, port_t, [_t(v) for v in u], _t(args['mrw_now']),
        *(_t(args[k]) for k in ('x', 'y', 'z', 'energy')), _t(chi),
        *(_t(args[k]) for k in ('d_close', 'alpha_inv', 'kappa_p_rows')),
        *(_t(r) for r in rows))
    deps, *rest = ref
    _close(port[0], np.stack(deps, axis=-1))
    assert (np.stack(deps)[:, ~args['mrw_now']] == 0).all()
    assert (np.stack(deps) > 0).any()
    for a, b in zip(port[1:4], rest[0:3]):
        _close(a, b)
    for a, b in zip(port[4], rest[3]):
        _close(a, b)
    for a, b in zip(port[5:], rest[4:]):
        _close(a, b)


def test_spectrum_bin_fractions(setup):
    from hyperion_tpu.transport.lucy import spectrum_bin_fractions as j_frac
    from hyperion_tpu_torch.transport.lucy import spectrum_bin_fractions
    jt, pt, _ = setup
    edges = np.logspace(9, 17, 7)
    ref = j_frac(jt, edges)
    np.testing.assert_allclose(spectrum_bin_fractions(pt, edges), ref,
                               rtol=RTOL, atol=1e-300)
    assert (ref.sum(axis=1) > 0.5).all()


@pytest.mark.parametrize('n_cells_starved', [12, 30])
def test_solve_pda(setup, n_cells_starved):
    """The same fields into both copies of solve_pda, on a spherical-polar
    grid: the photon-starved cells' specific energies match."""
    from hyperion_tpu.transport.pda import build_pda_tables as j_tables
    from hyperion_tpu.transport.pda import solve_pda as j_solve
    from hyperion_tpu_torch.transport.pda import build_pda_tables, solve_pda
    jt, pt, _ = setup

    def grid(package):
        return frontend(package).SphericalPolarGrid(
            np.hstack([0.0, np.geomspace(1e12, 1e14, 12)]),
            np.linspace(0.0, np.pi, 9), np.linspace(0.0, 2 * np.pi, 4))

    rng = np.random.default_rng(13)
    n_cells = 12 * 8 * 3
    density = rng.uniform(1e-19, 1e-17, (2, n_cells))
    se = 10 ** rng.uniform(-2, 3, (2, n_cells))
    n_phot = rng.integers(40, 400, n_cells)
    n_phot[rng.choice(n_cells, n_cells_starved, replace=False)] = 3
    ref, n_ref = j_solve(j_tables(grid('jax')), jt, density, se, n_phot)
    port, n_port = solve_pda(build_pda_tables(grid('port')), pt, density,
                             se, n_phot)
    assert n_port == n_ref > 0
    np.testing.assert_allclose(port, ref, rtol=RTOL)
    assert (port != se).any()
