"""The port's per-event physics against the JAX engine's, fed the same
uniforms: each JAX function draws from its key, and the test draws the same
uniforms from that key, following the function's own split sequence, and
hands them to the port. Floats match to rtol 1e-12; integer outputs and
masks are equal."""

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
