"""The port's sampling primitives and between-iteration physics against the
JAX package's, on the same numpy inputs (JAX x64, torch float64). Integer
outputs must be equal and floats match to rtol 1e-12; the two samplers that
draw their own numbers get distribution tests instead."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy import stats

from hyperion_tpu.transport import build_dust_tables as j_dust
from hyperion_tpu.transport import lucy as jl
from hyperion_tpu.transport import sampling as js
from hyperion_tpu_torch.transport import lucy as tl
from hyperion_tpu_torch.transport import sampling as ts
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from test_torch_frontend import lte_dust

torch.set_num_threads(1)
RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(port, ref, rtol=RTOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=0)


def test_interp_loglog_and_linear():
    rng = np.random.default_rng(1)
    xt = np.sort(rng.uniform(1.0, 1e4, 40))
    yt = rng.uniform(0.1, 10.0, 40)
    yt[7] = 0.0   # the zero-table guard of interp_loglog
    x = np.concatenate([rng.uniform(0.5, 2e4, 500), xt[:5], [xt[0], xt[-1]]])
    _close(ts.interp_loglog(_t(xt), _t(yt), _t(x)),
           js.interp_loglog(jnp.asarray(xt), jnp.asarray(yt), jnp.asarray(x)))
    _close(ts.interp_linear(_t(xt), _t(yt), _t(x)),
           js.interp_linear(jnp.asarray(xt), jnp.asarray(yt), jnp.asarray(x)))


@pytest.mark.parametrize('exp2', [False, True])
def test_sample_quantile_rows(exp2):
    rng = np.random.default_rng(2)
    qtab = np.sort(rng.uniform(-5.0, 20.0, (6, 33)), axis=1)
    rows = rng.integers(0, 6, 1000)
    xi = np.concatenate([rng.random(996), [0.0, 1.0 - 2 ** -53, 0.5, 1e-9]])
    _close(ts.sample_quantile_rows(_t(qtab), _t(rows), _t(xi), exp2=exp2),
           js.sample_quantile_rows(jnp.asarray(qtab), jnp.asarray(rows),
                                   jnp.asarray(xi), exp2=exp2))


def test_searchsorted():
    rng = np.random.default_rng(3)
    table = np.sort(rng.uniform(0.0, 1.0, 65))
    x = np.concatenate([rng.uniform(-0.1, 1.1, 1000), table[::4]])
    np.testing.assert_array_equal(
        ts.searchsorted_right(_t(table), _t(x)).numpy(),
        np.asarray(js.searchsorted_small(jnp.asarray(table), jnp.asarray(x),
                                         side='right')))
    # per-row search: the port searches each row and selects by row
    rows_tab = np.sort(rng.uniform(0.0, 1.0, (3, 300)), axis=1)
    rows = rng.integers(0, 3, len(x))
    ref = js.searchsorted_rows(jnp.asarray(rows_tab), jnp.asarray(rows),
                               jnp.asarray(x))
    per_row = torch.stack([ts.searchsorted_right(_t(rows_tab[r]), _t(x))
                           for r in range(3)], dim=1)
    port = per_row.gather(1, _t(rows)[:, None])[:, 0]
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_rotate_direction():
    rng = np.random.default_rng(4)
    n = 1000
    mu = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    st = np.sqrt(1 - mu ** 2)
    k = np.stack([st * np.cos(phi), st * np.sin(phi), mu])
    # polar and axis-aligned directions take the fallback frame
    k[:, :4] = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0]]).T
    cos_t = rng.uniform(-1, 1, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    port = ts.rotate_direction(*map(_t, (k[0], k[1], k[2], cos_t, ph)))
    ref = js.rotate_direction(*map(jnp.asarray, (k[0], k[1], k[2], cos_t,
                                                 ph)))
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-15)


def test_isotropic_direction_distribution():
    g = torch.Generator().manual_seed(5)
    u = torch.rand((2, 20000), generator=g, dtype=torch.float64)
    kx, ky, kz = ts.isotropic_direction(u[0], u[1])
    np.testing.assert_allclose((kx ** 2 + ky ** 2 + kz ** 2).numpy(), 1.0,
                               rtol=1e-12)
    assert stats.kstest(kz.numpy(), stats.uniform(-1, 2).cdf).pvalue > 1e-3
    phi = np.arctan2(ky.numpy(), kx.numpy()) % (2 * np.pi)
    assert stats.kstest(phi, stats.uniform(0, 2 * np.pi).cdf).pvalue > 1e-3


def test_random_exp_distribution():
    g = torch.Generator().manual_seed(6)
    tau = ts.random_exp(torch.rand(20000, generator=g, dtype=torch.float64))
    assert torch.isfinite(tau).all() and (tau >= 0).all()
    assert stats.kstest(tau.numpy(), stats.expon.cdf).pvalue > 1e-3
    # an exact zero draw stays finite
    assert torch.isfinite(ts.random_exp(torch.zeros(1, dtype=torch.float64)))


def _dust(package, mode=None, energy=None):
    d = lte_dust(package)
    if mode is not None:
        d.set_sublimation_specific_energy(mode, energy)
    return d


@pytest.fixture(scope='module')
def tables():
    """JAX and port tables of two dusts (the second one sublimates)."""
    return (j_dust([_dust('jax'), _dust('jax', 'fast', 1.0)],
                   dtype=jnp.float64),
            build_dust_tables([_dust('port'), _dust('port', 'fast', 1.0)],
                              torch.device('cpu'), torch.float64))


def _energies(jt, n_cells=400, seed=7):
    """Specific energies spanning below, inside and above each dust's
    emissivity grid, plus exact grid values and zeros."""
    rng = np.random.default_rng(seed)
    var = np.asarray(jt.emiss_var)
    se = 10 ** rng.uniform(np.log10(var[:, 0] / 10), np.log10(var[:, -1] * 10),
                           (n_cells, var.shape[0])).T
    se[:, :5] = var[:, :5]
    se[:, 5] = 0.0
    return se


def test_compute_jnu_var(tables):
    jt, pt = tables
    se = _energies(jt)
    ids, fracs = tl.compute_jnu_var(pt, _t(se))
    j_ids, j_fracs = jl.compute_jnu_var(jt, jnp.asarray(se))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    _close(fracs, j_fracs)


def test_specific_energy_to_temperature(tables):
    jt, pt = tables
    se = _energies(jt)
    _close(tl.specific_energy_to_temperature(pt, _t(se)),
           jl.specific_energy_to_temperature(jt, jnp.asarray(se)))


def test_normalize_specific_energy():
    rng = np.random.default_rng(8)
    es = rng.random((2, 300)) * 1e3
    vol = rng.uniform(0.5, 2.0, 300)
    vol[:3] = 0.0
    _close(tl.normalize_specific_energy(_t(es), 3.7e-5, _t(vol)),
           jl.normalize_specific_energy(jnp.asarray(es), 3.7e-5,
                                        jnp.asarray(vol)))


@pytest.mark.parametrize('minimum', [None, [1e-4, 3e-3]])
@pytest.mark.parametrize('enforce', [False, True])
def test_enforce_energy_limits(tables, minimum, enforce):
    jt, pt = tables
    se = _energies(jt)
    _close(tl.enforce_energy_limits(pt, _t(se), minimum, enforce),
           jl.enforce_energy_limits(jt, jnp.asarray(se), minimum, enforce))


@pytest.mark.parametrize('mode', ['no', 'fast', 'slow', 'cap'])
def test_sublimate_dust(mode):
    jt = j_dust([_dust('jax'), _dust('jax', mode, 0.5)], dtype=jnp.float64)
    pt = build_dust_tables([_dust('port'), _dust('port', mode, 0.5)],
                           torch.device('cpu'), torch.float64)
    se = _energies(jt)
    rho = np.random.default_rng(9).uniform(0.1, 1.0, se.shape)
    rho_p, se_p = tl.sublimate_dust(pt, _t(rho), _t(se), [1e-3, 2e-3])
    rho_j, se_j = jl.sublimate_dust(jt, jnp.asarray(rho), jnp.asarray(se),
                                    [1e-3, 2e-3])
    _close(rho_p, rho_j)
    _close(se_p, se_j)
