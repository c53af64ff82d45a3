"""Dust tables of the port (counterpart of
``hyperion_tpu/transport/dtable.py``).

The host code is the JAX package's numpy, copied because importing any
``hyperion_tpu.transport`` module imports JAX; only the tables the Lucy
and imaging paths read are built (with MRW, PDA, spectrum bins and the
scattering matrix for peeling and polarization). All CDFs are made
on the host in float64 and the tensors are cast to the engine dtype."""

from dataclasses import dataclass

import numpy as np
import torch

from .sampling import quantile_table


@dataclass
class DustTables:
    # opacities: (n_dust, n_nu) log-log tables, padded by edge replication;
    # kappa is derived as chi * (1 - albedo) where it is needed
    nu: torch.Tensor
    chi: torch.Tensor
    albedo: torch.Tensor
    # emissivity specific-energy grid (n_dust, n_var) and its log10
    emiss_var: torch.Tensor
    log_emiss_var: torch.Tensor
    # emissivity frequencies (n_dust, n_enu) and the CDFs of j_nu over them
    # per (dust, var) row, (n_dust * n_var, n_enu): the spectrum bins'
    # emissivity fractions
    emiss_nu: torch.Tensor
    jnu_cdf: torch.Tensor
    # log2(nu) quantile tables of j_nu, and of b_nu = j_nu / kappa (the MRW
    # re-emission, ref dust_setup), (n_dust * n_var, n_q)
    jnu_q: torch.Tensor
    bnu_q: torch.Tensor
    # mu quantile tables of the P1 phase function, (n_dust * n_nu, n_q_mu)
    mu_q: torch.Tensor
    # the scattering matrix for peeling and polarization: mu grid (n_dust,
    # n_mu); P1..P4 scaled by one norm per (dust, nu) row so that P1's
    # solid-angle mean is 1, (n_dust * n_nu, n_mu); the unnormalized
    # cumulatives of P1 and P2 over mu (same scale) that the polarized mu
    # sampler inverts (ref dust_scatter, dust_type_4elem.f90:504-545)
    mu: torch.Tensor
    P1_peel: torch.Tensor
    P2_peel: torch.Tensor
    P3_peel: torch.Tensor
    P4_peel: torch.Tensor
    P1_cum: torch.Tensor
    P2_cum: torch.Tensor
    # mean opacities vs specific energy: (n_dust, n_e); kappa_planck and
    # chi_inv_planck feed the MRW tables and the PDA
    me_specific_energy: torch.Tensor
    me_temperature: torch.Tensor
    me_kappa_planck: torch.Tensor
    me_chi_inv_planck: torch.Tensor
    me_chi_rosseland: torch.Tensor
    # sublimation: (n_dust,) mode codes 0=no 1=fast 2=slow 3=cap + threshold
    sublimation_mode: torch.Tensor
    sublimation_energy: torch.Tensor

    @property
    def n_dust(self):
        return self.nu.shape[0]

    @property
    def n_var(self):
        return self.emiss_var.shape[1]


def _pad_to(arr, n):
    """Pad a 1-D array to length n by replicating its final value."""
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad)])


def _pad_rows(cdf, n_rows, n_cols):
    """A (rows, cols) CDF table padded to (n_rows, n_cols): missing rows
    repeat the last row, missing columns hold 1."""
    out = np.ones((n_rows, n_cols))
    out[:cdf.shape[0], :cdf.shape[1]] = cdf
    out[cdf.shape[0]:, :cdf.shape[1]] = cdf[-1]
    return out


def _peel_matrix(mu_d, op, n_nu, n_mu):
    """The peel-normalized P1..P4 and the cumulatives of P1 and P2 over mu
    of one dust, each padded to (n_nu, n_mu) by edge replication (a copy of
    ``hyperion_tpu/transport/dtable.py:238-265``). A row with no P1 norm
    peels isotropically and unpolarized."""
    def pad2(a):
        return np.pad(a, ((0, n_nu - a.shape[0]), (0, n_mu - a.shape[1])),
                      mode='edge')

    P1 = np.asarray(op.P1, float)
    # 0.5 * np.trapezoid(P1, mu_d, axis=1), written out (np.trapezoid is
    # numpy >= 2 only)
    norm = 0.5 * (np.diff(mu_d)[None, :] * (P1[:, 1:] + P1[:, :-1])
                  / 2.0).sum(axis=1)
    with np.errstate(divide='ignore', invalid='ignore'):
        inv_norm = np.where(norm > 0, 1.0 / np.where(norm > 0, norm, 1.0),
                            1.0)
    pp = np.where(norm[:, None] > 0, P1 * inv_norm[:, None], 1.0)
    out = dict(P1_peel=pad2(pp))
    for k, empty in (('P2', 0.0), ('P3', 1.0), ('P4', 0.0)):
        p = np.asarray(getattr(op, k), float) * inv_norm[:, None]
        out[k + '_peel'] = pad2(np.where(norm[:, None] > 0, p, empty))
    dmu = np.diff(mu_d)[None, :]
    p2 = out['P2_peel'][:pp.shape[0], :len(mu_d)]
    for k, p in (('P1_cum', pp), ('P2_cum', p2)):
        seg = 0.5 * (p[:, :-1] + p[:, 1:]) * dmu
        out[k] = pad2(np.concatenate([np.zeros((pp.shape[0], 1)),
                                      np.cumsum(seg, axis=1)], axis=1))
    return out


def _cdf_loglog(x, y_rows):
    """Cumulative integral along x of piecewise power-law rows, normalized.

    y_rows is (n_rows, n_x). Returns (n_rows, n_x) with [:, 0] == 0 and
    [:, -1] == 1 (rows with zero integral become a uniform ramp).
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y_rows, dtype=float)
    x1, x2 = x[:-1], x[1:]
    y1, y2 = y[:, :-1], y[:, 1:]
    with np.errstate(divide='ignore', invalid='ignore'):
        b = np.log10(y2 / y1) / np.log10(x2 / x1)
        powlaw = y1 * x1 / (b + 1.0) * ((x2 / x1) ** (b + 1.0) - 1.0)
        logcase = x1 * y1 * np.log(x2 / x1)
    seg = np.where(np.abs(b + 1.0) < 1e-10, logcase, powlaw)
    seg = np.where((y1 == 0.0) | (y2 == 0.0), 0.0, seg)
    cdf = np.concatenate([np.zeros((y.shape[0], 1)), np.cumsum(seg, axis=1)],
                         axis=1)
    total = cdf[:, -1:]
    uniform = (x - x[0]) / (x[-1] - x[0])
    cdf = np.where(total > 0.0, cdf / np.where(total > 0.0, total, 1.0),
                   uniform[None, :])
    # a final value of exactly 1 keeps the inversion in range
    cdf[:, -1] = 1.0
    return cdf


def _cdf_linear(x, y_rows):
    """Trapezoidal cumulative integral along x, normalized per row."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y_rows, dtype=float)
    seg = 0.5 * (y[:, :-1] + y[:, 1:]) * np.diff(x)[None, :]
    cdf = np.concatenate([np.zeros((y.shape[0], 1)), np.cumsum(seg, axis=1)],
                         axis=1)
    total = cdf[:, -1:]
    uniform = (x - x[0]) / (x[-1] - x[0])
    cdf = np.where(total > 0.0, cdf / np.where(total > 0.0, total, 1.0),
                   uniform[None, :])
    cdf[:, -1] = 1.0
    return cdf


_PEEL_FIELDS = ('P1_peel', 'P2_peel', 'P3_peel', 'P4_peel', 'P1_cum',
                'P2_cum')
_SUBLIMATION_CODES = {'no': 0, 'fast': 1, 'slow': 2, 'cap': 3}


def build_dust_tables(dusts, device, dtype, n_quantiles=257,
                      n_quantiles_mu=129):
    """Build DustTables from a list of SphericalDust objects (completes each
    dust's mean opacities and LTE emissivities in place, as the JAX builder
    does)."""
    n_dust = len(dusts)
    for d in dusts:
        d.optical_properties.ensure_all_set()
        d._compute_mean_opacities()
        if not d.emissivities.all_set():
            d.emissivities.set_lte(d.optical_properties, d.mean_opacities)

    n_nu = max(len(d.optical_properties.nu) for d in dusts)
    n_mu = max(len(d.optical_properties.mu) for d in dusts)
    n_enu = max(len(d.emissivities.nu) for d in dusts)
    n_var = max(len(d.emissivities.var) for d in dusts)
    n_e = max(len(d.mean_opacities.temperature) for d in dusts)

    nu = np.zeros((n_dust, n_nu))
    chi = np.zeros((n_dust, n_nu))
    albedo = np.zeros((n_dust, n_nu))
    emiss_var = np.zeros((n_dust, n_var))
    emiss_nu = np.zeros((n_dust, n_enu))
    jnu_cdf = np.zeros((n_dust, n_var, n_enu))
    jnu_q = np.zeros((n_dust, n_var, n_quantiles))
    bnu_q = np.zeros((n_dust, n_var, n_quantiles))
    mu_q = np.zeros((n_dust, n_nu, n_quantiles_mu))
    mu = np.zeros((n_dust, n_mu))
    peel = {k: np.zeros((n_dust, n_nu, n_mu)) for k in _PEEL_FIELDS}
    me = {k: np.zeros((n_dust, n_e))
          for k in ('specific_energy', 'temperature', 'kappa_planck',
                    'chi_inv_planck', 'chi_rosseland')}
    subl_mode = np.zeros(n_dust, dtype=np.int32)
    subl_energy = np.zeros(n_dust)

    for i, d in enumerate(dusts):
        op = d.optical_properties
        op._sort()
        nu[i] = _pad_to(np.asarray(op.nu, float), n_nu)
        chi[i] = _pad_to(np.asarray(op.chi, float), n_nu)
        albedo[i] = _pad_to(np.asarray(op.albedo, float), n_nu)

        em = d.emissivities
        enu = np.asarray(em.nu, float)
        emiss_var[i] = _pad_to(np.asarray(em.var, float), n_var)
        emiss_nu[i] = _pad_to(enu, n_enu)
        # CDFs of j_nu and of b_nu = j_nu / kappa(nu) over nu per var bin
        # (ref dust_setup); missing var rows repeat the last, missing
        # frequencies hold 1
        rows = np.asarray(em.jnu, float).T
        kappa_enu = 10.0 ** np.interp(
            np.log10(enu), np.log10(np.asarray(op.nu, float)),
            np.log10(np.maximum(np.asarray(op.kappa, float), 1e-300)))
        cj = _pad_rows(_cdf_loglog(enu, rows), n_var, n_enu)
        cb = _pad_rows(_cdf_loglog(enu, rows / kappa_enu[None, :]), n_var,
                       n_enu)
        jnu_cdf[i] = cj
        jnu_q[i] = quantile_table(enu, cj[:, :len(enu)], n_quantiles,
                                  log2=True)
        bnu_q[i] = quantile_table(enu, cb[:, :len(enu)], n_quantiles,
                                  log2=True)

        mu_d = np.asarray(op.mu, float)
        mq = quantile_table(mu_d, _cdf_linear(mu_d, np.asarray(op.P1, float)),
                            n_quantiles_mu, log2=False)
        mu_q[i] = np.pad(mq, ((0, n_nu - mq.shape[0]), (0, 0)), mode='edge')
        mu[i] = _pad_to(mu_d, n_mu)
        for k, v in _peel_matrix(mu_d, op, n_nu, n_mu).items():
            peel[k][i] = v

        mo = d.mean_opacities
        for k in me:
            me[k][i] = _pad_to(np.asarray(getattr(mo, k), float), n_e)

        subl_mode[i] = _SUBLIMATION_CODES[d.sublimation_mode]
        subl_energy[i] = d.sublimation_energy

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    return DustTables(
        nu=f(nu), chi=f(chi), albedo=f(albedo),
        emiss_var=f(emiss_var), log_emiss_var=f(np.log10(emiss_var)),
        emiss_nu=f(emiss_nu),
        jnu_cdf=f(jnu_cdf.reshape(n_dust * n_var, n_enu)),
        jnu_q=f(jnu_q.reshape(n_dust * n_var, n_quantiles)),
        bnu_q=f(bnu_q.reshape(n_dust * n_var, n_quantiles)),
        mu_q=f(mu_q.reshape(n_dust * n_nu, n_quantiles_mu)),
        mu=f(mu),
        **{k: f(v.reshape(n_dust * n_nu, n_mu)) for k, v in peel.items()},
        me_specific_energy=f(me['specific_energy']),
        me_temperature=f(me['temperature']),
        me_kappa_planck=f(me['kappa_planck']),
        me_chi_inv_planck=f(me['chi_inv_planck']),
        me_chi_rosseland=f(me['chi_rosseland']),
        sublimation_mode=torch.as_tensor(subl_mode, device=device),
        sublimation_energy=f(subl_energy),
    )
