"""Planck / reciprocal-Planck / Rosseland mean opacities vs temperature.

Same physics and table layout as the reference (ref:
hyperion/dust/mean_opacities.py:16-140): a 1200-point log temperature grid
from 0.1 to 1e5 K, with ``specific_energy = 4 sigma T^4 kappa_planck(T)``
linking the two axes used by the transport engine's emissivity locator.
The per-temperature loop is vectorized into a (n_temp, n_nu) matrix of
Planck functions integrated row-wise.
"""

import numpy as np

from ..util.constants import h, k, c, sigma
from ..util.functions import FreezableClass, planck_nu_range, nu_common
from ..util.hdf5_tables import read_table, write_table
from ..util.integrate import integrate_loglog2d
from ..util.interpolate import interp1d_fast_loglog


def _B_nu_matrix(nu, T):
    """Planck function matrix with shape (n_temp, n_nu)."""
    x = h * nu[None, :] / (k * T[:, None])
    pref = 2.0 * h * nu[None, :] ** 3 / c ** 2
    with np.errstate(over='ignore', divide='ignore', invalid='ignore'):
        main = pref / np.expm1(np.minimum(x, 700.0))
        small = pref / x
    out = np.where(x < 1.e-8, small, main)
    return np.where(x >= 700.0, 0.0, out)


def _dB_nu_dT_matrix(nu, T):
    b = _B_nu_matrix(nu, T)
    x = h * nu[None, :] / (k * T[:, None])
    with np.errstate(over='ignore', divide='ignore', invalid='ignore'):
        main = x / T[:, None] / (-np.expm1(-x)) * b
    return np.where(x < 1.e-14, b / T[:, None], main)


class MeanOpacities(FreezableClass):

    def __init__(self):
        self.specific_energy = None
        self.temperature = None
        self.chi_planck = None
        self.kappa_planck = None
        self.chi_inv_planck = None
        self.kappa_inv_planck = None
        self.chi_rosseland = None
        self.kappa_rosseland = None
        self._freeze()

    def compute(self, optical_properties, n_temp=1200, temp_min=0.1,
                temp_max=100000.0):
        temperatures = np.logspace(np.log10(temp_min), np.log10(temp_max), n_temp)
        temperatures[0] = temp_min
        temperatures[-1] = temp_max

        planck_nu = planck_nu_range(temp_min, temp_max)
        nu = nu_common(planck_nu, optical_properties.nu)
        if planck_nu.min() < optical_properties.nu.min():
            nu = nu[nu >= optical_properties.nu.min()]
        if planck_nu.max() > optical_properties.nu.max():
            nu = nu[nu <= optical_properties.nu.max()]

        chi_nu = interp1d_fast_loglog(optical_properties.nu,
                                      optical_properties.chi, nu)
        kappa_nu = interp1d_fast_loglog(optical_properties.nu,
                                        optical_properties.kappa, nu)

        b_nu = _B_nu_matrix(nu, temperatures)
        db_nu_dt = _dB_nu_dT_matrix(nu, temperatures)

        int_b = integrate_loglog2d(nu, b_nu)
        int_db = integrate_loglog2d(nu, db_nu_dt)
        with np.errstate(divide='ignore', invalid='ignore'):
            self.chi_planck = integrate_loglog2d(nu, b_nu * chi_nu) / int_b
            self.kappa_planck = integrate_loglog2d(nu, b_nu * kappa_nu) / int_b
            self.chi_inv_planck = int_b / integrate_loglog2d(nu, b_nu / chi_nu)
            self.kappa_inv_planck = int_b / integrate_loglog2d(nu, b_nu / kappa_nu)
            self.chi_rosseland = int_db / integrate_loglog2d(nu, db_nu_dt / chi_nu)
            self.kappa_rosseland = int_db / integrate_loglog2d(nu, db_nu_dt / kappa_nu)

        self.temperature = temperatures
        self.specific_energy = 4.0 * sigma * temperatures ** 4 * self.kappa_planck

    # -- I/O ------------------------------------------------------------------

    def to_hdf5_group(self, group, compression=True):
        if not self.all_set():
            raise Exception("Not all attributes of the mean opacities are set")
        write_table(group, 'mean_opacities',
                    {'temperature': self.temperature,
                     'specific_energy': self.specific_energy,
                     'chi_planck': self.chi_planck,
                     'kappa_planck': self.kappa_planck,
                     'chi_inv_planck': self.chi_inv_planck,
                     'kappa_inv_planck': self.kappa_inv_planck,
                     'chi_rosseland': self.chi_rosseland,
                     'kappa_rosseland': self.kappa_rosseland},
                    compression=compression)

    def from_hdf5_group(self, group):
        t = read_table(group, 'mean_opacities')
        self.temperature = t['temperature']
        self.specific_energy = t['specific_energy']
        self.chi_planck = t['chi_planck']
        self.kappa_planck = t['kappa_planck']
        self.chi_inv_planck = t['chi_inv_planck']
        self.kappa_inv_planck = t['kappa_inv_planck']
        self.chi_rosseland = t['chi_rosseland']
        self.kappa_rosseland = t['kappa_rosseland']

    def all_set(self):
        return all(getattr(self, a) is not None for a in
                   ('temperature', 'specific_energy', 'chi_planck',
                    'kappa_planck', 'chi_inv_planck', 'kappa_inv_planck',
                    'chi_rosseland', 'kappa_rosseland'))

    def hash_update(self, hh):
        for a in ('temperature', 'specific_energy', 'chi_planck', 'kappa_planck',
                  'chi_inv_planck', 'kappa_inv_planck', 'chi_rosseland',
                  'kappa_rosseland'):
            v = getattr(self, a)
            if v is not None:
                hh.update(np.ascontiguousarray(v).tobytes())
