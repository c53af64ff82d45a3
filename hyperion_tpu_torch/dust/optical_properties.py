"""Dust optical properties: extinction, albedo and the 4-element scattering matrix.

Same capabilities as the reference's ``OpticalProperties``
(ref: hyperion/dust/optical_properties.py:20-300): frequency-sorted chi/albedo
tables, scattering matrix P1..P4(nu, mu) with normalization/truncation, and
power-law extrapolation of chi to wider frequency ranges. Implementation is
vectorized NumPy throughout (no per-frequency Python loops).
"""

import numpy as np

from ..util.constants import c
from ..util.functions import FreezableClass
from ..util.hdf5_tables import read_table, write_table
from ..util.integrate import integrate_linlog_subset
from ..util.interpolate import (interp1d_fast, interp1d_fast_linlog,
                                interp1d_fast_loglog)


class _vec:
    """Validated 1-D table attribute (ref: the reference's setters raise
    '<name> should be a 1-D sequence' / 'monotonically increasing' /
    range errors). Monotonically DEcreasing input is accepted — ``_sort``
    flips it — but unsorted input is rejected."""

    def __init__(self, name, lo=None, hi=None, monotonic=False):
        self.name = name
        self.slot = "_v_" + name
        self.lo = lo
        self.hi = hi
        self.monotonic = monotonic

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return getattr(obj, self.slot, None)

    def __set__(self, obj, value):
        if value is not None:
            value = np.asarray(value, dtype=float)
            if value.ndim != 1:
                raise ValueError("%s should be a 1-D sequence" % self.name)
            if self.lo is not None and np.any(value < self.lo):
                raise ValueError("%s should be >= %g" % (self.name, self.lo))
            if self.hi is not None and np.any(value > self.hi):
                raise ValueError("%s should be <= %g" % (self.name, self.hi))
            if self.monotonic and len(value) > 1:
                d = np.diff(value)
                if not (np.all(d > 0) or np.all(d < 0)):
                    raise ValueError("%s should be monotonically increasing"
                                     % self.name)
        object.__setattr__(obj, self.slot, value)


class OpticalProperties(FreezableClass):

    nu = _vec("nu", lo=0.0, monotonic=True)
    chi = _vec("chi", lo=0.0)
    albedo = _vec("albedo", lo=0.0, hi=1.0)
    mu = _vec("mu", lo=-1.0, hi=1.0, monotonic=True)

    def __init__(self):
        # Frequency grid (Hz), ascending after _sort()
        self.nu = None
        # Opacity to extinction per unit dust mass (cm^2/g)
        self.chi = None
        # Albedo (scattering / extinction)
        self.albedo = None
        # Scattering angle cosines, ascending
        self.mu = None
        # Scattering matrix elements, shape (n_nu, n_mu)
        self.P1 = None
        self.P2 = None
        self.P3 = None
        self.P4 = None
        self._freeze()

    @property
    def kappa(self):
        """Opacity to absorption (cm^2/g)."""
        return self.chi * (1.0 - self.albedo)

    @property
    def sigma(self):
        """Opacity to scattering (cm^2/g)."""
        return self.chi * self.albedo

    @property
    def wav(self):
        """Wavelength grid (microns), descending when nu ascending."""
        return c / self.nu * 1.e4

    def _sort(self):
        if self.mu is not None and len(self.mu) > 1 and self.mu[-1] < self.mu[0]:
            self.mu = self.mu[::-1]
            for name in ('P1', 'P2', 'P3', 'P4'):
                setattr(self, name, getattr(self, name)[:, ::-1])
        if self.nu is not None and len(self.nu) > 1 and self.nu[-1] < self.nu[0]:
            self.nu = self.nu[::-1]
            self.albedo = self.albedo[::-1]
            self.chi = self.chi[::-1]
            for name in ('P1', 'P2', 'P3', 'P4'):
                setattr(self, name, getattr(self, name)[::-1, :])

    def initialize_scattering_matrix(self):
        shape = (len(self.nu), len(self.mu))
        self.P1 = np.zeros(shape)
        self.P2 = np.zeros(shape)
        self.P3 = np.zeros(shape)
        self.P4 = np.zeros(shape)

    def normalize_scattering_matrix(self):
        """Normalize so that P1 interpolated (lin-log in mu) at mu=0 equals 1."""
        norm = np.array([interp1d_fast_linlog(self.mu, self.P1[i, :], 0.0)
                         for i in range(len(self.nu))])
        with np.errstate(invalid='ignore', divide='ignore'):
            for name in ('P1', 'P2', 'P3', 'P4'):
                setattr(self, name, getattr(self, name) / norm[:, None])

    def truncate_scattering_matrix(self, mu_max):
        """Remove forward scattering beyond mu_max, folding the removed
        fraction into a reduced scattering opacity/albedo."""
        self._sort()
        frac = np.array([
            integrate_linlog_subset(self.mu, self.P1[i, :], self.mu[0], mu_max) /
            integrate_linlog_subset(self.mu, self.P1[i, :], self.mu[0], self.mu[-1])
            for i in range(len(self.nu))])
        sigma_nu = self.chi * self.albedo * frac
        kappa_nu = self.chi * (1.0 - self.albedo)
        self.albedo = sigma_nu / (sigma_nu + kappa_nu)
        self.chi = sigma_nu + kappa_nu

        # Interpolate the matrix elements at the cut then truncate the grid
        P_max = []
        for name, interp in (('P1', interp1d_fast_linlog), ('P2', interp1d_fast),
                             ('P3', interp1d_fast), ('P4', interp1d_fast)):
            P = getattr(self, name)
            P_max.append(np.array([interp(self.mu, P[i, :], mu_max)
                                   for i in range(len(self.nu))])[:, None])
        cut = np.searchsorted(self.mu, mu_max)
        self.mu = np.hstack([self.mu[:cut], mu_max])
        for name, pm in zip(('P1', 'P2', 'P3', 'P4'), P_max):
            setattr(self, name, np.hstack([getattr(self, name)[:, :cut], pm]))

    def extrapolate_wav(self, wav1, wav2):
        """Extrapolate optical properties to wavelengths wav1..wav2 (microns)."""
        nu1 = c / max(wav1, wav2) * 1.e4
        nu2 = c / min(wav1, wav2) * 1.e4
        return self.extrapolate_nu(nu1, nu2)

    def extrapolate_nu(self, nu1, nu2):
        """Extrapolate to frequencies nu1..nu2: chi follows a power-law fit to
        the two edge points; albedo and scattering matrix are held constant."""
        self._sort()

        def powerlaw_edge(nu_a, nu_b, chi_a, chi_b, nu_new):
            b = np.log10(chi_b / chi_a) / np.log10(nu_b / nu_a)
            return chi_a * (nu_new / nu_a) ** b

        if nu1 < self.nu[0]:
            chi_new = powerlaw_edge(self.nu[0], self.nu[1],
                                    self.chi[0], self.chi[1], nu1)
            self.albedo = np.hstack([self.albedo[0], self.albedo])
            self.chi = np.hstack([chi_new, self.chi])
            self.nu = np.hstack([nu1, self.nu])
            for name in ('P1', 'P2', 'P3', 'P4'):
                P = getattr(self, name)
                setattr(self, name, np.vstack([P[0, :], P]))

        if nu2 > self.nu[-1]:
            chi_new = powerlaw_edge(self.nu[-2], self.nu[-1],
                                    self.chi[-2], self.chi[-1], nu2)
            self.albedo = np.hstack([self.albedo, self.albedo[-1]])
            self.chi = np.hstack([self.chi, chi_new])
            self.nu = np.hstack([self.nu, nu2])
            for name in ('P1', 'P2', 'P3', 'P4'):
                P = getattr(self, name)
                setattr(self, name, np.vstack([P, P[-1, :]]))

    # -- interpolation helpers ------------------------------------------------

    def interp_chi_wav(self, wav):
        return interp1d_fast_loglog(self.nu, self.chi, c / (wav * 1.e-4))

    def interp_kappa_wav(self, wav):
        return interp1d_fast_loglog(self.nu, self.kappa, c / (wav * 1.e-4))

    def interp_chi_nu(self, nu):
        return interp1d_fast_loglog(self.nu, self.chi, nu)

    def interp_kappa_nu(self, nu):
        return interp1d_fast_loglog(self.nu, self.kappa, nu)

    # -- I/O ------------------------------------------------------------------

    def to_hdf5_group(self, group, compression=True):
        self.ensure_all_set()
        self._sort()
        self.normalize_scattering_matrix()
        write_table(group, 'optical_properties',
                    {'nu': self.nu, 'albedo': self.albedo, 'chi': self.chi,
                     'P1': self.P1, 'P2': self.P2, 'P3': self.P3, 'P4': self.P4},
                    compression=compression)
        write_table(group, 'scattering_angles', {'mu': self.mu},
                    compression=compression)

    def from_hdf5_group(self, group):
        tmu = read_table(group, 'scattering_angles')
        self.mu = tmu['mu']
        topt = read_table(group, 'optical_properties')
        self.nu = topt['nu']
        self.albedo = topt['albedo']
        self.chi = topt['chi']
        self.P1 = topt['P1']
        self.P2 = topt['P2']
        self.P3 = topt['P3']
        self.P4 = topt['P4']

    def all_set(self):
        return all(getattr(self, a) is not None for a in
                   ('nu', 'chi', 'albedo', 'mu', 'P1', 'P2', 'P3', 'P4'))

    def ensure_all_set(self):
        if not self.all_set():
            missing = [a for a in ('nu', 'chi', 'albedo', 'mu', 'P1', 'P2', 'P3', 'P4')
                       if getattr(self, a) is None]
            raise Exception("The following attributes of the optical properties "
                            "have not been set: %s" % ', '.join(missing))

    def __getstate__(self):
        return self.__dict__

    def hash_update(self, h):
        for a in ('nu', 'chi', 'albedo', 'mu', 'P1', 'P2', 'P3', 'P4'):
            v = getattr(self, a)
            if v is not None:
                h.update(np.ascontiguousarray(v).tobytes())
