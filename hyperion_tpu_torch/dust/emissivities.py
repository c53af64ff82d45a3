"""Dust thermal emissivities j_nu as a function of specific energy.

LTE emissivities follow ``j_nu(E) = kappa_nu B_nu(T(E))`` on the mean-opacity
temperature grid, matching the reference pipeline
(ref: hyperion/dust/emissivities.py:15-120). The variable axis ('E') and the
normalization convention (integral of j_nu/nu over nu equals 1 per bin) are
what the transport engine's re-emission CDF tables are built from.
"""

import numpy as np

from ..util.functions import (FreezableClass, planck_nu_range, nu_common,
                              bool2str, str2bool, asstr)
from ..util.hdf5_tables import read_table, write_table
from ..util.integrate import integrate_loglog2d
from ..util.interpolate import interp1d_fast_loglog
from .mean_opacities import _B_nu_matrix


class Emissivities(FreezableClass):

    def __init__(self):
        self.is_lte = False
        self.var_name = None
        # Emissivity variable grid (specific energy), shape (n_var,)
        self.var = None
        # Frequency grid, shape (n_nu,)
        self.nu = None
        # Emissivities, shape (n_nu, n_var)
        self.jnu = None
        self._freeze()

    def normalize(self):
        norm = integrate_loglog2d(self.nu, (self.jnu / self.nu[:, None]).T)
        self.jnu = self.jnu / norm[None, :]

    def set_lte(self, optical_properties, mean_opacities):
        """Tabulate j_nu = kappa_nu B_nu(T) over the mean-opacity temperature
        grid, on the union frequency grid restricted to where kappa is
        defined (points outside [nu_min, nu_max] could only have come from
        the Planck range, so an unconditional clip is equivalent to the
        reference's two conditional ones)."""
        temperature = mean_opacities.temperature
        grid = nu_common(planck_nu_range(temperature[0], temperature[-1]),
                         optical_properties.nu)
        lo, hi = optical_properties.nu.min(), optical_properties.nu.max()
        grid = grid[(grid >= lo) & (grid <= hi)]

        self.is_lte = True
        self.var_name = 'specific_energy'
        self.var = mean_opacities.specific_energy
        self.nu = grid
        kappa_nu = interp1d_fast_loglog(optical_properties.nu,
                                        optical_properties.kappa, grid)
        # (n_temp, n_nu) Planck matrix -> (n_nu, n_temp) emissivities
        self.jnu = (kappa_nu[None, :] * _B_nu_matrix(grid, temperature)).T

    # -- I/O ------------------------------------------------------------------

    def to_hdf5_group(self, group, compression=True):
        if not self.all_set():
            raise Exception("Not all attributes of the emissivities are set")
        if self.var_name != 'specific_energy':
            raise Exception("Unknown emissivity variable: %s" % self.var_name)
        group.attrs['emissvar'] = np.bytes_('E')
        group.attrs['lte'] = bool2str(self.is_lte)
        write_table(group, 'emissivity_variable', {self.var_name: self.var},
                    compression=compression)
        write_table(group, 'emissivities', {'nu': self.nu, 'jnu': self.jnu},
                    compression=compression)

    def from_hdf5_group(self, group):
        if asstr(group.attrs['emissvar']) != 'E':
            raise Exception("Unknown emissivity variable: %s"
                            % group.attrs['emissvar'])
        self.var_name = 'specific_energy'
        tvar = read_table(group, 'emissivity_variable')
        self.var = tvar[self.var_name]
        temiss = read_table(group, 'emissivities')
        self.nu = temiss['nu']
        self.jnu = temiss['jnu']
        self.is_lte = str2bool(group.attrs['lte'])

    def all_set(self):
        return all(getattr(self, a) is not None
                   for a in ('var_name', 'var', 'nu', 'jnu'))

    def hash_update(self, hh):
        hh.update(str(self.is_lte).encode('utf-8'))
        for a in ('var', 'nu', 'jnu'):
            v = getattr(self, a)
            if v is not None:
                hh.update(np.ascontiguousarray(v).tobytes())
