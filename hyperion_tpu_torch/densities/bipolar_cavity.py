"""Bipolar cavity carved out of an envelope
(ref: hyperion/densities/bipolar_cavity.py).

The cavity walls follow z = z_0 (w/w_0)^power with half-opening angle
theta_0 at radius r_0; inside the cavity the density is
rho_0 (r/r_0)^-rho_exp, capped at the enclosing envelope's density.
"""

import numpy as np

from ..util.validator import validate_scalar
from ..util.functions import FreezableClass


class BipolarCavity(FreezableClass):

    def __init__(self, theta_0=None, power=1.5, r_0=None, rho_0=None,
                 rho_exp=0.0, cap_to_envelope_density=False, dust=None):
        self.power = power
        self.theta_0 = theta_0
        self.r_0 = r_0
        self.rho_0 = rho_0
        self.rho_exp = rho_exp
        self.cap_to_envelope_density = cap_to_envelope_density
        self.dust = dust
        self._envelope = None
        self._freeze()

    @property
    def theta_0(self):
        """Cavity half-opening angle at r_0 (degrees)."""
        return self._theta_0

    @theta_0.setter
    def theta_0(self, value):
        if value is not None:
            validate_scalar('theta_0', value, domain=[0, 90])
        self._theta_0 = value

    def _check_all_set(self):
        for attr in ('theta_0', 'power', 'r_0'):
            if getattr(self, attr) is None:
                raise Exception("%s is not set" % attr)

    def mask(self, grid):
        """True where OUTSIDE the cavity (i.e. where envelope material
        remains), matching the reference convention."""
        from ..grid import SphericalPolarGrid, CylindricalPolarGrid
        if not isinstance(grid, (SphericalPolarGrid, CylindricalPolarGrid)):
            raise TypeError("grid should be a SphericalPolarGrid or "
                            "CylindricalPolarGrid instance")
        if self.theta_0 == 0.0:
            return np.ones(grid.shape, dtype=bool)
        self._check_all_set()
        z0 = self.r_0 * np.cos(np.radians(self.theta_0))
        w0 = self.r_0 * np.sin(np.radians(self.theta_0))
        zcav = z0 * (grid.gw / w0) ** self.power
        return np.abs(grid.gz) < zcav

    def density(self, grid):
        """Density of the material inside the cavity."""
        self._check_all_set()
        if self.rho_0 is None:
            return np.zeros(grid.shape)
        from ..grid import SphericalPolarGrid, CylindricalPolarGrid
        if isinstance(grid, SphericalPolarGrid):
            r = grid.gr
        else:
            r = np.hypot(grid.gw, grid.gz)
        rho = self.rho_0 * (r / self.r_0) ** -self.rho_exp
        inside = ~self.mask(grid)
        rho = np.where(inside, rho, 0.0)
        if self._envelope is not None:
            rho[r < self._envelope.rmin] = 0.0
            rho[r > self._envelope.rmax] = 0.0
            if self.cap_to_envelope_density:
                env_rho = self._envelope.density(grid, ignore_cavity=True)
                rho = np.minimum(rho, env_rho)
        return rho
