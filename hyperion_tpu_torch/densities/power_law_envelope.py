"""Spherical power-law envelope (functional counterpart of
hyperion/densities/power_law_envelope.py):

    rho(r) = rho_0 (r/r_0)^power,   rmin <= r <= rmax.
"""

import numpy as np

from ..util.constants import pi
from ..util.integrate import integrate_powerlaw
from .core import Envelope, linked

__all__ = ["PowerLawEnvelope"]


class PowerLawEnvelope(Envelope):

    from .core import scalar_attribute as _sa
    power = _sa("power", positive=False, doc="Density radial exponent.")
    r_0 = _sa("r_0", doc="Reference radius (cm).")
    del _sa

    _required = ("rmin", "rmax", "r_0", "power")
    _pairs = (("mass", "rho_0"),)

    mass = linked("mass", "rho_0", "_mass_per_rho0", forward=True,
                  doc="Total envelope mass (g).")
    rho_0 = linked("rho_0", "mass", "_mass_per_rho0", forward=False,
                   doc="Density at r_0 (g/cm^3).")

    def __init__(self, mass=None, rho_0=None, rmin=None, rmax=None, r_0=None,
                 power=None, dust=None):
        object.__setattr__(self, "_mass", None)
        object.__setattr__(self, "_rho_0", None)
        self._base_init()
        self.rmin = rmin
        self.rmax = rmax
        self.r_0 = r_0
        self.power = power
        self.dust = dust
        if mass is not None and rho_0 is not None:
            raise Exception("Cannot specify both mass and rho_0")
        if mass is not None:
            self.mass = mass
        elif rho_0 is not None:
            self.rho_0 = rho_0
        self._freeze()

    def _mass_per_rho0(self):
        """Shell integral 4 pi r_0^{-power} int r^{2+power} dr."""
        return 4.0 * pi * self.r_0 ** -self.power * \
            integrate_powerlaw(self.rmin, self.rmax, 2.0 + self.power)

    def exists(self):
        return self.rho_0 > 0.0

    def density(self, grid, ignore_cavity=False):
        """Evaluate rho on a spherical/cylindrical polar grid (g/cm^3)."""
        self._check_all_set()
        if self.rmax <= self.rmin:
            return np.zeros(grid.shape)
        r = self._polar_coords(grid)[0]
        rho = self.rho_0 * (r / self.r_0) ** self.power
        rho = np.where((r >= self.rmin) & (r <= self.rmax), rho, 0.0)
        if self._rho_0 is None:
            # mass-specified: renormalize the discretized grid to the mass
            # (before cavity carving, so the cavity removes mass — matching
            # the reference's ordering)
            rho = rho * (self.mass / np.sum(rho * grid.volumes))
        if not ignore_cavity and self.cavity is not None:
            rho = np.where(self.cavity.mask(grid), rho, 0.0)
        return rho

    def outermost_radius(self, rho):
        """Radius where the density profile drops to rho."""
        return self.r_0 * (rho / self.rho_0) ** (1.0 / self.power)

    def midplane_cumulative_density(self, r):
        """Column density integrated along the midplane from rmin to r."""
        self._check_all_set()
        return self.rho_0 * self.r_0 ** -self.power * \
            integrate_powerlaw(self.rmin, np.asarray(r, float), self.power)
