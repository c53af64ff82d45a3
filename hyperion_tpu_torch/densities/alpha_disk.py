"""Alpha accretion disk, Whitney et al. (2003) (functional counterpart of
hyperion/densities/alpha_disk.py).

The flared-disk profile is tapered by ``1 - sqrt(R_*/w)`` (zero torque at the
stellar surface), and the disk carries a viscous accretion luminosity

    L_visc = G M Mdot / 2 [3 (1/rmin - 1/rmax)
                           - 2 (sqrt(R_*/rmin^3) - sqrt(R_*/rmax^3))].
"""

import numpy as np

from ..util.constants import G
from .core import Disk, linked

__all__ = ["AlphaDisk"]


class AlphaDisk(Disk):

    _pairs = Disk._pairs + (("mdot", "lvisc"),)

    mdot = linked("mdot", "lvisc", "_lvisc_per_mdot", forward=False,
                  doc="Accretion rate (g/s).")
    lvisc = linked("lvisc", "mdot", "_lvisc_per_mdot", forward=True,
                   doc="Viscous accretion luminosity (erg/s).")

    def __init__(self, mass=None, rho_0=None, rmin=None, rmax=None, p=-1,
                 beta=-1.25, h_0=None, r_0=None, cylindrical_inner_rim=True,
                 cylindrical_outer_rim=True, mdot=None, lvisc=None, star=None,
                 dust=None):
        object.__setattr__(self, "_mdot", None)
        object.__setattr__(self, "_lvisc", None)
        Disk.__init__(self, mass=mass, rho_0=rho_0, rmin=rmin, rmax=rmax,
                      p=p, beta=beta, h_0=h_0, r_0=r_0,
                      cylindrical_inner_rim=cylindrical_inner_rim,
                      cylindrical_outer_rim=cylindrical_outer_rim, dust=dust)
        self.star = star
        if mdot is not None and lvisc is not None:
            raise Exception("Cannot specify both mdot and lvisc")
        if mdot is not None:
            self.mdot = mdot
        elif lvisc is not None:
            self.lvisc = lvisc

    def _check_all_set(self):
        Disk._check_all_set(self)
        if self.star is None:
            raise Exception("star is not set")

    # -- accretion physics ------------------------------------------------------

    def _lvisc_per_mdot(self):
        """L_visc / Mdot for a viscous disk dissipating from rmin to rmax."""
        if self.star.mass is None:
            raise Exception("Stellar mass is required to relate mdot and lvisc")
        r_star = self.star.radius
        shear = 3.0 * (1.0 / self.rmin - 1.0 / self.rmax)
        torque = 2.0 * (np.sqrt(r_star / self.rmin ** 3)
                        - np.sqrt(r_star / self.rmax ** 3))
        return 0.5 * G * self.star.mass * (shear - torque)

    @property
    def accretion_luminosity(self):
        return self.lvisc

    def _radial_taper(self, w):
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.maximum(1.0 - np.sqrt(self.star.radius / w), 0.0)

    def accretion_luminosity_grid(self, grid):
        """Per-cell viscous energy release (erg/s), eq. 4 of Whitney+03,
        renormalized so the discretized total equals lvisc."""
        self._check_all_set()
        if not self.lvisc:
            return np.zeros(grid.shape)
        h = self.scale_height_at(grid.gw)
        with np.errstate(invalid="ignore", divide="ignore"):
            rate = (self._radial_taper(grid.gw) / (grid.gw ** 3 * h)
                    * np.exp(-0.5 * (grid.gz / h) ** 2))
        per_cell = np.where(self._inside_rims(grid), rate, 0.0) * grid.volumes
        total = np.sum(per_cell)
        return per_cell * (self.lvisc / total) if total > 0 else per_cell
