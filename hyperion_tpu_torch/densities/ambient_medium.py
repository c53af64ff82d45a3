"""Constant-density ambient medium (functional counterpart of
hyperion/densities/ambient_medium.py): uniform rho between rmin and rmax.
Components listed in ``subtract`` are deducted so that the *total* density
never falls below the ambient floor when this structure is co-added with
them.
"""

import numpy as np

from ..util.validator import validate_scalar
from .core import Density

__all__ = ["AmbientMedium"]


class AmbientMedium(Density):

    _required = ("rho", "rmin", "rmax")

    def __init__(self, rho=None, rmin=None, rmax=None, subtract=None,
                 dust=None):
        self._base_init()
        self.dust = dust
        self.rho = rho
        self.rmin = rmin
        self.rmax = rmax
        self.subtract = list(subtract) if subtract is not None else []
        self._freeze()

    @property
    def rho(self):
        """Ambient density level (g/cm^3)."""
        return self._rho

    @rho.setter
    def rho(self, value):
        if value is not None:
            validate_scalar("rho", value, domain="positive")
        object.__setattr__(self, "_rho", value)

    def density(self, grid):
        """Evaluate rho on a spherical polar grid (g/cm^3)."""
        from ..grid import SphericalPolarGrid
        if not isinstance(grid, SphericalPolarGrid):
            raise TypeError("grid should be a SphericalPolarGrid instance")
        self._check_all_set()
        r = grid.gr
        level = np.where((r >= self.rmin) & (r <= self.rmax), self.rho, 0.0)
        for other in self.subtract:
            level = level - other.density(grid)
        return np.maximum(level, 0.0)
