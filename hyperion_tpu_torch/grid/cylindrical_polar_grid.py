"""Cylindrical polar grid (ref: hyperion/grid/cylindrical_polar_grid.py)."""

import numpy as np

from ..util.meshgrid import meshgrid_nd
from .base import StructuredGrid


class CylindricalPolarGrid(StructuredGrid):
    """Cylindrical polar grid defined by w (cylindrical radius), z, and phi
    wall positions. Quantity arrays have shape (n_p, n_z, n_w)."""

    grid_type = 'cyl_pol'
    wall_columns = ('w', 'z', 'p')
    wall_attrs = ('w_wall', 'z_wall', 'p_wall')
    _wall_units = ('cm', 'cm', 'rad')

    def _init_attributes(self):
        self.w_wall = None
        self.z_wall = None
        self.p_wall = None
        self.w = None
        self.z = None
        self.p = None
        self.gw = None
        self.gz = None
        self.gp = None
        self.volumes = None
        self.areas = None
        self.widths = None

    def _validate_walls(self, w_wall, z_wall, p_wall):
        if w_wall[0] < 0.0:
            raise ValueError("w_wall values should be positive")
        if p_wall[0] < 0.0 or p_wall[-1] > 2.0 * np.pi + 1e-10:
            raise ValueError("p_wall values should be in the range [0, 2*pi]")

    def _compute_derived(self):
        w_wall, z_wall, p_wall = self.w_wall, self.z_wall, self.p_wall

        self.w = (w_wall[:-1] + w_wall[1:]) / 2.0
        self.z = (z_wall[:-1] + z_wall[1:]) / 2.0
        self.p = (p_wall[:-1] + p_wall[1:]) / 2.0

        self.gw, self.gz, self.gp = meshgrid_nd(self.w, self.z, self.p)

        gw_min, gz_min, gp_min = meshgrid_nd(w_wall[:-1], z_wall[:-1], p_wall[:-1])
        gw_max, gz_max, gp_max = meshgrid_nd(w_wall[1:], z_wall[1:], p_wall[1:])

        dw = gw_max - gw_min
        dw2 = gw_max ** 2 - gw_min ** 2
        dz = gz_max - gz_min
        dp = gp_max - gp_min

        # V = [w_2^2 - w_1^2]/2 * dz * dphi
        self.volumes = dw2 * dz * dp / 2.0

        self.areas = np.zeros((6,) + self.shape)
        self.areas[0] = gw_min * dz * dp       # inner cylinder
        self.areas[1] = gw_max * dz * dp       # outer cylinder
        self.areas[2] = self.areas[3] = dw2 * dp / 2.0   # lower/upper z
        self.areas[4] = self.areas[5] = dw * dz          # phi walls

        self.widths = np.zeros((3,) + self.shape)
        self.widths[0] = dw
        self.widths[1] = dz
        self.widths[2] = self.gw * dp
