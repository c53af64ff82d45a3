"""Spherical polar grid (ref: hyperion/grid/spherical_polar_grid.py)."""

import numpy as np

from ..util.meshgrid import meshgrid_nd
from .base import StructuredGrid


class SphericalPolarGrid(StructuredGrid):
    """Spherical polar grid defined by r, theta, and phi wall positions.

    Quantity arrays have shape (n_p, n_t, n_r).
    """

    grid_type = 'sph_pol'
    wall_columns = ('r', 't', 'p')
    wall_attrs = ('r_wall', 't_wall', 'p_wall')
    _wall_units = ('cm', 'rad', 'rad')

    def _init_attributes(self):
        self.r_wall = None
        self.t_wall = None
        self.p_wall = None
        self.r = None
        self.t = None
        self.p = None
        self.gr = None
        self.gt = None
        self.gp = None
        self.gw = None
        self.gz = None
        self.volumes = None
        self.areas = None
        self.widths = None

    def _validate_walls(self, r_wall, t_wall, p_wall):
        if r_wall[0] < 0.0:
            raise ValueError("r_wall values should be positive")
        if t_wall[0] < 0.0 or t_wall[-1] > np.pi + 1e-10:
            raise ValueError("t_wall values should be in the range [0, pi]")
        if p_wall[0] < 0.0 or p_wall[-1] > 2.0 * np.pi + 1e-10:
            raise ValueError("p_wall values should be in the range [0, 2*pi]")

    def _compute_derived(self):
        r_wall, t_wall, p_wall = self.r_wall, self.t_wall, self.p_wall

        # Radial centers are logarithmic midpoints (except an r=0 inner cell)
        if r_wall[0] == 0.0:
            self.r = np.zeros(len(r_wall) - 1)
            self.r[0] = r_wall[1] / 2.0
            self.r[1:] = 10.0 ** ((np.log10(r_wall[1:-1]) + np.log10(r_wall[2:])) / 2.0)
        else:
            self.r = 10.0 ** ((np.log10(r_wall[:-1]) + np.log10(r_wall[1:])) / 2.0)

        self.t = (t_wall[:-1] + t_wall[1:]) / 2.0
        self.p = (p_wall[:-1] + p_wall[1:]) / 2.0

        self.gr, self.gt, self.gp = meshgrid_nd(self.r, self.t, self.p)
        self.gz = self.gr * np.cos(self.gt)
        self.gw = self.gr * np.sin(self.gt)

        gr_min, gt_min, gp_min = meshgrid_nd(r_wall[:-1], t_wall[:-1], p_wall[:-1])
        gr_max, gt_max, gp_max = meshgrid_nd(r_wall[1:], t_wall[1:], p_wall[1:])

        dr = gr_max - gr_min
        dr2 = gr_max ** 2 - gr_min ** 2
        dr3 = gr_max ** 3 - gr_min ** 3
        dt = gt_max - gt_min
        dcost = np.cos(gt_min) - np.cos(gt_max)
        dp = gp_max - gp_min

        # V = [r_2^3 - r_1^3]/3 * [cos(t_1) - cos(t_2)] * dphi
        self.volumes = dr3 * dcost * dp / 3.0

        self.areas = np.zeros((6,) + self.shape)
        self.areas[0] = gr_min ** 2 * dcost * dp             # inner sphere
        self.areas[1] = gr_max ** 2 * dcost * dp             # outer sphere
        self.areas[2] = dr2 / 2.0 * np.sin(gt_min) * dp      # lower theta cone
        self.areas[3] = dr2 / 2.0 * np.sin(gt_max) * dp      # upper theta cone
        self.areas[4] = self.areas[5] = dr2 / 2.0 * dt       # phi walls

        self.widths = np.zeros((3,) + self.shape)
        self.widths[0] = dr
        self.widths[1] = self.gr * dt
        self.widths[2] = self.gr * np.sin(self.gt) * dp
