"""Cartesian grid (ref: hyperion/grid/cartesian_grid.py)."""

import numpy as np

from ..util.meshgrid import meshgrid_nd
from .base import StructuredGrid


class CartesianGrid(StructuredGrid):
    """Regular cartesian grid defined by x/y/z wall positions.

    Quantity arrays have shape (n_z, n_y, n_x).
    """

    grid_type = 'car'
    wall_columns = ('x', 'y', 'z')
    wall_attrs = ('x_wall', 'y_wall', 'z_wall')
    _wall_units = ('cm', 'cm', 'cm')

    def _init_attributes(self):
        self.x_wall = None
        self.y_wall = None
        self.z_wall = None
        self.x = None
        self.y = None
        self.z = None
        self.gx = None
        self.gy = None
        self.gz = None
        self.volumes = None
        self.areas = None
        self.widths = None

    def _compute_derived(self):
        x_wall, y_wall, z_wall = self.x_wall, self.y_wall, self.z_wall

        self.x = (x_wall[:-1] + x_wall[1:]) / 2.0
        self.y = (y_wall[:-1] + y_wall[1:]) / 2.0
        self.z = (z_wall[:-1] + z_wall[1:]) / 2.0

        self.gx, self.gy, self.gz = meshgrid_nd(self.x, self.y, self.z)

        gdx, gdy, gdz = meshgrid_nd(np.diff(x_wall), np.diff(y_wall),
                                    np.diff(z_wall))

        self.volumes = gdx * gdy * gdz

        self.areas = np.zeros((6,) + self.shape)
        self.areas[0] = self.areas[1] = gdy * gdz
        self.areas[2] = self.areas[3] = gdx * gdz
        self.areas[4] = self.areas[5] = gdx * gdy

        self.widths = np.zeros((3,) + self.shape)
        self.widths[0] = gdx
        self.widths[1] = gdy
        self.widths[2] = gdz

    def to_yt(self, dust_id=0):
        """Convert to a yt uniform-grid dataset (requires yt; ref
        cartesian_grid.py:430-444)."""
        from .yt_compat import cartesian_grid_to_yt_dataset
        return cartesian_grid_to_yt_dataset(self, dust_id=dust_id)
