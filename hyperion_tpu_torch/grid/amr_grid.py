"""AMR grid (ref: hyperion/grid/amr_grid.py:39-695): a hierarchy of levels,
each holding rectangular grids (fabs) with uniform cartesian cells.
Quantities are per-fab 3-D arrays stored under
Quantities/level_%05d/grid_%05d."""

import hashlib
from copy import deepcopy

import numpy as np

from ..util.functions import FreezableClass, asstr


class Grid(FreezableClass):
    """One rectangular fab of an AMR level."""

    def __init__(self):
        self.xmin, self.xmax = None, None
        self.ymin, self.ymax = None, None
        self.zmin, self.zmax = None, None
        self.nx, self.ny, self.nz = None, None, None
        self.quantities = {}
        self._freeze()

    @property
    def shape(self):
        return (self.nz, self.ny, self.nx)


class Level(FreezableClass):

    def __init__(self):
        self.grids = []
        self._freeze()

    def add_grid(self):
        grid = Grid()
        self.grids.append(grid)
        return grid


class AMRGrid(FreezableClass):

    grid_type = 'amr'

    def __init__(self, amr_grid=None):
        self.levels = []
        self._freeze()
        if amr_grid is not None:
            for level_in in amr_grid.levels:
                level = self.add_level()
                for grid_in in level_in.grids:
                    grid = level.add_grid()
                    for attr in ('xmin', 'xmax', 'ymin', 'ymax', 'zmin',
                                 'zmax', 'nx', 'ny', 'nz'):
                        setattr(grid, attr, getattr(grid_in, attr))

    def add_level(self):
        level = Level()
        self.levels.append(level)
        return level

    @property
    def shape(self):
        return None

    def _check_array_dimensions(self, amr_grid=None):
        for level in self.levels:
            for grid in level.grids:
                for quantity in grid.quantities:
                    q = grid.quantities[quantity]
                    arrs = q if isinstance(q, (list, tuple)) else [q]
                    for arr in arrs:
                        if np.shape(arr) != grid.shape:
                            raise ValueError(
                                "Quantity arrays do not have the right "
                                "dimensions: %s instead of %s"
                                % (np.shape(arr), grid.shape))

    def get_geometry_id(self):
        geo_hash = hashlib.md5()
        for level in self.levels:
            for grid in level.grids:
                for attr in ('xmin', 'xmax', 'ymin', 'ymax', 'zmin', 'zmax'):
                    geo_hash.update(np.float64(getattr(grid, attr)).tobytes())
                for attr in ('nx', 'ny', 'nz'):
                    geo_hash.update(np.int64(getattr(grid, attr)).tobytes())
        return geo_hash.hexdigest()

    @property
    def n_cells(self):
        return sum(g.nx * g.ny * g.nz
                   for level in self.levels for g in level.grids)

    # -- quantity access: grid['density'] appends per-fab -----------------------

    def __getitem__(self, item):
        return AMRGridView(self, item)

    def __contains__(self, item):
        if not self.levels:
            return False
        return all(item in g.quantities
                   for level in self.levels for g in level.grids)

    # -- I/O -------------------------------------------------------------------

    def read(self, group, quantities='all'):
        self.read_geometry(group['Geometry'])
        self.read_quantities(group['Quantities'], quantities=quantities)
        self._check_array_dimensions()

    def read_geometry(self, group):
        if asstr(group.attrs['grid_type']) != 'amr':
            raise ValueError("Grid is not an AMR grid")
        self.levels = []
        for ilevel in range(int(group.attrs['nlevels'])):
            g_level = group['level_%05i' % (ilevel + 1)]
            level = self.add_level()
            for igrid in range(int(g_level.attrs['ngrids'])):
                g_grid = g_level['grid_%05i' % (igrid + 1)]
                grid = level.add_grid()
                for attr in ('xmin', 'xmax', 'ymin', 'ymax', 'zmin', 'zmax'):
                    setattr(grid, attr, float(g_grid.attrs[attr]))
                grid.nx = int(g_grid.attrs['n1'])
                grid.ny = int(g_grid.attrs['n2'])
                grid.nz = int(g_grid.attrs['n3'])
        if asstr(group.attrs['geometry']) != self.get_geometry_id():
            raise Exception("Calculated geometry hash does not match hash "
                            "in file")

    def read_quantities(self, group, quantities='all'):
        for ilevel, level in enumerate(self.levels):
            g_level = group['level_%05i' % (ilevel + 1)]
            for igrid, grid in enumerate(level.grids):
                g_grid = g_level['grid_%05i' % (igrid + 1)]
                for quantity in g_grid:
                    if quantities == 'all' or quantity in quantities:
                        arr = np.array(g_grid[quantity])
                        if arr.ndim == 4:
                            grid.quantities[quantity] = [
                                arr[i] for i in range(arr.shape[0])]
                        else:
                            grid.quantities[quantity] = arr

    def write(self, group, quantities='all', copy=True, absolute_paths=False,
              compression=True, wall_dtype=float, physics_dtype=float):
        g_geometry = group.create_group('Geometry') if 'Geometry' not in group \
            else group['Geometry']
        g_quantities = group.create_group('Quantities') if 'Quantities' not in group \
            else group['Quantities']
        self._check_array_dimensions()
        g_geometry.attrs['grid_type'] = np.bytes_('amr')
        g_geometry.attrs['nlevels'] = len(self.levels)
        g_geometry.attrs['geometry'] = np.bytes_(self.get_geometry_id())
        for ilevel, level in enumerate(self.levels):
            level_path = 'level_%05i' % (ilevel + 1)
            g_level = g_geometry.create_group(level_path)
            q_level = g_quantities.create_group(level_path)
            g_level.attrs['ngrids'] = len(level.grids)
            for igrid, grid in enumerate(level.grids):
                grid_path = 'grid_%05i' % (igrid + 1)
                g_grid = g_level.create_group(grid_path)
                q_grid = q_level.create_group(grid_path)
                for attr in ('xmin', 'xmax', 'ymin', 'ymax', 'zmin', 'zmax'):
                    g_grid.attrs[attr] = getattr(grid, attr)
                g_grid.attrs['n1'] = grid.nx
                g_grid.attrs['n2'] = grid.ny
                g_grid.attrs['n3'] = grid.nz
                for quantity in grid.quantities:
                    if quantities == 'all' or quantity in quantities:
                        q_grid.create_dataset(
                            quantity, data=grid.quantities[quantity],
                            compression='gzip' if compression else None,
                            dtype=physics_dtype)


    def to_yt(self, dust_id=0):
        """Convert to a yt AMR stream dataset (requires yt; ref
        amr_grid.py:555-567)."""
        from .yt_compat import amr_grid_to_yt_dataset
        return amr_grid_to_yt_dataset(self.levels, dust_id=dust_id)

    @classmethod
    def from_yt(cls, ds, quantity_mapping={}):
        """Build an AMRGrid from a yt dataset (requires yt; ref
        amr_grid.py:569-653). quantity_mapping maps hyperion quantity
        names to yt field identifiers."""
        from .yt_compat import amr_grid_from_yt
        return amr_grid_from_yt(cls, ds, quantity_mapping)


class AMRGridView(AMRGrid):
    """A view selecting one quantity across all fabs."""

    def __init__(self, amr_grid, quantity):
        self.viewed_quantity = quantity
        AMRGrid.__init__(self, amr_grid)
        for level_in, level_out in zip(amr_grid.levels, self.levels):
            for grid_in, grid_out in zip(level_in.grids, level_out.grids):
                if quantity not in grid_in.quantities:
                    grid_in.quantities[quantity] = []
                grid_out.quantities = {quantity: grid_in.quantities[quantity]}

    @property
    def n_pop(self):
        for level in self.levels:
            for grid in level.grids:
                q = grid.quantities[self.viewed_quantity]
                return len(q) if isinstance(q, (list, tuple)) else 1
        return 0

    def append(self, amr_grid_view):
        """Append another view's arrays as a new population per fab."""
        for level_in, level_out in zip(amr_grid_view.levels, self.levels):
            for grid_in, grid_out in zip(level_in.grids, level_out.grids):
                arr = grid_in.quantities[amr_grid_view.viewed_quantity]
                if isinstance(arr, list):
                    raise Exception("Can only append a single grid")
                grid_out.quantities[self.viewed_quantity].append(deepcopy(arr))
