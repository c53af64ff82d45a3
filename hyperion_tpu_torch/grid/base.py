"""Shared machinery for structured (cartesian / cylindrical / spherical) grids.

The reference implements three nearly identical grid classes
(ref: hyperion/grid/cartesian_grid.py, cylindrical_polar_grid.py,
spherical_polar_grid.py); here the quantity-dict handling, HDF5 layout
(Geometry group with walls_1..3 compound datasets + Quantities group) and
view semantics live in one base class. On-disk layout matches the reference:
quantity arrays are stored (n3, n2, n1) = (dim3, dim2, dim1)-ordered, with an
optional leading dust-population axis.
"""

import hashlib
from copy import deepcopy

import numpy as np

from ..util.functions import FreezableClass, is_numpy_array, \
    monotonically_increasing, asstr


def is_external_link(value):
    """Is ``value`` an h5py.ExternalLink? False where h5py is not installed:
    no link can exist there, and building a grid in memory needs no HDF5."""
    try:
        import h5py
    except ImportError:
        return False
    return isinstance(value, h5py.ExternalLink)


def single_grid_dims(data, ndim=3):
    """Return (n_pop, shape) for a quantity that is either a list of
    ndim-arrays (one per dust population) or a bare array."""
    if type(data) in [list, tuple]:
        n_pop = len(data)
        shape = None
        for item in data:
            if shape is None:
                shape = item.shape
            elif item.shape != shape:
                raise ValueError("Grids in list/tuple should have the same dimensions")
        if shape is not None and len(shape) != ndim:
            raise ValueError("Grids should be %i-dimensional" % ndim)
    elif isinstance(data, np.ndarray):
        if data.ndim == ndim:
            n_pop, shape = None, data.shape
        elif data.ndim == ndim + 1:
            n_pop, shape = data.shape[0], data[0].shape
        else:
            raise Exception("Unexpected number of dimensions: %i" % data.ndim)
    elif is_external_link(data):
        import h5py
        with h5py.File(data.filename, 'r') as f:
            shape = f[data.path].shape
        if len(shape) == ndim:
            n_pop = None
        elif len(shape) == ndim + 1:
            n_pop, shape = shape[0], shape[1:]
        else:
            raise Exception("Unexpected number of dimensions: %i" % len(shape))
    else:
        raise Exception("Unexpected data type: %s" % type(data))
    return n_pop, shape


class StructuredGrid(FreezableClass):
    """Base for grids whose geometry is three 1-D wall arrays."""

    # Subclasses define: grid_type (HDF5 attr), wall column names and the
    # attribute names holding the three wall arrays.
    grid_type = None
    wall_columns = None   # e.g. ('x', 'y', 'z')
    wall_attrs = None     # e.g. ('x_wall', 'y_wall', 'z_wall')

    def __init__(self, *args):
        self.shape = None
        self.quantities = {}
        self._init_attributes()
        self._freeze()
        if len(args) > 0:
            if isinstance(args[0], StructuredGrid):
                self.set_walls(*[getattr(args[0], a) for a in self.wall_attrs])
            else:
                self.set_walls(*args)

    def _init_attributes(self):
        raise NotImplementedError()

    def _compute_derived(self):
        raise NotImplementedError()

    def set_walls(self, w1, w2, w3):
        walls = []
        for name, w in zip(self.wall_attrs, (w1, w2, w3)):
            w = np.asarray(w, dtype=float)
            if not is_numpy_array(w) or w.ndim != 1:
                raise ValueError("%s should be a 1-D sequence" % name)
            if not monotonically_increasing(w):
                raise ValueError("%s should be monotonically increasing" % name)
            walls.append(w)
        self._validate_walls(*walls)
        for name, w in zip(self.wall_attrs, walls):
            setattr(self, name, w)
        self.shape = (len(walls[2]) - 1, len(walls[1]) - 1, len(walls[0]) - 1)
        self._compute_derived()

    def _validate_walls(self, w1, w2, w3):
        pass

    @property
    def n_cells(self):
        return int(np.prod(self.shape))

    def _check_array_dimensions(self, array=None):
        for quantity in self.quantities:
            n_pop_ref = None
            if isinstance(self.quantities[quantity], (list, tuple)):
                for item in self.quantities[quantity]:
                    n_pop, shape = single_grid_dims(item)
                    if shape != self.shape:
                        raise ValueError("Quantity arrays do not have the right "
                                         "dimensions: %s instead of %s"
                                         % (shape, self.shape))
            else:
                n_pop, shape = single_grid_dims(self.quantities[quantity])
                if shape != self.shape:
                    raise ValueError("Quantity arrays do not have the right "
                                     "dimensions: %s instead of %s"
                                     % (shape, self.shape))
        if array is not None:
            n_pop, shape = single_grid_dims(array)
            if shape != self.shape:
                raise ValueError("Quantity arrays do not have the right "
                                 "dimensions: %s instead of %s"
                                 % (shape, self.shape))

    def get_geometry_id(self):
        geo_hash = hashlib.md5()
        for name in self.wall_attrs:
            geo_hash.update(np.ascontiguousarray(getattr(self, name)).tobytes())
        return geo_hash.hexdigest()

    # -- I/O ------------------------------------------------------------------

    def read(self, group, quantities='all'):
        self.read_geometry(group['Geometry'])
        self.read_quantities(group['Quantities'], quantities=quantities)
        self._check_array_dimensions()

    def read_geometry(self, group):
        if asstr(group.attrs['grid_type']) != self.grid_type:
            raise ValueError("Grid is not '%s' format" % self.grid_type)
        self.set_walls(*[group['walls_%d' % (i + 1)][col]
                         for i, col in enumerate(self.wall_columns)])
        if asstr(group.attrs['geometry']) != self.get_geometry_id():
            raise Exception("Calculated geometry hash does not match hash in file")

    def read_quantities(self, group, quantities='all'):
        if quantities is not None:
            for quantity in group:
                if quantities == 'all' or quantity in quantities:
                    array = np.array(group[quantity])
                    if array.ndim == 4:  # if array is 4D, it is a list of 3D arrays
                        self.quantities[quantity] = [array[i] for i in range(array.shape[0])]
                    else:
                        self.quantities[quantity] = array
        self._check_array_dimensions()

    def write(self, group, quantities='all', copy=True, absolute_paths=False,
              compression=True, wall_dtype=float, physics_dtype=float):
        if 'Geometry' not in group:
            g_geometry = group.create_group('Geometry')
        else:
            g_geometry = group['Geometry']
        if 'Quantities' not in group:
            g_quantities = group.create_group('Quantities')
        else:
            g_quantities = group['Quantities']

        self._check_array_dimensions()

        g_geometry.attrs['grid_type'] = np.bytes_(self.grid_type.encode('utf-8'))
        g_geometry.attrs['geometry'] = np.bytes_(self.get_geometry_id().encode('utf-8'))

        for i, (col, attr) in enumerate(zip(self.wall_columns, self.wall_attrs)):
            wall = getattr(self, attr)
            dset = g_geometry.create_dataset(
                "walls_%d" % (i + 1),
                data=np.array(list(zip(wall)), dtype=[(col, wall_dtype)]),
                compression=compression)
            dset.attrs['Unit'] = np.bytes_(self._wall_units[i].encode('utf-8'))

        for quantity in self.quantities:
            if quantities == 'all' or quantity in quantities:
                if is_external_link(self.quantities[quantity]):
                    link_or_copy(g_quantities, quantity,
                                 self.quantities[quantity], copy,
                                 absolute_paths=absolute_paths)
                else:
                    dset = g_quantities.create_dataset(
                        quantity, data=self.quantities[quantity],
                        compression=compression, dtype=physics_dtype)
                    dset.attrs['geometry'] = np.bytes_(
                        self.get_geometry_id().encode('utf-8'))

    def write_single_array(self, group, name, array, copy=True,
                           absolute_paths=False, compression=True,
                           physics_dtype=float):
        self._check_array_dimensions(array)
        if is_external_link(array):
            link_or_copy(group, name, array, copy, absolute_paths=absolute_paths)
        else:
            dset = group.create_dataset(name, data=array,
                                        compression=compression,
                                        dtype=physics_dtype)
            dset.attrs['geometry'] = np.bytes_(
                self.get_geometry_id().encode('utf-8'))

    # -- quantity views --------------------------------------------------------

    def __getitem__(self, item):
        return GridView(self, item)

    def __setitem__(self, item, value):
        if isinstance(value, GridView):
            if getattr(self, self.wall_attrs[0]) is None:
                self.set_walls(*[getattr(value._grid, a) for a in self.wall_attrs])
            self.quantities[item] = deepcopy(value.quantities[value.viewed_quantity])
        elif is_external_link(value):
            self.quantities[item] = value
        elif value == []:
            self.quantities[item] = []
        else:
            raise ValueError('value should be an empty list, and ExternalLink, '
                             'or a GridView instance')

    def __contains__(self, item):
        return item in self.quantities

    def reset_quantities(self):
        self.quantities = {}

    def add_derived_quantity(self, name, function):
        if name in self.quantities:
            raise KeyError(name + ' already exists')
        function(self.quantities)


class GridView(object):
    """A view of one named quantity on a grid, indexable by dust population."""

    def __init__(self, grid, quantity):
        self._grid = grid
        self.viewed_quantity = quantity
        if quantity not in grid.quantities:
            grid.quantities[quantity] = []
        self.quantities = {quantity: grid.quantities[quantity]}

    def __getattr__(self, attr):
        # Geometry attributes delegate to the parent grid
        return getattr(self._grid, attr)

    def append(self, grid):
        """Append a population from a 3-D array or another view."""
        if isinstance(grid, GridView):
            if self.quantities[self.viewed_quantity] is grid.quantities[grid.viewed_quantity]:
                raise Exception("Calling append recursively")
            if type(grid.quantities[grid.viewed_quantity]) is list:
                raise Exception("Can only append a single grid")
            self._grid._check_array_dimensions(grid.quantities[grid.viewed_quantity])
            self.quantities[self.viewed_quantity].append(
                deepcopy(grid.quantities[grid.viewed_quantity]))
        elif isinstance(grid, np.ndarray):
            self._grid._check_array_dimensions(grid)
            self.quantities[self.viewed_quantity].append(deepcopy(grid))
        elif is_external_link(grid):
            self.quantities[self.viewed_quantity].append(grid)
        else:
            raise ValueError("grid should be a GridView, array, or ExternalLink")

    def __getitem__(self, item):
        if type(item) is int:
            out = GridView(self._grid.__class__(self._grid), self.viewed_quantity)
            out.quantities = {self.viewed_quantity:
                              self.quantities[self.viewed_quantity][item]}
            return out
        return GridView(self._grid, item)

    @property
    def array(self):
        return self.quantities[self.viewed_quantity]

    @property
    def n_pop(self):
        if type(self.quantities[self.viewed_quantity]) in (list, tuple):
            return len(self.quantities[self.viewed_quantity])
        return 1


def link_or_copy(group, name, link, copy, absolute_paths=False):
    """Copy an external HDF5 link's data, or store the link itself."""
    import h5py
    import os
    if copy:
        with h5py.File(link.filename, 'r') as f:
            f.copy(link.path, group, name=name)
    else:
        if absolute_paths:
            filename = os.path.abspath(link.filename)
        else:
            filename = os.path.relpath(link.filename)
        group[name] = h5py.ExternalLink(filename, link.path)
