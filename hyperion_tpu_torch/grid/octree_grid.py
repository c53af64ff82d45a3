"""Octree grid (ref: hyperion/grid/octree_grid.py).

The geometry is a preorder 'refined' boolean array: element 0 describes the
root cell; a True value is followed immediately by the 8 sub-cell subtrees
(children ordered x-fastest, then y, then z). ``x, y, z`` are the root
center and ``dx, dy, dz`` its HALF-widths (ref cell_width,
src/grid/grid_geometry_octree.f90:68-80). Quantities are 1-D arrays with one
value per node (leaf values are the physical ones).
"""

import hashlib
from copy import deepcopy

import numpy as np

from ..util.functions import FreezableClass, is_numpy_array, asstr
from .base import GridView, single_grid_dims


class OctreeGrid(FreezableClass):

    grid_type = 'oct'

    def __init__(self, *args):
        self.shape = None
        self.x = None
        self.y = None
        self.z = None
        self.dx = None
        self.dy = None
        self.dz = None
        self._refined = None
        self.quantities = {}
        self._freeze()
        if len(args) > 0:
            if isinstance(args[0], OctreeGrid):
                self.set_walls(args[0].x, args[0].y, args[0].z,
                               args[0].dx, args[0].dy, args[0].dz,
                               args[0].refined)
            else:
                self.set_walls(*args)

    def set_walls(self, x, y, z, dx, dy, dz, refined):
        for name, v in (('x', x), ('y', y), ('z', z), ('dx', dx), ('dy', dy),
                        ('dz', dz)):
            if not np.isscalar(v):
                raise ValueError("%s should be a scalar value" % name)
        self.x, self.y, self.z = x, y, z
        self.dx, self.dy, self.dz = dx, dy, dz
        if type(refined) in [list, tuple]:
            refined = np.array(refined)
        if refined.dtype != bool:
            refined = refined.astype(bool)
        if not is_numpy_array(refined) or refined.ndim != 1:
            raise ValueError("refined should be a 1-D boolean sequence")
        self.refined = refined
        self.shape = (len(refined),)

    @property
    def refined(self):
        return self._refined

    @refined.setter
    def refined(self, value):
        if value is None:
            self._refined = None
            return
        if (len(value) - 1) % 8 != 0:
            raise ValueError("refined should have shape 8 * n + 1")
        self._validate(value)
        self._refined = value

    def _validate(self, refined):
        """Check the preorder structure is consistent (every True is followed
        by exactly 8 complete subtrees; ref octree_grid.py:198-244)."""
        i = [0]

        def walk(depth):
            if i[0] >= len(refined):
                raise ValueError("refined array is truncated")
            if depth > 30:
                raise ValueError("refined array implies a tree deeper than 30")
            node = i[0]
            i[0] += 1
            if refined[node]:
                for _ in range(8):
                    walk(depth + 1)

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(100000)
        try:
            walk(0)
        finally:
            sys.setrecursionlimit(old)
        if i[0] != len(refined):
            raise ValueError("refined array has %d extra elements"
                             % (len(refined) - i[0]))

    @property
    def n_cells(self):
        return len(self._refined)

    @property
    def n_leaves(self):
        return int(np.sum(~self._refined))

    @property
    def volumes(self):
        """Per-node volumes (leaf nodes hold the physical cells)."""
        centers, halves, _ = self.tree_tables()
        return 8.0 * halves[:, 0] * halves[:, 1] * halves[:, 2]

    def tree_tables(self):
        """Compute (centers (n,3), half_widths (n,3), children (n,8))
        from the preorder refined array — the flattened traversal tables the
        transport engine uses (replacing the reference's recursive pointers,
        grid_geometry_octree.f90:135-146)."""
        refined = np.asarray(self._refined)
        n = len(refined)
        centers = np.zeros((n, 3))
        halves = np.zeros((n, 3))
        children = np.full((n, 8), -1, dtype=np.int32)
        idx = [0]

        def walk(cx, cy, cz, hx, hy, hz):
            node = idx[0]
            idx[0] += 1
            centers[node] = (cx, cy, cz)
            halves[node] = (hx, hy, hz)
            if refined[node]:
                k = 0
                for oz in (-0.5, 0.5):
                    for oy in (-0.5, 0.5):
                        for ox in (-0.5, 0.5):
                            children[node, k] = idx[0]
                            walk(cx + ox * hx, cy + oy * hy, cz + oz * hz,
                                 hx / 2, hy / 2, hz / 2)
                            k += 1
            return node

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(100000)
        try:
            walk(self.x, self.y, self.z, self.dx, self.dy, self.dz)
        finally:
            sys.setrecursionlimit(old)
        return centers, halves, children

    def _check_array_dimensions(self, array=None):
        for quantity in self.quantities:
            n_pop, shape = single_grid_dims(self.quantities[quantity], ndim=1)
            if shape is not None and shape != self.shape:
                raise ValueError("Quantity arrays do not have the right "
                                 "dimensions: %s instead of %s"
                                 % (shape, self.shape))
        if array is not None:
            n_pop, shape = single_grid_dims(array, ndim=1)
            if shape != self.shape:
                raise ValueError("Quantity arrays do not have the right "
                                 "dimensions: %s instead of %s"
                                 % (shape, self.shape))

    def get_geometry_id(self):
        geo_hash = hashlib.md5()
        for v in (self.x, self.y, self.z, self.dx, self.dy, self.dz):
            geo_hash.update(np.float64(v).tobytes())
        geo_hash.update(np.ascontiguousarray(self._refined).tobytes())
        return geo_hash.hexdigest()

    # -- I/O ------------------------------------------------------------------

    def read(self, group, quantities='all'):
        self.read_geometry(group['Geometry'])
        self.read_quantities(group['Quantities'], quantities=quantities)
        self._check_array_dimensions()

    def read_geometry(self, group):
        if asstr(group.attrs['grid_type']) != 'oct':
            raise ValueError("Grid is not an octree")
        self.set_walls(group.attrs['x'], group.attrs['y'], group.attrs['z'],
                       group.attrs['dx'], group.attrs['dy'], group.attrs['dz'],
                       np.array(group['cells']['refined'], dtype=bool))
        if asstr(group.attrs['geometry']) != self.get_geometry_id():
            raise Exception("Calculated geometry hash does not match hash "
                            "in file")

    def read_quantities(self, group, quantities='all'):
        if quantities is not None:
            for quantity in group:
                if quantities == 'all' or quantity in quantities:
                    array = np.array(group[quantity])
                    if array.ndim == 2:
                        self.quantities[quantity] = [array[i]
                                                     for i in range(array.shape[0])]
                    else:
                        self.quantities[quantity] = array
        self._check_array_dimensions()

    def write(self, group, quantities='all', copy=True, absolute_paths=False,
              compression=True, wall_dtype=float, physics_dtype=float):
        import h5py
        g_geometry = group.create_group('Geometry') if 'Geometry' not in group \
            else group['Geometry']
        g_quantities = group.create_group('Quantities') if 'Quantities' not in group \
            else group['Quantities']
        self._check_array_dimensions()
        g_geometry.attrs['grid_type'] = np.bytes_('oct')
        g_geometry.attrs['geometry'] = np.bytes_(self.get_geometry_id())
        g_geometry.attrs['x'] = self.x
        g_geometry.attrs['y'] = self.y
        g_geometry.attrs['z'] = self.z
        g_geometry.attrs['dx'] = self.dx
        g_geometry.attrs['dy'] = self.dy
        g_geometry.attrs['dz'] = self.dz
        dset = g_geometry.create_dataset(
            'cells', data=np.array(list(zip(self._refined.astype(np.int32))),
                                   dtype=[('refined', np.int32)]),
            compression='gzip' if compression else None)
        for quantity in self.quantities:
            if quantities == 'all' or quantity in quantities:
                dset = g_quantities.create_dataset(
                    quantity, data=self.quantities[quantity],
                    compression='gzip' if compression else None,
                    dtype=physics_dtype)
                dset.attrs['geometry'] = np.bytes_(self.get_geometry_id())

    def write_single_array(self, group, name, array, copy=True,
                           absolute_paths=False, compression=True,
                           physics_dtype=float):
        self._check_array_dimensions(array)
        dset = group.create_dataset(name, data=array,
                                    compression='gzip' if compression else None,
                                    dtype=physics_dtype)
        dset.attrs['geometry'] = np.bytes_(self.get_geometry_id())

    # -- views ----------------------------------------------------------------

    def __getitem__(self, item):
        return GridView(self, item)

    def __setitem__(self, item, value):
        if isinstance(value, GridView):
            self.quantities[item] = deepcopy(
                value.quantities[value.viewed_quantity])
        elif value == []:
            self.quantities[item] = []
        else:
            raise ValueError('value should be an empty list or a GridView '
                             'instance')

    def __contains__(self, item):
        return item in self.quantities

    def reset_quantities(self):
        self.quantities = {}

    def add_derived_quantity(self, name, function):
        if name in self.quantities:
            raise KeyError(name + ' already exists')
        function(self.quantities)
