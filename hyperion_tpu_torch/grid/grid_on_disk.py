"""Grid referenced from an existing HDF5 file without loading it
(ref: hyperion/grid/grid_on_disk.py): ``Model.use_grid_from_file`` stores a
GridOnDisk, and ``Model.write`` embeds it as an HDF5 external link (or a
straight copy) instead of materializing the arrays in memory — the way to
feed very large precomputed grids through the pipeline.

h5py is imported where a file is read or written, so that this module
imports on a machine without HDF5.
"""

from ..util.functions import asstr


class GridOnDisk(object):

    def __init__(self, filename, path='/'):
        self.filename = filename
        self.path = path

    @property
    def link(self):
        import h5py
        return h5py.ExternalLink(self.filename, self.path)

    @property
    def grid_type(self):
        import h5py
        with h5py.File(self.filename, 'r') as f:
            return asstr(f[self.path]['Geometry'].attrs['grid_type'])

    def __contains__(self, item):
        import h5py
        with h5py.File(self.filename, 'r') as f:
            return item in f[self.path]['Quantities']

    def __getitem__(self, item):
        return GridQuantityOnDisk(self, item)

    def __repr__(self):
        return "<GridOnDisk %s:%s (%s)>" % (self.filename, self.path,
                                            self.grid_type)


class GridQuantityOnDisk(object):
    """Handle on one quantity dataset inside a GridOnDisk (shape inspection
    without reading the data)."""

    def __init__(self, grid, quantity):
        self.filename = grid.filename
        self.path = grid.path
        self.quantity = quantity

    @property
    def n_pop(self):
        import h5py
        with h5py.File(self.filename, 'r') as f:
            d = f[self.path]['Quantities'][self.quantity]
            return d.shape[0] if d.ndim == 4 else 1

    # alias matching GridView.n_pop naming elsewhere
    n_dust = n_pop

    @property
    def shape(self):
        import h5py
        with h5py.File(self.filename, 'r') as f:
            return f[self.path]['Quantities'][self.quantity].shape
