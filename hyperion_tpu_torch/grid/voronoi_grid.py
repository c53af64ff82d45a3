"""Voronoi grid (ref: hyperion/grid/voronoi_grid.py:18-644).

Cells are the Voronoi regions of a set of sites inside a bounding box.
The reference shells out to vendored voro++ (C++) for the tessellation;
here the tessellation uses scipy's Qhull with the mirror-site trick: sites
are reflected across all six box walls so every interior cell is bounded,
which makes box clipping exact without a native extension. The on-disk
format matches the reference: site coordinates, sparse neighbor lists
(CSR-style 'sparse_neighs'/'sparse_idx'), volumes and bounding box attrs.
"""

import hashlib
from copy import deepcopy

import numpy as np

from ..util.functions import FreezableClass, asstr


class VoronoiGrid(FreezableClass):

    grid_type = 'vor'

    def __init__(self, *args, **kwargs):
        self.shape = None
        self.x = None
        self.y = None
        self.z = None
        self.xmin = self.xmax = None
        self.ymin = self.ymax = None
        self.zmin = self.zmax = None
        self._volumes = None
        self._sparse_neighbors = None
        self.quantities = {}
        self._freeze()
        if len(args) > 0:
            if isinstance(args[0], VoronoiGrid):
                other = args[0]
                self.set_points(other.x, other.y, other.z,
                                xmin=other.xmin, xmax=other.xmax,
                                ymin=other.ymin, ymax=other.ymax,
                                zmin=other.zmin, zmax=other.zmax)
            else:
                self.set_points(*args, **kwargs)

    def set_points(self, x, y, z, xmin=None, xmax=None, ymin=None, ymax=None,
                   zmin=None, zmax=None):
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        z = np.asarray(z, float)
        if x.ndim != 1 or x.shape != y.shape or x.shape != z.shape:
            raise ValueError("x, y, z should be matching 1-D arrays")
        self.x, self.y, self.z = x, y, z
        pad = 0.05
        self.xmin = xmin if xmin is not None else x.min() - pad * np.ptp(x)
        self.xmax = xmax if xmax is not None else x.max() + pad * np.ptp(x)
        self.ymin = ymin if ymin is not None else y.min() - pad * np.ptp(y)
        self.ymax = ymax if ymax is not None else y.max() + pad * np.ptp(y)
        self.zmin = zmin if zmin is not None else z.min() - pad * np.ptp(z)
        self.zmax = zmax if zmax is not None else z.max() + pad * np.ptp(z)
        self.shape = (len(x),)
        self._volumes = None
        self._sparse_neighbors = None

    @property
    def n_cells(self):
        return len(self.x)

    def _tessellate(self):
        """Qhull tessellation with mirror sites for exact box clipping."""
        from scipy.spatial import Voronoi, ConvexHull

        n = self.n_cells
        pts = np.stack([self.x, self.y, self.z], axis=1)
        mirrors = []
        for axis, (lo, hi) in enumerate([(self.xmin, self.xmax),
                                         (self.ymin, self.ymax),
                                         (self.zmin, self.zmax)]):
            m_lo = pts.copy()
            m_lo[:, axis] = 2 * lo - m_lo[:, axis]
            m_hi = pts.copy()
            m_hi[:, axis] = 2 * hi - m_hi[:, axis]
            mirrors.extend([m_lo, m_hi])
        all_pts = np.vstack([pts] + mirrors)
        vor = Voronoi(all_pts)

        # neighbors among real sites (mirror neighbors encode wall contact,
        # ref: domain walls as neighbor ids 0..-5, grid_geometry_voronoi:356)
        neighbors = [[] for _ in range(n)]
        for (p, q) in vor.ridge_points:
            if p < n and q < n:
                neighbors[p].append(q)
                neighbors[q].append(p)
            elif p < n:
                # mirror neighbor: the cell touches a domain wall; which wall
                # follows from which mirror block q falls into
                neighbors[p].append(-1 - (q - n) // n)
            elif q < n:
                neighbors[q].append(-1 - (p - n) // n)
        # encode wall contacts simply as -1 entries
        sparse = []
        idx = [0]
        for i in range(n):
            uniq = sorted(set(neighbors[i]), key=lambda v: (v < 0, v))
            sparse.extend(uniq)
            idx.append(len(sparse))
        self._sparse_neighbors = (np.array(sparse, dtype=np.int64),
                                  np.array(idx, dtype=np.int64))

        # volumes from region convex hulls (bounded thanks to mirrors)
        volumes = np.zeros(n)
        for i in range(n):
            region = vor.regions[vor.point_region[i]]
            if -1 in region or len(region) < 4:
                volumes[i] = 0.0
            else:
                volumes[i] = ConvexHull(vor.vertices[region]).volume
        self._volumes = volumes

    @property
    def volumes(self):
        if self._volumes is None:
            self._tessellate()
        return self._volumes

    @property
    def sparse_neighbors(self):
        if self._sparse_neighbors is None:
            self._tessellate()
        return self._sparse_neighbors

    def evaluate_function_average(self, function, n_samples=10000000,
                                  min_cell_samples=5, seed=12345):
        """Average a function over each cell by Monte-Carlo sampling
        (ref voronoi_grid.py:172-260)."""
        rng = np.random.RandomState(seed)
        n = self.n_cells
        sums = np.zeros(n)
        counts = np.zeros(n, dtype=np.int64)
        from scipy.spatial import cKDTree
        tree = cKDTree(np.stack([self.x, self.y, self.z], axis=1))
        chunk = min(n_samples, 1000000)
        done = 0
        while done < n_samples:
            b = min(chunk, n_samples - done)
            sx = rng.uniform(self.xmin, self.xmax, b)
            sy = rng.uniform(self.ymin, self.ymax, b)
            sz = rng.uniform(self.zmin, self.zmax, b)
            _, owner = tree.query(np.stack([sx, sy, sz], axis=1))
            vals = function(sx, sy, sz)
            np.add.at(sums, owner, vals)
            np.add.at(counts, owner, 1)
            done += b
        # top-up cells below the minimum sample count by sampling near sites
        poor = np.where(counts < min_cell_samples)[0]
        for i in poor:
            scale = (self.xmax - self.xmin) / max(n ** (1 / 3), 1.0)
            sx = self.x[i] + 0.1 * scale * rng.randn(min_cell_samples * 4)
            sy = self.y[i] + 0.1 * scale * rng.randn(min_cell_samples * 4)
            sz = self.z[i] + 0.1 * scale * rng.randn(min_cell_samples * 4)
            _, owner = tree.query(np.stack([sx, sy, sz], axis=1))
            sel = owner == i
            if sel.any():
                sums[i] += function(sx[sel], sy[sel], sz[sel]).sum()
                counts[i] += sel.sum()
        with np.errstate(invalid='ignore'):
            out = sums / counts
        out[counts == 0] = 0.0
        return out

    def _check_array_dimensions(self, array=None):
        from .base import single_grid_dims
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
        for arr in (self.x, self.y, self.z):
            geo_hash.update(np.ascontiguousarray(arr).tobytes())
        for v in (self.xmin, self.xmax, self.ymin, self.ymax, self.zmin,
                  self.zmax):
            geo_hash.update(np.float64(v).tobytes())
        return geo_hash.hexdigest()

    # -- I/O -------------------------------------------------------------------

    def read(self, group, quantities='all'):
        self.read_geometry(group['Geometry'])
        self.read_quantities(group['Quantities'], quantities=quantities)
        self._check_array_dimensions()

    def read_geometry(self, group):
        if asstr(group.attrs['grid_type']) != 'vor':
            raise ValueError("Grid is not a Voronoi grid")
        cells = group['cells']
        self.set_points(np.array(cells['coordinates'][:, 0]),
                        np.array(cells['coordinates'][:, 1]),
                        np.array(cells['coordinates'][:, 2]),
                        xmin=group.attrs['xmin'], xmax=group.attrs['xmax'],
                        ymin=group.attrs['ymin'], ymax=group.attrs['ymax'],
                        zmin=group.attrs['zmin'], zmax=group.attrs['zmax'])
        if 'volumes' in cells.dtype.names:
            self._volumes = np.array(cells['volumes'])
        if 'sparse_neighs' in group:
            self._sparse_neighbors = (np.array(group['sparse_neighs']),
                                      np.array(group['sparse_idx']))
        if asstr(group.attrs['geometry']) != self.get_geometry_id():
            raise Exception("Calculated geometry hash does not match hash "
                            "in file")

    def read_quantities(self, group, quantities='all'):
        for quantity in group:
            if quantities == 'all' or quantity in quantities:
                arr = np.array(group[quantity])
                if arr.ndim == 2:
                    self.quantities[quantity] = [arr[i]
                                                 for i in range(arr.shape[0])]
                else:
                    self.quantities[quantity] = arr
        self._check_array_dimensions()

    def write(self, group, quantities='all', copy=True, absolute_paths=False,
              compression=True, wall_dtype=float, physics_dtype=float):
        g_geometry = group.create_group('Geometry') if 'Geometry' not in group \
            else group['Geometry']
        g_quantities = group.create_group('Quantities') if 'Quantities' not in group \
            else group['Quantities']
        self._check_array_dimensions()
        g_geometry.attrs['grid_type'] = np.bytes_('vor')
        g_geometry.attrs['geometry'] = np.bytes_(self.get_geometry_id())
        for attr in ('xmin', 'xmax', 'ymin', 'ymax', 'zmin', 'zmax'):
            g_geometry.attrs[attr] = getattr(self, attr)
        coords = np.stack([self.x, self.y, self.z], axis=1)
        cells = np.zeros(self.n_cells,
                         dtype=[('coordinates', float, (3,)),
                                ('volumes', float)])
        cells['coordinates'] = coords
        cells['volumes'] = self.volumes
        g_geometry.create_dataset('cells', data=cells,
                                  compression='gzip' if compression else None)
        sn, si = self.sparse_neighbors
        g_geometry.create_dataset('sparse_neighs', data=sn,
                                  compression='gzip' if compression else None)
        g_geometry.create_dataset('sparse_idx', data=si,
                                  compression='gzip' if compression else None)
        for quantity in self.quantities:
            if quantities == 'all' or quantity in quantities:
                dset = g_quantities.create_dataset(
                    quantity, data=self.quantities[quantity],
                    compression='gzip' if compression else None,
                    dtype=physics_dtype)
                dset.attrs['geometry'] = np.bytes_(self.get_geometry_id())

    # -- views -----------------------------------------------------------------

    def __getitem__(self, item):
        from .base import GridView
        return GridView(self, item)

    def __setitem__(self, item, value):
        from .base import GridView
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
