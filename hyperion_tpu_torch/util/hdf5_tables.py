"""Minimal HDF5 'table' read/write helpers.

The reference stores tabular data (dust optical properties, mean opacities,
emissivities, source spectra) as HDF5 compound datasets written by astropy's
Table HDF5 writer (ref: hyperion/dust/dust_type.py:249-353). These helpers
produce/consume the same on-disk layout using h5py + NumPy structured arrays,
avoiding the astropy dependency.
"""

import numpy as np


def write_table(group, path, columns, compression=True):
    """Write an ordered dict of {name: array} as a compound dataset.

    Columns may be 1-D (scalar field) or 2-D (fixed-size subarray field, e.g.
    scattering-matrix rows). All columns must share the same leading length.
    """
    names = list(columns)
    arrays = [np.asarray(columns[n]) for n in names]
    n_rows = arrays[0].shape[0]
    dtype = []
    for name, arr in zip(names, arrays):
        if arr.shape[0] != n_rows:
            raise ValueError("column %s has mismatched length" % name)
        if arr.ndim == 1:
            dtype.append((name, arr.dtype))
        else:
            dtype.append((name, arr.dtype, arr.shape[1:]))
    data = np.zeros(n_rows, dtype=dtype)
    for name, arr in zip(names, arrays):
        data[name] = arr
    kwargs = {'compression': 'gzip'} if (compression and n_rows > 1) else {}
    if path in group:
        del group[path]
    group.create_dataset(path, data=data, **kwargs)


def read_table(group, path):
    """Read a compound dataset back as a dict of {name: ndarray}."""
    data = group[path][...]
    return {name: np.array(data[name]) for name in data.dtype.names}
