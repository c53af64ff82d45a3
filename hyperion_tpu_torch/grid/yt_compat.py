"""yt interoperability (ref: hyperion/grid/yt3_wrappers.py, amr_grid.py
to_yt/from_yt). yt is an optional dependency — every entry point degrades
to an informative ImportError when it is absent (it is not installed in the
standard environment, so these paths are exercised only where yt exists).
"""

import numpy as np


def _require_yt():
    try:
        import yt
    except ImportError as exc:
        raise ImportError(
            "yt is required for to_yt/from_yt conversions — install yt>=3 "
            "to use the yt bridge") from exc
    return yt


def cartesian_grid_to_yt_dataset(grid, dust_id=0):
    """Load a CartesianGrid's quantities into a yt uniform-grid dataset."""
    yt = _require_yt()
    data = {}
    for q, arrays in grid.quantities.items():
        arr = arrays[dust_id] if isinstance(arrays, list) else arrays
        # hyperion arrays are (z, y, x); yt wants (x, y, z)
        data[q] = np.asarray(arr).transpose(2, 1, 0)
    bbox = np.array([[grid.x_wall[0], grid.x_wall[-1]],
                     [grid.y_wall[0], grid.y_wall[-1]],
                     [grid.z_wall[0], grid.z_wall[-1]]])
    shape = next(iter(data.values())).shape
    return yt.load_uniform_grid(data, shape, bbox=bbox)


def amr_grid_to_yt_dataset(levels, dust_id=0):
    """Load an AMRGrid level hierarchy into a yt AMR stream dataset."""
    yt = _require_yt()
    grid_data = []
    xmin = min(g.xmin for g in levels[0].grids)
    xmax = max(g.xmax for g in levels[0].grids)
    ymin = min(g.ymin for g in levels[0].grids)
    ymax = max(g.ymax for g in levels[0].grids)
    zmin = min(g.zmin for g in levels[0].grids)
    zmax = max(g.zmax for g in levels[0].grids)
    dx0 = None
    for ilevel, level in enumerate(levels):
        for g in level.grids:
            dx = (g.xmax - g.xmin) / g.nx
            if ilevel == 0 and dx0 is None:
                dx0 = dx
            entry = dict(
                left_edge=[g.xmin, g.ymin, g.zmin],
                right_edge=[g.xmax, g.ymax, g.zmax],
                level=ilevel,
                dimensions=[g.nx, g.ny, g.nz])
            for q, arrays in g.quantities.items():
                arr = arrays[dust_id] if isinstance(arrays, list) else arrays
                entry[q] = np.asarray(arr).transpose(2, 1, 0)
            grid_data.append(entry)
    domain_dimensions = [int(round((xmax - xmin) / dx0)),
                         int(round((ymax - ymin) / dx0)),
                         int(round((zmax - zmin) / dx0))]
    bbox = np.array([[xmin, xmax], [ymin, ymax], [zmin, zmax]])
    return yt.load_amr_grids(grid_data, domain_dimensions, bbox=bbox)


def amr_grid_from_yt(cls, ds, quantity_mapping={}):
    """Build an AMRGrid from a yt dataset: one hyperion fab per yt grid
    patch, quantities named by ``quantity_mapping`` ({hyperion_name:
    yt_field}). The domain is re-centered on ds.domain_center (ref
    amr_grid.py from_yt notes)."""
    _require_yt()
    if not quantity_mapping:
        raise ValueError("quantity_mapping needs at least one entry, e.g. "
                         "{'density': ('gas', 'density')}")
    ds.index  # make sure the hierarchy is built
    center = np.asarray(ds.domain_center.to_value())
    amr = cls()
    n_levels = int(ds.index.max_level) + 1
    levels = [amr.add_level() for _ in range(n_levels)]
    for ytgrid in ds.index.grids:
        level = levels[int(ytgrid.Level)]
        fab = level.add_grid()
        le = np.asarray(ytgrid.LeftEdge.to_value()) - center
        re = np.asarray(ytgrid.RightEdge.to_value()) - center
        fab.xmin, fab.ymin, fab.zmin = le
        fab.xmax, fab.ymax, fab.zmax = re
        nx, ny, nz = (int(v) for v in ytgrid.ActiveDimensions)
        fab.nx, fab.ny, fab.nz = nx, ny, nz
        for name, field in quantity_mapping.items():
            arr = np.asarray(ytgrid[field])
            fab.quantities[name] = arr.transpose(2, 1, 0).astype(float)
    return amr
