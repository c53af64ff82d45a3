"""Orion / BoxLib plotfile importer of the port (a copy of
``hyperion_tpu/importers/orion.py``; ref: hyperion/importers/orion.py:244
``parse_orion``; behavior re-derived from the BoxLib plotfile format).

A plotfile directory holds an ASCII ``Header`` describing the level
hierarchy, per-level ``Level_N/Cell_H`` MultiFab headers listing the fab
boxes and on-disk offsets, binary FAB files with the cell data, and a
``StarParticles`` table of sink particles.
"""

import os
import re

import numpy as np

from ..grid.amr_grid import AMRGrid

__all__ = ['parse_orion', 'OrionStar']


class OrionStar(object):
    """One sink/star particle from the StarParticles table.

    Columns (ref importers/orion.py:14-19): mass, x, y, z, then radius at
    index 11, accretion rate at 14, burn state at 15.
    """

    def __init__(self, line):
        v = [float(x) for x in line.split()]
        self.m = v[0]
        self.x, self.y, self.z = v[1], v[2], v[3]
        self.r = v[11]
        self.mdot = v[14]
        self.burnstate = v[15]

    def __repr__(self):
        return "<OrionStar m=%g at (%g, %g, %g)>" % (self.m, self.x,
                                                     self.y, self.z)


def _int_tuples(line):
    """All '(a,b,c)'-style integer tuples in a line."""
    return [tuple(int(v) for v in m.split(','))
            for m in re.findall(r'\(([\d,\s-]+?)\)', line)]


def _read_fab_header(fh):
    """Parse a binary-FAB header line; returns (word_size, numpy dtype).

    The header encodes the word size and the byte ORDER as a permutation,
    e.g. ``(8, (1 2 3 4 5 6 7 8))`` = big endian, reversed = little.
    """
    header = fh.readline().decode('ascii')
    groups = re.findall(r'\((\d+)\s*,\s*\(([\d\s]+)\)\)', header)
    if not groups:
        raise ValueError("Not a FAB header: %r" % header[:60])
    # the second group describes the stored data (the first is the
    # reference real format)
    nbytes, order = groups[-1]
    nbytes = int(nbytes)
    order = [int(x) for x in order.split()]
    if order == list(range(1, nbytes + 1)):
        endian = '>'
    elif order == list(range(nbytes, 0, -1)):
        endian = '<'
    else:
        raise ValueError("Unsupported FAB byte order: %s" % order)
    n_comp = int(header.strip().split()[-1])
    return np.dtype('%sf%d' % (endian, nbytes)), n_comp


def parse_orion(dirname, quantities='density', verbose=False, max_level=None):
    """Read a BoxLib/Orion plotfile into (AMRGrid, [OrionStar, ...]).

    ``quantities`` may be a name, a list of names, or 'all'. Only the first
    ``max_level`` levels are read when given.
    """
    with open(os.path.join(dirname, 'Header')) as f:
        f.readline()                                   # version string
        n_comp = int(f.readline())
        names = [f.readline().strip() for _ in range(n_comp)]
        if quantities == 'all':
            wanted = names
        elif isinstance(quantities, str):
            wanted = [quantities]
        else:
            wanted = list(quantities)
        for q in wanted:
            if q not in names:
                raise ValueError("Quantity %r not in plotfile (has: %s)"
                                 % (q, ', '.join(names)))
        indices = {q: names.index(q) for q in wanted}

        ndim = int(f.readline())
        if ndim != 3:
            raise ValueError("Only 3-d plotfiles are supported")
        f.readline()                                   # time
        n_levels = int(f.readline()) + 1
        if max_level is None:
            max_level = n_levels
        lo = [float(x) for x in f.readline().split()]
        hi = [float(x) for x in f.readline().split()]
        f.readline()                                   # refinement ratios
        f.readline()                                   # level index boxes
        f.readline()                                   # level steps
        for _ in range(n_levels):
            f.readline()                               # grid spacing
        if int(f.readline()) != 0:
            raise ValueError("Only cartesian (coordtype 0) plotfiles are "
                             "supported")
        f.readline()                                   # dummy

        amr = AMRGrid()
        for _ in range(min(n_levels, max_level)):
            level_num, ngrids, _time = f.readline().split()
            level_num, ngrids = int(level_num), int(ngrids)
            level = amr.add_level()
            f.readline()                               # level steps
            for _ in range(ngrids):
                grid = level.add_grid()
                grid.xmin, grid.xmax = [float(x) for x in
                                        f.readline().split()]
                grid.ymin, grid.ymax = [float(x) for x in
                                        f.readline().split()]
                grid.zmin, grid.zmax = [float(x) for x in
                                        f.readline().split()]
            mf_path = f.readline().strip()             # e.g. Level_0/Cell
            _read_multifab(dirname, mf_path, level, indices, n_comp,
                           verbose=verbose)

    stars = []
    star_file = os.path.join(dirname, 'StarParticles')
    if os.path.exists(star_file):
        with open(star_file) as fs:
            fs.readline()
            for line in fs:
                if line.strip():
                    stars.append(OrionStar(line))
    return amr, stars


def _read_multifab(dirname, mf_path, level, indices, n_comp_expected,
                   verbose=False):
    """Read the fab boxes + data offsets from <mf_path>_H and load the
    requested components of every fab."""
    with open(os.path.join(dirname, mf_path + '_H')) as fh:
        fh.readline()
        fh.readline()
        n_comp = int(fh.readline())
        if n_comp != n_comp_expected:
            raise ValueError("MultiFab holds %d of %d components — partial "
                             "plotfiles are not supported"
                             % (n_comp, n_comp_expected))
        fh.readline()                                  # ghost cells
        ngrids = int(re.match(r'\((\d+)', fh.readline().strip()).group(1))
        if ngrids != len(level.grids):
            raise ValueError("MultiFab box count %d != header grid count %d"
                             % (ngrids, len(level.grids)))
        for grid in level.grids:
            lo, hi, _types = _int_tuples(fh.readline())
            grid.nx = hi[0] - lo[0] + 1
            grid.ny = hi[1] - lo[1] + 1
            grid.nz = hi[2] - lo[2] + 1
        fh.readline()                                  # closing ')'
        fh.readline()                                  # blank / count line
        fabs = []
        for _ in range(ngrids):
            line = fh.readline()
            if 'FabOnDisk:' not in line:
                raise ValueError("Expected FabOnDisk line, got %r" % line)
            fname, offset = line.split('FabOnDisk:')[1].split()
            fabs.append((fname, int(offset)))

    level_dir = os.path.dirname(mf_path)
    for grid, (fname, offset) in zip(level.grids, fabs):
        path = os.path.join(dirname, level_dir, fname)
        n = grid.nx * grid.ny * grid.nz
        with open(path, 'rb') as fb:
            fb.seek(offset)
            dtype, _nc = _read_fab_header(fb)
            data_start = fb.tell()
            for q, idx in indices.items():
                fb.seek(data_start + idx * dtype.itemsize * n)
                arr = np.frombuffer(fb.read(dtype.itemsize * n), dtype=dtype)
                grid.quantities[q] = arr.astype(float).reshape(
                    grid.nz, grid.ny, grid.nx)
