"""Carry state from the JAX package into the port.

The JAX tables' fields, given as numpy arrays (for example
``{k: np.asarray(v) for k, v in jax_dt._asdict().items()}``), become the
port's tables, so both engines can run on the very same tables (the dust
tables with the scattering matrix the imaging step reads). Fields the port
does not use are ignored."""

import dataclasses

import numpy as np
import torch

from .transport.dtable import DustTables
from .transport.gtable import CartesianGeometry
from .transport.gtable_amr import AMRGeometry
from .transport.gtable_cylindrical import CylindricalGeometry
from .transport.gtable_octree import OctreeGeometry, node_bounds, tree_depth
from .transport.gtable_spherical import SphericalGeometry
from .transport.gtable_voronoi import VoronoiGeometry
from .transport.imaging import PeelGroup
from .transport.mrw import MRWTables
from .transport.stable import SourceTables


def _build(cls, fields, device, dtype):
    kw = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if isinstance(v, np.ndarray) and v.ndim:
            v = torch.tensor(v, device=device,
                             dtype=dtype if v.dtype.kind == 'f' else None)
        elif isinstance(v, np.ndarray):
            v = v.item()
        kw[f.name] = v
    return cls(**kw)


def _octree_from_numpy(fields, device, dtype):
    """The port's OctreeGeometry from the JAX one's fields: its walls
    ``lo`` and ``hi`` from the parents' centres and the root's ``c -+ h``
    (:func:`node_bounds`), its depth from the tree."""
    centers = np.asarray(fields['centers'])
    halves = np.asarray(fields['halves'])
    children = np.asarray(fields['children']).astype(np.int64)
    refined = np.asarray(fields['refined'], bool)
    lo, hi = node_bounds(centers, children, refined, centers[0] - halves[0],
                         centers[0] + halves[0])

    def f(a):
        return torch.tensor(a, device=device, dtype=dtype)

    return OctreeGeometry(
        centers=f(centers), halves=f(halves), lo=f(lo), hi=f(hi),
        children=torch.tensor(children, device=device),
        refined=torch.tensor(refined, device=device),
        volumes=f(np.asarray(fields['volumes'])),
        max_depth=tree_depth(children, refined),
        n_nodes=int(fields['n_nodes']),
        length_scale=float(fields['length_scale']))


def tables_from_numpy(dust, sources, geometry, device, dtype):
    """(DustTables, SourceTables, geometry) from dicts of numpy fields of
    the JAX DustTables, SourceTables and CartesianGeometry,
    SphericalGeometry, CylindricalGeometry, OctreeGeometry, AMRGeometry or
    VoronoiGeometry (told apart by ``rw``, ``ww``, ``children``, ``fab_lo``
    and ``neigh``)."""
    sources = dict(sources, energy_total=float(sources['energy_total']))
    if 'children' in geometry:
        geo = _octree_from_numpy(geometry, device, dtype)
    elif 'fab_lo' in geometry:
        geometry = dict(geometry, fab_offset=np.asarray(
            geometry['fab_offset']).astype(np.int64))
        geo = _build(AMRGeometry, geometry, device, dtype)
    elif 'neigh' in geometry:
        geo = _build(VoronoiGeometry, geometry, device, dtype)
    else:
        geometry_cls = SphericalGeometry if 'rw' in geometry else \
            CylindricalGeometry if 'ww' in geometry else CartesianGeometry
        geo = _build(geometry_cls, geometry, device, dtype)
    return (_build(DustTables, dust, device, dtype),
            _build(SourceTables, sources, device, dtype), geo)


def mrw_tables_from_numpy(mrw, device, dtype):
    """The port's MRWTables from a dict of numpy fields of the JAX
    MRWTables (its TPU row layout ``x_rows`` is dropped)."""
    return _build(MRWTables, mrw, device, dtype)


def visit_state_from_numpy(last_uid_padded, n_cells):
    """The JAX engine's padded last-uid table (the Pallas layout, rounded up
    to 128 lanes) trimmed to the port's (n_cells + 1,) int32 table."""
    return torch.as_tensor(
        np.asarray(last_uid_padded)[:n_cells + 1].astype(np.int32))


def peel_group_from_numpy(fields, device, dtype):
    """The port's PeelGroup from a dict of numpy fields (and static values)
    of the JAX PeelGroup: the frames stay float64 numpy, the limits become
    floats, the filter tables tensors, the monochromatic flag and first
    index a bool and an int."""
    kw = {}
    for f in dataclasses.fields(PeelGroup):
        if f.name.startswith('_'):
            continue
        v = fields.get(f.name)
        if f.name in ('view_dir', 'east', 'north', 'origin'):
            v = np.asarray(v, float)
        elif f.name == 'monochromatic':
            v = bool(v)
        elif f.name == 'iwav_min':
            v = int(v or 0)
        elif f.name in ('filter_lognu', 'filter_tn'):
            v = None if v is None else torch.tensor(np.asarray(v),
                                                    device=device, dtype=dtype)
        elif isinstance(v, np.ndarray) or hasattr(v, 'dtype'):
            v = float(np.asarray(v))
        kw[f.name] = v
    return PeelGroup(**kw)
