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
from .transport.gtable_cylindrical import CylindricalGeometry
from .transport.gtable_spherical import SphericalGeometry
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


def tables_from_numpy(dust, sources, geometry, device, dtype):
    """(DustTables, SourceTables, geometry) from dicts of numpy fields of
    the JAX DustTables, SourceTables and CartesianGeometry,
    SphericalGeometry or CylindricalGeometry (told apart by the radial
    walls ``rw`` and ``ww``)."""
    sources = dict(sources, energy_total=float(sources['energy_total']))
    geometry_cls = SphericalGeometry if 'rw' in geometry else \
        CylindricalGeometry if 'ww' in geometry else CartesianGeometry
    return (_build(DustTables, dust, device, dtype),
            _build(SourceTables, sources, device, dtype),
            _build(geometry_cls, geometry, device, dtype))


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
