"""Run a Model through the port and write its .rtout (counterpart of
``hyperion_tpu/model/run.py``).

The slice: cartesian, spherical-polar and cylindrical-polar grids; every
source type (point sources and their collections, spherical sources with
limb darkening, spots and the re-absorption of photons that hit them,
luminosity maps with or without an LTE spectrum, external spheres and
boxes, plane-parallel beams); any number of dust types;
Lucy iterations with or without convergence checking, the modified random
walk, the partial diffusion approximation, frequency-resolved specific
energy bins, an initial or additional specific energy read from the grid,
the minimum-specific-energy floor, ``enforce_energy_range``, sublimation
and the probabilistic geometry self-check; then the imaging iteration with
peeled and binned SEDs and images (forced first interaction, polarization,
every track_origin mode, filters, depth cuts, inside observers), or the
monochromatic one at exact frequencies, and the raytracing pass; models
without sources (monochromatic dust emission). Anything else raises
``NotImplementedError`` naming its ROADMAP.md item. The output
layout is the JAX package's, read by either package's ``ModelOutput``;
:func:`run_lucy_model` is the same run without the file, for machines
without HDF5. Both run on the card unless the caller passes
``device='cpu'``."""

import datetime
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import engine_dtype, resolve_device
from ..grid import (AMRGrid, CartesianGrid, CylindricalPolarGrid,
                    SphericalPolarGrid)
from ..transport.dtable import build_dust_tables
from ..transport.gtable import ESCAPED, build_cartesian_geometry
from ..transport.gtable_cylindrical import build_cylindrical_geometry
from ..transport.gtable_spherical import build_spherical_geometry
from ..transport.lucy import run_lucy
from ..transport.pda import build_pda_tables
from ..transport.stable import POINT, SPHERE, build_source_tables
from ..util.perf import PerfTable
from .imaging_runner import run_imaging, write_peel_group
from .model import Model


def _flatten_quantity(grid, quantity):
    """Per-dust quantity arrays -> (n_dust, n_cells) float64, handling the
    AMR per-fab layout (fabs flattened level-major); a copy of
    ``hyperion_tpu/model/run.py:_flatten_quantity``."""
    if isinstance(grid, AMRGrid):
        n_pop = None
        for level in grid.levels:
            for g in level.grids:
                q = g.quantities[quantity]
                n_pop = len(q) if isinstance(q, list) else 1
                break
            break
        rows = []
        for i in range(n_pop):
            parts = []
            for level in grid.levels:
                for g in level.grids:
                    q = g.quantities[quantity]
                    arr = q[i] if isinstance(q, list) else q
                    parts.append(np.asarray(arr, float).reshape(-1))
            rows.append(np.concatenate(parts))
        return np.array(rows)
    q = grid.quantities[quantity]
    return np.array([np.asarray(d, float).reshape(-1) for d in q])


def _write_grid_dataset(group, name, flat, model_grid, compression='gzip',
                        io_dtype=None):
    """Write a flat (n_cells,) or (n_dust, n_cells) array back in the
    grid's on-disk layout (structured: (ndust, n3, n2, n1); AMR: per
    level_*/grid_* datasets; voronoi/octree: flat); a copy of
    ``hyperion_tpu/model/run.py:_write_grid_dataset``.

    ``io_dtype``: on-disk float width for physical arrays, from
    ``set_output_bytes`` (ref grid_io.f90 writes f4 when io_bytes=4,
    conf_files.py:700)."""
    flat = np.asarray(flat)
    if io_dtype is not None and flat.dtype.kind == 'f':
        flat = flat.astype(io_dtype)
    if isinstance(model_grid, AMRGrid):
        pos = 0
        for ilevel, level in enumerate(model_grid.levels):
            g_level = group.require_group('level_%05i' % (ilevel + 1))
            for igrid, g in enumerate(level.grids):
                g_grid = g_level.require_group('grid_%05i' % (igrid + 1))
                n = g.nx * g.ny * g.nz
                block = flat[..., pos:pos + n]
                shape = flat.shape[:-1] + (g.nz, g.ny, g.nx)
                g_grid.create_dataset(name, data=block.reshape(shape),
                                      compression=compression)
                pos += n
        return
    shape = model_grid.shape
    if shape is not None and len(shape) > 1:
        flat = flat.reshape(flat.shape[:-1] + shape)
    group.create_dataset(name, data=flat, compression=compression)


def bool2bytes(value):
    return np.bytes_(b'yes') if value else np.bytes_(b'no')


def _check_slice(model):
    """Refuse what the port does not run yet, naming its ROADMAP item."""
    def refuse(what, item):
        raise NotImplementedError("%s is not in the port yet: ROADMAP.md "
                                  "queue 1 item %s" % (what, item))

    if not isinstance(model, Model):
        raise TypeError("the port runs a hyperion_tpu_torch.model.Model, not "
                        "a %s.%s" % (type(model).__module__,
                                     type(model).__name__))
    if not isinstance(model.grid, (CartesianGrid, SphericalPolarGrid,
                                   CylindricalPolarGrid)):
        refuse("%s" % type(model.grid).__name__, 11)


def build_geometry_tables(grid, device, dtype):
    """The geometry tables of a cartesian, spherical-polar or
    cylindrical-polar grid."""
    if isinstance(grid, SphericalPolarGrid):
        return build_spherical_geometry(grid, device, dtype)
    if isinstance(grid, CylindricalPolarGrid):
        return build_cylindrical_geometry(grid, device, dtype)
    return build_cartesian_geometry(grid, device, dtype)


def _initial_specific_energy(model):
    """(n_dust, n_cells) specific energy read from the grid, or None."""
    if 'specific_energy' in model.grid:
        return _flatten_quantity(model.grid, 'specific_energy')
    return None


def _density_array(model, length_scale, device, dtype):
    """Per-dust densities as (n_dust, n_cells) in ENGINE units (times the
    length scale, so chi*rho*ds is scale-free). Non-zero densities are
    floored at 1e-30 engine units, which keeps float32 cells that the
    reference (f64) sees as dusty from underflowing to dust-free."""
    arr = _flatten_quantity(model.grid, 'density') * length_scale
    arr = np.where(arr > 0.0, np.maximum(arr, 1e-30), 0.0)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def _validate_model(geometry, st, dt):
    """Fail fast where the reference aborts at run time: a point source or
    a sphere's centre outside the grid, or a source spectrum (not an LTE
    one) beyond the dust frequency tables. As in the JAX package
    (``hyperion_tpu/model/run.py:143-170``) other rows are not checked for
    lying inside the grid: their photons emitted outside it escape at
    once."""
    pos = st.position
    zero = torch.zeros_like(pos[:, 0])
    cell = geometry.find_cell(pos[:, 0], pos[:, 1], pos[:, 2], zero, zero,
                              zero + 1.0)
    checked = (st.type_code == POINT) | (st.type_code == SPHERE)
    bad = ((cell == ESCAPED) & checked).nonzero()
    if len(bad):
        i = int(bad[0, 0])
        raise ValueError(
            "photon was not emitted inside a cell: source %d at position %s "
            "lies outside the grid"
            % (i, pos[i].cpu().numpy() * geometry.length_scale))
    nu_lo = float(dt.nu.min())
    nu_hi = float(dt.nu.max())
    spec = st.spec_nu.cpu().numpy().astype(float)
    lte = st.lte.cpu().numpy() if st.has_lte else \
        np.zeros(spec.shape[0], bool)
    for i in range(spec.shape[0]):
        if lte[i]:
            continue
        if spec[i].min() < nu_lo * (1 - 1e-10) or \
                spec[i].max() > nu_hi * (1 + 1e-10):
            raise ValueError(
                "photon frequency for source %d (range %.3e-%.3e Hz) is "
                "outside the range defined (%.3e-%.3e Hz) for the dust "
                "optical properties" % (i, spec[i].min(), spec[i].max(),
                                        nu_lo, nu_hi))


class ModelRun(NamedTuple):
    """What :func:`run_lucy_model` computed, in memory."""
    result: object        # transport.lucy.LucyResult, None without iterations
    # per iteration: specific_energy, density, n_photons and
    # specific_energy_spectrum (None without spectrum bins)
    iterations: list
    density0: np.ndarray  # (n_dust, n_cells) physical density before the run
    # one row per iteration, and one for imaging: wall seconds, photons,
    # steps, transport events, lanes, energy_current, killed_int, killed_geo
    perf: PerfTable
    # imaging_runner.ImagingRun of the peeled and binned groups, or None
    # when the model asks for neither
    imaging: object = None


def run_lucy_model(model, device=None, batch_size=None, dtype=None,
                   max_steps=100000000, imaging_max_steps=None):
    """Run the model's Lucy iterations, then its imaging iteration when it
    has peeled or binned output, on ``device`` ('cuda', the default, or
    'cpu') and return a :class:`ModelRun`. This is :func:`run_model`
    without the file: it needs no HDF5. ``max_steps`` caps the steps of a
    Lucy iteration and ``imaging_max_steps`` (``max_steps`` when None) the
    imaging iteration's (the bounded-step safety net: lanes still alive at
    the cap are killed and counted in killed_int). The imaging batch is
    the Lucy iterations' (``hyperion_tpu/model/run.py:229-232,365``)."""
    device = resolve_device(device)
    dtype = engine_dtype(device, dtype)
    _check_slice(model)
    user_batch_size = batch_size

    dusts = model._dust_objects()
    if not dusts:
        raise Exception("Cannot run a model with no dust or density "
                        "(pure-source models are not yet supported)")

    geometry = build_geometry_tables(model.grid, device, dtype)
    dt = build_dust_tables(dusts, device, dtype)
    st = build_source_tables(model.sources, device, dtype,
                             length_scale=geometry.length_scale,
                             sample_evenly=model.sample_sources_evenly,
                             grid=model.grid)
    density = _density_array(model, geometry.length_scale, device, dtype)
    if model.sources:
        # (a source-less model's placeholder row emits nothing)
        _validate_model(geometry, st, dt)

    n_initial = model.n_photons.get('initial', 0)
    if batch_size is None:
        batch_size = int(min(2 ** 17, max(4096, n_initial // 4)))
    min_se = model._resolved_minimum_specific_energy(dusts)
    init_se = _initial_specific_energy(model)
    generator = torch.Generator(device=device)
    generator.manual_seed(abs(model._seed) % (2 ** 31))

    perf = PerfTable()
    iterations = []
    iter_t = [time.time()]

    def callback(it, se, rho, n_photons_cell, se_spectrum, stats):
        now = time.time()
        perf.add('lucy iteration %d' % it, now - iter_t[-1],
                 photons=n_initial, events=stats['n_events'],
                 steps=stats['n_steps'], lanes=stats['batch_size'],
                 energy_current=stats['energy_current'],
                 killed_int=stats['killed_int'],
                 killed_geo=stats['killed_geo'])
        iter_t.append(now)
        # the engine density carries the length scale: store the physical one
        iterations.append(dict(specific_energy=se,
                               density=rho / geometry.length_scale,
                               n_photons=n_photons_cell,
                               specific_energy_spectrum=se_spectrum))

    density0 = density.cpu().numpy().astype(float) / geometry.length_scale
    result = None
    if model.n_iterations > 0 and n_initial > 0:
        result = run_lucy(
            geometry, dt, st, density, generator,
            n_photons=n_initial, n_iterations=model.n_iterations,
            batch_size=batch_size,
            n_inter_max=model.n_inter_max,
            kill_on_scatter=model.kill_on_scatter,
            kill_on_absorb=model.kill_on_absorb,
            n_reabs_max=model.n_reabs_max,
            minimum_specific_energy=min_se,
            enforce_energy_range=model.enforce_energy_range,
            check_convergence=model.check_convergence,
            convergence_absolute=getattr(model, 'convergence_absolute', 0.0),
            convergence_relative=getattr(model, 'convergence_relative', 1.02),
            convergence_percentile=getattr(model, 'convergence_percentile',
                                           100.0),
            initial_specific_energy=init_se,
            additional_specific_energy=(
                init_se if model.specific_energy_type == 'additional'
                else None),
            use_mrw=model.mrw, mrw_gamma=getattr(model, 'mrw_gamma', 1.0),
            n_mrw_max=getattr(model, 'n_inter_mrw_max', 1000),
            use_pda=model.pda,
            pda_tables=build_pda_tables(model.grid) if model.pda else None,
            check_frequency=getattr(model, '_frequency', 0.0),
            spectrum_bins=model.specific_energy_spectrum_bins,
            max_steps=max_steps, verbose=True, iteration_callback=callback)

    img = None
    if model.peeled_output or model.binned_output is not None:
        # the last iteration's specific energy drives the emission, or with
        # no iterations the grid's own (ref: the engine reads the grid's
        # specific_energy when n_initial_iter == 0)
        se = iterations[-1]['specific_energy'] if iterations else init_se
        if result is not None:
            # the last iteration's (possibly sublimated) density
            density = torch.as_tensor(result.density, dtype=dtype,
                                      device=device)
        img = run_imaging(
            model, geometry, dt, st, density,
            None if se is None else torch.as_tensor(
                np.asarray(se, float), dtype=dtype, device=device),
            batch_size,
            max_steps=max_steps if imaging_max_steps is None
            else imaging_max_steps, user_batch_size=user_batch_size)
        n_img = sum(model.n_photons.get(k) or 0
                    for k in ('last', 'last_sources', 'last_dust'))
        # the imaging steps, as the JAX package's, make no geometry
        # self-check: their killed_geo is 0 by construction
        perf.add('imaging', img.wall, photons=n_img or None,
                 events=img.n_events, steps=img.n_steps,
                 lanes=img.batch_size, energy_current=img.energy_current,
                 killed_int=img.killed_int, killed_geo=0)
        print("[imaging] %d steps, killed=%d/0" % (img.n_steps,
                                                   img.killed_int))
        if img.raytrace is not None:
            perf.add('raytracing', img.raytrace['wall'],
                     photons=img.raytrace['photons'] or None,
                     outside=img.raytrace['outside'])
            print("[raytracing] %d batches in %.3f s, %d photons outside "
                  "the grid or their cell"
                  % (img.raytrace['batches'], img.raytrace['wall'],
                     img.raytrace['outside']))
    perf.report()
    return ModelRun(result, iterations, density0, perf, img)


def run_model(model, filename, device=None, batch_size=None, dtype=None):
    """Run the model (:func:`run_lucy_model`: the Lucy iterations, then
    imaging) and write the .rtout file. Returns the :class:`ModelRun`."""
    t_start = time.time()
    run = run_lucy_model(model, device=device, batch_size=batch_size,
                         dtype=dtype)
    _write_rtout(model, filename, run, t_start)
    return run


def _write_rtout(model, filename, run, t_start):
    """The .rtout layout of hyperion_tpu/model/run.py:297-382, with the
    /Peeled and /Binned groups of hyperion_tpu/model/imaging_runner.py."""
    import h5py
    result = run.result
    with h5py.File(filename, 'w') as out:
        out.attrs['python_version'] = np.bytes_("hyperion_tpu_torch")
        out.attrs['date_started'] = np.bytes_(
            datetime.datetime.now().isoformat())
        oc = model.conf.output
        io_dtype = np.float32 if getattr(model, 'physics_io_bytes', 8) == 4 \
            else np.float64
        for i, itdata in enumerate(run.iterations):
            g = out.create_group('iteration_%05i' % (i + 1))
            last = i == len(run.iterations) - 1

            def want(setting):
                return setting == 'all' or (setting == 'last' and last)

            if want(oc.output_specific_energy):
                _write_grid_dataset(g, 'specific_energy',
                                    itdata['specific_energy'], model.grid,
                                    io_dtype=io_dtype)
            if want(oc.output_density):
                _write_grid_dataset(g, 'density', itdata['density'],
                                    model.grid, io_dtype=io_dtype)
            if want(oc.output_density_diff):
                _write_grid_dataset(g, 'density_diff',
                                    itdata['density'] - run.density0,
                                    model.grid, io_dtype=io_dtype)
            if want(oc.output_n_photons):
                _write_grid_dataset(g, 'n_photons', itdata['n_photons'],
                                    model.grid)
            if itdata['specific_energy_spectrum'] is not None and \
                    want(oc.output_specific_energy_spectrum):
                # (n_dust, n_bins, *grid shape) and the bin edges (ref
                # grid_generic.f90:68-74)
                _write_grid_dataset(g, 'specific_energy_spectrum',
                                    itdata['specific_energy_spectrum'],
                                    model.grid, io_dtype=io_dtype)
                g.create_dataset('specific_energy_spectrum_bin_edges',
                                 data=np.asarray(
                                     model.specific_energy_spectrum_bins,
                                     float))
            g.attrs['killed_photons_geo'] = result.killed_geo
            g.attrs['killed_photons_int'] = result.killed_int

        if result is not None:
            out.attrs['converged'] = bool2bytes(result.converged)
            out.attrs['iterations'] = result.iterations
            out.attrs['killed_photons_geo_initial'] = result.killed_geo
            out.attrs['killed_photons_int_initial'] = result.killed_int
        else:
            out.attrs['converged'] = bool2bytes(False)
            out.attrs['iterations'] = 0

        img = run.imaging
        if img is not None:
            g_peeled = out.create_group('Peeled')
            for i, arrays in enumerate(img.peeled):
                write_peel_group(g_peeled.create_group('group_%05i' % (i + 1)),
                                 arrays)
            if img.binned is not None:
                # the binned datasets live directly under /Binned
                write_peel_group(out.create_group('Binned'), img.binned)
            out.attrs['killed_photons_int_final'] = img.killed_int
            out.attrs['killed_photons_geo_final'] = 0

        out.attrs['cpu_time'] = time.time() - t_start
        out.attrs['date_ended'] = np.bytes_(
            datetime.datetime.now().isoformat())
        # embed the input for a self-contained output (ref main.f90:135-151)
        if model.copy_input and model.filename is not None:
            with h5py.File(model.filename, 'r') as fin:
                fin.copy('/', out, name='Input')
