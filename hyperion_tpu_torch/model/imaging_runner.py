"""The imaging iteration of a model and its peeled and binned groups
(counterpart of ``hyperion_tpu/model/imaging_runner.py``; ref image_write,
src/images/image_type.f90:608-788).

:func:`run_imaging` runs the iteration (the Monte-Carlo one over sampled
frequencies, or the monochromatic one at the model's exact frequencies),
then with raytracing the raytracing pass, whose direct and thermal light
the Monte-Carlo iteration then leaves out (it peels scatterings only; ref
main.f90:272-302). It returns each group as numpy arrays in the on-disk
layout: 'seds' (n_stokes, n_orig, n_view, n_ap, n_nu) and 'images'
(n_stokes, n_orig, n_view, n_y, n_x, n_nu), nu F_nu through dnunorm (the
exact frequencies for monochromatic groups), cumulative apertures and
sqrt(sum x^2) uncertainties. :func:`write_peel_group` writes one such group
into an HDF5 group; the arrays need no h5py."""

import time
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.mesh import (STREAM_IMAGING, STREAM_MONO, STREAM_RAYTRACE,
                             rank_generator, run_final_sharded)
from ..transport import imaging, mono, raytrace
from ..transport.escape_tau import EscapeTau
from ..util.functions import bool2str


class ImagingRun(NamedTuple):
    """What :func:`run_imaging` computed: per peeled group, and for the
    binned group (or None), the dict of :func:`peel_group_arrays`."""
    peeled: list
    binned: object
    energy_current: float
    killed_int: int
    n_steps: int
    n_events: int
    batch_size: int
    wall: float
    # the raytracing pass's wall (seconds, its tables included), batches,
    # photons and photons that started outside the grid or their cell
    # (raytrace.run_raytracing), or None without raytracing
    raytrace: object = None


def imaging_options(model, geometry, dt, density):
    """The model's peeled groups on the density's device and the keywords
    of :func:`~..transport.imaging.start_final` that its settings give:
    ``(groups, options)``."""
    from .run import build_geometry_tables    # run.py imports this module
    device, dtype = density.device, density.dtype
    kw = dict(length_scale=geometry.length_scale,
              n_sources=max(len(model.sources), 1), n_dust=dt.n_dust)
    groups = [imaging.build_peel_group(conf, device, dtype, **kw)
              for conf in model.peeled_output]
    options = dict(
        walk_geometry=build_geometry_tables(model.grid, device,
                                            torch.float64),
        n_inter_max=model.n_inter_max, kill_on_scatter=model.kill_on_scatter,
        kill_on_absorb=model.kill_on_absorb,
        forced_first_interaction=model.forced_first_interaction,
        # with raytracing the Monte-Carlo iteration peels scattered light
        # only (ref main.f90:272-302: do_final(peeloff_scattering_only=
        # use_raytracing))
        peeloff_scattering_only=model.raytracing,
        n_reabs_max=model.n_reabs_max,
        ffi_algorithm=model.forced_first_interaction_algorithm,
        ffi_baes16_xi=model.forced_first_interaction_baes16_xi,
        use_mrw=model.mrw, mrw_gamma=getattr(model, 'mrw_gamma', 1.0),
        n_mrw_max=getattr(model, 'n_inter_mrw_max', 1000))
    if model.binned_output is not None:
        options.update(
            binned_group=imaging.build_binned_group(
                model.binned_output, device, dtype, **kw),
            binned_dims=(model.binned_output.n_theta,
                         model.binned_output.n_phi))
    return groups, options


def run_imaging(model, geometry, dt, st, density, specific_energy,
                batch_size, max_steps=100000000, user_batch_size=None,
                group=None):
    """Run the model's imaging iteration, monochromatic or not, and its
    raytracing pass, on the density's device. ``density`` and
    ``specific_energy`` are (n_dust, n_cells) engine-unit tensors (the
    specific energy None for zero); ``batch_size`` is the Lucy
    iterations', ``user_batch_size`` the caller's own (which the
    monochromatic iteration honours; it clamps the Lucy batch to its
    budget otherwise). With ``group`` (a launched
    :class:`..parallel.mesh.Group`) every pass is shared out over the
    ranks, each with its own generators, and reduced as the JAX package's
    (``batch_size`` a rank)."""
    groups, options = imaging_options(model, geometry, dt, density)
    if model._monochromatic:
        return _run_imaging_mono(model, geometry, dt, st, density,
                                 specific_energy, groups,
                                 options['walk_geometry'], batch_size,
                                 max_steps, user_batch_size, group)
    n_phot = model.n_photons.get('last')
    if n_phot is None:
        raise Exception("imaging photon count has not been set "
                        "(set_n_photons(imaging=...))")
    generator = rank_generator(model._seed, STREAM_IMAGING, density.device,
                               group)
    t0 = time.time()
    if group is None:
        res = imaging.run_final(
            geometry, dt, st, density, specific_energy, groups, generator,
            n_phot, batch_size=batch_size, max_steps=max_steps, **options)
    else:
        res = run_final_sharded(
            group, geometry, dt, st, density, specific_energy, groups,
            generator, n_phot, batch_size=batch_size, max_steps=max_steps,
            **options)
    wall = time.time() - t0
    scale = float(st.energy_total) / max(res.energy_current, 1e-300)
    raytraced, ray = [None] * len(groups), None
    if model.raytracing:
        dusts = model._dust_objects()

        def tables(g, se):
            return raytrace.build_raytrace_tables(
                dusts, model.sources, g, se, density, geometry.volumes,
                density.device, density.dtype,
                length_scale=geometry.length_scale)[:2]

        raytraced, ray = _raytrace(model, geometry, st, density,
                                   specific_energy, groups,
                                   options['walk_geometry'], batch_size,
                                   tables, group)
    peeled = [peel_group_arrays(conf, g, acc, scale, raytraced=r)
              for conf, g, acc, r in zip(model.peeled_output, groups,
                                         res.accums, raytraced)]
    binned = None
    if model.binned_output is not None:
        binned = peel_group_arrays(model.binned_output,
                                   options['binned_group'], res.binned_acc,
                                   scale)
    return ImagingRun(peeled, binned, res.energy_current, res.killed_int,
                      res.n_steps, res.n_events, int(batch_size), wall, ray)


def _raytrace(model, geometry, st, density, specific_energy, groups,
              walk_geometry, batch_size, tables, group=None):
    """The raytracing pass of every group (``tables(group, se)`` gives its
    ``(RaytraceTables, var_grids)``): per group the (sed, img) luminosity
    cubes to add to Stokes I, and (wall, batches, photons, outside)."""
    n_src = model.n_photons.get('raytracing_sources', 0) or 0
    n_dust = model.n_photons.get('raytracing_dust', 0) or 0
    se = torch.zeros_like(density) if specific_energy is None \
        else specific_energy
    walk = EscapeTau(walk_geometry, density.T.contiguous())
    generator = rank_generator(model._seed, STREAM_RAYTRACE, density.device,
                               group)
    t0 = time.time()
    out, batches, outside = [], 0, 0
    for g in groups:
        rt, var_grids = tables(g, se)
        sed, img, stats = raytrace.run_raytracing(
            walk, geometry, st, rt, var_grids, [g], se, generator, n_src,
            n_dust, int(batch_size), group=group)
        out.append((sed[0], img[0]))
        batches += stats['batches']
        outside += stats['outside']
    return out, dict(wall=time.time() - t0, batches=batches,
                     photons=n_src + n_dust, outside=outside)


def _run_imaging_mono(model, geometry, dt, st, density, specific_energy,
                      groups, walk_geometry, batch_size, max_steps,
                      user_batch_size, group=None):
    """The monochromatic iteration at the model's exact frequencies, then
    with raytracing the raytracing pass at the same frequencies (ref
    do_final_mono and do_raytracing, main.f90:272-302)."""
    n_src = model.n_photons.get('last_sources', 0) or 0
    n_dustp = model.n_photons.get('last_dust', 0) or 0
    per_pass = max(n_src, n_dustp, 1)
    if user_batch_size is not None:
        batch_size = user_batch_size
    elif batch_size is None or batch_size > per_pass:
        # a batch much wider than one pass's budget drags dead lanes
        # through every step: the Lucy batch clamped to it
        batch_size = max(1024, 1 << (per_pass - 1).bit_length())
    batch_size = int(batch_size)
    generator = rank_generator(model._seed, STREAM_MONO, density.device,
                               group)
    walk = EscapeTau(walk_geometry, density.T.contiguous())
    freqs = np.asarray(model._frequencies, float)
    dusts = model._dust_objects()
    t0 = time.time()
    accums, stats = mono.run_mono(
        geometry, walk, dt, st, density, specific_energy, groups, generator,
        freqs, n_src, n_dustp, model.sources, dusts, batch_size=batch_size,
        n_inter_max=model.n_inter_max, kill_on_scatter=model.kill_on_scatter,
        forced_first_interaction=model.forced_first_interaction,
        # with raytracing the direct light comes from the raytracing pass
        peeloff_scattering_only=model.raytracing,
        ffi_algorithm=model.forced_first_interaction_algorithm,
        ffi_baes16_xi=model.forced_first_interaction_baes16_xi,
        n_reabs_max=model.n_reabs_max, max_steps=max_steps, group=group)
    wall = time.time() - t0
    raytraced, ray = [None] * len(groups), None
    if model.raytracing:
        def tables(g, se):
            # each group images a contiguous slice of the frequencies
            return raytrace.build_raytrace_tables_mono(
                dusts, model.sources,
                freqs[g.iwav_min:g.iwav_min + g.n_nu], se,
                density, geometry.volumes, density.device, density.dtype,
                length_scale=geometry.length_scale)

        raytraced, ray = _raytrace(model, geometry, st, density,
                                   specific_energy, groups, walk_geometry,
                                   batch_size, tables, group)
    peeled = [peel_group_arrays(conf, g, acc, 1.0, raytraced=r,
                                frequencies=freqs)
              for conf, g, acc, r in zip(model.peeled_output, groups,
                                         accums, raytraced)]
    return ImagingRun(peeled, None, 0.0, stats['killed_int'],
                      stats['n_steps'], stats['n_events'], batch_size, wall,
                      ray)


def _origin_attrs(group):
    """The track_origin metadata the reader slices components by (ref
    ModelOutput._get_origin_slice)."""
    attrs = {'track_origin': np.bytes_(group.track_origin)}
    if group.track_origin == 'detailed':
        attrs.update(n_sources=group.n_sources, n_dust=group.n_dust)
    elif group.track_origin == 'scatterings':
        attrs['track_n_scat'] = group.track_n_scat
    return attrs


def peel_group_arrays(conf, group, acc, scale, raytraced=None,
                      frequencies=None):
    """One group normalized into the on-disk layout of
    ``hyperion_tpu/model/imaging_runner.py:write_peel_group``: returns
    ``{'attrs': {...}, 'datasets': {name: (array, attrs)}}`` in the order
    the writer creates them. ``raytraced``: the raytracing pass's (sed,
    img) luminosity cubes, added to Stokes I before the conversion;
    ``frequencies``: the model's exact frequencies, for a monochromatic
    group."""
    cubes = {k: v.detach().cpu().numpy().astype(np.float64)
             for k, v in acc.cubes().items()}
    n_nu = group.n_nu
    nu_min = 10.0 ** float(group.log10_nu_min)
    nu_max = 10.0 ** float(group.log10_nu_max)
    if group.monochromatic:
        # exact frequencies: F_nu -> nu F_nu bin by bin (ref
        # image_type.f90:678-683)
        nu_norm = np.asarray(frequencies, float)[
            group.iwav_min:group.iwav_min + n_nu]

        def per_nu(a, axis):
            shape = [1] * a.ndim
            shape[axis] = n_nu
            return a * nu_norm.reshape(shape)
    else:
        if group.use_filters:
            # the filter table already carries the normalization and the nu
            # factor (ref image_type.f90:650-654, dnunorm = 1)
            dnunorm = 1.0
        else:
            # F_nu dnu -> nu F_nu (ref image_type.f90:624-658)
            dnunorm = (nu_max / nu_min) ** (+0.5 / n_nu) - \
                (nu_max / nu_min) ** (-0.5 / n_nu)

        def per_nu(a, axis):
            return a / dnunorm

    def total(name, r):
        """The cube times the scale, the raytraced light added to I."""
        a = cubes[name] * scale
        if raytraced is not None and raytraced[r] is not None:
            a[..., 0] += raytraced[r]
        return a

    d_min = getattr(conf, 'd_min', None)
    d_max = getattr(conf, 'd_max', None)
    attrs = {'inside_observer': bool2str(group.inside),
             'd_min': -np.inf if d_min is None else d_min,
             'd_max': +np.inf if d_max is None else d_max}
    datasets = {}
    if group.monochromatic or group.use_filters:
        freq = np.zeros(n_nu, dtype=[('nu', float)])
        freq['nu'] = nu_norm if group.monochromatic else \
            [filt.central_nu for filt in conf._filters]
        datasets['frequencies'] = (freq, {})
    nu_attrs = {} if group.use_filters or group.monochromatic else \
        {'numin': nu_min, 'numax': nu_max}
    io_dtype = np.float32 if conf.io_bytes == 4 else np.float64

    if group.compute_sed:
        # (n_view, n_ap, n_nu, n_orig, n_stokes) ->
        # (n_stokes, n_orig, n_view, n_ap, n_nu), apertures cumulated
        sed = per_nu(total('sed', 0), 2).transpose(4, 3, 0, 1, 2)
        datasets['seds'] = (np.cumsum(sed, axis=3).astype(io_dtype), dict(
            nu_attrs, apmin=conf.ap_min, apmax=conf.ap_max,
            **_origin_attrs(group)))
        if group.uncertainties:
            unc = per_nu(np.sqrt(cubes['sed2']) * scale, 2).transpose(
                4, 3, 0, 1, 2)
            datasets['seds_unc'] = (
                np.sqrt(np.cumsum(unc ** 2, axis=3)).astype(io_dtype),
                dict(nu_attrs))
    if group.compute_image:
        # (n_view, n_y, n_x, n_nu, n_orig, n_stokes) ->
        # (n_stokes, n_orig, n_view, n_y, n_x, n_nu)
        img = per_nu(total('img', 1), 3).transpose(5, 4, 0, 1, 2, 3)
        datasets['images'] = (img.astype(io_dtype), dict(
            nu_attrs, xmin=conf.xmin, xmax=conf.xmax, ymin=conf.ymin,
            ymax=conf.ymax, **_origin_attrs(group)))
        if group.uncertainties:
            unc = per_nu(np.sqrt(cubes['img2']) * scale, 3).transpose(
                5, 4, 0, 1, 2, 3)
            datasets['images_unc'] = (unc.astype(io_dtype), dict(nu_attrs))
    return dict(attrs=attrs, datasets=datasets)


def write_peel_group(g, arrays):
    """Write one group of :func:`peel_group_arrays` into the HDF5 group
    ``g``."""
    for k, v in arrays['attrs'].items():
        g.attrs[k] = v
    for name, (data, attrs) in arrays['datasets'].items():
        dset = g.create_dataset(
            name, data=data,
            compression=None if name == 'frequencies' else 'gzip')
        for k, v in attrs.items():
            dset.attrs[k] = v
