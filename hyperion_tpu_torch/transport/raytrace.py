"""The raytracing pass of the port: noise-free direct and thermal emission
(counterpart of ``hyperion_tpu/transport/raytrace.py``; ref
src/main/iter_raytracing.f90:31-143, images_peeled.f90:228-258 and
image_bin_raytraced, image_type.f90:526-580).

Photons are emitted from the sources and from the grid's thermal emission
and peeled at once: each event bins its whole spectrum, attenuated by
exp(-Σ_d N_d chi_d(nu)), where N_d is the dust's column density along the
line of sight. One call of the column mode of the escape-tau walk
(:meth:`~.escape_tau.EscapeTau.columns`, a hand-written kernel on the card)
per batch and group walks every view's lines of sight at once; the cubes
take each batch with one ``index_add_`` each, in float64 on the device, and
are read once at the end.

The host tables (:func:`build_raytrace_tables`, and
:func:`build_raytrace_tables_mono` at exact frequencies) are numpy, made
once and moved to the density's device. A batch takes its uniforms as one
``(n_rows, B)`` block from a ``torch.Generator``; the batch pieces take
their uniforms as arguments, so that a test can feed the JAX package's
functions the same draws."""

import math
from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import (reduce_raytrace, run_raytrace_dust_sharded,
                             run_raytrace_source_sharded)
from .gtable import ESCAPED, CartesianGeometry, position_uniforms
from .gtable_amr import AMRGeometry
from .gtable_cylindrical import CylindricalGeometry
from .gtable_octree import OctreeGeometry
from .gtable_spherical import SphericalGeometry
from .gtable_voronoi import VoronoiGeometry
from .imaging import Provenance, origin_index
from .stable import emit_extra_rows, emit_packets, per_row

# rows of a source batch's uniforms: the source pick, the frequency (drawn,
# not used), the direction, then the stellar surface's point and direction;
# for maps, boxes and beams then the rows of stable.E_*
# (stable.emit_extra_rows)
U_SRC, U_NU, U_MU, U_PHI, U_CAP, U_CAP_PHI, U_OUT, U_OUT_PHI = range(8)
U_EXTRA = 8
# rows of a dust batch's uniforms: the emitting (dust, cell), then the
# position in the cell (geometry.POSITION_ROWS rows)
U_CELL, U_POS = 0, 1


@dataclass
class RaytraceTables:
    # source spectra in the group's bins, each normalized by its whole
    # spectrum's energy: (n_sources, n_int)
    source_spec: torch.Tensor
    # dust emissivity spectra per (dust, var row), normalized per row:
    # (n_dust * n_var, n_int)
    dust_spec: torch.Tensor
    # per-dust extinction on the internal spectral grid: (n_dust, n_int)
    chi_nu: torch.Tensor
    # the grid's thermal luminosity per (dust, cell) and its CDF
    cell_lum: torch.Tensor       # (n_dust * n_cells,)
    cell_cdf: torch.Tensor
    total_grid_luminosity: float
    # (n_int, n_chan) fold of the internal grid onto a filter group's
    # channels (ref images_peeled.f90:264-282); None for plain groups,
    # whose internal grid is their frequency axis
    fold: Optional[torch.Tensor] = None


def _host(a):
    """A float64 numpy copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, float)


def _bin_spectrum(nu_src, f_src, nu_edges):
    """A (nu, fnu) spectrum integrated into the bins (energy per bin, as
    the Monte-Carlo estimator's F_nu dnu bin contents)."""
    from ..util.integrate import integrate_loglog_subset
    out = np.zeros(len(nu_edges) - 1)
    for j in range(len(out)):
        lo = max(nu_edges[j], nu_src[0])
        hi = min(nu_edges[j + 1], nu_src[-1])
        if hi > lo:
            out[j] = integrate_loglog_subset(nu_src, f_src, lo, hi)
    return out


# the var rows of every dust's emissivity table that the tables keep,
# resampled evenly (duplicates allowed, so that the flat (n_dust *
# N_VAR_EFF, n_nu) table indexes uniformly), as the JAX package's
N_VAR_EFF = 60


def _var_rows(dust):
    """(var, row indices) of the dust's N_VAR_EFF resampled var rows."""
    var = np.asarray(dust.emissivities.var, float)
    idx = np.linspace(0, len(var) - 1, N_VAR_EFF).astype(int)
    return var[idx], idx


def _grid_luminosity(specific_energy, density, volumes, length_scale, f):
    """(cell_lum, cell_cdf, total) of the grid's thermal emission: L = E rho
    V per (dust, cell), the engine units scaled back to erg/s."""
    se, rho, vol = _host(specific_energy), _host(density), _host(volumes)
    lum = (se * rho * vol[None, :]).reshape(-1) * length_scale ** 2
    total = lum.sum()
    cdf = np.cumsum(lum) / total if total > 0 else \
        np.linspace(0, 1, lum.size)
    return f(lum), f(cdf), float(total)


def build_raytrace_tables(dusts, sources, group, specific_energy, density,
                          volumes, device, dtype, length_scale=1.0):
    """The tables of one peel group's frequency grid: ``(RaytraceTables,
    var_grids, nu_edges)``; the JAX package's builder (N_VAR_EFF var rows
    of each dust's emissivities), with a source row per emission row.
    Filter groups take the shared filter sampling grid as the internal
    grid and fold the attenuated spectra into their channels (ref
    images_peeled.f90:264-282)."""
    from ..util.functions import planck_nu_range
    from ..util.integrate import integrate_loglog
    fold = None
    if group.use_filters:
        lognu = _host(group.filter_lognu)
        d = lognu[1] - lognu[0]
        nu_edges = 10.0 ** np.concatenate([[lognu[0] - 0.5 * d],
                                           lognu + 0.5 * d])
        nu_c = 10.0 ** lognu
        # (n_samp, n_filt): channel = attenuated spectrum @ fold
        fold = _host(group.filter_tn).T
    else:
        nu_edges = np.logspace(float(group.log10_nu_min),
                               float(group.log10_nu_max), group.n_nu + 1)
        nu_c = np.sqrt(nu_edges[:-1] * nu_edges[1:])

    # sources, one row per emission row: binned in range and normalized by
    # the whole spectrum's energy, so that a photon's energy outside the
    # range is dropped, as in the Monte-Carlo estimator
    def binned(s):
        if getattr(s, 'temperature', None) is not None and \
                getattr(s, 'spectrum', None) is None:
            prange = planck_nu_range(s.temperature)
            nu_s, fnu_s = s.get_spectrum(nu_range=(prange[0], prange[-1]))
        else:
            nu_s, fnu_s = s.get_spectrum()
        spec = _bin_spectrum(nu_s, fnu_s, nu_edges)
        total = integrate_loglog(np.asarray(nu_s, float),
                                 np.asarray(fnu_s, float))
        return spec / total if total > 0 else spec

    source_spec = np.array(per_row(sources, binned))

    # dust emissivities per var row, binned, with the same normalization
    dust_spec = []
    var_grids = []
    for d in dusts:
        em = d.emissivities
        var, idx = _var_rows(d)
        var_grids.append(var)
        enu = np.asarray(em.nu, float)
        for i in idx:
            jnu = np.maximum(np.asarray(em.jnu[:, i], float), 0.0)
            spec = _bin_spectrum(enu, jnu, nu_edges)
            total = integrate_loglog(enu, jnu)
            dust_spec.append(spec / total if total > 0 else spec)
    dust_spec = np.array(dust_spec)

    # per-dust extinction: the bin average of chi, integral(chi dnu) over
    # the bin's width, not chi at its centre (ref get_chi_nu_binned,
    # dust_type_4elem.f90:793-818); chi at the centre of a bin outside
    # the dust's table
    chi_nu = []
    for d in dusts:
        op = d.optical_properties
        dnu = np.asarray(op.nu, float)
        covered = (np.minimum(nu_edges[1:], dnu[-1]) >
                   np.maximum(nu_edges[:-1], dnu[0]))
        chi_nu.append(np.where(
            covered, _bin_spectrum(dnu, np.asarray(op.chi, float), nu_edges) /
            np.diff(nu_edges), op.interp_chi_nu(nu_c)))
    chi_nu = np.array(chi_nu)

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    lum, cdf, total = _grid_luminosity(specific_energy, density, volumes,
                                       length_scale, f)
    return RaytraceTables(
        source_spec=f(source_spec), dust_spec=f(dust_spec), chi_nu=f(chi_nu),
        cell_lum=lum, cell_cdf=cdf, total_grid_luminosity=total,
        fold=None if fold is None else f(fold)), var_grids, nu_edges


def build_raytrace_tables_mono(dusts, sources, frequencies, specific_energy,
                               density, volumes, device, dtype,
                               length_scale=1.0):
    """Exact-frequency tables for monochromatic groups: ``(RaytraceTables,
    var_grids)`` (ref image_bin_raytraced with exact frequencies). The
    spectra are per-Hz probability densities at the frequencies (fnu /
    int(fnu dnu) for the sources, jnu / int(jnu dnu) per dust state), the
    weights of the monochromatic Monte-Carlo photons, so that the raytraced
    flux adds to their cubes in the same units."""
    from ..util.integrate import integrate_loglog
    from .mono import source_mono_energies

    frequencies = np.asarray(frequencies, float)
    source_spec = source_mono_energies(sources, frequencies)
    dust_spec = []
    var_grids = []
    for d in dusts:
        em = d.emissivities
        var, idx = _var_rows(d)
        var_grids.append(var)
        enu = np.asarray(em.nu, float)
        for i in idx:
            jnu = np.maximum(np.asarray(em.jnu[:, i], float), 0.0)
            norm = integrate_loglog(enu, jnu)
            if norm > 0:
                dust_spec.append(np.interp(frequencies, enu, jnu / norm,
                                           left=0.0, right=0.0))
            else:
                dust_spec.append(np.zeros_like(frequencies))
    dust_spec = np.array(dust_spec)
    chi_nu = np.array([d.optical_properties.interp_chi_nu(frequencies)
                       for d in dusts])

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    lum, cdf, total = _grid_luminosity(specific_energy, density, volumes,
                                       length_scale, f)
    return RaytraceTables(
        source_spec=f(source_spec), dust_spec=f(dust_spec), chi_nu=f(chi_nu),
        cell_lum=lum, cell_cdf=cdf,
        total_grid_luminosity=total), var_grids


def sample_position_in_cell(geometry, cell, u):
    """A random position inside each cell from the uniforms ``u``
    (geometry.POSITION_ROWS, B) (ref random_position_cell): exact on
    cartesian cells; uniform in r^3, cos(theta) and phi on spherical-polar
    ones, and in w^2, z and phi on cylindrical-polar ones; uniform in an
    octree leaf's or an AMR cell's box; a Voronoi cell's bounding-box
    rejection from 12 uniforms (the geometry's ``position_in_cell``)."""
    if isinstance(geometry, (OctreeGeometry, AMRGeometry, VoronoiGeometry)):
        return geometry.position_in_cell(cell, u)
    if not isinstance(geometry, (CartesianGeometry, SphericalGeometry,
                                 CylindricalGeometry)):
        raise TypeError("positions in the cells of %s"
                        % type(geometry).__name__)
    i1, i2, i3 = geometry.decode(cell)
    if isinstance(geometry, CartesianGeometry):
        xw, yw, zw = geometry.xw, geometry.yw, geometry.zw
        return (xw[i1] + u[0] * (xw[i1 + 1] - xw[i1]),
                yw[i2] + u[1] * (yw[i2 + 1] - yw[i2]),
                zw[i3] + u[2] * (zw[i3 + 1] - zw[i3]))
    if isinstance(geometry, SphericalGeometry):
        r3_lo = geometry.rw[i1] ** 3
        r3_hi = geometry.rw[i1 + 1] ** 3
        r = (r3_lo + u[0] * (r3_hi - r3_lo)) ** (1.0 / 3.0)
        mu_hi = geometry.cos_tw[i2]
        mu_lo = geometry.cos_tw[i2 + 1]
        mu = mu_lo + u[1] * (mu_hi - mu_lo)
        phi = geometry.phi_w[i3] + u[2] * (geometry.phi_w[i3 + 1] -
                                           geometry.phi_w[i3])
        st_ = torch.sqrt((1.0 - mu * mu).clamp_min(0.0))
        return r * st_ * torch.cos(phi), r * st_ * torch.sin(phi), r * mu
    w2_lo = geometry.ww[i1] ** 2
    w2_hi = geometry.ww[i1 + 1] ** 2
    w = torch.sqrt(w2_lo + u[0] * (w2_hi - w2_lo))
    zc = geometry.zw[i2] + u[1] * (geometry.zw[i2 + 1] - geometry.zw[i2])
    phi = geometry.phi_w[i3] + u[2] * (geometry.phi_w[i3 + 1] -
                                       geometry.phi_w[i3])
    return w * torch.cos(phi), w * torch.sin(phi), zc


class RaytraceAccum:
    """The float64 cubes of one group on the device: sed (n_view, n_ap,
    n_nu, n_orig) and img (n_view, n_y, n_x, n_nu, n_orig)."""

    def __init__(self, group, device):
        g = group
        self.sed = torch.zeros((g.n_view, g.n_ap, g.n_nu, g.n_orig),
                               dtype=torch.float64, device=device)
        self.img = torch.zeros((g.n_view, g.n_y, g.n_x, g.n_nu, g.n_orig),
                               dtype=torch.float64, device=device)


def _bin_vector_xy(group, acc, iv, x_img, y_img, flux, orig):
    """Add whole-spectrum vectors ``flux`` (B, n_nu) into the cubes of view
    ``iv`` by image-plane (or sky-angle) coordinates: one ``index_add_``
    per cube, the lanes outside the apertures or the image adding 0."""
    n_nu = flux.shape[1]
    f = torch.arange(n_nu, device=flux.device)
    flux = flux.to(torch.float64)
    if group.compute_sed:
        if group.n_ap == 1:
            ir = torch.zeros_like(orig)
            ok = torch.ones_like(orig, dtype=torch.bool)
        else:
            r_img = torch.sqrt(x_img ** 2 + y_img ** 2)
            logr = torch.log10(r_img.clamp_min(1e-300))
            fr = (logr - group.log10_ap_min) / \
                (group.log10_ap_max - group.log10_ap_min)
            ir = torch.floor(fr * (group.n_ap - 1)).clamp(
                -1.0, float(group.n_ap)).long() + 1
            ir = torch.where(logr < group.log10_ap_min, 0, ir)
            ok = ir < group.n_ap
            ir = ir.clamp(0, group.n_ap - 1)
        idx = ((iv * group.n_ap + ir)[:, None] * n_nu + f) * group.n_orig + \
            orig[:, None]
        acc.sed.view(-1).index_add_(0, idx.reshape(-1), torch.where(
            ok[:, None], flux, 0.0).reshape(-1))
    if group.compute_image:
        fx = (x_img - group.xmin) / (group.xmax - group.xmin)
        fy = (y_img - group.ymin) / (group.ymax - group.ymin)
        ix = torch.floor(fx * group.n_x).clamp(-1.0, float(group.n_x)).long()
        iy = torch.floor(fy * group.n_y).clamp(-1.0, float(group.n_y)).long()
        ok = (ix >= 0) & (ix < group.n_x) & (iy >= 0) & (iy < group.n_y)
        pix = (iv * group.n_y + iy.clamp(0, group.n_y - 1)) * group.n_x + \
            ix.clamp(0, group.n_x - 1)
        idx = (pix[:, None] * n_nu + f) * group.n_orig + orig[:, None]
        acc.img.view(-1).index_add_(0, idx.reshape(-1), torch.where(
            ok[:, None], flux, 0.0).reshape(-1))


def _sights(group, x, y, z):
    """The lines of sight of a group: ((vdx, vdy, vdz) each (n, B), t_max
    (n, B) or None, d_obs (B,) or None). Outside views: the view
    directions, n = n_view; an inside observer: the one direction toward
    it, n = 1, the walk limited to its distance (ref
    images_peeled.f90:158-161)."""
    if group.inside:
        ddx = float(group.origin[0]) - x
        ddy = float(group.origin[1]) - y
        ddz = float(group.origin[2]) - z
        d_obs = torch.sqrt(ddx ** 2 + ddy ** 2 + ddz ** 2)
        d_safe = d_obs.clamp_min(1e-30)
        k = tuple((a / d_safe)[None].contiguous() for a in (ddx, ddy, ddz))
        return k, d_obs[None].contiguous(), d_obs
    return group.view_block(x), None, None


def _peel_view_bin(group, rt, iv, x, y, z, vd, d_obs, col, active, spec,
                   acc, orig, scale=1.0, weight_fn=None):
    """One (group, view) peel of a raytraced batch (the JAX package's
    ``_peel_view_bin`` after its walk): the spectra ``spec`` (B, n_int)
    attenuated by exp(-col @ chi_nu) with the column densities ``col`` (B,
    n_dust) of the line of sight ``vd`` = (vdx, vdy, vdz) (B,) each,
    weighted (``weight_fn(vdx, vdy, vdz)``, the stellar surface's), diluted
    by 1/(4 pi d_obs^2) for an inside observer, folded into the filter
    channels, times ``scale``, and binned by the event's image-plane
    position (or its sky angles for an inside observer)."""
    vdx, vdy, vdz = vd
    tau_nu = col @ rt.chi_nu
    flux = spec * torch.exp(-tau_nu)
    if weight_fn is not None:
        flux = flux * weight_fn(vdx, vdy, vdz)[:, None]
    if group.inside:
        dil = group.inv_area / (4.0 * math.pi * d_obs.clamp_min(1e-30) ** 2)
        flux = flux * dil[:, None]
    if rt.fold is not None:
        flux = flux @ rt.fold
    flux = torch.where(active[:, None], flux * scale, 0.0)

    if group.inside:
        # the sky projection of the peel direction (as imaging.peel_and_bin)
        r_hat, e, n = group.view_dir[iv], group.east[iv], group.north[iv]
        vs_x = vdx * r_hat[0] + vdy * r_hat[1] + vdz * r_hat[2]
        vs_y = vdx * e[0] + vdy * e[1] + vdz * e[2]
        vs_z = vdx * n[0] + vdy * n[1] + vdz * n[2]
        rad2deg = 180.0 / math.pi
        x_img = torch.atan2(vs_y, vs_x) * rad2deg
        y_img = torch.atan2(torch.sqrt(vs_x ** 2 + vs_y ** 2),
                            vs_z) * rad2deg - 90.0
        if group.compute_image:
            x_img = group.xmax + torch.remainder(x_img - group.xmax, 360.0)
            y_img = group.ymin + torch.remainder(y_img - group.ymin, 360.0)
    else:
        dx = x - float(group.origin[0])
        dy = y - float(group.origin[1])
        dz = z - float(group.origin[2])
        e, n = group.east[iv], group.north[iv]
        x_img = dx * e[0] + dy * e[1] + dz * e[2]
        y_img = dx * n[0] + dy * n[1] + dz * n[2]
    _bin_vector_xy(group, acc, iv, x_img, y_img, flux, orig)


def _peel_batch(walk, rt, groups, accums, x, y, z, cell, active, spec, prov,
                scale, weight_fn=None):
    """Peel a batch into every group: one column call per group for all of
    its lines of sight, then each view's attenuation and binning."""
    for group, acc in zip(groups, accums):
        k, t_max, d_obs = _sights(group, x, y, z)
        col = walk.columns(x, y, z, *k, cell, active, t_max=t_max)
        orig = origin_index(group, prov).clamp(0, group.n_orig - 1)
        for iv in range(group.n_view):
            j = 0 if group.inside else iv
            _peel_view_bin(group, rt, iv, x, y, z,
                           tuple(a[j] for a in k), d_obs, col[j], active,
                           spec, acc, orig, scale, weight_fn)


def raytrace_source_batch(walk, geometry, st, rt, groups, accums, u, n_active,
                          scale, sphere):
    """One batch of source photons from the uniforms ``u`` (8, B), or (8 +
    ``stable.emit_extra_rows``, B) for map, box and beam rows: emitted,
    peeled into ``accums`` with the energy ``scale`` each (the sources'
    luminosity over the photon count; the source pick already weighs each
    source by its share). ``sphere``: whether a row emits from a sphere's surface
    (``st.has_sphere``). Returns the count (a device tensor) of the
    batch's photons emitted outside the grid, which peel nothing."""
    B = u.shape[1]
    new = emit_packets(st, u[U_SRC], u[U_NU], u[U_MU], u[U_PHI],
                       (u[U_CAP], u[U_CAP_PHI], u[U_OUT], u[U_OUT_PHI])
                       if sphere else None,
                       u_extra=u[U_EXTRA:] if u.shape[0] > U_EXTRA else None,
                       geometry=geometry)
    x, y, z = (new[c].contiguous() for c in ('x', 'y', 'z'))
    cell = geometry.find_cell(x, y, z, new['kx'], new['ky'], new['kz'])
    in_batch = torch.arange(B, device=x.device) < n_active
    active = in_batch & (cell != ESCAPED)
    src = new['source']
    weight_fn = None
    if sphere:
        def weight_fn(vdx, vdy, vdz):
            # the surface's peel weight (an external sphere's about its
            # inward normal): 4 mu, or limb-darkened 2 (1.5 mu^2 + mu) (ref
            # emit_from_sphere_peeloff)
            mu_s = (new['snx'] * vdx + new['sny'] * vdy +
                    new['snz'] * vdz).clamp_min(0.0)
            w = torch.where(new['limb'], 2.0 * (1.5 * mu_s * mu_s + mu_s),
                            4.0 * mu_s)
            return torch.where(new['surf'], w, 1.0)
    no = torch.zeros_like(active)
    zero = torch.zeros_like(src)
    prov = Provenance(scattered=no, reprocessed=no, source_id=src,
                      dust_id=zero, n_scat=zero)
    _peel_batch(walk, rt, groups, accums, x, y, z, cell, active,
                rt.source_spec[src], prov, scale, weight_fn)
    return (in_batch & ~active).sum()


def dust_emission_spectra(rt, var_log, specific_energy, d_sel, cell):
    """(B, n_int) emissivity spectra of the emitting (dust, cell) lanes: the
    cell's state located on its dust's var grid (log10, ``var_log``
    (n_dust, n_var)) and the binned spectra interpolated in log10 between
    the two var rows around it (ref get_dust_emissivity,
    images_peeled.f90:454-500)."""
    n_var = var_log.shape[1]
    e = specific_energy[d_sel, cell]
    le = torch.log10(e.clamp_min(1e-300))
    # the count of var rows below le: searchsorted(side='left')
    j = torch.zeros_like(d_sel)
    for d in range(var_log.shape[0]):
        j = torch.where(d_sel == d, torch.searchsorted(var_log[d], le), j)
    j = j.clamp(1, n_var - 1)
    v0 = var_log[d_sel, j - 1]
    v1 = var_log[d_sel, j]
    frac = torch.where(v1 > v0, (le - v0) / (v1 - v0).clamp_min(1e-30),
                       0.0).clamp(0.0, 1.0)
    ls0 = torch.log10(rt.dust_spec[d_sel * n_var + j - 1].clamp_min(1e-300))
    ls1 = torch.log10(rt.dust_spec[d_sel * n_var + j].clamp_min(1e-300))
    spec = 10.0 ** (ls0 * (1.0 - frac[:, None]) + ls1 * frac[:, None])
    return torch.where(spec > 1e-290, spec, 0.0)


def raytrace_dust_batch(walk, geometry, rt, var_log, groups, accums,
                        specific_energy, u, n_active, scale):
    """One batch of the grid's thermal photons from the uniforms ``u``
    (1 + geometry.POSITION_ROWS, B): a (dust, cell) picked on the
    luminosity CDF, a position in the cell, the emissivity spectrum of its
    state, peeled into ``accums`` with the energy ``scale`` each. Returns the count (a device tensor) of the
    batch's photons placed outside their cell's bounds (beyond the
    geometry self-check's tolerance, ``in_cell_tol``), whose walks start
    from that cell all the same."""
    B = u.shape[1]
    n_cells = specific_energy.shape[1]
    flat = torch.searchsorted(rt.cell_cdf, u[U_CELL].contiguous()).clamp(
        0, rt.cell_lum.shape[0] - 1)
    d_sel = flat // n_cells
    cell = flat % n_cells
    x, y, z = (a.contiguous() for a in sample_position_in_cell(
        geometry, cell, position_uniforms(geometry, u[U_POS:U_POS + 3],
                                          u[U_POS + 3:])))
    active = torch.arange(B, device=x.device) < n_active
    spec = dust_emission_spectra(rt, var_log, specific_energy, d_sel, cell)
    no = torch.zeros_like(active)
    zero = torch.zeros_like(d_sel)
    prov = Provenance(scattered=no, reprocessed=~no, source_id=zero,
                      dust_id=d_sel, n_scat=zero)
    _peel_batch(walk, rt, groups, accums, x, y, z, cell, active, spec, prov,
                scale)
    return (active & ~geometry.in_cell_tol(cell, x, y, z)).sum()


def run_raytracing(walk, geometry, st, rt, var_grids, groups,
                   specific_energy, generator, n_ray_sources, n_ray_dust,
                   batch_size, group=None):
    """The raytracing pass for the peel ``groups``: batches of
    ``batch_size`` source photons (each the sources' luminosity over
    ``n_ray_sources``) and of thermal photons (each the grid's luminosity
    over ``n_ray_dust``), until the budgets are spent. ``walk`` is the
    grid's :class:`~.escape_tau.EscapeTau`, ``geometry`` the engine's
    tables, ``specific_energy`` (n_dust, n_cells) on the density's device.
    Returns (per group sed (n_view, n_ap, n_nu, n_orig), per group img
    (n_view, n_y, n_x, n_nu, n_orig), stats): float64 numpy, read once.
    ``stats``: the batches, and ``outside``, the photons that started
    outside the grid (source photons) or outside their cell (dust photons;
    see :func:`raytrace_dust_batch`), counted on the device and read with
    the cubes. With ``group`` (a launched :class:`..parallel.mesh.Group`)
    a trip is ``batch_size`` photons a rank, each rank tracing its share
    (JAX ``per_trip = batch x n_dev``), and the cubes and the count come
    back sum-reduced over the ranks after the last trip."""
    device, dtype = specific_energy.device, specific_energy.dtype
    accums = [RaytraceAccum(g, device) for g in groups]
    batches = 0
    outside = torch.zeros((), dtype=torch.int64, device=device)
    source_batch, dust_batch = raytrace_source_batch, raytrace_dust_batch
    per_trip = batch_size
    if group is not None:
        source_batch = partial(run_raytrace_source_sharded, group)
        dust_batch = partial(run_raytrace_dust_sharded, group)
        per_trip = batch_size * group.world
    # a source-less model (a placeholder source row) has no source pass
    if n_ray_sources > 0 and rt.source_spec.shape[0] > 0:
        if st.has_lte:
            # (the JAX package's raytracing has no LTE context either)
            raise ValueError("raytracing cannot emit from a source with an "
                             "LTE spectrum")
        scale = float(st.energy_total) / n_ray_sources
        sphere = st.has_sphere
        n_rows = U_EXTRA + emit_extra_rows(st, geometry)
        for start in range(0, n_ray_sources, per_trip):
            b = min(per_trip, n_ray_sources - start)
            u = torch.rand((n_rows, batch_size), generator=generator,
                           device=device, dtype=dtype)
            outside += source_batch(walk, geometry, st, rt, groups, accums,
                                    u, b, scale, sphere)
            batches += 1
    if n_ray_dust > 0 and rt.total_grid_luminosity > 0:
        scale = rt.total_grid_luminosity / n_ray_dust
        var_log = torch.log10(torch.as_tensor(np.array(var_grids),
                                              dtype=dtype, device=device))
        for start in range(0, n_ray_dust, per_trip):
            b = min(per_trip, n_ray_dust - start)
            u = torch.rand((U_POS + geometry.POSITION_ROWS, batch_size),
                           generator=generator, device=device, dtype=dtype)
            outside += dust_batch(walk, geometry, rt, var_log, groups,
                                  accums, specific_energy, u, b, scale)
            batches += 1
    if group is not None:
        outside = reduce_raytrace(group, accums, outside)
    return ([a.sed.cpu().numpy() for a in accums],
            [a.img.cpu().numpy() for a in accums],
            dict(batches=batches, outside=int(outside)))
