"""Source tables and packet emission of the port (counterpart of
``hyperion_tpu/transport/stable.py``).

Every source type of the reference emits: point sources, point-source
collections, spherical sources (with limb darkening and spots), luminosity
maps, external spheres and boxes, and plane-parallel beams. A collection is
expanded into one emission row per point, which gives the same sampling
distribution as the reference's position PDF; a spotted sphere becomes one
whole-surface row plus one cap row per spot (ref spot_pdf,
source_type.f90:159-190). Every row carries its spectrum as a log2(nu)
quantile table, so drawing a frequency is one O(1) inversion, except a map
with an LTE spectrum, whose frequency comes from the dust emissivity of
its emission cell. Spheres of non-zero radius re-absorb photons that hit
them (ref source_intersect); the engine re-emits those from the same
row."""

from dataclasses import dataclass

import numpy as np
import torch

from ..sources import (ExternalBoxSource, ExternalSphericalSource, MapSource,
                       PlaneParallelSource, PointSource, PointSourceCollection,
                       SphericalSource)
from ..util.functions import B_nu, planck_nu_range
from .dtable import _cdf_loglog
from .sampling import (isotropic_direction, quantile_grid, quantile_table,
                       rotate_direction, sample_quantile_rows)

# source type codes of the rows (the JAX package's, ref source%type)
POINT = 1
SPHERE = 2
MAP = 4
EXTERN_SPH = 5
EXTERN_BOX = 6
PLANE_PARALLEL = 7

# rows of the (N_EMIT_EXTRA, B) block of uniforms that map, box,
# plane-parallel and LTE rows draw from (:func:`emit_packets`' ``u_extra``):
# the map's cell and the position in it, the position in the box, the
# beam's disk (radius, azimuth), the LTE spectrum's dust, var bin and
# quantile
(E_MAP, E_MAP_X, E_MAP_Y, E_MAP_Z, E_BOX_X, E_BOX_Y, E_BOX_Z, E_PP_R,
 E_PP_PHI, E_LTE_DUST, E_LTE_BIN, E_LTE_XI) = range(12)
N_EMIT_EXTRA = 12


@dataclass
class SourceTables:
    type_code: torch.Tensor      # (n_emit,) a type code above
    position: torch.Tensor       # (n_emit, 3) engine units
    radius: torch.Tensor         # (n_emit,) engine units, 0 for points
    limb: torch.Tensor           # (n_emit,) bool: limb-darkened sphere
    direction: torch.Tensor      # (n_emit, 3) a plane-parallel beam's
    bounds: torch.Tensor         # (n_emit, 3, 2) an external box's
    lum_cdf: torch.Tensor        # (n_emit,) cumulative, last == 1
    # per-row packet energy: 1 for luminosity-proportional sampling,
    # L_group * n_groups / L_tot when sampling sources evenly
    # (ref source.f90:162)
    energy_weight: torch.Tensor  # (n_emit,)
    spec_nu: torch.Tensor        # (n_emit, n_snu) nu at the quantile knots
    spec_logq: torch.Tensor      # (n_emit, n_snu) log2(spec_nu)
    energy_total: float          # sum of luminosities (host float64)
    # rows that re-absorb photons: spheres of non-zero radius, not spots
    intersect: torch.Tensor      # (n_emit,) bool
    # spot rows emit from the cap around cap_dir with cos(angular radius)
    # cap_cos; whole spheres have cap_cos = -1
    cap_dir: torch.Tensor        # (n_emit, 3)
    cap_cos: torch.Tensor        # (n_emit,)
    # luminosity maps (ref emit_from_map): map_row points into map_cdf, the
    # per-cell cumulative luminosity of each map, -1 for other rows;
    # map_cdf is (0, 1) without maps
    map_row: torch.Tensor        # (n_emit,) int64
    map_cdf: torch.Tensor        # (n_map, n_cells)
    # LTE spectra (ref freq_type 3): (n_emit,) bool where any row has one,
    # (0,) otherwise, as in the JAX package
    lte: torch.Tensor

    @property
    def n_sources(self):
        return self.position.shape[0]

    @property
    def has_sphere(self):
        """Does any row emit from a sphere's surface, outward (a star) or
        inward (an external sphere)? (reads the device)"""
        return bool(((self.type_code == SPHERE) |
                     (self.type_code == EXTERN_SPH)).any())

    @property
    def has_map(self):
        return self.map_cdf.shape[0] > 0

    @property
    def has_lte(self):
        return self.lte.shape[0] > 0

    @property
    def has_extra(self):
        """Does any row draw from ``u_extra`` (:func:`emit_packets`)?
        (reads the device)"""
        return self.has_map or bool(
            ((self.type_code == EXTERN_BOX) |
             (self.type_code == PLANE_PARALLEL)).any())

    @property
    def any_intersect(self):
        """Can any row re-absorb a photon? (reads the device)"""
        return bool(self.intersect.any())


def _spectrum_cdf(source, n_grid):
    """Host-side (nu, cdf) of one source's emission spectrum, resampled onto
    the cosine-warped quantile grid (photon frequencies are drawn in
    proportion to fnu, as the reference's spectrum PDF does)."""
    if getattr(source, 'spectrum', None) is not None:
        nu = np.asarray(source.spectrum['nu'], float)
        fnu = np.asarray(source.spectrum['fnu'], float)
    elif getattr(source, 'temperature', None) is not None:
        nu = planck_nu_range(source.temperature)
        fnu = B_nu(nu, source.temperature)
    else:
        # an LTE spectrum, drawn at emission from the dust (a placeholder
        # table, flagged by the lte column)
        return np.geomspace(1e8, 1e17, n_grid), quantile_grid(n_grid)
    cdf = _cdf_loglog(nu, fnu[None, :])[0]
    nu_new = 2.0 ** quantile_table(nu, cdf[None, :], n_grid, log2=True)[0]
    nu_new[0], nu_new[-1] = nu[0], nu[-1]
    return nu_new, quantile_grid(n_grid)


def _row(code, position, luminosity, nu, group, radius=0.0, limb=False,
         intersect=True, cap_dir=(0.0, 0.0, 1.0), cap_cos=-1.0,
         direction=(0.0, 0.0, 1.0), bounds=np.zeros((3, 2)), map_row=-1,
         lte=False):
    return dict(code=code, position=np.asarray(position, float),
                luminosity=float(luminosity), nu=nu, group=group,
                radius=float(radius), limb=bool(limb), intersect=intersect,
                cap_dir=cap_dir, cap_cos=cap_cos, direction=direction,
                bounds=np.asarray(bounds, float), map_row=map_row, lte=lte)


def _flatten_map(grid, arr):
    """A grid-shaped luminosity map as (n_cells,) in the engine's cell order
    (AMR: the fabs level-major, as run._flatten_quantity); a copy of the
    JAX package's."""
    from ..grid import AMRGrid
    if isinstance(grid, AMRGrid) and isinstance(arr, list):
        return np.concatenate([np.asarray(a, float).reshape(-1)
                               for a in arr])
    return np.asarray(arr, float).reshape(-1)


def _sphere_rows(s, n_spec, group):
    """A spherical source's whole-surface row and one cap row per spot
    (ref source_type.f90:150-190)."""
    nu, _ = _spectrum_cdf(s, n_spec)
    rows = [_row(SPHERE, s.position, s.luminosity, nu, group,
                 radius=s.radius, limb=s.limb)]
    for spot in s.spots:
        spot._check_all_set()
        lon = np.radians(float(spot.longitude))
        lat = np.radians(float(spot.latitude))
        rows.append(_row(
            SPHERE, s.position, spot.luminosity,
            _spectrum_cdf(spot, n_spec)[0], group, radius=s.radius,
            limb=s.limb, intersect=False,
            cap_dir=(np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)),
            cap_cos=float(np.cos(np.radians(float(spot.radius))))))
    return rows


def _diffuse_row(s, n_spec, group, grid, maps):
    """The row of a map, external sphere, external box or plane-parallel
    beam (JAX ``build_source_tables``, stable.py:176-241); a map's CDF is
    appended to ``maps``."""
    # (only a MapSource may have one: Source._check_all_set)
    lte = bool(s.has_lte_spectrum())
    nu, _ = _spectrum_cdf(s, n_spec)
    if isinstance(s, ExternalSphericalSource):
        return _row(EXTERN_SPH, s.position, s.luminosity, nu, group,
                    radius=s.radius, lte=lte)
    if isinstance(s, ExternalBoxSource):
        return _row(EXTERN_BOX, (0.0, 0.0, 0.0), s.luminosity, nu, group,
                    bounds=s.bounds, lte=lte)
    if isinstance(s, PlaneParallelSource):
        theta, phi = np.radians(s.direction[0]), np.radians(s.direction[1])
        return _row(PLANE_PARALLEL, s.position, s.luminosity, nu, group,
                    radius=s.radius, lte=lte,
                    direction=(np.sin(theta) * np.cos(phi),
                               np.sin(theta) * np.sin(phi), np.cos(theta)))
    if isinstance(s, MapSource):
        if grid is None:
            raise ValueError("build_source_tables needs the model grid "
                             "to flatten a MapSource luminosity map")
        flat = np.maximum(_flatten_map(grid, s.map), 0.0)
        if flat.sum() <= 0:
            raise ValueError("MapSource map has no positive values")
        cdf = np.cumsum(flat) / flat.sum()
        cdf[-1] = 1.0
        maps.append(cdf)
        return _row(MAP, (0.0, 0.0, 0.0), s.luminosity, nu, group,
                    map_row=len(maps) - 1, lte=lte)
    raise NotImplementedError("Unsupported source type: %s" % type(s))


def build_source_tables(sources, device, dtype, n_spec=1024,
                        length_scale=1.0, sample_evenly=False, grid=None):
    """Build SourceTables from a list of the front end's sources (``grid``,
    the model's grid, flattens a MapSource's luminosity map). A
    source-less model (monochromatic dust emission alone; the reference's
    source loop idles, iter_final_mono.f90) gets one zero-luminosity point
    row at the origin, as in the JAX package, so that the tables keep
    their shapes; its ``energy_total`` is 0."""
    rows = []
    maps = []
    for i_top, s in enumerate(sources):
        s._check_all_set()
        if isinstance(s, PointSourceCollection):
            nu, _ = _spectrum_cdf(s, n_spec)
            rows += [_row(POINT, s.position[i], s.luminosity[i], nu, i_top)
                     for i in range(s.position.shape[0])]
        elif isinstance(s, PointSource):
            rows.append(_row(POINT, s.position, s.luminosity,
                             _spectrum_cdf(s, n_spec)[0], i_top))
        elif isinstance(s, SphericalSource):
            rows += _sphere_rows(s, n_spec, i_top)
        else:
            rows.append(_diffuse_row(s, n_spec, i_top, grid, maps))

    if not rows:
        rows = [_row(POINT, (0.0, 0.0, 0.0), 0.0, np.array([1e10, 1e15]), 0,
                     intersect=False)]
    lum = np.array([r['luminosity'] for r in rows])
    groups = np.array([r['group'] for r in rows], dtype=int)
    n_groups = len(sources)
    if sample_evenly and n_groups > 1:
        # equal pick probability per top-level source, luminosity-split
        # within a collection; packets carry a compensating energy weight
        l_group = np.array([lum[groups == g].sum() for g in range(n_groups)])
        lum_cdf = np.cumsum(lum / l_group[groups] / n_groups)
        energy_weight = l_group[groups] * n_groups / lum.sum()
    else:
        lum_cdf = np.cumsum(lum) / max(lum.sum(), 1e-300)
        energy_weight = np.ones(len(rows))
    lum_cdf[-1] = 1.0
    L = float(length_scale)
    codes = np.array([r['code'] for r in rows])
    radii = np.array([r['radius'] for r in rows]) / L
    spec_nu = np.asarray([r['nu'] for r in rows], float)
    lte = np.array([r['lte'] for r in rows], bool)

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return SourceTables(
        type_code=torch.as_tensor(codes, dtype=torch.int64, device=device),
        position=f([r['position'] / L for r in rows]),
        radius=f(radii),
        limb=b([r['limb'] for r in rows]),
        direction=f([r['direction'] for r in rows]),
        bounds=f([r['bounds'] / L for r in rows]),
        lum_cdf=f(lum_cdf),
        energy_weight=f(energy_weight),
        spec_nu=f(spec_nu),
        spec_logq=f(np.log2(np.maximum(spec_nu, 1e-300))),
        energy_total=float(lum.sum()),
        intersect=b((codes == SPHERE) & (radii > 0.0) &
                    np.array([r['intersect'] for r in rows])),
        cap_dir=f([r['cap_dir'] for r in rows]),
        cap_cos=f([r['cap_cos'] for r in rows]),
        map_row=torch.as_tensor([r['map_row'] for r in rows],
                                dtype=torch.int64, device=device),
        map_cdf=f(np.stack(maps) if maps else np.zeros((0, 1))),
        lte=b(lte if lte.any() else np.zeros((0,), bool)))


def per_row(sources, one):
    """``[one(s) ...]`` for each emission row of :func:`build_source_tables`
    in its order: a collection's points share their ``one``, a spotted
    sphere's row is followed by one row per spot (``one(spot)``)."""
    rows = []
    for s in sources:
        if isinstance(s, PointSourceCollection):
            rows += [one(s)] * s.position.shape[0]
        elif isinstance(s, SphericalSource):
            rows += [one(s)] + [one(spot) for spot in s.spots]
        else:
            rows.append(one(s))
    return rows


def pick_sources(st, u):
    """Source rows picked on the luminosity CDF from uniforms ``u``."""
    return torch.searchsorted(st.lum_cdf, u.contiguous()).clamp(
        0, st.n_sources - 1)


def emit_packets(st, u_src, u_nu, u_mu, u_phi, u_sphere=None, src=None,
                 u_extra=None, geometry=None, lte_ctx=None):
    """Fresh packets from uniforms: a source row picked on the luminosity
    CDF (or the rows ``src``, the re-emission of re-absorbed photons, ref
    emit(reemit=...), source.f90:134-141), a frequency from its spectrum,
    and for point rows the row's position and an isotropic direction (JAX
    ``emit_packets``, stable.py:311-461, with the uniforms as arguments).

    Sphere rows, stars and external spheres, take ``u_sphere`` = (u_cap,
    u_cap_phi, u_out, u_out_phi): a point on the sphere (on the spot's cap
    for a spot row) and a direction about its normal, outward for a star
    (cosine-law or limb-darkened, ref emit_from_sphere,
    source_type.f90:630-639) and inward, cosine-law, for an external
    sphere. Map, box and plane-parallel rows take ``u_extra``, the
    (N_EMIT_EXTRA, B) block of the E_* rows: a map's cell from its CDF and
    a uniform position in it (``geometry``, ref emit_from_map), a uniform
    position in the box, or a point of the beam's disk and its fixed
    direction. A map with an LTE spectrum takes its frequency from the dust
    emissivity of its cell, the dust picked ∝ specific energy × density
    there (uniformly where that is 0): ``lte_ctx`` = (dust tables,
    jnu_var_id, jnu_var_frac, se_rho), each (n_dust, n_cells).

    Returns a dict of (n,) tensors x, y, z, kx, ky, kz, nu, energy and the
    emitting rows, ``source``; with ``u_sphere`` also the surface context
    of the peel's cosine law (ref emit_from_sphere_peeloff): ``surf``
    (emitted from a sphere), the normal ``snx``, ``sny``, ``snz`` (flipped
    inward for an external sphere) and ``limb``."""
    if src is None:
        src = pick_sources(st, u_src)
    code = st.type_code[src]
    nu = sample_quantile_rows(st.spec_logq, src, u_nu, exp2=True)
    pos = st.position[src]
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    kx, ky, kz = isotropic_direction(u_mu, u_phi)
    surface = {}
    if u_sphere is not None:
        u_cap, u_cap_phi, u_out, u_out_phi = u_sphere
        # the surface point: a cap around cap_dir (the whole sphere for
        # cap_cos = -1)
        cosc = 1.0 - u_cap * (1.0 - st.cap_cos[src])
        cd = st.cap_dir[src]
        sx, sy, sz = rotate_direction(cd[:, 0], cd[:, 1], cd[:, 2], cosc,
                                      u_cap_phi * (2.0 * torch.pi))
        inward = code == EXTERN_SPH
        sphere = (code == SPHERE) | inward
        r = st.radius[src]
        x = torch.where(sphere, x + r * sx, x)
        y = torch.where(sphere, y + r * sy, y)
        z = torch.where(sphere, z + r * sz, z)
        # P(mu) ∝ mu (cosine law) about the normal, outward or inward, or
        # limb-darkened (stars only)
        mu_s = torch.where(st.limb[src], _sample_limb_mu(u_out),
                           torch.sqrt(u_out))
        nx = torch.where(inward, -sx, sx)
        ny = torch.where(inward, -sy, sy)
        nz = torch.where(inward, -sz, sz)
        ox, oy, oz = rotate_direction(nx, ny, nz, mu_s,
                                      u_out_phi * (2.0 * torch.pi))
        kx = torch.where(sphere, ox, kx)
        ky = torch.where(sphere, oy, ky)
        kz = torch.where(sphere, oz, kz)
        surface = dict(surf=sphere, snx=nx, sny=ny, snz=nz,
                       limb=st.limb[src])
    if u_extra is not None:
        e = u_extra
        if st.has_map:
            # the map's cell on its CDF, a uniform position in it
            from .raytrace import sample_position_in_cell
            n_cells = st.map_cdf.shape[1]
            mrow = st.map_row[src]
            u_map = e[E_MAP].contiguous()
            map_cell = torch.zeros_like(src)
            for i in range(st.map_cdf.shape[0]):
                map_cell = torch.where(mrow == i, torch.searchsorted(
                    st.map_cdf[i], u_map), map_cell)
            map_cell = map_cell.clamp(0, n_cells - 1)
            mx, my, mz = sample_position_in_cell(geometry, map_cell,
                                                 e[E_MAP_X:E_MAP_Z + 1])
            in_map = code == MAP
            x = torch.where(in_map, mx, x)
            y = torch.where(in_map, my, y)
            z = torch.where(in_map, mz, z)
            if st.has_lte:
                nu = torch.where(st.lte[src], _lte_nu(lte_ctx, map_cell, e),
                                 nu)
        # uniform in the box
        bd = st.bounds[src]
        box = code == EXTERN_BOX
        x = torch.where(box, bd[:, 0, 0] + e[E_BOX_X] *
                        (bd[:, 0, 1] - bd[:, 0, 0]), x)
        y = torch.where(box, bd[:, 1, 0] + e[E_BOX_Y] *
                        (bd[:, 1, 1] - bd[:, 1, 0]), y)
        z = torch.where(box, bd[:, 2, 0] + e[E_BOX_Z] *
                        (bd[:, 2, 1] - bd[:, 2, 0]), z)
        # a plane-parallel beam: a uniform point of the disk about its
        # centre perpendicular to its direction, which it keeps
        d = st.direction[src]
        pp = code == PLANE_PARALLEL
        rr = st.radius[src] * torch.sqrt(e[E_PP_R])
        ax, ay, az = rotate_direction(d[:, 0], d[:, 1], d[:, 2],
                                      torch.zeros_like(rr),
                                      e[E_PP_PHI] * (2.0 * torch.pi))
        x = torch.where(pp, pos[:, 0] + rr * ax, x)
        y = torch.where(pp, pos[:, 1] + rr * ay, y)
        z = torch.where(pp, pos[:, 2] + rr * az, z)
        kx = torch.where(pp, d[:, 0], kx)
        ky = torch.where(pp, d[:, 1], ky)
        kz = torch.where(pp, d[:, 2], kz)
    return dict(x=x, y=y, z=z, kx=kx, ky=ky, kz=kz, nu=nu,
                energy=st.energy_weight[src], source=src, **surface)


def _lte_nu(lte_ctx, cell, e):
    """The LTE frequency at the emission cells (ref
    select_dust_specific_energy_rho + dust_sample_j_nu,
    source_type.f90:468-471, grid_physics_3d.f90:101-109)."""
    from .engine import sample_emission_nu
    if lte_ctx is None:
        raise ValueError("emit_packets needs lte_ctx for LTE rows")
    dt, jnu_var_id, jnu_var_frac, se_rho = lte_ctx
    w = se_rho[:, cell].T
    # a uniform dust pick where the specific energy is all zero (the first
    # iteration)
    w = torch.where(w.sum(dim=-1, keepdim=True) > 0.0, w,
                    torch.ones_like(w))
    csum = torch.cumsum(w, dim=-1)
    target = e[E_LTE_DUST] * csum[:, -1]
    d_sel = (csum < target[:, None]).sum(dim=-1).clamp(0, w.shape[-1] - 1)
    return sample_emission_nu(dt, d_sel, jnu_var_id[d_sel, cell],
                              jnu_var_frac[d_sel, cell], e[E_LTE_BIN],
                              e[E_LTE_XI])


def nearest_source_intersection(st, x, y, z, kx, ky, kz):
    """Distance along each ray to the nearest re-absorbing source's surface
    (ref find_nearest_source + source_intersect, source.f90:206-227,
    source_type.f90:359-396). Returns (t, source row); t = finfo.max / 8
    where no such source lies ahead."""
    big = torch.finfo(x.dtype).max / 8
    rx = x[:, None] - st.position[None, :, 0]
    ry = y[:, None] - st.position[None, :, 1]
    rz = z[:, None] - st.position[None, :, 2]
    b = rx * kx[:, None] + ry * ky[:, None] + rz * kz[:, None]
    disc = b * b - (rx * rx + ry * ry + rz * rz - st.radius[None, :] ** 2)
    sq = torch.sqrt(disc.clamp_min(0.0))
    t1 = -b - sq
    t2 = -b + sq
    # an exclusion zone of 1e-3 radius: a photon (re-)emitted on the
    # surface sits within float32 rounding of it and must not re-hit it
    eps = 1e-3 * st.radius[None, :]
    t = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, big))
    t = torch.where((disc > 0.0) & st.intersect[None, :], t, big)
    t_min, row = t.min(dim=-1)
    return t_min, row


def _sample_limb_mu(u):
    """mu with limb darkening, P(mu) ∝ mu + 1.5 mu^2 on [0, 1]: the cubic
    CDF mu^2/2 + mu^3/2 = u solved by 4 Newton steps from sqrt(u)."""
    mu = torch.sqrt(u)
    for _ in range(4):
        f = 0.5 * mu ** 2 + 0.5 * mu ** 3 - u
        fp = mu + 1.5 * mu ** 2
        mu = (mu - f / fp.clamp_min(1e-6)).clamp(0.0, 1.0)
    return mu
