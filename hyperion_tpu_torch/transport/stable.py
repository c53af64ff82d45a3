"""Source tables and packet emission of the port (counterpart of
``hyperion_tpu/transport/stable.py``).

This slice emits from point sources, point-source collections and
spherical sources (with limb darkening and spots). A collection is
expanded into one emission row per point, which gives the same sampling
distribution as the reference's position PDF; a spotted sphere becomes one
whole-surface row plus one cap row per spot (ref spot_pdf,
source_type.f90:159-190). Every row carries its spectrum as a log2(nu)
quantile table, so drawing a frequency is one O(1) inversion. Spheres of
non-zero radius re-absorb photons that hit them (ref source_intersect);
the engine re-emits those from the same row."""

from dataclasses import dataclass

import numpy as np
import torch

from ..sources import PointSource, PointSourceCollection, SphericalSource
from ..util.functions import B_nu, planck_nu_range
from .dtable import _cdf_loglog
from .sampling import (isotropic_direction, quantile_grid, quantile_table,
                       rotate_direction, sample_quantile_rows)

# source type codes of the rows (the JAX package's, ref source%type)
POINT = 1
SPHERE = 2


@dataclass
class SourceTables:
    type_code: torch.Tensor      # (n_emit,) POINT or SPHERE
    position: torch.Tensor       # (n_emit, 3) engine units
    radius: torch.Tensor         # (n_emit,) engine units, 0 for points
    limb: torch.Tensor           # (n_emit,) bool: limb-darkened sphere
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

    @property
    def n_sources(self):
        return self.position.shape[0]

    @property
    def has_sphere(self):
        """Does any row emit from a sphere's surface? (reads the device)"""
        return bool((self.type_code == SPHERE).any())

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
        raise ValueError("LTE spectra are only supported for MapSource")
    cdf = _cdf_loglog(nu, fnu[None, :])[0]
    nu_new = 2.0 ** quantile_table(nu, cdf[None, :], n_grid, log2=True)[0]
    nu_new[0], nu_new[-1] = nu[0], nu[-1]
    return nu_new, quantile_grid(n_grid)


def _row(code, position, luminosity, nu, group, radius=0.0, limb=False,
         intersect=True, cap_dir=(0.0, 0.0, 1.0), cap_cos=-1.0):
    return dict(code=code, position=np.asarray(position, float),
                luminosity=float(luminosity), nu=nu, group=group,
                radius=float(radius), limb=bool(limb), intersect=intersect,
                cap_dir=cap_dir, cap_cos=cap_cos)


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


def build_source_tables(sources, device, dtype, n_spec=1024,
                        length_scale=1.0, sample_evenly=False):
    """Build SourceTables from a list of PointSource, PointSourceCollection
    and SphericalSource objects; other source types raise. A source-less
    model (monochromatic dust emission alone; the reference's source loop
    idles, iter_final_mono.f90) gets one zero-luminosity point row at the
    origin, as in the JAX package, so that the tables keep their shapes;
    its ``energy_total`` is 0."""
    rows = []
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
            raise NotImplementedError(
                "%s is not in the port yet (point and spherical sources "
                "only): ROADMAP.md queue 1 item 4" % type(s).__name__)

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
    codes = np.array([r['code'] for r in rows])
    radii = np.array([r['radius'] for r in rows]) / float(length_scale)
    spec_nu = np.asarray([r['nu'] for r in rows], float)

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return SourceTables(
        type_code=torch.as_tensor(codes, dtype=torch.int64, device=device),
        position=f([r['position'] / float(length_scale) for r in rows]),
        radius=f(radii),
        limb=b([r['limb'] for r in rows]),
        lum_cdf=f(lum_cdf),
        energy_weight=f(energy_weight),
        spec_nu=f(spec_nu),
        spec_logq=f(np.log2(np.maximum(spec_nu, 1e-300))),
        energy_total=float(lum.sum()),
        intersect=b((codes == SPHERE) & (radii > 0.0) &
                    np.array([r['intersect'] for r in rows])),
        cap_dir=f([r['cap_dir'] for r in rows]),
        cap_cos=f([r['cap_cos'] for r in rows]))


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


def emit_packets(st, u_src, u_nu, u_mu, u_phi, u_sphere=None, src=None):
    """Fresh packets from uniforms: a source row picked on the luminosity
    CDF (or the rows ``src``, the re-emission of re-absorbed photons, ref
    emit(reemit=...), source.f90:134-141), a frequency from its spectrum,
    and for point rows the row's position and an isotropic direction.

    Sphere rows take ``u_sphere`` = (u_cap, u_cap_phi, u_out, u_out_phi):
    a point on the sphere (on the spot's cap for a spot row) and a
    direction about its outward normal, cosine-law or limb-darkened
    (ref emit_from_sphere, source_type.f90:630-639). Returns a dict of (n,)
    tensors x, y, z, kx, ky, kz, nu, energy and the emitting rows,
    ``source``; with ``u_sphere`` also the surface context of the peel's
    cosine law (ref emit_from_sphere_peeloff): ``surf`` (emitted from a
    sphere), the outward normal ``snx``, ``sny``, ``snz`` and ``limb``."""
    if src is None:
        src = pick_sources(st, u_src)
    nu = sample_quantile_rows(st.spec_logq, src, u_nu, exp2=True)
    pos = st.position[src]
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    kx, ky, kz = isotropic_direction(u_mu, u_phi)
    if u_sphere is not None:
        u_cap, u_cap_phi, u_out, u_out_phi = u_sphere
        # the surface point: a cap around cap_dir (the whole sphere for
        # cap_cos = -1)
        cosc = 1.0 - u_cap * (1.0 - st.cap_cos[src])
        cd = st.cap_dir[src]
        sx, sy, sz = rotate_direction(cd[:, 0], cd[:, 1], cd[:, 2], cosc,
                                      u_cap_phi * (2.0 * torch.pi))
        sphere = st.type_code[src] == SPHERE
        r = st.radius[src]
        x = torch.where(sphere, x + r * sx, x)
        y = torch.where(sphere, y + r * sy, y)
        z = torch.where(sphere, z + r * sz, z)
        # outward: P(mu) ∝ mu (cosine law), or limb-darkened
        mu_s = torch.where(st.limb[src], _sample_limb_mu(u_out),
                           torch.sqrt(u_out))
        ox, oy, oz = rotate_direction(sx, sy, sz, mu_s,
                                      u_out_phi * (2.0 * torch.pi))
        kx = torch.where(sphere, ox, kx)
        ky = torch.where(sphere, oy, ky)
        kz = torch.where(sphere, oz, kz)
        surface = dict(surf=sphere, snx=sx, sny=sy, snz=sz,
                       limb=st.limb[src])
    else:
        surface = {}
    return dict(x=x, y=y, z=z, kx=kx, ky=ky, kz=kz, nu=nu,
                energy=st.energy_weight[src], source=src, **surface)


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
