"""Source tables and packet emission of the port (counterpart of
``hyperion_tpu/transport/stable.py``).

This slice emits from point sources and point-source collections; a
collection is expanded into one emission row per point, which gives the
same sampling distribution as the reference's position PDF. Every row
carries its spectrum as a log2(nu) quantile table, so drawing a frequency
is one O(1) inversion."""

from dataclasses import dataclass

import numpy as np
import torch

from ..sources import PointSource, PointSourceCollection
from ..util.functions import B_nu, planck_nu_range
from .dtable import _cdf_loglog
from .sampling import (isotropic_direction, quantile_grid, quantile_table,
                       sample_quantile_rows)


@dataclass
class SourceTables:
    position: torch.Tensor       # (n_emit, 3) engine units
    lum_cdf: torch.Tensor        # (n_emit,) cumulative, last == 1
    # per-row packet energy: 1 for luminosity-proportional sampling,
    # L_group * n_groups / L_tot when sampling sources evenly
    # (ref source.f90:162)
    energy_weight: torch.Tensor  # (n_emit,)
    spec_nu: torch.Tensor        # (n_emit, n_snu) nu at the quantile knots
    spec_logq: torch.Tensor      # (n_emit, n_snu) log2(spec_nu)
    energy_total: float          # sum of luminosities (host float64)

    @property
    def n_sources(self):
        return self.position.shape[0]


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


def build_source_tables(sources, device, dtype, n_spec=1024,
                        length_scale=1.0, sample_evenly=False):
    """Build SourceTables from a list of PointSource and
    PointSourceCollection objects; other source types raise."""
    if not sources:
        raise NotImplementedError(
            "source-less models (monochromatic dust emission) are not in "
            "the port yet: ROADMAP.md queue 1 item 10")
    rows = []
    for i_top, s in enumerate(sources):
        s._check_all_set()
        if isinstance(s, PointSourceCollection):
            nu, _ = _spectrum_cdf(s, n_spec)
            for i in range(s.position.shape[0]):
                rows.append(dict(position=s.position[i],
                                 luminosity=float(s.luminosity[i]),
                                 nu=nu, group=i_top))
        elif isinstance(s, PointSource):
            nu, _ = _spectrum_cdf(s, n_spec)
            rows.append(dict(position=s.position,
                             luminosity=float(s.luminosity), nu=nu,
                             group=i_top))
        else:
            raise NotImplementedError(
                "%s is not in the port yet (point sources only): "
                "ROADMAP.md queue 1 item 4" % type(s).__name__)

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
    spec_nu = np.asarray([r['nu'] for r in rows], float)

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    return SourceTables(
        position=f([np.asarray(r['position'], float) / float(length_scale)
                    for r in rows]),
        lum_cdf=f(lum_cdf),
        energy_weight=f(energy_weight),
        spec_nu=f(spec_nu),
        spec_logq=f(np.log2(np.maximum(spec_nu, 1e-300))),
        energy_total=float(lum.sum()))


def emit_packets(st, u_src, u_nu, u_mu, u_phi):
    """Fresh packets from uniforms: a source row picked on the luminosity
    CDF, a frequency from its spectrum, an isotropic direction. Returns a
    dict of (n,) tensors x, y, z, kx, ky, kz, nu, energy."""
    src = torch.searchsorted(st.lum_cdf, u_src.contiguous()).clamp(
        0, st.n_sources - 1)
    nu = sample_quantile_rows(st.spec_logq, src, u_nu, exp2=True)
    pos = st.position[src]
    kx, ky, kz = isotropic_direction(u_mu, u_phi)
    return dict(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2], kx=kx, ky=ky, kz=kz,
                nu=nu, energy=st.energy_weight[src])
