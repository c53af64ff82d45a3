"""The imaging (final) iteration of the port: peeled and binned SEDs and
images (counterpart of ``hyperion_tpu/transport/imaging.py``; ref
iter_final.f90:60-275, images_peeled.f90:95-270, image_type.f90:408-530).

The batch advances in lockstep as in the Lucy step, with no energy
deposits. At every emission, MRW jump and interaction each view of each
peeled group takes the event's peel weight (isotropic, the stellar
surface's cosine law, or the scattering matrix toward the observer, with
the Stokes vector when a group asks for it), attenuates it by the optical
depth to the grid's edge along the line of sight (one ``escape_tau`` call
per event for all the views, a hand-written kernel on the card) and adds
it into the (view, aperture or pixel, frequency, origin, Stokes) cubes
with one ``index_add_`` per cube. Photons that leave the grid are binned
by their exit direction into the binned group. With forced first
interaction the escape optical depth along the emission ray, walked in
the emission peel's call, reweights the packet (WR99 or Baes16).

One ``(n_rows, B)`` block of uniforms per step, and no host read inside
a step: as in the Lucy step (``engine.py``), the budget and the alive,
waiting and working-step counts live on the device, the refill runs
under a device gate (a quarter of the lanes dead, or none alive, while
budget remains; or a re-absorbed photon waiting: ``engine.run_if``, in a
CUDA graph a conditional node skipped where the gate is false, eagerly
masked by it), and every lane field is written into the carry's own
tensors. On a CUDA device the iteration runs as replays of one CUDA graph
of ``engine.GRAPH_STEPS`` steps, the host reading the counters once a
replay; on the CPU one step at a time. No event is gated on an
``any()``, since the walk returns at once for lanes that are not active.
An external sphere's emission peels with its inward normal's cosine law,
as a star's with its outward one. The monochromatic iteration
(``mono.py``) peels through :func:`peel_and_bin` too."""

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from .engine import (_select_col, drive_graph, drive_steps, emit_options,
                     imaging_step_counts, own_carry, put, put_where,
                     run_refill,
                     sample_emission_nu, select_dust,
                     update_optical_constants)
from .escape_tau import EscapeTau
from .ffi import sample_first_interaction
from .gtable import ESCAPED
from .mrw import prepare_mrw_tables
from .sampling import isotropic_direction, random_exp
from .stable import emit_packets, nearest_source_intersection, pick_sources
from .stokes import (eval_phase_peel, peel_scatter_stokes, phase_rows,
                     sample_scatter_stokes)

ORIG_SOURCE_EMIT = 0
ORIG_DUST_EMIT = 1
ORIG_SOURCE_SCAT = 2
ORIG_DUST_SCAT = 3

# rows of the per-step uniform draw: the refill's (with the forced first
# interaction's), the step's, then the sphere emission's and the MRW
# move's, then for map, box and beam sources the rows of stable.E_* from
# U_EM_EXTRA (stable.emit_extra_rows); a step draws only the rows its model
# uses
(U_SRC, U_EM_NU, U_EM_MU, U_EM_PHI, U_EM_TAU, U_FFI,
 U_DUST, U_COIN, U_BIN, U_XI, U_DIR_MU, U_DIR_PHI, U_MU, U_PHI, U_TAU,
 U_EM_CAP, U_EM_CAP_PHI, U_EM_OUT, U_EM_OUT_PHI,
 U_MRW_JUMP_MU, U_MRW_JUMP_PHI, U_MRW_DIR_MU, U_MRW_DIR_PHI,
 U_MRW_DUST, U_MRW_BIN, U_MRW_XI) = range(26)
N_UNIFORMS = 26
U_EM_EXTRA = N_UNIFORMS


@dataclass
class PeelGroup:
    """One peeled (or binned) group. The frames and limits are host values
    (float64 numpy and floats); only the filter tables live on the device.
    Binned groups have n_view = n_theta * n_phi and unused frames."""
    view_dir: np.ndarray       # (n_view, 3) travel direction to the observer
    east: np.ndarray           # (n_view, 3) image +x axis
    north: np.ndarray          # (n_view, 3) image +y axis
    origin: np.ndarray         # (3,) peeloff origin, or the inside observer
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    log10_nu_min: float
    log10_nu_max: float
    log10_ap_min: float
    log10_ap_max: float
    n_view: int
    n_x: int
    n_y: int
    n_nu: int
    n_ap: int
    n_orig: int
    compute_image: bool
    compute_sed: bool
    uncertainties: bool
    track_origin: str
    n_stokes: int = 1
    # monochromatic groups: the frequency bins are the indices iwav_min ..
    # iwav_min + n_nu - 1 of the model's exact frequencies (ref
    # image_type.f90's monochromatic binning)
    monochromatic: bool = False
    iwav_min: int = 0
    # inside observer (ref images_peeled.f90:176-213): per-photon peel
    # directions toward ``origin``, (longitude, latitude) sky maps in
    # degrees and a 1/(4 pi d^2) dilution
    inside: bool = False
    ignore_optical_depth: bool = False
    # each of the n_nu channels is one filter, its response resampled onto
    # one uniform log10(nu) grid (ref image_type.f90:467-470)
    use_filters: bool = False
    track_n_scat: int = 0
    n_sources: int = 1
    n_dust: int = 1
    d_min: Optional[float] = None
    d_max: Optional[float] = None
    filter_lognu: Optional[torch.Tensor] = None   # (n_samp,)
    filter_tn: Optional[torch.Tensor] = None      # (n_nu, n_samp)
    inv_area: Optional[float] = None              # 1/L^2, inside observers
    # the (n_view, B) direction lanes of the outside views, made once per
    # batch
    _lanes: dict = field(default_factory=dict, repr=False, compare=False)

    def view_block(self, like):
        """(vdx, vdy, vdz) of every view, each a contiguous (n_view, B)
        tensor like ``like`` (B,), made at the first call for a batch and
        kept; row ``iv`` is view ``iv``."""
        key = (like.shape[0], like.device, like.dtype)
        block = self._lanes.get(key)
        if block is None:
            block = tuple(
                torch.as_tensor(self.view_dir[:, c], dtype=like.dtype,
                                device=like.device)[:, None]
                .expand(self.n_view, like.shape[0]).contiguous()
                for c in range(3))
            self._lanes[key] = block
        return block


def _viewing_frames(angles):
    """(theta, phi) degrees -> (view, east, north) unit vectors; for inside
    observers the rows of the sky rotation [r_hat; phi_hat; -theta_hat]."""
    theta = np.radians([a[0] for a in angles])
    phi = np.radians([a[1] for a in angles])
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    view = np.stack([st * cp, st * sp, ct], axis=1)
    east = np.stack([-sp, cp, np.zeros_like(sp)], axis=1)
    north = np.stack([-ct * cp, -ct * sp, st], axis=1)
    return view, east, north


def _n_orig(track, track_n_scat, n_sources, n_dust):
    """Origin slices per track mode (ref image_type.f90:228-241)."""
    if track == 'no':
        return 1
    if track == 'basic':
        return 4
    if track == 'detailed':
        return 2 * (n_sources + n_dust)
    if track == 'scatterings':
        return 2 * (track_n_scat + 2)
    raise ValueError("unknown track_origin flag: %s" % track)


def _resample_filters(filters, n_samp=512):
    """Every filter's normalized response on one shared uniform log10(nu)
    grid (linear in nu, zero outside its support)."""
    lo = min(float(np.min(f.nu)) for f in filters)
    hi = max(float(np.max(f.nu)) for f in filters)
    lognu = np.linspace(np.log10(lo), np.log10(hi), n_samp)
    grid = 10.0 ** lognu
    tn = np.zeros((len(filters), n_samp))
    for i, filt in enumerate(filters):
        fnu, ftn = filt.normalized_response
        tn[i] = np.interp(grid, fnu, ftn, left=0.0, right=0.0)
    return lognu, tn


def _spectral_setup(conf, device, dtype):
    """(n_nu, nu_min, nu_max, filter_lognu, filter_tn) of a group conf."""
    from ..util.constants import c
    filters = getattr(conf, '_filters', None) or []
    if filters:
        lognu, tn = _resample_filters(filters)
        return (len(filters), 1.0, 10.0,
                torch.as_tensor(lognu, dtype=dtype, device=device),
                torch.as_tensor(tn, dtype=dtype, device=device))
    return (conf.n_wav, c / (conf.wav_max * 1.e-4),
            c / (conf.wav_min * 1.e-4), None, None)


def _aperture_setup(conf, L):
    """(log10 ap_min, log10 ap_max, n_ap); an infinite radius is 300."""
    if not conf.sed:
        return 300.0, 300.0, 1
    with np.errstate(divide='ignore'):
        return tuple(float(np.log10(r / L)) if np.isfinite(r) else 300.0
                     for r in (conf.ap_min, conf.ap_max)) + (conf.n_ap,)


def build_peel_group(conf, device, dtype, length_scale=1.0, n_sources=1,
                     n_dust=1):
    """A PeelGroup from a PeeledImageConf (a copy of the JAX builder)."""
    L = float(length_scale)
    inside = conf.inside_observer is not None
    if inside:
        angles = conf.viewing_angles or [(90.0, 0.0)]
        origin = np.asarray(conf.inside_observer, float) / L
    else:
        angles = conf.viewing_angles
        origin = np.asarray(conf.peeloff_origin or (0.0, 0.0, 0.0),
                            float) / L
    view, east, north = _viewing_frames(angles)
    mono = bool(getattr(conf, '_monochromatic', False))
    if mono:
        # the bins are frequency indices: nu_min and nu_max are unused
        n_nu, nu_min, nu_max, filter_lognu, filter_tn = (
            conf.iwav_max - conf.iwav_min + 1, 1.0, 10.0, None, None)
    else:
        n_nu, nu_min, nu_max, filter_lognu, filter_tn = _spectral_setup(
            conf, device, dtype)
    ap_min, ap_max, n_ap = _aperture_setup(conf, L)
    track_n_scat = int(conf.track_n_scat or 0)
    d_min = getattr(conf, 'd_min', None)
    d_max = getattr(conf, 'd_max', None)
    # image limits: degrees (lon/lat) for inside observers, cm/L otherwise
    lim_scale = 1.0 if inside else L
    return PeelGroup(
        view_dir=view, east=east, north=north, origin=origin,
        xmin=conf.xmin / lim_scale if conf.image else 0.0,
        xmax=conf.xmax / lim_scale if conf.image else 0.0,
        ymin=conf.ymin / lim_scale if conf.image else 0.0,
        ymax=conf.ymax / lim_scale if conf.image else 0.0,
        log10_nu_min=float(np.log10(nu_min)),
        log10_nu_max=float(np.log10(nu_max)),
        log10_ap_min=ap_min, log10_ap_max=ap_max,
        n_view=len(angles), n_x=conf.n_x if conf.image else 1,
        n_y=conf.n_y if conf.image else 1, n_nu=n_nu, n_ap=n_ap,
        n_orig=_n_orig(conf.track_origin, track_n_scat, n_sources, n_dust),
        compute_image=bool(conf.image), compute_sed=bool(conf.sed),
        uncertainties=bool(conf.uncertainties),
        track_origin=conf.track_origin, n_stokes=4 if conf.stokes else 1,
        monochromatic=mono, iwav_min=int(conf.iwav_min or 0) if mono else 0,
        inside=inside,
        ignore_optical_depth=bool(getattr(conf, 'ignore_optical_depth',
                                          False)),
        use_filters=filter_tn is not None, track_n_scat=track_n_scat,
        n_sources=n_sources, n_dust=n_dust,
        d_min=None if d_min is None else d_min / L,
        d_max=None if d_max is None else d_max / L,
        filter_lognu=filter_lognu, filter_tn=filter_tn,
        inv_area=1.0 / L ** 2 if inside else None)


def build_binned_group(conf, device, dtype, length_scale=1.0, n_sources=1,
                       n_dust=1):
    """The PeelGroup of a binned-images conf: n_view = n_theta * n_phi
    direction bins (ref images_binned.f90:57-95); image axes come from each
    photon's own exit direction."""
    L = float(length_scale)
    n_nu, nu_min, nu_max, filter_lognu, filter_tn = _spectral_setup(
        conf, device, dtype)
    ap_min, ap_max, n_ap = _aperture_setup(conf, L)
    track_n_scat = int(conf.track_n_scat or 0)
    n_view = conf.n_theta * conf.n_phi
    z3 = np.zeros((n_view, 3))
    return PeelGroup(
        view_dir=z3, east=z3, north=z3, origin=np.zeros(3),
        xmin=conf.xmin / L if conf.image else 0.0,
        xmax=conf.xmax / L if conf.image else 0.0,
        ymin=conf.ymin / L if conf.image else 0.0,
        ymax=conf.ymax / L if conf.image else 0.0,
        log10_nu_min=float(np.log10(nu_min)),
        log10_nu_max=float(np.log10(nu_max)),
        log10_ap_min=ap_min, log10_ap_max=ap_max,
        n_view=n_view, n_x=conf.n_x if conf.image else 1,
        n_y=conf.n_y if conf.image else 1, n_nu=n_nu, n_ap=n_ap,
        n_orig=_n_orig(conf.track_origin, track_n_scat, n_sources, n_dust),
        compute_image=bool(conf.image), compute_sed=bool(conf.sed),
        uncertainties=bool(conf.uncertainties),
        track_origin=conf.track_origin, n_stokes=4 if conf.stokes else 1,
        use_filters=filter_tn is not None, track_n_scat=track_n_scat,
        n_sources=n_sources, n_dust=n_dust,
        filter_lognu=filter_lognu, filter_tn=filter_tn)


class Provenance(NamedTuple):
    """Photon origin at a peel or bin event: what the four track_origin
    modes read (ref orig(), image_type.f90:117-134, and the detailed and
    scatterings expansion :443-461)."""
    scattered: torch.Tensor    # this event is (or the photon last was) a scatter
    reprocessed: torch.Tensor  # the photon was (re-)emitted by dust
    source_id: torch.Tensor    # emitting source row
    dust_id: torch.Tensor      # last interacting dust
    n_scat: torch.Tensor       # scatterings since emission


def origin_index(group, prov):
    """The origin slice (0-based) of each lane in this group's mode."""
    mode = group.track_origin
    if mode == 'no':
        return torch.zeros_like(prov.source_id)
    if mode == 'basic':
        return torch.where(
            prov.scattered,
            torch.where(prov.reprocessed, ORIG_DUST_SCAT, ORIG_SOURCE_SCAT),
            torch.where(prov.reprocessed, ORIG_DUST_EMIT, ORIG_SOURCE_EMIT))
    if mode == 'detailed':
        # [sources emit][dusts emit][sources scat][dusts scat]
        ns, nd = group.n_sources, group.n_dust
        base = torch.where(prov.scattered, ns + nd, 0)
        return base + torch.where(prov.reprocessed, ns + prov.dust_id,
                                  prov.source_id)
    if mode == 'scatterings':
        # 0..K exactly n scatterings, K+1 more; doubled for reprocessed
        cap = group.track_n_scat + 1
        io = prov.n_scat.clamp_max(cap)
        return io + torch.where(prov.reprocessed, cap + 1, 0)
    raise ValueError("unknown track_origin flag: %s" % mode)


def filter_transmissions(group, nu):
    """(B, n_filt) filter responses at each lane's frequency: linear on the
    shared log10(nu) grid, zero outside it."""
    grid = group.filter_lognu
    n_samp = grid.shape[0]
    lognu = torch.log10(nu)
    j = torch.searchsorted(grid, lognu.contiguous()).clamp(1, n_samp - 1)
    w = (lognu - grid[j - 1]) / (grid[j] - grid[j - 1])
    tn = group.filter_tn
    tr = tn[:, j - 1] * (1.0 - w) + tn[:, j] * w
    inside = (lognu >= grid[0]) & (lognu <= grid[-1])
    return torch.where(inside[None, :], tr, 0.0).T


def _floor_index(f, n):
    """floor(f) as int64, with values outside [0, n) kept outside (clamped
    to -1 or n before the cast, which is undefined for huge floats)."""
    return f.floor().clamp(-1.0, float(n)).long()


class PeelAccum:
    """The six cubes of one group, each a flat buffer: sed (n_view, n_ap,
    n_nu, n_orig, n_stokes) and img (n_view, n_y, n_x, n_nu, n_orig,
    n_stokes), each with its sum of squares and count (filled with
    uncertainties)."""

    def __init__(self, group, device, dtype):
        g = group
        self.sed_shape = (g.n_view, g.n_ap, g.n_nu, g.n_orig, g.n_stokes)
        self.img_shape = (g.n_view, g.n_y, g.n_x, g.n_nu, g.n_orig,
                          g.n_stokes)
        for name, shape in (('sed', self.sed_shape), ('img', self.img_shape)):
            for suffix in ('', '2', 'n'):
                setattr(self, name + suffix,
                        torch.zeros(math.prod(shape), dtype=dtype,
                                    device=device))

    def cubes(self):
        """{name: cube} (views)."""
        out = {}
        for name, shape in (('sed', self.sed_shape), ('img', self.img_shape)):
            for suffix in ('', '2', 'n'):
                out[name + suffix] = getattr(self, name + suffix).view(shape)
        return out


def _deposit(group, flat, flat2, flatn, spatial_idx, ok_base, inu, nu_ok,
             tr, io, flux_s):
    """Add the lanes' fluxes into one cube (flat): one ``index_add_`` for
    the sums, and with uncertainties one each for the squares and the
    counts. With ``tr`` (B, n_filt) a lane lands in every filter channel
    weighted by its transmission, else in its ``inu`` bin. A masked-out
    lane adds a zero at its own clamped bin, so that the masked lanes'
    atomics do not all land on one address (PERF.md). The fluxes take the
    cube's type (float64 cubes of float32 lanes: the monochromatic
    iteration's)."""
    S = group.n_stokes
    vals = torch.stack(flux_s, dim=-1)                     # (B, S)
    s_off = torch.arange(S, device=flat.device)
    if tr is None:
        ok = (ok_base & nu_ok)[:, None]                    # (B, 1)
        idx0 = ((spatial_idx * group.n_nu + inu) * group.n_orig + io) * S
        idx = idx0[:, None] + s_off                        # (B, S)
    else:
        f = torch.arange(group.n_nu, device=flat.device)
        okf = ok_base[:, None] & (tr > 0.0)                # (B, F)
        idx0 = ((spatial_idx[:, None] * group.n_nu + f) * group.n_orig +
                io[:, None]) * S
        idx = idx0[..., None] + s_off                      # (B, F, S)
        vals = vals[:, None, :] * tr[..., None]
        ok = okf[..., None]
    idx = idx.reshape(-1)
    val = torch.where(ok, vals, 0.0).reshape(-1).to(flat.dtype)
    flat.index_add_(0, idx, val)
    if group.uncertainties:
        flat2.index_add_(0, idx, val * val)
        flatn.index_add_(0, idx, torch.where(ok, torch.ones_like(vals),
                                             0.0).reshape(-1).to(flat.dtype))


def _aperture_bin(group, x_img, y_img, ok_base):
    """Log-radius aperture bin for SEDs (ref find_sed_bin): photons inside
    ap_min go to bin 0; the bins are cumulated at write time."""
    if group.n_ap == 1:
        return torch.zeros_like(x_img, dtype=torch.int64), \
            torch.ones_like(ok_base)
    r_img = torch.sqrt(x_img ** 2 + y_img ** 2)
    logr = torch.log10(r_img.clamp_min(1e-300))
    fr = (logr - group.log10_ap_min) / \
        (group.log10_ap_max - group.log10_ap_min)
    ir = _floor_index(fr * (group.n_ap - 1), group.n_ap) + 1
    ir = torch.where(logr < group.log10_ap_min, 0, ir)
    return ir.clamp(0, group.n_ap - 1), ir < group.n_ap


def _spectral_bin(group, nu, inu_global=None):
    """(inu, nu_ok, tr) of a lane batch: the log-frequency bin, the filter
    transmissions, or for a monochromatic group the bin of the exact
    frequency's index ``inu_global`` (an int, the same for every lane)."""
    if group.use_filters:
        return None, torch.ones_like(nu, dtype=torch.bool), \
            filter_transmissions(group, nu)
    if group.monochromatic:
        inu = torch.full(nu.shape, int(inu_global) - group.iwav_min,
                         dtype=torch.int64, device=nu.device)
    else:
        fnu = (torch.log10(nu) - group.log10_nu_min) / \
            (group.log10_nu_max - group.log10_nu_min)
        inu = _floor_index(fnu * group.n_nu, group.n_nu)
    nu_ok = (inu >= 0) & (inu < group.n_nu)
    return inu.clamp(0, group.n_nu - 1), nu_ok, None


def _image_bin(group, x_img, y_img):
    """(flat pixel index within a view, in-image mask)."""
    ix = _floor_index((x_img - group.xmin) / (group.xmax - group.xmin)
                      * group.n_x, group.n_x)
    iy = _floor_index((y_img - group.ymin) / (group.ymax - group.ymin)
                      * group.n_y, group.n_y)
    in_img = (ix >= 0) & (ix < group.n_x) & (iy >= 0) & (iy < group.n_y)
    return (iy.clamp(0, group.n_y - 1) * group.n_x +
            ix.clamp(0, group.n_x - 1)), in_img


def bin_escaped(group, n_theta, n_phi, acc, x, y, z, kx, ky, kz, nu, energy,
                prov, escaped_mask, stokes_in=None):
    """Bin escaping photons by exit direction into the theta/phi cube (ref
    binned_images_bin_photon, images_binned.f90:57-95)."""
    theta = torch.arccos(kz.clamp(-1.0, 1.0))
    phi = torch.remainder(torch.atan2(ky, kx), 2.0 * math.pi)
    it = (theta / math.pi * n_theta).long().clamp(0, n_theta - 1)
    ip = (phi / (2.0 * math.pi) * n_phi).long().clamp(0, n_phi - 1)
    iv = it * n_phi + ip
    # the image plane perpendicular to the photon's own direction
    st_ = torch.sqrt((kx * kx + ky * ky).clamp_min(1e-30))
    sp, cp = ky / st_, kx / st_
    ct = kz.clamp(-1.0, 1.0)
    x_img = y * cp - x * sp
    y_img = z * st_ - y * ct * sp - x * ct * cp

    inu, nu_ok, tr = _spectral_bin(group, nu)
    io = origin_index(group, prov).clamp(0, group.n_orig - 1)
    ok_base = escaped_mask & (energy > 0.0)
    flux_s = [energy]
    if group.n_stokes > 1:
        if stokes_in is None:
            zq = torch.zeros_like(x)
            stokes_in = (zq, zq, zq)
        flux_s += [energy * s for s in stokes_in]
    if group.compute_sed:
        ir, ap_ok = _aperture_bin(group, x_img, y_img, ok_base)
        _deposit(group, acc.sed, acc.sed2, acc.sedn, iv * group.n_ap + ir,
                 ok_base & ap_ok, inu, nu_ok, tr, io, flux_s)
    if group.compute_image:
        pix, in_img = _image_bin(group, x_img, y_img)
        _deposit(group, acc.img, acc.img2, acc.imgn,
                 iv * (group.n_y * group.n_x) + pix, ok_base & in_img, inu,
                 nu_ok, tr, io, flux_s)


def _walk_sights(walk, groups, sights, chi_rows, p_x, p_y, p_z, cell,
                 active, extra=None):
    """The escape optical depth along the lines of sight of every group
    that attenuates, and along ``extra``'s rays (see :func:`peel_and_bin`),
    in one call of ``walk``; an outside view or an extra ray in a call with
    inside observers walks unlimited (t_max = +inf). Returns (per group
    tau of shape (n, B), or None for an ``ignore_optical_depth`` group;
    the extra rays' tau (B,) or None)."""
    rows = [s for g, s in zip(groups, sights) if not g.ignore_optical_depth]
    limited = [g.inside for g in groups if not g.ignore_optical_depth]
    if extra is not None:
        rows.append(tuple(k[None] for k in extra[:3]) + (None,))
        limited.append(False)
        active = active | extra[3]
    if not rows:
        return [None] * len(groups), None
    if len(rows) == 1:
        kx, ky, kz = rows[0][:3]
    else:
        kx, ky, kz = (torch.cat([r[c] for r in rows]) for c in range(3))
    t_max = None
    if any(limited):
        t_max = torch.cat([r[3][None] if lim else
                           torch.full_like(r[0], math.inf)
                           for r, lim in zip(rows, limited)])
    tau = walk(chi_rows, p_x, p_y, p_z, kx, ky, kz, cell, active,
               t_max=t_max)
    taus, row = [], 0
    for group, sight in zip(groups, sights):
        if group.ignore_optical_depth:
            taus.append(None)
            continue
        n = sight[0].shape[0]
        taus.append(tau[row:row + n])
        row += n
    return taus, None if extra is None else \
        torch.where(extra[3], tau[-1], 0.0)


def peel_and_bin(walk, dt, groups, accums, p_x, p_y, p_z, chi_rows, cell, nu,
                 energy, weight_iso, is_scatter, dust_id, k_in_x, k_in_y,
                 k_in_z, prov, active, stokes_in=None, surface=None,
                 extra=None, inu_global=None):
    """For every group and view: the peel weight, the escape optical depth
    and the binning into ``accums`` (in place). ``walk``, an
    :class:`~.escape_tau.EscapeTau`, is called once for the event: the
    lines of sight of every group that attenuates (each view of an outside
    observer, and the one direction toward an inside observer, limited to
    its distance, which all its views share) walk together.

    ``weight_iso``: the weight of isotropic events (1); scatterings take the
    scattering matrix at the angle between the incoming direction and the
    view, the whole Stokes vector when a group tracks polarization.
    ``surface``: (mask, nx, ny, nz, limb) of lanes emitted from a stellar
    surface, which peel with 4 mu or the limb-darkened 2 (1.5 mu^2 + mu)
    (ref emit_from_sphere_peeloff, source_type.f90:692-707).
    ``stokes_in``: the photons' (q, u, v), None for unpolarized.
    ``inu_global``: for monochromatic groups, the index of the lanes'
    exact frequency in the model's list (an int).
    ``extra``: (kx, ky, kz, mask), one more ray per lane, (B,) each, walked
    to the edge in the same call for the lanes of ``mask`` (the emission
    rays of a forced first interaction). Returns their tau (B,), 0 outside
    ``mask``, or None without ``extra``."""
    if stokes_in is None:
        zq = torch.zeros_like(p_x)
        stokes_in = (zq, zq, zq)
    q_in, u_in, v_in = stokes_in
    want_stokes = any(g.n_stokes > 1 for g in groups)
    rows = phase_rows(dt, dust_id, nu)
    # the lines of sight of each group: (vdx, vdy, vdz) of shape (n, B) and
    # the distance to an inside observer (ref images_peeled.f90:158-161)
    sights = []
    for group in groups:
        if group.inside:
            ddx = float(group.origin[0]) - p_x
            ddy = float(group.origin[1]) - p_y
            ddz = float(group.origin[2]) - p_z
            d_obs = torch.sqrt(ddx ** 2 + ddy ** 2 + ddz ** 2)
            d_safe = d_obs.clamp_min(1e-30)
            sights.append(((ddx / d_safe)[None], (ddy / d_safe)[None],
                           (ddz / d_safe)[None], d_obs))
        else:
            sights.append((*group.view_block(p_x), None))
    taus, tau_extra = _walk_sights(walk, groups, sights, chi_rows, p_x, p_y,
                                   p_z, cell, active, extra)
    for group, acc, sight, tau_g in zip(groups, accums, sights, taus):
        io = origin_index(group, prov).clamp(0, group.n_orig - 1)
        inu, nu_ok, tr = _spectral_bin(group, nu, inu_global)
        d_obs = sight[3]
        for iv in range(group.n_view):
            j = 0 if group.inside else iv
            vdx, vdy, vdz = sight[0][j], sight[1][j], sight[2][j]
            if group.inside:
                depth = d_obs
            else:
                # the event's depth along the line of sight
                # (ref images_peeled.f90:162-167)
                depth = -(vdx * p_x + vdy * p_y + vdz * p_z)

            # the peel probability (ref interact_peeloff ->
            # dust_scatter_peeloff)
            if want_stokes:
                wI, wQ, wU, wV = peel_scatter_stokes(
                    dt, dust_id, nu, k_in_x, k_in_y, k_in_z, q_in, u_in,
                    v_in, vdx, vdy, vdz, rows=rows)
                w = torch.where(is_scatter, wI, weight_iso)
                w_q = torch.where(is_scatter, wQ, 0.0)
                w_u = torch.where(is_scatter, wU, 0.0)
                w_v = torch.where(is_scatter, wV, 0.0)
            else:
                mu_req = k_in_x * vdx + k_in_y * vdy + k_in_z * vdz
                w = torch.where(is_scatter,
                                eval_phase_peel(dt, dust_id, nu, mu_req,
                                                rows=rows), weight_iso)
            if surface is not None:
                s_mask, snx, sny, snz, limb = surface
                mu_s = (snx * vdx + sny * vdy + snz * vdz).clamp_min(0.0)
                w_surf = torch.where(limb, 2.0 * (1.5 * mu_s * mu_s + mu_s),
                                     4.0 * mu_s)
                w = torch.where(s_mask & ~is_scatter, w_surf, w)

            if tau_g is None:
                atten = energy
            else:
                atten = energy * torch.exp(-tau_g[j])
            if group.inside:
                atten = atten * (group.inv_area / (
                    4.0 * math.pi * d_obs.clamp_min(1e-30) ** 2))
            flux = w * atten
            flux_s = [flux]
            if group.n_stokes > 1:
                flux_s += [w_q * atten, w_u * atten, w_v * atten]

            if group.inside:
                # the sky projection: the direction rotated into the view
                # frame R = [r_hat; east; north], (lon, lat) in degrees
                # with wraparound (ref images_peeled.f90:176-206)
                r_hat, e, n = (group.view_dir[iv], group.east[iv],
                               group.north[iv])
                vs_x = vdx * r_hat[0] + vdy * r_hat[1] + vdz * r_hat[2]
                vs_y = vdx * e[0] + vdy * e[1] + vdz * e[2]
                vs_z = vdx * n[0] + vdy * n[1] + vdz * n[2]
                rad2deg = 180.0 / math.pi
                x_img = torch.atan2(vs_y, vs_x) * rad2deg
                y_img = torch.atan2(torch.sqrt(vs_x ** 2 + vs_y ** 2),
                                    vs_z) * rad2deg - 90.0
                if group.compute_image:
                    x_img = group.xmax + torch.remainder(x_img - group.xmax,
                                                         360.0)
                    y_img = group.ymin + torch.remainder(y_img - group.ymin,
                                                         360.0)
            else:
                dx = p_x - float(group.origin[0])
                dy = p_y - float(group.origin[1])
                dz = p_z - float(group.origin[2])
                e, n = group.east[iv], group.north[iv]
                x_img = dx * e[0] + dy * e[1] + dz * e[2]
                y_img = dx * n[0] + dy * n[1] + dz * n[2]

            ok_base = active & (flux > 0.0)
            if group.d_min is not None:
                ok_base = ok_base & (depth >= group.d_min)
            if group.d_max is not None:
                ok_base = ok_base & (depth <= group.d_max)

            if group.compute_sed:
                ir, ap_ok = _aperture_bin(group, x_img, y_img, ok_base)
                _deposit(group, acc.sed, acc.sed2, acc.sedn,
                         iv * group.n_ap + ir, ok_base & ap_ok, inu, nu_ok,
                         tr, io, flux_s)
            if group.compute_image:
                pix, in_img = _image_bin(group, x_img, y_img)
                _deposit(group, acc.img, acc.img2, acc.imgn,
                         iv * (group.n_y * group.n_x) + pix,
                         ok_base & in_img, inu, nu_ok, tr, io, flux_s)
    return tau_extra


@dataclass
class FinalPacketState:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    kx: torch.Tensor
    ky: torch.Tensor
    kz: torch.Tensor
    nu: torch.Tensor
    energy: torch.Tensor
    cell: torch.Tensor         # (B,) int64, ESCAPED outside
    tau: torch.Tensor          # optical depth left to the next interaction
    n_inter: torch.Tensor      # (B,) int32
    n_mrw: torch.Tensor        # (B,) int32 MRW jumps since the last event
    n_reabs: torch.Tensor      # (B,) int32 successive source re-absorptions
    reemit_src: torch.Tensor   # (B,) int64 source row to re-emit from, -1
    alive: torch.Tensor        # (B,) bool
    reprocessed: torch.Tensor  # ever re-emitted by dust
    scattered: torch.Tensor    # scattered since the last emission
    source_id: torch.Tensor    # (B,) int64 emitting source row
    dust_id: torch.Tensor      # (B,) int64 last interacting dust
    n_scat: torch.Tensor       # (B,) int64 scatterings since emission
    chi: torch.Tensor          # (B, n_dust)
    kappa: torch.Tensor
    albedo: torch.Tensor
    # Stokes Q, U, V in the meridian frame of the direction, I = 1
    # (ref type_photon %s, dust_scatter:566-571)
    q: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


@dataclass
class FinalCarry:
    packets: FinalPacketState
    # () int64 device counters, as in the Lucy carry (engine.COUNTERS; the
    # carry owns its lanes and counters, engine.own_carry): the photons
    # left to emit, changed by each refill; the alive lanes and the photons
    # waiting for re-emission, set at the end of each step for the next
    # step's refill gate; the working steps
    budget: torch.Tensor
    n_alive: torch.Tensor
    n_pending: torch.Tensor
    n_steps: torch.Tensor
    energy_current: torch.Tensor   # () float64
    accums: list
    binned_acc: Optional[PeelAccum]
    killed_int: torch.Tensor       # () int64
    n_events: torch.Tensor         # () int64, lanes that moved or jumped
    # () int64 device count of the refills that ran (engine.run_if)
    refills: torch.Tensor = 0

    def __post_init__(self):
        own_carry(self)


def make_final_step(geometry, walk_geometry, dt, st, density, jnu_var_id,
                    jnu_var_frac, groups, config, binned=None, mrw=None,
                    se_rho=None):
    """The step of the imaging iteration: ``step(carry, generator)``
    advances the carry by one step, in place, reading nothing on the host
    (so that a CUDA graph can hold it); ``step.draw``, ``step.refill`` and
    ``step.counts`` as the Lucy step's (``engine.make_lucy_step``). After
    the iteration's end (no budget, nothing alive or waiting) a step
    changes nothing. ``walk_geometry``: the grid's float64 tables, which
    the escape-tau walk runs on (``escape_tau.py``).

    ``config``: n_inter_max, kill_on_scatter, kill_on_absorb,
    forced_first_interaction, ffi_algorithm, ffi_baes16_xi,
    peeloff_scattering_only, n_reabs_max, source_intersect, n_mrw_max.
    ``binned``: (group, n_theta, n_phi) of the binned images, or None.
    ``mrw``: the :class:`~.mrw.MRWTables`, or None. ``se_rho``: specific
    energy times density, where a map emits with an LTE spectrum."""
    n_dust, n_cells = density.shape
    rho_t = density.T.contiguous()
    vid_t = jnu_var_id.T.contiguous()
    vfrac_t = jnu_var_frac.T.contiguous()
    walk = EscapeTau(walk_geometry, rho_t)
    n_inter_max = int(config['n_inter_max'])
    kill_on_scatter = bool(config['kill_on_scatter'])
    kill_on_absorb = bool(config['kill_on_absorb'])
    ffi = bool(config['forced_first_interaction'])
    ffi_algorithm = str(config.get('ffi_algorithm', 'wr99'))
    ffi_xi = float(config.get('ffi_baes16_xi', 0.5))
    scat_only = bool(config['peeloff_scattering_only'])
    reabs_on = bool(config.get('source_intersect', False))
    n_reabs_max = int(config.get('n_reabs_max', 0))
    sphere = st.has_sphere
    n_extra, emit_kw = emit_options(geometry, dt, st, jnu_var_id,
                                    jnu_var_frac, se_rho)
    n_rows = N_UNIFORMS + n_extra if n_extra or mrw is not None else \
        U_EM_OUT_PHI + 1 if sphere else U_TAU + 1
    if mrw is not None:
        n_mrw_max = int(config['n_mrw_max'])
        alpha_t = mrw.alpha_inv_planck

    def refill(carry, u, gate):
        """Emit fresh packets into dead lanes while budget remains, and
        re-emit photons re-absorbed by a source (keeping their energy; FFI
        never applies to them, ref iter_final.f90:219-243); peel the
        emissions with the energy before the FFI reweight (ref
        iter_final.f90:120). Every lane is computed and peels masked;
        ``gate`` (a () bool) masks the whole refill off, which then
        changes nothing."""
        p = carry.packets
        B = p.x.shape[0]
        dead = ~p.alive
        if reabs_on:
            pending = (p.reemit_src >= 0) & gate
            dead = dead & ~pending
        rank = torch.cumsum(dead, dim=0)
        can_fresh = dead & (rank <= carry.budget) & gate
        n_new = torch.minimum(B - carry.n_alive - carry.n_pending,
                              carry.budget) * gate
        u_sphere = (u[U_EM_CAP], u[U_EM_CAP_PHI], u[U_EM_OUT],
                    u[U_EM_OUT_PHI]) if sphere else None
        src = None
        can = can_fresh
        reemit_ok = None
        if reabs_on:
            reabs_kill = pending & (p.n_reabs + 1 > n_reabs_max)
            reemit_ok = pending & ~reabs_kill
            src = torch.where(reemit_ok, p.reemit_src,
                              pick_sources(st, u[U_SRC]))
            can = can_fresh | reemit_ok
        new = emit_packets(st, u[U_SRC], u[U_EM_NU], u[U_EM_MU],
                           u[U_EM_PHI], u_sphere, src=src,
                           u_extra=u[U_EM_EXTRA:] if n_extra else None,
                           **emit_kw)
        # a point source's position columns are strided views; the walk
        # takes contiguous lanes
        for k in ('x', 'y', 'z'):
            new[k] = new[k].contiguous()
        cell_new = geometry.find_cell(new['x'], new['y'], new['z'],
                                      new['kx'], new['ky'], new['kz'])
        chi_n, kappa_n, alb_n = update_optical_constants(dt, new['nu'])
        emitted = can & (cell_new != ESCAPED)
        energy_new = new['energy'] if reemit_ok is None else \
            torch.where(reemit_ok, p.energy, new['energy'])
        # forced first interaction (ref iter_final.f90:178-210) needs the
        # escape optical depth along the emission ray
        forced = None
        if ffi:
            forced = emitted if reemit_ok is None else emitted & ~reemit_ok
        # the emission peel, with the energy before the FFI reweight (ref
        # iter_final.f90:120), on the emitted lanes' own state (the packets
        # below take it); re-emitted photons peel even when only
        # scatterings do, "because this is a kind of scattering" (ref
        # iter_final.f90:225-228). Its walk also walks the emission rays.
        tau_esc = None
        if not scat_only or reabs_on:
            peel = emitted
            if scat_only:
                peel = emitted & reemit_ok
            no = torch.zeros_like(peel)
            zero_id = torch.zeros_like(p.dust_id)
            prov = Provenance(scattered=no, reprocessed=no,
                              source_id=new['source'], dust_id=zero_id,
                              n_scat=torch.zeros_like(p.n_scat))
            surface = (new['surf'], new['snx'], new['sny'], new['snz'],
                       new['limb']) if sphere else None
            tau_esc = peel_and_bin(
                walk, dt, groups, carry.accums, new['x'], new['y'],
                new['z'], chi_n, cell_new, new['nu'],
                torch.where(peel, energy_new, 0.0), 1.0, no, zero_id,
                new['kx'], new['ky'], new['kz'], prov, peel, surface=surface,
                extra=None if forced is None else
                (new['kx'], new['ky'], new['kz'], forced))
        if ffi:
            if tau_esc is None:
                tau_esc = walk(chi_n, new['x'], new['y'], new['z'],
                               new['kx'][None], new['ky'][None],
                               new['kz'][None], cell_new, forced)[0]
            applies = tau_esc > 1e-10
            if reemit_ok is not None:
                applies = applies & ~reemit_ok
            tau_new, w_ffi = sample_first_interaction(
                u[U_FFI], u[U_EM_TAU], tau_esc, applies, ffi_algorithm,
                ffi_xi)
            energy_new = energy_new * w_ffi
        else:
            tau_new = random_exp(u[U_EM_TAU])

        def m(old, new_, mask=can):
            put_where(old, new_, mask)

        if reabs_on:
            # fresh photons start a run of re-absorptions at 0, re-emitted
            # ones count one more
            m(p.n_reabs, torch.where(reemit_ok, p.n_reabs + 1, 0))
            m(p.reemit_src, -1, pending)
        p.alive |= emitted & (energy_new > 0.0)
        for name in ('x', 'y', 'z', 'kx', 'ky', 'kz', 'nu'):
            m(getattr(p, name), new[name])
        m(p.energy, energy_new)
        m(p.cell, cell_new)
        m(p.tau, tau_new)
        m(p.n_inter, 0, can_fresh)
        m(p.source_id, new['source'])
        for name in ('n_mrw', 'dust_id', 'n_scat', 'reprocessed', 'scattered',
                     'q', 'u', 'v'):
            m(getattr(p, name), 0)
        m(p.chi, chi_n)
        m(p.kappa, kappa_n)
        m(p.albedo, alb_n)
        if reabs_on:
            carry.killed_int += reabs_kill.sum()
        carry.energy_current += torch.where(can_fresh, new['energy'],
                                            0.0).sum(dtype=torch.float64)
        carry.budget -= n_new

    def draw(carry, generator):
        x = carry.packets.x
        return torch.rand((n_rows, x.shape[0]), generator=generator,
                          device=x.device, dtype=density.dtype)

    def step(carry, generator):
        p = carry.packets
        B = p.x.shape[0]
        u = draw(carry, generator)
        # a working step: budget left, a live lane or a waiting photon
        carry.n_steps += (carry.budget > 0) | (carry.n_alive > 0) | \
            (carry.n_pending > 0)
        # refill when >= 1/4 of the lanes are dead (or none is alive) while
        # budget remains, or a re-absorbed photon waits (the JAX step
        # refills every step), as the Lucy step does (engine.run_if)
        gate = ((carry.budget > 0) & ((carry.n_alive * 4 <= 3 * B) |
                                      (carry.n_alive == 0))) | \
            (carry.n_pending > 0)
        run_refill(refill, carry, u, gate)

        cell_safe = p.cell.clamp_min(0)
        rho_rows = rho_t[cell_safe]
        vid_rows = vid_t[cell_safe]
        vfrac_rows = vfrac_t[cell_safe]
        x, y, z, kx, ky, kz = p.x, p.y, p.z, p.kx, p.ky, p.kz
        nu, chi, kappa, albedo = p.nu, p.chi, p.kappa, p.albedo
        q, uq, vq = p.q, p.u, p.v
        cell, n_mrw, alive = p.cell, p.n_mrw, p.alive
        dust_id, reprocessed = p.dust_id, p.reprocessed
        active = alive

        # --- MRW without deposits (ref iter_final.f90:167-184,
        # grid_do_mrw_noenergy, grid_mrw_3d.f90:113-150): a jump to the
        # closest-wall sphere, nu from b_nu, depolarized, an isotropic peel
        if mrw is not None:
            d_close = geometry.closest_wall_distance(cell_safe, x, y, z)
            mrw_now = alive & (p.n_inter >= 1) & \
                (alpha_t[cell_safe] * d_close > mrw.gamma)
            jx, jy, jz = isotropic_direction(u[U_MRW_JUMP_MU],
                                             u[U_MRW_JUMP_PHI])
            nkx, nky, nkz = isotropic_direction(u[U_MRW_DIR_MU],
                                                u[U_MRW_DIR_PHI])
            d_sel_m = select_dust(u[U_MRW_DUST], chi, rho_rows)
            nu_m = sample_emission_nu(dt, d_sel_m,
                                      _select_col(vid_rows, d_sel_m),
                                      _select_col(vfrac_rows, d_sel_m),
                                      u[U_MRW_BIN], u[U_MRW_XI], use_bnu=True)
            chi_m, kappa_m, alb_m = update_optical_constants(dt, nu_m)
            n_mrw = n_mrw + mrw_now.to(torch.int32)
            killed_mrw = mrw_now & (n_mrw > n_mrw_max)
            x_m, y_m, z_m = x + d_close * jx, y + d_close * jy, \
                z + d_close * jz
            # the jump sphere touches the nearest wall: locate with the new
            # direction so that a tangent landing picks its side
            cell_rm = geometry.find_cell(x_m, y_m, z_m, nkx, nky, nkz)
            cell = torch.where(mrw_now & (cell_rm != ESCAPED), cell_rm, cell)
            x = torch.where(mrw_now, x_m, x)
            y = torch.where(mrw_now, y_m, y)
            z = torch.where(mrw_now, z_m, z)
            kx = torch.where(mrw_now, nkx, kx)
            ky = torch.where(mrw_now, nky, ky)
            kz = torch.where(mrw_now, nkz, kz)
            nu = torch.where(mrw_now, nu_m, nu)
            chi = torch.where(mrw_now[:, None], chi_m, chi)
            kappa = torch.where(mrw_now[:, None], kappa_m, kappa)
            albedo = torch.where(mrw_now[:, None], alb_m, albedo)
            q = torch.where(mrw_now, 0.0, q)
            uq = torch.where(mrw_now, 0.0, uq)
            vq = torch.where(mrw_now, 0.0, vq)
            dust_id = torch.where(mrw_now, d_sel_m, dust_id)
            reprocessed = reprocessed | mrw_now
            alive = alive & ~killed_mrw
            carry.killed_int += killed_mrw.sum()
            if not scat_only:
                peel_mrw = mrw_now & alive
                no = torch.zeros_like(peel_mrw)
                prov = Provenance(scattered=no, reprocessed=~no,
                                  source_id=p.source_id, dust_id=dust_id,
                                  n_scat=p.n_scat)
                peel_and_bin(walk, dt, groups, carry.accums, x, y, z, chi,
                             cell, nu, torch.where(peel_mrw, p.energy, 0.0),
                             1.0, no, d_sel_m, kx, ky, kz, prov, peel_mrw)
            # lanes that jumped skip the propagation below
            active = alive & ~mrw_now

        # --- propagation, no deposits ---
        t_wall, next_cell, ax, wall_coord = geometry.find_wall(
            cell_safe, x, y, z, kx, ky, kz)
        chi_rho = (chi * rho_rows).sum(dim=-1)
        tau_wall = chi_rho * t_wall
        hits_wall = (tau_wall < p.tau) | (chi_rho <= 0.0)
        t_int = torch.where(chi_rho > 0.0, p.tau / chi_rho.clamp_min(1e-300),
                            t_wall)
        d_move = torch.where(hits_wall, t_wall, t_int)
        # source re-absorption: the photon waits for its re-emission (ref
        # grid_integrate_noenergy, grid_propagate_3d.f90:283,327-330)
        moving = active
        if reabs_on:
            t_src, src_row = nearest_source_intersection(st, x, y, z, kx, ky,
                                                         kz)
            hits_src = active & (d_move > t_src)
            hits_wall = hits_wall & ~hits_src
            moving = active & ~hits_src
        x = torch.where(moving, x + d_move * kx, x)
        y = torch.where(moving, y + d_move * ky, y)
        z = torch.where(moving, z + d_move * kz, z)
        crossed = moving & hits_wall
        x, y, z = geometry.snap(x, y, z, ax, wall_coord, crossed)
        tau = torch.where(moving, torch.where(hits_wall, p.tau - tau_wall,
                                              0.0), p.tau)
        cell = torch.where(crossed, next_cell, cell)
        escaped = crossed & (cell == ESCAPED)

        # --- interaction: absorption and re-emission, or a polarized
        # scattering (ref dust_scatter with Stokes) ---
        interacting = moving & ~hits_wall
        d_sel = select_dust(u[U_DUST], chi, rho_rows)
        scatter = u[U_COIN] <= _select_col(albedo, d_sel)
        nu_em = sample_emission_nu(dt, d_sel, _select_col(vid_rows, d_sel),
                                   _select_col(vfrac_rows, d_sel), u[U_BIN],
                                   u[U_XI])
        ex, ey, ez = isotropic_direction(u[U_DIR_MU], u[U_DIR_PHI])
        sx, sy, sz, q_s, u_s, v_s = sample_scatter_stokes(
            dt, d_sel, nu, u[U_PHI], u[U_MU], kx, ky, kz, q, uq, vq)
        absorbed = interacting & ~scatter
        scattered_now = interacting & scatter
        nu_new = torch.where(absorbed, nu_em, nu)
        kx_new = torch.where(absorbed, ex, torch.where(scattered_now, sx, kx))
        ky_new = torch.where(absorbed, ey, torch.where(scattered_now, sy, ky))
        kz_new = torch.where(absorbed, ez, torch.where(scattered_now, sz, kz))
        # re-emission depolarizes; a scattering rotates and polarizes
        q_new = torch.where(absorbed, 0.0, torch.where(scattered_now, q_s, q))
        u_new = torch.where(absorbed, 0.0,
                            torch.where(scattered_now, u_s, uq))
        v_new = torch.where(absorbed, 0.0,
                            torch.where(scattered_now, v_s, vq))
        # origin: a scattering keeps the last emission's, an absorption
        # makes it dust emission (ref orig(), image_type.f90:117-134);
        # n_scat survives re-emission (ref dust_interact.f90:70)
        n_scat = p.n_scat + scattered_now.to(p.n_scat.dtype)
        dust_id = torch.where(interacting, d_sel, dust_id)
        prov = Provenance(scattered=scattered_now,
                          reprocessed=reprocessed | ~scattered_now,
                          source_id=p.source_id, dust_id=dust_id,
                          n_scat=n_scat)
        # the re-emitted frequency's opacities before the peel (ref
        # interact() calls update_optconsts before peeloff_photon)
        chi_n, kappa_n, alb_n = update_optical_constants(dt, nu_new)
        chi = torch.where(absorbed[:, None], chi_n, chi)
        kappa = torch.where(absorbed[:, None], kappa_n, kappa)
        albedo = torch.where(absorbed[:, None], alb_n, albedo)
        # killed photons do not peel (ref iter_final.f90:262-268)
        peel = scattered_now if scat_only else interacting
        if kill_on_absorb:
            peel = peel & ~absorbed
        if kill_on_scatter:
            peel = peel & ~scattered_now
        peel_and_bin(walk, dt, groups, carry.accums, x, y, z, chi, cell,
                     nu_new, p.energy, 1.0, scattered_now, d_sel, kx, ky, kz,
                     prov, peel, stokes_in=(q, uq, vq))
        reprocessed = reprocessed | absorbed
        scattered = torch.where(absorbed, False, p.scattered | scattered_now)

        tau = torch.where(interacting, random_exp(u[U_TAU]), tau)
        n_inter = p.n_inter + interacting.to(torch.int32)
        # a packet whose tau ran out exactly on a wall may now point into
        # the other cell (ref adjust_wall)
        cell_re = geometry.find_cell(x, y, z, kx_new, ky_new, kz_new)
        cell = torch.where(interacting & (cell_re != ESCAPED), cell_re, cell)

        killed_now = interacting & (n_inter > n_inter_max)
        if kill_on_scatter:
            killed_now = killed_now | scattered_now
        if kill_on_absorb:
            killed_now = killed_now | absorbed
        # MRW lanes stay alive: their walk goes on next step
        alive = alive & ~escaped & ~killed_now
        n_reabs, reemit_src = p.n_reabs, p.reemit_src
        if reabs_on:
            alive = alive & ~hits_src
            reemit_src = torch.where(hits_src, src_row, reemit_src)
            n_reabs = torch.where(interacting, 0, n_reabs)

        # --- binned images: photons that leave the grid ---
        if binned is not None:
            bgroup, n_theta, n_phi = binned
            prov_escape = Provenance(
                scattered=p.scattered, reprocessed=p.reprocessed,
                source_id=p.source_id, dust_id=p.dust_id, n_scat=p.n_scat)
            bin_escaped(bgroup, n_theta, n_phi, carry.binned_acc, x, y, z,
                        kx, ky, kz, nu, p.energy, prov_escape, escaped,
                        stokes_in=(q, uq, vq))

        if reabs_on:
            put(p, n_reabs=n_reabs, reemit_src=reemit_src)
            carry.n_pending.copy_((reemit_src >= 0).sum())
        put(p, x=x, y=y, z=z, kx=kx_new, ky=ky_new, kz=kz_new, nu=nu_new,
            cell=cell, tau=tau, n_inter=n_inter,
            n_mrw=torch.where(interacting, 0, n_mrw), alive=alive,
            reprocessed=reprocessed, scattered=scattered, dust_id=dust_id,
            n_scat=n_scat, chi=chi, kappa=kappa, albedo=albedo, q=q_new,
            u=u_new, v=v_new)
        carry.killed_int += killed_now.sum()
        carry.n_events += (moving | mrw_now).sum() if mrw is not None \
            else moving.sum()
        carry.n_alive.copy_(alive.sum())

    step.draw = draw
    step.refill = refill
    step.counts = imaging_step_counts
    return step


def _init_final_carry(dt, density, groups, n_photons, batch_size,
                      binned_group=None):
    n_dust, n_cells = density.shape
    dtype, device = density.dtype, density.device
    B = int(batch_size)

    def zeros(*s, dtype=dtype):
        return torch.zeros(s, dtype=dtype, device=device)

    packets = FinalPacketState(
        x=zeros(B), y=zeros(B), z=zeros(B), kx=zeros(B), ky=zeros(B),
        kz=torch.ones(B, dtype=dtype, device=device),
        nu=torch.ones(B, dtype=dtype, device=device), energy=zeros(B),
        cell=zeros(B, dtype=torch.int64), tau=zeros(B),
        n_inter=zeros(B, dtype=torch.int32),
        n_mrw=zeros(B, dtype=torch.int32),
        n_reabs=zeros(B, dtype=torch.int32),
        reemit_src=torch.full((B,), -1, dtype=torch.int64, device=device),
        alive=zeros(B, dtype=torch.bool),
        reprocessed=zeros(B, dtype=torch.bool),
        scattered=zeros(B, dtype=torch.bool),
        source_id=zeros(B, dtype=torch.int64),
        dust_id=zeros(B, dtype=torch.int64),
        n_scat=zeros(B, dtype=torch.int64),
        chi=zeros(B, n_dust), kappa=zeros(B, n_dust),
        albedo=zeros(B, n_dust), q=zeros(B), u=zeros(B), v=zeros(B))
    return FinalCarry(
        packets=packets, budget=n_photons, n_alive=0, n_pending=0,
        n_steps=0, energy_current=zeros(dtype=torch.float64),
        accums=[PeelAccum(g, device, dtype) for g in groups],
        binned_acc=None if binned_group is None else
        PeelAccum(binned_group, device, dtype),
        killed_int=zeros(dtype=torch.int64),
        n_events=zeros(dtype=torch.int64))


class FinalResult(NamedTuple):
    accums: list               # one PeelAccum per peeled group
    binned_acc: object         # PeelAccum of the binned group, or None
    energy_current: float
    killed_int: int
    n_steps: int
    n_events: int


def start_final(geometry, dt, st, density, specific_energy, groups,
                n_photons, walk_geometry, batch_size=65536,
                n_inter_max=1000000,
                kill_on_scatter=False, kill_on_absorb=False,
                forced_first_interaction=True, peeloff_scattering_only=False,
                n_reabs_max=0, binned_group=None, binned_dims=None,
                ffi_algorithm='wr99', ffi_baes16_xi=0.5, use_mrw=False,
                mrw_gamma=1.0, n_mrw_max=1000):
    """The imaging iteration before its first step: ``(carry, step)``, where
    ``step(carry, generator)`` advances the :class:`FinalCarry` by one step.

    ``density`` (n_dust, n_cells) in engine units, ``specific_energy`` the
    same shape (None: zero) for the dust emissivities and the MRW tables,
    ``walk_geometry`` the grid's float64 tables for the escape-tau walk."""
    from .lucy import compute_jnu_var
    if specific_energy is None:
        specific_energy = torch.zeros_like(density)
    jnu_var_id, jnu_var_frac = compute_jnu_var(dt, specific_energy)
    config = dict(n_inter_max=n_inter_max, kill_on_scatter=kill_on_scatter,
                  kill_on_absorb=kill_on_absorb,
                  forced_first_interaction=forced_first_interaction,
                  peeloff_scattering_only=peeloff_scattering_only,
                  ffi_algorithm=ffi_algorithm, ffi_baes16_xi=ffi_baes16_xi,
                  n_reabs_max=n_reabs_max,
                  source_intersect=st.any_intersect, n_mrw_max=n_mrw_max)
    mrw = prepare_mrw_tables(dt, density, specific_energy, mrw_gamma) \
        if use_mrw else None
    binned = None if binned_group is None else \
        (binned_group,) + tuple(binned_dims)
    carry = _init_final_carry(dt, density, groups, n_photons, batch_size,
                              binned_group)
    # a map with an LTE spectrum picks its dust ∝ specific energy x density
    se_rho = specific_energy * density if st.has_lte else None
    step = make_final_step(geometry, walk_geometry, dt, st, density,
                           jnu_var_id, jnu_var_frac, groups, config,
                           binned=binned, mrw=mrw, se_rho=se_rho)
    return carry, step


def finish_final(carry, n_steps):
    """The :class:`FinalResult` of a carry that has run ``n_steps``
    working steps: lanes still alive (or waiting for re-emission) are
    killed and counted in killed_int."""
    p = carry.packets
    killed_int = carry.killed_int + p.alive.sum() + (p.reemit_src >= 0).sum()
    killed_int, n_events, refills = torch.stack(
        [killed_int, carry.n_events, carry.refills]).tolist()
    imaging_step_counts['refills'] += refills
    return FinalResult(carry.accums, carry.binned_acc,
                       float(carry.energy_current), killed_int, n_steps,
                       n_events)


def run_final(geometry, dt, st, density, specific_energy, groups, generator,
              n_photons, max_steps=100000000, **options):
    """Run the imaging iteration on one device and return a
    :class:`FinalResult`: on a CUDA device as replays of a CUDA graph of
    ``engine.GRAPH_STEPS`` steps (``engine.drive_graph``), on the CPU one
    step at a time (``engine.drive_steps``), as the Lucy iteration runs.

    ``options`` are the keywords of :func:`start_final`; ``generator`` the
    ``torch.Generator`` on the density's device. Lanes still alive (or
    waiting for re-emission) after ``max_steps`` working steps are killed
    and counted in killed_int."""
    carry, step = start_final(geometry, dt, st, density, specific_energy,
                              groups, n_photons, **options)
    drive = drive_graph if density.device.type == 'cuda' else drive_steps
    _, n_steps = drive(carry, step, generator, max_steps)
    return finish_final(carry, n_steps)
