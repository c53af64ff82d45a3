"""The Lucy transport step of the port (counterpart of
``hyperion_tpu/transport/engine.py``).

The whole batch advances in lockstep, one cell event per lane per step: a
wall crossing, an interaction (absorption and re-emission, or scattering)
or a modified-random-walk jump. Dead lanes are refilled from the photon
budget inside the loop, and photons re-absorbed by a spherical source are
re-emitted from it there. Each step deposits ds * kappa * E (and the MRW's
ct * kappa_planck * E) into the per-(dust, cell) accumulator and counts
unique-photon cell visits through the ``deposit_visit`` kernel; with
spectrum bins the deposits are also binned by frequency.

All random numbers of a step are drawn in one ``torch.rand`` call from the
iteration's generator; the physics functions take uniforms. A step reads
nothing on the host: the budget, the uid counter, the alive and waiting
counts and the count of working steps live on the device, the refill runs
under a gate computed there, and every result is written into the
carry's own tensors. On a CUDA device the iteration runs as replays of one
CUDA graph of GRAPH_STEPS steps, the host reading the counters once after
each replay (the JAX package runs the same loop as one device-resident
``lax.while_loop``); on the CPU the same step runs eagerly and the
counters are read after each. The JAX step's two ``lax.cond``s, the refill
and the MRW move, are :func:`run_if`: in a graph an IF conditional node
that a replay skips where the gate is false, eagerly a body masked by the
gate. Map sources place their photons in the grid's cells, and a map with
an LTE spectrum draws its frequencies from the dust emissivity there
(``se_rho``, the specific energy times the density of the previous
iteration)."""

import ctypes
import dataclasses
import math
from dataclasses import dataclass

import torch

from .deposit_visit import DepositVisit
from .gtable import ESCAPED
from .mrw import sample_min09
from .sampling import (interp_loglog, isotropic_direction, random_exp,
                       rotate_direction, sample_quantile_rows)
from .stable import (emit_extra_rows, emit_packets,
                     nearest_source_intersection, pick_sources)

# rows of the per-step uniform draw: refill (emission), the step, then the
# sphere emission's and the MRW move's, then for map, box and beam sources
# the rows of stable.E_* from U_EM_EXTRA (stable.emit_extra_rows); a step
# draws only the rows its model uses, so a point-source model without MRW
# draws the first 15
(U_SRC, U_EM_NU, U_EM_MU, U_EM_PHI, U_EM_TAU,
 U_CHECK, U_DUST, U_COIN, U_BIN, U_XI, U_DIR_MU, U_DIR_PHI, U_MU, U_PHI,
 U_TAU,
 U_EM_CAP, U_EM_CAP_PHI, U_EM_OUT, U_EM_OUT_PHI,
 U_MRW_Y, U_MRW_JUMP_MU, U_MRW_JUMP_PHI, U_MRW_DIR_MU, U_MRW_DIR_PHI,
 U_MRW_DUST, U_MRW_BIN, U_MRW_XI) = range(27)
N_UNIFORMS = 27
U_EM_EXTRA = N_UNIFORMS

# the steps that one CUDA graph holds, for the Lucy, imaging and
# monochromatic iterations alike: a replay runs this many steps, and the
# host reads the iteration's counters once after it. Picked on an H100
# from 4 to 64 for the Lucy step (PERF.md): a capture costs more than K
# times a step's host time, an iteration captures anew, and larger graphs
# replayed no faster
GRAPH_STEPS = 4

# how this process ran each iteration's steps since the last reset, one
# dict an iteration (a step's ``counts``): steps run eagerly, steps
# captured into graphs, graph replays and the steps they ran, host reads
# of the counters, and the gated bodies that ran (run_if: refills, and the
# Lucy step's MRW moves; each carry counts its own on the device, read once
# at the iteration's end: eagerly a body runs every step, in a graph only
# where its gate holds) (chip_smoke.py and scripts/profile_step.py read
# them); ``step_counts`` is the Lucy iteration's
step_counts = dict(eager=0, captured=0, replays=0, replayed=0, reads=0,
                   refills=0, mrw_moves=0)
imaging_step_counts = dict(step_counts)
mono_step_counts = dict(step_counts)

# the () int64 device counters of an iteration's carry that the drivers
# read: photons left to emit, alive lanes, photons waiting for re-emission
# and working steps
COUNTERS = ('budget', 'n_alive', 'n_pending', 'n_steps')


def reset_step_counts():
    global cond_nodes
    for counts in (step_counts, imaging_step_counts, mono_step_counts):
        for k in counts:
            counts[k] = 0
    cond_nodes = 0


def own_carry(carry):
    """Give a carry of the imaging or monochromatic step its own copy of
    its lanes (the step writes them in place: lanes that share memory with
    the caller's arrays, as ``torch.as_tensor`` of a numpy array does, are
    left as they were), and make each of its COUNTERS and its count of
    refills a () int64 tensor on the lanes' device (a host int given for
    one becomes one)."""
    p = carry.packets
    carry.packets = dataclasses.replace(p, **{
        f.name: getattr(p, f.name).clone() for f in dataclasses.fields(p)})
    for name in COUNTERS + ('refills',):
        value = getattr(carry, name)
        if not isinstance(value, torch.Tensor):
            setattr(carry, name, torch.full((), int(value),
                                            dtype=torch.int64,
                                            device=p.x.device))


@dataclass
class PacketState:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    kx: torch.Tensor
    ky: torch.Tensor
    kz: torch.Tensor
    nu: torch.Tensor
    energy: torch.Tensor
    cell: torch.Tensor        # (B,) int64 flat cell index, ESCAPED outside
    tau: torch.Tensor         # optical depth left to the next interaction
    n_inter: torch.Tensor     # (B,) int32 interaction count
    n_mrw: torch.Tensor       # (B,) int32 MRW jumps since the last event
    n_reabs: torch.Tensor     # (B,) int32 successive source re-absorptions
    reemit_src: torch.Tensor  # (B,) int64 source row to re-emit from, -1
    uid: torch.Tensor         # (B,) int32 photon id for the visit dedup
    alive: torch.Tensor       # (B,) bool
    chi: torch.Tensor         # (B, n_dust) extinction at nu
    kappa: torch.Tensor       # (B, n_dust) absorption at nu
    albedo: torch.Tensor      # (B, n_dust)


@dataclass
class LucyCarry:
    packets: PacketState
    # () int64 device counters: the photons left to emit and the ids
    # consumed, changed by each refill; the alive lanes and the photons
    # waiting for re-emission by their source, set at the end of each step
    # for the next step's refill gate; the working steps, those that began
    # with budget, a live lane or a waiting photon (a step after the
    # iteration's end changes nothing and is not counted)
    budget: torch.Tensor
    uid_counter: torch.Tensor
    n_alive: torch.Tensor
    n_pending: torch.Tensor
    n_steps: torch.Tensor
    energy_current: torch.Tensor   # () float64
    # energy_sum (n_dust, n_cells) and the (n_cells,) int64 unique-photon
    # visit counts (ref last_photon_id dedup, grid_propagate_3d.f90:91-97)
    stats: DepositVisit
    # (n_dust, n_bins, n_cells) frequency-binned deposits, n_bins = 0
    # without spectrum bins (ref grid_physics_3d.f90:41-56)
    energy_sum_spec: torch.Tensor
    killed_int: torch.Tensor       # () int64
    killed_geo: torch.Tensor       # () int64
    # lanes that moved (crossing or interaction) or jumped (MRW):
    # n_events/(n_steps*B) is the alive-lane occupancy
    n_events: torch.Tensor         # () int64
    # () int64 device counts of the gated bodies that ran (run_if)
    refills: torch.Tensor
    mrw_moves: torch.Tensor


def update_optical_constants(dt, nu):
    """chi and albedo log-log interpolated at each lane's frequency for
    every dust, and kappa DERIVED as chi * (1 - albedo), as the reference's
    update_optconsts does (dust.f90:74-76). Returns (B, n_dust) each."""
    chis, albedos = [], []
    for d in range(dt.n_dust):
        chis.append(interp_loglog(dt.nu[d], dt.chi[d], nu))
        albedos.append(interp_loglog(dt.nu[d], dt.albedo[d], nu)
                       .clamp(0.0, 1.0))
    chi = torch.stack(chis, dim=-1)
    albedo = torch.stack(albedos, dim=-1)
    return chi, chi * (1.0 - albedo), albedo


def sample_emission_nu(dt, dust_id, var_id, var_frac, u_bin, u_xi,
                       use_bnu=False):
    """Re-emission frequency: the bracketing specific-energy bin by a
    Bernoulli draw on var_frac, then one quantile-table inversion of j_nu
    (or, with ``use_bnu``, of the MRW's b_nu)."""
    v = var_id + (u_bin < var_frac).to(var_id.dtype)
    rows = dust_id * dt.n_var + v.clamp_max(dt.n_var - 1)
    q = dt.bnu_q if use_bnu else dt.jnu_q
    return sample_quantile_rows(q, rows, u_xi, exp2=True)


def sample_scattering_mu(dt, dust_id, nu, u):
    """cos(scattering angle) from the P1 quantile table of the lane's
    frequency bin (ref dust_scatter, dust_type_4elem.f90:504-545)."""
    n_nu = dt.nu.shape[1]
    j = torch.stack([torch.searchsorted(dt.nu[d], nu.contiguous(), right=True)
                     for d in range(dt.n_dust)], dim=-1)
    inu = (_select_col(j, dust_id) - 1).clamp(0, n_nu - 1)
    return sample_quantile_rows(dt.mu_q, dust_id * n_nu + inu, u)


def _select_col(mat, sel):
    """mat[i, sel[i]] for a (B, n) matrix."""
    return mat.gather(1, sel[:, None])[:, 0]


def select_dust(u, chi, density_rows):
    """The interacting dust population, with probability ∝ chi_d * rho_d
    (ref select_dust_chi_rho, grid_physics_3d.f90:87-109)."""
    w = chi * density_rows
    target = u * w.sum(dim=-1)
    # the running sum over the few dusts as a loop: torch.cumsum along a
    # short innermost axis of B rows takes ~0.7 ms on the H100 at B = 125,000
    csum = torch.zeros_like(target)
    sel = torch.zeros_like(target, dtype=torch.int64)
    for d in range(w.shape[-1]):
        csum = csum + w[:, d]
        sel += csum < target
    return sel.clamp(0, w.shape[-1] - 1)


def interaction_update(dt, u, interacting, nu, kx, ky, kz, chi, albedo,
                       rho_rows, vid_rows, vfrac_rows):
    """One interaction event (ref interact, dust_interact.f90:22-76): a dust
    picked ∝ chi*rho, an albedo coin, absorption → re-emission at a
    frequency from the local emissivity in an isotropic direction,
    scattering → deflection by a sampled mu, and the opacity refresh.

    ``u``: the uniforms (u_dust, u_coin, u_bin, u_xi, u_dir_mu, u_dir_phi,
    u_mu, u_phi), each (B,). Returns a dict of the post-event lane values
    (masked by ``interacting``), the absorbed/scattered masks and d_sel."""
    u_dust, u_coin, u_bin, u_xi, u_dir_mu, u_dir_phi, u_mu, u_phi = u
    d_sel = select_dust(u_dust, chi, rho_rows)
    scatter = u_coin <= _select_col(albedo, d_sel)
    var_id = _select_col(vid_rows, d_sel)
    var_frac = _select_col(vfrac_rows, d_sel)
    nu_em = sample_emission_nu(dt, d_sel, var_id, var_frac, u_bin, u_xi)
    mu_s = sample_scattering_mu(dt, d_sel, nu, u_mu)
    ex, ey, ez = isotropic_direction(u_dir_mu, u_dir_phi)
    sx, sy, sz = rotate_direction(kx, ky, kz, mu_s, u_phi * (2.0 * torch.pi))

    absorbed = interacting & ~scatter
    scattered = interacting & scatter
    nu_new = torch.where(absorbed, nu_em, nu)
    kx_new = torch.where(absorbed, ex, torch.where(scattered, sx, kx))
    ky_new = torch.where(absorbed, ey, torch.where(scattered, sy, ky))
    kz_new = torch.where(absorbed, ez, torch.where(scattered, sz, kz))
    chi_n, kappa_n, alb_n = update_optical_constants(dt, nu_new)
    return dict(nu=nu_new, kx=kx_new, ky=ky_new, kz=kz_new,
                chi=torch.where(absorbed[:, None], chi_n, chi),
                kappa_abs=kappa_n, albedo_abs=alb_n,
                absorbed=absorbed, scattered=scattered, d_sel=d_sel)


def mrw_jump_update(dt, mrw, u, mrw_now, x, y, z, energy, chi, d_close,
                    alpha_inv, kappa_p_rows, rho_rows, vid_rows, vfrac_rows):
    """One Min+09 modified-random-walk move (ref grid_do_mrw,
    grid_mrw_3d.f90:56-111): the diffusion time from eq. (8), the Lucy
    deposit ct * kappa_planck * E per dust (eq. 9), a jump to the surface of
    the sphere of radius d_close, a fresh isotropic direction and a
    frequency from the local b_nu.

    ``u``: the uniforms (u_y, u_jump_mu, u_jump_phi, u_dir_mu, u_dir_phi,
    u_dust, u_bin, u_xi), each (B,). Returns (deps (B, n_dust), x_m, y_m,
    z_m, (kx, ky, kz), nu_m, chi_m, kappa_m, albedo_m)."""
    u_y, u_jmu, u_jphi, u_kmu, u_kphi, u_dust, u_bin, u_xi = u
    y_s = sample_min09(mrw, u_y)
    ct = -torch.log(y_s.clamp_min(1e-30)) * 3.0 * alpha_inv * \
        (d_close / math.pi) ** 2
    deps = torch.where(mrw_now[:, None] & (rho_rows > 0.0),
                       ct[:, None] * kappa_p_rows * energy[:, None], 0.0)
    jx, jy, jz = isotropic_direction(u_jmu, u_jphi)
    nk = isotropic_direction(u_kmu, u_kphi)
    d_sel = select_dust(u_dust, chi, rho_rows)
    nu_m = sample_emission_nu(dt, d_sel, _select_col(vid_rows, d_sel),
                              _select_col(vfrac_rows, d_sel), u_bin, u_xi,
                              use_bnu=True)
    chi_m, kappa_m, alb_m = update_optical_constants(dt, nu_m)
    return (deps, x + d_close * jx, y + d_close * jy, z + d_close * jz, nk,
            nu_m, chi_m, kappa_m, alb_m)


def emit_options(geometry, dt, st, jnu_var_id, jnu_var_frac, se_rho):
    """``(n_extra, kw)``: the rows of extra uniforms that the source rows
    draw from (:func:`~.stable.emit_extra_rows`) and
    :func:`~.stable.emit_packets`' keywords besides them: the geometry for
    map cells, and for LTE spectra the context of the dust emissivity
    (``se_rho`` None: zero, the first iteration's uniform dust pick)."""
    kw = dict(geometry=geometry)
    if st.has_lte:
        kw['lte_ctx'] = (dt, jnu_var_id, jnu_var_frac,
                         torch.zeros_like(jnu_var_frac) if se_rho is None
                         else se_rho)
    return emit_extra_rows(st, geometry), kw


def make_lucy_step(geometry, dt, st, density, jnu_var_id, jnu_var_frac,
                   config, mrw=None, spec_bins=None, spec_bin_frac=None,
                   se_rho=None):
    """The step of one Lucy iteration: ``step(carry, generator)`` advances
    the carry by one step, in place, reading nothing on the host (so that
    a CUDA graph can hold it); ``step.draw(carry, generator)`` draws one
    step's uniforms, as the step does, ``step.refill(carry, u, gate)`` is
    its refill (scripts/profile_step.py times it masked off) and
    ``step.counts`` the dict the drivers count its steps in.

    density, jnu_var_id/frac: (n_dust, n_cells), the emissivity locator
    from the previous iteration's specific energy (ref precompute_jnu_var,
    grid_physics_3d.f90:613-635). ``config``: n_inter_max, kill_on_scatter,
    kill_on_absorb, check_frequency, and for this slice's options n_mrw_max,
    n_reabs_max and source_intersect (the sources can re-absorb photons).
    ``mrw``: the iteration's :class:`~.mrw.MRWTables`, or None for no MRW.
    ``spec_bins``: (n_bins + 1,) log2 frequency bin edges, or None;
    ``spec_bin_frac``: (n_dust * n_var, n_bins) emissivity fraction of each
    bin per (dust, var) row, which spreads MRW deposits over the bins (ref
    deposit_specific_energy_spectrum, grid_physics_3d.f90:367-415).
    ``se_rho``: (n_dust, n_cells) specific energy times density, where a
    map emits with an LTE spectrum (None: zero)."""
    n_dust, n_cells = density.shape
    dtype = density.dtype
    # per-cell rows, gathered by each lane's cell
    rho_t = density.T.contiguous()
    vid_t = jnu_var_id.T.contiguous()
    vfrac_t = jnu_var_frac.T.contiguous()
    n_inter_max = int(config['n_inter_max'])
    kill_on_scatter = bool(config['kill_on_scatter'])
    kill_on_absorb = bool(config['kill_on_absorb'])
    check_freq = float(config.get('check_frequency', 0.0))
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
        kp_t = mrw.kappa_planck.T.contiguous()
    spec_on = spec_bins is not None
    if spec_on:
        n_bins = spec_bins.shape[0] - 1
        dust_bin0 = torch.arange(n_dust, device=density.device) * n_bins
        if mrw is not None and spec_bin_frac is not None:
            # the (dust, bin) offsets of the spread MRW deposits
            mrw_bins = (dust_bin0[:, None] + torch.arange(
                n_bins, device=density.device)[None, :]) * n_cells
            var0 = torch.arange(n_dust, device=density.device) * dt.n_var

    def refill(carry, u, gate):
        """Emit fresh packets into dead lanes while budget remains
        (replaces the reference's chunk scheduler), and re-emit photons
        re-absorbed by a source from that source: they keep their energy,
        uid and interaction count (ref iter_lucy.f90:158-183), and one
        re-absorbed more than n_reabs_max times in a row is killed. Every
        lane is computed; ``gate`` (a () bool) masks the whole refill
        off, which then changes nothing."""
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
        cell_new = geometry.find_cell(new['x'], new['y'], new['z'],
                                      new['kx'], new['ky'], new['kz'])
        chi_n, kappa_n, alb_n = update_optical_constants(dt, new['nu'])

        def m(old, new_, mask=can):
            put_where(old, new_, mask)

        # fresh photons take ids from the consumed-budget counter; int32
        # holds them (run_lucy caps the budget below 2**31 - 1)
        uid_new = (carry.uid_counter + rank).to(torch.int32)
        if reabs_on:
            # fresh photons start a run of re-absorptions at 0, re-emitted
            # ones count one more
            m(p.n_reabs, torch.where(reemit_ok, p.n_reabs + 1, 0))
            m(p.reemit_src, -1, pending)
        for name in ('x', 'y', 'z', 'kx', 'ky', 'kz', 'nu'):
            m(getattr(p, name), new[name])
        m(p.energy, new['energy'], can_fresh)
        m(p.cell, cell_new)
        m(p.tau, random_exp(u[U_EM_TAU]))
        m(p.n_inter, 0, can_fresh)
        m(p.n_mrw, 0)
        m(p.uid, uid_new, can_fresh)
        # photons emitted outside the grid simply escape (run_model checks
        # that point and sphere sources lie inside it)
        p.alive |= can & (cell_new != ESCAPED)
        m(p.chi, chi_n)
        m(p.kappa, kappa_n)
        m(p.albedo, alb_n)
        # the emission cell of a fresh photon counts as visited; no deposits
        emit_idx = torch.where(can_fresh & (cell_new != ESCAPED), cell_new,
                               n_cells)
        carry.stats(None, None, emit_idx, p.uid)
        if reabs_on:
            carry.killed_int += reabs_kill.sum()
        carry.energy_current += torch.where(can_fresh, new['energy'],
                                            0.0).sum(dtype=torch.float64)
        carry.budget -= n_new
        carry.uid_counter += n_new

    def spectrum_deposits(carry, cell_safe, nu, dep_rows, mrw_deps,
                          vid_rows, vfrac_rows):
        """The step's deposits binned by the packet frequency (ref
        grid_propagate_3d.f90:71,155,217; packets outside the edges are not
        binned), and the MRW deposits spread over the bins by the local
        emissivity between the two bracketing var rows: one index_add_."""
        ibin = torch.searchsorted(
            spec_bins, torch.log2(nu.clamp_min(1e-30)).contiguous(),
            right=True) - 1
        bin_ok = (ibin >= 0) & (ibin < n_bins)
        idx = [((dust_bin0[None, :] + ibin.clamp(0, n_bins - 1)[:, None])
                * n_cells + cell_safe[:, None]).reshape(-1)]
        val = [torch.where(bin_ok[:, None], dep_rows, 0.0).reshape(-1)]
        if mrw_deps is not None and spec_bin_frac is not None:
            row0 = var0[None, :] + vid_rows
            row1 = var0[None, :] + (vid_rows + 1).clamp_max(dt.n_var - 1)
            vf = vfrac_rows[:, :, None]
            frac = (1.0 - vf) * spec_bin_frac[row0] + vf * spec_bin_frac[row1]
            idx.append((mrw_bins[None] + cell_safe[:, None, None]).reshape(-1))
            val.append((mrw_deps[:, :, None] * frac).reshape(-1))
        carry.energy_sum_spec.view(-1).index_add_(0, torch.cat(idx),
                                                  torch.cat(val))

    def draw(carry, generator):
        x = carry.packets.x
        return torch.rand((n_rows, x.shape[0]), generator=generator,
                          device=x.device, dtype=dtype)

    def step(carry, generator):
        p = carry.packets
        B = p.x.shape[0]
        u = draw(carry, generator)
        # a working step: budget left, a live lane or a waiting photon
        carry.n_steps += (carry.budget > 0) | (carry.n_alive > 0) | \
            (carry.n_pending > 0)
        # refill when >= 1/4 of the lanes are dead (or none is alive), or a
        # re-absorbed photon waits (the gate the JAX step computes)
        gate = ((carry.budget > 0) & ((carry.n_alive * 4 <= 3 * B) |
                                      (carry.n_alive == 0))) | \
            (carry.n_pending > 0)
        run_refill(refill, carry, u, gate)

        cell_safe = p.cell.clamp_min(0)
        rho_rows = rho_t[cell_safe]
        vid_rows = vid_t[cell_safe]
        vfrac_rows = vfrac_t[cell_safe]
        active = p.alive

        # --- modified random walk (ref iter_lucy.f90:138-152): lanes deep
        # in a cell jump; their deposits go to the cell they jump from.
        # The move runs only where a lane jumps (the JAX step's lax.cond);
        # it writes the packets in place and its deposits into mrw_deps,
        # which stays zero where it does not run ---
        mrw_deps = None
        if mrw is not None:
            alpha_inv = alpha_t[cell_safe]
            d_close = geometry.closest_wall_distance(cell_safe, p.x, p.y,
                                                     p.z)
            mrw_now = active & (p.n_inter >= 1) & \
                (alpha_inv * d_close > mrw.gamma)
            mrw_deps = torch.zeros_like(p.chi)

            def mrw_body():
                deps, x_m, y_m, z_m, (nkx, nky, nkz), nu_m, chi_m, \
                    kappa_m, alb_m = mrw_jump_update(
                        dt, mrw, u[U_MRW_Y:U_MRW_XI + 1], mrw_now, p.x, p.y,
                        p.z, p.energy, p.chi, d_close, alpha_inv,
                        kp_t[cell_safe], rho_rows, vid_rows, vfrac_rows)
                mrw_deps.copy_(deps)
                p.n_mrw += mrw_now.to(torch.int32)
                killed_mrw = mrw_now & (p.n_mrw > n_mrw_max)
                # the jump sphere touches the nearest wall: locate with the
                # new direction so that a tangent landing picks its side
                cell_rm = geometry.find_cell(x_m, y_m, z_m, nkx, nky, nkz)
                put_where(p.cell, cell_rm, mrw_now & (cell_rm != ESCAPED))
                for name, value in (('x', x_m), ('y', y_m), ('z', z_m),
                                    ('kx', nkx), ('ky', nky), ('kz', nkz),
                                    ('nu', nu_m), ('chi', chi_m),
                                    ('kappa', kappa_m), ('albedo', alb_m)):
                    put_where(getattr(p, name), value, mrw_now)
                p.alive &= ~killed_mrw
                carry.killed_int += killed_mrw.sum()
                carry.mrw_moves += 1

            run_if(mrw_now.any(), mrw_body)
            # lanes that jumped skip the propagation below
            active = p.alive & ~mrw_now
        x, y, z, kx, ky, kz = p.x, p.y, p.z, p.kx, p.ky, p.kz
        nu, chi, kappa, albedo = p.nu, p.chi, p.kappa, p.albedo
        cell, n_mrw, alive = p.cell, p.n_mrw, p.alive

        # --- distance to the next wall, optical depth through the cell ---
        t_wall, next_cell, ax, wall_coord = geometry.find_wall(
            cell_safe, x, y, z, kx, ky, kz)
        chi_rho = (chi * rho_rows).sum(dim=-1)
        tau_wall = chi_rho * t_wall
        hits_wall = (tau_wall < p.tau) | (chi_rho <= 0.0)
        t_int = torch.where(chi_rho > 0.0, p.tau / chi_rho.clamp_min(1e-300),
                            t_wall)
        d_move = torch.where(hits_wall, t_wall, t_int)

        # --- source re-absorption: a segment through a source's surface
        # ends there, with no deposit and no move; the photon waits for
        # its re-emission (ref grid_propagate_3d.f90:101,142-145) ---
        moving = active
        if reabs_on:
            t_src, src_row = nearest_source_intersection(st, x, y, z, kx, ky,
                                                         kz)
            hits_src = active & (d_move > t_src)
            hits_wall = hits_wall & ~hits_src
            moving = active & ~hits_src

        # --- deposit: specific_energy_sum += ds * kappa_d * E
        # (ref grid_propagate_3d.f90:153-154, 205-206) ---
        dep_rows = torch.where(moving[:, None] & (rho_rows > 0.0),
                               d_move[:, None] * kappa * p.energy[:, None],
                               0.0)
        if spec_on:
            spectrum_deposits(carry, cell_safe, nu, dep_rows, mrw_deps,
                              vid_rows, vfrac_rows)
        if mrw_deps is not None:
            # the MRW lanes' deposits ride the same call (disjoint lanes)
            dep_rows = dep_rows + mrw_deps

        # --- move, snapping wall crossers onto the wall ---
        x = torch.where(moving, x + d_move * kx, x)
        y = torch.where(moving, y + d_move * ky, y)
        z = torch.where(moving, z + d_move * kz, z)
        crossed = moving & hits_wall
        x, y, z = geometry.snap(x, y, z, ax, wall_coord, crossed)
        tau = torch.where(moving, torch.where(hits_wall, p.tau - tau_wall,
                                              0.0), p.tau)
        cell = torch.where(crossed, next_cell, cell)
        escaped = crossed & (cell == ESCAPED)

        # --- deposits and unique-visit counts of the entered cells ---
        enter_idx = torch.where(crossed & (cell != ESCAPED), cell, n_cells)
        carry.stats(cell_safe, dep_rows, enter_idx, p.uid)

        # --- interaction (absorb and re-emit, or scatter) ---
        interacting = moving & ~hits_wall
        evt = interaction_update(
            dt, (u[U_DUST], u[U_COIN], u[U_BIN], u[U_XI], u[U_DIR_MU],
                 u[U_DIR_PHI], u[U_MU], u[U_PHI]),
            interacting, nu, kx, ky, kz, chi, albedo, rho_rows, vid_rows,
            vfrac_rows)
        absorbed = evt['absorbed']
        scattered = evt['scattered']
        kx, ky, kz = evt['kx'], evt['ky'], evt['kz']
        kappa = torch.where(absorbed[:, None], evt['kappa_abs'], kappa)
        albedo = torch.where(absorbed[:, None], evt['albedo_abs'], albedo)

        # a packet whose tau ran out exactly on a wall may now point into
        # the cell on the other side: the direction-aware find_cell is the
        # on-wall disambiguation (ref adjust_wall)
        cell_re = geometry.find_cell(x, y, z, kx, ky, kz)
        cell = torch.where(interacting & (cell_re != ESCAPED), cell_re, cell)
        tau = torch.where(interacting, random_exp(u[U_TAU]), tau)
        n_inter = p.n_inter + interacting.to(torch.int32)
        # the MRW cap counts jumps in one diffusion burst (ref
        # iter_lucy.f90:141)
        n_mrw = torch.where(interacting, 0, n_mrw)

        killed_now = interacting & (n_inter > n_inter_max)
        if kill_on_scatter:
            killed_now = killed_now | scattered
        if kill_on_absorb:
            killed_now = killed_now | absorbed
        alive = alive & ~escaped & ~killed_now
        n_reabs, reemit_src = p.n_reabs, p.reemit_src
        if reabs_on:
            # a source-hit lane goes dormant until the next refill
            alive = alive & ~hits_src
            reemit_src = torch.where(hits_src, src_row, reemit_src)
            # a flight that reached an interaction ends the run of
            # re-absorptions (ref iter_lucy.f90:160)
            n_reabs = torch.where(interacting, 0, n_reabs)

        # --- probabilistic geometry self-check (ref grid_propagate_3d.f90:
        # 110-117 in_correct_cell): a packet found outside its cell's
        # bounds (with tolerance) is killed and counted in killed_geo ---
        if check_freq > 0.0:
            do_check = alive & moving & (cell != ESCAPED) & \
                (u[U_CHECK] < check_freq)
            ok = geometry.in_cell_tol(cell.clamp_min(0), x, y, z)
            bad = do_check & ~ok
            alive = alive & ~bad
            carry.killed_geo += bad.sum()

        if reabs_on:
            put(p, n_reabs=n_reabs, reemit_src=reemit_src)
            carry.n_pending.copy_((reemit_src >= 0).sum())
        put(p, x=x, y=y, z=z, kx=kx, ky=ky, kz=kz, nu=evt['nu'], cell=cell,
            tau=tau, n_inter=n_inter, n_mrw=n_mrw, alive=alive,
            chi=evt['chi'], kappa=kappa, albedo=albedo)
        carry.killed_int += killed_now.sum()
        carry.n_events += (moving | mrw_now).sum() if mrw is not None \
            else moving.sum()
        carry.n_alive.copy_(alive.sum())

    step.draw = draw
    step.refill = refill
    step.counts = step_counts
    return step


def put_where(lane, value, mask):
    """Write ``value`` (a tensor or a number) into the lane tensor ``lane``
    ((B,) or (B, n)) where the (B,) ``mask`` holds, in place."""
    mask = mask if lane.dim() == 1 else mask[:, None]
    if isinstance(value, torch.Tensor):
        torch.where(mask, value, lane, out=lane)
    else:
        lane.masked_fill_(mask, value)


def put(packets, **fields):
    """Write each field's new values into the packets' own tensor (a CUDA
    graph's replay then reads what the previous step wrote)."""
    for name, value in fields.items():
        getattr(packets, name).copy_(value)


# the memory pools of the CUDA graphs that capture_steps is capturing (one
# at a time): run_if routes a body's allocations into its graph's pool
_capture_pools = []
# conditional nodes captured since the last reset (reset_step_counts)
cond_nodes = 0
# {device: the stream that captures the gated bodies on it}
_body_streams = {}


def run_if(gate, body):
    """Run ``body()`` where the () bool tensor ``gate`` holds: the port's
    ``jax.lax.cond`` around a step's refill and MRW move. While the current
    stream captures a CUDA graph (:func:`capture_steps`), ``body`` is
    captured into an IF conditional node of that graph, and a replay runs
    it only where ``gate`` holds at that point of the replay (:func:`if_node`).
    Otherwise, on the CPU and in eager steps on the card, ``body()`` runs,
    and masks itself by ``gate``. So a body must change nothing when its
    gate is false, write only into tensors made before it, and draw no
    random numbers: then a skipped body leaves the carry and the generator
    as the masked one does."""
    if gate.device.type == 'cuda' and torch.cuda.is_current_stream_capturing():
        if_node(gate, body)
    else:
        body()


def run_refill(refill, carry, u, gate):
    """A step's ``refill(carry, u, gate)`` under its gate (:func:`run_if`),
    counted in ``carry.refills`` where its body runs."""
    def body():
        refill(carry, u, gate)
        carry.refills += 1

    run_if(gate, body)


def if_node(gate, body):
    """Capture ``body()`` into an IF conditional node of the CUDA graph that
    :func:`capture_steps` is capturing on the current stream
    (``csrc/cond_node.cu``): a one-thread kernel sets the node's condition
    from ``gate``, a stream of its own captures the body into the node's
    graph, and the caching allocator gives the body's tensors memory from
    the graph's pool. Raises where the node cannot be made or the body
    cannot be captured; nothing is captured unconditionally instead."""
    if not _capture_pools:
        raise RuntimeError("run_if: the current stream captures a graph that "
                           "capture_steps did not begin")
    if gate.dtype != torch.bool or gate.dim() != 0:
        raise ValueError("run_if: the gate must be a () bool tensor, not %s "
                         "%s" % (gate.dtype, tuple(gate.shape)))
    global cond_nodes
    lib, child = _cond_lib(gate.device)
    pool = _capture_pools[-1]
    index = gate.device.index
    parent = torch.cuda.current_stream(gate.device)
    if parent.cuda_stream == child.cuda_stream:
        raise RuntimeError("run_if: a gated body cannot hold another")
    err = lib.cond_begin(parent.cuda_stream, child.cuda_stream,
                         gate.data_ptr())
    if err != 0:
        raise RuntimeError("run_if: no conditional node (cudaError %d)" % err)
    cond_nodes += 1
    # the caching allocator gives the graph's pool to the parent's capture
    # only: the body's stream takes it over until the body is captured
    # (each begin takes a reference to the pool and each release gives it
    # back; the graph holds its own)
    C = torch._C
    C._cuda_endAllocateToPool(index, pool)
    try:
        with torch.cuda.stream(child):
            C._cuda_beginAllocateCurrentStreamToPool(index, pool)
            try:
                body()
            finally:
                C._cuda_endAllocateToPool(index, pool)
                C._cuda_releasePool(index, pool)
                err = lib.cond_end(child.cuda_stream)
    finally:
        C._cuda_beginAllocateCurrentStreamToPool(index, pool)
        C._cuda_releasePool(index, pool)
    if err != 0:
        raise RuntimeError("run_if: the body's capture failed (cudaError %d)"
                           % err)


def _cond_lib(device):
    """The library of ``csrc/cond_node.cu`` and the stream of the bodies'
    captures on ``device``: one of the library's own, made at first use
    (PyTorch's pool of streams hands out the stream that captures the
    graph again after 32 others)."""
    from . import _build
    lib = _build.load('cond_node')
    if lib.cond_begin.argtypes is None:
        lib.cond_begin.argtypes = [ctypes.c_void_p] * 3
        lib.cond_end.argtypes = [ctypes.c_void_p]
        lib.cond_stream.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        for fn in (lib.cond_begin, lib.cond_end, lib.cond_stream):
            fn.restype = ctypes.c_int
    stream = _body_streams.get(device)
    if stream is None:
        handle = ctypes.c_void_p()
        err = lib.cond_stream(ctypes.byref(handle))
        if err != 0:
            raise RuntimeError("run_if: no stream for the bodies (cudaError "
                               "%d)" % err)
        stream = _body_streams[device] = torch.cuda.ExternalStream(
            handle.value, device=device)
    return lib, stream


def _init_lucy_carry(dt, density, n_photons, batch_size, n_bins=0):
    n_dust, n_cells = density.shape
    dtype = density.dtype
    device = density.device
    B = int(batch_size)

    def zeros(*s, dtype=dtype):
        return torch.zeros(s, dtype=dtype, device=device)

    packets = PacketState(
        x=zeros(B), y=zeros(B), z=zeros(B), kx=zeros(B), ky=zeros(B),
        kz=torch.ones(B, dtype=dtype, device=device),
        nu=torch.ones(B, dtype=dtype, device=device), energy=zeros(B),
        cell=zeros(B, dtype=torch.int64), tau=zeros(B),
        n_inter=zeros(B, dtype=torch.int32),
        n_mrw=zeros(B, dtype=torch.int32),
        n_reabs=zeros(B, dtype=torch.int32),
        reemit_src=torch.full((B,), -1, dtype=torch.int64, device=device),
        uid=torch.full((B,), -1, dtype=torch.int32, device=device),
        alive=zeros(B, dtype=torch.bool),
        chi=zeros(B, n_dust), kappa=zeros(B, n_dust),
        albedo=zeros(B, n_dust))
    def count(n=0):
        return torch.full((), n, dtype=torch.int64, device=device)

    return LucyCarry(
        packets=packets, budget=count(int(n_photons)), uid_counter=count(),
        n_alive=count(), n_pending=count(), n_steps=count(),
        energy_current=zeros(dtype=torch.float64),
        stats=DepositVisit(n_dust, n_cells, device, dtype),
        energy_sum_spec=zeros(n_dust, n_bins, n_cells),
        killed_int=zeros(dtype=torch.int64),
        killed_geo=zeros(dtype=torch.int64),
        n_events=zeros(dtype=torch.int64), refills=count(),
        mrw_moves=count())


def read_counts(carry, counts=step_counts):
    """The host's one read of an iteration's counters (COUNTERS), tallied
    in ``counts``: (live, working steps), live while budget, a live lane or
    a waiting photon is left."""
    budget, n_alive, n_pending, n_steps = torch.stack(
        [getattr(carry, name) for name in COUNTERS]).tolist()
    counts['reads'] += 1
    return budget > 0 or n_alive > 0 or n_pending > 0, n_steps


def drive_steps(carry, step, generator, max_steps, last=None):
    """Run an iteration one step at a time, reading the counters after
    each, until it ends or has run ``max_steps`` working steps. The
    drivers serve any carry with the COUNTERS and any step with ``draw``
    and ``counts`` (the Lucy, imaging and monochromatic steps). ``last``:
    the last :func:`read_counts`, if the caller has one. Returns the last
    read."""
    counts = step.counts
    live, n = read_counts(carry, counts) if last is None else last
    while live and n < max_steps:
        step(carry, generator)
        counts['eager'] += 1
        live, n = read_counts(carry, counts)
    return live, n


def drive_blocks(carry, step, generator, max_steps, k, block, last=None):
    """Run an iteration in blocks of ``k`` steps, ``block()`` running one
    (a graph's replay on the card), reading the counters once after each,
    while a whole block fits under ``max_steps``; then the last steps one
    at a time (:func:`drive_steps`). The steps of a block after the
    iteration's end change nothing but draw their uniforms: the generator
    is then set back to where the iteration's last working step left it,
    so that the iteration consumes what the step-at-a-time loop consumes.
    ``last`` as :func:`drive_steps`'. Returns the last read."""
    live, n = read_counts(carry, step.counts) if last is None else last
    while live and n + k <= max_steps:
        state = generator.get_state()
        block()
        live, n_after = read_counts(carry, step.counts)
        if not live and n_after - n < k:
            generator.set_state(state)
            for _ in range(n_after - n):
                step.draw(carry, generator)
        n = n_after
    return drive_steps(carry, step, generator, max_steps, (live, n))


def capture_steps(carry, step, generator, k):
    """A CUDA graph of ``k`` steps of an iteration on the current stream,
    which must not be the default one: the carry's tensors, its tables and
    its kernels' state are the graph's inputs and outputs, and
    ``generator`` is registered with it, so that a replay runs k more
    steps and advances the generator as k eager steps would. The carry
    must have run a step eagerly first (the lazily built tables and
    kernels). Anything in the step that synchronises makes the capture
    raise, and so does this. The step's :func:`run_if` bodies become
    conditional nodes of the graph."""
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    pool = torch.cuda.graph_pool_handle()
    graph.capture_begin(pool=pool)
    _capture_pools.append(pool)
    try:
        for _ in range(k):
            step(carry, generator)
    except BaseException:
        try:
            graph.capture_end()
        except RuntimeError:
            pass
        raise
    finally:
        _capture_pools.pop()
    graph.capture_end()
    step.counts['captured'] += k
    return graph


def drive_graph(carry, step, generator, max_steps):
    """Run an iteration on the card as replays of one CUDA graph of
    GRAPH_STEPS steps (:func:`drive_blocks`): the first step runs eagerly
    on a side stream (the warm-up before a capture), then the capture on
    that stream. An iteration that ends or reaches ``max_steps`` before a
    whole block runs its steps eagerly. Returns the last read."""
    k = GRAPH_STEPS
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream(device=main.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        live, n = drive_steps(carry, step, generator, min(max_steps, 1))
        graph = capture_steps(carry, step, generator, k) \
            if live and n + k <= max_steps else None
    main.wait_stream(side)
    if graph is None:
        return drive_steps(carry, step, generator, max_steps, (live, n))

    def replay():
        graph.replay()
        step.counts['replays'] += 1
        step.counts['replayed'] += k

    return drive_blocks(carry, step, generator, max_steps, k, replay,
                        (live, n))


def start_lucy_iteration(geometry, dt, st, density, jnu_var_id,
                         jnu_var_frac, n_photons, batch_size, config,
                         mrw=None, spec_bins=None, spec_bin_frac=None,
                         se_rho=None):
    """The carry and the step of one Lucy iteration (the arguments of
    :func:`run_lucy_iteration` but the generator)."""
    n_bins = 0 if spec_bins is None else spec_bins.shape[0] - 1
    carry = _init_lucy_carry(dt, density, n_photons, batch_size, n_bins)
    step = make_lucy_step(geometry, dt, st, density, jnu_var_id,
                          jnu_var_frac, config, mrw=mrw, spec_bins=spec_bins,
                          spec_bin_frac=spec_bin_frac, se_rho=se_rho)
    return carry, step


def finish_lucy_iteration(carry, n_steps):
    """The tuple of :func:`run_lucy_iteration` from a carry that has run
    ``n_steps`` working steps: lanes still alive (or waiting for
    re-emission) at max_steps are killed (the bounded-step safety net).
    Adds the gated bodies that ran to ``step_counts``: one host read."""
    refills, mrw_moves = torch.stack([carry.refills,
                                      carry.mrw_moves]).tolist()
    step_counts['refills'] += refills
    step_counts['mrw_moves'] += mrw_moves
    carry.stats.flush()
    p = carry.packets
    killed_int = carry.killed_int + p.alive.sum() + (p.reemit_src >= 0).sum()
    return (carry.stats.energy_sum, carry.energy_current,
            carry.stats.n_photons_cell, killed_int, carry.killed_geo,
            n_steps, carry.energy_sum_spec, carry.n_events)


def run_lucy_iteration(geometry, dt, st, density, jnu_var_id, jnu_var_frac,
                       generator, n_photons, batch_size, config, mrw=None,
                       spec_bins=None, spec_bin_frac=None, se_rho=None):
    """One Lucy iteration on one device: on a CUDA device as replays of a
    CUDA graph of GRAPH_STEPS steps (:func:`drive_graph`), on the CPU one
    eager step at a time (:func:`drive_steps`).

    Returns (energy_sum (n_dust, n_cells), energy_current, n_photons_cell,
    killed_int, killed_geo, n_steps, energy_sum_spec (n_dust, n_bins,
    n_cells), n_events), the tuple of the JAX ``lucy_iteration_impl``;
    n_steps a host int, the others tensors."""
    carry, step = start_lucy_iteration(
        geometry, dt, st, density, jnu_var_id, jnu_var_frac, n_photons,
        batch_size, config, mrw=mrw, spec_bins=spec_bins,
        spec_bin_frac=spec_bin_frac, se_rho=se_rho)
    max_steps = int(config['max_steps'])
    drive = drive_graph if density.device.type == 'cuda' else drive_steps
    _, n_steps = drive(carry, step, generator, max_steps)
    return finish_lucy_iteration(carry, n_steps)
