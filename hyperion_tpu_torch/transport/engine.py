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
iteration's generator; the physics functions take uniforms. The loop is
driven from the host and reads the device once per step: the alive count,
and with source re-absorption the count of photons waiting for
re-emission in the same read. The MRW branch is computed masked in every
step of an MRW run (a gate on "any lane jumps" would need a second read).
Map sources place their photons in the grid's cells, and a map with an
LTE spectrum draws its frequencies from the dust emissivity there
(``se_rho``, the specific energy times the density of the previous
iteration)."""

import math
from dataclasses import dataclass

import torch

from .deposit_visit import DepositVisit
from .gtable import ESCAPED
from .mrw import sample_min09
from .sampling import (interp_loglog, isotropic_direction, random_exp,
                       rotate_direction, sample_quantile_rows)
from .stable import (N_EMIT_EXTRA, emit_packets, nearest_source_intersection,
                     pick_sources)

# rows of the per-step uniform draw: refill (emission), the step, then the
# sphere emission's and the MRW move's, then for map, box and beam sources
# the N_EMIT_EXTRA rows of stable.E_* from U_EM_EXTRA; a step draws only the
# rows its model uses, so a point-source model without MRW draws the first
# 15
(U_SRC, U_EM_NU, U_EM_MU, U_EM_PHI, U_EM_TAU,
 U_CHECK, U_DUST, U_COIN, U_BIN, U_XI, U_DIR_MU, U_DIR_PHI, U_MU, U_PHI,
 U_TAU,
 U_EM_CAP, U_EM_CAP_PHI, U_EM_OUT, U_EM_OUT_PHI,
 U_MRW_Y, U_MRW_JUMP_MU, U_MRW_JUMP_PHI, U_MRW_DIR_MU, U_MRW_DIR_PHI,
 U_MRW_DUST, U_MRW_BIN, U_MRW_XI) = range(27)
N_UNIFORMS = 27
U_EM_EXTRA = N_UNIFORMS


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
    # host integers: the budget and uid counter change only at refills,
    # by the host-known number of refilled lanes; n_alive and n_pending
    # (photons waiting for re-emission by their source) are the step's
    # one read of the device
    budget: int
    uid_counter: int
    n_alive: int
    n_pending: int
    n_steps: int
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
    draw from (0 or N_EMIT_EXTRA) and :func:`~.stable.emit_packets`'
    keywords besides them: the geometry for map cells, and for LTE spectra
    the context of the dust emissivity (``se_rho`` None: zero, the first
    iteration's uniform dust pick)."""
    kw = dict(geometry=geometry)
    if st.has_lte:
        kw['lte_ctx'] = (dt, jnu_var_id, jnu_var_frac,
                         torch.zeros_like(jnu_var_frac) if se_rho is None
                         else se_rho)
    return (N_EMIT_EXTRA if st.has_extra else 0), kw


def make_lucy_step(geometry, dt, st, density, jnu_var_id, jnu_var_frac,
                   config, mrw=None, spec_bins=None, spec_bin_frac=None,
                   se_rho=None):
    """The step of one Lucy iteration: ``step(carry, generator)`` advances
    the carry by one step, in place.

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

    def refill(carry, u):
        """Emit fresh packets into dead lanes while budget remains
        (replaces the reference's chunk scheduler), and re-emit photons
        re-absorbed by a source from that source: they keep their energy,
        uid and interaction count (ref iter_lucy.f90:158-183), and one
        re-absorbed more than n_reabs_max times in a row is killed."""
        p = carry.packets
        B = p.x.shape[0]
        dead = ~p.alive
        if reabs_on:
            pending = p.reemit_src >= 0
            dead = dead & ~pending
        rank = torch.cumsum(dead, dim=0)
        can_fresh = dead & (rank <= carry.budget)
        n_new = min(B - carry.n_alive - carry.n_pending, carry.budget)
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
            return torch.where(mask if old.dim() == 1 else mask[:, None],
                               new_, old)

        # fresh photons take ids from the consumed-budget counter; int32
        # holds them (run_lucy caps the budget below 2**31 - 1)
        uid_new = (carry.uid_counter + rank).to(torch.int32)
        n_reabs, reemit_src = p.n_reabs, p.reemit_src
        if reabs_on:
            n_reabs = torch.where(can_fresh, 0, torch.where(
                reemit_ok, n_reabs + 1, n_reabs))
            reemit_src = torch.where(pending, -1, reemit_src)
        packets = PacketState(
            x=m(p.x, new['x']), y=m(p.y, new['y']), z=m(p.z, new['z']),
            kx=m(p.kx, new['kx']), ky=m(p.ky, new['ky']),
            kz=m(p.kz, new['kz']), nu=m(p.nu, new['nu']),
            energy=m(p.energy, new['energy'], can_fresh),
            cell=m(p.cell, cell_new),
            tau=m(p.tau, random_exp(u[U_EM_TAU])),
            n_inter=torch.where(can_fresh, 0, p.n_inter),
            n_mrw=torch.where(can, 0, p.n_mrw),
            n_reabs=n_reabs, reemit_src=reemit_src,
            uid=m(p.uid, uid_new, can_fresh),
            # photons emitted outside the grid simply escape (run_model
            # checks that point and sphere sources lie inside it)
            alive=p.alive | (can & (cell_new != ESCAPED)),
            chi=m(p.chi, chi_n), kappa=m(p.kappa, kappa_n),
            albedo=m(p.albedo, alb_n))
        # the emission cell of a fresh photon counts as visited; no deposits
        emit_idx = torch.where(can_fresh & (cell_new != ESCAPED), cell_new,
                               n_cells)
        carry.stats(None, None, emit_idx, packets.uid)
        carry.packets = packets
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

    def step(carry, generator):
        p0 = carry.packets
        B = p0.x.shape[0]
        u = torch.rand((n_rows, B), generator=generator,
                       device=p0.x.device, dtype=dtype)
        # refill only when >= 1/4 of the lanes are dead (or none is alive),
        # or a re-absorbed photon waits: a refill is an emission pass over
        # every lane
        if (carry.budget > 0 and (carry.n_alive * 4 <= 3 * B or
                                  carry.n_alive == 0)) or carry.n_pending:
            refill(carry, u)
        p = carry.packets

        cell_safe = p.cell.clamp_min(0)
        rho_rows = rho_t[cell_safe]
        vid_rows = vid_t[cell_safe]
        vfrac_rows = vfrac_t[cell_safe]
        x, y, z, kx, ky, kz = p.x, p.y, p.z, p.kx, p.ky, p.kz
        nu, chi, kappa, albedo = p.nu, p.chi, p.kappa, p.albedo
        cell, n_mrw, alive = p.cell, p.n_mrw, p.alive
        active = alive

        # --- modified random walk (ref iter_lucy.f90:138-152): lanes deep
        # in a cell jump; their deposits go to the cell they jump from ---
        mrw_deps = None
        if mrw is not None:
            alpha_inv = alpha_t[cell_safe]
            d_close = geometry.closest_wall_distance(cell_safe, x, y, z)
            mrw_now = alive & (p.n_inter >= 1) & \
                (alpha_inv * d_close > mrw.gamma)
            mrw_deps, x_m, y_m, z_m, (nkx, nky, nkz), nu_m, chi_m, \
                kappa_m, alb_m = mrw_jump_update(
                    dt, mrw, u[U_MRW_Y:U_MRW_XI + 1], mrw_now, x, y, z,
                    p.energy, chi, d_close, alpha_inv, kp_t[cell_safe],
                    rho_rows, vid_rows, vfrac_rows)
            n_mrw = n_mrw + mrw_now.to(torch.int32)
            killed_mrw = mrw_now & (n_mrw > n_mrw_max)
            # the jump sphere touches the nearest wall: locate with the
            # new direction so that a tangent landing picks its side
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
            alive = alive & ~killed_mrw
            carry.killed_int += killed_mrw.sum()
            # lanes that jumped skip the propagation below
            active = alive & ~mrw_now

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

        carry.packets = PacketState(
            x=x, y=y, z=z, kx=kx, ky=ky, kz=kz, nu=evt['nu'],
            energy=p.energy, cell=cell, tau=tau, n_inter=n_inter,
            n_mrw=n_mrw, n_reabs=n_reabs, reemit_src=reemit_src, uid=p.uid,
            alive=alive, chi=evt['chi'], kappa=kappa, albedo=albedo)
        carry.killed_int += killed_now.sum()
        carry.n_events += (moving | mrw_now).sum() if mrw is not None \
            else moving.sum()
        carry.n_steps += 1
        # the step's one host synchronisation
        if reabs_on:
            carry.n_alive, carry.n_pending = torch.stack(
                [alive.sum(), (reemit_src >= 0).sum()]).tolist()
        else:
            carry.n_alive = int(alive.sum())

    return step


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
    return LucyCarry(
        packets=packets, budget=int(n_photons), uid_counter=0, n_alive=0,
        n_pending=0, n_steps=0, energy_current=zeros(dtype=torch.float64),
        stats=DepositVisit(n_dust, n_cells, device, dtype),
        energy_sum_spec=zeros(n_dust, n_bins, n_cells),
        killed_int=zeros(dtype=torch.int64),
        killed_geo=zeros(dtype=torch.int64),
        n_events=zeros(dtype=torch.int64))


def run_lucy_iteration(geometry, dt, st, density, jnu_var_id, jnu_var_frac,
                       generator, n_photons, batch_size, config, mrw=None,
                       spec_bins=None, spec_bin_frac=None, se_rho=None):
    """One Lucy iteration on one device.

    Returns (energy_sum (n_dust, n_cells), energy_current, n_photons_cell,
    killed_int, killed_geo, n_steps, energy_sum_spec (n_dust, n_bins,
    n_cells), n_events), the tuple of the JAX ``lucy_iteration_impl``."""
    n_bins = 0 if spec_bins is None else spec_bins.shape[0] - 1
    carry = _init_lucy_carry(dt, density, n_photons, batch_size, n_bins)
    step = make_lucy_step(geometry, dt, st, density, jnu_var_id,
                          jnu_var_frac, config, mrw=mrw, spec_bins=spec_bins,
                          spec_bin_frac=spec_bin_frac, se_rho=se_rho)
    max_steps = int(config['max_steps'])
    while (carry.budget > 0 or carry.n_alive > 0 or carry.n_pending > 0) \
            and carry.n_steps < max_steps:
        step(carry, generator)
    # lanes still alive (or waiting for re-emission) at max_steps are
    # killed (the bounded-step safety net)
    p = carry.packets
    killed_int = carry.killed_int + p.alive.sum() + (p.reemit_src >= 0).sum()
    return (carry.stats.energy_sum, carry.energy_current,
            carry.stats.n_photons_cell, killed_int, carry.killed_geo,
            carry.n_steps, carry.energy_sum_spec, carry.n_events)
