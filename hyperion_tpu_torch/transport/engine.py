"""The Lucy transport step of the port (counterpart of
``hyperion_tpu/transport/engine.py``).

The whole batch advances in lockstep, one cell event per lane per step: a
wall crossing, or an interaction (absorption and re-emission, or
scattering). Dead lanes are refilled from the photon budget inside the
loop. Each step deposits ds * kappa * E into the per-(dust, cell)
accumulator and counts unique-photon cell visits through the
``deposit_visit`` kernel.

All random numbers of a step are drawn in one ``torch.rand`` call from the
iteration's generator; the physics functions take uniforms. The loop is
driven from the host and reads one scalar per step (the alive count), which
serves both the refill gate and the end condition. The MRW, source
re-absorption, spectrum-binning, map and LTE branches of the JAX step are
not in this slice (``run_model`` refuses such models)."""

from dataclasses import dataclass

import torch

from .deposit_visit import DepositVisit
from .gtable import ESCAPED
from .sampling import (interp_loglog, isotropic_direction, random_exp,
                       rotate_direction, sample_quantile_rows)
from .stable import emit_packets

# rows of the per-step uniform draw: refill (emission), then the step
(U_SRC, U_EM_NU, U_EM_MU, U_EM_PHI, U_EM_TAU,
 U_CHECK, U_DUST, U_COIN, U_BIN, U_XI, U_DIR_MU, U_DIR_PHI, U_MU, U_PHI,
 U_TAU) = range(15)
N_UNIFORMS = 15


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
    cell: torch.Tensor      # (B,) int64 flat cell index, ESCAPED outside
    tau: torch.Tensor       # optical depth left to the next interaction
    n_inter: torch.Tensor   # (B,) int32 interaction count
    uid: torch.Tensor       # (B,) int32 photon id for the visit dedup
    alive: torch.Tensor     # (B,) bool
    chi: torch.Tensor       # (B, n_dust) extinction at nu
    kappa: torch.Tensor     # (B, n_dust) absorption at nu
    albedo: torch.Tensor    # (B, n_dust)


@dataclass
class LucyCarry:
    packets: PacketState
    # host integers: the budget and uid counter change only at refills,
    # by the host-known number of refilled lanes
    budget: int
    uid_counter: int
    n_alive: int
    n_steps: int
    energy_current: torch.Tensor   # () float64
    # energy_sum (n_dust, n_cells) and the (n_cells,) int64 unique-photon
    # visit counts (ref last_photon_id dedup, grid_propagate_3d.f90:91-97)
    stats: DepositVisit
    killed_int: torch.Tensor       # () int64
    killed_geo: torch.Tensor       # () int64
    # lanes that moved (crossing or interaction): n_events/(n_steps*B) is
    # the alive-lane occupancy
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


def sample_emission_nu(dt, dust_id, var_id, var_frac, u_bin, u_xi):
    """Re-emission frequency: the bracketing specific-energy bin by a
    Bernoulli draw on var_frac, then one quantile-table inversion."""
    v = var_id + (u_bin < var_frac).to(var_id.dtype)
    rows = dust_id * dt.n_var + v.clamp_max(dt.n_var - 1)
    return sample_quantile_rows(dt.jnu_q, rows, u_xi, exp2=True)


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


def make_lucy_step(geometry, dt, st, density, jnu_var_id, jnu_var_frac,
                   config):
    """The step of one Lucy iteration: ``step(carry, generator)`` advances
    the carry by one step, in place.

    density, jnu_var_id/frac: (n_dust, n_cells), the emissivity locator
    from the previous iteration's specific energy (ref precompute_jnu_var,
    grid_physics_3d.f90:613-635). ``config``: n_inter_max, kill_on_scatter,
    kill_on_absorb, check_frequency."""
    n_cells = density.shape[1]
    dtype = density.dtype
    # per-cell rows, gathered by each lane's cell
    rho_t = density.T.contiguous()
    vid_t = jnu_var_id.T.contiguous()
    vfrac_t = jnu_var_frac.T.contiguous()
    n_inter_max = int(config['n_inter_max'])
    kill_on_scatter = bool(config['kill_on_scatter'])
    kill_on_absorb = bool(config['kill_on_absorb'])
    check_freq = float(config.get('check_frequency', 0.0))

    def refill(carry, u):
        """Emit fresh packets into dead lanes while budget remains
        (replaces the reference's chunk scheduler)."""
        p = carry.packets
        B = p.x.shape[0]
        dead = ~p.alive
        rank = torch.cumsum(dead, dim=0)
        can = dead & (rank <= carry.budget)
        n_new = min(B - carry.n_alive, carry.budget)
        new = emit_packets(st, u[U_SRC], u[U_EM_NU], u[U_EM_MU],
                           u[U_EM_PHI])
        cell_new = geometry.find_cell(new['x'], new['y'], new['z'],
                                      new['kx'], new['ky'], new['kz'])
        chi_n, kappa_n, alb_n = update_optical_constants(dt, new['nu'])

        def m(old, new_):
            return torch.where(can if old.dim() == 1 else can[:, None],
                               new_, old)

        # fresh photons take ids from the consumed-budget counter; int32
        # holds them (run_lucy caps the budget below 2**31 - 1)
        uid_new = (carry.uid_counter + rank).to(torch.int32)
        packets = PacketState(
            x=m(p.x, new['x']), y=m(p.y, new['y']), z=m(p.z, new['z']),
            kx=m(p.kx, new['kx']), ky=m(p.ky, new['ky']),
            kz=m(p.kz, new['kz']), nu=m(p.nu, new['nu']),
            energy=m(p.energy, new['energy']),
            cell=m(p.cell, cell_new),
            tau=m(p.tau, random_exp(u[U_EM_TAU])),
            n_inter=torch.where(can, 0, p.n_inter),
            uid=m(p.uid, uid_new),
            # photons emitted outside the grid simply escape (run_model
            # checks that sources lie inside it)
            alive=p.alive | (can & (cell_new != ESCAPED)),
            chi=m(p.chi, chi_n), kappa=m(p.kappa, kappa_n),
            albedo=m(p.albedo, alb_n))
        # the emission cell counts as visited; no deposits
        emit_idx = torch.where(can & (cell_new != ESCAPED), cell_new,
                               n_cells)
        carry.stats(None, None, emit_idx, packets.uid)
        carry.packets = packets
        carry.energy_current += torch.where(can, new['energy'], 0.0).sum(
            dtype=torch.float64)
        carry.budget -= n_new
        carry.uid_counter += n_new

    def step(carry, generator):
        p0 = carry.packets
        B = p0.x.shape[0]
        u = torch.rand((N_UNIFORMS, B), generator=generator,
                       device=p0.x.device, dtype=dtype)
        # refill only when >= 1/4 of the lanes are dead (or none is alive):
        # a refill is an emission pass over every lane
        if carry.budget > 0 and (carry.n_alive * 4 <= 3 * B or
                                 carry.n_alive == 0):
            refill(carry, u)
        p = carry.packets

        cell_safe = p.cell.clamp_min(0)
        rho_rows = rho_t[cell_safe]
        vid_rows = vid_t[cell_safe]
        vfrac_rows = vfrac_t[cell_safe]

        # --- distance to the next wall, optical depth through the cell ---
        t_wall, next_cell, ax, wall_coord = geometry.find_wall(
            cell_safe, p.x, p.y, p.z, p.kx, p.ky, p.kz)
        chi_rho = (p.chi * rho_rows).sum(dim=-1)
        tau_wall = chi_rho * t_wall
        hits_wall = (tau_wall < p.tau) | (chi_rho <= 0.0)
        t_int = torch.where(chi_rho > 0.0, p.tau / chi_rho.clamp_min(1e-300),
                            t_wall)
        d_move = torch.where(hits_wall, t_wall, t_int)
        moving = p.alive

        # --- deposit: specific_energy_sum += ds * kappa_d * E
        # (ref grid_propagate_3d.f90:153-154, 205-206) ---
        dep_rows = torch.where(moving[:, None] & (rho_rows > 0.0),
                               d_move[:, None] * p.kappa * p.energy[:, None],
                               0.0)

        # --- move, snapping wall crossers onto the wall ---
        x = torch.where(moving, p.x + d_move * p.kx, p.x)
        y = torch.where(moving, p.y + d_move * p.ky, p.y)
        z = torch.where(moving, p.z + d_move * p.kz, p.z)
        crossed = moving & hits_wall
        x, y, z = geometry.snap(x, y, z, ax, wall_coord, crossed)
        tau = torch.where(moving, torch.where(hits_wall, p.tau - tau_wall,
                                              0.0), p.tau)
        cell = torch.where(crossed, next_cell, p.cell)
        escaped = crossed & (cell == ESCAPED)

        # --- deposits and unique-visit counts of the entered cells ---
        enter_idx = torch.where(crossed & (cell != ESCAPED), cell, n_cells)
        carry.stats(cell_safe, dep_rows, enter_idx, p.uid)

        # --- interaction (absorb and re-emit, or scatter) ---
        interacting = moving & ~hits_wall
        evt = interaction_update(
            dt, (u[U_DUST], u[U_COIN], u[U_BIN], u[U_XI], u[U_DIR_MU],
                 u[U_DIR_PHI], u[U_MU], u[U_PHI]),
            interacting, p.nu, p.kx, p.ky, p.kz, p.chi, p.albedo, rho_rows,
            vid_rows, vfrac_rows)
        absorbed = evt['absorbed']
        scattered = evt['scattered']
        kx, ky, kz = evt['kx'], evt['ky'], evt['kz']
        kappa = torch.where(absorbed[:, None], evt['kappa_abs'], p.kappa)
        albedo = torch.where(absorbed[:, None], evt['albedo_abs'], p.albedo)

        # a packet whose tau ran out exactly on a wall may now point into
        # the cell on the other side: the direction-aware find_cell is the
        # on-wall disambiguation (ref adjust_wall)
        cell_re = geometry.find_cell(x, y, z, kx, ky, kz)
        cell = torch.where(interacting & (cell_re != ESCAPED), cell_re, cell)
        tau = torch.where(interacting, random_exp(u[U_TAU]), tau)
        n_inter = p.n_inter + interacting.to(torch.int32)

        killed_now = interacting & (n_inter > n_inter_max)
        if kill_on_scatter:
            killed_now = killed_now | scattered
        if kill_on_absorb:
            killed_now = killed_now | absorbed
        alive = p.alive & ~escaped & ~killed_now

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
            energy=p.energy, cell=cell, tau=tau, n_inter=n_inter, uid=p.uid,
            alive=alive, chi=evt['chi'], kappa=kappa, albedo=albedo)
        carry.killed_int += killed_now.sum()
        carry.n_events += moving.sum()
        carry.n_steps += 1
        # the step's one host synchronisation
        carry.n_alive = int(alive.sum())

    return step


def _init_lucy_carry(dt, density, n_photons, batch_size):
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
        uid=torch.full((B,), -1, dtype=torch.int32, device=device),
        alive=zeros(B, dtype=torch.bool),
        chi=zeros(B, n_dust), kappa=zeros(B, n_dust),
        albedo=zeros(B, n_dust))
    return LucyCarry(
        packets=packets, budget=int(n_photons), uid_counter=0, n_alive=0,
        n_steps=0, energy_current=zeros(dtype=torch.float64),
        stats=DepositVisit(n_dust, n_cells, device, dtype),
        killed_int=zeros(dtype=torch.int64),
        killed_geo=zeros(dtype=torch.int64),
        n_events=zeros(dtype=torch.int64))


def run_lucy_iteration(geometry, dt, st, density, jnu_var_id, jnu_var_frac,
                       generator, n_photons, batch_size, config):
    """One Lucy iteration on one device.

    Returns (energy_sum (n_dust, n_cells), energy_current, n_photons_cell,
    killed_int, killed_geo, n_steps, energy_sum_spec (n_dust, 0, n_cells),
    n_events), the tuple of the JAX ``lucy_iteration_impl``."""
    carry = _init_lucy_carry(dt, density, n_photons, batch_size)
    step = make_lucy_step(geometry, dt, st, density, jnu_var_id,
                          jnu_var_frac, config)
    max_steps = int(config['max_steps'])
    while (carry.budget > 0 or carry.n_alive > 0) and \
            carry.n_steps < max_steps:
        step(carry, generator)
    # lanes still alive at max_steps are killed (bounded-step safety net)
    killed_int = carry.killed_int + carry.packets.alive.sum()
    n_dust, n_cells = density.shape
    return (carry.stats.energy_sum, carry.energy_current,
            carry.stats.n_photons_cell,
            killed_int, carry.killed_geo, carry.n_steps,
            density.new_zeros((n_dust, 0, n_cells)), carry.n_events)
