"""The Lucy iteration with the grid cut into slabs over the ranks, photons
passed round a ring (counterpart of ``hyperion_tpu/parallel/spatial.py``).

Each rank owns a contiguous slab of cell ids: its density, emissivity
locator, MRW per-cell tables and accumulators are the slab's alone, and
deposits touch only them. Geometry and sources are replicated. A rank
keeps two pools of B lanes:

- the **resident pool**: photons being propagated; only lanes whose cell
  lies in the slab advance, the others wait to emigrate;
- the **transit pool**: photons between ranks; the whole pool moves one
  hop round the ring (to rank + 1) every step.

A step is the JAX package's: ``refill`` (fresh photons into dead resident
lanes, re-absorbed photons re-emitted from their source), ``physics`` (one
local event: the MRW gate, the walk to the next wall or interaction, the
deposit, the interaction; the single-event physics is the engine's own
``interaction_update``, ``mrw_jump_update`` and
``update_optical_constants``), then ``exchange``: the ring hop, arrivals
for this slab swapped with residents waiting to leave (without the swap
the ring can gridlock, every resident waiting to leave and every transit
lane waiting to land), and the remaining foreign residents boarding free
transit slots. Every move pairs the k-th lane of one mask with the k-th
of another (:func:`rank_match_move`), so shapes stay fixed. A pool is one
float block and one int block, so a hop is two messages. Liveness is one
sum all-reduce a step; the step's one local read of the device gives the
counts the next refill needs.

``n_cells`` need not divide the world: the cell axis is padded with cells
of no dust, which no photon ever enters. At the end every rank gathers the
slabs into the full accumulators. As in the JAX package, ``n_photons_cell``
counts wall entries rather than unique photons, and the iteration reports
no geometry self-check kills and no event count (both 0)."""

import torch

from ..transport.engine import (
    N_UNIFORMS, U_BIN, U_COIN, U_DIR_MU, U_DIR_PHI, U_DUST, U_EM_CAP,
    U_EM_CAP_PHI, U_EM_EXTRA, U_EM_MU, U_EM_NU, U_EM_OUT, U_EM_OUT_PHI,
    U_EM_PHI, U_EM_TAU, U_MRW_XI, U_MRW_Y, U_MU, U_PHI, U_SRC, U_TAU, U_XI,
    emit_options, interaction_update, mrw_jump_update,
    update_optical_constants)
from ..transport.gtable import ESCAPED
from ..transport.sampling import random_exp
from ..transport.stable import (emit_packets, nearest_source_intersection,
                                pick_sources)
from .mesh import all_gather_cat, all_reduce, reduce_ints, ring_hop, share

# the rows of a pool's float block (then chi, kappa and albedo, n_dust
# rows each) and of its int32 block
X, Y, Z, KX, KY, KZ, NU, ENERGY, TAU = range(9)
N_FLOAT = 9
CELL, N_INTER, N_MRW, N_REABS, REEMIT, ALIVE = range(6)
N_INT = 6


def rank_match_move(src_mask, dst_mask):
    """Pair the k-th True lane of ``src_mask`` with the k-th True lane of
    ``dst_mask``: returns (src_ok, dst_idx), whether each lane's photon
    moves and the lane it moves to (B for lanes that do not move). JAX
    ``_rank_match_move``, with no host read."""
    B = src_mask.shape[0]
    # the True lanes of dst_mask first, in lane order
    dst_positions = torch.sort((~dst_mask).to(torch.int8), stable=True)[1]
    src_rank = torch.cumsum(src_mask, 0) - 1
    src_ok = src_mask & (src_rank < dst_mask.sum())
    dst_idx = torch.where(src_ok, dst_positions[src_rank.clamp(0, B - 1)],
                          B)
    return src_ok, dst_idx


def _write(pool, values, dst_idx):
    """``pool`` (a (float, int) block pair) with the lanes of ``values``
    whose ``dst_idx`` is below B written at those lanes."""
    B = pool[0].shape[1]
    src = torch.full((B + 1,), B, dtype=torch.int64, device=dst_idx.device)
    # the lanes that do not move all land on the spare slot B
    src.scatter_(0, dst_idx, torch.arange(B, device=dst_idx.device))
    src = src[:B]
    has = src < B
    src = src.clamp_max(B - 1)
    return tuple(torch.where(has, v[:, src], p) for p, v in zip(pool, values))


def _pad_cells(a, n_pad):
    """Pad the last (cell) axis with zeros to ``n_pad``."""
    extra = n_pad - a.shape[-1]
    if extra == 0:
        return a
    return torch.cat([a, a.new_zeros(a.shape[:-1] + (extra,))], dim=-1)


def run_lucy_iteration_spatial(group, geometry, dt, st, density, jnu_var_id,
                               jnu_var_frac, generator, n_photons,
                               batch_size, config, mrw=None, spec_bins=None,
                               spec_bin_frac=None, se_rho=None):
    """One Lucy iteration with the grid cut into slabs over the group's
    ranks (each rank calls it with the whole grid's arrays and its own
    ``generator``; it keeps only its slab on the device for the steps).
    ``config`` as :func:`..transport.engine.make_lucy_step`'s (no geometry
    self-check here). Returns (energy_sum (n_dust, n_cells), energy_current,
    n_photons_cell (wall entries), killed_int, n_steps, energy_sum_spec
    (n_dust, n_bins, n_cells)), the same on every rank."""
    world, me = group.world, group.rank
    n_dust, n_cells = density.shape
    dtype, device = density.dtype, density.device
    B = int(batch_size)
    n_pad = n_cells + (-n_cells) % world
    slab = n_pad // world
    offset = me * slab
    cells = slice(offset, offset + slab)

    def local_t(a):
        return _pad_cells(a, n_pad)[:, cells].T.contiguous()

    rho_t, vid_t, vfrac_t = (local_t(a) for a in (density, jnu_var_id,
                                                   jnu_var_frac))
    n_inter_max = int(config['n_inter_max'])
    kill_on_scatter = bool(config['kill_on_scatter'])
    kill_on_absorb = bool(config['kill_on_absorb'])
    reabs_on = bool(config.get('source_intersect', False))
    n_reabs_max = int(config.get('n_reabs_max', 0))
    max_steps = int(config['max_steps'])
    sphere = st.has_sphere
    n_extra, emit_kw = emit_options(geometry, dt, st, jnu_var_id,
                                    jnu_var_frac, se_rho)
    n_rows = N_UNIFORMS + n_extra if n_extra or mrw is not None else \
        U_EM_OUT_PHI + 1 if sphere else U_TAU + 1
    if mrw is not None:
        n_mrw_max = int(config['n_mrw_max'])
        alpha_l = _pad_cells(mrw.alpha_inv_planck[None], n_pad)[0, cells]
        kp_t = local_t(mrw.kappa_planck)
    spec_on = spec_bins is not None
    n_bins = spec_bins.shape[0] - 1 if spec_on else 0
    dust_off = (torch.arange(n_dust, device=device) * slab)[None, :]
    if spec_on:
        dust_bin0 = torch.arange(n_dust, device=device) * n_bins
        if mrw is not None and spec_bin_frac is not None:
            mrw_bins = (dust_bin0[:, None] + torch.arange(
                n_bins, device=device)[None, :]) * slab
            var0 = torch.arange(n_dust, device=device) * dt.n_var

    energy_sum = torch.zeros((n_dust, slab), dtype=dtype, device=device)
    energy_spec = torch.zeros((n_dust, n_bins, slab), dtype=dtype,
                              device=device)
    npc = torch.zeros(slab, dtype=torch.int64, device=device)
    energy_current = torch.zeros((), dtype=torch.float64, device=device)
    killed_int = torch.zeros((), dtype=torch.int64, device=device)

    def owner(cell):
        return torch.where(cell >= 0, cell // slab, -1)

    def empty_pool():
        f = torch.zeros((N_FLOAT + 3 * n_dust, B), dtype=dtype, device=device)
        f[KZ] = 1.0
        f[NU] = 1.0
        i = torch.zeros((N_INT, B), dtype=torch.int32, device=device)
        i[CELL] = ESCAPED
        i[REEMIT] = -1
        return f, i

    res = empty_pool()
    trans = empty_pool()
    budget = share(int(n_photons), me, world)
    n_res_alive = n_pending = 0
    n_steps = 0

    def chi_block(f):
        return tuple(f[N_FLOAT + k * n_dust:N_FLOAT + (k + 1) * n_dust].T
                     for k in range(3))

    def refill(res, u):
        """Fresh photons into dead resident lanes while the budget lasts,
        and re-absorbed photons re-emitted from their source keeping their
        energy (ref iter_lucy.f90:158-183); photons born in another slab
        leave at this step's exchange."""
        nonlocal budget, energy_current, killed_int
        f, i = res
        alive = i[ALIVE] != 0
        dead = ~alive
        if reabs_on:
            pending = i[REEMIT] >= 0
            dead = dead & ~pending
        rank = torch.cumsum(dead, 0)
        can_fresh = dead & (rank <= budget)
        n_new = min(B - n_res_alive - n_pending, budget)
        src = None
        can = can_fresh
        if reabs_on:
            reabs_kill = pending & (i[N_REABS] + 1 > n_reabs_max)
            reemit_ok = pending & ~reabs_kill
            src = torch.where(reemit_ok, i[REEMIT].long(),
                              pick_sources(st, u[U_SRC]))
            can = can_fresh | reemit_ok
        u_sphere = (u[U_EM_CAP], u[U_EM_CAP_PHI], u[U_EM_OUT],
                    u[U_EM_OUT_PHI]) if sphere else None
        new = emit_packets(st, u[U_SRC], u[U_EM_NU], u[U_EM_MU], u[U_EM_PHI],
                           u_sphere, src=src,
                           u_extra=u[U_EM_EXTRA:] if n_extra else None,
                           **emit_kw)
        cell_new = geometry.find_cell(new['x'], new['y'], new['z'],
                                      new['kx'], new['ky'], new['kz'])
        chi_n, kappa_n, alb_n = update_optical_constants(dt, new['nu'])
        f_new = torch.cat([torch.stack(
            [new['x'], new['y'], new['z'], new['kx'], new['ky'], new['kz'],
             new['nu'], new['energy'], random_exp(u[U_EM_TAU])]),
            chi_n.T, kappa_n.T, alb_n.T])
        f_out = torch.where(can, f_new, f)
        # a re-emitted photon keeps its energy
        f_out[ENERGY] = torch.where(can_fresh, new['energy'], f[ENERGY])
        i_out = i.clone()
        i_out[CELL] = torch.where(can, cell_new.to(torch.int32), i[CELL])
        i_out[N_INTER] = torch.where(can_fresh, 0, i[N_INTER])
        i_out[N_MRW] = torch.where(can, 0, i[N_MRW])
        if reabs_on:
            i_out[N_REABS] = torch.where(can_fresh, 0, torch.where(
                reemit_ok, i[N_REABS] + 1, i[N_REABS]))
            i_out[REEMIT] = torch.where(pending, -1, i[REEMIT])
            killed_int = killed_int + reabs_kill.sum()
        # photons emitted outside the grid escape at once
        i_out[ALIVE] = (alive | (can & (cell_new != ESCAPED))).to(torch.int32)
        energy_current = energy_current + torch.where(
            can_fresh, new['energy'], 0.0).sum(dtype=torch.float64)
        budget -= n_new
        return f_out, i_out

    def spectrum_deposits(lcell, nu, dep_rows, mrw_deps, vid_rows,
                          vfrac_rows):
        """The step's deposits binned by frequency, and the MRW deposits
        spread over the bins by the local emissivity (the engine's
        ``spectrum_deposits`` on the slab)."""
        ibin = torch.searchsorted(
            spec_bins, torch.log2(nu.clamp_min(1e-30)).contiguous(),
            right=True) - 1
        bin_ok = (ibin >= 0) & (ibin < n_bins)
        idx = [((dust_bin0[None, :] + ibin.clamp(0, n_bins - 1)[:, None])
                * slab + lcell[:, None]).reshape(-1)]
        val = [torch.where(bin_ok[:, None], dep_rows, 0.0).reshape(-1)]
        if mrw_deps is not None and spec_bin_frac is not None:
            row0 = var0[None, :] + vid_rows
            row1 = var0[None, :] + (vid_rows + 1).clamp_max(dt.n_var - 1)
            vf = vfrac_rows[:, :, None]
            frac = (1.0 - vf) * spec_bin_frac[row0] + vf * spec_bin_frac[row1]
            idx.append((mrw_bins[None] + lcell[:, None, None]).reshape(-1))
            val.append((mrw_deps[:, :, None] * frac).reshape(-1))
        energy_spec.view(-1).index_add_(0, torch.cat(idx), torch.cat(val))

    def physics(res, u):
        """One local event for the resident lanes in this slab."""
        nonlocal killed_int
        f, i = res
        x, y, z, kx, ky, kz, nu = f[X], f[Y], f[Z], f[KX], f[KY], f[KZ], f[NU]
        energy, tau = f[ENERGY], f[TAU]
        chi, kappa, albedo = chi_block(f)
        cell = i[CELL].long()
        n_inter, n_mrw = i[N_INTER], i[N_MRW]
        alive = i[ALIVE] != 0
        local = alive & (owner(cell) == me)
        lcell = (cell - offset).clamp(0, slab - 1)
        cell_w = torch.where(local, cell, 0)
        rho_rows, vid_rows, vfrac_rows = rho_t[lcell], vid_t[lcell], \
            vfrac_t[lcell]
        active = local

        mrw_deps = None
        if mrw is not None:
            alpha_inv = alpha_l[lcell]
            d_close = geometry.closest_wall_distance(cell_w, x, y, z)
            mrw_now = local & (n_inter >= 1) & \
                (alpha_inv * d_close > mrw.gamma)
            mrw_deps, x_m, y_m, z_m, (nkx, nky, nkz), nu_m, chi_m, \
                kappa_m, alb_m = mrw_jump_update(
                    dt, mrw, u[U_MRW_Y:U_MRW_XI + 1], mrw_now, x, y, z,
                    energy, chi, d_close, alpha_inv, kp_t[lcell], rho_rows,
                    vid_rows, vfrac_rows)
            n_mrw = n_mrw + mrw_now.to(torch.int32)
            killed_mrw = mrw_now & (n_mrw > n_mrw_max)
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
            killed_int = killed_int + killed_mrw.sum()
            active = alive & local & ~mrw_now
            cell_w = torch.where(local, cell, 0)

        t_wall, next_cell, ax, wall_coord = geometry.find_wall(
            cell_w, x, y, z, kx, ky, kz)
        chi_rho = (chi * rho_rows).sum(dim=-1)
        tau_wall = chi_rho * t_wall
        hits_wall = (tau_wall < tau) | (chi_rho <= 0.0)
        t_int = torch.where(chi_rho > 0.0, tau / chi_rho.clamp_min(1e-300),
                            t_wall)
        d_move = torch.where(hits_wall, t_wall, t_int)

        moving = active
        if reabs_on:
            t_src, src_row = nearest_source_intersection(st, x, y, z, kx, ky,
                                                         kz)
            hits_src = active & (d_move > t_src)
            hits_wall = hits_wall & ~hits_src
            moving = active & ~hits_src

        dep_rows = torch.where(moving[:, None] & (rho_rows > 0.0),
                               d_move[:, None] * kappa * energy[:, None],
                               0.0)
        if spec_on:
            spectrum_deposits(lcell, nu, dep_rows, mrw_deps, vid_rows,
                              vfrac_rows)
        if mrw_deps is not None:
            dep_rows = dep_rows + mrw_deps
        energy_sum.view(-1).index_add_(
            0, (dust_off + lcell[:, None]).reshape(-1), dep_rows.reshape(-1))

        x = torch.where(moving, x + d_move * kx, x)
        y = torch.where(moving, y + d_move * ky, y)
        z = torch.where(moving, z + d_move * kz, z)
        crossed = moving & hits_wall
        x, y, z = geometry.snap(x, y, z, ax, wall_coord, crossed)
        tau = torch.where(moving, torch.where(hits_wall, tau - tau_wall, 0.0),
                          tau)
        cell = torch.where(crossed, next_cell, cell)
        escaped = crossed & (cell == ESCAPED)
        # wall entries into this slab's cells
        entered = crossed & (owner(cell) == me)
        npc.index_add_(0, (cell - offset).clamp(0, slab - 1),
                       entered.to(torch.int64))

        interacting = moving & ~hits_wall
        evt = interaction_update(
            dt, (u[U_DUST], u[U_COIN], u[U_BIN], u[U_XI], u[U_DIR_MU],
                 u[U_DIR_PHI], u[U_MU], u[U_PHI]),
            interacting, nu, kx, ky, kz, chi, albedo, rho_rows, vid_rows,
            vfrac_rows)
        absorbed = evt['absorbed']
        kx, ky, kz = evt['kx'], evt['ky'], evt['kz']
        kappa = torch.where(absorbed[:, None], evt['kappa_abs'], kappa)
        albedo = torch.where(absorbed[:, None], evt['albedo_abs'], albedo)
        cell_re = geometry.find_cell(x, y, z, kx, ky, kz)
        cell = torch.where(interacting & (cell_re != ESCAPED), cell_re, cell)
        tau = torch.where(interacting, random_exp(u[U_TAU]), tau)
        n_inter = n_inter + interacting.to(torch.int32)
        n_mrw = torch.where(interacting, 0, n_mrw)
        killed_now = interacting & (n_inter > n_inter_max)
        if kill_on_scatter:
            killed_now = killed_now | evt['scattered']
        if kill_on_absorb:
            killed_now = killed_now | absorbed
        alive = alive & ~escaped & ~killed_now
        n_reabs, reemit = i[N_REABS], i[REEMIT]
        if reabs_on:
            alive = alive & ~hits_src
            reemit = torch.where(hits_src, src_row.to(torch.int32), reemit)
            n_reabs = torch.where(interacting, 0, n_reabs)
        killed_int = killed_int + killed_now.sum()
        f = torch.cat([torch.stack([x, y, z, kx, ky, kz, evt['nu'], energy,
                                    tau]),
                       evt['chi'].T, kappa.T, albedo.T])
        i = torch.stack([cell.to(torch.int32), n_inter, n_mrw, n_reabs,
                         reemit, alive.to(torch.int32)])
        return f, i

    def foreign(pool):
        cell = pool[1][CELL].long()
        return (pool[1][ALIVE] != 0) & (cell != ESCAPED) & (owner(cell) != me)

    def exchange(res, trans):
        """The ring hop, arrivals swapped into this slab's resident lanes,
        the remaining foreign residents into free transit slots."""
        trans = tuple(ring_hop(group, list(trans)))
        res_alive = res[1][ALIVE] != 0
        pending = res[1][REEMIT] >= 0 if reabs_on else \
            torch.zeros_like(res_alive)
        away = foreign(res)
        arriving = (trans[1][ALIVE] != 0) & \
            (owner(trans[1][CELL].long()) == me)
        slots = (~res_alive & ~pending) | away
        a_ok, r_idx = rank_match_move(arriving, slots)
        r_safe = r_idx.clamp_max(B - 1)
        # the displaced residents take the arrivals' transit slots
        displaced = tuple(p[:, r_safe] for p in res)
        swapped = tuple(torch.where(a_ok, d, t)
                        for d, t in zip(displaced, trans))
        swapped[1][ALIVE] = torch.where(
            a_ok, (a_ok & away[r_safe]).to(torch.int32), trans[1][ALIVE])
        res = _write(res, trans, r_idx)
        s_ok, t_idx = rank_match_move(foreign(res), swapped[1][ALIVE] == 0)
        trans = _write(swapped, res, t_idx)
        res[1][ALIVE] = res[1][ALIVE] * (~s_ok).to(torch.int32)
        return res, trans

    while True:
        u = torch.rand((n_rows, B), generator=generator, device=device,
                       dtype=dtype)
        if (budget > 0 and (n_res_alive * 4 <= 3 * B or n_res_alive == 0)) \
                or n_pending:
            res = refill(res, u)
        res = physics(res, u)
        res, trans = exchange(res, trans)
        n_steps += 1
        counts = [res[1][ALIVE].sum(), (res[1][REEMIT] >= 0).sum(),
                  trans[1][ALIVE].sum()]
        n_res_alive, n_pending, n_trans = torch.stack(counts).tolist()
        live, = reduce_ints(group, [n_res_alive + n_pending + n_trans +
                                    budget])
        if live == 0 or n_steps >= max_steps:
            break

    # lanes still alive (or waiting for re-emission) at max_steps are
    # killed, the bounded-step safety net
    killed_int = killed_int + n_res_alive + n_pending + n_trans
    energy_current, killed_int = all_reduce(group, [energy_current,
                                                    killed_int])
    n_steps, = reduce_ints(group, [n_steps], 'max')
    energy_sum = all_gather_cat(group, energy_sum)[:, :n_cells]
    npc = all_gather_cat(group, npc)[:n_cells]
    energy_spec = all_gather_cat(group, energy_spec)[:, :, :n_cells]
    return energy_sum, energy_current, npc, killed_int, n_steps, energy_spec
