"""The monochromatic (exact-frequency) imaging iteration of the port
(counterpart of ``hyperion_tpu/transport/mono.py``; ref
src/main/iter_final_mono.f90:58-343, src/grid/grid_monochromatic.f90:
50-176).

For each frequency two passes run: source photons, emitted as usual but at
the frequency, each with the source's normalized spectral density there
(ref source_emit, source_type.f90:441-476); and dust photons, from a cell
picked on a per-dust CDF ∝ j_nu(nu; E_cell) E_abs(cell), leaving a random
point of the cell isotropically. Both propagate with forced scattering:
every interaction scatters (polarized, as in the imaging iteration) and
multiplies the energy by the albedo, and a packet dies when its energy
falls below ``energy_threshold`` of its initial one (ref
iter_final_mono.f90:335-338). Emissions and scatterings peel into the
frequency's index of the cubes, through ``imaging.peel_and_bin`` and its
one escape-tau walk per event. Each pass runs with raw energies into its
own float64 cubes on the device (a point source's direct light puts every
photon's same weight into one bin), which are scaled (sources:
energy_total / n; dust: 1, the photons carrying their share) and summed.

The step follows ``imaging.make_final_step``: one ``(n_rows, B)`` block of
uniforms per step from a ``torch.Generator``, the counters on the device,
the refill under the imaging step's device gate (``engine.run_if``: in a
CUDA graph a conditional node skipped where the gate is false, eagerly
masked), the lanes written in place and no host read inside a step; no
event is gated on an ``any()``. Each pass builds its own step, and on a
CUDA device runs as replays of its own CUDA graph of
``engine.GRAPH_STEPS`` steps (the host reading the counters once a
replay), on the CPU one step at a time.
The host tables (:func:`source_mono_energies`,
:func:`dust_mono_cell_pdfs`) are numpy."""

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..parallel.mesh import run_mono_pass_sharded
from .engine import (drive_graph, drive_steps, mono_step_counts, own_carry,
                     put, put_where, run_refill, select_dust,
                     update_optical_constants)
from .ffi import sample_first_interaction
from .gtable import ESCAPED, position_uniforms
from .imaging import PeelAccum, Provenance, peel_and_bin
from .raytrace import sample_position_in_cell
from .sampling import isotropic_direction, random_exp
from .stable import emit_extra_rows, emit_packets, \
    nearest_source_intersection, per_row, pick_sources
from .stokes import sample_scatter_stokes

# rows of the per-step uniforms: the refill's (the source pick, the drawn
# frequency, which mono ignores, the direction, the first depth, the forced
# first interaction, the stellar surface; the dust pick, its cell, the
# position in it and the direction), then the step's
(U_SRC, U_EM_NU, U_EM_MU, U_EM_PHI, U_EM_TAU, U_FFI,
 U_EM_CAP, U_EM_CAP_PHI, U_EM_OUT, U_EM_OUT_PHI,
 U_DUST_PICK, U_CELL, U_POS_X, U_POS_Y, U_POS_Z, U_DIR_MU, U_DIR_PHI,
 U_DUST, U_MU, U_PHI, U_TAU) = range(21)
N_UNIFORMS = 21
# then, for map, box and beam sources, the rows of stable.E_*
# (stable.emit_extra_rows); on a Voronoi grid the dust pass's positions take
# the rows after those too (gtable.position_uniforms)
U_EM_EXTRA = N_UNIFORMS


def source_mono_energies(sources, frequencies):
    """(n_rows, n_freq) spectral densities per emission row (the rows of
    ``build_source_tables``): a tabulated spectrum's fnu / int(fnu dnu)
    interpolated at nu, 0 outside it; a blackbody's pi B_nu / (sigma T^4)
    (ref normalized_B_nu, source_type.f90:1088)."""
    from ..util.constants import pi, sigma
    from ..util.functions import B_nu
    from ..util.integrate import integrate_loglog

    frequencies = np.asarray(frequencies, float)

    def one(s):
        if s.spectrum is not None:
            nu = np.asarray(s.spectrum['nu'], float)
            fnu = np.asarray(s.spectrum['fnu'], float)
            norm = integrate_loglog(nu, fnu)
            return np.interp(frequencies, nu, fnu / norm, left=0.0,
                             right=0.0)
        if s.temperature is not None:
            return pi * B_nu(frequencies, s.temperature) / \
                (sigma * s.temperature ** 4)
        raise ValueError("LTE-spectrum sources are not supported in "
                         "monochromatic mode")

    return np.asarray(per_row(sources, one))


def dust_mono_cell_pdfs(dusts, density, volumes, specific_energy,
                        frequencies):
    """Per (frequency, dust) cell CDFs of the thermal emission: weight(cell)
    = prob_nu(cell) E_abs(cell), prob_nu the normalized j_nu at nu, log10
    interpolated between the cell's two specific-energy bins (ref
    dust_sample_emit_probability, dust_type_4elem.f90:356-375). Returns
    (cell_cdf (n_freq, n_dust, n_cells), mean_prob (n_freq, n_dust),
    energy_abs_tot (n_dust,)), float64 numpy; a copy of the JAX package's."""
    from ..util.integrate import integrate_loglog

    frequencies = np.asarray(frequencies, float)
    density = np.asarray(density, float)
    volumes = np.asarray(volumes, float)
    specific_energy = np.asarray(specific_energy, float)
    n_dust, n_cells = density.shape
    n_freq = len(frequencies)

    cell_cdf = np.zeros((n_freq, n_dust, n_cells))
    mean_prob = np.zeros((n_freq, n_dust))
    energy_abs_tot = np.zeros(n_dust)

    for d_id, d in enumerate(dusts):
        em = d.emissivities
        enu = np.asarray(em.nu, float)
        jnu = np.asarray(em.jnu, float)          # (n_enu, n_var)
        var = np.asarray(em.var, float)
        norms = np.array([integrate_loglog(enu, jnu[:, i])
                          for i in range(jnu.shape[1])])
        pdf = jnu / np.maximum(norms[None, :], 1e-300)

        e = specific_energy[d_id]
        E_abs = e * density[d_id] * volumes
        energy_abs_tot[d_id] = E_abs.sum()
        if energy_abs_tot[d_id] <= 0:
            continue

        # the var bins (the rule of compute_jnu_var)
        i = np.clip(np.searchsorted(var, e, side='right') - 1, 0,
                    len(var) - 2)
        with np.errstate(divide='ignore', invalid='ignore'):
            frac = (np.log10(np.maximum(e, 1e-300)) - np.log10(var[i])) / \
                   (np.log10(var[i + 1]) - np.log10(var[i]))
        below, above = e < var[0], e > var[-1]
        i = np.where(below, 0, np.where(above, len(var) - 2, i))
        frac = np.clip(np.where(below, 0.0, np.where(above, 1.0, frac)),
                       0.0, 1.0)

        for f_id, nu in enumerate(frequencies):
            pdf_at_nu = np.array([np.interp(nu, enu, pdf[:, v],
                                            left=0.0, right=0.0)
                                  for v in range(pdf.shape[1])])
            prob1 = pdf_at_nu[i]
            prob2 = pdf_at_nu[np.minimum(i + 1, pdf.shape[1] - 1)]
            with np.errstate(divide='ignore'):
                prob = np.where(
                    (prob1 > 0) & (prob2 > 0),
                    10.0 ** (np.log10(np.maximum(prob1, 1e-300)) + frac *
                             (np.log10(np.maximum(prob2, 1e-300)) -
                              np.log10(np.maximum(prob1, 1e-300)))),
                    0.0)
            w = prob * E_abs
            mean_prob[f_id, d_id] = w.mean() * n_cells / \
                max(energy_abs_tot[d_id], 1e-300)
            tot = w.sum()
            if tot > 0:
                cell_cdf[f_id, d_id] = np.cumsum(w) / tot
                cell_cdf[f_id, d_id, -1] = 1.0
    return cell_cdf, mean_prob, energy_abs_tot


@dataclass
class MonoPacketState:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    kx: torch.Tensor
    ky: torch.Tensor
    kz: torch.Tensor
    energy: torch.Tensor
    energy_initial: torch.Tensor
    cell: torch.Tensor         # (B,) int64, ESCAPED outside
    tau: torch.Tensor
    n_inter: torch.Tensor      # (B,) int32
    n_reabs: torch.Tensor      # (B,) int32 successive source re-absorptions
    reemit_src: torch.Tensor   # (B,) int64 source row to re-emit from, -1
    alive: torch.Tensor
    reprocessed: torch.Tensor
    scattered: torch.Tensor
    source_id: torch.Tensor    # (B,) int64
    dust_id: torch.Tensor      # (B,) int64
    n_scat: torch.Tensor       # (B,) int64
    q: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


@dataclass
class MonoCarry:
    packets: MonoPacketState
    # () int64 device counters, as in the imaging carry (engine.COUNTERS;
    # the carry owns its lanes and counters, engine.own_carry)
    budget: torch.Tensor
    n_alive: torch.Tensor
    n_pending: torch.Tensor
    n_steps: torch.Tensor
    accums: list
    killed_int: torch.Tensor   # () int64
    n_events: torch.Tensor     # () int64, lanes that moved
    # () int64 device count of the refills that ran (engine.run_if)
    refills: torch.Tensor = 0

    def __post_init__(self):
        own_carry(self)


def _init_mono_carry(groups, n_photons, batch_size, device, dtype):
    B = int(batch_size)

    def zeros(dtype=dtype):
        return torch.zeros(B, dtype=dtype, device=device)

    packets = MonoPacketState(
        x=zeros(), y=zeros(), z=zeros(), kx=zeros(), ky=zeros(),
        kz=torch.ones(B, dtype=dtype, device=device), energy=zeros(),
        energy_initial=zeros(), cell=zeros(torch.int64), tau=zeros(),
        n_inter=zeros(torch.int32), n_reabs=zeros(torch.int32),
        reemit_src=torch.full((B,), -1, dtype=torch.int64, device=device),
        alive=zeros(torch.bool), reprocessed=zeros(torch.bool),
        scattered=zeros(torch.bool), source_id=zeros(torch.int64),
        dust_id=zeros(torch.int64), n_scat=zeros(torch.int64), q=zeros(),
        u=zeros(), v=zeros())
    # float64 cubes: a point source's direct light adds the same weight
    # into one bin for every photon, and in float32 each of 10^5 such adds
    # can round the same way by up to half a unit of 2^-24 of the sum
    return MonoCarry(packets=packets, budget=n_photons, n_alive=0,
                     n_pending=0, n_steps=0,
                     accums=[PeelAccum(g, device, torch.float64)
                             for g in groups],
                     killed_int=torch.zeros((), dtype=torch.int64,
                                            device=device),
                     n_events=torch.zeros((), dtype=torch.int64,
                                          device=device))


def make_mono_step(geometry, walk, dt, st, density, groups, config, mode,
                   f_id, nu_value, chi_vec, albedo_vec, src_energy=None,
                   cell_cdf=None, mean_prob=None):
    """The step of one pass at one frequency: ``step(carry, generator)``
    advances a :class:`MonoCarry` in place, reading nothing on the host;
    ``step.draw``, ``step.refill`` and ``step.counts`` as the imaging
    step's, and after the pass's end a step changes nothing. ``mode``
    'source' (with
    ``src_energy`` (n_rows,), each row's energy at the frequency) or 'dust'
    (with ``cell_cdf`` (n_dust, n_cells) and ``mean_prob`` (n_dust,), each
    dust's photon energy); ``f_id`` the frequency's index in the model's
    list, ``nu_value`` the frequency, ``chi_vec`` and ``albedo_vec``
    (n_dust,) the dusts' opacities there. ``walk``: the grid's
    :class:`~.escape_tau.EscapeTau`."""
    n_dust, n_cells = density.shape
    dtype = density.dtype
    rho_t = walk.rho_t
    ffi = bool(config['forced_first_interaction'])
    ffi_algorithm = str(config.get('ffi_algorithm', 'wr99'))
    ffi_xi = float(config.get('ffi_baes16_xi', 0.5))
    threshold = float(config['energy_threshold'])
    scat_only = bool(config['peeloff_scattering_only'])
    reabs_on = bool(config.get('source_intersect', False))
    n_reabs_max = int(config.get('n_reabs_max', 0))
    n_inter_max = int(config['n_inter_max'])
    kill_on_scatter = bool(config['kill_on_scatter'])
    sphere = st.has_sphere
    n_extra = emit_extra_rows(st, geometry) if mode == 'source' else 0
    # the dust pass's position uniforms after U_POS_X-U_POS_Z
    n_pos = geometry.POSITION_ROWS - 3 if mode == 'dust' else 0
    lanes = {}

    def consts(B, device):
        """The lanes' frequency and chi rows, the same for every lane."""
        if B not in lanes:
            lanes[B] = (
                torch.full((B,), nu_value, dtype=dtype, device=device),
                chi_vec[None, :].expand(B, n_dust).contiguous())
        return lanes[B]

    def emit_sources(u, src):
        new = emit_packets(st, u[U_SRC], u[U_EM_NU], u[U_EM_MU], u[U_EM_PHI],
                           (u[U_EM_CAP], u[U_EM_CAP_PHI], u[U_EM_OUT],
                            u[U_EM_OUT_PHI]) if sphere else None, src=src,
                           u_extra=u[U_EM_EXTRA:] if n_extra else None,
                           geometry=geometry)
        for k in ('x', 'y', 'z'):
            new[k] = new[k].contiguous()
        return new

    def refill(carry, u, gate):
        """Emit fresh photons into dead lanes and re-emit the waiting
        ones, computed over every lane; ``gate`` (a () bool) masks the
        whole refill off, which then changes nothing."""
        p = carry.packets
        B = p.x.shape[0]
        nu, chi_rows = consts(B, p.x.device)
        dead = ~p.alive
        if reabs_on:
            pending = (p.reemit_src >= 0) & gate
            dead = dead & ~pending
        rank = torch.cumsum(dead, dim=0)
        can_fresh = dead & (rank <= carry.budget) & gate
        n_new = torch.minimum(B - carry.n_alive - carry.n_pending,
                              carry.budget) * gate
        reemit_ok = None
        if reabs_on:
            # re-emitted at the same frequency with the photon's energy (ref
            # iter_final_mono.f90:289-295: emit(reemit, inu=p%inu))
            reabs_kill = pending & (p.n_reabs + 1 > n_reabs_max)
            reemit_ok = pending & ~reabs_kill
            carry.killed_int += reabs_kill.sum()
        can = can_fresh if reemit_ok is None else can_fresh | reemit_ok
        if mode == 'source':
            src = None if reemit_ok is None else torch.where(
                reemit_ok, p.reemit_src, pick_sources(st, u[U_SRC]))
            new = emit_sources(u, src)
            x, y, z = new['x'], new['y'], new['z']
            kx, ky, kz = new['kx'], new['ky'], new['kz']
            src = new['source']
            e_new = src_energy[src] * st.energy_weight[src]
            if reemit_ok is not None:
                e_new = torch.where(reemit_ok, p.energy, e_new)
            reproc = torch.zeros_like(can)
            source_id, dust_id = src, torch.zeros_like(src)
            cell_new = geometry.find_cell(x, y, z, kx, ky, kz)
        else:
            # a dust picked uniformly, its cell on its CDF (a search per
            # dust: n_dust is small)
            d_pick = (u[U_DUST_PICK] * n_dust).long().clamp(0, n_dust - 1)
            uc = u[U_CELL].contiguous()
            cell_pick = torch.zeros_like(d_pick)
            for d in range(n_dust):
                cell_pick = torch.where(d_pick == d,
                                        torch.searchsorted(cell_cdf[d], uc),
                                        cell_pick)
            cell_new = cell_pick.clamp(0, n_cells - 1)
            u_pos = position_uniforms(geometry, u[U_POS_X:U_POS_Z + 1],
                                      u[N_UNIFORMS + n_extra:])
            x, y, z = (a.contiguous() for a in sample_position_in_cell(
                geometry, cell_new, u_pos))
            kx, ky, kz = isotropic_direction(u[U_DIR_MU], u[U_DIR_PHI])
            e_new = mean_prob[d_pick]
            reproc = torch.ones_like(can)
            source_id, dust_id = torch.zeros_like(d_pick), d_pick
            if reemit_ok is not None:
                # dust photons re-absorbed by a source leave from it
                new = emit_sources(u, p.reemit_src.clamp_min(0))
                sel = reemit_ok

                def r(a, b):
                    return torch.where(sel, b, a)
                x, y, z = r(x, new['x']), r(y, new['y']), r(z, new['z'])
                kx, ky, kz = r(kx, new['kx']), r(ky, new['ky']), \
                    r(kz, new['kz'])
                e_new = r(e_new, p.energy)
                reproc = reproc & ~sel
                source_id = r(source_id, p.reemit_src.clamp_min(0))
                cell_new = r(cell_new, geometry.find_cell(x, y, z, kx, ky,
                                                          kz))
        emitted = can & (cell_new != ESCAPED) & (e_new > 0.0)
        forced = None
        if ffi:
            forced = emitted if reemit_ok is None else emitted & ~reemit_ok
        # the emission peel with the energy before the forced first
        # interaction's reweight; re-emits peel even when only scatterings
        # do (ref iter_final_mono.f90:292-295); its walk also walks the
        # emission rays of the forced first interaction
        tau_esc = None
        if not scat_only or reabs_on:
            peel = emitted if not scat_only else emitted & reemit_ok
            no = torch.zeros_like(peel)
            zero = torch.zeros_like(p.n_scat)
            prov = Provenance(scattered=no, reprocessed=reproc,
                              source_id=source_id, dust_id=dust_id,
                              n_scat=zero)
            zq = torch.zeros_like(x)
            tau_esc = peel_and_bin(
                walk, dt, groups, carry.accums, x, y, z, chi_rows, cell_new,
                nu, torch.where(peel, e_new, 0.0), 1.0, no, zero, kx, ky, kz,
                prov, peel, stokes_in=(zq, zq, zq), inu_global=f_id,
                extra=None if forced is None else (kx, ky, kz, forced))
        if ffi:
            if tau_esc is None:
                tau_esc = walk(chi_rows, x, y, z, kx[None], ky[None],
                               kz[None], cell_new, forced)[0]
            applies = tau_esc > 1e-10
            if reemit_ok is not None:
                applies = applies & ~reemit_ok
            tau_new, w_ffi = sample_first_interaction(
                u[U_FFI], u[U_EM_TAU], tau_esc, applies, ffi_algorithm,
                ffi_xi)
            e_ffi = e_new * w_ffi
        else:
            tau_new = random_exp(u[U_EM_TAU])
            e_ffi = e_new

        def m(old, new_, mask=can):
            put_where(old, new_, mask)

        if reabs_on:
            m(p.n_reabs, torch.where(reemit_ok, p.n_reabs + 1, 0))
            m(p.reemit_src, -1, pending)
        p.alive |= emitted
        for name, value in (('x', x), ('y', y), ('z', z), ('kx', kx),
                            ('ky', ky), ('kz', kz), ('energy', e_ffi),
                            ('cell', cell_new), ('tau', tau_new),
                            ('reprocessed', reproc), ('source_id', source_id),
                            ('dust_id', dust_id)):
            m(getattr(p, name), value)
        m(p.energy_initial, e_new, can_fresh)
        m(p.n_inter, 0, can_fresh)
        for name in ('scattered', 'n_scat', 'q', 'u', 'v'):
            m(getattr(p, name), 0)
        carry.budget -= n_new

    def draw(carry, generator):
        x = carry.packets.x
        return torch.rand((N_UNIFORMS + n_extra + n_pos, x.shape[0]),
                          generator=generator, device=x.device, dtype=dtype)

    def step(carry, generator):
        p = carry.packets
        B = p.x.shape[0]
        u = draw(carry, generator)
        # a working step, and the imaging step's refill gate
        carry.n_steps += (carry.budget > 0) | (carry.n_alive > 0) | \
            (carry.n_pending > 0)
        gate = ((carry.budget > 0) & ((carry.n_alive * 4 <= 3 * B) |
                                      (carry.n_alive == 0))) | \
            (carry.n_pending > 0)
        # the lanes' constants are made outside the gated body: a tensor
        # made in a skipped body holds nothing
        nu, chi_rows = consts(B, p.x.device)
        run_refill(refill, carry, u, gate)

        active = p.alive
        cell_safe = p.cell.clamp_min(0)
        t_wall, next_cell, ax, wall_coord = geometry.find_wall(
            cell_safe, p.x, p.y, p.z, p.kx, p.ky, p.kz)
        rho_rows = rho_t[cell_safe]
        chi_rho = (chi_rows * rho_rows).sum(dim=-1)
        tau_wall = chi_rho * t_wall
        hits_wall = (tau_wall < p.tau) | (chi_rho <= 0.0)
        t_int = torch.where(chi_rho > 0.0, p.tau / chi_rho.clamp_min(1e-300),
                            t_wall)
        d_move = torch.where(hits_wall, t_wall, t_int)
        # source re-absorption: the photon waits for its re-emission at the
        # same frequency (ref iter_final_mono.f90:278-295)
        moving = active
        if reabs_on:
            t_src, src_row = nearest_source_intersection(st, p.x, p.y, p.z,
                                                         p.kx, p.ky, p.kz)
            hits_src = active & (d_move > t_src)
            hits_wall = hits_wall & ~hits_src
            moving = active & ~hits_src
        x = torch.where(moving, p.x + d_move * p.kx, p.x)
        y = torch.where(moving, p.y + d_move * p.ky, p.y)
        z = torch.where(moving, p.z + d_move * p.kz, p.z)
        crossed = moving & hits_wall
        x, y, z = geometry.snap(x, y, z, ax, wall_coord, crossed)
        tau = torch.where(moving, torch.where(hits_wall, p.tau - tau_wall,
                                              0.0), p.tau)
        cell = torch.where(crossed, next_cell, p.cell)
        escaped = crossed & (cell == ESCAPED)

        # forced scattering (ref interact(force_scatter=.true.)): the energy
        # times the albedo, a polarized scattering
        interacting = moving & ~hits_wall
        d_sel = select_dust(u[U_DUST], chi_rows, rho_rows)
        energy = torch.where(interacting, p.energy * albedo_vec[d_sel],
                             p.energy)
        sx, sy, sz, q_s, u_s, v_s = sample_scatter_stokes(
            dt, d_sel, nu, u[U_PHI], u[U_MU], p.kx, p.ky, p.kz, p.q, p.u,
            p.v)
        n_inter = p.n_inter + interacting.to(torch.int32)
        over = interacting & (n_inter > n_inter_max)
        killed = over | (interacting & (energy < p.energy_initial *
                                        threshold))
        if kill_on_scatter:
            killed = killed | interacting
        alive = active & ~escaped & ~killed
        n_reabs, reemit_src = p.n_reabs, p.reemit_src
        if reabs_on:
            alive = alive & ~hits_src
            reemit_src = torch.where(hits_src, src_row, reemit_src)
            n_reabs = torch.where(interacting, 0, n_reabs)

        # the scattering peel (killed photons do not peel)
        n_scat = p.n_scat + interacting.to(p.n_scat.dtype)
        dust_id = torch.where(interacting, d_sel, p.dust_id)
        one = torch.ones_like(interacting)
        prov = Provenance(scattered=one, reprocessed=p.reprocessed,
                          source_id=p.source_id, dust_id=dust_id,
                          n_scat=n_scat)
        peel_and_bin(walk, dt, groups, carry.accums, x, y, z, chi_rows, cell,
                     nu, energy, 1.0, one, d_sel, p.kx, p.ky, p.kz, prov,
                     interacting & ~killed, stokes_in=(p.q, p.u, p.v),
                     inu_global=f_id)

        def s(new_, old):
            return torch.where(interacting, new_, old)

        if reabs_on:
            put(p, n_reabs=n_reabs, reemit_src=reemit_src)
            carry.n_pending.copy_((reemit_src >= 0).sum())
        put(p, x=x, y=y, z=z, kx=s(sx, p.kx), ky=s(sy, p.ky), kz=s(sz, p.kz),
            energy=energy, cell=cell, tau=s(random_exp(u[U_TAU]), tau),
            n_inter=n_inter, alive=alive, scattered=p.scattered | interacting,
            dust_id=dust_id, n_scat=n_scat, q=s(q_s, p.q), u=s(u_s, p.u),
            v=s(v_s, p.v))
        carry.killed_int += over.sum()
        carry.n_events += moving.sum()
        carry.n_alive.copy_(alive.sum())

    step.draw = draw
    step.refill = refill
    step.counts = mono_step_counts
    return step


def start_mono_pass(geometry, walk, dt, st, density, groups, n_photons,
                    batch_size, config, mode, f_id, nu_value, chi_vec,
                    albedo_vec, **tables):
    """The carry and the step of one pass (the arguments of
    :func:`run_mono_pass` but the generator and ``max_steps``)."""
    carry = _init_mono_carry(groups, n_photons, batch_size, density.device,
                             density.dtype)
    step = make_mono_step(geometry, walk, dt, st, density, groups, config,
                          mode, f_id, nu_value, chi_vec, albedo_vec, **tables)
    return carry, step


def finish_mono_pass(carry, n_steps):
    """The tuple of :func:`run_mono_pass` from a carry that has run
    ``n_steps`` working steps: lanes still alive or waiting are killed and
    counted."""
    p = carry.packets
    killed = carry.killed_int + p.alive.sum() + (p.reemit_src >= 0).sum()
    killed, n_events, refills = torch.stack(
        [killed, carry.n_events, carry.refills]).tolist()
    mono_step_counts['refills'] += refills
    return carry.accums, killed, n_steps, n_events


def run_mono_pass(geometry, walk, dt, st, density, groups, generator,
                  n_photons, batch_size, config, mode, f_id, nu_value,
                  chi_vec, albedo_vec, max_steps=100000000, **tables):
    """One pass (``mode`` 'source' or 'dust') at one frequency; ``tables``
    the keywords of :func:`make_mono_step`. On a CUDA device the pass runs
    as replays of its own CUDA graph (``engine.drive_graph``), on the CPU
    one step at a time. Returns (accums, killed_int, n_steps, n_events)
    with raw energies; lanes still alive or waiting after ``max_steps``
    working steps are killed and counted."""
    carry, step = start_mono_pass(geometry, walk, dt, st, density, groups,
                                  n_photons, batch_size, config, mode, f_id,
                                  nu_value, chi_vec, albedo_vec, **tables)
    drive = drive_graph if density.device.type == 'cuda' else drive_steps
    _, n_steps = drive(carry, step, generator, max_steps)
    return finish_mono_pass(carry, n_steps)


def _add_scaled(final, acc, scale):
    """final += acc * scale (the sums of squares by scale^2, the counts as
    they are), float64 cubes on the device."""
    for name in ('sed', 'img'):
        getattr(final, name).add_(getattr(acc, name), alpha=scale)
        getattr(final, name + '2').add_(getattr(acc, name + '2'),
                                        alpha=scale ** 2)
        getattr(final, name + 'n').add_(getattr(acc, name + 'n'))


def run_mono(geometry, walk, dt, st, density, specific_energy, groups,
             generator, frequencies, n_photons_sources, n_photons_dust,
             sources, dusts, batch_size=65536, n_inter_max=1000000,
             kill_on_scatter=False, forced_first_interaction=True,
             peeloff_scattering_only=False, energy_threshold=1e-10,
             max_steps=100000000, ffi_algorithm='wr99', ffi_baes16_xi=0.5,
             n_reabs_max=0, group=None):
    """The monochromatic iteration over all ``frequencies``: returns (one
    float64 :class:`~.imaging.PeelAccum` per group, stats). The source
    pass's cubes are scaled by energy_total / n_photons_sources; the dust
    photons carry mean_prob x energy_abs_tot x n_dust / n_photons_dust
    each (ref iter_final_mono.f90:115,185). ``density`` and
    ``specific_energy`` (None: zero) are (n_dust, n_cells) engine-unit
    tensors; ``walk`` the grid's EscapeTau. stats: killed_int, n_steps,
    n_events and passes. With ``group`` (a launched
    :class:`..parallel.mesh.Group`) each pass runs this rank's share of its
    photons and its cubes come back sum-reduced over the ranks
    (:func:`..parallel.mesh.run_mono_pass_sharded`)."""
    device, dtype = density.device, density.dtype
    frequencies = np.asarray(frequencies, float)
    n_freq = len(frequencies)
    n_dust, n_cells = density.shape
    config = dict(n_inter_max=n_inter_max, kill_on_scatter=kill_on_scatter,
                  forced_first_interaction=forced_first_interaction,
                  peeloff_scattering_only=peeloff_scattering_only,
                  energy_threshold=energy_threshold,
                  ffi_algorithm=ffi_algorithm, ffi_baes16_xi=ffi_baes16_xi,
                  source_intersect=st.any_intersect, n_reabs_max=n_reabs_max)
    # the dusts' opacities at each frequency: (n_freq, n_dust)
    chi_all, _, albedo_all = update_optical_constants(
        dt, torch.as_tensor(frequencies, dtype=dtype, device=device))
    src_e = source_mono_energies(sources, frequencies) \
        if n_photons_sources and sources else \
        np.zeros((st.n_sources, n_freq))
    if n_photons_dust and specific_energy is not None:
        # in float64: the volumes in cm^3 overflow float32
        L = geometry.length_scale
        cell_cdf, mean_prob, energy_abs_tot = dust_mono_cell_pdfs(
            dusts, density.double().cpu().numpy() / L,
            geometry.volumes.double().cpu().numpy() * L ** 3,
            specific_energy.double().cpu().numpy(), frequencies)
    else:
        cell_cdf = np.zeros((n_freq, n_dust, n_cells))
        mean_prob = np.zeros((n_freq, n_dust))
        energy_abs_tot = np.zeros(n_dust)

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    final = [PeelAccum(g, device, torch.float64) for g in groups]
    stats = dict(killed_int=0, n_steps=0, n_events=0, passes=0)

    def add(accums, scale, *counts):
        for a, b in zip(final, accums):
            _add_scaled(a, b, scale)
        for k, v in zip(('killed_int', 'n_steps', 'n_events'), counts):
            stats[k] += v
        stats['passes'] += 1

    one_pass = run_mono_pass if group is None else \
        partial(run_mono_pass_sharded, group)
    for f_id in range(n_freq):
        common = (geometry, walk, dt, st, density, groups, generator)
        at = dict(batch_size=batch_size, config=config, f_id=f_id,
                  nu_value=float(frequencies[f_id]), chi_vec=chi_all[f_id],
                  albedo_vec=albedo_all[f_id], max_steps=max_steps)
        if n_photons_sources > 0:
            accums, *counts = one_pass(
                *common, n_photons_sources, mode='source',
                src_energy=f(src_e[:, f_id]), **at)
            add(accums, float(st.energy_total) / n_photons_sources, *counts)
        if n_photons_dust > 0 and mean_prob[f_id].sum() > 0:
            accums, *counts = one_pass(
                *common, n_photons_dust, mode='dust',
                cell_cdf=f(cell_cdf[f_id]),
                mean_prob=f(mean_prob[f_id] * energy_abs_tot * n_dust /
                            n_photons_dust), **at)
            add(accums, 1.0, *counts)
    return final, stats
