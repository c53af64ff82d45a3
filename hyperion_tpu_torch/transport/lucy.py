"""Lucy (1999) temperature iterations of the port (counterpart of
``hyperion_tpu/transport/lucy.py``).

Between iterations (ref iter_lucy.f90:216-238, grid_physics_3d.f90:500-690):
energy normalization, an additional specific energy, the emissivity
locator, the MRW tables, the minimum-specific-energy floor and energy
range, the PDA, sublimation, temperatures and the percentile convergence
test."""

from typing import NamedTuple

import numpy as np
import torch

from .engine import run_lucy_iteration
from .mrw import prepare_mrw_tables
from .pda import solve_pda
from .sampling import interp_loglog, searchsorted_right


def normalize_specific_energy(energy_sum, scale, volumes):
    """ref update_energy_abs, grid_physics_3d.f90:500-555. Divides by the
    volume BEFORE applying the luminosity scale, which keeps float32 in
    range."""
    se = energy_sum / volumes[None, :].clamp_min(1e-300) * scale
    return torch.where(volumes[None, :] > 0.0, se, 0.0)


def compute_jnu_var(dt, specific_energy):
    """Each (dust, cell) specific energy located in the dust's emissivity
    grid (ref dust_jnu_var_pos_frac, dust_type_4elem.f90:296-321).
    Returns int64 ids and float fractions, both (n_dust, n_cells)."""
    n_var = dt.n_var
    ids, fracs = [], []
    for d in range(dt.n_dust):
        var = dt.emiss_var[d]
        logv = dt.log_emiss_var[d]
        e = specific_energy[d]
        i = (searchsorted_right(var, e) - 1).clamp(0, n_var - 2)
        frac = (torch.log10(e.clamp_min(1e-300)) - logv[i]) / \
            (logv[i + 1] - logv[i])
        below = e < var[0]
        above = e > var[-1]
        i = torch.where(below, 0, torch.where(above, n_var - 2, i))
        frac = torch.where(below, 0.0, torch.where(above, 1.0, frac))
        ids.append(i)
        fracs.append(frac)
    return torch.stack(ids), torch.stack(fracs)


def specific_energy_to_temperature(dt, specific_energy):
    """Invert E = 4 sigma T^4 kappa_planck(T) through the mean-opacity
    table (ref specific_energy2temperature)."""
    temps = []
    for d in range(dt.n_dust):
        se_tab = dt.me_specific_energy[d]
        e = specific_energy[d].clamp(se_tab[0], se_tab[-1])
        temps.append(interp_loglog(se_tab, dt.me_temperature[d], e))
    return torch.stack(temps)


def enforce_energy_limits(dt, specific_energy, minimum_specific_energy,
                          enforce_range):
    """Floor at the user minimum, then (with ``enforce_energy_range``, the
    reference's default) clip every cell into the dust's tabulated
    specific-energy range (ref check_energy_abs,
    grid_physics_3d.f90:555-601)."""
    se = specific_energy
    if minimum_specific_energy is not None:
        floor = torch.as_tensor(minimum_specific_energy, dtype=se.dtype,
                                device=se.device)
        se = torch.maximum(se, floor[:, None])
    if enforce_range:
        table = dt.me_specific_energy
        se = se.clamp(table[:, :1], table[:, -1:])
    return se


def _chi_rosseland(dt, d, e):
    se_tab = dt.me_specific_energy[d]
    e = torch.as_tensor(e, dtype=se_tab.dtype, device=se_tab.device).clamp(
        se_tab[0], se_tab[-1])
    return interp_loglog(se_tab, dt.me_chi_rosseland[d], e.reshape(-1))


def sublimate_dust(dt, density, specific_energy,
                   minimum_specific_energy=None):
    """Per-dust sublimation (ref sublimate_dust, grid_physics_3d.f90:
    420-498). Modes: 0 none; 1 fast: remove the dust and reset E to the
    minimum; 2 slow: scale the density by (E_sub/E)·(χ_R(E)/χ_R(E_sub))²
    and cap E; 3 cap: cap E only."""
    modes = dt.sublimation_mode.tolist()
    rows_rho, rows_se = [], []
    for d in range(dt.n_dust):
        rho, e = density[d], specific_energy[d]
        if modes[d]:
            e_sub = dt.sublimation_energy[d]
            exceed = e > e_sub
        if modes[d] == 1:
            rho = torch.where(exceed, 0.0, rho)
            e_min = 0.0 if minimum_specific_energy is None else \
                float(minimum_specific_energy[d])
            e = torch.where(exceed, e_min, e)
        elif modes[d] == 2:
            ratio = _chi_rosseland(dt, d, e) / _chi_rosseland(dt, d, e_sub)
            rho = torch.where(exceed, rho * e_sub / e.clamp_min(1e-300)
                              * ratio ** 2, rho)
            e = torch.where(exceed, e_sub, e)
        elif modes[d] == 3:
            e = torch.where(exceed, e_sub, e)
        rows_rho.append(rho)
        rows_se.append(e)
    return torch.stack(rows_rho), torch.stack(rows_se)


def specific_energy_converged(se_prev, se, percentile, absolute, relative,
                              value_prev):
    """Quantile convergence test (ref specific_energy_converged,
    grid_physics_3d.f90:637-690). Returns (converged, value)."""
    se_prev = np.asarray(se_prev, dtype=float)
    se = np.asarray(se, dtype=float)
    mask = (se_prev > 0) & (se > 0) & (se_prev != se)
    if np.all(se_prev == se):
        value = 0.0
    elif not np.any(mask):
        return False, None
    else:
        ratio = np.maximum(se_prev[mask] / se[mask], se[mask] / se_prev[mask])
        value = np.percentile(ratio, percentile)
    if value_prev is None:
        return False, value
    if value == 0.0:
        return True, value
    rel_change = max(value_prev / value, value / value_prev)
    return (value < absolute) and (abs(rel_change) < relative), value


def spectrum_bin_fractions(dt, edges):
    """The fraction of the local LTE emissivity in each spectrum bin per
    (dust, var) row, (n_dust * n_var, n_bins): it spreads MRW deposits over
    the bins without sampling (ref j_nu_bin_frac of
    deposit_specific_energy_spectrum, grid_physics_3d.f90:367-415). Host
    numpy, a copy of the JAX package's."""
    n_dust, n_var = dt.n_dust, dt.n_var
    cdf = dt.jnu_cdf.cpu().numpy().astype(float)
    emiss_nu = dt.emiss_nu.cpu().numpy().astype(float)
    edges = np.asarray(edges, float)
    out = np.zeros((n_dust * n_var, len(edges) - 1))
    for d in range(n_dust):
        lg = np.log(np.maximum(emiss_nu[d], 1e-300))
        for v in range(n_var):
            c_at = np.interp(np.log(edges), lg, cdf[d * n_var + v])
            out[d * n_var + v] = np.maximum(np.diff(c_at), 0.0)
    return out


class LucyResult(NamedTuple):
    specific_energy: np.ndarray     # (n_dust, n_cells)
    temperature: np.ndarray         # (n_dust, n_cells)
    density: np.ndarray             # possibly sublimated
    n_photons_cell: np.ndarray
    energy_current: float
    killed_int: int
    killed_geo: int
    n_steps: int
    n_events: int                   # occupancy = n_events/(n_steps*batch)
    converged: bool
    iterations: int
    # (n_dust, n_bins, n_cells) with spectrum bins, else None
    specific_energy_spectrum: np.ndarray = None


def run_lucy(geometry, dt, st, density, generator, n_photons, n_iterations,
             batch_size=65536, n_inter_max=1000000, kill_on_scatter=False,
             kill_on_absorb=False, n_reabs_max=0, max_steps=100000000,
             minimum_specific_energy=None, enforce_energy_range=True,
             check_convergence=False, convergence_absolute=0.0,
             convergence_relative=1.02, convergence_percentile=100.0,
             initial_specific_energy=None, additional_specific_energy=None,
             use_mrw=False, mrw_gamma=1.0, n_mrw_max=1000, use_pda=False,
             pda_tables=None, check_frequency=0.0, spectrum_bins=None,
             verbose=True, iteration_callback=None):
    """Run n_iterations Lucy iterations (or until converged) on one device.

    ``density`` is (n_dust, n_cells) in engine units; ``generator`` is the
    ``torch.Generator`` on the density's device that every step draws from.
    ``initial_specific_energy`` seeds the first iteration's emissivities;
    ``additional_specific_energy`` is added to every iteration's estimate
    (ref grid_physics_3d.f90:213-240,530-541); both are (n_dust, n_cells).
    ``use_mrw`` turns the modified random walk on, its tables made each
    iteration from the current specific energy; ``use_pda`` with
    ``pda_tables`` (:func:`.pda.build_pda_tables`) fills photon-starved
    cells by diffusion; ``spectrum_bins`` are frequency bin edges (Hz) of
    the frequency-resolved specific energy. ``iteration_callback(it,
    specific_energy, density, n_photons_cell, specific_energy_spectrum,
    stats)`` gets numpy arrays after each iteration (the spectrum None
    without bins)."""
    if n_photons >= 2 ** 31 - 1:
        raise ValueError("n_photons = %d: photon ids are int32, so an "
                         "iteration holds fewer than 2**31 - 1 photons"
                         % n_photons)
    n_dust, n_cells = density.shape
    dtype, device = density.dtype, density.device

    def tensor(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    specific_energy = torch.zeros_like(density) \
        if initial_specific_energy is None else \
        tensor(initial_specific_energy)
    if additional_specific_energy is not None:
        additional_specific_energy = tensor(additional_specific_energy)
    config = dict(n_inter_max=n_inter_max, kill_on_scatter=kill_on_scatter,
                  kill_on_absorb=kill_on_absorb, n_mrw_max=n_mrw_max,
                  n_reabs_max=n_reabs_max,
                  # the re-absorption branch only where a source can
                  # intersect photon paths
                  source_intersect=st.any_intersect,
                  check_frequency=check_frequency, max_steps=max_steps)
    spec_bins = spec_bin_frac = None
    if spectrum_bins is not None:
        edges = np.asarray(spectrum_bins, float)
        spec_bins = tensor(np.log2(np.maximum(edges, 1e-300)))
        if use_mrw:
            spec_bin_frac = tensor(spectrum_bin_fractions(dt, edges))

    se_prev = None
    value_prev = None
    converged = False
    stats = dict(killed_int=0, killed_geo=0, n_steps=0, n_events=0,
                 energy_current=0.0)
    n_photons_cell = np.zeros(n_cells, dtype=np.int64)
    se_spectrum = None
    it = 0
    for it in range(1, n_iterations + 1):
        jnu_var_id, jnu_var_frac = compute_jnu_var(dt, specific_energy)
        mrw = prepare_mrw_tables(dt, density, specific_energy, mrw_gamma) \
            if use_mrw else None
        # a map with an LTE spectrum picks its dust ∝ specific energy x
        # density at the emission cell (ref select_dust_specific_energy_rho)
        se_rho = specific_energy * density if st.has_lte else None
        energy_sum, energy_current, npc, killed_int, killed_geo, n_steps, \
            energy_sum_spec, n_events = run_lucy_iteration(
                geometry, dt, st, density, jnu_var_id, jnu_var_frac,
                generator, n_photons, batch_size, config, mrw=mrw,
                spec_bins=spec_bins, spec_bin_frac=spec_bin_frac,
                se_rho=se_rho)
        n_photons_cell = npc.cpu().numpy()

        # host float64 for the combined scale; engine lengths carry one
        # factor of L in ds and L^3 in the volumes: net 1/L^2
        scale = st.energy_total / max(float(energy_current), 1e-300) \
            / geometry.length_scale ** 2
        specific_energy = normalize_specific_energy(energy_sum, scale,
                                                    geometry.volumes)
        if spec_bins is not None:
            # the same luminosity and volume normalization per bin
            nb = energy_sum_spec.shape[1]
            se_spectrum = normalize_specific_energy(
                energy_sum_spec.reshape(n_dust * nb, n_cells), scale,
                geometry.volumes).reshape(n_dust, nb, n_cells).cpu().numpy()
        if additional_specific_energy is not None:
            specific_energy = specific_energy + additional_specific_energy
        specific_energy = enforce_energy_limits(
            dt, specific_energy, minimum_specific_energy,
            enforce_energy_range)
        if use_pda and pda_tables is not None:
            # diffusion fill-in of photon-starved cells, on the host (ref
            # iter_lucy.f90:228 solve_pda)
            rho_phys = density.cpu().numpy().astype(float) / \
                geometry.length_scale
            se_fixed, n_pda = solve_pda(
                pda_tables, dt, rho_phys,
                specific_energy.cpu().numpy().astype(float), n_photons_cell)
            if verbose and n_pda:
                print("[pda] corrected %d photon-starved cells" % n_pda)
            specific_energy = tensor(se_fixed)
        density, specific_energy = sublimate_dust(
            dt, density, specific_energy, minimum_specific_energy)
        specific_energy = enforce_energy_limits(
            dt, specific_energy, minimum_specific_energy,
            enforce_energy_range)

        stats = dict(killed_int=int(killed_int), killed_geo=int(killed_geo),
                     n_steps=int(n_steps), n_events=int(n_events),
                     energy_current=float(energy_current))
        if verbose:
            print("[lucy] iteration %d/%d: %d steps, killed=%d/%d"
                  % (it, n_iterations, stats['n_steps'], stats['killed_int'],
                     stats['killed_geo']))
        se_np = specific_energy.cpu().numpy()
        if iteration_callback is not None:
            iteration_callback(it, se_np, density.cpu().numpy(),
                               n_photons_cell, se_spectrum,
                               stats=dict(stats, batch_size=batch_size))

        if check_convergence and se_prev is not None:
            converged, value_prev = specific_energy_converged(
                se_prev, se_np, convergence_percentile,
                convergence_absolute, convergence_relative, value_prev)
            if converged:
                if verbose:
                    print("[lucy] converged after %d iterations" % it)
                break
        elif check_convergence:
            _, value_prev = specific_energy_converged(
                np.ones_like(se_np), se_np, convergence_percentile,
                convergence_absolute, convergence_relative, None)
        se_prev = se_np

    temperature = specific_energy_to_temperature(dt, specific_energy)
    return LucyResult(
        specific_energy=specific_energy.cpu().numpy(),
        temperature=temperature.cpu().numpy(),
        density=density.cpu().numpy(),
        n_photons_cell=n_photons_cell,
        energy_current=stats['energy_current'],
        killed_int=stats['killed_int'], killed_geo=stats['killed_geo'],
        n_steps=stats['n_steps'], n_events=stats['n_events'],
        converged=converged, iterations=it,
        specific_energy_spectrum=se_spectrum)
