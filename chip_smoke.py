#!/usr/bin/env python3
"""Smoke run of hyperion_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card and the software: name and power limit, torch, CUDA, nvcc;
2. build the deposit_visit and escape_tau kernels from
   hyperion_tpu_torch/transport/csrc, one nvcc per source, all at once;
3. the kernel against its plain PyTorch version, counts and uids equal and
   float32 energies within rtol 1e-4 of a float64 plain run (the kernel's
   float atomics and in-warp sums add in another, run-dependent order):
   the main path's six shapes over 8 carried calls; visits-only calls (a
   refill's) between step calls; a hot cell that every lane deposits into
   and enters; warps whose lanes form groups of 1, 2, 31 and 32 equal cells
   with repeated and tied uids; the 5, 3, 5 overwrite case over three
   carried calls; CUDA graphs of 1, 2 (refill and step) and 100 calls
   replayed several times on new lanes; and the very calls of 40 steps of
   the tutorial, refills included, recorded from the engine. On those
   calls, the hottest cell's share of the lanes and the warps and blocks
   that hold it (the same-address atomics left after a merge per warp or
   per block). Then, at the six shapes, the hot cell, and on the
   tutorial's calls (the kernels line reports these):
   device time per call (a CUDA graph's replay, CUDA events), host time per
   call (host clock around ~1,000 eager calls, before the synchronise), the
   plain version's time, the deposits-only index_add_ yardstick and the
   bound;
4. the slice: examples/quickstart.py whole (32^3 cells, 4 Lucy iterations
   of 500,000 photons, then 1,000,000 imaging photons with forced first
   interaction into its peeled 128 x 128 image and SED of 60 wavelengths
   at 45 degrees) built with the port's own Model and run on the card by
   run_lucy_model, the port's run_model without the .rtout file (the
   card's machine has no h5py; the tests check the file on the CPU):
   nothing killed, energy_current the photon count, the SED and image
   finite and >= 0, the band-integrated peeled luminosity (sum of nu L_nu
   dln nu) within 2% of L_sun times the 6000 K blackbody's share of 0.3 to
   1000 um (the box's tau is ~0.015), the imaging wall, steps, ms per step
   and host reads per step (at most 1.05); both kernels' launch counts are
   reset just before and read just after;
5. physics on the card in float32: the optically thin inverse-square check
   of tests/test_engine_lucy.py, one iteration of bench.py's quickstart
   configuration, the host synchronisations per step, and the binned-image
   check of tests/test_binned_images.py:9-41 with that test's model (all
   the emitted energy within 5%, each theta bin's flux in proportion to
   its solid angle within 10%);
6. deposit_visit on the very calls of 40 steps of bench.py's yso_thick
   configuration (a spherical star in the innermost shell, MRW lanes in the
   dense midplane, B = 4,096), refills included: against the plain
   version, the hottest cell's share of them, and their times;
7. MRW physics on the card in float32 (tests/test_mrw.py:42-58 with 20,000
   photons, on 4^3 cells of 20 mean free paths): MRW on and off agree
   (median specific-energy ratio within 0.05), MRW takes fewer than 0.85 x
   the steps, nothing is killed;
8. examples/class2_sed.py with its peeled SEDs at 20, 45 and 80 degrees,
   built with the port's AnalyticalYSOModel (96 x 32 x 1 auto grid, MRW, a
   spherical star) and run on the card by run_lucy_model, cut to 1 Lucy
   iteration of 200,000 photons capped at 8,000 steps and 100,000 imaging
   photons capped at 3,000 steps (CLASS2_CUT; lanes alive at a cap are
   killed and counted in killed_int): no geometry kills, energy_current
   the photon count, the SEDs finite and >= 0 and the 80 degree view
   fainter than the 20 degree one at the shortest wavelength; per
   iteration wall, photons/s, steps, ms per step, occupancy, killed_int and
   host syncs per step (at most 1.05); escape_tau launches per imaging
   step, at most the peel events per step (one launch per event);
9. bench.py's yso_thick configuration through transport.lucy.run_lucy as
   bench.py calls it, cut to 1 iteration of 20,000 photons (bench.py: 2
   of 2,000,000; ``--yso-thick-photons N`` runs phases 1, 2 and 9 alone
   with 2 iterations of N photons): nothing killed, the steps per
   iteration beside the JAX package's;
10. escape_tau against its plain version on the very walk calls of
   imaging steps 1-20 and 41-60 (WALK_WINDOWS) of the quickstart
   (cartesian, B = 125,000) and of class2 (spherical-polar, B = 50,000),
   recorded from imaging_runner.run_imaging: one call per peel event with
   the event's V views as (V, B) directions (and one per forced first
   interaction). In each window, the kernel (which walks in float64) with
   float64 lanes within 1e-10 relative of the float64 plain version on
   every ray, with float32 lanes within 1e-6 relative of it on every ray
   (ESCAPE_TAU_RTOL32 says why) and equal to its own plain version; the
   longest walk's crossings, and the times: device us per call (each call
   one event, CUDA events) and per view, host us per call, the plain
   version's, and the bound;
11. raytracing at full width: examples/class2_sed.py's model (phase 8's)
   with set_raytracing(True), 10,000 source and 1,000,000 dust raytracing
   photons (Hyperion's class 2 tutorial's), phase 8's specific energy
   given to the grid (no Lucy iteration) and the imaging iteration at
   CLASS2_CUT's budget peeling scattered light only, through
   run_lucy_model: no raytraced photon outside the grid or its cell (the
   imaging steps, as the JAX package's, make no geometry self-check), the
   SEDs finite and >= 0; their band
   at >= 100 um beside phase 8's Monte-Carlo SED's per view, and the 80/20
   degree ratio at 0.3 um beside phase 8's (reported); the raytracing
   wall, batches and column launches. Then class2 in monochromatic mode at
   100, 300 and 1000 um without and with raytracing (the same emission
   model): the two within RAYTRACE_N_SIGMA at every view and wavelength
   (RAYTRACE_N_SIGMA says why this and not phase 8 is the check);
12. monochromatic imaging at full width: the quickstart's model (phase 4's,
   its 128 x 128 image and SED at 45 degrees) at 0.5, 1, 10, 100 and 1000
   um, 500,000 source and 500,000 dust photons per wavelength, phase 4's
   specific energy given to the grid, (a) without and (b) with raytracing
   (phase 11's photons): (a) at 0.5 and 1 um within 2% of the point
   source's nu L pi B_nu / (sigma T^4) (the box's tau is ~0.01), (b) -
   (a) within MONO_N_SIGMA of the offset that raytracing's resampled var
   rows predict (raytrace_table_offset; MONO_N_SIGMA says why) at every
   wavelength, nothing killed, no
   raytraced photon outside the grid or its cell, escape_tau launched in
   both;
13. the column mode of escape_tau against its plain version on the very
   column calls of phases 11 (spherical-polar, B = 50,000, 3 views) and 12
   (b) (cartesian, B = 125,000, 1 view), recorded from run_lucy_model:
   float64 lanes equal to the float64 plain version (0 relative error) on
   every ray and dust, float32 lanes equal to their own float32 plain
   version and within ESCAPE_TAU_RTOL32 of the float64 one; the longest
   walk and the times (device us per call, host us per call, the plain
   version's, the bound).

14. BASELINE.md config 3 (class1_cyl_model: an embedded star with a flared
   disk, an Ulrich envelope with a bipolar cavity and an ISRF-like
   external sphere on the 200 x 200 x 1 cylindrical-polar auto grid, MRW,
   SEDs at 10, 60 and 85 degrees with their origins, a 128 x 128 image at
   60 degrees of 10 wavelengths, raytracing with phase 11's photons) at
   CLASS1_CYL_CUT's photons through run_lucy_model: no geometry kills,
   killed_int only at the step caps, energy_current the photons emitted,
   the ISRF's share of the source draws within 3 sigma of its luminosity
   share, temperatures finite and > 0 in dusty cells, SEDs and images
   finite and >= 0, the 85 degree view's scattered share at 0.3 um above
   the 10 degree view's, at most one escape_tau launch per peel event, no
   raytraced photon outside the grid or its cell; walls, steps, ms per
   step, occupancy and host reads per stage. Then the three kernels
   against their plain versions on this run's own calls, by the methods
   of phases 6 (deposit_visit, 80 Lucy calls), 10 (escape_tau, the
   WALK_WINDOWS imaging steps) and 13 (escape_column, the raytracing
   calls), with their times;
15. the other sources of ROADMAP.md item 4 on the card in float32: a
   plane-parallel beam through a slab of pure absorbers of tau 1 (escaped
   share within 3 sigma of exp(-1)), an external box over the
   quickstart's box (positions' means and variances within 3 sigma of
   uniform), and an LTE map source after one Lucy iteration (emission
   cells against the map, chi^2 per degree of freedom below 2).

``--raytracing`` runs phases 1, 2, 4, 8 and 11-13 alone; ``--cylindrical``
phases 1, 2, 14 (with its parts of phases 6, 10 and 13) and 15.

Each kernel's launch count is reset just before and read just after each
main-path run (phases 4, 8, 9, 11, 12 and 14); the kernels line sums them.
It ends with a JSON line of the kernels, then the result line
{"ok": true, "device": {...}}. Longer records go to chip_smoke_out/.
It needs no network and imports nothing of JAX or of hyperion_tpu.
"""

import contextlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / 'chip_smoke_out'
KERNEL_SOURCE = 'hyperion_tpu_torch/transport/csrc/deposit_visit.cu'
REPLACES = 'hyperion_tpu/transport/pallas_ops.py:116'
ESCAPE_TAU_SOURCE = 'hyperion_tpu_torch/transport/csrc/escape_tau.cu'
# an XLA while_loop, not a Pallas kernel
ESCAPE_TAU_REPLACES = 'hyperion_tpu/transport/imaging.py:465'
# (B, n_cells): bench.py's quickstart (15^3 cells, 131,072 lanes), the
# tutorial (32^3 cells, run.py's batch for 500,000 photons) and bench.py's
# yso_thick (64 x 32 spherical-polar cells, 4,096 lanes)
SHAPES = [(131072, 3375), (125000, 32768), (4096, 2048)]
TUTORIAL = (125000, 32768, 1)
# The YSO steps are host-bound (7-17 ms each on the H100) and the diffusion
# tail sets their count, so phases 8 and 9 run cut to keep the script well
# inside 10 minutes: fewer iterations first, then fewer photons (or, for
# class2, a step cap); grid, dust, densities, star and MRW stay as given.
# bench.py:103-195, yso_thick: the run_lucy arguments, and the photons and
# iterations chip_smoke runs (bench.py: 2 x 2,000,000, some 58,000 steps
# each; 1 x 50,000 takes ~12,600, 1 x 20,000 ~8,400, at 10-16 ms a step on
# the H100: 20,000 since class2's imaging joined phase 8;
# --yso-thick-photons runs it at bench size)
YSO_THICK = dict(batch_size=4096, mrw_gamma=1.0, n_mrw_max=100000,
                 n_reabs_max=100, max_steps=100000)
YSO_THICK_CUT = dict(n_photons=20_000, n_iterations=1)
# examples/class2_sed.py as chip_smoke runs it: its 200,000 photons, 1 of
# its 5 iterations, capped at 8,000 steps. The diffusion tail (photons deep
# in the disk's inner rim, whose innermost shells are too thin for MRW
# jumps) is heavy: on the H100 145-155 of the 200,000 photons were still
# alive at 8,000 steps, and the iteration's occupancy was 5% at B = 50,000.
# Lanes alive at the cap are killed and counted in killed_int.
# Imaging is cut to 100,000 of its 500,000 photons, capped at 3,000 steps,
# for the same diffusion tail.
CLASS2_CUT = dict(n_photons=200_000, n_iterations=1, max_steps=8000,
                  n_imaging=100_000, imaging_max_steps=3000)
# BASELINE.md config 3 (class1_cyl, phase 14) as chip_smoke runs it: the
# full 200 x 200 x 1 auto grid and every density component and source, with
# the photons cut so that the phase stays near two minutes on the card:
# 1 Lucy iteration of 100,000 photons capped at 3,000 steps (uncut, the
# counts of examples/class2_sed.py: 5 iterations of 200,000) and 50,000
# imaging photons capped at 1,500 steps (uncut: 500,000); the raytracing
# photons are RAYTRACING's, uncut. Lanes alive at a cap are killed and
# counted in killed_int.
CLASS1_CYL_CUT = dict(n_photons=100_000, n_iterations=1, max_steps=3000,
                      n_imaging=50_000, imaging_max_steps=1500)
# its star's and its ISRF stand-in's luminosities (Lsun)
CLASS1_CYL_LUM = dict(star=1.0, isrf=0.1)
# the JAX package's yso_thick steps per iteration at B = 4,096
# (BENCH_r05.json, TPU v5e): a property of the algorithm and the batch
JAX_YSO_THICK_STEPS = 55580
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA's data sheet
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
FP64_FLOPS = 34e12             # H100 SXM float64 outside the tensor cores
RTOL = 1e-4
# escape_tau (phase 10) walks in float64 whatever its lanes' type. The
# float64 kernel must equal the float64 plain version to 1e-10 on every lane:
# that holds the kernel's logic. The float32 kernel (float32 lanes, chi rows
# and density, as the engine keeps them) must be within 1e-6 tau of the
# float64 plain version on the float64 density on every lane: the float32
# rounding of each cell's density and of tau moves tau by at most ~1.2e-7,
# and a wrong crossing moves it by a whole segment.
ESCAPE_TAU_RTOL32 = 1e-6
# phase 10's windows of imaging steps (indices from 0): the first 20 steps,
# and steps 41-60, past the first refills, where class2's walks are the long
# ones of its steady state (deep in the disk, grazing the cones)
WALK_WINDOWS = ((0, 20), (40, 60))
# the float64 operations of one crossing of the walk itself, counted from
# the plain walk's find_wall (transport/gtable.py, gtable_spherical.py,
# gtable_cylindrical.py): three plane distances and the move (cartesian);
# two spheres, two cones, the nudged find_cell at the landing point
# (spherical-polar); with one phi cell, the exclusion (8), the ray's a, b
# and w^2 (9), two cylinders (10 each: b^2 - a (w^2 - ww^2), the root, two
# roots and two divisions), two z planes (2 each), the move (6) and the
# nudged find_cell (the landing's w and exclusion, the nudge and its w^2:
# 17) (cylindrical-polar; each phi wall would add 12). The bound counts
# this work, whatever the kernel does around it.
FLOPS_PER_CROSSING = {'cartesian': 25, 'spherical': 120, 'cylindrical': 64}
# escape_tau.cu's column mode (an XLA while_loop too, not a Pallas kernel)
ESCAPE_COLUMN_REPLACES = 'hyperion_tpu/transport/raytrace.py:25'
# phase 13's host time: rounds of the eager column calls, each round's
# calls queued back to back and the card drained between rounds
HOST_ROUNDS = 10
# phases 11 and 12: the raytracing photons of Hyperion's class 2 YSO
# tutorial (set_raytracing(True), raytracing_sources=1e4,
# raytracing_dust=1e6)
RAYTRACING = dict(raytracing_sources=10_000, raytracing_dust=1_000_000)
# phase 11: the raytraced SED within this many sigma of a Monte-Carlo SED
# (sigma both runs' Monte-Carlo uncertainties in quadrature; the raytraced
# light's own sampling noise is not in it: few of 1,000,000 dust photons
# come from the cool cells that make class2's far infrared, so from run to
# run it spreads by 3-9% there, the same photons for every view and
# wavelength, scripts/raytrace_spread.py; the check's run takes ten times
# as many). First set for the band at >= 100 um against phase 8's imaging
# iteration, where a run measured 0.913, 0.901 and 0.916 of phase 8's
# (9.44, 9.65 and 4.99 sigma, NVIDIA H100 80GB HBM3, 700 W). The cause is
# raytracing's emission from uniform points in each cell, where the imaging
# iteration re-emits at its absorption points: on optically thick cells
# the two are attenuated differently. The JAX package's own raytracing and
# imaging iteration show the same, from the same specific energy on the
# CPU in float64 (scripts/raytrace_vs_mc.py --package jax and port):
# raytracing / Monte Carlo at 20-100 um on class2's 24 x 8 grid with MRW
# off 0.922 and 0.900 at 20 and 45 degrees (5.9 and 6.8 sigma; the port
# 0.915 and 0.894), and 1.151 on a cube of cells of optical depth 1.7 lit
# from inside (the port 1.130). With MRW on, the JAX package's imaging
# iteration is no witness: its light at >= 100 um falls to 0.69-0.71 of
# its own with MRW off (9-11 sigma), where the port's stays within 3%. So
# phase 8's band is reported beside phase 11's, and the check holds the
# raytracing to the Monte-Carlo light of its own emission model: class2 in
# monochromatic mode, dust photons from uniform points in the cells
# (class2_mono_check)
RAYTRACE_N_SIGMA = 5.0
CLASS2_MONO_WAVELENGTHS = [100.0, 300.0, 1000.0]
# phase 12: the quickstart in monochromatic mode at these wavelengths
# (micron), MONO_PHOTONS source and dust photons each per wavelength; (a)
# at 0.5 and 1 um within MONO_ANALYTIC_RTOL of the point source's SED,
# (b) (with raytracing) within MONO_N_SIGMA of (a). (b)'s thermal light
# comes from the raytracing tables, which keep 60 of the dust's 1,200 var
# rows (the JAX package's tables), and (a)'s from the whole table, so
# (b) - (a) is held to the offset that the two interpolations predict on
# this optically thin box (raytrace_table_offset): without it, a run
# measured (b) 1.26% below (a) at 100 um, 8.93 sigma (NVIDIA H100 80GB
# HBM3, 700 W; the old check). The JAX package's tables and
# emission probabilities are the port's to 1e-12
# (tests/test_torch_raytrace.py, tests/test_torch_mono.py), and its own
# runs show the same offset: on the quickstart's box on 9^3 cells, from
# one specific energy on the CPU in float64 (scripts/raytrace_vs_mc.py
# --model cube --density 1e-19 --mono 0.5 1 10 100 1000 --photons
# 200000), raytracing / Monte Carlo at 100 um 0.9887 (5.06 sigma) in the
# JAX package and 0.9882 (5.29 sigma) in the port, where the offset is
# -1.17%.
MONO_WAVELENGTHS = [0.5, 1.0, 10.0, 100.0, 1000.0]
MONO_PHOTONS = 500_000
MONO_ANALYTIC_RTOL = 0.02
MONO_N_SIGMA = 5.0
# phase 11's monochromatic check: source and dust photons per wavelength
# (half CLASS2_CUT's imaging budget, for the time limit)
CLASS2_MONO_PHOTONS = 50_000


def phase(msg):
    print('[chip_smoke] ' + msg, flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs --

def _tensors(device, cell_dep, dep, enter, uid):
    """Lane tensors in the step's own layout: int64 cells, int32 uids,
    float32 deposits (B, n_dust)."""
    import torch
    return [torch.as_tensor(a, device=device) for a in (
        cell_dep.astype(np.int64), dep.astype(np.float32),
        enter.astype(np.int64), uid.astype(np.int32))]


def mixed_lanes(rng, B, n_cells, n_dust, device):
    """One step's lanes: ~30% deposit into and enter one busy cell (a
    refill), ~40% sit in the drop slot, a fifth of the deposits are masked,
    and uids come from a pool smaller than B, so they repeat across steps."""
    busy = int(rng.integers(0, n_cells))
    cell_dep = rng.integers(0, n_cells, B)
    cell_dep[rng.random(B) < 0.3] = busy
    dep = rng.exponential(1.0, (B, n_dust))
    dep[rng.random(B) < 0.2] = 0.0
    enter = rng.integers(0, n_cells, B)
    r = rng.random(B)
    enter[r < 0.3] = busy
    enter[(r >= 0.3) & (r < 0.7)] = n_cells
    uid = rng.integers(0, B // 2, B)
    return _tensors(device, cell_dep, dep, enter, uid)


def visits_only(rng, B, n_cells, n_dust, device):
    """A refill's call: mixed_lanes' entries and uids, no deposits."""
    _, _, enter, uid = mixed_lanes(rng, B, n_cells, n_dust, device)
    return None, None, enter, uid


def hot_lanes(rng, B, n_cells, n_dust, device):
    """Every lane deposits into and enters one cell; uids from a pool of
    40, so they tie within a call and repeat the cell's last uid."""
    hot = n_cells // 3
    return _tensors(device, np.full(B, hot), rng.exponential(1.0, (B, n_dust)),
                    np.full(B, hot), rng.integers(0, 40, B))


def warp_group_lanes(rng, B, n_cells, n_dust, device):
    """Warps of 32 lanes whose cells form groups of 1, 2, 31 and 32 equal
    lanes, contiguous and interleaved (the last warp may be partial), with
    drop-slot lanes among them; uids from a pool of 6 (repeated and tied)."""
    lane = np.arange(32)
    patterns = [np.zeros(32, int), np.where(lane == 13, 1, 0), lane // 2,
                lane, lane % 2, np.where(lane % 3 == 0, 0, 1 + lane)]
    n_warps = -(-B // 32)
    pick = rng.integers(0, len(patterns), n_warps)
    base = rng.integers(0, n_cells - 40, n_warps)
    enter = np.concatenate([base[w] + patterns[pick[w]]
                            for w in range(n_warps)])[:B]
    cell_dep = np.roll(enter, 32 * int(rng.integers(1, 9)))
    enter[rng.random(B) < 0.1] = n_cells
    dep = rng.exponential(1.0, (B, n_dust))
    dep[rng.random(B) < 0.2] = 0.0
    return _tensors(device, cell_dep, dep, enter, rng.integers(0, 6, B))


# ---------------------------------------------------------------- checks --

def _compare(stats, plain, what):
    """Counts and uids equal, energies within RTOL of the float64 plain
    run; returns the max abs energy error."""
    import torch
    stats.flush()
    torch.cuda.synchronize()
    es64, npc, luid = plain
    if not torch.equal(stats.n_photons_cell, npc):
        raise AssertionError('%s: visit counts differ from the plain version'
                             % what)
    if not torch.equal(stats.last_uid, luid):
        raise AssertionError('%s: last uids differ from the plain version'
                             % what)
    err = (stats.energy_sum.double() - es64).abs()
    if not bool((err <= RTOL * es64.abs()).all()):
        raise AssertionError('%s: energies beyond rtol %g: worst rel %g'
                             % (what, RTOL, float((err / es64.abs().clamp_min(
                                 1e-30)).max())))
    return float(err.max()) if err.numel() else 0.0


def _plain_tables(n_dust, n_cells, device):
    import torch
    return (torch.zeros((n_dust, n_cells), dtype=torch.float64,
                        device=device),
            torch.zeros(n_cells, dtype=torch.int64, device=device),
            torch.full((n_cells + 1,), -2, dtype=torch.int32, device=device))


def _plain_call(dv, plain, cd, dep, enter, uid):
    dv.deposit_visit_reference(plain[0], plain[1], plain[2], cd,
                               None if dep is None else dep.double(), enter,
                               uid)


def check_calls(dv, calls, n_dust, n_cells, device, what):
    """A list of (cell_dep, dep or None, enter, uid) calls carried through
    the kernel (no flush between them: the scratch tables carry the uids)
    and through the plain version in float64."""
    import torch
    stats = dv.DepositVisit(n_dust, n_cells, device, torch.float32)
    plain = _plain_tables(n_dust, n_cells, device)
    for lanes in calls:
        stats(*lanes)
        _plain_call(dv, plain, *lanes)
    return _compare(stats, plain, what)


def check_sequence(dv, makes, B, n_cells, n_dust, n_calls, device, seed,
                   what):
    """n_calls carried calls, call k of makes[k % len(makes)](...) lanes,
    through the kernel and the plain version (check_calls)."""
    rng = np.random.default_rng(seed)
    calls = [makes[k % len(makes)](rng, B, n_cells, n_dust, device)
             for k in range(n_calls)]
    return check_calls(dv, calls, n_dust, n_cells, device, what)


def check_overwrite(dv, device):
    """Uids 5, 3, 5 enter one cell in three carried calls at the tutorial's
    shape, no other lane entering it: count 3 and last uid 5."""
    import torch
    B, n_cells, _ = TUTORIAL
    hot = 7
    rng = np.random.default_rng(535)
    stats = dv.DepositVisit(1, n_cells, device, torch.float32)
    plain = _plain_tables(1, n_cells, device)
    for u in (5, 3, 5):
        cd, dep, enter, uid = mixed_lanes(rng, B, n_cells, 1, device)
        enter[enter == hot] = hot + 1
        enter[0], uid[0] = hot, u
        stats(cd, dep, enter, uid)
        _plain_call(dv, plain, cd, dep, enter, uid)
    err = _compare(stats, plain, '5, 3, 5')
    got = (int(stats.n_photons_cell[hot]), int(stats.last_uid[hot]))
    if got != (3, 5):
        raise AssertionError('5, 3, 5: count and last uid %s, not (3, 5)'
                             % (got,))
    return err


def check_graph(dv, device, per_graph, replays):
    """A CUDA graph of ``per_graph`` calls at the tutorial's shape (with
    two, a refill's visits-only call and a step's call) on static lane
    buffers that take new lanes before each of ``replays`` replays, as a
    graph of the step would: the same tables as the plain version over the
    per_graph x replays calls. The kernel keeps its turn on the device, so
    any count of calls replays exactly."""
    import torch
    B, n_cells, n_dust = TUTORIAL
    rng = np.random.default_rng(100 + per_graph)
    forms = [visits_only, mixed_lanes] if per_graph == 2 else [mixed_lanes]

    def lanes():
        return [forms[k % len(forms)](rng, B, n_cells, n_dust, device)
                for k in range(per_graph)]

    static = lanes()
    stats = dv.DepositVisit(n_dust, n_cells, device, torch.float32)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in static:
            stats(*call)
    plain = _plain_tables(n_dust, n_cells, device)
    for _ in range(replays):
        for buf, new in zip(static, lanes()):
            for b, n in zip(buf, new):
                if b is not None:
                    b.copy_(n)
        graph.replay()
        for call in static:
            _plain_call(dv, plain, *call)
    return _compare(stats, plain, 'CUDA graph of %d call(s), %d replays'
                    % (per_graph, replays))


# ---------------------------------------------------------------- timing --

def graph_us(call, n_calls=100, replays=20):
    """Device microseconds per call: n_calls calls captured in a CUDA
    graph, the replay timed with CUDA events; the median over replays."""
    import torch
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_calls):
            call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) * 1e3 / n_calls)
    return float(np.median(times))


def host_us(call, n_calls=1000):
    """Host microseconds per call: the host clock around n_calls eager
    calls, read before the synchronise."""
    import torch
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / n_calls


def event_ms(call, n=20):
    """Milliseconds per call: CUDA events around single eager calls (host
    cost included where the device waits for it); the median."""
    import torch
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        call()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def bound_bytes(cell_dep, dep, enter, n_cells):
    """The bytes the function must move for these inputs: every lane input
    read once (int64 cells, int32 uids, float32 deposits; a visits-only
    call, dep None, has no deposits and reads no cell_dep); per (dust,
    cell) with a non-zero deposit its energy read and written (8 bytes);
    per entered cell its last uid and its int64 count read and written
    (24 bytes). The arithmetic (a few operations per lane) is far below
    the card's rates, so bytes bound it."""
    import torch
    B = enter.shape[0]
    n_dust = 0 if dep is None else dep.shape[1]
    lane = B * (8 + 4) + (0 if dep is None else B * (8 + 4 * n_dust))
    energy = sum(int(torch.unique(cell_dep[dep[:, d] != 0]).numel())
                 for d in range(n_dust)) * 8
    entered = int(torch.unique(enter[enter < n_cells]).numel()) * 24
    return lane + energy + entered


def time_turn(call, n):
    """One turn of timing ``call``, which makes n kernel calls: per kernel
    call, device microseconds (~100 calls in a CUDA graph), host
    microseconds (~1,000 eager calls) and one eager run between CUDA events
    in milliseconds."""
    return dict(device_us=graph_us(call, max(2, 100 // n)) / n,
                host_us=host_us(call, max(10, 1000 // n)) / n,
                call_ms=event_ms(call) / n)


def contention(calls, n_cells):
    """Per call, the cell that most lanes enter and the cell that most
    non-zero deposits go to: its share of the call's lanes, and the warps
    (32 lanes) and blocks (256) that hold those lanes, which is how many
    same-address atomics per table reach L2 after a merge per warp or per
    block. The max and mean over the calls, for entries and deposits."""
    import torch
    rows = dict(enter=[], deposit=[])
    for cd, dep, enter, _ in calls:
        keys = dict(enter=enter.masked_fill(enter >= n_cells, -1))
        if dep is not None:
            keys['deposit'] = cd.masked_fill((dep == 0).all(1), -1)
        for what, key in keys.items():
            hot = torch.bincount(key[key >= 0], minlength=n_cells).argmax()
            lanes = torch.nonzero(key == hot).flatten()
            rows[what].append((lanes.numel() / key.numel(),
                               torch.unique(lanes // 32).numel(),
                               torch.unique(lanes // 256).numel()))
    out = {}
    for what, r in rows.items():
        a = np.array(r, dtype=float)
        out[what] = dict(calls=len(r), share_max=a[:, 0].max(),
                         share_mean=a[:, 0].mean(), warps_max=a[:, 1].max(),
                         warps_mean=a[:, 1].mean(), blocks_max=a[:, 2].max(),
                         blocks_mean=a[:, 2].mean())
    return out


def time_calls(dv, calls, n_dust, n_cells, device):
    """Per call of a list of (cell_dep, dep, enter, uid) calls (dep None for
    visits only): device and host time of the kernel, its time between CUDA
    events, the plain version's time, the deposits-only index_add_
    yardstick (per call with deposits) and the bound (the calls' mean).
    Returns a dict."""
    import torch
    n = len(calls)
    stats = dv.DepositVisit(n_dust, n_cells, device, torch.float32)
    plain = _plain_tables(n_dust, n_cells, device)
    plain = (plain[0].float(),) + plain[1:]
    lib = torch.zeros((n_dust, n_cells), device=device)
    deposits = [(cd, dep.T) for cd, dep, _, _ in calls if dep is not None]

    def kernel():
        for lanes in calls:
            stats(*lanes)

    def plain_call():
        for cd, dep, enter, uid in calls:
            dv.deposit_visit_reference(plain[0], plain[1], plain[2], cd, dep,
                                       enter, uid)

    def library():
        for cd, dep_t in deposits:
            lib.index_add_(1, cd, dep_t)

    # in turns: plain, kernel, kernel, plain
    plain_ms = [event_ms(plain_call) / n]
    turns = [time_turn(kernel, n) for _ in range(2)]
    plain_ms.append(event_ms(plain_call) / n)
    res = {k: float(np.median([t[k] for t in turns])) for k in turns[0]}
    res['plain_ms'] = float(np.median(plain_ms))
    res['library_ms'] = graph_us(library, max(2, 100 // len(deposits))) \
        / len(deposits) / 1e3
    nbytes = float(np.mean([bound_bytes(cd, dep, enter, n_cells)
                            for cd, dep, enter, _ in calls]))
    res.update(calls=n, B=int(calls[0][2].shape[0]), n_cells=n_cells,
               n_dust=n_dust, bound_bytes=nbytes,
               bound_us=nbytes / HBM_BYTES_PER_S * 1e6)
    return res


def warm_engine(geo, dt, st, density, n_photons, batch, config, mrw=None,
                warmup=20):
    """A model's first Lucy iteration on the card, run through ``warmup``
    steps: (carry, step, generator)."""
    import torch
    from hyperion_tpu_torch.transport import engine
    from hyperion_tpu_torch.transport.lucy import compute_jnu_var

    jid, jfrac = compute_jnu_var(dt, torch.zeros_like(density))
    gen = torch.Generator(device=density.device).manual_seed(1)
    carry = engine._init_lucy_carry(dt, density, n_photons, batch)
    step = engine.make_lucy_step(geo, dt, st, density, jid, jfrac, config,
                                 mrw=mrw)
    for _ in range(warmup):
        step(carry, gen)
    torch.cuda.synchronize()
    return carry, step, gen


def tutorial_engine(batch=TUTORIAL[0], warmup=20):
    """The tutorial model's first Lucy iteration on the card, built with
    the port's front end and run through ``warmup`` steps: (carry, step,
    generator, geometry)."""
    import torch
    from hyperion_tpu_torch.model.run import _density_array
    from hyperion_tpu_torch.transport.dtable import build_dust_tables
    from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
    from hyperion_tpu_torch.transport.stable import build_source_tables

    dev, f32 = torch.device('cuda'), torch.float32
    m = tutorial_model()
    geo = build_cartesian_geometry(m.grid, dev, f32)
    dt = build_dust_tables(m._dust_objects(), dev, f32)
    st = build_source_tables(m.sources, dev, f32,
                             length_scale=geo.length_scale)
    density = _density_array(m, geo.length_scale, dev, f32)
    config = dict(n_inter_max=m.n_inter_max, kill_on_scatter=False,
                  kill_on_absorb=False, check_frequency=0.0)
    return warm_engine(geo, dt, st, density, m.n_photons['initial'], batch,
                       config, warmup=warmup) + (geo,)


def yso_thick_engine(warmup=20):
    """bench.py's yso_thick configuration's first Lucy iteration on the
    card (B = 4,096, MRW with gamma 1, source re-absorption), run through
    ``warmup`` steps: (carry, step, generator, geometry)."""
    import torch
    from hyperion_tpu_torch.transport.mrw import prepare_mrw_tables

    geo, dt, st, density = yso_thick_tables()
    mrw = prepare_mrw_tables(dt, density, torch.zeros_like(density),
                             YSO_THICK['mrw_gamma'])
    config = dict(n_inter_max=1000000, kill_on_scatter=False,
                  kill_on_absorb=False, check_frequency=0.0,
                  n_mrw_max=YSO_THICK['n_mrw_max'],
                  n_reabs_max=YSO_THICK['n_reabs_max'],
                  source_intersect=st.any_intersect)
    return warm_engine(geo, dt, st, density, 2_000_000,
                       YSO_THICK['batch_size'], config, mrw=mrw,
                       warmup=warmup) + (geo,)


def record_calls(dv, engine, n_steps=40):
    """The lanes of every deposit_visit call of ``n_steps`` steps of a warm
    engine (carry, step, generator, ...), refills included: a list of
    (cell_dep, dep, enter, uid), cell_dep and dep None for the refills'
    visits-only calls."""
    carry, step, gen = engine[:3]
    calls = []
    run = dv.DepositVisit.__call__

    def recording(self, cell_dep, dep, enter, uid):
        calls.append((None if dep is None else cell_dep.clone(),
                      None if dep is None else dep.clone(), enter.clone(),
                      uid.clone()))
        run(self, cell_dep, dep, enter, uid)

    dv.DepositVisit.__call__ = recording
    try:
        for _ in range(n_steps):
            step(carry, gen)
    finally:
        dv.DepositVisit.__call__ = run
    return calls


def record_tutorial_calls(dv, n_steps=40):
    """The deposit_visit calls of ``n_steps`` steps of the tutorial's first
    iteration after 20 warm-up steps (:func:`record_calls`)."""
    return record_calls(dv, tutorial_engine(), n_steps)


def kernel_phase(dv, device, card):
    """Phase 3. Returns (max abs energy error, check rows, timing rows,
    the tutorial calls' contention)."""
    errs, rows = [], []

    def record(what, err):
        errs.append(err)
        rows.append(dict(check=what, max_abs_err=err))
        phase('deposit_visit %s: counts and uids equal, max abs energy err '
              '%.3g' % (what, err))

    seed = 0
    for B, n_cells in SHAPES:
        for n_dust in (1, 2):
            seed += 1
            record('B=%d n_cells=%d n_dust=%d, 8 calls' % (B, n_cells, n_dust),
                   check_sequence(dv, [mixed_lanes], B, n_cells, n_dust, 8,
                                  device, seed, 'mixed'))
    B, n_cells, _ = TUTORIAL
    for n_dust in (1, 2):
        record('visits only between steps B=%d n_cells=%d n_dust=%d, 8 '
               'calls' % (B, n_cells, n_dust),
               check_sequence(dv, [visits_only, mixed_lanes], B, n_cells,
                              n_dust, 8, device, 8 + n_dust, 'visits only'))
    record('hot cell B=%d n_cells=%d, 4 calls' % (B, n_cells),
           check_sequence(dv, [hot_lanes], B, n_cells, 1, 4, device, 11,
                          'hot'))
    record('warp groups B=131072 n_cells=%d n_dust=2, 4 calls' % n_cells,
           check_sequence(dv, [warp_group_lanes], 131072, n_cells, 2, 4,
                          device, 12, 'warp groups'))
    record('5, 3, 5 over three calls', check_overwrite(dv, device))
    for per_graph, replays in ((1, 5), (2, 4), (100, 2)):
        record('CUDA graph of %d call(s), %d replays' % (per_graph, replays),
               check_graph(dv, device, per_graph, replays))
    recorded = record_tutorial_calls(dv)
    n_vis = sum(dep is None for _, dep, _, _ in recorded)
    record('tutorial calls, 40 steps (%d calls, %d visits only)'
           % (len(recorded), n_vis),
           check_calls(dv, recorded, 1, n_cells, device, 'tutorial calls'))
    hot = contention(recorded, n_cells)
    for what, h in hot.items():
        phase('tutorial calls, hottest cell by %s over %d calls: share of '
              'lanes max %.4f mean %.4f; warps holding it max %d mean %.1f; '
              'blocks max %d mean %.1f' % (
                  what, h['calls'], h['share_max'], h['share_mean'],
                  h['warps_max'], h['warps_mean'], h['blocks_max'],
                  h['blocks_mean']))

    # (lanes, calls, n_dust, n_cells): one call at each of the four shapes
    # and the hot cell, then the very calls of 40 tutorial steps
    cases = []
    hot_k = 2 * len(SHAPES)
    for k, (B, n_cells, n_dust) in enumerate(
            [(B, c, d) for B, c in SHAPES for d in (1, 2)] + [TUTORIAL]):
        make = hot_lanes if k == hot_k else mixed_lanes
        lanes = make(np.random.default_rng(20 + k), B, n_cells, n_dust,
                     device)
        cases.append(('hot cell' if k == hot_k else 'mixed', [lanes], n_dust,
                      n_cells))
    cases.append(('tutorial steps', recorded, 1, TUTORIAL[1]))
    timings = []
    for name, calls, n_dust, n_cells in cases:
        t = time_calls(dv, calls, n_dust, n_cells, device)
        t['lanes'] = name
        timings.append(t)
        phase('deposit_visit %s (%d calls) B=%d n_cells=%d n_dust=%d: '
              'device %.2f us, host %.2f us per call (one eager call %.4f '
              'ms), plain %.4f ms, index_add_ %.4f ms, bound %.3f us (%d '
              'bytes) [%s]'
              % (name, t['calls'], t['B'], n_cells, n_dust, t['device_us'],
                 t['host_us'], t['call_ms'], t['plain_ms'], t['library_ms'],
                 t['bound_us'], t['bound_bytes'], card))
    return max(errs), rows, timings, hot


def yso_calls_phase(dv, device, card):
    """Phase 6: deposit_visit on the calls of 40 steps of bench.py's
    yso_thick configuration (after 20 warm-up steps), refills included:
    against the plain version, the busiest cell's share of them, and their
    times. Returns (max abs energy error, check row, timing row,
    contention)."""
    recorded = record_calls(dv, yso_thick_engine())
    n_cells = SHAPES[-1][1]
    n_vis = sum(dep is None for _, dep, _, _ in recorded)
    what = 'yso_thick calls, 40 steps (%d calls, %d visits only)' % (
        len(recorded), n_vis)
    err = check_calls(dv, recorded, 1, n_cells, device, 'yso_thick calls')
    phase('deposit_visit %s: counts and uids equal, max abs energy err %.3g'
          % (what, err))
    hot = contention(recorded, n_cells)
    for kind, h in hot.items():
        phase('yso_thick calls, hottest cell by %s over %d calls: share of '
              'lanes max %.4f mean %.4f; warps holding it max %d mean %.1f; '
              'blocks max %d mean %.1f' % (
                  kind, h['calls'], h['share_max'], h['share_mean'],
                  h['warps_max'], h['warps_mean'], h['blocks_max'],
                  h['blocks_mean']))
    t = time_calls(dv, recorded, 1, n_cells, device)
    t['lanes'] = 'yso_thick steps'
    phase('deposit_visit yso_thick steps (%d calls) B=%d n_cells=%d: device '
          '%.2f us, host %.2f us per call (one eager call %.4f ms), plain '
          '%.4f ms, index_add_ %.4f ms, bound %.3f us (%d bytes) [%s]'
          % (t['calls'], t['B'], n_cells, t['device_us'], t['host_us'],
             t['call_ms'], t['plain_ms'], t['library_ms'], t['bound_us'],
             t['bound_bytes'], card))
    return err, dict(check=what, max_abs_err=err), t, hot


# ----------------------------------------------------------------- slice --

def tutorial_model():
    """examples/quickstart.py with its peeled image and SED, with a fixed
    seed, built with the port's own front end."""
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.model import Model
    from hyperion_tpu_torch.util.constants import au, lsun
    nu = np.logspace(8, 17, 32)
    dust = IsotropicDust(nu, np.repeat(0.4, 32), np.repeat(100.0, 32))
    m = Model()
    lim = 50 * au
    m.set_cartesian_grid(np.linspace(-lim, lim, 33),
                         np.linspace(-lim, lim, 33),
                         np.linspace(-lim, lim, 33))
    m.add_density_grid(np.full(m.grid.shape, 1e-19), dust)
    src = m.add_point_source()
    src.luminosity = lsun
    src.temperature = 6000.0
    sed = m.add_peeled_images(sed=True, image=True)
    sed.set_viewing_angles([45.0], [0.0])
    sed.set_image_size(128, 128)
    sed.set_image_limits(-lim, lim, -lim, lim)
    sed.set_wavelength_range(60, 0.3, 1000.0)
    sed.set_aperture_radii(1, 2 * lim, 2 * lim)
    m.set_n_initial_iterations(4)
    m.set_n_photons(initial=500_000, imaging=1_000_000)
    m.set_seed(20261016)
    return m


@contextlib.contextmanager
def imaging_syncs():
    """Count the host synchronisations of the imaging iteration
    (``imaging.run_final``, table set-up included) with torch's sync debug
    mode; yields the list of counts, one per run."""
    import torch
    from hyperion_tpu_torch.transport import imaging

    counts = []
    inner = imaging.run_final

    def counted(*args, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('warn')
            try:
                out = inner(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode('default')
        counts.append(sum('synchroniz' in str(w.message) for w in caught))
        return out

    imaging.run_final = counted
    try:
        yield counts
    finally:
        imaging.run_final = inner


@contextlib.contextmanager
def peel_events():
    """Count the imaging step's peel events that walk (a call of
    ``imaging.peel_and_bin`` with a group that does not ignore the optical
    depth); yields a one-item list."""
    from hyperion_tpu_torch.transport import imaging

    count = [0]
    inner = imaging.peel_and_bin

    def counted(walk, dt, groups, *args, **kw):
        count[0] += any(not g.ignore_optical_depth for g in groups)
        return inner(walk, dt, groups, *args, **kw)

    imaging.peel_and_bin = counted
    try:
        yield count
    finally:
        imaging.peel_and_bin = inner


def check_imaging(what, run, n_photons, syncs, card):
    """The imaging row of a run: energy_current the photon count, no
    geometry kills, at most 1.05 host reads per step, the peeled arrays
    finite and >= 0. Returns the row with ms per step and reads per step."""
    img = run.imaging
    rows = [r for r in run.perf.rows if r['label'] == 'imaging']
    if len(rows) != 1 or img is None:
        raise AssertionError('%s: no imaging iteration ran' % what)
    row = dict(rows[0])
    if img.energy_current != n_photons:
        raise AssertionError('%s imaging: energy_current %r'
                             % (what, img.energy_current))
    per_step = syncs[-1] / img.n_steps
    if per_step > 1.05:
        raise AssertionError('%s imaging: %.3f host reads per step'
                             % (what, per_step))
    for g in img.peeled:
        for name, (data, _) in g['datasets'].items():
            if not np.isfinite(data).all() or (data < 0).any():
                raise AssertionError('%s imaging: %s not finite and >= 0'
                                     % (what, name))
    row.update(ms_per_step=img.wall * 1e3 / img.n_steps,
               host_reads_per_step=per_step,
               occupancy=img.n_events / (img.n_steps * img.batch_size))
    phase('%s imaging: %d photons in %.3f s, %d steps, %.3f ms per step, '
          '%.3f host reads per step, occupancy %.4f, killed_int %d [%s]'
          % (what, n_photons, img.wall, img.n_steps, row['ms_per_step'],
             per_step, row['occupancy'], img.killed_int, card))
    return row


def band_fraction(temperature, wav_min, wav_max):
    """The share of a blackbody's luminosity between two wavelengths
    (micron), over the port's own spectrum range of a ``temperature``
    source (numpy, trapezoids on a fine log grid)."""
    from hyperion_tpu_torch.util.constants import c
    from hyperion_tpu_torch.util.functions import B_nu, planck_nu_range
    nu_src = planck_nu_range(temperature)
    nu = np.geomspace(nu_src.min(), nu_src.max(), 200001)
    b = B_nu(nu, temperature)

    def integral(sel):
        x, y = nu[sel], b[sel]
        return float(np.sum(0.5 * (y[1:] + y[:-1]) * np.diff(x)))

    band = (nu >= c / (wav_max * 1e-4)) & (nu <= c / (wav_min * 1e-4))
    return integral(band) / integral(np.ones_like(band))


def run_slice(dv, et, card):
    """Phase 4: the tutorial through run_lucy_model, the port's run_model
    without its .rtout file: 4 Lucy iterations, then imaging. Returns
    (deposit_visit launches, escape_tau launches, per-iteration rows,
    wall, imaging report, the last iteration's specific energy)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model
    from hyperion_tpu_torch.util.constants import lsun

    m = tutorial_model()
    dv.launches = 0
    et.launches = 0
    t0 = time.time()
    with imaging_syncs() as syncs, peel_events() as events:
        run = run_lucy_model(m, device='cuda')
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dv.launches
    launches_et = et.launches

    temp = run.result.temperature[0]
    dusty = run.density0[0] > 0
    if not np.isfinite(temp).all() or not (temp[dusty] > 0).all():
        raise AssertionError('temperatures not finite and > 0 in dusty cells')
    if run.result.iterations != 4 or len(run.perf.rows) != 5:
        raise AssertionError('ran %d iterations' % run.result.iterations)
    steps = 0
    for i, row in enumerate(run.perf.rows[:4], 1):
        killed = (row['killed_geo'], row['killed_int'])
        if killed != (0, 0) or row['energy_current'] != 500_000:
            raise AssertionError('iteration %d: killed %s, energy_current %r'
                                 % (i, killed, row['energy_current']))
        steps += row['steps']
        phase('slice iteration %d: %.3f s, %.0f photons/s, %d steps, '
              'occupancy %.4f [%s]'
              % (i, row['wall'], row['photons'] / row['wall'], row['steps'],
                 row['events'] / (row['steps'] * row['lanes']), card))
    # one launch per step, plus one per refill (at most one per step)
    if not steps < launches <= 2 * steps:
        raise AssertionError('deposit_visit launches %d vs %d steps'
                             % (launches, steps))
    img = check_imaging('slice', run, 1_000_000, syncs, card)
    if img['killed_int'] or launches_et == 0:
        raise AssertionError('slice imaging: killed %d, escape_tau launches '
                             '%d' % (img['killed_int'], launches_et))
    # the band-integrated peeled luminosity (isotropic equivalent): the box
    # is optically thin, so the light that escapes is the light emitted
    sed = run.imaging.peeled[0]['datasets']['seds'][0][0, 0, 0, 0]
    dlnnu = np.log((1000.0 / 0.3)) / 60
    band = float(sed.sum()) * dlnnu
    expected = lsun * band_fraction(6000.0, 0.3, 1000.0)
    image = run.imaging.peeled[0]['datasets']['images'][0]
    if abs(band / expected - 1.0) > 0.02:
        raise AssertionError('slice: peeled band luminosity %.6e against '
                             '%.6e expected' % (band, expected))
    n_img = run.imaging.n_steps
    img.update(band_luminosity=band, expected=expected,
               ratio=band / expected, image_sum=float(image.sum()),
               escape_tau_launches=launches_et, peel_events=events[0],
               escape_tau_launches_per_step=launches_et / n_img)
    # one launch per peel event, and one per forced first interaction
    # (a refill: at most one per step)
    phase('slice imaging: band luminosity %.6e erg/s = %.5f x expected '
          '(%.6e), image sum %.6e, escape_tau launches %d (%.3f per imaging '
          'step) for %d peel events [%s]'
          % (band, band / expected, expected, image.sum(), launches_et,
             launches_et / n_img, events[0], card))
    if not events[0] <= launches_et <= events[0] + n_img:
        raise AssertionError('slice imaging: %d escape_tau launches for %d '
                             'peel events over %d steps'
                             % (launches_et, events[0], n_img))
    phase('slice: 4 x 500000 photons and 1000000 imaging photons in %.3f s '
          'wall (run_lucy_model), T %.1f .. %.1f K, deposit_visit launches '
          '%d over %d steps [%s]'
          % (wall, temp[dusty].min(), temp.max(), launches, steps, card))
    return launches, launches_et, [dict(row) for row in run.perf.rows[:4]], \
        wall, img, run.iterations[-1]['specific_energy']


# --------------------------------------------------------------- physics --

def physics_on_card(card):
    """Phase 5: the thin inverse-square check, bench.py's quickstart
    configuration, and the host synchronisations per step."""
    import torch
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.grid import CartesianGrid
    from hyperion_tpu_torch.sources import PointSource
    from hyperion_tpu_torch.transport import engine
    from hyperion_tpu_torch.transport.dtable import build_dust_tables
    from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
    from hyperion_tpu_torch.transport.lucy import compute_jnu_var, run_lucy
    from hyperion_tpu_torch.transport.stable import build_source_tables

    dev, f32 = torch.device('cuda'), torch.float32

    def point_model(n, chi, albedo, rho, n_nu):
        grid = CartesianGrid(*[np.linspace(-1, 1, n + 1)] * 3)
        nu = np.logspace(5, 18, n_nu)
        dust = IsotropicDust(nu, np.repeat(albedo, n_nu),
                             np.repeat(chi, n_nu))
        geo = build_cartesian_geometry(grid, dev, f32)
        dt = build_dust_tables([dust], dev, f32)
        st = build_source_tables([PointSource(luminosity=1.0,
                                              temperature=5000.0)], dev, f32,
                                 length_scale=geo.length_scale)
        density = torch.full((1, grid.n_cells), rho * geo.length_scale,
                             dtype=f32, device=dev)
        return grid, geo, dt, st, density

    grid, geo, dt, st, density = point_model(15, 1.0, 0.0, 1e-4, 20)
    res = run_lucy(geo, dt, st, density,
                   torch.Generator(device=dev).manual_seed(7),
                   n_photons=200000, n_iterations=1, batch_size=8192,
                   verbose=False)
    se = res.specific_energy[0].reshape(grid.shape)
    r = np.sqrt(grid.gx ** 2 + grid.gy ** 2 + grid.gz ** 2)
    sel = (r > 0.35) & (r < 0.75)
    ratio = se[sel] / (1.0 / (4 * np.pi * r[sel] ** 2))
    med = float(np.median(ratio))
    if abs(med - 1.0) >= 0.05 or res.killed_geo or res.killed_int:
        raise AssertionError('inverse square: median ratio %g, killed %d/%d'
                             % (med, res.killed_int, res.killed_geo))
    phase('inverse square (float32): median ratio %.4f, std %.4f'
          % (med, float(np.std(ratio))))

    # bench.py:61-91: 15^3, gray dust of albedo 0.3, 2M photons, B = 131072
    grid, geo, dt, st, density = point_model(15, 1.0, 0.3, 0.2, 24)
    jid, jfrac = compute_jnu_var(dt, torch.zeros_like(density))
    config = dict(n_inter_max=1000000, kill_on_scatter=False,
                  kill_on_absorb=False, max_steps=1000000)
    gen = torch.Generator(device=dev).manual_seed(1)
    engine.run_lucy_iteration(geo, dt, st, density, jid, jfrac, gen, 200000,
                              131072, config)
    torch.cuda.synchronize()
    t0 = time.time()
    out = engine.run_lucy_iteration(geo, dt, st, density, jid, jfrac, gen,
                                    2_000_000, 131072, config)
    e_current = float(out[1])
    torch.cuda.synchronize()
    wall = time.time() - t0
    if e_current != 2_000_000 or int(out[3]) or int(out[4]):
        raise AssertionError('bench quickstart: E %g killed %d/%d'
                             % (e_current, int(out[3]), int(out[4])))
    bench = dict(photons=2_000_000, wall_s=wall, photons_per_sec=2e6 / wall,
                 steps=int(out[5]),
                 occupancy=int(out[7]) / (int(out[5]) * 131072))
    phase('bench quickstart config: %.4f s, %.1f photons/s, %d steps, '
          'occupancy %.4f [%s]' % (wall, bench['photons_per_sec'],
                                   bench['steps'], bench['occupancy'], card))

    # host synchronisations per step, counted by torch's sync debug mode
    carry = engine._init_lucy_carry(dt, density, 2_000_000, 131072)
    step = engine.make_lucy_step(geo, dt, st, density, jid, jfrac,
                                 dict(config, check_frequency=0.001))
    step(carry, gen)
    torch.cuda.synchronize()
    n_steps = 50
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            for _ in range(n_steps):
                step(carry, gen)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = sum('synchroniz' in str(w.message) for w in caught)
    bench['host_syncs_per_step'] = syncs / n_steps
    phase('host synchronisations per step: %.2f (%d over %d steps)'
          % (syncs / n_steps, syncs, n_steps))
    bench['binned'] = binned_check(card)
    return med, bench


def binned_check(card):
    """tests/test_binned_images.py:9-41 on the card in float32, with that
    test's model (9^3 cells, forced first interaction off, 30,000 Lucy and
    100,000 imaging photons, 4 x 2 direction bins): all the emitted energy
    leaves the grid (within 5% of L_sun), and each theta bin's flux is in
    proportion to its solid angle (within 10%)."""
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.model import Model, run_lucy_model
    from hyperion_tpu_torch.util.constants import au, lsun

    nu = np.logspace(5, 18, 30)
    dust = IsotropicDust(nu, np.repeat(0.3, 30), np.repeat(2.0, 30))
    m = Model()
    lim = 3 * au
    w = np.linspace(-lim, lim, 10)
    m.set_cartesian_grid(w, w, w)
    m.add_density_grid(np.full(m.grid.shape, 1e-17), dust)
    s = m.add_point_source()
    s.luminosity = lsun
    s.temperature = 6000.0
    m.set_forced_first_interaction(False)
    m.set_n_photons(initial=30000, imaging=100000)
    m.set_n_initial_iterations(1)
    binned = m.add_binned_images(sed=True, image=False)
    binned.set_viewing_bins(4, 2)
    binned.set_wavelength_range(60, 0.1, 1500.0)
    m.set_seed(12345)
    run = run_lucy_model(m, device='cuda')
    # seds: (n_stokes, n_orig, n_view, n_ap, n_nu); the one aperture
    val = run.imaging.binned['datasets']['seds'][0][0, 0, :, 0, :]
    dlognu = np.log(1500.0 / 0.1) / 60
    total = float(val.sum()) * dlognu
    per_bin = val.sum(axis=1).reshape(4, 2).sum(axis=1)
    tw = np.linspace(0, np.pi, 5)
    solid = np.cos(tw[:-1]) - np.cos(tw[1:])
    expected = per_bin.sum() * solid / solid.sum()
    dev = np.abs(per_bin / expected - 1.0)
    if abs(total / lsun - 1.0) >= 0.05 or (dev >= 0.1).any() or \
            run.imaging.killed_int:
        raise AssertionError('binned: total %.4f L_sun, theta bins %s of '
                             'their solid angle, killed %d'
                             % (total / lsun, per_bin / expected,
                                run.imaging.killed_int))
    phase('binned (float32, 100000 photons): total %.5f L_sun, theta bins '
          '%s of their solid-angle share, %d imaging steps [%s]'
          % (total / lsun, np.round(per_bin / expected, 4).tolist(),
             run.imaging.n_steps, card))
    return dict(total_lsun=total / lsun,
                theta_ratio=(per_bin / expected).tolist(),
                steps=run.imaging.n_steps)


# ------------------------------------------------------------------ yso --

@contextlib.contextmanager
def transport_syncs():
    """Count the host synchronisations inside each Lucy iteration's
    transport loop (``lucy.run_lucy_iteration``, table set-up included)
    with torch's sync debug mode; yields the list of per-iteration
    counts."""
    import torch
    from hyperion_tpu_torch.transport import lucy

    counts = []
    inner = lucy.run_lucy_iteration

    def counted(*args, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('warn')
            try:
                out = inner(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode('default')
        counts.append(sum('synchroniz' in str(w.message) for w in caught))
        return out

    lucy.run_lucy_iteration = counted
    try:
        yield counts
    finally:
        lucy.run_lucy_iteration = inner


def report_iterations(what, rows, syncs, n_photons, card):
    """Print and check per-iteration rows (wall, steps, events, lanes,
    energy_current, killed): energy_current is the photon count, nothing
    is killed by the geometry, and the transport loop reads the device at
    most 1.05 times per step. Returns the rows with the derived figures."""
    out = []
    for i, (row, n_sync) in enumerate(zip(rows, syncs), 1):
        if row['killed_geo'] or row['energy_current'] != n_photons:
            raise AssertionError('%s iteration %d: killed_geo %d, '
                                 'energy_current %r' % (
                                     what, i, row['killed_geo'],
                                     row['energy_current']))
        per_step = n_sync / row['steps']
        if per_step > 1.05:
            raise AssertionError('%s iteration %d: %.3f host syncs per step'
                                 % (what, i, per_step))
        r = dict(row, photons_per_sec=n_photons / row['wall'],
                 ms_per_step=row['wall'] * 1e3 / row['steps'],
                 occupancy=row['events'] / (row['steps'] * row['lanes']),
                 host_syncs_per_step=per_step)
        out.append(r)
        phase('%s iteration %d: %.3f s, %.0f photons/s, %d steps, %.3f ms '
              'per step, occupancy %.4f, %.3f host syncs per step, killed '
              '%d/%d [%s]' % (what, i, r['wall'], r['photons_per_sec'],
                              r['steps'], r['ms_per_step'], r['occupancy'],
                              per_step, r['killed_int'], r['killed_geo'],
                              card))
    return out


def yso_thick_tables():
    """bench.py:103-195's yso_thick configuration, built with the port's
    classes, on the card in float32: a flared disk (2e-5 Msun, 0.1 to 300
    au, tau_mid ~ 7.6e3) on a 64 x 32 x 1 spherical-polar grid, gray dust
    of albedo 0.5 and chi 800 cm^2/g, and a 1 Lsun, 2 Rsun, 4000 K
    spherical star. Returns (geometry, dust tables, source tables, engine
    density)."""
    import torch
    from hyperion_tpu_torch.densities import FlaredDisk
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.grid import SphericalPolarGrid
    from hyperion_tpu_torch.sources import SphericalSource
    from hyperion_tpu_torch.transport.dtable import build_dust_tables
    from hyperion_tpu_torch.transport.gtable_spherical import \
        build_spherical_geometry
    from hyperion_tpu_torch.transport.stable import build_source_tables
    from hyperion_tpu_torch.util.constants import au, lsun, msun, rsun

    dev, f32 = torch.device('cuda'), torch.float32
    rmin, rmax = 0.1 * au, 300.0 * au
    grid = SphericalPolarGrid(
        np.hstack([0.0, np.logspace(np.log10(rmin), np.log10(rmax), 64)]),
        np.linspace(0.0, np.pi, 33), np.array([0.0, 2.0 * np.pi]))
    nu = np.logspace(9, 17, 32)
    dust = IsotropicDust(nu, np.repeat(0.5, 32), np.repeat(800.0, 32))
    disk = FlaredDisk(mass=2e-5 * msun, rmin=rmin, rmax=rmax,
                      r_0=10.0 * au, h_0=1.0 * au, p=-1.0, beta=1.25)
    rho = np.asarray(disk.density(grid), float).reshape(-1)
    geo = build_spherical_geometry(grid, dev, f32)
    dt = build_dust_tables([dust], dev, f32)
    star = SphericalSource(luminosity=lsun, radius=2.0 * rsun,
                           temperature=4000.0)
    st = build_source_tables([star], dev, f32, length_scale=geo.length_scale)
    density = torch.as_tensor(rho[None, :] * geo.length_scale, dtype=f32,
                              device=dev)
    return geo, dt, st, density


def mrw_phase(card, n_photons=20000):
    """Phase 7: tests/test_mrw.py:42-58 on the card in float32, with
    ``n_photons`` photons in one batch: a point source in a box of gray
    absorbing dust whose cells are 20 mean free paths across (4^3 cells of
    density 40, where the test has 6^3 of density 60: the same cells, and
    half the direct run's steps), run with and without MRW (gamma 1). The
    specific energies agree (median ratio within 0.05), MRW takes fewer
    than 0.85 x the steps, and nothing is killed."""
    import torch
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.grid import CartesianGrid
    from hyperion_tpu_torch.sources import PointSource
    from hyperion_tpu_torch.transport.dtable import build_dust_tables
    from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
    from hyperion_tpu_torch.transport.lucy import run_lucy
    from hyperion_tpu_torch.transport.stable import build_source_tables

    dev, f32 = torch.device('cuda'), torch.float32
    grid = CartesianGrid(*[np.linspace(-1, 1, 5)] * 3)
    nu = np.logspace(5, 18, 20)
    dust = IsotropicDust(nu, np.repeat(0.0, 20), np.repeat(1.0, 20))
    geo = build_cartesian_geometry(grid, dev, f32)
    dt = build_dust_tables([dust], dev, f32)
    st = build_source_tables([PointSource(luminosity=1.0, temperature=500.0)],
                             dev, f32, length_scale=geo.length_scale)
    density = torch.full((1, geo.n_cells), 40.0 * geo.length_scale,
                         dtype=f32, device=dev)
    runs = {}
    for use_mrw in (False, True):
        t0 = time.time()
        runs[use_mrw] = run_lucy(
            geo, dt, st, density,
            torch.Generator(device=dev).manual_seed(1 + use_mrw),
            n_photons=n_photons, n_iterations=1, batch_size=n_photons,
            use_mrw=use_mrw, mrw_gamma=1.0, verbose=False)
        phase('MRW %s: %d steps, %.3f s, killed %d/%d [%s]' % (
            'on' if use_mrw else 'off', runs[use_mrw].n_steps,
            time.time() - t0, runs[use_mrw].killed_int,
            runs[use_mrw].killed_geo, card))
    direct, mrw = runs[False], runs[True]
    sel = direct.specific_energy > 0
    med = float(np.median(mrw.specific_energy[sel] /
                          direct.specific_energy[sel]))
    step_ratio = mrw.n_steps / direct.n_steps
    if abs(med - 1.0) >= 0.05 or step_ratio >= 0.85 or any(
            r.killed_int or r.killed_geo for r in runs.values()):
        raise AssertionError('MRW on/off: median ratio %g, steps %d/%d, '
                             'killed %d/%d' % (med, mrw.n_steps,
                                               direct.n_steps,
                                               mrw.killed_int,
                                               direct.killed_int))
    phase('MRW on/off (float32, %d photons): median specific-energy ratio '
          '%.4f, steps %d against %d (%.3f)' % (n_photons, med, mrw.n_steps,
                                                direct.n_steps, step_ratio))
    return dict(photons=n_photons, median_ratio=med,
                steps_mrw=mrw.n_steps, steps_direct=direct.n_steps)


def class2_model(n_photons=200_000, n_iterations=5, n_imaging=500_000):
    """examples/class2_sed.py with its peeled SEDs, built with the port's
    AnalyticalYSOModel and evaluated to a Model (no file: the card's
    machine has no h5py): a flared disk around a 2 Rsun star, HG dust, the
    96 x 32 x 1 auto spherical-polar grid, MRW with gamma 2, Lucy
    iterations with convergence checking (the example: 5 of 200,000
    photons), then ``n_imaging`` imaging photons (the example: 500,000)
    into SEDs at 20, 45 and 80 degrees, with their uncertainties."""
    from hyperion_tpu_torch.dust import HenyeyGreensteinDust
    from hyperion_tpu_torch.model import AnalyticalYSOModel
    from hyperion_tpu_torch.util.constants import au, lsun, msun, rsun

    nu = np.logspace(8, 17, 64)
    dust = HenyeyGreensteinDust(nu, np.repeat(0.5, 64), np.repeat(400.0, 64),
                                np.repeat(0.4, 64), np.repeat(0.8, 64))
    m = AnalyticalYSOModel()
    m.star.luminosity = lsun
    m.star.radius = 2.0 * rsun
    m.star.temperature = 4300.0
    disk = m.add_flared_disk()
    disk.mass = 1e-3 * msun
    disk.rmin = 0.1 * au
    disk.rmax = 200.0 * au
    disk.r_0 = 10.0 * au
    disk.h_0 = 0.4 * au
    disk.p = -1.0
    disk.beta = 1.25
    disk.dust = dust
    m.set_spherical_polar_grid_auto(96, 32, 1)
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([20.0, 45.0, 80.0], [0.0, 0.0, 0.0])
    sed.set_wavelength_range(120, 0.3, 2000.0)
    sed.set_aperture_radii(1, 400 * au, 400 * au)
    # the uncertainties give phase 11 its sigma
    sed.set_uncertainties(True)
    m.set_mrw(True, gamma=2.0)
    m.set_n_initial_iterations(n_iterations)
    m.set_convergence(True, percentile=99., absolute=2., relative=1.02)
    m.set_n_photons(initial=n_photons, imaging=n_imaging)
    m.evaluate_optically_thin_radii()
    return m.to_model()


def class2_phase(dv, et, card, n_photons, n_iterations, max_steps,
                 n_imaging, imaging_max_steps):
    """Phase 8: the class2 YSO model through run_lucy_model on the card
    (run.py's batch rule: B = n_photons / 4, at least 4,096), each Lucy
    iteration capped at ``max_steps``, then ``n_imaging`` imaging photons
    capped at ``imaging_max_steps``. Returns (deposit_visit launches,
    escape_tau launches, report, {specific_energy, seds, seds_unc} for
    phase 11)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model

    m = class2_model(n_photons, n_iterations, n_imaging)
    dv.launches = 0
    et.launches = 0
    t0 = time.time()
    with transport_syncs() as syncs, imaging_syncs() as img_syncs, \
            peel_events() as events:
        run = run_lucy_model(m, device='cuda', max_steps=max_steps,
                             imaging_max_steps=imaging_max_steps)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dv.launches
    launches_et = et.launches
    temp = run.result.temperature[0]
    dusty = run.density0[0] > 0
    if not np.isfinite(temp).all() or not (temp[dusty] > 0).all():
        raise AssertionError('class2: temperatures not finite and > 0 in '
                             'dusty cells')
    rows = report_iterations('class2', run.perf.rows[:-1], syncs, n_photons,
                             card)
    steps = sum(r['steps'] for r in rows)
    img = check_imaging('class2', run, n_imaging, img_syncs, card)
    # seds: (n_stokes, n_orig, n_view, n_ap, n_nu), frequency ascending
    seds = run.imaging.peeled[0]['datasets']['seds'][0][0, 0, :, 0, :]
    s20, s80 = float(seds[0, -1]), float(seds[2, -1])
    if not s20 > 0 or not s80 < s20 or launches_et == 0:
        raise AssertionError('class2: at 0.3 um the 80 degree SED %g, the 20 '
                             'degree one %g; escape_tau launches %d'
                             % (s80, s20, launches_et))
    n_img = run.imaging.n_steps
    img.update(ratio_80_20=s80 / s20, nuLnu_max=seds.max(axis=1).tolist(),
               escape_tau_launches=launches_et, peel_events=events[0],
               escape_tau_launches_per_step=launches_et / n_img,
               peel_events_per_step=events[0] / n_img)
    phase('class2 imaging: 80/20 degree ratio at 0.3 um %.4e, peak nu L_nu '
          'per view %s erg/s, escape_tau launches %d over %d imaging steps: '
          '%.3f per step for %.3f peel events per step [%s]'
          % (s80 / s20, ['%.4e' % v for v in seds.max(axis=1)], launches_et,
             n_img, launches_et / n_img, events[0] / n_img, card))
    # one launch per peel event (class2 has no forced first interaction)
    if launches_et > events[0]:
        raise AssertionError('class2 imaging: %d escape_tau launches for %d '
                             'peel events' % (launches_et, events[0]))
    if not steps < launches <= 2 * steps:
        raise AssertionError('class2: deposit_visit launches %d vs %d steps'
                             % (launches, steps))
    phase('class2: %d iterations (converged: %s) in %.3f s, T %.1f .. %.1f '
          'K, killed_int %d, deposit_visit launches %d over %d steps [%s]'
          % (run.result.iterations, run.result.converged, wall,
             temp[dusty].min(), temp.max(), run.result.killed_int, launches,
             steps, card))
    data = run.imaging.peeled[0]['datasets']
    return launches, launches_et, dict(
        photons=n_photons, max_steps=max_steps, wall_s=wall,
        iterations=rows, converged=bool(run.result.converged),
        launches=launches, steps=steps, imaging=img,
        imaging_cut=dict(photons=n_imaging, max_steps=imaging_max_steps)), \
        dict(specific_energy=run.iterations[-1]['specific_energy'],
             seds=data['seds'][0], seds_unc=data['seds_unc'][0])


def yso_thick_phase(dv, card, n_photons, n_iterations):
    """Phase 9: bench.py's yso_thick configuration through the port's
    transport.lucy.run_lucy, as bench.py calls it (B = 4,096, MRW gamma 1,
    n_mrw_max 100,000, n_reabs_max 100, max_steps 100,000), with
    ``n_photons`` photons per iteration. Nothing may be killed. Returns
    (launches, report)."""
    import torch
    from hyperion_tpu_torch.transport.lucy import run_lucy

    geo, dt, st, density = yso_thick_tables()
    rows = []
    t_last = [time.time()]

    def callback(it, se, rho, n_photons_cell, se_spectrum, stats):
        now = time.time()
        rows.append(dict(stats, wall=now - t_last[0], events=stats['n_events'],
                         steps=stats['n_steps'], lanes=stats['batch_size']))
        t_last[0] = now

    dv.launches = 0
    with transport_syncs() as syncs:
        res = run_lucy(geo, dt, st, density,
                       torch.Generator(device='cuda').manual_seed(1),
                       n_photons, n_iterations, use_mrw=True,
                       verbose=False, iteration_callback=callback,
                       **YSO_THICK)
    launches = dv.launches
    rows = report_iterations('yso_thick', rows, syncs, n_photons, card)
    if any(r['killed_int'] for r in rows):
        raise AssertionError('yso_thick: photons killed: %s'
                             % [r['killed_int'] for r in rows])
    temp = res.temperature[0]
    dusty = res.density[0] > 0
    if not np.isfinite(temp).all() or not (temp[dusty] > 0).all():
        raise AssertionError('yso_thick: temperatures not finite and > 0')
    steps = [r['steps'] for r in rows]
    phase('yso_thick: %d x %d photons, steps per iteration %s (the JAX '
          'package at 2,000,000 photons: %d), deposit_visit launches %d '
          '[%s]' % (n_iterations, n_photons, steps, JAX_YSO_THICK_STEPS,
                    launches, card))
    return launches, dict(photons=n_photons, iterations=rows,
                          launches=launches, T_max=float(temp.max()))


# ---------------------------------------------------------- escape_tau --

def imaging_tables(model, dtype):
    """The model's engine tables on the card in ``dtype``: (geometry, dust
    tables, source tables, density)."""
    import torch
    from hyperion_tpu_torch.model.run import (_density_array,
                                              build_geometry_tables)
    from hyperion_tpu_torch.transport.dtable import build_dust_tables
    from hyperion_tpu_torch.transport.stable import build_source_tables

    dev = torch.device('cuda')
    geo = build_geometry_tables(model.grid, dev, dtype)
    dt = build_dust_tables(model._dust_objects(), dev, dtype)
    st = build_source_tables(model.sources, dev, dtype,
                             length_scale=geo.length_scale,
                             sample_evenly=model.sample_sources_evenly)
    density = _density_array(model, geo.length_scale, dev, dtype)
    return geo, dt, st, density


@contextlib.contextmanager
def walk_calls(windows):
    """Record the escape_tau calls of the imaging steps in each window
    (first, last) of step indices, counted from 0, made inside the block:
    yields {window: calls}, each call the list of its nine lane tensors and
    t_max (cloned)."""
    from hyperion_tpu_torch.transport import escape_tau as et
    from hyperion_tpu_torch.transport import imaging

    calls = {w: [] for w in windows}
    at = [0]          # the index of the step that runs
    inner_call, inner_make = et.EscapeTau.__call__, imaging.make_final_step

    def recording(self, *args, t_max=None):
        for (first, last), rec in calls.items():
            if first <= at[0] < last:
                rec.append([a.clone() for a in args] +
                           [None if t_max is None else t_max.clone()])
        return inner_call(self, *args, t_max=t_max)

    def counting(*args, **kw):
        step = inner_make(*args, **kw)

        def counted(carry, generator):
            at[0] = carry.n_steps
            step(carry, generator)
        return counted

    et.EscapeTau.__call__ = recording
    imaging.make_final_step = counting
    try:
        yield calls
    finally:
        et.EscapeTau.__call__ = inner_call
        imaging.make_final_step = inner_make


def record_walks(model, batch, windows):
    """The escape_tau calls (:func:`walk_calls`) of the imaging steps in
    each window of ``model`` run on the card in float32 by
    ``imaging_runner.run_imaging``, the entry point's own imaging (the
    specific energy zero: the walks' inputs do not depend on it), up to the
    last window's end. Returns (density, {window: calls})."""
    import torch
    from hyperion_tpu_torch.model import imaging_runner

    geo, dt, st, density = imaging_tables(model, torch.float32)
    with walk_calls(windows) as calls:
        imaging_runner.run_imaging(model, geo, dt, st, density, None, batch,
                                   max_steps=max(last for _, last in windows))
    torch.cuda.synchronize()
    return density, calls


def _f64(call):
    import torch
    return [None if a is None else
            a.double() if a.dtype == torch.float32 else a for a in call]


def lane_bytes(call, n_dust):
    """The bytes of one float32 walk call of V views: each active lane
    reads its position, cell, flag and chi row once, each of its rays its
    direction (and t_max), and every ray's tau is written; an inactive
    lane reads its flag."""
    active, V = call[8], call[4].shape[0]
    n_act, B = int(active.sum()), active.shape[0]
    lane = 3 * 4 + 8 + 1 + n_dust * 4
    ray = 3 * 4 + (0 if call[9] is None else 4)
    return n_act * (lane + V * ray) + (B - n_act) * 1 + V * B * 4


def _rel_err(a, ref):
    """The largest |a - ref| / ref over lanes (1 where ref is 0 and a not)."""
    import torch
    rel = (a - ref).abs() / ref.abs().clamp_min(1e-300)
    return float(torch.where(ref == 0, (a != 0).double(), rel).max())


def _active_rays(call, active):
    """The rays of a call's active lanes as one view of n lanes: (chi,
    x, y, z, kx, ky, kz, cell) and t_max, views one after another."""
    import torch
    V = call[4].shape[0]
    lanes = [torch.cat([a[active]] * V) for a in (call[0],) + tuple(call[1:4])]
    dirs = [k[:, active].reshape(1, -1) for k in call[4:7]]
    cell = torch.cat([call[7][active]] * V)
    t_max = None if call[9] is None else call[9][:, active].reshape(1, -1)
    return lanes + dirs + [cell], t_max


def check_window(kind, window, calls, tables, batch, card):
    """Phase 10 for the walk calls of one window of steps: hold the kernel
    with float64 and with float32 lanes against the float64 plain version
    on every ray, and time it on the float32 lanes. ``tables``: the grid's
    float64 geometry and the density transpose in float32 and float64."""
    import torch
    from hyperion_tpu_torch.transport import escape_tau as et

    geo64, rt32, rt64 = tables
    walk32, walk64 = et.EscapeTau(geo64, rt32), et.EscapeTau(geo64, rt64)
    n_dust = rt32.shape[1]
    worst64 = worst32 = 0.0
    n_lanes = n_rays = n_views = n_far = max_cross = n_cross_all = 0
    nbytes = 0
    groups = {False: [], True: []}     # by whether a call limits the walk
    for call in calls:
        active = call[8]
        c64 = _f64(call)
        k64 = walk64(*c64[:9], t_max=c64[9])
        k32 = walk32(*call[:9], t_max=call[9]).double()
        # the rays of inactive lanes get 0
        n_far += int((k64[:, ~active] != 0).sum() +
                     (k32[:, ~active] != 0).sum())
        groups[call[9] is not None].append(
            (c64, active, k64[:, active].reshape(-1),
             k32[:, active].reshape(-1)))
        n_lanes += int(active.sum())
        n_views += call[4].shape[0]
        n_rays += int(active.sum()) * call[4].shape[0]
        nbytes += lane_bytes(call, n_dust)
    # the float64 plain version on the rays of all calls at once: it takes
    # as many steps as the longest walk, not that many per call and view
    for limited, group in groups.items():
        rays = [_active_rays(c, a) for c, a, _, _ in group]
        if not rays or sum(r[0][1].numel() for r in rays) == 0:
            continue
        lanes = [torch.cat([r[0][i] for r in rays], dim=1 if 4 <= i < 7
                           else 0) for i in range(8)]
        t_max = torch.cat([r[1] for r in rays], dim=1) if limited else None
        ones = torch.ones_like(lanes[7], dtype=torch.bool)
        ref, n_cross = et.escape_tau_reference(
            geo64, rt64, *lanes, ones, t_max=t_max, crossings=True)
        ref = ref[0]
        k64 = torch.cat([k for _, _, k, _ in group])
        k32 = torch.cat([k for _, _, _, k in group])
        worst64 = max(worst64, _rel_err(k64, ref))
        worst32 = max(worst32, _rel_err(k32, ref))
        n_far += int(((k32 - ref).abs() >
                      ESCAPE_TAU_RTOL32 * ref + 1e-30).sum())
        max_cross = max(max_cross, int(n_cross.max()))
        n_cross_all += int(n_cross.sum())
    # every crossing reads one density row and does the crossing's float64
    # operations (FLOPS_PER_CROSSING)
    nbytes += n_cross_all * n_dust * 4
    flops = n_cross_all * FLOPS_PER_CROSSING[kind]
    steps = '%d-%d' % (window[0] + 1, window[1])
    if n_lanes == 0:
        raise AssertionError('escape_tau %s: no active lane in the walks of '
                             'steps %s' % (kind, steps))
    # times: device (CUDA events, each call behind a sleep so that the
    # launch is queued before its start event), host (eager calls before
    # the synchronise), the plain version (synchronised)
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in calls]
    ends = [torch.cuda.Event(enable_timing=True) for _ in calls]
    for rep in range(2):
        for a, b, call in zip(starts, ends, calls):
            torch.cuda._sleep(2_000_000)
            a.record()
            walk32(*call[:9], t_max=call[9])
            b.record()
        torch.cuda.synchronize()
    device_us = sum(a.elapsed_time(b) for a, b in zip(starts, ends)) * 1e3
    t0 = time.perf_counter()
    for call in calls:
        walk32(*call[:9], t_max=call[9])
    host_us = (time.perf_counter() - t0) * 1e6 / len(calls)
    torch.cuda.synchronize()
    some = calls[:10]
    t0 = time.perf_counter()
    plain = [et.escape_tau_reference(geo64, rt32, *call[:9], t_max=call[9])
             for call in some]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / len(some)
    # the float32 kernel against its own plain version, on the timed calls
    # (both round the same float64 walk once: equal but for a sum's order)
    max_err = max(float((walk32(*call[:9], t_max=call[9]) - tau_p).abs()
                        .max()) for call, tau_p in zip(some, plain))
    n_far_plain = sum(int(((walk32(*call[:9], t_max=call[9]) - tau_p).abs()
                           > ESCAPE_TAU_RTOL32 * tau_p + 1e-30).sum())
                      for call, tau_p in zip(some, plain))
    t_bytes = nbytes / len(calls) / HBM_BYTES_PER_S * 1e6
    t_ops = flops / len(calls) / FP64_FLOPS * 1e6
    out = dict(model=kind, steps=steps, calls=len(calls), views=n_views,
               B=batch, f64_max_rel_err=worst64,
               f32_max_rel_err_vs_f64=worst32, f32_rays_outside=n_far,
               active_lanes=n_lanes, active_rays=n_rays,
               f32_vs_plain32_max_abs_err=max_err, longest_walk=max_cross,
               device_us=device_us / len(calls),
               device_us_per_view=device_us / n_views, host_us=host_us,
               plain_ms=plain_ms, bound_us=max(t_bytes, t_ops),
               bound_by='bytes' if t_bytes >= t_ops else 'operations',
               bytes_per_call=nbytes / len(calls),
               flops_per_call=flops / len(calls))
    phase('escape_tau %s (%d calls, %d views, of steps %s, B=%d, %d active '
          'lanes, %d rays): max rel err against the float64 plain version '
          '%.3e (float64 lanes), %.3e (float32 lanes; %d rays beyond %.0e '
          'tau); float32 lanes against their plain version on %d calls: max '
          'abs err %.3e; longest walk %d crossings; device %.2f us per call '
          '(one event), %.2f us per view, host %.2f us per call, plain %.3f '
          'ms, bound %.3f us (%s: %.0f bytes, %.0f float64 flops per call) '
          '[%s]'
          % (kind, len(calls), n_views, steps, batch, n_lanes, n_rays,
             worst64, worst32, n_far, ESCAPE_TAU_RTOL32, len(some), max_err,
             max_cross, out['device_us'], out['device_us_per_view'], host_us,
             plain_ms, out['bound_us'], out['bound_by'],
             out['bytes_per_call'], out['flops_per_call'], card))
    if worst64 > 1e-10 or n_far or n_far_plain:
        raise AssertionError('escape_tau %s: the kernel against its plain '
                             'version: %s' % (kind, out))
    return out


def check_walks(kind, model, batch, card, windows=WALK_WINDOWS):
    """Phase 10 for one model: record its walks in each window of steps
    and check each window (:func:`check_window`); returns their reports."""
    import torch
    from hyperion_tpu_torch.model.run import (_density_array,
                                              build_geometry_tables)

    rho32, calls = record_walks(model, batch, windows)
    dev = torch.device('cuda')
    geo64 = build_geometry_tables(model.grid, dev, torch.float64)
    rho64 = _density_array(model, geo64.length_scale, dev, torch.float64)
    tables = (geo64, rho32.T.contiguous(), rho64.T.contiguous())
    return [check_window(kind, w, calls[w], tables, batch, card)
            for w in windows]


def escape_tau_phase(card):
    """Phase 10: escape_tau on the very walk calls of the WALK_WINDOWS
    imaging steps of the quickstart (cartesian, B = 125,000) and of class2
    (spherical-polar, B = 50,000, run.py's batch for its 200,000 Lucy
    photons)."""
    return (check_walks('cartesian', tutorial_model(), 125_000, card) +
            check_walks('spherical', class2_model(n_photons=200_000),
                        50_000, card))


# ------------------------------------------- raytracing and monochromatic --

@contextlib.contextmanager
def column_calls():
    """Record the column walks (``EscapeTau.columns``) made inside the
    block: yields a list that gets, per call, the kind of grid and its
    eight lane tensors and t_max (cloned)."""
    from hyperion_tpu_torch.transport import escape_tau as et
    from hyperion_tpu_torch.transport.gtable import CartesianGeometry
    from hyperion_tpu_torch.transport.gtable_cylindrical import \
        CylindricalGeometry

    calls = []
    inner = et.EscapeTau.columns

    def recording(self, *args, t_max=None):
        kind = 'cartesian' if isinstance(self.geometry, CartesianGeometry) \
            else 'cylindrical' if isinstance(self.geometry,
                                             CylindricalGeometry) \
            else 'spherical'
        calls.append((kind, [a.clone() for a in args] +
                      [None if t_max is None else t_max.clone()]))
        return inner(self, *args, t_max=t_max)

    et.EscapeTau.columns = recording
    try:
        yield calls
    finally:
        et.EscapeTau.columns = inner


def _given_specific_energy(model, se):
    """Give ``model`` the (n_dust, n_cells) specific energy ``se`` as its
    grid's, to start from with no Lucy iteration."""
    grid = model.grid
    grid.quantities['specific_energy'] = [
        np.asarray(row, float).reshape(grid.shape) for row in se]
    model.set_n_initial_iterations(0)


def class2_raytrace_phase(et, card, phase8):
    """Phase 11: examples/class2_sed.py's model with raytracing (its
    10,000 source and 1,000,000 dust photons) through run_lucy_model,
    phase 8's specific energy given to the grid (no Lucy iteration), the
    imaging iteration at CLASS2_CUT's budget peeling scattered light only;
    its band at >= 100 um beside phase 8's (reported: see
    RAYTRACE_N_SIGMA), then :func:`class2_mono_check`. Returns
    (escape_tau launches, escape_column launches, report, the recorded
    column calls)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model

    cut = CLASS2_CUT
    m = class2_model(cut['n_photons'], 0, cut['n_imaging'])
    m.set_raytracing(True)
    m.set_n_photons(initial=cut['n_photons'], imaging=cut['n_imaging'],
                    **RAYTRACING)
    _given_specific_energy(m, phase8['specific_energy'])
    et.launches = 0
    et.column_launches = 0
    t0 = time.time()
    with column_calls() as calls:
        run = run_lucy_model(m, device='cuda',
                             imaging_max_steps=cut['imaging_max_steps'])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches_et, launches_col = et.launches, et.column_launches
    img, ray = run.imaging, run.imaging.raytrace
    # no geometry faults: no raytraced photon started outside the grid or
    # outside its cell (the imaging steps, as the JAX package's, make no
    # geometry self-check, and phase 11 runs no Lucy iteration)
    if ray['outside']:
        raise AssertionError('class2 raytracing: %d photons outside the grid '
                             'or their cell' % ray['outside'])
    data = img.peeled[0]['datasets']
    for name, (a, _) in data.items():
        if not np.isfinite(a).all() or (a < 0).any():
            raise AssertionError('class2 raytracing: %s not finite and >= 0'
                                 % name)
    # (n_view, n_nu), frequency ascending; phase 8's the same
    sed = data['seds'][0][0, 0, :, 0, :]
    unc = data['seds_unc'][0][0, 0, :, 0, :]
    sed8 = phase8['seds'][0, 0, :, 0, :]
    unc8 = phase8['seds_unc'][0, 0, :, 0, :]
    from hyperion_tpu_torch.util.constants import c
    nu = np.logspace(np.log10(c / 2000e-4), np.log10(c / 0.3e-4), 121)
    wav = c / np.sqrt(nu[1:] * nu[:-1]) * 1e4
    # per view, the band of the bins at >= 100 um: its sum and the two
    # runs' uncertainties added in quadrature over the bins
    far = wav >= 100.0
    band, band8 = sed[:, far].sum(axis=1), sed8[:, far].sum(axis=1)
    sigma = np.sqrt((unc[:, far] ** 2 + unc8[:, far] ** 2).sum(axis=1))
    n_sig = np.abs(band - band8) / np.maximum(sigma, 1e-300)
    ratio = float(sed[2, -1] / sed[0, -1])
    out = dict(wall_s=wall, imaging_wall_s=img.wall, imaging_steps=img.n_steps,
               killed_int=img.killed_int, raytracing_wall_s=ray['wall'],
               batches=ray['batches'], raytracing_photons=ray['photons'],
               raytracing_outside=ray['outside'],
               escape_tau_launches=launches_et,
               escape_column_launches=launches_col,
               far_ir_band_sigma=n_sig.tolist(),
               far_ir_band_ratio_to_phase8=(band / band8).tolist(),
               far_ir_bins=int(far.sum()), ratio_80_20=ratio)
    phase('class2 raytracing: %d imaging steps (scattered light only) in '
          '%.3f s, killed_int %d; raytracing %d photons in %d batches, '
          '%.3f s wall, %d column launches, %d escape_tau launches; the '
          'SEDs\' band at >= 100 um (%d bins) per view %s x phase 8\'s, %s '
          'sigma (reported, not checked); 80/20 degree ratio at 0.3 um '
          '%.4e (phase 8: %.4e) [%s]'
          % (img.n_steps, img.wall, img.killed_int, ray['photons'],
             ray['batches'], ray['wall'], launches_col, launches_et,
             far.sum(), ['%.4f' % v for v in band / band8],
             ['%.2f' % v for v in n_sig], ratio, sed8[2, -1] / sed8[0, -1],
             card))
    if launches_col == 0 or not ratio > 0:
        raise AssertionError('class2 raytracing: %s' % out)
    out['mono_check'] = class2_mono_check(et, card, phase8)
    return launches_et, launches_col, out, calls


def class2_mono_check(et, card, phase8):
    """Phase 11's check of the raytracing against the Monte-Carlo light of
    the same emission model: class2 in monochromatic mode at
    CLASS2_MONO_WAVELENGTHS, phase 8's specific energy given to the grid,
    CLASS2_MONO_PHOTONS from the sources and from the dust per
    wavelength, (a) without and (b) with raytracing (RAYTRACING's source
    photons, ten times its dust photons, see RAYTRACE_N_SIGMA);
    (b) within RAYTRACE_N_SIGMA of (a) at every view and wavelength (sigma
    both runs' Monte-Carlo uncertainties). Both emit the dust's light from
    uniform points in the cells, by their specific energy: raytracing's model,
    which on class2's optically thick cells differs from the imaging
    iteration's emission at its absorption points (see RAYTRACE_N_SIGMA).
    Returns the report."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model

    n = CLASS2_MONO_PHOTONS
    seds, out = [], {}
    for name, ray in (('a', False), ('b', True)):
        m = class2_model(CLASS2_CUT['n_photons'], 0, n)
        m.set_monochromatic(True, wavelengths=CLASS2_MONO_WAVELENGTHS)
        m.peeled_output[0].set_wavelength_index_range(
            0, len(CLASS2_MONO_WAVELENGTHS) - 1)
        m.set_raytracing(ray)
        m.set_n_photons(initial=CLASS2_CUT['n_photons'], imaging_sources=n,
                        imaging_dust=n, **(dict(
                            RAYTRACING, raytracing_dust=10 * RAYTRACING[
                                'raytracing_dust']) if ray else {}))
        _given_specific_energy(m, phase8['specific_energy'])
        et.launches = 0
        t0 = time.time()
        run = run_lucy_model(m, device='cuda')
        torch.cuda.synchronize()
        img = run.imaging
        data = img.peeled[0]['datasets']
        seds.append((data['seds'][0][0, 0, :, 0], data['seds_unc'][0][0, 0,
                                                                     :, 0]))
        out[name] = dict(wall_s=time.time() - t0, steps=img.n_steps,
                         killed_int=img.killed_int,
                         escape_tau_launches=et.launches)
        if img.killed_int or et.launches == 0 or \
                not np.isfinite(seds[-1][0]).all():
            raise AssertionError('class2 mono (%s): %s' % (name, out[name]))
    (a, ua), (b, ub) = seds
    n_sig = np.abs(b - a) / np.maximum(np.hypot(ua, ub), 1e-300)
    out.update(wavelengths=CLASS2_MONO_WAVELENGTHS,
               ratio_b_a=(b / a).tolist(), sigma=n_sig.tolist())
    phase('class2 mono at %s um: (a) %d steps in %.3f s, (b) with '
          'raytracing %d steps in %.3f s; (b) / (a) per view %s, %s sigma '
          '(the bound %.1f) [%s]'
          % (CLASS2_MONO_WAVELENGTHS, out['a']['steps'], out['a']['wall_s'],
             out['b']['steps'], out['b']['wall_s'],
             [['%.4f' % v for v in row] for row in b / a],
             [['%.2f' % v for v in row] for row in n_sig], RAYTRACE_N_SIGMA,
             card))
    if n_sig.max() > RAYTRACE_N_SIGMA:
        raise AssertionError('class2 mono: %s' % out)
    return out


def raytrace_table_offset(model, se):
    """Per exact frequency of the monochromatic ``model``, what the
    raytracing pass's thermal light should exceed the monochromatic
    iteration's by on an optically thin grid, as nu L_nu (erg/s, the SEDs'
    unit), from the (n_dust, n_cells) specific energy ``se``: nu times the
    sum over cells of L j_nu as the pass estimates it, less the same as
    the iteration does. The pass interpolates a cell's emissivity between
    the N_VAR_EFF var rows that the JAX package's tables keep of the
    dust's table, the iteration between the two rows of the whole table
    around the cell's state (dust_mono_cell_pdfs); where the two agree the
    offset is 0."""
    import torch
    from hyperion_tpu_torch.model import run as prun
    from hyperion_tpu_torch.transport import raytrace as rt
    from hyperion_tpu_torch.transport.mono import dust_mono_cell_pdfs

    cpu, f64 = torch.device('cpu'), torch.float64
    geo = prun.build_geometry_tables(model.grid, cpu, f64)
    rho = prun._density_array(model, geo.length_scale, cpu, f64)
    dusts = model._dust_objects()
    for d in dusts:
        # the LTE emissivities, as the run's build_dust_tables sets them
        d._compute_mean_opacities()
        if not d.emissivities.all_set():
            d.emissivities.set_lte(d.optical_properties, d.mean_opacities)
    freqs = np.asarray(model._frequencies, float)
    se = np.asarray(se, float)
    _, mean_prob, e_tot = dust_mono_cell_pdfs(
        dusts, rho.numpy(), geo.volumes.numpy(), se, freqs)
    tab, var_grids = rt.build_raytrace_tables_mono(
        dusts, model.sources, freqs, se, rho, geo.volumes, cpu, f64)
    n_dust, n_cells = se.shape
    spec = rt.dust_emission_spectra(
        tab, torch.log10(torch.as_tensor(np.array(var_grids))),
        torch.as_tensor(se), torch.arange(n_dust).repeat_interleave(n_cells),
        torch.arange(n_cells).repeat(n_dust))
    ray = (tab.cell_lum[:, None] * spec).sum(dim=0).numpy()
    mc = (mean_prob * e_tot[None, :]).sum(axis=1)
    # the engine's density and volumes carry the length scale: L rho V / L^3
    return freqs * (ray - mc) * geo.length_scale ** 2


def mono_model(se, raytracing):
    """examples/quickstart.py (tutorial_model) in monochromatic mode at
    MONO_WAVELENGTHS, its peeled group taking all of them (index range 0 to
    4) with uncertainties, ``se`` (phase 4's specific energy) given to the
    grid, MONO_PHOTONS source and dust photons per wavelength, with or
    without raytracing (RAYTRACING's photons)."""
    m = tutorial_model()
    m.set_monochromatic(True, wavelengths=MONO_WAVELENGTHS)
    group = m.peeled_output[0]
    group.set_wavelength_index_range(0, len(MONO_WAVELENGTHS) - 1)
    group.set_uncertainties(True)
    m.set_raytracing(raytracing)
    m.set_n_photons(initial=500_000, imaging_sources=MONO_PHOTONS,
                    imaging_dust=MONO_PHOTONS,
                    **(RAYTRACING if raytracing else {}))
    _given_specific_energy(m, se)
    return m


def mono_phase(et, card, se):
    """Phase 12: the quickstart's model in monochromatic mode through
    run_lucy_model, (a) without and (b) with raytracing, phase 4's specific
    energy given to the grid. (a) at 0.5 and 1 um within
    MONO_ANALYTIC_RTOL of the point source's nu L pi B_nu / (sigma T^4)
    (the box's tau along the line of sight is ~0.01); (b)'s SED less
    (a)'s within MONO_N_SIGMA of raytrace_table_offset at every
    wavelength; nothing killed, escape_tau launched. Returns (escape_tau launches per run, escape_column launches
    of (b), report, (b)'s recorded column calls)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model
    from hyperion_tpu_torch.util.constants import lsun, pi, sigma
    from hyperion_tpu_torch.util.functions import B_nu

    runs, out, launches = {}, {}, {}
    for name, ray in (('a', False), ('b', True)):
        m = mono_model(se, ray)
        et.launches = 0
        et.column_launches = 0
        t0 = time.time()
        with column_calls() as calls:
            run = run_lucy_model(m, device='cuda')
        torch.cuda.synchronize()
        wall = time.time() - t0
        img = run.imaging
        launches[name] = (et.launches, et.column_launches)
        data = img.peeled[0]['datasets']
        for key, (a, _) in data.items():
            if key != 'frequencies' and (not np.isfinite(a).all() or
                                         (a < 0).any()):
                raise AssertionError('mono (%s): %s not finite and >= 0'
                                     % (name, key))
        runs[name] = (data['seds'][0][0, 0, 0, 0],
                      data['seds_unc'][0][0, 0, 0, 0],
                      data['frequencies'][0]['nu'], calls)
        out[name] = dict(wall_s=wall, imaging_wall_s=img.wall,
                         steps=img.n_steps, killed_int=img.killed_int,
                         batch=img.batch_size,
                         ms_per_step=img.wall * 1e3 / img.n_steps,
                         occupancy=img.n_events / (img.n_steps *
                                                   img.batch_size),
                         escape_tau_launches=et.launches,
                         escape_column_launches=et.column_launches,
                         raytrace=img.raytrace)
        phase('mono (%s, %s raytracing): %d steps in %.3f s (%.3f ms per '
              'step, B=%d, occupancy %.4f), killed_int %d, escape_tau '
              'launches %d, escape_column launches %d%s [%s]'
              % (name, 'with' if ray else 'without', img.n_steps, img.wall,
                 out[name]['ms_per_step'], img.batch_size,
                 out[name]['occupancy'], img.killed_int, et.launches,
                 et.column_launches,
                 '' if not ray else ', raytracing %d batches in %.3f s'
                 % (img.raytrace['batches'], img.raytrace['wall']), card))
        if img.killed_int or et.launches == 0 or \
                (ray and (et.column_launches == 0 or
                          img.raytrace['outside'])):
            raise AssertionError('mono (%s): %s' % (name, out[name]))
    sed_a, unc_a, nu, _ = runs['a']
    sed_b, unc_b, _, calls = runs['b']
    expected = nu * lsun * pi * B_nu(nu, 6000.0) / (sigma * 6000.0 ** 4)
    ratio = sed_a / expected
    # (b) - (a) against the offset of raytracing's resampled var rows
    # (MONO_N_SIGMA says why)
    offset = raytrace_table_offset(mono_model(se, True), se)
    n_sig = np.abs(sed_b - sed_a - offset) / \
        np.maximum(np.hypot(unc_a, unc_b), 1e-300)
    out.update(wavelengths=MONO_WAVELENGTHS, sed_a=sed_a.tolist(),
               sed_b=sed_b.tolist(), analytic_ratio_a=ratio.tolist(),
               table_offset=offset.tolist(),
               b_vs_a_raw_sigma=(np.abs(sed_b - sed_a) / np.maximum(
                   np.hypot(unc_a, unc_b), 1e-300)).tolist(),
               b_vs_a_sigma=n_sig.tolist())
    phase('mono: (a) against the analytic SED at %s um: %s; (b) / (a) %s, '
          'the tables\' offset / (a) %s; (b) - (a) against the offset: %s '
          'sigma (the bound %.1f) [%s]'
          % (MONO_WAVELENGTHS, ['%.5f' % r for r in ratio],
             ['%.5f' % r for r in sed_b / sed_a],
             ['%.2e' % r for r in offset / sed_a],
             ['%.2f' % v for v in n_sig], MONO_N_SIGMA, card))
    if (np.abs(ratio[:2] - 1.0) > MONO_ANALYTIC_RTOL).any() or \
            n_sig.max() > MONO_N_SIGMA:
        raise AssertionError('mono: %s' % out)
    return (launches['a'][0], launches['b'][0]), launches['b'][1], out, calls


def column_bytes(call, n_dust):
    """The bytes of one float32 column call of V views: each active lane
    reads its position, cell and flag once, each of its rays its direction
    (and t_max) and writes its n_dust columns; an inactive lane reads its
    flag and writes zeros."""
    active, V = call[7], call[3].shape[0]
    n_act, B = int(active.sum()), active.shape[0]
    lane = 3 * 4 + 8 + 1
    ray = 3 * 4 + (0 if call[8] is None else 4)
    return n_act * (lane + V * ray) + (B - n_act) * 1 + V * B * n_dust * 4


def check_columns(what, kind, calls, tables, card):
    """Phase 13 for the column calls of one run: the kernel with float64
    lanes equal to the float64 plain version on every ray and dust (0
    relative error), with float32 lanes equal to its own float32 plain
    version and within ESCAPE_TAU_RTOL32 of the float64 one; then its
    times on the float32 lanes: device, host (the mean over
    HOST_ROUNDS rounds of the eager calls), the plain version's.
    ``tables``: the grid's float64 geometry and the density transpose in
    float32 and float64."""
    import torch
    from hyperion_tpu_torch.transport import escape_tau as et

    geo64, rt32, rt64 = tables
    walk32, walk64 = et.EscapeTau(geo64, rt32), et.EscapeTau(geo64, rt64)
    n_dust = rt32.shape[1]
    nbytes = n_far = 0
    groups = {False: [], True: []}     # by whether a call limits the walk
    for call in calls:
        c64, active = _f64(call), call[7]
        k64 = walk64.columns(*c64[:8], t_max=c64[8])
        k32 = walk32.columns(*call[:8], t_max=call[8]).double()
        # the columns of inactive lanes' rays are 0
        n_far += int((k64[:, ~active] != 0).sum() +
                     (k32[:, ~active] != 0).sum())
        groups[call[8] is not None].append(
            (c64, active, k64[:, active].reshape(-1, n_dust),
             k32[:, active].reshape(-1, n_dust)))
        nbytes += column_bytes(call, n_dust)
    # the float64 plain version (on the float64 and on the float32
    # density) on the live rays of all calls at once, as one view: as many
    # steps as the longest walk, not that many per call and view
    worst64 = worst32 = 0.0
    max_cross = n_cross_all = n_rays = n_ne32 = 0
    for limited, group in groups.items():
        if not group:
            continue
        lanes, t_max = [], []
        for c64, active, _, _ in group:
            V = c64[3].shape[0]
            lanes.append([torch.cat([a[active]] * V) for a in c64[:3]] +
                         [k[:, active].reshape(1, -1) for k in c64[3:6]] +
                         [torch.cat([c64[6][active]] * V)])
            if limited:
                t_max.append(c64[8][:, active].reshape(1, -1))
        lanes = [torch.cat([r[i] for r in lanes], dim=1 if 3 <= i < 6
                           else 0) for i in range(7)]
        ones = torch.ones_like(lanes[6], dtype=torch.bool)
        t_max = torch.cat(t_max, dim=1) if limited else None
        ref, n_cross = et.escape_column_reference(
            geo64, rt64, *lanes, ones, t_max=t_max, crossings=True)
        # the float32 plain version: the same widened lanes on the float32
        # density, rounded once
        ref32 = et.escape_column_reference(geo64, rt32, *lanes, ones,
                                           t_max=t_max)[0].float().double()
        ref = ref[0]
        k64 = torch.cat([k for _, _, k, _ in group])
        k32 = torch.cat([k for _, _, _, k in group])
        worst64 = max(worst64, _rel_err(k64, ref))
        worst32 = max(worst32, _rel_err(k32, ref))
        n_ne32 += int((k32 != ref32).sum())
        n_far += int(((k32 - ref).abs() >
                      ESCAPE_TAU_RTOL32 * ref.abs() + 1e-30).sum())
        max_cross = max(max_cross, int(n_cross.max()))
        n_cross_all += int(n_cross.sum())
        n_rays += int((n_cross > 0).sum())
    # every crossing reads one density row and does the crossing's float64
    # operations and a multiply-add per dust
    nbytes += n_cross_all * n_dust * 4
    flops = n_cross_all * (FLOPS_PER_CROSSING[kind] + 2 * n_dust)
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in calls]
    ends = [torch.cuda.Event(enable_timing=True) for _ in calls]
    for rep in range(2):
        for a, b, call in zip(starts, ends, calls):
            torch.cuda._sleep(2_000_000)
            a.record()
            walk32.columns(*call[:8], t_max=call[8])
            b.record()
        torch.cuda.synchronize()
    device_us = sum(a.elapsed_time(b) for a, b in zip(starts, ends)) * 1e3
    host = 0.0
    for rep in range(HOST_ROUNDS):
        t0 = time.perf_counter()
        for call in calls:
            walk32.columns(*call[:8], t_max=call[8])
        host += time.perf_counter() - t0
        torch.cuda.synchronize()
    host_us = host * 1e6 / (HOST_ROUNDS * len(calls))
    some = calls[:5]
    t0 = time.perf_counter()
    plain = [et.escape_column_reference(geo64, rt32, *call[:8],
                                        t_max=call[8]) for call in some]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / len(some)
    max_err = max(float((walk32.columns(*call[:8], t_max=call[8]) - p)
                        .abs().max()) for call, p in zip(some, plain))
    t_bytes = nbytes / len(calls) / HBM_BYTES_PER_S * 1e6
    t_ops = flops / len(calls) / FP64_FLOPS * 1e6
    out = dict(run=what, model=kind, calls=len(calls),
               views=sum(c[3].shape[0] for c in calls),
               B=calls[0][7].shape[0], n_dust=n_dust, rays=n_rays,
               f64_max_rel_err=worst64, f32_max_rel_err_vs_f64=worst32,
               f32_rays_outside=n_far, f32_ne_plain32=n_ne32,
               f32_vs_plain32_max_abs_err=max_err, longest_walk=max_cross,
               plan=walk32.plan, device_us=device_us / len(calls),
               host_us=host_us, plain_ms=plain_ms,
               bound_us=max(t_bytes, t_ops),
               bound_by='bytes' if t_bytes >= t_ops else 'operations',
               bytes_per_call=nbytes / len(calls),
               flops_per_call=flops / len(calls))
    phase('escape_column %s (%s, %d calls, %d views, B=%d, %d walking '
          'rays): max rel err against the float64 plain version %.3e '
          '(float64 lanes), %.3e (float32 lanes; %d ray-dusts beyond %.0e); '
          'float32 lanes against their plain version: %d ray-dusts differ '
          '(max abs err %.3e on %d timed calls); longest walk %d '
          'crossings; device %.2f us per call, host %.2f us per call, plain '
          '%.3f ms, bound %.3f us (%s: %.0f bytes, %.0f float64 flops per '
          'call) [%s]'
          % (what, kind, len(calls), out['views'], out['B'], n_rays,
             worst64, worst32, n_far, ESCAPE_TAU_RTOL32, n_ne32, max_err,
             len(some), max_cross, out['device_us'], host_us, plain_ms,
             out['bound_us'], out['bound_by'], out['bytes_per_call'],
             out['flops_per_call'], card))
    if worst64 > 0.0 or n_far or n_ne32 or max_err > 0.0:
        raise AssertionError('escape_column %s: the kernel against its '
                             'plain version: %s' % (what, out))
    return out


def column_phase(card, runs):
    """Phase 13: the column mode against its plain version on the very
    column calls of phase 11 (class2) and phase 12 (b) (the quickstart),
    ``runs`` = [(what, model, calls)]."""
    import torch
    from hyperion_tpu_torch.model.run import (_density_array,
                                              build_geometry_tables)

    dev = torch.device('cuda')
    out = []
    for what, model, calls in runs:
        geo64 = build_geometry_tables(model.grid, dev, torch.float64)
        rho64 = _density_array(model, geo64.length_scale, dev, torch.float64)
        rho32 = _density_array(model, geo64.length_scale, dev, torch.float32)
        kinds = {k for k, _ in calls}
        if len(kinds) != 1 or not calls:
            raise AssertionError('escape_column %s: calls %s' % (what, kinds))
        out.append(check_columns(what, kinds.pop(), [c for _, c in calls],
                                 (geo64, rho32.T.contiguous(),
                                  rho64.T.contiguous()), card))
    return out


# ------------------------------------------ BASELINE config 3: class1_cyl --

def class1_cyl_model(n_w=200, n_z=200, n_photons=100_000, n_iterations=1,
                     n_imaging=50_000, raytracing=RAYTRACING, n_pix=128,
                     frontend=None):
    """BASELINE.md config 3 (class1_cyl): an embedded source with a bipolar
    cavity on a cylindrical-polar grid, with peeled SEDs and multi-
    wavelength images, laid out as Hyperion's class 1 tutorial
    (hyperion-rt/hyperion, docs/tutorials/example_class1.rst), built with
    the port's AnalyticalYSOModel and evaluated to a Model (no file):

    - the star and flared disk of examples/class2_sed.py (1 Lsun, 2 Rsun,
      4300 K, 0.5 Msun; 1e-3 Msun from 0.1 to 200 au), its gray HG dust;
    - an Ulrich envelope (rc 200 au, 0.1 to 5,000 au, rho_0 5e-20 g/cm^3)
      with a bipolar cavity (power 1.5, theta_0 20 degrees at r_0 5,000
      au, rho_0 1e-22 g/cm^3, rho_exp 0);
    - an ExternalSphericalSource of 5,000 au at the origin, 5,000 K and
      0.1 Lsun, a stand-in for the interstellar field, inscribed in the
      grid's cylinder;
    - set_cylindrical_polar_grid_auto(n_w, n_z, 1) (200 x 200 in the
      config), MRW with gamma 2, n_iterations Lucy iterations of n_photons;
    - SEDs at 10 (down the cavity), 60 and 85 degrees (120 wavelengths
      from 0.3 to 2,000 um, one 5,000 au aperture, track_origin 'basic',
      with uncertainties), and one image group at 60 degrees: n_pix x n_pix
      pixels over +-2,000 au at 10 wavelengths from 0.5 to 100 um;
    - n_imaging imaging photons and raytracing with ``raytracing``'s
      source and dust photons (none when None).

    ``frontend`` holds the front end's AnalyticalYSOModel,
    HenyeyGreensteinDust and the constants au, lsun, msun and rsun (the
    port's when None; the CPU tests pass the JAX package's too)."""
    if frontend is None:
        from types import SimpleNamespace
        from hyperion_tpu_torch.dust import HenyeyGreensteinDust
        from hyperion_tpu_torch.model import AnalyticalYSOModel
        from hyperion_tpu_torch.util import constants
        frontend = SimpleNamespace(
            AnalyticalYSOModel=AnalyticalYSOModel,
            HenyeyGreensteinDust=HenyeyGreensteinDust, au=constants.au,
            lsun=constants.lsun, msun=constants.msun, rsun=constants.rsun)
    F = frontend
    au = F.au
    nu = np.logspace(8, 17, 64)
    dust = F.HenyeyGreensteinDust(nu, np.repeat(0.5, 64),
                                  np.repeat(400.0, 64), np.repeat(0.4, 64),
                                  np.repeat(0.8, 64))
    m = F.AnalyticalYSOModel()
    m.star.luminosity = CLASS1_CYL_LUM['star'] * F.lsun
    m.star.radius = 2.0 * F.rsun
    m.star.temperature = 4300.0
    m.star.mass = 0.5 * F.msun
    disk = m.add_flared_disk()
    disk.mass = 1e-3 * F.msun
    disk.rmin = 0.1 * au
    disk.rmax = 200.0 * au
    disk.r_0 = 10.0 * au
    disk.h_0 = 0.4 * au
    disk.p = -1.0
    disk.beta = 1.25
    disk.dust = dust
    env = m.add_ulrich_envelope()
    env.rc = 200.0 * au
    env.rmin = 0.1 * au
    env.rmax = 5000.0 * au
    env.rho_0 = 5e-20
    env.dust = dust
    cav = env.add_bipolar_cavity()
    cav.power = 1.5
    cav.theta_0 = 20.0
    cav.r_0 = 5000.0 * au
    cav.rho_0 = 1e-22
    cav.rho_exp = 0.0
    cav.dust = dust
    isrf = m.add_external_spherical_source()
    isrf.luminosity = CLASS1_CYL_LUM['isrf'] * F.lsun
    isrf.temperature = 5000.0
    isrf.radius = 5000.0 * au
    isrf.position = (0.0, 0.0, 0.0)
    m.set_cylindrical_polar_grid_auto(n_w, n_z, 1)
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([10.0, 60.0, 85.0], [0.0, 0.0, 0.0])
    sed.set_wavelength_range(120, 0.3, 2000.0)
    sed.set_aperture_radii(1, 5000.0 * au, 5000.0 * au)
    sed.set_track_origin('basic')
    sed.set_uncertainties(True)
    image = m.add_peeled_images(sed=False, image=True)
    image.set_viewing_angles([60.0], [0.0])
    image.set_image_size(n_pix, n_pix)
    image.set_image_limits(-2000.0 * au, 2000.0 * au, -2000.0 * au,
                           2000.0 * au)
    image.set_wavelength_range(10, 0.5, 100.0)
    m.set_mrw(True, gamma=2.0)
    m.set_n_initial_iterations(n_iterations)
    m.set_raytracing(raytracing is not None)
    m.set_n_photons(initial=n_photons, imaging=n_imaging,
                    **(raytracing or {}))
    m.set_seed(20261017)
    m.evaluate_optically_thin_radii()
    return m.to_model()


@contextlib.contextmanager
def source_picks(n_rows, device):
    """Tally the source rows that the emission draws (``pick_sources``, one
    draw per lane of every refill, as the Lucy and imaging steps call it):
    yields an int64 (n_rows,) tensor on ``device``."""
    import torch
    from hyperion_tpu_torch.transport import engine, imaging, stable

    tally = torch.zeros(n_rows, dtype=torch.int64, device=device)
    inner = stable.pick_sources

    def counted(st, u):
        rows = inner(st, u)
        tally.add_(torch.bincount(rows, minlength=n_rows))
        return rows

    mods = (stable, engine, imaging)
    for mod in mods:
        mod.pick_sources = counted
    try:
        yield tally
    finally:
        for mod in mods:
            mod.pick_sources = inner


@contextlib.contextmanager
def deposit_calls(dv, first, last):
    """Record the deposit_visit calls number ``first`` to ``last`` (from 0)
    made inside the block, as :func:`record_calls` does."""
    calls, n = [], [0]
    run = dv.DepositVisit.__call__

    def recording(self, cell_dep, dep, enter, uid):
        if first <= n[0] < last:
            calls.append((None if dep is None else cell_dep.clone(),
                          None if dep is None else dep.clone(),
                          enter.clone(), uid.clone()))
        n[0] += 1
        run(self, cell_dep, dep, enter, uid)

    dv.DepositVisit.__call__ = recording
    try:
        yield calls
    finally:
        dv.DepositVisit.__call__ = run


def class1_cyl_phase(dv, et, card, n_photons, n_iterations, max_steps,
                     n_imaging, imaging_max_steps):
    """Phase 14: BASELINE config 3 (:func:`class1_cyl_model`, the full 200 x
    200 grid, CLASS1_CYL_CUT's photons) through run_lucy_model on the card:
    the Lucy iteration, the imaging iteration with MRW into its SEDs and
    images, and the raytracing pass. Checks: no geometry kills;
    killed_int only at the step caps; energy_current the photons emitted;
    the ISRF's share of the source draws within 3 sigma of its share of
    the luminosity; temperatures finite and > 0 in dusty cells; SEDs and
    images finite and >= 0; at the shortest wavelength the 85 degree
    view's scattered share above the 10 degree one's; at most one
    escape_tau launch per peel event; no raytraced photon outside the grid
    or its cell. Then each kernel against its plain version on this run's
    own calls: deposit_visit on 80 calls of the Lucy iteration (phase 6's
    method), escape_tau on the imaging steps of WALK_WINDOWS (phase 10's)
    and escape_column on the raytracing calls (phase 13's). Returns
    ({kernel: launches}, report)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model
    from hyperion_tpu_torch.model.run import (_density_array,
                                              build_geometry_tables)
    from hyperion_tpu_torch.transport.gtable import ESCAPED
    from hyperion_tpu_torch.transport.stable import (EXTERN_SPH,
                                                     build_source_tables,
                                                     emit_packets)

    dev = torch.device('cuda')
    t0 = time.time()
    m = class1_cyl_model(n_photons=n_photons, n_iterations=n_iterations,
                         n_imaging=n_imaging)
    build_s = time.time() - t0
    n_rows = len(m.sources)
    dv.launches = et.launches = et.column_launches = 0
    t0 = time.time()
    with transport_syncs() as syncs, imaging_syncs() as img_syncs, \
            peel_events() as events, source_picks(n_rows, dev) as picks, \
            deposit_calls(dv, 40, 120) as dcalls, \
            walk_calls(WALK_WINDOWS) as wcalls, column_calls() as ccalls:
        run = run_lucy_model(m, device='cuda', max_steps=max_steps,
                             imaging_max_steps=imaging_max_steps)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(deposit_visit=dv.launches, escape_tau=et.launches,
                    escape_column=et.column_launches)
    res, img = run.result, run.imaging
    what = 'class1_cyl'
    rows = report_iterations(what, run.perf.rows[:len(run.iterations)],
                             syncs, n_photons, card)
    temp = res.temperature[0]
    dusty = run.density0[0] > 0
    if not np.isfinite(temp).all() or not (temp[dusty] > 0).all():
        raise AssertionError('class1_cyl: temperatures not finite and > 0 in '
                             'dusty cells')
    if res.killed_int and res.n_steps < max_steps:
        raise AssertionError('class1_cyl Lucy: killed_int %d below the cap '
                             '(%d steps)' % (res.killed_int, res.n_steps))
    img_row = check_imaging(what, run, n_imaging, img_syncs, card)
    if img.killed_int and img.n_steps < imaging_max_steps:
        raise AssertionError('class1_cyl imaging: killed_int %d below the '
                             'cap (%d steps)' % (img.killed_int, img.n_steps))
    # the ISRF's share of the draws against its share of the luminosity
    lum = np.array([float(s.luminosity) for s in m.sources])
    i_isrf = next(i for i, s in enumerate(m.sources)
                  if type(s).__name__ == 'ExternalSphericalSource')
    n_picks = int(picks.sum())
    p = lum[i_isrf] / lum.sum()
    share = int(picks[i_isrf]) / n_picks
    sigma = np.sqrt(p * (1.0 - p) / n_picks)
    # the scattered share of each view at the shortest wavelength: seds
    # (n_stokes, n_orig, n_view, n_ap, n_nu), frequency ascending, origins
    # source and dust emission, then source and dust scattering
    seds = img.peeled[0]['datasets']['seds'][0][0, :, :, 0, -1]
    scat = (seds[2] + seds[3]) / np.maximum(seds.sum(axis=0), 1e-300)
    ray = img.raytrace
    # where the ISRF's photons start: a million emissions from the engine's
    # float32 tables (those found outside the grid escape at once, as in
    # the JAX package)
    geo32 = build_geometry_tables(m.grid, dev, torch.float32)
    st32 = build_source_tables(m.sources, dev, torch.float32,
                               length_scale=geo32.length_scale, grid=m.grid)
    gen = torch.Generator(device=dev).manual_seed(5)
    u = torch.rand((8, 1_000_000), generator=gen, device=dev)
    new = emit_packets(st32, *u[:4], tuple(u[4:]))
    cell = geo32.find_cell(new['x'], new['y'], new['z'], new['kx'],
                           new['ky'], new['kz'])
    from_isrf = st32.type_code[new['source']] == EXTERN_SPH
    isrf_outside = int((from_isrf & (cell == ESCAPED)).sum())
    out = dict(
        model_build_s=build_s, wall_s=wall, iterations=rows,
        lucy_steps=res.n_steps, lucy_killed_int=res.killed_int,
        lucy_killed_geo=res.killed_geo, imaging=img_row,
        imaging_killed_int=img.killed_int, launches=launches,
        peel_events=events[0],
        escape_tau_launches_per_step=launches['escape_tau'] / img.n_steps,
        peel_events_per_step=events[0] / img.n_steps,
        isrf_share=share, isrf_share_expected=p, isrf_share_sigma=sigma,
        isrf_picks=n_picks, isrf_outside_of_1e6=isrf_outside,
        isrf_emitted_of_1e6=int(from_isrf.sum()),
        scattered_share_shortest=scat.tolist(),
        raytracing=dict(wall_s=ray['wall'], batches=ray['batches'],
                        photons=ray['photons'], outside=ray['outside']),
        grid=dict(n_cells=int(np.prod(m.grid.shape)),
                  shape=list(m.grid.shape)),
        cut=dict(n_photons=n_photons, n_iterations=n_iterations,
                 max_steps=max_steps, n_imaging=n_imaging,
                 imaging_max_steps=imaging_max_steps))
    phase('class1_cyl (%d x %d x %d cells): run_lucy_model in %.3f s (model '
          'built in %.3f s); Lucy %d steps, killed %d/%d; imaging %d steps, '
          'killed_int %d; escape_tau %d launches for %d peel events '
          '(%.3f per step); raytracing %d photons in %d batches, %.3f s, %d '
          'outside; the ISRF drew %.5f of %d sources (its luminosity share '
          '%.5f, sigma %.2e); %d of its 1,000,000-draw photons (%d) start '
          'outside the grid; scattered share at 0.3 um per view (10, 60, 85 '
          'degrees) %s [%s]'
          % (*m.grid.shape[::-1], wall, build_s, res.n_steps,
             res.killed_int, res.killed_geo, img.n_steps, img.killed_int,
             launches['escape_tau'], events[0],
             launches['escape_tau'] / img.n_steps, ray['photons'],
             ray['batches'], ray['wall'], ray['outside'], share, n_picks, p,
             sigma, isrf_outside, int(from_isrf.sum()),
             ['%.4f' % v for v in scat], card))
    if res.killed_geo or ray['outside'] or launches['escape_tau'] > events[0]:
        raise AssertionError('class1_cyl: %s' % out)
    if abs(share - p) > 3.0 * sigma:
        raise AssertionError('class1_cyl: the ISRF drew %.5f of the sources, '
                             'its luminosity share is %.5f (sigma %.2e)'
                             % (share, p, sigma))
    if not scat[2] > scat[0]:
        raise AssertionError('class1_cyl: scattered share at 0.3 um of the 85 '
                             'degree view %g, of the 10 degree view %g'
                             % (scat[2], scat[0]))
    if not all(launches.values()):
        raise AssertionError('class1_cyl: a kernel was not launched: %s'
                             % launches)

    # the kernels on this run's own calls
    n_dust, n_cells = run.density0.shape
    err = check_calls(dv, dcalls, n_dust, n_cells, dev, 'class1_cyl calls')
    t = time_calls(dv, dcalls, n_dust, n_cells, dev)
    t['lanes'] = 'class1_cyl steps'
    phase('deposit_visit class1_cyl Lucy calls (%d, %d visits only): counts '
          'and uids equal, max abs energy err %.3g; B=%d n_cells=%d: device '
          '%.2f us, host %.2f us per call, plain %.4f ms, index_add_ %.4f '
          'ms, bound %.3f us [%s]'
          % (len(dcalls), sum(d is None for _, d, _, _ in dcalls), err,
             t['B'], n_cells, t['device_us'], t['host_us'], t['plain_ms'],
             t['library_ms'], t['bound_us'], card))
    geo64 = build_geometry_tables(m.grid, dev, torch.float64)
    rho64 = _density_array(m, geo64.length_scale, dev, torch.float64)
    rho32 = _density_array(m, geo64.length_scale, dev, torch.float32)
    tables = (geo64, rho32.T.contiguous(), rho64.T.contiguous())
    walks = [check_window('cylindrical', w, wcalls[w], tables,
                          img.batch_size, card) for w in WALK_WINDOWS]
    kinds = {k for k, _ in ccalls}
    if kinds != {'cylindrical'}:
        raise AssertionError('class1_cyl columns: calls of %s' % kinds)
    cols = check_columns('class1_cyl raytracing (phase 14)', 'cylindrical',
                         [c for _, c in ccalls], tables, card)
    out.update(deposit_visit=dict(max_abs_err=err, timing=t), walks=walks,
               columns=cols)
    return launches, out


def sources_phase(card):
    """Phase 15: the source types of ROADMAP.md item 4 on the card in
    float32. A PlaneParallelSource's beam through a uniform cartesian slab
    of pure absorbers (tau 1, absorptions kill): the escaped share within
    3 sigma of exp(-1). An ExternalBoxSource filling the quickstart's box:
    the emitted positions' means and variances within 3 sigma of uniform.
    A MapSource with an LTE spectrum after one Lucy iteration: the
    emission cells' counts against the map's luminosity, chi^2 per degree
    of freedom below 2, and the LTE frequencies inside the dust's
    emissivity grid."""
    import torch
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.grid import CartesianGrid
    from hyperion_tpu_torch.sources import (ExternalBoxSource, MapSource,
                                            PlaneParallelSource)
    from hyperion_tpu_torch.transport.dtable import build_dust_tables
    from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
    from hyperion_tpu_torch.transport.lucy import compute_jnu_var, run_lucy
    from hyperion_tpu_torch.transport.stable import (N_EMIT_EXTRA,
                                                     build_source_tables,
                                                     emit_packets)
    from hyperion_tpu_torch.util.constants import au, lsun

    dev, f32 = torch.device('cuda'), torch.float32
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}

    # the beam: 200,000 photons up through a slab of tau 1
    grid = CartesianGrid(*[np.linspace(-1.0, 1.0, 9)] * 3)
    nu = np.logspace(5, 18, 20)
    chi = 2.0
    dust = IsotropicDust(nu, np.zeros(20), np.repeat(chi, 20))
    geo = build_cartesian_geometry(grid, dev, f32)
    dt = build_dust_tables([dust], dev, f32)
    beam = PlaneParallelSource(luminosity=1.0, temperature=5000.0,
                               radius=0.5, position=(0.1, -0.2, -1.0),
                               direction=(0.0, 0.0))
    st = build_source_tables([beam], dev, f32, length_scale=geo.length_scale)
    density = torch.full((1, grid.n_cells), 0.5 / chi * geo.length_scale,
                         dtype=f32, device=dev)
    n = 200_000
    res = run_lucy(geo, dt, st, density, gen, n_photons=n, n_iterations=1,
                   batch_size=50_000, kill_on_absorb=True, verbose=False)
    escaped = 1.0 - res.killed_int / n
    p = np.exp(-1.0)
    sigma = np.sqrt(p * (1 - p) / n)
    out['beam'] = dict(escaped=escaped, expected=p, sigma=sigma,
                       killed_geo=res.killed_geo,
                       energy_current=res.energy_current)
    phase('plane-parallel beam through tau 1 of pure absorbers: %.5f escaped '
          '(exp(-1) %.5f, %.2f sigma) [%s]'
          % (escaped, p, (escaped - p) / sigma, card))
    if abs(escaped - p) > 3 * sigma or res.killed_geo or \
            res.energy_current != n:
        raise AssertionError('plane-parallel beam: %s' % out['beam'])

    # the box: a million positions in the quickstart's +-50 au box
    lim = 50 * au
    box = ExternalBoxSource(luminosity=lsun, temperature=5000.0)
    box.bounds = [(-lim, lim)] * 3
    q = tutorial_model()
    qgeo = build_cartesian_geometry(q.grid, dev, f32)
    st = build_source_tables([box], dev, f32, length_scale=qgeo.length_scale)
    n = 1_000_000
    u = torch.rand((4 + N_EMIT_EXTRA, n), generator=gen, device=dev)
    new = emit_packets(st, *u[:4], u_extra=u[4:])
    pos = torch.stack([new[c] for c in 'xyz']).double() * \
        (qgeo.length_scale / lim)
    mean = pos.mean(dim=1).cpu().numpy()
    var = pos.var(dim=1).cpu().numpy()
    n_sig_mean = np.abs(mean) / np.sqrt(1.0 / 3.0 / n)
    n_sig_var = np.abs(var - 1.0 / 3.0) / np.sqrt(4.0 / 45.0 / n)
    cells = qgeo.find_cell(*(new[c] for c in ('x', 'y', 'z', 'kx', 'ky',
                                              'kz')))
    out['box'] = dict(mean=mean.tolist(), var=var.tolist(),
                      sigma_mean=n_sig_mean.tolist(),
                      sigma_var=n_sig_var.tolist(),
                      outside=int((cells < 0).sum()))
    phase('external box over the quickstart box: means %s (%s sigma), '
          'variances %s (%s sigma from 1/3), %d of %d outside [%s]'
          % (['%.5f' % v for v in mean], ['%.2f' % v for v in n_sig_mean],
             ['%.5f' % v for v in var], ['%.2f' % v for v in n_sig_var],
             out['box']['outside'], n, card))
    if (n_sig_mean > 3).any() or (n_sig_var > 3).any():
        raise AssertionError('external box: %s' % out['box'])

    # the LTE map: one Lucy iteration, then a million emissions
    grid = CartesianGrid(*[np.linspace(-10 * au, 10 * au, 9)] * 3)
    nu = np.logspace(8, 17, 32)
    dust = IsotropicDust(nu, np.repeat(0.5, 32), np.repeat(2.0, 32))
    lum = np.random.default_rng(15).uniform(0.0, 1.0, grid.shape)
    lum[lum < 0.2] = 0.0
    lmap = MapSource(luminosity=lsun, map=lum)
    geo = build_cartesian_geometry(grid, dev, f32)
    dt = build_dust_tables([dust], dev, f32)
    st = build_source_tables([lmap], dev, f32, length_scale=geo.length_scale,
                             grid=grid)
    density = torch.full((1, grid.n_cells), 1e-19 * geo.length_scale,
                         dtype=f32, device=dev)
    res = run_lucy(geo, dt, st, density, gen, n_photons=100_000,
                   n_iterations=1, batch_size=25_000, verbose=False)
    se = torch.as_tensor(res.specific_energy, dtype=f32, device=dev)
    jid, jfrac = compute_jnu_var(dt, se)
    u = torch.rand((4 + N_EMIT_EXTRA, n), generator=gen, device=dev)
    new = emit_packets(st, *u[:4], u_extra=u[4:], geometry=geo,
                       lte_ctx=(dt, jid, jfrac, se * density))
    # each photon's cell by its position (find_cell's direction would put
    # one emitted on the grid's face, with float32 rounding, outside: it
    # escapes at once, as in the JAX package; counted as 'outside')
    cells = geo.find_cell(*(new[c] for c in ('x', 'y', 'z', 'kx', 'ky',
                                             'kz')))
    walls = (geo.xw, geo.yw, geo.zw)
    idx = [(torch.searchsorted(w, new[c].contiguous(), right=True) - 1)
           .clamp(0, len(w) - 2) for w, c in zip(walls, 'xyz')]
    flat = (idx[2] * geo.n2 + idx[1]) * geo.n1 + idx[0]
    counts = torch.bincount(flat, minlength=grid.n_cells).cpu().numpy()
    expect = n * lum.reshape(-1) / lum.sum()
    pos_cells = expect > 0
    chi2 = float(((counts[pos_cells] - expect[pos_cells]) ** 2 /
                  expect[pos_cells]).sum())
    dof = int(pos_cells.sum()) - 1
    nu_lte = new['nu'].cpu().numpy()
    e_nu = dt.emiss_nu[0].cpu().numpy()
    out['map_lte'] = dict(chi2_per_dof=chi2 / dof, dof=dof,
                          in_dark_cells=int(counts[~pos_cells].sum()),
                          outside=int((cells < 0).sum()),
                          lucy_killed=[res.killed_int, res.killed_geo],
                          nu_range=[float(nu_lte.min()),
                                    float(nu_lte.max())])
    phase('LTE map after one Lucy iteration: emission cells chi^2/dof %.4f '
          '(%d dof), %d photons in dark cells, %d found outside the grid; '
          'frequencies %.4e .. %.4e Hz (emissivity grid %.4e .. %.4e) [%s]'
          % (chi2 / dof, dof, out['map_lte']['in_dark_cells'],
             out['map_lte']['outside'], nu_lte.min(), nu_lte.max(),
             e_nu.min(), e_nu.max(), card))
    if chi2 / dof >= 2.0 or out['map_lte']['in_dark_cells'] or \
            not (np.isfinite(nu_lte).all() and
                 nu_lte.min() >= e_nu.min() * 0.999 and
                 nu_lte.max() <= e_nu.max() * 1.001):
        raise AssertionError('LTE map: %s' % out['map_lte'])
    return out


def cylindrical_kernels(cyl, launches):
    """The kernels line of ``--cylindrical``: each kernel on phase 14's own
    calls (class1_cyl's Lucy deposits, imaging walks and raytracing
    columns) and its launches there."""
    t, w, c = cyl['deposit_visit']['timing'], cyl['walks'][0], cyl['columns']
    walk_keys = ('model', 'steps', 'calls', 'views', 'device_us',
                 'device_us_per_view', 'host_us', 'plain_ms', 'bound_us',
                 'bound_by', 'longest_walk')
    return [
        dict(name='deposit_visit', route='cuda', source=KERNEL_SOURCE,
             replaces=REPLACES, launches=sum(launches['deposit_visit'].values()),
             max_abs_err=cyl['deposit_visit']['max_abs_err'],
             ms=t['device_us'] / 1e3, plain_ms=t['plain_ms'],
             bound_ms=t['bound_us'] / 1e3, bound_by='bytes',
             library_ms=t['library_ms'], device_us=t['device_us'],
             host_us=t['host_us'], bound_us=t['bound_us']),
        dict(name='escape_tau', route='cuda', source=ESCAPE_TAU_SOURCE,
             replaces=ESCAPE_TAU_REPLACES,
             launches=sum(launches['escape_tau'].values()),
             max_abs_err=max(x['f32_vs_plain32_max_abs_err']
                             for x in cyl['walks']),
             ms=w['device_us'] / 1e3, plain_ms=w['plain_ms'],
             bound_ms=w['bound_us'] / 1e3, bound_by=w['bound_by'],
             library_ms=None, f64_max_rel_err=max(
                 x['f64_max_rel_err'] for x in cyl['walks']),
             windows=[{k: x[k] for k in walk_keys} for x in cyl['walks']]),
        dict(name='escape_column', route='cuda', source=ESCAPE_TAU_SOURCE,
             replaces=ESCAPE_COLUMN_REPLACES,
             launches=sum(launches['escape_column'].values()),
             max_abs_err=c['f32_vs_plain32_max_abs_err'],
             ms=c['device_us'] / 1e3, plain_ms=c['plain_ms'],
             bound_ms=c['bound_us'] / 1e3, bound_by=c['bound_by'],
             library_ms=None, f64_max_rel_err=c['f64_max_rel_err'],
             host_us=c['host_us'], longest_walk=c['longest_walk'],
             plan=c['plan'])]


def main():
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--yso-thick-photons', type=int, default=None,
                    help='run only phases 1, 2 and 9, with 2 iterations of '
                    'this many photons (bench.py: 2000000)')
    ap.add_argument('--raytracing', action='store_true',
                    help='run only phases 1, 2, 4 and 8 (for their specific '
                    'energies) and 11-13')
    ap.add_argument('--cylindrical', action='store_true',
                    help='run only phases 1, 2, 14 (with its part of phases '
                    '10 and 13) and 15')
    args = ap.parse_args()
    t_start = time.time()
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False: this needs '
              'an NVIDIA card', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from hyperion_tpu_torch.transport import _build
    from hyperion_tpu_torch.transport import deposit_visit as dv
    from hyperion_tpu_torch.transport import escape_tau as et

    # 1. the card and the software
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([_build._nvcc(), '--version'], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    phase('python %s, torch %s, CUDA %s, %s, %s'
          % (sys.version.split()[0], torch.__version__, torch.version.cuda,
             nvcc[-1], torch.cuda.get_device_name(0)))
    OUT.mkdir(parents=True, exist_ok=True)
    device = torch.device('cuda')
    result_line = json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}})

    # 2. build both libraries, one nvcc each, at once
    t0 = time.time()
    libs = _build.build('deposit_visit', 'escape_tau')
    phase('built %s in %.2f s' % (', '.join(lib.name for lib in libs),
                                  time.time() - t0))

    if args.yso_thick_photons:
        # 9 alone, at the size asked for
        t0 = time.time()
        _, yso = yso_thick_phase(dv, card, args.yso_thick_photons, 2)
        yso.update(card=card, wall_s=time.time() - t0)
        (OUT / ('yso_thick_%d.json' % args.yso_thick_photons)).write_text(
            json.dumps(yso, indent=1))
        print(json.dumps({'yso_thick': yso}), flush=True)
        print(result_line, flush=True)
        return 0

    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda)
    launches = dict(deposit_visit={}, escape_tau={}, escape_column={})

    def run_phase(n, fn, *a, **kw):
        t0 = time.time()
        out = fn(*a, **kw)
        record.setdefault('phase_s', {})[n] = time.time() - t0
        phase('phase %d in %.1f s' % (n, time.time() - t0))
        return out

    def raytracing_phases(se4, phase8):
        """Phases 11-13; returns their column reports."""
        # for scripts/raytrace_spread.py and scripts/raytrace_vs_mc.py
        np.save(OUT / 'class2_specific_energy.npy',
                phase8['specific_energy'])
        np.save(OUT / 'quickstart_specific_energy.npy', se4)
        t0 = time.time()
        launches['escape_tau']['class2_raytrace'], \
            launches['escape_column']['class2_raytrace'], \
            record['class2_raytrace'], calls11 = run_phase(
                11, class2_raytrace_phase, et, card, phase8)
        (launches['escape_tau']['mono_a'], launches['escape_tau']['mono_b']), \
            launches['escape_column']['mono_raytrace'], record['mono'], \
            calls12 = run_phase(12, mono_phase, et, card, se4)
        cols = record['escape_column_calls'] = run_phase(
            13, column_phase, card,
            [('class2 raytracing (phase 11)',
              class2_model(CLASS2_CUT['n_photons']), calls11),
             ('quickstart mono raytracing (phase 12 b)',
              tutorial_model(), calls12)])
        record['class2_raytrace']['longest_walk'] = cols[0]['longest_walk']
        phase('phases 11-13 in %.1f s' % (time.time() - t0))
        return cols

    def cylindrical_phases():
        """Phases 14 and 15; returns phase 14's report."""
        launches_14, cyl = run_phase(14, class1_cyl_phase, dv, et, card,
                                     **CLASS1_CYL_CUT)
        for name, n in launches_14.items():
            launches[name]['class1_cyl'] = n
        record['class1_cyl'] = cyl
        record['sources'] = run_phase(15, sources_phase, card)
        return cyl

    def column_kernel(cols):
        """The kernels line's escape_column entry: class2's calls (phase
        11, the full-width raytracing of the main path) as the headline,
        the quickstart's and class1_cyl's beside them."""
        c = cols[0]
        return dict(name='escape_column', route='cuda',
                    source=ESCAPE_TAU_SOURCE, replaces=ESCAPE_COLUMN_REPLACES,
                    launches=sum(launches['escape_column'].values()),
                    max_abs_err=max(r['f32_vs_plain32_max_abs_err']
                                    for r in cols),
                    ms=c['device_us'] / 1e3, plain_ms=c['plain_ms'],
                    bound_ms=c['bound_us'] / 1e3, bound_by=c['bound_by'],
                    library_ms=None, device_us=c['device_us'],
                    host_us=c['host_us'], bound_us=c['bound_us'],
                    launches_by_phase=launches['escape_column'],
                    f64_max_rel_err=max(r['f64_max_rel_err'] for r in cols),
                    f32_max_rel_err_vs_f64=max(r['f32_max_rel_err_vs_f64']
                                               for r in cols),
                    calls=[{k: r[k] for k in (
                        'run', 'model', 'calls', 'views', 'B', 'device_us',
                        'host_us', 'plain_ms', 'bound_us', 'bound_by',
                        'longest_walk')} for r in cols])

    if args.cylindrical:
        cyl = cylindrical_phases()
        (OUT / 'cylindrical.json').write_text(json.dumps(record, indent=1))
        kernels = cylindrical_kernels(cyl, launches)
        print(json.dumps({'kernels': kernels}), flush=True)
        print(result_line, flush=True)
        return 0

    if args.raytracing:
        # 4 and 8 for their specific energies, then 11-13
        *_, se4 = run_phase(4, run_slice, dv, et, card)
        *_, phase8 = run_phase(8, class2_phase, dv, et, card, **CLASS2_CUT)
        kernel = column_kernel(raytracing_phases(se4, phase8))
        (OUT / 'raytracing.json').write_text(json.dumps(record, indent=1))
        for name in ('escape_tau', 'escape_column'):
            if not all(launches[name].values()):
                raise AssertionError('%s was not launched on the main path: '
                                     '%s' % (name, launches[name]))
        print(json.dumps({'kernels': [kernel]}), flush=True)
        print(result_line, flush=True)
        return 0

    # 3. kernel against the plain version, and its times
    max_err, checks, timings, hot = run_phase(3, kernel_phase, dv, device,
                                              card)
    record.update(kernel_checks=checks, kernel_timings=timings,
                  tutorial_contention=hot)

    # 4. the slice, through the kernels
    launches['deposit_visit']['tutorial'], launches['escape_tau']['tutorial'], \
        iterations, wall, img, se4 = run_phase(4, run_slice, dv, et, card)
    record['slice'] = dict(wall_s=wall, iterations=iterations, imaging=img)

    # 5. physics on the card
    record['inverse_square_median_ratio'], record['bench_quickstart'] = \
        run_phase(5, physics_on_card, card)

    # 6. deposit_visit on the YSO path's own calls
    yso_err, yso_check, yso_t, yso_hot = run_phase(6, yso_calls_phase, dv,
                                                   device, card)
    record.update(yso_thick_check=yso_check, yso_thick_timing=yso_t,
                  yso_thick_contention=yso_hot)

    # 7. MRW physics on the card
    record['mrw'] = run_phase(7, mrw_phase, card)

    # 8. the class2 YSO model through the normal entry point
    launches['deposit_visit']['class2'], launches['escape_tau']['class2'], \
        record['class2'], phase8 = run_phase(8, class2_phase, dv, et, card,
                                             **CLASS2_CUT)

    # 9. bench.py's yso_thick configuration, cut
    launches['deposit_visit']['yso_thick'], record['yso_thick'] = \
        run_phase(9, yso_thick_phase, dv, card, **YSO_THICK_CUT)

    # 10. escape_tau on the imaging path's own walk calls
    walks = record['escape_tau_walks'] = run_phase(10, escape_tau_phase, card)

    # 11-13. raytracing and monochromatic imaging, and the column mode on
    # their own calls
    cols = raytracing_phases(se4, phase8)

    # 14-15. BASELINE config 3 (cylindrical-polar), with config 3's own
    # calls of phases 6, 10 and 13's checks, and the remaining sources
    cyl = cylindrical_phases()
    walks = walks + cyl['walks']
    cols = cols + [cyl['columns']]
    phase('phases 3-15 in %.1f s' % (time.time() - t_start))

    record['launches'] = launches
    record['wall_s'] = time.time() - t_start
    (OUT / 'results.json').write_text(json.dumps(record, indent=1))
    for name, counts in launches.items():
        if not all(counts.values()):
            raise AssertionError('%s was not launched on the main path: %s'
                                 % (name, counts))
    t = next(r for r in timings if r['lanes'] == 'tutorial steps')
    # the headline times: the quickstart's first window (the full-size
    # slice); every window's beside them
    q = walks[0]
    kernels = [dict(name='deposit_visit', route='cuda', source=KERNEL_SOURCE,
                    replaces=REPLACES,
                    launches=sum(launches['deposit_visit'].values()),
                    max_abs_err=max(max_err, yso_err,
                                    cyl['deposit_visit']['max_abs_err']),
                    ms=t['device_us'] / 1e3,
                    plain_ms=t['plain_ms'], bound_ms=t['bound_us'] / 1e3,
                    bound_by='bytes', library_ms=t['library_ms'],
                    device_us=t['device_us'], host_us=t['host_us'],
                    bound_us=t['bound_us'],
                    launches_by_phase=launches['deposit_visit'],
                    yso_device_us=yso_t['device_us'],
                    yso_host_us=yso_t['host_us'],
                    yso_bound_us=yso_t['bound_us'],
                    yso_plain_ms=yso_t['plain_ms'],
                    yso_library_ms=yso_t['library_ms'],
                    yso_contention=yso_hot,
                    class1_cyl=cyl['deposit_visit']['timing']),
               dict(name='escape_tau', route='cuda', source=ESCAPE_TAU_SOURCE,
                    replaces=ESCAPE_TAU_REPLACES,
                    launches=sum(launches['escape_tau'].values()),
                    max_abs_err=max(w['f32_vs_plain32_max_abs_err']
                                    for w in walks),
                    ms=q['device_us'] / 1e3, plain_ms=q['plain_ms'],
                    bound_ms=q['bound_us'] / 1e3, bound_by=q['bound_by'],
                    library_ms=None, device_us=q['device_us'],
                    host_us=q['host_us'], bound_us=q['bound_us'],
                    launches_by_phase=launches['escape_tau'],
                    f64_max_rel_err=max(w['f64_max_rel_err'] for w in walks),
                    f32_max_rel_err_vs_f64=max(w['f32_max_rel_err_vs_f64']
                                               for w in walks),
                    windows=[{k: w[k] for k in (
                        'model', 'steps', 'calls', 'views', 'device_us',
                        'device_us_per_view', 'host_us', 'plain_ms',
                        'bound_us', 'bound_by', 'longest_walk')}
                        for w in walks]),
               column_kernel(cols)]
    record['kernels'] = kernels
    (OUT / 'results.json').write_text(json.dumps(record, indent=1))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(result_line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
