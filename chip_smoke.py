#!/usr/bin/env python3
"""Smoke run of hyperion_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card and the software: name and power limit, torch, CUDA, nvcc;
2. build the deposit_visit, escape_tau, voronoi_locate and octree_locate
   kernels and the conditional nodes' library (cond_node) from
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
   1000 um (the box's tau is ~0.015), the imaging wall, steps, ms per step,
   its steps run as graph replays with at most IMAGING_READS host
   synchronisations a step, set-up included (check_imaging); both kernels'
   launch counts are
   reset just before and read just after, beside the Lucy steps run
   eagerly, captured into CUDA graphs and replayed (check_step_counts).
   Before it, a CUDA graph of torch.rand calls from a registered generator
   draws what the eager calls draw (graph_rand_check); after it, the first
   Lucy iteration runs whole both ways, as the eager step loop and as
   run_lucy_iteration's graph replays (graph_witness: steps, killed, events,
   n_photons_cell, energy_current and the generators' states equal,
   energy_sum within RTOL, each way's ms per step), and so does the imaging
   iteration, as the eager step loop and as run_final's graph replays
   (imaging_witness: steps, killed, events, energy_current and the
   generators' states equal, every cube within RTOL, each way's ms per
   step, host reads a step, replays and peak memory);
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
   iteration of 200,000 photons capped at 2,500 steps and 100,000 imaging
   photons capped at 1,000 steps (CLASS2_CUT; lanes alive at a cap are
   killed and counted in killed_int): no geometry kills, energy_current
   the photon count, the SEDs finite and >= 0 and the 80 degree view
   fainter than the 20 degree one at the shortest wavelength; per
   iteration wall, photons/s, steps, ms per step, occupancy, killed_int and
   host syncs per step (at most 1.05 a Lucy step, IMAGING_READS an
   imaging step); escape_tau launches per imaging
   step beside the peel events per step (one launch in each event); the
   first Lucy iteration's first 300 steps both ways (graph_witness) and
   the imaging iteration's first 200 (imaging_witness);
9. bench.py's yso_thick configuration through transport.lucy.run_lucy as
   bench.py calls it, cut to 1 iteration of 10,000 photons (bench.py: 2
   of 2,000,000; ``--yso-thick-photons N`` runs phases 1, 2 and 9 alone
   with 2 iterations of N photons): nothing killed, the steps per
   iteration beside the JAX package's;
10. escape_tau against its plain version on the very walk calls of
   imaging steps 1-20 and 41-60 (WALK_WINDOWS) of the quickstart
   (cartesian, B = 125,000) and of class2 (spherical-polar, B = 50,000),
   recorded from imaging_runner.run_imaging with its steps driven eagerly
   (walk_calls; a window that records nothing fails): one call per peel
   event with the event's V views as (V, B) directions (and one per forced
   first interaction). In each window, the kernel (which walks in float64) with
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
   both; (a)'s source pass at 0.5 um and its dust pass at 100 um both
   ways (imaging_witness);
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
   the 10 degree view's, one escape_tau launch in each peel event, no
   raytraced photon outside the grid or its cell; walls, steps, ms per
   step, occupancy and host reads per stage; the first Lucy iteration's
   first 200 steps both ways (graph_witness, as in phases 16-18) and the
   imaging iteration's first 100 (imaging_witness). Then the three
   kernels against their plain versions on this run's own calls, by the
   methods of phases 6 (deposit_visit, 80 Lucy calls of graph_witness's
   eager run), 10 (escape_tau, the WALK_WINDOWS imaging steps of
   imaging_witness's eager run) and 13 (escape_column, the raytracing
   calls), with their times;
15. the other sources of ROADMAP.md item 4 on the card in float32: a
   plane-parallel beam through a slab of pure absorbers of tau 1 (escaped
   share within 3 sigma of exp(-1)), an external box over the
   quickstart's box (positions' means and variances within 3 sigma of
   uniform), and an LTE map source after one Lucy iteration (emission
   cells against the map, chi^2 per degree of freedom below 2).

16. BASELINE.md config 4 (sph_octree_model: 100,000 SPH particles, 80%
   in a Plummer sphere and 20% in 10 clumps, imported by the port's
   construct_octree with the native library into an octree of ~12,400
   nodes over a +-0.5 pc cube, three point sources of 1.2e4 Lsun in all,
   SEDs at 0, 45 and 90 degrees, a 128 x 128 image at 45 degrees of 10
   wavelengths, a binned SED over all directions, raytracing with phase
   11's photons) at SPH_OCT_CUT's photons through run_lucy_model: no
   geometry kills, killed_int 0 with every Lucy iteration below its step
   cap (a walk that stalled would run into it), energy_current the photons
   emitted, temperatures finite and > 0 in dusty leaves, no photon in a
   refined node, the grid's dust mass within [0.95, 1] of the particles'
   in the cube, the binned SED within 3% of 1.2e4 Lsun, SEDs and images
   finite and >= 0, one escape_tau launch in each peel event, no
   raytraced photon outside the grid or its cell, the native library
   loaded; walls, steps, ms per step, occupancy and host reads per stage;
   then the three kernels against their plain versions on this run's own
   calls (phase 14's way); the octree's locate kernel (octree_locate: its
   find_cell and find_wall) launched in the Lucy and the imaging
   iterations, and bit-equal to its plain versions on every call of three
   Lucy steps (B = 131,072 float32 lanes), with its device and host time a
   call and its bound;
17. BASELINE.md config 5 on one card (orion_amr_model: a BoxLib plotfile
   of 3 levels of 8 fabs of 32^3 cells written here and read by the
   port's parse_orion, a dense core of tau ~ 100 with a 10 Lsun sink, MRW
   gamma 2, forced first interaction, SEDs at 10, 45 and 80 degrees, a 128
   x 128 image at 45 degrees, raytracing) at AMR_CUT's photons and step
   caps (one emission, nearly every photon killed at a cap: the share is
   printed): the plotfile read back equal to what was written, no geometry
   kills, killed_int only at the step caps, MRW jumps counted and > 0,
   the forced first interaction's weights finite and > 0, and the checks
   and kernels of phase 16;
18. config 4's cloud on a Voronoi mesh (voronoi_cloud_model: VORONOI_CLOUD's
   50,000 sites drawn from config 4's particles, tessellated by the port's
   VoronoiGrid, equal gas mass per cell, config 4's sources and outputs) at
   VORONOI_CUT's photons (3 Lucy iterations and the imaging iteration of
   1,000,000 each) through run_lucy_model: phase 16's checks, the volumes
   partitioning the box and the grid's dust mass the one given, the
   locate kernel launched on the main path and equal to its plain version
   on every call of 40 Lucy steps and of the raytracing pass's positions,
   its lanes at the cap, the kernels of phases 6, 10 (escape_tau kind 5)
   and 13 on this run's own calls; then the lattice oracle of
   tests/test_torch_voronoi.py on the card at 16^3 sites and 1,000,000
   photons (VORONOI_LATTICE);
19. two ranks sharing the card (hyperion_tpu_torch.parallel: one process
   a rank, started by its launcher, gloo staging through pinned host
   memory; NCCL needs a card a rank): (a) phase 4's tutorial at phase 4's
   size through run_lucy_model(parallel=2), each rank phase 4's batch:
   every iteration's energy_current 500,000 and nothing killed, phase 4's
   band and temperature checks, the median cell temperature within 1% of
   phase 4's, rank 0's first 20 deposit_visit calls held to the plain
   version; (b) one Lucy iteration of it with the grid cut into two slabs
   (shard_grid): energy exact, nothing killed, both slabs with deposits,
   within 2% of phase 4's first iteration in total and 5% in the median
   per-cell ratio; (c) __graft_entry__.dryrun_multichip's thick MRW 8^3
   case slab-sharded, both slabs with deposits. Each prints its wall,
   photons/s, steps, ms per step and the collectives' and ring hops' host
   times (the launcher's start-up too). A rank that fails fails the phase.

``--raytracing`` runs phases 1, 2, 4, 8 and 11-13 alone; ``--cylindrical``
phases 1, 2, 14 (with its parts of phases 6, 10 and 13) and 15;
``--hierarchical`` phases 1, 2, 16 and 17; ``--voronoi`` phases 1, 2 and
18; ``--parallel`` phases 1, 2 and 19 (with phase 4, its reference);
``--graph`` phases 1 and 2, graph_rand_check, and graph_witness and
imaging_witness on the models of phases 4, 8, 14 and 16-18, built and run
to the start of their first Lucy iteration (the imaging iteration from a
zero specific energy), and phase 12's monochromatic source pass.

On the card run_lucy_iteration runs each Lucy iteration, run_final the
imaging iteration and run_mono_pass each monochromatic pass as replays of
a CUDA graph of GRAPH_STEPS steps (hyperion_tpu_torch/transport/engine.py):
its first step runs eagerly, the next GRAPH_STEPS are captured, and a
replay launches the captured kernels again without their wrappers. A
step's refill, and the Lucy step's MRW move, are IF conditional nodes of
the graph (engine.run_if, csrc/cond_node.cu) that a replay skips where
their gate is false; each iteration counts the bodies that ran, and the
witnesses and phases 4, 5, 8 and 9 print them beside the working steps
(check_bodies: the eager loop runs them every step, the graph no more
often, and a whole tutorial, quickstart or class2 iteration skips some
refills). Each
kernel's launch count (its wrapper's: a launch captured into a graph
counts once, at its capture) is reset just before and read just after
each main-path run (phases 4, 8, 9, 11, 12, 14, 16, 17, 18 and, on rank
0, 19); the kernels line sums them, and phases 4, 8 and 9 print the
device's deposit_visit launches beside them (check_step_counts). The
recorders that hold a kernel to its plain version on a run's own calls
record eager calls: a captured call's lanes are the graph's, which each
replay writes anew.
It ends with a JSON line of the kernels, then the result line
{"ok": true, "device": {...}}. Longer records go to chip_smoke_out/.
It needs no network and imports nothing of JAX or of hyperion_tpu.
"""

import contextlib
import functools
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
# tail sets their count, so phases 8, 9 and 14 run cut, to keep the whole
# script well inside its 1,200 s on the slowest hosts seen (phases 3-17
# took 884.6 s on one H100 machine and 1,115.5 s on another with the cuts
# before these; with phase 18, phases 3-18 took 759.7 s with these cuts,
# PERF.md): fewer iterations first, then fewer
# photons (or, for class2 and class1_cyl, step caps); grid, dust,
# densities, star and MRW stay as given.
# bench.py:103-195, yso_thick: the run_lucy arguments, and the photons and
# iterations chip_smoke runs (bench.py: 2 x 2,000,000, some 58,000 steps
# each; 1 x 50,000 takes ~12,600, 1 x 20,000 ~8,400, at 10-16 ms a step on
# the H100; --yso-thick-photons runs it at bench size; 5,000 photons took
# as long as 10,000, 8,385 steps in 82.3 s: the diffusion tail sets it)
YSO_THICK = dict(batch_size=4096, mrw_gamma=1.0, n_mrw_max=100000,
                 n_reabs_max=100, max_steps=100000)
YSO_THICK_CUT = dict(n_photons=10_000, n_iterations=1)
# examples/class2_sed.py as chip_smoke runs it: its 200,000 photons, 1 of
# its 5 iterations, capped at 2,500 steps. The diffusion tail (photons deep
# in the disk's inner rim, whose innermost shells are too thin for MRW
# jumps) is heavy: on the H100 145-155 of the 200,000 photons were still
# alive at 8,000 steps and 251 at 4,000, and the iteration's occupancy was
# 5% at B = 50,000 (its photons ~107 events each: all are emitted in the
# first ~1,000 steps). Lanes alive at the cap are killed and counted in
# killed_int. Imaging is cut to 100,000 of its 500,000 photons, capped at
# 1,000 steps, for the same diffusion tail (phase 11's imaging too). The
# caps were 4,000 and 1,500 until phase 19 came: with them phases 3-19
# took 958.1 s on a slow host (PERF.md), over the 950 s they are held to,
# and the tail's steps are 15-27 ms each there.
CLASS2_CUT = dict(n_photons=200_000, n_iterations=1, max_steps=2500,
                  n_imaging=100_000, imaging_max_steps=1000)
# BASELINE.md config 3 (class1_cyl, phase 14) as chip_smoke runs it: the
# full 200 x 200 x 1 auto grid and every density component and source, with
# the photons cut so that the phase stays near a minute and a half on the
# card: 1 Lucy iteration of 100,000 photons capped at 2,500 steps (uncut,
# the counts of examples/class2_sed.py: 5 iterations of 200,000; at a
# 2,000-step cap the iteration's fixed host reads came to 1.051 per step,
# over report_iterations' 1.05) and
# 50,000 imaging photons capped at 1,500 steps (uncut: 500,000; its
# graph-run steps with the tables' fixed reads come to 0.259 host
# synchronisations a step, under check_imaging's IMAGING_READS); the
# raytracing photons are RAYTRACING's, uncut. Lanes alive at a cap are killed and
# counted in killed_int.
CLASS1_CYL_CUT = dict(n_photons=100_000, n_iterations=1, max_steps=2500,
                      n_imaging=50_000, imaging_max_steps=1500)
# its star's and its ISRF stand-in's luminosities (Lsun)
CLASS1_CYL_LUM = dict(star=1.0, isrf=0.1)
# BASELINE.md config 4 (sph_octree, phase 16): 100,000 SPH particles from
# np.random.default_rng(1234) (80% Plummer, scale radius 0.1 pc; 20% in 10
# clumps of sigma 0.01 pc), the +-0.5 pc root cube, n_ref 32, kernel sigma
# half the distance to the 32nd neighbour, 100 Msun of gas at dust-to-gas
# 0.01 (tau ~ 2 through the Plummer body's centre, ~ 3 through a clump in
# the HG stand-in dust), three point sources of 1.2e4 Lsun in all; its
# binned SED's bins over the dust table's frequency range
SPH_OCT = dict(n_particles=100_000, seed=1234, half_pc=0.5, n_ref=32,
               n_neighbour=32, gas_msun=100.0, dust_to_gas=0.01,
               luminosity_lsun=1.2e4, binned_bins=250)
# config 4 as chip_smoke runs it: its 5 Lucy iterations of 1,000,000
# photons and 1,000,000 imaging photons, with step caps far above what the
# optically moderate cloud needs (a stalled walk would run into them); the
# particles, the tree and the image sizes are not cut
SPH_OCT_CUT = dict(n_photons=1_000_000, n_iterations=5, max_steps=20_000,
                   n_imaging=1_000_000, imaging_max_steps=20_000)
# BASELINE.md config 5 (orion_amr, phase 17) on one card: a BoxLib plotfile
# of 3 levels (refinement 2), each 64^3 cells in 8 fabs of 32^3, over 0.2,
# 0.1 and 0.05 pc cubes around the origin; gas density rho_c / (1 + (r /
# r_c)^2) (g/cm^3, pc), dust-to-gas 0.01: tau ~ 100 from the centre
# outwards and ~ 10 across a finest central cell in the HG stand-in dust
ORION_AMR = dict(level_widths_pc=(0.2, 0.1, 0.05), fab_cells=32,
                 rho_c=1e-15, r_c_pc=0.005, dust_to_gas=0.01)
# config 5 as chip_smoke runs it: its 3 Lucy iterations, each of 131,072
# photons in as many lanes (one emission, no refill) capped at 500 steps,
# and 131,072 imaging photons capped at 500 steps (uncut: 1,000,000
# photons each; fewer imaging steps would spread its fixed host reads
# over too few for check_imaging's IMAGING_READS a step: 0.290 at 500).
# The core is thick: on the H100 a first run of 1,000,000 photons at B =
# 131,072 had emitted 163,842 of them after 3,000 steps (~2,400 steps a
# photon; PERF.md), and the caps keep the whole script well inside its
# time limit (at 2,000 and 1,000 steps phase 17 took 159 s of an 885 s
# run). Lanes alive at a cap are killed and counted in killed_int: at
# these caps nearly every photon (phase 17 prints the share), so config
# 5's temperatures and SEDs are not physical; the phase drives the AMR
# walk, MRW and the forced first interaction on the card and holds the
# kernels to their plain versions. The levels and fabs are not cut.
AMR_CUT = dict(n_photons=131_072, n_iterations=3, max_steps=500,
               n_imaging=131_072, imaging_max_steps=500,
               batch_size=131_072)
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
# 17) (cylindrical-polar; each phi wall would add 12); the box exit (three
# differences and divisions, two minima) and the move (6), with the
# root-box test (6 comparisons) (octree) or the cell's walls (12) and the
# probe (2) (AMR); the locate of the cell entered comes on top: the
# octree's descend (3 comparisons a level) and the AMR grid's indexed
# locate (AMR_LOCATE_FLOPS_PER_LEVEL at each level), counted on the run's
# own crossings (walk_work). The bound counts this work, whatever the
# kernel does around it.
FLOPS_PER_CROSSING = {'cartesian': 25, 'spherical': 120, 'cylindrical': 64,
                      'octree': 20, 'amr': 28, 'voronoi': 18}
AMR_LOCATE_FLOPS_PER_LEVEL = 6
# a Voronoi crossing (gtable_voronoi.py find_wall): the box exit (three
# differences, divisions and clamps, two minima), the escape test and the
# move (18 above); for each neighbour read, the normal (3), k . n (5) and
# its test (1); for each neighbour whose bisector faces the ray (k . n > 0,
# the plain walk's ``facing`` count), the midpoint (6), (m - p) . n (8),
# the division, the clamp and the argmin's comparison (3) on top
VORONOI_FLOPS_PER_NEIGHBOUR = 9
VORONOI_FLOPS_PER_FACING = 17
# the owner walk (voronoi_locate.cu): per lane the box test (6) and the
# lattice index (3 x 3, locate only) and the start's d2 (8); per neighbour
# read its d2 (8) and the comparison (1); per row read the move's test (1)
LOCATE_FLOPS_PER_LANE = 8
LOCATE_FLOPS_LATTICE = 15
LOCATE_FLOPS_PER_NEIGHBOUR = 9
VORONOI_LOCATE_SOURCE = 'hyperion_tpu_torch/transport/csrc/voronoi_locate.cu'
OCTREE_LOCATE_SOURCE = 'hyperion_tpu_torch/transport/csrc/octree_locate.cu'
OCTREE_LOCATE_REPLACES = 'hyperion_tpu/transport/gtable_octree.py:42'
# the octree locate's operations (octree_locate.cu): per lane the root box
# test (6 compares) and per level the octant (3 compares); find_wall adds
# the box exit (3 subtractions, 3 divisions, 2 minima, 3 compares for the
# axis) and the landing point (3 products, 3 sums)
OCTREE_OPS_PER_LANE = 6
OCTREE_OPS_PER_LEVEL = 3
OCTREE_WALL_OPS = 17
# the record bytes a level reads (the centre, parent word, leaf mask and
# children: 64 of a node's 128) and a leaf's walls (48)
OCTREE_NODE_BYTES = 64
OCTREE_WALL_BYTES = 48
# an XLA fori_loop with its lattice start, not a Pallas kernel
VORONOI_LOCATE_REPLACES = 'hyperion_tpu/transport/gtable_voronoi.py:49'
# phase 18 (voronoi_cloud): config 4's cloud meshed as a moving-mesh code
# meshes it (Hyperion on AREPO's Voronoi cells is what Powderday runs,
# Narayanan et al. 2021, ApJS 252, 12): VORONOI_CLOUD['n_sites'] sites
# drawn from config 4's particles inside the +-0.5 pc cube
# (np.random.default_rng(seed)), equal gas mass per cell, 100 Msun in all
# at dust-to-gas 0.01 (density m / V), config 4's three point sources and
# outputs (cloud_setup). The tessellation (scipy's Qhull on the sites and
# their six mirror images, on the host) took 54.2-63.9 s at 50,000 sites
# on the card's hosts (PERF.md section 4); above 90 s the phase is to drop
# to 32,768 sites.
VORONOI_CLOUD = dict(n_sites=50_000, seed=4321)
# phase 18 as chip_smoke runs it: 3 Lucy iterations of 1,000,000 photons
# and 1,000,000 imaging photons, with step caps far above what the
# moderate cloud needs (a walk that went astray would run into them)
VORONOI_CUT = dict(n_photons=1_000_000, n_iterations=3, max_steps=20_000,
                   n_imaging=1_000_000, imaging_max_steps=20_000)
# phase 18's lattice oracle (tests/test_torch_voronoi.py's, on the card):
# a Voronoi grid on the centres of an n^3 lattice against the cartesian
# n^3 grid, one Lucy iteration of n_photons each
VORONOI_LATTICE = dict(n=16, n_photons=1_000_000)
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
# the dust pass that phase 12's witness runs both ways: 100 um's (the
# box's dust, at tens of K, emits next to nothing at 0.5 um)
MONO_WITNESS_DUST = 3
MONO_ANALYTIC_RTOL = 0.02
MONO_N_SIGMA = 5.0
# phase 11's monochromatic check: source and dust photons per wavelength
# (half CLASS2_CUT's imaging budget, for the time limit)
CLASS2_MONO_PHOTONS = 50_000
# each geometry's Lucy iteration on the card run both ways, the eager step
# loop and replays of the CUDA graph that run_lucy_iteration captures
# (graph_witness, in phases 4, 8, 14 and 16-18): the working steps of the
# main path's first iteration that each run takes (None: the whole
# iteration), and their generator's seed
GRAPH_WITNESS_STEPS = dict(tutorial=None, class2=300, box=200)
GRAPH_WITNESS_SEED = 20
# each geometry's imaging iteration (and the quickstart's monochromatic
# passes) run both ways too (imaging_witness, in phases 4, 8, 12, 14 and
# 16-18): the working steps each run takes (None: whole); a box grid's
# eager run records phase 10's walks of WALK_WINDOWS, so at least 60
IMAGING_WITNESS_STEPS = dict(tutorial=None, class2=200, box=100)
# the witnesses whose graph run must skip its refill in some working step
# (check_bodies; phase 5 holds the bench quickstart's whole iteration to
# the same): the refill waits for a quarter of the lanes to die, which the
# tutorial's whole iterations and class2's first 300 Lucy steps do not see
# every step
REFILL_SKIPS = dict(lucy=('tutorial', 'class2'), imaging=('tutorial',))
# check_imaging's bound on the main path's host synchronisations a working
# imaging step: the replays of GRAPH_STEPS = 4 steps read the counters once
# each, and the tables' set-up adds a fixed few (0.254-0.290 a step in all
# on phases 4, 8, 14 and 16-18's runs, PERF.md)
IMAGING_READS = 0.3
# graph_witness's reports by geometry, and check_step_counts' by phase, for
# results.json and the kernels line
GRAPH_WITNESS = {}
STEP_COUNTS = {}


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
def peel_events(et):
    """The imaging step's peel events that walk (a call of
    ``imaging.peel_and_bin`` with a group that does not ignore the optical
    depth) and the escape_tau launches inside each: yields a dict of the
    events, the launches made inside them and the most inside one event.
    The launches outside them are the forced first interaction's own walks
    of emission rays where the emission does not peel (raytracing peels
    scattered light only): at most one a step (:func:`check_peels`)."""
    from hyperion_tpu_torch.transport import imaging

    out = dict(events=0, launches=0, most=0)
    inner = imaging.peel_and_bin

    def counted(walk, dt, groups, *args, **kw):
        before = et.launches
        res = inner(walk, dt, groups, *args, **kw)
        if any(not g.ignore_optical_depth for g in groups):
            out['events'] += 1
            out['launches'] += et.launches - before
            out['most'] = max(out['most'], et.launches - before)
        return res

    imaging.peel_and_bin = counted
    try:
        yield out
    finally:
        imaging.peel_and_bin = inner


def check_peels(what, peels, launches, n_steps, forced):
    """One escape_tau launch in each peel event, and outside the events
    (of ``launches`` in all over ``n_steps`` imaging steps) at most one a
    step for the forced first interaction (``forced``), else none."""
    outside = launches - peels['launches']
    if peels['most'] > 1 or peels['launches'] != peels['events'] or \
            outside > (n_steps if forced else 0):
        raise AssertionError('%s imaging: escape_tau launches %d, %d of them '
                             'in %d peel events (at most %d in one) over %d '
                             'steps' % (what, launches, peels['launches'],
                                        peels['events'], peels['most'],
                                        n_steps))


def check_imaging(what, run, n_photons, syncs, card):
    """The imaging row of a run: energy_current the photon count, no
    geometry kills, at least 90% of the working steps run as replays of
    CUDA graphs (``engine.imaging_step_counts`` over the run, reset before
    it), at most IMAGING_READS host synchronisations a working step in all
    (the reads of the counters and the tables' set-up), the peeled arrays
    finite and >= 0. Returns the row with ms per step, reads of the
    counters and synchronisations per step and the step counts."""
    from hyperion_tpu_torch.transport import engine

    img = run.imaging
    rows = [r for r in run.perf.rows if r['label'] == 'imaging']
    if len(rows) != 1 or img is None:
        raise AssertionError('%s: no imaging iteration ran' % what)
    row = dict(rows[0])
    if img.energy_current != n_photons:
        raise AssertionError('%s imaging: energy_current %r'
                             % (what, img.energy_current))
    counts = dict(engine.imaging_step_counts)
    reads = counts['reads'] / img.n_steps
    per_step = syncs[-1] / img.n_steps
    if per_step > IMAGING_READS or counts['replayed'] < 0.9 * img.n_steps:
        raise AssertionError('%s imaging: %.3f host synchronisations, %.3f '
                             'reads of the counters per step; step counts %s'
                             % (what, per_step, reads, counts))
    for g in img.peeled:
        for name, (data, _) in g['datasets'].items():
            if not np.isfinite(data).all() or (data < 0).any():
                raise AssertionError('%s imaging: %s not finite and >= 0'
                                     % (what, name))
    row.update(ms_per_step=img.wall * 1e3 / img.n_steps,
               host_reads_per_step=reads, host_syncs_per_step=per_step,
               step_counts=counts,
               occupancy=img.n_events / (img.n_steps * img.batch_size))
    phase('%s imaging: %d photons in %.3f s, %d steps (%d replays of %d, %d '
          'eager), refill bodies %d of the %d steps, %.3f ms per step, %.3f '
          'host reads of the counters and %.3f host synchronisations per '
          'step, occupancy %.4f, killed_int %d [%s]'
          % (what, n_photons, img.wall, img.n_steps, counts['replays'],
             engine.GRAPH_STEPS, counts['eager'], counts['refills'],
             img.n_steps, row['ms_per_step'], reads, per_step,
             row['occupancy'], img.killed_int, card))
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


def check_step_counts(what, launches, counts, steps, iterations):
    """The Lucy steps of a main-path run of ``iterations`` iterations
    (``engine.step_counts`` over it) against its deposit_visit launches
    and its working steps: each step calls the kernel twice (its gated
    refill's visits and its own), so the wrapper counts two launches for
    each step run eagerly or captured into a graph (a replay launches the
    captured ones again without it), and one an iteration for the flush
    at its end; every working step ran eagerly or in a replay; the host
    read the counters at most once a step. Returns the device's
    launches: a step's own, a refill's where its body ran (every eager
    step; in a replay where its gate held) and the flushes."""
    ran = counts['eager'] + counts['replayed']
    device = ran + counts['refills'] + iterations
    if launches != 2 * (counts['eager'] + counts['captured']) + \
            iterations or \
            ran < steps or not counts['replays'] or counts['reads'] > steps:
        raise AssertionError('%s: deposit_visit launches %d over %d working '
                             'steps, step counts %s'
                             % (what, launches, steps, counts))
    STEP_COUNTS[what] = dict(counts, working=steps,
                             deposit_visit_wrapper_launches=launches,
                             deposit_visit_device_launches=device)
    phase('%s Lucy steps: %d working, %d eager, %d captured, %d replays of '
          '%d, %d host reads (%.4f a working step); refill bodies %d, MRW '
          'bodies %d of the %d working steps; deposit_visit launched %d '
          'times by its wrapper, %d times on the device'
          % (what, steps, counts['eager'], counts['captured'],
             counts['replays'], counts['replayed'], counts['reads'],
             counts['reads'] / steps, counts['refills'], counts['mrw_moves'],
             steps, launches, device))
    return device


def run_slice(dv, et, card):
    """Phase 4: the tutorial through run_lucy_model, the port's run_model
    without its .rtout file: 4 Lucy iterations, then imaging. Returns
    (deposit_visit launches, escape_tau launches, per-iteration rows,
    wall, imaging report, the last iteration's specific energy, phase 19's
    reference: the temperatures, the first iteration's specific energy and
    the dusty cells)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model
    from hyperion_tpu_torch.transport import engine
    from hyperion_tpu_torch.util.constants import lsun

    m = tutorial_model()
    dv.launches = 0
    et.launches = 0
    engine.reset_step_counts()
    t0 = time.time()
    with imaging_syncs() as syncs, peel_events(et) as peels, \
            first_lucy_iteration() as first, first_imaging() as fimg:
        run = run_lucy_model(m, device='cuda')
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dv.launches
    launches_et = et.launches
    counts = dict(engine.step_counts)

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
    check_step_counts('slice', launches, counts, steps, 4)
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
               escape_tau_launches=launches_et, peel_events=peels['events'],
               escape_tau_launches_per_step=launches_et / n_img)
    # one launch per peel event, and one per forced first interaction
    # (a refill: at most one per step)
    phase('slice imaging: band luminosity %.6e erg/s = %.5f x expected '
          '(%.6e), image sum %.6e, escape_tau launches %d (%.3f per imaging '
          'step) for %d peel events [%s]'
          % (band, band / expected, expected, image.sum(), launches_et,
             launches_et / n_img, peels['events'], card))
    check_peels('slice', peels, launches_et, n_img, forced=True)
    phase('slice: 4 x 500000 photons and 1000000 imaging photons in %.3f s '
          'wall (run_lucy_model), T %.1f .. %.1f K, deposit_visit launches '
          '%d over %d steps [%s]'
          % (wall, temp[dusty].min(), temp.max(), launches, steps, card))
    graph_witness('tutorial', first, GRAPH_WITNESS_STEPS['tutorial'], card)
    imaging_witness('tutorial', fimg, IMAGING_WITNESS_STEPS['tutorial'],
                    card)
    ref = dict(temperature=temp, se1=run.iterations[0]['specific_energy'],
               dusty=dusty)
    return launches, launches_et, [dict(row) for row in run.perf.rows[:4]], \
        wall, img, run.iterations[-1]['specific_energy'], ref


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
    engine.reset_step_counts()
    t0 = time.time()
    out = engine.run_lucy_iteration(geo, dt, st, density, jid, jfrac, gen,
                                    2_000_000, 131072, config)
    e_current = float(out[1])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(engine.step_counts)
    if e_current != 2_000_000 or int(out[3]) or int(out[4]):
        raise AssertionError('bench quickstart: E %g killed %d/%d'
                             % (e_current, int(out[3]), int(out[4])))
    bench = dict(photons=2_000_000, wall_s=wall, photons_per_sec=2e6 / wall,
                 steps=int(out[5]),
                 occupancy=int(out[7]) / (int(out[5]) * 131072),
                 step_counts=counts,
                 host_reads_per_step=counts['reads'] / int(out[5]))
    phase('bench quickstart config: %.4f s, %.1f photons/s, %d steps, '
          'occupancy %.4f, %d graph replays of %d steps, %.4f host reads per '
          'step, refill bodies %d of the %d working steps [%s]'
          % (wall, bench['photons_per_sec'], bench['steps'],
             bench['occupancy'], counts['replays'], counts['replayed'],
             bench['host_reads_per_step'], counts['refills'], bench['steps'],
             card))
    if counts['refills'] >= bench['steps']:
        raise AssertionError('bench quickstart: the refill ran in every '
                             'working step: %s' % counts)

    # host synchronisations inside the step (none: the driver reads the
    # counters), counted by torch's sync debug mode
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


class _FirstIteration(Exception):
    pass


@contextlib.contextmanager
def first_call(module, name, stop=False, want=None):
    """Record the arguments of the first call of ``module.name`` made
    inside the block (of those whose keywords ``want`` accepts, if given);
    yields a dict that gets them as 'args' (a list) and 'kw'. With
    ``stop`` the run inside the block ends there, before the call."""
    rec = {}
    inner = getattr(module, name)

    def recorded(*args, **kw):
        if not rec and (want is None or want(kw)):
            rec.update(args=list(args), kw=dict(kw))
            if stop:
                raise _FirstIteration
        return inner(*args, **kw)

    setattr(module, name, recorded)
    try:
        yield rec
    except _FirstIteration:
        pass
    finally:
        setattr(module, name, inner)


def first_lucy_iteration(stop=False):
    """Record the arguments of the first Lucy iteration
    (``lucy.run_lucy_iteration``) run inside the block (:func:`first_call`)."""
    from hyperion_tpu_torch.transport import lucy
    return first_call(lucy, 'run_lucy_iteration', stop)


def first_imaging(stop=False):
    """Record the arguments of the imaging iteration
    (``imaging.run_final``) run inside the block (:func:`first_call`)."""
    from hyperion_tpu_torch.transport import imaging
    return first_call(imaging, 'run_final', stop)


def first_mono_pass(mode, f_id=0, stop=False):
    """Record the arguments of the monochromatic pass of ``mode`` ('source'
    or 'dust', ``mono.run_mono_pass``) at the frequency index ``f_id`` run
    inside the block (:func:`first_call`)."""
    from hyperion_tpu_torch.transport import mono
    return first_call(mono, 'run_mono_pass', stop,
                      want=lambda kw: (kw['mode'], kw['f_id']) == (mode, f_id))


def first_iteration_args(model, batch_size=None):
    """The arguments of a model's first Lucy iteration on the card as
    run_lucy_model gives them, without running it (``--graph``)."""
    from hyperion_tpu_torch.model import run_lucy_model

    with first_lucy_iteration(stop=True) as rec:
        run_lucy_model(model, device='cuda', batch_size=batch_size)
    return rec


def graph_rand_check(card, shape=(27, 125_000), k=2, replays=3):
    """A CUDA graph of ``k`` torch.rand calls from a generator registered
    with it, replayed ``replays`` times, draws what as many eager calls
    draw from the same seed, and leaves the generator where they leave it;
    set back and redrawn, as the engine gives back the draws of a replay's
    steps after an iteration's end, it draws them again. Returns the
    report."""
    import torch
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(GRAPH_WITNESS_SEED)
    eager = [torch.rand(shape, generator=gen, device=dev)
             for _ in range(k * replays)]
    eager_state = gen.get_state()
    gen.manual_seed(GRAPH_WITNESS_SEED)
    bufs = [torch.empty(shape, device=dev) for _ in range(k)]
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        for b in bufs:
            torch.rand(shape, generator=gen, device=dev, out=b)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    got = []
    for _ in range(replays):
        state = gen.get_state()
        graph.replay()
        got += [b.clone() for b in bufs]
    same = all(torch.equal(a, b) for a, b in zip(got, eager))
    same_state = torch.equal(gen.get_state(), eager_state)
    # give back the last replay's draws but the first, and draw it again
    gen.set_state(state)
    again = torch.rand(shape, generator=gen, device=dev)
    redraw = torch.equal(again, eager[-k])
    phase('captured torch.rand: %d replays of a graph of %d draws of %s '
          'from the registered generator equal to the %d eager draws: %s; '
          'generator state after equal: %s; set back and redrawn equal: %s '
          '[%s]' % (replays, k, shape, k * replays, same, same_state, redraw,
                    card))
    if not (same and same_state and redraw):
        raise AssertionError('captured torch.rand differs from the eager '
                             'draws')
    return dict(shape=list(shape), per_graph=k, replays=replays, equal=same,
                state_equal=same_state, redraw_equal=redraw)


def both_ways(run, counts):
    """``run(how, generator)`` for how 'graph' and 'eager', each from a
    generator on the card seeded GRAPH_WITNESS_SEED, the iteration's step
    counts (``counts``, an ``engine`` dict) reset before: {how: (its
    output, wall seconds, a copy of the counts with the conditional nodes
    captured under 'nodes', the generator's state after)}; the graph run
    first, its peak device memory (bytes) under 'graph_memory'."""
    import torch
    from hyperion_tpu_torch.transport import engine

    runs = {}
    for how in ('graph', 'eager'):
        gen = torch.Generator(device='cuda').manual_seed(GRAPH_WITNESS_SEED)
        engine.reset_step_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = run(how, gen)
        torch.cuda.synchronize()
        runs[how] = (out, time.time() - t0,
                     dict(counts, nodes=engine.cond_nodes), gen.get_state())
        if how == 'graph':
            runs['graph_memory'] = torch.cuda.max_memory_allocated()
    return runs


def check_bodies(what, g_counts, e_counts, steps, mrw, must_skip):
    """The gated bodies (``engine.run_if``) of a witness's graph and eager
    runs (their step counts ``g_counts`` and ``e_counts``) beside its
    ``steps`` working steps: raises unless the eager run ran its refill,
    and with ``mrw`` its MRW move, in every step, and the graph run
    captured a conditional node for each in every captured step and ran no
    more bodies than the eager run; with ``must_skip`` (REFILL_SKIPS)
    unless the graph run skipped a refill in some working step. Returns
    the text for the phase line."""
    text = ('refill bodies %d of %d working steps (eager %d), MRW bodies %d '
            '(eager %d), %d conditional nodes captured'
            % (g_counts['refills'], steps, e_counts['refills'],
               g_counts['mrw_moves'], e_counts['mrw_moves'],
               g_counts['nodes']))
    ok = (e_counts['refills'] == e_counts['eager'] and
          e_counts['mrw_moves'] == (e_counts['eager'] if mrw else 0) and
          g_counts['nodes'] == g_counts['captured'] * (2 if mrw else 1) and
          g_counts['refills'] <= e_counts['refills'] and
          g_counts['mrw_moves'] <= e_counts['mrw_moves'] and
          not (must_skip and g_counts['refills'] >= steps))
    if not ok:
        raise AssertionError('%s: gated bodies: %s; step counts %s, eager %s'
                             % (what, text, g_counts, e_counts))
    return text


def graph_witness(what, first, max_steps, card, recorder=None,
                  wrap_step=None):
    """The main path's first Lucy iteration (``first``: its recorded
    arguments) run twice on the card from one generator seed, cut at
    ``max_steps`` working steps (None: the whole iteration): as the eager
    step loop (``engine.drive_steps``, a read of the counters after each
    step) and as run_lucy_iteration runs it (replays of one CUDA graph of
    GRAPH_STEPS steps, a read after each) (:func:`both_ways`). Steps,
    killed_int, killed_geo, events, n_photons_cell, energy_current and the
    generators' states must be equal, energy_sum and the spectrum bins
    within RTOL (deposit_visit's float atomics add in another order).
    ``recorder``: a context manager factory around the eager run (the
    kernels' recorders), ``wrap_step`` wraps its step. Returns (report,
    what the recorder yielded)."""
    import torch
    from hyperion_tpu_torch.transport import engine

    args, kw = list(first['args']), first['kw']
    if max_steps is not None:
        args[9] = dict(args[9], max_steps=max_steps)
    cap = int(args[9]['max_steps'])
    recorded = []

    def run(how, gen):
        args[6] = gen
        if how == 'graph':
            return engine.run_lucy_iteration(*args, **kw)
        carry, step = engine.start_lucy_iteration(*args[:6], *args[7:], **kw)
        with (recorder() if recorder else
              contextlib.nullcontext()) as rec:
            _, n = engine.drive_steps(
                carry, wrap_step(step) if wrap_step else step, gen, cap)
        recorded.append(rec)
        return engine.finish_lucy_iteration(carry, n)

    runs = both_ways(run, engine.step_counts)
    (e, e_wall, e_counts, e_gen), (g, g_wall, g_counts, g_gen) = \
        runs['eager'], runs['graph']
    equal = dict(n_steps=e[5] == g[5],
                 n_photons_cell=bool(torch.equal(e[2], g[2])),
                 killed_int=int(e[3]) == int(g[3]),
                 killed_geo=int(e[4]) == int(g[4]),
                 n_events=int(e[7]) == int(g[7]),
                 energy_current=float(e[1]) == float(g[1]),
                 generator=bool(torch.equal(e_gen, g_gen)))
    errs = []
    for a, b in ((g[0], e[0]), (g[6], e[6])):
        err = (a.double() - b.double()).abs()
        errs.append(float((err / b.double().abs().clamp_min(1e-30)).max())
                    if err.numel() else 0.0)
        if not bool((err <= RTOL * b.double().abs()).all()):
            equal['energy_sum'] = False
    steps = e[5]
    rep = dict(
        steps=steps, cap=cap, killed_int=int(e[3]), killed_geo=int(e[4]),
        n_events=int(e[7]), lanes=int(args[8]), equal=equal,
        energy_sum_max_rel_err=errs[0], spectrum_max_rel_err=errs[1],
        eager_ms_per_step=e_wall * 1e3 / steps,
        graph_ms_per_step=g_wall * 1e3 / steps,
        speedup=e_wall / g_wall, graph_steps=engine.GRAPH_STEPS,
        graph_counts=g_counts, eager_counts=e_counts,
        eager_reads_per_step=e_counts['reads'] / steps,
        graph_reads_per_step=g_counts['reads'] / steps,
        graph_max_memory_gb=runs['graph_memory'] / 1e9)
    GRAPH_WITNESS[what] = rep
    bodies = check_bodies(what, g_counts, e_counts, steps,
                          kw.get('mrw') is not None,
                          what in REFILL_SKIPS['lucy'])
    phase('%s Lucy iteration 1 (%s, B=%d) both ways: graph of %d steps '
          '(%d replays, %d eager steps) against the eager step loop, %d '
          'working steps both, killed %d/%d, events %d; equal: %s; '
          'energy_sum max rel err %.3g; eager %.3f ms per step (%.3f reads '
          'per step), graph %.3f ms per step (%.4f reads per step), %.2fx; '
          '%s [%s]'
          % (what, 'whole' if max_steps is None else
             'first %d steps' % max_steps, rep['lanes'], engine.GRAPH_STEPS,
             g_counts['replays'], g_counts['eager'], steps,
             rep['killed_int'], rep['killed_geo'], rep['n_events'],
             ', '.join(k for k, v in equal.items() if v), errs[0],
             rep['eager_ms_per_step'], rep['eager_reads_per_step'],
             rep['graph_ms_per_step'], rep['graph_reads_per_step'],
             rep['speedup'], bodies, card))
    if not all(equal.values()) or not g_counts['replays']:
        raise AssertionError('%s: the graph run differs from the eager one: '
                             '%s' % (what, rep))
    return rep, recorded[0]


def stokes_rel_err(got, ref):
    """max |got - ref| over the Stokes I of ref's bin (the cube's last
    axis), 0 where both are 0 (inf where only ``got`` is): a float sum
    added in another order moves by ~eps times the sum of its terms' sizes,
    and |Q|, |U|, |V| <= I."""
    got, ref = got.double(), ref.double()
    i = ref[..., :1].abs()
    err = (got - ref).abs()
    if bool((err[(i == 0).expand_as(err)] > 0).any()):
        return float('inf')
    return float((err / i.clamp_min(1e-300)).max()) if err.numel() else 0.0


def _imaging_kind():
    """The imaging iteration's (run, start, finish, counts, outputs): the
    outputs of a FinalResult (cubes, then energy_current, killed_int,
    n_steps, n_events)."""
    from hyperion_tpu_torch.transport import engine, imaging
    return (imaging.run_final, imaging.start_final, imaging.finish_final,
            engine.imaging_step_counts,
            lambda r: ([a for a in r.accums + [r.binned_acc] if a],
                       (r.energy_current, r.killed_int, r.n_steps,
                        r.n_events)))


def _mono_kind():
    """A monochromatic pass's, as :func:`_imaging_kind` (its counts:
    killed_int, n_steps, n_events)."""
    from hyperion_tpu_torch.transport import engine, mono
    return (mono.run_mono_pass, mono.start_mono_pass, mono.finish_mono_pass,
            engine.mono_step_counts,
            lambda r: (list(r[0]), tuple(r[1:])))


IMAGING_WITNESS = {}


def imaging_witness(what, rec, max_steps, card, mono=False, recorder=None):
    """The main path's imaging iteration (or with ``mono`` a monochromatic
    pass; ``rec``: its recorded arguments) run twice on the card from one
    generator seed (:func:`both_ways`), cut at ``max_steps`` working steps
    (None: whole): as the eager step loop (``engine.drive_steps``, inside
    ``recorder()`` if given) and as run_final (run_mono_pass) runs it,
    replays of one CUDA graph of GRAPH_STEPS steps. Working steps,
    killed_int, events, energy_current and the generators' states must be
    equal, every cube (each group's sums, squares and counts, the binned
    group's) within RTOL of the eager run's on every bin, Q, U and V
    against the bin's I (:func:`stokes_rel_err`; ``index_add_``'s float
    atomics add in another order). Reports ms a step both ways, the graph
    run's host reads a step, replays and peak device memory. Returns
    (report, what the recorder yielded)."""
    import torch
    from hyperion_tpu_torch.transport import engine

    run_it, start, finish, counts, outputs = \
        _mono_kind() if mono else _imaging_kind()
    args, kw = list(rec['args']), dict(rec['kw'])
    if max_steps is not None:
        kw['max_steps'] = max_steps
    cap = kw.pop('max_steps', 100000000)
    recorded = []

    def run(how, gen):
        args[6] = gen
        if how == 'graph':
            return run_it(*args, max_steps=cap, **kw)
        with (recorder() if recorder else
              contextlib.nullcontext()) as got:
            carry, step = start(*args[:6], *args[7:], **kw)
            _, n = engine.drive_steps(carry, step, gen, cap)
        recorded.append(got)
        return finish(carry, n)

    runs = both_ways(run, counts)
    (e, e_wall, e_counts, e_gen), (g, g_wall, g_counts, g_gen) = \
        runs['eager'], runs['graph']
    (e_cubes, e_nums), (g_cubes, g_nums) = outputs(e), outputs(g)
    errs = {}
    for i, (a, b) in enumerate(zip(g_cubes, e_cubes)):
        ca, cb = a.cubes(), b.cubes()
        for name in ca:
            errs['%d.%s' % (i, name)] = stokes_rel_err(ca[name], cb[name])
    equal = dict(counts=g_nums == e_nums, cubes=len(g_cubes) == len(e_cubes)
                 and max(errs.values()) <= RTOL,
                 generator=bool(torch.equal(e_gen, g_gen)))
    if not e_nums[-1]:
        raise AssertionError('%s: no event in the witness run' % what)
    steps = e_nums[-2]
    rep = dict(
        steps=steps, cap=cap, counts=e_nums, lanes=int(kw['batch_size']),
        equal=equal, cube_max_rel_err=max(errs.values()),
        eager_ms_per_step=e_wall * 1e3 / steps,
        graph_ms_per_step=g_wall * 1e3 / steps, speedup=e_wall / g_wall,
        graph_steps=engine.GRAPH_STEPS, graph_counts=g_counts,
        eager_counts=e_counts,
        graph_reads_per_step=g_counts['reads'] / steps,
        graph_max_memory_gb=runs['graph_memory'] / 1e9)
    IMAGING_WITNESS[what] = rep
    bodies = check_bodies(what, g_counts, e_counts, steps, False,
                          not mono and what in REFILL_SKIPS['imaging'])
    phase('%s %s (%s, B=%d) both ways: graph of %d steps (%d replays, %d '
          'eager steps) against the eager step loop, %d working steps both, '
          'counts %s; equal: %s; cubes max rel err %.3g; eager %.3f ms per '
          'step, graph %.3f ms per step (%.4f reads per step, %.3f GB peak), '
          '%.2fx; %s [%s]'
          % (what, 'monochromatic pass' if mono else 'imaging iteration',
             'whole' if max_steps is None else 'first %d steps' % max_steps,
             rep['lanes'], engine.GRAPH_STEPS, g_counts['replays'],
             g_counts['eager'], steps, e_nums,
             ', '.join(k for k, v in equal.items() if v),
             rep['cube_max_rel_err'], rep['eager_ms_per_step'],
             rep['graph_ms_per_step'], rep['graph_reads_per_step'],
             rep['graph_max_memory_gb'], rep['speedup'], bodies, card))
    if not all(equal.values()) or not g_counts['replays']:
        raise AssertionError('%s: the graph run differs from the eager one: '
                             '%s, errors %s' % (what, rep, errs))
    return rep, recorded[0]


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
    from hyperion_tpu_torch.transport import engine

    m = class2_model(n_photons, n_iterations, n_imaging)
    dv.launches = 0
    et.launches = 0
    engine.reset_step_counts()
    t0 = time.time()
    with transport_syncs() as syncs, imaging_syncs() as img_syncs, \
            peel_events(et) as peels, first_lucy_iteration() as first, \
            first_imaging() as fimg:
        run = run_lucy_model(m, device='cuda', max_steps=max_steps,
                             imaging_max_steps=imaging_max_steps)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dv.launches
    launches_et = et.launches
    counts = dict(engine.step_counts)
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
               escape_tau_launches=launches_et, peel_events=peels['events'],
               escape_tau_launches_per_step=launches_et / n_img,
               peel_events_per_step=peels['events'] / n_img)
    phase('class2 imaging: 80/20 degree ratio at 0.3 um %.4e, peak nu L_nu '
          'per view %s erg/s, escape_tau launches %d over %d imaging steps: '
          '%.3f per step for %.3f peel events per step [%s]'
          % (s80 / s20, ['%.4e' % v for v in seds.max(axis=1)], launches_et,
             n_img, launches_et / n_img, peels['events'] / n_img, card))
    # one launch per peel event (class2 has no forced first interaction)
    check_peels('class2', peels, launches_et, n_img, forced=False)
    check_step_counts('class2', launches, counts, steps, len(rows))
    phase('class2: %d iterations (converged: %s) in %.3f s, T %.1f .. %.1f '
          'K, killed_int %d, deposit_visit launches %d over %d steps [%s]'
          % (run.result.iterations, run.result.converged, wall,
             temp[dusty].min(), temp.max(), run.result.killed_int, launches,
             steps, card))
    graph_witness('class2', first, GRAPH_WITNESS_STEPS['class2'], card)
    imaging_witness('class2', fimg, IMAGING_WITNESS_STEPS['class2'], card)
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
    from hyperion_tpu_torch.transport import engine
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
    engine.reset_step_counts()
    with transport_syncs() as syncs:
        res = run_lucy(geo, dt, st, density,
                       torch.Generator(device='cuda').manual_seed(1),
                       n_photons, n_iterations, use_mrw=True,
                       verbose=False, iteration_callback=callback,
                       **YSO_THICK)
    launches = dv.launches
    rows = report_iterations('yso_thick', rows, syncs, n_photons, card)
    check_step_counts('yso_thick', launches, dict(engine.step_counts),
                      sum(r['steps'] for r in rows), len(rows))
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
    t_max (cloned). Inside the block run_final drives its steps eagerly
    (``engine.drive_steps``: a captured call's lanes are the graph's,
    which each replay writes anew), and a window that records no call
    fails the block."""
    from hyperion_tpu_torch.transport import engine
    from hyperion_tpu_torch.transport import escape_tau as et
    from hyperion_tpu_torch.transport import imaging

    calls = {w: [] for w in windows}
    at = [0]          # the index of the step that runs
    inner = (et.EscapeTau.__call__, imaging.make_final_step,
             imaging.drive_graph)

    def recording(self, *args, t_max=None):
        for (first, last), rec in calls.items():
            if first <= at[0] < last:
                rec.append([a.clone() for a in args] +
                           [None if t_max is None else t_max.clone()])
        return inner[0](self, *args, t_max=t_max)

    def counting(*args, **kw):
        step = inner[1](*args, **kw)

        @functools.wraps(step)
        def counted(carry, generator):
            at[0] = int(carry.n_steps)
            step(carry, generator)
        return counted

    et.EscapeTau.__call__ = recording
    imaging.make_final_step = counting
    imaging.drive_graph = engine.drive_steps
    try:
        yield calls
    finally:
        et.EscapeTau.__call__, imaging.make_final_step, \
            imaging.drive_graph = inner
    empty = [w for w, rec in calls.items() if not rec]
    if empty:
        raise AssertionError('no escape_tau call recorded in the imaging '
                             'steps %s' % empty)


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
    nbytes = flops_extra = 0
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
        visits, facing = walk_counters(kind, rt64.shape[0], ones.device)
        ref, n_cross = et.escape_tau_reference(
            geo64, rt64, *lanes, ones, t_max=t_max, crossings=True,
            visits=visits, facing=facing)
        extra_bytes, extra_flops = walk_work(kind, geo64, lanes[7], visits,
                                             facing)
        nbytes += extra_bytes
        flops_extra += extra_flops
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
    flops = n_cross_all * FLOPS_PER_CROSSING[kind] + flops_extra
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

    calls = []
    inner = et.EscapeTau.columns

    def recording(self, *args, t_max=None):
        kind = grid_kind(self.geometry)
        calls.append((kind, [a.clone() for a in args] +
                      [None if t_max is None else t_max.clone()]))
        return inner(self, *args, t_max=t_max)

    et.EscapeTau.columns = recording
    try:
        yield calls
    finally:
        et.EscapeTau.columns = inner


def grid_kind(geometry):
    """The name of a geometry's kind of grid, as FLOPS_PER_CROSSING's."""
    return {'CartesianGeometry': 'cartesian',
            'SphericalGeometry': 'spherical',
            'CylindricalGeometry': 'cylindrical',
            'OctreeGeometry': 'octree',
            'AMRGeometry': 'amr',
            'VoronoiGeometry': 'voronoi'}[type(geometry).__name__]


def walk_counters(kind, n_cells, device):
    """The plain walk's counters for walk_work: ``visits`` (n_cells,) and,
    on a Voronoi grid, ``facing`` (0-d; else None)."""
    import torch
    visits = torch.zeros(n_cells, dtype=torch.int64, device=device)
    facing = torch.zeros((), dtype=torch.int64, device=device) \
        if kind == 'voronoi' else None
    return visits, facing


def walk_work(kind, geo, start, visits, facing=None):
    """The work of the octree's, AMR and Voronoi grids' crossings beyond
    FLOPS_PER_CROSSING, counted from what the plain walk visited
    (``visits``, (n_cells,) crossings per cell walked through; ``start``,
    the rays' first cells; ``facing``, the neighbours facing the ray summed
    over the Voronoi crossings). Every crossing into a cell after the first
    locates the point: in the octree by the descend from the root, 3
    comparisons a level down to the leaf entered; in the AMR grid by an
    indexed locate at each level (the offset from the level's corner over
    its cell size on three axes, AMR_LOCATE_FLOPS_PER_LEVEL), since the
    fabs of a level tile a box (the kernel's indexed locate also visits
    the finer levels that do not hold the point: its own work, not
    counted); a Voronoi crossing
    reads the neighbours of the cell walked through, VORONOI_FLOPS_PER_
    NEIGHBOUR each (the normal and its test), and VORONOI_FLOPS_PER_FACING
    more for each that faces the ray (its crossing distance). Bytes: the
    tables read once, as far as the walks need them: the octree's nodes on
    the descend paths to the leaves walked through (a centre and a child
    index, 28 bytes each) and those leaves' walls (48 bytes); the AMR
    grid's fab tables (68 bytes a fab); the Voronoi rows of the cells
    walked through up to their first -1 (4 bytes an id) and the sites of
    those cells and of their neighbours (24 bytes each). (Counted per
    crossing and level, the descend's reads came to more bytes than a
    call's measured time can move at the HBM rate, PERF.md: they hit in
    cache.) Returns (bytes, flops); (0, 0) for the other grids."""
    import torch
    if kind == 'voronoi':
        return voronoi_table_bytes(geo, visits, 24), \
            VORONOI_FLOPS_PER_NEIGHBOUR * int(
                (visits * (geo.neigh >= 0).sum(dim=1)).sum()) + \
            VORONOI_FLOPS_PER_FACING * int(facing)
    if kind not in ('octree', 'amr'):
        return 0, 0
    entered = int(visits.sum()) - start.numel()
    if kind == 'amr':
        n_levels = int(geo.fab_level.max()) + 1
        return (68 * geo.n_fabs,
                AMR_LOCATE_FLOPS_PER_LEVEL * n_levels * entered)
    n, dev = geo.n_nodes, visits.device
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    parent = torch.zeros(n, dtype=torch.int64, device=dev)
    kids = geo.children[geo.refined]
    parent[kids.reshape(-1)] = \
        torch.nonzero(geo.refined)[:, 0].repeat_interleave(8)
    for _ in range(geo.max_depth):
        depth[kids.reshape(-1)] = (depth[geo.refined][:, None] + 1
                                   ).expand_as(kids).reshape(-1)
    levels = int((visits * depth).sum()) - int(depth[start].sum())
    on_path = visits > 0
    walls = int(on_path.sum())
    for _ in range(geo.max_depth):
        on_path[parent[on_path]] = True
    return 28 * int(on_path.sum()) + 48 * walls, 3 * levels


def voronoi_table_bytes(geo, rows_read, site_bytes):
    """The bytes of a Voronoi grid's tables that walks reading the
    neighbour rows of the cells where ``rows_read`` (n_cells,) > 0 touch,
    each read once: each row up to its first -1 (4 bytes an id) and the
    sites of those cells and their neighbours (``site_bytes`` each)."""
    on = rows_read > 0
    n_nb = (geo.neigh[on] >= 0).sum(dim=1)
    ids = int((n_nb + 1).clamp_max(geo.neigh.shape[1]).sum())
    touched = on.clone()
    nb = geo.neigh[on]
    touched[nb[nb >= 0].long()] = True
    return 4 * ids + site_bytes * int(touched.sum())


def voronoi_packed_bytes(geo, rows_read, starts, site_bytes):
    """The bytes of a Voronoi grid's packed rows (gtable_voronoi.py
    packed_rows) that walks from the cells ``starts`` reading the rows of
    the cells where ``rows_read`` (n_cells,) > 0 touch, each read once:
    each such row's entries (its neighbour's site, ``site_bytes``, and
    (id, offset), 8 bytes), its two offsets, and the start cells' sites."""
    on = rows_read > 0
    deg = (geo.neigh[on] >= 0).sum(dim=1)
    return (site_bytes + 8) * int(deg.sum()) + 8 * int(on.sum()) + \
        site_bytes * int(starts.unique().numel())


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
    grid (None: no specific energy and no Lucy iteration), MONO_PHOTONS
    source and dust photons per wavelength, with or without raytracing
    (RAYTRACING's photons)."""
    m = tutorial_model()
    m.set_monochromatic(True, wavelengths=MONO_WAVELENGTHS)
    group = m.peeled_output[0]
    group.set_wavelength_index_range(0, len(MONO_WAVELENGTHS) - 1)
    group.set_uncertainties(True)
    m.set_raytracing(raytracing)
    m.set_n_photons(initial=500_000, imaging_sources=MONO_PHOTONS,
                    imaging_dust=MONO_PHOTONS,
                    **(RAYTRACING if raytracing else {}))
    if se is None:
        m.set_n_initial_iterations(0)
    else:
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
        with column_calls() as calls, first_mono_pass('source') as src, \
                first_mono_pass('dust', MONO_WITNESS_DUST) as dust:
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
        if not ray:
            passes = dict(source=src, dust=dust)
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
    # (a)'s source pass at 0.5 um and dust pass at 100 um, graph against
    # eager
    for mode, rec in passes.items():
        out['witness_' + mode] = imaging_witness(
            'mono %s' % mode, rec, None, card, mono=True)[0]
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
    nbytes = n_far = flops_extra = 0
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
        visits, facing = walk_counters(kind, rt64.shape[0], ones.device)
        ref, n_cross = et.escape_column_reference(
            geo64, rt64, *lanes, ones, t_max=t_max, crossings=True,
            visits=visits, facing=facing)
        extra_bytes, extra_flops = walk_work(kind, geo64, lanes[6], visits,
                                             facing)
        nbytes += extra_bytes
        flops_extra += extra_flops
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
    flops = n_cross_all * (FLOPS_PER_CROSSING[kind] + 2 * n_dust) + \
        flops_extra
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
    kernel = column_kernel_resources(geo64, walk32.plan['big_col'])
    out = dict(run=what, model=kind, calls=len(calls),
               views=sum(c[3].shape[0] for c in calls),
               B=calls[0][7].shape[0], n_dust=n_dust, rays=n_rays,
               f64_max_rel_err=worst64, f32_max_rel_err_vs_f64=worst32,
               f32_rays_outside=n_far, f32_ne_plain32=n_ne32,
               f32_vs_plain32_max_abs_err=max_err, longest_walk=max_cross,
               column_kernel=kernel,
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
          'call); the float32 kernel in blocks of %s threads, %s registers, '
          '%s bytes of spill stores [%s]'
          % (what, kind, len(calls), out['views'], out['B'], n_rays,
             worst64, worst32, n_far, ESCAPE_TAU_RTOL32, n_ne32, max_err,
             len(some), max_cross, out['device_us'], host_us, plain_ms,
             out['bound_us'], out['bound_by'], out['bytes_per_call'],
             out['flops_per_call'], kernel['block'], kernel['registers'],
             kernel['spill_store_bytes'], card))
    if worst64 > 0.0 or n_far or n_ne32 or max_err > 0.0:
        raise AssertionError('escape_column %s: the kernel against its '
                             'plain version: %s' % (what, out))
    return out


def column_kernel_resources(geo64, big_col):
    """The float32 column kernel that a grid's calls launch: its block, and
    its registers and spill store bytes as ptxas reported them when
    phase 2 built the library (None where the library was built
    elsewhere). A kind's column kernel comes in blocks of 128 threads and,
    where it may take the density into opt-in shared memory, in one larger
    block; ``big_col`` (the plan's) says which of the two the calls
    launch."""
    import re
    from hyperion_tpu_torch.transport import _build
    from hyperion_tpu_torch.transport import escape_tau as et
    name = re.compile(r'walk_kernelIfLi%dELb1ELi(\d+)E'
                      % et.kernel_tables(geo64)[0])
    res = [(int(m.group(1)),) + r for m, r in (
        (name.search(entry), r) for entry, r in _build.ptxas_resources(
            _build.ptxas_log('escape_tau')).items())
        if m and (int(m.group(1)) != 128) == big_col]
    block, regs, spill = res[0] if res else (None, None, None)
    return dict(block=block, registers=regs, spill_store_bytes=spill)


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
    draw per lane of every refill, as the Lucy and imaging steps call it;
    the Lucy step's masked refill draws in every step, and a graph's
    replays add theirs): yields an int64 (n_rows,) tensor on ``device``."""
    import torch
    from hyperion_tpu_torch.transport import engine, imaging, stable

    tally = torch.zeros(n_rows, dtype=torch.int64, device=device)
    inner = stable.pick_sources

    def counted(st, u):
        rows = inner(st, u)
        # (bincount would read the device, which a graph capture refuses)
        tally.index_add_(0, rows, torch.ones_like(rows))
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
    """Record the eager deposit_visit calls number ``first`` to ``last``
    (from 0) made inside the block, as :func:`record_calls` does; calls
    captured into a CUDA graph are neither recorded nor numbered (their
    lanes are the graph's, which each replay writes anew)."""
    import torch
    calls, n = [], [0]
    run = dv.DepositVisit.__call__

    def recording(self, cell_dep, dep, enter, uid):
        if not torch.cuda.is_current_stream_capturing():
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
    images, and the raytracing pass, with :func:`box_grid_run`'s checks and
    kernels (deposit_visit on 80 calls of the Lucy iteration, escape_tau on
    the imaging steps of WALK_WINDOWS, escape_column on the raytracing
    calls), and: the ISRF's share of the source draws within 3 sigma of its
    share of the luminosity; at the shortest wavelength the 85 degree
    view's scattered share above the 10 degree one's. Returns ({kernel:
    launches}, report)."""
    import torch
    from hyperion_tpu_torch.model.run import build_geometry_tables
    from hyperion_tpu_torch.transport.gtable import ESCAPED
    from hyperion_tpu_torch.transport.stable import (EXTERN_SPH,
                                                     build_source_tables,
                                                     emit_packets)

    dev = torch.device('cuda')
    t0 = time.time()
    m = class1_cyl_model(n_photons=n_photons, n_iterations=n_iterations,
                         n_imaging=n_imaging)
    build_s = time.time() - t0
    with source_picks(len(m.sources), dev) as picks:
        launches, run, out = box_grid_run(
            'class1_cyl', 'cylindrical', dv, et, card, m, n_photons,
            n_imaging, max_steps, imaging_max_steps)
    img = run.imaging
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
    out.update(
        model_build_s=build_s,
        isrf_share=share, isrf_share_expected=p, isrf_share_sigma=sigma,
        isrf_picks=n_picks, isrf_outside_of_1e6=isrf_outside,
        isrf_emitted_of_1e6=int(from_isrf.sum()),
        scattered_share_shortest=scat.tolist(),
        grid=dict(n_cells=int(np.prod(m.grid.shape)),
                  shape=list(m.grid.shape)),
        cut=dict(out['cut'], n_iterations=n_iterations))
    phase('class1_cyl (%d x %d x %d cells, model built in %.3f s): the ISRF '
          'drew %.5f of %d sources (its luminosity share %.5f, sigma %.2e); '
          '%d of its 1,000,000-draw photons (%d) start outside the grid; '
          'scattered share at 0.3 um per view (10, 60, 85 degrees) %s [%s]'
          % (*m.grid.shape[::-1], build_s, share, n_picks, p, sigma,
             isrf_outside, int(from_isrf.sum()), ['%.4f' % v for v in scat],
             card))
    if abs(share - p) > 3.0 * sigma:
        raise AssertionError('class1_cyl: the ISRF drew %.5f of the sources, '
                             'its luminosity share is %.5f (sigma %.2e)'
                             % (share, p, sigma))
    if not scat[2] > scat[0]:
        raise AssertionError('class1_cyl: scattered share at 0.3 um of the 85 '
                             'degree view %g, of the 10 degree view %g'
                             % (scat[2], scat[0]))
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


# ------------------------------- BASELINE configs 4 and 5: octree and AMR --

def sph_particles(n=None, seed=None):
    """Config 4's SPH particles (cm): 80% in a Plummer sphere of scale
    radius 0.1 pc, 20% in 10 Gaussian clumps of sigma 0.01 pc whose centres
    are drawn from N(0, 0.1 pc) per axis, from np.random.default_rng(seed);
    those outside the +-0.5 pc root cube dropped. Returns (positions (3,
    n_inside), the clump centres (3, 10), each kept particle's clump (-1 for
    the Plummer body))."""
    from hyperion_tpu_torch.util.constants import pc
    n = SPH_OCT['n_particles'] if n is None else n
    rng = np.random.default_rng(SPH_OCT['seed'] if seed is None else seed)
    n_pl = int(0.8 * n)
    r = 0.1 * pc / np.sqrt(rng.uniform(0.0, 1.0, n_pl) ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(3, n_pl))
    plummer = v / np.linalg.norm(v, axis=0) * r
    centres = rng.normal(0.0, 0.1 * pc, (3, 10))
    member = np.repeat(np.arange(10), (n - n_pl) // 10)
    clumps = centres[:, member] + rng.normal(0.0, 0.01 * pc,
                                             (3, len(member)))
    p = np.concatenate([plummer, clumps], axis=1)
    which = np.concatenate([np.full(n_pl, -1), member])
    keep = (np.abs(p) <= SPH_OCT['half_pc'] * pc).all(axis=0)
    return p[:, keep], centres, which[keep]


def cloud_setup(m, rho, centres, which, n_photons, n_iterations, n_imaging,
                raytracing, n_pix):
    """Config 4's dust, sources and outputs on the model ``m`` whose grid
    (over the +-0.5 pc cube) holds the dust density ``rho``: the HG dust
    stand-in of examples/class2_sed.py; a 1e4 Lsun, 20,000 K point source
    at the origin and two 1e3 Lsun, 10,000 K ones at the centres of the two
    clumps with most particles (``centres``, each particle's clump in
    ``which``); n_iterations Lucy iterations of n_photons; n_imaging
    imaging photons into peeled SEDs at 0, 45 and 90 degrees (120
    wavelengths, 0.1 to 3,000 um), an n_pix x n_pix image at 45 degrees of
    10 wavelengths (0.5 to 500 um) and a binned SED over all directions
    across the dust table's whole frequency range, forced first
    interaction off (so that the binned SED holds every photon's light);
    raytracing with ``raytracing``'s photons."""
    from hyperion_tpu_torch.dust import HenyeyGreensteinDust
    from hyperion_tpu_torch.util.constants import c, lsun, pc

    half = SPH_OCT['half_pc'] * pc
    nu = np.logspace(8, 17, 64)
    dust = HenyeyGreensteinDust(nu, np.repeat(0.5, 64), np.repeat(400.0, 64),
                                np.repeat(0.4, 64), np.repeat(0.8, 64))
    m.add_density_grid(rho, dust)
    s = m.add_point_source()
    s.luminosity, s.temperature, s.position = 1e4 * lsun, 20000.0, \
        (0.0, 0.0, 0.0)
    heaviest = np.argsort(-np.bincount(which[which >= 0], minlength=10))[:2]
    for i in heaviest:
        s = m.add_point_source()
        s.luminosity, s.temperature = 1e3 * lsun, 10000.0
        s.position = tuple(centres[:, i])
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([0.0, 45.0, 90.0], [0.0, 0.0, 0.0])
    sed.set_wavelength_range(120, 0.1, 3000.0)
    image = m.add_peeled_images(sed=False, image=True)
    image.set_viewing_angles([45.0], [0.0])
    image.set_image_size(n_pix, n_pix)
    image.set_image_limits(-half, half, -half, half)
    image.set_wavelength_range(10, 0.5, 500.0)
    binned = m.add_binned_images(sed=True, image=False)
    binned.set_viewing_bins(1, 1)
    # the dust table's whole frequency range (micron)
    binned.set_wavelength_range(SPH_OCT['binned_bins'], c / nu[-1] * 1e4,
                                c / nu[0] * 1e4)
    # every imaging photon escapes at its full weight, into the binned SED
    # (a forced first interaction would keep the light that escapes
    # without interacting out of it, as in phase 5's binned check)
    m.set_forced_first_interaction(False)
    m.set_n_initial_iterations(n_iterations)
    m.set_raytracing(raytracing is not None)
    m.set_n_photons(initial=n_photons, imaging=n_imaging,
                    **(raytracing or {}))
    m.set_seed(20261017)


def binned_lsun(img):
    """The binned SED over all directions of config 4's outputs
    (:func:`cloud_setup`) in Lsun: its bins even in log nu over the dust
    table's 1e8 to 1e17 Hz."""
    from hyperion_tpu_torch.util.constants import lsun
    # seds: (n_stokes, n_orig, n_view, n_ap, n_nu); the one direction bin
    val = img.binned['datasets']['seds'][0][0, 0, 0, 0, :]
    dlognu = np.log(1e17 / 1e8) / SPH_OCT['binned_bins']
    return float(val.sum()) * dlognu / lsun


def sph_octree_model(n_photons, n_iterations, n_imaging, raytracing=RAYTRACING,
                     n_pix=128):
    """BASELINE.md config 4 (sph_octree): an SPH cloud imported into an
    octree, full thermal RT and raytraced images. The particles of
    :func:`sph_particles`; each one's kernel sigma half the distance to its
    32nd neighbour (scipy's cKDTree); 100 Msun of gas shared equally by the
    100,000 drawn particles, dust-to-gas 0.01; the port's construct_octree
    (n_ref 32, the exact discretization, the native library) over the +-0.5
    pc root cube; examples/class2_sed.py's HG dust stand-in; a 1e4 Lsun,
    20,000 K point source at the origin and two 1e3 Lsun, 10,000 K ones at
    the centres of the two clumps that keep most particles in the cube;
    n_iterations Lucy iterations of n_photons; n_imaging imaging photons
    into peeled SEDs at 0, 45 and 90 degrees (120 wavelengths, 0.1 to
    3,000 um), an n_pix x n_pix image at 45 degrees of 10 wavelengths (0.5
    to 500 um) and a binned SED over all directions across the dust table's
    whole frequency range, forced first interaction off (so that the binned
    SED holds every photon's light); raytracing with ``raytracing``'s
    photons. Returns (model, report of the import)."""
    from scipy.spatial import cKDTree
    from hyperion_tpu_torch import native
    from hyperion_tpu_torch.importers import construct_octree
    from hyperion_tpu_torch.model import Model
    from hyperion_tpu_torch.transport.gtable_octree import tree_depth
    from hyperion_tpu_torch.util.constants import msun, pc

    t0 = time.time()
    p, centres, which = sph_particles()
    d32 = cKDTree(p.T).query(p.T, k=SPH_OCT['n_neighbour'] + 1)[0][:, -1]
    sigma = 0.5 * d32
    dust_mass = SPH_OCT['gas_msun'] * msun * SPH_OCT['dust_to_gas'] / \
        SPH_OCT['n_particles']
    mass = np.full(p.shape[1], dust_mass)
    half = SPH_OCT['half_pc'] * pc
    t1 = time.time()
    grid = construct_octree(0.0, 0.0, 0.0, half, half, half, *p, sigma, mass,
                            n_ref=SPH_OCT['n_ref'], method='exact')
    t_tree = time.time() - t1
    refined = np.asarray(grid.refined, bool)
    rho = np.asarray(grid['density'][0].array, float)
    _, halves, children = grid.tree_tables()
    volumes = 8.0 * halves.prod(axis=1)
    m = Model()
    m.set_octree_grid(0.0, 0.0, 0.0, half, half, half, refined)
    cloud_setup(m, rho, centres, which, n_photons, n_iterations, n_imaging,
                raytracing, n_pix)
    info = dict(particles_inside=int(p.shape[1]), nodes=int(len(refined)),
                leaves=int((~refined).sum()),
                depth=tree_depth(children, refined),
                smallest_half_width_of_root=float(halves[:, 0].min() /
                                                  halves[0, 0]),
                tree_s=t_tree, import_s=time.time() - t0,
                native=native.available(),
                particle_dust_mass=float(dust_mass * p.shape[1]),
                grid_dust_mass=float((rho * volumes)[~refined].sum()))
    return m, info


def write_plotfile(dirname, levels, quantities, stars=()):
    """Write a BoxLib plotfile: levels = [[(bounds, shape), ...]],
    quantities = {name: [[array per fab per level]]}, shape (nz, ny, nx);
    stars (m, x, y, z, r, mdot). A copy of the writer of
    tests/test_orion_importer.py:13-84."""
    import os
    os.makedirs(dirname)
    names = list(quantities)
    n_levels = len(levels)
    with open(os.path.join(dirname, 'Header'), 'w') as f:
        f.write("HyperCLaw-V1.1\n")
        f.write("%d\n" % len(names))
        for q in names:
            f.write(q + "\n")
        f.write("3\n")                       # ndim
        f.write("0.0\n")                     # time
        f.write("%d\n" % (n_levels - 1))     # finest level
        f.write("0.0 0.0 0.0\n")
        f.write("1.0 1.0 1.0\n")
        f.write(" ".join(["2"] * max(n_levels - 1, 1)) + "\n")
        f.write(" ".join("((0,0,0) (7,7,7) (0,0,0))"
                         for _ in range(n_levels)) + "\n")
        f.write(" ".join(["10"] * n_levels) + "\n")
        for _ in range(n_levels):
            f.write("0.125 0.125 0.125\n")
        f.write("0\n")                       # coordtype
        f.write("0\n")                       # dummy
        for ilev, fabs in enumerate(levels):
            f.write("%d %d 0.0\n" % (ilev, len(fabs)))
            f.write("10\n")
            for (bounds, shape) in fabs:
                f.write("%r %r\n" % (bounds[0], bounds[1]))
                f.write("%r %r\n" % (bounds[2], bounds[3]))
                f.write("%r %r\n" % (bounds[4], bounds[5]))
            f.write("Level_%d/Cell\n" % ilev)
            _write_multifab(dirname, ilev, fabs, names,
                            [quantities[q][ilev] for q in names])
    with open(os.path.join(dirname, 'StarParticles'), 'w') as f:
        f.write("%d\n" % len(stars))
        for (m, x, y, z, r, mdot) in stars:
            row = [m, x, y, z] + [0.0] * 7 + [r, 0.0, 0.0, mdot, 1.0]
            f.write(" ".join("%r" % v for v in row) + "\n")


def _write_multifab(dirname, ilev, fabs, names, arrays_per_name):
    import os
    lev_dir = os.path.join(dirname, 'Level_%d' % ilev)
    os.makedirs(lev_dir, exist_ok=True)
    offsets = []
    data_name = 'Cell_D_00000'
    with open(os.path.join(lev_dir, data_name), 'wb') as fd:
        for i, (bounds, shape) in enumerate(fabs):
            nz, ny, nx = shape
            offsets.append(fd.tell())
            box = "((0,0,0) (%d,%d,%d) (0,0,0))" % (nx - 1, ny - 1, nz - 1)
            fd.write(("FAB ((8, (64 11 52 0 1 12 0 1023)),"
                      "(8, (1 2 3 4 5 6 7 8))) %s %d\n"
                      % (box, len(names))).encode('ascii'))
            for arrays in arrays_per_name:
                fd.write(np.asarray(arrays[i], '>f8').tobytes())
    with open(os.path.join(lev_dir, 'Cell_H'), 'w') as fh:
        fh.write("1\n1\n%d\n0\n" % len(names))
        fh.write("(%d 0\n" % len(fabs))
        for (bounds, shape) in fabs:
            nz, ny, nx = shape
            fh.write("((0,0,0) (%d,%d,%d) (0,0,0))\n"
                     % (nx - 1, ny - 1, nz - 1))
        fh.write(")\n")
        fh.write("%d\n" % len(fabs))
        for off in offsets:
            fh.write("FabOnDisk: %s %d\n" % (data_name, off))


def orion_levels():
    """Config 5's levels: 3, refinement 2, each 64^3 cells in 8 fabs of
    32^3 (its octants): level 0 over a 0.2 pc cube, level 1 over the central
    0.1 pc, level 2 over the central 0.05 pc, around the origin; and the
    gas density rho_c / (1 + (r / r_c)^2) at each fab's cell centres.
    Returns ([[(bounds (cm), (nz, ny, nx))]], [[density]])."""
    from hyperion_tpu_torch.util.constants import pc
    levels, dens = [], []
    for width in ORION_AMR['level_widths_pc']:
        half = 0.5 * width * pc
        fabs, rho = [], []
        for oz in (0, 1):
            for oy in (0, 1):
                for ox in (0, 1):
                    lo = [-half + o * half for o in (ox, oy, oz)]
                    b = (lo[0], lo[0] + half, lo[1], lo[1] + half, lo[2],
                         lo[2] + half)
                    n = ORION_AMR['fab_cells']
                    fabs.append((b, (n, n, n)))
                    c = [lo[a] + (np.arange(n) + 0.5) * half / n
                         for a in range(3)]
                    z, y, x = np.meshgrid(c[2], c[1], c[0], indexing='ij')
                    r2 = x ** 2 + y ** 2 + z ** 2
                    r_c = ORION_AMR['r_c_pc'] * pc
                    rho.append(ORION_AMR['rho_c'] / (1.0 + r2 / r_c ** 2))
        levels.append(fabs)
        dens.append(rho)
    return levels, dens


def orion_amr_model(n_photons, n_iterations, n_imaging, raytracing=RAYTRACING,
                    n_pix=128):
    """BASELINE.md config 5 (orion_amr) on one card: an AMR grid from a
    hydro snapshot. A BoxLib plotfile of :func:`orion_levels`'s density and
    one StarParticles sink at the centre, written by :func:`write_plotfile`
    and read back by the port's parse_orion; dust-to-gas 0.01 in
    examples/class2_sed.py's HG dust stand-in; a 10 Lsun, 4,000 K point
    source at the sink; MRW with gamma 2; n_iterations Lucy iterations of
    n_photons; forced first interaction in imaging; n_imaging photons into
    peeled SEDs at 10, 45 and 80 degrees (120 wavelengths, 0.1 to 3,000 um)
    and an n_pix x n_pix image at 45 degrees (10 wavelengths, 0.5 to 500
    um); raytracing with ``raytracing``'s photons. Returns (model, report
    of the import)."""
    import shutil
    from hyperion_tpu_torch.dust import HenyeyGreensteinDust
    from hyperion_tpu_torch.importers import parse_orion
    from hyperion_tpu_torch.model import Model
    from hyperion_tpu_torch.util.constants import lsun, msun, pc

    t0 = time.time()
    levels, dens = orion_levels()
    path = OUT / 'orion_amr_plt'
    shutil.rmtree(path, ignore_errors=True)
    write_plotfile(str(path), levels, {'density': dens},
                   stars=[(20.0 * msun, 0.0, 0.0, 0.0, 7e10, 1e-6)])
    t1 = time.time()
    amr, stars = parse_orion(str(path), quantities='density')
    t_parse = time.time() - t1
    # what was read against what was written
    if len(amr.levels) != len(levels) or len(stars) != 1 or \
            (stars[0].x, stars[0].y, stars[0].z) != (0.0, 0.0, 0.0):
        raise AssertionError('orion_amr: parse_orion read %d levels and %s'
                             % (len(amr.levels), stars))
    for level, fabs, rho in zip(amr.levels, levels, dens):
        if len(level.grids) != len(fabs):
            raise AssertionError('orion_amr: a level of %d fabs read as %d'
                                 % (len(fabs), len(level.grids)))
        for g, (b, shape), r in zip(level.grids, fabs, rho):
            got = (g.xmin, g.xmax, g.ymin, g.ymax, g.zmin, g.zmax)
            if got != b or (g.nz, g.ny, g.nx) != shape or \
                    not np.array_equal(g.quantities['density'], r):
                raise AssertionError('orion_amr: a fab read as %s %s'
                                     % (got, (g.nz, g.ny, g.nx)))
            g.quantities['density'] = g.quantities['density'] * \
                ORION_AMR['dust_to_gas']
    nu = np.logspace(8, 17, 64)
    dust = HenyeyGreensteinDust(nu, np.repeat(0.5, 64), np.repeat(400.0, 64),
                                np.repeat(0.4, 64), np.repeat(0.8, 64))
    m = Model()
    m.set_amr_grid(amr)
    m.add_density_grid(amr['density'], dust)
    s = m.add_point_source()
    s.luminosity, s.temperature = 10.0 * lsun, 4000.0
    s.position = (stars[0].x, stars[0].y, stars[0].z)
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([10.0, 45.0, 80.0], [0.0, 0.0, 0.0])
    sed.set_wavelength_range(120, 0.1, 3000.0)
    half = 0.5 * ORION_AMR['level_widths_pc'][0] * pc
    image = m.add_peeled_images(sed=False, image=True)
    image.set_viewing_angles([45.0], [0.0])
    image.set_image_size(n_pix, n_pix)
    image.set_image_limits(-half, half, -half, half)
    image.set_wavelength_range(10, 0.5, 500.0)
    m.set_mrw(True, gamma=2.0)
    m.set_forced_first_interaction(True)
    m.set_n_initial_iterations(n_iterations)
    m.set_raytracing(raytracing is not None)
    m.set_n_photons(initial=n_photons, imaging=n_imaging,
                    **(raytracing or {}))
    m.set_seed(20261017)
    info = dict(levels=len(amr.levels),
                fabs=sum(len(level.grids) for level in amr.levels),
                cells=int(amr.n_cells), write_s=t1 - t0, parse_s=t_parse)
    return m, info


@contextlib.contextmanager
def mrw_jumps():
    """Count the Lucy steps' MRW jumps (``engine.mrw_jump_update``'s
    lanes) on the device, where a graph's replays add theirs too; yields
    a () int64 tensor on the card."""
    import torch
    from hyperion_tpu_torch.transport import engine

    counts = torch.zeros((), dtype=torch.int64, device='cuda')
    inner = engine.mrw_jump_update

    def counted(dt, mrw, u, mrw_now, *args):
        counts.add_(mrw_now.sum())
        return inner(dt, mrw, u, mrw_now, *args)

    engine.mrw_jump_update = counted
    try:
        yield counts
    finally:
        engine.mrw_jump_update = inner


@contextlib.contextmanager
def forced_weights():
    """Check the forced first interaction's energy factors
    (``imaging.sample_first_interaction``'s second result) on the device,
    where a graph's replays check theirs too; yields a dict of 'calls' (the
    calls made eagerly or captured) and 'ok', a () bool tensor on the card
    that stays true while every factor is finite and > 0."""
    import torch
    from hyperion_tpu_torch.transport import imaging

    seen = dict(calls=0, ok=torch.ones((), dtype=torch.bool, device='cuda'))
    inner = imaging.sample_first_interaction

    def recorded(*args, **kw):
        tau, w = inner(*args, **kw)
        seen['ok'].logical_and_((torch.isfinite(w) & (w > 0)).all())
        seen['calls'] += 1
        return tau, w

    imaging.sample_first_interaction = recorded
    try:
        yield seen
    finally:
        imaging.sample_first_interaction = inner


@contextlib.contextmanager
def stage_launches(kernels):
    """The launches of each kernel module of ``kernels`` ({name: module},
    its ``launches`` count) made inside the Lucy iterations
    (``lucy.run_lucy_iteration``) and the imaging iteration
    (``imaging.run_final``) run inside the block; yields {name: {'lucy': n,
    'imaging': n}}."""
    from hyperion_tpu_torch.transport import imaging, lucy

    out = {name: dict(lucy=0, imaging=0) for name in kernels}
    stages = dict(lucy=(lucy, 'run_lucy_iteration'),
                  imaging=(imaging, 'run_final'))
    inner = {stage: getattr(mod, attr) for stage, (mod, attr)
             in stages.items()}

    def counted(stage):
        @functools.wraps(inner[stage])
        def run(*args, **kw):
            before = {name: mod.launches for name, mod in kernels.items()}
            try:
                return inner[stage](*args, **kw)
            finally:
                for name, mod in kernels.items():
                    out[name][stage] += mod.launches - before[name]
        return run

    for stage, (mod, attr) in stages.items():
        setattr(mod, attr, counted(stage))
    try:
        yield out
    finally:
        for stage, (mod, attr) in stages.items():
            setattr(mod, attr, inner[stage])


def box_grid_run(what, kind, dv, et, card, model, n_photons, n_imaging,
                 max_steps, imaging_max_steps, mrw=False, batch_size=None,
                 more_kernels=None, wrap_step=None):
    """Run a config on the card through run_lucy_model with the recorders
    of phase 13 and the launch and step counts reset just before; the
    shared checks: killed_geo 0 in every iteration, energy_current the
    photons emitted, temperatures finite and > 0 in dusty cells, killed_int
    only at the step caps (the share killed there reported), the SEDs and
    images finite and >= 0, the imaging steps run as graph replays
    (:func:`check_imaging`), one escape_tau launch in each peel event
    (:func:`check_peels`), no raytraced photon outside the grid or its
    cell, each kernel launched; the first Lucy iteration's first
    GRAPH_WITNESS_STEPS['box'] steps run both ways (:func:`graph_witness`)
    and the imaging iteration's first IMAGING_WITNESS_STEPS['box']
    (:func:`imaging_witness`); then each kernel against its plain version
    on this run's own calls (deposit_visit on the calls of the Lucy
    witness's eager run, whose step ``wrap_step`` wraps, escape_tau on
    the WALK_WINDOWS steps of the imaging witness's eager run).
    ``more_kernels``: {name: module} of other
    kernels whose ``launches`` count is reset and read with these, and
    split between the Lucy and the imaging iterations
    (:func:`stage_launches`, the report's 'launches_by_stage'). Returns
    ({kernel: launches}, run, report)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model
    from hyperion_tpu_torch.model.run import (_density_array,
                                              build_geometry_tables)
    from hyperion_tpu_torch.transport import engine

    dev = torch.device('cuda')
    more_kernels = more_kernels or {}
    for mod in more_kernels.values():
        mod.launches = 0
    dv.launches = et.launches = et.column_launches = 0
    engine.reset_step_counts()
    t0 = time.time()
    with transport_syncs() as syncs, imaging_syncs() as img_syncs, \
            peel_events(et) as peels, first_lucy_iteration() as first, \
            first_imaging() as fimg, column_calls() as ccalls, \
            mrw_jumps() as jumps, stage_launches(more_kernels) as stages:
        run = run_lucy_model(model, device='cuda', batch_size=batch_size,
                             max_steps=max_steps,
                             imaging_max_steps=imaging_max_steps)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(deposit_visit=dv.launches, escape_tau=et.launches,
                    escape_column=et.column_launches,
                    **{name: mod.launches
                       for name, mod in more_kernels.items()})
    res, img, ray = run.result, run.imaging, run.imaging.raytrace
    rows = report_iterations(what, run.perf.rows[:len(run.iterations)],
                             syncs, n_photons, card)
    temp = res.temperature[0]
    dusty = run.density0[0] > 0
    if not np.isfinite(temp).all() or not (temp[dusty] > 0).all():
        raise AssertionError('%s: temperatures not finite and > 0 in dusty '
                             'cells' % what)
    capped = [r for r in rows if r['killed_int'] and r['steps'] < max_steps]
    if capped:
        raise AssertionError('%s Lucy: killed_int below the cap: %s'
                             % (what, capped))
    img_row = check_imaging(what, run, n_imaging, img_syncs, card)
    if img.killed_int and img.n_steps < imaging_max_steps:
        raise AssertionError('%s imaging: killed_int %d below the cap (%d '
                             'steps)' % (what, img.killed_int, img.n_steps))
    n_jumps = int(jumps)
    # the share of the photons killed at the step caps: Lucy's over all
    # its iterations
    lucy_killed = sum(r['killed_int'] for r in rows) / (n_photons * len(rows))
    img_killed = img.killed_int / n_imaging
    out = dict(wall_s=wall, iterations=rows, lucy_steps=res.n_steps,
               lucy_killed_int=res.killed_int,
               lucy_killed_geo=res.killed_geo, imaging=img_row,
               imaging_killed_int=img.killed_int,
               lucy_killed_int_share=lucy_killed,
               imaging_killed_int_share=img_killed, launches=launches,
               peel_events=peels['events'],
               escape_tau_launches_in_peels=peels['launches'],
               escape_tau_launches_per_peel_max=peels['most'],
               mrw_jumps=n_jumps,
               escape_tau_launches_per_step=launches['escape_tau'] /
               img.n_steps, peel_events_per_step=peels['events'] /
               img.n_steps, launches_by_stage=stages,
               raytracing=dict(wall_s=ray['wall'], batches=ray['batches'],
                               photons=ray['photons'],
                               outside=ray['outside']),
               cut=dict(n_photons=n_photons, max_steps=max_steps,
                        n_imaging=n_imaging,
                        imaging_max_steps=imaging_max_steps))
    phase('%s: run_lucy_model in %.3f s; Lucy %d steps, killed %d/%d; '
          'imaging %d steps, killed_int %d; killed at the step caps: %.5f of '
          'the Lucy photons, %.5f of the imaging photons; escape_tau %d '
          'launches, %d of them in %d peel events (at most %d in one; the '
          'others the forced first interaction\'s own walks), %.3f per step; '
          'raytracing %d photons in %d batches, %.3f s, %d outside; %d MRW '
          'jumps in the Lucy steps [%s]'
          % (what, wall, res.n_steps, res.killed_int, res.killed_geo,
             img.n_steps, img.killed_int, lucy_killed, img_killed,
             launches['escape_tau'], peels['launches'], peels['events'],
             peels['most'], launches['escape_tau'] / img.n_steps,
             ray['photons'], ray['batches'], ray['wall'], ray['outside'],
             n_jumps, card))
    if res.killed_geo or ray['outside']:
        raise AssertionError('%s: %s' % (what, out))
    check_peels(what, peels, launches['escape_tau'], img.n_steps,
                model.forced_first_interaction)
    if mrw and not n_jumps:
        raise AssertionError('%s: no MRW jump' % what)
    if not all(launches.values()):
        raise AssertionError('%s: a kernel was not launched: %s'
                             % (what, launches))

    # the graph against the eager loop; then the kernels on this run's own
    # calls
    out['graph_witness'], dcalls = graph_witness(
        what, first, GRAPH_WITNESS_STEPS['box'], card,
        recorder=lambda: deposit_calls(dv, 40, 120), wrap_step=wrap_step)
    out['imaging_witness'], wcalls = imaging_witness(
        what, fimg, IMAGING_WITNESS_STEPS['box'], card,
        recorder=lambda: walk_calls(WALK_WINDOWS))
    n_dust, n_cells = run.density0.shape
    err = check_calls(dv, dcalls, n_dust, n_cells, dev, '%s calls' % what)
    t = time_calls(dv, dcalls, n_dust, n_cells, dev)
    t['lanes'] = '%s steps' % what
    phase('deposit_visit %s Lucy calls (%d, %d visits only): counts and uids '
          'equal, max abs energy err %.3g; B=%d n_cells=%d: device %.2f us, '
          'host %.2f us per call, plain %.4f ms, index_add_ %.4f ms, bound '
          '%.3f us [%s]'
          % (what, len(dcalls), sum(d is None for _, d, _, _ in dcalls), err,
             t['B'], n_cells, t['device_us'], t['host_us'], t['plain_ms'],
             t['library_ms'], t['bound_us'], card))
    geo64 = build_geometry_tables(model.grid, dev, torch.float64)
    rho64 = _density_array(model, geo64.length_scale, dev, torch.float64)
    rho32 = _density_array(model, geo64.length_scale, dev, torch.float32)
    tables = (geo64, rho32.T.contiguous(), rho64.T.contiguous())
    walks = [check_window(kind, w, wcalls[w], tables, img.batch_size, card)
             for w in WALK_WINDOWS]
    kinds = {k for k, _ in ccalls}
    if kinds != {kind}:
        raise AssertionError('%s columns: calls of %s' % (what, kinds))
    cols = check_columns('%s raytracing' % what, kind,
                         [c for _, c in ccalls], tables, card)
    out.update(deposit_visit=dict(max_abs_err=err, timing=t), walks=walks,
               columns=cols)
    return launches, run, out


def sph_octree_phase(dv, et, card, n_photons, n_iterations, max_steps,
                     n_imaging, imaging_max_steps):
    """Phase 16: BASELINE config 4 (:func:`sph_octree_model`) through
    run_lucy_model on the card in float32 (:func:`box_grid_run`'s checks
    and kernels), and: killed_int 0 with every Lucy iteration below its
    step cap (a walk that stalled would run into it); no photon visit in a
    refined node, whose specific energy is the dust table's floor; the
    grid's dust mass at most the particles' inside
    the cube (+1e-9 relative) and at least 95% of it (kernel mass spills
    past the faces); the all-direction binned SED over the dust table's
    frequency range within 3% of the sources' 1.2e4 Lsun (every photon
    escapes); the native library built and loaded; the locate kernel
    (octree_locate) launched in the Lucy and in the imaging iterations, and
    bit-equal to its plain versions on every call of Lucy steps 41-43 of
    graph_witness's eager run (:func:`check_octree_locate`). Returns
    ({kernel: launches}, report)."""
    from hyperion_tpu_torch.transport import octree_locate as ol

    t0 = time.time()
    m, info = sph_octree_model(n_photons, n_iterations, n_imaging)
    build_s = time.time() - t0
    phase('sph_octree: %d particles in the cube, %d nodes (%d leaves), '
          'depth %d (smallest half-width %.6g of the root), tree and density '
          'in %.3f s, import in %.3f s on the host (native library %s) '
          '[%s]'
          % (info['particles_inside'], info['nodes'], info['leaves'],
             info['depth'], info['smallest_half_width_of_root'],
             info['tree_s'], info['import_s'],
             'loaded' if info['native'] else 'NOT loaded', card))
    if not info['native']:
        raise AssertionError('sph_octree: the native library was not built '
                             'and loaded')
    ratio = info['grid_dust_mass'] / info['particle_dust_mass']
    if not 0.95 <= ratio <= 1.0 + 1e-9:
        raise AssertionError('sph_octree: the grid holds %.6f of the '
                             'particles\' dust mass' % ratio)
    with octree_calls(40, 43) as ocalls:
        launches, run, out = box_grid_run(
            'sph_octree', 'octree', dv, et, card, m, n_photons, n_imaging,
            max_steps, imaging_max_steps,
            more_kernels=dict(octree_locate=ol), wrap_step=ocalls['wrap'])
    stages = out['launches_by_stage']['octree_locate']
    phase('sph_octree: octree_locate %d launches on the main path (a launch '
          'captured into a graph counts once): %d in the Lucy iterations, %d '
          'in the imaging iteration [%s]'
          % (launches['octree_locate'], stages['lucy'], stages['imaging'],
             card))
    if not (stages['lucy'] and stages['imaging']):
        raise AssertionError('sph_octree: octree_locate was not launched in '
                             'both iterations: %s' % stages)
    out['octree_locate'] = check_octree_locate(
        'sph_octree Lucy steps 41-43', ocalls['calls'], card)
    res, img = run.result, run.imaging
    if res.killed_int or any(r['steps'] >= max_steps
                             for r in out['iterations']):
        raise AssertionError('sph_octree Lucy: killed_int %d, steps %s (cap '
                             '%d)' % (res.killed_int, [r['steps'] for r in
                                                       out['iterations']],
                                      max_steps))
    # no photon ever sits in a refined node (cells are leaves), and their
    # specific energy is what a cell without deposits gets: the dust
    # table's floor (enforce_energy_range, as in the JAX package)
    refined = np.asarray(m.grid.refined, bool)
    se = res.specific_energy
    visits = np.asarray(run.iterations[-1]['n_photons']).reshape(-1)
    if visits[refined].any() or \
            (se[:, refined] != se.min(axis=1, keepdims=True)).any():
        raise AssertionError('sph_octree: refined nodes were visited (%d) or '
                             'hold specific energy above the floor'
                             % int(visits[refined].sum()))
    total = binned_lsun(img)
    if abs(total / SPH_OCT['luminosity_lsun'] - 1.0) > 0.03:
        raise AssertionError('sph_octree: the binned SED holds %.1f Lsun of '
                             'the sources\' %.0f' % (total,
                                                     SPH_OCT['luminosity_lsun']))
    out.update(model_build_s=build_s, import_=info,
               grid_to_particle_dust_mass=ratio, binned_lsun=total,
               cut=dict(out['cut'], n_iterations=n_iterations))
    phase('sph_octree: grid dust mass %.6f of the particles\' in the cube; '
          'binned SED over all directions %.2f Lsun of the sources\' %.0f '
          '(%.5f) [%s]'
          % (ratio, total, SPH_OCT['luminosity_lsun'],
             total / SPH_OCT['luminosity_lsun'], card))
    return launches, out


@contextlib.contextmanager
def octree_calls(first, last):
    """Record the octree locate's calls (``OctreeLocate.find_cell`` and
    ``find_wall``, with what they returned) made in steps ``first`` to
    ``last`` (from 0) of a Lucy step that ``rec['wrap']`` wraps (the eager
    loop of :func:`graph_witness`); yields {'calls': [(locator, cell or
    None, lanes, outputs)], 'wrap': the step wrapper}, cloned."""
    from hyperion_tpu_torch.transport.octree_locate import OctreeLocate

    state = dict(on=False)
    cls = OctreeLocate
    inner = (cls.find_cell, cls.find_wall)

    def keep(self, cell, lanes, outs):
        if state['on']:
            rec['calls'].append(
                (self, None if cell is None else cell.clone(),
                 [a.clone() for a in lanes], [o.clone() for o in outs]))

    def find_cell(self, *lanes):
        out = inner[0](self, *lanes)
        keep(self, None, lanes, [out])
        return out

    def find_wall(self, cell, *lanes):
        out = inner[1](self, cell, *lanes)
        keep(self, cell, lanes, out)
        return out

    def wrap(step):
        n = [0]

        @functools.wraps(step)
        def counted(carry, generator):
            state['on'] = first <= n[0] < last
            n[0] += 1
            try:
                step(carry, generator)
            finally:
                state['on'] = False
        return counted

    rec = dict(calls=[], wrap=wrap)
    cls.find_cell, cls.find_wall = find_cell, find_wall
    try:
        yield rec
    finally:
        cls.find_cell, cls.find_wall = inner


def differing_bits(got, want):
    """The elements of ``got`` whose bits differ from ``want``'s (all of
    them where the dtypes or shapes differ; a float's sign of zero
    counts)."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        return max(got.numel(), want.numel())
    if got.dtype.is_floating_point:
        view = torch.int32 if got.dtype == torch.float32 else torch.int64
        got, want = got.view(view), want.view(view)
    return int((got != want).sum())


def max_abs_diff(got, want):
    """The largest |got - want| over the elements, in float64 (0.0 where
    the bits are equal everywhere; inf where the dtypes or shapes differ)."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        return float('inf')
    if got.numel() == 0:
        return 0.0
    diff = (got.double() - want.double()).abs()
    if got.dtype.is_floating_point:
        view = torch.int32 if got.dtype == torch.float32 else torch.int64
        diff = torch.where(got.view(view) == want.view(view), 0.0, diff)
    return float(diff.max())


def octree_descend_reads(geo, x, y, z, kx, ky, kz):
    """The root descends of points by the plain rule: (the refined nodes
    read, unique, the levels read, summed over the lanes inside the root
    box)."""
    import torch
    from hyperion_tpu_torch.transport.gtable_octree import upper

    node = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    active = geo._inside(x, y, z, kx, ky, kz)
    seen, levels = [], 0
    for _ in range(geo.max_depth):
        active = active & geo.refined[node]
        seen.append(node[active])
        levels += int(active.sum())
        c = geo.centers[node]
        octant = (upper(x, c[:, 0], kx).long() +
                  2 * upper(y, c[:, 1], ky).long() +
                  4 * upper(z, c[:, 2], kz).long())
        node = torch.where(active, geo.children[node, octant], node)
    return int(torch.unique(torch.cat(seen)).numel()), levels


def check_octree_locate(what, calls, card):
    """The octree locate kernel on recorded calls of the main path: the
    run's own outputs and a relaunch's equal to the plain versions'
    (find_cell_reference, find_wall_reference) bit for bit on every lane
    and output; then for the first find_cell and the first find_wall call:
    device us a call (CUDA events over a CUDA graph of 10 calls), host us a
    call (eager calls before the synchronise), the plain version's ms
    (CUDA events around eager calls), and the bound: the lanes read and
    the outputs written once, the records that the root descends read
    (OCTREE_NODE_BYTES a refined node and OCTREE_WALL_BYTES the root's and
    each leaf's walls, once), over HBM_BYTES_PER_S, against the operations
    (OCTREE_*_OPS) over the lanes' type's rate."""
    import torch
    from hyperion_tpu_torch.transport import octree_locate as ol

    if not calls:
        raise AssertionError('octree_locate %s: no call recorded' % what)
    mismatched, max_err = 0, 0.0
    first = {}
    for loc, cell, lanes, outs in calls:
        geo = loc.geo
        if cell is None:
            ref = [ol.find_cell_reference(geo, *lanes)]
            again = [loc.find_cell(*lanes)]
        else:
            ref = list(ol.find_wall_reference(geo, cell, *lanes))
            again = list(loc.find_wall(cell, *lanes))
        mismatched += sum(differing_bits(g, w) for got in (outs, again)
                          for g, w in zip(got, ref))
        max_err = max([max_err] + [max_abs_diff(g, w) for got in
                                   (outs, again) for g, w in zip(got, ref)])
        first.setdefault('find_cell' if cell is None else 'find_wall',
                         (loc, cell, lanes, ref))
    torch.cuda.synchronize()
    out = dict(run=what, calls=len(calls), mismatched=mismatched,
               max_abs_err=max_err,
               find_cell_calls=sum(c[1] is None for c in calls),
               find_wall_calls=sum(c[1] is not None for c in calls))
    for kind, (loc, cell, lanes, ref) in sorted(first.items()):
        geo = loc.geo
        B, elem = lanes[0].shape[0], lanes[0].element_size()
        rate = FP64_FLOPS if elem == 8 else FP32_FLOPS
        if cell is None:
            def call(loc=loc, lanes=lanes):
                loc.find_cell(*lanes)

            def plain(geo=geo, lanes=lanes):
                ol.find_cell_reference(geo, *lanes)
            points = lanes
            nbytes = B * (6 * elem + 8)
            ops = B * OCTREE_OPS_PER_LANE
        else:
            def call(loc=loc, cell=cell, lanes=lanes):
                loc.find_wall(cell, *lanes)

            def plain(geo=geo, cell=cell, lanes=lanes):
                ol.find_wall_reference(geo, cell, *lanes)
            t, _, ax, wall = ref
            points = list(geo.snap(*(p + t * k for p, k in
                                     zip(lanes[:3], lanes[3:])), ax, wall,
                                   torch.ones_like(cell, dtype=torch.bool)))
            points += lanes[3:]
            # the cell and six lanes in; t, the next cell, the axis and the
            # wall out; each leaf's walls once
            nbytes = B * (8 + 6 * elem + 2 * elem + 16) + \
                int(torch.unique(cell).numel()) * OCTREE_WALL_BYTES
            ops = B * (OCTREE_OPS_PER_LANE + OCTREE_WALL_OPS)
        nodes, levels = octree_descend_reads(geo, *points)
        nbytes += nodes * OCTREE_NODE_BYTES + OCTREE_WALL_BYTES
        ops += levels * OCTREE_OPS_PER_LEVEL
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
        t_ops = ops / rate * 1e6
        out[kind] = dict(
            B=B, dtype=str(lanes[0].dtype), device_us=graph_us(call, 10),
            host_us=host_us(call, 200), plain_ms=event_ms(plain, 10),
            bound_us=max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes >= t_ops else 'operations',
            bytes=nbytes, ops=ops, records_read=nodes,
            levels_per_lane=levels / B, depth=geo.max_depth,
            nodes=geo.n_nodes)
        phase('octree_locate %s %s (B=%d %s, %d nodes of depth %d): device '
              '%.2f us, host %.2f us a call, plain %.4f ms, bound %.3f us '
              '(%s: %d bytes, %d operations; %d refined nodes read, %.3f '
              'levels a lane) [%s]'
              % (what, kind, B, out[kind]['dtype'], geo.n_nodes,
                 geo.max_depth, out[kind]['device_us'], out[kind]['host_us'],
                 out[kind]['plain_ms'], out[kind]['bound_us'],
                 out[kind]['bound_by'], nbytes, ops, nodes,
                 levels / B, card))
    phase('octree_locate %s: %d calls (%d find_cell, %d find_wall), %d '
          'outputs whose bits differ from the plain versions\' (the run\'s '
          'and a relaunch\'s), max abs difference %r [%s]'
          % (what, len(calls), out['find_cell_calls'],
             out['find_wall_calls'], mismatched, max_err, card))
    if mismatched or 'find_cell' not in out or 'find_wall' not in out:
        raise AssertionError('octree_locate %s: the kernel against its '
                             'plain versions: %s' % (what, out))
    return out


def octree_locate_kernel(oct_, n_launches):
    """The kernels line's octree_locate entry: phase 16's find_cell calls
    as the headline, its find_wall calls beside them; 'mismatched' counts
    the outputs whose bits differ from the plain versions'."""
    rec = oct_['octree_locate']
    c = rec['find_cell']
    keys = ('B', 'device_us', 'host_us', 'plain_ms', 'bound_us', 'bound_by',
            'levels_per_lane')
    return dict(
        name='octree_locate', route='cuda', source=OCTREE_LOCATE_SOURCE,
        replaces=OCTREE_LOCATE_REPLACES, launches=n_launches,
        max_abs_err=rec['max_abs_err'], mismatched=rec['mismatched'],
        ms=c['device_us'] / 1e3,
        plain_ms=c['plain_ms'], bound_ms=c['bound_us'] / 1e3,
        bound_by=c['bound_by'], library_ms=None, device_us=c['device_us'],
        host_us=c['host_us'], bound_us=c['bound_us'],
        launches_by_stage=oct_['launches_by_stage']['octree_locate'],
        calls={kind: {k: rec[kind][k] for k in keys}
               for kind in ('find_cell', 'find_wall')})


def orion_amr_phase(dv, et, card, n_photons, n_iterations, max_steps,
                    n_imaging, imaging_max_steps, batch_size):
    """Phase 17: BASELINE config 5 on one card (:func:`orion_amr_model`)
    through run_lucy_model in float32 (:func:`box_grid_run`'s checks and
    kernels; killed_int only at a stated step cap: a thick core), and:
    parse_orion's levels, fabs and density equal to what was written (in
    :func:`orion_amr_model`); MRW jumps counted and > 0; the forced first
    interaction's weights finite. Returns ({kernel: launches}, report)."""
    import torch

    t0 = time.time()
    m, info = orion_amr_model(n_photons, n_iterations, n_imaging)
    build_s = time.time() - t0
    phase('orion_amr: %d levels, %d fabs, %d cells written in %.3f s and '
          'read by parse_orion in %.3f s, equal to what was written [%s]'
          % (info['levels'], info['fabs'], info['cells'], info['write_s'],
             info['parse_s'], card))
    with forced_weights() as weights:
        launches, run, out = box_grid_run(
            'orion_amr', 'amr', dv, et, card, m, n_photons, n_imaging,
            max_steps, imaging_max_steps, mrw=True, batch_size=batch_size)
    if not weights['calls'] or not bool(weights['ok']):
        raise AssertionError('orion_amr: forced first interaction weights '
                             'not finite (%d calls)' % weights['calls'])
    out.update(model_build_s=build_s, import_=info,
               forced_weight_calls=weights['calls'],
               cut=dict(out['cut'], n_iterations=n_iterations,
                        batch_size=batch_size))
    return launches, out


def hierarchical_kernels(records, launches):
    """The kernels line of ``--hierarchical``: each kernel on phases 16's
    and 17's own calls (config 4's as the headline) and its launches
    there."""
    oct_, amr = records
    t = oct_['deposit_visit']['timing']
    walks = oct_['walks'] + amr['walks']
    w, c = oct_['walks'][0], oct_['columns']
    walk_keys = ('model', 'steps', 'calls', 'views', 'device_us',
                 'device_us_per_view', 'host_us', 'plain_ms', 'bound_us',
                 'bound_by', 'longest_walk')
    col_keys = ('run', 'model', 'calls', 'views', 'B', 'device_us',
                'host_us', 'plain_ms', 'bound_us', 'bound_by', 'longest_walk')
    return [
        dict(name='deposit_visit', route='cuda', source=KERNEL_SOURCE,
             replaces=REPLACES,
             launches=sum(launches['deposit_visit'].values()),
             max_abs_err=max(r['deposit_visit']['max_abs_err']
                             for r in records),
             ms=t['device_us'] / 1e3, plain_ms=t['plain_ms'],
             bound_ms=t['bound_us'] / 1e3, bound_by='bytes',
             library_ms=t['library_ms'], device_us=t['device_us'],
             host_us=t['host_us'], bound_us=t['bound_us'],
             orion_amr=amr['deposit_visit']['timing']),
        dict(name='escape_tau', route='cuda', source=ESCAPE_TAU_SOURCE,
             replaces=ESCAPE_TAU_REPLACES,
             launches=sum(launches['escape_tau'].values()),
             max_abs_err=max(x['f32_vs_plain32_max_abs_err'] for x in walks),
             ms=w['device_us'] / 1e3, plain_ms=w['plain_ms'],
             bound_ms=w['bound_us'] / 1e3, bound_by=w['bound_by'],
             library_ms=None,
             f64_max_rel_err=max(x['f64_max_rel_err'] for x in walks),
             windows=[{k: x[k] for k in walk_keys} for x in walks]),
        dict(name='escape_column', route='cuda', source=ESCAPE_TAU_SOURCE,
             replaces=ESCAPE_COLUMN_REPLACES,
             launches=sum(launches['escape_column'].values()),
             max_abs_err=max(r['columns']['f32_vs_plain32_max_abs_err']
                             for r in records),
             ms=c['device_us'] / 1e3, plain_ms=c['plain_ms'],
             bound_ms=c['bound_us'] / 1e3, bound_by=c['bound_by'],
             library_ms=None,
             f64_max_rel_err=max(r['columns']['f64_max_rel_err']
                                 for r in records),
             calls=[{k: r['columns'][k] for k in col_keys}
                    for r in records]),
        octree_locate_kernel(oct_, sum(launches['octree_locate'].values()))]


# ------------------- phase 18: config 4's cloud on a Voronoi mesh (voronoi) --

@contextlib.contextmanager
def locate_calls(first, last):
    """Record the locate kernel's calls (``VoronoiLocate.locate`` and
    ``walk_from`` with their cells) made inside the block: those of steps
    ``first`` to ``last`` (from 0) of a Lucy step that ``rec['wrap']``
    wraps (the eager loop of :func:`graph_witness`: a graph's captured
    calls hold its own lanes, which each replay writes anew), and those of
    the raytracing pass's dust batches (the positions in cells); yields
    {'lucy': calls, 'raytracing': calls, 'locators': the VoronoiLocate
    objects made, 'wrap': the step wrapper}, each call (locator, start or
    None, x, y, z, cells), cloned."""
    from hyperion_tpu_torch.transport import raytrace
    from hyperion_tpu_torch.transport import voronoi_locate as vl

    state = dict(where=None)
    cls = vl.VoronoiLocate
    inner = (cls.__init__, cls.locate, cls.walk_from,
             raytrace.raytrace_dust_batch)

    def init(self, geo):
        inner[0](self, geo)
        rec['locators'].append(self)

    def keep(self, start, x, y, z, cells):
        if state['where'] is not None:
            rec[state['where']].append(
                (self, None if start is None else start.clone(), x.clone(),
                 y.clone(), z.clone(), cells.clone()))
        return cells

    def locate(self, x, y, z):
        return keep(self, None, x, y, z, inner[1](self, x, y, z))

    def walk_from(self, start, x, y, z):
        return keep(self, start, x, y, z, inner[2](self, start, x, y, z))

    def wrap(step):
        n = [0]

        @functools.wraps(step)
        def counted(carry, generator):
            if first <= n[0] < last:
                state['where'] = 'lucy'
            n[0] += 1
            try:
                step(carry, generator)
            finally:
                state['where'] = None
        return counted

    def dust(*args, **kw):
        state['where'] = 'raytracing'
        try:
            return inner[3](*args, **kw)
        finally:
            state['where'] = None

    rec = dict(lucy=[], raytracing=[], locators=[], wrap=wrap)
    cls.__init__, cls.locate, cls.walk_from = init, locate, walk_from
    raytrace.raytrace_dust_batch = dust
    try:
        yield rec
    finally:
        cls.__init__, cls.locate, cls.walk_from = inner[:3]
        raytrace.raytrace_dust_batch = inner[3]


def check_locate(what, calls, card):
    """The locate kernel on recorded calls of the main path: the run's own
    cells and a relaunch's equal to the plain version's on every lane;
    the lanes at the cap by the plain version; then its times: device
    (CUDA events, each call behind a sleep), host (eager calls before the
    synchronise), the plain version's, and the bound (lanes read and cells
    written once, the lattice entries, neighbour rows and sites that the
    plain walks read, once; the walks' operations, LOCATE_FLOPS_*, in the
    sites' type). Beside the bound's bytes, those of the same walks over
    the packed rows that the kernel reads (voronoi_packed_bytes)."""
    import torch
    from hyperion_tpu_torch.transport import voronoi_locate as vl

    if not calls:
        raise AssertionError('voronoi_locate %s: no call recorded' % what)
    geo = calls[0][0].geo
    n_nb = (geo.neigh >= 0).sum(dim=1)
    elem = geo.sites.element_size()
    fp_rate = FP64_FLOPS if elem == 8 else FP32_FLOPS
    n_lanes = n_ne = n_cap = rows_read = nbrs_read = nbytes = flops = 0
    packed = 0
    for loc, start, x, y, z, cells in calls:
        visits = torch.zeros(geo.n_cells, dtype=torch.int64, device=x.device)
        B = x.shape[0]
        if start is None:
            ref, cap = vl.locate_reference(loc.geo, x, y, z, visits=visits,
                                           at_cap=True)
            inside = vl.inside_box(loc.geo, x, y, z)
            lattice = vl.lattice_index(loc.geo, x, y, z)[inside]
            common = 4 * int(torch.unique(lattice).numel())
            flops += LOCATE_FLOPS_LATTICE * B
            first = loc.geo.lookup[lattice]
        else:
            ref, cap = vl.owner_walk_reference(
                loc.geo.sites, loc.geo.neigh, start, x, y, z,
                loc.geo.walk_steps, visits)
            common = 8 * B
            first = start
        again = loc.locate(x, y, z) if start is None else \
            loc.walk_from(start, x, y, z)
        n_ne += int((cells != ref).sum() + (again != ref).sum())
        n_cap += int(cap.sum())
        n_lanes += B
        rows = int(visits.sum())
        nbrs = int((visits * n_nb).sum())
        rows_read += rows
        nbrs_read += nbrs
        flops += LOCATE_FLOPS_PER_LANE * B + rows + \
            LOCATE_FLOPS_PER_NEIGHBOUR * nbrs
        common += (3 * elem + 8) * B
        nbytes += common + voronoi_table_bytes(geo, visits, 3 * elem)
        packed += common + voronoi_packed_bytes(geo, visits, first, 3 * elem)

    def launch(call):
        loc, start, x, y, z, _ = call
        return loc.locate(x, y, z) if start is None else \
            loc.walk_from(start, x, y, z)

    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in calls]
    ends = [torch.cuda.Event(enable_timing=True) for _ in calls]
    for rep in range(2):
        for a, b, call in zip(starts, ends, calls):
            torch.cuda._sleep(1_000_000)
            a.record()
            launch(call)
            b.record()
        torch.cuda.synchronize()
    device_us = sum(a.elapsed_time(b) for a, b in zip(starts, ends)) * 1e3
    t0 = time.perf_counter()
    for call in calls:
        launch(call)
    host_us = (time.perf_counter() - t0) * 1e6 / len(calls)
    torch.cuda.synchronize()
    some = calls[:10]
    t0 = time.perf_counter()
    for loc, start, x, y, z, _ in some:
        if start is None:
            vl.locate_reference(loc.geo, x, y, z)
        else:
            vl.owner_walk_reference(loc.geo.sites, loc.geo.neigh, start, x,
                                    y, z, loc.geo.walk_steps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / len(some)
    t_bytes = nbytes / len(calls) / HBM_BYTES_PER_S * 1e6
    t_ops = flops / len(calls) / fp_rate * 1e6
    out = dict(run=what, calls=len(calls), lanes=n_lanes,
               lanes_per_call=n_lanes / len(calls), mismatched=n_ne,
               plain_at_cap=n_cap, rows_per_lane=rows_read / n_lanes,
               neighbours_per_lane=nbrs_read / n_lanes,
               walk_steps=geo.walk_steps, K=int(geo.neigh.shape[1]),
               dtype=str(geo.sites.dtype), device_us=device_us / len(calls),
               host_us=host_us, plain_ms=plain_ms,
               bound_us=max(t_bytes, t_ops),
               bound_by='bytes' if t_bytes >= t_ops else 'operations',
               bytes_per_call=nbytes / len(calls),
               packed_bytes_per_call=packed / len(calls),
               flops_per_call=flops / len(calls))
    phase('voronoi_locate %s (%d calls, %d lanes, %s sites, walk_steps %d, '
          'K %d): %d cells differ from the plain version (the run\'s and a '
          'relaunch\'s); %d lanes at the cap; %.3f rows and %.2f neighbours '
          'read a lane; device %.2f us per call, host %.2f us per call, '
          'plain %.3f ms, bound %.3f us (%s: %.0f bytes, %.0f flops per '
          'call; over the packed rows %.0f bytes) [%s]'
          % (what, len(calls), n_lanes, out['dtype'], geo.walk_steps,
             out['K'], n_ne, n_cap, out['rows_per_lane'],
             out['neighbours_per_lane'], out['device_us'], host_us,
             plain_ms, out['bound_us'], out['bound_by'],
             out['bytes_per_call'], out['flops_per_call'],
             out['packed_bytes_per_call'], card))
    if n_ne:
        raise AssertionError('voronoi_locate %s: the kernel against its '
                             'plain version: %s' % (what, out))
    return out


def voronoi_cloud_model(n_sites, n_photons, n_iterations, n_imaging,
                        raytracing=RAYTRACING, n_pix=128):
    """Phase 18's model (voronoi_cloud): ``n_sites`` sites drawn from
    config 4's particles inside the +-0.5 pc cube
    (VORONOI_CLOUD['seed']), tessellated by the port's VoronoiGrid, equal
    gas mass per cell (SPH_OCT's 100 Msun in all, dust-to-gas 0.01, the
    dust density m / V), config 4's sources and outputs (:func:`cloud_setup`).
    Returns (model, report of the mesh)."""
    from hyperion_tpu_torch.model import Model
    from hyperion_tpu_torch.transport.gtable_voronoi import dense_neighbours
    from hyperion_tpu_torch.util.constants import msun, pc

    p, centres, which = sph_particles()
    rng = np.random.default_rng(VORONOI_CLOUD['seed'])
    pick = np.sort(rng.choice(p.shape[1], n_sites, replace=False))
    sites, which = p[:, pick], which[pick]
    half = SPH_OCT['half_pc'] * pc
    m = Model()
    m.set_voronoi_grid(*sites, xmin=-half, xmax=half, ymin=-half, ymax=half,
                       zmin=-half, zmax=half)
    t0 = time.time()
    volumes = m.grid.volumes
    t_tess = time.time() - t0
    dust_mass = SPH_OCT['gas_msun'] * msun * SPH_OCT['dust_to_gas']
    rho = np.where(volumes > 0, dust_mass / n_sites / np.maximum(volumes,
                                                                 1e-300), 0)
    cloud_setup(m, rho, centres, which, n_photons, n_iterations, n_imaging,
                raytracing, n_pix)
    _, counts = dense_neighbours(m.grid)
    info = dict(sites=n_sites, tessellation_s=t_tess,
                min_neighbours=int(counts.min()),
                max_neighbours=int(counts.max()),
                mean_neighbours=float(counts.mean()),
                empty_cells=int((volumes <= 0).sum()),
                volume_of_box=float(volumes.sum() / (2 * half) ** 3),
                dust_mass=dust_mass,
                grid_dust_mass=float((rho * volumes).sum()))
    return m, info


def voronoi_lattice_check(card, n, n_photons):
    """tests/test_torch_voronoi.py's lattice oracle on the card: the
    Voronoi grid on the centres of an n^3 lattice over [-1, 1]^3 (cm) has
    the cartesian n^3 grid's cells; one Lucy iteration of n_photons on
    each through transport.lucy.run_lucy in float32, the same gray
    absorbing medium (tau 2.4 across) and point source: the specific
    energies' totals within 0.02 and the 95th percentile of |log10 ratio|
    below 0.08, nothing killed."""
    import torch
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.grid import CartesianGrid, VoronoiGrid
    from hyperion_tpu_torch.sources import PointSource
    from hyperion_tpu_torch.transport.dtable import build_dust_tables
    from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
    from hyperion_tpu_torch.transport.gtable_voronoi import \
        build_voronoi_geometry
    from hyperion_tpu_torch.transport.lucy import run_lucy
    from hyperion_tpu_torch.transport.stable import build_source_tables

    dev, f32 = torch.device('cuda'), torch.float32
    walls = np.linspace(-1.0, 1.0, n + 1)
    c = 0.5 * (walls[1:] + walls[:-1])
    zz, yy, xx = np.meshgrid(c, c, c, indexing='ij')
    t0 = time.time()
    vgrid = VoronoiGrid(xx.ravel(), yy.ravel(), zz.ravel(), xmin=-1.,
                        xmax=1., ymin=-1., ymax=1., zmin=-1., zmax=1.)
    vgeo = build_voronoi_geometry(vgrid, dev, f32)
    t_tess = time.time() - t0
    dust = IsotropicDust(np.logspace(5, 18, 16), np.repeat(0.4, 16),
                         np.repeat(1.0, 16))
    dt = build_dust_tables([dust], dev, f32)
    src = PointSource(luminosity=1.0, temperature=4000.0,
                      position=(0.07, -0.03, 0.02))
    fields, walls_s = {}, {}
    for name, geo in (('vor', vgeo), ('car', build_cartesian_geometry(
            CartesianGrid(walls, walls, walls), dev, f32))):
        st = build_source_tables([src], dev, f32,
                                 length_scale=geo.length_scale)
        density = torch.full((1, geo.n_cells), 1.2 * geo.length_scale,
                             dtype=f32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        t1 = time.time()
        res = run_lucy(geo, dt, st, density, gen, n_photons=n_photons,
                       n_iterations=1, batch_size=131_072, verbose=False)
        walls_s[name] = time.time() - t1
        if res.killed_geo or res.killed_int:
            raise AssertionError('voronoi lattice %s: killed %d/%d'
                                 % (name, res.killed_int, res.killed_geo))
        fields[name] = np.asarray(res.specific_energy[0], float)
    i, j, k = (np.clip(np.searchsorted(walls, q) - 1, 0, n - 1)
               for q in (xx.ravel(), yy.ravel(), zz.ravel()))
    vse = np.zeros(n ** 3)
    vse[(k * n + j) * n + i] = fields['vor']
    cse = fields['car']
    total = float(vse.sum() / cse.sum())
    p95 = float(np.percentile(np.abs(np.log10(vse / cse)), 95))
    out = dict(n=n, photons=n_photons, tessellation_s=t_tess,
               total_ratio=total, p95_abs_log10_ratio=p95,
               lucy_s=walls_s)
    phase('voronoi lattice oracle: %d^3 sites (tessellated in %.3f s) '
          'against the cartesian %d^3 grid, %d photons each: total ratio '
          '%.5f, 95th percentile of |log10 ratio| %.4f; Lucy %.3f s '
          '(Voronoi) and %.3f s (cartesian) [%s]'
          % (n, t_tess, n, n_photons, total, p95, walls_s['vor'],
             walls_s['car'], card))
    if not ((vse > 0).all() and (cse > 0).all() and abs(total - 1) < 0.02
            and p95 < 0.08):
        raise AssertionError('voronoi lattice oracle: %s' % out)
    return out


def voronoi_cloud_phase(dv, et, card, n_sites, n_photons, n_iterations,
                        max_steps, n_imaging, imaging_max_steps):
    """Phase 18: config 4's cloud on a Voronoi mesh
    (:func:`voronoi_cloud_model`) through run_lucy_model on the card in
    float32 (:func:`box_grid_run`'s checks and kernels: killed_geo 0,
    energy_current the photons emitted, the SEDs and images finite and >=
    0, one escape_tau launch in each peel event, no raytraced photon
    outside its cell; deposit_visit on 80 Lucy calls, escape_tau kind 5 on
    the walks of imaging steps 1-20 and 41-60 and escape_column on every
    column call against their plain versions; graph_witness), and:
    killed_int 0 with every Lucy iteration below its step cap; the cells'
    volumes partition the box and the grid's dust mass, the cells' summed
    rho V from the engine's own volumes, is the 1 Msun given; the binned
    SED within 3% of the sources' 1.2e4 Lsun; the locate kernel launched
    on the main path, its cells equal to the plain version's on every call
    of Lucy steps 41-80 (of graph_witness's eager run) and of the
    raytracing pass's positions (:func:`check_locate`), and its lanes at
    the cap counted; then the lattice oracle
    (:func:`voronoi_lattice_check`). Returns ({kernel: launches},
    report)."""
    import torch
    from hyperion_tpu_torch.model.run import build_geometry_tables
    from hyperion_tpu_torch.transport import voronoi_locate as vl

    t0 = time.time()
    m, info = voronoi_cloud_model(n_sites, n_photons, n_iterations,
                                  n_imaging)
    build_s = time.time() - t0
    geo = build_geometry_tables(m.grid, torch.device('cuda'), torch.float64)
    vol = geo.volumes.cpu().numpy() * geo.length_scale ** 3
    rho = np.asarray(m.grid['density'][0].array, float)
    mass_ratio = float((rho * vol).sum()) / info['dust_mass']
    phase('voronoi_cloud: %d sites tessellated in %.3f s on the host (%d to '
          '%d neighbours, mean %.2f; %d empty cells), model in %.3f s; the '
          'volumes sum to %.9f of the box; grid dust mass %.9f of the %.3g '
          'g given [%s]'
          % (n_sites, info['tessellation_s'], info['min_neighbours'],
             info['max_neighbours'],
             info['mean_neighbours'], info['empty_cells'], build_s,
             info['volume_of_box'], mass_ratio, info['dust_mass'], card))
    if abs(info['volume_of_box'] - 1) > 1e-6 or abs(mass_ratio - 1) > 1e-6 \
            or info['empty_cells']:
        raise AssertionError('voronoi_cloud: the mesh: %s, mass ratio %r'
                             % (info, mass_ratio))
    with locate_calls(40, 80) as lcalls:
        launches, run, out = box_grid_run(
            'voronoi_cloud', 'voronoi', dv, et, card, m, n_photons,
            n_imaging, max_steps, imaging_max_steps,
            more_kernels=dict(voronoi_locate=vl), wrap_step=lcalls['wrap'])
    engine_locators = [loc for loc in lcalls['locators'] if loc._cuda and
                       loc.dtype == torch.float32]
    at_cap = sum(loc.lanes_at_cap() for loc in engine_locators)
    res, img = run.result, run.imaging
    if res.killed_int or any(r['steps'] >= max_steps
                             for r in out['iterations']):
        raise AssertionError('voronoi_cloud Lucy: killed_int %d, steps %s '
                             '(cap %d)' % (res.killed_int,
                                           [r['steps'] for r in
                                            out['iterations']], max_steps))
    total = binned_lsun(img)
    phase('voronoi_cloud: binned SED over all directions %.2f Lsun of the '
          'sources\' %.0f (%.5f); voronoi_locate %d launches on the main '
          'path, %d lanes at the cap (walk_steps %d) [%s]'
          % (total, SPH_OCT['luminosity_lsun'],
             total / SPH_OCT['luminosity_lsun'], launches['voronoi_locate'],
             at_cap, geo.walk_steps, card))
    if abs(total / SPH_OCT['luminosity_lsun'] - 1.0) > 0.03:
        raise AssertionError('voronoi_cloud: the binned SED holds %.1f Lsun '
                             'of the sources\' %.0f'
                             % (total, SPH_OCT['luminosity_lsun']))
    locate = [check_locate('voronoi_cloud Lucy steps 41-80', lcalls['lucy'],
                           card),
              check_locate('voronoi_cloud raytracing positions',
                           lcalls['raytracing'], card)]
    lattice = voronoi_lattice_check(card, **VORONOI_LATTICE)
    out.update(model_build_s=build_s, mesh=info,
               grid_to_given_dust_mass=mass_ratio, binned_lsun=total,
               locate=locate, locate_lanes_at_cap=at_cap, lattice=lattice,
               cut=dict(out['cut'], n_iterations=n_iterations,
                        n_sites=n_sites))
    return launches, out


def voronoi_kernels(vor, launches):
    """The kernels line of ``--voronoi``: each kernel on phase 18's own
    calls and its launches there."""
    t = vor['deposit_visit']['timing']
    w, c = vor['walks'][0], vor['columns']
    return [
        dict(name='deposit_visit', route='cuda', source=KERNEL_SOURCE,
             replaces=REPLACES, launches=launches['deposit_visit'],
             max_abs_err=vor['deposit_visit']['max_abs_err'],
             ms=t['device_us'] / 1e3, plain_ms=t['plain_ms'],
             bound_ms=t['bound_us'] / 1e3, bound_by='bytes',
             library_ms=t['library_ms']),
        dict(name='escape_tau', route='cuda', source=ESCAPE_TAU_SOURCE,
             replaces=ESCAPE_TAU_REPLACES, launches=launches['escape_tau'],
             max_abs_err=max(x['f32_vs_plain32_max_abs_err']
                             for x in vor['walks']),
             ms=w['device_us'] / 1e3, plain_ms=w['plain_ms'],
             bound_ms=w['bound_us'] / 1e3, bound_by=w['bound_by'],
             library_ms=None,
             f64_max_rel_err=max(x['f64_max_rel_err'] for x in vor['walks'])),
        dict(name='escape_column', route='cuda', source=ESCAPE_TAU_SOURCE,
             replaces=ESCAPE_COLUMN_REPLACES,
             launches=launches['escape_column'],
             max_abs_err=c['f32_vs_plain32_max_abs_err'],
             ms=c['device_us'] / 1e3, plain_ms=c['plain_ms'],
             bound_ms=c['bound_us'] / 1e3, bound_by=c['bound_by'],
             library_ms=None, f64_max_rel_err=c['f64_max_rel_err']),
        locate_kernel(vor, launches['voronoi_locate'])]


def locate_kernel(vor, n_launches):
    """The kernels line's voronoi_locate entry: phase 18's Lucy calls as
    the headline, the raytracing positions' beside them. Its max_abs_err
    counts the cells that differ from the plain version's."""
    loc = vor['locate'][0]
    return dict(
        name='voronoi_locate', route='cuda', source=VORONOI_LOCATE_SOURCE,
        replaces=VORONOI_LOCATE_REPLACES, launches=n_launches,
        max_abs_err=float(max(r['mismatched'] for r in vor['locate'])),
        ms=loc['device_us'] / 1e3, plain_ms=loc['plain_ms'],
        bound_ms=loc['bound_us'] / 1e3, bound_by=loc['bound_by'],
        library_ms=None, device_us=loc['device_us'], host_us=loc['host_us'],
        bound_us=loc['bound_us'], lanes_at_cap=vor['locate_lanes_at_cap'],
        calls=[{k: r[k] for k in ('run', 'calls', 'lanes_per_call',
                                  'device_us', 'host_us', 'plain_ms',
                                  'bound_us', 'bound_by', 'rows_per_lane',
                                  'plain_at_cap')}
               for r in vor['locate']])


# ------------------------------------------------------ ranks (phase 19) --

def _jsonable(obj):
    """numpy values in a record, for json.dumps."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(type(obj).__name__)


def _mesh_numbers(stats, steps=None, iterations=None):
    """The collectives' and ring's host-clock numbers of a rank's
    ``mesh.stats`` (µs per collective, per step or iteration; hops, bytes
    and µs per hop)."""
    out = dict(collectives=stats['collectives'],
               collective_us=stats['collective_s'] * 1e6 /
               max(stats['collectives'], 1),
               hops=stats['hops'])
    if steps:
        out['collective_us_per_step'] = stats['collective_s'] * 1e6 / steps
    if iterations:
        out['collective_us_per_iteration'] = \
            stats['collective_s'] * 1e6 / iterations
    if stats['hops']:
        out.update(bytes_per_hop=stats['hop_bytes'] / stats['hops'],
                   us_per_hop=stats['hop_s'] * 1e6 / stats['hops'])
    return out


def dryrun_tables(device):
    """__graft_entry__.dryrun_multichip's sharded-grid workload on the port,
    float32: the toy dust (albedo 0.3, chi 1) and 5000 K point source, 8^3
    cells over +-1 of density 4 (engine units; thick), a specific energy of
    1e-2 everywhere and MRW at gamma 2."""
    import torch
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.grid import CartesianGrid
    from hyperion_tpu_torch.sources import PointSource
    from hyperion_tpu_torch.transport.dtable import build_dust_tables
    from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
    from hyperion_tpu_torch.transport.lucy import compute_jnu_var
    from hyperion_tpu_torch.transport.mrw import prepare_mrw_tables
    from hyperion_tpu_torch.transport.stable import build_source_tables
    f32 = torch.float32
    nu = np.logspace(5, 18, 16)
    dust = IsotropicDust(nu, np.repeat(0.3, 16), np.repeat(1.0, 16))
    grid = CartesianGrid(*[np.linspace(-1, 1, 9)] * 3)
    geometry = build_cartesian_geometry(grid, device, f32)
    dt = build_dust_tables([dust], device, f32)
    st = build_source_tables([PointSource(luminosity=1.0, temperature=5000.0)],
                             device, f32, length_scale=geometry.length_scale)
    density = torch.full((1, grid.n_cells), 4.0, dtype=f32, device=device)
    se = torch.full_like(density, 1e-2)
    jid, jfrac = compute_jnu_var(dt, se)
    mrw = prepare_mrw_tables(dt, density, se, 2.0)
    return (geometry, dt, st, density, jid, jfrac), mrw


def parallel_rank():
    """Phase 19 on each rank (``chip_smoke:parallel_rank``, started by
    hyperion_tpu_torch.parallel.launch): (a) the tutorial at phase 4's size
    through run_lucy_model, rank 0 recording its first 20 eager
    deposit_visit calls (:func:`deposit_calls`; each iteration's first
    step runs eagerly before its graph's capture); (b) one Lucy iteration of it with the grid cut into slabs; (c)
    the dryrun's thick MRW 8^3 case, slab-sharded. Returns this rank's
    records (the launcher returns rank 0's)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model
    from hyperion_tpu_torch.parallel import mesh
    from hyperion_tpu_torch.parallel.spatial import \
        run_lucy_iteration_spatial
    from hyperion_tpu_torch.transport import deposit_visit as dv
    from hyperion_tpu_torch.transport import engine
    from hyperion_tpu_torch.transport import escape_tau as et
    group = mesh.active_group()
    device = group.device
    out = dict(t_start=time.time(), rank=group.rank, world=group.world,
               backend=group.backend, device=str(device))

    # (a) the tutorial, photon-parallel
    m = tutorial_model()
    dv.launches = 0
    et.launches = 0
    engine.reset_step_counts()
    mesh.reset_stats()
    t0 = time.time()
    with deposit_calls(dv, 0, 20 if group.rank == 0 else 0) as calls:
        run = run_lucy_model(m, device=device, parallel=group.world)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_dv, n_et = dv.launches, et.launches
    counts = dict(engine.step_counts)
    stats = dict(mesh.stats)
    sed = run.imaging.peeled[0]['datasets']['seds'][0][0, 0, 0, 0]
    out['a'] = dict(
        wall_s=wall, rows=[dict(r) for r in run.perf.rows],
        deposit_visit_launches=n_dv, escape_tau_launches=n_et,
        step_counts=counts,
        iterations=run.result.iterations,
        temperature=run.result.temperature[0],
        band=float(sed.sum()) * np.log(1000.0 / 0.3) / 60,
        image_sum=float(run.imaging.peeled[0]['datasets']['images'][0]
                        .sum()),
        imaging_energy=run.imaging.energy_current,
        imaging_killed=run.imaging.killed_int,
        mesh=_mesh_numbers(stats, iterations=run.result.iterations + 1))
    if group.rank == 0:
        out['a']['deposit_visit_calls'] = len(calls)
        out['a']['deposit_visit_max_abs_err'] = check_calls(
            dv, calls, 1, TUTORIAL[1], device, 'phase 19 rank 0 calls')

    # (b) one iteration with the grid cut into slabs
    m = tutorial_model()
    m.set_n_initial_iterations(1)
    m.peeled_output = []
    m.set_n_photons(initial=500_000, imaging=0)
    mesh.reset_stats()
    t0 = time.time()
    run = run_lucy_model(m, device=device, parallel=group.world,
                         shard_grid=True)
    torch.cuda.synchronize()
    row = dict(run.perf.rows[0])
    out['b'] = dict(wall_s=time.time() - t0, row=row,
                    se1=run.iterations[0]['specific_energy'],
                    mesh=_mesh_numbers(mesh.stats, steps=row['steps']))

    # (c) the dryrun's thick MRW case, slab-sharded
    tables, mrw = dryrun_tables(device)
    config = dict(n_inter_max=1000, kill_on_scatter=False,
                  kill_on_absorb=False, max_steps=5000, n_reabs_max=0,
                  n_mrw_max=100000)
    n_photons = group.world * 256
    gen = mesh.rank_generator(1, mesh.STREAM_LUCY, device, group)
    mesh.reset_stats()
    t0 = time.time()
    energy_sum, energy_current, _, killed, n_steps, _ = \
        run_lucy_iteration_spatial(group, *tables, gen, n_photons, 128,
                                   config, mrw=mrw)
    torch.cuda.synchronize()
    out['c'] = dict(wall_s=time.time() - t0, n_photons=n_photons,
                    energy_sum=energy_sum.double().cpu().numpy(),
                    energy_current=float(energy_current),
                    killed_int=int(killed), steps=n_steps,
                    mesh=_mesh_numbers(mesh.stats, steps=n_steps))
    return out


def _slab_sums(per_cell, world):
    """Each rank's slab's sum of a (n_cells,) array (the ranks' cut: the
    cell axis padded to a multiple of the world)."""
    n = per_cell.shape[-1]
    padded = np.zeros(n + (-n) % world)
    padded[:n] = per_cell
    return padded.reshape(world, -1).sum(axis=1)


def parallel_phase(card, ref):
    """Phase 19: two ranks sharing the card (gloo through host memory),
    started by the port's launcher; ``ref`` is phase 4's single-rank run
    (run_slice). Returns (rank 0's deposit_visit launches, escape_tau
    launches, record)."""
    from hyperion_tpu_torch.parallel import mesh
    from hyperion_tpu_torch.parallel.launch import launch
    from hyperion_tpu_torch.util.constants import lsun
    group = mesh.resolve_group(2, 'cuda')
    t0 = time.time()
    r = launch(group, 'chip_smoke:parallel_rank')
    wall = time.time() - t0
    rec = dict(world=r['world'], backend=r['backend'], device=r['device'],
               launcher_startup_s=r['t_start'] - t0, wall_s=wall)
    phase('parallel: %d ranks on %s over %s, launcher start-up %.3f s '
          '[%s]' % (r['world'], r['device'], r['backend'],
                    rec['launcher_startup_s'], card))

    # (a) the tutorial, photon-parallel, against phase 4
    a = r['a']
    n_lucy = 0
    for i, row in enumerate(a['rows'][:4], 1):
        if (row['killed_geo'], row['killed_int']) != (0, 0) or \
                row['energy_current'] != 500_000:
            raise AssertionError('parallel (a) iteration %d: killed %s, '
                                 'energy_current %r'
                                 % (i, (row['killed_geo'], row['killed_int']),
                                    row['energy_current']))
        n_lucy += row['steps']
        phase('parallel (a) iteration %d: %.3f s, %.0f photons/s, %d steps '
              '(the ranks\' most), %.3f ms per step [%s]'
              % (i, row['wall'], row['photons'] / row['wall'], row['steps'],
                 row['wall'] * 1e3 / row['steps'], card))
    if a['iterations'] != 4 or len(a['rows']) != 5:
        raise AssertionError('parallel (a) ran %d iterations'
                             % a['iterations'])
    img = a['rows'][4]
    if a['imaging_energy'] != 1_000_000 or a['imaging_killed']:
        raise AssertionError('parallel (a) imaging: energy_current %r, '
                             'killed %d' % (a['imaging_energy'],
                                            a['imaging_killed']))
    temp = a['temperature']
    dusty = ref['dusty']
    if not np.isfinite(temp).all() or not (temp[dusty] > 0).all():
        raise AssertionError('parallel (a): temperatures not finite and > 0 '
                             'in dusty cells')
    expected = lsun * band_fraction(6000.0, 0.3, 1000.0)
    if abs(a['band'] / expected - 1.0) > 0.02:
        raise AssertionError('parallel (a): peeled band luminosity %.6e '
                             'against %.6e expected' % (a['band'], expected))
    t_ratio = float(np.median(temp[dusty] / ref['temperature'][dusty]))
    if abs(t_ratio - 1.0) > 0.01:
        raise AssertionError('parallel (a): median temperature ratio %.5f '
                             'against phase 4' % t_ratio)
    c = a['step_counts']
    if a['deposit_visit_calls'] != min(20, 2 * c['eager']):
        raise AssertionError('parallel (a): rank 0 recorded %d deposit_visit '
                             'calls of %d eager steps'
                             % (a['deposit_visit_calls'], c['eager']))
    # rank 0's own steps are at most the ranks' most; two calls a step (its
    # masked refill's and its own), counted by the wrapper for the steps
    # run eagerly or captured into a graph, and a flush an iteration
    if not 0 < a['deposit_visit_launches'] == 2 * (
            c['eager'] + c['captured']) + a['iterations'] or \
            not c['replays'] or c['reads'] > n_lucy or \
            not a['escape_tau_launches']:
        raise AssertionError('parallel (a): rank 0 launched deposit_visit '
                             '%d times, step counts %s over at most %d '
                             'steps, escape_tau %d times'
                             % (a['deposit_visit_launches'], c, n_lucy,
                                a['escape_tau_launches']))
    phase('parallel (a) imaging: %d photons in %.3f s, %d steps, %.3f '
          'ms per step; band luminosity %.5f x expected; median T / phase '
          '4\'s %.5f; rank 0: deposit_visit launches %d (%d graph replays '
          'of %d steps), escape_tau %d, its first %d eager deposit_visit '
          'calls equal to the plain version (max abs err %.3e); collectives '
          '%d, %.1f us each, %.1f us per iteration; wall %.3f s [%s]'
          % (img['photons'], img['wall'], img['steps'],
             img['wall'] * 1e3 / img['steps'], a['band'] / expected, t_ratio,
             a['deposit_visit_launches'], c['replays'], c['replayed'],
             a['escape_tau_launches'], a['deposit_visit_calls'],
             a['deposit_visit_max_abs_err'],
             a['mesh']['collectives'], a['mesh']['collective_us'],
             a['mesh']['collective_us_per_iteration'], a['wall_s'], card))
    rec['a'] = dict({k: v for k, v in a.items() if k != 'temperature'},
                    band_ratio=a['band'] / expected,
                    median_temperature_ratio=t_ratio)

    # (b) the grid cut into slabs, against phase 4's first iteration
    b = r['b']
    row = b['row']
    if (row['killed_geo'], row['killed_int']) != (0, 0) or \
            row['energy_current'] != 500_000:
        raise AssertionError('parallel (b): killed %s, energy_current %r'
                             % ((row['killed_geo'], row['killed_int']),
                                row['energy_current']))
    se, se_ref = b['se1'][0], ref['se1'][0]
    slabs = _slab_sums(se, r['world'])
    total = float(se.sum() / se_ref.sum())
    sel = se_ref > np.percentile(se_ref, 60)
    median = float(np.median(se[sel] / se_ref[sel]))
    if not (slabs > 0).all() or abs(total - 1.0) > 0.02 or \
            abs(median - 1.0) > 0.05:
        raise AssertionError('parallel (b): slabs %s, total %.5f and median '
                             '%.5f of phase 4\'s first iteration'
                             % (slabs, total, median))
    mb = b['mesh']
    phase('parallel (b) slabs: %d photons in %.3f s, %.0f photons/s, %d '
          'steps, %.3f ms per step; deposits %.5f x phase 4\'s first '
          'iteration, median per cell %.5f; %d ring hops of %.0f bytes, %.1f '
          'us per hop; %.1f us of collectives per step [%s]'
          % (row['photons'], row['wall'], row['photons'] / row['wall'],
             row['steps'], row['wall'] * 1e3 / row['steps'], total, median,
             mb['hops'],
             mb['bytes_per_hop'], mb['us_per_hop'],
             mb['collective_us_per_step'], card))
    rec['b'] = dict(row=row, total_ratio=total, median_ratio=median,
                    slabs=slabs.tolist(), mesh=mb, wall_s=b['wall_s'])

    # (c) the dryrun's thick MRW case, slab-sharded
    c = r['c']
    slabs = _slab_sums(c['energy_sum'].sum(axis=0), r['world'])
    if c['energy_current'] != c['n_photons'] or not (slabs > 0).all():
        raise AssertionError('parallel (c): energy_current %r of %d, slabs %s'
                             % (c['energy_current'], c['n_photons'], slabs))
    mc = c['mesh']
    phase('parallel (c) thick MRW 8^3: %d photons in %.3f s, %d steps, '
          '%.3f ms per step, killed_int %d, slabs %s; %d ring hops of %.0f '
          'bytes, %.1f us per hop; %.1f us of collectives per step [%s]'
          % (c['n_photons'], c['wall_s'], c['steps'],
             c['wall_s'] * 1e3 / c['steps'], c['killed_int'], slabs,
             mc['hops'], mc['bytes_per_hop'], mc['us_per_hop'],
             mc['collective_us_per_step'], card))
    rec['c'] = dict({k: v for k, v in c.items() if k != 'energy_sum'},
                    slabs=slabs.tolist())
    return a['deposit_visit_launches'], a['escape_tau_launches'], rec


def graph_phase(card):
    """``--graph``: each geometry's first Lucy iteration both ways
    (:func:`graph_witness`) on the models of phases 4, 8, 14, 16, 17 and
    18, built here and run only up to their first iteration's start; then
    each one's imaging iteration both ways (:func:`imaging_witness`) from
    a zero specific energy, and phase 12's monochromatic source pass (no
    specific energy, so no dust pass)."""
    models = [('tutorial', lambda: tutorial_model(), None, 'tutorial'),
              ('class2', lambda: class2_model(
                  CLASS2_CUT['n_photons'], 1, CLASS2_CUT['n_imaging']), None,
               'class2'),
              ('class1_cyl', lambda: class1_cyl_model(
                  n_photons=CLASS1_CYL_CUT['n_photons'],
                  n_imaging=CLASS1_CYL_CUT['n_imaging']), None, 'box'),
              ('sph_octree', lambda: sph_octree_model(
                  SPH_OCT_CUT['n_photons'], 1,
                  SPH_OCT_CUT['n_imaging'])[0], None, 'box'),
              ('orion_amr', lambda: orion_amr_model(
                  AMR_CUT['n_photons'], 1, AMR_CUT['n_imaging'])[0],
               AMR_CUT['batch_size'], 'box'),
              ('voronoi_cloud', lambda: voronoi_cloud_model(
                  VORONOI_CLOUD['n_sites'], VORONOI_CUT['n_photons'], 1,
                  VORONOI_CUT['n_imaging'])[0], None, 'box')]
    from hyperion_tpu_torch.model import run_lucy_model
    for what, make, batch, cut in models:
        t0 = time.time()
        model = make()
        first = first_iteration_args(model, batch_size=batch)
        phase('%s: model and tables in %.1f s' % (what, time.time() - t0))
        graph_witness(what, first, GRAPH_WITNESS_STEPS[cut], card)
        # the imaging iteration from a zero specific energy
        model.set_n_initial_iterations(0)
        with first_imaging(stop=True) as rec:
            run_lucy_model(model, device='cuda', batch_size=batch)
        imaging_witness(what, rec, IMAGING_WITNESS_STEPS[cut], card)
    with first_mono_pass('source', stop=True) as rec:
        run_lucy_model(mono_model(None, False), device='cuda')
    imaging_witness('mono source', rec, None, card, mono=True)


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
    ap.add_argument('--hierarchical', action='store_true',
                    help='run only phases 1, 2, 16 and 17 (BASELINE configs '
                    '4 and 5, with their parts of phases 6, 10 and 13)')
    ap.add_argument('--voronoi', action='store_true',
                    help='run only phases 1, 2 and 18 (config 4\'s cloud on '
                    'a Voronoi mesh, with its parts of phases 6, 10 and 13 '
                    'and the locate kernel)')
    ap.add_argument('--parallel', action='store_true',
                    help='run only phases 1, 2 and 19 (two ranks sharing the '
                    'card), with phase 4\'s single-rank run as its '
                    'reference')
    ap.add_argument('--graph', action='store_true',
                    help='run only phases 1 and 2, the captured torch.rand '
                    'check and each geometry\'s first Lucy iteration both '
                    'ways, the eager step loop and the CUDA graph (the '
                    'graph_witness checks of phases 4, 8, 14 and 16-18, '
                    'on models built here)')
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

    # 2. build the libraries, one nvcc each, all at once
    t0 = time.time()
    libs = _build.build('deposit_visit', 'escape_tau', 'voronoi_locate',
                        'octree_locate', 'cond_node')
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
    launches = dict(deposit_visit={}, escape_tau={}, escape_column={},
                    voronoi_locate={}, octree_locate={})

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

    def hierarchical_phases():
        """Phases 16 and 17; returns their reports."""
        out = []
        for n, name, fn, cut in ((16, 'sph_octree', sph_octree_phase,
                                  SPH_OCT_CUT),
                                 (17, 'orion_amr', orion_amr_phase, AMR_CUT)):
            got, rec = run_phase(n, fn, dv, et, card, **cut)
            for kernel, count in got.items():
                launches[kernel][name] = count
            record[name] = rec
            out.append(rec)
        return out

    def voronoi_phase():
        """Phase 18; returns its report."""
        got, vor = run_phase(18, voronoi_cloud_phase, dv, et, card,
                             VORONOI_CLOUD['n_sites'], **VORONOI_CUT)
        for kernel, count in got.items():
            launches[kernel]['voronoi_cloud'] = count
        record['voronoi_cloud'] = vor
        return vor

    def parallel_phase_19(ref):
        """Phase 19; returns its report."""
        launches['deposit_visit']['parallel'], \
            launches['escape_tau']['parallel'], rec = run_phase(
                19, parallel_phase, card, ref)
        record['parallel'] = rec
        return rec

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

    if args.graph:
        record['graph_rand'] = graph_rand_check(card)
        graph_phase(card)
        record['graph_witness'] = GRAPH_WITNESS
        record['imaging_witness'] = IMAGING_WITNESS
        (OUT / 'graph.json').write_text(json.dumps(record, indent=1,
                                                   default=_jsonable))
        print(json.dumps({name: {
            k: {f: v[f] for f in ('steps', 'eager_ms_per_step',
                                  'graph_ms_per_step', 'speedup')}
            for k, v in reps.items()} for name, reps in (
                ('graph_witness', GRAPH_WITNESS),
                ('imaging_witness', IMAGING_WITNESS))}), flush=True)
        print(result_line, flush=True)
        return 0

    if args.cylindrical:
        cyl = cylindrical_phases()
        (OUT / 'cylindrical.json').write_text(json.dumps(record, indent=1))
        kernels = cylindrical_kernels(cyl, launches)
        print(json.dumps({'kernels': kernels}), flush=True)
        print(result_line, flush=True)
        return 0

    if args.hierarchical:
        boxes = hierarchical_phases()
        (OUT / 'hierarchical.json').write_text(json.dumps(record, indent=1))
        kernels = hierarchical_kernels(boxes, launches)
        print(json.dumps({'kernels': kernels}), flush=True)
        print(result_line, flush=True)
        return 0

    if args.voronoi:
        vor = voronoi_phase()
        (OUT / 'voronoi.json').write_text(json.dumps(record, indent=1))
        kernels = voronoi_kernels(vor, {k: v['voronoi_cloud']
                                        for k, v in launches.items()
                                        if 'voronoi_cloud' in v})
        print(json.dumps({'kernels': kernels}), flush=True)
        print(result_line, flush=True)
        return 0

    if args.parallel:
        # 4 for its single-rank reference, then 19
        *_, ref4 = run_phase(4, run_slice, dv, et, card)
        parallel_phase_19(ref4)
        (OUT / 'parallel.json').write_text(json.dumps(record, indent=1,
                                                      default=_jsonable))
        for name in ('deposit_visit', 'escape_tau'):
            if not all(launches[name].values()):
                raise AssertionError('%s was not launched on the main path: '
                                     '%s' % (name, launches[name]))
        print(json.dumps({'parallel': {k: record['parallel'][k] for k in (
            'world', 'backend', 'launcher_startup_s', 'wall_s')}}),
            flush=True)
        print(result_line, flush=True)
        return 0

    if args.raytracing:
        # 4 and 8 for their specific energies, then 11-13
        *_, se4, _ = run_phase(4, run_slice, dv, et, card)
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

    # 4. the slice, through the kernels (after the check that a captured
    # torch.rand draws what the eager one draws)
    record['graph_rand'] = graph_rand_check(card)
    launches['deposit_visit']['tutorial'], launches['escape_tau']['tutorial'], \
        iterations, wall, img, se4, ref4 = run_phase(4, run_slice, dv, et,
                                                     card)
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

    # 16-17. BASELINE configs 4 (octree) and 5 (AMR), with their own calls
    # of phases 6, 10 and 13's checks
    boxes = hierarchical_phases()
    for box in boxes:
        walks = walks + box['walks']
        cols = cols + [box['columns']]

    # 18. config 4's cloud on a Voronoi mesh, with its own calls of phases
    # 6, 10 and 13's checks and of the locate kernel
    vor = voronoi_phase()
    walks = walks + vor['walks']
    cols = cols + [vor['columns']]

    # 19. two ranks sharing the card: the tutorial photon-parallel, and
    # the Lucy iteration with the grid cut into slabs
    parallel_phase_19(ref4)
    phase('phases 3-19 in %.1f s' % (time.time() - t_start))

    record['launches'] = launches
    record['graph_witness'] = GRAPH_WITNESS
    record['imaging_witness'] = IMAGING_WITNESS
    record['step_counts'] = STEP_COUNTS
    record['wall_s'] = time.time() - t_start
    (OUT / 'results.json').write_text(json.dumps(record, indent=1,
                                                 default=_jsonable))
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
                    max_abs_err=max([max_err, yso_err,
                                     cyl['deposit_visit']['max_abs_err']] +
                                    [b['deposit_visit']['max_abs_err']
                                     for b in boxes + [vor]]),
                    ms=t['device_us'] / 1e3,
                    plain_ms=t['plain_ms'], bound_ms=t['bound_us'] / 1e3,
                    bound_by='bytes', library_ms=t['library_ms'],
                    device_us=t['device_us'], host_us=t['host_us'],
                    bound_us=t['bound_us'],
                    launches_by_phase=launches['deposit_visit'],
                    lucy_step_counts=STEP_COUNTS,
                    yso_device_us=yso_t['device_us'],
                    yso_host_us=yso_t['host_us'],
                    yso_bound_us=yso_t['bound_us'],
                    yso_plain_ms=yso_t['plain_ms'],
                    yso_library_ms=yso_t['library_ms'],
                    yso_contention=yso_hot,
                    class1_cyl=cyl['deposit_visit']['timing'],
                    sph_octree=boxes[0]['deposit_visit']['timing'],
                    orion_amr=boxes[1]['deposit_visit']['timing'],
                    voronoi_cloud=vor['deposit_visit']['timing']),
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
               column_kernel(cols),
               locate_kernel(vor, sum(launches['voronoi_locate'].values())),
               octree_locate_kernel(boxes[0],
                                    sum(launches['octree_locate'].values()))]
    record['kernels'] = kernels
    (OUT / 'results.json').write_text(json.dumps(record, indent=1,
                                                 default=_jsonable))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(result_line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
