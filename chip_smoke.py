#!/usr/bin/env python3
"""Smoke run of hyperion_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card and the software: name and power limit, torch, CUDA, nvcc;
2. build the deposit_visit kernel from hyperion_tpu_torch/transport/csrc;
3. the kernel against its plain PyTorch version at the main path's shapes,
   over 8 steps of carried state: counts and uids equal, float32 energies
   within rtol 1e-4 of a float64 plain run (float32 atomics add in a
   run-dependent order); median time per call of both, interleaved;
4. the slice: examples/quickstart.py without its peeled image (32^3 cells,
   4 Lucy iterations of 500,000 photons) built through the public Model API
   and run on the card by run_lucy_model, the port's run_model without the
   .rtout file (the card's machine has no h5py; the tests check the file on
   the CPU); the kernel's launch count is reset just before and read just
   after;
5. physics on the card in float32: the optically thin inverse-square check
   of tests/test_engine_lucy.py, one iteration of bench.py's quickstart
   configuration, and the host synchronisations per step.

It ends with a JSON line of the kernels, then the result line
{"ok": true, "device": {...}}. Longer records go to chip_smoke_out/.
It needs no network and imports nothing of JAX.
"""

import importlib.util
import json
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / 'chip_smoke_out'
KERNEL_SOURCE = 'hyperion_tpu_torch/transport/csrc/deposit_visit.cu'
REPLACES = 'hyperion_tpu/transport/pallas_ops.py:116'
# (B, n_cells): bench.py's quickstart (15^3 cells, 131,072 lanes) and the
# tutorial (32^3 cells, run.py's batch for 500,000 photons)
SHAPES = [(131072, 3375), (125000, 32768)]
TIMED_SHAPE = (125000, 32768, 1)


def phase(msg):
    print('[chip_smoke] ' + msg, flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def step_inputs(rng, B, n_cells, n_dust, device):
    """One step's lanes: ~30% deposit into and enter one busy cell (a
    refill), ~40% sit in the drop slot, a fifth of the deposits are masked,
    and uids come from a pool smaller than B, so they repeat across steps."""
    import torch
    busy = int(rng.integers(0, n_cells))
    cell_dep = rng.integers(0, n_cells, B)
    cell_dep[rng.random(B) < 0.3] = busy
    dep = rng.exponential(1.0, (n_dust, B)).astype(np.float32)
    dep[:, rng.random(B) < 0.2] = 0.0
    enter = rng.integers(0, n_cells, B)
    r = rng.random(B)
    enter[r < 0.3] = busy
    enter[(r >= 0.3) & (r < 0.7)] = n_cells
    uid = rng.integers(0, B // 2, B)
    return [torch.as_tensor(a, device=device) for a in (
        cell_dep.astype(np.int32), dep, enter.astype(np.int32),
        uid.astype(np.int32))]


def check_kernel(dv, B, n_cells, n_dust, device, seed):
    """8 carried steps through the kernel and through the plain version in
    float64; then the median time per call of each, interleaved plain,
    kernel, kernel, plain. Returns a dict of the results."""
    import torch
    rng = np.random.default_rng(seed)
    es = torch.zeros((n_dust, n_cells), device=device)
    npc = torch.zeros(n_cells, dtype=torch.int64, device=device)
    luid = torch.full((n_cells + 1,), -2, dtype=torch.int32, device=device)
    win = dv.new_visit_scratch(n_cells, device)
    es64, npc_p, luid_p = es.double(), npc.clone(), luid.clone()
    for _ in range(8):
        cd, dep, enter, uid = step_inputs(rng, B, n_cells, n_dust, device)
        dv.deposit_visit(es, npc, luid, win, cd, dep, enter, uid)
        dv.deposit_visit_reference(es64, npc_p, luid_p, cd, dep.double(),
                                   enter, uid)
    torch.cuda.synchronize()
    if not torch.equal(npc, npc_p):
        raise AssertionError('visit counts differ from the plain version')
    if not torch.equal(luid, luid_p):
        raise AssertionError('last uids differ from the plain version')
    if not torch.equal(win, dv.new_visit_scratch(n_cells, device)):
        raise AssertionError('the scratch table was not reset')
    err = (es.double() - es64).abs()
    if not bool((err <= 1e-4 * es64.abs()).all()):
        raise AssertionError('energies beyond rtol 1e-4: worst rel %g'
                             % float((err / es64.abs().clamp_min(1e-30))
                                     .max()))

    # timing on fresh float32 state, the same step inputs for both
    cd, dep, enter, uid = step_inputs(rng, B, n_cells, n_dust, device)
    tables = {name: (torch.zeros((n_dust, n_cells), device=device),
                     torch.zeros(n_cells, dtype=torch.int64, device=device),
                     torch.full((n_cells + 1,), -2, dtype=torch.int32,
                                device=device))
              for name in ('kernel', 'plain')}

    def call(name):
        e, n, lu = tables[name]
        if name == 'kernel':
            dv.deposit_visit(e, n, lu, win, cd, dep, enter, uid)
        else:
            dv.deposit_visit_reference(e, n, lu, cd, dep, enter, uid)

    for name in ('plain', 'kernel', 'kernel', 'plain'):
        call(name)
    times = {'kernel': [], 'plain': []}
    for _ in range(10):
        for name in ('plain', 'kernel', 'kernel', 'plain'):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            call(name)
            t1.record()
            t1.synchronize()
            times[name].append(t0.elapsed_time(t1))
    return dict(B=B, n_cells=n_cells, n_dust=n_dust,
                max_abs_err=float(err.max()),
                ms=float(np.median(times['kernel'])),
                plain_ms=float(np.median(times['plain'])))


def tutorial_model():
    """examples/quickstart.py without its peeled image, with a fixed seed."""
    from hyperion_tpu.dust import IsotropicDust
    from hyperion_tpu.model import Model
    from hyperion_tpu.util.constants import au, lsun
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
    m.set_n_initial_iterations(4)
    m.set_n_photons(initial=500_000, imaging=0)
    m.set_seed(20261016)
    return m


def run_slice(dv, card):
    """Phase 4: the tutorial through run_lucy_model, the port's run_model
    without its .rtout file. Returns (launches, per-iteration rows, wall)."""
    import torch
    from hyperion_tpu_torch.model.run import run_lucy_model

    m = tutorial_model()
    dv.launches = 0
    t0 = time.time()
    run = run_lucy_model(m, device='cuda')
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dv.launches

    temp = run.result.temperature[0]
    dusty = run.density0[0] > 0
    if not np.isfinite(temp).all() or not (temp[dusty] > 0).all():
        raise AssertionError('temperatures not finite and > 0 in dusty cells')
    if run.result.iterations != 4 or len(run.perf.rows) != 4:
        raise AssertionError('ran %d iterations' % run.result.iterations)
    steps = 0
    for i, row in enumerate(run.perf.rows, 1):
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
    phase('slice: 4 x 500000 photons in %.3f s wall (run_lucy_model), T %.1f '
          '.. %.1f K, deposit_visit launches %d over %d steps [%s]'
          % (wall, temp[dusty].min(), temp.max(), launches, steps, card))
    return launches, [dict(row) for row in run.perf.rows], wall


def physics_on_card(card):
    """Phase 5: the thin inverse-square check, bench.py's quickstart
    configuration, and the host synchronisations per step."""
    import torch
    from hyperion_tpu.dust import IsotropicDust
    from hyperion_tpu.grid import CartesianGrid
    from hyperion_tpu.sources import PointSource
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
    return med, bench


class _NoHDF5(types.ModuleType):
    """Stands in for h5py where it is not installed. The card's machine has
    neither h5py nor libhdf5. The shared front end imports h5py at module
    level in hyperion_tpu/grid/grid_on_disk.py, and the grid classes test
    quantities with isinstance(..., h5py.ExternalLink); otherwise it uses
    h5py only to read and write files, which this script never does. No
    HDF5 link can exist here, so ExternalLink cannot be made and every
    isinstance test is False; any other use raises."""

    class ExternalLink:
        def __init__(self, *args, **kwargs):
            raise ImportError('h5py is not installed')

    def __getattr__(self, name):
        if name.startswith('__'):
            raise AttributeError(name)
        raise ImportError('h5py is not installed: HDF5 files cannot be read '
                          'or written here (h5py.%s)' % name)


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False: this needs '
              'an NVIDIA card', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if importlib.util.find_spec('h5py') is None:
        sys.modules['h5py'] = _NoHDF5('h5py')
    from hyperion_tpu_torch.transport import _build
    from hyperion_tpu_torch.transport import deposit_visit as dv

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

    # 2. build
    t0 = time.time()
    lib = _build.build('deposit_visit')
    phase('built %s in %.2f s' % (lib.name, time.time() - t0))

    # 3. kernel against the plain version
    checks = []
    for seed, (B, n_cells) in enumerate(SHAPES):
        for n_dust in (1, 2):
            res = check_kernel(dv, B, n_cells, n_dust, device, seed)
            checks.append(res)
            phase('deposit_visit B=%d n_cells=%d n_dust=%d: equal counts and '
                  'uids, max abs energy err %.3g; kernel %.4f ms, plain %.4f '
                  'ms per call [%s]' % (B, n_cells, n_dust,
                                        res['max_abs_err'], res['ms'],
                                        res['plain_ms'], card))

    # 4. the slice, through the kernel
    launches, iterations, wall = run_slice(dv, card)

    # 5. physics on the card
    median_ratio, bench = physics_on_card(card)

    timed = next(c for c in checks
                 if (c['B'], c['n_cells'], c['n_dust']) == TIMED_SHAPE)
    kernels = [dict(name='deposit_visit', route='cuda', source=KERNEL_SOURCE,
                    replaces=REPLACES, launches=launches,
                    max_abs_err=max(c['max_abs_err'] for c in checks),
                    ms=timed['ms'], plain_ms=timed['plain_ms'])]
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, kernel_checks=checks,
                  slice=dict(wall_s=wall, iterations=iterations),
                  inverse_square_median_ratio=median_ratio,
                  bench_quickstart=bench, kernels=kernels)
    (OUT / 'results.json').write_text(json.dumps(record, indent=1))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
