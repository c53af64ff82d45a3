#!/usr/bin/env python3
"""The port's Lucy, imaging and monochromatic iterations on one card, one
package against another in turns: the iterations of chip_smoke.py's
phases 4, 5, 8, 9 and 12.

    python3 scripts/lucy_graph_ab.py --old DIR [--turns old,new,new,old]
                                     [--workloads tutorial,quickstart,
                                                  class2,yso_thick,
                                                  tutorial_imaging,
                                                  class2_imaging,
                                                  quickstart_mono,
                                                  sph_octree,
                                                  sph_octree_imaging]

DIR holds another commit's ``hyperion_tpu_torch/`` (``git archive <rev>
hyperion_tpu_torch | tar -x -C DIR``); "new" is this checkout's, and
"new:K" this checkout's with graphs of K steps (``engine.GRAPH_STEPS``;
by default its own). Each turn
is a process of its own that imports one package (the model builders are
this checkout's chip_smoke.py) and runs, on the card in float32:

- tutorial: phase 4's 4 Lucy iterations of 500,000 photons (B = 125,000)
  through run_lucy_model, its imaging left out;
- quickstart: phase 5's bench.py quickstart iteration, 2,000,000 photons
  at B = 131,072 after one of 200,000;
- class2: phase 8's Lucy iteration (200,000 photons, B = 50,000, capped at
  2,500 steps) through run_lucy_model, its imaging left out;
- yso_thick: phase 9's iteration (10,000 photons, B = 4,096) through
  transport.lucy.run_lucy;
- tutorial_imaging: phase 4's imaging iteration (1,000,000 photons, B =
  125,000) through run_lucy_model with no Lucy iteration (a zero specific
  energy: a step's work does not depend on it);
- class2_imaging: phase 8's imaging iteration (100,000 photons, B =
  50,000, capped at 1,000 steps), the same way;
- quickstart_mono: phase 12 (a)'s monochromatic iteration (500,000 source
  and 500,000 dust photons at each of 5 wavelengths), the grid given a
  uniform 30 K specific energy;
- sph_octree: phase 16's 5 Lucy iterations of 1,000,000 photons (config 4's
  octree, B = 131,072) through run_lucy_model, its imaging and raytracing
  left out (not in the default list);
- sph_octree_imaging: phase 16's imaging iteration (1,000,000 photons),
  with no Lucy iteration and no raytracing (not in the default list).

A turn builds its package's kernels first, untimed. Each iteration's
wall (host clock, the card synchronised; an imaging
iteration's the runner's own, around run_final or the monochromatic
passes), steps, photons/s and ms a step; with the graph driver also its
replays and host reads a step (``engine.step_counts``, and the imaging
and monochromatic iterations' own counts; in a package with gated bodies,
``engine.run_if``, also the refills and MRW moves that ran). Prints one JSON object of all
turns and writes it to chiprun_out/lucy_graph_ab.json.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
WORKLOADS = ('tutorial', 'quickstart', 'class2', 'yso_thick',
             'tutorial_imaging', 'class2_imaging', 'quickstart_mono')
# each imaging workload's step counts in the engine module
IMAGING_COUNTS = dict(tutorial_imaging='imaging_step_counts',
                      class2_imaging='imaging_step_counts',
                      sph_octree_imaging='imaging_step_counts',
                      quickstart_mono='mono_step_counts')


def rows_of(run):
    return [dict(wall=r['wall'], steps=r['steps']) for r in
            run.perf.rows[:len(run.iterations)]]


def tutorial():
    from chip_smoke import tutorial_model
    from hyperion_tpu_torch.model import run_lucy_model
    m = tutorial_model()
    m.peeled_output = []
    m.set_n_photons(initial=500_000, imaging=0)
    return 500_000, rows_of(run_lucy_model(m, device='cuda'))


def quickstart():
    import torch
    from hyperion_tpu_torch.transport import engine
    from hyperion_tpu_torch.transport.lucy import compute_jnu_var
    from profile_step import quickstart_tables
    geo, dt, st, density, config = quickstart_tables()
    jid, jfrac = compute_jnu_var(dt, torch.zeros_like(density))
    gen = torch.Generator(device='cuda').manual_seed(1)
    engine.run_lucy_iteration(geo, dt, st, density, jid, jfrac, gen, 200000,
                              131072, config)
    torch.cuda.synchronize()
    if hasattr(engine, 'reset_step_counts'):
        engine.reset_step_counts()
    t0 = time.time()
    out = engine.run_lucy_iteration(geo, dt, st, density, jid, jfrac, gen,
                                    2_000_000, 131072, config)
    torch.cuda.synchronize()
    return 2_000_000, [dict(wall=time.time() - t0, steps=int(out[5]))]


def class2():
    from chip_smoke import CLASS2_CUT, class2_model
    from hyperion_tpu_torch.model import run_lucy_model
    m = class2_model(CLASS2_CUT['n_photons'], 1, CLASS2_CUT['n_imaging'])
    m.peeled_output = []
    m.set_n_photons(initial=CLASS2_CUT['n_photons'], imaging=0)
    return CLASS2_CUT['n_photons'], rows_of(run_lucy_model(
        m, device='cuda', max_steps=CLASS2_CUT['max_steps']))


def yso_thick():
    import torch
    from chip_smoke import YSO_THICK, YSO_THICK_CUT, yso_thick_tables
    from hyperion_tpu_torch.transport.lucy import run_lucy
    geo, dt, st, density = yso_thick_tables()
    rows, t = [], [time.time()]

    def callback(it, se, rho, npc, spec, stats):
        rows.append(dict(wall=time.time() - t[0], steps=stats['n_steps']))
        t[0] = time.time()

    run_lucy(geo, dt, st, density,
             torch.Generator(device='cuda').manual_seed(1),
             YSO_THICK_CUT['n_photons'], YSO_THICK_CUT['n_iterations'],
             use_mrw=True, verbose=False, iteration_callback=callback,
             **YSO_THICK)
    return YSO_THICK_CUT['n_photons'], rows


def imaging_rows(run):
    """The imaging iteration's row: the runner's wall and steps."""
    return [dict(wall=run.imaging.wall, steps=run.imaging.n_steps)]


def tutorial_imaging():
    from chip_smoke import tutorial_model
    from hyperion_tpu_torch.model import run_lucy_model
    m = tutorial_model()
    m.set_n_initial_iterations(0)
    return 1_000_000, imaging_rows(run_lucy_model(m, device='cuda'))


def class2_imaging():
    from chip_smoke import CLASS2_CUT, class2_model
    from hyperion_tpu_torch.model import run_lucy_model
    m = class2_model(CLASS2_CUT['n_photons'], 1, CLASS2_CUT['n_imaging'])
    m.set_n_initial_iterations(0)
    return CLASS2_CUT['n_imaging'], imaging_rows(run_lucy_model(
        m, device='cuda',
        imaging_max_steps=CLASS2_CUT['imaging_max_steps']))


def quickstart_mono():
    import numpy as np
    from chip_smoke import (MONO_PHOTONS, MONO_WAVELENGTHS, mono_model,
                            tutorial_model)
    from hyperion_tpu_torch.model import run_lucy_model
    m = tutorial_model()
    dust = m._dust_objects()[0]
    se = [dust.temperature2specific_energy(np.full(m.grid.shape, 30.0))
          .ravel()]
    return 2 * MONO_PHOTONS * len(MONO_WAVELENGTHS), imaging_rows(
        run_lucy_model(mono_model(se, False), device='cuda'))


def sph_octree():
    from chip_smoke import SPH_OCT_CUT, sph_octree_model
    from hyperion_tpu_torch.model import run_lucy_model
    cut = SPH_OCT_CUT
    m, _ = sph_octree_model(cut['n_photons'], cut['n_iterations'], 0,
                            raytracing=None)
    m.peeled_output = []
    m.binned_output = None
    return cut['n_photons'], rows_of(run_lucy_model(
        m, device='cuda', max_steps=cut['max_steps']))


def sph_octree_imaging():
    from chip_smoke import SPH_OCT_CUT, sph_octree_model
    from hyperion_tpu_torch.model import run_lucy_model
    cut = SPH_OCT_CUT
    m, _ = sph_octree_model(cut['n_photons'], 0, cut['n_imaging'],
                            raytracing=None)
    return cut['n_imaging'], imaging_rows(run_lucy_model(
        m, device='cuda', imaging_max_steps=cut['imaging_max_steps']))


def run_turn(workloads):
    """One turn in this process: each workload's iterations."""
    import torch
    from chip_smoke import card_line
    from hyperion_tpu_torch.transport import _build, engine

    out = dict(card=card_line(), package=str(Path(engine.__file__)
                                             .parents[2]),
               graph_steps=getattr(engine, 'GRAPH_STEPS', None))
    # the package's kernels built before the first workload (a package's
    # first turn builds them, which no iteration should be timed with)
    t0 = time.time()
    _build.build(*(name for name in ('deposit_visit', 'escape_tau',
                                     'voronoi_locate', 'octree_locate',
                                     'cond_node')
                   if (_build.CSRC / (name + '.cu')).exists()))
    out['build_s'] = time.time() - t0
    for name in workloads:
        if hasattr(engine, 'reset_step_counts'):
            engine.reset_step_counts()
        torch.cuda.synchronize()
        photons, rows = globals()[name]()
        for r in rows:
            r.update(photons_per_sec=photons / r['wall'],
                     ms_per_step=r['wall'] * 1e3 / r['steps'])
        rec = dict(photons=photons, iterations=rows)
        counts = getattr(engine, IMAGING_COUNTS.get(name, 'step_counts'),
                         None)
        if counts is not None:
            c = dict(counts)
            steps = sum(r['steps'] for r in rows)
            rec.update(step_counts=c, reads_per_step=c['reads'] / steps)
        out[name] = rec
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old', help='directory holding the other package')
    ap.add_argument('--turns', default='old,new,new,old')
    ap.add_argument('--workloads', default=','.join(WORKLOADS))
    ap.add_argument('--run', default=None,
                    help='(a turn) run in this process with the package '
                    'in this directory')
    ap.add_argument('--graph-steps', type=int, default=None,
                    help='(a turn) steps a graph holds')
    args = ap.parse_args()
    workloads = args.workloads.split(',')
    if args.run is not None:
        sys.path.insert(0, str(Path(args.run).resolve()))
        sys.path.insert(1, str(ROOT / 'scripts'))
        if args.graph_steps:
            from hyperion_tpu_torch.transport import engine
            engine.GRAPH_STEPS = args.graph_steps
        print(json.dumps(run_turn(workloads)), flush=True)
        return 0
    turns = []
    for which in args.turns.split(','):
        name, _, k = which.partition(':')
        pkg = ROOT if name == 'new' else Path(args.old).resolve()
        t0 = time.time()
        done = subprocess.run(
            [sys.executable, __file__, '--run', str(pkg), '--workloads',
             ','.join(workloads)] + (['--graph-steps', k] if k else []),
            capture_output=True, text=True)
        if done.returncode:
            sys.stderr.write(done.stderr[-4000:])
            raise SystemExit('turn %s failed' % which)
        rec = json.loads(done.stdout.strip().splitlines()[-1])
        rec.update(turn=which, wall_s=time.time() - t0)
        turns.append(rec)
        print('[lucy_graph_ab] %s: %s' % (which, json.dumps(
            {w: [round(r['ms_per_step'], 4) for r in rec[w]['iterations']]
             for w in workloads})), flush=True)
    out = dict(turns=turns)
    dest = ROOT / 'chiprun_out'
    dest.mkdir(exist_ok=True)
    (dest / 'lucy_graph_ab.json').write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
