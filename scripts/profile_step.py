#!/usr/bin/env python3
"""Where a transport step of the port spends its time, on one card.

    python3 scripts/profile_step.py [--model tutorial|yso_thick|quickstart|
                                     class2|quickstart_imaging|
                                     class2_imaging]
                                    [--warmup 20] [--steps 48]
                                    [--package DIR]

Lucy models: the tutorial (examples/quickstart.py: 32^3 cells, 500,000
photons, B = 125,000) built with the port's front end; bench.py's yso_thick
configuration (64 x 32 spherical-polar cells, MRW, a re-absorbing star,
B = 4,096; chip_smoke.yso_thick_engine); bench.py's quickstart
configuration (chip_smoke phase 5: 15^3 cells, gray dust of albedo 0.3,
2,000,000 photons, B = 131,072); and class2's first Lucy iteration as
chip_smoke's phase 8 runs it (examples/class2_sed.py: 96 x 32 cells, MRW,
a re-absorbing star, 200,000 photons, B = 50,000), its arguments taken
from run_lucy_model. Imaging models: the imaging iteration of the
quickstart (1,000,000 photons, one view with an SED and a 128 x 128 image,
forced first interaction, B = 125,000) or of class2 (three views, B =
50,000), with a zero specific energy (the step's launches do not depend
on it).

Each runs ``--warmup`` eager steps, then profiles ``--steps`` eager steps
with torch.profiler (CPU and CUDA activities) and times as many unprofiled
steps with the host clock around work that ends in a synchronise. For a
Lucy model, a second copy of the iteration is then run the way
``engine.run_lucy_iteration`` runs it on the card: ``--warmup`` eager
steps, a CUDA graph of GRAPH_STEPS steps captured, and ``--steps`` /
GRAPH_STEPS replays each followed by the host's read of the counters,
profiled and then timed (and the capture and the first replay timed
alone); and a CUDA graph of GRAPH_STEPS refills masked
off (a step in which no lane is refilled still runs its refill's emission
pass) is timed with CUDA events. Prints one JSON object: device kernels
and their launches per step, the host's launch calls per step (kernels,
graphs, copies and sets), device busy time per step and its share of the
profiled span, the deposit_visit and escape_tau kernels' device time and
launches per step, host milliseconds per step, the ten kernels with the
most device time, and for a Lucy model the same for the graph run and the
masked refill's device microseconds.

``--package DIR`` imports hyperion_tpu_torch from DIR (another commit's
copy, e.g. ``git archive <rev> hyperion_tpu_torch | tar -x -C DIR``); a
package without the graph driver gets the eager figures alone.
"""

import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the host's calls that put work on the device
HOST_LAUNCH = re.compile(r'^cu(da)?(LaunchKernel|LaunchKernelExC|'
                         r'LaunchCooperativeKernel|GraphLaunch|MemcpyAsync|'
                         r'MemsetAsync)')


def imaging_engine(model, batch, warmup):
    """The imaging iteration of a model (chip_smoke's builders) on the
    card, with the settings ``run_model`` gives it, run through ``warmup``
    steps: (carry, step, generator, geometry)."""
    import torch
    from chip_smoke import imaging_tables
    from hyperion_tpu_torch.model.imaging_runner import imaging_options
    from hyperion_tpu_torch.transport import imaging

    geo, dt, st, density = imaging_tables(model, torch.float32)
    groups, options = imaging_options(model, geo, dt, density)
    carry, step = imaging.start_final(geo, dt, st, density, None, groups,
                                      model.n_photons['last'],
                                      batch_size=batch, **options)
    gen = torch.Generator(device=density.device).manual_seed(1)
    for _ in range(warmup):
        step(carry, gen)
    torch.cuda.synchronize()
    return carry, step, gen, geo


def quickstart_tables():
    """bench.py's quickstart configuration (chip_smoke phase 5) on the card
    in float32: (geometry, dust tables, source tables, density, config)."""
    import numpy as np
    import torch
    from hyperion_tpu_torch.dust import IsotropicDust
    from hyperion_tpu_torch.grid import CartesianGrid
    from hyperion_tpu_torch.sources import PointSource
    from hyperion_tpu_torch.transport.dtable import build_dust_tables
    from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
    from hyperion_tpu_torch.transport.stable import build_source_tables

    dev, f32 = torch.device('cuda'), torch.float32
    grid = CartesianGrid(*[np.linspace(-1, 1, 16)] * 3)
    nu = np.logspace(5, 18, 24)
    dust = IsotropicDust(nu, np.repeat(0.3, 24), np.repeat(1.0, 24))
    geo = build_cartesian_geometry(grid, dev, f32)
    dt = build_dust_tables([dust], dev, f32)
    st = build_source_tables([PointSource(luminosity=1.0,
                                          temperature=5000.0)], dev, f32,
                             length_scale=geo.length_scale)
    density = torch.full((1, grid.n_cells), 0.2 * geo.length_scale,
                         dtype=f32, device=dev)
    config = dict(n_inter_max=1000000, kill_on_scatter=False,
                  kill_on_absorb=False, max_steps=1000000)
    return geo, dt, st, density, config


def quickstart_engine(warmup):
    """bench.py's quickstart iteration of 2,000,000 photons at B = 131,072
    on the card, run through ``warmup`` steps."""
    from chip_smoke import warm_engine
    geo, dt, st, density, config = quickstart_tables()
    return warm_engine(geo, dt, st, density, 2_000_000, 131072, config,
                       warmup=warmup) + (geo,)


def class2_engine(warmup):
    """class2's first Lucy iteration as chip_smoke's phase 8 runs it (the
    arguments run_lucy_model gives it), run through ``warmup`` steps."""
    import torch
    from chip_smoke import CLASS2_CUT, class2_model, first_iteration_args
    from hyperion_tpu_torch.transport import engine

    first = first_iteration_args(class2_model(
        CLASS2_CUT['n_photons'], 1, CLASS2_CUT['n_imaging']))
    args, kw = first['args'], first['kw']
    geo, dt, st, density, jid, jfrac, gen, n_photons, batch, config = args
    n_bins = 0 if kw.get('spec_bins') is None else \
        kw['spec_bins'].shape[0] - 1
    carry = engine._init_lucy_carry(dt, density, n_photons, batch, n_bins)
    step = engine.make_lucy_step(geo, dt, st, density, jid, jfrac, config,
                                 **kw)
    gen = torch.Generator(device='cuda').manual_seed(1)
    for _ in range(warmup):
        step(carry, gen)
    torch.cuda.synchronize()
    return carry, step, gen, geo


def lucy_engine(name, warmup):
    from chip_smoke import tutorial_engine, yso_thick_engine
    return {'tutorial': lambda: tutorial_engine(warmup=warmup),
            'yso_thick': lambda: yso_thick_engine(warmup=warmup),
            'quickstart': lambda: quickstart_engine(warmup),
            'class2': lambda: class2_engine(warmup)}[name]()


def profiled(run, n_steps):
    """``run()`` profiled, then timed unprofiled: the figures per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    events = prof.events()
    # device-side events only (kernels, copies, sets): the CPU-side
    # operator rows would count the same device time again
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host = sum(1 for e in events if e.device_type == DeviceType.CPU and
               HOST_LAUNCH.match(e.name))
    by_name = {}
    for e in kernels:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    busy_us = sum(us for us, _ in by_name.values())
    dv = [v for k, v in by_name.items() if 'deposit_visit' in k]
    et = [v for k, v in by_name.items() if 'escape_tau' in k]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    n = n_steps
    return dict(
        device_launches_per_step=len(kernels) / n,
        host_launches_per_step=host / n,
        device_busy_ms_per_step=busy_us / n / 1e3,
        profiled_span_ms_per_step=span / n * 1e3,
        device_busy_share=busy_us / 1e6 / span,
        deposit_visit_us_per_step=sum(us for us, _ in dv) / n,
        deposit_visit_launches_per_step=sum(c for _, c in dv) / n,
        escape_tau_us_per_step=sum(us for us, _ in et) / n,
        escape_tau_launches_per_step=sum(c for _, c in et) / n,
        host_ms_per_step_unprofiled=wall / n * 1e3,
        top_kernels=[dict(name=k[:80], us_per_step=us / n,
                          launches_per_step=c / n)
                     for k, (us, c) in top])


def graph_figures(name, warmup, n_steps):
    """A second copy of the Lucy iteration run as on the card's main path:
    replays of a CUDA graph of GRAPH_STEPS steps, the host reading the
    counters after each; then the masked refill's device time."""
    import numpy as np
    import torch
    from hyperion_tpu_torch.transport import engine

    carry, step, gen, _ = lucy_engine(name, warmup)
    k = engine.GRAPH_STEPS
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        graph = engine.capture_steps(carry, step, gen, k)
    main.wait_stream(side)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph.replay()
    engine.read_counts(carry)
    first_replay_s = time.perf_counter() - t0
    replays = max(1, n_steps // k)

    def run():
        for _ in range(replays):
            graph.replay()
            engine.read_counts(carry)

    run()
    torch.cuda.synchronize()
    out = profiled(run, replays * k)
    out.update(graph_steps=k, replays=replays, capture_s=capture_s,
               first_replay_s=first_replay_s, reads_per_step=1.0 / k,
               alive_after=int(carry.n_alive), working_steps=int(
                   carry.n_steps))

    # GRAPH_STEPS refills masked off, captured and timed with CUDA events
    u = step.draw(carry, gen)
    gate = torch.zeros((), dtype=torch.bool, device=u.device)
    refills = torch.cuda.CUDAGraph()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        step.refill(carry, u, gate)
        refills.capture_begin()
        for _ in range(k):
            step.refill(carry, u, gate)
        refills.capture_end()
    main.wait_stream(side)
    times = []
    for _ in range(20):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        refills.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) * 1e3 / k)
    out['masked_refill_us'] = float(np.median(times))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', choices=['tutorial', 'yso_thick',
                                        'quickstart', 'class2',
                                        'quickstart_imaging',
                                        'class2_imaging'],
                    default='tutorial')
    ap.add_argument('--warmup', type=int, default=20)
    ap.add_argument('--steps', type=int, default=48)
    ap.add_argument('--package', default=None,
                    help='import hyperion_tpu_torch from this directory')
    ap.add_argument('--graph-steps', type=int, default=None,
                    help='steps a graph holds (engine.GRAPH_STEPS)')
    args = ap.parse_args()
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    import torch
    from chip_smoke import card_line, class2_model, tutorial_model
    from hyperion_tpu_torch.transport import engine

    if not torch.cuda.is_available():
        print('profile_step: needs an NVIDIA card', file=sys.stderr)
        return 1
    lucy = args.model in ('tutorial', 'yso_thick', 'quickstart', 'class2')
    if lucy:
        carry, step, gen, geo = lucy_engine(args.model, args.warmup)
    elif args.model == 'quickstart_imaging':
        carry, step, gen, geo = imaging_engine(tutorial_model(), 125_000,
                                               args.warmup)
    else:
        carry, step, gen, geo = imaging_engine(
            class2_model(n_photons=200_000, n_iterations=1,
                         n_imaging=100_000), 50_000, args.warmup)

    def run():
        for _ in range(args.steps):
            step(carry, gen)

    out = dict(card=card_line(), torch=torch.__version__, model=args.model,
               package=str(Path(engine.__file__).parents[2]),
               B=carry.packets.x.shape[0], n_cells=geo.n_cells,
               steps=args.steps)
    out.update(profiled(run, args.steps))
    out['alive_after'] = int(carry.n_alive)
    if lucy and hasattr(engine, 'capture_steps'):
        if args.graph_steps:
            engine.GRAPH_STEPS = args.graph_steps
        del carry, step
        out['graph'] = graph_figures(args.model, args.warmup, args.steps)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
