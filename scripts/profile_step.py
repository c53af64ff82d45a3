#!/usr/bin/env python3
"""Where a transport step of the port spends its time, on one card.

    python3 scripts/profile_step.py [--model tutorial|yso_thick|
                                     quickstart_imaging|class2_imaging]
                                    [--warmup 20] [--steps 40]

Builds the tutorial model (examples/quickstart.py: 32^3 cells, 500,000
photons, B = 125,000) with the port's front end, or bench.py's yso_thick
configuration (64 x 32 spherical-polar cells, MRW, a re-absorbing star,
B = 4,096; chip_smoke.yso_thick_engine), takes ``--warmup`` steps of its
first Lucy iteration; or, for the two imaging models, the imaging
iteration of the quickstart (1,000,000 photons, one view with an SED and a
128 x 128 image, forced first interaction, B = 125,000) or of class2
(examples/class2_sed.py: 96 x 32 cells, MRW, three views, B = 50,000),
with a zero specific energy (the step's launches do not depend on it),
through ``--warmup`` imaging steps. It then profiles
``--steps`` steps with torch.profiler (CPU and CUDA activities) and times
as many unprofiled steps with the host clock around work that ends in a
synchronise. Prints one JSON object: device kernels and their launches
per step, device busy time per step and its share of the profiled span,
the deposit_visit and escape_tau kernels' device time and launches per
step, host milliseconds per step, and the ten kernels with the most device
time.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


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


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (card_line, class2_model, tutorial_engine,
                            tutorial_model, yso_thick_engine)

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', choices=['tutorial', 'yso_thick',
                                        'quickstart_imaging',
                                        'class2_imaging'],
                    default='tutorial')
    ap.add_argument('--warmup', type=int, default=20)
    ap.add_argument('--steps', type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_step: needs an NVIDIA card', file=sys.stderr)
        return 1
    if args.model == 'tutorial':
        carry, step, gen, geo = tutorial_engine(warmup=args.warmup)
    elif args.model == 'yso_thick':
        carry, step, gen, geo = yso_thick_engine(warmup=args.warmup)
    elif args.model == 'quickstart_imaging':
        carry, step, gen, geo = imaging_engine(tutorial_model(), 125_000,
                                               args.warmup)
    else:
        carry, step, gen, geo = imaging_engine(
            class2_model(n_photons=200_000, n_iterations=1,
                         n_imaging=100_000), 50_000, args.warmup)
    batch = carry.packets.x.shape[0]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(carry, gen)
        torch.cuda.synchronize()
        span = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(carry, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    # device-side events only (kernels, copies, sets): the CPU-side
    # operator rows would count the same device time again
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    busy_us = sum(us for us, _ in by_name.values())
    launches = len(kernels)
    dv = [v for k, v in by_name.items() if 'deposit_visit' in k]
    et = [v for k, v in by_name.items() if 'escape_tau' in k]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    n = args.steps
    out = dict(
        card=card_line(), torch=torch.__version__, model=args.model, B=batch,
        n_cells=geo.n_cells, steps=n, alive_after=carry.n_alive,
        device_launches_per_step=launches / n,
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
    print(json.dumps(out, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
