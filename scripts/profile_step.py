#!/usr/bin/env python3
"""Where a transport step of the port spends its time, on one card.

    python3 scripts/profile_step.py [--model tutorial|yso_thick|quickstart|
                                     class2|sph_octree|quickstart_imaging|
                                     class2_imaging|quickstart_mono]
                                    [--warmup 20] [--steps 48]
                                    [--package DIR] [--graph-steps K]
                                    [--sink-ab]
    python3 scripts/profile_step.py --loops B

Lucy models: the tutorial (examples/quickstart.py: 32^3 cells, 500,000
photons, B = 125,000) built with the port's front end; bench.py's yso_thick
configuration (64 x 32 spherical-polar cells, MRW, a re-absorbing star,
B = 4,096; chip_smoke.yso_thick_engine); bench.py's quickstart
configuration (chip_smoke phase 5: 15^3 cells, gray dust of albedo 0.3,
2,000,000 photons, B = 131,072); class2's first Lucy iteration as
chip_smoke's phase 8 runs it (examples/class2_sed.py: 96 x 32 cells, MRW,
a re-absorbing star, 200,000 photons, B = 50,000); and config 4's
(sph_octree, chip_smoke phase 16: an octree of ~12,400 nodes, 1,000,000
photons, B = 131,072), their arguments taken from run_lucy_model. Imaging
models: the imaging iteration of the quickstart (1,000,000 photons, one
view with an SED and a 128 x 128 image, forced first interaction, B =
125,000) or of class2 (three views, B = 50,000), with a zero specific
energy (the step's launches do not depend on it); the monochromatic
source pass at 1 um of the quickstart in phase 12's monochromatic mode
(500,000 photons, B = 125,000).

Each runs ``--warmup`` eager steps, then profiles ``--steps`` eager steps
with torch.profiler (CPU and CUDA activities) and times as many unprofiled
steps with the host clock around work that ends in a synchronise. Then
(a package whose step has ``draw``) a second copy of the iteration is run
the way the drivers run it on the card (``engine.drive_graph``):
``--warmup`` eager steps, a CUDA graph of GRAPH_STEPS steps captured, and
``--steps`` / GRAPH_STEPS replays each followed by the host's read of the
counters, profiled and then timed (and the capture and the first replay
timed alone), with the gated bodies that ran a step (the refills, the
Lucy step's MRW moves: ``engine.run_if``, which a replay skips where the
gate is false); the cost of a conditional node (a graph of 64 tiny steps
against the same with a gated body behind a false gate, in turns); a
CUDA graph of GRAPH_STEPS refills masked off (a step in
which no lane is refilled still runs its refill's emission pass) is timed
with CUDA events and profiled, its device time split into the
``index_add_`` kernels (the peel cubes' and the visits' sums), the
escape_tau kernel and the rest; and the geometry's ``find_cell`` and
``find_wall`` on the carry's lanes (kernels a call, device us a call in a
graph of 10 calls).
With ``--sink-ab`` (imaging and monochromatic models) the step's graph
and the masked refill's graph are captured twice, the peel cubes'
``_deposit`` sending masked lanes to one slot of the cube (as a sink slot
did before) or leaving each at its own clamped in-range index, with a
zero value, and replayed in turns (sink, own, own, sink) from one saved
carry state, timed with CUDA events. Prints one JSON object: device kernels and their
launches per step, the host's launch calls per step (kernels, graphs,
copies and sets), device busy time per step and its share of the profiled
span, the deposit_visit and escape_tau kernels' device time and launches
per step, the octree locate kernels' device time and launches per step
(each launch one descend from the root a lane), host milliseconds per step,
the ten kernels with the most device time, and the graph, refill,
find_cell, find_wall and sink figures.

``--loops B`` profiles, instead of a step, the JAX package's device loops
that the port still runs as chains of PyTorch ops, one call each on B
float32 lanes (:func:`loop_figures`): kernels and device us a call.

``--package DIR`` imports hyperion_tpu_torch from DIR (another commit's
copy, e.g. ``git archive <rev> hyperion_tpu_torch | tar -x -C DIR``); a
step without ``draw`` (an eager-only package's) gets the eager figures
alone.
"""

import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LUCY = ('tutorial', 'yso_thick', 'quickstart', 'class2', 'sph_octree')
MODELS = LUCY + ('quickstart_imaging', 'class2_imaging', 'quickstart_mono')
# escape_tau.cu's kernel (both modes), by its name in a trace
ESCAPE_TAU = 'walk_kernel'
# octree_locate.cu's two kernels, by their names in a trace: each is one
# descend from the root a lane
OCTREE_LOCATE = ('find_cell_kernel', 'find_wall_kernel')
# the index_add_ kernels (the peel cubes' and spectrum bins' sums)
INDEX_ADD = re.compile(r'index(Func|_add)', re.I)
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


def first_iteration_engine(model, warmup):
    """A model's first Lucy iteration as run_lucy_model gives it on the
    card (chip_smoke.first_iteration_args), run through ``warmup`` steps."""
    import torch
    from chip_smoke import first_iteration_args
    from hyperion_tpu_torch.transport import engine

    first = first_iteration_args(model)
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


def mono_engine(warmup):
    """The quickstart's monochromatic source pass at 1 um (chip_smoke
    phase 12's model, ``mono_model`` without a specific energy, so without
    its dust passes; B = 125,000 as there), its arguments taken from
    run_lucy_model, run through ``warmup`` steps: (carry, step, generator,
    geometry)."""
    import torch
    from chip_smoke import first_mono_pass, mono_model
    from hyperion_tpu_torch.model import run_lucy_model
    from hyperion_tpu_torch.transport import mono

    with first_mono_pass('source', f_id=1, stop=True) as rec:
        run_lucy_model(mono_model(None, False), device='cuda')
    geo, walk, dt, st, density, groups, _, n_photons = rec['args']
    kw = rec['kw']
    kw.pop('max_steps', None)
    carry = mono._init_mono_carry(groups, n_photons, kw.pop('batch_size'),
                                  density.device, density.dtype)
    step = mono.make_mono_step(geo, walk, dt, st, density, groups,
                               kw.pop('config'), **kw)
    gen = torch.Generator(device=density.device).manual_seed(1)
    for _ in range(warmup):
        step(carry, gen)
    torch.cuda.synchronize()
    return carry, step, gen, geo


def build(name, warmup):
    """The named model's iteration on the card, run through ``warmup``
    steps: (carry, step, generator, geometry)."""
    from chip_smoke import (CLASS2_CUT, SPH_OCT_CUT, class2_model,
                            sph_octree_model, tutorial_engine, tutorial_model,
                            yso_thick_engine)
    return {
        'tutorial': lambda: tutorial_engine(warmup=warmup),
        'yso_thick': lambda: yso_thick_engine(warmup=warmup),
        'quickstart': lambda: quickstart_engine(warmup),
        'class2': lambda: first_iteration_engine(class2_model(
            CLASS2_CUT['n_photons'], 1, CLASS2_CUT['n_imaging']), warmup),
        'sph_octree': lambda: first_iteration_engine(sph_octree_model(
            SPH_OCT_CUT['n_photons'], 1, SPH_OCT_CUT['n_imaging'])[0],
            warmup),
        'quickstart_imaging': lambda: imaging_engine(tutorial_model(),
                                                     125_000, warmup),
        'class2_imaging': lambda: imaging_engine(
            class2_model(n_photons=200_000, n_iterations=1,
                         n_imaging=100_000), 50_000, warmup),
        'quickstart_mono': lambda: mono_engine(warmup)}[name]()


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
    et = [v for k, v in by_name.items() if ESCAPE_TAU in k]
    octree = {name: [v for k, v in by_name.items() if name in k]
              for name in OCTREE_LOCATE}
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
        octree_locate_us_per_step=sum(us for v in octree.values()
                                      for us, _ in v) / n,
        **{'octree_%s_launches_per_step' % name.replace('_kernel', ''):
           sum(c for _, c in v) / n for name, v in octree.items()},
        host_ms_per_step_unprofiled=wall / n * 1e3,
        top_kernels=[dict(name=k[:80], us_per_step=us / n,
                          launches_per_step=c / n)
                     for k, (us, c) in top])


def read(engine, carry, step):
    """The drivers' read of the counters (a package whose read_counts
    takes no counts counts every read as the Lucy iteration's)."""
    if hasattr(step, 'counts'):
        return engine.read_counts(carry, step.counts)
    return engine.read_counts(carry)


def capture(torch, k, body):
    """A CUDA graph of ``k`` calls of ``body()`` on a side stream."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        for _ in range(k):
            body()
        graph.capture_end()
    main.wait_stream(side)
    return graph


def event_us(torch, graph, n=20, per=1):
    """Median device us of a graph's replay (CUDA events), over ``per``."""
    import numpy as np
    times = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) * 1e3 / per)
    return float(np.median(times))


def kernel_split(torch, run, n):
    """Device us of the kernels of ``run()`` over ``n``: all, the
    index_add_ sums, escape_tau, and the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def us(match):
        return sum(e.time_range.elapsed_us() for e in kernels
                   if match(e.name)) / n
    return dict(device_us=us(lambda name: True),
                index_add_us=us(lambda name: bool(INDEX_ADD.search(name))),
                escape_tau_us=us(lambda name: ESCAPE_TAU in name),
                launches=len(kernels) / n)


def refill_figures(carry, step, gen, k):
    """K refills masked off, captured: device us a refill (CUDA events) and
    its split (a profile of 5 replays)."""
    import torch
    u = step.draw(carry, gen)
    gate = torch.zeros((), dtype=torch.bool, device=u.device)
    step.refill(carry, u, gate)
    graph = capture(torch, k, lambda: step.refill(carry, u, gate))
    out = dict(masked_refill_us=event_us(torch, graph, per=k))

    def run():
        for _ in range(5):
            graph.replay()

    split = kernel_split(torch, run, 5 * k)
    out.update({'masked_refill_' + key: v for key, v in split.items()})
    return out


def call_figures(call):
    """Kernels and device us a call of ``call()``: a profile of 10 eager
    calls, and a CUDA graph of 10 calls timed with CUDA events."""
    import torch
    call()
    torch.cuda.synchronize()

    def run():
        for _ in range(10):
            call()

    split = kernel_split(torch, run, 10)
    graph = capture(torch, 10, call)
    return dict(launches=split['launches'], profiled_us=split['device_us'],
                us=event_us(torch, graph, per=10))


def find_cell_figures(carry, geo):
    """The geometry's find_cell and find_wall on the carry's lanes: kernels
    and device us a call (:func:`call_figures`)."""
    p = carry.packets
    lanes = (p.x, p.y, p.z, p.kx, p.ky, p.kz)
    cell = p.cell.clamp_min(0)
    out = {}
    for name, call in (
            ('find_cell', lambda: geo.find_cell(*lanes)),
            ('find_wall', lambda: geo.find_wall(cell, *lanes))):
        out.update({name + '_' + key: v
                    for key, v in call_figures(call).items()})
    return out


def loop_figures(B):
    """The JAX package's device loops that the port still runs as chains of
    PyTorch ops, one call each on ``B`` float32 lanes of seeded inputs
    (:func:`call_figures`): the polarized scattering angle
    (``stokes.sample_scatter_stokes``, a bisection of ceil(log2 n_mu) + 1
    steps over the scattering cumulatives, on class2's dust tables), the
    limb-darkened emission angle (``stable._sample_limb_mu``, 4 Newton
    steps) and the Baes16 forced first interaction
    (``ffi.forced_interaction_baes16``, 60 bisection steps)."""
    import math

    import torch
    from chip_smoke import CLASS2_CUT, class2_model
    from hyperion_tpu_torch.transport import ffi, stable, stokes
    from hyperion_tpu_torch.transport.dtable import build_dust_tables

    dev, f32 = torch.device('cuda'), torch.float32
    gen = torch.Generator(device=dev).manual_seed(5)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f32)

    model = class2_model(CLASS2_CUT['n_photons'], 1, CLASS2_CUT['n_imaging'])
    dt = build_dust_tables(model._dust_objects(), dev, f32)
    n_mu = dt.mu.shape[1]
    k = torch.nn.functional.normalize(uniform(3, B) * 2 - 1, dim=0)
    kx, ky, kz = (a.contiguous() for a in k)
    dust_id = torch.zeros(B, dtype=torch.int64, device=dev)
    nu = dt.nu[0, 0] + uniform(B) * (dt.nu[0, -1] - dt.nu[0, 0])
    rows = stokes.phase_rows(dt, dust_id, nu)
    q, u, v = (uniform(B) * 0.2 - 0.1 for _ in range(3))
    u_phi, u_mu, u_limb, u_ffi = (uniform(B) for _ in range(4))
    tau_escape = uniform(B) * 5.0
    return dict(
        lanes=B,
        stokes_scatter=dict(
            call_figures(lambda: stokes.sample_scatter_stokes(
                dt, dust_id, nu, u_phi, u_mu, kx, ky, kz, q, u, v,
                rows=rows)),
            n_mu=n_mu,
            bisection_steps=math.ceil(math.log2(max(n_mu, 2))) + 1),
        limb_mu=dict(call_figures(lambda: stable._sample_limb_mu(u_limb)),
                     newton_steps=4),
        ffi_baes16=dict(
            call_figures(lambda: ffi.forced_interaction_baes16(
                u_ffi, tau_escape, 0.5)),
            bisection_steps=60))


def graph_figures(name, warmup, n_steps):
    """A second copy of the iteration run as the drivers run it on the
    card: replays of a CUDA graph of GRAPH_STEPS steps, the host reading
    the counters after each; then the masked refill's device time and the
    find_cell's."""
    import torch
    from hyperion_tpu_torch.transport import engine

    carry, step, gen, geo = build(name, warmup)
    k = engine.GRAPH_STEPS
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        graph = engine.capture_steps(carry, step, gen, k)
    main.wait_stream(side)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph.replay()
    read(engine, carry, step)
    first_replay_s = time.perf_counter() - t0
    replays = max(1, n_steps // k)

    def run():
        for _ in range(replays):
            graph.replay()
            read(engine, carry, step)

    run()
    torch.cuda.synchronize()
    before = bodies(carry)
    out = profiled(run, replays * k)
    # the gated bodies that ran in the profiled and the timed replays
    out.update({'%s_per_step' % name: (n - before[name]) / (2 * replays * k)
                for name, n in bodies(carry).items()})
    out.update(graph_steps=k, replays=replays, capture_s=capture_s,
               first_replay_s=first_replay_s, reads_per_step=1.0 / k,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() /
               1e9, alive_after=int(carry.n_alive),
               working_steps=int(carry.n_steps))
    out.update(refill_figures(carry, step, gen, k))
    out.update(find_cell_figures(carry, geo))
    return out


def bodies(carry):
    """{name: count} of the gated bodies that a carry has run
    (``engine.run_if``; a package without them: none)."""
    return {name: int(getattr(carry, name)) for name in
            ('refills', 'mrw_moves') if hasattr(carry, name)}


def node_figures(n=64):
    """The cost of a conditional node (``engine.run_if`` in a graph):
    device us a step of graphs of ``n`` steps, each one tiny kernel, then
    the same with a gated body of one more such kernel behind a gate
    false, then true, in turns (CUDA events); a node's cost is the false
    graph's step less the plain one's."""
    import numpy as np
    import torch
    from hyperion_tpu_torch.transport import engine

    dev = torch.device('cuda')
    x = torch.zeros((), device=dev)
    gates = {v: torch.full((), v, dtype=torch.bool, device=dev)
             for v in (False, True)}
    graphs = {}
    for how in ('plain', 'false', 'true'):
        def step(carry, generator, how=how):
            x.add_(1.0)
            if how != 'plain':
                engine.run_if(gates[how == 'true'], lambda: x.add_(1.0))
        step.counts = dict(engine.step_counts)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graphs[how] = engine.capture_steps(
                None, step, torch.Generator(device=dev), n)
        torch.cuda.current_stream().wait_stream(side)
        graphs[how].replay()
    times = {how: [] for how in graphs}
    for how in ('plain', 'false', 'true', 'true', 'false', 'plain'):
        times[how].append(event_us(torch, graphs[how], per=n))
    us = {how: float(np.mean(t)) for how, t in times.items()}
    return dict(node_us_step_plain=us['plain'],
                node_us_step_gate_false=us['false'],
                node_us_step_gate_true=us['true'],
                node_us=us['false'] - us['plain'], node_turns=times)


def deposit_variant(own_index):
    """The peel cubes' ``_deposit`` (transport/imaging.py) with its masked
    lanes sent to the cube's last slot (``own_index`` False: a package
    whose cubes end in a sink slot sent them there) or left at their own
    clamped in-range index (True, the package since then), each adding a
    zero there; the sums are the same either way."""
    import torch

    def deposit(group, flat, flat2, flatn, spatial_idx, ok_base, inu, nu_ok,
                tr, io, flux_s):
        sink = flat.shape[0] - 1
        S = group.n_stokes
        vals = torch.stack(flux_s, dim=-1)
        s_off = torch.arange(S, device=flat.device)
        if tr is None:
            ok = (ok_base & nu_ok)[:, None]
            idx0 = ((spatial_idx * group.n_nu + inu) * group.n_orig + io) * S
            idx = idx0[:, None] + s_off
        else:
            f = torch.arange(group.n_nu, device=flat.device)
            okf = ok_base[:, None] & (tr > 0.0)
            idx0 = ((spatial_idx[:, None] * group.n_nu + f) * group.n_orig +
                    io[:, None]) * S
            idx = idx0[..., None] + s_off
            vals = vals[:, None, :] * tr[..., None]
            ok = okf[..., None]
        idx = (idx if own_index else torch.where(ok, idx, sink)).reshape(-1)
        val = torch.where(ok, vals, 0.0).reshape(-1).to(flat.dtype)
        flat.index_add_(0, idx, val)
        if group.uncertainties:
            flat2.index_add_(0, idx, val * val)
            flatn.index_add_(0, idx, torch.where(
                ok, torch.ones_like(vals), 0.0).reshape(-1).to(flat.dtype))
    return deposit


def carry_tensors(carry):
    """Every tensor a carry holds (lanes, counters, cubes)."""
    import torch
    out = []
    for value in vars(carry).values():
        items = value if isinstance(value, list) else [value]
        for item in items:
            if isinstance(item, torch.Tensor):
                out.append(item)
            elif item is not None and hasattr(item, '__dict__'):
                out += [t for t in vars(item).values()
                        if isinstance(t, torch.Tensor)]
    return out


def sink_ab(name, warmup, replays=10):
    """The step's graph and the masked refill's graph captured with each
    ``_deposit`` variant and replayed in turns (sink, own, own, sink) from
    one saved carry and generator state: device us a step and a refill."""
    import numpy as np
    import torch
    from hyperion_tpu_torch.transport import engine, imaging

    carry, step, gen, _ = build(name, warmup)
    k = engine.GRAPH_STEPS
    inner = imaging._deposit
    graphs = {}
    u = step.draw(carry, gen)
    gate = torch.zeros((), dtype=torch.bool, device=u.device)
    saved = [t.clone() for t in carry_tensors(carry)]
    state = gen.get_state()
    try:
        for variant in ('sink', 'own'):
            imaging._deposit = deposit_variant(variant == 'own')
            step(carry, gen)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                steps = engine.capture_steps(carry, step, gen, k)
            torch.cuda.current_stream().wait_stream(side)
            refills = capture(torch, k, lambda: step.refill(carry, u, gate))
            graphs[variant] = (steps, refills)
    finally:
        imaging._deposit = inner
    times = {v: dict(step_us=[], refill_us=[]) for v in graphs}
    for variant in ('sink', 'own', 'own', 'sink'):
        for t, s in zip(carry_tensors(carry), saved):
            t.copy_(s)
        gen.set_state(state)
        steps, refills = graphs[variant]
        times[variant]['step_us'].append(event_us(torch, steps, replays, k))
        times[variant]['refill_us'].append(event_us(torch, refills, 5, k))
    return {v: {key: float(np.mean(x)) for key, x in t.items()} | dict(
        turns=t) for v, t in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', choices=MODELS, default='tutorial')
    ap.add_argument('--warmup', type=int, default=20)
    ap.add_argument('--steps', type=int, default=48)
    ap.add_argument('--package', default=None,
                    help='import hyperion_tpu_torch from this directory')
    ap.add_argument('--graph-steps', type=int, default=None,
                    help='steps a graph holds (engine.GRAPH_STEPS)')
    ap.add_argument('--sink-ab', action='store_true',
                    help='time the peel cubes\' two masked-lane layouts')
    ap.add_argument('--loops', type=int, default=None, metavar='B',
                    help='instead of a step: the op-chain loops, one call '
                    'each on B lanes')
    args = ap.parse_args()
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    import torch
    from chip_smoke import card_line
    from hyperion_tpu_torch.transport import engine

    if not torch.cuda.is_available():
        print('profile_step: needs an NVIDIA card', file=sys.stderr)
        return 1
    if args.loops:
        print(json.dumps(dict(card=card_line(), torch=torch.__version__,
                              loops=loop_figures(args.loops)), indent=1))
        return 0
    if args.graph_steps:
        engine.GRAPH_STEPS = args.graph_steps
    carry, step, gen, geo = build(args.model, args.warmup)

    def run():
        for _ in range(args.steps):
            step(carry, gen)

    out = dict(card=card_line(), torch=torch.__version__, model=args.model,
               package=str(Path(engine.__file__).parents[2]),
               B=carry.packets.x.shape[0],
               n_cells=geo.n_cells,
               steps=args.steps)
    out.update(profiled(run, args.steps))
    out['alive_after'] = int(carry.n_alive)
    graph = hasattr(step, 'draw')
    del carry, step
    if graph:
        out['graph'] = graph_figures(args.model, args.warmup, args.steps)
        if hasattr(engine, 'run_if'):
            out['graph'].update(node_figures())
    if args.sink_ab and graph and args.model not in LUCY:
        out['sink_ab'] = sink_ab(args.model, args.warmup)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
