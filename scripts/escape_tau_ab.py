#!/usr/bin/env python3
"""Time an earlier escape_tau design beside the current one on one card, on
the walks the imaging step makes.

    git archive <rev> hyperion_tpu_torch | tar -x -C _checkout/old
    python3 scripts/escape_tau_ab.py --old _checkout/old \
        [--models class2,quickstart,class1_cyl,orion_amr,voronoi_cloud,\
sph_octree] \
        [--columns] [--variant NAME=CONSTANT=VALUE[,CONSTANT=VALUE...] ...]

``--old`` is a directory that holds an earlier ``hyperion_tpu_torch/``
whose ``EscapeTau`` walks an event's V views in one call, as the current
one does (commit 98bb6b9, before the AMR and cylindrical crossings were
redesigned, or a later one). It is loaded under another package name and
builds its own library inside its directory. The current package records
the walk calls of imaging steps 1-20 and 41-60 (chip_smoke's WALK_WINDOWS)
of class2 (examples/class2_sed.py, B = 50,000) and of the quickstart (B =
125,000) with chip_smoke's record_walks, and those of chip_smoke.py's
phases 14 (BASELINE config 3, class1_cyl, cylindrical-polar, B = 25,000),
16 (config 4, sph_octree, octree, B = 131,072) and 17 (config 5,
orion_amr, AMR, B = 131,072) from the phase's own run
(:func:`record_phase`); each call is one event of V views. For each
window, in turns (old, new, new, old; with ``--variant``, old, new, the
variants, the variants again in reverse, new, old), it times every event
behind a ``torch.cuda._sleep`` between CUDA events, each as one launch,
and on the host clock (escape_column_ab.host_us). Both must give the same
tau.
Then the latency of one crossing: the window's longest ray alone (its lane
the only active one, its view the only one, at the window's B), less the
same call with no active lane, over the ray's crossings, for both designs;
and the registers and spill bytes of each design's walk kernels
(escape_tau_cycles.registers, -Xptxas -v).

``voronoi_cloud`` takes the calls of chip_smoke.py's phase 18 (config 4's
cloud on 50,000 Voronoi cells, B = 131,072) from the phase's own run, and
with them its locate calls (Lucy steps 41-80 and the raytracing pass's
positions, chip_smoke.locate_calls): the old design's voronoi_locate
beside the current one, and copies of the current source with other
constants (``--locate-variant NAME=kGroup=2``), in turns
(:func:`locate_ab`). ``--columns`` also times the phase runs'
raytracing column calls as scripts/escape_column_ab.py does
(``column_run``, with the same ``--variant`` copies).
Prints the card and one JSON object per window, and writes
chip_smoke_out/escape_tau_ab.json unless --out names another file.
"""

import argparse
import contextlib
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'scripts'))

import chip_smoke as cs  # noqa: E402

MODELS = {'class2': (lambda: cs.class2_model(n_photons=200_000), 50_000),
          'quickstart': (cs.tutorial_model, 125_000),
          'class1_cyl': (lambda: cs.class1_cyl_model(
              n_photons=cs.CLASS1_CYL_CUT['n_photons'],
              n_iterations=cs.CLASS1_CYL_CUT['n_iterations'],
              n_imaging=cs.CLASS1_CYL_CUT['n_imaging']), 25_000),
          'orion_amr': (lambda: cs.orion_amr_model(
              cs.AMR_CUT['n_photons'], cs.AMR_CUT['n_iterations'],
              cs.AMR_CUT['n_imaging'])[0], cs.AMR_CUT['batch_size']),
          'voronoi_cloud': (lambda: cs.voronoi_cloud_model(
              cs.VORONOI_CLOUD['n_sites'], cs.VORONOI_CUT['n_photons'],
              cs.VORONOI_CUT['n_iterations'],
              cs.VORONOI_CUT['n_imaging'])[0], 131_072),
          'sph_octree': (lambda: cs.sph_octree_model(
              cs.SPH_OCT_CUT['n_photons'], cs.SPH_OCT_CUT['n_iterations'],
              cs.SPH_OCT_CUT['n_imaging'])[0], 131_072)}
# the models whose calls are those of chip_smoke.py's phase, from its run:
# run_lucy_model's batch and Lucy step cap
PHASE_RUNS = {'class1_cyl': dict(batch_size=None,
                                 max_steps=cs.CLASS1_CYL_CUT['max_steps']),
              'orion_amr': dict(batch_size=cs.AMR_CUT['batch_size'],
                                max_steps=cs.AMR_CUT['max_steps']),
              'voronoi_cloud': dict(batch_size=None,
                                    max_steps=cs.VORONOI_CUT['max_steps']),
              'sph_octree': dict(batch_size=None,
                                 max_steps=cs.SPH_OCT_CUT['max_steps'])}
ORDER = ['old', 'new', 'new', 'old']


def record_phase(name, windows=cs.WALK_WINDOWS):
    """The calls of chip_smoke.py's phase 14 (class1_cyl), 16 (sph_octree),
    17 (orion_amr) or 18 (voronoi_cloud): the phase's model, photons and
    Lucy step cap
    through run_lucy_model on the card, as the phase runs them, with its
    imaging iteration cut at the last window's end (the calls of the steps
    before are the phase's; the raytracing pass draws from its own
    generator). Returns (model, {window: walk calls}, column calls, and
    on a Voronoi grid the locate calls of Lucy steps 41-80 and of the
    raytracing pass's positions, chip_smoke.locate_calls's record, else
    None)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model
    model = MODELS[name][0]()
    locate = cs.locate_calls(40, 80) if name == 'voronoi_cloud' else \
        contextlib.nullcontext()
    with cs.walk_calls(windows) as wcalls, cs.column_calls() as ccalls, \
            locate as lcalls:
        run_lucy_model(model, device='cuda',
                       imaging_max_steps=max([last for _, last in windows],
                                             default=1),
                       **PHASE_RUNS[name])
    torch.cuda.synchronize()
    return model, wcalls, [c for _, c in ccalls], lcalls


def load_old(directory):
    """The escape_tau module of the hyperion_tpu_torch/ in ``directory``,
    imported as package ``old_port``."""
    pkg = Path(directory).resolve() / 'hyperion_tpu_torch'
    spec = importlib.util.spec_from_file_location(
        'old_port', pkg / '__init__.py', submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules['old_port'] = module
    spec.loader.exec_module(module)
    return importlib.import_module('old_port.transport.escape_tau')


def event_us(run, calls, reps=2):
    """Device microseconds of ``run(call)`` for each call: behind a sleep,
    between CUDA events; the mean over calls of the last of ``reps``
    passes."""
    import torch
    starts = [torch.cuda.Event(enable_timing=True) for _ in calls]
    ends = [torch.cuda.Event(enable_timing=True) for _ in calls]
    for _ in range(reps):
        for a, b, call in zip(starts, ends, calls):
            torch.cuda._sleep(2_000_000)
            a.record()
            run(call)
            b.record()
        torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) * 1e3 \
        / len(calls)


def longest_ray(geo64, rt64, calls, et):
    """(call index, view, lane, crossings) of the window's longest ray: one
    plain walk over the rays of every call (chip_smoke._active_rays), the
    calls with a distance limit apart from the others."""
    import torch
    best = (0, 0, 0, -1)
    for limited in (False, True):
        group = [(c, call) for c, call in enumerate(calls)
                 if (call[9] is not None) == limited and bool(call[8].any())]
        if not group:
            continue
        rays = [cs._active_rays(cs._f64(call), call[8]) for _, call in group]
        lanes = [torch.cat([r[0][i] for r in rays], dim=1 if 4 <= i < 7
                           else 0) for i in range(8)]
        t_max = torch.cat([r[1] for r in rays], dim=1) if limited else None
        ones = torch.ones_like(lanes[7], dtype=torch.bool)
        _, n_cross = et.escape_tau_reference(geo64, rt64, *lanes, ones,
                                             t_max=t_max, crossings=True)
        # (call, view, lane) of each ray, in _active_rays' order
        where = torch.cat([torch.stack([
            torch.full_like(lane, c), torch.full_like(lane, v), lane])
            for c, call in group for lane in [call[8].nonzero()[:, 0]]
            for v in range(call[4].shape[0])], dim=1)
        r = int(n_cross[0].argmax())
        if int(n_cross[0, r]) > best[3]:
            best = tuple(int(x) for x in where[:, r]) + (int(n_cross[0, r]),)
    return best


def as_old(geometry, old):
    """The same geometry tables as an instance of the old package's class
    (its EscapeTau checks the class)."""
    import dataclasses
    module = importlib.import_module(type(geometry).__module__.replace(
        'hyperion_tpu_torch', 'old_port', 1))
    return getattr(module, type(geometry).__name__)(
        **{f.name: getattr(geometry, f.name)
           for f in dataclasses.fields(geometry)})


def window(old, new, kind, steps, calls, geo64, rt32, rt64, card,
           variants=None):
    """One window's calls: the designs in turns, the same tau from each,
    the longest ray's crossing. ``variants``: {name: ctypes library} of
    copies of the current source with other constants
    (escape_column_ab.build_variants), timed in turns after ``new``."""
    import torch
    import escape_column_ab as cab
    w_old = old.EscapeTau(as_old(geo64, old), rt32)
    w_new = new.EscapeTau(geo64, rt32)
    w_var = {name: cab.variant_walk(new, lib, geo64, rt32)
             for name, lib in (variants or {}).items()}

    def run_old(call):
        return w_old(*call[:9], t_max=call[9])
    # the same tau from both
    for call in calls:
        tau = w_new(*call[:9], t_max=call[9])
        ref = run_old(call)
        if not torch.equal(tau, ref):
            raise AssertionError('%s %s: the designs disagree by %g'
                                 % (kind, steps, float((tau - ref).abs()
                                                       .max())))
    runs = {'old': run_old,
            'new': lambda call: w_new(*call[:9], t_max=call[9])}
    for name, w in w_var.items():
        runs[name] = lambda call, w=w: w(*call[:9], t_max=call[9])
        for call in calls:
            if not torch.equal(runs[name](call), runs['new'](call)):
                raise AssertionError('%s %s: variant %s disagrees'
                                     % (kind, steps, name))
    order = ['old', 'new'] + list(w_var)
    order = order + order[::-1]
    turns = [dict(design=d, device_us_per_event=event_us(runs[d], calls),
                  host_us=cab.host_us(runs[d], calls)) for d in order]
    # one crossing's latency: the longest ray alone, less an empty call
    c, v, i, n_cross = longest_ray(geo64, rt64, calls, new)
    call = calls[c]
    one = torch.zeros_like(call[8])
    one[i] = True
    none = torch.zeros_like(call[8])
    lone = [call[:4] + [k[v:v + 1].contiguous() for k in call[4:7]] +
            [call[7], act, None if call[9] is None else
             call[9][v:v + 1].contiguous()] for act in (one, none)]
    latency = {}
    for design in ('old', 'new'):
        us = [event_us(runs[design], [x], reps=5) for x in lone]
        latency[design] = dict(alone_us=us[0], empty_us=us[1],
                               us_per_crossing=(us[0] - us[1]) / n_cross)
    plans = {d: getattr(w, 'plan', {}).get('resident_blocks')
             for d, w in [('old', w_old), ('new', w_new)] +
             list(w_var.items())}
    out = dict(model=kind, steps=steps, calls=len(calls),
               views=sum(x[4].shape[0] for x in calls), turns=turns,
               longest_ray_crossings=n_cross, latency=latency,
               resident_blocks=plans, card=card)
    print(json.dumps(out), flush=True)
    return out


def locate_ab(old, lcalls, card, variants=()):
    """voronoi_locate on phase 18's own calls (the Lucy steps' and the
    raytracing positions'), the old design's kernel beside the current
    one in turns (old, new, copies of the current source with other constants (``variants``:
    (name, {constant: value})), the same in reverse, old): every design's
    cells equal to those the run recorded; device us per call (each call
    behind a sleep, CUDA events) and host us per call
    (escape_column_ab.host_us)."""
    import torch
    import escape_column_ab as cab
    from hyperion_tpu_torch.transport import _build
    from hyperion_tpu_torch.transport import voronoi_locate as vl
    old_vl = importlib.import_module('old_port.transport.voronoi_locate')
    libs = cab.build_variants([tuple(sorted(c.items()))
                               for _, c in variants], 'voronoi_locate')
    out = []
    for run, calls in (('lucy', lcalls['lucy']),
                       ('raytracing positions', lcalls['raytracing'])):
        geo = calls[0][0].geo
        locators = {'old': old_vl.VoronoiLocate(as_old(geo, old)),
                    'new': vl.VoronoiLocate(geo)}
        own = _build._loaded.get('voronoi_locate')
        for (name, _), (lib, _) in zip(variants, libs):
            _build._loaded['voronoi_locate'] = lib
            locators[name] = vl.VoronoiLocate(geo)
        _build._loaded['voronoi_locate'] = own

        def runner(loc):
            return lambda call: loc.locate(*call[2:5]) if call[1] is None \
                else loc.walk_from(*call[1:5])
        runs = {name: runner(loc) for name, loc in locators.items()}
        for name, r in runs.items():
            for call in calls:
                if not torch.equal(r(call), call[5]):
                    raise AssertionError('voronoi_locate %s: %s disagrees '
                                         'with the run' % (run, name))
        order = list(runs)
        order = order + order[::-1]
        turns = [dict(design=d, device_us=event_us(runs[d], calls),
                      host_us=cab.host_us(runs[d], calls)) for d in order]
        row = dict(locate=run, calls=len(calls),
                   lanes_per_call=sum(c[2].shape[0] for c in calls) /
                   len(calls),
                   turns=turns, card=card)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main():
    import torch
    from hyperion_tpu_torch.model.run import (_density_array,
                                              build_geometry_tables)
    from hyperion_tpu_torch.transport import escape_tau as new

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old', required=True,
                    help='a directory holding an earlier hyperion_tpu_torch/')
    ap.add_argument('--models', default='class2,quickstart')
    ap.add_argument('--out', default=str(cs.OUT / 'escape_tau_ab.json'))
    ap.add_argument('--variant', action='append', default=[],
                    help='NAME=CONSTANT=VALUE[,CONSTANT=VALUE...]: a copy of '
                    'the current source with those constexpr constants set, '
                    'timed after the current one')
    ap.add_argument('--locate-variant', action='append', default=[],
                    help='NAME=CONSTANT=VALUE[,...]: a copy of '
                    'csrc/voronoi_locate.cu with those constants, timed '
                    'beside the current one')
    ap.add_argument('--columns', action='store_true',
                    help='also time the column calls of the phase runs\' '
                    'raytracing, as scripts/escape_column_ab.py does')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('escape_tau_ab: needs an NVIDIA card', file=sys.stderr)
        return 1
    import escape_tau_cycles as cyc
    old = load_old(args.old)
    card = cs.card_line()
    print(card, flush=True)
    old_src = Path(args.old) / 'hyperion_tpu_torch/transport/csrc/escape_tau.cu'
    print(json.dumps(dict(registers=dict(old=cyc.registers(old_src),
                                         new=cyc.registers()),
                          card=card)), flush=True)
    variants = {}
    if args.variant:
        import escape_column_ab as cab
        specs = [cab.parse_variant(v) for v in args.variant]
        for (name, consts), (lib, regs) in zip(
                specs, cab.build_variants([tuple(sorted(c.items()))
                                           for _, c in specs])):
            variants[name] = lib
            print(json.dumps(dict(variant=name, consts=consts,
                                  registers=regs, card=card)), flush=True)
    dev = torch.device('cuda')
    rows = []
    for name in args.models.split(','):
        make, batch = MODELS[name]
        lcalls = None
        if name in PHASE_RUNS:
            model, calls, ccalls, lcalls = record_phase(name)
        else:
            model = make()
            _, calls = cs.record_walks(model, batch, cs.WALK_WINDOWS)
        geo64 = build_geometry_tables(model.grid, dev, torch.float64)
        rho32 = _density_array(model, geo64.length_scale, dev, torch.float32)
        rho64 = _density_array(model, geo64.length_scale, dev, torch.float64)
        for first, last in cs.WALK_WINDOWS:
            rows.append(window(old, new, name, '%d-%d' % (first + 1, last),
                               calls[(first, last)], geo64,
                               rho32.T.contiguous(), rho64.T.contiguous(),
                               card, variants))
        if name in PHASE_RUNS and args.columns:
            import escape_column_ab as cab
            specs = [('new', {})] + [cab.parse_variant(v)
                                     for v in args.variant]
            built = cab.build_variants([tuple(sorted(c.items()))
                                        for _, c in specs])
            cvar = {vname: (lib, consts, regs) for (vname, consts),
                    (lib, regs) in zip(specs, built)}
            rows.append(cab.column_run(name, model, ccalls, old, new, cvar,
                                       card))
        if lcalls is not None:
            import escape_column_ab as cab
            rows += locate_ab(old, lcalls, card,
                              [cab.parse_variant(v)
                               for v in args.locate_variant])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
