#!/usr/bin/env python3
"""Time an earlier escape_column design beside the current one on one card,
on the column calls the raytracing pass makes.

    git archive <rev> hyperion_tpu_torch | tar -x -C _checkout/old
    python3 scripts/escape_column_ab.py --old _checkout/old [--se-dir DIR] \
        [--models class2,quickstart,class1_cyl,orion_amr,voronoi_cloud] \
        [--variant NAME=CONSTANT=VALUE[,CONSTANT=VALUE...] ...]

``--old`` is a directory holding an earlier ``hyperion_tpu_torch/`` whose
``EscapeTau`` has a block clock (commit 98bb6b9, before the AMR and
cylindrical crossings were redesigned, or a later one), loaded under
another package name (scripts/escape_tau_ab.py's ``load_old``). The
calls of ``class2`` and ``quickstart`` are those of chip_smoke.py's phase
11 (class2 raytracing, B = 50,000, 3 views) and phase 12 (b) (the
quickstart's monochromatic raytracing, B = 125,000, 1 view), recorded with
``chip_smoke.column_calls`` from run_lucy_model with the Monte-Carlo
imaging photons cut (the raytracing pass draws from its own generator, so
its calls are phase 11's and 12's). They start from phase 8's and phase
4's specific energies: computed here (1 Lucy iteration of 200,000 photons
capped at 8,000 steps; 4 of 500,000), or read from ``--se-dir``
(``class2_specific_energy.npy`` and ``quickstart_specific_energy.npy``, as
chip_smoke.py writes them), and written there when absent. Those of
``class1_cyl``, ``orion_amr`` and ``voronoi_cloud`` are the raytracing
calls of phases 14 (BASELINE config 3), 17 (config 5) and 18 (config 4's
cloud on a Voronoi mesh), from the phase's own Lucy iterations
(scripts/escape_tau_ab.py's ``record_phase``). For each run it
prints:

- the ray lengths: the plain float64 walk's crossings, their mean,
  percentiles and the share of rays above each K;
- the K sweep: both designs with ``max_steps`` = K, the walks cut short:
  device us per call (the time of the first K crossings of every ray);
- the block end times on the call with the most crossings (each block's
  start and end from ``%globaltimer``, ``EscapeTau.block_clock`` of each
  design): the share of the call after the first block ends, when the
  card is not full;
- turns (old, then each variant, then the variants again in reverse,
  then old): device us per call (each call behind a
  ``torch.cuda._sleep``, CUDA events) and host us per call (each of
  HOST_CALLS eager calls or more timed alone on the host clock, the card
  drained after each pass over the calls: mean, median, p90); every
  design must give the same columns, to the bit. A variant is a copy of
  the current source with the named ``constexpr int`` constants set to
  other values (``kColumnChunkRays``, ``kColumnMinBlocks``,
  ``kBigBlock``, ``kBigBlockLean``, ``kTauMinBlocks``); ``new`` (the
  source as it is) is always the first. Each
  variant's registers and spills are read from ``-Xptxas -v``;
- the longest column ray of class2 alone (old and new): us per crossing;
- for class2 and the quickstart, the escape_tau walks of imaging steps
  41-60 (chip_smoke.record_walks) in turns, device and host us per call
  as above; and, with class2, escape_tau_cycles.py's SM cycles per
  crossing of the tau walk's longest ray beside that ray's us per
  crossing times the SM clock that ``nvidia-smi --query-gpu=clocks.sm``
  reports while it runs (scripts/escape_tau_ab.py times the walks of
  class1_cyl and orion_amr).

Prints the card and one JSON object per part, and writes
chip_smoke_out/escape_column_ab.json unless --out names another file.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'scripts'))

import chip_smoke as cs  # noqa: E402
import escape_tau_ab as ab  # noqa: E402
import escape_tau_cycles as cyc  # noqa: E402

ORDER = ['old', 'new', 'new', 'old']
K_SWEEP = (16, 32, 64, 128, 273)
# eager calls timed on the host clock per design and turn, at least
HOST_CALLS = 2000


def log(obj):
    print(json.dumps(obj), flush=True)
    return obj


# ------------------------------------------------------------------ inputs

def specific_energies(se_dir):
    """(class2's, the quickstart's) (n_dust, n_cells) specific energies,
    from ``se_dir`` or from Lucy iterations run here (phase 8's cut and
    phase 4's model)."""
    import torch
    from hyperion_tpu_torch.model import run_lucy_model
    files = None if se_dir is None else (
        Path(se_dir) / 'class2_specific_energy.npy',
        Path(se_dir) / 'quickstart_specific_energy.npy')
    if files and all(f.exists() for f in files):
        return tuple(np.load(f) for f in files)
    t0 = time.time()
    cut = cs.CLASS2_CUT
    # the imaging photons cut: they do not change the Lucy iterations
    m = cs.class2_model(cut['n_photons'], cut['n_iterations'], 1000)
    run = run_lucy_model(m, device='cuda', max_steps=cut['max_steps'],
                         imaging_max_steps=100)
    se8 = run.iterations[-1]['specific_energy']
    q = cs.tutorial_model()
    q.set_n_photons(initial=500_000, imaging=1000)
    se4 = run_lucy_model(q, device='cuda').iterations[-1]['specific_energy']
    torch.cuda.synchronize()
    log(dict(specific_energies_s=time.time() - t0))
    if files:
        Path(se_dir).mkdir(parents=True, exist_ok=True)
        for f, se in zip(files, (se8, se4)):
            np.save(f, se)
    return se8, se4


def record_columns(se8, se4):
    """[(name, model, calls)] of phase 11's and phase 12 (b)'s column calls
    (each call the eight lane tensors and t_max, float32)."""
    from hyperion_tpu_torch.model import run_lucy_model
    cut = cs.CLASS2_CUT
    m = cs.class2_model(cut['n_photons'], 0, 1000)
    m.set_raytracing(True)
    m.set_n_photons(initial=cut['n_photons'], imaging=1000, **cs.RAYTRACING)
    cs._given_specific_energy(m, se8)
    with cs.column_calls() as calls11:
        run_lucy_model(m, device='cuda', imaging_max_steps=100)
    q = cs.mono_model(se4, True)
    q.set_n_photons(initial=500_000, imaging_sources=1000, imaging_dust=1000,
                    **cs.RAYTRACING)
    with cs.column_calls() as calls12:
        run_lucy_model(q, device='cuda', batch_size=125_000)
    return [('class2', cs.class2_model(cut['n_photons']),
             [c for _, c in calls11]),
            ('quickstart', cs.tutorial_model(), [c for _, c in calls12])]


def tables(model):
    """(float64 geometry, float32 and float64 density transposes) on the
    card."""
    import torch
    from hyperion_tpu_torch.model.run import (_density_array,
                                              build_geometry_tables)
    dev = torch.device('cuda')
    geo64 = build_geometry_tables(model.grid, dev, torch.float64)
    rho = [_density_array(model, geo64.length_scale, dev, dt).T.contiguous()
           for dt in (torch.float32, torch.float64)]
    return geo64, rho[0], rho[1]


def crossings(geo64, rt64, calls, et):
    """Each call's (V, B) crossings of the plain float64 walk (0 for the
    rays of dead lanes)."""
    out = []
    for call in calls:
        c64 = cs._f64(call)
        _, n = et.escape_column_reference(geo64, rt64, *c64[:8],
                                          t_max=c64[8], crossings=True)
        out.append(n)
    return out


# ------------------------------------------------------------------ timing

def host_us(run, calls, n_calls=HOST_CALLS):
    """Host microseconds of ``run(call)``: each call timed alone on the host
    clock, passes over ``calls`` until ``n_calls`` are timed, the card
    drained between passes (so that no call waits for the launch queue);
    the mean, median and p90 over the calls."""
    import torch
    times = []
    while len(times) < n_calls:
        torch.cuda.synchronize()
        for call in calls:
            t0 = time.perf_counter()
            run(call)
            times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t = np.asarray(times) * 1e6
    return dict(mean=float(t.mean()), median=float(np.median(t)),
                p90=float(np.percentile(t, 90)), calls=len(t))


def block_ends(clock):
    """The end times of the blocks that ran, in us after the call's first
    start (integer nanoseconds subtracted before the conversion),
    ascending."""
    c = clock.cpu().numpy().reshape(-1, 2)
    c = c[c[:, 0] > 0]
    return np.sort((c[:, 1] - c[:, 0].min()).astype(np.float64) / 1e3)


def percentiles(a):
    return {('p%g' % q): float(np.percentile(a, q)) for q in (50, 90, 99)}


# ------------------------------------------------------------ variants

def parse_variant(spec):
    """NAME=CONSTANT=VALUE[,CONSTANT=VALUE...] -> (name, {constant: value})."""
    name, _, rest = spec.partition('=')
    consts = {}
    for item in filter(None, rest.split(',')):
        k, _, v = item.partition('=')
        consts[k.strip()] = int(v)
    return name, consts


def variant_source(consts, kernel='escape_tau'):
    """The current csrc/<kernel>.cu with each ``constexpr int NAME = ...;``
    of ``consts`` set to its value; raises if a constant is not found
    exactly once."""
    from hyperion_tpu_torch.transport import _build
    src = (_build.CSRC / (kernel + '.cu')).read_text()
    for name, value in consts.items():
        pattern = r'constexpr int %s = -?\d+;' % re.escape(name)
        if len(re.findall(pattern, src)) != 1:
            raise RuntimeError('escape_column_ab: constant %s not found once '
                               'in the source' % name)
        src = re.sub(pattern, 'constexpr int %s = %d;' % (name, value), src)
    return src


def build_variants(const_sets, kernel='escape_tau'):
    """A copy of the current csrc/<kernel>.cu built for each set of
    constants (the library's own flags, ptxas's -v among them), one nvcc
    each, all at once: [(ctypes library, {walk kernel: (registers, spill
    bytes)})]."""
    import hashlib
    from hyperion_tpu_torch.transport import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = _build._flags(kernel)
    jobs = []
    for consts in const_sets:
        src = variant_source(dict(consts), kernel)
        tag = hashlib.sha256((src + ' '.join(flags)).encode()).hexdigest()[:16]
        cu = _build.BUILD_DIR / ('%s_variant_%s.cu' % (kernel, tag))
        lib = _build.BUILD_DIR / ('lib%s_variant_%s.so' % (kernel, tag))
        cu.write_text(src)
        jobs.append((lib, subprocess.Popen(
            [_build._nvcc()] + flags + ['-o', str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for lib, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('escape_column_ab: nvcc failed:\n' + text)
        out.append((ctypes.CDLL(str(lib)), cyc.ptxas_registers(text)))
    return out


def variant_walk(new, lib, geo64, rt, max_steps=100000):
    """The current EscapeTau bound to the variant library ``lib``."""
    from hyperion_tpu_torch.transport import _build
    own = _build._loaded.get('escape_tau')
    _build._loaded['escape_tau'] = lib
    try:
        return new.EscapeTau(geo64, rt, max_steps=max_steps)
    finally:
        if own is None:
            _build._loaded.pop('escape_tau')
        else:
            _build._loaded['escape_tau'] = own


# ------------------------------------------------------- the old design

def old_walk(old, geo64, rt, max_steps=100000):
    """The old design's EscapeTau."""
    return old.EscapeTau(ab.as_old(geo64, old), rt, max_steps=max_steps)


# ------------------------------------------------------------------ parts

def ends_summary(v):
    """The blocks' end times (us, ascending): when the first and the last
    end, percentiles, and the busy share (mean end over last end: the
    share of the blocks' time until the last end that they ran)."""
    return dict(blocks=len(v), first_end_us=float(v[0]),
                last_end_us=float(v[-1]), **percentiles(v),
                busy_share=float(v.mean() / v[-1]))


def column_run(name, model, calls, old, new, variants, card):
    import torch
    geo64, rt32, rt64 = tables(model)
    n_cross = crossings(geo64, rt64, calls, new)
    live = torch.cat([n[n > 0] for n in n_cross]).cpu().numpy()
    longest = int(live.max())
    lengths = dict(rays=int(live.size), mean=float(live.mean()),
                   max=longest, **percentiles(live),
                   share_above={k: float((live > k).mean()) for k in K_SWEEP},
                   histogram=np.histogram(live, bins=[1, 2, 4, 8, 16, 32, 64,
                                                      128, 256, 512, 1024]
                                          )[0].tolist())
    log(dict(part='lengths', run=name, **lengths, card=card))

    w_old = old_walk(old, geo64, rt32)
    walks = {vname: variant_walk(new, lib, geo64, rt32)
             for vname, (lib, _, _) in variants.items()}

    def runner(w):
        return lambda call: w.columns(*call[:8], t_max=call[8])
    run_old = runner(w_old)
    # the same columns from every design
    for vname, w in walks.items():
        for call in calls:
            a, b = runner(w)(call), run_old(call)
            if not torch.equal(a, b):
                raise AssertionError('%s %s: the designs disagree by %g'
                                     % (name, vname,
                                        float((a - b).abs().max())))

    # K sweep: both designs with every walk cut at K crossings
    lib_new = variants['new'][0]
    sweep = []
    for k in K_SWEEP:
        sweep.append(log(dict(
            part='k_sweep', run=name, K=k,
            old_us=ab.event_us(runner(old_walk(old, geo64, rt32,
                                               max_steps=k)), calls),
            new_us=ab.event_us(runner(variant_walk(new, lib_new, geo64, rt32,
                                                   max_steps=k)), calls),
            card=card)))

    # block end times on the call with the most crossings: the old design
    # and each variant
    big = max(range(len(calls)), key=lambda j: int(n_cross[j].sum()))
    call = calls[big]
    ends = {}
    for vname, w in walks.items():
        w.block_clock = torch.zeros(w.clock_words(), dtype=torch.int64,
                                    device='cuda')
        runner(w)(call)
        torch.cuda.synchronize()
        ends[vname] = ends_summary(block_ends(w.block_clock))
        w.block_clock = None
    w_old.block_clock = torch.zeros(w_old.clock_words(), dtype=torch.int64,
                                    device='cuda')
    run_old(call)
    torch.cuda.synchronize()
    ends['old'] = ends_summary(block_ends(w_old.block_clock))
    w_old.block_clock = None
    log(dict(part='block_ends', run=name, call=big,
             crossings=int(n_cross[big].sum()), card=card, **ends))

    # turns: old, the variants, the variants in reverse, old
    order = ['old'] + list(walks) + list(walks)[::-1] + ['old']
    turns = []
    for d in order:
        run = run_old if d == 'old' else runner(walks[d])
        turns.append(dict(design=d, device_us=ab.event_us(run, calls),
                          host_us=host_us(run, calls)))
    per_variant = {vname: dict(consts=variants[vname][1],
                               registers=variants[vname][2], plan=w.plan)
                   for vname, w in walks.items()}
    log(dict(part='turns', run=name, turns=turns, variants=per_variant,
             card=card))

    # the longest ray alone, less the same call with no live lane
    c = max(range(len(calls)), key=lambda j: int(n_cross[j].max()))
    v, i = divmod(int(n_cross[c].argmax()), n_cross[c].shape[1])
    call = calls[c]
    lone = []
    for on in (True, False):
        act = torch.zeros_like(call[7])
        act[i] = on
        lone.append(call[:3] + [k[v:v + 1].contiguous() for k in call[3:6]]
                    + [call[6], act, None if call[8] is None else
                       call[8][v:v + 1].contiguous()])
    latency = {}
    for design, run in (('old', run_old), ('new', runner(walks['new']))):
        us = [ab.event_us(run, [x], reps=5) for x in lone]
        latency[design] = dict(alone_us=us[0], empty_us=us[1],
                               us_per_crossing=(us[0] - us[1]) / longest)
    log(dict(part='longest_ray', run=name, crossings=longest,
             latency=latency, card=card))
    return dict(run=name, lengths=lengths, sweep=sweep, ends=ends,
                turns=turns, variants=per_variant, latency=latency)


def tau_run(name, make, batch, old, new, card):
    """escape_tau on the walks of imaging steps 41-60: old and new in
    turns, device and host us per call."""
    import torch
    model = make()
    window = (40, 60)
    rho32, calls = cs.record_walks(model, batch, (window,))
    calls = calls[window]
    geo64, rt32, _ = tables(model)
    w_new = new.EscapeTau(geo64, rt32)
    w_old = old_walk(old, geo64, rt32)

    def run_new(call):
        return w_new(*call[:9], t_max=call[9])

    def run_old(call):
        return w_old(*call[:9], t_max=call[9])
    for call in calls:
        if not torch.equal(run_new(call), run_old(call)):
            raise AssertionError('escape_tau %s: the designs disagree' % name)
    runs = {'old': run_old, 'new': run_new}
    turns = [dict(design=d, device_us=ab.event_us(runs[d], calls),
                  host_us=host_us(runs[d], calls)) for d in ORDER]
    return log(dict(part='escape_tau', run=name, steps='41-60',
                    calls=len(calls), turns=turns, card=card))


class SmClock:
    """Samples ``nvidia-smi --query-gpu=clocks.sm`` (MHz) in a thread while
    the block runs."""

    def __enter__(self):
        self.samples, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ['nvidia-smi', '--query-gpu=clocks.sm',
                 '--format=csv,noheader,nounits', '-i', '0'],
                capture_output=True, text=True)
            if out.returncode == 0 and out.stdout.strip():
                self.samples.append(float(out.stdout.split()[0]))
            self._stop.wait(0.1)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def cycles_vs_clock(card):
    """escape_tau_cycles.py's SM cycles per crossing of class2's longest
    tau ray (steps 41-60) beside the same ray's us per crossing (alone,
    less an empty call) times the SM clock sampled while it runs."""
    import torch
    from hyperion_tpu_torch.transport import _build
    from hyperion_tpu_torch.transport import escape_tau as et
    make, batch = ab.MODELS['class2']
    model = make()
    window = (40, 60)
    rho32, calls = cs.record_walks(model, batch, (window,))
    calls = calls[window]
    geo64, rt32, rt64 = tables(model)
    c, v, i, n_cross = ab.longest_ray(geo64, rt64, calls, et)
    call = calls[c]
    lone = []
    for on in (True, False):
        act = torch.zeros_like(call[8])
        act[i] = on
        lone.append(call[:4] + [k[v:v + 1].contiguous() for k in call[4:7]]
                    + [call[7], act, None if call[9] is None else
                       call[9][v:v + 1].contiguous()])
    walk = et.EscapeTau(geo64, rt32)

    def run(x):
        return walk(*x[:9], t_max=x[9])
    with SmClock() as clk:
        us = [ab.event_us(run, [x], reps=200) for x in lone]
    us_per = (us[0] - us[1]) / n_cross
    lib = cyc.build()
    kernel = _build._loaded.get('escape_tau')
    _build._loaded['escape_tau'] = lib
    try:
        probed = cyc.measure(lib, et.EscapeTau(geo64, rt32), lone[0])
    finally:
        _build._loaded['escape_tau'] = kernel
    mhz = float(np.median(clk.samples)) if clk.samples else float('nan')
    return log(dict(part='cycles_vs_clock', crossings=n_cross,
                    us_per_crossing=us_per, sm_clock_mhz=mhz,
                    sm_clock_samples=len(clk.samples),
                    sm_clock_range=[min(clk.samples, default=0),
                                    max(clk.samples, default=0)],
                    cycles_from_us=us_per * mhz,
                    probe_cycles_per_crossing=probed[
                        'ray_cycles_per_crossing'],
                    probe_body_cycles=probed['body_cycles'], card=card))


def main():
    import torch
    from hyperion_tpu_torch.transport import escape_tau as new

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old', required=True,
                    help='a directory holding an earlier hyperion_tpu_torch/')
    ap.add_argument('--se-dir', default=None,
                    help='where the specific energies are read from, or '
                    'written to when absent')
    ap.add_argument('--out', default=str(cs.OUT / 'escape_column_ab.json'))
    ap.add_argument('--models', default='class2,quickstart')
    ap.add_argument('--variant', action='append', default=[],
                    help='NAME=CONSTANT=VALUE[,CONSTANT=VALUE...]: a copy of '
                    'the current source with those constexpr constants set')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('escape_column_ab: needs an NVIDIA card', file=sys.stderr)
        return 1
    old = ab.load_old(args.old)
    card = cs.card_line()
    print(card, flush=True)
    models = args.models.split(',')
    specs = [('new', {})] + [parse_variant(spec) for spec in args.variant]
    built = build_variants([tuple(sorted(c.items())) for _, c in specs])
    variants = {}
    for (vname, consts), (lib, regs) in zip(specs, built):
        variants[vname] = (lib, consts, regs)
        log(dict(part='variant', name=vname, consts=consts, registers=regs))
    runs = []
    if {'class2', 'quickstart'} & set(models):
        se8, se4 = specific_energies(args.se_dir)
        runs += [r for r in record_columns(se8, se4) if r[0] in models]
    for name in models:
        if name in ab.PHASE_RUNS:
            model, _, calls, _ = ab.record_phase(name, windows=())
            runs.append((name, model, calls))
    out = dict(card=card, columns=[], tau=[])
    for name, model, calls in runs:
        out['columns'].append(column_run(name, model, calls, old, new,
                                         variants, card))
    for name in models:
        if name not in ab.PHASE_RUNS:
            make, batch = ab.MODELS[name]
            out['tau'].append(tau_run(name, make, batch, old, new, card))
    if 'class2' in models:
        out['cycles'] = cycles_vs_clock(card)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
