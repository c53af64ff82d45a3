#!/usr/bin/env python3
"""Where a crossing of the escape_tau kernel spends its cycles, on one card.

    python3 scripts/escape_tau_cycles.py [--models class1_cyl,orion_amr] \
        [--old _checkout/old] [--registers]

Builds an instrumented copy of csrc/escape_tau.cu (clock64() around the
parts of a crossing, summed into a device table; the arithmetic is the
kernel's own) into hyperion_tpu_torch/_build/, or with ``--old`` that of
an earlier ``hyperion_tpu_torch/`` in that directory (from ``git archive``;
one whose EscapeTau walks (V, B) directions, bound through its own
wrapper, loaded as scripts/escape_tau_ab.py loads it), records the walk calls of imaging steps 41-60
of class2 (examples/class2_sed.py, B = 50,000), of the quickstart (B =
125,000), of BASELINE config 3 (chip_smoke.class1_cyl_model,
cylindrical-polar, B = 25,000) and of BASELINE config 5
(chip_smoke.orion_amr_model, AMR, B = 131,072) with
chip_smoke.record_walks, and runs, with the instrumented library in place
of the kernel's:

- the window's longest ray alone (its lane the only active one, its view
  the only one): SM cycles per crossing from the ray's start to its end,
  in the crossing's body, and in the parts of the crossing: for a
  spherical or cylindrical grid the six wall candidates and find_cell at
  the landing point; for an AMR grid the cell's walls (with the decode of
  the flat cell where the source decodes it at every crossing), the box
  exit with the move and the probe, the locate of the probe, and the rest
  (the snap); the share of crossings walked again with the operators'
  arithmetic after a fast path's check failed (``retry_share``);
- every call of the window: the same figures averaged over all crossings.

``--registers`` builds the source (uninstrumented) with -Xptxas -v and
prints each walk kernel's registers and spill bytes, and the resident
blocks of each mode's kernel on each model's grid (EscapeTau.plan).
Prints the card and one JSON object per model. The clock reads and the
table's atomics add a few tens of cycles to each part.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'scripts'))

import chip_smoke as cs  # noqa: E402

# the device table's words
SLOTS = dict(ray=0, candidates=1, find_cell=2, body=3, crossings=4,
             retries=5, walls=6, box_exit=7, locate=8, rest=9)
N_SLOTS = 16
# Markers in the source: (marker, times found, probe put before it or
# after it, what the probe does). 'start' sets the part's clock;
# ('split', slot) adds the cycles since the part's clock to slot and
# restarts it. Each set belongs to one design of the source; the first set
# whose markers are all found is used.
COMMON = [
    ('        walking = true;\n', 1, 'after', 'ray_start'),
    ('      // one crossing\n', 1, 'after', 'body_start'),
    ('      ++steps;\n', 1, 'after', 'body_end'),
    ('        walking = false;\n', 1, 'after', 'ray_end'),
]
MARKER_SETS = {
    # the AMR and cylindrical crossings redesigned: the fab carried with
    # the lane, an indexed locate, both on the Fast arithmetic
    'indexed': COMMON + [
        ('  if (!fast.ok) {\n', 1, 'after', ('count', 'retries')),
        ('  const double big = DBL_MAX / 8.0;\n  const double b = x * kx',
         1, 'before', 'start'),
        ('  const double big = DBL_MAX / 8.0;\n  const double eps = cyl_eps',
         1, 'before', 'start'),
        ('  t = tmin;\n', 2, 'after', ('split', 'candidates')),
        ('  return i1 >= 0 && i1 < g.n1;\n', 1, 'before',
         ('split', 'find_cell')),
        ('  return i1 < g.n1 && i2 >= 0 && i2 < g.n2 && w2 >= g.w[1][0];\n',
         1, 'before', ('split', 'find_cell')),
        ('  const AmrTables a = amr_tables(g);\n  const int idx', 1, 'before',
         'start'),
        ('  double w[3];\n  const int ax = box_exit(ops, lo, hi,', 1,
         'before', ('split', 'walls')),
        ('  const bool found = amr_locate(', 1, 'before',
         ('split', 'box_exit')),
        ('  // the snap onto the crossed wall\n', 1, 'before',
         ('split', 'locate')),
        ('  return found && !same;\n', 1, 'before', ('split', 'rest')),
    ],
    # the source before that (commit 98bb6b9): the AMR cell decoded and
    # the fabs searched one by one at every crossing, the cylindrical
    # crossing on the operators. Kept only to reproduce PERF.md's split
    # before the redesign (--old on that commit); the next redesign of
    # these crossings replaces it with the markers of its own parent.
    'searched': COMMON + [
        ('  if (!fast.ok) {\n', 1, 'after', ('count', 'retries')),
        ('  const double big = DBL_MAX / 8.0;\n  const double b = x * kx',
         1, 'before', 'start'),
        ('  const double big = DBL_MAX / 8.0;\n  const double eps = cyl_eps',
         1, 'before', 'start'),
        ('  t = tmin;\n', 2, 'after', ('split', 'candidates')),
        ('  return i1 >= 0 && i1 < g.n1;\n', 1, 'before',
         ('split', 'find_cell')),
        ('  return i1 < g.n1 && i2 >= 0 && i2 < g.n2 && w2 >= g.w[1][0];\n',
         1, 'before', ('split', 'find_cell')),
        ('  const Fabs f = fabs_of(g);\n', 1, 'after', 'start'),
        ('  double w[3];\n  const int ax = box_exit(lo, hi,', 1,
         'before', ('split', 'walls')),
        ('  const int next = amr_locate(f, xp, yp, zp, kx, ky, kz);\n', 1,
         'before', ('split', 'box_exit')),
        ('  if (ax == 0) x = w[0];\n  if (ax == 1) y = w[1];\n'
         '  if (ax == 2) z = w[2];\n  const bool inside = next', 1,
         'before', ('split', 'locate')),
        ('  cell = next;\n  return inside;\n', 1, 'before',
         ('split', 'rest')),
    ],
}


def _probe_text(what):
    if what == 'ray_start':
        return '        ray0 = clock64();\n'
    if what == 'body_start':
        return '      const long long w0 = clock64();\n'
    if what == 'body_end':
        return ('      atomicAdd(&probe[%d], (unsigned long long)'
                '(clock64() - w0));\n      atomicAdd(&probe[%d], 1ull);\n'
                % (SLOTS['body'], SLOTS['crossings']))
    if what == 'ray_end':
        return ('        atomicAdd(&probe[%d], (unsigned long long)'
                '(clock64() - ray0));\n' % SLOTS['ray'])
    if what == 'start':
        return '  long long pc = clock64();\n'
    kind, slot = what
    if kind == 'count':
        return '    atomicAdd(&probe[%d], 1ull);\n' % SLOTS[slot]
    return ('  { const long long pn = clock64(); atomicAdd(&probe[%d], '
            '(unsigned long long)(pn - pc)); pc = pn; }\n' % SLOTS[slot])


def marker_set(src):
    """(name, markers) of the first marker set whose markers are all found
    in ``src`` as often as they should be."""
    for name, markers in MARKER_SETS.items():
        if all(src.count(m) == times for m, times, _, _ in markers):
            return name, markers
    raise RuntimeError('escape_tau_cycles: no marker set matches the source')


def instrumented_source(path=None):
    """The kernel's source (csrc/escape_tau.cu, or ``path``) with the
    probes; raises if no marker set matches it."""
    path = path or ROOT / 'hyperion_tpu_torch/transport/csrc/escape_tau.cu'
    src = Path(path).read_text()
    _, markers = marker_set(src)
    src = src.replace('namespace {\n', '__device__ unsigned long long '
                      'probe[%d];\nnamespace {\n' % N_SLOTS, 1)
    for marker, _, where, what in markers:
        text = _probe_text(what)
        src = src.replace(marker, text + marker if where == 'before'
                          else marker + text)
    src = src.replace('  bool walking = false;\n',
                      '  bool walking = false;\n  long long ray0 = 0;\n', 1)
    return src + '''
extern "C" int probe_read(unsigned long long* h) {
  cudaDeviceSynchronize();
  return (int)cudaMemcpyFromSymbol(h, probe, sizeof(probe));
}
extern "C" int probe_zero() {
  unsigned long long z[%d] = {0};
  return (int)cudaMemcpyToSymbol(probe, z, sizeof(z));
}
''' % N_SLOTS


def build(source=None):
    from hyperion_tpu_torch.transport import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = 'old' if source else 'new'
    src = _build.BUILD_DIR / ('escape_tau_cycles_%s.cu' % tag)
    lib = _build.BUILD_DIR / ('libescape_tau_cycles_%s.so' % tag)
    src.write_text(instrumented_source(source))
    subprocess.run([_build._nvcc()] + _build._flags('escape_tau') +
                   ['-o', str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


KIND_NAMES = {'0': 'cartesian', '1': 'spherical', '2': 'cylindrical',
              '3': 'octree', '4': 'amr', '5': 'voronoi'}


def ptxas_registers(text):
    """{kernel: (registers, spill store bytes)} of the walk kernels in
    -Xptxas -v output."""
    regs, name, spill = {}, None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '.*?walk_kernel"
                      r"I([fd])Li(\d)ELb(\d)ELi(\d+)E", line)
        if m:
            typ, kind, cols, n = m.groups()
            name = '%s %s %s block %s' % (
                'f32' if typ == 'f' else 'f64', KIND_NAMES[kind],
                'columns' if cols == '1' else 'tau', n)
            continue
        m = re.search(r'(\d+) bytes spill stores', line)
        if m:
            spill = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            regs[name] = (int(m.group(1)), spill)
            name = None
    return regs


def registers(source=None):
    """The walk kernels' registers and spills: the source built with the
    library's flags and -Xptxas -v."""
    from hyperion_tpu_torch.transport import _build
    source = source or _build.CSRC / 'escape_tau.cu'
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / 'libescape_tau_registers.so'
    proc = subprocess.run([_build._nvcc()] + _build._flags('escape_tau') +
                          ['-Xptxas', '-v', '-o', str(out), str(source)],
                          capture_output=True, text=True, check=True)
    return ptxas_registers(proc.stdout + proc.stderr)


def measure(lib, walk, call):
    h = (ctypes.c_ulonglong * N_SLOTS)()
    for _ in range(3):      # the last of three runs
        lib.probe_zero()
        walk(*call[:9], t_max=call[9])
        lib.probe_read(h)
    n = max(h[SLOTS['crossings']], 1)
    # the parts of another kind of grid's crossing are 0
    out = dict(crossings=int(h[SLOTS['crossings']]),
               ray_cycles_per_crossing=h[SLOTS['ray']] / n,
               body_cycles=h[SLOTS['body']] / n,
               retry_share=h[SLOTS['retries']] / n)
    for part in ('candidates', 'find_cell', 'walls', 'box_exit', 'locate',
                 'rest'):
        out[part + '_cycles'] = h[SLOTS[part]] / n
    return out


MODELS = {
    'class2': (lambda: cs.class2_model(n_photons=200_000), 50_000),
    'quickstart': (cs.tutorial_model, 125_000),
    'class1_cyl': (cs.class1_cyl_model, 25_000),
    'orion_amr': (lambda: cs.orion_amr_model(
        cs.AMR_CUT['n_photons'], cs.AMR_CUT['n_iterations'],
        cs.AMR_CUT['n_imaging'])[0], cs.AMR_CUT['batch_size']),
}


def main():
    import torch
    import escape_tau_ab as ab
    from hyperion_tpu_torch.model.run import (_density_array,
                                              build_geometry_tables)
    from hyperion_tpu_torch.transport import _build
    from hyperion_tpu_torch.transport import escape_tau as et

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--models', default=','.join(MODELS))
    ap.add_argument('--old', default=None,
                    help='a directory holding an earlier hyperion_tpu_torch/ '
                    'to measure instead of the current one')
    ap.add_argument('--registers', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('escape_tau_cycles: needs an NVIDIA card', file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    # the package whose kernel is measured: the current one, or the old one
    walk_mod, build_mod, source = et, _build, None
    if args.old:
        old = ab.load_old(args.old)
        walk_mod, build_mod = old, sys.modules['old_port.transport._build']
        source = (Path(args.old) / 'hyperion_tpu_torch/transport/csrc/'
                  'escape_tau.cu').resolve()
    design = marker_set(Path(source or _build.CSRC / 'escape_tau.cu')
                        .read_text())[0]
    if args.registers:
        print(json.dumps(dict(registers=registers(source), design=design,
                              card=card)), flush=True)
    lib = build(source)
    dev = torch.device('cuda')
    window = (40, 60)
    for name in args.models.split(','):
        make, batch = MODELS[name]
        model = make()
        # record with the kernel, then probe with the instrumented copy
        rho32, calls = cs.record_walks(model, batch, (window,))
        calls = calls[window]
        geo64 = build_geometry_tables(model.grid, dev, torch.float64)
        rho64 = _density_array(model, geo64.length_scale, dev, torch.float64)
        c, v, i, n_cross = ab.longest_ray(geo64, rho64.T.contiguous(), calls,
                                          et)
        call = calls[c]
        one = torch.zeros_like(call[8])
        one[i] = True
        lone = call[:4] + [k[v:v + 1].contiguous() for k in call[4:7]] + \
            [call[7], one, None if call[9] is None else
             call[9][v:v + 1].contiguous()]
        kernel = build_mod._loaded.get('escape_tau')
        build_mod._loaded['escape_tau'] = lib
        try:
            walk = walk_mod.EscapeTau(
                ab.as_old(geo64, old) if args.old else geo64,
                rho32.T.contiguous())
            plan = walk.plan
            alone = measure(lib, walk, lone)
            every = [measure(lib, walk, x) for x in calls]
        finally:
            build_mod._loaded['escape_tau'] = kernel
        n = sum(e['crossings'] for e in every)
        mean = {k: sum(e[k] * e['crossings'] for e in every) / n
                for k in every[0] if k != 'crossings'}
        print(json.dumps(dict(model=name, design=design,
                              steps='%d-%d' % (window[0] + 1, window[1]),
                              longest_ray=dict(alone, expected=n_cross),
                              every_call=dict(mean, crossings=n),
                              resident_blocks=plan['resident_blocks'],
                              card=card)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
