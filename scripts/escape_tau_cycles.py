#!/usr/bin/env python3
"""Where a crossing of the escape_tau kernel spends its cycles, on one card.

    python3 scripts/escape_tau_cycles.py [--models class1_cyl,orion_amr,\
voronoi_cloud,sph_octree] [--old _checkout/old] [--registers]

Builds an instrumented copy of csrc/escape_tau.cu (clock64() around the
parts of a crossing, summed into a device table; the arithmetic is the
kernel's own) into hyperion_tpu_torch/_build/, or with ``--old`` that of
an earlier ``hyperion_tpu_torch/`` in that directory (from ``git archive``;
one whose EscapeTau walks (V, B) directions, bound through its own
wrapper, loaded as scripts/escape_tau_ab.py loads it), records the walk
calls of imaging steps 41-60 of class2 (examples/class2_sed.py, B =
50,000), of the quickstart (B = 125,000), of BASELINE config 3
(chip_smoke.class1_cyl_model, cylindrical-polar, B = 25,000) and of
BASELINE config 5 (chip_smoke.orion_amr_model, AMR, B = 131,072) with
chip_smoke.record_walks, and those of chip_smoke.py's phases 16
(sph_octree, BASELINE config 4, B = 131,072) and 18 (voronoi_cloud, B =
131,072) from the phase's own run (escape_tau_ab.record_phase), and runs,
with the instrumented library in place of the kernel's:

- the window's longest ray alone (its lane the only active one, its view
  the only one): SM cycles per crossing from the ray's start to its end,
  in the crossing's body, and in the parts of the crossing: for a
  spherical or cylindrical grid the six wall candidates and find_cell at
  the landing point; for an AMR grid the cell's walls (with the decode of
  the flat cell where the source decodes it at every crossing), the box
  exit with the move and the probe, the locate of the probe, and the rest
  (the snap); for a Voronoi grid the reads of the row (its neighbours'
  ids, or its packed entries' ends), of the sites, the divisions, the
  argmin and the box exit, and the neighbours read and divisions taken
  per crossing; for an octree the leaf's walls (their loads issued, and
  the ancestors' records where the source loads them), the box exit with
  the move and the root-box test (a load's wait falls where its value is
  first used: the leaf's walls' in the box exit), the walk up, the
  descend, and the records read going up and down per crossing (the
  source of commit c41ab2d descends from the root: no walk up); the share
  of crossings walked again with the operators'
  arithmetic after a fast path's check failed (``retry_share``);
- every call of the window: the same figures averaged over all crossings;
  on an octree also the levels of the descend from the root a crossing
  (``root_levels_per_crossing``, chip_smoke.walk_work's count, which sets
  the bound).

``--registers`` prints each walk kernel's registers and spill bytes as
ptxas reported them when the library was built (-Xptxas -v is among its
flags; with ``--old``, the old source built with them), and the resident
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
             retries=5, walls=6, box_exit=7, locate=8, rest=9, row=10,
             sites=11, divisions=12, argmin=13, neighbours=14, divided=15,
             walk_up=16, descend=17, levels_up=18, levels_down=19)
N_SLOTS = 20
# Markers in the source: (marker, times found, probe put before it or
# after it, what the probe does). 'start' sets the part's clock;
# ('split', slot) adds the cycles since the part's clock to slot and
# restarts it; ('count', slot) adds one to slot, ('add', slot, expr) the
# value of expr. Each set belongs to one design of the source; the first
# set whose markers are all found is used.
COMMON = [
    ('        walking = true;\n', 1, 'after', 'ray_start'),
    ('      // one crossing\n', 1, 'after', 'body_start'),
    ('      ++steps;\n', 1, 'after', 'body_end'),
    ('        walking = false;\n', 1, 'after', 'ray_end'),
]
# the AMR and cylindrical crossings as redesigned in commit 41f3206: the fab
# carried with the lane, an indexed locate, both on the Fast arithmetic
BOXES = [
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
]
# the Voronoi crossing over packed rows (commit c41ab2d): the row's sites
# and the neighbours' (id, offset) read a chunk at a time, the division
# only where a plane can win. Its parts: row, the first chunk's loads
# issued; box_exit, the box planes (while the row arrives) and the escape
# test and move; sites, a neighbour's wait for its entry and its normal;
# divisions, the skip test and the divisions taken; argmin, the update
PACKED = [
        ('  const double big = DBL_MAX / 8.0;\n  const double* es = g.w[2]',
         1, 'before', 'start'),
        ('  const int deg = __ldg(g.ints + cell + 1) - off;\n', 1, 'after',
         ('add', 'neighbours', 'deg')),
        ('  // the box exit while the row arrives\n', 1, 'before',
         ('split', 'row')),
        ('  // argmin over the row: the first of the least, big where none '
         'crosses\n  // (then', 1, 'before', ('split', 'box_exit')),
        ('      const double denom = kx * nvx + ky * nvy + kz * nvz;\n', 1,
         'after', ('split', 'sites')),
        ('      const bool lost = vor_beyond(numer, denom, t_best);\n', 1,
         'after', ('split', 'divisions')),
        ('      tn = tn < 0.0 ? 0.0 : tn;\n', 1, 'after',
         ('split', 'divisions')),
        ('      tn = tn < 0.0 ? 0.0 : tn;\n', 1, 'after', ('count', 'divided')),
        ('        best = m[u];\n      }\n', 1, 'after', ('split', 'argmin')),
        ('  cell = best.x;\n  off = best.y;\n', 1, 'before',
         ('split', 'box_exit')),
]
MARKER_SETS = {
    # the octree crossing over node records: the leaf's walls and its
    # parent's record read together, the climb from the parent to the
    # first ancestor that holds the landing point (comparing centres), the
    # descend from it (the tau kernel's reads, which this script probes).
    # Its parts: walls, the loads issued; box_exit, the exit (with the wait
    # for the leaf's walls), the move, the snap and the root-box test;
    # walk_up, the setters' tests and the climb, a record a level; descend,
    # a record a level down; the records read up (the parent's counted)
    # and the levels down are counted
    'walkup': COMMON + BOXES + PACKED + [
        ('  const double* rec = g.w[0];\n  const double* box = g.w[1];\n'
         '  const double* r = oct_record(rec, node) + 8;\n', 1, 'before',
         'start'),
        ('  OctNode n;\n  if (!kLean) n = oct_node<true>(rec, id);\n', 1,
         'after', ('count', 'levels_up')),
        ('  double w[3];\n  const int ax = box_exit(lo, hi, x,', 1, 'before',
         ('split', 'walls')),
        ('  // the walls of the leaf that the landing point lies on and '
         'moves onto\n', 1, 'before', ('split', 'box_exit')),
        ('      n = oct_node<!kLean>(rec, id);\n', 1, 'after',
         ('count', 'levels_up')),
        ('  // the descend from it\n', 1, 'before', ('split', 'walk_up')),
        ('    const int child = oct_child<!kLean>(rec, id, n, o);\n', 1,
         'after', ('count', 'levels_down')),
        ('      node = child;\n      parent = id;\n', 1, 'before',
         ('split', 'descend')),
    ],
    # the source of commit c41ab2d: the octree crossing reads the leaf's
    # walls, then descends from the root, a centre and a child index a
    # level (the leaf's own row read too). Kept to reproduce PERF.md's
    # split before the node records (--old on that commit); the next
    # redesign replaces it with its own parent's.
    'packed': COMMON + BOXES + PACKED + [
        ('  const double* lo = g.w[0];\n  const double* hi = g.w[1];\n', 1,
         'before', 'start'),
        ('                         __ldg(hi + n3 + 2)};\n', 1, 'after',
         ('split', 'walls')),
        ('  // find_cell at the landing point\n  const bool inside = within(',
         1, 'before', ('split', 'box_exit')),
        ('    const int child = __ldg(g.ints + 8LL * n + octant);\n', 1,
         'after', ('count', 'levels_down')),
        ('  node = n;\n  return inside;\n', 1, 'before',
         ('split', 'descend')),
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
    if what[0] == 'add':
        return '  atomicAdd(&probe[%d], (unsigned long long)(%s));\n' % (
            SLOTS[what[1]], what[2])
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
    proc = subprocess.run([_build._nvcc()] + _build._flags('escape_tau') +
                          ['-o', str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError('escape_tau_cycles: nvcc failed:\n' + proc.stderr)
    return ctypes.CDLL(str(lib))


KIND_NAMES = {'0': 'cartesian', '1': 'spherical', '2': 'cylindrical',
              '3': 'octree', '4': 'amr', '5': 'voronoi'}


def ptxas_registers(text):
    """{kernel: (registers, spill store bytes)} of the walk kernels in
    -Xptxas -v output, named by type, kind, mode and block."""
    from hyperion_tpu_torch.transport import _build
    regs = {}
    for entry, res in _build.ptxas_resources(text).items():
        m = re.search(r'walk_kernelI([fd])Li(\d)ELb(\d)ELi(\d+)E', entry)
        if m:
            typ, kind, cols, n = m.groups()
            regs['%s %s %s block %s' % (
                'f32' if typ == 'f' else 'f64', KIND_NAMES[kind],
                'columns' if cols == '1' else 'tau', n)] = res
    return regs


def registers(source=None):
    """The walk kernels' registers and spills: ptxas's report from the
    library's build (-Xptxas -v is among its flags), or ``source`` built
    with the same flags."""
    from hyperion_tpu_torch.transport import _build
    if source is None:
        _build.build('escape_tau')
        return ptxas_registers(_build.ptxas_log('escape_tau'))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / 'libescape_tau_registers.so'
    proc = subprocess.run([_build._nvcc()] + _build._flags('escape_tau') +
                          ['-o', str(out), str(source)],
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
                 'rest', 'row', 'sites', 'divisions', 'argmin', 'walk_up',
                 'descend'):
        out[part + '_cycles'] = h[SLOTS[part]] / n
    # the Voronoi crossing's neighbours read and divisions taken, the
    # octree's records read going up and down, per crossing
    for count in ('neighbours', 'divided', 'levels_up', 'levels_down'):
        out[count + '_per_crossing'] = h[SLOTS[count]] / n
    return out


MODELS = {
    'class2': (lambda: cs.class2_model(n_photons=200_000), 50_000),
    'quickstart': (cs.tutorial_model, 125_000),
    'class1_cyl': (cs.class1_cyl_model, 25_000),
    'orion_amr': (lambda: cs.orion_amr_model(
        cs.AMR_CUT['n_photons'], cs.AMR_CUT['n_iterations'],
        cs.AMR_CUT['n_imaging'])[0], cs.AMR_CUT['batch_size']),
    # their calls are phases 16's and 18's own (escape_tau_ab.record_phase)
    'sph_octree': (None, None),
    'voronoi_cloud': (None, None),
}


def root_levels(geo64, rho64, calls):
    """The levels of the descend from the root a crossing on an octree,
    over every ray of ``calls``: chip_smoke.walk_work's count (3
    comparisons a level) from the plain walk's visits, over the crossings
    that enter a cell."""
    import torch
    from hyperion_tpu_torch.transport import escape_tau as et
    levels = entered = 0
    for limited in (False, True):
        group = [call for call in calls
                 if (call[9] is not None) == limited and bool(call[8].any())]
        if not group:
            continue
        rays = [cs._active_rays(cs._f64(call), call[8]) for call in group]
        lanes = [torch.cat([r[0][i] for r in rays], dim=1 if 4 <= i < 7
                           else 0) for i in range(8)]
        t_max = torch.cat([r[1] for r in rays], dim=1) if limited else None
        visits = torch.zeros(rho64.shape[0], dtype=torch.int64,
                             device=rho64.device)
        et.escape_tau_reference(geo64, rho64, *lanes,
                                torch.ones_like(lanes[7], dtype=torch.bool),
                                t_max=t_max, visits=visits)
        levels += cs.walk_work('octree', geo64, lanes[7], visits)[1] // 3
        entered += int(visits.sum()) - lanes[7].numel()
    return levels / max(entered, 1)


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
        # record with the kernel, then probe with the instrumented copy
        if make is None:
            model, calls, _, _ = ab.record_phase(name, (window,))
        else:
            model = make()
            _, calls = cs.record_walks(model, batch, (window,))
        calls = calls[window]
        geo64 = build_geometry_tables(model.grid, dev, torch.float64)
        rho32 = _density_array(model, geo64.length_scale, dev, torch.float32)
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
        if type(geo64).__name__ == 'OctreeGeometry':
            mean['root_levels_per_crossing'] = root_levels(
                geo64, rho64.T.contiguous(), calls)
        print(json.dumps(dict(model=name, design=design,
                              steps='%d-%d' % (window[0] + 1, window[1]),
                              longest_ray=dict(alone, expected=n_cross),
                              every_call=dict(mean, crossings=n),
                              resident_blocks=plan['resident_blocks'],
                              card=card)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
