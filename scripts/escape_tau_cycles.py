#!/usr/bin/env python3
"""Where a crossing of the escape_tau kernel spends its cycles, on one card.

    python3 scripts/escape_tau_cycles.py

Builds an instrumented copy of csrc/escape_tau.cu (clock64() around the
parts of a crossing, summed into a device table; the arithmetic is the
kernel's own) into hyperion_tpu_torch/_build/, records the walk calls of
imaging steps 41-60 of class2 (examples/class2_sed.py, B = 50,000), of
the quickstart (B = 125,000) and of BASELINE config 3
(chip_smoke.class1_cyl_model, cylindrical-polar, B = 25,000) with
chip_smoke.record_walks, and runs, with the instrumented library in place
of the kernel's:

- the window's longest ray alone (its lane the only active one, its view
  the only one): SM cycles per crossing from the ray's start to its end,
  in the crossing's body, and for a spherical or cylindrical grid in the
  six wall candidates and in find_cell at the landing point;
- every call of the window: the same figures averaged over all crossings.

Prints the card and one JSON object per model. The clock reads and the
table's atomics add a few tens of cycles to each part.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'scripts'))

import chip_smoke as cs  # noqa: E402

# (marker in csrc/escape_tau.cu, text put after it, the times it is found:
# the spherical and cylindrical crossings share some markers)
PROBES = [
    ('  const double big = DBL_MAX / 8.0;\n  const double b = x * kx',
     None, 1),  # replaced below: the spherical candidates' start
    ('  const double big = DBL_MAX / 8.0;\n  const double eps = cyl_eps',
     None, 1),  # and the cylindrical ones'
    ('  t = tmin;\n', '  const long long c1 = clock64();\n'
     '  atomicAdd(&probe[1], (unsigned long long)(c1 - c0));\n', 2),
    ('        walking = true;\n',
     '        ray0 = clock64();\n', 1),
    ('      // one crossing\n', '      const long long w0 = clock64();\n', 1),
    ('      ++steps;\n',
     '      atomicAdd(&probe[3], (unsigned long long)(clock64() - w0));\n'
     '      atomicAdd(&probe[4], 1ull);\n', 1),
    ('        walking = false;\n',
     '        atomicAdd(&probe[0],'
     ' (unsigned long long)(clock64() - ray0));\n', 1),
]
# the end of find_cell at the landing point: spherical, cylindrical
ENDS = ['  return i1 >= 0 && i1 < g.n1;\n',
        '  return i1 < g.n1 && i2 >= 0 && i2 < g.n2 && w2 >= g.w[1][0];\n']


def instrumented_source():
    """The kernel's source with the probes; raises if a marker moved."""
    src = (ROOT / 'hyperion_tpu_torch/transport/csrc/escape_tau.cu') \
        .read_text()
    src = src.replace('namespace {\n', '__device__ unsigned long long '
                      'probe[8];\nnamespace {\n', 1)
    for marker, after, times in PROBES:
        if src.count(marker) != times:
            raise RuntimeError('escape_tau_cycles: marker %r found %d times'
                               % (marker, src.count(marker)))
        if after is None:
            src = src.replace(marker, '  const long long c0 = clock64();\n'
                              + marker)
        else:
            src = src.replace(marker, marker + after)
    for end in ENDS:
        if src.count(end) != 1:
            raise RuntimeError('escape_tau_cycles: find_cell end %r moved'
                               % end)
        src = src.replace(end, '  atomicAdd(&probe[2], (unsigned long long)'
                          '(clock64() - c1));\n' + end)
    src = src.replace('  bool walking = false;\n',
                      '  bool walking = false;\n  long long ray0 = 0;\n', 1)
    return src + '''
extern "C" int probe_read(unsigned long long* h) {
  cudaDeviceSynchronize();
  return (int)cudaMemcpyFromSymbol(h, probe, sizeof(probe));
}
extern "C" int probe_zero() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(probe, z, sizeof(z));
}
'''


def build():
    from hyperion_tpu_torch.transport import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / 'escape_tau_cycles.cu'
    lib = _build.BUILD_DIR / 'libescape_tau_cycles.so'
    src.write_text(instrumented_source())
    subprocess.run([_build._nvcc()] + _build._flags('escape_tau') +
                   ['-o', str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def measure(lib, walk, call):
    h = (ctypes.c_ulonglong * 8)()
    for _ in range(3):      # the last of three runs
        lib.probe_zero()
        walk(*call[:9], t_max=call[9])
        lib.probe_read(h)
    n = max(h[4], 1)
    # the candidates and find_cell parts are 0 on a cartesian grid
    return dict(crossings=int(h[4]), ray_cycles_per_crossing=h[0] / n,
                body_cycles=h[3] / n, candidates_cycles=h[1] / n,
                find_cell_cycles=h[2] / n)


def main():
    import torch
    import escape_tau_ab as ab
    from hyperion_tpu_torch.model.run import (_density_array,
                                              build_geometry_tables)
    from hyperion_tpu_torch.transport import _build
    from hyperion_tpu_torch.transport import escape_tau as et

    if not torch.cuda.is_available():
        print('escape_tau_cycles: needs an NVIDIA card', file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    lib = build()
    dev = torch.device('cuda')
    window = (40, 60)
    models = dict(ab.MODELS, class1_cyl=(cs.class1_cyl_model, 25_000))
    for name, (make, batch) in models.items():
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
        kernel = _build._loaded.get('escape_tau')
        _build._loaded['escape_tau'] = lib
        try:
            walk = et.EscapeTau(geo64, rho32.T.contiguous())
            alone = measure(lib, walk, lone)
            every = [measure(lib, walk, x) for x in calls]
        finally:
            _build._loaded['escape_tau'] = kernel
        n = sum(e['crossings'] for e in every)
        mean = {k: sum(e[k] * e['crossings'] for e in every) / n
                for k in every[0] if k != 'crossings'}
        print(json.dumps(dict(model=name, steps='%d-%d' % (window[0] + 1,
                                                          window[1]),
                              longest_ray=dict(alone, expected=n_cross),
                              every_call=dict(mean, crossings=n),
                              card=card)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
