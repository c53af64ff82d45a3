#!/usr/bin/env python3
"""The raytraced SED beside the Monte-Carlo one, in bands or at exact
wavelengths, on the port or on the JAX package.

    python3 scripts/raytrace_vs_mc.py --model class2 [--mrw off] \
        --save-specific-energy raytrace_vs_mc_out/se.npy
    python3 scripts/raytrace_vs_mc.py --package jax [--mrw off] \
        --specific-energy raytrace_vs_mc_out/se.npy
    python3 scripts/raytrace_vs_mc.py --model cube --density 1e-19 \
        --mono 0.5 1 10 100 1000 --photons 200000

Runs a model twice: (1) the imaging iteration peeling every event (the
Monte-Carlo SED), after one Lucy iteration or from ``--specific-energy``
(an (n_dust, n_cells) .npy) with none; (2) the same model given (1)'s
specific energy, no Lucy iteration, the imaging iteration peeling
scattered light only, and the raytracing pass (direct and thermal light).
With the same specific energy the two estimate the same light; the script
prints, per view and band, (2) / (1) and the difference in units of both
runs' Monte-Carlo uncertainties (the raytraced part's own noise is not in
them). ``--save-specific-energy FILE`` writes (2)'s specific energy, so
that the other package can start from it; both SEDs and their
uncertainties go to raytrace_vs_mc_out/PACKAGE_MODEL_seds.npz.

``--package port`` (the default) runs ``hyperion_tpu_torch``'s
``run_lucy_model`` on ``--device``; ``--package jax`` runs the JAX
package's ``run_model`` on the CPU in float64 (its .rtout files go to
raytrace_vs_mc_out/): the same model built by the JAX package's
own front end, so that its raytracing and imaging iteration witness the
port's. One run imports one package.

Models: ``class2`` (examples/class2_sed.py's model on a ``--cells`` R x T
grid, MRW on or off) and ``cube`` (examples/quickstart.py's box on 9^3
cells at ``--density`` g/cm^3: 1e-18 gives cells of optical depth ~0.016,
3e-16 ~5). ``--mono W [W ...]`` images in monochromatic mode at those
wavelengths (um), the photons per wavelength and kind; the port's run
then also prints the offset that raytracing's resampled var rows predict
on an optically thin grid (``chip_smoke.raytrace_table_offset``).
``--device cuda`` runs the port on the card, ``cpu`` (the default) on
the CPU in float64."""

import argparse
import importlib
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / 'raytrace_vs_mc_out'
# the package whose front end builds the model (--package)
PKG = {'port': 'hyperion_tpu_torch', 'jax': 'hyperion_tpu'}
BASE = PKG['port']


def _mod(name):
    return importlib.import_module(BASE + '.' + name)


def _imaging(m, sed, n_photons, raytracing, mono, wav_range):
    """The peeled group's frequencies (``wav_range`` bins, or the exact
    wavelengths ``mono``) and the photons: ``n_photons`` Lucy and imaging
    photons (per wavelength and kind in monochromatic mode), with
    raytracing that many source and ten times as many dust photons."""
    ray = dict(raytracing_sources=n_photons,
               raytracing_dust=10 * n_photons) if raytracing else {}
    if mono:
        m.set_monochromatic(True, wavelengths=mono)
        sed.set_wavelength_index_range(0, len(mono) - 1)
        m.set_n_photons(initial=n_photons, imaging_sources=n_photons,
                        imaging_dust=n_photons, **ray)
    else:
        sed.set_wavelength_range(*wav_range)
        m.set_n_photons(initial=n_photons, imaging=n_photons, **ray)
    m.set_raytracing(raytracing)


def class2(n_r, n_t, n_photons, mrw, raytracing, mono):
    HenyeyGreensteinDust = _mod('dust').HenyeyGreensteinDust
    AnalyticalYSOModel = _mod('model').AnalyticalYSOModel
    k = _mod('util.constants')
    au, lsun, msun, rsun = k.au, k.lsun, k.msun, k.rsun
    nu = np.logspace(8, 17, 64)
    m = AnalyticalYSOModel()
    m.star.luminosity, m.star.radius, m.star.temperature = \
        lsun, 2.0 * rsun, 4300.0
    disk = m.add_flared_disk()
    disk.mass, disk.rmin, disk.rmax = 1e-3 * msun, 0.1 * au, 200.0 * au
    disk.r_0, disk.h_0, disk.p, disk.beta = 10.0 * au, 0.4 * au, -1.0, 1.25
    disk.dust = HenyeyGreensteinDust(nu, np.repeat(0.5, 64),
                                     np.repeat(400.0, 64),
                                     np.repeat(0.4, 64), np.repeat(0.8, 64))
    m.set_spherical_polar_grid_auto(n_r, n_t, 1)
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([20.0, 45.0, 80.0], [0.0, 0.0, 0.0])
    sed.set_aperture_radii(1, 400 * au, 400 * au)
    sed.set_uncertainties(True)
    m.set_mrw(mrw, gamma=2.0)
    _imaging(m, sed, n_photons, raytracing, mono, (120, 0.3, 2000.0))
    m.evaluate_optically_thin_radii()
    return m.to_model()


def cube(density, n_photons, raytracing, mono):
    IsotropicDust = _mod('dust').IsotropicDust
    Model = _mod('model').Model
    k = _mod('util.constants')
    au, lsun = k.au, k.lsun
    nu = np.logspace(8, 17, 32)
    m = Model()
    lim = 50 * au
    w = np.linspace(-lim, lim, 10)
    m.set_cartesian_grid(w, w, w)
    m.add_density_grid(np.full(m.grid.shape, density),
                       IsotropicDust(nu, np.repeat(0.4, 32),
                                     np.repeat(100.0, 32)))
    s = m.add_point_source()
    s.luminosity, s.temperature = lsun, 6000.0
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([45.0], [0.0])
    sed.set_aperture_radii(1, 2 * lim, 2 * lim)
    sed.set_uncertainties(True)
    _imaging(m, sed, n_photons, raytracing, mono, (60, 0.3, 1000.0))
    return m


def run_port(m, args):
    """(SED (n_view, n_nu), its uncertainty, the specific energy the
    imaging iteration used) of the port's run_lucy_model."""
    from hyperion_tpu_torch.model import run_lucy_model
    run = run_lucy_model(m, device=args.device, batch_size=args.batch_size)
    print('  imaging killed_int %d' % run.imaging.killed_int)
    data = run.imaging.peeled[0]['datasets']
    se = run.iterations[-1]['specific_energy'] if run.iterations else None
    return data['seds'][0][0, 0, :, 0], data['seds_unc'][0][0, 0, :, 0], se


def run_jax(m, args, name):
    """The same from the JAX package's run_model, read from its .rtout
    (the on-disk layout the port's arrays share)."""
    import h5py
    from hyperion_tpu.model.run import run_model
    OUT.mkdir(parents=True, exist_ok=True)
    m.write(str(OUT / (name + '.rtin')))
    path = str(OUT / (name + '.rtout'))
    run_model(m, path, batch_size=args.batch_size)
    with h5py.File(path, 'r') as f:
        g = f['Peeled/group_00001']
        print('  imaging killed_int %d' % f.attrs['killed_photons_int_final'])
        sed, unc = g['seds'][0, 0, :, 0], g['seds_unc'][0, 0, :, 0]
        its = sorted(k for k in f if k.startswith('iteration_'))
        se = None
        if its:
            se = np.asarray(f[its[-1]]['specific_energy'], float)
            se = se.reshape(se.shape[0], -1)
    return sed, unc, se


def main():
    global BASE
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--package', choices=tuple(PKG), default='port')
    ap.add_argument('--model', choices=('class2', 'cube'), default='class2')
    ap.add_argument('--cells', type=int, nargs=2, default=(24, 8))
    ap.add_argument('--density', type=float, default=1e-18)
    ap.add_argument('--mrw', choices=('on', 'off'), default='on')
    ap.add_argument('--photons', type=int, default=20000)
    ap.add_argument('--batch-size', type=int, default=4096)
    ap.add_argument('--device', default='cpu')
    ap.add_argument('--mono', type=float, nargs='+',
                    help='monochromatic imaging at these wavelengths (um)')
    ap.add_argument('--specific-energy')
    ap.add_argument('--save-specific-energy')
    args = ap.parse_args()
    BASE = PKG[args.package]
    if args.package == 'jax':
        import jax
        jax.config.update('jax_platforms', 'cpu')
        jax.config.update('jax_enable_x64', True)
    else:
        import torch
        torch.set_num_threads(8)
    c = _mod('util.constants').c

    def make(raytracing):
        if args.model == 'class2':
            return class2(*args.cells, args.photons, args.mrw == 'on',
                          raytracing, args.mono)
        return cube(args.density, args.photons, raytracing, args.mono)

    seds = []
    se = None if args.specific_energy is None else np.load(
        args.specific_energy)
    for raytracing in (False, True):
        m = make(raytracing)
        m.set_n_initial_iterations(1 if se is None else 0)
        if se is not None:
            g = m.grid
            g.quantities['specific_energy'] = [
                np.asarray(row, float).reshape(g.shape) for row in se]
        t0 = time.time()
        name = '%s_%s' % (args.model, 'raytracing' if raytracing else 'mc')
        sed, unc, se_run = run_port(m, args) if args.package == 'port' \
            else run_jax(m, args, name)
        print('%s (%s): %.1f s' % (
            'raytracing' if raytracing else 'Monte Carlo', args.package,
            time.time() - t0), flush=True)
        if se is None:
            se = se_run
        seds.append((sed, unc))
    if args.save_specific_energy:
        np.save(args.save_specific_energy, se)
    OUT.mkdir(parents=True, exist_ok=True)
    np.savez(OUT / ('%s_%s_seds.npz' % (args.package, args.model)),
             mc=seds[0][0], mc_unc=seds[0][1], raytraced=seds[1][0],
             raytraced_unc=seds[1][1])
    (s1, u1), (s2, u2) = seds
    if args.mono:
        # one column per exact wavelength, in the order given
        columns = [('%g um' % w, np.arange(len(args.mono)) == i)
                   for i, w in enumerate(args.mono)]
    else:
        wav_min, wav_max, n_wav = (0.3, 2000.0, 120) \
            if args.model == 'class2' else (0.3, 1000.0, 60)
        nu = np.logspace(np.log10(c / (wav_max * 1e-4)),
                         np.log10(c / (wav_min * 1e-4)), n_wav + 1)
        wav = c / np.sqrt(nu[1:] * nu[:-1]) * 1e4
        columns = [('%g-%g um' % (lo, hi), (wav >= lo) & (wav < hi))
                   for lo, hi in ((100, 3000), (20, 100), (3, 20), (0.3, 3))]
    offset = None
    if args.mono and args.package == 'port':
        # what the raytracing tables' resampled var rows alone move (2)
        # by on an optically thin grid (chip_smoke.raytrace_table_offset)
        import chip_smoke
        offset = chip_smoke.raytrace_table_offset(m, se)
    print('%-12s view: raytracing / Monte Carlo  (sigma)%s' % (
        'band', '  [the tables\' offset / Monte Carlo]' if offset is not None
        else ''))
    for label, sel in columns:
        a, b = s1[:, sel].sum(axis=1), s2[:, sel].sum(axis=1)
        sig = np.sqrt((u1[:, sel] ** 2 + u2[:, sel] ** 2).sum(axis=1))
        print('%-12s %s%s' % (label, '  '.join(
            '%.4f (%.2f)' % (r, n) for r, n in
            zip(b / a, np.abs(b - a) / np.maximum(sig, 1e-300))),
            '' if offset is None else '  [%s]' % '  '.join(
                '%+.4f' % v for v in offset[sel].sum() / a)))


if __name__ == '__main__':
    main()
