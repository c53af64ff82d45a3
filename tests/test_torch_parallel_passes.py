"""The port's photon-parallel monochromatic and raytracing passes
(hyperion_tpu_torch/parallel/mesh.py's run_mono_pass_sharded,
run_raytrace_{source,dust}_sharded and reduce_raytrace, and the
per-trip split in transport/raytrace.py) on gloo ranks on the CPU:

- tests/test_parallel.py's monochromatic and raytracing models under
  Model.run(n_processes=2) against the JAX package's
  Model.run(n_processes=2) of the same .rtin (a 2-device mesh): the
  directly peeled or raytraced source emission per wavelength exactly,
  the peeled SED and image per wavelength within Monte-Carlo bounds; and
  against the port's own single-rank run (tests/test_parallel.py's
  bound);
- a raytracing trip never gives a rank more lanes than its batch, and a
  last, partial trip over three ranks traces every photon: a point
  source's raytraced SED, the same for every photon, is that of one rank
  to float64 rounding."""

import numpy as np
import pytest
import torch

from hyperion_tpu_torch.parallel import mesh
from test_torch_frontend import frontend

torch.set_num_threads(1)
PC = 3.086e18


def _mono_or_raytracing(package, mono, seed=-8):
    """tests/test_parallel.py's monochromatic and raytracing models with
    either package's front end, at 5,000 photons a stage, the peeled group
    tracking the photons' origins; the raytracing model's four wavelength
    bins reach 10 mm, where the grid's thermal emission shows."""
    F = frontend(package)
    nu = np.logspace(8, 18, 24)
    dust = F.IsotropicDust(nu, np.repeat(0.4, 24), np.repeat(2.0e4, 24))
    m = F.Model()
    x = np.linspace(-PC, PC, 6)
    m.set_cartesian_grid(x, x, x)
    m.add_density_grid(np.ones((5, 5, 5)) * 2e-23, dust)
    s = m.add_point_source()
    s.luminosity = F.lsun
    s.temperature = 5000.
    i = m.add_peeled_images()
    if mono:
        m.set_monochromatic(True, wavelengths=[1.0, 10.0])
        i.set_wavelength_index_range(0, 1)
        m.set_n_photons(initial=5000, imaging_sources=5000,
                        imaging_dust=5000)
    else:
        i.set_wavelength_range(4, 0.1, 1e4)
        m.set_raytracing(True)
        m.set_n_photons(initial=5000, imaging=5000, raytracing_sources=5000,
                        raytracing_dust=5000)
    i.set_viewing_angles([60.], [45.])
    i.set_image_size(4, 4)
    i.set_image_limits(-PC, PC, -PC, PC)
    i.set_aperture_radii(1, PC, PC)
    i.set_track_origin('basic')
    m.set_seed(seed)
    m.set_copy_input(False)
    return m


def _run(package, mono, n_processes, tmp_path):
    """The peeled SED (n_nu,) and image (n_y, n_x, n_nu) at the one
    viewing angle, in total and of each origin."""
    m = _mono_or_raytracing(package, mono)
    stem = '%s_%d' % (package, n_processes)
    m.write(str(tmp_path / (stem + '.rtin')))
    kw = dict(device='cpu') if package == 'port' else {}
    out = m.run(str(tmp_path / (stem + '.rtout')), n_processes=n_processes,
                batch_size=1024, **kw)
    return {c: (np.asarray(out.get_sed(inclination=0, aperture=-1,
                                       component=c).val),
                np.asarray(out.get_image(inclination=0, component=c).val))
            for c in ('total', 'source_emit', 'dust_emit')}


def _bright(a, share=0.01):
    """The wavelengths that hold at least ``share`` of ``a``'s total
    (fainter ones get a few scattered photons or none)."""
    return a >= share * a.sum()


@pytest.mark.parametrize('mono', [True, False], ids=['mono', 'raytracing'])
def test_mono_and_raytracing_two_processes(mono, tmp_path):
    """Under n_processes=2 the monochromatic iteration and the raytracing
    pass share their photons over the ranks. Against the JAX package's
    n_processes=2 run of the same model:

    - the directly peeled (mono) or raytraced source emission, the same
      for every photon of the central point source, per wavelength in the
      SED and the image to 1e-9: a wrong split of a pass or of a trip, or
      a cube reduced or scaled wrongly, shows here exactly;
    - the SED and the image's total per wavelength, and the raytraced
      thermal emission per wavelength, within 5% (mono, 5,000 photons a
      wavelength) or 10% (raytracing, 5,000 imaging photons over four
      bins), at the wavelengths holding at least 1% of the total.

    Against the port's single-rank run: the SED total within 10%
    (tests/test_parallel.py's bound)."""
    one = _run('port', mono, 1, tmp_path)
    two = _run('port', mono, 2, tmp_path)
    ref = _run('jax', mono, 2, tmp_path)
    for c in two:
        for a, b in zip(two[c], ref[c]):
            assert a.shape == b.shape, c
            assert np.isfinite(a).all() and (a >= 0).all(), c
    for a, b in zip(two['source_emit'], ref['source_emit']):
        assert b.sum() > 0
        np.testing.assert_allclose(a, b, rtol=1e-9)
    rtol = 0.05 if mono else 0.1
    comps = ('total',) if mono else ('total', 'dust_emit')
    for c in comps:
        (sed, img), (sed_j, img_j) = two[c], ref[c]
        flux, flux_j = img.sum(axis=(0, 1)), img_j.sum(axis=(0, 1))
        for a, b in ((sed, sed_j), (flux, flux_j)):
            sel = _bright(b)
            assert sel.any(), c
            np.testing.assert_allclose(a[sel], b[sel], rtol=rtol,
                                       err_msg=c)
    assert abs(two['total'][0].sum() / one['total'][0].sum() - 1.0) < 0.1


@pytest.mark.parametrize('world', range(1, 9))
def test_raytracing_trip_share_fits_the_batch(world):
    """Every trip of b <= batch x world photons gives out b lanes, and no
    rank more than its batch (the JAX split would give device 0 up to
    batch + world - 2 on a last trip)."""
    batch = 16
    for b in range(batch * world + 1):
        shares = [mesh.trip_share(b, r, world) for r in range(world)]
        assert sum(shares) == b
        assert max(shares) <= batch


def _point_source_raytracing(n_ray):
    """A point source in an almost empty 4^3 grid, its source photons
    raytraced (no thermal photons): every photon peels the same spectrum
    along the same line of sight, so the raytraced SED is the number
    traced times one photon's."""
    F = frontend('port')
    nu = np.logspace(8, 18, 24)
    dust = F.IsotropicDust(nu, np.repeat(0.4, 24), np.repeat(2.0e4, 24))
    m = F.Model()
    x = np.linspace(-PC, PC, 5)
    m.set_cartesian_grid(x, x, x)
    m.add_density_grid(np.ones((4, 4, 4)) * 1e-30, dust)
    s = m.add_point_source()
    s.luminosity = F.lsun
    s.temperature = 5000.
    i = m.add_peeled_images(image=False)
    i.set_wavelength_range(3, 0.1, 100.)
    i.set_viewing_angles([60.], [45.])
    i.set_aperture_radii(1, PC, PC)
    i.set_track_origin('basic')
    m.set_raytracing(True)
    m.set_n_photons(initial=200, imaging=200, raytracing_sources=n_ray,
                    raytracing_dust=0)
    m.set_seed(-4)
    m.set_copy_input(False)
    return m


def test_raytracing_partial_trip_over_three_ranks(tmp_path):
    """47 source photons in batches of 16 over three ranks: one trip of 48
    lanes, the last photon short. Every photon is traced, so the raytraced
    source SED equals the single-rank run's to float64 rounding (the JAX
    split would drop one photon of 47 on device 0)."""
    seds = []
    for n in (1, 3):
        m = _point_source_raytracing(47)
        m.write(str(tmp_path / ('r%d.rtin' % n)))
        out = m.run(str(tmp_path / ('r%d.rtout' % n)), n_processes=n,
                    device='cpu', batch_size=16)
        seds.append(np.asarray(out.get_sed(
            inclination=0, aperture=-1, component='source_emit').val))
    s1, s3 = seds
    assert (s1 > 0).all()
    np.testing.assert_allclose(s3, s1, rtol=1e-12)
