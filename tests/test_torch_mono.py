"""The port's monochromatic iteration against the JAX package's (JAX x64,
torch float64, the same numpy inputs).

- The host tables: ``dust_mono_cell_pdfs`` and a source-less model's
  placeholder source row, equal to the JAX package's to 1e-12.
- Whole runs through each package's ``run_model``, the .rtout read by both
  ``ModelOutput``s: 12^3 cells around a point source with source and dust
  photons at three exact wavelengths (a given specific energy, forced first
  interaction, track_origin 'detailed'): the direct light of the point
  source, the same weight for every photon, equal to 1e-9, the other
  components and the total within five sigma of both runs' uncertainties;
  the class2 YSO (24 x 8 cells, the spherical star) raytraced at six exact
  wavelengths, the port fed the JAX package's uniforms, to rounding.
- The models of tests/test_monochromatic.py's test_mono_zero_prob and
  test_mono_check_weighting run on the port (source-less, with dust
  photons only)."""

import numpy as np
import torch
import jax.numpy as jnp

from hyperion_tpu.transport.mono import dust_mono_cell_pdfs as j_pdfs
from hyperion_tpu.transport.stable import build_source_tables as j_sources
from hyperion_tpu_torch.model.run import run_lucy_model, run_model
from hyperion_tpu_torch.transport.mono import dust_mono_cell_pdfs
from hyperion_tpu_torch.transport.stable import build_source_tables
from test_torch_frontend import class2_model, frontend
from test_torch_raytrace import _run_both

torch.set_num_threads(1)
CPU = torch.device('cpu')


def _dust(F, albedo=0.4, chi=2.0):
    nu = np.logspace(5, 18, 30)
    d = F.IsotropicDust(nu, np.repeat(albedo, 30), np.repeat(chi, 30))
    d._compute_mean_opacities()
    d.emissivities.set_lte(d.optical_properties, d.mean_opacities)
    return d


def test_dust_cell_pdfs_match_jax():
    """Per (frequency, dust) cell CDFs, mean probabilities and absorbed
    energies; a dust whose cells absorb nothing, frequencies outside the
    emissivity table, specific energies beyond both ends of its var grid."""
    rng = np.random.default_rng(2)
    n_cells = 40
    freqs = np.array([1e5, 3e11, 3e12, 3e13, 3e14, 1e19])
    se = 10.0 ** rng.uniform(-6.0, 9.0, (3, n_cells))
    rho = rng.uniform(0.0, 2.0, (3, n_cells))
    rho[2] = 0.0
    vol = rng.uniform(0.5, 1.5, n_cells)
    ref = j_pdfs([_dust(frontend('jax'), chi=c) for c in (1.0, 5.0, 2.0)],
                 rho, vol, se, freqs)
    got = dust_mono_cell_pdfs([_dust(frontend('port'), chi=c)
                               for c in (1.0, 5.0, 2.0)], rho, vol, se, freqs)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=0)
    assert (got[1][:, 2] == 0).all() and (got[1][:, :2] > 0).any()


def test_source_less_row_matches_jax():
    """No sources: one zero-luminosity point row at the origin, as the JAX
    package's; nothing divides by its energy_total of 0."""
    ref = j_sources([], dtype=jnp.float64)
    got = build_source_tables([], CPU, torch.float64)
    assert got.n_sources == 1 and got.energy_total == 0.0
    for name in ('type_code', 'position', 'radius', 'limb', 'lum_cdf',
                 'energy_weight', 'spec_nu', 'spec_logq', 'intersect',
                 'cap_dir', 'cap_cos'):
        np.testing.assert_allclose(
            getattr(got, name).numpy().astype(float),
            np.asarray(getattr(ref, name), float), rtol=1e-12, atol=0,
            err_msg=name)
    assert float(ref.energy_total) == got.energy_total


def _mono_model(pkg):
    """12^3 cells of albedo 0.4 dust around a 1 Lsun 6000 K point source,
    a given specific energy (a 300 K (r / 3 au)^-0.5 profile), 1,000
    source and 1,000 dust photons at 1, 10 and 100 um into an SED at one
    view, track_origin 'detailed', with uncertainties."""
    F = frontend(pkg)
    m = F.Model()
    lim = 3 * F.au
    w = np.linspace(-lim, lim, 13)
    m.set_cartesian_grid(w, w, w)
    dust = _dust(F)
    c = 0.5 * (w[1:] + w[:-1])
    r = np.sqrt(sum(a ** 2 for a in np.meshgrid(c, c, c, indexing='ij')))
    m.add_density_grid(np.full(m.grid.shape, 3e-16), dust,
                       specific_energy=dust.temperature2specific_energy(
                           300.0 * (r / lim) ** -0.5))
    s = m.add_point_source()
    s.luminosity, s.temperature = F.lsun, 6000.0
    s.position = (0.1 * F.au, -0.2 * F.au, 0.3 * F.au)
    g = m.add_peeled_images(sed=True, image=False)
    g.set_viewing_angles([45.0], [60.0])
    g.set_aperture_radii(1, lim * 10, lim * 10)
    g.set_track_origin('detailed')
    g.set_uncertainties(True)
    m.set_monochromatic(True, wavelengths=[1.0, 10.0, 100.0])
    g.set_wavelength_index_range(0, 2)
    m.set_n_photons(initial=0, imaging_sources=1000, imaging_dust=1000)
    m.set_n_initial_iterations(0)
    return m


def test_mono_run_matches_jax(tmp_path):
    outs = _run_both(_mono_model, tmp_path, 'mono')
    for reader in ('jax', 'port'):
        j, p = outs['jax', reader], outs['port', reader]
        sj, sp = (o.get_sed(inclination=0, aperture=-1,
                            component='source_emit') for o in (j, p))
        np.testing.assert_allclose(sp.nu, sj.nu, rtol=1e-14)
        assert (sj.val > 0).all()
        np.testing.assert_allclose(sp.val, sj.val, rtol=1e-9, atol=0)
        for comp in ('total', 'source_scat', 'dust_emit', 'dust_scat'):
            sj, sp = (o.get_sed(inclination=0, aperture=-1, component=comp,
                                uncertainties=True) for o in (j, p))
            assert np.isfinite(sp.val).all() and (sp.val >= 0).all()
            tol = 5.0 * np.hypot(sj.unc, sp.unc)
            assert (np.abs(sp.val - sj.val) <= tol).all(), \
                (comp, sp.val / sj.val)
        # the thermal emission at 100 um, the scattered light at 1 um
        assert p.get_sed(inclination=0, aperture=-1,
                         component='dust_emit').val[-1] > 0
        assert p.get_sed(inclination=0, aperture=-1,
                         component='source_scat').val[0] > 0


def _class2_model(pkg):
    """class2_model at 24 x 8 cells with a given specific energy (a 300 K
    (r / 1 au)^-0.5 profile; no Lucy iteration), its three views, and the
    raytraced sources (the spherical star, its surface's peel weight) and
    dust at six exact wavelengths, without Monte-Carlo photons."""
    F = frontend(pkg)
    m = class2_model(pkg, 24, 8, 0)
    g = m.add_peeled_images(sed=True, image=False)
    g.set_viewing_angles([20.0, 45.0, 80.0], [0.0, 0.0, 0.0])
    g.set_aperture_radii(1, 400 * F.au, 400 * F.au)
    g.set_uncertainties(True)
    m.set_monochromatic(True, wavelengths=[0.5, 2.0, 10.0, 50.0, 200.0,
                                           1000.0])
    g.set_wavelength_index_range(0, 5)
    m.set_raytracing(True)
    m.set_n_photons(initial=0, imaging_sources=0, imaging_dust=0,
                    raytracing_sources=4000, raytracing_dust=20000)
    m.set_n_initial_iterations(0)
    m.evaluate_optically_thin_radii()
    mm = m.to_model()
    g = mm.grid
    r = 0.5 * (g.r_wall[1:] + g.r_wall[:-1])
    temp = np.clip(300.0 * (r / F.au) ** -0.5, 10.0, 1500.0)
    temp = np.broadcast_to(temp[None, None, :], g.shape)
    g.quantities['specific_energy'] = [
        d.temperature2specific_energy(temp) for d in mm._dust_objects()]
    return mm


def test_class2_raytracing_within_noise_of_jax(tmp_path, monkeypatch):
    """The spherical star's surface weight and the thermal photons of the
    spherical grid through both run_models, at exact wavelengths, the
    port's raytracing fed the JAX package's uniforms (its key for the
    first group's pass, split from PRNGKey(|seed| + 3) after the
    monochromatic iteration, which draws nothing here): no Monte-Carlo
    photons, so the SEDs, read by both ModelOutputs, equal to rounding."""
    import jax
    from hyperion_tpu_torch.transport import raytrace as rt
    from test_torch_raytrace import JaxDraws
    B = 2048
    seed = class2_model('port', 24, 8, 0)._seed
    _, k_ray = jax.random.split(jax.random.PRNGKey((abs(seed) + 3) %
                                                   (2 ** 31)))
    draws = JaxDraws(k_ray, B, 4000, 20000)
    monkeypatch.setattr(rt, 'torch', draws)
    outs = _run_both(_class2_model, tmp_path, 'class2', B)
    assert not draws.draws
    for reader in ('jax', 'port'):
        j, p = outs['jax', reader], outs['port', reader]
        for inc in range(3):
            sj = j.get_sed(inclination=inc, aperture=-1)
            sp = p.get_sed(inclination=inc, aperture=-1)
            assert (sj.val > 0).all()
            np.testing.assert_allclose(sp.val, sj.val, rtol=1e-9, atol=0)


def _zero_prob_model():
    """tests/test_monochromatic.py:test_mono_zero_prob's model, with the
    port's front end: one cell of two dusts, no source, no specific energy,
    100 dust photons at six wavelengths into an SED and a 20 x 20 image."""
    F = frontend('port')
    dust = _dust(F)
    m = F.Model()
    m.set_cartesian_grid([-1., 1.], [-1., 1.], [-1., 1.])
    m.add_density_grid(np.array([[[1.]]]), dust)
    m.add_density_grid(np.array([[[0.5]]]), dust, merge_if_possible=False)
    image = m.add_peeled_images(sed=True, image=True)
    image.set_image_limits(-2., 2., -2., 2.)
    image.set_image_size(20, 20)
    image.set_viewing_angles([45.], [45.])
    m.set_minimum_temperature(10.)
    m.set_monochromatic(True, wavelengths=[0.01, 0.1, 1., 10., 100., 1000.])
    m.set_n_initial_iterations(0)
    m.set_n_photons(imaging_sources=0, imaging_dust=100)
    m.set_copy_input(False)
    return m


def test_mono_zero_prob_runs(tmp_path):
    """Emission probabilities of zero at every wavelength (no specific
    energy) and no source: the run writes empty cubes."""
    m = _zero_prob_model()
    m.write(str(tmp_path / 'z.rtin'))
    run_model(m, str(tmp_path / 'z.rtout'), device='cpu')
    out = frontend('port').ModelOutput(str(tmp_path / 'z.rtout'))
    sed = out.get_sed(inclination=0, aperture=-1)
    assert sed.val.shape == (6,) and (sed.val == 0).all()
    assert out.get_image(inclination=0).val.shape == (20, 20, 6)


def test_mono_check_weighting(tmp_path):
    """tests/test_monochromatic.py:test_mono_check_weighting on the port:
    the first dust's emission does not change when a second, optically
    thin dust with a tiny specific energy (a mean probability of 0 at
    most wavelengths) is added (50,000 dust photons per wavelength)."""
    F = frontend('port')
    d = _dust(F)

    def build(two):
        m = F.Model()
        m.set_cartesian_grid([-1., 1.], [-1., 1.], [-1., 1.])
        m.add_density_grid(np.array([[[1.e-10]]]), d,
                           specific_energy=np.array([[[1.e8]]]))
        if two:
            m.add_density_grid(np.array([[[1.e-10]]]), d,
                               specific_energy=np.array([[[1.e-4]]]),
                               merge_if_possible=False)
        image = m.add_peeled_images(sed=True, image=False)
        image.set_viewing_angles([45.], [45.])
        image.set_track_origin('detailed')
        m.set_monochromatic(True, wavelengths=np.logspace(-1., 4., 10))
        m.set_n_initial_iterations(0)
        m.set_n_photons(imaging_sources=0, imaging_dust=50000)
        m.set_copy_input(False)
        return m

    vals = []
    for i, two in enumerate((True, False)):
        run = run_lucy_model(build(two), device='cpu')
        assert run.imaging.killed_int == 0
        # (n_stokes, n_orig, n_view, n_ap, n_nu): origin 'dust 0 emission'
        # is slot n_sources + 0 = 1
        vals.append(run.imaging.peeled[0]['datasets']['seds'][0][0, 1, 0,
                                                                 0])
    v1, v2 = vals
    sel = (v1 > 0) & (v2 > 0)
    assert sel.sum() >= 5
    ratio = v1[sel] / v2[sel]
    assert np.all((ratio < 1.05) & (1 / ratio < 1.05)), ratio
