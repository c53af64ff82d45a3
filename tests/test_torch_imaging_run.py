"""Whole imaging iterations through each package's run_model: the
``imaging_peeloff`` model of tests/test_self_regression.py:100-121 (2
views, 3 apertures, an image, HG dust, Stokes, track_origin 'basic'), a
small quickstart with its peeled SED and image (forced first interaction)
and a binned-images model. The files have the same layout and read alike in both
packages' ModelOutput. Stokes I agrees within Monte-Carlo noise: the
per-bin RMS relative difference between the port and JAX is at most 1.5 x
the one between two seeds of the port (JAX's threefry and torch's Philox
streams differ, so no closer agreement is possible)."""

import h5py
import numpy as np
import pytest
import torch

from hyperion_tpu.model import ModelOutput as JModelOutput
from hyperion_tpu.model.run import run_model as j_run_model
from hyperion_tpu_torch.model import ModelOutput
from hyperion_tpu_torch.model.run import run_model
from test_torch_frontend import class2_model, frontend, tutorial_model
from test_torch_run_model import _layout

torch.set_num_threads(1)


def _dust_hg(package):
    """tests/test_self_regression.py:_dust_hg."""
    nu = np.logspace(np.log10(3e10), np.log10(5e16), 24)
    d = frontend(package).HenyeyGreensteinDust(
        nu, np.full(24, 0.6), np.full(24, 90.0), np.full(24, 0.4),
        np.full(24, 0.3))
    d.set_lte_emissivities(n_temp=40, temp_min=0.1, temp_max=1600.)
    return d


def imaging_peeloff(package, seed=-99):
    """tests/test_self_regression.py:model_imaging_peeloff (4,000 imaging
    photons, the model's own), from either front end."""
    F = frontend(package)
    au = F.au
    m = F.Model()
    x = np.linspace(-2 * au, 2 * au, 6)
    m.set_cartesian_grid(x, x, x)
    m.add_density_grid(np.full((5, 5, 5), 1e-18), _dust_hg(package))
    s = m.add_point_source()
    s.luminosity = F.lsun
    s.temperature = 6000.
    m.set_n_photons(initial=2000, imaging=4000)
    m.set_n_initial_iterations(1)
    conf = m.add_peeled_images(sed=True, image=True)
    conf.set_viewing_angles([30., 120.], [10., 200.])
    conf.set_wavelength_range(6, 0.1, 1000.)
    conf.set_image_size(5, 5)
    conf.set_image_limits(-2 * au, 2 * au, -2 * au, 2 * au)
    conf.set_aperture_radii(3, 0.5 * au, 2 * au)
    conf.set_stokes(True)
    conf.set_track_origin('basic')
    m.set_seed(seed)
    m.set_copy_input(False)
    return m


def binned_model(package, seed=-5):
    """tests/test_binned_images.py's model at 6^3 cells and 8,000 imaging
    photons, with a binned SED and image in 4 x 2 direction bins and the
    uncertainties."""
    F = frontend(package)
    nu = np.logspace(5, 18, 30)
    dust = F.IsotropicDust(nu, np.repeat(0.3, 30), np.repeat(2.0, 30))
    m = F.Model()
    lim = 3 * F.au
    w = np.linspace(-lim, lim, 7)
    m.set_cartesian_grid(w, w, w)
    m.add_density_grid(np.full(m.grid.shape, 1e-17), dust)
    s = m.add_point_source()
    s.luminosity = F.lsun
    s.temperature = 6000.0
    m.set_forced_first_interaction(False)
    m.set_n_photons(initial=3000, imaging=8000)
    m.set_n_initial_iterations(1)
    b = m.add_binned_images(sed=True, image=True)
    b.set_viewing_bins(4, 2)
    b.set_wavelength_range(20, 0.1, 1500.0)
    b.set_image_size(4, 4)
    b.set_image_limits(-lim, lim, -lim, lim)
    b.set_uncertainties(True)
    m.set_seed(seed)
    m.set_copy_input(False)
    return m


def quickstart(package, seed=-7):
    """examples/quickstart.py with its peeled SED and image, cut to 8^3
    cells, one Lucy iteration of 2,000 photons, 6,000 imaging photons and
    an 8 x 8 image."""
    return tutorial_model(package, n=8, n_photons=2000, iterations=1,
                          seed=seed, peeled=True, n_imaging=6000,
                          image_size=8)


MODELS = {'peeloff': imaging_peeloff, 'quickstart': quickstart,
          'binned': binned_model}


def _run(tmp, make, package, seed, name):
    m = make(package, seed=seed)
    m.write(str(tmp / (name + '.rtin')), overwrite=True)
    if package == 'jax':
        j_run_model(m, str(tmp / (name + '.rtout')), batch_size=1024)
    else:
        run_model(m, str(tmp / (name + '.rtout')), device='cpu',
                  batch_size=1024)
    return tmp / (name + '.rtout')


@pytest.fixture(scope='module', params=sorted(MODELS))
def outputs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    make = MODELS[request.param]
    return request.param, dict(
        jax=_run(tmp, make, 'jax', -99, 'jax'),
        port=_run(tmp, make, 'port', -99, 'port'),
        port2=_run(tmp, make, 'port', -4242, 'port2'))


def test_rtout_layout_matches_jax(outputs):
    kind, files = outputs
    jax_layout = _layout(files['jax'])
    port_layout = _layout(files['port'])
    assert sorted(port_layout) == sorted(jax_layout)
    for name, entry in jax_layout.items():
        assert port_layout[name] == entry, name
    group = 'Binned' if kind == 'binned' else 'Peeled/group_00001'
    assert group in port_layout
    with h5py.File(files['port'], 'r') as f:
        assert f.attrs['killed_photons_geo_final'] == 0
        assert f.attrs['killed_photons_int_final'] == 0


def _stokes_i(path, reader, kind):
    """Stokes I of the SED and the image, every origin and bin, read back
    by ``reader`` (either package's ModelOutput)."""
    out = reader(str(path))
    kw = dict(technique='binned') if kind == 'binned' else dict(group=0)
    sed = out.get_sed(inclination='all', aperture='all', **kw)
    image = out.get_image(inclination='all', **kw)
    arrays = [np.asarray(sed.val), np.asarray(image.val)]
    if kind == 'peeloff':
        for comp in ('source_emit', 'dust_emit', 'source_scat', 'dust_scat'):
            arrays.append(np.asarray(out.get_sed(
                inclination='all', aperture='all', component=comp,
                **kw).val))
        q = np.asarray(out.get_sed(inclination='all', aperture='all',
                                   stokes='Q', **kw).val)
        assert np.isfinite(q).all() and np.abs(q).sum() > 0
    return np.concatenate([a.ravel() for a in arrays])


@pytest.mark.parametrize('reader', [ModelOutput, JModelOutput],
                         ids=['port_reader', 'jax_reader'])
def test_stokes_i_agrees_with_jax(outputs, reader):
    kind, files = outputs
    a, b, c = (_stokes_i(files[k], reader, kind)
               for k in ('port', 'port2', 'jax'))
    assert np.isfinite(a).all() and (a >= 0).all()
    sel = (a > 0) & (b > 0) & (c > 0)
    assert sel.sum() > 40

    def rms_rel(x, y):
        return np.sqrt(np.mean((x[sel] / y[sel] - 1.0) ** 2))

    noise = rms_rel(a, b)
    assert noise > 0
    assert rms_rel(a, c) <= 1.5 * noise
    # the two readers agree on the port's file
    np.testing.assert_array_equal(
        _stokes_i(files['port'], ModelOutput, kind),
        _stokes_i(files['port'], JModelOutput, kind))


def test_binned_energy_and_isotropy(outputs):
    """tests/test_binned_images.py:9-41's checks at this size: all the
    emitted energy leaves the grid (within 5%), and each theta bin holds
    flux in proportion to its solid angle (within 15%: 8,000 photons)."""
    kind, files = outputs
    if kind != 'binned':
        pytest.skip('the binned model only')
    sed = ModelOutput(str(files['port'])).get_sed(
        technique='binned', aperture=0, inclination='all')
    assert sed.val.shape == (8, 20)
    dlognu = np.log(sed.nu[-1] / sed.nu[0]) / (len(sed.nu) - 1)
    lsun = frontend('port').lsun
    assert abs(np.sum(sed.val) * dlognu / lsun - 1.0) < 0.05
    per_bin = np.sum(sed.val, axis=1).reshape(4, 2).sum(axis=1)
    tw = np.linspace(0, np.pi, 5)
    solid = np.cos(tw[:-1]) - np.cos(tw[1:])
    np.testing.assert_allclose(per_bin, per_bin.sum() * solid / solid.sum(),
                               rtol=0.15)


def test_class2_imaging_runs_on_the_cpu(tmp_path):
    """A class2-like cut model (24 x 8 cells, MRW, a re-absorbing 2 Rsun
    star) with its peeled SEDs at three inclinations: the imaging iteration
    runs on the CPU, kills nothing, and writes finite SEDs >= 0."""
    m = class2_model('port', n_photons=300, peeled=True, n_imaging=600)
    m.write(str(tmp_path / 'c2.rtin'))
    out = m.run(str(tmp_path / 'c2.rtout'), device='cpu', batch_size=256)
    with h5py.File(tmp_path / 'c2.rtout', 'r') as f:
        assert f['iteration_00001'].attrs['killed_photons_geo'] == 0
        assert f.attrs['killed_photons_geo_final'] == 0
        assert f.attrs['killed_photons_int_final'] == 0
    sed = out.get_sed(group=0, inclination='all', aperture=-1)
    assert sed.val.shape == (3, 120)
    assert np.isfinite(sed.val).all() and (sed.val >= 0).all()
    assert (sed.val.sum(axis=1) > 0).all()
