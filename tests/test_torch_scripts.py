"""The port's command line and FITS export against the JAX package's
(hyperion_tpu/scripts/main.py, scripts/tofits.py, util/minifits.py):

- ``hyperion_tpu_torch.scripts.main.main(['--cpu', ...])`` runs a
  quickstart .rtin to an .rtout with ``date_ended`` that both packages'
  ModelOutput read alike; ``-m 2``, ``--shard-grid`` and ``-m 4
  --shard-grid`` run (gloo ranks on the CPU) to temperatures within noise
  of ``--cpu`` alone; ``--f64`` without ``--cpu`` and an existing output
  without ``-f`` are refused;
- the port's minifits writes the JAX copy's bytes and reads them back;
- the port's tofits mirrors tests/test_scripts.py and writes the same
  files, byte for byte, as the JAX package's from the same .rtout;
- pyproject.toml names both console scripts of each package."""

import os
from pathlib import Path

import h5py
import numpy as np
import pytest

from hyperion_tpu.util import minifits as j_minifits
from hyperion_tpu_torch.util.minifits import readfrom, writeto
from test_torch_frontend import PACKAGES, frontend

REPO = Path(__file__).resolve().parent.parent


def quickstart_rtin(tmp_path, n_photons=1000):
    """tests/test_scripts.py's launcher model, built with the port."""
    F = frontend('port')
    nu = np.logspace(5, 18, 16)
    dust = F.IsotropicDust(nu, np.repeat(0.4, 16), np.repeat(1.0, 16))
    m = F.Model()
    w = np.linspace(-1, 1, 5)
    m.set_cartesian_grid(w, w, w)
    m.add_density_grid(np.full((4, 4, 4), 0.05), dust)
    s = m.add_point_source()
    s.luminosity = 1.0
    s.temperature = 5000.0
    m.set_n_photons(initial=n_photons, imaging=0)
    m.set_n_initial_iterations(1)
    rtin = str(tmp_path / 'q.rtin')
    m.write(rtin)
    return rtin


def test_launcher_main_runs_quickstart(tmp_path, capsys):
    from hyperion_tpu_torch.scripts.main import main
    rtin = quickstart_rtin(tmp_path)
    rtout = str(tmp_path / 'q.rtout')
    assert main(['--cpu', rtin, rtout]) == 0
    assert 'run complete' in capsys.readouterr().out
    with h5py.File(rtout, 'r') as f:
        assert 'date_ended' in f.attrs
        assert f['iteration_00001'].attrs['killed_photons_geo'] == 0
    temps = [np.asarray(frontend(pkg).ModelOutput(rtout).get_quantities()
                        ['temperature'].array) for pkg in PACKAGES]
    np.testing.assert_array_equal(temps[0], temps[1])
    assert temps[0].shape == (1, 4, 4, 4) and (temps[0] > 0).all()
    # the output exists: refused without -f, run again with it (float64)
    with pytest.raises(SystemExit):
        main(['--cpu', rtin, rtout])
    assert main(['-f', '--cpu', '--f64', rtin, rtout]) == 0


@pytest.mark.parametrize('flags', [['-m', '2'], ['--shard-grid'],
                                   ['-m', '4', '--shard-grid']])
def test_launcher_runs_multi_device(flags, tmp_path):
    """``-m N`` runs N ranks (photon-parallel, or with ``--shard-grid`` the
    grid cut into slabs over them); ``--shard-grid`` without ``-m`` runs on
    one device, as in the JAX package. The temperatures are finite and
    their median within 5% of ``--cpu`` alone's."""
    from hyperion_tpu_torch.scripts.main import main
    rtin = quickstart_rtin(tmp_path, n_photons=4000)
    temps = []
    for name, extra in (('one', []), ('x', flags)):
        out = str(tmp_path / ('%s.rtout' % name))
        assert main(extra + ['--cpu', rtin, out]) == 0
        temps.append(np.asarray(frontend('port').ModelOutput(out)
                                .get_quantities()['temperature'].array))
    assert np.isfinite(temps[1]).all() and (temps[1] > 0).all()
    assert abs(np.median(temps[1] / temps[0]) - 1.0) < 0.05


def test_launcher_refuses_f64_on_the_card(tmp_path):
    from hyperion_tpu_torch.scripts.main import main
    with pytest.raises(SystemExit):
        main(['--f64', str(tmp_path / 'q.rtin'), str(tmp_path / 'q.rtout')])


@pytest.mark.parametrize('data', [
    np.arange(24, dtype=np.float64).reshape(2, 3, 4),
    np.arange(6, dtype=np.float32).reshape(3, 2),
    np.arange(5, dtype=np.int32), np.arange(4, dtype=np.int64),
    np.array([[0.5, -1e300], [np.inf, 2.0]])], ids=str)
def test_minifits_bytes_equal_jax(data, tmp_path):
    ours, theirs = str(tmp_path / 'p.fits'), str(tmp_path / 'j.fits')
    header = {'EXTRAKEY': 42, 'RATIO': 0.25, 'NAME': "it's", 'FLAG': True}
    writeto(ours, data, header=header, overwrite=True)
    j_minifits.writeto(theirs, data, header=header, overwrite=True)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    back, hdr = readfrom(ours)
    np.testing.assert_array_equal(back, data)
    assert hdr['EXTRAKEY'] == 42 and os.path.getsize(ours) % 2880 == 0
    with pytest.raises(OSError):
        writeto(ours, data, overwrite=False)


def _rtout(path):
    """tests/test_scripts.py's .rtout, with a binned image too."""
    rng = np.random.default_rng(3)
    with h5py.File(path, 'w') as f:
        g = f.create_group('Peeled/group_00001')
        g.create_dataset('images', data=rng.random((1, 4, 5, 3, 1),
                                                   dtype=np.float32))
        g.create_dataset('seds', data=rng.random((1, 2, 3, 1),
                                                 dtype=np.float32))
        f.create_group('Binned').create_dataset(
            'images', data=rng.random((1, 2, 3, 4, 2)))
        it = f.create_group('iteration_00001')
        it.create_dataset('specific_energy', data=rng.random((6, 5, 4)))
        it.create_dataset('density', data=rng.random((6, 5, 4)))


def test_tofits_writes_the_jax_files(tmp_path):
    """The port's tofits writes each image, SED and physical grid of an
    .rtout (tests/test_scripts.py's checks), the same files with the same
    bytes as the JAX package's tofits."""
    from hyperion_tpu.scripts.tofits import main as j_main
    from hyperion_tpu_torch.scripts.tofits import main
    out = {}
    for name, run in (('port', main), ('jax', j_main)):
        d = tmp_path / name
        d.mkdir()
        _rtout(str(d / 'model.rtout'))
        assert run(['--images', '--physics', str(d / 'model.rtout')]) == 0
        out[name] = {p.name: p.read_bytes() for p in d.glob('*.fits')}
    assert out['port'] == out['jax']
    assert sorted(out['port']) == [
        'model_00001_images.fits', 'model_00001_seds.fits',
        'model_binned_images.fits', 'model_density.fits',
        'model_specific_energy.fits']
    with h5py.File(str(tmp_path / 'port' / 'model.rtout'), 'r') as f:
        img = f['Peeled/group_00001/images'][()]
        se = f['iteration_00001/specific_energy'][()]
    back, _ = readfrom(str(tmp_path / 'port' / 'model_00001_images.fits'))
    np.testing.assert_array_equal(back, img)
    back, _ = readfrom(str(tmp_path / 'port' / 'model_specific_energy.fits'))
    np.testing.assert_array_equal(back, se)


def test_tofits_requires_mode_and_files(tmp_path, capsys):
    from hyperion_tpu_torch.scripts.tofits import main
    assert main([str(tmp_path / 'none.rtout')]) == 1
    assert main(['--images']) == 1
    # an unreadable file is reported and skipped
    assert main(['--images', str(tmp_path / 'none.rtout')]) == 0
    assert 'failed' in capsys.readouterr().out


def test_console_scripts_are_declared():
    text = (REPO / 'pyproject.toml').read_text()
    for line in ('hyperion_tpu = "hyperion_tpu.scripts.main:main"',
                 'hyperion_tpu2fits = "hyperion_tpu.scripts.tofits:main"',
                 'hyperion_tpu_torch = "hyperion_tpu_torch.scripts.main:main"',
                 'hyperion_tpu_torch2fits = '
                 '"hyperion_tpu_torch.scripts.tofits:main"'):
        assert line in text, line
