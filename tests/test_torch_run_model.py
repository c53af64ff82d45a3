"""The whole slice: a scaled-down tutorial model (examples/quickstart.py at
9^3 cells, 2 iterations of 20k photons) built by each package's front end
and run through its run_model, the files read back with the JAX package's
ModelOutput. The files must have the same layout; temperatures agree
statistically (see tests/test_torch_lucy.py). The port's entry points run
on the card unless asked for the CPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from hyperion_tpu.model import ModelOutput
from hyperion_tpu.model.run import run_model as j_run_model
from hyperion_tpu_torch.util.constants import lsun
from hyperion_tpu_torch.device import resolve_device
from hyperion_tpu_torch.model.run import run_lucy_model, run_model
from test_torch_frontend import tutorial_model as _tutorial

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def tutorial_model(package='port', seed=-1234):
    """examples/quickstart.py without its peeled image, scaled down to 9^3
    cells and 2 iterations of 20k photons, and denser than the tutorial,
    so that 20k photons interact."""
    m = _tutorial(package, n=9, n_photons=20000, iterations=2, seed=seed,
                  density=3e-17)
    m.conf.output.output_n_photons = 'last'
    return m


def _layout(path):
    """{hdf5 path: (kind, shape, dtype, attribute names)} of a file."""
    out = {}
    with h5py.File(path, 'r') as f:
        out['/'] = ('group', None, None, sorted(f.attrs))

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = ('dataset', obj.shape, obj.dtype,
                             sorted(obj.attrs))
            else:
                out[name] = ('group', None, None, sorted(obj.attrs))
        f.visititems(visit)
    return out


@pytest.fixture(scope='module')
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('slice')
    mj = tutorial_model('jax')
    mj.write(str(tmp / 'mj.rtin'), overwrite=True)
    j_run_model(mj, str(tmp / 'jax.rtout'), batch_size=2048)
    m = tutorial_model()
    m.write(str(tmp / 'm.rtin'), overwrite=True)
    run_model(m, str(tmp / 'port.rtout'), device='cpu', batch_size=2048)
    m2 = tutorial_model(seed=-999)
    m2.write(str(tmp / 'm2.rtin'), overwrite=True)
    run_model(m2, str(tmp / 'port2.rtout'), device='cpu', batch_size=2048)
    return tmp


def test_rtout_layout_matches_jax(outputs):
    jax_layout = _layout(outputs / 'jax.rtout')
    port_layout = _layout(outputs / 'port.rtout')
    assert sorted(port_layout) == sorted(jax_layout)
    for name, entry in jax_layout.items():
        assert port_layout[name] == entry, name
    with h5py.File(outputs / 'jax.rtout', 'r') as fj, \
            h5py.File(outputs / 'port.rtout', 'r') as fp:
        assert fp.attrs['iterations'] == fj.attrs['iterations'] == 2
        for g in ('iteration_00001', 'iteration_00002'):
            assert fp[g].attrs['killed_photons_geo'] == 0
            assert fp[g].attrs['killed_photons_int'] == 0


def test_temperatures_agree_with_jax(outputs):
    def temperature(name):
        grid = ModelOutput(str(outputs / name)).get_quantities()
        return np.asarray(grid['temperature'][0].array)

    t_jax = temperature('jax.rtout')
    t_port = temperature('port.rtout')
    t_port2 = temperature('port2.rtout')
    assert np.isfinite(t_port).all() and (t_port > 0).all()

    def rms_rel(a, b):
        return np.sqrt(np.mean((a / b - 1.0) ** 2))

    noise = rms_rel(t_port, t_port2)
    assert noise > 0
    assert rms_rel(t_port, t_jax) <= 1.5 * noise
    n_photons = ModelOutput(str(outputs / 'port.rtout')).get_quantities()
    assert np.asarray(n_photons['n_photons'].array).sum() > 0


def test_port_never_imports_jax(tmp_path):
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from hyperion_tpu_torch.dust import IsotropicDust
        from hyperion_tpu_torch.model import Model, ModelOutput
        from hyperion_tpu_torch.model.run import run_model
        m = Model()
        w = np.linspace(-1e14, 1e14, 4)
        m.set_cartesian_grid(w, w, w)
        nu = np.logspace(8, 17, 8)
        m.add_density_grid(np.full(m.grid.shape, 1e-18),
                           IsotropicDust(nu, np.repeat(0.4, 8),
                                         np.repeat(100.0, 8)))
        s = m.add_point_source()
        s.luminosity = 3.8e33
        s.temperature = 6000.0
        m.set_n_initial_iterations(1)
        m.set_n_photons(initial=500, imaging=0)
        m.write(sys.argv[1] + '.rtin')
        run_model(m, sys.argv[1], device='cpu', batch_size=256)
        ModelOutput(sys.argv[1]).get_quantities()
        assert 'jax' not in sys.modules, 'jax was imported'
        assert 'hyperion_tpu' not in sys.modules, 'hyperion_tpu was imported'
    """)
    proc = subprocess.run([sys.executable, '-c', code,
                           str(tmp_path / 'x.rtout')], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        run_model(tutorial_model(), 'unused.rtout', device='cuda')


@pytest.mark.parametrize('entry', ['resolve_device', 'run_lucy_model',
                                   'run_model', 'Model.run'])
def test_entry_points_need_the_card_unless_asked(entry, monkeypatch,
                                                 tmp_path):
    """Without a device argument every entry point asks for the card and
    raises where there is none; only device='cpu' runs on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    m = tutorial_model()
    m.write(str(tmp_path / 'm.rtin'))
    call = {'resolve_device': lambda: resolve_device(),
            'run_lucy_model': lambda: run_lucy_model(m),
            'run_model': lambda: run_model(m, str(tmp_path / 'x.rtout')),
            'Model.run': lambda: m.run()}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert resolve_device('cpu') == torch.device('cpu')
    assert not (tmp_path / 'x.rtout').exists()


def _amr(m):
    from hyperion_tpu_torch.grid import AMRGrid
    dust = m.dust[0]
    amr = AMRGrid()
    g = amr.add_level().add_grid()
    g.xmin, g.xmax = g.ymin, g.ymax = g.zmin, g.zmax = -1e14, 1e14
    g.nx = g.ny = g.nz = 4
    g.quantities['density'] = np.full((4, 4, 4), 1e-18)
    m.set_amr_grid(amr)
    m.add_density_grid(amr['density'], dust)


def _voronoi(m):
    dust = m.dust[0]
    pts = np.random.default_rng(3).uniform(-1e14, 1e14, (3, 30))
    m.set_voronoi_grid(*pts)
    m.add_density_grid(np.full(30, 1e-18), dust)


def _octree(m):
    dust = m.dust[0]
    refined = [True] + [False] * 8
    m.set_octree_grid(0.0, 0.0, 0.0, 1e14, 1e14, 1e14, refined)
    m.add_density_grid(np.full(len(refined), 1e-18), dust)
    s = m.add_map_source()
    s.luminosity = lsun
    s.temperature = 5000.0
    s.map = np.ones(len(refined))


def _two_processes(m):
    # a multi-device run (Model.run refuses it before it needs a file)
    return lambda path: m.run(path, n_processes=2, device='cpu')
def test_jax_model_is_refused(tmp_path):
    """A model built with hyperion_tpu's front end is not the port's."""
    with pytest.raises(TypeError, match='hyperion_tpu_torch.model.Model'):
        run_model(tutorial_model('jax'), str(tmp_path / 'x.rtout'),
                  device='cpu')


@pytest.mark.parametrize('change', [_amr, _voronoi, _octree,
                                    _two_processes])
def test_outside_the_slice_raises(change, tmp_path):
    """What the port does not run yet raises, naming its ROADMAP.md item:
    the AMR, Voronoi and octree grids (the octree with a map source, which
    the port now emits from on the other grids) and multi-device runs."""
    m = tutorial_model()
    run = change(m) or (lambda path: run_model(m, path, device='cpu'))
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        run(str(tmp_path / 'x.rtout'))


@pytest.mark.parametrize('where', ['checkout', 'alone'])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, from the checkout and as a lone file."""
    script = REPO / 'chip_smoke.py'
    if where == 'alone':
        script = tmp_path / 'chip_smoke.py'
        script.write_text((REPO / 'chip_smoke.py').read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=''),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_initial_and_additional_specific_energy():
    """A specific energy in the grid seeds the first iteration's
    emissivities ('initial'); with 'additional' it is also added to every
    iteration's estimate (ref grid_physics_3d.f90:213-240,530-541). With
    the same seed the two runs' Monte-Carlo parts are the same, so they
    differ by exactly the added field."""
    def run(kind):
        m = tutorial_model()
        m.set_n_initial_iterations(1)
        add = np.random.default_rng(5).uniform(1e4, 3e4, m.grid.shape)
        dust = m.dust[0]
        m.grid['density'] = []
        m.dust = []
        m.add_density_grid(np.full(m.grid.shape, 3e-17), dust,
                           specific_energy=add)
        m.set_specific_energy_type(kind)
        return run_lucy_model(m, device='cpu', batch_size=2048), add

    initial, add = run('initial')
    additional, _ = run('additional')
    se_i = initial.result.specific_energy[0]
    se_a = additional.result.specific_energy[0]
    assert initial.result.energy_current == 20000.0
    assert (se_i > 0).all()
    np.testing.assert_allclose(se_a, se_i + add.reshape(-1), rtol=1e-12)
