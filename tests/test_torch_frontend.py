"""The port's own front end held to the JAX package's, and the builders that
every tests/test_torch_*.py file uses to make the same model or objects
from either package.

hyperion_tpu_torch carries a copy of hyperion_tpu's JAX-free front end
(model, dust, grid, sources, conf, filter, util). Built from either package
with the same arguments, a model must write the same .rtin (every dataset
and attribute, apart from version strings); the port's Model.run writes an
.rtout that both packages' ModelOutput read back alike; and no module of
the port, nor chip_smoke.py, imports JAX or anything of hyperion_tpu."""

import ast
import importlib
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hyperion_tpu_torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
PACKAGES = {'jax': 'hyperion_tpu', 'port': 'hyperion_tpu_torch'}


def frontend(package):
    """The front-end classes and constants of 'jax' (hyperion_tpu) or
    'port' (hyperion_tpu_torch)."""
    name = PACKAGES[package]

    def mod(sub):
        return importlib.import_module('%s.%s' % (name, sub))

    dust, grid, sources = mod('dust'), mod('grid'), mod('sources')
    model, const = mod('model'), mod('util.constants')
    return SimpleNamespace(
        IsotropicDust=dust.IsotropicDust,
        HenyeyGreensteinDust=dust.HenyeyGreensteinDust,
        CartesianGrid=grid.CartesianGrid,
        SphericalPolarGrid=grid.SphericalPolarGrid,
        CylindricalPolarGrid=grid.CylindricalPolarGrid,
        OctreeGrid=grid.OctreeGrid, AMRGrid=grid.AMRGrid,
        PointSource=sources.PointSource,
        PointSourceCollection=sources.PointSourceCollection,
        SphericalSource=sources.SphericalSource,
        ExternalSphericalSource=sources.ExternalSphericalSource,
        ExternalBoxSource=sources.ExternalBoxSource,
        PlaneParallelSource=sources.PlaneParallelSource,
        MapSource=sources.MapSource,
        Model=model.Model, AnalyticalYSOModel=model.AnalyticalYSOModel,
        ModelOutput=model.ModelOutput, densities=mod('densities'),
        au=const.au, lsun=const.lsun, rsun=const.rsun, msun=const.msun)


def tutorial_model(package, n=32, n_photons=500_000, iterations=4,
                   seed=20261016, density=1e-19, peeled=False,
                   n_imaging=1_000_000, image_size=128):
    """examples/quickstart.py: n^3 cells of +-50 au, one isotropic dust, a
    1 Lsun 6000 K point source; with ``peeled`` its peeled group (one view
    at 45 degrees, an image_size^2 image, 60 wavelengths from 0.3 to 1000
    um, one aperture) and ``n_imaging`` imaging photons."""
    F = frontend(package)
    nu = np.logspace(8, 17, 32)
    dust = F.IsotropicDust(nu, np.repeat(0.4, 32), np.repeat(100.0, 32))
    m = F.Model()
    lim = 50 * F.au
    w = np.linspace(-lim, lim, n + 1)
    m.set_cartesian_grid(w, w, w)
    m.add_density_grid(np.full(m.grid.shape, density), dust)
    src = m.add_point_source(name='star')
    src.luminosity = F.lsun
    src.temperature = 6000.0
    m.set_n_initial_iterations(iterations)
    m.set_n_photons(initial=n_photons, imaging=n_imaging if peeled else 0)
    if peeled:
        sed = m.add_peeled_images(sed=True, image=True)
        sed.set_viewing_angles([45.0], [0.0])
        sed.set_image_size(image_size, image_size)
        sed.set_image_limits(-lim, lim, -lim, lim)
        sed.set_wavelength_range(60, 0.3, 1000.0)
        sed.set_aperture_radii(1, 2 * lim, 2 * lim)
    m.set_seed(seed)
    return m


def lte_dust(package, albedo=0.4, chi=60.0, n_nu=24, nu_lo=3e10):
    """A gray-ish isotropic dust with LTE emissivities on a 40-temperature
    grid (tests/test_self_regression.py:_dust_iso when the defaults are
    kept)."""
    nu = np.logspace(np.log10(nu_lo), np.log10(5e16), n_nu)
    alb = albedo if np.ndim(albedo) else np.full(n_nu, albedo)
    ch = chi if np.ndim(chi) else np.full(n_nu, chi)
    d = frontend(package).IsotropicDust(nu, alb, ch)
    d.set_lte_emissivities(n_temp=40, temp_min=0.1, temp_max=1600.)
    return d


def point_sources(package, scale=1.0):
    """A three-point collection of 4000 K and a 9000 K point source, at
    positions in units of ``scale``."""
    F = frontend(package)
    c = F.PointSourceCollection(name='cluster')
    c.luminosity = np.array([1.0, 2.0, 0.5]) * F.lsun
    c.position = np.array([[0.0, 0.0, 0.0], [0.3, 0.0, -0.2],
                           [-0.1, 0.4, 0.1]]) * scale
    c.temperature = 4000.0
    s = F.PointSource(name='star', luminosity=3 * F.lsun,
                      temperature=9000.0,
                      position=(0.1 * scale, 0.2 * scale, 0.3 * scale))
    return [c, s]


def two_dust_model(package, n=6, n_photons=4000):
    """Two dusts (the second sublimates) on a non-uniform cartesian grid,
    lit by a point-source collection and a point source."""
    F = frontend(package)
    m = F.Model()
    L = 20 * F.au
    m.set_cartesian_grid(np.linspace(-L, L, n + 1),
                         np.linspace(-L, L, n + 2),
                         np.concatenate([[-L], np.geomspace(0.1, 1, n) * L]))
    rng = np.random.default_rng(3)
    dust_b = lte_dust(package, albedo=0.6, chi=20.0)
    dust_b.set_sublimation_specific_energy('fast', 5.0)
    for d, rho in ((lte_dust(package), 1e-18), (dust_b, 3e-18)):
        m.add_density_grid(rho * rng.uniform(0.5, 1.5, m.grid.shape), d)
    for s in point_sources(package, scale=0.5 * L):
        m.add_source(s)
    m.set_n_initial_iterations(2)
    m.set_n_photons(initial=n_photons, imaging=0)
    m.set_minimum_temperature(5.0)
    m.set_seed(-77)
    m.conf.output.output_density = 'last'
    m.conf.output.output_n_photons = 'last'
    return m


def class2_model(package, n_r=24, n_t=8, n_photons=200, iterations=1,
                 seed=-1234, peeled=False, n_imaging=500_000):
    """examples/class2_sed.py: an AnalyticalYSOModel of a flared disk
    around a 2 Rsun star, HG dust, an auto spherical-polar grid (96 x 32 x 1
    in the example), MRW with gamma 2; with ``peeled`` its peeled SEDs (20,
    45 and 80 degrees, 120 wavelengths from 0.3 to 2000 um, one 400 au
    aperture) and ``n_imaging`` imaging photons."""
    F = frontend(package)
    nu = np.logspace(8, 17, 64)
    dust = F.HenyeyGreensteinDust(nu, np.repeat(0.5, 64),
                                  np.repeat(400.0, 64), np.repeat(0.4, 64),
                                  np.repeat(0.8, 64))
    m = F.AnalyticalYSOModel()
    m.star.luminosity = F.lsun
    m.star.radius = 2.0 * F.rsun
    m.star.temperature = 4300.0
    disk = m.add_flared_disk()
    disk.mass = 1e-3 * F.msun
    disk.rmin = 0.1 * F.au
    disk.rmax = 200.0 * F.au
    disk.r_0 = 10.0 * F.au
    disk.h_0 = 0.4 * F.au
    disk.p = -1.0
    disk.beta = 1.25
    disk.dust = dust
    m.set_spherical_polar_grid_auto(n_r, n_t, 1)
    if peeled:
        sed = m.add_peeled_images(sed=True, image=False)
        sed.set_viewing_angles([20.0, 45.0, 80.0], [0.0, 0.0, 0.0])
        sed.set_wavelength_range(120, 0.3, 2000.0)
        sed.set_aperture_radii(1, 400 * F.au, 400 * F.au)
    m.set_mrw(True, gamma=2.0)
    m.set_n_initial_iterations(iterations)
    m.set_n_photons(initial=n_photons, imaging=n_imaging if peeled else 0)
    m.set_seed(seed)
    return m


def octree_model(package, n_photons=2000):
    """tests/test_octree.py's two-level octree (the root and its first
    child refined) with dust in the leaves, a point source and a map
    source over the nodes, and a peeled SED."""
    F = frontend(package)
    refined = np.array([True, True] + [False] * 15)
    m = F.Model()
    m.set_octree_grid(0.0, 0.0, 0.0, 10 * F.au, 10 * F.au, 10 * F.au,
                      refined)
    rho = np.where(refined, 0.0, np.linspace(1e-18, 3e-18, 17))
    m.add_density_grid(rho, F.IsotropicDust(
        np.logspace(8, 17, 10), np.repeat(0.4, 10), np.repeat(40.0, 10)))
    s = m.add_point_source(name='star')
    s.luminosity, s.temperature = F.lsun, 6000.0
    s.position = (1.0 * F.au, -2.0 * F.au, 0.5 * F.au)
    mp = m.add_map_source(name='map')
    mp.luminosity, mp.temperature = 0.1 * F.lsun, 3000.0
    mp.map = np.where(refined, 0.0, np.arange(17.0))
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([30.0], [10.0])
    sed.set_wavelength_range(8, 0.3, 1000.0)
    m.set_n_initial_iterations(1)
    m.set_n_photons(initial=n_photons, imaging=n_photons)
    return m


def amr_model(package, n_photons=2000):
    """A two-level AMR grid (a coarse fab and two finer ones) with a
    density per fab, a point source and a peeled SED."""
    F = frontend(package)
    amr = F.AMRGrid()
    scale = 10 * F.au
    for level, fabs in enumerate([[((-1.0, 1.0) * 3, (4, 4, 4))],
                                  [((-0.5, 0.0, -0.5, 0.5, -0.5, 0.5),
                                    (2, 4, 4)),
                                   ((0.0, 0.5, -0.5, 0.5, -0.5, 0.5),
                                    (2, 4, 4))]]):
        lev = amr.add_level()
        for b, n in fabs:
            g = lev.add_grid()
            g.xmin, g.xmax, g.ymin, g.ymax, g.zmin, g.zmax = \
                (v * scale for v in b)
            g.nx, g.ny, g.nz = n
            g.quantities['density'] = np.full(n[::-1], 1e-18 * (level + 1))
    m = F.Model()
    m.set_amr_grid(amr)
    m.add_density_grid(amr['density'], F.IsotropicDust(
        np.logspace(8, 17, 10), np.repeat(0.4, 10), np.repeat(40.0, 10)))
    s = m.add_point_source(name='star')
    s.luminosity, s.temperature = F.lsun, 6000.0
    s.position = (0.0, 0.0, 0.0)
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([60.0], [0.0])
    sed.set_wavelength_range(8, 0.3, 1000.0)
    m.set_mrw(True, gamma=2.0)
    m.set_n_initial_iterations(1)
    m.set_n_photons(initial=n_photons, imaging=n_photons)
    return m


MODELS = {'tutorial': lambda pkg: tutorial_model(pkg, n=8, n_photons=3000,
                                                 iterations=1),
          'two_dusts_collection': two_dust_model,
          'class2_yso': class2_model,
          'octree_with_map': octree_model,
          'amr_two_levels': amr_model}

# attributes that name the writing package or the time of writing
_UNCOMPARED = ('python_version', 'date_started', 'date_ended')


def _contents(path):
    """{hdf5 path: (kind, data, {attribute: value})} of a whole file."""
    def attrs(obj):
        return {k: v for k, v in obj.attrs.items() if k not in _UNCOMPARED}

    import h5py
    with h5py.File(path, 'r') as f:
        out = {'/': ('group', None, attrs(f))}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = ('dataset', obj[()], attrs(obj))
            else:
                out[name] = ('group', None, attrs(obj))
        f.visititems(visit)
    return out


def _assert_same_contents(a, b):
    assert sorted(a) == sorted(b)
    for name, (kind, data, attrs) in a.items():
        kind_b, data_b, attrs_b = b[name]
        assert kind == kind_b, name
        assert sorted(attrs) == sorted(attrs_b), name
        for k, v in attrs.items():
            assert np.array_equal(v, attrs_b[k]), (name, k)
        if kind == 'dataset':
            assert data.dtype == data_b.dtype, name
            assert np.array_equal(data, data_b), name


@pytest.mark.parametrize('which', sorted(MODELS))
def test_rtin_equals_jax(which, tmp_path):
    for pkg in PACKAGES:
        MODELS[which](pkg).write(str(tmp_path / (pkg + '.rtin')))
    jax_file = _contents(tmp_path / 'jax.rtin')
    assert 'Dust/dust_001' in jax_file and 'Sources/source_00001' in jax_file
    _assert_same_contents(_contents(tmp_path / 'port.rtin'), jax_file)


def test_model_run_rtout_reads_alike(tmp_path):
    m = two_dust_model('port')
    m.write(str(tmp_path / 'm.rtin'))
    out = m.run(device='cpu', batch_size=1024)
    assert isinstance(out, hyperion_tpu_torch.model.ModelOutput)
    readers = [frontend(pkg).ModelOutput(str(tmp_path / 'm.rtout'))
               for pkg in PACKAGES]
    grids = [r.get_quantities() for r in readers]
    names = sorted(grids[0].quantities)
    assert {'temperature', 'specific_energy', 'density',
            'n_photons'} <= set(names)
    assert sorted(grids[1].quantities) == names
    for q in names:
        a, b = (np.asarray(g[q].array) for g in grids)
        np.testing.assert_array_equal(a, b, err_msg=q)
    t = np.asarray(grids[0]['temperature'].array)
    assert t.shape == (2,) + m.grid.shape
    assert np.isfinite(t).all() and (t > 0).all()


@pytest.mark.parametrize('make', [octree_model, amr_model],
                         ids=['octree', 'amr'])
def test_box_grid_models_run_and_read_alike(make, tmp_path):
    """An octree model (with a map source) and an AMR model (with MRW) run
    through the port's Model.run on the CPU; both packages' ModelOutput
    read the same quantities back, in the grid's own layout (the octree's
    flat nodes, the AMR grid's level_*/grid_* datasets), and the peeled
    SED."""
    m = make('port')
    m.write(str(tmp_path / 'm.rtin'))
    m.run(device='cpu', batch_size=1024)
    readers = [frontend(pkg).ModelOutput(str(tmp_path / 'm.rtout'))
               for pkg in PACKAGES]
    grids = [r.get_quantities() for r in readers]
    t = [g['temperature'] for g in grids]
    if make is octree_model:
        assert sorted(grids[0].quantities) == sorted(grids[1].quantities)
        a, b = (np.asarray(x.array) for x in t)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (1, 17) and (a[0, ~m.grid.refined] > 0).all()
    else:
        assert len(t[0].levels) == len(t[1].levels) == 2
        for la, lb in zip(t[0].levels, t[1].levels):
            for ga, gb in zip(la.grids, lb.grids):
                a, b = (np.asarray(g.quantities['temperature'])
                        for g in (ga, gb))
                np.testing.assert_array_equal(a, b)
                assert (a > 0).all()
    seds = [r.get_sed(inclination=0, aperture=-1).val for r in readers]
    np.testing.assert_array_equal(seds[0], seds[1])
    assert np.isfinite(seds[0]).all() and (seds[0] > 0).any()


def test_yso_model_runs_on_the_cpu(tmp_path):
    """The port's AnalyticalYSOModel (class2 at 24 x 8 x 1, MRW, a
    spherical star that re-absorbs) runs through its own run() on the CPU:
    nothing killed, temperatures finite and positive in dusty
    cells."""
    m = class2_model('port', iterations=2)
    model = m.write(str(tmp_path / 'c2.rtin'))
    out = m.run(str(tmp_path / 'c2.rtout'), device='cpu', batch_size=256)
    import h5py
    with h5py.File(tmp_path / 'c2.rtout', 'r') as f:
        for g in ('iteration_00001', 'iteration_00002'):
            assert f[g].attrs['killed_photons_geo'] == 0
            assert f[g].attrs['killed_photons_int'] == 0
    grid = out.get_quantities()
    t = np.asarray(grid['temperature'][0].array)
    dusty = np.asarray(model.grid['density'][0].array) > 0
    assert np.isfinite(t).all()
    assert dusty.sum() > 30 and (t[dusty] > 0.0).all()


def _structures(package, grid):
    """Every density class of the densities package on ``grid`` (the
    ambient medium on a spherical-polar grid only)."""
    D = frontend(package).densities
    F = frontend(package)
    star = type('Star', (), {'mass': F.msun, 'radius': F.rsun})()
    yr = 365.25 * 24 * 3600
    flared = D.FlaredDisk(mass=0.01 * F.msun, rmin=0.5 * F.au,
                          rmax=100 * F.au, r_0=F.au, h_0=0.5 * F.au)
    alpha = D.AlphaDisk(mass=0.01 * F.msun, rmin=5 * F.rsun,
                        rmax=50 * F.au, r_0=F.au, h_0=0.5 * F.au,
                        mdot=1e-7 * F.msun / yr, star=star)
    power = D.PowerLawEnvelope(mass=0.1 * F.msun, rmin=0.5 * F.au,
                               rmax=400 * F.au, r_0=F.au, power=-1.5)
    cav = power.add_bipolar_cavity()
    cav.theta_0, cav.power, cav.r_0, cav.rho_0 = 20.0, 1.5, 100 * F.au, 1e-20
    ulrich = D.UlrichEnvelope(mdot=1e-6 * F.msun / yr, rc=50 * F.au,
                              rmin=0.5 * F.au, rmax=400 * F.au, star=star)
    out = {'flared': flared.density(grid), 'alpha': alpha.density(grid),
           'power_law_with_cavity': power.density(grid),
           'cavity': cav.density(grid), 'ulrich': ulrich.density(grid),
           'flared_column': flared.midplane_cumulative_density(
               np.array([F.au, 10 * F.au]))}
    if isinstance(grid, F.SphericalPolarGrid):
        # an ambient medium takes spherical-polar grids only
        out['ambient'] = D.AmbientMedium(
            rho=1e-21, rmin=0.5 * F.au, rmax=400 * F.au,
            subtract=[power]).density(grid)
    return out


@pytest.mark.parametrize('kind', ['spherical', 'cylindrical'])
def test_densities_equal_jax(kind):
    def grid(package):
        F = frontend(package)
        if kind == 'spherical':
            return F.SphericalPolarGrid(
                np.hstack([0.0, np.geomspace(0.05 * F.au, 500 * F.au, 40)]),
                np.linspace(0, np.pi, 17), np.array([0.0, 2 * np.pi]))
        return F.CylindricalPolarGrid(
            np.hstack([0.0, np.geomspace(0.05 * F.au, 500 * F.au, 40)]),
            np.linspace(-100 * F.au, 100 * F.au, 21),
            np.linspace(0.0, 2 * np.pi, 3))

    ref = _structures('jax', grid('jax'))
    port = _structures('port', grid('port'))
    assert sorted(port) == sorted(ref)
    for name, rho in ref.items():
        assert np.asarray(rho).any(), name
        np.testing.assert_array_equal(port[name], rho, err_msg=name)


def test_model_run_mpi_on_the_cpu_runs_one_rank(tmp_path):
    """mpi=True asks for a rank per card: one rank on the CPU, which is the
    single-device run (the same bits as n_processes=1)."""
    m = two_dust_model('port')
    m.write(str(tmp_path / 'm.rtin'))
    temps = []
    for name, kw in (('mpi', dict(mpi=True)), ('one', dict(n_processes=1))):
        out = m.run(str(tmp_path / ('%s.rtout' % name)), device='cpu', **kw)
        temps.append(np.asarray(out.get_quantities()['temperature'][0]
                                .array))
    assert np.isfinite(temps[0]).all() and (temps[0] > 0).any()
    np.testing.assert_array_equal(temps[0], temps[1])


def test_port_imports_neither_jax_nor_hyperion_tpu():
    """Every module of the port imports, in a fresh interpreter without
    h5py (as on the card's machine), and leaves jax and hyperion_tpu out of
    sys.modules; a model with a peeled SED is then built and run, Lucy and
    imaging, without HDF5."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules['h5py'] = None      # no HDF5, as on the card's machine
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import hyperion_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            hyperion_tpu_torch.__path__, 'hyperion_tpu_torch.')]
        for name in names:
            importlib.import_module(name)
        # the JAX-free host modules: the importers and the native library
        for sub in ('importers', 'importers.sph', 'importers.orion',
                    'native'):
            assert 'hyperion_tpu_torch.' + sub in names, sub
        from hyperion_tpu_torch import native
        from hyperion_tpu_torch.importers import construct_octree
        rng = np.random.default_rng(0)
        p = rng.normal(0.0, 0.3, (3, 300))
        g = construct_octree(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, *p,
                             np.full(300, 0.05), np.full(300, 1.0), n_ref=16)
        assert len(g.refined) > 1 and native.available()
        from hyperion_tpu_torch.dust import IsotropicDust
        from hyperion_tpu_torch.model import Model, run_lucy_model
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
        m.set_n_photons(initial=500, imaging=500)
        sed = m.add_peeled_images(sed=True, image=False)
        sed.set_viewing_angles([45.0], [0.0])
        sed.set_wavelength_range(10, 0.3, 1000.0)
        run = run_lucy_model(m, device='cpu', batch_size=256)
        assert run.result.energy_current == 500.0
        assert run.imaging.energy_current == 500.0
        bad = sorted(k for k in sys.modules
                     if k.split('.')[0] in ('jax', 'hyperion_tpu'))
        assert not bad, bad
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 40


def _imports_of(path):
    """The absolute module names that a source file imports."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_source_of_the_port_imports_hyperion_tpu():
    files = sorted((REPO / 'hyperion_tpu_torch').rglob('*.py')) + \
        [REPO / 'chip_smoke.py']
    assert len(files) > 40
    # the JAX-free host modules are among them
    names = {str(p.relative_to(REPO)) for p in files}
    assert {'hyperion_tpu_torch/importers/sph.py',
            'hyperion_tpu_torch/importers/orion.py',
            'hyperion_tpu_torch/importers/__init__.py',
            'hyperion_tpu_torch/native/__init__.py'} <= names
    for path in files:
        for name in _imports_of(path):
            assert name.split('.')[0] not in ('jax', 'hyperion_tpu'), \
                (path, name)
