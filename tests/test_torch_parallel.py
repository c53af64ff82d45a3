"""The port's photon-parallel runs (hyperion_tpu_torch/parallel/mesh.py and
launch.py) on gloo ranks on the CPU, against the JAX package's runs over
a mesh of as many CPU devices and against the port's own single-device
runs:

- ``share`` is the JAX package's split of a pass's photons;
- a world-2 Lucy iteration on tests/test_parallel.py's setup (11^3
  cartesian cells, tau ~ 0.2 a cell, a point source) is, to the bit, the
  sum of two single-device iterations with the ranks' generators and
  shares (two float64 terms add exactly), and agrees within Monte-Carlo
  noise with the JAX package's run_lucy_iteration_sharded on two devices
  (tests/test_parallel_spatial.py's bounds);
- the whole slice: Model.run(n_processes=2) of a small .rtin with a
  peeled group against the JAX package's Model.run(n_processes=2);
- parallel=1 and parallel=True on the CPU are the single-device run;
- a rank that raises makes the launcher raise at once, naming it.

The ranks import this module, so JAX and hyperion_tpu are imported inside
the tests only."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from hyperion_tpu_torch.convert import tables_from_numpy
from hyperion_tpu_torch.model import ModelOutput
from hyperion_tpu_torch.model.run import run_lucy_model, run_model
from hyperion_tpu_torch.parallel import mesh
from hyperion_tpu_torch.parallel.launch import RankFailed, launch
from hyperion_tpu_torch.transport.engine import run_lucy_iteration
from hyperion_tpu_torch.transport.lucy import compute_jnu_var
from test_torch_frontend import frontend, tutorial_model

torch.set_num_threads(1)
CPU, F64 = torch.device('cpu'), torch.float64
GLOO2 = mesh.Group(world=2, backend='gloo', device_type='cpu')
# tests/test_parallel.py's configuration, photons and batch
CONFIG = dict(n_inter_max=1000, kill_on_scatter=False, kill_on_absorb=False,
              max_steps=100000)
N_PHOTONS, BATCH, SEED = 20000, 1024, 5


def test_share_equals_jax_split():
    """The JAX package's split (parallel/mesh.py:59-60, evaluated in a
    shard_map over 1-8 CPU devices): n // world, the remainder on rank 0."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from hyperion_tpu.parallel import make_mesh

    ns = np.array([0, 1, 7, 8, 9, 20000, 20001, 123457, 2 ** 31 - 2])
    for world in range(1, 9):
        def per_device(n):
            idx = jax.lax.axis_index('dp')
            return (n // world + jnp.where(idx == 0, n % world, 0))[None]

        split = jax.jit(jax.shard_map(
            per_device, mesh=make_mesh(jax.devices()[:world]),
            in_specs=P(), out_specs=P('dp'), check_vma=False))
        ref = np.asarray(split(jnp.asarray(ns))).reshape(world, -1)
        ours = np.array([[mesh.share(int(n), r, world) for n in ns]
                         for r in range(world)])
        np.testing.assert_array_equal(ours, ref)
        assert ours.sum(axis=0).tolist() == ns.tolist()


def _numpy_fields(obj):
    items = obj._asdict().items() if hasattr(obj, '_asdict') else \
        ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return {k: np.asarray(v) for k, v in items}


def _lucy_tables():
    """tests/test_parallel.py:setup() as the JAX tables and the port's."""
    import test_parallel as J
    _, jg, jt, js, jrho = J.setup()
    dt, st, geometry = tables_from_numpy(_numpy_fields(jt), _numpy_fields(js),
                                         _numpy_fields(jg), CPU, F64)
    density = torch.tensor(np.asarray(jrho))
    jid, jfrac = compute_jnu_var(dt, torch.zeros_like(density))
    return (jg, jt, js, jrho), (geometry, dt, st, density, jid, jfrac)


def sharded_iteration(tables, n_photons, batch, config, seed):
    """Rank side: run_lucy_iteration_sharded with the rank's generator."""
    group = mesh.active_group()
    gen = mesh.rank_generator(seed, mesh.STREAM_LUCY, CPU, group)
    out = mesh.run_lucy_iteration_sharded(group, *tables, gen, n_photons,
                                          batch, config)
    return [np.asarray(o) if torch.is_tensor(o) else o for o in out]


@pytest.fixture(scope='module')
def lucy_world2():
    jax_tables, tables = _lucy_tables()
    out = launch(GLOO2, 'test_torch_parallel:sharded_iteration',
                 (tables, N_PHOTONS, BATCH, CONFIG, SEED))
    return jax_tables, tables, out


def test_world2_is_the_sum_of_the_ranks(lucy_world2):
    """Every summed output equals the sum of the two ranks' single-device
    iterations (their generators, seed + rank, and shares) to the bit; the
    step count is their maximum."""
    _, tables, out = lucy_world2
    parts = [run_lucy_iteration(
        *tables, mesh.rank_generator(SEED, mesh.STREAM_LUCY, CPU,
                                     mesh.Group(2, 'gloo', 'cpu', rank=r)),
        mesh.share(N_PHOTONS, r, 2), BATCH, CONFIG) for r in range(2)]
    assert all(p[5] > 0 for p in parts)
    for i, name in enumerate(('energy_sum', 'energy_current',
                              'n_photons_cell', 'killed_int', 'killed_geo',
                              'n_steps', 'energy_sum_spec', 'n_events')):
        a, b = (np.asarray(p[i]) for p in parts)
        want = max(a, b) if name == 'n_steps' else a + b
        np.testing.assert_array_equal(out[i], want, err_msg=name)
    assert out[1] == N_PHOTONS


def test_world2_agrees_with_jax_sharded(lucy_world2):
    """Within Monte-Carlo noise of the JAX package's
    run_lucy_iteration_sharded on two devices: every photon emitted,
    nothing killed, the total deposit within 2% and the median per-cell
    ratio above the 60th percentile within 5%."""
    import jax
    from hyperion_tpu.parallel import make_mesh, run_lucy_iteration_sharded
    from hyperion_tpu.transport.lucy import compute_jnu_var as j_jnu
    import jax.numpy as jnp
    (jg, jt, js, jrho), _, out = lucy_world2
    energy_sum, energy_current, _, killed_int, killed_geo = out[:5]
    assert energy_current == N_PHOTONS
    assert killed_int == 0 and killed_geo == 0
    jid, jfrac = j_jnu(jt, jnp.zeros_like(jrho))
    ref = run_lucy_iteration_sharded(
        make_mesh(jax.devices()[:2]), jg, jt, js, jrho, jid, jfrac,
        jax.random.PRNGKey(SEED), N_PHOTONS, BATCH,
        tuple(CONFIG.items()))
    es_ref = np.asarray(ref[0])
    assert float(ref[1]) == N_PHOTONS
    assert abs(energy_sum.sum() / es_ref.sum() - 1.0) < 0.02
    sel = es_ref > np.percentile(es_ref, 60)
    assert abs(np.median(energy_sum[sel] / es_ref[sel]) - 1.0) < 0.05


def _slice_model(package):
    """examples/quickstart.py at 8^3 cells, 2 Lucy iterations of 4,000
    photons and 8,000 imaging photons into its peeled SED and 8 x 8
    image."""
    return tutorial_model(package, n=8, n_photons=4000, iterations=2,
                          seed=-31, peeled=True, n_imaging=8000,
                          image_size=8)


def test_model_run_two_processes_against_jax(tmp_path):
    """The whole slice: Model.run(n_processes=2) on the CPU against the JAX
    package's Model.run(n_processes=2) (a 2-device mesh) of the same .rtin:
    every photon emitted and none killed, the median cell-temperature ratio
    within 2%, the peeled band luminosity within 3%; the port's .rtout
    reads in both packages' ModelOutput."""
    J = frontend('jax')
    runs = {}
    for package in ('jax', 'port'):
        m = _slice_model(package)
        m.write(str(tmp_path / ('%s.rtin' % package)))
        kw = dict(device='cpu') if package == 'port' else {}
        runs[package] = m.run(str(tmp_path / ('%s.rtout' % package)),
                              n_processes=2, batch_size=1024, **kw)
    path = str(tmp_path / 'port.rtout')
    import h5py
    with h5py.File(path, 'r') as f:
        assert f.attrs['iterations'] == 2
        for g in ('iteration_00001', 'iteration_00002'):
            assert f[g].attrs['killed_photons_int'] == 0
            assert f[g].attrs['killed_photons_geo'] == 0
        assert f.attrs['killed_photons_int_final'] == 0

    def temperature(out):
        return np.asarray(out.get_quantities()['temperature'][0].array)

    t_port, t_jax = temperature(runs['port']), temperature(runs['jax'])
    assert np.isfinite(t_port).all() and (t_port > 0).all()
    assert abs(np.median(t_port / t_jax) - 1.0) < 0.02

    def band(out):
        sed = out.get_sed(inclination=0, aperture=-1)
        return np.sum(sed.val) * abs(np.log(sed.nu[0] / sed.nu[-1])) / \
            (len(sed.nu) - 1)

    assert np.isfinite(band(runs['port'])) and band(runs['port']) > 0
    assert abs(band(runs['port']) / band(runs['jax']) - 1.0) < 0.03
    # the port's file in the JAX package's reader
    assert band(J.ModelOutput(path)) == band(runs['port'])


@pytest.mark.parametrize('parallel', [1, True])
def test_one_rank_is_the_single_device_run(parallel):
    """parallel=1, and parallel=True on the CPU (one rank), run the
    single-device code: the same bits as the default."""
    m = tutorial_model('port', n=6, n_photons=3000, iterations=1, seed=-2,
                       peeled=True, n_imaging=2000, image_size=4)
    a = run_lucy_model(m, device='cpu', batch_size=512)
    b = run_lucy_model(m, device='cpu', batch_size=512, parallel=parallel)
    np.testing.assert_array_equal(a.result.specific_energy,
                                  b.result.specific_energy)
    for name in ('seds', 'images'):
        np.testing.assert_array_equal(
            a.imaging.peeled[0]['datasets'][name][0],
            b.imaging.peeled[0]['datasets'][name][0])


def raise_on_rank(bad):
    """Rank side: ``bad`` raises, the others wait in a collective."""
    group = mesh.active_group()
    if group.rank == bad:
        raise ValueError('rank %d gives up' % bad)
    mesh.reduce_ints(group, [1])


def test_failing_rank_raises_at_once():
    """A rank that raises makes the launcher kill the others (waiting in a
    collective) and raise within seconds, naming the rank and giving its
    traceback."""
    t0 = time.time()
    with pytest.raises(RankFailed, match='rank 1 of 2 failed') as info:
        launch(GLOO2, 'test_torch_parallel:raise_on_rank', (1,))
    assert time.time() - t0 < 30.0
    assert 'rank 1 gives up' in str(info.value)
    assert 'Traceback' in str(info.value)


def test_run_model_writes_only_on_rank_zero(tmp_path):
    """run_model with parallel=2 writes the .rtout once, from rank 0, and
    returns rank 0's ModelRun."""
    m = tutorial_model('port', n=6, n_photons=3000, iterations=1, seed=-3)
    m.write(str(tmp_path / 'p.rtin'))
    run = run_model(m, str(tmp_path / 'p.rtout'), device='cpu',
                    batch_size=512, parallel=2)
    assert run.result.energy_current == 3000.0
    assert sorted(p.name for p in tmp_path.iterdir()) == ['p.rtin',
                                                          'p.rtout']
    t = ModelOutput(str(tmp_path / 'p.rtout')).get_quantities()
    assert (np.asarray(t['temperature'][0].array) > 0).all()
