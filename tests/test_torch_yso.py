"""The YSO slice as a whole: tests/test_self_regression.py's
spherical_mrw_pda model (a thick shell on a spherical-polar grid around a
spherical star, MRW and PDA), cut to run in seconds, with spectrum bins,
built by each package's front end and run through its run_model. The cuts:
density 3e-15 -> 1e-15 g/cm^3 (the tail of the diffusion sets the step
count), MRW gamma 2 -> 1 (so that the thinner shell still triggers it),
150 photons (so that the PDA finds starved cells) and B = 512. The files
have the same dataset tree; energy_current is the photon count and nothing
is killed in either; temperatures agree statistically (JAX against the
port within 1.5 times what two port seeds give); the spectrum bins add up
to the specific energy."""

import h5py
import numpy as np
import pytest
import torch

import hyperion_tpu.transport as j_transport
from hyperion_tpu.model.run import run_model as j_run_model
from hyperion_tpu_torch.model.run import run_model
from test_torch_frontend import frontend, lte_dust
from test_torch_run_model import _layout

torch.set_num_threads(1)
N_PHOTONS = 150
EDGES = np.logspace(9, 18, 7)


def spherical_mrw_pda(package, seed=-777):
    """tests/test_self_regression.py:model_spherical_mrw_pda, cut (see the
    module's docstring), with spectrum bins."""
    F = frontend(package)
    m = F.Model()
    rw = np.hstack([0., np.logspace(np.log10(0.1 * F.au),
                                    np.log10(20 * F.au), 24)])
    m.set_spherical_polar_grid(rw, np.linspace(0., np.pi, 9),
                               np.array([0., 2 * np.pi]))
    rho = np.zeros((1, 8, 24))
    rho[:, :, 4:] = 1e-15
    m.add_density_grid(rho, lte_dust(package))
    s = m.add_spherical_source()
    s.luminosity = F.lsun
    s.radius = 0.05 * F.au
    s.temperature = 4000.
    m.set_n_photons(initial=N_PHOTONS, imaging=0)
    m.set_n_initial_iterations(2)
    m.set_mrw(True, gamma=1.0)
    m.set_pda(True)
    m.set_specific_energy_spectrum_bins(EDGES)
    m.conf.output.output_specific_energy_spectrum = 'last'
    m.conf.output.output_n_photons = 'last'
    m.set_seed(seed)
    return m


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX package's run (its run_lucy result kept) and two port runs
    with different seeds."""
    tmp = tmp_path_factory.mktemp('yso')
    results = []
    run_lucy = j_transport.run_lucy

    def keep(*args, **kw):
        results.append(run_lucy(*args, **kw))
        return results[-1]

    def model(package, name, seed=-777):
        m = spherical_mrw_pda(package, seed)
        m.write(str(tmp / (name + '.rtin')))
        return m, str(tmp / (name + '.rtout'))

    j_transport.run_lucy = keep
    try:
        j_run_model(*model('jax', 'jax'), batch_size=512)
    finally:
        j_transport.run_lucy = run_lucy
    port = [run_model(*model('port', name, seed), device='cpu',
                      batch_size=512)
            for seed, name in ((-777, 'port'), (-999, 'port2'))]
    return tmp, results[0], port


def test_rtout_tree_and_counts_match_jax(runs):
    tmp, ref, port = runs
    jax_layout = _layout(tmp / 'jax.rtout')
    assert 'iteration_00002/specific_energy_spectrum' in jax_layout
    assert _layout(tmp / 'port.rtout') == jax_layout
    for run in port:
        assert run.result.energy_current == ref.energy_current == N_PHOTONS
        assert (run.result.killed_int, run.result.killed_geo) == (0, 0)
    assert (ref.killed_int, ref.killed_geo) == (0, 0)


def test_temperatures_agree_with_jax(runs):
    tmp, _, port = runs

    def temperature(name):
        grid = frontend('jax').ModelOutput(str(tmp / name)).get_quantities()
        return np.asarray(grid['temperature'][0].array)

    t_jax, t_port, t_port2 = (temperature(n) for n in
                              ('jax.rtout', 'port.rtout', 'port2.rtout'))
    dusty = port[0].density0[0].reshape(t_jax.shape) > 0
    assert np.isfinite(t_port).all() and (t_port[dusty] > 1.0).all()

    def rms_rel(a, b):
        return np.sqrt(np.mean((a[dusty] / b[dusty] - 1.0) ** 2))

    noise = rms_rel(t_port, t_port2)
    assert noise > 0
    assert rms_rel(t_port, t_jax) <= 1.5 * noise


def test_spectrum_bins_sum_to_specific_energy(runs):
    """Where neither the PDA nor the energy range changed a cell, the bins
    (frequency-binned path deposits and the MRW deposits spread by the
    local emissivity) add up to its specific energy."""
    tmp, _, port = runs
    with h5py.File(tmp / 'port.rtout', 'r') as f:
        g = f['iteration_00002']
        spec = g['specific_energy_spectrum'][()]
        se = g['specific_energy'][()]
        n_photons = g['n_photons'][()]
        np.testing.assert_array_equal(
            g['specific_energy_spectrum_bin_edges'][()], EDGES)
    assert spec.shape == (1, len(EDGES) - 1) + se.shape[1:]
    sampled = (n_photons >= 30) & (se[0] > 1.001 * se[0].min())
    assert sampled.sum() > 50
    np.testing.assert_allclose(spec.sum(axis=1)[0][sampled],
                               se[0][sampled], rtol=1e-9)
    assert (spec.sum(axis=(0, 2, 3, 4)) > 0).sum() >= 2
