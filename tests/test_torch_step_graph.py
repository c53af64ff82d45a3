"""The port's Lucy iteration driven in blocks of K steps, the host reading
the counters once a block (``engine.drive_blocks``, which on the card
replays a CUDA graph of K steps), against the step-at-a-time loop that the
CPU runs (``engine.run_lucy_iteration``): on three small models the same
energy sums, visit counts, energy_current, killed counts, working steps
and events, bit for bit, and the generator left where the per-step loop
leaves it (the steps of a block after the iteration's end are no-ops whose
uniforms are given back). The models: the tutorial at 8^3 cells; class2 at
24 x 8 cells with MRW, its re-absorbing star and spectrum bins; and class2
cut at a step cap that kills lanes still alive. Each model's first Lucy
iteration takes the arguments that run_lucy_model gives it. The card's
graph against its eager loop is the cuda-marked test at the end (and
chip_smoke.py's phases 4, 8, 14 and 16-18 at full size)."""

import numpy as np
import pytest
import torch

from hyperion_tpu_torch.model.run import run_lucy_model
from hyperion_tpu_torch.transport import engine, lucy
from test_torch_frontend import class2_model, tutorial_model

torch.set_num_threads(1)
EDGES = np.logspace(9, 18, 7)
# run_lucy_iteration's positional arguments: the generator's and config's
GEN, CONFIG = 6, 9
NAMES = ('energy_sum', 'energy_current', 'n_photons_cell', 'killed_int',
         'killed_geo', 'n_steps', 'energy_sum_spec', 'n_events')


class _Recorded(Exception):
    pass


def first_iteration(model, device='cpu', batch_size=None):
    """The arguments of the model's first Lucy iteration as run_lucy_model
    gives them (the run stops there): (args, kwargs)."""
    rec = {}

    def record(*args, **kw):
        rec.update(args=list(args), kw=kw)
        raise _Recorded

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lucy, 'run_lucy_iteration', record)
        with pytest.raises(_Recorded):
            run_lucy_model(model, device=device, batch_size=batch_size)
    return rec['args'], rec['kw']


def tutorial():
    return first_iteration(tutorial_model('port', n=8, n_photons=2000,
                                          iterations=1), batch_size=256)


def yso(m):
    """An AnalyticalYSOModel evaluated to a Model."""
    m.evaluate_optically_thin_radii()
    return m.to_model()


def class2(max_steps=None):
    m = class2_model('port', 24, 8, n_photons=200)
    m.set_specific_energy_spectrum_bins(EDGES)
    args, kw = first_iteration(yso(m), batch_size=64)
    if max_steps is not None:
        args[CONFIG] = dict(args[CONFIG], max_steps=max_steps)
    return args, kw


MODELS = {'tutorial': tutorial, 'class2': class2,
          'class2_capped': lambda: class2(max_steps=45)}


def run(args, kw, k=None, seed=3):
    """The iteration from a generator seeded ``seed``: step at a time
    (k None) or in blocks of k eager steps. Returns (outputs, the
    generator's state after)."""
    args = list(args)
    gen = args[GEN] = torch.Generator().manual_seed(seed)
    if k is None:
        out = engine.run_lucy_iteration(*args, **kw)
    else:
        carry, step = engine.start_lucy_iteration(
            *args[:GEN], *args[GEN + 1:], **kw)

        def block():
            for _ in range(k):
                step(carry, gen)

        _, n_steps = engine.drive_blocks(
            carry, step, gen, int(args[CONFIG]['max_steps']), k, block)
        out = engine.finish_lucy_iteration(carry, n_steps)
    return out, gen.get_state()


@pytest.fixture(scope='module')
def per_step():
    """Each model's arguments and its step-at-a-time run."""
    cache = {}

    def get(name):
        if name not in cache:
            args, kw = MODELS[name]()
            cache[name] = (args, kw, run(args, kw))
        return cache[name]
    return get


@pytest.mark.parametrize('k', [1, 7, 32])
@pytest.mark.parametrize('model', list(MODELS))
def test_blocks_of_k_steps_equal_the_step_loop(per_step, model, k):
    args, kw, (ref, ref_gen) = per_step(model)
    out, gen = run(args, kw, k)
    for name, a, b in zip(NAMES, out, ref):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert type(a) is int and a == b, name
    assert torch.equal(gen, ref_gen)
    n_steps, killed = ref[5], int(ref[3])
    assert n_steps > 0 and int(ref[7]) > 0
    if model == 'class2_capped':
        # lanes alive at the cap were killed there
        assert n_steps == 45 and killed > 0
    else:
        assert n_steps < int(args[CONFIG]['max_steps']) and killed == 0
        assert float(ref[1]) == args[7]
    if model != 'tutorial':
        assert ref[6].shape[1] == len(EDGES) - 1 and ref[6].sum() > 0


def test_step_after_the_end_changes_nothing(per_step):
    """A step with nothing alive, no budget and nothing waiting leaves
    every lane, table and counter as it was (it draws its uniforms)."""
    args, kw, _ = per_step('class2')
    args = list(args)
    gen = args[GEN] = torch.Generator().manual_seed(3)
    carry, step = engine.start_lucy_iteration(*args[:GEN], *args[GEN + 1:],
                                              **kw)
    live, n = engine.drive_steps(carry, step, gen, 10 ** 6)
    assert not live and n > 0

    def snapshot():
        p = carry.packets
        return [t.clone() for t in (
            *(getattr(p, f) for f in p.__dataclass_fields__),
            carry.budget, carry.uid_counter, carry.n_alive, carry.n_pending,
            carry.n_steps, carry.energy_current, carry.stats.energy_sum,
            carry.stats.n_photons_cell, carry.stats.last_uid,
            carry.energy_sum_spec, carry.killed_int, carry.killed_geo,
            carry.n_events)]

    before = snapshot()
    for _ in range(3):
        step(carry, gen)
    assert all(torch.equal(a, b) for a, b in zip(snapshot(), before))


@pytest.mark.cuda
def test_graph_iteration_equals_eager_on_the_card():
    """On the card: run_lucy_iteration (replays of a CUDA graph) against
    the eager step loop on the same generator seed, for the tutorial at
    8^3 and class2 with a step cap: counts, steps and killed equal, the
    generators left in the same state, the float32 energies (float
    atomics) within rtol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph runs only there")
    for args, kw in (
            first_iteration(tutorial_model('port', n=8, n_photons=20000,
                                           iterations=1),
                            device='cuda', batch_size=2048),
            first_iteration(yso(class2_model('port', 24, 8,
                                             n_photons=2000)),
                            device='cuda', batch_size=512)):
        args[CONFIG] = dict(args[CONFIG], max_steps=300)
        outs, states = [], []
        for graph in (False, True):
            args[GEN] = torch.Generator(device='cuda').manual_seed(5)
            if graph:
                out = engine.run_lucy_iteration(*args, **kw)
            else:
                carry, step = engine.start_lucy_iteration(
                    *args[:GEN], *args[GEN + 1:], **kw)
                _, n = engine.drive_steps(carry, step, args[GEN], 300)
                out = engine.finish_lucy_iteration(carry, n)
            outs.append(out)
            states.append(args[GEN].get_state())
        (e0, c0, n0, k0, g0, s0, _, v0), (e1, c1, n1, k1, g1, s1, _, v1) = \
            outs
        assert s0 == s1 and torch.equal(n0, n1) and int(k0) == int(k1)
        assert int(g0) == int(g1) and int(v0) == int(v1)
        assert float(c0) == float(c1) and torch.equal(*states)
        torch.testing.assert_close(e1, e0, rtol=1e-4, atol=0.0)
