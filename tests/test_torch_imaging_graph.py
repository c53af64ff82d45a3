"""The port's imaging iteration and monochromatic passes driven in blocks
of K steps, the host reading the counters once a block
(``engine.drive_blocks``, which on the card replays a CUDA graph of K
steps), against the step-at-a-time loop that the CPU runs
(``imaging.run_final``, ``mono.run_mono_pass``): bit for bit the same
peeled cubes (sums, squares and counts), binned cube, energy_current,
killed count, working steps and events, and the generator left where the
per-step loop leaves it (the steps of a block after the iteration's end
are no-ops whose uniforms are given back). The models: the tutorial at
8^3 cells with a peeled group, binned images and forced first
interaction; class2 at 24 x 8 cells with MRW, its re-absorbing star and a
polarized group, whole and cut at a step cap that kills live lanes; and
one monochromatic pass of each mode (tests/test_torch_mono.py's 12^3
model). Each iteration takes the arguments that run_lucy_model gives it.
A step after the end changes nothing. The card's graph against its eager
loop is the cuda-marked test at the end (and chip_smoke.py's imaging and
monochromatic witnesses at full size)."""

import numpy as np
import pytest
import torch

from hyperion_tpu_torch.model.run import run_lucy_model
from hyperion_tpu_torch.transport import engine, imaging, mono
from hyperion_tpu_torch.util.constants import au
from test_torch_frontend import class2_model, tutorial_model

torch.set_num_threads(1)
# run_final's and run_mono_pass's generator argument
GEN = 6
CUBES = ('sed', 'sed2', 'sedn', 'img', 'img2', 'imgn')


class _Recorded(Exception):
    pass


def recorded_call(module, name, model, batch_size, device='cpu',
                  want=lambda kw: True):
    """The arguments of the first call of ``module.name`` (run_final or
    run_mono_pass) whose keywords ``want`` accepts, as run_lucy_model makes
    it for ``model`` (the run stops there): (args, kwargs)."""
    rec = {}
    inner = getattr(module, name)

    def record(*args, **kw):
        if not want(kw):
            return inner(*args, **kw)
        rec.update(args=list(args), kw=dict(kw))
        raise _Recorded

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, record)
        with pytest.raises(_Recorded):
            run_lucy_model(model, device=device, batch_size=batch_size)
    return rec['args'], rec['kw']


def tutorial(device='cpu', n_imaging=3000, batch_size=512):
    """The tutorial at 8^3 cells, its peeled group (a 16 x 16 image and the
    SED) and binned images in 3 x 2 direction bins, forced first
    interaction, no Lucy iteration."""
    m = tutorial_model('port', n=8, n_photons=0, iterations=0, peeled=True,
                       n_imaging=n_imaging, image_size=16)
    b = m.add_binned_images(sed=True, image=True)
    b.set_viewing_bins(3, 2)
    b.set_image_size(8, 8)
    lim = 50 * au
    b.set_image_limits(-lim, lim, -lim, lim)
    b.set_wavelength_range(6, 0.3, 1000.0)
    b.set_aperture_radii(1, 2 * lim, 2 * lim)
    assert m.forced_first_interaction
    return recorded_call(imaging, 'run_final', m, batch_size, device)


def class2(max_steps=None, device='cpu', n_imaging=256, batch_size=64):
    """class2 at 24 x 8 cells from a given specific energy (a 300 K (r / 1
    au)^-0.5 profile, as tests/test_torch_imaging_mrw.py's), MRW, the
    re-absorbing star, its three views polarized and with uncertainties;
    ``max_steps`` caps the iteration."""
    m = class2_model('port', 24, 8, 0, peeled=True, n_imaging=n_imaging)
    m.peeled_output[0].set_uncertainties(True)
    m.peeled_output[0].set_stokes(True)
    m.set_n_initial_iterations(0)
    m.evaluate_optically_thin_radii()
    mm = m.to_model()
    g = mm.grid
    r = 0.5 * (g.r_wall[1:] + g.r_wall[:-1])
    temp = np.clip(300.0 * (r / au) ** -0.5, 10.0, 1500.0)
    temp = np.broadcast_to(temp[None, None, :], g.shape)
    g.quantities['specific_energy'] = [
        d.temperature2specific_energy(temp) for d in mm._dust_objects()]
    args, kw = recorded_call(imaging, 'run_final', mm, batch_size, device)
    if max_steps is not None:
        kw['max_steps'] = max_steps
    return args, kw


def mono_pass(mode):
    """One monochromatic pass (the first at its mode) of
    tests/test_torch_mono.py's 12^3 model."""
    from test_torch_mono import _mono_model     # imports JAX
    return recorded_call(mono, 'run_mono_pass', _mono_model('port'), 256,
                         want=lambda kw: kw['mode'] == mode)


MODELS = {'tutorial': tutorial, 'class2': class2,
          'class2_capped': lambda: class2(max_steps=25),
          'mono_source': lambda: mono_pass('source'),
          'mono_dust': lambda: mono_pass('dust')}
# each kind's (start, finish, run): start takes the run's arguments but the
# generator and max_steps
KINDS = {'imaging': (imaging.start_final, imaging.finish_final,
                     imaging.run_final),
         'mono': (mono.start_mono_pass, mono.finish_mono_pass,
                  mono.run_mono_pass)}


def kind_of(model):
    return 'mono' if model.startswith('mono') else 'imaging'


def outputs(kind, out):
    """(accums, binned accum or None, counts) of a run's result."""
    if kind == 'imaging':
        return out.accums, out.binned_acc, (
            out.energy_current, out.killed_int, out.n_steps, out.n_events)
    accums, killed, n_steps, n_events = out
    return accums, None, (killed, n_steps, n_events)


def start(kind, args, kw):
    """The carry and step of the run (arguments as recorded) and its
    max_steps."""
    kw = dict(kw)
    max_steps = kw.pop('max_steps', 100000000)
    carry, step = KINDS[kind][0](*args[:GEN], *args[GEN + 1:], **kw)
    return carry, step, max_steps


def run(kind, args, kw, k=None, seed=3):
    """The run from a generator seeded ``seed``: step at a time (k None,
    the CPU's ``run_final`` / ``run_mono_pass``) or in blocks of k eager
    steps. Returns (outputs, the generator's state after)."""
    args = list(args)
    gen = args[GEN] = torch.Generator().manual_seed(seed)
    if k is None:
        out = KINDS[kind][2](*args, **kw)
    else:
        carry, step, max_steps = start(kind, args, kw)

        def block():
            for _ in range(k):
                step(carry, gen)

        _, n_steps = engine.drive_blocks(carry, step, gen, max_steps, k,
                                         block)
        out = KINDS[kind][1](carry, n_steps)
    return outputs(kind, out), gen.get_state()


@pytest.fixture(scope='module')
def per_step():
    """Each model's arguments and its step-at-a-time run."""
    cache = {}

    def get(name):
        if name not in cache:
            args, kw = MODELS[name]()
            cache[name] = (args, kw, run(kind_of(name), args, kw))
        return cache[name]
    return get


def assert_accums_equal(a, b):
    for name in CUBES:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize('k', [4, 5])
@pytest.mark.parametrize('model', list(MODELS))
def test_blocks_of_k_steps_equal_the_step_loop(per_step, model, k):
    args, kw, ((ref_acc, ref_bin, ref_counts), ref_gen) = per_step(model)
    kind = kind_of(model)
    (acc, binned, counts), gen = run(kind, args, kw, k)
    assert len(acc) == len(ref_acc)
    for a, b in zip(acc, ref_acc):
        assert_accums_equal(a, b)
    assert (binned is None) == (ref_bin is None)
    if binned is not None:
        assert_accums_equal(binned, ref_bin)
    assert all(type(a) is type(b) and a == b
               for a, b in zip(counts, ref_counts)), (counts, ref_counts)
    assert torch.equal(gen, ref_gen)

    # what the runs hold: light in every cube, lanes killed only at a cap
    n_steps, killed = counts[-2], counts[-3]
    assert n_steps > 0 and counts[-1] > 0
    assert all(float(a.sed.sum()) > 0 for a in ref_acc)
    if model == 'class2_capped':
        assert n_steps == 25 and killed > 0
    else:
        assert killed == 0
        if kind == 'imaging':
            assert counts[0] == args[7]
    if model == 'tutorial':
        assert float(ref_bin.img.sum()) > 0 and float(ref_bin.sed.sum()) > 0
    if model.startswith('class2'):
        # the polarized group's Q and U
        sed = ref_acc[0].cubes()['sed']
        assert sed.shape[-1] == 4 and bool((sed[..., 1:] != 0).any())


def _snapshot(carry):
    p = carry.packets
    out = [getattr(p, f).clone() for f in p.__dataclass_fields__]
    out += [getattr(carry, n).clone() for n in engine.COUNTERS]
    for name in ('energy_current', 'killed_int', 'n_events'):
        if hasattr(carry, name):
            out.append(getattr(carry, name).clone())
    accums = list(carry.accums)
    if getattr(carry, 'binned_acc', None) is not None:
        accums.append(carry.binned_acc)
    out += [getattr(a, n).clone() for a in accums for n in CUBES]
    return out


@pytest.mark.parametrize('model', ['tutorial', 'class2', 'mono_dust'])
def test_step_after_the_end_changes_nothing(per_step, model):
    """A step with nothing alive, no budget and nothing waiting leaves
    every lane, cube and counter as it was: no emission peel, no binned
    photon, nothing added to energy_current, killed_int or the events (it
    draws its uniforms)."""
    args, kw, _ = per_step(model)
    args = list(args)
    gen = args[GEN] = torch.Generator().manual_seed(3)
    carry, step, _ = start(kind_of(model), args, kw)
    live, n = engine.drive_steps(carry, step, gen, 10 ** 6)
    assert not live and n > 0
    before = _snapshot(carry)
    for _ in range(3):
        step(carry, gen)
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(carry), before))


def test_steps_count_in_their_own_iteration(per_step):
    """The drivers count an imaging or monochromatic step in its own
    iteration's counts, not in the Lucy iteration's."""
    engine.reset_step_counts()
    for model in ('tutorial', 'mono_source'):
        args, kw, _ = per_step(model)
        run(kind_of(model), args, kw)
    assert engine.step_counts['eager'] == engine.step_counts['reads'] == 0
    for counts in (engine.imaging_step_counts, engine.mono_step_counts):
        assert counts['eager'] > 0 and counts['reads'] == counts['eager'] + 1
        assert counts['replays'] == counts['captured'] == 0


@pytest.mark.cuda
def test_graph_iteration_equals_eager_on_the_card():
    """On the card: run_final (replays of a CUDA graph) against the eager
    step loop on the same generator seed, for the tutorial at 8^3 and
    class2 with a step cap: counts, steps, events and energy_current
    equal, the generator states equal, the float32 cubes (float atomics)
    within rtol 1e-4 (Q and U against the I cube)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph runs only there")
    for args, kw in (tutorial('cuda', n_imaging=40000, batch_size=4096),
                     class2(max_steps=300, device='cuda', n_imaging=4000,
                            batch_size=512)):
        outs = []
        for graph in (False, True):
            args[GEN] = torch.Generator(device='cuda').manual_seed(5)
            if graph:
                out = imaging.run_final(*args, **kw)
            else:
                carry, step, max_steps = start('imaging', args, kw)
                _, n = engine.drive_steps(carry, step, args[GEN], max_steps)
                out = imaging.finish_final(carry, n)
            outs.append((outputs('imaging', out), args[GEN].get_state()))
        ((a0, b0, c0), g0), ((a1, b1, c1), g1) = outs
        assert c0 == c1 and torch.equal(g0, g1)
        assert (b0 is None) == (b1 is None)
        pairs = list(zip(a1, a0)) + ([] if b0 is None else [(b1, b0)])
        for x, y in pairs:
            gc, rc = x.cubes(), y.cubes()
            for name in CUBES:
                assert stokes_rel_err(gc[name], rc[name]) <= 1e-4, name


def stokes_rel_err(got, ref):
    """max |got - ref| over the Stokes I of ref's bin (the last axis), 0
    where both are 0: a sum added in another order moves by ~eps times the
    sum of its terms' sizes, and |Q|, |U|, |V| <= I."""
    got, ref = got.double(), ref.double()
    i = ref[..., :1].abs()
    err = (got - ref).abs()
    if bool((err[(i == 0).expand_as(err)] > 0).any()):
        return float('inf')
    return float((err / i.clamp_min(1e-300)).max()) if err.numel() else 0.0
