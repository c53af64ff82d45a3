"""The port's gated bodies (``engine.run_if``): the JAX step's two
``lax.cond``s, the refill and the Lucy step's MRW move, which on the card
are IF conditional nodes of the iteration's CUDA graph, skipped where the
gate is false, and elsewhere run masked by the gate. A skipped body must
leave everything as the masked one does:

- a refill called mid-iteration with its gate false changes no tensor of
  the carry, for the Lucy step (re-absorption on and off), the imaging
  step (forced first interaction and peels on) and the monochromatic
  step;
- an iteration whose bodies are skipped where their gates are false (as
  a conditional node skips them) equals the step loop that runs them
  masked, bit for bit, with its generator left in the same state: on
  class2 at 24 x 8 cells (MRW, where some steps jump and some do not, and
  a re-absorbing star), the tutorial, the imaging iteration of each
  (class2's capped at 60 steps) and a monochromatic pass;
- on the CPU ``run_if`` runs its body and calls no CUDA API.

The cuda-marked test at the end captures a gated body on the card and
shows that a replay runs it only where its gate holds."""

import pytest
import torch

from hyperion_tpu_torch.transport import engine
from test_torch_imaging_graph import class2 as class2_imaging
from test_torch_imaging_graph import mono_pass, start
from test_torch_imaging_graph import tutorial as tutorial_imaging
from test_torch_step_graph import CONFIG, GEN, class2, tutorial

torch.set_num_threads(1)
# the fewest steps run before the refill is called with its gate false
MID = 6


def lucy_run(args, kw):
    """A Lucy iteration's (carry, step, max_steps) from its arguments."""
    args = list(args)
    carry, step = engine.start_lucy_iteration(*args[:GEN], *args[GEN + 1:],
                                              **kw)
    return carry, step, int(args[CONFIG]['max_steps'])


def finish_lucy(carry, n):
    return engine.finish_lucy_iteration(carry, n)


# {name: (the recorded arguments, the kind, (carry, step, max_steps) of
# the arguments, the result of a finished carry)}
MODELS = {
    'lucy_class2': (class2, 'lucy', lucy_run, finish_lucy),
    'lucy_tutorial': (tutorial, 'lucy', lucy_run, finish_lucy),
    'imaging_tutorial': (tutorial_imaging, 'imaging',
                         lambda a, k: start('imaging', a, k),
                         lambda c, n: c),
    'imaging_class2': (lambda: class2_imaging(max_steps=60), 'imaging',
                       lambda a, k: start('imaging', a, k),
                       lambda c, n: c),
    'mono_source': (lambda: mono_pass('source'), 'mono',
                    lambda a, k: start('mono', a, k), lambda c, n: c),
}


@pytest.fixture(scope='module')
def recorded():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = MODELS[name][0]()
        return cache[name]
    return get


def tensors(carry):
    """{path: a copy} of every tensor that a carry holds: lanes, counters,
    the deposit and visit tables, the peel cubes."""
    out, seen = {}, set()

    def walk(path, value):
        if isinstance(value, torch.Tensor):
            out[path] = value.clone()
        elif isinstance(value, (list, tuple)):
            for i, item in enumerate(value):
                walk('%s[%d]' % (path, i), item)
        elif hasattr(value, '__dict__') and id(value) not in seen:
            seen.add(id(value))
            for name, item in vars(value).items():
                walk('%s.%s' % (path, name), item)

    walk('carry', carry)
    return out


def assert_same(a, b):
    assert a.keys() == b.keys()
    for path in a:
        assert a[path].dtype == b[path].dtype and \
            torch.equal(a[path], b[path]), path


@pytest.mark.parametrize('model', ['lucy_class2', 'lucy_tutorial',
                                   'imaging_tutorial', 'mono_source'])
def test_refill_with_its_gate_false_changes_nothing(recorded, model):
    args, kw = recorded(model)
    _, kind, make, _ = MODELS[model]
    if kind == 'lucy':
        # class2's star re-absorbs photons, the tutorial's point does not
        assert args[CONFIG]['source_intersect'] == (model == 'lucy_class2')
    elif kind == 'imaging':
        assert kw['forced_first_interaction']
    args = list(args)
    gen = args[GEN] = torch.Generator().manual_seed(3)
    carry, step, _ = make(args, kw)
    p = carry.packets

    def mid():
        # live and dead lanes, and budget left
        return bool(p.alive.any()) and not bool(p.alive.all()) and \
            int(carry.budget) > 0

    n = 0
    while n < MID or not mid():
        step(carry, gen)
        n += 1
        assert n < 500, 'no step mid-iteration'
    if model == 'lucy_class2':
        # a dead lane's photon waits for the star to re-emit it, as one
        # re-absorbed there does
        lane = int((~p.alive).nonzero()[0, 0])
        p.reemit_src[lane] = 0
        carry.n_pending.fill_(1)
    before = tensors(carry)
    u = step.draw(carry, gen)
    step.refill(carry, u, torch.zeros((), dtype=torch.bool))
    assert_same(tensors(carry), before)


def skip_where_false(gate, body):
    """What a conditional node does: the body runs only where the gate
    holds."""
    if bool(gate):
        body()


@pytest.mark.parametrize('model', list(MODELS))
def test_skipped_bodies_equal_the_masked_ones(recorded, model,
                                              monkeypatch):
    args, kw = recorded(model)
    _, kind, make, finish = MODELS[model]
    runs = []
    for skip in (False, True):
        if skip:
            monkeypatch.setattr(engine, 'run_if', skip_where_false)
        args = list(args)
        gen = args[GEN] = torch.Generator().manual_seed(5)
        carry, step, max_steps = make(args, kw)
        _, n = engine.drive_steps(carry, step, gen, max_steps)
        bodies = [int(getattr(carry, name)) for name in
                  ('refills', 'mrw_moves') if hasattr(carry, name)]
        state = tensors(carry)
        finish(carry, n)
        runs.append((n, bodies, state, gen.get_state()))
    (n0, b0, s0, g0), (n1, b1, s1, g1) = runs
    # the masked run ran each body every step (the Lucy step's MRW move
    # where it has one); the other skipped some refills
    mrw = kind == 'lucy' and kw.get('mrw') is not None
    assert n0 == n1 > MID
    assert b0 == [n0] + ([n0 if mrw else 0] if kind == 'lucy' else [])
    assert b1[0] < n0
    for name in ('refills', 'mrw_moves'):
        s0.pop('carry.' + name, None)
        s1.pop('carry.' + name, None)
    assert_same(s1, s0)
    assert torch.equal(g0, g1)
    if model == 'lucy_class2':
        # some steps jumped and some did not
        assert 0 < b1[1] < n0


def test_run_if_on_the_cpu_runs_its_body_without_cuda(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError('a CUDA API was called')

    for name in ('is_available', 'is_current_stream_capturing',
                 'current_stream', 'current_device', 'Stream',
                 'ExternalStream', 'synchronize'):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    monkeypatch.setattr(engine, 'if_node', no_cuda)
    monkeypatch.setattr(engine, '_cond_lib', no_cuda)
    ran = []
    for value in (True, False):
        engine.run_if(torch.tensor(value), lambda: ran.append(value))
    assert ran == [True, False]


@pytest.mark.cuda
def test_a_captured_body_runs_only_where_its_gate_holds():
    """On the card: a body captured by run_if into a CUDA graph of 3 steps
    (each a gated body that allocates and adds into a tensor made before
    it) runs in a replay only where its gate holds; eagerly it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: conditional nodes run only there")
    dev = torch.device('cuda')
    gate = torch.zeros((), dtype=torch.bool, device=dev)
    ran = torch.zeros((), dtype=torch.int64, device=dev)
    x = torch.zeros(100_000, device=dev)

    def step(carry, generator):
        def body():
            x.add_(torch.ones_like(x))
            ran.add_(1)
        engine.run_if(gate, body)

    step.counts = dict(engine.step_counts)
    engine.reset_step_counts()
    step(None, None)
    gen = torch.Generator(device=dev)
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        graph = engine.capture_steps(None, step, gen, 3)
    main.wait_stream(side)
    assert engine.cond_nodes == 3
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    assert int(ran) == 1 and bool((x == 1).all())
    gate.fill_(True)
    graph.replay()
    torch.cuda.synchronize()
    assert int(ran) == 4 and bool((x == 4).all())
