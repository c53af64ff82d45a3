"""The escape-tau walk: the port's plain version against the JAX package's
``escape_tau_walk``, one view at a time, on the same seeded rays (JAX x64,
torch float64): a cartesian grid, a spherical-polar grid with theta and phi
walls, and a spherical grid whose innermost shells are thinner than the
float64 on-wall nudge; with and without a distance limit (an inside
observer's ``t_max``), a limited call with +inf for its unlimited views, two
dust types and a tenth of the lanes inactive. The walks take the same
crossings, so tau matches to rtol 1e-10. float32 lanes walk in float64.
On the card (marked ``cuda``: the kernel has no CPU mode), the kernel
against the plain version: both lane types and grids, the thin shells, a
call with no live ray and one with a single live ray among 50,000, rays
whose lengths differ 100-fold, and a CUDA graph of the call replayed on
new lanes; and the column mode against its plain version on the same
grids (thin shells too), sparse calls, six dust types (more than the
kernel keeps in registers) and a CUDA graph; and how the column mode
shares its rays out: more rays than the card has threads, the inner
shells' lanes first or in lane order (the same bits), a density in the
card's opt-in shared memory, and the blocks' clock. On the CPU, the
split of the column mode's sweeps. The column walk against the JAX
package's is in tests/test_torch_raytrace.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hyperion_tpu.transport import build_cartesian_geometry as j_cartesian
from hyperion_tpu.transport.gtable_spherical import \
    build_spherical_geometry as j_spherical
from hyperion_tpu.transport.imaging import escape_tau_walk
from hyperion_tpu_torch.transport import escape_tau as et
from hyperion_tpu_torch.transport.gtable import build_cartesian_geometry
from hyperion_tpu_torch.transport.gtable_spherical import \
    build_spherical_geometry
from test_torch_frontend import frontend
from test_torch_geometry import _grid as _cartesian_grid
from test_torch_geometry import _rays as _cartesian_rays
from test_torch_spherical import _grid as _spherical_grid
from test_torch_spherical import _rays as _spherical_rays

torch.set_num_threads(1)
CPU = torch.device('cpu')
RTOL = 1e-10
# the views of a call: the grid's own test rays, then seeded directions
N_VIEWS = 3


def _thin_grid(package):
    """A spherical-polar grid (n3 = 2) whose 11 innermost shells are 2e-15
    wide at r = 0.01: the float64 on-wall nudge t_eps (r + rw[1]) is 2e-14
    there and jumps about ten of them at once, as class2's innermost shells
    (~1e-7 of the radius) are jumped by the float32 nudge."""
    rw = np.hstack([0.01 + 2e-15 * np.arange(12),
                    np.geomspace(0.0102, 1.0, 10)])
    t = np.linspace(0.0, np.pi, 9)
    return frontend(package).SphericalPolarGrid(
        rw, t + np.sin(2.0 * t) / 6.0, np.linspace(0.0, 2.0 * np.pi, 2))


def _thin_rays(g, n, seed=53):
    """Rays around the thin shells: a third start in them, a third just
    outside aimed at or past them, a third anywhere in the grid."""
    rng = np.random.default_rng(seed)
    part = rng.integers(0, 3, n)
    r = np.where(part == 0, 0.01 + 2.2e-14 * rng.random(n),
                 np.where(part == 1, 0.01 * (1.0 + 0.05 * rng.random(n)),
                          rng.uniform(0.0102, 1.0, n)))
    mu = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    st = np.sqrt(1 - mu ** 2)
    pos = r * np.stack([st * np.cos(phi), st * np.sin(phi), mu])
    k = rng.normal(size=(3, n))
    # half of those just outside head straight in
    inward = (part == 1) & (rng.random(n) < 0.5)
    k[:, inward] = -pos[:, inward]
    k /= np.linalg.norm(k, axis=0)
    return pos, k


GRIDS = {
    'cartesian': (lambda pkg: _cartesian_grid(pkg), build_cartesian_geometry,
                  _cartesian_rays, j_cartesian),
    'spherical': (lambda pkg: _spherical_grid(pkg, 4, 0.0),
                  build_spherical_geometry, _spherical_rays, j_spherical),
    'thin_shells': (_thin_grid, build_spherical_geometry, _thin_rays,
                    j_spherical),
}


def _jax_geometry(kind):
    make, _, _, build = GRIDS[kind]
    return build(make('jax'), dtype=jnp.float64)


def _setup(kind, device=CPU, n=10000, n_views=N_VIEWS, seed=41,
           contrast=1e12):
    """(port geometry on ``device``, float64 as the walk takes it, positions
    (3, n), directions (3, V, n), cells, active mask, density (2, n_cells),
    chi rows (n, 2), t_max (V, n)). Made with the port alone (the card's
    machine has no h5py, which the JAX package's grids need): the rays from
    the float64 walls, the cells by the float64 find_cell of view 0's
    direction. The thin shells are ``contrast`` times denser than the
    rest, as a disk's inner rim is."""
    make, build, rays, _ = GRIDS[kind]
    grid = make('port')
    g64 = build(grid, CPU, torch.float64)
    pos, k0 = rays(g64, n=n)
    cell = g64.find_cell(*[torch.as_tensor(a) for a in pos],
                         *[torch.as_tensor(a) for a in k0]).numpy()
    pg = build(grid, device, torch.float64)
    rng = np.random.default_rng(seed)
    ks = [k0]
    for _ in range(n_views - 1):
        k = rng.normal(size=(3, n))
        ks.append(k / np.linalg.norm(k, axis=0))
    k = np.stack(ks, axis=1)
    # a ray aimed at its own position has no direction: it never escapes
    active = (cell >= 0) & (rng.random(n) < 0.9) & \
        (np.linalg.norm(k0, axis=0) > 0.5)
    n_cells = pg.n_cells
    density = rng.uniform(0.0, 3.0, (2, n_cells))
    density[1, rng.random(n_cells) < 0.3] = 0.0
    if kind == 'thin_shells':
        density[:, (np.arange(n_cells) % pg.n1) < 11] *= contrast
    chi = rng.uniform(0.1, 2.0, (n, 2))
    t_max = rng.uniform(0.0, 1.5, (n_views, n))
    return pg, pos, k, cell, active, density, chi, t_max


def _through_axis(pos, k):
    """Rays whose line meets the z axis (within 1e-7): the radial rays, the
    rays aimed at the axis and those along it. There every phi wall and
    the cones' apex meet, and the compiled JAX loop (which may fuse a
    multiply-add) and eager arithmetic can round the landing point onto
    different sides of a wall."""
    kxy = np.hypot(k[0], k[1])
    b = np.abs(pos[0] * k[1] - pos[1] * k[0]) / np.maximum(kxy, 1e-300)
    return np.where(kxy > 1e-9, b < 1e-7, np.hypot(pos[0], pos[1]) < 1e-7)


def _port_args(pos, k, cell, active, chi, dtype=torch.float64, device=CPU):
    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    return [t(chi)] + [t(a) for a in pos] + [t(k[c]) for c in range(3)] + \
        [t(cell, torch.int64), t(active, torch.bool)]


def _jax_views(kind, pos, k, cell, active, density, chi, t_max):
    """The JAX walk of each view, stacked (V, n); ``t_max`` (V, n) or
    None."""
    J = jnp.asarray
    geo = _jax_geometry(kind)
    return np.stack([np.asarray(escape_tau_walk(
        geo, J(density), J(chi), *[J(a) for a in pos],
        *[J(k[c, v]) for c in range(3)], J(cell), J(active),
        t_max=None if t_max is None else J(t_max[v])))
        for v in range(k.shape[1])])


def _shared_setup(kind, n, **kw):
    """The CPU inputs of a parity test: on the spherical grids the lanes
    whose ray in any view runs through the z axis are left out
    (:func:`_through_axis`)."""
    pg, pos, k, cell, active, density, chi, t_max = _setup(kind, n=n, **kw)
    if kind != 'cartesian':
        for v in range(k.shape[1]):
            active = active & ~_through_axis(pos, k[:, v])
    return pg, pos, k, cell, active, density, chi, t_max


@pytest.mark.parametrize('limited', [False, True], ids=['edge', 't_max'])
@pytest.mark.parametrize('kind', ['cartesian', 'spherical'])
def test_reference_matches_jax(kind, limited):
    """Three views in one call against three JAX walks. On the spherical
    grid ~45% of the random rays run through the z axis and are left out,
    so more lanes are drawn; the kernel test on the card keeps them all."""
    n = 4000 if kind == 'cartesian' else 8000
    pg, pos, k, cell, active, density, chi, t_max = _shared_setup(kind, n)
    assert active.sum() > 0.35 * n
    ref = _jax_views(kind, pos, k, cell, active, density, chi,
                     t_max if limited else None)
    walk = et.EscapeTau(pg, torch.as_tensor(density.T.copy()))
    launches = et.launches
    port = walk(*_port_args(pos, k, cell, active, chi),
                t_max=torch.as_tensor(t_max) if limited else None).numpy()
    assert et.launches == launches        # the CPU runs the plain version
    assert port.shape == (N_VIEWS, n)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-300)
    assert (port[:, ~active] == 0).all()
    assert (port[:, active] > 0).sum() > 0.8 * N_VIEWS * active.sum()


@pytest.mark.parametrize('kind', ['cartesian', 'spherical'])
def test_unlimited_view_in_a_limited_call(kind):
    """t_max = +inf for view 1 of a limited call: that view is the
    unlimited walk (min(t, inf) = t, remaining stays inf > 0), and the
    limited views are JAX's limited walks."""
    pg, pos, k, cell, active, density, chi, t_max = _shared_setup(kind, 3000)
    t_max[1] = np.inf
    walk = et.EscapeTau(pg, torch.as_tensor(density.T.copy()))
    args = _port_args(pos, k, cell, active, chi)
    mixed = walk(*args, t_max=torch.as_tensor(t_max)).numpy()
    free = walk(*args).numpy()
    np.testing.assert_array_equal(mixed[1], free[1])
    ref = _jax_views(kind, pos, k[:, [0, 2]], cell, active, density, chi,
                     t_max[[0, 2]])
    np.testing.assert_allclose(mixed[[0, 2]], ref, rtol=RTOL, atol=1e-300)
    assert (mixed[[0, 2]] < free[[0, 2]]).sum() > 0.2 * active.sum()


@pytest.mark.parametrize('limited', [False, True], ids=['edge', 't_max'])
def test_thin_shells_match_jax(limited):
    """Shells thinner than the on-wall nudge, walked by rays that start in
    them, dive through them or graze them. torch's float64 sqrt on the CPU
    is one ulp off on ~0.7% of its inputs (XLA's, like CUDA's, rounds
    correctly), and a landing point one ulp off can fall in the
    neighbouring thin shell, or out through the inner wall. So the thin
    shells are 1e3 times denser than the rest here, and tau may differ by
    one thin-shell segment's worth (at most 4e-14 long, chi x rho <= 1.2e4:
    atol 5e-10), far below any segment in the wrong ordinary cell; the
    card test, where both walks round sqrt correctly, gives them 1e12 and
    no atol."""
    pg, pos, k, cell, active, density, chi, t_max = \
        _shared_setup('thin_shells', 3000, contrast=1e3)
    ref = _jax_views('thin_shells', pos, k, cell, active, density, chi,
                     t_max if limited else None)
    port, n_cross = et.escape_tau_reference(
        pg, torch.as_tensor(density.T.copy()),
        *_port_args(pos, k, cell, active, chi),
        t_max=torch.as_tensor(t_max) if limited else None, crossings=True)
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=5e-10)
    # rays that walked through the thin shells
    assert int(n_cross.max()) > 10


def test_max_steps_stops_the_walk():
    pg, pos, k, cell, active, density, chi, _ = _setup('cartesian', n=500)
    args = _port_args(pos, k, cell, active, chi)
    rho = torch.as_tensor(density.T.copy())
    one = et.EscapeTau(pg, rho, max_steps=1)(*args)
    full = et.EscapeTau(pg, rho)(*args)
    assert (one <= full * (1 + 1e-12)).all() and (one < full).any()
    with pytest.raises(ValueError, match='max_steps'):
        et.EscapeTau(pg, rho, max_steps=0)


def test_float32_lanes_walk_in_float64():
    """float32 lanes, chi rows and density walk on the float64 walls: tau
    is the float64 walk's on the widened inputs, rounded once. A float32
    geometry is refused."""
    pg, pos, k, cell, active, density, chi, t_max = _setup('spherical',
                                                           n=2000)
    args = _port_args(pos, k, cell, active, chi, torch.float32)
    rho32 = torch.as_tensor(density.T.copy()).float()
    for tm in (None, torch.as_tensor(t_max).float()):
        tau = et.EscapeTau(pg, rho32)(*args, t_max=tm)
        assert tau.dtype == torch.float32
        wide = [a.double() if a.is_floating_point() else a for a in args]
        ref = et.EscapeTau(pg, rho32.double())(
            *wide, t_max=None if tm is None else tm.double())
        assert torch.equal(tau, ref.float())
        assert (tau[:, torch.as_tensor(active)] > 0).sum() > \
            0.8 * N_VIEWS * active.sum()
    g32 = build_spherical_geometry(_spherical_grid('port', 4, 0.0), CPU,
                                   torch.float32)
    with pytest.raises(ValueError, match='float64'):
        et.EscapeTau(g32, rho32)


@pytest.mark.parametrize('wrong', ['1d_directions', 'short_view', 't_max_1d',
                                   'strided_x'])
def test_call_checks_its_lanes(wrong):
    """The CPU call refuses what the kernel would not take: directions of
    shape (B,), a view row of another length, a (B,) t_max, a strided
    position column."""
    pg, pos, k, cell, active, density, chi, t_max = _setup('cartesian', n=64)
    args = _port_args(pos, k, cell, active, chi)
    tm = None
    if wrong == '1d_directions':
        args[4] = args[4][0]
    elif wrong == 'short_view':
        args[5] = args[5][:, :-1].contiguous()
    elif wrong == 't_max_1d':
        tm = torch.as_tensor(t_max[0])
    else:
        args[1] = torch.stack(args[1:4], dim=1)[:, 0]
    with pytest.raises(ValueError, match='escape_tau'):
        et.EscapeTau(pg, torch.as_tensor(density.T.copy()))(*args, t_max=tm)


def _deep_grid(package):
    """A spherical-polar grid with DEEP_WALLS + 24 shells, two theta cells
    a hemisphere and one phi cell: the column mode hands out the lanes of
    its inner 24 shells first."""
    return frontend(package).SphericalPolarGrid(
        np.geomspace(0.01, 1.0, et.DEEP_WALLS + 25),
        np.linspace(0.0, np.pi, 5), np.linspace(0.0, 2.0 * np.pi, 2))


SPLIT_GRIDS = {
    'cartesian': (lambda: build_cartesian_geometry(
        _cartesian_grid('port'), CPU, torch.float64), 0),
    'spherical': (lambda: build_spherical_geometry(
        _spherical_grid('port', 4, 0.0), CPU, torch.float64), 0),
    'deep': (lambda: build_spherical_geometry(_deep_grid('port'), CPU,
                                              torch.float64), 24),
}


@pytest.mark.parametrize('kind', list(SPLIT_GRIDS))
def test_column_split(kind):
    """The column mode's first sweep: on a spherical grid the lanes that
    start in the inner shells, whose rays cross at least DEEP_WALLS radial
    walls; none (one sweep, in lane order) on cartesian grids and on
    spherical grids of DEEP_WALLS shells or fewer."""
    make, split = SPLIT_GRIDS[kind]
    geometry = make()
    assert et.column_split(geometry) == split
    if split:
        assert geometry.n1 - split == et.DEEP_WALLS


# ------------------------------------------------------------- on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device('cuda')


def _card_pair(pg, density, args, t_max, cuda_device):
    """(kernel, plain version) of one call on the card; the kernel's call
    launches once."""
    rho_t = torch.as_tensor(density.T.copy(), dtype=args[1].dtype,
                            device=cuda_device)
    launches = et.launches
    tau = et.EscapeTau(pg, rho_t)(*args, t_max=t_max)
    torch.cuda.synchronize()
    assert et.launches == launches + 1
    return tau, et.escape_tau_reference(pg, rho_t, *args, t_max=t_max)


def _close(kernel, plain, dtype):
    """float64 lanes to rtol 1e-10; float32 lanes to 1e-6 (both walk in
    float64 and round tau once)."""
    rtol, atol = (RTOL, 1e-300) if dtype == torch.float64 else (1e-6, 1e-30)
    np.testing.assert_allclose(kernel.cpu().double().numpy(),
                               plain.cpu().double().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_fast_arithmetic_is_the_operators_on_card(cuda_device):
    """The kernel's branch-free float64 division and square root give the
    operators' bits wherever their range check passes, on 2^24 pairs
    spread over the whole exponent range and on zeros, denormals,
    infinities and NaNs (for which the check sends the crossing to the
    operators)."""
    import ctypes
    from hyperion_tpu_torch.transport import _build
    rng = np.random.default_rng(17)
    n = 1 << 24
    a = rng.uniform(-2.0, 2.0, n) * 2.0 ** rng.integers(-1074, 1024, n)
    b = rng.uniform(-2.0, 2.0, n) * 2.0 ** rng.integers(-1074, 1024, n)
    near = rng.random(n) < 0.5         # quotients and roots of ordinary size
    a[near] = rng.uniform(-4.0, 4.0, near.sum())
    b[near] = rng.uniform(-4.0, 4.0, near.sum())
    special = [0.0, -0.0, 5e-324, -5e-324, 2.2250738585072014e-308,
               1.0, -1.0, 1.7976931348623157e308, np.inf, -np.inf, np.nan]
    a[:len(special) ** 2] = np.repeat(special, len(special))
    b[:len(special) ** 2] = np.tile(special, len(special))
    da = torch.as_tensor(a, device=cuda_device)
    db = torch.as_tensor(b, device=cuda_device)
    counts = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    fn = _build.load('escape_tau').escape_tau_arith_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    err = fn(da.data_ptr(), db.data_ptr(), n, counts.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    bad_div, slow_div, bad_sqrt, slow_sqrt = counts.tolist()
    assert bad_div == 0 and bad_sqrt == 0
    # the ordinary half takes the fast paths
    assert slow_div < n // 2 and slow_sqrt < n // 2


@pytest.mark.cuda
@pytest.mark.parametrize('limited', [False, True], ids=['edge', 't_max'])
@pytest.mark.parametrize('kind', ['cartesian', 'spherical'])
def test_kernel_matches_plain_version_on_card(kind, limited, cuda_device):
    """Three views in one call, float64 and float32 lanes, an unlimited
    view (+inf) in the limited call."""
    pg, pos, k, cell, active, density, chi, t_max = _setup(kind, cuda_device)
    t_max[2] = np.inf
    for dtype in (torch.float64, torch.float32):
        args = _port_args(pos, k, cell, active, chi, dtype, cuda_device)
        tm = torch.as_tensor(t_max, dtype=dtype, device=cuda_device) \
            if limited else None
        tau, plain = _card_pair(pg, density, args, tm, cuda_device)
        assert tau.shape == (N_VIEWS, len(cell))
        _close(tau, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
def test_kernel_thin_shells_on_card(dtype, cuda_device):
    pg, pos, k, cell, active, density, chi, t_max = _setup(
        'thin_shells', cuda_device, n=20000)
    args = _port_args(pos, k, cell, active, chi, dtype, cuda_device)
    tau, plain = _card_pair(pg, density, args, None, cuda_device)
    _close(tau, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('live', [0, 1], ids=['none', 'one'])
def test_kernel_sparse_calls_on_card(live, cuda_device):
    """50,000 lanes of which none, or one, is active: dead rays get 0, the
    live one its walk, and the next call starts from a reset counter."""
    pg, pos, k, cell, active, density, chi, t_max = _setup(
        'spherical', cuda_device, n=50000)
    only = np.zeros_like(active)
    if live:
        only[np.flatnonzero(active)[live * 7919 % active.sum()]] = True
    for _ in range(2):
        args = _port_args(pos, k, cell, only, chi, torch.float64, cuda_device)
        tau, plain = _card_pair(pg, density, args, None, cuda_device)
        _close(tau, plain, torch.float64)
        assert int((tau != 0).sum()) == (N_VIEWS if live else 0)


@pytest.mark.cuda
def test_kernel_rays_of_unequal_length_on_card(cuda_device):
    """A 200-cell row: rays from one end walk 200 cells, rays near the far
    end one or two, in the same call and the same warps."""
    grid = frontend('port').CartesianGrid(np.linspace(-1.0, 1.0, 201),
                                          np.linspace(-0.1, 0.1, 3),
                                          np.linspace(-0.1, 0.1, 3))
    pg = build_cartesian_geometry(grid, cuda_device, torch.float64)
    n = 4096
    rng = np.random.default_rng(7)
    far = rng.random(n) < 0.5
    x = np.where(far, -0.9995, 0.9965) + rng.uniform(0, 5e-4, n)
    pos = np.stack([x, rng.uniform(-0.09, 0.09, n),
                    rng.uniform(-0.09, 0.09, n)])
    k = np.zeros((3, 1, n))
    k[0] = 1.0
    cell = build_cartesian_geometry(grid, CPU, torch.float64).find_cell(
        *[torch.as_tensor(a) for a in pos],
        *[torch.as_tensor(a) for a in k[:, 0]]).numpy()
    density = rng.uniform(0.5, 2.0, (2, pg.n_cells))
    chi = rng.uniform(0.1, 2.0, (n, 2))
    args = _port_args(pos, k, cell, cell >= 0, chi, torch.float64,
                      cuda_device)
    tau, plain = _card_pair(pg, density, args, None, cuda_device)
    _close(tau, plain, torch.float64)
    _, n_cross = et.escape_tau_reference(
        pg, torch.as_tensor(density.T.copy(), device=cuda_device), *args,
        crossings=True)
    assert int(n_cross.max()) >= 100 * int(n_cross[n_cross > 0].min())


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph_on_card(cuda_device):
    """One fused call captured in a CUDA graph, replayed on new lanes
    copied into its inputs: each replay equals the plain version."""
    pg, pos, k, cell, active, density, chi, t_max = _setup(
        'spherical', cuda_device, n=20000)
    rho_t = torch.as_tensor(density.T.copy(), device=cuda_device)
    walk = et.EscapeTau(pg, rho_t)
    static = _port_args(pos, k, cell, active, chi, torch.float64,
                        cuda_device)
    tm = torch.as_tensor(t_max, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        walk(*static, t_max=tm)                 # warm up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = walk(*static, t_max=tm)
    rng = np.random.default_rng(5)
    for seed in range(3):
        # other directions, flags, chi rows and limits, on shuffled lanes
        _, pos2, k2, cell2, active2, _, chi2, t_max2 = _setup(
            'spherical', cuda_device, n=20000, seed=100 + seed)
        p = rng.permutation(20000)
        new = _port_args(pos2[:, p], k2[:, :, p], cell2[p], active2[p],
                         chi2[p], torch.float64, cuda_device)
        t_max2 = t_max2[:, p]
        for s, a in zip(static, new):
            s.copy_(a)
        tm.copy_(torch.as_tensor(t_max2, device=cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, et.escape_tau_reference(pg, rho_t, *new, t_max=tm),
               torch.float64)


# -------------------------------------------- the column mode, on the card --

def _card_columns(pg, density, args, t_max, cuda_device):
    """(kernel, plain version) of one column call on the card (the lanes of
    ``args`` without their chi rows); the kernel's call launches once."""
    rho_t = torch.as_tensor(density.T.copy(), dtype=args[1].dtype,
                            device=cuda_device)
    launches, col_launches = et.launches, et.column_launches
    col = et.EscapeTau(pg, rho_t).columns(*args[1:], t_max=t_max)
    torch.cuda.synchronize()
    assert et.column_launches == col_launches + 1
    assert et.launches == launches
    return col, et.escape_column_reference(pg, rho_t, *args[1:], t_max=t_max)


@pytest.mark.cuda
@pytest.mark.parametrize('limited', [False, True], ids=['edge', 't_max'])
@pytest.mark.parametrize('kind', ['cartesian', 'spherical', 'thin_shells'])
def test_column_kernel_matches_plain_version_on_card(kind, limited,
                                                     cuda_device):
    """The column mode with three views, float64 and float32 lanes, an
    unlimited view (+inf) in the limited call: (V, B, n_dust) equal to the
    plain column walk, 0 for inactive lanes."""
    pg, pos, k, cell, active, density, chi, t_max = _setup(
        kind, cuda_device, n=20000)
    t_max[2] = np.inf
    for dtype in (torch.float64, torch.float32):
        args = _port_args(pos, k, cell, active, chi, dtype, cuda_device)
        tm = torch.as_tensor(t_max, dtype=dtype, device=cuda_device) \
            if limited else None
        col, plain = _card_columns(pg, density, args, tm, cuda_device)
        assert col.shape == (N_VIEWS, len(cell), 2)
        _close(col, plain, dtype)
        assert (col[:, torch.as_tensor(~active)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize('live', [0, 1], ids=['none', 'one'])
def test_column_kernel_sparse_calls_on_card(live, cuda_device):
    """50,000 lanes of which none, or one, is active, twice (the counter
    the tau walk shares is reset by each call)."""
    pg, pos, k, cell, active, density, chi, _ = _setup(
        'spherical', cuda_device, n=50000)
    only = np.zeros_like(active)
    if live:
        only[np.flatnonzero(active)[live * 7919 % active.sum()]] = True
    for _ in range(2):
        args = _port_args(pos, k, cell, only, chi, torch.float64, cuda_device)
        col, plain = _card_columns(pg, density, args, None, cuda_device)
        _close(col, plain, torch.float64)
        assert int((col.sum(dim=-1) != 0).sum()) == (N_VIEWS if live else 0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
def test_column_kernel_many_dusts_on_card(dtype, cuda_device):
    """Six dust types, more than the kernel keeps in registers: the sums go
    through the ray's float64 scratch row and are rounded once."""
    pg, pos, k, cell, active, _, chi, t_max = _setup('spherical',
                                                     cuda_device, n=20000)
    rng = np.random.default_rng(11)
    density = rng.uniform(0.0, 3.0, (6, pg.n_cells))
    density[rng.random(density.shape) < 0.2] = 0.0
    args = _port_args(pos, k, cell, active, chi, dtype, cuda_device)
    tm = torch.as_tensor(t_max, dtype=dtype, device=cuda_device)
    for limit in (None, tm):
        col, plain = _card_columns(pg, density, args, limit, cuda_device)
        assert col.shape == (N_VIEWS, len(cell), 6)
        _close(col, plain, dtype)


@pytest.mark.cuda
def test_column_kernel_in_a_cuda_graph_on_card(cuda_device):
    """One column call captured in a CUDA graph, replayed on new lanes
    copied into its inputs: each replay equals the plain version."""
    pg, pos, k, cell, active, density, chi, t_max = _setup(
        'cartesian', cuda_device, n=20000)
    rho_t = torch.as_tensor(density.T.copy(), device=cuda_device)
    walk = et.EscapeTau(pg, rho_t)
    static = _port_args(pos, k, cell, active, chi, torch.float64,
                        cuda_device)[1:]
    tm = torch.as_tensor(t_max, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        walk.columns(*static, t_max=tm)          # warm up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = walk.columns(*static, t_max=tm)
    rng = np.random.default_rng(6)
    for seed in range(3):
        _, pos2, k2, cell2, active2, _, chi2, t_max2 = _setup(
            'cartesian', cuda_device, n=20000, seed=200 + seed)
        p = rng.permutation(20000)
        new = _port_args(pos2[:, p], k2[:, :, p], cell2[p], active2[p],
                         chi2[p], torch.float64, cuda_device)[1:]
        for s, a in zip(static, new):
            s.copy_(a)
        tm.copy_(torch.as_tensor(t_max2[:, p], device=cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, et.escape_column_reference(pg, rho_t, *new, t_max=tm),
               torch.float64)


# ------------------------------ how the column mode shares its rays out --

def _five_dusts(pg, seed=13):
    rng = np.random.default_rng(seed)
    density = rng.uniform(0.0, 3.0, (5, pg.n_cells))
    density[rng.random(density.shape) < 0.2] = 0.0
    return density


@pytest.mark.cuda
@pytest.mark.parametrize('n_dust', [1, 5])
@pytest.mark.parametrize('limited', [False, True], ids=['edge', 't_max'])
@pytest.mark.parametrize('kind', ['spherical', 'thin_shells'])
def test_column_sweeps_match_plain_version_on_card(kind, limited, n_dust,
                                                   cuda_device, monkeypatch):
    """More rays than the card has threads (50,000 lanes, three views: the
    warps take chunks of 16 rays from the counter after their first), the
    lanes of the inner half of the shells handed out first or in lane
    order: the same columns to the bit, equal to the plain walk; one and
    five dusts (more than kChiRegs sum in the scratch row)."""
    pg, pos, k, cell, active, density, chi, t_max = _setup(
        kind, cuda_device, n=50000)
    t_max[2] = np.inf
    density = density[:1] if n_dust == 1 else _five_dusts(pg)
    for dtype in (torch.float64, torch.float32):
        args = _port_args(pos, k, cell, active, chi, dtype, cuda_device)[1:]
        tm = torch.as_tensor(t_max, dtype=dtype, device=cuda_device) \
            if limited else None
        rho_t = torch.as_tensor(density.T.copy(), dtype=dtype,
                                device=cuda_device)
        cols = {}
        for deep in (pg.n1, pg.n1 - pg.n1 // 2):
            monkeypatch.setattr(et, 'DEEP_WALLS', deep)
            walk = et.EscapeTau(pg, rho_t)
            assert walk.plan['split'] == pg.n1 - deep
            cols[deep] = walk.columns(*args, t_max=tm)
        first, second = cols.values()
        assert torch.equal(first, second)
        _close(first, et.escape_column_reference(pg, rho_t, *args, t_max=tm),
               dtype)
        assert (first[:, torch.as_tensor(~active)] == 0).all()


def _big_cartesian_grid(package, n=24):
    """A cartesian grid of n^3 cells: its float32 density (55,296 bytes at
    n = 24) needs more shared memory than a block takes without the
    opt-in."""
    w = np.linspace(-1.0, 1.0, n + 1)
    return frontend(package).CartesianGrid(w, w + 0.01 * np.sin(7.0 * w),
                                           w * 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
def test_column_density_in_opt_in_shared_memory_on_card(dtype, cuda_device):
    """A density past 48 KB: the column mode takes it into the card's
    opt-in shared memory (blocks of 1,024 threads) while the tau walk
    reads it from global memory; both equal their plain versions."""
    grid = _big_cartesian_grid('port')
    g64 = build_cartesian_geometry(grid, CPU, torch.float64)
    pos, k0 = _cartesian_rays(g64, n=20000, seed=5)
    cell = g64.find_cell(*[torch.as_tensor(a) for a in pos],
                         *[torch.as_tensor(a) for a in k0]).numpy()
    pg = build_cartesian_geometry(grid, cuda_device, torch.float64)
    rng = np.random.default_rng(9)
    k = np.stack([k0, -k0], axis=1)
    active = (cell >= 0) & (rng.random(len(cell)) < 0.9)
    density = rng.uniform(0.0, 3.0, (1, pg.n_cells))
    chi = rng.uniform(0.1, 2.0, (len(cell), 1))
    args = _port_args(pos, k, cell, active, chi, dtype, cuda_device)
    rho_t = torch.as_tensor(density.T.copy(), dtype=dtype, device=cuda_device)
    walk = et.EscapeTau(pg, rho_t)
    plan = walk.plan
    assert plan['big_col'] and plan['rho_shared_col']
    assert plan['smem_col'] > 48 * 1024 and not plan['rho_shared']
    _close(walk.columns(*args[1:]),
           et.escape_column_reference(pg, rho_t, *args[1:]), dtype)
    _close(walk(*args), et.escape_tau_reference(pg, rho_t, *args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('columns', [True, False], ids=['columns', 'tau'])
def test_block_clock_on_card(columns, cuda_device):
    """With a block clock set, each block that ran writes its start and its
    end (ns) and the results are unchanged; a table too short, of another
    type or on the CPU is refused."""
    pg, pos, k, cell, active, density, chi, t_max = _setup(
        'spherical', cuda_device, n=20000)
    args = _port_args(pos, k, cell, active, chi, torch.float64, cuda_device)
    rho_t = torch.as_tensor(density.T.copy(), device=cuda_device)
    walk = et.EscapeTau(pg, rho_t)

    def call():
        return walk.columns(*args[1:]) if columns else walk(*args)
    plain = call()
    n = walk.clock_words()
    for wrong in (torch.zeros(n - 1, dtype=torch.int64, device=cuda_device),
                  torch.zeros(n, dtype=torch.int32, device=cuda_device),
                  torch.zeros(n, dtype=torch.int64)):
        with pytest.raises(ValueError, match='block_clock'):
            walk.block_clock = wrong
    walk.block_clock = torch.zeros(n, dtype=torch.int64, device=cuda_device)
    assert torch.equal(call(), plain)
    torch.cuda.synchronize()
    c = walk.block_clock.cpu().numpy().reshape(-1, 2)
    ran = c[:, 0] > 0
    assert ran.sum() >= 1 and (c[ran, 1] >= c[ran, 0]).all()
    walk.block_clock = None
    assert torch.equal(call(), plain)


def test_cycle_probes_match_the_kernel_source():
    """scripts/escape_tau_cycles.py finds each of its markers in the
    kernel's source as often as it should (the set of the octree crossing
    over node records, with the AMR, cylindrical and packed Voronoi
    crossings' markers), so that its instrumented copy splits the
    crossings it measures."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / 'scripts' / \
        'escape_tau_cycles.py'
    spec = importlib.util.spec_from_file_location('escape_tau_cycles', path)
    cyc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cyc)
    src = (Path(et.__file__).parent / 'csrc' / 'escape_tau.cu').read_text()
    name, markers = cyc.marker_set(src)
    assert name == 'walkup'
    probed = cyc.instrumented_source()
    for slot in ('walls', 'box_exit', 'locate', 'rest', 'candidates',
                 'find_cell', 'row', 'sites', 'divisions', 'argmin',
                 'neighbours', 'divided', 'walk_up', 'descend', 'levels_up',
                 'levels_down'):
        assert 'atomicAdd(&probe[%d]' % cyc.SLOTS[slot] in probed


def test_ptxas_resources_reads_each_entry():
    """_build.ptxas_resources reads each kernel's registers and spill
    stores from ptxas's -v output (escape_tau's build keeps it beside the
    library; chip_smoke.py reports the column kernel's)."""
    from hyperion_tpu_torch.transport import _build
    text = (
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL11walk_kernel"
        "IfLi5ELb1ELi1024EEEvNS_6ParamsIT_EE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN4_GLOBAL11walk_kernel"
        "IfLi5ELb1ELi1024EEEvNS_6ParamsIT_EE\n"
        "    56 bytes stack frame, 132 bytes spill stores, 84 bytes spill "
        "loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 56 bytes "
        "cumulative stack size\n"
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL11walk_kernel"
        "IdLi5ELb1ELi128EEEvNS_6ParamsIT_EE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN4_GLOBAL11walk_kernel"
        "IdLi5ELb1ELi128EEEvNS_6ParamsIT_EE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 86 registers, used 1 barriers\n")
    assert _build.ptxas_resources(text) == {
        '_ZN4_GLOBAL11walk_kernelIfLi5ELb1ELi1024EEEvNS_6ParamsIT_EE':
            (64, 132),
        '_ZN4_GLOBAL11walk_kernelIdLi5ELb1ELi128EEEvNS_6ParamsIT_EE':
            (86, 0)}
