"""The escape-tau walk: the port's plain version against the JAX package's
``escape_tau_walk`` on the same ~10^4 rays (JAX x64, torch float64), on a
cartesian grid and on a spherical-polar grid with theta and phi walls,
with and without a distance limit (an inside observer's ``t_max``), two
dust types and a tenth of the lanes inactive. The walks take the same
crossings, so tau matches to rtol 1e-10. float32 lanes walk in float64.
On the card, the CUDA kernel against the plain version (marked ``cuda``:
the kernel has no CPU mode)."""

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
from test_torch_geometry import _grid as _cartesian_grid
from test_torch_geometry import _rays as _cartesian_rays
from test_torch_spherical import _grid as _spherical_grid
from test_torch_spherical import _rays as _spherical_rays

torch.set_num_threads(1)
CPU = torch.device('cpu')
RTOL = 1e-10


def _jax_geometry(kind):
    if kind == 'cartesian':
        return j_cartesian(_cartesian_grid('jax'), dtype=jnp.float64)
    return j_spherical(_spherical_grid('jax', 4, 0.0), dtype=jnp.float64)


def _setup(kind, device=CPU, n=10000):
    """(port geometry on ``device``, float64 as the walk takes it, rays
    (3, n) and (3, n), cells, active mask, density (2, n_cells), chi rows
    (n, 2), t_max (n,)). Made with the port alone (the card's machine has
    no h5py, which the JAX package's grids need): the rays from the float64
    walls, the cells by the float64 find_cell."""
    if kind == 'cartesian':
        grid, build = _cartesian_grid('port'), build_cartesian_geometry
        rays = _cartesian_rays
    else:
        grid, build = _spherical_grid('port', 4, 0.0), build_spherical_geometry
        rays = _spherical_rays
    g64 = build(grid, CPU, torch.float64)
    pos, k = rays(g64, n=n)
    cell = g64.find_cell(*[torch.as_tensor(a) for a in pos],
                         *[torch.as_tensor(a) for a in k]).numpy()
    pg = build(grid, device, torch.float64)
    rng = np.random.default_rng(41)
    # a ray aimed at its own position has no direction: it never escapes
    active = (cell >= 0) & (rng.random(n) < 0.9) & \
        (np.linalg.norm(k, axis=0) > 0.5)
    n_cells = pg.n_cells
    density = rng.uniform(0.0, 3.0, (2, n_cells))
    density[1, rng.random(n_cells) < 0.3] = 0.0
    chi = rng.uniform(0.1, 2.0, (n, 2))
    t_max = rng.uniform(0.0, 1.5, n)
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


@pytest.mark.parametrize('limited', [False, True], ids=['edge', 't_max'])
@pytest.mark.parametrize('kind', ['cartesian', 'spherical'])
def test_reference_matches_jax(kind, limited):
    """On the spherical grid the rays through the z axis are left out
    (:func:`_through_axis`, ~45% of the random rays), so twice as many
    rays are drawn; the kernel test on the card keeps them all."""
    n = 10000 if kind == 'cartesian' else 20000
    pg, pos, k, cell, active, density, chi, t_max = _setup(kind, n=n)
    if kind == 'spherical':
        active = active & ~_through_axis(pos, k)
        assert active.sum() > 8000
    ref = np.asarray(escape_tau_walk(
        _jax_geometry(kind), jnp.asarray(density), jnp.asarray(chi),
        *[jnp.asarray(a) for a in pos], *[jnp.asarray(a) for a in k],
        jnp.asarray(cell), jnp.asarray(active),
        t_max=jnp.asarray(t_max) if limited else None))
    t = torch.as_tensor
    walk = et.EscapeTau(pg, t(density.T.copy()))
    launches = et.launches
    port = walk(t(chi), *[t(a) for a in pos], *[t(a) for a in k], t(cell),
                t(active), t_max=t(t_max) if limited else None).numpy()
    assert et.launches == launches        # the CPU runs the plain version
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-300)
    assert (port[~active] == 0).all()
    assert (port[active] > 0).sum() > 0.8 * active.sum()


def test_max_steps_stops_the_walk():
    pg, pos, k, cell, active, density, chi, _ = _setup('cartesian', n=500)
    t = torch.as_tensor
    args = [t(chi)] + [t(a) for a in pos] + [t(a) for a in k] + \
        [t(cell), t(active)]
    one = et.EscapeTau(pg, t(density.T.copy()), max_steps=1)(*args)
    full = et.EscapeTau(pg, t(density.T.copy()))(*args)
    assert (one <= full * (1 + 1e-12)).all() and (one < full).any()


def test_float32_lanes_walk_in_float64():
    """float32 lanes, chi rows and density walk on the float64 walls: tau
    is the float64 walk's on the widened inputs, rounded once. A float32
    geometry is refused."""
    pg, pos, k, cell, active, density, chi, t_max = _setup('spherical',
                                                           n=2000)
    t = torch.as_tensor
    args = [t(chi).float()] + [t(a).float() for a in pos] + \
        [t(a).float() for a in k] + [t(cell), t(active)]
    rho32 = t(density.T.copy()).float()
    for tm in (None, t(t_max).float()):
        tau = et.EscapeTau(pg, rho32)(*args, t_max=tm)
        assert tau.dtype == torch.float32
        wide = [a.double() if a.is_floating_point() else a for a in args]
        ref = et.EscapeTau(pg, rho32.double())(
            *wide, t_max=None if tm is None else tm.double())
        assert torch.equal(tau, ref.float())
        assert (tau[t(active)] > 0).sum() > 0.8 * active.sum()
    g32 = build_spherical_geometry(_spherical_grid('port', 4, 0.0), CPU,
                                   torch.float32)
    with pytest.raises(ValueError, match='float64'):
        et.EscapeTau(g32, rho32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('limited', [False, True], ids=['edge', 't_max'])
@pytest.mark.parametrize('kind', ['cartesian', 'spherical'])
def test_kernel_matches_plain_version_on_card(kind, limited, cuda_device):
    """The kernel against the plain version on the card, with float64 lanes
    (rtol 1e-10) and with float32 lanes (rtol 1e-6: both walk in float64
    and round tau once)."""
    pg, pos, k, cell, active, density, chi, t_max = _setup(kind, cuda_device)

    def run(dtype, reference):
        def t(a, dt=dtype):
            return torch.as_tensor(a, device=cuda_device, dtype=dt)

        args = [t(chi)] + [t(a) for a in pos] + [t(a) for a in k] + \
            [t(cell, torch.int64), t(active, torch.bool)]
        tm = t(t_max) if limited else None
        rho_t = t(density.T.copy())
        if reference:
            return et.escape_tau_reference(pg, rho_t, *args, t_max=tm)
        launches = et.launches
        tau = et.EscapeTau(pg, rho_t)(*args, t_max=tm)
        torch.cuda.synchronize()
        assert et.launches == launches + 1
        return tau

    ref = run(torch.float64, True).cpu().numpy()
    np.testing.assert_allclose(run(torch.float64, False).cpu().numpy(), ref,
                               rtol=RTOL, atol=1e-300)
    plain32 = run(torch.float32, True).cpu().numpy().astype(float)
    k32 = run(torch.float32, False).cpu().numpy().astype(float)
    np.testing.assert_allclose(k32, plain32, rtol=1e-6, atol=1e-30)
