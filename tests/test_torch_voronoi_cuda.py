"""The Voronoi grid's kernels on the card against their plain versions
(marked cuda: skipped without a card). The file imports only the port,
numpy and scipy, so it runs on a machine without JAX or h5py:

- the locate kernel (``csrc/voronoi_locate.cu``): ``locate`` and
  ``walk_from`` equal to the plain walk on points inside the box, on the
  faces, edges and corners between lattice sites, and outside the box, in
  float32 and float64, the lanes at the cap counted alike;
- escape_tau.cu's Voronoi crossing (``kKind = 5``), tau and column modes:
  float64 lanes equal to the plain walk to the bit, float32 lanes equal to
  their own plain walk; on the lattice mesh from points on its cells'
  faces, edges and corners along the axes and diagonals (ties between
  bisectors, so the first index must win, and lanes on a bisector wall
  that cross it at t = 0), and from the cells of a row of 4 neighbours
  and of one of 32 (one and four chunks of the packed row);
- the locate kernel, four threads a lane, at lane counts on either side
  of a warp's and a block's lanes, where a group's last threads lie past
  the call's last lane.

The meshes' helpers serve tests/test_torch_voronoi.py too."""

import functools

import numpy as np
import pytest
import torch

from hyperion_tpu_torch.grid import VoronoiGrid
from hyperion_tpu_torch.transport.escape_tau import (EscapeTau,
                                                     escape_column_reference,
                                                     escape_tau_reference)
from hyperion_tpu_torch.transport.gtable_voronoi import \
    build_voronoi_geometry
from hyperion_tpu_torch.transport.voronoi_locate import (
    VoronoiLocate, locate_reference, owner_walk_reference)

CPU = torch.device('cpu')
F64 = torch.float64


def clustered(n, seed):
    """Points in [-1, 1]^3: 80% in a Plummer sphere of radius 0.2, 20% in
    10 Gaussian clumps of sigma 0.02 (chip_smoke.sph_particles at 1 pc =
    2), those outside the cube dropped."""
    rng = np.random.default_rng(seed)
    n_pl = int(0.8 * n)
    r = 0.2 / np.sqrt(rng.uniform(0, 1, n_pl) ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(3, n_pl))
    pl = v / np.linalg.norm(v, axis=0) * r
    centres = rng.normal(0.0, 0.2, (3, 10))
    cl = np.repeat(centres, (n - n_pl) // 10, axis=1) + \
        rng.normal(0.0, 0.02, (3, n - n_pl))
    p = np.concatenate([pl, cl], axis=1)
    return p[:, (np.abs(p) < 1.0).all(axis=0)]


def lattice_sites(n):
    """The centres of an n^3 lattice over [-1, 1]^3, x fastest."""
    walls = np.linspace(-1.0, 1.0, n + 1)
    c = 0.5 * (walls[1:] + walls[:-1])
    zz, yy, xx = np.meshgrid(c, c, c, indexing='ij')
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel()]), walls


def fibonacci_sphere(n, radius):
    """``n`` nearly even points on a sphere about the origin."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    return radius * np.stack([np.cos(theta) * np.sin(phi),
                              np.sin(theta) * np.sin(phi), np.cos(phi)])


@functools.lru_cache(maxsize=None)
def port_mesh(kind, n=2000):
    """A port VoronoiGrid in [-1, 1]^3 of ``n`` uniform or clustered sites,
    of an n^3 lattice's centres, of a tetrahedron's corners and centre
    ('tetra': every row 4 neighbours) or of the origin inside ``n``
    (32) points of a sphere ('shell': the origin's row 32)."""
    if kind == 'uniform':
        pts = np.random.RandomState(42).uniform(-1, 1, (3, n))
    elif kind == 'clustered':
        pts = clustered(n, 5)
    elif kind == 'tetra':
        pts = np.concatenate([np.zeros((3, 1)), 0.6 / 3 ** 0.5 * np.array(
            [[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]).T], axis=1)
    elif kind == 'shell':
        pts = np.concatenate([np.zeros((3, 1)), fibonacci_sphere(n, 0.5)],
                             axis=1)
    else:
        pts = lattice_sites(n)[0]
    return VoronoiGrid(*pts, xmin=-1., xmax=1., ymin=-1., ymax=1.,
                       zmin=-1., zmax=1.)


def walk_inputs(geo, n=3000, n_dust=2, seed=43):
    """Seeded rays from points inside the box, their cells, a density with
    a tenth of the cells empty, chi rows, the active lanes and distance
    limits."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-0.95, 0.95, (3, n)) / geo.length_scale
    k = rng.normal(size=(3, n))
    k /= np.linalg.norm(k, axis=0)
    zero = torch.zeros(n, dtype=geo.sites.dtype, device=geo.sites.device)
    cell = geo.find_cell(*(torch.as_tensor(a, device=geo.sites.device,
                                           dtype=geo.sites.dtype)
                           for a in pos), zero, zero, zero).cpu().numpy()
    density = rng.uniform(0.1, 2.0, (n_dust, geo.n_cells))
    density[:, rng.rand(geo.n_cells) < 0.1] = 0.0
    chi = rng.uniform(0.5, 2.0, (n, n_dust))
    active = rng.rand(n) < 0.9
    t_max = rng.uniform(0.0, 1.5, n)
    return pos, k, cell, active, density, chi, t_max


# ---- the kernels on the card (marked cuda: skipped without one) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kind,dtype', [
    ('uniform', torch.float64), ('clustered', torch.float64),
    ('clustered', torch.float32), ('lattice', torch.float32)])
def test_locate_kernel_matches_plain_on_card(kind, dtype, cuda_device):
    """The locate kernel's cells against the plain locate on the same
    points (inside, on ties, outside the box), and its walks from given
    starts; float32 and float64 lanes, the lanes at the cap counted alike."""
    pg = port_mesh(kind, 8 if kind == 'lattice' else 2000)
    geo = build_voronoi_geometry(pg, cuda_device, dtype)
    rng = np.random.RandomState(5)
    n = 200000
    pts = rng.uniform(-1.02, 1.02, (3, n)) / geo.length_scale
    if kind == 'lattice':
        walls = np.linspace(-1.0, 1.0, 9) / geo.length_scale
        pts[:, ::2] = rng.choice(walls, (3, n // 2))
    x, y, z = (torch.as_tensor(a, device=cuda_device, dtype=dtype)
               for a in pts)
    loc = VoronoiLocate(geo)
    cell = loc.locate(x, y, z)
    ref, cap = locate_reference(geo, x, y, z, at_cap=True)
    assert torch.equal(cell, ref)
    assert (cell >= 0).sum() > n // 2 and (cell < 0).any()
    start = torch.as_tensor(rng.randint(0, geo.n_cells, n),
                            device=cuda_device)
    walked = loc.walk_from(start, x, y, z)
    ref_w, cap_w = owner_walk_reference(geo.sites, geo.neigh, start, x, y, z,
                                        geo.walk_steps)
    assert torch.equal(walked, ref_w)
    assert loc.lanes_at_cap() == int(cap.sum()) + int(cap_w.sum())


@pytest.mark.cuda
@pytest.mark.parametrize('limited,dtype', [
    (False, torch.float64), (True, torch.float64), (False, torch.float32),
    (True, torch.float32)], ids=['f64', 'limited_f64', 'f32', 'limited_f32'])
def test_escape_kernel_matches_plain_walk_on_card(limited, dtype,
                                                  cuda_device):
    """escape_tau.cu's Voronoi crossing (``kKind = 5``), tau and column
    modes, against the plain walk on the same rays: float64 lanes equal to
    the bit, float32 lanes equal to their own plain walk."""
    pg = port_mesh('clustered')
    pos, k, cell, active, density, chi, t_max = walk_inputs(
        build_voronoi_geometry(pg, CPU, F64), n=20000)
    geo = build_voronoi_geometry(pg, cuda_device, F64)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(cuda_device, dt)

    rho_t = dev(density.T)
    walk = EscapeTau(geo, rho_t)
    lanes = [dev(a) for a in pos] + [dev(a)[None] for a in k]
    cellt = dev(cell, torch.int64)
    act = dev(active, torch.bool)
    tm = dev(t_max)[None] if limited else None
    tau = walk(dev(chi), *lanes, cellt, act, t_max=tm)
    col = walk.columns(*lanes, cellt, act, t_max=tm)
    torch.cuda.synchronize()
    ref_tau = escape_tau_reference(geo, rho_t, dev(chi), *lanes, cellt, act,
                                   t_max=tm)
    ref_col = escape_column_reference(geo, rho_t, *lanes, cellt, act,
                                      t_max=tm)
    assert (ref_tau > 0).sum() > 15000
    assert torch.equal(tau, ref_tau)
    assert torch.equal(col, ref_col)


def tie_rays(geo, n, seed):
    """Rays on the 8^3 lattice mesh from points on its cells' faces, edges
    and corners (each coordinate a lattice wall or a random value), along
    the axes, the face and body diagonals and random directions: rays on
    a wall between two cells, through edges and corners, tie between
    bisectors; those on a wall moving into the neighbour cross at t = 0."""
    rng = np.random.RandomState(seed)
    walls = np.linspace(-1.0, 1.0, 9)[1:-1]
    pos = rng.uniform(-0.95, 0.95, (3, n))
    on = rng.rand(3, n) < 0.6
    pos[on] = rng.choice(walls, int(on.sum()))
    dirs = np.concatenate([np.eye(3), -np.eye(3),
                           np.array([[1, 1, 0], [1, -1, 0], [0, 1, 1],
                                     [1, 0, -1], [1, 1, 1], [-1, 1, 1],
                                     [1, -1, -1]]).T], axis=1)
    dirs = dirs / np.linalg.norm(dirs, axis=0)
    k = dirs[:, rng.randint(0, dirs.shape[1], n)]
    free = rng.rand(n) < 0.2
    k[:, free] = rng.normal(size=(3, int(free.sum())))
    k /= np.linalg.norm(k, axis=0)
    return pos / geo.length_scale, k


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['lattice', 'tetra', 'shell'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
def test_escape_kernel_ties_and_row_lengths_on_card(kind, dtype,
                                                    cuda_device):
    """escape_tau.cu's Voronoi crossing, tau and column modes, unlimited and
    limited, against the plain walk: the lattice mesh's tie rays
    (:func:`tie_rays`), and rays from the cells of rows of 4 neighbours
    ('tetra') and of 32 ('shell', its centre); float64 lanes to the bit,
    float32 lanes equal to their own plain walk."""
    pg = port_mesh(kind, {'lattice': 8, 'shell': 32}.get(kind, 0))
    geo = build_voronoi_geometry(pg, cuda_device, F64)
    deg = geo.packed_rows.degrees.cpu().numpy()
    rng = np.random.RandomState(7)
    n = 20000
    if kind == 'lattice':
        pos, k = tie_rays(geo, n, 7)
    else:
        assert deg.max() == (4 if kind == 'tetra' else 32)
        pos = rng.uniform(-0.95, 0.95, (3, n)) / geo.length_scale
        # half the rays from the largest row's cell
        big = int(np.argmax(deg))
        pos[:, ::2] = geo.sites[big].cpu().numpy()[:, None] + \
            rng.uniform(-0.05, 0.05, (3, n // 2)) / geo.length_scale
        k = rng.normal(size=(3, n))
        k /= np.linalg.norm(k, axis=0)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(cuda_device, dt)

    lanes = [dev(a) for a in pos] + [dev(a)[None] for a in k]
    zero = torch.zeros(n, dtype=dtype, device=cuda_device)
    geo_l = build_voronoi_geometry(pg, cuda_device, dtype)
    cell = geo_l.find_cell(*lanes[:3], zero, zero, zero)
    act = cell >= 0
    cell = cell.clamp_min(0)
    density = rng.uniform(0.1, 2.0, (geo.n_cells, 2))
    rho_t = dev(density)
    chi = dev(rng.uniform(0.5, 2.0, (n, 2)))
    walk = EscapeTau(geo, rho_t)
    for tm in (None, dev(rng.uniform(0.0, 1.5, n))[None]):
        tau = walk(chi, *lanes, cell, act, t_max=tm)
        col = walk.columns(*lanes, cell, act, t_max=tm)
        torch.cuda.synchronize()
        ref_tau, n_cross = escape_tau_reference(geo, rho_t, chi, *lanes, cell,
                                                act, t_max=tm, crossings=True)
        ref_col = escape_column_reference(geo, rho_t, *lanes, cell, act,
                                          t_max=tm)
        assert torch.equal(tau, ref_tau)
        assert torch.equal(col, ref_col)
    assert int(act.sum()) > n // 2 and int(n_cross.max()) > 2
    if kind == 'lattice':
        # rays that cross a wall at t = 0 and rays that tie: the plain
        # walk's zero-length segments
        t0 = escape_tau_reference(geo, rho_t, chi, *lanes, cell, act,
                                  max_steps=1)
        assert (t0[0][act] == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_locate_groups_on_card(dtype, cuda_device):
    """The locate kernel (four threads a lane: 8 lanes a warp, 64 a block
    of 256 threads) at lane counts on either side of a warp's and a
    block's lanes: ``locate`` and ``walk_from`` equal to the plain walk."""
    geo = build_voronoi_geometry(port_mesh('clustered'), cuda_device, dtype)
    loc = VoronoiLocate(geo)
    counts = (1, 3, 7, 8, 9, 63, 64, 65, 127, 128, 129, 1000, 4097)
    rng = np.random.RandomState(9)
    capped = 0
    for B in counts:
        pts = rng.uniform(-1.02, 1.02, (3, B)) / geo.length_scale
        x, y, z = (torch.as_tensor(a, device=cuda_device, dtype=dtype)
                   for a in pts)
        start = torch.as_tensor(rng.randint(0, geo.n_cells, B),
                                device=cuda_device)
        ref, cap = locate_reference(geo, x, y, z, at_cap=True)
        ref_w, cap_w = owner_walk_reference(geo.sites, geo.neigh, start, x,
                                            y, z, geo.walk_steps)
        capped += int(cap.sum()) + int(cap_w.sum())
        assert torch.equal(loc.locate(x, y, z), ref), B
        assert torch.equal(loc.walk_from(start, x, y, z), ref_w), B
    assert loc.lanes_at_cap() == capped
