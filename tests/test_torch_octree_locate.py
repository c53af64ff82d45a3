"""The octree locate of the port (``transport/octree_locate.py``, the kernel
``csrc/octree_locate.cu`` and its plain versions) against the JAX package's
``OctreeGeometry._descend`` and ``find_cell`` (JAX x64, torch float64
unless stated).

- The plain ``find_cell_reference`` on the SPH tree and on the clumped tree
  of tests/test_torch_octree.py, on seeded points (a third on a leaf's
  wall, a refined node's centre plane or a leaf's corner; some outside the
  root box): the leaf ids equal the JAX ``find_cell``'s and, away from the
  node planes (1e-9), its ``_descend``'s.
- CPU tensors run the plain versions: the geometry's ``find_cell`` and
  ``find_wall`` give theirs, in float64 and float32, and no kernel is
  loaded or launched.
- On the card (marked cuda, skipped here): the kernel against the plain
  versions on corner, tie, along-plane and off-box crossings, float32 and
  float64 lanes, all four ``find_wall`` outputs and ``find_cell`` bit for
  bit, also inside a CUDA graph."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperion_tpu.transport.gtable_octree import \
    build_octree_geometry as j_geometry
from hyperion_tpu_torch.transport import _build
from hyperion_tpu_torch.transport import octree_locate as ol
from hyperion_tpu_torch.transport.gtable_octree import build_octree_geometry
from test_torch_octree import (_crossing_starts, _near_plane, _pair, _planes,
                               _rays, clumped_tree, sph_tree)

torch.set_num_threads(1)
CPU = torch.device('cpu')
F32, F64 = torch.float32, torch.float64
STYLES = ('rays', 'tie', 'along', 'off')

_TREES = {}


def _tree(which):
    """The port's OctreeGrid of the SPH or the clumped tree, built once."""
    if which not in _TREES:
        _TREES[which] = clumped_tree() if which == 'clumped' else \
            sph_tree('port')
    return _TREES[which]


def _points(pg, n=4000, seed=5):
    """The rays of :func:`_rays` (points on walls, centre planes and
    corners; directions along axes, faces and diagonals), a tenth of them
    moved anywhere in the root box grown 1.5 times, most of those outside
    it."""
    pos, k = _rays(pg, n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    out = rng.random(n) < 0.1
    lo, hi = pg.lo[0].numpy(), pg.hi[0].numpy()
    centre, half = (lo + hi) / 2, (hi - lo) / 2
    pos[:, out] = centre[:, None] + half[:, None] * rng.uniform(
        -1.5, 1.5, (3, out.sum()))
    return pos, k


@pytest.mark.parametrize('which', ['sph', 'clumped'])
def test_find_cell_reference_matches_jax(which):
    """find_cell_reference equals the JAX find_cell on every point, and
    the port's descend equals JAX's _descend wherever a point lies more
    than 1e-9 from every node plane (on a plane the JAX descend takes the
    upper side whatever the direction)."""
    if which == 'sph':
        jg, pg = _pair()
    else:
        jg = j_geometry(_tree(which), dtype=jnp.float64)
        pg = build_octree_geometry(_tree(which), CPU, F64)
    pos, k = _points(pg)
    tpos, tk = ([torch.as_tensor(a) for a in arr] for arr in (pos, k))
    jpos, jk = ([jnp.asarray(a) for a in arr] for arr in (pos, k))
    cell = ol.find_cell_reference(pg, *tpos, *tk)
    np.testing.assert_array_equal(cell.numpy(),
                                  np.asarray(jg.find_cell(*jpos, *jk)))
    inside = cell >= 0
    assert inside.sum() > 3000 and (~inside).sum() > 200
    planes = _planes(pg)
    off_planes = inside.numpy().copy()
    for a in range(3):
        off_planes &= ~_near_plane(planes[a], pos[a])
    assert off_planes.sum() > 1000
    sel = torch.as_tensor(off_planes)
    np.testing.assert_array_equal(
        pg._descend(*(a[sel] for a in tpos), *(a[sel] for a in tk)).numpy(),
        np.asarray(jg._descend(*(a[off_planes] for a in jpos))))


@pytest.mark.parametrize('dtype', [F64, F32])
def test_cpu_tensors_run_the_plain_version(dtype):
    """On CPU tensors the geometry's find_cell and find_wall are the plain
    versions' (the same tensors' bits, the same dtypes), the locator holds
    no kernel and nothing is launched or loaded."""
    pg = build_octree_geometry(_tree('sph'), CPU, dtype)
    pos, k, _ = _crossing_starts(pg, 'tie', seed=3, n=2000)
    lanes = [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
             for a in (*pos, *k)]
    before = ol.launches
    cell = pg.find_cell(*lanes)
    np.testing.assert_array_equal(cell.numpy(),
                                  ol.find_cell_reference(pg, *lanes).numpy())
    keep = cell >= 0
    args = [cell[keep]] + [a[keep] for a in lanes]
    got = pg.find_wall(*args)
    want = ol.find_wall_reference(pg, *args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert got[0].dtype == dtype and got[1].dtype == torch.int64
    assert ol.launches == before
    assert not pg.locator._cuda and not hasattr(pg.locator, '_fn')
    assert 'octree_locate' not in _build._loaded


# ---- the kernel on the card (marked cuda: skipped without one) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device('cuda')


def _same_bits(got, want):
    """Equal dtypes and equal bits (a float's sign of zero included)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point:
        view = torch.int32 if got.dtype == F32 else torch.int64
        got, want = got.view(view), want.view(view)
    return bool(torch.equal(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['sph', 'clumped'])
@pytest.mark.parametrize('dtype', [F32, F64], ids=['f32', 'f64'])
def test_kernel_matches_plain_version_on_card(which, dtype, cuda_device):
    """find_cell and find_wall launched on the card against
    find_cell_reference and find_wall_reference on the same CUDA tensors,
    every output bit for bit, on each style of crossing start (rays on
    walls, planes and corners; exact corner and edge ties; moves along a
    face; starts off the leaf's box), each call counted once; then the
    same calls captured in a CUDA graph and replayed. Lanes of another type
    than the tables' are refused."""
    pg = build_octree_geometry(_tree(which), cuda_device, dtype)
    host = build_octree_geometry(_tree(which), CPU, dtype)
    before = ol.launches
    n_calls = 0
    escaped = 0
    for style in STYLES:
        for seed in range(2):
            pos, k, start = _crossing_starts(host, style, seed, n=20000)
            lane = [torch.as_tensor(np.ascontiguousarray(a)).to(
                cuda_device, dtype) for a in (*pos, *k)]
            cell = pg.find_cell(*lane)
            assert _same_bits(cell, ol.find_cell_reference(pg, *lane))
            if start is not None:
                cell = torch.as_tensor(start).to(cuda_device)
            keep = cell >= 0
            args = [cell[keep].contiguous()] + [a[keep].contiguous()
                                                for a in lane]
            got = pg.find_wall(*args)
            want = ol.find_wall_reference(pg, *args)
            for name, g, w in zip(('t', 'next_cell', 'axis', 'wall'), got,
                                  want):
                assert _same_bits(g, w), (style, seed, name)
            escaped += int((got[1] < 0).sum())
            n_calls += 2
    torch.cuda.synchronize()
    assert ol.launches - before == n_calls
    assert escaped > 0
    other = F64 if dtype == F32 else F32
    with pytest.raises(ValueError, match='tables'):
        pg.find_cell(*(a.to(other) for a in lane))

    # captured: the replay writes the kernel's outputs anew
    out = {}
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out['cell'] = pg.find_cell(*lane)
        out['wall'] = pg.find_wall(*args)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(out['cell'], ol.find_cell_reference(pg, *lane))
    for g, w in zip(out['wall'], want):
        assert _same_bits(g, w)
