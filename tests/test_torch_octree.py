"""The port's octree geometry against the JAX package's on the same seeded
inputs (JAX x64, torch float64 unless stated).

- The tables equal the JAX tables, and each node's walls ``lo`` and ``hi``
  are its ancestors' centres (or the root's bounds) to the bit.
- On a ``construct_octree`` tree (about 2,000 clustered particles, n_ref
  16) and seeded rays, a third of them starting on a leaf's wall, on a
  refined node's centre plane or at a leaf's corner, with directions along
  an axis, parallel to a face and along a diagonal: ``find_cell`` and
  ``in_cell_tol`` equal the JAX functions; ``find_wall``'s distance to
  rtol 1e-12 and its next leaf equal on every ray whose JAX relocation
  leaves the leaf, apart from those whose exit point lies within 1e-9 of
  a second node plane (an edge or corner crossing, which the JAX
  package's nudge of 1e-12 of the root decides); ``closest_wall_distance``
  to 1e-15 absolute (engine units).
- The uniform-density chord oracle of tests/test_octree.py:67-102 at rtol
  1e-8, on the rays above; the plain tau and column walks against JAX's
  ``escape_tau_walk`` and ``escape_column_walk`` at rtol 1e-12.
- The witness of the recorded difference (ROADMAP.md section 3): on a
  20,000-particle clustered tree with n_ref 32 (2,753 nodes), the port's
  float32 walk relocates into the same leaf 0 times and every ray
  escapes. The JAX package's float32 walk (its ``find_wall`` and move,
  jitted) from the same 4,000 rays, run once on the CPU: 175,329 of its
  229,698 crossings relocated into the same leaf, and 176 of the 4,000
  rays were still walking after 1,000 crossings.
- The zero-killed placements of tests/test_propagation.py through the
  port's run_lucy: sources at the origin (a vertex of the root's
  children), at deeper vertices and on edges and faces.
- A Lucy iteration, the imaging iteration's peeled SED and raytracing,
  run through both packages' run_model: the specific energies and the SED
  within 5 sigma of both runs' Monte-Carlo noise (plus 5% of the larger
  for the raytraced part's own sampling noise), and the same .rtout
  layout.
- The walk kernel's node records (``OctreeGeometry.node_records``, what
  ``escape_tau.kernel_tables`` binds) hold each node's walls, centre,
  parent, grandparent, children and leaf-children mask to the bit, on a
  port tree, a clumped tree with leaves at every depth, float32 tables and
  a geometry carried from the JAX tables; the host copy of the kernel's
  walk up and descend (``locate_from``) finds the root descend's leaf on
  hypothesis-drawn crossings (walls, centre planes, corners, axes, faces,
  diagonals, exact edge and corner ties, landings on a face the ray runs
  along), from an ancestor of both leaves at the levels it reports.
- The kernel's octree crossing (``kKind = 3``) against the plain walk on
  the card (marked cuda, skipped here), on the SPH tree and on the clumped
  tree, with lanes that start in the leaves beside the root's faces."""


import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from hyperion_tpu.transport.gtable_octree import \
    build_octree_geometry as j_geometry
from hyperion_tpu.transport.imaging import escape_tau_walk as j_tau_walk
from hyperion_tpu.transport.raytrace import \
    escape_column_walk as j_column_walk
from hyperion_tpu.transport.raytrace import \
    sample_position_in_cell as j_position
from hyperion_tpu_torch.convert import _octree_from_numpy
from hyperion_tpu_torch.grid import OctreeGrid
from hyperion_tpu_torch.importers import construct_octree
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.escape_tau import (EscapeTau,
                                                     escape_column_reference,
                                                     escape_tau_reference,
                                                     kernel_tables)
from hyperion_tpu_torch.transport.gtable_octree import (
    RECORD_CHILDREN, RECORD_LEAVES, RECORD_PARENT, RECORD_WALLS,
    RECORD_WORDS, build_octree_geometry)
from hyperion_tpu_torch.transport.lucy import run_lucy
from hyperion_tpu_torch.transport.raytrace import sample_position_in_cell
from hyperion_tpu_torch.transport.stable import build_source_tables
from test_torch_frontend import frontend

torch.set_num_threads(1)
CPU = torch.device('cpu')
F64 = torch.float64
RTOL = 1e-12


def cloud(n, seed, scale=1.0):
    """Clustered particles inside the cube of half-width ``scale``: 80% in
    a Plummer sphere of radius 0.2 scale, 20% in 10 Gaussian clumps of
    sigma 0.02 scale whose centres are drawn from N(0, 0.2 scale) per axis
    (chip_smoke.py's config 4 at 2 scale = 1 pc)."""
    rng = np.random.default_rng(seed)
    n_pl = int(0.8 * n)
    r = 0.2 * scale / np.sqrt(rng.uniform(0, 1, n_pl) ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(3, n_pl))
    pl = v / np.linalg.norm(v, axis=0) * r
    centres = rng.normal(0.0, 0.2 * scale, (3, 10))
    cl = np.repeat(centres, (n - n_pl) // 10, axis=1) + \
        rng.normal(0.0, 0.02 * scale, (3, (n - n_pl) // 10 * 10))
    p = np.concatenate([pl, cl], axis=1)
    return p[:, (np.abs(p) < scale).all(axis=0)]


def sph_tree(package, n=2000, n_ref=16, seed=7, method='exact'):
    """An OctreeGrid from ``construct_octree`` of either package over the
    cube of half-width 1 around the origin."""
    if package == 'jax':
        from hyperion_tpu.importers import construct_octree as build
    else:
        build = construct_octree
    p = cloud(n, seed)
    sigma = np.full(p.shape[1], 0.03)
    mass = np.full(p.shape[1], 1.0 / p.shape[1])
    return build(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, *p, sigma, mass, n_ref=n_ref,
                 method=method)


def clumped_tree(n=3000, n_ref=2, seed=11):
    """A port ``construct_octree`` tree over a cloud in one octant of the
    root cube (the cloud of half-width 0.5 moved by 0.45 on each axis):
    leaves at every depth from 1 to the tree's 10."""
    p = cloud(n, seed, scale=0.5) + 0.45
    sigma = np.full(p.shape[1], 0.03)
    mass = np.full(p.shape[1], 1.0 / p.shape[1])
    return construct_octree(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, *p, sigma, mass,
                            n_ref=n_ref, method='exact')


def node_depths(pg):
    """(n_nodes,) int64: each node's levels below the root."""
    parent = pg.parents
    depth = torch.zeros(pg.n_nodes, dtype=torch.int64)
    for _ in range(pg.max_depth):
        depth = torch.where(parent >= 0, depth[parent.clamp_min(0)] + 1,
                            depth)
    return depth


def two_level(package='port', scale=1.0):
    """tests/test_octree.py's tree: the root and its first child refined."""
    refined = np.array([True, True] + [False] * 15, bool)
    if package == 'jax':
        from hyperion_tpu.grid import OctreeGrid as JGrid
        return JGrid(0.0, 0.0, 0.0, scale, scale, scale, refined)
    return OctreeGrid(0.0, 0.0, 0.0, scale, scale, scale, refined)


def _rays(pg, n=10000, seed=41):
    """Positions (3, n) and unit directions (3, n) in engine units on the
    port's CPU float64 geometry ``pg``: a sixth of the points on a leaf's
    wall, a sixth on a refined node's centre plane, a ninth at a leaf's
    corner, the rest anywhere in the root box; directions along an axis,
    parallel to a face (one component 0), along a diagonal, or any."""
    rng = np.random.default_rng(seed)
    lo, hi = pg.lo.numpy(), pg.hi.numpy()
    c = pg.centers.numpy()
    refined = pg.refined.numpy()
    leaves = np.where(~refined)[0]
    nodes = np.where(refined)[0]
    pos = rng.uniform(lo[0], hi[0], (n, 3)).T.copy()
    kind = rng.integers(0, 9, n)
    axis = rng.integers(0, 3, n)
    leaf = rng.choice(leaves, n)
    node = rng.choice(nodes, n)
    side = rng.integers(0, 2, (n, 3)).astype(bool)
    on_wall = np.where(side[:, 0], hi[leaf, axis], lo[leaf, axis])
    for a in range(3):
        pos[a] = np.where((kind <= 1) & (axis == a), on_wall, pos[a])
        pos[a] = np.where((kind >= 2) & (kind <= 3) & (axis == a),
                          c[node, a], pos[a])
        pos[a] = np.where(kind == 4, np.where(side[:, a], hi[leaf, a],
                                              lo[leaf, a]), pos[a])
    k = rng.normal(size=(3, n))
    style = rng.integers(0, 8, n)
    for a in range(3):
        along = np.zeros((3, 1))
        along[a] = 1.0
        sel = (style == 0) & (axis == a)
        k[:, sel] = along * rng.choice([-1.0, 1.0], sel.sum())
        k[a, (style == 1) & (axis == a)] = 0.0
    diag = style == 2
    k[:, diag] = rng.choice([-1.0, 1.0], (3, diag.sum()))
    k /= np.linalg.norm(k, axis=0)
    return pos, k


def _planes(pg):
    """Sorted node planes per axis: every centre and wall coordinate."""
    return [np.unique(np.concatenate([pg.centers[:, a].numpy(),
                                      pg.lo[:, a].numpy(),
                                      pg.hi[:, a].numpy()]))
            for a in range(3)]


def _near_plane(planes, v, tol=1e-9):
    i = np.clip(np.searchsorted(planes, v), 1, len(planes) - 1)
    return np.minimum(np.abs(v - planes[i - 1]), np.abs(v - planes[i])) < tol


def _pair(tree_args=None, dtype=64):
    jdt, tdt = (jnp.float64, F64) if dtype == 64 else \
        (jnp.float32, torch.float32)
    args = tree_args or {}
    return (j_geometry(sph_tree('jax', **args), dtype=jdt),
            build_octree_geometry(sph_tree('port', **args), CPU, tdt))


@pytest.mark.parametrize('precision', [64, 32])
def test_octree_tables_equal_jax(precision):
    """The centres, half-widths, children, refined flags and volumes equal
    the JAX tables; each node's walls are copies of its parent's centre
    and bounds (exact in the tables' type), and the depth is the tree's."""
    jg, pg = _pair(dtype=precision)
    for name in ('centers', 'halves', 'children', 'refined', 'volumes'):
        np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert pg.n_nodes == jg.n_nodes and pg.length_scale == jg.length_scale
    c, lo, hi = (a.numpy() for a in (pg.centers, pg.lo, pg.hi))
    ch = pg.children.numpy()
    for p in np.where(pg.refined.numpy())[0]:
        for k in range(8):
            bits = np.array([k & 1, (k >> 1) & 1, (k >> 2) & 1], bool)
            np.testing.assert_array_equal(lo[ch[p, k]],
                                          np.where(bits, c[p], lo[p]))
            np.testing.assert_array_equal(hi[ch[p, k]],
                                          np.where(bits, hi[p], c[p]))
    # the walls are the centre plus or minus the half-width, to rounding
    np.testing.assert_allclose(lo, c - pg.halves.numpy(), rtol=0,
                               atol=4 * np.finfo(lo.dtype).eps)
    # every leaf is reached within the depth
    assert 4 <= pg.max_depth <= jg.max_depth


def test_octree_geometry_matches_jax():
    """find_cell, in_cell_tol and closest_wall_distance on the same rays;
    find_wall's distance and next leaf (module docstring)."""
    jg, pg = _pair()
    pos, k = _rays(pg)
    jpos, jk = [jnp.asarray(a) for a in pos], [jnp.asarray(a) for a in k]
    tpos, tk = [torch.as_tensor(a) for a in pos], [torch.as_tensor(a)
                                                   for a in k]
    cell_j = np.asarray(jg.find_cell(*jpos, *jk))
    cell_p = pg.find_cell(*tpos, *tk)
    np.testing.assert_array_equal(cell_p.numpy(), cell_j)
    inside = cell_j >= 0
    assert inside.sum() > 9000 and (~inside).sum() > 20
    assert not pg.refined[cell_p[torch.as_tensor(inside)]].any()

    sel = np.where(inside)[0]
    args_j = [a[sel] for a in jpos] + [a[sel] for a in jk]
    args_p = [a[sel] for a in tpos] + [a[sel] for a in tk]
    cj, cp = jnp.asarray(cell_j[sel]), cell_p[sel]
    np.testing.assert_array_equal(
        pg.in_cell_tol(cp, *args_p[:3]).numpy(),
        np.asarray(jg.in_cell_tol(cj, *args_j[:3])))
    np.testing.assert_allclose(
        pg.closest_wall_distance(cp, *args_p[:3]).numpy(),
        np.asarray(jg.closest_wall_distance(cj, *args_j[:3])), rtol=0,
        atol=1e-15)
    t_j, next_j, _, _ = jg.find_wall(cj, *args_j)
    t_p, next_p, ax, wall = pg.find_wall(cp, *args_p)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=RTOL,
                               atol=0)
    next_j, next_p = np.asarray(next_j), next_p.numpy()
    # the port never relocates into the same leaf
    assert (next_p != cp.numpy()).all()
    # the exit point, and whether it lies near a second plane
    exit_ = [(pos[a][sel] + t_p.numpy() * k[a][sel]) for a in range(3)]
    planes = _planes(pg)
    edge = np.zeros(len(sel), bool)
    for a in range(3):
        edge |= (ax.numpy() != a) & _near_plane(planes[a], exit_[a])
    compare = (next_j != cell_j[sel]) & ~edge
    assert compare.mean() > 0.8
    np.testing.assert_array_equal(next_p[compare], next_j[compare])
    # at an edge or corner the port's next leaf holds the exit point
    moved = pg.snap(*[torch.as_tensor(a) for a in exit_], ax, wall,
                    torch.ones(len(sel), dtype=torch.bool))
    into = torch.as_tensor(next_p)
    ok = into >= 0
    assert pg.in_cell_tol(into[ok], *[m[ok] for m in moved], tol=1e-9).all()


def test_corner_and_parallel_crossings():
    """Rays from a leaf's corner along a diagonal, and rays on a wall or a
    centre plane parallel to it: each crossing enters another leaf that
    holds the landing point, and every walk escapes."""
    pg = build_octree_geometry(sph_tree('port'), CPU, F64)
    pos, k = _rays(pg, n=6000, seed=3)
    x, y, z = (torch.as_tensor(a) for a in pos)
    kx, ky, kz = (torch.as_tensor(a) for a in k)
    cell = pg.find_cell(x, y, z, kx, ky, kz)
    active = cell >= 0
    corner_diag = torch.as_tensor(
        (np.abs(np.abs(k) - 1 / np.sqrt(3)) < 1e-12).all(axis=0))
    parallel = torch.as_tensor((k == 0).any(axis=0))
    assert (corner_diag & active).sum() > 200
    assert (parallel & active).sum() > 500
    for _ in range(400):
        if not active.any():
            break
        t, nxt, ax, wall = pg.find_wall(cell.clamp_min(0), x, y, z, kx, ky,
                                        kz)
        assert not (active & (nxt == cell)).any()
        x, y, z = pg.snap(x + t * kx, y + t * ky, z + t * kz, ax, wall,
                          active)
        cell = torch.where(active, nxt, cell)
        active = active & (cell >= 0)
        if active.any():
            assert pg.in_cell_tol(cell[active], x[active], y[active],
                                  z[active], tol=1e-9).all()
    assert not active.any()


def _records_geometry(source):
    """The geometry whose node records a test reads: the SPH tree of
    :func:`sph_tree` (float64 or float32), :func:`clumped_tree`, or the SPH
    tree carried from the JAX package's tables."""
    if source == 'jax_tables':
        jg = j_geometry(sph_tree('jax'), dtype=jnp.float64)
        return _octree_from_numpy({f.name: np.asarray(getattr(jg, f.name))
                                   for f in dataclasses.fields(jg)}, CPU, F64)
    tree = clumped_tree() if source == 'clumped' else sph_tree('port')
    return build_octree_geometry(
        tree, CPU, torch.float32 if source == 'sph_f32' else F64)


@pytest.mark.parametrize('source', ['sph', 'sph_f32', 'clumped',
                                    'jax_tables'])
def test_node_records(source):
    """What EscapeTau binds on an octree (escape_tau.kernel_tables): the
    node records in w[0], one of RECORD_WORDS float64 words a node (the
    kernel's kRecordWords), and the root's box in w[1]. Each record holds
    its node's centre and walls to the bit, its parent (-1 for the root),
    its children and the mask of those that are leaves; the pads are
    zero."""
    from pathlib import Path
    pg = _records_geometry(source)
    kind, walls, ints, sizes, aux, *_ = kernel_tables(pg)
    assert kind == 3 and ints is None and aux == pg.max_depth
    assert sizes == (pg.n_nodes, 1, 1)
    assert walls[0].data_ptr() == pg.node_records.data_ptr()
    src = (Path(__file__).resolve().parent.parent / 'hyperion_tpu_torch' /
           'transport' / 'csrc' / 'escape_tau.cu').read_text()
    assert 'constexpr int kRecordWords = %d;' % RECORD_WORDS in src
    rec = walls[0].numpy().reshape(pg.n_nodes, RECORD_WORDS)
    words = rec.view(np.int32)
    lo, hi, c = (a.double().numpy() for a in (pg.lo, pg.hi, pg.centers))
    for got, want in ((rec[:, 0:3], c),
                      (rec[:, RECORD_WALLS:RECORD_WALLS + 3], lo),
                      (rec[:, RECORD_WALLS + 3:RECORD_WALLS + 6], hi),
                      (walls[1].numpy(), np.concatenate([lo[0], hi[0]]))):
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))
    children = pg.children.numpy()
    refined = pg.refined.numpy()
    parent = np.full(pg.n_nodes, -1)
    for p in np.where(refined)[0]:
        parent[children[p]] = p
    np.testing.assert_array_equal(words[:, RECORD_PARENT], parent)
    np.testing.assert_array_equal(
        words[:, RECORD_CHILDREN:RECORD_CHILDREN + 8], children)
    leaf = (children >= 0) & ~refined[np.maximum(children, 0)]
    np.testing.assert_array_equal(words[:, RECORD_LEAVES],
                                  (leaf << np.arange(8)).sum(axis=1))
    assert not words[~refined, RECORD_LEAVES].any()
    assert not rec[:, RECORD_WALLS + 6:].any()
    if source == 'clumped':
        # leaves at every depth from 1 to the tree's
        depth = node_depths(pg).numpy()
        assert set(depth[~refined]) == set(range(1, pg.max_depth + 1))


_HOST_TREES = {}


def _host_tree(which, dtype=F64):
    if (which, dtype) not in _HOST_TREES:
        _HOST_TREES[which, dtype] = build_octree_geometry(
            clumped_tree() if which == 'clumped' else sph_tree('port'), CPU,
            dtype)
    return _HOST_TREES[which, dtype]


def _crossing_starts(pg, style, seed, n=64):
    """Starts and directions (3, n) on ``pg``, and the leaves they start
    in (None: those that hold them): those of :func:`_rays` ('rays');
    starts at an exact distance from a leaf's corner or edge, heading for
    it along dyadic directions, so that two or three box distances tie
    exactly ('tie'); starts on a leaf's face with the direction along it,
    one component or two exactly 0 ('along'); or starts a hair past a
    leaf's face, given to that leaf, along the face or moving back in, so
    that the landing point lies off the leaf's box ('off', as rounding
    leaves a lane after a diagonal move)."""
    if style == 'rays':
        return _rays(pg, n=n, seed=seed) + (None,)
    rng = np.random.default_rng(seed)
    lo, hi = pg.lo.numpy(), pg.hi.numpy()
    leaf = rng.choice(np.where(~pg.refined.numpy())[0], n)
    lo, hi = lo[leaf].T, hi[leaf].T
    width = hi - lo
    if style == 'off':
        pos = lo + width * rng.uniform(0.05, 0.95, (3, n))
        k = rng.normal(size=(3, n))
        face = rng.integers(0, 3, n)
        up = rng.integers(0, 2, n).astype(bool)
        for a in range(3):
            on = face == a
            pos[a, on] = np.where(up, np.nextafter(hi[a], np.inf),
                                  np.nextafter(lo[a], -np.inf))[on]
            k[a, on] = np.where(up, -1.0, 1.0)[on] * np.abs(k[a, on]) * \
                (rng.random(on.sum()) < 0.5)
        return pos, k / np.linalg.norm(k, axis=0), leaf
    if style == 'tie':
        up = rng.integers(0, 2, (3, n)).astype(bool)
        corner = np.where(up, hi, lo)
        k = rng.choice([0.25, 0.5, 1.0], (3, n)) * np.where(up, 1.0, -1.0)
        # an edge: one axis does not move, its start a quarter, half or
        # three quarters across
        edge = rng.random(n) < 0.4
        still = rng.integers(0, 3, n)
        for a in range(3):
            k[a, edge & (still == a)] = 0.0
        s = width.min(axis=0) * rng.choice([0.25, 0.5, 0.75], n)
        pos = corner - s * k
        frac = lo + width * rng.choice([0.25, 0.5, 0.75], (3, n))
        return np.where(k == 0.0, frac, pos), k, None
    pos = lo + width * rng.uniform(0.0, 1.0, (3, n))
    k = rng.normal(size=(3, n))
    face = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n).astype(bool)
    second = rng.random(n) < 0.3
    for a in range(3):
        on = face == a
        pos[a, on] = np.where(side, hi[a], lo[a])[on]
        k[a, on] = 0.0
        k[a, second & (face == (a + 1) % 3)] = 0.0
    return pos, k / np.linalg.norm(k, axis=0), None


def _ancestor(pg, node, levels):
    """The ancestor ``levels`` above each node."""
    for i in range(pg.max_depth):
        node = torch.where(levels > i, pg.parents[node], node)
    return node


def _first_holder(pg, leaf, x, y, z, kx, ky, kz):
    """The first ancestor of each leaf that holds the point by its walls
    (``holds``), the root at most."""
    node = pg.parents[leaf].clamp_min(0)
    for _ in range(pg.max_depth):
        climb = ~pg.holds(node, x, y, z, kx, ky, kz) & \
            (pg.parents[node] >= 0)
        node = torch.where(climb, pg.parents[node], node)
    return node


@pytest.mark.parametrize('dtype', [F64, torch.float32], ids=['f64', 'f32'])
@settings(max_examples=150, deadline=None, database=None)
@given(which=st.sampled_from(['sph', 'clumped']),
       style=st.sampled_from(['rays', 'tie', 'along', 'off']),
       seed=st.integers(0, 2 ** 32 - 1))
def test_walk_up_finds_the_root_descends_leaf(dtype, which, style, seed):
    """The host copy of the kernel's locate (locate_from: up from the leaf
    to the first ancestor that holds the landing point under the descend's
    side rule, told by the centres it reads, then down) gives, at the
    landing point of each crossing, the leaf of the descend from the root
    (find_wall's next leaf where the point is inside the root box), never
    the leaf it left. The ancestor it climbs to is the first that holds
    the point by its walls (``holds``) where the point lies on the leaf's
    box, and lies the levels it reports above both leaves, so it descends
    no more levels than the root descend. In float64 (the walk kernel's
    type) and with float32 tables and lanes (the steps' type, in which
    find_wall computes its landing point)."""
    pg = _host_tree(which, dtype)
    pos, k, start = _crossing_starts(pg, style, seed)
    t = [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
         for a in (*pos, *k)]
    cell = pg.find_cell(*t) if start is None else torch.as_tensor(start)
    keep = cell >= 0
    t = [a[keep] for a in t]
    cell = cell[keep]
    assert len(cell) > 0
    dist, nxt, ax, wall = pg.find_wall(cell, *t)
    land = pg.snap(*(p + dist * d for p, d in zip(t[:3], t[3:])), ax, wall,
                   torch.ones_like(keep[keep]))
    leaf, up, down = pg.locate_from(cell, *land, *t[3:])
    assert torch.equal(leaf, pg._descend(*land, *t[3:]))
    inside = nxt >= 0
    assert torch.equal(leaf[inside], nxt[inside])
    assert not (leaf[inside] == cell[inside]).any()
    assert (up >= 1).all()
    top = _ancestor(pg, cell, up)
    assert torch.equal(top, _ancestor(pg, leaf, down))
    assert (down <= node_depths(pg)[leaf]).all()
    lo, hi = pg.lo[cell], pg.hi[cell]
    on_box = ((torch.stack(land, dim=1) >= lo) &
              (torch.stack(land, dim=1) <= hi)).all(dim=1)
    assert style != 'off' or not on_box.all()
    first = _first_holder(pg, cell, *land, *t[3:])
    assert torch.equal(top[on_box], first[on_box])


def test_walk_up_reads_fewer_levels_than_the_root_descend():
    """Over whole walks on the clumped tree (the rays of :func:`_rays`),
    the host copy of the kernel's locate reads fewer node records a
    crossing, up and down, than the descend from the root has levels (3.4
    against 4.3), and three crossings in four climb at most the two levels
    whose records the kernel loads before the box exit."""
    pg = _host_tree('clumped')
    pos, k = _rays(pg, n=4000, seed=17)
    x, y, z, kx, ky, kz = (torch.as_tensor(a) for a in (*pos, *k))
    cell = pg.find_cell(x, y, z, kx, ky, kz)
    active = cell >= 0
    depth = node_depths(pg)
    ups, downs, roots = [], [], []
    while bool(active.any()):
        c = cell[active]
        t, nxt, ax, wall = pg.find_wall(c, x[active], y[active], z[active],
                                        kx[active], ky[active], kz[active])
        lx, ly, lz = pg.snap(x[active] + t * kx[active],
                             y[active] + t * ky[active],
                             z[active] + t * kz[active], ax, wall,
                             torch.ones_like(c, dtype=torch.bool))
        leaf, up, down = pg.locate_from(c, lx, ly, lz, kx[active],
                                        ky[active], kz[active])
        inside = nxt >= 0
        assert torch.equal(leaf[inside], nxt[inside])
        ups.append(up[inside])
        downs.append(down[inside])
        roots.append(depth[nxt[inside]])
        x[active], y[active], z[active] = lx, ly, lz
        cell[active] = nxt
        active = cell >= 0
    up, down, root = torch.cat(ups), torch.cat(downs), torch.cat(roots)
    assert len(up) > 10000
    assert (up + down).sum() < root.sum()
    assert (up <= 2).float().mean() > 0.75


def _uniform_inputs(pg, pos, k, rho_phys=0.8, chi=1.5):
    density = np.full((1, pg.n_nodes), rho_phys * pg.length_scale)
    density[0, pg.refined.numpy()] = 0.0
    return density, np.full((pos.shape[1], 1), chi)


def test_uniform_density_chord_oracle():
    """tests/test_octree.py:67-102 on the port's plain walk, from the rays
    of :func:`_rays` too (walls, centre planes, corners): tau = chi rho
    times the chord to the root's faces, rtol 1e-8."""
    pg = build_octree_geometry(two_level(), CPU, F64)
    rng = np.random.RandomState(3)
    n = 1500
    pts = rng.uniform(-0.9, 0.9, (3, n)) / pg.length_scale
    dirs = rng.normal(size=(3, n))
    dirs /= np.linalg.norm(dirs, axis=0)
    more, kmore = _rays(pg, n=3000, seed=5)
    pts, dirs = np.hstack([pts, more]), np.hstack([dirs, kmore])
    t = [torch.as_tensor(a) for a in (*pts, *dirs)]
    cell = pg.find_cell(*t)
    inside = (cell >= 0).numpy()
    assert inside[:n].all() and inside.sum() > 4000
    density, chi = _uniform_inputs(pg, pts, dirs)
    tau = escape_tau_reference(
        pg, torch.as_tensor(density.T.copy()), torch.as_tensor(chi), *t[:3],
        *[a[None] for a in t[3:]], cell.clamp_min(0),
        torch.as_tensor(inside))[0].numpy()
    half = 0.5
    ts = []
    for a in range(3):
        with np.errstate(divide='ignore', invalid='ignore'):
            ts.append(np.where(dirs[a] > 0, (half - pts[a]) / dirs[a],
                               np.where(dirs[a] < 0,
                                        (-half - pts[a]) / dirs[a], np.inf)))
    chord = np.min(ts, axis=0)
    expected = 1.5 * 0.8 * pg.length_scale * chord
    np.testing.assert_allclose(tau[inside], expected[inside], rtol=1e-8,
                               atol=1e-12)


def _face_rays(pg, n, seed):
    """Positions (3, n) in the leaves beside the root's faces (a third of
    them on the face itself) and any unit directions (3, n)."""
    rng = np.random.default_rng(seed)
    lo, hi = pg.lo.numpy(), pg.hi.numpy()
    face = ((lo == lo[0]) | (hi == hi[0])).any(axis=1) & \
        ~pg.refined.numpy()
    leaf = rng.choice(np.where(face)[0], n)
    pos = (lo[leaf] + (hi[leaf] - lo[leaf]) * rng.uniform(0, 1, (n, 3))).T
    axis = rng.integers(0, 3, n)
    on = rng.random(n) < 1 / 3
    for a in range(3):
        sel = on & (axis == a)
        pos[a, sel] = np.where(lo[leaf, a] == lo[0, a], lo[0, a],
                               hi[0, a])[sel]
    k = rng.normal(size=(3, n))
    return pos.copy(), k / np.linalg.norm(k, axis=0)


def _walk_inputs(pg, n=3000, n_dust=2, seed=43, generic=True, faces=False):
    """Rays on the port's CPU float64 geometry ``pg`` (any points and
    directions, with ``generic`` False those of :func:`_rays`, with
    ``faces`` those of :func:`_face_rays`), their cells, lanes and a
    density: made with the port alone (the card's machine has no h5py,
    which the JAX package's front end imports)."""
    rng = np.random.default_rng(seed + 1)
    if faces:
        pos, k = _face_rays(pg, n, seed)
    elif generic:
        lo, hi = pg.lo[0].numpy(), pg.hi[0].numpy()
        pos = rng.uniform(lo, hi, (n, 3)).T.copy()
        k = rng.normal(size=(3, n))
        k /= np.linalg.norm(k, axis=0)
    else:
        pos, k = _rays(pg, n=n, seed=seed)
    cell = pg.find_cell(*[torch.as_tensor(a) for a in (*pos, *k)]).numpy()
    active = (cell >= 0) & (rng.random(n) < 0.9)
    density = rng.uniform(0.0, 3.0, (n_dust, pg.n_cells))
    density[:, rng.random(pg.n_cells) < 0.1] = 0.0
    density[:, pg.refined.numpy()] = 0.0
    chi = rng.uniform(0.5, 2.0, (n, n_dust))
    t_max = np.where(rng.random(n) < 0.3, rng.uniform(0.0, 1.0, n), np.inf)
    return pos, k, np.maximum(cell, 0), active, density, chi, t_max


@pytest.mark.parametrize('limited', [False, True],
                         ids=['unlimited', 'limited'])
def test_plain_walks_match_jax(limited):
    """The port's plain tau and column walks against JAX's
    ``escape_tau_walk`` and ``escape_column_walk`` on the same rays (any
    points, any directions), float64 to rtol 1e-12, with and without a
    distance limit."""
    jg, pg = _pair()
    pos, k, cell, active, density, chi, t_max = _walk_inputs(pg)
    assert active.sum() > 2500
    tm = t_max if limited else None
    jargs = [jnp.asarray(a) for a in (*pos, *k)]
    tau_j = np.asarray(j_tau_walk(
        jg, jnp.asarray(density), jnp.asarray(chi), *jargs,
        jnp.asarray(cell), jnp.asarray(active),
        t_max=None if tm is None else jnp.asarray(tm)))
    col_j = np.asarray(j_column_walk(
        jg, jnp.asarray(density), *jargs, jnp.asarray(cell),
        jnp.asarray(active), t_max=None if tm is None else jnp.asarray(tm)))
    t = [torch.as_tensor(a) for a in (*pos, *k)]
    rho_t = torch.as_tensor(density.T.copy())
    lanes = dict(cell=torch.as_tensor(cell), active=torch.as_tensor(active),
                 t_max=None if tm is None else torch.as_tensor(tm)[None])
    tau_p = escape_tau_reference(pg, rho_t, torch.as_tensor(chi), *t[:3],
                                 *[a[None] for a in t[3:]], **lanes)[0]
    col_p = escape_column_reference(pg, rho_t, *t[:3],
                                    *[a[None] for a in t[3:]], **lanes)[0]
    assert (tau_j > 0).sum() > 2000
    np.testing.assert_allclose(tau_p.numpy(), tau_j, rtol=RTOL, atol=0)
    np.testing.assert_allclose(col_p.numpy(), col_j, rtol=RTOL, atol=0)


def cells_walked(geo, x, y, z, kx, ky, kz, cell, active, t_max=None):
    """Each cell's count of crossings through it, found by stepping the
    geometry's ``find_wall`` and ``snap`` (one view, float64)."""
    counts = torch.zeros(geo.n_cells, dtype=torch.int64)
    remaining = t_max
    while bool(active.any()):
        counts += torch.bincount(cell[active], minlength=geo.n_cells)
        t, nxt, ax, wall = geo.find_wall(cell, x, y, z, kx, ky, kz)
        x, y, z = geo.snap(x + t * kx, y + t * ky, z + t * kz, ax, wall,
                           active)
        cell = torch.where(active & (nxt >= 0), nxt, cell)
        active = active & (nxt >= 0)
        if remaining is not None:
            remaining = remaining - t
            active = active & (remaining > 0.0)
    return counts


@pytest.mark.parametrize('limited', [False, True],
                         ids=['unlimited', 'limited'])
def test_reference_visits_count_the_cells_walked(limited):
    """The plain walks' ``visits`` (what chip_smoke.py's bounds count the
    locates from): each crossing adds one at the cell it walks through,
    the same in the tau and the column walk, as many as the crossings, none
    in a refined node."""
    _, pg = _pair()
    pos, k, cell, active, density, chi, t_max = _walk_inputs(pg, n=600)
    t = [torch.as_tensor(a) for a in (*pos, *k)]
    rho_t = torch.as_tensor(density.T.copy())
    tm = torch.as_tensor(t_max) if limited else None
    lanes = dict(cell=torch.as_tensor(cell), active=torch.as_tensor(active),
                 t_max=None if tm is None else tm[None])
    v_tau = torch.zeros(pg.n_cells, dtype=torch.int64)
    v_col = torch.zeros(pg.n_cells, dtype=torch.int64)
    _, n_cross = escape_tau_reference(
        pg, rho_t, torch.as_tensor(chi), *t[:3], *[a[None] for a in t[3:]],
        **lanes, crossings=True, visits=v_tau)
    escape_column_reference(pg, rho_t, *t[:3], *[a[None] for a in t[3:]],
                            **lanes, visits=v_col)
    ref = cells_walked(pg, *t, torch.as_tensor(cell),
                       torch.as_tensor(active), tm)
    assert int(v_tau.sum()) == int(n_cross.sum()) > 600
    np.testing.assert_array_equal(v_tau.numpy(), ref.numpy())
    np.testing.assert_array_equal(v_col.numpy(), ref.numpy())
    assert not v_tau[pg.refined].any()


def test_float32_walk_never_stalls():
    """The witness of the recorded difference (module docstring): on a
    20,000-particle clustered tree with n_ref 32, 4,000 rays from particle
    positions in random directions walk the float32 geometry with the
    port's find_wall and snap: no crossing relocates into the same leaf,
    every ray escapes within 1,000 crossings, and each lands in the leaf
    that holds it."""
    p = cloud(20000, 1234)
    grid = construct_octree(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, *p,
                            np.full(p.shape[1], 0.02),
                            np.full(p.shape[1], 1.0 / p.shape[1]), n_ref=32,
                            method='mc', mc_samples=1)
    pg = build_octree_geometry(grid, CPU, torch.float32)
    assert pg.n_nodes > 2000 and pg.max_depth >= 6
    rng = np.random.default_rng(5)
    pick = rng.integers(0, p.shape[1], 4000)
    x, y, z = (torch.as_tensor((p[a, pick] / pg.length_scale)
                               .astype(np.float32)) for a in range(3))
    k = rng.normal(size=(3, 4000))
    k /= np.linalg.norm(k, axis=0)
    kx, ky, kz = (torch.as_tensor(a.astype(np.float32)) for a in k)
    cell = pg.find_cell(x, y, z, kx, ky, kz)
    active = cell >= 0
    assert active.all()
    same = crossings = 0
    for _ in range(1000):
        t, nxt, ax, wall = pg.find_wall(cell.clamp_min(0), x, y, z, kx, ky,
                                        kz)
        same += int((active & (nxt == cell)).sum())
        crossings += int(active.sum())
        x, y, z = pg.snap(x + t * kx, y + t * ky, z + t * kz, ax, wall,
                          active)
        cell = torch.where(active, nxt, cell)
        active = active & (cell >= 0)
        if active.any():
            assert pg.in_cell_tol(cell[active], x[active], y[active],
                                  z[active], tol=1e-5).all()
        else:
            break
    assert same == 0
    assert int(active.sum()) == 0
    assert crossings > 20000


def test_position_in_cell_matches_jax():
    """Uniform in a leaf's box from the uniforms JAX draws (its [-1, 1)
    draws are 2u - 1 of the [0, 1) ones), rtol 1e-12; every position lies
    in its leaf."""
    jg, pg = _pair()
    leaves = np.where(~pg.refined.numpy())[0]
    cell = np.random.default_rng(44).choice(leaves, 4000)
    key = jax.random.PRNGKey(45)
    ref = j_position(jg, jnp.asarray(cell), key, jnp.float64)
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, (3, 4000),
                                                      dtype=jnp.float64)))
    port = sample_position_in_cell(pg, torch.as_tensor(cell), u)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-15)
    assert pg.in_cell_tol(torch.as_tensor(cell), *port, tol=1e-9).all()


OCT_POSITIONS = [
    (0.0, 0.0, 0.0),          # the origin: a vertex of the root's children
    (-0.5, -0.5, -0.5),       # a vertex of the refined child's children
    (-0.5, 0.0, 0.3),         # on an edge of the refined child
    (0.5, 0.5, 0.5),          # the centre of a leaf
    (0.0, 0.25, -0.7),        # on a face between two leaves
    (-0.75, -0.25, 0.0),      # on a face of the grandchildren
]


@pytest.mark.parametrize('position', OCT_POSITIONS)
def test_octree_robustness(position):
    """tests/test_propagation.py's zero-killed placements on the two-level
    tree of tests/test_octree.py, through the port's run_lucy with the
    geometry self-check on: no photon killed."""
    P = frontend('port')
    geo = build_octree_geometry(two_level(), CPU, F64)
    dust = P.IsotropicDust(np.logspace(5, 18, 16), np.repeat(0.5, 16),
                           np.repeat(1.0, 16))
    dt = build_dust_tables([dust], CPU, F64)
    src = P.PointSource(luminosity=1.0, temperature=5000.0,
                        position=position)
    st = build_source_tables([src], CPU, F64, length_scale=geo.length_scale)
    density = torch.full((1, geo.n_cells), 0.5 * geo.length_scale,
                         dtype=F64)
    density[0, geo.refined] = 0.0
    res = run_lucy(geo, dt, st, density, torch.Generator().manual_seed(0),
                   n_photons=20000, n_iterations=1, batch_size=4096,
                   check_frequency=0.1, verbose=False)
    assert res.killed_geo == 0
    assert res.killed_int == 0
    assert res.energy_current == 20000.0


# ---- whole runs through both packages ----

def sph_model(package, n=1500, n_photons=6000, n_imaging=2000,
              raytracing=(300, 3000), seed=20261017):
    """A point source in an SPH cloud on an octree (``construct_octree`` of
    either package, n_ref 16), gray HG dust at tau ~ 0.3 through the
    centre; 1 Lucy iteration, then the imaging iteration into SEDs at 0 and
    60 degrees with uncertainties, and raytracing."""
    F = frontend(package)
    if package == 'jax':
        from hyperion_tpu.importers import construct_octree as build
    else:
        build = construct_octree
    scale = 100.0 * F.au
    p = cloud(n, 11, scale)
    mass = np.full(p.shape[1], 1e27 / p.shape[1])
    grid = build(0.0, 0.0, 0.0, scale, scale, scale, *p,
                 np.full(p.shape[1], 0.05 * scale), mass, n_ref=16)
    nu = np.logspace(8, 17, 40)
    dust = F.HenyeyGreensteinDust(nu, np.repeat(0.5, 40),
                                  np.repeat(200.0, 40), np.repeat(0.4, 40),
                                  np.repeat(0.8, 40))
    m = F.Model()
    m.set_octree_grid(0.0, 0.0, 0.0, scale, scale, scale, grid.refined)
    m.add_density_grid(grid['density'][0].array, dust)
    s = m.add_point_source()
    s.luminosity, s.temperature = F.lsun, 6000.0
    s.position = (0.1 * scale, -0.05 * scale, 0.02 * scale)
    sed = m.add_peeled_images(sed=True, image=False)
    sed.set_viewing_angles([0.0, 60.0], [0.0, 30.0])
    sed.set_wavelength_range(12, 0.3, 1000.0)
    sed.set_uncertainties(True)
    m.set_n_initial_iterations(1)
    m.conf.output.output_n_photons = 'last'
    m.set_raytracing(raytracing is not None)
    rt = {} if raytracing is None else dict(raytracing_sources=raytracing[0],
                                            raytracing_dust=raytracing[1])
    m.set_n_photons(initial=n_photons, imaging=n_imaging, **rt)
    m.set_seed(seed)
    return m


def run_both(make, tmp_path, batch_size=2048):
    """Run ``make(pkg)`` through both packages' run_model: {pkg: path}."""
    from hyperion_tpu.model.run import run_model as j_run_model
    from hyperion_tpu_torch.model.run import run_model
    out = {}
    for pkg in ('jax', 'port'):
        m = make(pkg)
        m.write(str(tmp_path / ('%s.rtin' % pkg)))
        path = str(tmp_path / ('%s.rtout' % pkg))
        if pkg == 'jax':
            j_run_model(m, path, batch_size=batch_size)
        else:
            run_model(m, path, device='cpu', batch_size=batch_size)
        out[pkg] = path
    return out


def layout(path):
    """{dataset: (shape, dtype)} of an .rtout, without the input copy."""
    import h5py
    out = {}
    with h5py.File(path, 'r') as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset) and not name.startswith('Input'):
                out[name] = (obj.shape, obj.dtype.str)
        f.visititems(visit)
    return out


def grid_dataset(group, name):
    """A grid quantity of an .rtout iteration group, flat: the dataset
    itself, or an AMR grid's level_*/grid_* datasets in order."""
    if name in group:
        return group[name][()].reshape(-1)
    return np.concatenate([
        group[level][fab][name][()].reshape(-1)
        for level in sorted(group) if level.startswith('level_')
        for fab in sorted(group[level])])


def assert_within_noise(paths, n_sigma=5.0, rtol=0.05):
    """The port's specific energies (cells lit by more than 50 photon
    visits) and peeled SEDs against the JAX package's, within n_sigma of
    both runs' Monte-Carlo noise plus rtol of the larger (the raytraced
    part's own sampling noise), plus 1e-6 of a view's brightest bin; and
    the same .rtout layout."""
    import h5py
    F = frontend('port')
    assert layout(paths['port']) == layout(paths['jax'])
    with h5py.File(paths['jax'], 'r') as fj, \
            h5py.File(paths['port'], 'r') as fp:
        it = 'iteration_00001'
        se_j, se_p = (grid_dataset(f[it], 'specific_energy')
                      for f in (fj, fp))
        n_j, n_p = (grid_dataset(f[it], 'n_photons') for f in (fj, fp))
        assert fp.attrs['killed_photons_geo_initial'] == 0
    lit = (n_j > 50) & (n_p > 50)
    assert lit.sum() > 20
    rel = 1.0 / np.sqrt(np.minimum(n_j, n_p)[lit])
    ratio = se_p[lit] / se_j[lit]
    assert (np.abs(ratio - 1.0) < n_sigma * np.sqrt(2.0) * rel + rtol).all()
    j, p = F.ModelOutput(paths['jax']), F.ModelOutput(paths['port'])
    for inc in range(2):
        sj = j.get_sed(inclination=inc, aperture=-1, uncertainties=True)
        sp = p.get_sed(inclination=inc, aperture=-1, uncertainties=True)
        assert np.isfinite(sp.val).all() and (sp.val >= 0).all()
        assert (sp.val > 0).sum() > 0.8 * len(sp.val)
        tol = n_sigma * np.hypot(sj.unc, sp.unc) + \
            rtol * np.maximum(sj.val, sp.val) + 1e-6 * sj.val.max()
        assert (np.abs(sp.val - sj.val) <= tol).all(), (inc, sp.val / sj.val)


def test_lucy_imaging_raytracing_within_noise_of_jax(tmp_path):
    """A Lucy iteration, the imaging iteration and raytracing on an SPH
    octree through both packages' run_model (:func:`sph_model`): within
    noise of each other (:func:`assert_within_noise`)."""
    assert_within_noise(run_both(sph_model, tmp_path))


def pda_then_monochromatic(model):
    """Run ``model`` on the CPU through run_lucy_model with the PDA on in
    its Lucy iteration, then as a monochromatic run from the specific
    energy it found (source and dust photons at 100 um; the dust photons
    start at uniform points in their cells; each pass capped at 30 steps):
    nothing killed but at the cap, the SEDs finite, light > 0."""
    from hyperion_tpu_torch.model import run_lucy_model
    model.set_pda(True)
    run = run_lucy_model(model, device='cpu', batch_size=2048)
    res = run.result
    assert res.killed_geo == 0 and res.killed_int == 0
    assert np.isfinite(res.temperature).all()
    grid = model.grid
    se = res.specific_energy
    if hasattr(grid, 'levels'):
        pos = 0
        for level in grid.levels:
            for g in level.grids:
                n = g.nx * g.ny * g.nz
                g.quantities['specific_energy'] = [
                    se[0, pos:pos + n].reshape(g.nz, g.ny, g.nx)]
                pos += n
    else:
        grid.quantities['specific_energy'] = [se[0]]
    model.set_n_initial_iterations(0)
    model.set_pda(False)
    model.set_monochromatic(True, wavelengths=[100.0])
    for group in model.peeled_output:
        group.set_wavelength_index_range(0, 0)
    model.set_n_photons(initial=0, imaging_sources=500, imaging_dust=500)
    # (each pass capped at 30 steps: a thick core's diffusion tail is long
    # on the CPU; lanes alive at the cap are killed and counted)
    mono = run_lucy_model(model, device='cpu', batch_size=2048,
                          imaging_max_steps=30)
    seds = mono.imaging.peeled[0]['datasets']['seds'][0]
    assert mono.imaging.killed_int == 0 or mono.imaging.n_steps >= 30
    assert np.isfinite(seds).all() and (seds >= 0).all()
    assert seds[0].sum() > 0
    return run, mono


def test_pda_and_monochromatic_run_on_the_octree():
    """The PDA (its octree tables), MRW-free Lucy steps and the
    monochromatic iteration, dust photons placed by the leaves'
    positions, on a thick SPH octree (:func:`pda_then_monochromatic`)."""
    m = sph_model("port", n_photons=1500, n_imaging=0, raytracing=None)
    # thick enough that the PDA has cells to fill
    rho = np.asarray(m.grid["density"][0].array) * 30.0
    m.grid['density'] = []
    m.dust = []
    nu = np.logspace(8, 17, 40)
    m.add_density_grid(rho, frontend('port').HenyeyGreensteinDust(
        nu, np.repeat(0.5, 40), np.repeat(200.0, 40), np.repeat(0.4, 40),
        np.repeat(0.8, 40)))
    pda_then_monochromatic(m)


# ---- the kernel on the card (marked cuda: skipped without one) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('tree,rays,limited,dtype', [
    ('sph', 'planes', False, torch.float64),
    ('sph', 'generic', True, torch.float64),
    ('sph', 'planes', False, torch.float32),
    ('sph', 'planes', True, torch.float32),
    ('sph', 'faces', False, torch.float64),
    ('clumped', 'planes', False, torch.float64),
    ('clumped', 'generic', True, torch.float64),
    ('clumped', 'faces', False, torch.float64),
    ('clumped', 'faces', True, torch.float32)],
    ids=['planes', 'limited', 'planes_f32', 'limited_f32', 'faces',
         'clumped_planes', 'clumped_limited', 'clumped_faces',
         'clumped_faces_f32'])
def test_kernel_matches_plain_walk_on_card(tree, rays, limited, dtype,
                                           cuda_device):
    """The octree crossing of escape_tau.cu (tau and column modes) against
    the plain walk on the same rays (on walls, centre planes and corners,
    along axes, parallel to faces and along diagonals; any; or from the
    leaves beside the root's faces), on the SPH tree and on the clumped
    tree (leaves at every depth from 1 to 10): float64 tau to rtol 1e-10
    and columns to 0; float32 lanes equal to their own plain walk."""
    tree = clumped_tree() if tree == 'clumped' else sph_tree('port')
    pos, k, cell, active, density, chi, t_max = _walk_inputs(
        build_octree_geometry(tree, CPU, F64), n=20000,
        generic=rays == 'generic', faces=rays == 'faces')
    pg = build_octree_geometry(tree, cuda_device, F64)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(cuda_device, dt)

    rho_t = dev(density.T)
    walk = EscapeTau(pg, rho_t)
    lanes = [dev(a) for a in pos] + [dev(a)[None] for a in k]
    cellt = dev(cell, torch.int64)
    act = dev(active, torch.bool)
    tm = dev(t_max)[None] if limited else None
    tau = walk(dev(chi), *lanes, cellt, act, t_max=tm)
    col = walk.columns(*lanes, cellt, act, t_max=tm)
    torch.cuda.synchronize()
    ref_tau = escape_tau_reference(pg, rho_t, dev(chi), *lanes, cellt, act,
                                   t_max=tm)
    ref_col = escape_column_reference(pg, rho_t, *lanes, cellt, act,
                                      t_max=tm)
    assert (ref_tau > 0).sum() > 10000
    if dtype == torch.float64:
        np.testing.assert_allclose(tau.cpu().numpy(), ref_tau.cpu().numpy(),
                                   rtol=1e-10, atol=0)
    else:
        np.testing.assert_array_equal(tau.cpu().numpy(),
                                      ref_tau.cpu().numpy())
    np.testing.assert_array_equal(col.cpu().numpy(), ref_col.cpu().numpy())
