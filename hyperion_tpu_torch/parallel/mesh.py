"""Photon-parallel Monte-Carlo passes over the ranks of a
``torch.distributed`` group (counterpart of
``hyperion_tpu/parallel/mesh.py``).

The reference runs ``mpirun -n N``: N processes, each reading the model,
each emitting its share of every pass from its own random stream
(``set_seed(seed + rank)``, mpi_routines.f90:266-270), the physical arrays
and image cubes sum-reduced between passes and rank 0 writing the output.
The port does the same with N processes in one ``torch.distributed`` group
(:mod:`.launch` starts them): each rank runs the single-device pass on its
share of the photons, ``n // N`` and the remainder on rank 0, and the
outputs are sum-reduced (the step counts max-reduced), as the JAX package's
``psum``/``pmax`` over its device mesh. Grid, dust and source tables are
replicated: every rank builds them from the model.

Rank r computes on ``cuda:(r mod device_count)``, or on the CPU when the
caller asks for it. The backend is NCCL where every rank has a card of its
own, gloo otherwise (ranks sharing a card, and every CPU run); under gloo
the helpers here stage CUDA tensors through pinned host memory, since gloo
moves host buffers. A group's collectives go through these helpers, which
count them and their host-clock time in :data:`stats`."""

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device

# the generator streams of a run: each rank's generator of stream k is
# seeded with seed + k * world + rank, so that every (stream, rank) pair
# draws its own sequence and a world of one draws as a single-device run
STREAM_LUCY, STREAM_IMAGING, STREAM_RAYTRACE, STREAM_MONO = range(4)

# the collectives and ring hops since the last reset_stats(): counts, host
# seconds (staging included) and the bytes a hop sends
stats = dict(collectives=0, collective_s=0.0, hops=0, hop_bytes=0,
             hop_s=0.0)


def reset_stats():
    for k in stats:
        stats[k] = 0.0 if k.endswith('_s') else 0


@dataclass(frozen=True)
class Group:
    """A world of ranks. ``rank`` and ``device`` are set inside a launched
    rank (:func:`active_group`); a group without them is the plan that
    :func:`.launch.launch` starts."""
    world: int
    backend: str
    device_type: str
    rank: int = None
    device: torch.device = None

    @property
    def active(self):
        return self.rank is not None


_ACTIVE = None


def active_group():
    """The group this process is a rank of, or None."""
    return _ACTIVE


def _set_active(group):
    global _ACTIVE
    _ACTIVE = group


def world_size(parallel, device):
    """The number of ranks that ``parallel`` asks for: None, False, 0 or 1
    one; True one per card on the card and one on the CPU; an integer that
    many (ranks beyond the cards share them)."""
    if parallel is True:
        return torch.cuda.device_count() if device.type == 'cuda' else 1
    if parallel in (None, False, 0, 1):
        return 1
    n = int(parallel)
    if n < 1:
        raise ValueError("parallel=%r: the number of ranks is >= 1"
                         % (parallel,))
    return n


def backend_for(world, device):
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if device.type == 'cuda' and world <= torch.cuda.device_count():
        return 'nccl'
    return 'gloo'


def rank_device(rank, device_type):
    """The device rank ``rank`` computes on."""
    if device_type == 'cuda':
        return torch.device('cuda', rank % torch.cuda.device_count())
    return torch.device('cpu')


def resolve_group(parallel, device=None):
    """Map the user's ``parallel`` (the ``-m N`` of the launcher) onto a
    group of ranks, or None for the single-device path. Inside a launched
    rank this is the rank's own group."""
    device = resolve_device(device)
    n = world_size(parallel, device)
    if n == 1:
        return None
    if _ACTIVE is not None:
        if _ACTIVE.world != n:
            raise ValueError("parallel=%r inside a world of %d ranks"
                             % (parallel, _ACTIVE.world))
        return _ACTIVE
    return Group(world=n, backend=backend_for(n, device),
                 device_type=device.type)


def share(n, rank, world):
    """This rank's photons of ``n``: ``n // world``, and the remainder on
    rank 0 (the JAX package's split)."""
    return n // world + (n % world if rank == 0 else 0)


def trip_share(n, rank, world):
    """This rank's lanes of a raytracing trip of ``n`` <= batch x world
    photons: ``n // world``, and one more on each of the first ``n % world``
    ranks, so that no rank is given more lanes than its batch holds. (The
    JAX package puts the whole remainder on device 0, which with three or
    more devices can exceed its batch on a last, partial trip: those
    photons are never traced.)"""
    return n // world + (1 if rank < n % world else 0)


def rank_generator(seed, stream, device, group=None):
    """The ``torch.Generator`` of one stream of this rank (seed + stream *
    world + rank; ``seed`` the model's, ``stream`` a ``STREAM_*``)."""
    world, rank = (1, 0) if group is None else (group.world, group.rank)
    g = torch.Generator(device=device)
    g.manual_seed((abs(seed) + stream * world + rank) % (2 ** 31))
    return g


# ------------------------------------------------------------ collectives --

def _staged(group, t):
    """``t`` as the backend takes it: CUDA tensors through pinned host
    memory under gloo."""
    if group.backend == 'gloo' and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host
    return t


def _back(buf, like):
    if buf.device == like.device:
        return buf
    return buf.to(like.device, non_blocking=True)


def _timed(counter):
    def wrap(fn):
        def inner(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            stats[counter + '_s'] += time.perf_counter() - t0
            stats[counter + 's'] += 1
            return out
        inner.__doc__ = fn.__doc__
        inner.__name__ = fn.__name__
        return inner
    return wrap


@_timed('collective')
def all_reduce(group, tensors, op='sum'):
    """Reduce ``tensors`` (one device) over the group, ``op`` 'sum' or
    'max'; returns new tensors of the same shapes. Tensors of one dtype
    travel in one buffer."""
    red = dist.ReduceOp.SUM if op == 'sum' else dist.ReduceOp.MAX
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        buf = _staged(group, flat)
        dist.all_reduce(buf, op=red)
        flat = _back(buf, flat)
        pos = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[pos:pos + n].view(tensors[i].shape)
            pos += n
    return out


def reduce_ints(group, values, op='sum'):
    """Host integers reduced over the group; returns a list of ints."""
    dev = group.device if group.backend == 'nccl' else torch.device('cpu')
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=dev)
    return [int(v) for v in all_reduce(group, [t], op)[0].tolist()]


@_timed('collective')
def broadcast_int(group, value):
    """Rank 0's host integer on every rank."""
    dev = group.device if group.backend == 'nccl' else torch.device('cpu')
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, 0)
    return int(t.item())


@_timed('collective')
def all_gather_cat(group, t):
    """Every rank's ``t`` (same shape on each) concatenated along its last
    axis, the cell axis, in rank order."""
    buf = _staged(group, t.contiguous())
    parts = [torch.empty_like(buf) for _ in range(group.world)]
    dist.all_gather(parts, buf)
    return _back(torch.cat(parts, dim=-1), t)


def ring_hop(group, tensors):
    """Send each of ``tensors`` one hop round the ring, to rank + 1, and
    return the same-shaped tensors received from rank - 1: one message a
    tensor."""
    t0 = time.perf_counter()
    nxt = (group.rank + 1) % group.world
    prv = (group.rank - 1) % group.world
    send = [_staged(group, t.contiguous()) for t in tensors]
    recv = [torch.empty_like(s) for s in send]
    ops = []
    for tag, (s, r) in enumerate(zip(send, recv)):
        ops.append(dist.P2POp(dist.isend, s, nxt, tag=tag))
        ops.append(dist.P2POp(dist.irecv, r, prv, tag=tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = [_back(r, t) for r, t in zip(recv, tensors)]
    stats['hops'] += 1
    stats['hop_bytes'] += sum(s.numel() * s.element_size() for s in send)
    stats['hop_s'] += time.perf_counter() - t0
    return out


# ------------------------------------------------------ the sharded passes --

def run_lucy_iteration_sharded(group, geometry, dt, st, density, jnu_var_id,
                               jnu_var_frac, generator, n_photons,
                               batch_size, config, mrw=None, spec_bins=None,
                               spec_bin_frac=None, se_rho=None):
    """One Lucy iteration on this rank's share of ``n_photons`` (its
    ``generator`` the rank's own), every output sum-reduced over the group
    and ``n_steps`` max-reduced: the tuple of
    :func:`..transport.engine.run_lucy_iteration`, the same on every rank
    (JAX ``_lucy_sharded_fn``, mesh.py:48-84)."""
    from ..transport.engine import run_lucy_iteration
    energy_sum, energy_current, npc, killed_int, killed_geo, n_steps, \
        spec, n_events = run_lucy_iteration(
            geometry, dt, st, density, jnu_var_id, jnu_var_frac, generator,
            share(n_photons, group.rank, group.world), batch_size, config,
            mrw=mrw, spec_bins=spec_bins, spec_bin_frac=spec_bin_frac,
            se_rho=se_rho)
    energy_sum, spec, energy_current, npc, killed_int, killed_geo, \
        n_events = all_reduce(group, [energy_sum, spec, energy_current, npc,
                                      killed_int, killed_geo, n_events])
    n_steps, = reduce_ints(group, [n_steps], 'max')
    return (energy_sum, energy_current, npc, killed_int, killed_geo,
            n_steps, spec, n_events)


def _reduce_accums(group, accums):
    """Sum each :class:`~..transport.imaging.PeelAccum`'s six cubes over
    the group, in place of the rank's own."""
    names = [n + s for n in ('sed', 'img') for s in ('', '2', 'n')]
    flat = [getattr(a, n) for a in accums for n in names]
    red = iter(all_reduce(group, flat))
    for a in accums:
        for n in names:
            setattr(a, n, next(red))


def run_final_sharded(group, geometry, dt, st, density, specific_energy,
                      groups, generator, n_photons, **options):
    """The imaging iteration on this rank's share of ``n_photons``; the
    peeled and binned cubes, ``energy_current``, ``killed_int`` and the
    events sum-reduced and ``n_steps`` max-reduced (JAX
    ``_final_sharded_fn``, mesh.py:112-146). Returns the
    :class:`~..transport.imaging.FinalResult`."""
    from ..transport.imaging import FinalResult, run_final
    res = run_final(geometry, dt, st, density, specific_energy, groups,
                    generator, share(n_photons, group.rank, group.world),
                    **options)
    accums = list(res.accums) + ([] if res.binned_acc is None
                                 else [res.binned_acc])
    _reduce_accums(group, accums)
    dev = density.device
    e, = all_reduce(group, [torch.tensor([res.energy_current],
                                         dtype=torch.float64, device=dev)])
    killed, n_events = reduce_ints(group, [res.killed_int, res.n_events])
    n_steps, = reduce_ints(group, [res.n_steps], 'max')
    return FinalResult(res.accums, res.binned_acc, float(e[0]), killed,
                       n_steps, n_events)


def run_mono_pass_sharded(group, geometry, walk, dt, st, density, groups,
                          generator, n_photons, batch_size, config, mode,
                          f_id, nu_value, chi_vec, albedo_vec,
                          max_steps=100000000, **tables):
    """One monochromatic pass on this rank's share of ``n_photons``: the
    cubes, killed photons and events sum-reduced, the steps max-reduced
    (JAX ``_mono_sharded_fn``, mesh.py:166-191). Returns the tuple of
    :func:`..transport.mono.run_mono_pass`."""
    from ..transport.mono import run_mono_pass
    accums, killed, n_steps, n_events = run_mono_pass(
        geometry, walk, dt, st, density, groups, generator,
        share(n_photons, group.rank, group.world), batch_size, config, mode,
        f_id, nu_value, chi_vec, albedo_vec, max_steps=max_steps, **tables)
    _reduce_accums(group, accums)
    killed, n_events = reduce_ints(group, [killed, n_events])
    n_steps, = reduce_ints(group, [n_steps], 'max')
    return accums, killed, n_steps, n_events


def run_raytrace_source_sharded(group, walk, geometry, st, rt, groups,
                                accums, u, n_trip, scale, sphere):
    """This rank's lanes of one raytracing trip of source photons: ``n_trip``
    photons over the group, ``u`` the rank's uniforms of one batch, its
    lanes :func:`trip_share`'s (JAX ``_ray_sharded_fn``, mesh.py:209-231).
    The rank's cubes are reduced once, after the last trip
    (:func:`reduce_raytrace`): a sum of trips."""
    from ..transport.raytrace import raytrace_source_batch
    return raytrace_source_batch(walk, geometry, st, rt, groups, accums, u,
                                 trip_share(n_trip, group.rank, group.world),
                                 scale, sphere)


def run_raytrace_dust_sharded(group, walk, geometry, rt, var_log, groups,
                              accums, specific_energy, u, n_trip, scale):
    """This rank's lanes of one raytracing trip of the grid's thermal
    photons (as :func:`run_raytrace_source_sharded`)."""
    from ..transport.raytrace import raytrace_dust_batch
    return raytrace_dust_batch(walk, geometry, rt, var_log, groups, accums,
                               specific_energy, u,
                               trip_share(n_trip, group.rank, group.world),
                               scale)


def reduce_raytrace(group, accums, outside):
    """The raytracing cubes and the count of photons outside the grid or
    their cell, sum-reduced over the group (in place of the rank's)."""
    flat = [t for a in accums for t in (a.sed, a.img)]
    red = all_reduce(group, flat + [outside.reshape(1)])
    for i, a in enumerate(accums):
        a.sed, a.img = red[2 * i], red[2 * i + 1]
    return red[-1][0]
