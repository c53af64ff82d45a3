"""Start the ranks of a run, as ``mpirun -n N`` starts the reference's
(ref scripts/hyperion:60-92), and return rank 0's result.

:func:`launch` pickles a target (``"module:function"``), its arguments and
the parent's ``sys.path`` into a fresh temporary directory and starts one
process a rank::

    python -m hyperion_tpu_torch.parallel.launch <directory> <rank>

Each rank joins one ``torch.distributed`` group through a ``file://``
rendezvous in that directory (with a timeout on its collectives), becomes
the process's :func:`.mesh.active_group`, calls the target and, on rank 0,
pickles what it returns. The parent watches the ranks: when one exits with
an error it kills the others at once and raises, naming the rank and
giving its traceback, so that a rank that fails never leaves the others
waiting in a collective. Ranks other than 0 print nothing. On the CPU
each rank runs few threads, since several ranks share the host's cores.
Subprocesses, not ``torch.multiprocessing``: a spawned child re-imports
the parent's ``__main__``, which a test runner or an interactive session
may not allow."""

import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

# the collectives' timeout inside a rank (a rank that hangs raises)
TIMEOUT_S = 1800.0
# how often the parent looks at its ranks, and a rank at its parent
POLL_S = 0.02
PARENT_POLL_S = 1.0
# set in a rank's environment: a rank never launches ranks of its own
RANK_ENV = 'HYPERION_TPU_TORCH_RANK'


class RankFailed(RuntimeError):
    """A rank of a launched run exited with an error."""


def _target(name):
    module, _, func = name.partition(':')
    obj = importlib.import_module(module)
    for part in func.split('.'):
        obj = getattr(obj, part)
    return obj


def _threads(world):
    """Threads per rank on the CPU: the cores shared by the ranks and by
    up to six such runs side by side."""
    return max(1, (os.cpu_count() or 1) // (world * 6))


def launch(group, target, args=(), kwargs=None):
    """Run ``target(*args, **kwargs)`` on each of ``group.world`` ranks (a
    :class:`.mesh.Group` from :func:`.mesh.resolve_group`) and return rank
    0's result. Raises :class:`RankFailed` as soon as a rank fails."""
    if RANK_ENV in os.environ:
        raise RuntimeError("a rank (%s) cannot launch ranks"
                           % os.environ[RANK_ENV])
    tmp = Path(tempfile.mkdtemp(prefix='hyperion_ranks_'))
    procs, logs = [], []
    try:
        with open(tmp / 'job.pkl', 'wb') as f:
            pickle.dump(dict(target=target, args=tuple(args),
                             kwargs=dict(kwargs or {}), world=group.world,
                             backend=group.backend,
                             device_type=group.device_type,
                             sys_path=list(sys.path)),
                        f)
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env['PYTHONPATH'] = os.pathsep.join(
            [root] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                      if p])
        # ranks talk over the loopback interface only
        env.setdefault('GLOO_SOCKET_IFNAME', 'lo')
        sys.stdout.flush()
        for rank in range(group.world):
            env[RANK_ENV] = str(rank)
            if rank:
                logs.append(open(tmp / ('stderr_%d.txt' % rank), 'wb'))
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'hyperion_tpu_torch.parallel.launch',
                 str(tmp), str(rank)], env=env,
                stdout=None if rank == 0 else subprocess.DEVNULL,
                stderr=logs[-1] if rank else None))
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                _kill(procs)
                r = bad[0]
                err = tmp / ('error_%d.txt' % r)
                raise RankFailed(
                    'rank %d of %d failed (exit code %d):\n%s'
                    % (r, group.world, codes[r],
                       err.read_text() if err.exists() else
                       _tail(tmp / ('stderr_%d.txt' % r))))
            if all(c == 0 for c in codes):
                break
            time.sleep(POLL_S)
        with open(tmp / 'result.pkl', 'rb') as f:
            return pickle.load(f)
    finally:
        _kill(procs)
        for f in logs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _tail(path, n=4000):
    return path.read_text(errors='replace')[-n:] if path.exists() else ''


def _watch_parent():
    """Leave when the launching process is gone (a rank is never left
    running on its own)."""
    parent = os.getppid()
    while os.getppid() == parent:
        time.sleep(PARENT_POLL_S)
    os._exit(1)


def _rank_main(tmp, rank):
    """One rank: join the group, run the target, rank 0 pickles the
    result. Returns the exit code."""
    import threading
    threading.Thread(target=_watch_parent, daemon=True).start()
    tmp = Path(tmp)
    try:
        with open(tmp / 'job.pkl', 'rb') as f:
            job = pickle.load(f)
        for p in reversed(job['sys_path']):
            if p not in sys.path:
                sys.path.insert(0, p)
        import torch
        import torch.distributed as dist
        from . import mesh
        world, device_type = job['world'], job['device_type']
        device = mesh.rank_device(rank, device_type)
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(_threads(world))
        dist.init_process_group(
            job['backend'], init_method='file://' + str(tmp / 'rendezvous'),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        mesh._set_active(mesh.Group(world=world, backend=job['backend'],
                                    device_type=device_type, rank=rank,
                                    device=device))
        try:
            result = _target(job['target'])(*job['args'], **job['kwargs'])
            if rank == 0:
                with open(tmp / 'result.part', 'wb') as f:
                    pickle.dump(result, f)
                os.replace(tmp / 'result.part', tmp / 'result.pkl')
        finally:
            mesh._set_active(None)
        dist.destroy_process_group()
        return 0
    except BaseException:
        (tmp / ('error_%d.txt' % rank)).write_text(traceback.format_exc())
        traceback.print_exc()
        return 1


if __name__ == '__main__':
    # flush and leave without tearing the interpreter down: a rank's peers
    # may already be gone
    code = _rank_main(sys.argv[1], int(sys.argv[2]))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
