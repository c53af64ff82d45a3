#!/usr/bin/env python3
"""Time the first port's deposit_visit design beside the current one on one
card.

    git archive <rev> hyperion_tpu_torch | tar -x -C _checkout/old
    python3 scripts/deposit_visit_ab.py --old _checkout/old

``--old`` is a directory that holds an earlier ``hyperion_tpu_torch/``
whose ``transport/deposit_visit.py`` has the two-launch interface of the
first port (``deposit_visit(energy_sum, n_photons_cell, last_uid, win,
cell_dep, dep_rows, enter, uid)`` on int32 indices and (n_dust, B) rows).
It is loaded under another package name and builds its own library inside
its directory. At the main path's four shapes, the hot cell and on the
calls of 40 recorded tutorial steps, in turns (old, old+conversions, new,
new, old+conversions, old), it measures per call what
``chip_smoke.time_turn`` does: device microseconds (~100 calls in a CUDA
graph), host microseconds (~1,000 eager calls) and one eager run between
CUDA events. The old design is timed on inputs already in its layout
('old'), and with the three conversions its caller made each step
('old+conversions': int64 -> int32 cells and entries, the (B, n_dust) ->
(n_dust, B) transpose copy). Writes chip_smoke_out/deposit_visit_ab.json
unless --out names another file.
"""

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# (lanes, B, n_cells, n_dust): the main path's four shapes and the hot cell
SHAPES = [('mixed', 131072, 3375, 1), ('mixed', 131072, 3375, 2),
          ('mixed', 125000, 32768, 1), ('mixed', 125000, 32768, 2),
          ('hot cell', 125000, 32768, 1)]
ORDER = ['old', 'old+conversions', 'new']


def load_old(directory):
    """The deposit_visit module of the hyperion_tpu_torch/ in
    ``directory``, imported as package ``old_port``."""
    pkg = Path(directory).resolve() / 'hyperion_tpu_torch'
    spec = importlib.util.spec_from_file_location(
        'old_port', pkg / '__init__.py', submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules['old_port'] = module
    spec.loader.exec_module(module)
    return importlib.import_module('old_port.transport.deposit_visit')


def designs(old, new, workload, n_dust, n_cells, device):
    """{design: call}, each call running every (cell_dep, dep or None,
    enter, uid) of the workload in order, each design on its own tables."""
    import torch
    stats = new.DepositVisit(n_dust, n_cells, device, torch.float32)
    es = torch.zeros((n_dust, n_cells), device=device)
    npc = torch.zeros(n_cells, dtype=torch.int64, device=device)
    luid = torch.full((n_cells + 1,), -2, dtype=torch.int32, device=device)
    win = old.new_visit_scratch(n_cells, device)

    def old_layout(cd, dep, enter, uid):
        """The first port's arguments: int32 cells, (n_dust, B) rows, and
        for a visits-only call no dusts and the entries as cells."""
        en32 = enter.to(torch.int32)
        if dep is None:
            return (es[:0], en32, es.new_empty((0, enter.shape[0])), en32,
                    uid)
        return es, cd.to(torch.int32), dep.T.contiguous(), en32, uid

    converted = [old_layout(*lanes) for lanes in workload]

    def new_call():
        for lanes in workload:
            stats(*lanes)

    def old_call():
        for e, cd, dep, enter, uid in converted:
            old.deposit_visit(e, npc, luid, win, cd, dep, enter, uid)

    def old_with_conversions():
        for lanes in workload:
            e, cd, dep, enter, uid = old_layout(*lanes)
            old.deposit_visit(e, npc, luid, win, cd, dep, enter, uid)

    return {'old': old_call, 'old+conversions': old_with_conversions,
            'new': new_call}


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old', required=True,
                    help='directory holding the old hyperion_tpu_torch/')
    ap.add_argument('--out', default=str(ROOT / 'chip_smoke_out' /
                                         'deposit_visit_ab.json'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('deposit_visit_ab: needs an NVIDIA card', file=sys.stderr)
        return 1
    from hyperion_tpu_torch.transport import deposit_visit as new
    old = load_old(args.old)
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device('cuda')

    # (name, calls, n_dust, n_cells)
    workloads = []
    for k, (name, B, n_cells, n_dust) in enumerate(SHAPES):
        make = cs.hot_lanes if name == 'hot cell' else cs.mixed_lanes
        lanes = make(np.random.default_rng(40 + k), B, n_cells, n_dust,
                     device)
        workloads.append((name, [lanes], n_dust, n_cells))
    workloads.append(('tutorial steps', cs.record_tutorial_calls(new), 1,
                      cs.TUTORIAL[1]))

    rows = []
    for name, workload, n_dust, n_cells in workloads:
        n = len(workload)
        B = workload[0][2].shape[0]
        calls = designs(old, new, workload, n_dust, n_cells, device)
        got = {d: [] for d in ORDER}
        for d in ORDER + ORDER[::-1]:
            got[d].append(cs.time_turn(calls[d], n))
        bounds = [cs.bound_bytes(cd, dep, enter, n_cells)
                  for cd, dep, enter, _ in workload]
        row = dict(lanes=name, calls=n, B=B, n_cells=n_cells, n_dust=n_dust,
                   card=card, bound_us=float(np.mean(bounds))
                   / cs.HBM_BYTES_PER_S * 1e6)
        for d, turns in got.items():
            row[d] = {k: [float(t[k]) for t in turns] for k in turns[0]}
            print('%-14s %2d call(s) B=%d n_cells=%d n_dust=%d %-16s device '
                  '%s us, host %s us, eager call %s ms per call [%s]'
                  % (name, n, B, n_cells, n_dust, d,
                     ' / '.join('%.2f' % x for x in row[d]['device_us']),
                     ' / '.join('%.2f' % x for x in row[d]['host_us']),
                     ' / '.join('%.4f' % x for x in row[d]['call_ms']), card),
                  flush=True)
        rows.append(row)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
