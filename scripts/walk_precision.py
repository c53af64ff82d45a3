#!/usr/bin/env python3
"""How far a float32 escape-tau walk strays from the float64 one, on the
walks the imaging step makes, on one card.

    python3 scripts/walk_precision.py [--model class2|quickstart]

Records the walk calls of imaging steps 1-20 and 41-60 (chip_smoke's
record_walks and WALK_WINDOWS) of class2 (examples/class2_sed.py, B =
50,000) or of the quickstart (B = 125,000), then walks each call's float32
lanes twice: in float32 arithmetic on the port's float32 geometry tables
(the find_wall of the float32 Lucy and imaging steps), and with the
escape_tau kernel, which walks in float64 on the grid's float64 walls.
Prints the card and one JSON object per window: the rays of active lanes
(each view of each active lane), how many of them the float32 walk puts
beyond 1e-4 tau + 1e-6 of the float64 one,
quantiles (0.5, 0.9, 0.99, 0.999, 1) of the relative difference, and the
summed transmission exp(-tau) of each walk and of their difference.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def float32_walk(geo, rho_t, chi, x, y, z, kx, ky, kz, cell, active,
                 t_max, max_steps=100000):
    """The plain walk in the lanes' float32 arithmetic on float32 tables."""
    import torch
    from hyperion_tpu_torch.transport.gtable import ESCAPED

    tau = torch.zeros_like(x)
    remaining = t_max
    for _ in range(max_steps):
        if not bool(active.any()):
            break
        cs = cell.clamp_min(0)
        t_wall, next_cell, ax, wall = geo.find_wall(cs, x, y, z, kx, ky, kz)
        seg = t_wall
        if t_max is not None:
            seg = torch.minimum(t_wall, remaining)
            remaining = remaining - t_wall
        tau = tau + torch.where(active, (chi * rho_t[cs]).sum(-1) * seg, 0.0)
        x2, y2, z2 = geo.snap(x + t_wall * kx, y + t_wall * ky,
                              z + t_wall * kz, ax, wall, active)
        x = torch.where(active, x2, x)
        y = torch.where(active, y2, y)
        z = torch.where(active, z2, z)
        cell = torch.where(active, next_cell, cell)
        active = active & (cell != ESCAPED)
        if t_max is not None:
            active = active & (remaining > 0.0)
    return tau


def main():
    import torch
    import chip_smoke as cs
    from hyperion_tpu_torch.model.run import build_geometry_tables
    from hyperion_tpu_torch.transport import escape_tau as et

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', choices=['class2', 'quickstart'],
                    default='class2')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('walk_precision: needs an NVIDIA card', file=sys.stderr)
        return 1
    if args.model == 'class2':
        model, batch = cs.class2_model(n_photons=200_000), 50_000
    else:
        model, batch = cs.tutorial_model(), 125_000
    print(cs.card_line(), flush=True)
    rho32, calls = cs.record_walks(model, batch, cs.WALK_WINDOWS)
    dev = torch.device('cuda')
    rt32 = rho32.T.contiguous()
    geo32 = build_geometry_tables(model.grid, dev, torch.float32)
    walk = et.EscapeTau(build_geometry_tables(model.grid, dev, torch.float64),
                        rt32)
    q = torch.tensor([0.5, 0.9, 0.99, 0.999, 1.0], dtype=torch.float64,
                     device=dev)
    for first, last in cs.WALK_WINDOWS:
        t32, t64 = [], []
        for call in calls[(first, last)]:
            a, t_max = call[8], call[9]
            # one event's views, in the order of the kernel's rows
            for v in range(call[4].shape[0]):
                t32.append(float32_walk(
                    geo32, rt32, *call[:4], *[k[v] for k in call[4:7]],
                    *call[7:9], None if t_max is None else t_max[v])
                    .double()[a])
            t64.append(walk(*call[:9], t_max=t_max).double()[:, a]
                       .reshape(-1))
        t32, t64 = torch.cat(t32), torch.cat(t64)
        diff = (t32 - t64).abs()
        rel = diff / t64.clamp_min(1e-300)
        print(json.dumps(dict(
            model=args.model, steps='%d-%d' % (first + 1, last),
            calls=len(calls[(first, last)]), active_rays=int(t64.numel()),
            beyond_1e4=int((diff > 1e-4 * t64 + 1e-6).sum()),
            rel_diff_quantiles=torch.quantile(rel, q).tolist(),
            transmission_f64=float((-t64).exp().sum()),
            transmission_f32=float((-t32).exp().sum()),
            transmission_abs_diff=float(((-t32).exp() - (-t64).exp())
                                        .abs().sum()))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
