#!/usr/bin/env python3
"""The spread of class2's raytraced SED from run to run, in float32 and
float64, on the card.

    python3 scripts/raytrace_spread.py \\
        --specific-energy chip_smoke_out/class2_specific_energy.npy

chip_smoke.py's phase 11 checks the raytracing against the Monte-Carlo
light with the Monte-Carlo uncertainties alone; this measures the
raytraced light's own noise there. It runs chip_smoke.py's class2 model in
monochromatic mode at CLASS2_MONO_WAVELENGTHS with raytracing only (no
Monte-Carlo photons), the given specific energy in the grid (phase 8's,
which chip_smoke.py saves), RAYTRACING's photons, ``--seeds`` seeds in each
type, and prints per view and wavelength the mean nu L_nu, the spread
(standard deviation / mean) of one run, and the float32 mean over the
float64 one. Needs a card."""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    import torch
    import chip_smoke as cs
    from hyperion_tpu_torch.model import run_lucy_model

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--specific-energy', required=True)
    ap.add_argument('--seeds', type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('raytrace_spread: needs a card', file=sys.stderr)
        return 1
    se = np.load(args.specific_energy)
    card = cs.card_line()
    waves = cs.CLASS2_MONO_WAVELENGTHS
    means = {}
    for dtype in (torch.float32, torch.float64):
        runs = []
        t0 = time.time()
        for seed in range(args.seeds):
            m = cs.class2_model(cs.CLASS2_CUT['n_photons'], 0, 0)
            m.set_monochromatic(True, wavelengths=waves)
            m.peeled_output[0].set_wavelength_index_range(0, len(waves) - 1)
            m.set_raytracing(True)
            m.set_n_photons(initial=cs.CLASS2_CUT['n_photons'],
                            imaging_sources=0, imaging_dust=0,
                            **cs.RAYTRACING)
            m.set_seed(1000 + seed)
            cs._given_specific_energy(m, se)
            run = run_lucy_model(m, device='cuda', dtype=dtype,
                                 batch_size=50_000)
            runs.append(run.imaging.peeled[0]['datasets']['seds'][0][
                0, 0, :, 0])
        runs = np.array(runs)             # (seeds, n_view, n_wav)
        means[dtype] = runs.mean(axis=0)
        print('%s, %d seeds in %.1f s [%s]' % (dtype, args.seeds,
                                              time.time() - t0, card))
        for v in range(runs.shape[1]):
            print('  view %d: mean %s, spread %s' % (
                v, ['%.4e' % x for x in means[dtype][v]],
                ['%.4f' % x for x in runs[:, v].std(axis=0, ddof=1) /
                 means[dtype][v]]))
    ratio = means[torch.float32] / means[torch.float64]
    print('float32 mean / float64 mean per view: %s'
          % [['%.4f' % x for x in row] for row in ratio])
    return 0


if __name__ == '__main__':
    sys.exit(main())
