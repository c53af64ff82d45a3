"""Command-line launcher of the port: run a .rtin model file with the
PyTorch engine (counterpart of ``hyperion_tpu/scripts/main.py``; ref
scripts/hyperion:39-106). The grid type is read from the file and its
tables built by ``model.run.run_model``.

Usage:
    hyperion_tpu_torch [-f] [-m n_devices] [--shard-grid] [--cpu] [--f64]
                       input.rtin output.rtout

-f             overwrite the output file if it exists
-m n_devices   run on n ranks, photon-parallel, as ``mpirun -n`` (one
               process a rank; ranks beyond the cards share them)
--shard-grid   with -m, cut the grid into slabs over the ranks for the Lucy
               iterations (without -m: one device)
--cpu          run on the CPU (default: the CUDA card, and without one the
               run raises)
--f64          run the engine in float64 (needs --cpu: the card's kernels
               take the float32 engine)
"""

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog='hyperion_tpu_torch')
    parser.add_argument('-f', action='store_true', dest='force',
                        help='overwrite existing output')
    parser.add_argument('-m', type=int, default=None, dest='n_processes',
                        metavar='n_devices',
                        help='number of ranks for data parallelism')
    parser.add_argument('--shard-grid', action='store_true',
                        dest='shard_grid',
                        help='cut the grid into slabs over the ranks for the '
                        'Lucy iterations (with -m)')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the CUDA card')
    parser.add_argument('--f64', action='store_true',
                        help='run the engine in float64 (with --cpu)')
    parser.add_argument('input')
    parser.add_argument('output')
    args = parser.parse_args(argv)

    if args.f64 and not args.cpu:
        parser.error("--f64 runs the engine on the CPU: add --cpu")
    if not os.path.exists(args.input):
        parser.error("input file %s does not exist" % args.input)
    if os.path.exists(args.output) and not args.force:
        parser.error("output file %s exists (use -f to overwrite)"
                     % args.output)

    import torch
    from ..model import Model
    from ..model.run import run_model

    model = Model.read(args.input)
    model.filename = args.input
    run_model(model, args.output, device='cpu' if args.cpu else None,
              dtype=torch.float64 if args.f64 else None,
              parallel=args.n_processes
              if args.n_processes and args.n_processes > 1 else False,
              shard_grid=args.shard_grid)

    # post-run integrity check (ref scripts/hyperion:95-106)
    import h5py
    with h5py.File(args.output, 'r') as f:
        if 'date_ended' not in f.attrs:
            print("ERROR: output file appears incomplete", file=sys.stderr)
            return 1
    print("run complete: %s" % args.output)
    return 0


if __name__ == '__main__':
    sys.exit(main())
