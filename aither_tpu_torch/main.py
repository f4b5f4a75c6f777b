"""Command-line entry point of the PyTorch/CUDA port:

    python -m aither_tpu_torch case.inp [--device cuda|cpu] [--iterations N]
                               [--nproc N]

Runs the implicit time-marching loop with residual logging to
``<case>.resid`` / ``<case>.tme`` in the working directory.  ``--device``
defaults to ``cuda`` and raises when no card is present; the CPU runs only
when asked for.  Function and restart files are not written yet.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="aither_tpu_torch",
        description="PyTorch/CUDA port of the aither structured RANS solver")
    parser.add_argument("input", help="input deck (.inp)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--iterations", type=int, default=None,
                        help="override deck iteration count")
    parser.add_argument("--nproc", type=int, default=1,
                        help="decompose the grid into this many blocks "
                             "(reference: mpirun -np N)")
    args = parser.parse_args(argv)

    import torch
    from .solver.driver import Solver
    solver = Solver(args.input, device=args.device, nproc=args.nproc)
    where = (torch.cuda.get_device_name(solver.device)
             if solver.device.type == "cuda" else "cpu")
    print(f"aither_tpu_torch running on {where} (dtype: float64)")
    solver.run(iterations=args.iterations)
    print("Program Complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
