"""Command-line entry point of the PyTorch/CUDA port:

    python -m aither_tpu_torch case.inp [restart.rst] [--device cuda|cpu]
                               [--iterations N] [--nproc N] [--shard N]
                               [--no-files] [--debug]

Runs the deck's time-marching loop (implicit Euler, Crank-Nicolson or
BDF2 with dual time through LU-SGS, block LU-SGS, DPLUR or block DPLUR
with the Rusanov or approximateRoe off-diagonal; or explicit Euler or
RK4) with residual logging to ``<case>.resid`` / ``<case>.tme`` and
function and restart output at the deck's frequencies, in the working
directory: ``<grid>_center.xyz``, ``<case>_<n>_center.fun`` and
``<case>_center.p3d`` from the start and every ``outputFrequency`` steps
(with ``wallOutputVariables`` the ``_wall_center`` files, with
``outputNodalVariables`` the nodal ``<case>_<n>.fun`` and
``<case>.p3d``), and ``<case>_<n>.rst`` every ``restartFrequency`` steps
(the files of ``python -m aither_tpu``).  A restart file (either
package's) resumes from its state and iteration; ``--no-files`` writes
only the logs.  ``--device`` defaults to ``cuda`` and raises when no card
is present; the CPU runs only when asked for.  ``--debug`` checks
physicality after every iteration (non-finite residual, non-positive
density or pressure, non-finite tke) and aborts with the block and cell;
unset, it defers to ``AITHER_DEBUG=1``.

``--shard N`` runs the deck over N ranks, one process each
(``parallel/distributed.launch_local``; reference: ``mpirun -np N``):
each rank owns whole blocks of the (``--nproc``-decomposed) grid, holds
only those on its device (``cuda:{rank % device_count}``, or the CPU with
``--device cpu``), runs the kernels on them and exchanges connection
ghosts with the others at every grid level over gloo with host staging.
Only rank 0 reads the case directory and the restart file; it prints the
rows and writes the logs and files into the case directory, the same as
a one-rank run's.  N may not exceed the number of blocks.  ``--shard 1``
(the default) is the one-process run.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="aither_tpu_torch",
        description="PyTorch/CUDA port of the aither structured RANS solver")
    parser.add_argument("input", help="input deck (.inp)")
    parser.add_argument("restart", nargs="?", default=None,
                        help="restart file (.rst) to resume from")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--iterations", type=int, default=None,
                        help="override deck iteration count")
    parser.add_argument("--nproc", type=int, default=1,
                        help="decompose the grid into this many blocks "
                             "(reference: mpirun -np N)")
    parser.add_argument("--shard", type=int, default=1,
                        help="run over this many ranks, one process each, "
                             "each owning whole blocks (reference: mpirun "
                             "-np N)")
    parser.add_argument("--no-files", action="store_true",
                        help="skip .fun/.rst output")
    parser.add_argument("--debug", action="store_true", default=None,
                        help="per-iteration physicality checks; unset "
                             "defers to AITHER_DEBUG=1")
    args = parser.parse_args(argv)

    if args.shard < 1:
        parser.error(f"--shard {args.shard}: at least one rank")
    if args.shard > 1:
        import os
        from .parallel.distributed import launch_local
        case_dir = os.path.dirname(os.path.abspath(args.input))
        print(f"aither_tpu_torch running over {args.shard} ranks on "
              f"{args.device} (exchange: gloo with host staging)",
              flush=True)
        launch_local(args.shard, case_dir, os.path.basename(args.input),
                     iterations=args.iterations, device=args.device,
                     nproc=args.nproc, restart=args.restart,
                     write_files=not args.no_files, debug=args.debug,
                     echo=True)
        print("Program Complete")
        return 0

    import torch
    from .solver.driver import Solver
    solver = Solver(args.input, device=args.device, nproc=args.nproc,
                    restart_path=args.restart, debug=args.debug)
    where = (torch.cuda.get_device_name(solver.device)
             if solver.device.type == "cuda" else "cpu")
    print(f"aither_tpu_torch running on {where} (dtype: float64)")
    solver.run(iterations=args.iterations, write_files=not args.no_files)
    print("Program Complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
