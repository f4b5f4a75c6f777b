"""Where the main path's time goes on one GPU, per layer and per kernel.

    python -m aither_tpu_torch.utils.profile [--dims NI NJ NK]
                                             [--iterations N] [--warmup W]
                                             [--matrix-solver SOLVER]
                                             [--matrix-sweeps S]
                                             [--inviscid-flux-jacobian JAC]
                                             [--time-integration TI]
                                             [--equation-set SET]
                                             [--turbulence-model MODEL]
                                             [--mixture NAME]
                                             [--multigrid-levels L]
                                             [--multigrid-cycle V|W]
                                             [--face-reconstruction R]
                                             [--viscous-face-reconstruction V]
                                             [--inviscid-flux F]
                                             [--thermodynamic-model M]

Writes the generated two-block plate (each block NI x NJ x NK cells;
default the 1.05M-cell case; the deck's matrixSolver (lusgs, blusgs,
dplur, bdplur) and matrixSweeps, inviscidFluxJacobian (rusanov,
approximateRoe), timeIntegration (the decks of ``cases.TIME_INTEGRATORS``),
equationSet and turbulenceModel as given, default lusgs, 1, rusanov,
implicitEuler, rans and sst2003; with ``--mixture`` the gas of
``cases.MIXTURES``, e.g. n2o2 or air5_frozen; with ``--multigrid-levels``
above 1 FAS multigrid, V or W cycles; faceReconstruction (thirdOrder,
constant, weno, wenoZ), viscousFaceReconstruction (central,
centralFourth), inviscidFlux (roe, ausm) and thermodynamicModel
(caloricallyPerfect, thermallyPerfect: one species is then the hot air
of ``cases.TP_AIR``), each written when it is not the default) to
``smoke_run/profile_<solver>_<set>_<model>[_<mixture>]_<jacobian>_<time
integration>[_mg<levels><cycle>][_<each physics setting not the
default>]/``, runs W warm-up nonlinear iterations,
then N nonlinear
iterations (the rk4 stages in turn; bdf2 against its time n-1 solution)
three times:

1. plain, ending in one synchronise: the iteration time;
2. with a device synchronise around each layer (ghosts, residual, linear
   setup, sweeps with their du swaps, matrix residual, the multigrid
   restriction and prolongation, update, norms; a layer sums its calls
   at every grid level), timing each layer on the host clock; "other" is
   the rest of the iteration (mut/f1 swaps, local dt, Python);
3. under ``torch.profiler``: the device's busy time per iteration (sum of
   kernel times; one stream, so kernels do not overlap), kernel launches
   per iteration and the top kernels by device time.  The profiler slows
   the host many times over, so the idle share is taken against the
   plain iteration time of window 1.

Prints one JSON line, with the peak device memory of the whole run
(``torch.cuda.max_memory_allocated``).  Requires CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time

import torch

from .. import cases
from ..solver import driver, implicit, multigrid, step

LAYERS = (("ghosts", step, "apply_all_bcs"),
          ("residual", step, "full_residual"),
          ("linear_setup", driver.Solver, "_setup_linear"),
          ("sweeps", driver.Solver, "_relax"),
          ("matrix_residual", implicit, "matrix_residual"),
          ("multigrid_transfer", multigrid, "restrict_sum"),
          ("multigrid_transfer", multigrid, "prolong"),
          ("update", step, "implicit_update"),
          ("explicit_update", driver.Solver, "_explicit_update"),
          ("norms", step, "residual_norms"))


@contextlib.contextmanager
def layer_timers(totals: dict):
    """Wrap each layer function so that it adds its synchronised wall time
    to ``totals[name]``; restores the functions on exit."""
    saved = []

    def wrap(name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for name, owner, attr in LAYERS:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, wrap(name, fn))
    try:
        yield totals
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def iterate(solver, n):
    """n nonlinear iterations from the time-n solution at the solver's
    state, each an rk4 stage in turn on an rk4 deck (stage 0 from a new
    time-n solution), each against the time n-1 solution on a bdf2 deck"""
    stages = solver.deck["nonlinearIterations"]
    rk4 = solver.cfg["time_integration"] == "rk4"
    for m in range(n):
        if not rk4 or m % stages == 0:
            solver.cons_n = solver.store_old_solution()
        solver.prims, *_ = solver._iteration(
            solver.prims, solver.cons_n, solver.deck.cfl(0),
            stage=m % stages if rk4 else 0, cons_nm1=solver.cons_nm1)
    torch.cuda.synchronize()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="aither_tpu_torch.utils.profile")
    parser.add_argument("--dims", type=int, nargs=3,
                        default=list(cases.SMOKE_3D_DIMS))
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--matrix-solver", default="lusgs",
                        choices=("lusgs", "blusgs", "dplur", "bdplur"))
    parser.add_argument("--matrix-sweeps", type=int, default=1)
    parser.add_argument("--inviscid-flux-jacobian", default="rusanov",
                        choices=("rusanov", "approximateRoe"))
    parser.add_argument("--time-integration", default="implicitEuler",
                        choices=tuple(cases.TIME_INTEGRATORS))
    parser.add_argument("--equation-set", default="rans",
                        choices=("euler", "navierStokes",
                                 "largeEddySimulation", "rans"))
    parser.add_argument("--turbulence-model", default="sst2003",
                        choices=("none", "wale", "kOmegaWilcox2006",
                                 "sst2003", "sstdes"))
    parser.add_argument("--mixture", choices=tuple(cases.MIXTURES),
                        default=None)
    parser.add_argument("--multigrid-levels", type=int, default=1)
    parser.add_argument("--multigrid-cycle", default="V", choices=("V", "W"))
    parser.add_argument("--face-reconstruction", default="thirdOrder",
                        choices=("thirdOrder", "constant", "weno", "wenoZ"))
    parser.add_argument("--viscous-face-reconstruction", default="central",
                        choices=("central", "centralFourth"))
    parser.add_argument("--inviscid-flux", default="roe",
                        choices=("roe", "ausm"))
    parser.add_argument("--thermodynamic-model",
                        default="caloricallyPerfect",
                        choices=("caloricallyPerfect", "thermallyPerfect"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    wd = os.path.join(os.getcwd(), "smoke_run",
                      f"profile_{args.matrix_solver}_{args.equation_set}_"
                      f"{args.turbulence_model}"
                      + (f"_{args.mixture}" if args.mixture else "")
                      + f"_{args.inviscid_flux_jacobian}_"
                        f"{args.time_integration}"
                      + (f"_mg{args.multigrid_levels}{args.multigrid_cycle}"
                         if args.multigrid_levels > 1 else "")
                      + "".join(f"_{v}" for v, default in (
                          (args.face_reconstruction, "thirdOrder"),
                          (args.viscous_face_reconstruction, "central"),
                          (args.inviscid_flux, "roe"),
                          (args.thermodynamic_model, "caloricallyPerfect"))
                                if v != default))
    physics = dict(
        face_reconstruction=args.face_reconstruction,
        viscous_face_reconstruction=args.viscous_face_reconstruction,
        inviscid_flux=args.inviscid_flux,
        thermodynamic_model=args.thermodynamic_model)
    if args.thermodynamic_model == "thermallyPerfect" and not args.mixture:
        physics.update(cases.TP_AIR)
    path = cases.write_plate_case(
        wd, *args.dims, matrix_solver=args.matrix_solver,
        matrix_sweeps=args.matrix_sweeps,
        inviscid_flux_jacobian=args.inviscid_flux_jacobian,
        equation_set=args.equation_set,
        turbulence_model=args.turbulence_model,
        multigrid_levels=args.multigrid_levels,
        multigrid_cycle=args.multigrid_cycle,
        **cases.MIXTURES.get(args.mixture, {}),
        **cases.TIME_INTEGRATORS[args.time_integration], **physics)
    here = os.getcwd()
    os.chdir(wd)            # a reacting deck's mechanism is read from here
    try:
        solver = driver.Solver(path, device="cuda", workdir=wd)
    finally:
        os.chdir(here)
    n = args.iterations
    iterate(solver, args.warmup)

    t0 = time.perf_counter()
    iterate(solver, n)
    iteration_ms = 1e3 * (time.perf_counter() - t0) / n

    totals = {}
    t0 = time.perf_counter()
    with layer_timers(totals):
        iterate(solver, n)
    synced_ms = 1e3 * (time.perf_counter() - t0) / n
    layers = {k: 1e3 * v / n for k, v in totals.items()}
    layers["other"] = synced_ms - sum(layers.values())

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        iterate(solver, n)
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((evt.key, dev_us / 1e3 / n, evt.count / n))
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    print(json.dumps({
        "card": card, "dims": args.dims, "cells": solver.case.total_cells,
        "matrix_solver": args.matrix_solver,
        "matrix_sweeps": args.matrix_sweeps,
        "inviscid_flux_jacobian": args.inviscid_flux_jacobian,
        "time_integration": args.time_integration,
        "equation_set": args.equation_set,
        "turbulence_model": args.turbulence_model,
        "mixture": args.mixture, "multigrid_levels": args.multigrid_levels,
        "multigrid_cycle": args.multigrid_cycle,
        "face_reconstruction": args.face_reconstruction,
        "viscous_face_reconstruction": args.viscous_face_reconstruction,
        "inviscid_flux": args.inviscid_flux,
        "thermodynamic_model": args.thermodynamic_model,
        "iterations": n, "iteration_ms": iteration_ms,
        "iteration_ms_synced": synced_ms, "layers_ms": layers,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / iteration_ms,
        "kernel_launches_per_iteration": sum(k[2] for k in kernels),
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
        "top_kernels": [[k[0][:80], k[1], k[2]] for k in kernels[:12]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
