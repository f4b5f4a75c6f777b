#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aither_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — implicit SST RANS with one forward and one
backward LU-SGS sweep per iteration, the sweep on the hand-written CUDA
kernel — on the generated two-block flat plate (aither_tpu_torch/cases.py)
and checks it.  Phases, each printing its own lines:

 1. device facts: the card's name and power limit, torch and CUDA
    versions, nvcc; exits non-zero without CUDA;
 2. build: the sweep kernel from csrc/ with nvcc (time, ptxas report);
 3. kernel against the plain PyTorch sweep at the main path's shapes, on
    case A (2 x 96x120x1, 23k cells) and case B (2 x 256x64x32, 1.05M
    cells): identical inputs, max relative difference per equation within
    SWEEP_RTOL, times with CUDA events in the order plain, kernel, kernel,
    plain;
 4. main path: Solver(case B, device="cuda").run(MAIN_ITERATIONS) with the
    launch counter reset before and read after: it must equal
    iterations x 2 x sum over blocks of the hyperplane count; every L2
    finite; one .resid row per iteration; iterations/s from iteration 3
    on, Mcell-iterations/s and peak device memory;
 5. reference: the small test case run on cuda and on cpu (plain sweep)
    give the same raw residual L2 history within REF_RTOL.

Then, on lines of their own: the card's name and power limit, the kernels
JSON object, and last {"ok": true, "device": {...}}.  Any failure exits
non-zero before the last line.  Case files go to ./smoke_run/ (git-ignored).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, "smoke_run")

MAIN_ITERATIONS = 12
STEADY_FROM = 3          # iterations/s averaged from this iteration on
KERNEL_REPS = 5          # timed kernel sweep pairs per window
# kernel vs plain: max |kernel - plain| / max |plain| per equation.  The
# two differ by FMA contraction and the order of the three directions'
# sums (~1e-16 relative per operation), carried through the plane
# recurrence and the flux-difference cancellation (~2 digits).  The
# plate's spanwise momentum update is orders of magnitude smaller than
# the others' and shows the largest relative difference (2.1e-10 at case
# B, max abs 4.5e-16, on the H100).
SWEEP_RTOL = 1e-9
# cuda vs cpu raw L2 history of the small case: reduction order on the
# card, FMA in the kernel, amplified over REF_ITERATIONS implicit steps.
REF_RTOL = 1e-8
REF_ITERATIONS = 3


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def linear_system(solver):
    """The first iteration's state, residual and linear system, and a du
    with realistic connection ghosts (one relaxation on the kernel)."""
    cfl = solver.deck.cfl(0)
    prims, res, sr, dg, dts, auxs = solver._residuals(dict(solver.prims),
                                                      cfl)
    inv_diag, _, bs, dus = solver._setup_linear(prims, res, sr, dg, dts,
                                                auxs, solver.cons_n)
    dus = solver._relax(prims, auxs, inv_diag, bs, dus)
    return prims, auxs, inv_diag, bs, dus


def sweep_pair(solver, system, forward, backward, du0):
    """forward then backward sweep of every block from copies of du0."""
    prims, auxs, inv_diag, bs, _ = system
    out = {}
    for b in solver.case.blocks:
        bi = b.index
        du = du0[bi].clone()
        forward(solver.phys, solver.cfg, solver.plans[bi], prims[bi], du,
                bs[bi], *inv_diag[bi], auxs[bi])
        backward(solver.phys, solver.cfg, solver.plans[bi], prims[bi], du,
                 bs[bi], *inv_diag[bi], auxs[bi])
        out[bi] = du
    return out


def timed_ms(torch, fn, reps: int) -> float:
    """mean milliseconds of fn() over reps, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_kernel(torch, solver, label, card):
    """Phase 3 on one case: (max_abs_err, kernel ms, plain ms)."""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    system = linear_system(solver)
    du0 = system[4]
    kern = sweep_pair(solver, system, ls.forward, ls.backward, du0)
    plain = sweep_pair(solver, system, ls.forward_plain, ls.backward_plain,
                       du0)
    torch.cuda.synchronize()
    max_abs = 0.0
    rel = np.zeros(solver.phys.neq)     # per equation, worst block
    for bi, p in plain.items():
        k = kern[bi]
        if not bool(torch.isfinite(k).all()):
            fail(f"{label}: kernel sweep gave non-finite values")
        for e in range(p.shape[0]):
            scale = float(p[e].abs().max())
            err = float((k[e] - p[e]).abs().max())
            max_abs = max(max_abs, err)
            rel[e] = max(rel[e], err / scale if scale > 0 else err)
    print(f"phase 3 {label}: kernel vs plain max rel diff per equation "
          f"{[f'{r:.2e}' for r in rel]} (tol {SWEEP_RTOL:.0e}), max abs "
          f"diff {max_abs:.3e}", flush=True)
    if not rel.max() <= SWEEP_RTOL:
        fail(f"{label}: kernel disagrees with the plain sweep")

    def run_kernel():
        sweep_pair(solver, system, ls.forward, ls.backward, du0)

    def run_plain():
        sweep_pair(solver, system, ls.forward_plain, ls.backward_plain, du0)

    p1 = timed_ms(torch, run_plain, 1)
    k1 = timed_ms(torch, run_kernel, KERNEL_REPS)
    k2 = timed_ms(torch, run_kernel, KERNEL_REPS)
    p2 = timed_ms(torch, run_plain, 1)
    kernel_ms, plain_ms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    cells = sum(b.ni * b.nj * b.nk for b in solver.case.blocks)
    print(f"phase 3 {label}: {cells} cells, one forward+backward sweep "
          f"pair over all blocks: kernel {kernel_ms:.4f} ms "
          f"[{k1:.4f}, {k2:.4f}], plain {plain_ms:.2f} ms "
          f"[{p1:.2f}, {p2:.2f}] ({card})", flush=True)
    return max_abs, kernel_ms, plain_ms


def reference_history(Solver, write_plate_case, dims, device):
    """raw L2 history (REF_ITERATIONS, neq) of the small case from a
    state perturbed by up to 1% on the interior (seeded; the unperturbed
    plate has roundoff-level residual components)."""
    wd = os.path.join(RUN_DIR, f"reference_{device}")
    s = Solver(write_plate_case(wd, *dims), device=device, workdir=wd)
    rng = np.random.default_rng(7)
    prims = {}
    for b in s.case.blocks:
        prim = b.prim0.cpu().numpy().copy()
        prim[b.interior] *= 1.0 + 0.01 * rng.random(prim[b.interior].shape)
        prims[b.index] = prim
    s.set_state(prims)
    s.run(iterations=REF_ITERATIONS)
    return np.asarray(s.l2_history)


def read_tme(path):
    rows = []
    with open(path) as f:
        for ln in f:
            t = ln.split()
            if t and t[0] != "Step":
                rows.append((int(t[0]), float(t[1])))
    return rows


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    sys.path.insert(0, REPO)
    try:
        from aither_tpu_torch.cases import (SMOKE_2D_DIMS, SMOKE_3D_DIMS,
                                            TEST_DIMS, write_plate_case)
        from aither_tpu_torch.kernels import lusgs_sweep as ls
        from aither_tpu_torch.solver.driver import Solver
        from aither_tpu_torch.utils.build import load_cuda_library, nvcc_path
    except ImportError as exc:
        fail(f"the aither_tpu_torch package is not beside this script: "
             f"{exc}")
    if "jax" in sys.modules:
        fail("jax was imported")

    # -- phase 1: device facts ------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    proc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    nvcc = proc.stdout.strip().splitlines()[-1] if proc.stdout else "?"
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc: {nvcc}", flush=True)

    # -- phase 2: build -------------------------------------------------------
    _, info = load_cuda_library("lusgs_sweep")
    print(f"phase 2 build: {os.path.relpath(info['path'], REPO)} "
          f"built={info['built']} in {info['seconds']:.2f} s", flush=True)
    for ln in info["ptxas"].splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"phase 2 ptxas: {ln.strip()}", flush=True)

    # -- phase 3: kernel vs plain at main-path shapes -------------------------
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    results = {}
    solvers = {}
    for label, dims in (("case A", SMOKE_2D_DIMS), ("case B", SMOKE_3D_DIMS)):
        wd = os.path.join(RUN_DIR, label.replace(" ", "_"))
        t0 = time.perf_counter()
        solver = Solver(write_plate_case(wd, *dims), device="cuda",
                        workdir=wd)
        print(f"phase 3 {label}: 2 blocks of {dims} built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        results[label] = compare_kernel(torch, solver, label, card)
        solvers[label] = solver
    del solvers["case A"]

    # -- phase 4: main path ---------------------------------------------------
    solver = solvers["case B"]
    cells = solver.case.total_cells
    planes = sum(p.nplanes for p in solver.plans.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ls.LAUNCHES.reset()
    solver.run(iterations=MAIN_ITERATIONS)
    launches = ls.LAUNCHES.count
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    expect = MAIN_ITERATIONS * 2 * planes
    print(f"phase 4 main path: {MAIN_ITERATIONS} iterations of case B "
          f"({cells} cells), kernel launches {launches} (expected "
          f"{expect})", flush=True)
    if launches != expect:
        fail(f"the main path launched the sweep kernel {launches} times, "
             f"expected {expect}")
    l2 = solver.l2_history
    if len(l2) != MAIN_ITERATIONS or not np.isfinite(l2).all():
        fail(f"non-finite or missing residual L2: {l2}")
    with open(solver.sim_root + ".resid") as f:
        rows = [ln for ln in f.read().splitlines()[1:] if ln.strip()]
    if len(rows) != MAIN_ITERATIONS:
        fail(f".resid has {len(rows)} rows for {MAIN_ITERATIONS} "
             f"iterations")
    steady = [t for n, t in read_tme(solver.sim_root + ".tme")
              if n >= STEADY_FROM]
    its = len(steady) / sum(steady)
    print(f"phase 4 main path: {its:.4f} iterations/s steady (iterations "
          f"{STEADY_FROM}-{MAIN_ITERATIONS - 1}), "
          f"{its * cells / 1e6:.4f} Mcell-iterations/s, peak device memory "
          f"{peak / 2**30:.3f} GiB ({card})", flush=True)
    print(f"phase 4 main path: last L2 {[f'{v:.4e}' for v in l2[-1]]}",
          flush=True)
    del solvers, solver

    # -- phase 5: small-case reference, cuda against cpu ----------------------
    hist = {dev: reference_history(Solver, write_plate_case, TEST_DIMS, dev)
            for dev in ("cuda", "cpu")}
    # per equation, relative to that equation's largest L2 in the history
    worst = float((np.abs(hist["cuda"] - hist["cpu"]).max(axis=0)
                   / np.abs(hist["cpu"]).max(axis=0)).max())
    print(f"phase 5 reference: {TEST_DIMS} x 2 blocks, {REF_ITERATIONS} "
          f"iterations, cuda vs cpu raw L2 max rel diff {worst:.3e} "
          f"(tol {REF_RTOL:.0e})", flush=True)
    if not worst <= REF_RTOL:
        fail("the cuda run disagrees with the cpu run")

    max_abs = max(r[0] for r in results.values())
    _, kernel_ms, plain_ms = results["case B"]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "lusgs_sweep", "route": "cuda",
        "source": "aither_tpu_torch/csrc/lusgs_sweep.cu",
        "replaces": "aither_tpu/solver/pallas_sweep.py:239",
        "launches": launches, "max_abs_err": max_abs, "ms": kernel_ms,
        "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
