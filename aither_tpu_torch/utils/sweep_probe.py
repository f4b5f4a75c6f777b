"""The sweep kernels (csrc/lusgs_sweep.cu and csrc/blusgs_sweep.cu, any
build) on one GPU: pair times and the step's parts by SM clocks.

    python3 aither_tpu_torch/utils/sweep_probe.py [--forms NAME ...]
                                                 [--check] [--marks]
                                                 [--out PATH]

For each form (FORMS: the calorically perfect SST lusgs and blusgs decks,
the main paths' Rusanov forms (a) and (c), at case B, 2 x 256x64x32 cells,
both blocks; the hot-air thermally perfect SST lusgs deck and its
approximateRoe twin at case B; the calorically perfect SST approximateRoe
deck at case B; the seven-species
hydrogen-air thermally perfect deck at case A, 2 x 96x120x1, block 0
alone, as ``chip_smoke.py`` compares it; the blusgs decks of hot air
thermally perfect and thermally perfect approximateRoe at case B, and of
the thermally perfect P5 mixture ``n2o2_ch4x`` and five-species air at
case S, 2 x 48x60x1, block 0) it builds the generated
plate's Solver on the card, takes its first linear system
(``chip_smoke.linear_system``), times the variant (a) or (c)
forward+backward pair as ``Solver.run`` launches it (CUDA events: one untimed pair, then
two windows of ``chip_smoke.KERNEL_REPS`` pairs) and divides it by the
critical path's planes, then runs each sweep of each block once more
through the probe's build of the library (``<library>_probe``,
``-DSWEEP_PROBE=1``: the production builds carry no marks) with the
kernel's step clocks (``lusgs_sweep.clock_breakdown``) and prints the
mean SM cycles a plane spends in each part, the parts' share of a plane,
the span of each launch and, where the form has one, of its pre-pass (by
%globaltimer), and the SM clock.  With ``--check`` the pair is first held
to its plain version (``chip_smoke.SWEEP_RTOL``).  With ``--marks`` the
pair is also timed block after block through the probe's build and
through the form's own library, which has no marks, in turns (with,
without, without, with), so that the cost of the marks reads as the
difference.  The earlier design's pair, in another checkout, is timed
against this one's by ``utils/pair_turns.py``.  One JSON line per library
(its ptxas report) and per form; the same lines, with the libraries'
whole -Xptxas -v output, to ``--out`` (default
``smoke_run/sweep_probe.jsonl``).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# name -> (case dims, physics and deck tag of chip_smoke, compared blocks,
# the form's library, matrix solver)
FORMS = {"sst": ((256, 64, 32), "sst", "rusanov", None, "lusgs_sweep",
                 "lusgs"),
         "block_sst": ((256, 64, 32), "sst", "rusanov", None,
                       "blusgs_sweep", "blusgs"),
         "tp": ((256, 64, 32), "sst", "tp", None, "lusgs_sweep_tp",
                "lusgs"),
         "roe_tp": ((256, 64, 32), "sst", "roe_tp", None,
                    "lusgs_sweep_roe_tp", "lusgs"),
         "roe": ((256, 64, 32), "sst", "roe", None, "lusgs_sweep_roe",
                 "lusgs"),
         "tp_ns7": ((96, 120, 1), "h2air7", "tp_gas", (0,),
                    "lusgs_sweep_tp_ns7", "lusgs"),
         "block_tp": ((256, 64, 32), "sst", "tp", None, "blusgs_sweep_tp",
                      "blusgs"),
         "block_roe_tp": ((256, 64, 32), "sst", "roe_tp", None,
                          "blusgs_sweep_roe_tp", "blusgs"),
         "block_p5": ((48, 60, 1), "n2o2_ch4x", "tp_gas", (0,),
                      "blusgs_sweep_tp", "blusgs"),
         "block_air5": ((48, 60, 1), "air5", "tp_gas_cfl1", (0,),
                        "blusgs_sweep_tp", "blusgs")}


def marks_cost(solver, system, du0) -> dict:
    """ms of the variant (a) pair of the blocks of ``du0``, one block
    after the other, with the library's marks and without them, each the
    mean of its two windows of ``chip_smoke.KERNEL_REPS`` pairs"""
    import numpy as np
    import torch
    import chip_smoke as cs
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    prims, auxs, inv_diag, bs, _ = system
    library = ls.form_library(solver.phys, solver.cfg)

    def pair(lib):
        def run():
            for bi, du in du0.items():
                du = du.clone()
                for forward in (True, False):
                    ls._kernel_sweep(solver.phys, solver.cfg,
                                     solver.plans[bi], prims[bi], du,
                                     bs[bi], *inv_diag[bi], auxs[bi],
                                     forward, library=lib)
        return run

    runs = {"with marks": pair(f"{library}_probe"),
            "without marks": pair(library)}
    for run in runs.values():
        run()
    ms = {k: [] for k in runs}
    for k in ("with marks", "without marks", "without marks", "with marks"):
        ms[k].append(cs.timed_ms(torch, runs[k], cs.KERNEL_REPS))
    out = {f"{k} ms": v for k, v in ms.items()}
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    out["marks cost"] = mean["with marks"] / mean["without marks"] - 1.0
    return out


def form_system(name: str):
    """(solver, its linear system with du0 on the form's compared blocks)
    of form ``name`` (FORMS), in ``smoke_run/sweep_probe_<name>``"""
    import chip_smoke as cs
    dims, physics, deck, blocks, _, solver_name = FORMS[name]
    wd = os.path.join(REPO, "smoke_run", f"sweep_probe_{name}")
    solver = cs.make_solver(wd, dims, "cuda", solver_name, 1, physics, deck)
    prims, auxs, inv_diag, bs, du0 = cs.linear_system(solver)
    if blocks is not None:
        du0 = {bi: du for bi, du in du0.items() if bi in blocks}
    return solver, (prims, auxs, inv_diag, bs, du0)


def pair_ms(solver, system) -> dict:
    """the variant (a) or (c) pair of the system's blocks as ``Solver.run``
    launches it: one untimed pair, then two windows of
    ``chip_smoke.KERNEL_REPS`` pairs; with the critical path's steps"""
    import numpy as np
    import torch
    import chip_smoke as cs
    du0 = system[4]

    def pair():
        return cs.sweep_pair(solver, system, du0, None)

    pair()
    windows = [cs.timed_ms(torch, pair, cs.KERNEL_REPS) for _ in range(2)]
    steps = 2 * max(solver.plans[bi].nplanes for bi in du0)
    ms = float(np.mean(windows))
    return dict(windows_ms=windows, pair_ms=ms, steps=steps,
                us_per_step=1e3 * ms / steps)


def probe(name: str, check: bool, marks: bool = False) -> dict:
    import numpy as np
    import chip_smoke as cs
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    solver, system = form_system(name)
    phys, cfg = solver.phys, solver.cfg
    prims, auxs, inv_diag, bs, du0 = system
    out = dict(form=name, library=ls.form_library(phys, cfg),
               card=cs.card_line())
    if check:
        kern = cs.sweep_pair(solver, system, du0, None)
        plain = cs.sweep_pair(solver, system, du0, None, kernel=False)
        max_abs, rel = cs.sweep_errors(kern, plain)
        out.update(max_abs_err=max_abs, max_rel=float(rel.max()),
                   within_rtol=bool(rel.max() <= cs.SWEEP_RTOL))

    out.update(pair_ms(solver, system))
    parts = []
    for forward in (True, False):
        for bi, du in du0.items():
            parts.append(ls.clock_breakdown(
                phys, cfg, solver.plans[bi], prims[bi], du.clone(), bs[bi],
                *inv_diag[bi], auxs[bi], forward))
    slots = (ls.BLOCK_CLOCK_SLOTS if cfg.get("block_matrix")
             else ls.CLOCK_SLOTS)
    cycles = {k: float(np.mean([p[k] for p in parts])) for k in slots}
    total = sum(cycles.values())
    out.update(cycles_per_plane=cycles,
               share={k: v / total for k, v in cycles.items()},
               cycles_per_plane_sum=total,
               launch_us=[p["wavefront ns"] / 1e3 for p in parts],
               prepass_us=[p["pre-pass ns"] / 1e3 for p in parts
                           if "pre-pass ns" in p],
               sm_clock=subprocess.run(
                   ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                    "--format=csv,noheader"], capture_output=True,
                   text=True).stdout.strip())
    if marks:
        out.update(marks_cost(solver, system, du0))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forms", nargs="+", default=list(FORMS),
                    choices=list(FORMS))
    ap.add_argument("--check", action="store_true",
                    help="hold each pair to its plain version first")
    ap.add_argument("--marks", action="store_true",
                    help="time each pair with and without the step "
                         "clocks' marks")
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_run",
                                                  "sweep_probe.jsonl"),
                    help="the whole record, JSON lines")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_probe: needs a card", flush=True)
        return 1
    import chip_smoke as cs
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.utils.build import load_cuda_libraries
    names = {FORMS[f][4] for f in args.forms}
    # the forms' own libraries and the probe's builds, all at once
    libs = load_cuda_libraries(sorted(names | {f"{n}_probe"
                                               for n in names}))
    # the whole record to a file, a short one to the output
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    ok = True
    with open(args.out, "w") as f:
        for lib, (_, info) in libs.items():
            line = dict(library=lib, seconds=info["seconds"],
                        ptxas=info["ptxas"].splitlines())
            f.write(json.dumps(line) + "\n")
            print(json.dumps(dict(library=lib, seconds=info["seconds"],
                                  ptxas=cs.ptxas_report(info["ptxas"]))),
                  flush=True)
        for name in args.forms:
            out = probe(name, args.check, args.marks)
            ok = ok and out.get("within_rtol", True)
            f.write(json.dumps(out) + "\n")
            print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    # run as a file: import the checkout's package and chip_smoke.py,
    # never this directory's modules
    sys.path[0] = REPO
    sys.exit(main())
