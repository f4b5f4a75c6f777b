"""Sweep kernel pairs of some decks in this checkout and another, in turns,
on one GPU.

    python3 aither_tpu_torch/utils/pair_turns.py --against DIR
        [--libraries NAME ...] DECK [DECK ...]

A DECK is ``case:physics:solver:tag[:b]``: case ``A`` (2 x 96x120x1) or
``S`` (2 x 48x60x1, ``chip_smoke.SMALL_DIMS``), block 0 alone, as
``chip_smoke.py`` compares them, or ``B`` (2 x 256x64x32, both blocks),
and the physics, matrix solver and deck tag of ``chip_smoke.py``
(``PHYSICS``, ``TIME_DECKS``), e.g. ``B:sst:lusgs:roe`` or
``S:n2o2_ch4x:blusgs:tp_gas``; a last field ``b`` times the pair with the
lagged term (variant (b), or (c)+(b) for blusgs: the lagged sums of
``implicit.offdiag_sum``, as ``chip_smoke.compare_sweeps`` takes them),
e.g. ``B:sst:lusgs:rusanov:b``.  For each checkout,
in the order DIR, this, this, DIR (DIR another checkout, e.g. the parent's
unpacked under a git-ignored directory), a process of its own imports that
checkout's package and ``chip_smoke.py``, builds each deck's Solver on the
card, takes its first linear system (``chip_smoke.linear_system``) and
times its variant (a) or (c) pair (or with the lagged term) as
``Solver.run`` launches it: one
untimed pair, then three windows of ``chip_smoke.KERNEL_REPS`` pairs (CUDA
events).  It prints one JSON line per checkout and deck (the windows, their
median and the median over the critical path's steps: on the small decks
a first window now and then takes several times the others), then one
per deck with both checkouts' means of those medians and their ratio.
``--libraries`` first builds the named libraries
(``utils.build.load_cuda_libraries``) in both checkouts at once, one nvcc
per library, so that no deck of a turn waits for a build; one JSON line
per checkout with its build seconds and ptxas reports.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DIMS = {"A": (96, 120, 1), "B": (256, 64, 32), "S": (48, 60, 1)}


def worker(tree: str, tag: str, decks) -> None:
    """run in a process whose sys.path starts at ``tree``: one JSON line a
    deck"""
    import numpy as np
    import torch
    import chip_smoke as cs
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver import implicit as imp
    assert ls.__file__.startswith(os.path.abspath(tree)), ls.__file__
    for deck in decks:
        case, physics, solver_name, deck_tag, *lagged = deck.split(":")
        wd = os.path.join(REPO, "smoke_run",
                          f"pair_turns_{tag}_{deck.replace(':', '_')}")
        s = cs.make_solver(wd, DIMS[case], "cuda", solver_name, 1, physics,
                           deck_tag)
        prims, auxs, inv_diag, bs, du0 = cs.linear_system(s)
        if case != "B":
            du0 = {0: du0[0]}
        system = (prims, auxs, inv_diag, bs, du0)
        extras = None
        if lagged == ["b"]:
            extras = {b.index: tuple(imp.offdiag_sum(
                s.phys, s.cfg, b, prims[b.index], du0[b.index], side,
                auxs[b.index]) for side in ("upper", "lower"))
                for b in s.mg_cases[0].blocks if b.index in du0}

        def pair():
            return cs.sweep_pair(s, system, du0, extras)

        pair()
        windows = [cs.timed_ms(torch, pair, cs.KERNEL_REPS)
                   for _ in range(3)]
        ms = float(np.median(windows))
        steps = 2 * max(s.plans[bi].nplanes for bi in du0)
        print(json.dumps(dict(
            tag=tag, deck=deck, library=ls.form_library(s.phys, s.cfg),
            card=cs.card_line(), windows_ms=windows, ms=ms,
            us_per_step=1e3 * ms / steps)), flush=True)
        del s, system, prims, auxs, inv_diag, bs, du0, extras
        torch.cuda.empty_cache()


# run in a checkout's process by --libraries: build and report
_BUILD = """
import json, sys
import chip_smoke as cs
from aither_tpu_torch.utils.build import load_cuda_libraries
libs = load_cuda_libraries(sys.argv[2:])
print(json.dumps(dict(tag=sys.argv[1], libraries={
    n: dict(seconds=i["seconds"], ptxas=cs.ptxas_report(i["ptxas"]))
    for n, (_, i) in libs.items()})), flush=True)
"""


def build_both(trees, names) -> int:
    """build ``names`` in every checkout of ``trees`` ({tag: root}) at
    once; the first failing process's return code, else 0"""
    procs = {tag: subprocess.Popen(
        [sys.executable, "-c", _BUILD, tag, *names], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=tree,
        env=dict(os.environ, PYTHONPATH=tree))
        for tag, tree in trees.items()}
    rc = 0
    for proc in procs.values():
        out, err = proc.communicate()
        sys.stdout.write(out)
        if proc.returncode != 0:
            sys.stderr.write(err)
            rc = rc or proc.returncode
    return rc


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", required=True, metavar="DIR",
                    help="the other checkout's root")
    ap.add_argument("--libraries", nargs="+", default=[], metavar="NAME",
                    help="build these libraries in both checkouts first")
    ap.add_argument("decks", nargs="+", metavar="DECK")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "TAG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker, args.decks)
        return 0
    other = os.path.abspath(args.against)
    if args.libraries:
        rc = build_both({"against": other, "this": REPO}, args.libraries)
        if rc:
            return rc
    means = {}
    for n, (tree, name) in enumerate(((other, "against"), (REPO, "this"),
                                      (REPO, "this"), (other, "against"))):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--against", other,
             "--worker", tree, f"{name}{n}", *args.decks],
            capture_output=True, text=True, cwd=tree,
            env=dict(os.environ, PYTHONPATH=tree))
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        for ln in proc.stdout.splitlines():
            d = json.loads(ln)
            means.setdefault(d["deck"], {}).setdefault(name, []).append(
                d["ms"])
    for deck, m in means.items():
        a = sum(m["against"]) / len(m["against"])
        t = sum(m["this"]) / len(m["this"])
        print(json.dumps(dict(deck=deck, against_ms=a, this_ms=t,
                              this_over_against=t / a)), flush=True)
    return 0


if __name__ == "__main__":
    # run as a file: import the checkout's package and chip_smoke.py (the
    # worker's checkout, else this one), never this directory's modules
    sys.path[0] = (os.path.abspath(sys.argv[sys.argv.index("--worker") + 1])
                   if "--worker" in sys.argv else REPO)
    sys.exit(main())
