#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aither_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths — the implicit solver with scalar LU-SGS (lusgs:
the viscous residual on the hand-written fused kernel csrc/viscous_march.cu,
the sweeps on the hand-written csrc/lusgs_sweep.cu) and with block-matrix
LU-SGS (blusgs: the sweeps on the hand-written csrc/blusgs_sweep.cu), for
every single-species physics: Euler, laminar Navier-Stokes, LES (WALE) and
RANS (Wilcox 2006 k-omega, SST 2003, SST-DES), and for calorically perfect
mixtures (N2/O2 with Schmidt diffusion, hot five-species air frozen and
reacting; the mixture forms of both sweep kernels), the other linear
solvers and time integrators, FAS multigrid, and every boundary
condition — on the generated two-block flat plate
(aither_tpu_torch/cases.py) and checks them, the remaining physics:
WENO and WENO-Z at three ghost layers, AUSMPW+, centralFourth and a
thermally perfect gas (the thermally perfect forms of both sweep
kernels), runs over ranks, and the last forms: the thermally perfect
approximateRoe sweeps and species counts above 5 (seven and sixteen).
Phases, each printing its own lines:

 1. device facts: the card's name and power limit, torch and CUDA
    versions, nvcc; exits non-zero without CUDA;
 2. build: the three kernels from csrc/ as sixteen libraries, one nvcc
    each, started together in three groups (time, ptxas report: registers
    and spills of every instantiation): FIRST_LIBRARIES (the Rusanov
    builds of both sweeps for 1-5 species and the viscous kernel), waited
    for here; then, in a thread of lower priority that builds them behind
    the phases, DEFERRED_LIBRARIES (the approximateRoe and thermally
    perfect builds of both sweeps for 1-5 species), their report printed
    when phase 11 waits for them, and the nine libraries of phase 17
    (LAST_LIBRARIES: the thermally perfect approximateRoe builds of both
    sweeps, the seven- and sixteen-species builds and the seven-species
    thermally perfect approximateRoe one), their report printed when
    phase 17 waits for them;
 3. kernels against their plain PyTorch versions at the main paths'
    shapes, on case A (2 x 96x120x1, 23k cells) and case B (2 x 256x64x32,
    1.05M cells), identical inputs, times with CUDA events (a sweep pair:
    its checked plain run, one untimed kernel pair, then the kernel twice;
    the viscous residual:
    plain, the kernel's first window with its cudaMalloc calls, kernel,
    kernel, plain), SST 2003:
    - the scalar sweep pair without (variant a) and with (variant b) the
      lagged term, and the block sweep pair of the blusgs deck without
      (variant c) and with (variant c+b) it (at case B; at case A on the
      paths of phases 12 and 13): max relative difference per equation
      within SWEEP_RTOL;
    - the viscous residual of every block on a seeded 1%-perturbed state:
      every output within |kernel - plain| <= VISC_ATOL max|plain| +
      VISC_RTOL |plain|;
    - per sweep form: the pair's time beside the plane-per-launch
      kernel's (BEFORE_MS, from PERF.md), the critical path (2 x the
      largest block's ni+nj+nk-2 planes: the blocks of a sweep run
      concurrently, as Solver.run launches them) and the time of one step
      of it;
 4. main path, matrixSweeps 1: Solver(case B, device="cuda").run(
    MAIN_ITERATIONS) with the launch counters set to 0 before and read
    after: sweep launches = iterations x 2 x blocks (one per block and
    sweep, each after one reset of its schedule), viscous kernel
    launches = iterations x blocks, each timed where it runs by CUDA
    events (kernels/viscous_march.TIMINGS); every L2 finite; one .resid row per
    iteration; iterations/s from iteration 3 on, Mcell-iterations/s and
    peak device memory;
 5. the lagged-term path, matrixSweeps 2: the same on case B for
    LAGGED_ITERATIONS, sweep launches = iterations x 2 x 2 x blocks
    (every sweep takes the lagged term: the matrix is initialised);
 6. reference: the small test case run on cuda and on cpu (plain versions)
    gives the same raw residual L2 history within REF_RTOL: SST with lusgs
    and blusgs at matrixSweeps 1 and 2; Euler, laminar, LES and Wilcox
    with lusgs; laminar and Wilcox with blusgs; N2/O2 SST with lusgs and
    the reacting five-species air with blusgs (REACTING_BLOCK_RTOL);
    WENO-Z, AUSM and centralFourth SST lusgs (and, once their libraries
    are built, at the start of phase 11 SST approximateRoe and thermally
    perfect hot air SST, each with lusgs and blusgs, and at the start of
    phase 17 thermally perfect hot air approximateRoe SST lusgs and
    seven-species hydrogen-air SST blusgs);
 7. the blusgs path: Solver(case B with matrixSolver blusgs).run(
    BLOCK_ITERATIONS) at matrixSweeps 1 (variant c), then
    BLOCK_LAGGED_ITERATIONS at matrixSweeps 2 (variant c+b), checked as in
    phases 4-5: block sweep launches = iterations x matrixSweeps x 2 x
    blocks, no scalar sweep and no viscous kernel launch (the block
    solvers take the plain viscous residual, as in the JAX package);
 8. the other physics (NEW_DECKS), every solver built once and used for
    its kernels' comparison and then for its drive: each new form of the
    sweeps (5 equations inviscid, 5 equations viscous, Wilcox; scalar and
    block) and each new branch of the viscous residual (laminar, WALE,
    Wilcox; WALE also on the unperturbed field) against its plain version
    as in phase 3 (from this phase on, the sweep pair of a case-A or
    case-S deck on block 0 alone, COMPARED_BLOCKS, and a case-B pair run
    on both blocks but held against the plain version on block 0,
    PLAIN_BLOCKS), then Solver.run(NEW_ITERATIONS)
    checked as in phase 4
    (the viscous kernel launches iterations x blocks times on a viscous
    lusgs deck, never on blusgs or Euler).  Case B: Wilcox and LES with
    lusgs, laminar and Wilcox with blusgs (their viscous kernel compared,
    their sweep forms at case A only).  Case A: those again at
    matrixSweeps 2 (every new form without and with the lagged term),
    Euler with both solvers at matrixSweeps 1 and 2, laminar (its
    viscous kernel; its sweep form is LES's) and SST-DES with lusgs.  The
    Euler decks start from a seeded 1%-perturbed state (the Euler plate
    is a uniform flow with roundoff-level residuals);
 9. multispecies (MIXTURE_DECKS), every solver built once, compared and
    driven as in phase 8: on case S the scalar and block sweeps of N2/O2
    SST with Schmidt diffusion (2 species) and of reacting five-species
    air (laminar, Schmidt; 5 species), each without and with the lagged
    term, of the inviscid N2/O2 deck, and of frozen three- and
    four-species air (one form with and one without the lagged term on
    each solver), against their plain versions; drives of every compared
    form, the reacting deck's with lusgs and blusgs among them; on case B
    N2/O2 SST lusgs at matrixSweeps 1 and frozen five-species air laminar
    blusgs at matrixSweeps 2, driven by Solver.run(MIXTURE_ITERATIONS)
    (their forms compared at case S).  A
    mixture's viscous residual is the plain version (the fused kernel
    covers one species, as in the JAX package): no viscous kernel
    launch;
10. the viscous kernel on a ragged plate (RAGGED_DIMS, 2 x 51x44x37, whose
    dims the kernel's default tiles and segments do not divide), SST,
    Wilcox, LES and laminar, each against its plain version as in phase 3;
11. the other linear solvers and time integrators (SOLVER_DECKS, decks
    of TIME_DECKS), every solver built once, compared and driven as in
    phase 8: on case B SST lusgs with the approximateRoe off-diagonal (the
    Roe forms of the scalar sweep with and without the lagged term against
    their plain versions; its drive launches the Roe sweep and K2), SST
    dplur at matrixSweeps 4 (K2, no sweep launch) and SST bdf2 with dual
    time (2 time steps of 3 nonlinear iterations); on case A the Roe forms
    of both sweeps for SST, laminar, Euler, Wilcox and the mixtures of 2-5
    species, each compared and driven, then explicitEuler (Euler), rk4
    (laminar: K2 on an explicit path), crankNicholson (Wilcox) and bdplur
    (laminar), each driven.  Phase 6 holds SST dplur, laminar rk4 and SST
    bdf2 cuda against cpu, and the start of this phase SST approximateRoe
    lusgs and blusgs;
12. multigrid (MG_DECKS), every solver built once, compared and driven:
    case B SST lusgs with a 3-level W cycle (the host time to build the
    levels and the cells of each printed; on each coarse level its own
    linear system with its forcing, captured in one iteration, gives the
    sweep pair of variant b, held against its plain version; K2 on a
    level-1 block against its plain version; then Solver.run with exactly
    40 sweep launches (10 pairs: 2 of variant a on level 0, 8 of b below
    it) and 8 K2 launches (2 + 2 + 4: level 2 is restricted to twice) an
    iteration), case B SST dplur at matrixSweeps 4 with a 2-level V cycle
    at CFL 1000 (the solver settings of the reference's
    turbFlatPlate-mg-rans deck: 4 K2 launches an iteration, no sweep) and
    case A SST blusgs with a 2-level V cycle (the coarse level's c+b pair
    against plain; 12 block-sweep launches an iteration, no scalar sweep
    or K2).  Each drive prints iterations/s, peak memory and the share of
    the iteration spent below level 0 (restriction from level 0 and the
    coarse cycles, synchronised at their ends).  Phase 6 also holds SST
    lusgs with a 3-level W cycle and SST blusgs with a 2-level V cycle
    cuda against cpu;
13. boundaries (BC_DECKS, layouts of BC_LAYOUTS), every solver built once,
    compared and driven BC_ITERATIONS steps: case B SST lusgs with a
    stagnation inlet, pressure outlet and periodic span (the (a) pair and
    K2 on block 0 against their plain versions; exactly 4 sweep and 2 K2
    launches an iteration; its steps/s beside phase 4's and the share of
    a further run spent in the boundary pass, timed between
    synchronisations), with nonreflecting (LODI) inlet and outlet (the (a)
    pair; 4 sweep launches, no K2: the JAX package's route for the
    pressure gradient; the carried dt's range) and with the wall law (4
    sweep launches, no K2; the wall faces' y+ shares and the wall-law
    solve's time an iteration by CUDA events); case A SST blusgs with the
    wall law (the (c) pair; 4 block-sweep launches) and a Mach-2 Euler
    plate with the supersonic pair (the Euler (a) pair; 4 launches).
    Phase 6 also holds the periodic, LODI and wall-law decks cuda against
    cpu.  The wall-law decks take cases.WALL_LAW_CLUSTER;
14. files (files_phase): the case-B SST lusgs deck (matrixSweeps 1,
    Rusanov, the constant FILES_CFL) through the CLI with files,
    FILES_ITERATIONS steps with output and a restart every FILES_EVERY,
    the variables of cases.FILES_OUTPUT_VARIABLES (every aux branch of
    Solver.write_output), wall (cases.FILES_WALL_VARIABLES) and nodal
    files: exactly 16 K1 (a) and 8 K2 launches (the output evaluation
    takes the plain viscous residual, as in the JAX package); then the
    CLI resumed from plate_2.rst in a second directory for 2 steps (8 and
    4 launches): its .resid steps 2 and 3, its l2_first the file's, its
    raw L2 within RESTART_RTOL of the uninterrupted run's; every file of
    both runs parsed by the port's readers (block dims, variable counts,
    finite values); the seconds of write_output (cell-center, wall,
    nodal) and write_restart, the step seconds with and without a write,
    and the file sizes; then a case-A point-cloud deck
    (cases.write_cloud, every point twice) whose initial state on cuda
    equals the cpu one bit for bit, driven 2 steps.  Phase 6 also holds
    a small files deck's .fun and .rst values cuda against cpu
    (reference_files);
15. the remaining physics (PHYSICS_DECKS, decks of TIME_DECKS), every
    solver built once, compared and driven: case-B SST lusgs with WENO-Z
    (three ghost layers; the slice's main path): the (a) and (b) pairs and
    K2 on every block against their plain versions (recorded as the rows'
    'g3'), then 3 steps with exactly 4 K1 and 2 K2 launches a step; WENO,
    AUSMPW+ (4 and 2) and centralFourth (4 and 0: the plain viscous
    residual, the JAX package's route) driven the same; the thermally
    perfect forms of both sweeps against their plain versions with their
    mean Ridder iterations (case-B hot air SST lusgs (a) and (b), driven
    with 4 K1 and 0 K2 launches a step; case-S hot air SST blusgs (c)
    and (c)+(b), N2/O2 SST lusgs (a) and reacting five-species air
    blusgs (c) at CFL 1), each form driven on case S; and the case-B
    hot air SST blusgs (c) pair (the block thermally perfect form's
    pre-pass and persistent CTAs), timed on both blocks, compared on
    block 0 (PLAIN_BLOCKS) and driven 2 steps;
16. multi-rank runs on the card (ranks_phase, RANK_DECKS): each deck run
    on one rank (the reference) and then over its ranks, processes of
    this script (``--rank-worker``, rank_worker) that share the card and
    join by the torchrun environment; rank 0 alone is given the case and
    sends it to the others (distribute_case); each rank holds only its
    own blocks on the card and exchanges connection ghosts over gloo with
    host staging.  Case-B SST lusgs over 2 ranks, a block each: each
    rank's K1 (a) pair and K2 on its own block against their plain
    versions (as in phase 3), then RANK_ITERATIONS steps with exactly 2
    K1 and 1 K2 launches per own block a step (K1 variant d: the sweeps
    of each rank over its own whole blocks); case-A SST blusgs on a
    2-level V cycle at --nproc 4 over 4 ranks (the four connections'
    corner exchange), 6 block-sweep launches per own block a step.  Every
    rank's raw L2 within REF_RTOL of the one-rank run's (bit for bit
    printed), its .resid rows beside the one-rank ones; per rank its pair
    and K2 times, steps/s beside the one-rank run's (ranks time-sliced on
    one card: no speed-up is claimed), the bytes exchanged a step, the
    exchange's share of its run (timed apart: the device synchronised at
    each swap) and its peak device memory;
17. the last forms (LAST_DECKS; the libraries of LAST_LIBRARIES, each
    solver's form library checked to be one of them), every solver built
    once, compared and driven: case-B hot one-species air thermally
    perfect approximateRoe SST lusgs (the slice's main path: the
    ``lusgs_sweep_roe_tp`` (a) pair against plain with its mean Ridder
    iterations, then 4 steps with exactly 4 K1 and 0 K2 launches a step)
    and frozen seven-species hydrogen-air SST lusgs (``lusgs_sweep_ns7``,
    the (a) pair, 4 steps at 4 K1 a step); on case S (SMALL_DIMS, 2 x
    48x60x1), compared on block 0 (COMPARED_BLOCKS) and driven 2 steps:
    the thermally perfect
    approximateRoe (b), (c) and (c)+(b) of hot air (and the (c) pair at
    case B, the block form's stage: timed on both blocks, compared on
    block 0 and driven 1 step; the case-S block decks at CFL
    1: at the CFL ramp the plain block sweep gives NaN from the second
    step on, on the CPU) and its (a) of N2/O2, the seven-species (b), (c),
    (c)+(b), approximateRoe (a) and thermally perfect (a), and the
    sixteen-species (every species of the fluid database and a tracer)
    (a) and (c) (the block deck at CFL 1, for the same reason), the
    thermally perfect (a) and (c) of N2/O2 with the tracer
    CH4x, a species of eleven vibrational modes (cases.MIXTURES
    "n2o2_ch4x"), the thermally perfect and thermally perfect
    approximateRoe (a) of frozen five-species air and the thermally
    perfect approximateRoe (a) of seven species (``_roe_tp_ns7``), the
    five- and seven-species decks at CFL 1.

Every comparison of a pre-pass form (every form of the scalar sweep, and
every form of the block sweep but the inviscid calorically perfect
Rusanov ones: they store the old-state terms once per face or once per
cell in a pre-pass; the thermally perfect scalar ones also invert q + du
once per cell) also prints its pair and per-step time beside the earlier
design's (REDESIGN_BEFORE_MS, text from PERF.md) and the traffic of its
own work space, outside the bound; its row holds the traffic in
'work_space_bytes', and the pre-pass launches of its driven path in
'prepass_launches' (each drive checks one before every sweep launch of a
pre-pass form).  Every form runs on persistent CTAs.  The parts of a
form's step by the kernel's step clocks come from
aither_tpu_torch/utils/sweep_probe.py, through builds of the probe's own
(the marks cost 1-3% of a pair, so the libraries here carry none).  A thermally perfect scalar mixture form
whose deck compares only variant (a) (N2/O2 in phase 15; N2/O2
approximateRoe and seven species in phase 17) is held against its plain
version in variant (b) too, on the same solver; no driven path takes
those, so they are no rows of the kernels line.

The viscous kernel's lines (phases 3, 8, 10) print its time beside the
first design's (VISC_BEFORE_MS, text from PERF.md) and each block's launch:
tile, segment, CTAs, dynamic shared memory, CTAs per SM and registers;
phase 2 fails if an instantiation of it spills; a sweep instantiation's
spill is printed.  A line "phase N done" gives the seconds since the start
after every phase.

Then, on lines of their own: the card's name and power limit, the kernels
JSON object (one row per kernel form; its times from case B where the form
ran there, else case A, else case S, named in the row as 'case';
'plain_blocks', where the plain version held only those blocks of it;
a pre-pass form's 'work_space_bytes', the traffic of its own work space,
outside the bound, and 'prepass_launches'; a sweep row's 'registers',
ptxas's registers and spills of its instantiations (sm_90a: the forward
and backward wavefront and the pre-pass); 'launches_case' is the
case of the driven path that gave 'launches'; a viscous row also has
'cold_ms', the first window after the plain run, and 'path_ms', the kernel
inside Solver.run per iteration, with 'path_case'; a row of a form on
the multigrid path also has 'mg_launches', its launches in each phase-12
drive, and 'mg_levels', its comparisons on the coarse levels; a row of
a form on a boundary path has 'bc_launches', its launches in each phase-13
drive, and 'bc_compared', its comparisons there; the SST K1 (a) and K2
rows have 'files_launches', their launches in each phase-14 run; the K1
(d) row's times are the slower rank's, with each rank's in 'ranks'; a
row compared on some blocks only has them in 'compared_blocks', and the
library of a sweep row is named at the end of its name), and
last
{"ok": true, "device": {...}}.  Any failure exits non-zero before the last
line.  Case files go to ./smoke_run/ (git-ignored).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, "smoke_run")
# cases.WALL_LAW_CLUSTER and cases.TP_AIR, kept here: the script reads
# nothing of the package before it has checked the card
WALL_LAW_CLUSTER = 1.0
TP_AIR = dict(density=0.0882, wall_temperature=3500.0,
              thermodynamic_model="thermallyPerfect")

MAIN_ITERATIONS = 12
LAGGED_ITERATIONS = 6
BLOCK_ITERATIONS = 6
BLOCK_LAGGED_ITERATIONS = 5
NEW_ITERATIONS = 2       # phase 8, every deck
MG_ITERATIONS = 3        # phase 12, every deck
MIXTURE_ITERATIONS = 2   # phase 9, every deck
STEADY_FROM = 3          # iterations/s averaged from this iteration on
KERNEL_REPS = 5          # timed kernel calls per window
# the plane-per-launch sweep pairs (one launch per hyperplane) these
# kernels replace, ms: PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W
BEFORE_MS = {("case B", "lusgs_sweep", False): "28.18",
             ("case B", "lusgs_sweep", True): "29.82",
             ("case B", "blusgs_sweep", False): "24.43",
             ("case B", "blusgs_sweep", True): "25.01",
             ("case A", "lusgs_sweep", False): "9.93",
             ("case A", "lusgs_sweep", True): "10.79",
             ("case A", "blusgs_sweep", False): "9.62",
             ("case A", "blusgs_sweep", True): "10.06"}
# the pre-pass forms' sweep pairs of the earlier design (the old-state
# terms on the plane chain: both Roe fluxes per neighbour, or every
# neighbour's q + du inverted on its direction's lane), ms, by (case,
# kernel, form, lagged term), case A on block 0 (COMPARED_BLOCKS): PERF.md
# section 6 (the thermally perfect scalar forms' design with a Ridder
# inversion per neighbour, the approximateRoe forms' with both fluxes on
# the plane chain, the block thermally perfect forms' with the old state's
# thermodynamics on it and the Roe ones' Ridder inversion per neighbour,
# the calorically perfect Rusanov forms' with the old flux, sound speed,
# radii or conductivity per face on it and a CTA a tile), NVIDIA H100
# 80GB HBM3, 700 W
REDESIGN_BEFORE_MS = {
    ("case B", "lusgs_sweep", (1, 7, True, False, False, False), False):
        "6.31",
    ("case B", "lusgs_sweep", (1, 7, True, False, False, False), True):
        "6.45",
    ("case B", "blusgs_sweep", (1, 7, True, False, False, False), False):
        "9.27",
    ("case B", "blusgs_sweep", (1, 7, True, False, False, False), True):
        "10.39",
    ("case B", "lusgs_sweep", (7, 13, True, False, False, False), False):
        "13.92",
    ("case B", "lusgs_sweep", (2, 8, True, False, False, False), False):
        "7.11",
    ("case B", "blusgs_sweep", (5, 9, True, False, False, False), True):
        "23.35",
    ("case B", "lusgs_sweep", (1, 7, True, False, False, True), False):
        "19.30",
    ("case B", "lusgs_sweep", (1, 7, True, False, False, True), True):
        "19.35",
    ("case B", "lusgs_sweep", (1, 7, True, False, True, True), False):
        "26.14",
    ("case B", "lusgs_sweep", (1, 7, True, False, True, False), False):
        "10.706",
    ("case B", "lusgs_sweep", (1, 7, True, False, True, False), True):
        "10.379",
    ("case A", "blusgs_sweep", (1, 7, True, False, True, False), False):
        "3.597",
    ("case A", "blusgs_sweep", (1, 7, True, False, True, False), True):
        "3.674",
    ("case A", "blusgs_sweep", (1, 5, True, False, True, False), False):
        "3.110",
    ("case A", "blusgs_sweep", (1, 5, True, False, True, False), True):
        "3.152",
    ("case A", "lusgs_sweep", (1, 5, True, False, True, False), False):
        "2.873",
    ("case A", "lusgs_sweep", (1, 5, False, False, True, False), False):
        "2.521",
    ("case A", "blusgs_sweep", (1, 5, False, False, True, False), True):
        "2.763",
    ("case A", "lusgs_sweep", (1, 7, True, True, True, False), True):
        "3.232",
    ("case A", "blusgs_sweep", (1, 7, True, True, True, False), False):
        "3.620",
    ("case A", "lusgs_sweep", (2, 8, True, False, True, False), False):
        "3.909",
    ("case A", "blusgs_sweep", (2, 8, True, False, True, False), True):
        "4.420",
    ("case A", "lusgs_sweep", (5, 9, True, False, True, False), True):
        "4.741",
    ("case A", "blusgs_sweep", (5, 9, True, False, True, False), False):
        "5.425",
    ("case A", "lusgs_sweep", (3, 7, True, False, True, False), False):
        "3.909",
    ("case A", "blusgs_sweep", (4, 8, True, False, True, False), True):
        "4.875",
    ("case B", "blusgs_sweep", (1, 7, True, False, False, True), False):
        "11.326",
    ("case B", "blusgs_sweep", (1, 7, True, False, True, True), False):
        "17.333",
    ("case S", "blusgs_sweep", (1, 7, True, False, False, True), False):
        "1.541",
    ("case S", "blusgs_sweep", (1, 7, True, False, False, True), True):
        "1.58",
    ("case S", "blusgs_sweep", (1, 7, True, False, True, True), False):
        "3.886",
    ("case S", "blusgs_sweep", (1, 7, True, False, True, True), True):
        "3.86",
    ("case S", "blusgs_sweep", (5, 9, True, False, False, True), False):
        "2.748",
    ("case S", "blusgs_sweep", (3, 9, True, False, False, True), False):
        "4.125"}
# the fused viscous residual's first design (one thread per cell, each face
# evaluated by both its cells), ms for both blocks: PERF.md section 6, NVIDIA
# H100 80GB HBM3, 700 W (PRs 2 and 4)
VISC_BEFORE_MS = {("case B", "sst2003"): "1.642",
                  ("case B", "kOmegaWilcox2006"): "1.523",
                  ("case B", "wale"): "1.395", ("case B", "none"): "1.053",
                  ("case A", "sst2003"): "0.261",
                  ("case A", "kOmegaWilcox2006"): "0.152",
                  ("case A", "wale"): "0.150", ("case A", "none"): "0.181"}
# phase 10's ragged plate for the viscous kernel: its default plan divides
# none of its dims (viscous_march.viscous_tile: 3 x 32 columns over 44 x 37,
# segments of 13 over 51 planes), and the four branches
RAGGED_DIMS = (51, 44, 37)
RAGGED_PHYSICS = ("sst", "wilcox", "les", "laminar")
# one NVIDIA H100 SXM (data sheet): HBM rate; FP64 peak outside the tensor
# cores (the kernels are elementwise FP64)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# sweep kernels vs plain: max |kernel - plain| / max |plain| per equation.
# The two differ by FMA contraction and the order of the three directions'
# sums (~1e-16 relative per operation; the block kernel also sums each
# Jacobian row in another order), carried through the plane recurrence and
# the flux-difference cancellation (~2 digits).  The
# plate's spanwise momentum update is orders of magnitude smaller than
# the others' and shows the largest relative difference (2.1e-10 at case
# B, max abs 4.5e-16, on the H100).  The block sweep has no flux
# difference to cancel: 1.1e-15 at most (case B, H100).
SWEEP_RTOL = 1e-9
# viscous kernel vs plain, elementwise |kernel - plain| <= VISC_RTOL |plain|
# + VISC_ATOL max|plain of that output|: the bound the JAX package holds its
# own fused march to (rtol 1e-9, atol 1e-13; tests/test_pallas_residual.py),
# with the atol taken relative to each output's scale.  FMA contraction and
# the order of the six faces' sums are the differences.  The velocity and
# omega gradient averages reach 1.6e4 at the plate's wall clustering (case
# A), where one ulp is ~2e-12: an absolute atol of 1e-13 failed at case B
# by a factor 1.005, the largest difference there being 1.8e-12 (H100).
VISC_RTOL, VISC_ATOL = 1e-9, 1e-13
# cuda vs cpu raw L2 history of the small case: reduction order on the
# card, FMA in the kernels, amplified over REF_ITERATIONS implicit steps.
REF_RTOL = 1e-8
REF_ITERATIONS = 2
# the reacting blusgs deck's block diagonal holds the reference's
# forward-difference chemistry Jacobian (step 1e-10 rho): the card's and the
# CPU's exp differ by an ulp, which the quotient turns into ~1e-7 relative
# differences of the Jacobian (tests/test_torch_mixture.py), carried into
# the update (tests/test_torch_reacting_blusgs.py holds the port to the JAX
# package at 2e-6 on the same grounds)
REACTING_BLOCK_RTOL = 2e-6
# the approximateRoe and time-integration decks by tag: (time integrator of
# cases.TIME_INTEGRATORS, further write_plate_case keywords).  The
# hot-air decks take approximateRoe at CFL 1 ("roe_cfl1"): at the ramp
# 10-1000 the Roe sweeps of five-species air give NaN from the second or
# third iteration on, the plain sweep on the CPU as the kernel on the card
# and as the JAX package (du grows without bound along a sweep until the
# Roe flux of q + du overflows; PERF.md section 6)
ROE = dict(inviscid_flux_jacobian="approximateRoe")
TIME_DECKS = {
    "rusanov": ("implicitEuler", {}),
    "roe": ("implicitEuler", ROE),
    "roe_cfl1": ("implicitEuler", dict(ROE, cfl=(1.0, 0.0, 1.0))),
    "bdf2": ("bdf2", {}),
    "explicit": ("explicitEuler", {}),
    "rk4": ("rk4", {}),
    "cn": ("crankNicholson", {}),
    "mg3W": ("implicitEuler", dict(multigrid_levels=3, multigrid_cycle="W")),
    "mg2V": ("implicitEuler", dict(multigrid_levels=2)),
    "mg2V_cfl1000": ("implicitEuler", dict(multigrid_levels=2,
                                           cfl=(1000.0, 0.0, 1000.0))),
    "wenoZ": ("implicitEuler", dict(face_reconstruction="wenoZ")),
    "weno": ("implicitEuler", dict(face_reconstruction="weno")),
    "ausm": ("implicitEuler", dict(inviscid_flux="ausm")),
    "c4": ("implicitEuler",
           dict(viscous_face_reconstruction="centralFourth")),
    "tp": ("implicitEuler", TP_AIR),
    "tp_gas": ("implicitEuler", dict(thermodynamic_model="thermallyPerfect")),
    "tp_gas_cfl1": ("implicitEuler", dict(
        thermodynamic_model="thermallyPerfect", cfl=(1.0, 0.0, 1.0))),
    "roe_tp": ("implicitEuler", dict(ROE, **TP_AIR)),
    "roe_tp_cfl1": ("implicitEuler", dict(ROE, cfl=(1.0, 0.0, 1.0),
                                          **TP_AIR)),
    "roe_tp_gas": ("implicitEuler", dict(
        ROE, thermodynamic_model="thermallyPerfect")),
    "roe_tp_gas_cfl1": ("implicitEuler", dict(
        ROE, thermodynamic_model="thermallyPerfect", cfl=(1.0, 0.0, 1.0))),
    "cfl1": ("implicitEuler", dict(cfl=(1.0, 0.0, 1.0))),
}
ROE_REPLACES = ("aither_tpu/solver/implicit.py:113 roe_offdiagonal (scan "
                "path; no Pallas form)")
TP_REPLACES = ("aither_tpu/solver/pallas_sweep.py:239 (a thermally perfect "
               "deck takes the JAX package's scan sweep, implicit.py:89, "
               "137: use_pallas is off there)")

# name -> (equationSet, turbulenceModel, mixture of cases.MIXTURES or None)
PHYSICS = {"euler": ("euler", "none", None),
           "laminar": ("navierStokes", "none", None),
           "les": ("largeEddySimulation", "wale", None),
           "wilcox": ("rans", "kOmegaWilcox2006", None),
           "sst": ("rans", "sst2003", None),
           "sstdes": ("rans", "sstdes", None),
           "n2o2": ("rans", "sst2003", "n2o2"),
           "n2o2_euler": ("euler", "none", "n2o2"),
           "air5": ("navierStokes", "none", "air5"),
           "air5_frozen": ("navierStokes", "none", "air5_frozen"),
           "air3_frozen": ("navierStokes", "none", "air3_frozen"),
           "air4_frozen": ("navierStokes", "none", "air4_frozen"),
           "h2air7": ("rans", "sst2003", "h2air7_frozen"),
           "db16": ("rans", "sst2003", "db16_frozen"),
           "n2o2_ch4x": ("rans", "sst2003", "n2o2_ch4x")}
# phase 8: (case, physics, matrixSolver, matrixSweeps, sweep comparisons
# (with the lagged term or not), viscous comparisons ("perturbed" /
# "uniform" state)).  A solver's sweep comparisons do not depend on its
# matrixSweeps; its drive does: with matrixSweeps 2 every launch of the
# drive takes the lagged term.
NEW_DECKS = (
    ("case B", "wilcox", "lusgs", 1, (), ("perturbed",)),
    ("case B", "les", "lusgs", 1, (), ("perturbed",)),
    ("case B", "laminar", "blusgs", 1, (), ("perturbed",)),
    ("case B", "wilcox", "blusgs", 1, (), ()),
    ("case A", "euler", "lusgs", 1, (False,), ()),
    ("case A", "euler", "lusgs", 2, (True,), ()),
    ("case A", "euler", "blusgs", 1, (False,), ()),
    ("case A", "euler", "blusgs", 2, (True,), ()),
    ("case A", "laminar", "lusgs", 1, (), ("perturbed",)),
    ("case A", "les", "lusgs", 2, (False, True), ("perturbed", "uniform")),
    ("case A", "wilcox", "lusgs", 2, (False, True), ("perturbed",)),
    ("case A", "laminar", "blusgs", 2, (False, True), ()),
    ("case A", "wilcox", "blusgs", 2, (False, True), ()),
    ("case A", "sstdes", "lusgs", 1, (), ()),
)
# phase 9: (case, physics, matrixSolver, matrixSweeps, sweep comparisons).
# Every compared form is driven: the lagged forms by a matrixSweeps 2
# deck, the others by a matrixSweeps 1 deck (at case S: a plain block pair
# of five species takes 8 s on block 0 at case A).  The three- and four-species
# decks check the kernels' NS = 3 and 4 instantiations, each solver one
# form with and one without the lagged term.
MIXTURE_DECKS = (
    ("case S", "n2o2", "lusgs", 2, (False, True)),
    ("case S", "n2o2", "blusgs", 1, (False, True)),
    ("case S", "n2o2", "blusgs", 2, ()),
    ("case S", "air5", "lusgs", 1, (False, True)),
    ("case S", "air5", "lusgs", 2, ()),
    ("case S", "air5", "blusgs", 1, (False, True)),
    ("case S", "n2o2_euler", "lusgs", 1, (False,)),
    ("case S", "n2o2_euler", "blusgs", 1, (False,)),
    ("case S", "air3_frozen", "lusgs", 1, (False,)),
    ("case S", "air3_frozen", "blusgs", 2, (True,)),
    ("case S", "air4_frozen", "lusgs", 2, (True,)),
    ("case S", "air4_frozen", "blusgs", 1, (False,)),
    ("case B", "n2o2", "lusgs", 1, ()),
    ("case B", "air5_frozen", "blusgs", 2, ()),
)
# phase 11: (case, physics, matrixSolver, matrixSweeps, deck tag of
# TIME_DECKS, sweep comparisons, time steps driven).  Every compared form
# is driven; the case-B Roe lusgs deck's lagged form by the case-A one at
# matrixSweeps 2.  Frozen three- and four-species air give the Roe forms
# the species counts 3 and 4.
SOLVER_DECKS = (
    ("case B", "sst", "lusgs", 1, "roe", (False, True), 3),
    ("case B", "sst", "dplur", 4, "rusanov", (), 3),
    ("case B", "sst", "lusgs", 1, "bdf2", (), 2),
    ("case A", "sst", "lusgs", 2, "roe", (), 3),
    ("case A", "sst", "blusgs", 1, "roe", (False,), 3),
    ("case A", "sst", "blusgs", 2, "roe", (True,), 3),
    ("case A", "laminar", "blusgs", 1, "roe", (False,), 3),
    ("case A", "laminar", "blusgs", 2, "roe", (True,), 3),
    ("case A", "laminar", "lusgs", 1, "roe", (False,), 3),
    ("case A", "euler", "lusgs", 1, "roe", (False,), 3),
    ("case A", "euler", "blusgs", 2, "roe", (True,), 3),
    ("case A", "wilcox", "lusgs", 2, "roe", (True,), 3),
    ("case A", "wilcox", "blusgs", 1, "roe", (False,), 3),
    ("case A", "n2o2", "lusgs", 1, "roe", (False,), 3),
    ("case A", "n2o2", "blusgs", 2, "roe", (True,), 3),
    ("case A", "air5", "lusgs", 2, "roe_cfl1", (True,), 3),
    ("case A", "air5", "blusgs", 1, "roe_cfl1", (False,), 3),
    ("case A", "air3_frozen", "lusgs", 1, "roe", (False,), 3),
    ("case A", "air4_frozen", "blusgs", 2, "roe_cfl1", (True,), 3),
    ("case A", "euler", "lusgs", 1, "explicit", (), 3),
    ("case A", "laminar", "lusgs", 1, "rk4", (), 2),
    ("case A", "wilcox", "lusgs", 1, "cn", (), 3),
    ("case A", "laminar", "bdplur", 1, "rusanov", (), 3),
)

# phase 12: (case, physics, matrixSolver, matrixSweeps, deck tag of
# TIME_DECKS, launches per iteration {kernel: n}, compare the coarse
# levels' kernels).  Per iteration, with 2 blocks and matrixSweeps 1, a
# level visited v times relaxes 2 v pairs (pre and post) and the coarsest
# v pairs; each coarse visit computes its level's residual once
MG_DECKS = (
    ("case B", "sst", "lusgs", 1, "mg3W",
     {"lusgs_sweep": 40, "blusgs_sweep": 0, "viscous_march": 8}, True),
    ("case B", "sst", "dplur", 4, "mg2V_cfl1000",
     {"lusgs_sweep": 0, "blusgs_sweep": 0, "viscous_march": 4}, False),
    ("case A", "sst", "blusgs", 1, "mg2V",
     {"lusgs_sweep": 0, "blusgs_sweep": 12, "viscous_march": 0}, True),
)

# phase 13: the boundary layouts of write_plate_case (BC_LAYOUTS) and the
# decks (case, physics, matrixSolver, layout, launches per iteration
# {kernel: n} with 2 blocks, sweep pair compared, K2 compared on block 0).
# LODI needs the cell pressure gradient and the wall law its face values,
# so both take the plain viscous residual (no K2), as in the JAX package.
# The wall-law decks take a weaker clustering (cases.WALL_LAW_CLUSTER):
# every wall face's y+ lies in the wall law's bracket [10, 1e4] there
BC_LAYOUTS = {
    "stagnation_periodic": dict(inflow="stagnationInlet",
                                outflow="pressureOutlet", span="periodic"),
    "lodi": dict(inflow="inlet", outflow="pressureOutlet",
                 nonreflecting=True),
    "wall_law": dict(inflow="stagnationInlet", outflow="pressureOutlet",
                     wall_treatment="wallLaw", cluster=WALL_LAW_CLUSTER),
    "supersonic": dict(inflow="supersonicInflow",
                       outflow="supersonicOutflow", velocity=680.0),
}
BC_DECKS = (
    ("case B", "sst", "lusgs", "stagnation_periodic",
     {"lusgs_sweep": 4, "blusgs_sweep": 0, "viscous_march": 2}, True, True),
    ("case B", "sst", "lusgs", "lodi",
     {"lusgs_sweep": 4, "blusgs_sweep": 0, "viscous_march": 0}, True, False),
    ("case B", "sst", "lusgs", "wall_law",
     {"lusgs_sweep": 4, "blusgs_sweep": 0, "viscous_march": 0}, False,
     False),
    ("case A", "sst", "blusgs", "wall_law",
     {"lusgs_sweep": 0, "blusgs_sweep": 4, "viscous_march": 0}, True, False),
    ("case A", "euler", "lusgs", "supersonic",
     {"lusgs_sweep": 4, "blusgs_sweep": 0, "viscous_march": 0}, True, False),
)
BC_ITERATIONS = 3        # phase 13, every deck
# phase 15: (case, physics, matrixSolver, matrixSweeps, deck tag of
# TIME_DECKS, sweep comparisons, compare K2, steps driven).  The case-B
# decks are the slice's paths, and the case-B blusgs deck times the block
# thermally perfect form where its redesign gains most; the case-S ones
# give every thermally perfect form its comparison and a driven path (the
# lagged forms by a matrixSweeps 2 deck).  A drive's launches are checked
# as in phase 4: K2 none on centralFourth and thermally perfect decks.
# Reacting hot air takes CFL 1, as its Roe decks do
PHYSICS_DECKS = (
    ("case B", "sst", "lusgs", 1, "wenoZ", (False, True), True, 3),
    ("case B", "sst", "lusgs", 1, "weno", (), False, 3),
    ("case B", "sst", "lusgs", 1, "ausm", (), False, 3),
    ("case B", "sst", "lusgs", 1, "c4", (), False, 3),
    ("case B", "sst", "lusgs", 1, "tp", (False, True), False, 3),
    ("case S", "sst", "lusgs", 2, "tp", (), False, 2),
    ("case S", "sst", "blusgs", 1, "tp", (False, True), False, 2),
    ("case S", "sst", "blusgs", 2, "tp", (), False, 2),
    ("case S", "n2o2", "lusgs", 1, "tp_gas", (False,), False, 2),
    ("case S", "air5", "blusgs", 1, "tp_gas_cfl1", (False,), False, 2),
    ("case B", "sst", "blusgs", 1, "tp", (False,), False, 2),
)
# the case label of phase 15's WENO-Z comparisons (three ghost layers)
G3_CASE = "case B g3"
# phase 16: (case, physics, matrixSolver, matrixSweeps, deck tag of
# TIME_DECKS, ranks, --nproc, compare each rank's kernels, launches per
# block and iteration {kernel: n}).  A 2-level V cycle with matrixSweeps 1
# relaxes one pair before and one after on level 0 and one on level 1
RANK_DECKS = (
    ("case B", "sst", "lusgs", 1, "rusanov", 2, 1, True,
     {"lusgs_sweep": 2, "blusgs_sweep": 0, "viscous_march": 1}),
    ("case A", "sst", "blusgs", 1, "mg2V", 4, 4, False,
     {"lusgs_sweep": 0, "blusgs_sweep": 6, "viscous_march": 0}),
)
RANK_ITERATIONS = 5
# the thermally perfect scalar mixture decks (physics, deck tag) of phases
# 15 and 17 whose variant (b), which no driven path takes, is held against
# its plain version on the (a) deck's solver
LAGGED_ONLY = (("n2o2", "tp_gas"), ("n2o2", "roe_tp_gas"),
               ("h2air7", "tp_gas"))
# the blocks of the sweep comparisons of phases 8, 9, 11, 15 and 17 by case
# (all where not named): a case-A pair on block 0 alone, whose plain sweeps
# take half the time of both blocks' (the blocks of a sweep run
# concurrently on the card, so a pair of one block takes about the time of
# both blocks' pair: 8.95 against 9.25 ms for the thermally perfect Roe (b)
# form, NVIDIA H100 80GB HBM3, 700 W, PERF.md section 6)
COMPARED_BLOCKS = {"case A": (0,), "case S": (0,)}
# the blocks whose kernel pair the plain version holds in the comparisons
# of phases 8-17 by case (the kernel pair runs and is timed on every
# block of COMPARED_BLOCKS, as the solver launches it): at case B block 0
# alone, whose plain pair takes half the time of both blocks' (a
# thermally perfect one 14-16 s); phase 3's main-path pairs hold every
# block
PLAIN_BLOCKS = {"case B": (0,)}
# case S, the plate of phases 9, 15 and 17's comparisons and drives of the
# forms off the slices' main paths, 2 x 48x60x1 (a quarter of case A's
# cells, half its planes): a plain pair of a thermally perfect form of 3-7
# species costs seconds on block 0
SMALL_DIMS = (48, 60, 1)
# phase 17, the last forms (the thermally perfect approximateRoe forms and
# species counts above the base libraries' 5): (case, physics,
# matrixSolver, matrixSweeps, deck tag of TIME_DECKS, sweep comparisons,
# steps driven).  The case-B decks are the slice's paths (hot air
# thermally perfect approximateRoe SST lusgs at the CPU parity test's CFL
# ramp; frozen seven-species hydrogen-air SST lusgs); the case-S ones give
# every new form its comparison and a driven path (the lagged forms by a
# matrixSweeps 2 deck), and the case-B blusgs deck times the block
# thermally perfect approximateRoe form (driven 1 step: at the CFL ramp
# the plain block sweep of this deck gives NaN from the second step on,
# on the CPU, which is why its case-S decks take CFL 1).
# A drive's launches are checked as in phase 4: no K2 on thermally
# perfect and mixture decks
LAST_DECKS = (
    ("case B", "sst", "lusgs", 1, "roe_tp", (False,), 4),
    ("case B", "h2air7", "lusgs", 1, "rusanov", (False,), 4),
    ("case S", "sst", "lusgs", 2, "roe_tp", (True,), 2),
    ("case S", "sst", "blusgs", 1, "roe_tp_cfl1", (False, True), 2),
    ("case S", "sst", "blusgs", 2, "roe_tp_cfl1", (), 2),
    ("case S", "n2o2", "lusgs", 1, "roe_tp_gas", (False,), 2),
    ("case S", "h2air7", "lusgs", 2, "rusanov", (True,), 2),
    ("case S", "h2air7", "blusgs", 1, "rusanov", (False, True), 2),
    ("case S", "h2air7", "blusgs", 2, "rusanov", (), 2),
    ("case S", "h2air7", "lusgs", 1, "roe", (False,), 2),
    ("case S", "h2air7", "lusgs", 1, "tp_gas", (False,), 2),
    ("case S", "db16", "lusgs", 1, "rusanov", (False,), 2),
    ("case S", "db16", "blusgs", 1, "cfl1", (False,), 2),
    ("case S", "n2o2_ch4x", "lusgs", 1, "tp_gas", (False,), 2),
    ("case S", "n2o2_ch4x", "blusgs", 1, "tp_gas", (False,), 2),
    ("case S", "air5_frozen", "lusgs", 1, "tp_gas_cfl1", (False,), 2),
    ("case S", "air5_frozen", "lusgs", 1, "roe_tp_gas_cfl1", (False,), 2),
    ("case S", "h2air7", "lusgs", 1, "roe_tp_gas_cfl1", (False,), 2),
    ("case B", "sst", "blusgs", 1, "roe_tp", (False,), 1),
)
# the libraries of the phase-17 forms (every form of LAST_DECKS and of
# phase 6's two new references is held by one of them or by a base
# library): started in phase 2 after the base libraries, built while
# phases 3-16 run
LAST_LIBRARIES = ("lusgs_sweep_roe_tp", "blusgs_sweep_roe_tp",
                  "lusgs_sweep_ns7", "blusgs_sweep_ns7",
                  "lusgs_sweep_roe_ns7", "lusgs_sweep_tp_ns7",
                  "lusgs_sweep_roe_tp_ns7", "lusgs_sweep_ns16",
                  "blusgs_sweep_ns16")
# the base libraries (1-5 species): phase 2 waits for the first three
# (FIRST_LIBRARIES: the Rusanov builds of both sweeps and the viscous
# kernel, all that phases 3-10 launch); the approximateRoe and thermally
# perfect builds (DEFERRED_LIBRARIES: lusgs_sweep_tp alone takes 111 s)
# build behind phases 3-10, before LAST_LIBRARIES, and phase 11 waits for
# them
FIRST_LIBRARIES = ("lusgs_sweep", "blusgs_sweep", "viscous_march")
DEFERRED_LIBRARIES = ("lusgs_sweep_roe", "blusgs_sweep_roe",
                      "lusgs_sweep_tp", "blusgs_sweep_tp")
BASE_LIBRARIES = FIRST_LIBRARIES + DEFERRED_LIBRARIES
# phase 14: the files run (case B, output and restart every 2 steps) and
# its resumption from the step-2 restart
FILES_ITERATIONS = 4
FILES_EVERY = 2
# a constant CFL: a resumed run starts the CFL ramp again at its first
# step (the JAX package's order), so only a constant CFL lets its steps
# repeat the uninterrupted run's
FILES_CFL = (50.0, 0.0, 50.0)
# resumed against uninterrupted raw L2, per equation relative to its
# largest: the .rst holds the state dimensional (times a_ref, r_ref) and
# the resumed run reads it back, a few units in the last place of the
# state that two implicit steps carry into the L2; the bound of the
# parity tests' histories (tests/test_torch_restart.py)
RESTART_RTOL = 1e-8


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


def check_no_jax_package():
    loaded = [m for m, v in sys.modules.items()
              if v is not None and m.split(".")[0] in ("jax", "aither_tpu")]
    if loaded:
        fail(f"the port loaded the JAX side: {sorted(loaded)[:5]}")


def timed_once(torch, fn):
    """(fn(), milliseconds of that one call by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def timed_ms(torch, fn, reps: int) -> float:
    """mean milliseconds of fn() over reps, by CUDA events."""
    _, ms = timed_once(torch, lambda: [fn() for _ in range(reps)])
    return ms / reps


def device_allocs(torch):
    """cudaMalloc calls of the caching allocator so far (None where this
    torch does not count them)"""
    return torch.cuda.memory_stats().get("num_device_alloc")


def in_turns(torch, plain, kernel):
    """(kernel ms, plain ms, [p1, k1, k2, p2], cold ms, [cudaMalloc calls
    in the cold window, in the two warm ones]) timed plain, cold kernel
    window, kernel, kernel, plain.  A window holds the outputs of all its
    KERNEL_REPS calls until it ends, so the first window after a plain run
    must find room for all of them at once; the cold window is reported
    beside the warm ones with the cudaMalloc calls each made, and the
    kernel's time where the solver runs it is taken in the drive
    (path_timings)."""
    p1 = timed_ms(torch, plain, 1)
    a0 = device_allocs(torch)
    cold = timed_ms(torch, kernel, KERNEL_REPS)
    a1 = device_allocs(torch)
    k1 = timed_ms(torch, kernel, KERNEL_REPS)
    k2 = timed_ms(torch, kernel, KERNEL_REPS)
    a2 = device_allocs(torch)
    p2 = timed_ms(torch, plain, 1)
    allocs = [None, None] if a0 is None else [a1 - a0, a2 - a1]
    return (0.5 * (k1 + k2), 0.5 * (p1 + p2), [p1, k1, k2, p2], cold,
            allocs)


def perturb(solver, seed=7):
    """set the solver's state to its initial one times (1 + 0.01 U[0,1))
    on the interior, seeded"""
    rng = np.random.default_rng(seed)
    prims = {}
    for b in solver.case.blocks:
        prim = b.prim0.cpu().numpy().copy()
        prim[b.interior] *= 1.0 + 0.01 * rng.random(prim[b.interior].shape)
        prims[b.index] = prim
    solver.set_state(prims)


def bound_ms(nbytes, ops):
    """(least ms, what bounds it): bytes over the HBM rate against FP64
    operations over the FP64 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 3: the sweep kernel


def linear_system(solver):
    """The first iteration's state, residual and linear system, and a du
    with realistic connection ghosts (one relaxation on the kernel)."""
    cfl = solver.deck.cfl(0)
    prims, res, sr, dg, dts, auxs = solver._residuals(dict(solver.prims),
                                                      cfl)
    inv_diag, a_diag, bs, dus = solver._setup_linear(prims, res, sr, dg,
                                                     dts, auxs, solver.cons_n)
    st = solver._relax(0, dict(prims=prims, auxs=auxs, inv_diag=inv_diag,
                               a_diag=a_diag, bs=bs, dus=dus),
                       solver.cfg["matrix_sweeps"])
    return prims, auxs, inv_diag, bs, st["dus"]


def level_systems(solver):
    """{level: (prims, auxs, inv_diag, b + forcing, du)} of every coarse
    level of a multigrid solver: its linear system with its forcing and
    the restricted du (connection ghosts swapped) as its first relaxation
    of the first iteration starts (one iteration on the card, outside any
    counted drive)"""
    systems = {}
    relax = solver._relax

    def capture(lvl, st, sweeps):
        if lvl > 0 and lvl not in systems:
            bs = {bi: b + st["forcing"][bi] for bi, b in st["bs"].items()}
            systems[lvl] = (st["prims"], st["auxs"], st["inv_diag"], bs,
                            {bi: du.clone() for bi, du in st["dus"].items()})
        return relax(lvl, st, sweeps)

    solver._relax = capture
    try:
        solver._iteration(dict(solver.prims), solver.cons_n,
                          solver.deck.cfl(0))
    finally:
        del solver._relax
    return systems


def sweep_pair(solver, system, du0, extras, kernel=True, lvl=0):
    """forward then backward sweep of every block of grid level ``lvl``
    from copies of du0, with the given lagged terms ({block: (forward
    extra, backward extra)}) or none: the kernels through
    lusgs_sweep.sweep_blocks as Solver.run launches them (the blocks of a
    sweep concurrently), or the plain versions block by block."""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    prims, auxs, inv_diag, bs, _ = system
    phys, cfg = solver.phys, solver.cfg
    plans = solver.mg_plans[lvl]
    out = {bi: du.clone() for bi, du in du0.items()}
    if kernel:
        for n, forward in enumerate((True, False)):
            ls.sweep_blocks(phys, cfg, [
                (plans[bi], prims[bi], out[bi], bs[bi], *inv_diag[bi],
                 auxs[bi], extras[bi][n] if extras else None)
                for bi in out], forward)
        return out
    for bi, du in out.items():
        ef, eb = extras[bi] if extras else (None, None)
        args = (phys, cfg, plans[bi], prims[bi], du, bs[bi],
                *inv_diag[bi], auxs[bi])
        ls.forward_plain(*args, extra=ef)
        ls.backward_plain(*args, extra=eb)
    return out


def form_name(form):
    """the sweep kernels' form (ns, neq, viscous, wilcox, roe, tp) in
    words"""
    ns, neq, viscous, wilcox, roe, tp = form
    if neq == ns + 4:
        name = f"{neq} eq {'viscous' if viscous else 'inviscid'}"
    else:
        name = f"{neq} eq {'Wilcox' if wilcox else 'SST'}"
    name = name if ns == 1 else f"{name}, {ns} species"
    name = f"{name}, thermally perfect" if tp else name
    return f"{name}, approximateRoe" if roe else name


def sweep_errors(kern, plain):
    """(max |kernel - plain|, max relative difference per equation over the
    blocks) of two sweep results {block: du}, or None if the kernel's is
    not finite"""
    import torch
    max_abs, rel = 0.0, None
    for bi, p in plain.items():
        k = kern[bi]
        if not bool(torch.isfinite(k).all()):
            return None
        if rel is None:
            rel = np.zeros(p.shape[0])
        for e in range(p.shape[0]):
            scale = float(p[e].abs().max())
            err = float((k[e] - p[e]).abs().max())
            max_abs = max(max_abs, err)
            rel[e] = max(rel[e], err / scale if scale > 0 else err)
    return max_abs, rel


def compare_sweeps(torch, solver, system, label, card, with_extra,
                   case="case B", lvl=0, blocks=None, plain_blocks=None):
    """The sweep pair on one case (at grid level ``lvl``) against its
    plain version: (max_abs_err, kernel ms, plain ms, bound ms, bound_by).
    The plain pair takes seconds, so its checked run is its timed one; the
    kernel pair is timed after it (the median of three windows).
    ``blocks`` (indices) restricts the pair to those blocks, whose sweeps
    then run as in the solver (the others' du stays in the connection
    ghosts); ``plain_blocks`` restricts
    the plain pair alone: the kernel pair runs and is timed on every block
    of ``blocks`` and must be finite on each, and is held against the
    plain version on those (a block's sweeps read no other block's du, so
    its result does not depend on the others').  Printed beside it: the
    plane-per-launch pair's time (BEFORE_MS, text from PERF.md; level 0),
    the critical path and the time of a step of it."""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver import implicit as imp
    prims, auxs, _, _, du0 = system
    if blocks is not None:
        du0 = {bi: du for bi, du in du0.items() if bi in blocks}
    held = du0 if plain_blocks is None else {
        bi: du for bi, du in du0.items() if bi in plain_blocks}
    block = bool(solver.cfg["block_matrix"])
    kernel = "blusgs_sweep" if block else "lusgs_sweep"
    form = ls.sweep_form(solver.phys, solver.cfg)
    variant = {(False, False): "a", (False, True): "b (lagged term)",
               (True, False): "c (block)",
               (True, True): "c+b (block, lagged term)"}[(block, with_extra)]
    variant = f"{variant}, {form_name(form)}"
    if lvl:
        variant = f"{variant}, level {lvl}"
    plans = {bi: p for bi, p in solver.mg_plans[lvl].items() if bi in du0}
    extras = None
    if with_extra:
        extras = {b.index: tuple(imp.offdiag_sum(
            solver.phys, solver.cfg, b, prims[b.index], du0[b.index], side,
            auxs[b.index]) for side in ("upper", "lower"))
            for b in solver.mg_cases[lvl].blocks if b.index in du0}

    def run_plain():
        return sweep_pair(solver, system, held, extras, kernel=False,
                          lvl=lvl)

    def run_kernel():
        return sweep_pair(solver, system, du0, extras, lvl=lvl)

    kern = run_kernel()
    plain, plain_ms = timed_once(torch, run_plain)
    errors = sweep_errors(kern, plain)
    if errors is None or not all(bool(torch.isfinite(k).all())
                                 for k in kern.values()):
        fail(f"{label}: sweep kernel variant {variant} gave non-finite "
             f"values")
    max_abs, rel = errors
    print(f"{label}: sweep variant {variant}, kernel vs plain max "
          f"rel diff per equation {[f'{r:.2e}' for r in rel]} (tol "
          f"{SWEEP_RTOL:.0e}), max abs diff {max_abs:.3e}", flush=True)
    if not rel.max() <= SWEEP_RTOL:
        fail(f"{label}: sweep kernel variant {variant} disagrees with the "
             f"plain sweep")
    run_kernel()    # the card idled through the plain pair: wake it
    # the median of three windows: now and then one window of a small
    # deck's pair takes several times the others (28.2 against 3.3 ms for
    # the case-S block thermally perfect Roe (c) pair, PERF.md section 6)
    t = [timed_ms(torch, run_kernel, KERNEL_REPS) for _ in range(3)]
    kernel_ms = float(np.median(t))
    diffusion = solver.phys.ns > 1 and solver.cfg["diffusion"] != "none"
    modes, iters, ridder = (), 0.0, ""
    if form[5]:
        modes = [len(v) for v in solver.phys.vib]
    if ls.staged_form(form, block):
        # the Ridder iterations of this run's q + du, cell by cell (the
        # scalar and the Roe forms': the block Rusanov form inverts no
        # energy)
        iters = float(np.mean([ls.mean_ridder_iterations(
            solver.phys, prims[b.index][b.interior],
            du0[b.index][b.interior])
            for b in solver.mg_cases[lvl].blocks if b.index in du0]))
        ridder = (f", Ridder iterations of q + du mean {iters:.3f} "
                  f"(modes {modes})")
    costs = [ls.sweep_cost(p, fwd, with_extra, block, form, diffusion,
                           modes, iters)
             for p in plans.values() for fwd in (True, False)]
    bound, by = bound_ms(sum(c[0] for c in costs), sum(c[1] for c in costs))
    # the critical path of the pair: the blocks of a sweep run concurrently
    steps = 2 * max(p.nplanes for p in plans.values())
    before = (BEFORE_MS.get((case, kernel, with_extra))
              if form == ls.SST_FORM and lvl == 0 else None)
    where = "all blocks" if blocks is None else f"blocks {list(blocks)}"
    if plain_blocks is not None:
        where = f"{where} (plain on blocks {list(held)})"
    print(f"{label}: sweep variant {variant}, forward+backward "
          f"pair over {where}: kernel {kernel_ms:.4f} ms "
          f"{[round(x, 4) for x in t]} (one launch per plane, PERF.md: "
          f"{before + ' ms' if before else 'not measured'}), critical path "
          f"{steps} planes, "
          f"{1e3 * kernel_ms / steps:.3f} us per step, plain "
          f"{plain_ms:.2f} ms, bound {bound:.4f} ms ({by}){ridder} "
          f"({card})", flush=True)
    if not (ls.prepass_form(form, block) and lvl == 0):
        return max_abs, kernel_ms, plain_ms, bound, by
    # a pre-pass form: the traffic of the terms it stores for itself, not
    # the function's, so outside the bound
    own = sum(ls.prepass_bytes(p, fwd, form, block, diffusion)
              for p in plans.values() for fwd in (True, False))
    old = REDESIGN_BEFORE_MS.get((case, kernel, form, with_extra))
    print(f"{label}: sweep variant {variant}, the redesign: pair "
          f"{kernel_ms:.4f} ms, {1e3 * kernel_ms / steps:.3f} us per step "
          f"(earlier design, PERF.md: "
          f"{old + ' ms' if old else 'not measured'}); the work space's own "
          f"traffic {own / 1e6:.1f} MB, {bound_ms(own, 0)[0]:.4f} ms at the "
          f"memory rate, not in the bound ({card})", flush=True)
    return max_abs, kernel_ms, plain_ms, bound, by, dict(
        work_space_bytes=own)


# ---------------------------------------------------------------------------
# phase 3: the viscous residual kernel


def viscous_inputs(torch, solver, seed=3, perturbed=True, lvl=0):
    """{block: (prim, T, mu)}: the initial state of grid level ``lvl``,
    perturbed by up to 1% on the interior (seeded) unless ``perturbed`` is
    False, after the full and the viscous ghost fill."""
    from aither_tpu_torch.solver import step
    phys = solver.phys
    case = solver.mg_cases[lvl]
    rng = np.random.default_rng(seed)
    prims = {}
    for b in case.blocks:
        prim = b.prim0.cpu().numpy().copy()
        if perturbed:
            prim[b.interior] *= 1.0 + 0.01 * rng.random(
                prim[b.interior].shape)
        prims[b.index] = torch.as_tensor(prim, device=solver.device)
    prims = step.apply_all_bcs(phys, case, prims)
    out = {}
    for b in case.blocks:
        prim = step.apply_boundary_ghosts(phys, b, prims[b.index],
                                          viscous_pass=True)
        prim = step.apply_edge_ghosts(phys, b, prim, viscous_pass=True)
        t_all = phys.temperature(prim[phys.ie], prim[:phys.ns])
        out[b.index] = (prim, t_all, phys.viscosity(t_all))
    return out


def flat_outputs(res):
    """the viscous_residual tuple as {name: tensor}"""
    out = dict(zip(("resid", "sr_flow", "sr_turb", "diag_flow",
                    "diag_turb"), res[:5]))
    out.update({f"cellavg_{k}": v for k, v in res[5].items()})
    return out


def compare_viscous(torch, solver, label, card, perturbed=True,
                    case="case B", lvl=0, blocks=None, inputs=None):
    """The viscous residual of every block (or of ``blocks``, indices) of
    grid level ``lvl`` on one case against its plain version: (max_abs_err,
    kernel ms, plain ms, bound ms, bound_by, cold window ms).  A blusgs
    solver's blocks are taken with the scalar solver's cfg: the kernel has
    no block-matrix form.  Printed beside the time: the first design's
    (VISC_BEFORE_MS, text from PERF.md; level 0) and each block's launch
    (tile, segment, CTAs, shared memory, CTAs per SM).  ``inputs``: the
    viscous_inputs to take (a rank's, built with the other ranks)."""
    from aither_tpu_torch.kernels import viscous_march as vm
    from aither_tpu_torch.solver import viscous as vis
    phys, cfg = solver.phys, dict(solver.cfg, block_matrix=False)
    model = phys.turb_model
    what = (f"viscous residual ({model}"
            f"{'' if perturbed else ', unperturbed field'}"
            f"{f', level {lvl}' if lvl else ''})")
    if inputs is None:
        inputs = viscous_inputs(torch, solver, perturbed=perturbed, lvl=lvl)
    blocks = [b for b in solver.mg_cases[lvl].blocks
              if blocks is None or b.index in blocks]
    max_abs, worst, worst_name = 0.0, 0.0, ""
    for b in blocks:
        got = flat_outputs(vm.viscous_residual(phys, cfg, b,
                                               *inputs[b.index]))
        want = flat_outputs(vis.viscous_residual(phys, cfg, b,
                                                 *inputs[b.index]))
        torch.cuda.synchronize()
        if set(got) != set(want):
            fail(f"{label}: {what} kernel outputs {sorted(got)}")
        for name, w in want.items():
            g = got[name]
            if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                fail(f"{label}: {what} kernel {name} shape {g.shape} or "
                     f"non-finite")
            err = (g - w).abs()
            scale = float(w.abs().max())
            ratio = float((err / (VISC_ATOL * scale + VISC_RTOL * w.abs()
                                  + 1e-300)).max())
            max_abs = max(max_abs, float(err.max()))
            if ratio > worst:
                worst, worst_name = ratio, (f"{name} of block {b.index} "
                                            f"(max |diff| {err.max():.3e}, "
                                            f"scale {scale:.3e})")
        if model == "wale" and perturbed and not float(
                want["cellavg_mut"].max()) > 0.0:
            fail(f"{label}: the WALE eddy viscosity is zero everywhere")
    print(f"{label}: {what}, kernel vs plain max abs diff "
          f"{max_abs:.3e}, worst |diff| / (atol scale + rtol |plain|) "
          f"{worst:.3e} at {worst_name} (rtol {VISC_RTOL:.0e}, atol "
          f"{VISC_ATOL:.0e} x scale)", flush=True)
    if not worst <= 1.0:
        fail(f"{label}: the {what} kernel disagrees with the plain version")

    def run(fn):
        return lambda: [fn(phys, cfg, b, *inputs[b.index]) for b in blocks]

    kernel_ms, plain_ms, t, cold_ms, allocs = in_turns(
        torch, run(vis.viscous_residual), run(vm.viscous_residual))
    costs = [vm.cost(b, model) for b in blocks]
    bound, by = bound_ms(sum(c[0] for c in costs), sum(c[1] for c in costs))
    before = VISC_BEFORE_MS.get((case, model)) if lvl == 0 else None
    infos = [vm.launch_info(b, model) for b in blocks]
    for i in infos:
        if i["smem_bytes"] != vm.smem_bytes(vm.MODELS[model], *i["tile"]):
            fail(f"{label}: the kernel's shared memory {i['smem_bytes']} B "
                 f"is not viscous_march.smem_bytes'")
    launches = "; ".join(
        f"block {b.index}: tile {i['tile'][0]} x {i['tile'][1]} columns, "
        f"segments of {i['seg']} planes, {i['ctas']} CTAs of "
        f"{i['threads']} threads, {i['smem_bytes']} B dynamic shared "
        f"memory each, {i['ctas_per_sm']} per SM, {i['registers']} "
        f"registers" for b, i in zip(blocks, infos))
    with_len = vis.needs_face_length(cfg)
    statics = sum(sum(v.numel() for v in vis.viscous_statics(b, with_len)
                      ["face"].values())
                  + vis.viscous_statics(b, with_len)["cell"].numel()
                  for b in blocks) * 8
    print(f"{label}: {what} of all blocks: kernel "
          f"{kernel_ms:.4f} ms [{t[1]:.4f}, {t[2]:.4f}] (one thread per "
          f"cell, PRs 2/4, PERF.md: "
          f"{before + ' ms' if before else 'not measured'}), first window "
          f"after the plain run {cold_ms:.4f} ms with {allocs[0]} cudaMalloc "
          f"calls ({allocs[1]} in the two warm windows; a window holds "
          f"{KERNEL_REPS} x {len(blocks)} outputs), plain "
          f"{plain_ms:.2f} ms [{t[0]:.2f}, {t[3]:.2f}], bound {bound:.4f} "
          f"ms ({by}); static face geometry {statics / 2**30:.3f} GiB; "
          f"{launches} ({card})", flush=True)
    return max_abs, kernel_ms, plain_ms, bound, by, cold_ms


# ---------------------------------------------------------------------------
# phases 4-6


def read_tme(path):
    rows = []
    with open(path) as f:
        for ln in f:
            t = ln.split()
            if t and t[0] != "Step":
                rows.append((int(t[0]), float(t[1])))
    return rows


def drive(torch, solver, iterations, sweep_pairs, label, card,
          case="case B", per_iteration=None):
    """Solver.run of ``iterations`` time steps on the card with the launch
    counters set to 0 just before and read just after; checks and prints;
    returns the launch counts {kernel: n} and, as 'viscous_path_ms', the
    viscous kernel's time per nonlinear iteration inside the run
    (path_timings).  Per nonlinear iteration (the deck's per step) lusgs
    launches the scalar sweep and, on a viscous deck, the viscous kernel;
    blusgs the block sweep only; each sweep launch follows one reset of
    its schedule's state.  dplur and the explicit integrators launch no
    sweep, dplur and explicit one-species viscous decks the viscous
    kernel, bdplur neither.  ``per_iteration`` ({kernel: launches per
    nonlinear iteration}) states the counts of a multigrid deck; its drive
    also returns, as 'sweeps_with_extra', the sweep launches that took the
    lagged term, and, as 'coarse_share', the share of the steady
    iterations' time spent below level 0 (coarse_timer)."""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.kernels import viscous_march as vm
    cells = solver.case.total_cells
    nblocks = len(solver.case.blocks)
    nonlinear = solver.deck["nonlinearIterations"]
    passes = iterations * nonlinear
    counters = {"lusgs_sweep": ls.LAUNCHES, "blusgs_sweep": ls.BLOCK_LAUNCHES,
                "viscous_march": vm.LAUNCHES,
                "sweep_state_resets": ls.STATE_RESETS,
                "sweep_prepass": ls.PREPASS_LAUNCHES}
    # one launch per block and sweep
    sweeps = passes * sweep_pairs * 2 * nblocks if solver.sweeps else 0
    if per_iteration is not None:
        expect = {k: passes * n for k, n in per_iteration.items()}
        expect["sweep_state_resets"] = (expect["lusgs_sweep"]
                                        + expect["blusgs_sweep"])
    elif solver.cfg["block_matrix"]:
        expect = {"lusgs_sweep": 0, "blusgs_sweep": sweeps,
                  "viscous_march": 0, "sweep_state_resets": sweeps}
    else:
        # a mixture's, a thermally perfect gas's and a centralFourth
        # deck's viscous residual is the plain version (one calorically
        # perfect species and central reconstruction only in the fused
        # kernel, as in the JAX package's use_march)
        fused = (solver.cfg["viscous"] and solver.phys.ns == 1
                 and not solver.phys.thermally_perfect
                 and solver.cfg["viscous_recon"] == "central")
        expect = {"lusgs_sweep": sweeps, "blusgs_sweep": 0,
                  "viscous_march": passes * nblocks if fused else 0,
                  "sweep_state_resets": sweeps}
    # a pre-pass form launches its pre-pass before each sweep launch
    prepass = solver.sweeps and ls.prepass_form(
        ls.sweep_form(solver.phys, solver.cfg),
        bool(solver.cfg["block_matrix"]))
    expect["sweep_prepass"] = (expect["sweep_state_resets"] if prepass
                               else 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocs = device_allocs(torch)
    vm.TIMINGS = []
    multigrid = solver.mg_nlevels > 1
    if multigrid:
        coarse, with_extra = coarse_timer(torch, solver)
    for c in counters.values():
        c.reset()
    try:
        solver.run(iterations=iterations)
    finally:
        if multigrid:
            for name in ("_restrict_level", "_mg_cycle"):
                delattr(solver, name)
            ls.sweep_blocks = with_extra[1]
    launches = {name: c.count for name, c in counters.items()}
    torch.cuda.synchronize()
    timings, vm.TIMINGS = vm.TIMINGS, None
    peak = torch.cuda.max_memory_allocated()
    if allocs is not None:
        allocs = device_allocs(torch) - allocs
    path_ms = path_timings(timings, nblocks, label, allocs, card)
    deck = solver.deck
    print(f"{label}: {iterations} steps of {nonlinear} nonlinear "
          f"iterations of {case} ({cells} cells, "
          f"{deck['equationSet']} / {deck['turbulenceModel']}, "
          f"{solver.phys.ns} species, {deck['timeIntegration']}, "
          f"{deck['matrixSolver']}, {deck['inviscidFluxJacobian']}, "
          f"{deck['faceReconstruction']}, {deck['inviscidFlux']}, "
          f"{deck['viscousFaceReconstruction']}, "
          f"{deck['thermodynamicModel']}, "
          f"matrixSweeps {sweep_pairs}), kernel launches {launches} "
          f"(expected {expect})", flush=True)
    for name, n in expect.items():
        if launches[name] != n:
            fail(f"{label}: {name} launched {launches[name]} times, "
                 f"expected {n}")
    l2 = solver.l2_history
    if len(l2) != passes or not np.isfinite(l2).all():
        fail(f"{label}: non-finite or missing residual L2: {l2}")
    with open(solver.sim_root + ".resid") as f:
        rows = [ln for ln in f.read().splitlines()[1:] if ln.strip()]
    if len(rows) != passes:
        fail(f"{label}: .resid has {len(rows)} rows for {passes} "
             f"nonlinear iterations")
    first = min(STEADY_FROM, iterations - 1)
    steady = [t for n, t in read_tme(solver.sim_root + ".tme")
              if n >= first]
    its = len(steady) / sum(steady)
    print(f"{label}: {its:.4f} steps/s steady (steps {first}-"
          f"{iterations - 1}), {its * nonlinear:.4f} nonlinear "
          f"iterations/s, {its * nonlinear * cells / 1e6:.4f} "
          f"Mcell-iterations/s, peak device memory {peak / 2**30:.3f} GiB "
          f"({card})", flush=True)
    print(f"{label}: last L2 {[f'{v:.4e}' for v in l2[-1]]}", flush=True)
    out = dict(launches, viscous_path_ms=path_ms, steps_per_s=its)
    if multigrid:
        per = len(coarse) // passes
        below = sum(coarse[first * per:])
        out["coarse_share"] = below / sum(steady)
        out["sweeps_with_extra"] = with_extra[0][0]
        print(f"{label}: {solver.mg_nlevels} levels, "
              f"{solver.deck['multigridCycle']} cycle: below level 0 "
              f"{1e3 * below / len(steady):.2f} ms of "
              f"{1e3 * sum(steady) / len(steady):.2f} ms a step (share "
              f"{out['coarse_share']:.4f}; restriction from level 0 and "
              f"the coarse cycles, each synchronised at its ends); sweep "
              f"launches with the lagged term {with_extra[0][0]} of "
              f"{launches['lusgs_sweep'] + launches['blusgs_sweep']} "
              f"({card})", flush=True)
    return out


def coarse_timer(torch, solver):
    """Time below level 0 in a multigrid solver's run: wraps the
    solver's restriction from level 0 and its level-1 cycles (instance
    attributes, deleted by the caller after the run) so that each call is
    timed between two synchronisations, and lusgs_sweep.sweep_blocks so
    that the sweep launches which take the lagged term are counted.
    Returns (the list of timed seconds, in call order; ([count],
    the original sweep_blocks))"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    timed = []

    def timer(fn, level):
        def call(lvl, *args):
            if lvl != level:
                return fn(lvl, *args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(lvl, *args)
            torch.cuda.synchronize()
            timed.append(time.perf_counter() - t0)
            return out
        return call

    solver._restrict_level = timer(solver._restrict_level, 0)
    solver._mg_cycle = timer(solver._mg_cycle, 1)
    count = [0]
    sweep_blocks = ls.sweep_blocks

    def counted(phys, cfg, blocks, forward):
        count[0] += sum(1 for args in blocks if args[-1] is not None)
        return sweep_blocks(phys, cfg, blocks, forward)

    ls.sweep_blocks = counted
    return timed, (count, sweep_blocks)


def path_timings(timings, nblocks, label, allocs, card):
    """The viscous kernel where the solver runs it, from the three CUDA
    events of each launch of a drive (before the output's allocation,
    before the launch, after it): prints the first iteration's and the
    later iterations' times and returns the later iterations' mean kernel
    ms of one iteration (all blocks), or None without a launch."""
    if not timings:
        return None
    alloc = np.array([e[0].elapsed_time(e[1]) for e in timings])
    kern = np.array([e[1].elapsed_time(e[2]) for e in timings])
    later = slice(nblocks, None)
    per_iteration = nblocks * float(kern[later].mean())
    print(f"{label}: viscous kernel inside Solver.run, {len(timings)} "
          f"launches by CUDA events: first iteration "
          f"{[f'{v:.4f}' for v in kern[:nblocks]]} ms (output allocation "
          f"before it {[f'{v:.4f}' for v in alloc[:nblocks]]} ms); later "
          f"launches mean {kern[later].mean():.4f}, min "
          f"{kern[later].min():.4f}, max {kern[later].max():.4f} ms each "
          f"(allocation mean {alloc[later].mean():.4f}, max "
          f"{alloc[later].max():.4f} ms), {per_iteration:.4f} ms per "
          f"iteration over {nblocks} blocks; {allocs} cudaMalloc calls in "
          f"the whole drive ({card})", flush=True)
    return per_iteration


def wall_law_shares(solver) -> str:
    """the share of the solver's wall faces at y+ >= 10 and of those
    whose wall-law root the Ridder bracket [10, 1e4] holds (an
    unbracketed face is set to y+ = 1e4), from its state, in words"""
    import torch
    from aither_tpu_torch.solver import step
    from aither_tpu_torch.solver import wall_law
    prims = step.apply_all_bcs(solver.phys, solver.case, dict(solver.prims))
    yplus = []
    for b in solver.case.blocks:
        wall = {}
        step.apply_boundary_ghosts(solver.phys, b, prims[b.index],
                                   viscous_pass=True, cfg=solver.cfg,
                                   wall_data=wall)
        yplus += [v["yplus"].reshape(-1) for v in wall.values()]
    y = torch.cat(yplus)
    at_10 = float((y >= 10.0).double().mean())
    bracketed = float((y < wall_law.YPLUS_HI).double().mean())
    return (f"{y.numel()} wall faces, share at y+ >= 10 {at_10:.4f}, root "
            f"bracketed {bracketed:.4f}, y+ in [{float(y.min()):.2f}, "
            f"{float(y.max()):.2f}]")


def wall_law_timer(torch):
    """time every wall-law solve by CUDA events: wraps
    wall_law.solve_wall_law (restored by the caller); returns (the list
    of (start, stop) events, the original function)"""
    from aither_tpu_torch.solver import wall_law
    events = []
    solve = wall_law.solve_wall_law

    def timed(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = solve(*args, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    wall_law.solve_wall_law = timed
    return events, solve


def boundary_share(torch, solver, iterations=3):
    """share of a further ``iterations``-step run (from its step 1 on)
    spent in the boundary pass: the full ghost fill
    (step.apply_all_bcs) and the viscous wall ghosts (the viscous_pass
    calls of step.apply_boundary_ghosts / apply_edge_ghosts), each timed
    between two synchronisations"""
    from aither_tpu_torch.solver import step
    timed = []
    names = ("apply_all_bcs", "apply_boundary_ghosts", "apply_edge_ghosts")
    saved = {name: getattr(step, name) for name in names}

    def timer(fn, always):
        def call(*args, **kw):
            if not (always or kw.get("viscous_pass")):
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timed.append(time.perf_counter() - t0)
            return out
        return call

    for name in names:
        setattr(step, name, timer(saved[name], name == "apply_all_bcs"))
    try:
        solver.run(iterations=iterations)
    finally:
        for name, fn in saved.items():
            setattr(step, name, fn)
    steps = [t for n, t in read_tme(solver.sim_root + ".tme") if n >= 1]
    per = len(timed) // iterations
    return sum(timed[per:]) / sum(steps)


def write_deck(wd, dims, solver_name, sweeps, physics, tag="rusanov",
               layout=None):
    """the generated plate in ``wd`` with the named physics (PHYSICS),
    deck (TIME_DECKS) and boundary layout (BC_LAYOUTS, or the plate's
    own); returns the deck's path"""
    from aither_tpu_torch.cases import (MIXTURES, TIME_INTEGRATORS,
                                        write_plate_case)
    es, tm, mixture = PHYSICS[physics]
    integrator, deck = TIME_DECKS[tag]
    return write_plate_case(wd, *dims, matrix_sweeps=sweeps,
                            matrix_solver=solver_name, equation_set=es,
                            turbulence_model=tm,
                            **MIXTURES.get(mixture, {}),
                            **TIME_INTEGRATORS[integrator], **deck,
                            **BC_LAYOUTS.get(layout, {}))


def make_solver(wd, dims, device, solver_name, sweeps, physics,
                tag="rusanov", layout=None, nproc=1):
    """Solver of ``write_deck``'s plate, built in ``wd``: a reacting deck
    reads its mechanism from the working directory"""
    from aither_tpu_torch.solver.driver import Solver
    path = write_deck(wd, dims, solver_name, sweeps, physics, tag, layout)
    here = os.getcwd()
    os.chdir(wd)
    try:
        return Solver(path, device=device, workdir=wd, nproc=nproc)
    finally:
        os.chdir(here)


def reference_history(dims, device, solver_name, sweeps, physics,
                      tag="rusanov", layout=None):
    """raw L2 history (REF_ITERATIONS steps x nonlinear iterations, neq)
    of the small case from a state perturbed by up to 1% on the interior
    (seeded; the unperturbed plate has roundoff-level residual
    components)."""
    wd = os.path.join(RUN_DIR, f"reference_{device}_{physics}_{solver_name}_"
                               f"{sweeps}_{tag}_{layout}")
    s = make_solver(wd, dims, device, solver_name, sweeps, physics, tag,
                    layout)
    perturb(s)
    s.run(iterations=REF_ITERATIONS)
    return np.asarray(s.l2_history)


def in_dir(path, fn):
    """fn() with ``path`` as the working directory"""
    here = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(here)


def resid_steps(path):
    """the step column of every row of a .resid (headers skipped)"""
    with open(path) as f:
        return [int(ln.split()[0]) for ln in f
                if ln.strip() and not ln.startswith("Step")]


def check_files(wd, label, dims, iterations, restarts):
    """every file of a files run in ``wd`` exists and parses with the
    port's readers, with the block dims, the variable counts and finite
    values; returns {file: bytes}"""
    from aither_tpu_torch import cases
    from aither_tpu_torch.io.output import read_fun_file
    from aither_tpu_torch.io.plot3d import read_p3d
    from aither_tpu_torch.io.restart import read_restart
    sizes = {}
    cells = tuple(dims)
    nodes = tuple(n + 1 for n in dims)
    wall = (dims[0], 1, dims[2])
    nvar = len(cases.FILES_OUTPUT_VARIABLES)
    nwall = len(cases.FILES_WALL_VARIABLES)
    for name, want in (("plate_center.xyz", cells),
                       ("plate_wall_center.xyz", wall)):
        blocks = read_p3d(os.path.join(wd, name))
        if (len(blocks) != 2 or any(b.shape != want + (3,) for b in blocks)
                or not all(np.isfinite(b).all() for b in blocks)):
            fail(f"{label}: {name} has {[b.shape for b in blocks]}")
        sizes[name] = os.path.getsize(os.path.join(wd, name))
    for it in iterations:
        for name, want, nv in ((f"plate_{it}_center.fun", cells, nvar),
                               (f"plate_{it}.fun", nodes, nvar),
                               (f"plate_{it}_wall_center.fun", wall, nwall)):
            path = os.path.join(wd, name)
            if not os.path.isfile(path):
                fail(f"{label}: {name} was not written")
            hdr, blocks = read_fun_file(path)
            if (len(blocks) != 2 or any(tuple(h) != want for h in hdr)
                    or any(b.shape[0] != nv for b in blocks)
                    or not all(np.isfinite(b).all() for b in blocks)):
                fail(f"{label}: {name} has dims {hdr.tolist()}, "
                     f"{[b.shape[0] for b in blocks]} variables")
            sizes[name] = os.path.getsize(path)
    for it in restarts:
        name = f"plate_{it}.rst"
        rec = read_restart(os.path.join(wd, name))
        # density, velocity, pressure, tke, sdr and the mass fractions
        nv = 7 + len(rec["species"])
        if (rec["iteration"] != it or len(rec["blocks"]) != 2
                or any(b.shape != (nv,) + cells for b in rec["blocks"])
                or not all(np.isfinite(b).all() for b in rec["blocks"])):
            fail(f"{label}: {name} holds iteration {rec['iteration']}, "
                 f"{[b.shape for b in rec['blocks']]}")
        sizes[name] = os.path.getsize(os.path.join(wd, name))
    for name in ("plate_center.p3d", "plate.p3d"):
        if not os.path.isfile(os.path.join(wd, name)):
            fail(f"{label}: {name} was not written")
    return sizes


def files_phase(torch, card, drive_cloud):
    """phase 14: the case-B main-path deck with files through the CLI, its
    resumption from the step-2 restart, and a case-A point-cloud deck.
    Returns ({kernel: {run: launches}}, the SST lusgs solver's sweep form)
    for the kernels rows."""
    from aither_tpu_torch import cases
    from aither_tpu_torch.io import output as out_mod
    from aither_tpu_torch.io.restart import read_restart
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.kernels import viscous_march as vm
    from aither_tpu_torch.main import main as cli
    from aither_tpu_torch.solver.driver import Solver
    dims = cases.SMOKE_3D_DIMS
    times = {"write_output": [], "_write_nodal": [], "write_wall_files": [],
             "write_restart": []}
    solvers = []

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
        return wrapper

    def recording(fn):
        def wrapper(self, *args, **kw):
            solvers.append(self)
            return fn(self, *args, **kw)
        return wrapper

    saved = {name: getattr(Solver, name) for name in
             ("write_output", "_write_nodal", "write_restart", "run")}
    saved_wall = out_mod.write_wall_files
    for name in ("write_output", "_write_nodal", "write_restart"):
        setattr(Solver, name, timed(name, saved[name]))
    Solver.run = recording(saved["run"])
    out_mod.write_wall_files = timed("write_wall_files", saved_wall)
    counters = (ls.LAUNCHES, ls.BLOCK_LAUNCHES, vm.LAUNCHES)
    launches = {}
    try:
        # the uninterrupted run
        wd1 = os.path.join(RUN_DIR, "files_run")
        path = cases.write_plate_case(
            wd1, *dims, iterations=FILES_ITERATIONS, cfl=FILES_CFL,
            output_frequency=FILES_EVERY, restart_frequency=FILES_EVERY,
            output_variables=cases.FILES_OUTPUT_VARIABLES,
            wall_output_variables=cases.FILES_WALL_VARIABLES,
            output_nodal=True)
        runs = (("run", wd1, [path, "--device", "cuda"], FILES_ITERATIONS),
                ("resumed", os.path.join(RUN_DIR, "files_resumed"),
                 ["plate.inp", f"plate_{FILES_EVERY}.rst", "--device",
                  "cuda", "--iterations", str(FILES_ITERATIONS - FILES_EVERY)],
                 FILES_ITERATIONS - FILES_EVERY))
        for tag, wd, argv, its in runs:
            if tag == "resumed":
                os.makedirs(wd)
                for name in ("plate.inp", "plate.xyz",
                             f"plate_{FILES_EVERY}.rst"):
                    shutil.copy(os.path.join(wd1, name), wd)
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            t0 = time.perf_counter()
            if in_dir(wd, lambda: cli(argv)) != 0:
                fail(f"phase 14 {tag}: the CLI failed")
            seconds = time.perf_counter() - t0
            got = tuple(c.count for c in counters)
            want = (its * 2 * 2, 0, its * 2)
            launches[tag] = got
            print(f"phase 14 {tag}: case B SST lusgs, {its} steps with "
                  f"files, kernel launches (lusgs_sweep, blusgs_sweep, "
                  f"viscous_march) {got}, expected {want}; {seconds:.1f} s "
                  f"through the CLI ({card})", flush=True)
            if got != want:
                fail(f"phase 14 {tag}: launches {got}, expected {want}")
        first, resumed = solvers[0], solvers[-1]
        wd2 = runs[1][1]
        sizes = check_files(wd1, "phase 14 run", dims,
                            range(0, FILES_ITERATIONS + 1, FILES_EVERY),
                            range(FILES_EVERY, FILES_ITERATIONS + 1,
                                  FILES_EVERY))
        check_files(wd2, "phase 14 resumed", dims,
                    (FILES_EVERY, FILES_ITERATIONS), (FILES_ITERATIONS,))
        steps = resid_steps(os.path.join(wd2, "plate.resid"))
        if steps != list(range(FILES_EVERY, FILES_ITERATIONS)):
            fail(f"phase 14 resumed: .resid steps {steps}")
        rec = read_restart(os.path.join(wd1, f"plate_{FILES_EVERY}.rst"))
        if not (np.array_equal(resumed.l2_first, rec["l2_first"])
                and resumed.is_restart):
            fail(f"phase 14 resumed: l2_first {resumed.l2_first}, the "
                 f"file's {rec['l2_first']}")
        want = np.asarray(first.l2_history[FILES_EVERY:])
        got = np.asarray(resumed.l2_history)
        worst = float((np.abs(got - want).max(axis=0)
                       / np.abs(want).max(axis=0)).max())
        print(f"phase 14 resumed: .resid steps {steps}, l2_first the "
              f"file's, raw L2 of steps {FILES_EVERY}-"
              f"{FILES_ITERATIONS - 1} against the uninterrupted run's "
              f"max rel diff {worst:.3e} (tol {RESTART_RTOL:.0e})",
              flush=True)
        if not worst <= RESTART_RTOL:
            fail("phase 14 resumed: the resumed run left the "
                 "uninterrupted run's history")
        tme = read_tme(os.path.join(wd1, "plate.tme"))
        out_s, nodal_s = times["write_output"], times["_write_nodal"]
        wall_s = times["write_wall_files"]
        center_s = [o - n - w for o, n, w in zip(out_s, nodal_s, wall_s)]
        fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)   # noqa: E731
        print(f"phase 14 times, case B ({first.case.total_cells} cells), "
              f"host clock "
              f"between synchronisations, s per call (run at 0, "
              f"{FILES_EVERY}, {FILES_ITERATIONS}; resumed at "
              f"{FILES_EVERY}, {FILES_ITERATIONS}): write_output "
              f"{fmt(out_s)}; of it cell-center {fmt(center_s)}, wall "
              f"{fmt(wall_s)}, nodal {fmt(nodal_s)}; write_restart "
              f"{fmt(times['write_restart'])} ({card})", flush=True)
        print(f"phase 14 step seconds of the run (.tme; steps "
              f"{FILES_EVERY - 1} and {FILES_ITERATIONS - 1} write output "
              f"and a restart): {[round(t, 4) for _, t in tme]} ({card})",
              flush=True)
        print(f"phase 14 file bytes: {sizes}", flush=True)
        form = ls.sweep_form(first.phys, first.cfg)
        model = first.phys.turb_model
    finally:
        for name, fn in saved.items():
            setattr(Solver, name, fn)
        out_mod.write_wall_files = saved_wall
    for wd in (wd1, wd2):
        shutil.rmtree(wd, ignore_errors=True)

    # a point-cloud initial condition, host-built: cuda equals cpu
    wd3 = os.path.join(RUN_DIR, "files_cloud")
    path = cases.write_plate_case(wd3, *cases.SMOKE_2D_DIMS, ic_file="cloud.dat")
    rows = cases.write_cloud(os.path.join(wd3, "cloud.dat"))
    built = {dev: Solver(path, device=dev, workdir=wd3)
             for dev in ("cpu", "cuda")}
    same = all(torch.equal(gb.prim0.cpu(), cb.prim0) for gb, cb in
               zip(built["cuda"].case.blocks, built["cpu"].case.blocks))
    print(f"phase 14 cloud: case A SST lusgs from {len(rows)} cloud points "
          f"(each twice: every cell's nearest points tie), initial state on "
          f"cuda equal to cpu bit for bit: {same}", flush=True)
    if not same:
        fail("phase 14 cloud: the initial state differs between cuda and cpu")
    n = drive_cloud(built["cuda"])
    launches["cloud"] = (n["lusgs_sweep"], n["blusgs_sweep"],
                         n["viscous_march"])
    rows_out = {("lusgs_sweep", form, False): {}, ("viscous_march", model): {}}
    for tag, where in (("run", f"case B {FILES_ITERATIONS} steps with files"),
                       ("resumed", f"case B resumed, "
                                   f"{FILES_ITERATIONS - FILES_EVERY} steps"),
                       ("cloud", "case A point-cloud IC, 2 steps")):
        rows_out[("lusgs_sweep", form, False)][where] = launches[tag][0]
        rows_out[("viscous_march", model)][where] = launches[tag][2]
    return rows_out


def reference_files(torch):
    """phase 6's files deck: the small SST lusgs case from the seeded
    perturbed state, REF_ITERATIONS steps with output and a restart every
    step, the files variables, wall and nodal files, on cuda and on cpu;
    every .fun and .rst value of the two within REF_RTOL of its variable's
    largest magnitude per block"""
    from aither_tpu_torch import cases
    from aither_tpu_torch.io.output import read_fun_file
    from aither_tpu_torch.io.restart import read_restart
    from aither_tpu_torch.solver.driver import Solver
    dirs = {}
    for dev in ("cuda", "cpu"):
        wd = os.path.join(RUN_DIR, f"reference_files_{dev}")
        path = cases.write_plate_case(
            wd, *cases.TEST_DIMS, iterations=REF_ITERATIONS,
            output_frequency=1, restart_frequency=1,
            output_variables=cases.FILES_OUTPUT_VARIABLES,
            wall_output_variables=cases.FILES_WALL_VARIABLES,
            output_nodal=True)
        s = Solver(path, device=dev, workdir=wd)
        perturb(s)
        s.run(write_files=True)
        dirs[dev] = wd
    names = sorted(n for n in os.listdir(dirs["cpu"])
                   if n.endswith((".fun", ".rst")))
    if names != sorted(n for n in os.listdir(dirs["cuda"])
                       if n.endswith((".fun", ".rst"))):
        fail("phase 6 files: cuda and cpu wrote different files")
    worst = 0.0
    for name in names:
        if name.endswith(".fun"):
            got, want = (read_fun_file(os.path.join(dirs[d], name))[1]
                         for d in ("cuda", "cpu"))
        else:
            got, want = (read_restart(os.path.join(dirs[d], name))["blocks"]
                         for d in ("cuda", "cpu"))
        for g, w in zip(got, want):
            scale = np.abs(w).reshape(w.shape[0], -1).max(axis=1)
            err = np.abs(g - w).reshape(w.shape[0], -1).max(axis=1)
            worst = max(worst, float((err / np.where(scale > 0, scale,
                                                     1.0)).max()))
    print(f"phase 6 files: {cases.TEST_DIMS} x 2 blocks, SST lusgs, "
          f"{REF_ITERATIONS} steps with output and a restart every step "
          f"({len(names)} .fun and .rst files), cuda vs cpu max rel diff "
          f"{worst:.3e} of each variable's largest (tol {REF_RTOL:.0e})",
          flush=True)
    if not worst <= REF_RTOL:
        fail("phase 6 files: the cuda files disagree with the cpu files")


# ---------------------------------------------------------------------------
# phase 16: multi-rank runs on the card


def run_stats(solver, seconds) -> dict:
    """one rank's statistics of its run: its blocks and cells, the run's
    seconds and step seconds (host clock), the exchange's bytes, calls and
    seconds summed over the grid levels, each kernel's launches, and the
    device's peak memory"""
    import torch
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.kernels import viscous_march as vm
    xs = [c.exchange for c in solver.mg_cases]
    return dict(
        rank=solver.comm.rank, blocks=[b.index for b in solver.case.blocks],
        cells=sum(b.ni * b.nj * b.nk for b in solver.case.blocks),
        seconds=seconds, step_seconds=solver.step_seconds,
        exchange_bytes=sum(x.bytes for x in xs),
        exchange_calls=sum(x.calls for x in xs),
        exchange_seconds=sum(x.seconds for x in xs),
        launches=dict(lusgs_sweep=ls.LAUNCHES.count,
                      blusgs_sweep=ls.BLOCK_LAUNCHES.count,
                      viscous_march=vm.LAUNCHES.count),
        max_memory_allocated=torch.cuda.max_memory_allocated(solver.device))


def rank_worker(spec_json):
    """One rank of a phase-16 run, a process of this script: joins the
    job from RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT
    (``distributed.initialize`` bare), receives the case from rank 0
    (``distribute_case``) and builds its Solver (``rank_solver``: its own
    blocks on the card).  With ``compare``, the K1 (a) pair and K2 on its
    own block against their plain versions, as in phase 3 (the linear
    system and the viscous inputs built with the other ranks, the
    comparisons and their timings one rank after another).  Then the
    launch counters to 0, the exchange timed apart and ``Solver.run``;
    with ``compare``, after it, the device memory of rank 0's view of the
    whole grid for the files.  Writes its ``run_stats`` with the
    comparisons and the raw L2 history as JSON."""
    import torch
    sys.path.insert(0, REPO)
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.kernels import viscous_march as vm
    from aither_tpu_torch.parallel import distributed as dd
    spec = json.loads(spec_json)
    comm = dd.initialize(device="cuda")
    try:
        label = f"{spec['label']} rank {comm.rank}"
        wd = os.path.join(spec["root"], f"rank{comm.rank}")
        dd.distribute_case(comm, wd,
                           spec["case_dir"] if comm.rank == 0 else None)
        t0 = time.perf_counter()
        solver = dd.rank_solver(comm, os.path.join(wd, spec["deck"]),
                                nproc=spec["nproc"], workdir=wd)
        out = dict(build_seconds=time.perf_counter() - t0)
        if spec["compare"]:
            system = linear_system(solver)
            inputs = viscous_inputs(torch, solver)
            for r in range(comm.world):
                if r == comm.rank:
                    out["sweep"] = compare_sweeps(torch, solver, system,
                                                  label, spec["card"], False)
                    out["viscous"] = compare_viscous(
                        torch, solver, label, spec["card"], inputs=inputs)
                comm.barrier()
        for c in solver.mg_cases:
            c.exchange.timed = True
            c.exchange.bytes, c.exchange.seconds, c.exchange.calls = 0, 0.0, 0
        for counter in (ls.LAUNCHES, ls.BLOCK_LAUNCHES, vm.LAUNCHES):
            counter.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(solver.device)
        comm.barrier()
        t0 = time.perf_counter()
        solver.run(iterations=spec["iterations"])
        seconds = time.perf_counter() - t0
        out.update(run_stats(solver, seconds),
                   l2_history=np.asarray(solver.l2_history).tolist())
        if spec["compare"]:
            # the files' view: every rank sends rank 0 its blocks, and
            # rank 0 holds a one-rank Solver of the whole grid on the card
            before = torch.cuda.memory_allocated(solver.device)
            t0 = time.perf_counter()
            view = solver._sync_output_view()
            torch.cuda.synchronize()
            out["view_seconds"] = time.perf_counter() - t0
            out["view_bytes"] = (torch.cuda.memory_allocated(solver.device)
                                 - before)
            del view
        with open(os.path.join(spec["root"], f"stats{comm.rank}.json"),
                  "w") as f:
            json.dump(out, f)
        check_no_jax_package()
    finally:
        dd.finalize()
    return 0


def spawn_ranks(world, spec, root, timeout=900):
    """``world`` processes of ``rank_worker`` on a free port (the torchrun
    environment); fails with every rank's tail if one exits non-zero, the
    others killed; returns each rank's output"""
    from aither_tpu_torch.parallel.distributed import _free_port
    os.makedirs(root, exist_ok=True)
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        log = open(os.path.join(root, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             json.dumps(spec)], env=env, stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if (any(p.returncode not in (None, 0) for p in procs)
                or time.monotonic() > deadline):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.1)
    outs = []
    for p, log in zip(procs, logs):
        p.wait()
        log.seek(0)
        outs.append(log.read())
        log.close()
    if any(p.returncode != 0 for p in procs):
        fail(f"{spec['label']}: a rank failed:\n" + "\n".join(
            f"--- rank {r} (rc={p.returncode}) ---\n{o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return outs


def one_rank_reference(solver):
    """(raw L2 history, .resid lines, steady steps/s) of a one-rank drive"""
    with open(solver.sim_root + ".resid") as f:
        rows = f.read().splitlines()
    steady = solver.step_seconds[STEADY_FROM:]
    return (np.asarray(solver.l2_history), rows,
            len(steady) / sum(steady))


def ranks_phase(torch, card, main_path):
    """phase 16 (RANK_DECKS): each deck once on one rank (the reference:
    raw L2, .resid rows, iterations/s; for case-B SST lusgs the first
    RANK_ITERATIONS steps of phase 4's drive, ``main_path``) and once over
    its ranks, processes of this script sharing the card (rank_worker);
    the ranks' L2 within
    REF_RTOL of the one-rank run's, their launches exact, every block on
    one rank; prints per rank its K1 (a) pair and K2 times (case B), its
    iterations/s beside the one-rank run's, the bytes it exchanged per
    iteration, the exchange's share of its run and its peak memory.
    Returns the case-B ranks' stats for the K1 (d) row."""
    from aither_tpu_torch.cases import SMOKE_2D_DIMS, SMOKE_3D_DIMS
    rows = None
    for (case, physics, solver_name, sweeps, tag, world, nproc, compare,
         per_block) in RANK_DECKS:
        dims = {"case A": SMOKE_2D_DIMS, "case B": SMOKE_3D_DIMS}[case]
        label = (f"phase 16 {case} {physics} {solver_name} {tag} {world} "
                 f"ranks nproc {nproc}")
        base = os.path.join(RUN_DIR, label.replace(" ", "_"))
        t0 = time.perf_counter()
        if (case, physics, solver_name, sweeps, tag, nproc) == (
                "case B", "sst", "lusgs", 1, "rusanov", 1):
            ref, ref_rows, ref_rate = main_path
            ref = ref[:RANK_ITERATIONS]
            ref_rows = ref_rows[:RANK_ITERATIONS + 1]
            nblocks = 2
            print(f"{label}: one rank: the first {RANK_ITERATIONS} steps of "
                  f"phase 4's drive ({ref_rate:.4f} steps/s steady there)",
                  flush=True)
        else:
            one = make_solver(base + "_one", dims, "cuda", solver_name,
                              sweeps, physics, tag, nproc=nproc)
            one.run(iterations=RANK_ITERATIONS)
            ref, ref_rows, ref_rate = one_rank_reference(one)
            nblocks = len(one.case.blocks)
            del one
            torch.cuda.empty_cache()
            print(f"{label}: one rank {RANK_ITERATIONS} steps, "
                  f"{ref_rate:.4f} steps/s steady (steps {STEADY_FROM}-"
                  f"{RANK_ITERATIONS - 1}), built and run in "
                  f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        src = base + "_src"
        deck = os.path.basename(write_deck(src, dims, solver_name, sweeps,
                                           physics, tag))
        root = base + "_ranks"
        spec = dict(label=label, case_dir=src, deck=deck, root=root,
                    iterations=RANK_ITERATIONS, nproc=nproc,
                    compare=compare, card=card)
        t0 = time.perf_counter()
        outs = spawn_ranks(world, spec, root)
        seconds = time.perf_counter() - t0
        for r, o in enumerate(outs):
            for ln in o.splitlines():
                if ln.startswith(("phase 16", "FAIL")):
                    print(f"[rank {r}] {ln}", flush=True)
        stats = []
        for r in range(world):
            with open(os.path.join(root, f"stats{r}.json")) as f:
                stats.append(json.load(f))
        owned = sorted(b for st in stats for b in st["blocks"])
        if owned != list(range(nblocks)) or not all(st["blocks"]
                                                    for st in stats):
            fail(f"{label}: blocks by rank {[st['blocks'] for st in stats]}")
        worst, exact = 0.0, True
        scale = np.abs(ref).max(axis=0)
        scale[scale == 0.0] = 1.0      # the k momentum of a 2-D plate
        for st in stats:
            got = np.asarray(st["l2_history"])
            if got.shape != ref.shape or not np.isfinite(got).all():
                fail(f"{label}: rank {st['rank']} L2 history {got.shape}")
            worst = max(worst, float((np.abs(got - ref).max(axis=0)
                                      / scale).max()))
            exact = exact and bool((got == ref).all())
        with open(os.path.join(root, "rank0", "plate.resid")) as f:
            rows_got = f.read().splitlines()
        same_rows = sum(a == b for a, b in zip(rows_got[1:], ref_rows[1:]))
        print(f"{label}: {world} ranks, raw L2 of every rank against the "
              f"one-rank run max rel diff {worst:.3e} (tol {REF_RTOL:.0e}; "
              f"bit for bit: {exact}), .resid rows identical "
              f"{same_rows} of {len(ref_rows) - 1}; {world} processes in "
              f"{seconds:.1f} s", flush=True)
        if not worst <= REF_RTOL or len(rows_got) != len(ref_rows):
            fail(f"{label}: the ranks disagree with the one-rank run")
        for st in stats:
            want = {k: RANK_ITERATIONS * n * len(st["blocks"])
                    for k, n in per_block.items()}
            if st["launches"] != want:
                fail(f"{label}: rank {st['rank']} launched "
                     f"{st['launches']}, expected {want}")
            steady = st["step_seconds"][STEADY_FROM:]
            rate = len(steady) / sum(steady)
            pair = ""
            if compare:
                pair = (f"K1 (a) pair on its block {st['sweep'][1]:.4f} ms "
                        f"(plain {st['sweep'][2]:.1f}, bound "
                        f"{st['sweep'][3]:.4f}), K2 {st['viscous'][1]:.4f} "
                        f"ms (plain {st['viscous'][2]:.2f}, bound "
                        f"{st['viscous'][3]:.4f}); ")
            print(f"{label}: rank {st['rank']} blocks {st['blocks']} "
                  f"({st['cells']} cells): {pair}launches {st['launches']} "
                  f"(expected {want}); {rate:.4f} steps/s steady against "
                  f"{ref_rate:.4f} on one rank ({world} ranks time-sliced "
                  f"on one card, the exchange timed apart); exchange "
                  f"{st['exchange_bytes'] / RANK_ITERATIONS:.0f} bytes a "
                  f"step in {st['exchange_calls'] // RANK_ITERATIONS} swaps "
                  f"(gloo, host staging), {st['exchange_seconds']:.3f} s of "
                  f"the {st['seconds']:.3f} s run (share "
                  f"{st['exchange_seconds'] / st['seconds']:.4f}); peak "
                  f"device memory {st['max_memory_allocated'] / 2**30:.3f} "
                  f"GiB; built in {st['build_seconds']:.1f} s ({card})",
                  flush=True)
            if st.get("view_bytes") and st["rank"] == 0:
                print(f"{label}: rank 0's view of the whole grid for the "
                      f"files (a one-rank Solver, the state gathered from "
                      f"every rank) {st['view_bytes'] / 2**30:.3f} GiB on "
                      f"the card, built in {st['view_seconds']:.1f} s "
                      f"({card})", flush=True)
        if compare:
            rows = stats
    return rows


def ptxas_report(text):
    """one line per kernel instantiation from nvcc's -Xptxas -v output:
    the kernel with its template arguments, its registers and its spills"""
    lines, entry, spills = [], "?", ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry, spills = m.group(1), ""
            k = re.search(r"(sweep_tiles|viscous_tiles|prepass)I"
                          r"((?:L[ib]\d+E)+)E", entry)
            if k:
                args = re.findall(r"L[ib](\d+)E", k.group(2))
                entry = f"{k.group(1)}<{', '.join(args)}>"
        elif "spill" in ln and not spills:
            spills = ln.strip()
        elif "registers" in ln:
            used = ln.split(":", 1)[-1].strip()
            lines.append(f"{entry}: {used}; {spills}")
    return lines


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--rank-worker":
        return rank_worker(sys.argv[2])
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    sys.path.insert(0, REPO)
    try:
        from aither_tpu_torch import cases
        from aither_tpu_torch.cases import (SMOKE_2D_DIMS, SMOKE_3D_DIMS,
                                            TEST_DIMS)
        from aither_tpu_torch.utils.build import (load_cuda_libraries,
                                                  nvcc_path)
    except ImportError as exc:
        fail(f"the aither_tpu_torch package is not beside this script: "
             f"{exc}")
    check_no_jax_package()
    if cases.WALL_LAW_CLUSTER != WALL_LAW_CLUSTER:
        fail("WALL_LAW_CLUSTER differs from cases.WALL_LAW_CLUSTER")
    if cases.TP_AIR != TP_AIR:
        fail("TP_AIR differs from cases.TP_AIR")

    # -- phase 1: device facts ------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    proc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    nvcc = proc.stdout.strip().splitlines()[-1] if proc.stdout else "?"
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc: {nvcc}", flush=True)

    def done(phase):
        print(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    # -- phase 2: build -------------------------------------------------------
    ptxas = {}   # library -> its instantiations' ptxas lines

    def report_build(libs):
        for name, (_, info) in libs.items():
            print(f"phase 2 build: {os.path.relpath(info['path'], REPO)} "
                  f"built={info['built']} in {info['seconds']:.2f} s",
                  flush=True)
            ptxas[name] = ptxas_report(info["ptxas"])
            for ln in ptxas[name]:
                print(f"phase 2 ptxas {name}: {ln}", flush=True)
                spill = re.search(r"(\d+) bytes spill stores", ln)
                if name == "viscous_march" and (not spill
                                                or int(spill.group(1))):
                    fail(f"the viscous kernel spills: {ln}")
                if spill and int(spill.group(1)):
                    print(f"phase 2 ptxas {name}: spills: {ln}",
                          flush=True)

    t0 = time.perf_counter()
    libs = load_cuda_libraries(FIRST_LIBRARIES)
    print(f"phase 2 build: {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel)",
          flush=True)
    report_build(libs)
    # the other libraries build in a thread behind the phases, in two
    # groups, each one nvcc a library, in parallel: DEFERRED_LIBRARIES
    # (nothing before phase 11 loads one), then LAST_LIBRARIES (nothing
    # before phase 17)
    groups = {"deferred": DEFERRED_LIBRARIES, "last": LAST_LIBRARIES}
    builds = {name: {"ended": threading.Event()} for name in groups}
    started = time.perf_counter()

    def build_behind():
        # a lower priority for this thread and the nvcc it starts (on
        # Linux the nice value is a thread's): built at the main thread's,
        # they made phases 6 and 7 run 10-11% longer (PERF.md, section 6;
        # NVIDIA H100 80GB HBM3, 700 W)
        os.nice(10)
        for name, names in groups.items():
            try:
                builds[name]["libs"] = load_cuda_libraries(names)
            except Exception as exc:    # re-raised by built_behind
                builds[name]["error"] = exc
            builds[name]["ended"].set()

    behind = threading.Thread(target=build_behind)
    behind.start()
    done(2)

    def built_behind(name, phases):
        """wait for the builds of the group ``name`` and report them as
        phase 2's"""
        t_wait = time.perf_counter()
        builds[name]["ended"].wait()
        if "error" in builds[name]:
            fail(f"the {name} libraries: {builds[name]['error']}")
        print(f"phase 2 build: {len(builds[name]['libs'])} {name} "
              f"libraries, started {t_wait - started:.2f} s before, waited "
              f"{time.perf_counter() - t_wait:.2f} s (one nvcc each, in "
              f"parallel, behind phases {phases})", flush=True)
        report_build(builds[name]["libs"])

    def build(label, dims, solver_name, sweeps=1, physics="sst",
              tag="rusanov", layout=None):
        wd = os.path.join(RUN_DIR, f"{label}_{physics}_{solver_name}_"
                                   f"{sweeps}_{tag}_{layout}".replace(" ",
                                                                      "_"))
        es, tm, mixture = PHYSICS[physics]
        t0 = time.perf_counter()
        s = make_solver(wd, dims, "cuda", solver_name, sweeps, physics, tag,
                        layout)
        if es == "euler":           # a uniform flow otherwise
            perturb(s)
        gas = f", {mixture} ({s.phys.ns} species)" if mixture else ""
        bcs = f", boundaries {layout}" if layout else ""
        print(f"{label}: 2 blocks of {dims} ({es} / {tm}{gas}, "
              f"{solver_name}, matrixSweeps {sweeps}, {tag}: "
              f"{s.deck['timeIntegration']}, "
              f"{s.deck['inviscidFluxJacobian']}{bcs}) built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return s

    # -- phase 3: kernels vs plain at main-path shapes ------------------------
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    all_dims = {"case A": SMOKE_2D_DIMS, "case B": SMOKE_3D_DIMS,
                "case S": SMALL_DIMS}
    # (kernel, form, with the lagged term) -> {case: comparison result}
    results = {}

    def record(key, case, result):
        results.setdefault(key, {})[case] = result

    # (kernel, form, with the lagged term) of the forms compared on some
    # blocks (COMPARED_BLOCKS) -> the blocks
    compared_blocks = {}

    # (kernel, form, with the lagged term, case) of the forms whose plain
    # version held some blocks alone (PLAIN_BLOCKS) -> the blocks
    plain_held = {}

    def compare_all(solver, label, case, extras, fields, blocks=None,
                    plain_blocks=None):
        """this solver's sweep kernel (scalar or block) with and without
        the lagged term as ``extras`` says (on ``blocks``, indices, or
        every block; held against the plain version on ``plain_blocks``,
        or on all of those), and the viscous kernel on the ``fields``
        named"""
        from aither_tpu_torch.kernels import lusgs_sweep as ls
        kernel = ("blusgs_sweep" if solver.cfg["block_matrix"]
                  else "lusgs_sweep")
        form = ls.sweep_form(solver.phys, solver.cfg)
        if extras:
            system = linear_system(solver)
            for with_extra in extras:
                record((kernel, form, with_extra), case,
                       compare_sweeps(torch, solver, system, label, card,
                                      with_extra, case, blocks=blocks,
                                      plain_blocks=plain_blocks))
                if plain_blocks is not None:
                    plain_held[(kernel, form, with_extra, case)] = list(
                        plain_blocks)
                if blocks is not None:
                    compared_blocks[(kernel, form, with_extra)] = list(
                        blocks)
        for field in fields:
            res = compare_viscous(torch, solver, label, card,
                                  perturbed=field == "perturbed", case=case)
            if field == "perturbed":
                record(("viscous_march", solver.phys.turb_model), case, res)

    def compare_lagged_only(solver, label, case, physics, tag):
        """the lagged variant (b) of a thermally perfect scalar mixture
        form whose deck (LAGGED_ONLY) compares only (a): held against its
        plain version as well (compare_sweeps fails the run if it
        disagrees), but no row of the kernels line, since no driven path
        launches it"""
        if (physics, tag) not in LAGGED_ONLY:
            return
        print(f"{label}: variant (b) of this form, held against its plain "
              f"version only (no driven path takes it)", flush=True)
        compare_sweeps(torch, solver, linear_system(solver), label, card,
                       True, case, blocks=COMPARED_BLOCKS.get(case),
                       plain_blocks=PLAIN_BLOCKS.get(case))

    solver = None
    for case in ("case A", "case B"):
        dims = all_dims[case]
        label = f"phase 3 {case}"
        del solver
        if case == "case B":
            # the block pair at case B only: at case A phase 13 compares
            # (c) on the wall-law deck and phase 12 (c)+(b) at level 1
            solver = build(label, dims, "blusgs")
            compare_all(solver, label, case, (False, True), ())
            del solver
        solver = build(label, dims, "lusgs")
        compare_all(solver, label, case, (False, True), ("perturbed",))
    done(3)

    # (kernel, form, with the lagged term) -> (launches of its drive, case)
    launches = {}
    # viscous kernel key -> (ms per iteration inside Solver.run, case)
    path_ms = {}

    # phase 11: K2 launches of each drive of the new paths, with its model
    new_path_k2 = {}

    def drive_and_count(solver, iterations, sweeps, label, case="case B"):
        from aither_tpu_torch.kernels import lusgs_sweep as ls
        n = drive(torch, solver, iterations, sweeps, label, card, case)
        if label.startswith("phase 11"):
            new_path_k2[label] = (n["viscous_march"], solver.phys.turb_model)
        if solver.sweeps:
            kernel = ("blusgs_sweep" if solver.cfg["block_matrix"]
                      else "lusgs_sweep")
            form = ls.sweep_form(solver.phys, solver.cfg)
            # a form's first driven path gives its count (and its
            # pre-pass launches)
            launches.setdefault((kernel, form, sweeps > 1),
                                (n[kernel], case, n["sweep_prepass"]))
        if n["viscous_march"]:
            key = ("viscous_march", solver.phys.turb_model)
            launches.setdefault(key, (n["viscous_march"], case))
            # the kernel's time inside Solver.run, at the size of the
            # row's other times where a path of that size was driven
            if key not in path_ms or (case == "case B"
                                      and path_ms[key][1] != case):
                path_ms[key] = (n["viscous_path_ms"], case)
        return n

    # -- phase 4: main path, matrixSweeps 1 ----------------------------------
    main_rate = drive_and_count(solver, MAIN_ITERATIONS, 1,
                                "phase 4 main path")["steps_per_s"]
    main_path = one_rank_reference(solver)
    del solver
    done(4)

    # -- phase 5: the lagged-term path, matrixSweeps 2 ------------------------
    solver = build("phase 5", SMOKE_3D_DIMS, "lusgs", 2)
    drive_and_count(solver, LAGGED_ITERATIONS, 2, "phase 5 matrixSweeps 2")
    del solver
    done(5)

    # -- phase 6: small-case reference, cuda against cpu ----------------------
    references = [("sst", name, sweeps, "rusanov")
                  for name in ("lusgs", "blusgs") for sweeps in (1, 2)]
    references += [(physics, "lusgs", 1, "rusanov")
                   for physics in ("euler", "laminar", "les", "wilcox")]
    references += [(physics, "blusgs", 1, "rusanov")
                   for physics in ("laminar", "wilcox")]
    references += [("n2o2", "lusgs", 1, "rusanov"),
                   ("air5", "blusgs", 1, "rusanov")]
    references += [("sst", "dplur", 4, "rusanov"),
                   ("laminar", "lusgs", 1, "rk4"), ("sst", "lusgs", 1, "bdf2")]
    references += [("sst", "lusgs", 1, "mg3W"), ("sst", "blusgs", 1, "mg2V")]
    # phase 15's: WENO-Z, AUSM, centralFourth
    references += [("sst", "lusgs", 1, tag) for tag in ("wenoZ", "ausm", "c4")]
    references = [r + (None,) for r in references]
    # phase 13's decks 1-3: periodic span, LODI with its carry, wall law
    references += [("sst", "lusgs", 1, "rusanov", layout)
                   for layout in ("stagnation_periodic", "lodi", "wall_law")]

    def check_references(references, when=""):
        for physics, solver_name, sweeps, tag, layout in references:
            hist = {dev: reference_history(TEST_DIMS, dev, solver_name,
                                           sweeps, physics, tag, layout)
                    for dev in ("cuda", "cpu")}
            # per equation, relative to that equation's largest L2
            worst = float((np.abs(hist["cuda"] - hist["cpu"]).max(axis=0)
                           / np.abs(hist["cpu"]).max(axis=0)).max())
            tol = (REACTING_BLOCK_RTOL if (physics, solver_name) == (
                "air5", "blusgs") else REF_RTOL)
            if not np.isfinite(hist["cuda"]).all():
                fail(f"{physics}, {solver_name}, {tag}: non-finite L2 on "
                     f"cuda")
            print(f"phase 6 reference{when}: {TEST_DIMS} x 2 blocks, "
                  f"{physics}, {solver_name}, matrixSweeps {sweeps}, {tag}, "
                  f"{f'boundaries {layout}, ' if layout else ''}"
                  f"{REF_ITERATIONS} steps ({len(hist['cpu'])} nonlinear "
                  f"iterations), cuda vs cpu raw L2 max rel diff "
                  f"{worst:.3e} (tol {tol:.0e})", flush=True)
            if not worst <= tol:
                fail(f"{physics}, {solver_name}, matrixSweeps {sweeps}, "
                     f"{tag}: the cuda run disagrees with the cpu run")

    check_references(references)
    reference_files(torch)
    done(6)

    # -- phase 7: the blusgs path, matrixSweeps 1 and 2 -----------------------
    solver = build("phase 7", SMOKE_3D_DIMS, "blusgs", 1)
    drive_and_count(solver, BLOCK_ITERATIONS, 1, "phase 7 blusgs")
    del solver
    solver = build("phase 7", SMOKE_3D_DIMS, "blusgs", 2)
    drive_and_count(solver, BLOCK_LAGGED_ITERATIONS, 2,
                    "phase 7 blusgs matrixSweeps 2")
    del solver
    done(7)

    # -- phase 8: the other physics, compared and driven ----------------------
    for case, physics, solver_name, sweeps, extras, fields in NEW_DECKS:
        label = f"phase 8 {case} {physics} {solver_name}"
        solver = build(label, all_dims[case], solver_name, sweeps, physics)
        compare_all(solver, label, case, extras, fields,
                    blocks=COMPARED_BLOCKS.get(case),
                    plain_blocks=PLAIN_BLOCKS.get(case))
        drive_and_count(solver, NEW_ITERATIONS, sweeps, label, case)
        del solver
    done(8)

    # -- phase 9: multispecies, compared and driven ---------------------------
    for case, physics, solver_name, sweeps, extras in MIXTURE_DECKS:
        label = f"phase 9 {case} {physics} {solver_name}"
        solver = build(label, all_dims[case], solver_name, sweeps, physics)
        compare_all(solver, label, case, extras, (),
                    blocks=COMPARED_BLOCKS.get(case),
                    plain_blocks=PLAIN_BLOCKS.get(case))
        drive_and_count(solver, MIXTURE_ITERATIONS, sweeps, label, case)
        del solver
    done(9)

    # -- phase 10: the viscous kernel's tile and segment edges ----------------
    for physics in RAGGED_PHYSICS:
        solver = build("phase 10 ragged", RAGGED_DIMS, "lusgs", 1, physics)
        compare_viscous(torch, solver, "phase 10 ragged", card,
                        case="ragged")
        del solver
    done(10)

    # -- phase 11: the other linear solvers and time integrators -------------
    built_behind("deferred", "3-10")
    # phase 6's references of the deferred libraries: SST approximateRoe
    # lusgs and blusgs (phase 11's), thermally perfect hot air SST lusgs
    # and blusgs (phase 15's)
    check_references([("sst", name, 1, tag, None)
                      for tag in ("roe", "tp") for name in ("lusgs", "blusgs")],
                     " (the deferred libraries')")
    for case, physics, solver_name, sweeps, tag, extras, steps in \
            SOLVER_DECKS:
        label = (f"phase 11 {case} {physics} {solver_name} matrixSweeps "
                 f"{sweeps} {tag}")
        solver = build(label, all_dims[case], solver_name, sweeps, physics,
                       tag)
        compare_all(solver, label, case, extras, (),
                    blocks=COMPARED_BLOCKS.get(case),
                    plain_blocks=PLAIN_BLOCKS.get(case))
        drive_and_count(solver, steps, sweeps, label, case)
        del solver
    print(f"phase 11: viscous kernel launches of the drives {new_path_k2}",
          flush=True)
    done(11)

    # -- phase 12: multigrid, compared and driven ----------------------------
    # (kernel, form, with the lagged term) -> {label: launches of the drive}
    mg_launches = {}
    # (kernel, form, with the lagged term) -> {"<case> level <l>": result}
    mg_levels = {}
    for case, physics, solver_name, sweeps, tag, per_iteration, compare in \
            MG_DECKS:
        from aither_tpu_torch.kernels import lusgs_sweep as ls
        label = f"phase 12 {case} {physics} {solver_name} {tag}"
        solver = build(label, all_dims[case], solver_name, sweeps, physics,
                       tag)
        cells = [c.total_cells for c in solver.mg_cases]
        dims = [[(b.ni, b.nj, b.nk) for b in c.blocks]
                for c in solver.mg_cases]
        print(f"{label}: {solver.mg_nlevels} levels of {dims} blocks, "
              f"{cells} cells, built on the host in "
              f"{solver.mg_build_seconds:.2f} s (coarse cases and "
              f"transfer maps)", flush=True)
        block = bool(solver.cfg["block_matrix"])
        kernel = "blusgs_sweep" if block else "lusgs_sweep"
        form = ls.sweep_form(solver.phys, solver.cfg) if solver.sweeps \
            else None
        if compare:
            for lvl, system in sorted(level_systems(solver).items()):
                mg_levels.setdefault((kernel, form, True), {})[
                    f"{case} level {lvl}"] = compare_sweeps(
                    torch, solver, system, label, card, True, case, lvl)
            if not block and solver.cfg["viscous"]:
                mg_levels.setdefault(
                    ("viscous_march", solver.phys.turb_model), {})[
                    f"{case} level 1"] = compare_viscous(
                    torch, solver, label, card, case=case, lvl=1, blocks=(0,))
        n = drive(torch, solver, MG_ITERATIONS, sweeps, label, card, case,
                  per_iteration)
        if solver.sweeps:
            lagged = n["sweeps_with_extra"]
            for with_extra, count in ((False, n[kernel] - lagged),
                                      (True, lagged)):
                if count:
                    mg_launches.setdefault((kernel, form, with_extra), {})[
                        label] = count
        if n["viscous_march"]:
            mg_launches.setdefault(
                ("viscous_march", solver.phys.turb_model), {})[label] = \
                n["viscous_march"]
        print(f"{label}: below level 0 a share {n['coarse_share']:.4f} of "
              f"the steady iterations ({card})", flush=True)
        del solver
    done(12)

    # -- phase 13: boundaries, compared and driven ----------------------------
    # (kernel, form, with the lagged term) -> {label: launches of the drive}
    bc_launches = {}
    # (kernel, form, with the lagged term) -> {label: comparison result}
    bc_compared = {}
    for case, physics, solver_name, layout, per_iteration, pair, visc in \
            BC_DECKS:
        from aither_tpu_torch.kernels import lusgs_sweep as ls
        label = f"phase 13 {case} {physics} {solver_name} {layout}"
        solver = build(label, all_dims[case], solver_name, 1, physics,
                       layout=layout)
        block = bool(solver.cfg["block_matrix"])
        kernel = "blusgs_sweep" if block else "lusgs_sweep"
        form = ls.sweep_form(solver.phys, solver.cfg)
        if pair:
            bc_compared.setdefault((kernel, form, False), {})[label] = \
                compare_sweeps(torch, solver, linear_system(solver), label,
                               card, False, case)
        if visc:
            bc_compared.setdefault(
                ("viscous_march", solver.phys.turb_model), {})[label] = \
                compare_viscous(torch, solver, label, card, case=case,
                                blocks=(0,))
        wall_law = BC_LAYOUTS[layout].get("wall_treatment") == "wallLaw"
        if wall_law:
            print(f"{label}: {wall_law_shares(solver)} before the drive",
                  flush=True)
            events, solve = wall_law_timer(torch)
        try:
            n = drive(torch, solver, BC_ITERATIONS, 1, label, card, case,
                      per_iteration)
        finally:
            if wall_law:
                from aither_tpu_torch.solver import wall_law as wl
                wl.solve_wall_law = solve
        for name, count in per_iteration.items():
            if count:
                key = ((name, solver.phys.turb_model)
                       if name == "viscous_march" else (name, form, False))
                bc_launches.setdefault(key, {})[label] = n[name]
        if wall_law:
            torch.cuda.synchronize()
            per = [e0.elapsed_time(e1) for e0, e1 in events]
            steady = per[len(per) // BC_ITERATIONS:]
            print(f"{label}: {wall_law_shares(solver)} after the drive; "
                  f"the wall-law solve {len(per)} calls "
                  f"({len(per) // BC_ITERATIONS} an iteration: blocks x "
                  f"ghost layers), "
                  f"{sum(steady) / (BC_ITERATIONS - 1):.3f} ms an iteration "
                  f"from iteration 1 on by CUDA events ({card})", flush=True)
        if layout == "stagnation_periodic":
            share = boundary_share(torch, solver)
            print(f"{label}: {n['steps_per_s']:.4f} steps/s against the "
                  f"main path's {main_rate:.4f} (phase 4: characteristic "
                  f"in/outflow, slipWall span); boundary pass (full ghost "
                  f"fill and viscous wall ghosts) {share:.4f} of the "
                  f"iteration in a further 3-step run timed between "
                  f"synchronisations ({card})", flush=True)
        if layout == "lodi":
            dts = torch.stack([a["dt"].aminmax()[i]
                               for a in solver.bc_aux.values()
                               for i in (0, 1)]).cpu().numpy()
            if not (np.isfinite(dts).all() and dts.min() > 0.0):
                fail(f"{label}: the carried dt is {dts}")
            print(f"{label}: carried bc_aux dt after the drive in "
                  f"[{dts.min():.4e}, {dts.max():.4e}]", flush=True)
        del solver
    done(13)

    # -- phase 14: files, restart and point-cloud initial conditions ---------
    files_launches = files_phase(
        torch, card, lambda s: drive(torch, s, 2, 1, "phase 14 cloud", card,
                                     "case A"))
    done(14)

    # -- phase 15: the remaining physics, compared and driven ----------------
    for case, physics, solver_name, sweeps, tag, extras, visc, steps in \
            PHYSICS_DECKS:
        label = (f"phase 15 {case} {physics} {solver_name} matrixSweeps "
                 f"{sweeps} {tag}")
        solver = build(label, all_dims[case], solver_name, sweeps, physics,
                       tag)
        # the WENO-Z comparisons of the SST forms run at three ghost
        # layers: a case of their own in the rows
        where = G3_CASE if tag == "wenoZ" else case
        print(f"{label}: {solver.case.blocks[0].g} ghost layers",
              flush=True)
        compare_all(solver, label, where, extras,
                    ("perturbed",) if visc else (),
                    blocks=COMPARED_BLOCKS.get(case),
                    plain_blocks=PLAIN_BLOCKS.get(case))
        compare_lagged_only(solver, label, case, physics, tag)
        drive_and_count(solver, steps, sweeps, label, case)
        del solver
    done(15)

    # -- phase 16: multi-rank runs on the card --------------------------------
    rank_rows = ranks_phase(torch, card, main_path)
    done(16)

    # -- phase 17: the last forms, compared and driven ------------------------
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    built_behind("last", "3-16")
    # phase 6's references of the last libraries (hot air thermally
    # perfect approximateRoe SST lusgs, seven-species hydrogen-air SST
    # blusgs), once their builds have ended
    check_references([("sst", "lusgs", 1, "roe_tp", None),
                      ("h2air7", "blusgs", 1, "rusanov", None)],
                     " (the last libraries')")
    for case, physics, solver_name, sweeps, tag, extras, steps in \
            LAST_DECKS:
        label = (f"phase 17 {case} {physics} {solver_name} matrixSweeps "
                 f"{sweeps} {tag}")
        solver = build(label, all_dims[case], solver_name, sweeps, physics,
                       tag)
        library = ls.form_library(solver.phys, solver.cfg)
        if library not in LAST_LIBRARIES + BASE_LIBRARIES:
            fail(f"{label}: its form's library {library} is not one of "
                 f"LAST_LIBRARIES or BASE_LIBRARIES")
        print(f"{label}: the sweep form "
              f"{form_name(ls.sweep_form(solver.phys, solver.cfg))} of "
              f"library {library}", flush=True)
        compare_all(solver, label, case, extras, (),
                    blocks=COMPARED_BLOCKS.get(case),
                    plain_blocks=PLAIN_BLOCKS.get(case))
        compare_lagged_only(solver, label, case, physics, tag)
        drive_and_count(solver, steps, sweeps, label, case)
        del solver
    done(17)
    check_no_jax_package()

    sources = {"lusgs_sweep": "aither_tpu_torch/csrc/lusgs_sweep.cu",
               "blusgs_sweep": "aither_tpu_torch/csrc/blusgs_sweep.cu",
               "viscous_march": "aither_tpu_torch/csrc/viscous_march.cu"}
    kernels = []
    for key, by_case in results.items():
        if key not in launches:
            fail(f"{key} was compared but no driven path launched it")
        case = next((c for c in ("case B", "case A", "case S")
                     if c in by_case), None)
        if case is None:
            fail(f"{key}: compared only at {sorted(by_case)}")
        _, ms, plain_ms, bound, by = by_case[case][:5]
        if key[0] == "viscous_march":
            name = f"viscous_march ({key[1]})"
            replaces = "aither_tpu/solver/pallas_residual.py:602"
        else:
            variant = {"lusgs_sweep": ("a", "b, lagged term"),
                       "blusgs_sweep": ("c, block", "c+b, block, lagged term")
                       }[key[0]][int(key[2])]
            name = f"{key[0]} (variant {variant}; {form_name(key[1])})"
            replaces = (ROE_REPLACES if key[1][4] else TP_REPLACES
                        if key[1][5]
                        else "aither_tpu/solver/pallas_sweep.py:239")
        if key[0] != "viscous_march":
            ns, _, _, _, roe, tp = key[1]
            library = ls.library_name(key[0] == "blusgs_sweep", roe, tp, ns)
            name = f"{name}, library {library}"
        kernels.append({
            "name": name, "route": "cuda", "source": sources[key[0]],
            "replaces": replaces, "launches": launches[key][0],
            "max_abs_err": max(r[0] for r in by_case.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "case": case,
            "launches_case": launches[key][1]})
        if key[0] != "viscous_march":
            # the registers and spills of its instantiations (ptxas,
            # sm_90a): the forward and backward wavefront, and the
            # pre-pass's where it has one
            ns, neq, viscous, wilcox = key[1][:4]
            args = f"{ns}, {neq}, {int(viscous)}, {int(wilcox)}, "
            kernels[-1]["registers"] = [
                ln for ln in ptxas.get(library, [])
                if ln.split(">")[0].split("<")[-1].startswith(args)]
            kernels[-1]["prepass_launches"] = launches[key][2]
        if key[0] != "viscous_march" and len(by_case[case]) > 5:
            # a pre-pass form: its work space's traffic (work_space_bytes),
            # from this run's plans (the earlier design's time is only in
            # the printed line)
            kernels[-1].update(by_case[case][5])
        if key[0] == "viscous_march":
            # the first window after the plain run, and the kernel inside
            # Solver.run (all blocks, per iteration) with its case
            kernels[-1].update(cold_ms=by_case[case][5],
                               path_ms=path_ms[key][0],
                               path_case=path_ms[key][1],
                               new_path_launches={
                                   label: n for label, (n, model) in
                                   new_path_k2.items()
                                   if n and model == key[1]})
    for key in list(mg_launches) + list(mg_levels):
        if key not in results:
            fail(f"{key}: on the multigrid path but in no kernels row")
    for row, key in zip(kernels, results):
        if key in mg_launches:
            row["mg_launches"] = mg_launches[key]
        if key in mg_levels:
            row["mg_levels"] = {
                where: dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by"), r[:5]))
                for where, r in mg_levels[key].items()}
    for key in list(bc_launches) + list(bc_compared):
        if key not in results:
            fail(f"{key}: on a boundary path but in no kernels row")
    for row, key in zip(kernels, results):
        if key in bc_launches:
            row["bc_launches"] = bc_launches[key]
        if key in bc_compared:
            row["bc_compared"] = {
                where: dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by"), r[:5]))
                for where, r in bc_compared[key].items()}
    for row, key in zip(kernels, results):
        if key in compared_blocks and row["case"] in COMPARED_BLOCKS:
            row["compared_blocks"] = compared_blocks[key]
        if key + (row["case"],) in plain_held:
            row["plain_blocks"] = plain_held[key + (row["case"],)]
    for row, key in zip(kernels, results):
        if G3_CASE in results[key]:
            # phase 15's WENO-Z comparison at three ghost layers
            row["g3"] = dict(zip(("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by"),
                                 results[key][G3_CASE][:5]))
    for key in files_launches:
        if key not in results:
            fail(f"{key}: on the files path but in no kernels row")
    for row, key in zip(kernels, results):
        if key in files_launches:
            row["files_launches"] = files_launches[key]
    # K1 (d): the scalar SST sweep (variant a) of each rank on its own
    # whole blocks, compared on each rank and launched by the ranks' drive
    kernels.append({
        "name": "lusgs_sweep (variant d: each rank's sweeps over its own "
                "whole blocks; a, 7 eq SST)",
        "route": "cuda", "source": sources["lusgs_sweep"],
        "replaces": "aither_tpu/solver/pallas_sweep.py:362-378 (sweep in "
                    "a shard_map, variant d)",
        "launches": sum(st["launches"]["lusgs_sweep"] for st in rank_rows),
        "max_abs_err": max(st["sweep"][0] for st in rank_rows),
        "ms": max(st["sweep"][1] for st in rank_rows),
        "plain_ms": max(st["sweep"][2] for st in rank_rows),
        "bound_ms": max(st["sweep"][3] for st in rank_rows),
        "bound_by": rank_rows[0]["sweep"][4], "library_ms": None,
        "case": "case B, one block per rank", "launches_case": "case B",
        "ranks": [{"rank": st["rank"], "blocks": st["blocks"],
                   "ms": st["sweep"][1], "plain_ms": st["sweep"][2],
                   "launches": st["launches"],
                   "viscous_ms": st["viscous"][1],
                   "viscous_max_abs_err": st["viscous"][0],
                   "steps_per_s": len(st["step_seconds"][STEADY_FROM:])
                   / sum(st["step_seconds"][STEADY_FROM:]),
                   "exchange_bytes_per_step":
                       st["exchange_bytes"] / RANK_ITERATIONS,
                   "exchange_share": st["exchange_seconds"] / st["seconds"],
                   "max_memory_allocated": st["max_memory_allocated"]}
                  for st in rank_rows]})
    for row in kernels:
        if not row["launches"] > 0:
            fail(f"{row['name']}: no launch on its driven path")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
