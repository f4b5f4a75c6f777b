"""Time-marching driver: implicit (implicitEuler, crankNicholson, bdf2
with or without dual time) or explicit (explicitEuler, rk4) steps of one
or more nonlinear iterations, residual logging in the reference format.

Port of ``aither_tpu/solver/driver.py`` for the slice the port runs:
``Solver.__init__`` (the subset the decks need, with the multigrid levels
of an implicit deck, ``solver/multigrid.py``), ``_iteration`` (the
implicit update, or the explicit Euler / RK4 stage update), ``_setup_linear``
(scalar or block diagonal at a grid level with the W cycle's diagonal
carry, the rhs of one or two time levels, with the matrix initialisation
``matrixSweeps > 1`` and DPLUR need), ``_relax`` at a grid level (lusgs /
blusgs sweeps, dplur / bdplur Jacobi sweeps, the coarse levels' forcing),
the FAS V/W cycle (``_level_state``, ``_restrict_level``, ``_mg_cycle``,
with the stage trace ``_mg_trace``), ``_implicit_update``,
``store_old_solution``, the ``.resid`` / ``.tme`` writers with the
first-5-iteration re-max normalisation, the debug-mode physicality check
(``check_physicality``), the per-step branch of ``run`` with the time
n-1 solution of bdf2 and the nonreflecting boundaries' carry ``bc_aux``,
and file output and restart: ``write_grid_center``, ``write_output``
(cell-center, wall and nodal function files from one output evaluation
of the residual at the pre-update state), ``write_restart`` and
``_load_restart`` (the reference's ``.rst``), recombined into the grid's
original blocks for a decomposed run (``_sync_output_view``) (reference:
src/main.cpp:231-302, output.cpp:55-1166).

Every deck setting outside the slice is refused with NotImplementedError
naming its ROADMAP.md item; nothing silently takes another path.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..io import output as out_mod
from ..kernels import lusgs_sweep
from . import implicit as imp
from . import multigrid as mg
from . import state as st_mod
from . import step as step_mod
from . import viscous as vis
from .case import build_case
from .convert import bc_aux_from_numpy, scatter_state, state_from_numpy
from .viscous import needs_face_length, viscous_statics

EPS = 1.0e-30


def check_supported(deck):
    """Admit every deck setting of the JAX package's decks: an unknown
    boundary type raises its ValueError from ``bc.ghost_state``, as there,
    and a form the sweep kernels lack is refused on the card by
    ``lusgs_sweep.sweep_form`` at ``Solver`` construction."""


class Solver:
    """Solver on one device: Euler, laminar Navier-Stokes, LES (WALE) and
    RANS (k-omega Wilcox 2006, SST 2003, SST-DES), one species or a
    mixture (Schmidt diffusion, frozen or reacting chemistry), calorically
    or thermally perfect; MUSCL, constant, WENO or WENO-Z face
    reconstruction, central or centralFourth viscous reconstruction, the
    Roe or AUSMPW+ flux; implicit with scalar or block LU-SGS or DPLUR and the
    Rusanov or approximateRoe off-diagonal, on one grid level or by FAS
    multigrid V or W cycles (``multigridLevels``, ``multigridCycle``), or
    explicit (Euler, RK4).

    ``Solver(deck_path, device="cuda")`` builds the case on the device;
    ``run(iterations)`` marches and writes ``<deck>.resid`` / ``<deck>.tme``
    into ``workdir``.  Raises if the device is CUDA and no card is present.
    ``debug`` turns on the per-iteration physicality check; None defers to
    the ``AITHER_DEBUG`` environment variable (any value but "0" or "").
    ``restart_path`` resumes from a ``.rst`` file of either package (the
    state, time n-1 of a bdf2 deck, the iteration and the residual
    normalisation).  ``run(write_files=True)`` also writes, into
    ``workdir``: ``<gridName>_center.xyz`` (cell centers),
    ``<deck>_<n>_center.fun`` with ``<deck>_center.p3d`` (the deck's
    ``outputVariables`` at the cell centers), with ``wallOutputVariables``
    ``<deck>_wall_center.xyz`` and ``<deck>_<n>_wall_center.fun``, with
    ``outputNodalVariables`` ``<deck>_<n>.fun`` and ``<deck>.p3d`` (at the
    grid's nodes), at the start and every ``outputFrequency`` steps, and
    ``<deck>_<n>.rst`` every ``restartFrequency`` steps.

    ``comm`` (``parallel/distributed.Comm``) makes this Solver one rank of
    a multi-rank run (``parallel/distributed.rank_solver``): the rank owns
    whole blocks (``parallel/shard.block_owners``) and holds on its device
    only their state, geometry, statics, sweep plans and multigrid levels;
    ``case.blocks`` and every per-block dict are its blocks, by their
    global index, and ``case.layout`` describes them all.  It runs the
    kernels on its blocks (K1 (d): each rank's sweeps over its own whole
    blocks), swaps connection ghosts with the other ranks at every level
    (``case.exchange``), gathers the norms per block and reduces them in
    block order as one rank does, so that every rank's rows are the
    one-rank run's, and takes part in the files, which rank 0 alone
    writes (``_sync_output_view``).
    """

    def __init__(self, deck_path: str, device="cuda", dtype=torch.float64,
                 workdir=None, nproc: int = 1, restart_path=None,
                 debug=None, comm=None):
        # debug mode: per-iteration physicality checks, the analogue of the
        # reference's armed FP exceptions + MSG_ASSERT guards
        # (reference: main.cpp:78-82, procBlock.cpp:434-437)
        if debug is None:
            debug = os.environ.get("AITHER_DEBUG", "0") not in ("0", "")
        self.debug = bool(debug)
        self._deck_path = deck_path
        self._nproc = nproc
        self.comm = comm
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False (use "
                               "device 'cpu' to run on the CPU)")
        self.case = build_case(deck_path, self.device, dtype=dtype,
                               nproc=nproc, comm=comm)
        self.deck = self.case.deck
        self.phys = self.case.phys
        deck = self.deck
        self.workdir = workdir or os.getcwd()
        sim_root = os.path.splitext(os.path.basename(deck_path))[0]
        self.sim_root = os.path.join(self.workdir, sim_root)
        a_ref, l_ref = deck.a_ref, deck.l_ref
        self.cfg = dict(
            recon={"constant": "constant", "weno": "weno",
                   "wenoZ": "wenoZ"}.get(deck["faceReconstruction"],
                                         "muscl"),
            kappa=deck.kappa,
            limiter=deck["limiter"],
            flux=deck["inviscidFlux"],
            dt=deck["timeStep"],
            dt_nondim=deck["timeStep"] * a_ref / l_ref,
            time_integration=deck["timeIntegration"],
            implicit=deck.is_implicit,
            theta=deck.theta,
            zeta=deck.zeta,
            multilevel_time=deck.is_multilevel_in_time,
            dual_time_cfl=deck["dualTimeCFL"],
            matrix_relaxation=deck["matrixRelaxation"],
            viscous=deck.is_viscous,
            turbulent=deck.is_turbulent,
            turb_model=deck["turbulenceModel"],
            viscous_cfl_coeff=deck.viscous_cfl_coefficient(),
            viscous_recon=deck["viscousFaceReconstruction"],
            inv_flux_jac=deck["inviscidFluxJacobian"],
            block_matrix=deck.is_block_matrix,
            matrix_sweeps=deck["matrixSweeps"],
            matrix_init=deck.matrix_requires_initialization(),
            diffusion=deck["diffusionModel"],
            schmidt=deck["schmidtNumber"],
            turb_schmidt=0.7,
        )
        # the LODI (nonreflecting) BCs are the only per-iteration consumer
        # of the cell pressure gradient (the bc_aux carry); without them
        # the residual skips its accumulation (step.full_residual)
        self.cfg["need_pgrad"] = any(
            spec.data is not None and spec.data.nonreflecting
            for b in self.case.layout for spec in b.surfaces)
        # the LU-SGS sweeps (lusgs, blusgs) walk hyperplane plans; DPLUR
        # and the explicit integrators sweep nothing
        self.sweeps = deck.is_implicit and deck["matrixSolver"] in (
            "lusgs", "blusgs")
        if self.sweeps and self.device.type == "cuda":
            # refuse a form the sweep kernels are not built for (a species
            # count above lusgs_sweep.MAX_SPECIES, a thermally perfect
            # approximateRoe off-diagonal) before any work
            lusgs_sweep.sweep_form(self.phys, self.cfg)
        # multigrid levels of an implicit deck (an explicit one runs on
        # one level, as the JAX package does): the coarse cases, each with
        # its own connection swap maps, and the fine->coarse transfer maps
        self.mg_nlevels = deck["multigridLevels"] if deck.is_implicit else 1
        self.mg_cycle_index = 2 if deck["multigridCycle"] == "W" else 1
        self.mg_cases, self.mg_maps = [self.case], []
        t0 = time.perf_counter()
        if self.mg_nlevels > 1:
            self.mg_cases, self.mg_maps = mg.build_levels(self.case,
                                                          self.mg_nlevels)
        self.mg_build_seconds = time.perf_counter() - t0
        self._mg_diag_carry = {}
        self._mg_trace_log = None
        if deck.is_viscous:
            # static face geometry of the viscous residual, once per block
            # of every level
            for c in self.mg_cases:
                for b in c.blocks:
                    viscous_statics(b, needs_face_length(self.cfg))
        self.prims = {b.index: b.prim0.clone() for b in self.case.blocks}
        # restart: the state, iteration and residual normalisation of a
        # .rst file (the time n-1 solution of a bdf2 deck below)
        self.is_restart = restart_path is not None
        if comm is not None:
            # rank 0 alone is given the file; every rank takes part in
            # its scatter
            self.is_restart = comm.broadcast_object(self.is_restart)
        self.l2_first = None
        self.iteration_start = 0
        self._restart_nm1 = None
        if self.is_restart:
            self._load_restart(restart_path)
        # file output: the state before the last update (write_output's
        # output evaluation), the parent-layout view of a decomposed run
        # and its per-cell rank and block fields
        self._prev_prims = None
        self._parent_view = None
        self._decomp_fields = None
        # the hyperplane plans of the sweeps, per level and block
        self.mg_plans = [
            {b.index: imp.build_sweep_plan(b, dtype, self.device)
             for b in c.blocks} if self.sweeps else {}
            for c in self.mg_cases]
        self.plans = self.mg_plans[0]
        self.cons_n = self.store_old_solution()
        # the nonreflecting BCs' carry: the previous iteration's dt and
        # cell pressure and velocity gradients, zero at the start
        self.bc_aux = self._zero_bc_aux()
        # time n-1 conserved interiors of a multilevel (bdf2) deck; set to
        # time n at the first step of ``run`` unless carried in by
        # ``set_state``
        self.cons_nm1 = (dict(self.cons_n) if deck.is_multilevel_in_time
                         else None)
        self._nm1_carried = False
        if self._restart_nm1 is not None:
            from ..io.restart import cons_from_restart
            self.cons_nm1 = {b.index: torch.as_tensor(cons_from_restart(
                self._restart_nm1[b.index], self.phys, deck,
                mu_ref=self.phys.mu_mix_ref), dtype=dtype,
                device=self.device) for b in self.case.blocks}
            self._nm1_carried = True
            self._restart_nm1 = None
        self.l2_history = []     # raw per-equation L2 of every iteration
        self.step_seconds = []   # host seconds of every step of ``run``

    # -- state ---------------------------------------------------------------
    def set_state(self, prims, cons_n=None, cons_nm1=None, bc_aux=None):
        """Start from given padded primitive arrays ({block: numpy}) and,
        optionally, time-n conserved interiors, for a multilevel (bdf2)
        deck time n-1 ones, and the nonreflecting BCs' carry ({block:
        {'dt', 'pgrad', 'vgrad'}}) (e.g. the JAX package's
        ``Solver.prims`` / ``cons_n`` / ``cons_nm1`` / ``bc_aux``).  A
        carried ``cons_nm1`` is kept by the next ``run``, as a restart's
        is, where ``run`` otherwise starts it at time n.  On the ranks of a
        multi-rank run rank 0 passes the whole case's dicts, the others
        None, and each rank keeps its own blocks
        (``convert.scatter_state``)."""
        if self.comm is not None:
            prims, cons_n, cons_nm1, bc_aux = scatter_state(
                self.comm, self.case.owners, prims, cons_n, cons_nm1, bc_aux)
        dt = self.case.dtype
        self._prev_prims = None
        self.prims = state_from_numpy(prims, self.device, dt)
        self.cons_n = (state_from_numpy(cons_n, self.device, dt)
                       if cons_n is not None else self.store_old_solution())
        if bc_aux is not None:
            self.bc_aux = bc_aux_from_numpy(bc_aux, self.device, dt)
        if cons_nm1 is not None:
            if not self.cfg["multilevel_time"]:
                raise ValueError("cons_nm1: the deck's time integrator "
                                 f"{self.cfg['time_integration']} has one "
                                 "time level")
            self.cons_nm1 = state_from_numpy(cons_nm1, self.device, dt)
            self._nm1_carried = True

    def _zero_bc_aux(self):
        """the carry of the first iteration: zero dt and gradients"""
        out = {}
        for b in self.case.blocks:
            shp = (b.ni, b.nj, b.nk)
            kw = dict(dtype=self.case.dtype, device=self.device)
            out[b.index] = dict(dt=torch.zeros(shp, **kw),
                                pgrad=torch.zeros((3,) + shp, **kw),
                                vgrad=torch.zeros((3, 3) + shp, **kw))
        return out

    def store_old_solution(self):
        """conserved state at time n (reference: mgSolution.cpp:103)."""
        return {b.index: st_mod.cons_from_prim(
            self.phys, self.prims[b.index][b.interior])
            for b in self.case.blocks}

    def check_physicality(self, nn, mm, l2=None):
        """Debug-mode guard: densities and pressures must stay positive,
        tke finite and residual norms finite, else FloatingPointError with
        the offending block parent and interior cell (reference:
        procBlock.cpp:434-437/896-897, main.cpp:78-82).  One flag per block
        and field comes to the host; the location only on a failure."""
        phys = self.phys
        if l2 is not None and not np.all(np.isfinite(l2)):
            raise FloatingPointError(
                f"non-finite residual L2 {l2} at iteration {nn} "
                f"nonlinear-iter {mm}")
        if self.comm is not None:
            return self._check_physicality_ranks(nn, mm)
        checks = []
        for b in self.case.blocks:
            q = self.prims[b.index][b.interior]
            fields = [("density", q[:phys.ns].sum(dim=0)),
                      ("pressure", q[phys.ie])]
            if phys.nturb:
                fields.append(("tke", q[phys.it]))
            for name, f in fields:
                bad = ~torch.isfinite(f)
                if name != "tke":
                    bad = bad | (f <= 0.0)
                checks.append((b, name, f, bad))
        flags = torch.stack([bad.any() for *_, bad in checks]).cpu()
        for (b, name, f, bad), hit in zip(checks, flags.tolist()):
            if hit:
                flat = int(torch.argmax(bad.reshape(-1).to(torch.uint8)))
                loc = tuple(int(x) for x in np.unravel_index(flat, f.shape))
                raise FloatingPointError(
                    f"non-physical {name} {float(f[loc]):.6e} at iteration "
                    f"{nn} nonlinear-iter {mm}, block {b.parent}, "
                    f"cell {loc}")

    def _check_physicality_ranks(self, nn, mm):
        """``check_physicality`` of a multi-rank run: per own block and
        field its flag, the first offending value and flat cell, gathered
        (``Comm.block_rows``), so that every rank raises on the first
        offence in block and field order with the same message, whichever
        rank holds the block"""
        phys = self.phys
        names = ["density", "pressure"] + (["tke"] if phys.nturb else [])
        parts = {}
        for b in self.case.blocks:
            q = self.prims[b.index][b.interior]
            fields = [q[:phys.ns].sum(dim=0), q[phys.ie]]
            if phys.nturb:
                fields.append(q[phys.it])
            row = []
            for name, f in zip(names, fields):
                bad = ~torch.isfinite(f)
                if name != "tke":
                    bad = bad | (f <= 0.0)
                flat = torch.argmax(bad.reshape(-1).to(torch.uint8))
                row += [bad.any().to(f.dtype), f.reshape(-1)[flat],
                        flat.to(f.dtype)]
            parts[b.index] = torch.stack(row)
        rows = self.comm.block_rows(parts, len(self.case.layout),
                                    self.case.owners).tolist()
        for info, row in zip(self.case.layout, rows):
            for k, name in enumerate(names):
                hit, val, flat = row[3 * k:3 * k + 3]
                if hit:
                    loc = tuple(int(x) for x in np.unravel_index(
                        int(flat), (info.ni, info.nj, info.nk)))
                    raise FloatingPointError(
                        f"non-physical {name} {val:.6e} at iteration "
                        f"{nn} nonlinear-iter {mm}, block {info.parent}, "
                        f"cell {loc}")

    # -- one nonlinear iteration ---------------------------------------------
    def _residuals(self, prims, cfl, bc_aux=None, cons_n=None):
        """Ghosts (the nonreflecting BCs in their LODI form from the
        carry ``bc_aux`` and the time-n interiors ``cons_n`` where both
        are given), residual, spectral radii, diagonal terms, local time
        step and implicit aux fields of every block.  Returns (prims with
        ghosts, residuals, specrads, diags, dts, auxs) as dicts by block."""
        phys, case, cfg = self.phys, self.case, self.cfg
        prims = step_mod.apply_all_bcs(phys, case, prims, bc_aux=bc_aux,
                                       cons_n=cons_n)
        residuals, specrads, diags, dts, auxs = {}, {}, {}, {}, {}
        for b in case.blocks:
            (resid, sr_f, sr_t, dg_f, dg_t, _, prim_v,
             aux) = step_mod.full_residual(phys, cfg, b, prims[b.index])
            prims[b.index] = prim_v  # includes viscous-wall ghosts
            auxs[b.index] = aux
            residuals[b.index] = resid
            sr_max = torch.maximum(sr_f, sr_t) if phys.nturb else sr_f
            specrads[b.index] = sr_max
            diags[b.index] = (dg_f, dg_t)
            dts[b.index] = step_mod.local_dt(cfg, b.geom, sr_max, b.g,
                                             (b.ni, b.nj, b.nk), cfl)

        # connection swaps of eddy viscosity / f1 (and, for the block
        # solver, the 9 velocity-gradient channels) so the implicit
        # off-diagonals see donor values at connection ghosts (reference:
        # gridLevel.cpp:343-395, procBlock.cpp:3057-3084); an explicit
        # step has no off-diagonals
        if cfg["implicit"] and cfg["viscous"]:
            for key in ["mut"] + (["f1"] if phys.nturb else []):
                step_mod.swap_case(
                    case, {bi: auxs[bi][key][None] for bi in auxs})
            if cfg["block_matrix"]:
                step_mod.swap_case(
                    case, {bi: auxs[bi]["vgrad"].view(
                        (9,) + auxs[bi]["mu"].shape) for bi in auxs})
        return prims, residuals, specrads, diags, dts, auxs

    def _iteration(self, prims, cons_n, cfl, stage=0, cons_nm1=None,
                   bc_aux=None):
        """One nonlinear iteration of every block: the implicit update, or
        the explicit Euler or RK4 stage ``stage`` update.  ``cons_nm1``:
        the time n-1 interiors of a multilevel deck; ``bc_aux``: the
        nonreflecting BCs' carry (zero when None, as at the first
        iteration).  Returns (new_prims, l2 sum of squares per equation,
        per-block (max residual, flat location), matrix residual sum: zero
        for an explicit step, the next iteration's carry)."""
        if bc_aux is None:
            bc_aux = self._zero_bc_aux()
        prims, residuals, specrads, diags, dts, auxs = self._residuals(
            prims, cfl, bc_aux, cons_n)
        if self.cfg["implicit"]:
            new_prims, matrix_resid = self._implicit_update(
                prims, residuals, specrads, diags, dts, cons_n, auxs,
                cons_nm1, cfl)
        else:
            new_prims = self._explicit_update(prims, residuals, dts, cons_n,
                                              stage)
            matrix_resid = torch.zeros((), dtype=self.case.dtype,
                                       device=self.device)
        if self.comm is None:
            l2 = torch.zeros(self.phys.neq, dtype=self.case.dtype,
                             device=self.device)
            linfs = []
            for b in self.case.blocks:
                bl2, blinf, bloc = step_mod.residual_norms(residuals[b.index])
                l2 = l2 + bl2
                linfs.append((blinf, bloc))
        else:
            l2, linfs, matrix_resid = self._reduce_norms(
                residuals, matrix_resid if self.cfg["implicit"] else None)
        # the carry of the next iteration's nonreflecting BCs: this
        # iteration's dt and gradients; an inviscid deck has none and
        # carries zero gradients, as the JAX package does
        new_bc_aux = {}
        for b in self.case.blocks:
            aux = auxs[b.index] or {}
            zero = bc_aux[b.index]
            new_bc_aux[b.index] = dict(
                dt=dts[b.index],
                pgrad=aux.get("press_grad", torch.zeros_like(zero["pgrad"])),
                vgrad=aux.get("vel_grad", torch.zeros_like(zero["vgrad"])))
        return new_prims, l2, linfs, matrix_resid, new_bc_aux

    def _reduce_norms(self, residuals, mr_parts):
        """The norms of a multi-rank run on the host: each own block's L2
        squares, max residual and its flat location, and matrix residual
        part (``mr_parts``, {block: sum of squares}; None for an explicit
        step, whose matrix residual is zero) gathered into one row per
        block, then summed in block order as one rank sums them
        (``_iteration``, ``_implicit_update``), so every rank gets the
        one-rank values to the last bit.  Returns (l2, linfs, matrix
        residual)."""
        neq, dt = self.phys.neq, self.case.dtype
        zero = torch.zeros((), dtype=dt, device=self.device)
        parts = {}
        for b in self.case.blocks:
            bl2, blinf, bloc = step_mod.residual_norms(residuals[b.index])
            mr = zero if mr_parts is None else mr_parts[b.index]
            parts[b.index] = torch.cat([bl2, torch.stack(
                [blinf, bloc.to(dt), mr])])
        rows = self.comm.block_rows(parts, len(self.case.layout),
                                    self.case.owners)
        l2 = torch.zeros(neq, dtype=dt)
        mr_sum = torch.zeros((), dtype=dt)
        for row in rows:
            l2 = l2 + row[:neq]
            mr_sum = mr_sum + row[neq + 2]
        linfs = [(row[neq], row[neq + 1].to(torch.int64)) for row in rows]
        if mr_parts is None:
            return l2, linfs, zero.cpu()
        return l2, linfs, mr_sum / self._mr_count()

    def _mr_count(self):
        """the matrix residual's divisor: every block's padded size times
        the equations (mgSolution.cpp:199-207)"""
        return sum(self.phys.neq * int(np.prod(b.shape))
                   for b in self.case.layout)

    def _explicit_update(self, prims, residuals, dts, cons_n, stage):
        """explicitEuler, or the rk4 stage ``stage`` from the time-n
        conserved interiors (reference: procBlock.cpp:866-950)"""
        phys, rk4 = self.phys, self.cfg["time_integration"] == "rk4"
        new_prims = {}
        for b in self.case.blocks:
            bi = b.index
            new_prims[bi] = (
                step_mod.rk4_update(phys, b, prims[bi], cons_n[bi],
                                    residuals[bi], dts[bi], stage) if rk4
                else step_mod.explicit_euler_update(phys, b, prims[bi],
                                                    residuals[bi], dts[bi]))
        return new_prims

    # -- implicit path (reference: mgSolution::ImplicitUpdate) ---------------
    def _setup_linear(self, prims, residuals, specrads, diags, dts, auxs,
                      cons_n, cons_nm1=None, lvl=0, matrix_init=None):
        """Inverted diagonal, diagonal, rhs b and initial update per block
        of grid level ``lvl``: zero, or D^-1 b on the interior when the
        deck needs the matrix initialised (matrixSweeps > 1; ``matrix_init``
        None takes the deck's) (reference: linearSolver::AddDiagonalTerms /
        Invert / InitializeMatrixUpdate).  ``cons_nm1`` enters the rhs of a
        multilevel (bdf2) deck.  For blusgs and bdplur the diagonal is the
        (ni, nj, nk, N, N) flow and (ni, nj, nk, 2, 2) turbulence blocks,
        and its inverse those blocks as the sweeps take them: channels
        (N*N, ni, nj, nk) and (4, ni, nj, nk), permuted once here.  Without
        turbulence equations the turbulence entry of both is None.

        The main diagonal is zeroed only after the whole multigrid cycle
        (mgSolution.cpp:236-239 ResetDiagonal), so a coarse level visited
        again within a W cycle adds the previous visit's full diagonal
        (scalar 1/inv, block (af, at) before the channel permutation) to
        its new one: the per-level carry, reset with level 0's set-up at
        the start of every implicit update."""
        phys, cfg = self.phys, self.cfg
        if matrix_init is None:
            matrix_init = cfg["matrix_init"]
        if lvl == 0:
            self._mg_diag_carry = {}
        carry = self._mg_diag_carry.get(lvl)
        inv_diag, a_diag, bs, dus = {}, {}, {}, {}
        for b in self.mg_cases[lvl].blocks:
            bi = b.index
            if cfg["block_matrix"]:
                dfb, dtb = auxs[bi]["diag_flow_blk"], auxs[bi]["diag_turb_blk"]
                if carry is not None:
                    dfb = dfb + carry[bi][0]
                    if dtb is not None and carry[bi][1] is not None:
                        dtb = dtb + carry[bi][1]
                a_diag[bi], inv = imp.build_block_diagonal(
                    phys, b, cfg, dfb, dtb, specrads[bi], dts[bi])
                inv_flow, inv_turb = (None if m is None
                                      else imp.blk_to_channels(m)
                                      for m in inv)
                dmul = imp.diag_mult_channels
            else:
                df, dtu = diags[bi]
                if carry is not None:
                    df = df + carry[bi][0]
                    if dtu is not None and carry[bi][1] is not None:
                        dtu = dtu + carry[bi][1]
                inv_flow, inv_turb = imp.build_diagonal(
                    phys, b, cfg, df, dtu, specrads[bi], dts[bi])
                a_diag[bi] = (1.0 / inv_flow, None if inv_turb is None
                              else 1.0 / inv_turb)
                dmul = imp.diag_mult
            inv_diag[bi] = (inv_flow, inv_turb)
            bs[bi] = imp.rhs_b(
                phys, b, cfg, prims[bi], residuals[bi], cons_n[bi], dts[bi],
                None if cons_nm1 is None else cons_nm1[bi])
            du = torch.zeros((phys.neq,) + b.shape, dtype=self.case.dtype,
                             device=self.device)
            if matrix_init:
                du[b.interior] = dmul(phys, inv_flow, inv_turb, bs[bi])
            dus[bi] = du
        self._mg_diag_carry[lvl] = a_diag
        return inv_diag, a_diag, bs, dus

    def _swap_level(self, lvl, d):
        """connection swaps of padded fields at grid level ``lvl``, in
        place (through the rank exchange of a multi-rank run)"""
        return step_mod.swap_case(self.mg_cases[lvl], d)

    def _relax(self, lvl, st, sweeps):
        """``sweeps`` relaxations at grid level ``lvl`` of the linear
        system in ``st`` (prims, auxs, inv_diag, bs, dus and, on a coarse
        level, the multigrid forcing, which adds to b): pairs of a forward
        and a backward LU-SGS sweep over every block, with connection swaps
        of du before each sweep and once after the last (reference:
        lusgs::Relax).  Each sweep takes the lagged opposite-side sum of
        the du it starts from (the upper sum forward, the lower sum
        backward) after the first pair, or from the first when the matrix
        was initialised or on a coarse level.  The fine level's
        post-relaxation counts its pairs from 0 again, as the reference
        does.  The sweeps update du in place; the blocks of one sweep run
        concurrently on the card (``lusgs_sweep.sweep_blocks``).  dplur /
        bdplur instead take Jacobi sweeps (``implicit.dplur_sweep``), each
        after a swap of du (reference: dplur::Relax).  Returns ``st``."""
        phys, cfg = self.phys, self.cfg
        blocks = self.mg_cases[lvl].blocks
        prims, auxs = st["prims"], st["auxs"]
        inv_diag, dus = st["inv_diag"], st["dus"]
        forcing = st.get("forcing")
        bs = ({bi: st["bs"][bi] + forcing[bi] for bi in st["bs"]} if forcing
              else st["bs"])
        if not self.sweeps:
            for _ in range(sweeps):
                self._swap_level(lvl, dus)
                for b in blocks:
                    bi = b.index
                    imp.dplur_sweep(phys, cfg, b, prims[bi], dus[bi], bs[bi],
                                    *inv_diag[bi], auxs[bi])
            st["dus"] = self._swap_level(lvl, dus)
            return st
        plans = self.mg_plans[lvl]
        for sweep in range(sweeps):
            with_extra = sweep > 0 or cfg["matrix_init"] or lvl > 0
            for forward, side in ((True, "upper"), (False, "lower")):
                self._swap_level(lvl, dus)
                work = []
                for b in blocks:
                    bi = b.index
                    extra = (imp.offdiag_sum(phys, cfg, b, prims[bi],
                                             dus[bi], side, auxs[bi])
                             if with_extra else None)
                    work.append((plans[bi], prims[bi], dus[bi], bs[bi],
                                 *inv_diag[bi], auxs[bi], extra))
                lusgs_sweep.sweep_blocks(phys, cfg, work, forward)
        st["dus"] = self._swap_level(lvl, dus)
        return st

    def _matrix_resid_field(self, lvl, st):
        """forcing - (A x - b) per block of grid level ``lvl`` (reference:
        linearSolver::Residual)."""
        forcing = st.get("forcing")
        return {b.index: imp.matrix_residual(
            self.phys, self.cfg, b, st["prims"][b.index], st["dus"][b.index],
            st["bs"][b.index], *st["a_diag"][b.index],
            aux=st["auxs"][b.index],
            forcing=forcing[b.index] if forcing else None)
            for b in self.mg_cases[lvl].blocks}

    def _level_state(self, lvl, prims_int, cfl):
        """BCs + residual + time step on a coarse level from restricted
        interior states (reference: gridLevel::Restriction midsection).
        As in the JAX package, a coarse level swaps no eddy viscosity, f1
        or velocity gradients across its connections, and its boundaries
        take no carry: a nonreflecting BC takes its reflecting form
        there."""
        phys, cfg = self.phys, self.cfg
        case = self.mg_cases[lvl]
        prims = {}
        for b in case.blocks:
            pad = b.prim0.clone()
            pad[b.interior] = prims_int[b.index]
            prims[b.index] = pad
        prims = step_mod.apply_all_bcs(phys, case, prims)
        residuals, specrads, diags, dts, auxs, cons_n = {}, {}, {}, {}, {}, {}
        for b in case.blocks:
            bi = b.index
            (resid, sr_f, sr_t, dg_f, dg_t, _, prim_v,
             aux) = step_mod.full_residual(phys, cfg, b, prims[bi])
            prims[bi] = prim_v
            auxs[bi] = aux
            residuals[bi] = resid
            sr_max = torch.maximum(sr_f, sr_t) if phys.nturb else sr_f
            specrads[bi] = sr_max
            diags[bi] = (dg_f, dg_t)
            dts[bi] = step_mod.local_dt(cfg, b.geom, sr_max, b.g,
                                        (b.ni, b.nj, b.nk), cfl)
            cons_n[bi] = st_mod.cons_from_prim(phys, prim_v[b.interior])
        return prims, residuals, specrads, diags, dts, auxs, cons_n

    def _restrict_level(self, lvl, st, resid_field, cfl):
        """The solve state of level ``lvl + 1`` from that of ``lvl``
        (reference: gridLevel::Restriction): restricted state and update,
        the coarse residual and linear system (its time n-1 solution its
        time n one), and the forcing (A_c x_c - b_c) + restrict(fine
        matrix residual)."""
        phys = self.phys
        fine, coarse = self.mg_cases[lvl], self.mg_cases[lvl + 1]
        maps = self.mg_maps[lvl]
        prims_c_int, dus_c, force_r = {}, {}, {}
        for b in fine.blocks:
            bi = b.index
            lm, cb = maps[bi], coarse.block(bi)
            cshape = (cb.ni, cb.nj, cb.nk)
            prims_c_int[bi] = mg.restrict_weighted(
                st["prims"][bi][b.interior], lm, cshape)
            du_c = torch.zeros((phys.neq,) + cb.shape, dtype=self.case.dtype,
                               device=self.device)
            du_c[cb.interior] = mg.restrict_weighted(
                st["dus"][bi][b.interior], lm, cshape)
            dus_c[bi] = du_c
            force_r[bi] = mg.restrict_sum(resid_field[bi], lm, cshape)
        self._swap_level(lvl + 1, dus_c)

        (prims_c, residuals_c, specrads_c, diags_c, dts_c, auxs_c,
         cons_n_c) = self._level_state(lvl + 1, prims_c_int, cfl)
        inv_diag_c, a_diag_c, bs_c, _ = self._setup_linear(
            prims_c, residuals_c, specrads_c, diags_c, dts_c, auxs_c,
            cons_n_c, cons_n_c, lvl=lvl + 1, matrix_init=False)
        cs = dict(prims=prims_c, auxs=auxs_c, inv_diag=inv_diag_c,
                  a_diag=a_diag_c, bs=bs_c, dus=dus_c, forcing=None)
        neg_axmb = self._matrix_resid_field(lvl + 1, cs)
        self._mg_trace("axmb", lvl + 1, {bi: -v for bi, v in neg_axmb.items()})
        self._mg_trace("force_r", lvl + 1, force_r)
        cs["forcing"] = {bi: -neg_axmb[bi] + force_r[bi] for bi in neg_axmb}
        return cs

    def _mg_trace(self, stage, lvl, d):
        """record a copy of ``d`` ({block: tensor}) under ``stage`` when
        ``_mg_trace_log`` is a list (the tests compare the cycle stage by
        stage with the JAX package's)"""
        if self._mg_trace_log is not None:
            self._mg_trace_log.append(
                (stage, lvl, {k: v.clone() for k, v in d.items()}))

    def _mg_cycle(self, lvl, st, cfl):
        """FAS V/W cycle from level ``lvl`` (reference:
        mgSolution::CycleAtLevel): pre-relaxation, restriction, the coarse
        cycles (one for V, two for W), prolongation of the coarse
        correction, post-relaxation; max(matrixSweeps // 2, 1) sweeps
        before and after, matrixSweeps on the coarsest level."""
        sweeps = self.cfg["matrix_sweeps"]
        if lvl == self.mg_nlevels - 1:
            return self._relax(lvl, st, sweeps)
        pre = max(sweeps // 2, 1)
        st = self._relax(lvl, st, pre)
        self._mg_trace("prerelax", lvl, st["dus"])
        resid_field = self._matrix_resid_field(lvl, st)
        cs = self._restrict_level(lvl, st, resid_field, cfl)
        self._mg_trace("postrestrict", lvl + 1, cs["dus"])
        self._mg_trace("forcing", lvl + 1, cs["forcing"])
        # the coarse sweeps update du in place: keep the restricted update
        du_c0 = {bi: du.clone() for bi, du in cs["dus"].items()}
        for _ in range(self.mg_cycle_index):
            cs = self._mg_cycle(lvl + 1, cs, cfl)
        corr = {bi: cs["dus"][bi] - du_c0[bi] for bi in du_c0}
        coarse = self.mg_cases[lvl + 1]
        for b in self.mg_cases[lvl].blocks:
            cb = coarse.block(b.index)
            st["dus"][b.index][b.interior] += mg.prolong(
                corr[b.index][cb.interior], self.mg_maps[lvl][b.index])
        self._mg_trace("corr", lvl + 1, corr)
        self._mg_trace("postprolong", lvl, st["dus"])
        self._swap_level(lvl, st["dus"])
        return self._relax(lvl, st, pre)

    def _implicit_update(self, prims, residuals, specrads, diags, dts,
                         cons_n, auxs, cons_nm1=None, cfl=None):
        """The linear solve at level 0, by ``matrixSweeps`` relaxations or
        one multigrid cycle, then the matrix residual (level 0, no
        forcing) and the update.  Returns (new prims, matrix residual sum
        of squares / padded size); on a rank of a multi-rank run the sum
        of squares of each own block instead ({block: tensor}), which
        ``_reduce_norms`` reduces."""
        phys = self.phys
        inv_diag, a_diag, bs, dus = self._setup_linear(
            prims, residuals, specrads, diags, dts, auxs, cons_n, cons_nm1)
        st = dict(prims=prims, auxs=auxs, inv_diag=inv_diag, a_diag=a_diag,
                  bs=bs, dus=dus, forcing=None)
        if self.mg_nlevels == 1:
            st = self._relax(0, st, self.cfg["matrix_sweeps"])
        else:
            st = self._mg_cycle(0, st, cfl)
        dus = st["dus"]
        mr_sum = torch.zeros((), dtype=self.case.dtype, device=self.device)
        mr_parts = {}
        new_prims = {}
        mrf = self._matrix_resid_field(0, st)
        for b in self.case.blocks:
            mr = mrf[b.index]
            mr_parts[b.index] = (mr * mr).sum()
            mr_sum = mr_sum + mr_parts[b.index]
            new_prims[b.index] = step_mod.implicit_update(
                phys, b, prims[b.index], dus[b.index][b.interior])
        if self.comm is not None:
            return new_prims, mr_parts
        # the reference divides by the padded array size (ghost entries
        # are zero)
        return new_prims, mr_sum / self._mr_count()

    # -- restart / output -----------------------------------------------------
    def _interior(self, prim, b):
        """the interior of padded ``prim`` of block ``b`` as numpy"""
        return prim[b.interior].cpu().numpy()

    def _load_restart(self, path):
        """Resume from a reference-compatible .rst file (reference:
        output.cpp:756-900 ReadRestart): the interior state, the iteration
        and the residual normalisation; a decomposed case re-splits the
        file's original blocks (reference: parallel.hpp:137-154
        DecompArray on ReadRestart); a multilevel (bdf2) deck keeps the
        file's time n-1 solution for ``__init__``.  In a multi-rank run
        rank 0 alone reads the file and sends each rank its blocks."""
        from ..io.restart import prim_from_restart, read_restart
        rec = None
        if self.comm is None or self.comm.rank == 0:
            rec = read_restart(path)
            decomp = self.case.decomp
            if decomp is not None and decomp.splits:
                from ..parallel.decompose import split_cell_arrays
                rec["blocks"] = split_cell_arrays(decomp.splits,
                                                  rec["blocks"])
                if rec["blocks_nm1"] is not None:
                    rec["blocks_nm1"] = split_cell_arrays(decomp.splits,
                                                          rec["blocks_nm1"])
        if self.comm is not None:
            owners = self.case.owners
            parts = None
            if rec is not None:
                def mine(arrs, r):
                    return None if arrs is None else {
                        bi: a for bi, a in enumerate(arrs)
                        if owners[bi] == r}
                parts = [dict(iteration=rec["iteration"],
                              l2_first=rec["l2_first"],
                              blocks=mine(rec["blocks"], r),
                              blocks_nm1=mine(rec["blocks_nm1"], r))
                         for r in range(self.comm.world)]
            rec = self.comm.scatter_objects(parts)
        self.iteration_start = rec["iteration"]
        self.l2_first = np.asarray(rec["l2_first"]).copy()
        for b in self.case.blocks:
            prim = prim_from_restart(rec["blocks"][b.index], self.phys,
                                     self.deck, mu_ref=self.phys.mu_mix_ref)
            self.prims[b.index][b.interior] = torch.as_tensor(
                prim, dtype=self.case.dtype, device=self.device)
        if rec["blocks_nm1"] is not None and self.deck.is_multilevel_in_time:
            self._restart_nm1 = rec["blocks_nm1"]

    def _output_arrays(self, padded):
        """numpy copies of what the files read, by own block: the state
        and the pre-update state (padded, or their interiors), the time-n
        and (bdf2) time n-1 interiors and the nonreflecting BCs' carry"""
        prev = self._prev_prims
        multilevel = self.cfg["multilevel_time"]

        def host(t):
            return t.cpu().numpy()

        out = {}
        for b in self.case.blocks:
            bi = b.index
            sl = (slice(None),) if padded else b.interior
            out[bi] = dict(
                prim=host(self.prims[bi][sl]),
                prev=None if prev is None else host(prev[bi][sl]),
                cons_n=host(self.cons_n[bi]),
                cons_nm1=host(self.cons_nm1[bi]) if multilevel else None,
                **{k: host(v) for k, v in self.bc_aux[bi].items()})
        return out

    def _sync_output_view(self):
        """The Solver whose blocks the files are written from.  For
        decomposed runs, push the current state (recombined into the
        ORIGINAL block structure) onto a parent-layout Solver on the same
        device, so that all file output matches the reference's Recombine
        semantics (reference: output.cpp:595,1089-1166; restart
        compatibility across process counts depends on this).  In a
        multi-rank run every rank sends rank 0 its blocks' arrays (the
        reference's Recombine on ROOT), and rank 0 writes from a one-rank
        Solver of the whole grid on its device: the parent layout of a
        decomposed grid, or the same layout, given the padded state
        as it is, so that the files are the one-rank run's; the other
        ranks get None and write nothing.  Returns self when neither."""
        decomp = self.case.decomp
        split = decomp is not None and bool(decomp.splits)
        if self.comm is None and not split:
            return self
        arrs = self._output_arrays(padded=not split)
        if self.comm is not None:
            got = self.comm.gather_objects(arrs)
            if got is None:
                return None
            arrs = {bi: a for part in got for bi, a in part.items()}
        if self._parent_view is None:
            self._parent_view = Solver(self._deck_path, device=self.device,
                                       dtype=self.case.dtype,
                                       workdir=self.workdir,
                                       nproc=1 if split else self._nproc,
                                       debug=False)
        view = self._parent_view
        view.l2_first = self.l2_first
        view.iteration_start = self.iteration_start
        multilevel = self.cfg["multilevel_time"]

        def dev(a):
            return torch.as_tensor(a, dtype=view.case.dtype,
                                   device=view.device)

        if not split:
            has_prev = self._prev_prims is not None
            for vb in view.case.blocks:
                a = arrs[vb.index]
                view.prims[vb.index] = dev(a["prim"])
                view.cons_n[vb.index] = dev(a["cons_n"])
                if multilevel:
                    view.cons_nm1[vb.index] = dev(a["cons_nm1"])
                view.bc_aux[vb.index] = {k: dev(a[k])
                                         for k in ("dt", "pgrad", "vgrad")}
            view._prev_prims = ({vb.index: dev(arrs[vb.index]["prev"])
                                 for vb in view.case.blocks}
                                if has_prev else None)
            return view

        from ..parallel.decompose import join_cell_arrays
        splits = decomp.splits
        nblocks = len(self.case.layout)

        def joined(key, axes=(1, 2, 3)):
            return join_cell_arrays(
                splits, [arrs[bi][key] if arrs[bi][key] is not None
                         else arrs[bi]["prim"] for bi in range(nblocks)],
                axes)

        prim_j = joined("prim")
        prev_j = joined("prev")
        consn_j = joined("cons_n")
        nm1_j = joined("cons_nm1") if multilevel else None
        dt_j = joined("dt", axes=(0, 1, 2))
        pg_j = joined("pgrad")
        vg_j = joined("vgrad", axes=(2, 3, 4))

        prev_pads = {}
        for i, vb in enumerate(view.case.blocks):
            pad = view.prims[vb.index].clone()
            pad[vb.interior] = dev(prim_j[i])
            view.prims[vb.index] = pad
            prev_pads[vb.index] = pad.clone()
            prev_pads[vb.index][vb.interior] = dev(prev_j[i])
            view.cons_n[vb.index] = dev(consn_j[i])
            if multilevel:
                view.cons_nm1[vb.index] = dev(nm1_j[i])
            view.bc_aux[vb.index] = dict(dt=dev(dt_j[i]), pgrad=dev(pg_j[i]),
                                         vgrad=dev(vg_j[i]))
        # refresh ghosts: the BC pass is a function of the interior state
        # (and bc_aux / cons_n)
        view.prims = step_mod.apply_all_bcs(view.phys, view.case,
                                            view.prims, bc_aux=view.bc_aux,
                                            cons_n=view.cons_n)
        view._prev_prims = prev_pads
        # recombined per-cell decomposition fields: owning rank and owning
        # block's global position (reference: output.cpp:278-283
        # SplitBlockNumber -> Rank()/GlobalPos()), constant per split
        # block, joined back into the parent layout like every field
        rank_j = join_cell_arrays(splits, [np.full(
            (b.ni, b.nj, b.nk), float(decomp.rank[b.index]))
            for b in self.case.layout], (0, 1, 2))
        gpos_j = join_cell_arrays(splits, [np.full(
            (b.ni, b.nj, b.nk), float(b.index)) for b in self.case.layout],
            (0, 1, 2))
        view._decomp_fields = {
            vb.index: (rank_j[i], gpos_j[i])
            for i, vb in enumerate(view.case.blocks)}
        return view

    def write_restart(self, iteration):
        """``<deck>_<iteration>.rst`` of the current state (reference:
        output.cpp:591-754 WriteRestart)"""
        view = self._sync_output_view()
        if view is None:             # a rank other than 0
            return None
        if view is not self:
            return view.write_restart(iteration)
        from ..io.restart import write_restart
        prims = [self._interior(self.prims[b.index], b)
                 for b in self.case.blocks]
        cons_nm1 = None
        if self.deck.is_multilevel_in_time:
            cons_nm1 = [self.cons_nm1[b.index].cpu().numpy()
                        for b in self.case.blocks]
        l2_first = (self.l2_first if self.l2_first is not None
                    else np.zeros(self.phys.neq))
        write_restart(f"{self.sim_root}_{iteration}.rst", self.deck,
                      self.phys, iteration, l2_first, prims, cons_nm1,
                      mu_ref=self.phys.mu_mix_ref)

    def write_output(self, iteration):
        """The cell-center function file of the deck's output variables
        (and its .p3d meta file), the wall files and the nodal files
        (reference: output.cpp:55-560).  The derived fields (gradients,
        residual, dt, eddy viscosity, temperature, viscosity, wall data)
        come from one output evaluation of the residual (``need_aux``) at
        the PRE-update state, which the reference stores on the block
        during the last iteration (procBlock.hpp:100-121); the state
        itself is the current one.  Computed on the state's device, then
        copied to the host for writing."""
        view = self._sync_output_view()
        if view is None:             # a rank other than 0
            return None
        if view is not self:
            return view.write_output(iteration)
        deck, phys, cfg = self.deck, self.phys, self.cfg
        prims = [self._interior(self.prims[b.index], b)
                 for b in self.case.blocks]
        names = list(deck.output_variables)
        need_fields = any(
            n.endswith(("Grad_x", "Grad_y", "Grad_z")) or
            n.startswith(("velGrad_", "resid_")) or
            n in ("dt", "f1", "f2", "turbulentViscosity", "viscosityRatio")
            for n in names)
        wall_names = deck.wall_output_variables
        nodal = bool(deck["outputNodalVariables"])
        auxs, wall_blocks, prim_pads, aux_pads = [], [], {}, {}
        base = self._prev_prims or self.prims
        full_prims = step_mod.apply_all_bcs(phys, self.case, dict(base),
                                            bc_aux=self.bc_aux,
                                            cons_n=self.cons_n)
        decomp = self.case.decomp
        for b in self.case.blocks:
            g = b.g
            P = b.interior[1:]
            aux = {"wall_dist": b.geom_host["wall_dist"][P]}
            if self._decomp_fields is not None:   # recombined decomposed
                aux["rank"], aux["globalPosition"] = \
                    self._decomp_fields[b.index]
            else:                                  # constants per block
                rk = decomp.rank[b.index] if decomp is not None else 0
                aux["rank"] = np.full((b.ni, b.nj, b.nk), float(rk))
                aux["globalPosition"] = np.full((b.ni, b.nj, b.nk),
                                                float(b.index))
            # current padded state: updated interior + the ghost values
            # of the last iteration's BC pass (the reference's state_ at
            # output time: ghosts are not refreshed after UpdateBlocks)
            prim_pads[b.index] = self.prims[b.index]
            aux_pads[b.index] = full_prims[b.index]
            if (need_fields or wall_names or nodal) and (
                    cfg["viscous"] or cfg["implicit"]):
                (resid, sr_f, sr_t, _, _, _, prim_v,
                 full_aux) = step_mod.full_residual(phys, cfg, b,
                                                    full_prims[b.index],
                                                    need_aux=True)
                aux_pads[b.index] = prim_v
                # the temperature / viscosity FIELDS of the pre-update
                # state (reference: procBlock.cpp:306-310
                # UpdateAuxillaryVariables)
                q_int = prim_v[b.interior]
                t_int = phys.temperature(q_int[phys.ie], q_int[:phys.ns])
                aux["temperature"] = t_int.cpu().numpy()
                if cfg["viscous"]:
                    rho_s = q_int[:phys.ns]
                    aux["viscosity"] = phys.viscosity(
                        t_int, rho_s / rho_s.sum(dim=0)).cpu().numpy()
                sr = torch.maximum(sr_f, sr_t) if phys.nturb else sr_f
                cfl = deck.cfl(max(iteration - 1, 0))
                aux["dt"] = step_mod.local_dt(
                    cfg, b.geom, sr, g, (b.ni, b.nj, b.nk),
                    cfl).cpu().numpy()
                aux["resid"] = resid.cpu().numpy()
                if full_aux and "cellavg" in full_aux:
                    ca = full_aux["cellavg"]
                    aux["cellavg"] = {k: v.cpu().numpy()
                                      for k, v in ca.items()
                                      if k not in ("wall_out", "mix")}
                    aux["mut"] = aux["cellavg"]["mut"]
                    aux["f1"] = aux["cellavg"]["f1"]
                    aux["f2"] = aux["cellavg"]["f2"]
                    if wall_names:
                        for spec in b.surfaces:
                            if spec.bc_type != "viscousWall":
                                continue
                            wd = ca["wall_out"].get(id(spec))
                            if wd is None:
                                continue
                            wd = {k: v if v is None else v.cpu().numpy()
                                  for k, v in wd.items()}
                            fc = self._wall_face_centers(b, spec)
                            wall_blocks.append((b.index, spec, fc, wd))
            auxs.append(aux)
        out_mod.write_fun_file(f"{self.sim_root}_{iteration}_center.fun",
                               names, prims, phys, deck, auxs)
        out_mod.write_meta(f"{self.sim_root}_center.p3d", self.sim_root,
                           deck["gridName"], iteration, names)
        if wall_names and wall_blocks:
            out_mod.write_wall_files(self.sim_root, deck["gridName"],
                                     iteration, self.case, wall_blocks,
                                     wall_names)
        if nodal:
            self._write_nodal(iteration, names, prim_pads, aux_pads, auxs)

    def _write_nodal(self, iteration, names, prim_pads, aux_pads, auxs):
        """Nodal .fun output: cell data interpolated to the grid's nodes
        (reference: output.cpp:452-470 WriteNodeFun, procBlock.cpp:
        6607-6847 CellToNode), indexing the original node grid
        (<gridName>.xyz).  ``prim_pads`` / ``aux_pads``: the padded
        current state and pre-update state (with the viscous ghosts) on
        the device.  As in the JAX package: the state is the CURRENT one
        with its last BC pass's ghosts and the 3-D corner fill, averaged
        1/8; temperature, viscosity, mut, f1 and f2 the pre-update fields
        (mut, f1, f2 average against zero ghosts); the gradients FRESH
        from the current state's faces with the stored temperature,
        scattered with 1/12-1/8-1/5-1/3 node weights; residual and dt the
        no-ghost ignore-edge weighting.  Temperature, viscosity and the
        face gradients are computed on the device; the node averages in
        numpy on the host."""
        phys, deck = self.phys, self.deck
        nodal_prims, nodal_auxs = [], []
        for b in self.case.blocks:
            g = b.g
            dims = (b.ni, b.nj, b.nk)
            pad = out_mod.assign_corner_ghosts(
                prim_pads[b.index].cpu().numpy(), g)
            nprim = out_mod.cell_to_node_state(pad, g)
            aux_in = auxs[b.index]
            apad = aux_pads[b.index]
            naux = {}
            t_dev = phys.temperature(apad[phys.ie], apad[:phys.ns])
            t_aux = t_dev.cpu().numpy()
            naux["temperature"] = out_mod.cell_to_node_state(t_aux, g)
            if self.cfg["viscous"]:
                rho_s = apad[:phys.ns]
                mu_pad = phys.viscosity(t_dev, rho_s / rho_s.sum(dim=0))
                naux["viscosity"] = out_mod.cell_to_node_state(
                    mu_pad.cpu().numpy(), g)
            naux["wall_dist"] = out_mod.cell_to_node_ghost_ignore_edge(
                b.geom_host["wall_dist"], g)
            for k in ("dt", "resid", "rank", "globalPosition"):
                if k in aux_in:
                    naux[k] = out_mod.cell_to_node_noghost_ignore_edge(
                        aux_in[k])
            for k in ("mut", "f1", "f2"):
                if k not in aux_in:
                    continue
                # the reference never accumulates these into ghost cells
                # (procBlock.cpp:1392/1427 guards), so boundary nodes
                # average against zeros
                padk = np.zeros(pad.shape[1:], aux_in[k].dtype)
                padk[b.interior[1:]] = aux_in[k]
                naux[k] = out_mod.cell_to_node_state(padk, g)
            if self.cfg["viscous"]:
                # fresh face gradients at the written (current) state; the
                # temperature gradient reads the STORED temperature field
                # (reference: CalcGradsI/J/K use temperature_)
                pad_dev = torch.as_tensor(pad, device=self.device)
                fg = {d: {k: v.cpu().numpy() for k, v in
                          vis.face_cv_gradients(phys, b, pad_dev, t_dev, d,
                                                need_aux=True).items()}
                      for d in "ijk"}
                naux["cellavg"] = {
                    key: out_mod.face_grads_to_node(
                        {d: fg[d][key] for d in fg}, dims)
                    for key in ("vel", "temp", "rho", "press", "tke",
                                "omega") if key in fg["i"]}
            nodal_prims.append(nprim)
            nodal_auxs.append(naux)
        out_mod.write_fun_file(f"{self.sim_root}_{iteration}.fun", names,
                               nodal_prims, phys, deck, nodal_auxs)
        out_mod.write_meta(f"{self.sim_root}.p3d", self.sim_root,
                           deck["gridName"], iteration, names,
                           is_center=False)

    def _wall_face_centers(self, b, spec):
        """face centers (n1, n2, 3) of a viscousWall surface patch"""
        g = b.g
        d = spec.direction
        fc = b.geom_host[f"fc_{d}"]
        pos = g if spec.lower else g + {"i": b.ni, "j": b.nj,
                                        "k": b.nk}[d]
        sl = [slice(None)] * 4
        sl[1 + spec.axis] = pos
        taxes = [a for a in range(3) if a != spec.axis]
        for a, (lo, hi) in zip(taxes, spec.patch):
            sl[1 + a] = slice(lo, hi)
        return np.moveaxis(fc[tuple(sl)], 0, -1)

    def write_grid_center(self):
        """``<gridName>_center.xyz``: the cell centers (reference:
        output.cpp:55-104 WriteCellCenter)"""
        view = self._sync_output_view()
        if view is None:             # a rank other than 0
            return None
        if view is not self:
            return view.write_grid_center()
        centers = [np.moveaxis(b.geom_host["center"][b.interior], 0, -1)
                   for b in self.case.blocks]
        grid_root = os.path.join(self.workdir, self.deck["gridName"])
        out_mod.write_cell_center(f"{grid_root}_center.xyz", centers,
                                  self.deck.l_ref)

    # -- logging (reference format) ------------------------------------------
    def _open_logs(self, restart=False):
        """the .resid (appended to on a restart, as the JAX package does)
        and .tme logs with their headers; on rank 0 alone of a multi-rank
        run"""
        self.resid_file = self.time_file = None
        if self.comm is not None and self.comm.rank != 0:
            return
        self.resid_file = open(self.sim_root + ".resid",
                               "a" if restart else "w")
        self.time_file = open(self.sim_root + ".tme", "w")
        self._print_headers(self.resid_file)
        self.time_file.write(f"{'Step':<7}{'Iter-Time':<16}{'Sim-Time':<16}\n")

    def _print_headers(self, f):
        deck = self.deck
        cols = [f"{'Step':<7}", f"{'NL-Iter':<8}"]
        cols.append(f"{'Time-Step' if deck['timeStep'] > 0 else 'CFL':<12}")
        for name in ("Res-Mass", "Res-Mom-X", "Res-Mom-Y", "Res-Mom-Z",
                     "Res-Energy"):
            cols.append(f"{name:<12}")
        if deck.is_rans:
            cols.append(f"{'Res-Tke':<12}")
            cols.append(f"{'Res-Omega':<12}")
        for name in ("Max-Eqn", "Max-Blk", "Max-I", "Max-J", "Max-K"):
            cols.append(f"{name:<8}")
        cols.append(f"{'Max-Res':<12}")
        cols.append(f"{'Res-Matrix':<12}")
        f.write("".join(cols) + "\n")

    def _update_l2_first(self, l2, nn, mm):
        """First-iteration normalization, re-maxed over the first 5 steps
        (reference: output.cpp:1028-1046); a restart keeps its file's."""
        ns = self.phys.ns
        if nn == 0 and mm == 0 and not self.is_restart:
            self.l2_first = l2.copy()
        elif nn < 5 and mm == 0 and not self.is_restart:
            if l2[:ns].sum() > self.l2_first[:ns].sum():
                self.l2_first[:ns] = l2[:ns]
            self.l2_first[ns:] = np.maximum(self.l2_first[ns:], l2[ns:])

    def _write_residuals(self, nn, mm, cfl, l2, linf_val, linf_loc,
                         matrix_resid=0.0):
        deck = self.deck
        self._update_l2_first(l2, nn, mm)
        first = self.l2_first
        ns = self.phys.ns
        res_mass = (l2[:ns].sum() + EPS) / (first[:ns].sum() + EPS)
        res = (l2 + EPS) / (first + EPS)
        parts = [f"{nn:<7d}{mm:<8d}"]
        lead = deck["timeStep"] if deck["timeStep"] > 0 else cfl
        parts.append(f"{lead:<12.4e}")
        vals = [res_mass, res[self.phys.mx], res[self.phys.my],
                res[self.phys.mz], res[self.phys.ie]]
        if deck.is_rans:
            vals += [res[self.phys.it], res[self.phys.it + 1]]
        parts += [f"{v:<12.4e}" for v in vals]
        eqn, blk, iloc, jloc, kloc = linf_loc
        parts += [f"{eqn:<8d}{blk:<8d}{iloc:<8d}{jloc:<8d}{kloc:<8d}"]
        parts += [f"{linf_val:<12.4e}{matrix_resid:<12.4e}"]
        line = "".join(parts)
        if self.resid_file is not None:
            self.resid_file.write(line + "\n")
            print(line)

    def _decode_linf(self, linfs):
        vals = torch.stack([v for v, _ in linfs]).cpu().numpy()
        locs = torch.stack([loc for _, loc in linfs]).cpu().numpy()
        bi = int(np.argmax(vals))
        b = self.case.layout[bi]
        ncell = b.nj * b.nk
        eqn, rem = divmod(int(locs[bi]), b.ni * ncell)
        i, rem = divmod(rem, ncell)
        j, k = divmod(rem, b.nk)
        return float(vals[bi]), (eqn + 1, b.parent, i, j, k)

    # -- main loop -----------------------------------------------------------
    def run(self, iterations=None, write_files=False):
        """March ``iterations`` steps (default: the deck's) of the deck's
        nonlinear iterations each (the rk4 stages; the dual-time
        iterations), logging every one to ``.resid`` and every step to
        ``.tme`` and, in debug mode, checking physicality after each.  A
        bdf2 deck sets its time n-1 solution to time n at the first step
        (unless ``set_state`` or a restart carried one in) and rolls it
        after the last nonlinear iteration of every step.  The steps are
        numbered from the restart's iteration in the logs and files, the
        CFL ramp from 0, as in the JAX package.  ``write_files`` writes
        the cell centers and the output at the start, the output every
        ``outputFrequency`` steps and a restart every ``restartFrequency``
        steps (class docstring); without it no iteration keeps, copies or
        synchronises anything for output.  On the ranks of a multi-rank run
        every rank marches its blocks and takes part in the files; rank 0
        alone prints the rows and writes the logs and files."""
        deck = self.deck
        iterations = iterations or deck["iterations"]
        self._open_logs(restart=self.is_restart)
        start = self.iteration_start
        sim_start = time.perf_counter()
        if write_files:
            self.write_grid_center()
            self.write_output(start)
        total_dof = self.case.total_cells * self.phys.neq
        multilevel = self.cfg["multilevel_time"]
        rk4 = self.cfg["time_integration"] == "rk4"
        nl_iters = deck["nonlinearIterations"]
        out_freq, rst_freq = deck["outputFrequency"], deck["restartFrequency"]
        try:
            for nn in range(iterations):
                iter_start = time.perf_counter()
                cfl = deck.cfl(nn)
                # store time n (and start time n-1) (reference:
                # mgSolution.cpp:103-114)
                self.cons_n = self.store_old_solution()
                if multilevel and nn == 0 and not self._nm1_carried:
                    self.cons_nm1 = dict(self.cons_n)
                self._nm1_carried = False
                for mm in range(nl_iters):
                    if write_files:
                        # the pre-update state of the output's derived
                        # fields: held, not copied (an iteration makes
                        # new tensors)
                        self._prev_prims = self.prims
                    (self.prims, l2, linfs, matrix_resid,
                     self.bc_aux) = self._iteration(
                        self.prims, self.cons_n, cfl,
                        stage=mm if rk4 else 0, cons_nm1=self.cons_nm1,
                        bc_aux=self.bc_aux)
                    l2 = np.sqrt(l2.cpu().numpy())
                    self.l2_history.append(l2)
                    linf_val, linf_loc = self._decode_linf(linfs)
                    mr = float(matrix_resid)
                    mr = np.sqrt(mr / total_dof) if mr > 0 else 0.0
                    self._write_residuals(nn + start, mm, cfl, l2, linf_val,
                                          linf_loc, mr)
                    if self.debug:
                        self.check_physicality(nn + start, mm, l2)
                    if multilevel and mm == nl_iters - 1:
                        self.cons_nm1 = dict(self.cons_n)
                if write_files and out_freq > 0 and (nn + 1) % out_freq == 0:
                    self.write_output(nn + start + 1)
                if write_files and rst_freq > 0 and (nn + 1) % rst_freq == 0:
                    self.write_restart(nn + start + 1)
                now = time.perf_counter()
                self.step_seconds.append(now - iter_start)
                if self.time_file is not None:
                    self.time_file.write(f"{nn:<7d}{now - iter_start:<16.6e}"
                                         f"{now - sim_start:<16.6e}\n")
        finally:
            for f in (self.resid_file, self.time_file):
                if f is not None:
                    f.close()
        return self
