"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages build the generated two-block flat plate (SST by default) of
``aither_tpu_torch/cases.py`` (2 x 12x8x3 cells, so the sweeps act in i,
j and k) from one deck; the JAX side runs on the CPU in float64 as the
other tests run it (tests/conftest.py), with its LU-SGS sweep reached
through the Pallas kernel in interpret mode.  Inputs come from
``np.random.default_rng(seed)`` and pass between the packages as numpy.

The unperturbed flat plate has near-zero residual components (mass L2
~1e-19), so every state is first perturbed by up to 1% on its interior
(the pattern of tests/test_shard_sweep.py).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

from aither_tpu_torch.cases import TEST_DIMS, write_plate_case

SEED = 7


def write_case(tmp_dir, dims=TEST_DIMS, matrix_sweeps=1,
               matrix_solver="lusgs", equation_set="rans",
               turbulence_model="sst2003", **deck):
    """the generated deck; ``deck`` takes write_plate_case's other
    keywords: the species ones (cases.N2O2, cases.AIR5) and the time
    integration, Jacobian, time-step, nonlinear-iteration, dual-time and
    CFL ones"""
    return write_plate_case(str(tmp_dir), *dims,
                            matrix_sweeps=matrix_sweeps,
                            matrix_solver=matrix_solver,
                            equation_set=equation_set,
                            turbulence_model=turbulence_model, **deck)


@contextlib.contextmanager
def quick_jax_compiles():
    """the JAX side compiles with most of XLA's optimisations off
    (``jax_disable_most_optimizations``): a deck's iteration compiles in
    about two thirds of the time, its float64 results unchanged at the
    tolerances of these tests; restored on exit"""
    import jax
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_module():
    """``quick_jax_compiles`` over a whole test module: autouse where a
    module imports it"""
    with quick_jax_compiles():
        yield


def jax_solver(deck_path, workdir, scan=False, nproc=1):
    """aither_tpu Solver with its sweep on the Pallas kernel (interpret),
    or with ``scan`` on its plain scan path (``cfg["no_pallas"]``);
    ``nproc`` decomposes the grid."""
    from aither_tpu.solver.driver import Solver
    solver = Solver(deck_path, workdir=str(workdir), nproc=nproc)
    solver.cfg["no_pallas" if scan else "pallas_interpret"] = True
    return solver


def enable_jax_march(solver):
    """Put aither_tpu's fused viscous march (pallas_residual, interpret
    mode) on its residual path: prepack every block's statics as its
    Solver does at init when the march is on, and rebuild the geometry
    arguments its jitted iteration takes."""
    from aither_tpu.solver import pallas_residual as pres
    solver.cfg["pallas_interpret"] = True
    for b in solver.case.blocks:
        assert pres.use_march(solver.phys, solver.cfg, b, solver.case.dtype,
                              for_prepack=True)
        pres.ensure_static(solver.phys, solver.cfg, b, solver.case.dtype)
    solver._geo_args = solver._build_geo_args()
    return solver


def torch_solver(deck_path, workdir, nproc=1):
    from aither_tpu_torch.solver.driver import Solver
    return Solver(deck_path, device="cpu", workdir=str(workdir),
                  nproc=nproc)


def perturbed_prims(blocks, seed=SEED):
    """{block: padded numpy prim}: prim0 times (1 + 0.01 U[0,1)) on the
    interior (ghosts untouched)."""
    rng = np.random.default_rng(seed)
    out = {}
    for b in blocks:
        prim = np.array(b.prim0, dtype=np.float64)
        g = b.g
        P = (slice(None), slice(g, g + b.ni), slice(g, g + b.nj),
             slice(g, g + b.nk))
        prim[P] *= 1.0 + 0.01 * rng.random(prim[P].shape)
        out[b.index] = prim
    return out


def np_(x):
    """numpy copy of a JAX array or torch tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, rtol, atol, what):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def rel_err(got, want):
    """max |got - want| / max |want| (scale-relative error)."""
    got, want = np_(got), np_(want)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))


# ---------------------------------------------------------------------------
# the checks every physics family shares (tests/test_torch_laminar.py,
# test_torch_les.py, test_torch_wilcox.py): the deck's keywords select the
# equation set, the turbulence model and the matrix solver


def solver_pair(workdir, scan=False, nproc=1, **deck):
    """(JAX solver, port solver) of one generated deck (decomposed for
    ``nproc`` processes), both holding the same perturbed state and its
    conserved twin."""
    import jax.numpy as jnp
    path = write_case(workdir, **deck)
    js = jax_solver(path, workdir, scan, nproc)
    ts = torch_solver(path, workdir, nproc)
    prims = perturbed_prims(js.case.blocks)
    js.prims = {b: jnp.asarray(v) for b, v in prims.items()}
    js.cons_n = js.store_old_solution()
    ts.set_state(prims, {b: np_(v) for b, v in js.cons_n.items()})
    return js, ts


def jax_step(js, nn):
    """one iteration of the JAX Solver: (prims, L2 squares, matrix
    residual)"""
    import jax.numpy as jnp
    cfl = jnp.asarray(js.deck.cfl(nn), js.case.dtype)
    prims, l2, linfs, mr, js.bc_aux = js._iterate(
        js.prims, js.cons_n, js.cons_nm1, cfl, 0, bc_aux=js.bc_aux)
    return prims, np.asarray(l2), float(mr)


def check_one_iteration(js, ts, tol=1e-10, mr_tol=1e-9):
    """one full implicit iteration from the shared state: interior prims
    per equation and the L2 norms within ``tol``, the matrix residual
    within ``mr_tol`` (relative)."""
    want_prims, want_l2, want_mr = jax_step(js, 0)
    got_prims, got_l2, _, got_mr, _ = ts._iteration(dict(ts.prims), ts.cons_n,
                                                 ts.deck.cfl(0))
    assert len(want_l2) == ts.phys.neq
    for b in ts.case.blocks:
        g = b.g
        for e in range(ts.phys.neq):
            w = np_(want_prims[b.index])[e, g:g + b.ni, g:g + b.nj,
                                         g:g + b.nk]
            t = got_prims[b.index][b.interior][e]
            assert rel_err(t, w) < tol, (b.index, e, rel_err(t, w))
    np.testing.assert_allclose(np_(got_l2), want_l2, rtol=tol)
    assert abs(float(got_mr) - want_mr) <= mr_tol * abs(want_mr)


def check_history(js, ts, iterations=5, rtol=1e-8):
    """raw residual L2 of ``iterations`` iterations, JAX Solver against
    the port's ``run``"""
    want = []
    for nn in range(iterations):
        js.cons_n = js.store_old_solution()
        js.prims, l2, _ = jax_step(js, nn)
        want.append(np.sqrt(l2))
    ts.run(iterations=iterations)
    got = np.asarray(ts.l2_history)
    assert got.shape == (iterations, ts.phys.neq)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol)


AUX_KEYS = ("mu", "mut", "f1", "vgrad")


def sweep_inputs(ts, seed=5):
    """numpy sweep inputs by block: the port's linear system of its state
    (block inverses as channels), random du in the ghosts so connection
    ghosts feed the sweep.  Entries a model lacks (the turbulence inverse
    with 5 equations, the viscous fields of an inviscid deck) are left
    out."""
    prims, res, sr, dg, dts, auxs = ts._residuals(dict(ts.prims),
                                                  ts.deck.cfl(0))
    inv_diag, _, bs, _ = ts._setup_linear(prims, res, sr, dg, dts, auxs,
                                          ts.cons_n)
    rng = np.random.default_rng(seed)
    inputs = {}
    for b in ts.case.blocks:
        bi = b.index
        a = dict(prim=prims[bi], b=bs[bi], inv_f=inv_diag[bi][0],
                 inv_t=inv_diag[bi][1],
                 **{k: (auxs[bi] or {}).get(k) for k in AUX_KEYS})
        inputs[bi] = {k: v.numpy() for k, v in a.items() if v is not None}
        inputs[bi]["du"] = 1e-4 * rng.standard_normal(
            (ts.phys.neq,) + b.shape)
    return inputs


def jax_sweep_pair(js, inputs, with_extra, scan=False):
    """forward then backward group sweep of the JAX package over both
    (same-shape) blocks through its Pallas kernel in interpret mode
    (whatever path the Solver's own iteration takes), or with ``scan``
    through its scan path (the only one of approximateRoe), scalar or
    block by the deck: ({block: du after forward}, {block: du after
    backward})"""
    import jax
    import jax.numpy as jnp
    from aither_tpu.solver import implicit as jim
    from aither_tpu.solver import pallas_sweep as ps
    blocks = js.case.blocks
    ctxs = [jim.build_implicit_context(b) for b in blocks]
    cfg = {k: v for k, v in js.cfg.items()
           if k not in ("no_pallas", "pallas_interpret")}
    cfg["no_pallas" if scan else "pallas_interpret"] = True
    blk = bool(cfg.get("block_matrix"))

    def inverse(ctx, ch):
        if ch is None:
            return None
        if not blk:
            return jim.skew_from_physical(ctx, ch)
        n = int(round(ch.shape[0] ** 0.5))   # channels -> (..., n, n)
        return jim.skew_from_physical_blk(
            ctx, jnp.moveaxis(ch, 0, -1).reshape(ch.shape[1:] + (n, n)))

    def run(arrs):
        items = []
        for b, ctx in zip(blocks, ctxs):
            a = arrs[b.index]
            items.append(dict(
                block=b, ctx=ctx, prim=a["prim"], du=a["du"],
                b=jim.skew_from_physical(ctx, a["b"]),
                inv_f=inverse(ctx, a["inv_f"]),
                inv_t=inverse(ctx, a.get("inv_t")),
                aux={k: a[k] for k in AUX_KEYS if k in a}))
        fwd = jim.lusgs_forward_group(js.phys, cfg, items, with_extra)
        for it, du in zip(items, fwd):
            it["du"] = du
        bwd = jim.lusgs_backward_group(js.phys, cfg, items, with_extra)
        return fwd, bwd

    # the kernel path, or the scan path
    assert ps.use_pallas(cfg, jnp.float64, js.phys) != scan
    arrs = {bi: {k: jnp.asarray(v) for k, v in a.items()}
            for bi, a in inputs.items()}
    fwd, bwd = jax.jit(run)(arrs)
    return ({b.index: np.asarray(f) for b, f in zip(blocks, fwd)},
            {b.index: np.asarray(f) for b, f in zip(blocks, bwd)})


def check_sweep_pair(js, ts, inputs, with_extra, tol=1e-10, scan=False):
    """the port's plain forward + backward sweep pair (scalar or block by
    the deck) against the JAX package's Pallas sweep (``scan``: its scan
    sweep), per equation within ``tol`` of its scale; CPU tensors launch
    no kernel."""
    import torch
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver import implicit as tim
    want_f, want_b = jax_sweep_pair(js, inputs, with_extra, scan)
    launches = (ls.LAUNCHES.count, ls.BLOCK_LAUNCHES.count)
    for b in ts.case.blocks:
        bi = b.index
        a = {k: torch.as_tensor(v.copy()) for k, v in inputs[bi].items()}
        aux = {k: a[k] for k in AUX_KEYS if k in a} or None
        inv = (a["inv_f"], a.get("inv_t"))
        plan = ts.plans[bi]
        extra = (tim.offdiag_sum(ts.phys, ts.cfg, b, a["prim"], a["du"],
                                 "upper", aux) if with_extra else None)
        du = ls.forward(ts.phys, ts.cfg, plan, a["prim"], a["du"], a["b"],
                        *inv, aux, extra=extra)
        for e in range(ts.phys.neq):
            err = rel_err(du[e], want_f[bi][e])
            assert err < tol, ("forward", bi, e, err)
        extra = (tim.offdiag_sum(ts.phys, ts.cfg, b, a["prim"], du, "lower",
                                 aux) if with_extra else None)
        du = ls.backward(ts.phys, ts.cfg, plan, a["prim"], du, a["b"], *inv,
                         aux, extra=extra)
        for e in range(ts.phys.neq):
            err = rel_err(du[e], want_b[bi][e])
            assert err < tol, ("backward", bi, e, err)
    assert (ls.LAUNCHES.count, ls.BLOCK_LAUNCHES.count) == launches


def viscous_inputs(ts, prims):
    """{block: (prim, T, mu)}: the port's viscous residual inputs, prim
    after the full and the viscous ghost fill"""
    import torch
    from aither_tpu_torch.solver import state as tstate
    from aither_tpu_torch.solver import step as tstep
    phys = ts.phys
    filled = tstep.apply_all_bcs(phys, ts.case,
                                 {b: torch.as_tensor(v)
                                  for b, v in prims.items()})
    out = {}
    for b in ts.case.blocks:
        prim = tstep.apply_boundary_ghosts(phys, b, filled[b.index],
                                           viscous_pass=True)
        prim = tstep.apply_edge_ghosts(phys, b, prim, viscous_pass=True)
        t_all = phys.temperature(prim[phys.ie], prim[:phys.ns])
        out[b.index] = (prim, t_all, phys.viscosity(
            t_all, tstate.mixture_fractions(phys, prim)))
    return out


MARCH_NAMES = ("resid", "sr_flow", "sr_turb", "diag_flow", "diag_turb")


def assert_close_scaled(got, want, rtol, atol_scale, what):
    """|got - want| <= rtol |want| + atol_scale max|want|: the absolute
    part is relative to the output's own scale, so that a small field (the
    WALE eddy viscosity) is held as tightly as a large one"""
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rtol * np.abs(want) + atol_scale * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound), (
        what, float(np.abs(got - want).max()), float(np.abs(want).max()))


def check_march(js, ts, inputs, cellavg_keys):
    """the port's ``kernels.viscous_march.viscous_residual`` on the CPU
    (its plain version) against the JAX package's Pallas march in
    interpret mode: the residual rows, radii and diagonals within rtol
    1e-9, the cell averages (gradients, mut, f1, f2) within 1e-13 of their
    own scale besides.  Returns the JAX cell averages by block."""
    import jax.numpy as jnp
    from aither_tpu.solver import pallas_residual as pres
    from aither_tpu_torch.kernels import viscous_march as vm
    launches = vm.LAUNCHES.count
    cellavgs = {}
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        prim, t_all, mu_all = inputs[tb.index]
        assert pres.use_march(js.phys, js.cfg, jb, js.case.dtype,
                              for_prepack=True)
        pres.ensure_static(js.phys, js.cfg, jb, js.case.dtype)
        want = pres.viscous_residual_march(
            js.phys, js.cfg, jb, jnp.asarray(prim.numpy()),
            jnp.asarray(t_all.numpy()), jnp.asarray(mu_all.numpy()))
        got = vm.viscous_residual(ts.phys, ts.cfg, tb, prim, t_all, mu_all)
        assert len(got) == 6
        for i, name in enumerate(MARCH_NAMES):
            assert_close_scaled(got[i], want[i], 1e-9, 1e-13,
                                f"block {tb.index} {name}")
        assert set(got[5]) == set(cellavg_keys)
        for key in cellavg_keys:
            assert_close_scaled(got[5][key], want[5][key], 1e-9, 1e-13,
                                f"block {tb.index} cellavg[{key}]")
        cellavgs[tb.index] = {k: np_(v) for k, v in want[5].items()}
    # CPU tensors take the plain version: no kernel launch
    assert vm.LAUNCHES.count == launches
    return cellavgs


def resid_columns(ts):
    """names of the residual columns in the port's .resid header"""
    with open(ts.sim_root + ".resid") as f:
        return [c for c in f.readline().split() if c.startswith("Res-")]


# ---------------------------------------------------------------------------
# multigrid (tests/test_torch_multigrid*.py)


def traced_iterate(js):
    """Replace the JAX Solver's jitted iteration by one program that also
    returns its multigrid trace (``_mg_trace_log``, filled while it
    traces): one compile serves the iteration, the history and the
    stage-by-stage comparison.  The last call's trace is
    ``js.last_trace``, a list of ((stage, level), {block: array})."""
    import jax
    names = []

    def iteration(geo_args, prims, cons_n, cons_nm1, cfl, bc_aux):
        js._mg_trace_log = []
        try:
            out = js._iteration_with_geo(geo_args, prims, cons_n, cons_nm1,
                                         cfl, stage=0, bc_aux=bc_aux)
            log = js._mg_trace_log
        finally:
            js._mg_trace_log = None
        names[:] = [(stage, lvl) for stage, lvl, _ in log]
        return out, [d for _, _, d in log]

    jitted = jax.jit(iteration)

    def _iterate(prims, cons_n, cons_nm1, cfl, stage, bc_aux=None):
        assert stage == 0
        out, trace = jitted(js._geo_args, prims, cons_n, cons_nm1, cfl,
                            bc_aux)
        js.last_trace = list(zip(names, trace))
        return out

    js._iterate = _iterate
    return js


def mg_solver_pair(workdir, **deck):
    """``solver_pair`` of a multigrid deck, the JAX side on its scan sweep
    path (its Pallas sweep in interpret mode compiles several times slower
    at up to twenty sweeps an iteration; its multigrid code is the same on
    both paths) through ``traced_iterate``"""
    js, ts = solver_pair(workdir, scan=True, **deck)
    assert js.mg_nlevels == ts.mg_nlevels > 1
    assert js.mg_cycle_index == ts.mg_cycle_index
    return traced_iterate(js), ts


def check_cycle_stages(js, ts, forced, tol=1e-10):
    """one iteration's multigrid cycle from the shared state, the port's
    ``_mg_trace_log`` against the JAX package's: the same stages at the
    same levels in the same order (``forced``: the levels of the forcing
    stages, one per restriction), every field within ``tol`` of its
    scale"""
    assert ts._mg_trace_log is None
    jax_step(js, 0)
    ts._mg_trace_log = []
    try:
        ts._iteration(dict(ts.prims), ts.cons_n, ts.deck.cfl(0))
        got = ts._mg_trace_log
    finally:
        ts._mg_trace_log = None
    want = js.last_trace
    assert [(s, lv) for s, lv, _ in got] == [key for key, _ in want]
    assert [lv for s, lv, _ in got if s == "forcing"] == forced
    for (stage, lvl, g), (_, w) in zip(got, want):
        assert set(g) == set(w)
        for bi in g:
            err = rel_err(g[bi], w[bi])
            assert err < tol, (stage, lvl, bi, err)
