"""PyTorch port, the time integrators against aither_tpu: explicitEuler,
rk4 (explicit), crankNicholson and bdf2 with dual time (implicit).

Function level (relative 1e-13 of each equation's scale: the same float64
expressions on both sides): ``explicit_euler_update``, ``rk4_update`` at
every stage, ``sol_delta_coeffs`` and the right-hand side ``rhs_b`` with
the time n-1 term of a multilevel deck, for implicit Euler, Crank-Nicolson
(theta 1/2) and BDF2 (zeta 1/2), on random states of the generated plate.

Solver level (the tolerances of tests/test_torch_slice.py: 1e-10 for a
state after one step, 1e-8 for the raw L2 of every nonlinear iteration):
one RK4 time step (its four stages) of the Euler equations; two BDF2
dual-time steps of three nonlinear iterations of SST lusgs, both packages
starting from one carried (prims, cons_n, cons_nm1) with cons_nm1 another
state than cons_n; one crankNicholson step of the Euler equations.  The
JAX sweeps run on their scan path.  The command line on an explicit deck
writes the JAX package's ``.resid`` columns.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch.cases import TIME_INTEGRATORS  # noqa: E402
from tests.torch_parity import (jax_solver, np_, perturbed_prims,  # noqa
                                rel_err, resid_columns, solver_pair,
                                torch_solver, write_case)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

EULER = dict(equation_set="euler", turbulence_model="none")


def _close(got, want, tol, what):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, what
    for e in range(want.shape[0]):
        assert rel_err(got[e], want[e]) < tol, (what, e)


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """(JAX Solver, port Solver) of the SST bdf2 deck (nothing is run) and
    random inputs by block: padded prim, residual, two conserved
    interiors, a positive time step"""
    wd = tmp_path_factory.mktemp("functions")
    path = write_case(wd, **TIME_INTEGRATORS["bdf2"])
    js, ts = jax_solver(path, wd, scan=True), torch_solver(path, wd)
    rng = np.random.default_rng(3)
    prims = perturbed_prims(js.case.blocks)
    inputs = {}
    for b in ts.case.blocks:
        shape = (ts.phys.neq, b.ni, b.nj, b.nk)
        cons = ts.store_old_solution()[b.index].numpy()
        inputs[b.index] = dict(
            prim=prims[b.index], resid=1e-3 * rng.standard_normal(shape),
            cons_n=cons * (1.0 + 1e-3 * rng.random(shape)),
            cons_nm1=cons * (1.0 + 1e-3 * rng.random(shape)),
            dt=1e-3 * (1.0 + rng.random(shape[1:])))
    return js, ts, inputs


def test_explicit_updates(blocks):
    from aither_tpu.solver import step as jstep
    from aither_tpu_torch.solver import step as tstep
    js, ts, inputs = blocks
    assert tstep.RK4_ALPHA == jstep.RK4_ALPHA
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        a = inputs[tb.index]
        j = {k: jnp.asarray(v) for k, v in a.items()}
        t = {k: torch.as_tensor(v) for k, v in a.items()}
        want = jstep.explicit_euler_update(js.phys, jb, j["prim"],
                                           j["resid"], j["dt"])
        got = tstep.explicit_euler_update(ts.phys, tb, t["prim"],
                                          t["resid"], t["dt"])
        _close(got, want, 1e-13, "explicit Euler")
        for stage in range(4):
            want = jstep.rk4_update(js.phys, jb, j["prim"], j["cons_n"],
                                    j["resid"], j["dt"], stage)
            got = tstep.rk4_update(ts.phys, tb, t["prim"], t["cons_n"],
                                   t["resid"], t["dt"], stage)
            _close(got, want, 1e-13, f"rk4 stage {stage}")


@pytest.mark.parametrize("integrator", ["implicitEuler", "crankNicholson",
                                        "bdf2"])
def test_time_terms(blocks, integrator):
    """sol_delta_coeffs and rhs_b with theta and zeta of the integrator,
    the time n-1 term on the multilevel one"""
    from aither_tpu.io.deck import parse_deck
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import implicit as tim
    js, ts, inputs = blocks
    deck = parse_deck(js._deck_path)
    deck.values["timeIntegration"] = integrator
    cfg = dict(theta=deck.theta, zeta=deck.zeta,
               multilevel_time=deck.is_multilevel_in_time)
    assert cfg["multilevel_time"] == (integrator == "bdf2")
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        a = inputs[tb.index]
        j = {k: jnp.asarray(v) for k, v in a.items()}
        t = {k: torch.as_tensor(v) for k, v in a.items()}
        for w, g in zip(jim.sol_delta_coeffs(jb, j["dt"], cfg["theta"],
                                             cfg["zeta"]),
                        tim.sol_delta_coeffs(tb, t["dt"], cfg["theta"],
                                             cfg["zeta"])):
            _close(g[None], w[None], 1e-13, "sol_delta_coeffs")
        want = jim.rhs_b(js.phys, jb, cfg, j["prim"], j["resid"],
                         j["cons_n"], j["cons_nm1"], j["dt"])
        got = tim.rhs_b(ts.phys, tb, cfg, t["prim"], t["resid"],
                        t["cons_n"], t["dt"], t["cons_nm1"])
        _close(got, want, 1e-13, f"rhs_b {integrator}")


# ---------------------------------------------------------------------------
# solver level


def _jax_steps(js, steps, prims, cons_n=None, cons_nm1=None):
    """``steps`` time steps of the JAX Solver's nonlinear iterations (the
    rk4 stages in turn), the time n-1 solution carried in and rolled after
    each step as its ``run`` does on a restart: (prims, raw L2 of every
    nonlinear iteration)"""
    js.prims = {b: jnp.asarray(v) for b, v in prims.items()}
    rk4 = js.cfg["time_integration"] == "rk4"
    l2s = []
    for nn in range(steps):
        js.cons_n = (js.store_old_solution() if cons_n is None or nn
                     else {b: jnp.asarray(v) for b, v in cons_n.items()})
        if cons_nm1 is not None and nn == 0:
            js.cons_nm1 = {b: jnp.asarray(v) for b, v in cons_nm1.items()}
        cfl = jnp.asarray(js.deck.cfl(nn), js.case.dtype)
        for mm in range(js.deck["nonlinearIterations"]):
            js.prims, l2, _, _, js.bc_aux = js._iterate(
                js.prims, js.cons_n, js.cons_nm1, cfl,
                mm if rk4 else 0, bc_aux=js.bc_aux)
            l2s.append(np.sqrt(np.asarray(l2)))
        if js.cfg["multilevel_time"]:
            js.cons_nm1 = dict(js.cons_n)
    return js.prims, np.asarray(l2s)


def _check_run(js, ts, want_prims, want_l2, tol=1e-10, rtol=1e-8):
    got = np.asarray(ts.l2_history)
    assert got.shape == want_l2.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want_l2, rtol=rtol)
    for b in ts.case.blocks:
        g = b.g
        w = np_(want_prims[b.index])[:, g:g + b.ni, g:g + b.nj, g:g + b.nk]
        _close(ts.prims[b.index][b.interior], w, tol, f"block {b.index}")


def test_rk4_step(tmp_path):
    """one time step of four stages, each from the step's time-n solution"""
    js, ts = solver_pair(tmp_path, scan=True, **EULER,
                         **TIME_INTEGRATORS["rk4"])
    assert ts.deck["nonlinearIterations"] == 4 and not ts.cfg["implicit"]
    prims = {b: np_(v) for b, v in js.prims.items()}
    with jax.disable_jit():
        want_prims, want_l2 = _jax_steps(js, 1, prims)
    ts.run(iterations=1)
    _check_run(js, ts, want_prims, want_l2)


def test_bdf2_carried_state(tmp_path):
    """two dual-time BDF2 steps of three nonlinear iterations from a
    carried (prims, cons_n, cons_nm1): the first uses the carried n-1
    solution, the second the rolled one"""
    js, ts = solver_pair(tmp_path, scan=True, **TIME_INTEGRATORS["bdf2"])
    assert ts.cfg["multilevel_time"] and ts.deck["nonlinearIterations"] == 3
    prims = {b: np_(v) for b, v in js.prims.items()}
    cons_n = {b: np_(v) for b, v in js.cons_n.items()}
    from aither_tpu_torch.solver import state as tstate
    other = perturbed_prims(js.case.blocks, seed=11)
    cons_nm1 = {b.index: tstate.cons_from_prim(
        ts.phys, torch.as_tensor(other[b.index])[b.interior]).numpy()
        for b in ts.case.blocks}
    ts.set_state(prims, cons_n, cons_nm1)
    want_prims, want_l2 = _jax_steps(js, 2, prims, cons_n, cons_nm1)
    ts.run(iterations=2)
    _check_run(js, ts, want_prims, want_l2)
    # the carried n-1 solution was used: started at time n, as a run
    # without one starts it, the first update differs
    fresh = torch_solver(js._deck_path, tmp_path)
    fresh.set_state(prims, cons_n)
    fresh.run(iterations=1)
    assert rel_err(fresh.l2_history[1], want_l2[1]) > 1e-6


def test_crank_nicolson_step(tmp_path):
    js, ts = solver_pair(tmp_path, scan=True, **EULER,
                         **TIME_INTEGRATORS["crankNicholson"])
    assert ts.cfg["theta"] == 0.5 and ts.cfg["implicit"]
    prims = {b: np_(v) for b, v in js.prims.items()}
    with jax.disable_jit():
        want_prims, want_l2 = _jax_steps(js, 1, prims)
    ts.run(iterations=1)
    _check_run(js, ts, want_prims, want_l2)


def test_cli_explicit_deck_writes_the_jax_columns(tmp_path, monkeypatch):
    from aither_tpu_torch.main import main
    path = write_case(tmp_path, (4, 3, 2), **EULER,
                      **TIME_INTEGRATORS["explicitEuler"])
    monkeypatch.chdir(tmp_path)
    assert main([path, "--device", "cpu", "--iterations", "2",
                 "--no-files"]) == 0
    ts = torch_solver(path, tmp_path)
    with open(tmp_path / "plate.resid") as f:
        rows = [ln.split() for ln in f if ln.strip()]
    assert len(rows) == 3
    # the explicit step's matrix residual prints as zero, as the JAX
    # package prints it
    assert all(float(r[-1]) == 0.0 for r in rows[1:])
    jwd = tmp_path / "jax"
    os.makedirs(jwd)
    js = jax_solver(path, jwd)
    js._open_logs()
    js.resid_file.close()
    js.time_file.close()
    with open(js.sim_root + ".resid") as f:
        want = [c for c in f.readline().split() if c.startswith("Res-")]
    assert resid_columns(ts) == want
