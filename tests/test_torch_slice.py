"""PyTorch port, whole-slice parity with aither_tpu's Solver on the
generated two-block SST plate: one full implicit iteration (ghosts, Roe +
MUSCL and viscous SST residual, mut/f1 swaps, diagonal and rhs, one
forward and one backward LU-SGS sweep — on the JAX side through the Pallas
kernel in interpret mode — matrix residual, update, norms), and a
5-iteration history of the raw residual L2 norms; both again with
``matrixSweeps: 2`` (matrix initialised to D^-1 b, two sweep pairs with
the lagged opposite-side term), the one-iteration check with the JAX
package's fused viscous march (interpret mode) on its residual path.

Raw L2 values are compared, not the .resid columns (those are normalised
to 1 over the first 5 iterations).  Tolerances, relative: 1e-10 for one
iteration (float64 roundoff through residual cancellation and the sweep
recurrence, see test_torch_residual / test_torch_sweep); 1e-8 for the
5-iteration history, where each iteration's update feeds the next
residual and the difference may grow by the implicit operator's
amplification per step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (enable_jax_march, jax_solver,  # noqa: E402
                                np_, perturbed_prims, rel_err, torch_solver,
                                write_case)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

ITERATIONS = 5


def _pair(tmp_path_factory, matrix_sweeps=1):
    wd = tmp_path_factory.mktemp("plate")
    path = write_case(wd, matrix_sweeps=matrix_sweeps)
    js, ts = jax_solver(path, wd), torch_solver(path, wd)
    prims = perturbed_prims(js.case.blocks)
    js.prims = {b: jnp.asarray(v) for b, v in prims.items()}
    js.cons_n = js.store_old_solution()
    ts.set_state(prims, {b: np_(v) for b, v in js.cons_n.items()})
    return js, ts


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _pair(tmp_path_factory)


@pytest.fixture(scope="module")
def pair_lagged(tmp_path_factory):
    return _pair(tmp_path_factory, matrix_sweeps=2)


def _jax_step(js, nn):
    cfl = jnp.asarray(js.deck.cfl(nn), js.case.dtype)
    prims, l2, linfs, mr, js.bc_aux = js._iterate(
        js.prims, js.cons_n, js.cons_nm1, cfl, 0, bc_aux=js.bc_aux)
    return prims, np.asarray(l2), float(mr)


def _check_one_iteration(js, ts):
    want_prims, want_l2, want_mr = _jax_step(js, 0)
    got_prims, got_l2, _, got_mr, _ = ts._iteration(dict(ts.prims), ts.cons_n,
                                                 ts.deck.cfl(0))
    for b in ts.case.blocks:
        g = b.g
        for e in range(ts.phys.neq):
            w = np_(want_prims[b.index])[e, g:g + b.ni, g:g + b.nj,
                                         g:g + b.nk]
            t = got_prims[b.index][b.interior][e]
            assert rel_err(t, w) < 1e-10, (b.index, e)
    np.testing.assert_allclose(np_(got_l2), want_l2, rtol=1e-10)
    assert float(got_mr) == pytest.approx(want_mr, rel=1e-10)


def _check_history(js, ts):
    want = []
    for nn in range(ITERATIONS):
        js.cons_n = js.store_old_solution()
        js.prims, l2, _ = _jax_step(js, nn)
        want.append(np.sqrt(l2))
    ts.run(iterations=ITERATIONS)
    got = np.asarray(ts.l2_history)
    assert got.shape == (ITERATIONS, ts.phys.neq)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-8)


def test_one_iteration(pair):
    _check_one_iteration(*pair)


def test_residual_history(pair):
    _check_history(*pair)


def test_one_iteration_lagged_sweeps(pair_lagged, monkeypatch):
    from aither_tpu.solver import pallas_residual as pres
    js, ts = pair_lagged
    assert js.cfg["matrix_sweeps"] == ts.cfg["matrix_sweeps"] == 2
    calls = []
    march = pres.viscous_residual_march
    monkeypatch.setattr(pres, "viscous_residual_march",
                        lambda *a: calls.append(1) or march(*a))
    enable_jax_march(js)
    _check_one_iteration(js, ts)
    assert len(calls) == len(js.case.blocks)   # traced once per block


def test_residual_history_lagged_sweeps(pair_lagged):
    _check_history(*pair_lagged)
