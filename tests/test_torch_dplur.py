"""PyTorch port, DPLUR (``matrixSolver: dplur``, scalar) and BDPLUR
(``bdplur``, block) against aither_tpu on the generated plate.  Neither
package has a kernel for them: the JAX package's ``dplur_sweep`` is plain
array code, the port's ``implicit.dplur_sweep`` plain tensor code.

Function level: one Jacobi sweep of ``dplur_sweep`` (both off-diagonal
sums at the sweep-start du, then the scalar or the block inverse) from the
port's linear system with random ghost du, against the JAX function on the
same inputs, per equation within 1e-12 of its scale.

Solver level: one whole iteration (1e-10) and a 5-iteration raw L2 history
(1e-8) of SST dplur at matrixSweeps 4 and of laminar bdplur (matrixSweeps
1), the tolerances of tests/test_torch_slice.py.  Two JAX Solvers, one per
deck.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (AUX_KEYS, check_history,  # noqa: E402
                                check_one_iteration, rel_err, solver_pair,
                                sweep_inputs)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

DECKS = {
    "sst_dplur": dict(matrix_solver="dplur", matrix_sweeps=4),
    "laminar_bdplur": dict(matrix_solver="bdplur", equation_set="navierStokes",
                           turbulence_model="none"),
}


@pytest.fixture(scope="module", params=list(DECKS))
def pair(request, tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp(request.param),
                       **DECKS[request.param])


def test_dplur_sweep(pair):
    """one DPLUR sweep of each block, the port's against the JAX one"""
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import implicit as tim
    js, ts = pair
    assert not ts.sweeps and not ts.plans
    blk = bool(ts.cfg["block_matrix"])
    assert blk == (ts.deck["matrixSolver"] == "bdplur")
    inputs = sweep_inputs(ts)
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        a = inputs[tb.index]

        def inverse(ch):
            if ch is None or not blk:
                return None if ch is None else jnp.asarray(ch)
            n = int(round(ch.shape[0] ** 0.5))   # channels -> (..., n, n)
            return jnp.asarray(np.moveaxis(ch, 0, -1).reshape(
                ch.shape[1:] + (n, n)))

        want = jim.dplur_sweep(
            js.phys, js.cfg, jb, jim.build_implicit_context(jb),
            jnp.asarray(a["prim"]), jnp.asarray(a["du"]), jnp.asarray(a["b"]),
            inverse(a["inv_f"]), inverse(a.get("inv_t")),
            aux={k: jnp.asarray(a[k]) for k in AUX_KEYS if k in a})
        t = {k: torch.as_tensor(v.copy()) for k, v in a.items()}
        aux = {k: t[k] for k in AUX_KEYS if k in t} or None
        got = tim.dplur_sweep(ts.phys, ts.cfg, tb, t["prim"], t["du"],
                              t["b"], t["inv_f"], t.get("inv_t"), aux)
        assert got is t["du"]       # in place
        want = np.asarray(want)
        for e in range(ts.phys.neq):
            assert rel_err(got[e], want[e]) < 1e-12, (tb.index, e)


def test_one_iteration(pair):
    js, ts = pair
    check_one_iteration(js, ts)


def test_history(pair):
    js, ts = pair
    check_history(js, ts)
