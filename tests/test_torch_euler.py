"""PyTorch port, the Euler deck (``equationSet: euler``: 5 equations,
inviscid, the plate's wall a slipWall) against aither_tpu on the generated
two-block plate, perturbed (the unperturbed Euler plate is a uniform flow
with roundoff-level residuals):

1. K1: the plain forward + backward sweep pair against the Pallas sweep in
   interpret mode, scalar and block (Rusanov rows only: no viscous field is
   passed), without and with the lagged term (1e-10 per equation);
2. the slice: one full lusgs iteration against the JAX Solver (Pallas
   sweep, interpret mode) and one full blusgs iteration against its scan
   path: prims 1e-10, matrix residual 1e-9; a 5-iteration lusgs history;
3. there is no viscous residual: the residual's aux is None (lusgs), the
   fused viscous kernel's wrapper refuses the deck, and the .resid header
   has 5 residual columns.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_history, check_one_iteration,  # noqa: E402
                                check_sweep_pair, resid_columns, solver_pair,
                                sweep_inputs)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

DECK = dict(equation_set="euler", turbulence_model="none")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("euler"), **DECK)


@pytest.fixture(scope="module")
def block_pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("euler_blusgs"), scan=True,
                       matrix_solver="blusgs", **DECK)


def test_deck_is_inviscid(pair):
    from aither_tpu_torch.kernels import viscous_march as vm
    from aither_tpu_torch.solver import step as tstep
    js, ts = pair
    assert (ts.phys.neq, ts.phys.nturb) == (js.phys.neq, js.phys.nturb) \
        == (5, 0)
    assert not ts.cfg["viscous"] and not js.cfg["viscous"]
    assert {s.bc_type for b in ts.case.blocks for s in b.surfaces} \
        == {"slipWall", "characteristic", "interblock"}
    prims = tstep.apply_all_bcs(ts.phys, ts.case, dict(ts.prims))
    b = ts.case.blocks[0]
    out = tstep.full_residual(ts.phys, ts.cfg, b, prims[b.index])
    assert out[5] is None and out[7] is None          # cellavg, aux
    with pytest.raises(ValueError, match="viscous"):
        vm.viscous_residual(ts.phys, ts.cfg, b, prims[b.index], None, None)


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_scalar_sweep_pair_matches_pallas_kernel(pair, with_extra):
    js, ts = pair
    inputs = sweep_inputs(ts)
    assert set(inputs[0]) == {"prim", "b", "inv_f", "du"}
    check_sweep_pair(js, ts, inputs, with_extra)


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_block_sweep_pair_matches_pallas_kernel(block_pair, with_extra):
    js, ts = block_pair
    inputs = sweep_inputs(ts)
    assert set(inputs[0]) == {"prim", "b", "inv_f", "du"}
    assert inputs[0]["inv_f"].shape[0] == 25
    check_sweep_pair(js, ts, inputs, with_extra)


def test_one_lusgs_iteration(pair):
    check_one_iteration(*pair)


def test_one_blusgs_iteration(block_pair):
    check_one_iteration(*block_pair)


def test_residual_history_and_resid_header(pair):
    js, ts = pair
    check_history(js, ts)
    assert resid_columns(ts) == ["Res-Mass", "Res-Mom-X", "Res-Mom-Y",
                                 "Res-Mom-Z", "Res-Energy", "Res-Matrix"]
    assert np.asarray(ts.l2_history).shape[1] == 5
