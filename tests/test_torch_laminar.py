"""PyTorch port, the laminar Navier-Stokes deck (``equationSet:
navierStokes``, 5 equations, no turbulence model) against aither_tpu on
the generated two-block plate, perturbed:

1. K2: the port's plain viscous residual against the JAX package's Pallas
   march in interpret mode (its laminar branch): every output, 21 channels'
   worth (no 'tke' / 'omega' averages; mut = f1 = f2 = 0 and sr_turb =
   diag_turb = 0 exactly);
2. K1: the plain forward + backward sweep pair against the Pallas sweep in
   interpret mode, scalar and block, without and with the lagged term
   (1e-10 per equation, as test_torch_sweep / test_torch_blusgs);
3. the slice: one full lusgs iteration against the JAX Solver (Pallas
   sweep, interpret mode): prims 1e-10, matrix residual 1e-9, and a
   5-iteration raw L2 history (1e-8); one full blusgs iteration against
   the JAX Solver's scan path (1e-10; the block kernel is held by 2);
4. the .resid header has 5 residual columns.

Tolerances as test_torch_slice and test_torch_viscous_march state them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_history, check_march,  # noqa: E402
                                check_one_iteration, check_sweep_pair,
                                perturbed_prims, resid_columns, solver_pair,
                                sweep_inputs, viscous_inputs)

DECK = dict(equation_set="navierStokes", turbulence_model="none")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("laminar"), **DECK)


@pytest.fixture(scope="module")
def block_pair(tmp_path_factory):
    """blusgs; the JAX Solver's own iteration on its scan path (its Pallas
    block sweep is called directly by the sweep-pair test)"""
    return solver_pair(tmp_path_factory.mktemp("laminar_blusgs"), scan=True,
                       matrix_solver="blusgs", **DECK)


def test_deck_is_five_equations(pair):
    js, ts = pair
    assert (ts.phys.neq, ts.phys.nturb, ts.phys.turb_model) == (5, 0, "none")
    assert (js.phys.neq, js.phys.nturb) == (5, 0)
    assert ts.cfg["viscous"] and not ts.cfg["turbulent"]


def test_plain_viscous_residual_matches_pallas_march(pair):
    js, ts = pair
    inputs = viscous_inputs(ts, perturbed_prims(ts.case.blocks))
    cellavg = check_march(js, ts, inputs, ("vel", "mut", "f1", "f2"))
    for ca in cellavg.values():
        assert not ca["mut"].any() and not ca["f1"].any()
    from aither_tpu_torch.kernels import viscous_march as vm
    b = ts.case.blocks[0]
    got = vm.viscous_residual(ts.phys, ts.cfg, b, *inputs[b.index])
    assert got[0].shape[0] == 5
    assert not got[2].any() and not got[4].any()      # sr_turb, diag_turb
    assert sum(k for _, k in vm.out_channels(0)) == 21


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_scalar_sweep_pair_matches_pallas_kernel(pair, with_extra):
    js, ts = pair
    inputs = sweep_inputs(ts)
    assert "inv_t" not in inputs[0] and inputs[0]["prim"].shape[0] == 5
    check_sweep_pair(js, ts, inputs, with_extra)


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_block_sweep_pair_matches_pallas_kernel(block_pair, with_extra):
    js, ts = block_pair
    inputs = sweep_inputs(ts)
    assert inputs[0]["inv_f"].shape[0] == 25 and "inv_t" not in inputs[0]
    assert inputs[0]["vgrad"].shape[:2] == (3, 3)
    check_sweep_pair(js, ts, inputs, with_extra)


def test_one_lusgs_iteration(pair):
    check_one_iteration(*pair)


def test_one_blusgs_iteration(block_pair):
    js, ts = block_pair
    assert js.cfg["block_matrix"] and ts.cfg["block_matrix"]
    check_one_iteration(js, ts)


def test_residual_history_and_resid_header(pair):
    js, ts = pair
    check_history(js, ts)
    assert resid_columns(ts) == ["Res-Mass", "Res-Mom-X", "Res-Mom-Y",
                                 "Res-Mom-Z", "Res-Energy", "Res-Matrix"]
    assert np.asarray(ts.l2_history).shape[1] == 5
