"""PyTorch port, the Wilcox 2006 k-omega deck (``equationSet: rans``,
``turbulenceModel: kOmegaWilcox2006``, 7 equations) against aither_tpu on
the generated two-block plate, perturbed:

1. K2: the port's plain viscous residual against the JAX package's Pallas
   march in interpret mode (its Wilcox branch: the stress-limited mut, f1 =
   1, f2 = 0, sigma* / sigma with the unlimited rho k / omega in the k and
   omega fluxes and in the turbulence spectral radius), every output;
2. K1: the plain forward + backward sweep pair against the Pallas sweep in
   interpret mode, scalar and block, without and with the lagged term
   (1e-10 per equation);
3. the slice: one full lusgs iteration against the JAX Solver (Pallas
   sweep, interpret mode): prims 1e-10, matrix residual 1e-9, and a
   5-iteration raw L2 history (1e-8); one full blusgs iteration against
   the JAX Solver's scan path (1e-10), which runs the Wilcox source
   Jacobian with ``wilcox_beta``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_history, check_march,  # noqa: E402
                                check_one_iteration, check_sweep_pair,
                                perturbed_prims, resid_columns, solver_pair,
                                sweep_inputs, viscous_inputs)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

DECK = dict(equation_set="rans", turbulence_model="kOmegaWilcox2006")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("wilcox"), **DECK)


@pytest.fixture(scope="module")
def block_pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("wilcox_blusgs"), scan=True,
                       matrix_solver="blusgs", **DECK)


def test_deck_is_wilcox(pair):
    js, ts = pair
    assert (ts.phys.neq, ts.phys.nturb) == (7, 2)
    assert ts.phys.turb_model == js.phys.turb_model == "kOmegaWilcox2006"
    assert ts.phys.turb_prandtl() == js.phys.turb_prandtl() == 8.0 / 9.0


def test_plain_viscous_residual_matches_pallas_march(pair):
    js, ts = pair
    inputs = viscous_inputs(ts, perturbed_prims(ts.case.blocks))
    cellavg = check_march(js, ts, inputs,
                          ("vel", "tke", "omega", "mut", "f1", "f2"))
    for ca in cellavg.values():
        assert ca["mut"].min() > 0.0
        assert np.all(ca["f1"] == 1.0) and not ca["f2"].any()


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_scalar_sweep_pair_matches_pallas_kernel(pair, with_extra):
    js, ts = pair
    check_sweep_pair(js, ts, sweep_inputs(ts), with_extra)


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_block_sweep_pair_matches_pallas_kernel(block_pair, with_extra):
    js, ts = block_pair
    inputs = sweep_inputs(ts)
    assert inputs[0]["inv_f"].shape[0] == 25
    assert inputs[0]["inv_t"].shape[0] == 4
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
    assert resid_columns(ts)[-3:] == ["Res-Tke", "Res-Omega", "Res-Matrix"]
