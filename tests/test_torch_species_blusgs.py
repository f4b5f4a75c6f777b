"""PyTorch port, the N2/O2 mixture with SST and Schmidt diffusion
(``cases.N2O2``: two species, 8 equations, 6x6 flow blocks) and
block-matrix LU-SGS (blusgs) against aither_tpu on the generated two-block
plate, perturbed:

1. K1: the plain forward + backward block sweep pair against the JAX
   package's Pallas block sweep in interpret mode (its multispecies form:
   36 inverse channels, the species-diffusion rows of the thin-shear-layer
   Jacobian), without and with the lagged term (1e-10 per equation);
2. the slice: one full blusgs iteration at matrixSweeps 1 and 2 against
   the JAX Solver's scan path (as the other blusgs decks' tests: the same
   block off-diagonal, without the Pallas kernel's compile) (prims and L2
   1e-10, matrix residual 1e-9), and a 5-iteration raw L2 history (1e-8).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import (check_history,  # noqa: E402
                                check_one_iteration, check_sweep_pair,
                                solver_pair, sweep_inputs)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("n2o2_blusgs"), scan=True,
                       matrix_solver="blusgs", **cases.N2O2)


@pytest.fixture(scope="module")
def pair_lagged(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("n2o2_blusgs_lagged"),
                       scan=True, matrix_solver="blusgs", matrix_sweeps=2,
                       **cases.N2O2)


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_block_sweep_pair_matches_pallas_kernel(pair, with_extra):
    js, ts = pair
    inputs = sweep_inputs(ts)
    assert inputs[0]["inv_f"].shape[0] == 36
    assert inputs[0]["inv_t"].shape[0] == 4
    check_sweep_pair(js, ts, inputs, with_extra)


def test_one_iteration(pair):
    check_one_iteration(*pair)


def test_one_iteration_lagged_sweeps(pair_lagged):
    check_one_iteration(*pair_lagged)


def test_residual_history(pair):
    check_history(*pair)
