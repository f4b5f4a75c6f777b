"""PyTorch port, hot five-species air (``cases.AIR5``: N2, O2, NO, N, O
at about 3,900 K, laminar, Schmidt diffusion, the inline three-reaction
air5 mechanism, 9 equations) with block-matrix LU-SGS (blusgs) against
aither_tpu on the generated two-block plate, perturbed.  Both packages
find the mechanism in the working directory, the case's.

1. K1: the plain forward + backward block sweep pair against the JAX
   package's Pallas block sweep in interpret mode (81 inverse channels,
   the chemistry Jacobian in the block diagonal, the species-diffusion
   rows in the off-diagonal), without and with the lagged term (1e-10 per
   equation, on the same inputs);
2. the slice: one full blusgs iteration against the JAX Solver's scan
   path, held to 2e-6 of each equation's scale.  Its block diagonal holds
   the reference's forward-difference chemistry Jacobian (step 1e-10 rho,
   chemistry.cpp:127-176), which turns the two packages' one-ulp
   differences of exp in the sources into relative differences of ~2e-7
   in the Jacobian (tests/test_torch_mixture.py::test_source_jacobian);
   the update inherits them, 4e-7 of the NO density's scale measured on
   this case.  Everything but that Jacobian is held to 1e-10 by the sweep
   pairs above and by the frozen decks (test_torch_species_blusgs.py).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import (check_one_iteration,  # noqa: E402
                                check_sweep_pair, solver_pair, sweep_inputs)

DECK = dict(cases.AIR5, equation_set="navierStokes", turbulence_model="none")
FD_JACOBIAN_TOL = 2e-6


@pytest.fixture(scope="module")
def block_pair(tmp_path_factory):
    wd = tmp_path_factory.mktemp("air5_blusgs")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(wd)
        return solver_pair(wd, scan=True, matrix_solver="blusgs", **DECK)


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_block_sweep_pair_matches_pallas_kernel(block_pair,
                                                      with_extra):
    js, ts = block_pair
    inputs = sweep_inputs(ts)
    assert inputs[0]["inv_f"].shape[0] == 81 and "inv_t" not in inputs[0]
    check_sweep_pair(js, ts, inputs, with_extra)


def test_one_blusgs_iteration(block_pair):
    check_one_iteration(*block_pair, tol=FD_JACOBIAN_TOL,
                        mr_tol=FD_JACOBIAN_TOL)
