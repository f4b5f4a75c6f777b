"""PyTorch port, the N2/O2 mixture with SST and Schmidt diffusion
(``cases.N2O2``: two species, 8 equations) and scalar LU-SGS against
aither_tpu on the generated two-block plate, perturbed:

1. K1: the plain forward + backward scalar sweep pair against the JAX
   package's Pallas sweep in interpret mode (its multispecies form), without
   and with the lagged term (1e-10 per equation);
2. the slice: one full lusgs iteration against the JAX Solver (Pallas
   sweep, interpret mode) at matrixSweeps 1 and 2 (prims and L2 1e-10,
   matrix residual 1e-9), and a 5-iteration raw L2 history (1e-8).

The mixture's viscous residual takes the plain version on every device
(the JAX package's fused march covers one species); its function-level
checks are tests/test_torch_mixture.py.
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
    return solver_pair(tmp_path_factory.mktemp("n2o2"), **cases.N2O2)


@pytest.fixture(scope="module")
def pair_lagged(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("n2o2_lagged"),
                       matrix_sweeps=2, **cases.N2O2)


def test_deck_is_a_two_species_sst_mixture(pair):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    js, ts = pair
    assert (ts.phys.ns, ts.phys.neq, ts.phys.nturb) == (2, 8, 2)
    assert (js.phys.ns, js.phys.neq) == (2, 8)
    assert ts.phys.diffusion_model == "schmidt" and ts.phys.chemistry is None
    assert ls.sweep_form(ts.phys, ts.cfg) == (2, 8, True, False,
                                                False, False)


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_scalar_sweep_pair_matches_pallas_kernel(pair, with_extra):
    js, ts = pair
    check_sweep_pair(js, ts, sweep_inputs(ts), with_extra)


def test_one_iteration(pair):
    check_one_iteration(*pair)


def test_one_iteration_lagged_sweeps(pair_lagged):
    js, ts = pair_lagged
    assert ts.cfg["matrix_sweeps"] == 2 and ts.cfg["matrix_init"]
    check_one_iteration(js, ts)


def test_residual_history(pair):
    check_history(*pair)
