"""PyTorch port, the inviscid N2/O2 mixture (``cases.N2O2`` with
``equationSet: euler``: two species, 6 equations, slip walls, no
diffusion) against aither_tpu on the generated two-block plate, perturbed
by 1% (a uniform flow otherwise): the plain sweep pairs against the JAX
package's Pallas sweep in interpret mode, scalar and block (36 inverse
channels), with the lagged term (1e-10 per equation), and one full
iteration with lusgs (the Pallas sweep) and blusgs (the JAX Solver's scan
path), prims and L2 within 1e-10, the matrix residual within 1e-9.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import (check_one_iteration,  # noqa: E402
                                check_sweep_pair, solver_pair, sweep_inputs)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

DECK = dict(cases.N2O2, equation_set="euler", turbulence_model="none",
            diffusion="none")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("n2o2_euler"), **DECK)


@pytest.fixture(scope="module")
def block_pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("n2o2_euler_blusgs"),
                       scan=True, matrix_solver="blusgs", **DECK)


def test_deck_is_an_inviscid_mixture(pair):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    _, ts = pair
    assert (ts.phys.ns, ts.phys.neq) == (2, 6) and not ts.cfg["viscous"]
    assert ls.sweep_form(ts.phys, ts.cfg) == (2, 6, False, False,
                                                False, False)


def test_plain_scalar_sweep_pair_matches_pallas_kernel(pair):
    js, ts = pair
    check_sweep_pair(js, ts, sweep_inputs(ts), True)


def test_plain_block_sweep_pair_matches_pallas_kernel(block_pair):
    js, ts = block_pair
    inputs = sweep_inputs(ts)
    assert inputs[0]["inv_f"].shape[0] == 36
    check_sweep_pair(js, ts, inputs, True)


def test_one_lusgs_iteration(pair):
    check_one_iteration(*pair)


def test_one_blusgs_iteration(block_pair):
    check_one_iteration(*block_pair)
