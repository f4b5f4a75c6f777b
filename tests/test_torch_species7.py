"""PyTorch port, seven species: frozen burned hydrogen-air
(``cases.MIXTURES["h2air7_frozen"]``: H2, O2, H2O, OH, H, O, N2 with SST
and Schmidt diffusion, 13 equations, 11x11 flow blocks), a species count
above the sweep kernels' base libraries (on the card the ``_ns7``
libraries), against aither_tpu on the generated two-block plate,
perturbed:

1. K1: the plain forward + backward scalar and block sweep pairs against
   the JAX package's Pallas sweep in interpret mode (its multispecies
   forms, any species count), without and with the lagged term (1e-10
   per equation);
2. the slice: one full lusgs and one full blusgs iteration against the
   JAX Solver (prims and L2 1e-10, matrix residual 1e-9): the lusgs one
   through its scan path, the blusgs one through its Pallas sweep in
   interpret mode, whichever compiles sooner on the CPU (72 against 84 s
   for lusgs, 115 against 175 s for blusgs, cold).

One JAX Solver compiles per solver, with ``quick_jax_compiles``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import (check_one_iteration,  # noqa: E402
                                check_sweep_pair, solver_pair, sweep_inputs)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

H2AIR7 = cases.MIXTURES["h2air7_frozen"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("h2air7"), scan=True,
                       **H2AIR7)


@pytest.fixture(scope="module")
def pair_blusgs(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("h2air7_blusgs"),
                       matrix_solver="blusgs", **H2AIR7)


def test_deck_is_a_seven_species_sst_mixture(pair, pair_blusgs):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    js, ts = pair
    assert (ts.phys.ns, ts.phys.neq, ts.phys.nturb) == (7, 13, 2)
    assert (js.phys.ns, js.phys.neq) == (7, 13)
    assert abs(sum(H2AIR7["mass_fractions"]) - 1.0) < 1e-15
    assert ls.sweep_form(ts.phys, ts.cfg) == (7, 13, True, False, False,
                                              False)
    assert ls.form_library(ts.phys, ts.cfg) == "lusgs_sweep_ns7"
    _, tb = pair_blusgs
    assert ls.form_library(tb.phys, tb.cfg) == "blusgs_sweep_ns7"


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_scalar_sweep_pair_matches_pallas_kernel(pair, with_extra):
    js, ts = pair
    check_sweep_pair(js, ts, sweep_inputs(ts), with_extra)


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_block_sweep_pair_matches_pallas_kernel(pair_blusgs,
                                                      with_extra):
    js, ts = pair_blusgs
    inputs = sweep_inputs(ts)
    assert inputs[0]["inv_f"].shape[0] == 11 * 11
    check_sweep_pair(js, ts, inputs, with_extra)


def test_one_iteration(pair):
    check_one_iteration(*pair)


def test_one_iteration_blusgs(pair_blusgs):
    check_one_iteration(*pair_blusgs)
