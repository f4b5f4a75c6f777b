"""PyTorch port, thermally perfect mixtures and the thermally perfect
approximateRoe deck against aither_tpu (its scan sweep: a thermally
perfect deck takes no Pallas sweep there), one full iteration each (prims
and L2 1e-10, matrix residual 1e-9):

- N2/O2 with SST and Schmidt diffusion, scalar LU-SGS (the mixture form);
- reacting five-species air (``cases.AIR5``, about 3,900 K) with block
  LU-SGS at CFL 1 (the CFL the hot-air Roe decks take; the block
  diagonal's forward-difference chemistry Jacobian differs by libm's ulp
  between the packages, tests/test_torch_reacting_blusgs.py: held at
  REACTING_RTOL), in tests/test_torch_physics5b_tpmix_air5.py (a file of
  its own, so that ``--dist loadfile`` can run it beside the other two);
- hot one-species air with the approximateRoe off-diagonal and scalar
  LU-SGS: on the CPU its plain sweep (the CUDA sweeps have no thermally
  perfect Roe form: such a deck is refused on the card, ROADMAP item 5c).

One JAX Solver compiles per deck, with ``quick_jax_compiles``.
"""

import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import (check_one_iteration,  # noqa: E402
                                quick_jax_compiles, solver_pair)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

TP = dict(thermodynamic_model="thermallyPerfect")
# the reacting block deck's bound (tests/test_torch_reacting_blusgs.py)
REACTING_RTOL = 2e-6
DECKS = {
    "n2o2_lusgs": (dict(cases.N2O2, **TP), 1e-10),
    "air_roe_lusgs": (dict(cases.TP_AIR,
                           inviscid_flux_jacobian="approximateRoe"), 1e-10),
}
# tests/test_torch_physics5b_tpmix_air5.py
AIR5_DECK = (dict(cases.AIR5, matrix_solver="blusgs",
                  equation_set="navierStokes", turbulence_model="none",
                  cfl=(1.0, 0.0, 1.0), **TP), REACTING_RTOL)


@pytest.mark.parametrize("name", list(DECKS))
def test_one_iteration(tmp_path, name):
    check_deck(tmp_path, *DECKS[name])


def check_deck(tmp_path, deck, tol):
    """one full iteration of ``deck`` against the JAX Solver's scan path"""
    here = os.getcwd()
    os.chdir(tmp_path)      # the reacting deck reads its mechanism here
    try:
        with quick_jax_compiles():
            js, ts = solver_pair(tmp_path, scan=True, **deck)
            assert ts.phys.thermally_perfect
            check_one_iteration(js, ts, tol=tol, mr_tol=max(tol, 1e-9))
    finally:
        os.chdir(here)
