"""PyTorch port, the LES deck (``equationSet: largeEddySimulation``,
``turbulenceModel: wale``: 5 equations with the WALE eddy viscosity)
against aither_tpu on the generated two-block plate:

1. K2: the port's plain viscous residual against the JAX package's Pallas
   march in interpret mode (its WALE branch), every output; ``mut`` is held
   to 1e-13 of its OWN scale (it is ~nondim_scaling times smaller than a
   RANS mut, and the first-iteration residual equals the laminar one to 5
   digits, so the residual alone would not test the branch) and must be
   positive somewhere; again on the unperturbed state, where the velocity
   gradient is at roundoff away from the wall and WALE's quotient
   underflows;
2. K1: the plain scalar sweep pair (5 equations, viscous, mut > 0) against
   the Pallas sweep in interpret mode, without and with the lagged term
   (1e-10 per equation);
3. the slice: one full lusgs iteration against the JAX Solver (Pallas
   sweep, interpret mode) and one full blusgs iteration against its scan
   path: prims 1e-10, matrix residual 1e-9;
4. the .resid header has 5 residual columns.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_march, check_one_iteration,  # noqa: E402
                                check_sweep_pair, perturbed_prims,
                                resid_columns, solver_pair, sweep_inputs,
                                viscous_inputs)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

DECK = dict(equation_set="largeEddySimulation", turbulence_model="wale")
CELLAVG = ("vel", "mut", "f1", "f2")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("les"), **DECK)


def test_deck_is_five_equations_with_wale(pair):
    from aither_tpu_torch.solver import viscous as vis
    js, ts = pair
    assert (ts.phys.neq, ts.phys.nturb, ts.phys.turb_model) == (5, 0, "wale")
    assert ts.cfg["viscous"] and ts.cfg["turbulent"]
    assert ts.phys.turb_prandtl() == js.phys.turb_prandtl() == 0.9
    # only WALE's face statics carry the face length, as a 27th channel
    statics = vis.viscous_statics(ts.case.blocks[0],
                                  vis.needs_face_length(ts.cfg))
    assert statics["face"]["i"].shape[0] == vis.NFACE + 1 == 27
    assert "len" in vis.face_fields(statics, "j")


def test_plain_viscous_residual_matches_pallas_march(pair):
    js, ts = pair
    inputs = viscous_inputs(ts, perturbed_prims(ts.case.blocks))
    cellavg = check_march(js, ts, inputs, CELLAVG)
    for ca in cellavg.values():
        assert ca["mut"].max() > 0.0 and ca["mut"].min() >= 0.0
        assert np.all(ca["f1"] == 1.0) and not ca["f2"].any()


def test_wale_on_a_uniform_field(pair):
    """the unperturbed plate: the velocity gradient is at roundoff away
    from the wall, where S:S and Sd:Sd underflow towards 0 and EPS keeps
    mut finite (test_torch_models holds the exactly-zero gradient)"""
    js, ts = pair
    prims = {b.index: np.array(b.prim0) for b in js.case.blocks}
    cellavg = check_march(js, ts, viscous_inputs(ts, prims), CELLAVG)
    for ca in cellavg.values():
        assert np.all(np.isfinite(ca["mut"]))
        assert 0.0 <= ca["mut"].min() < 1e-40 * ca["mut"].max()


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_scalar_sweep_pair_matches_pallas_kernel(pair, with_extra):
    js, ts = pair
    inputs = sweep_inputs(ts)
    assert "inv_t" not in inputs[0] and inputs[0]["mut"].max() > 0.0
    check_sweep_pair(js, ts, inputs, with_extra)


def test_one_lusgs_iteration(pair):
    check_one_iteration(*pair)


def test_one_blusgs_iteration(tmp_path_factory):
    js, ts = solver_pair(tmp_path_factory.mktemp("les_blusgs"), scan=True,
                         matrix_solver="blusgs", **DECK)
    assert js.cfg["block_matrix"] and ts.cfg["block_matrix"]
    check_one_iteration(js, ts)


def test_resid_header_has_five_residual_columns(pair):
    _, ts = pair
    ts.run(iterations=1)
    assert resid_columns(ts) == ["Res-Mass", "Res-Mom-X", "Res-Mom-Y",
                                 "Res-Mom-Z", "Res-Energy", "Res-Matrix"]
