"""PyTorch port, the SST-DES deck (``equationSet: rans``,
``turbulenceModel: sstdes``) against aither_tpu on the generated
two-block plate, perturbed.  SST-DES takes the SST forms of all three
kernels unchanged; what differs is the turbulence source (the DES length
scale in the k destruction and in the source spectral radius) and, for
blusgs, the source Jacobian's ``phi_des``:

1. K2: the port's plain viscous residual against the JAX package's Pallas
   march in interpret mode (the SST branch under the sstdes model name);
2. one full lusgs iteration against the JAX Solver (Pallas sweep,
   interpret mode) and one full blusgs iteration against its scan path:
   prims 1e-10, matrix residual 1e-9;
3. the DES source differs from the SST one on this state (so 2 tests it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_march, check_one_iteration,  # noqa: E402
                                perturbed_prims, solver_pair, viscous_inputs)

DECK = dict(equation_set="rans", turbulence_model="sstdes")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("sstdes"), **DECK)


def test_plain_viscous_residual_matches_pallas_march(pair):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.kernels import viscous_march as vm
    js, ts = pair
    assert ts.phys.turb_model == js.phys.turb_model == "sstdes"
    assert vm.MODELS["sstdes"] == vm.MODELS["sst2003"]
    assert ls.sweep_form(ts.phys, ts.cfg) == ls.SST_FORM
    inputs = viscous_inputs(ts, perturbed_prims(ts.case.blocks))
    check_march(js, ts, inputs, ("vel", "tke", "omega", "mut", "f1", "f2"))


def test_des_source_differs_from_sst(pair):
    import dataclasses
    from aither_tpu_torch.solver import step as tstep
    _, ts = pair
    prims = tstep.apply_all_bcs(ts.phys, ts.case, dict(ts.prims))
    b = ts.case.blocks[0]
    des = tstep.full_residual(ts.phys, ts.cfg, b, prims[b.index])[0]
    sst = tstep.full_residual(
        dataclasses.replace(ts.phys, turb_model="sst2003"),
        dict(ts.cfg, turb_model="sst2003"), b, prims[b.index])[0]
    assert torch.equal(des[:5], sst[:5])
    assert not torch.allclose(des[5], sst[5], rtol=1e-3, atol=0.0)


def test_one_lusgs_iteration(pair):
    check_one_iteration(*pair)


def test_one_blusgs_iteration(tmp_path_factory):
    js, ts = solver_pair(tmp_path_factory.mktemp("sstdes_blusgs"), scan=True,
                         matrix_solver="blusgs", **DECK)
    assert js.cfg["block_matrix"] and ts.cfg["block_matrix"]
    check_one_iteration(js, ts)
