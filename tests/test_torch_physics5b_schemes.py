"""PyTorch port, WENO on the Euler plate and AUSMPW+ on the SST plate
(``inviscidFlux: ausm``), scalar LU-SGS, against aither_tpu (its sweep
through the Pallas kernel in interpret mode): one full iteration each
(prims and L2 1e-10, matrix residual 1e-9; tests/test_torch_slice.py's
tolerances).  The Euler plate is a uniform flow with roundoff-level
residuals, so it starts, like every pair, from the 1%-perturbed state.
Two JAX Solvers compile, with ``quick_jax_compiles``.  The centralFourth
deck is tests/test_torch_physics5b_c4.py (a file of its own, so that
``--dist loadfile`` can put it on another worker).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_one_iteration,  # noqa: E402
                                quick_jax_compiles, solver_pair)

DECKS = {
    "weno_euler": dict(face_reconstruction="weno", equation_set="euler",
                       turbulence_model="none"),
    "ausm_sst": dict(inviscid_flux="ausm"),
}


@pytest.mark.parametrize("name", list(DECKS))
def test_one_iteration(tmp_path, name):
    with quick_jax_compiles():
        js, ts = solver_pair(tmp_path, **DECKS[name])
        assert [b.g for b in ts.case.blocks] == (
            [3, 3] if name.startswith("weno") else [2, 2])
        assert ts.cfg["flux"] == js.cfg["flux"]
        check_one_iteration(js, ts)


# the full ghost fills of the plate layouts tests/test_torch_bc_decks.py
# leaves to the function level: the inlet and pressure outlet in their
# LODI forms (SST, with a random carry and time-n state) and the Mach-2
# Euler plate with the supersonic pair, against the JAX package's fill
# (1e-12: the same float64 formulas in the same order)
LAYOUTS = {
    "inlet_lodi": dict(inflow="inlet", outflow="pressureOutlet",
                       nonreflecting=True),
    "mach2": dict(inflow="supersonicInflow", outflow="supersonicOutflow",
                  velocity=680.0, equation_set="euler",
                  turbulence_model="none"),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_full_ghost_fill(tmp_path, layout):
    import jax.numpy as jnp
    import numpy as np
    from aither_tpu.solver import case as jcase
    from aither_tpu.solver import step as jstep
    from aither_tpu_torch.solver import case as tcase
    from aither_tpu_torch.solver import state as tst
    from aither_tpu_torch.solver import step as tstep
    from tests.torch_parity import (assert_close, perturbed_prims,
                                    write_case)
    path = write_case(tmp_path, **LAYOUTS[layout])
    jc, tc = jcase.build_case(path), tcase.build_case(path, "cpu")
    rng = np.random.default_rng(23)
    carry, cons_n = {}, {}
    for b in tc.blocks:
        shp = (b.ni, b.nj, b.nk)
        carry[b.index] = dict(dt=0.01 + 0.1 * rng.random(shp),
                              pgrad=0.1 * rng.standard_normal((3,) + shp),
                              vgrad=rng.standard_normal((3, 3) + shp))
        cons = tst.cons_from_prim(tc.phys, b.prim0[b.interior]).numpy()
        cons_n[b.index] = cons * (1.0 + 0.01 * rng.random(cons.shape))
    prims = perturbed_prims(jc.blocks)
    want = jax.jit(lambda p: jstep.apply_all_bcs(
        jc.phys, jc, p,
        bc_aux={b: {k: jnp.asarray(v) for k, v in a.items()}
                for b, a in carry.items()},
        cons_n={b: jnp.asarray(v) for b, v in cons_n.items()}))(
        {b: jnp.asarray(v) for b, v in prims.items()})
    got = tstep.apply_all_bcs(
        tc.phys, tc, {b: torch.as_tensor(v) for b, v in prims.items()},
        bc_aux={b: {k: torch.as_tensor(v) for k, v in a.items()}
                for b, a in carry.items()},
        cons_n={b: torch.as_tensor(v) for b, v in cons_n.items()})
    for b in prims:
        assert_close(got[b], want[b], 1e-12, 0.0, f"{layout} block {b}")
