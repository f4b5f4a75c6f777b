"""PyTorch port, centralFourth viscous face reconstruction
(``viscousFaceReconstruction: centralFourth``: 4-point q with the
turbulence rows 2-point, 4-point mu, the wall distance 2-point) on the SST
plate, scalar LU-SGS, against aither_tpu: one full iteration (prims and
L2 1e-10, matrix residual 1e-9; tests/test_torch_slice.py's tolerances).
Both packages take the plain viscous residual for such a deck (the JAX
package's ``use_march``, the port's ``step.full_residual``); the JAX
sweep runs through its Pallas kernel in interpret mode.  One JAX Solver
compiles, with ``quick_jax_compiles``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_one_iteration,  # noqa: E402
                                quick_jax_compiles, solver_pair)


def test_one_iteration(tmp_path):
    with quick_jax_compiles():
        js, ts = solver_pair(tmp_path,
                             viscous_face_reconstruction="centralFourth")
        assert ts.cfg["viscous_recon"] == js.cfg["viscous_recon"] == (
            "centralFourth")
        assert ts.cfg["turb_model"] == js.cfg["turb_model"] != "none"
        assert [b.g for b in ts.case.blocks] == [2, 2]
        check_one_iteration(js, ts)
