"""PyTorch port, the slice's main path: the SST plate with WENO-Z face
reconstruction (``faceReconstruction: wenoZ``: three ghost layers) and
scalar LU-SGS against aither_tpu, whose sweep runs through its Pallas
kernel and whose viscous residual through its fused Pallas march, both in
interpret mode (its Solver keeps both kernels on at three ghost layers):
one full iteration (prims and L2 1e-10, matrix residual 1e-9) and a
5-iteration raw L2 history (1e-8), the tolerances of
tests/test_torch_slice.py.  One JAX Solver compiles, with
``quick_jax_compiles``.

The other WENO, AUSMPW+ and centralFourth decks are
tests/test_torch_physics5b_schemes.py; the thermally perfect ones
test_torch_physics5b_tp.py and _tpmix.py; function-level checks
test_torch_recon.py and test_torch_thermo.py.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_history,  # noqa: E402
                                check_one_iteration, enable_jax_march,
                                quick_jax_compiles, solver_pair)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with quick_jax_compiles():
        js, ts = solver_pair(tmp_path_factory.mktemp("wenoz"),
                             face_reconstruction="wenoZ")
        yield enable_jax_march(js), ts


def test_deck_has_three_ghost_layers(pair):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    js, ts = pair
    assert ts.cfg["recon"] == js.cfg["recon"] == "wenoZ"
    assert [b.g for b in ts.case.blocks] == [3, 3]
    assert ls.sweep_form(ts.phys, ts.cfg) == ls.SST_FORM


def test_one_iteration(pair):
    with quick_jax_compiles():
        check_one_iteration(*pair)


def test_residual_history(pair):
    with quick_jax_compiles():
        check_history(*pair)
