"""PyTorch port, reacting five-species air (``cases.AIR5``, about 3,900 K)
thermally perfect with block LU-SGS at CFL 1 against aither_tpu (its scan
sweep), one full iteration (prims and L2 within REACTING_RTOL, the bound
of tests/test_torch_reacting_blusgs.py: the block diagonal's
forward-difference chemistry Jacobian differs by libm's ulp between the
packages).  The third deck of tests/test_torch_physics5b_tpmix.py, in a
file of its own so that ``--dist loadfile`` can run it beside the other
two; one JAX Solver compiles, with ``quick_jax_compiles``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.test_torch_physics5b_tpmix import (AIR5_DECK,  # noqa: E402
                                              check_deck)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize("name", ["air5_blusgs"])
def test_one_iteration(tmp_path, name):
    check_deck(tmp_path, *AIR5_DECK)
