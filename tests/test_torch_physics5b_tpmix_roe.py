"""PyTorch port, two thermally perfect approximateRoe decks against
aither_tpu (its scan sweep), one full iteration each (prims and L2 1e-10,
matrix residual 1e-9): hot one-species air with block LU-SGS and N2/O2
with scalar LU-SGS (``ROE_DECKS`` of tests/test_torch_physics5b_tpmix.py,
whose one-species scalar deck stays there; on the card the ``*_roe_tp``
sweep libraries).  A file of its own, so that ``--dist loadfile`` can run
it beside the others.  One JAX Solver compiles per deck, with
``quick_jax_compiles``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.test_torch_physics5b_tpmix import (DECKS, ROE_DECKS,  # noqa: E402
                                              check_deck)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize("name", ROE_DECKS)
def test_one_iteration(tmp_path, name):
    check_deck(tmp_path, *DECKS[name])
