"""PyTorch port, FAS multigrid with block LU-SGS: SST blusgs with a
2-level V cycle (``matrixSolver: blusgs``, ``multigridLevels: 2``) against
aither_tpu on the generated plate (2 x 12x8x3 cells, coarsened to 6x4x2).
One whole iteration (1e-10, matrix residual 1e-9), a 5-iteration raw L2
history (1e-8) and the cycle of one iteration stage by stage (1e-10 of
each field's scale; ``torch_parity.check_cycle_stages``).  The coarse
level's block sweeps take the lagged term (variant c+b), the fine ones not
(variant c).  One JAX compile (its scan sweep path, about 3 minutes
here).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_cycle_stages,  # noqa: E402
                                check_history, check_one_iteration,
                                mg_solver_pair)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return mg_solver_pair(tmp_path_factory.mktemp("sst_blusgs_2V"),
                          matrix_solver="blusgs", multigrid_levels=2)


def test_one_iteration(pair):
    check_one_iteration(*pair)


def test_cycle_stages(pair):
    check_cycle_stages(*pair, forced=[1])


def test_history(pair):
    check_history(*pair)
