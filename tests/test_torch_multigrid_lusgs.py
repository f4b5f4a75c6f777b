"""PyTorch port, FAS multigrid with scalar LU-SGS: SST lusgs with a
3-level W cycle (``multigridLevels: 3``, ``multigridCycle: W``) against
aither_tpu on the generated plate (2 x 12x8x3 cells, coarsened to 6x4x2
and 3x2x1).  One whole iteration (1e-10, matrix residual 1e-9), a
5-iteration raw L2 history (1e-8) and the cycle of one iteration stage by
stage (1e-10 of each field's scale; ``torch_parity.check_cycle_stages``):
pre-relaxation, restriction, forcing and its two terms, coarse correction
and prolonged update at every level and visit.  Level 2 is restricted to
twice, so its second visit holds the diagonal carry of a revisited level,
and every coarse correction holds the copy of the restricted update that
the in-place sweeps would otherwise overwrite; the coarse sweeps take the
lagged term (variant b), the fine ones not (variant a).  One JAX compile
(its scan sweep path, about 3.5 minutes here).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import (check_cycle_stages,  # noqa: E402
                                check_history, check_one_iteration,
                                mg_solver_pair)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return mg_solver_pair(tmp_path_factory.mktemp("sst_lusgs_3W"),
                          multigrid_levels=3, multigrid_cycle="W")


def test_one_iteration(pair):
    check_one_iteration(*pair)


def test_cycle_stages(pair):
    # a W cycle of 3 levels: level 1 restricted to once, level 2 twice
    check_cycle_stages(*pair, forced=[1, 2, 2])


def test_history(pair):
    check_history(*pair)
