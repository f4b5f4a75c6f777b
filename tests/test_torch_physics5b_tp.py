"""PyTorch port, the thermally perfect gas (``thermodynamicModel:
thermallyPerfect``) on hot one-species air (``cases.TP_AIR``, about
4,000 K, where the vibrational terms are a few percent of the energy) and
the SST plate, against aither_tpu, whose sweep of such a deck is its scan
sweep (``pallas_sweep.use_pallas`` is off for a thermally perfect gas)
and whose viscous residual is its plain one:

1. K1: the port's plain scalar (lusgs, without the lagged term) and block
   (blusgs, with it) sweep pairs against the JAX scan sweeps on a 2 x
   5x4x2 plate, the JAX side run eagerly (``jax.disable_jit``: compiling
   its scan sweep with the Ridder loop in it costs more than running it),
   per equation within 1e-10 of its scale;
2. lusgs: one full iteration (prims and L2 1e-10, matrix residual 1e-9)
   and a 5-iteration raw L2 history, held at HISTORY_RTOL (1e-11, from
   the measured drift);
3. blusgs: one full iteration.

Two JAX Solvers compile, with ``quick_jax_compiles``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from aither_tpu_torch.cases import TP_AIR  # noqa: E402
from tests.torch_parity import (check_history,  # noqa: E402
                                check_one_iteration, check_sweep_pair,
                                quick_jax_compiles, solver_pair,
                                sweep_inputs)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

SWEEP_DIMS = (5, 4, 2)
# the 5-iteration history of the thermally perfect deck: the Ridder
# inversion's last evaluation point (T within a few ulp on both sides)
# passes its roundoff on through every update of the state.  Measured
# here: 5.3e-14 elementwise relative at most over the 5 rows (1.3e-14 of
# a row's largest); the bound leaves about 200x of that for libm and XLA
HISTORY_RTOL = 1e-11


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with quick_jax_compiles():
        yield solver_pair(tmp_path_factory.mktemp("tp_lusgs"), scan=True,
                          **TP_AIR)


def test_deck_is_thermally_perfect(pair):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    js, ts = pair
    assert ts.phys.thermally_perfect
    assert js.phys.thermo_model == "thermallyPerfect"
    assert ls.sweep_form(ts.phys, ts.cfg) == (1, 7, True, False, False,
                                              True)


@pytest.mark.parametrize("block,with_extra", [(False, False), (True, True)])
def test_plain_sweep_pair_matches_the_jax_scan_sweep(tmp_path, block,
                                                     with_extra):
    js, ts = solver_pair(tmp_path, scan=True, dims=SWEEP_DIMS,
                         matrix_solver="blusgs" if block else "lusgs",
                         **TP_AIR)
    assert bool(ts.cfg["block_matrix"]) == block
    with jax.disable_jit():
        check_sweep_pair(js, ts, sweep_inputs(ts), with_extra, scan=True)


def test_one_iteration(pair):
    with quick_jax_compiles():
        check_one_iteration(*pair)


def test_residual_history(pair):
    with quick_jax_compiles():
        check_history(*pair, rtol=HISTORY_RTOL)


def test_one_iteration_blusgs(tmp_path):
    with quick_jax_compiles():
        js, ts = solver_pair(tmp_path, scan=True, matrix_solver="blusgs",
                             **TP_AIR)
        check_one_iteration(js, ts)
