"""PyTorch port, hot five-species air (``cases.AIR5``: N2, O2, NO, N, O
at about 3,900 K, laminar, Schmidt diffusion, the inline three-reaction
air5 mechanism, 9 equations) with scalar LU-SGS against aither_tpu on the
generated two-block plate, perturbed.  Both packages find the mechanism in
the working directory, the case's.

1. the chemistry sources move the species residual and nothing else;
2. K1: the plain forward + backward scalar sweep pair against the JAX
   package's Pallas sweep in interpret mode, without and with the lagged
   term (1e-10 per equation);
3. the slice: one full lusgs iteration against the JAX Solver (Pallas
   sweep, interpret mode; prims and L2 1e-10, matrix residual 1e-9): the
   scalar diagonal takes the sources' spectral radius.

The block solver's checks are tests/test_torch_reacting_blusgs.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import (check_one_iteration,  # noqa: E402
                                check_sweep_pair, solver_pair, sweep_inputs)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

DECK = dict(cases.AIR5, equation_set="navierStokes", turbulence_model="none")


def _pair(tmp_path_factory, name, **kw):
    wd = tmp_path_factory.mktemp(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(wd)
        return solver_pair(wd, **DECK, **kw)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _pair(tmp_path_factory, "air5")


def test_deck_reacts(pair):
    import dataclasses
    from aither_tpu_torch.solver import step
    js, ts = pair
    assert (ts.phys.ns, ts.phys.neq, ts.phys.nturb) == (5, 9, 0)
    assert ts.phys.chemistry is not None and js.phys.chemistry is not None
    b = ts.case.blocks[0]
    prim = ts.prims[0]
    # the chemistry sources move the species residual
    with_chem = step.full_residual(ts.phys, ts.cfg, b, prim)[0]
    frozen = step.full_residual(dataclasses.replace(ts.phys, chemistry=None),
                                ts.cfg, b, prim)[0]
    diff = (with_chem - frozen)[:5].abs().max()
    assert float(diff) > 1e-3 * float(frozen[:5].abs().max())
    assert not bool((with_chem - frozen)[5:].abs().max())


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_scalar_sweep_pair_matches_pallas_kernel(pair, with_extra):
    js, ts = pair
    check_sweep_pair(js, ts, sweep_inputs(ts), with_extra)


def test_one_lusgs_iteration(pair):
    check_one_iteration(*pair)
    assert np.isfinite(pair[1].prims[0].numpy()).all()
