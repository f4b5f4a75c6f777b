"""PyTorch port, sixteen species: every species of the fluid database and
the tracer ``N2t`` (``cases.MIXTURES["db16_frozen"]``, SST and Schmidt
diffusion, 22 equations), the top species count a deck names (on the card
the ``_ns16`` libraries), against aither_tpu on the generated two-block
plate, perturbed: one full lusgs iteration against the JAX Solver's scan
path (prims and L2 1e-10, matrix residual 1e-9).  Both packages read the
tracer's fluid file, which ``write_plate_case`` writes beside the deck,
from the working directory.  A file of its own, so that ``--dist
loadfile`` can run it beside the others; one JAX Solver compiles, with
``quick_jax_compiles``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import check_one_iteration, solver_pair  # noqa: E402
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

DB16 = cases.MIXTURES["db16_frozen"]


def test_one_iteration(tmp_path, monkeypatch):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    monkeypatch.chdir(tmp_path)
    js, ts = solver_pair(tmp_path, scan=True, **DB16)
    assert (ts.phys.ns, ts.phys.neq, ts.phys.nturb) == (16, 22, 2)
    assert (js.phys.ns, js.phys.neq) == (16, 22)
    assert ls.form_library(ts.phys, ts.cfg) == "lusgs_sweep_ns16"
    check_one_iteration(js, ts)
