"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages build the generated two-block SST flat plate of
``aither_tpu_torch/cases.py`` (2 x 12x8x3 cells, so the sweeps act in i,
j and k) from one deck; the JAX side runs on the CPU in float64 as the
other tests run it (tests/conftest.py), with its LU-SGS sweep reached
through the Pallas kernel in interpret mode.  Inputs come from
``np.random.default_rng(seed)`` and pass between the packages as numpy.

The unperturbed flat plate has near-zero residual components (mass L2
~1e-19), so every state is first perturbed by up to 1% on its interior
(the pattern of tests/test_shard_sweep.py).
"""

from __future__ import annotations

import numpy as np

from aither_tpu_torch.cases import TEST_DIMS, write_plate_case

SEED = 7


def write_case(tmp_dir, dims=TEST_DIMS, matrix_sweeps=1):
    return write_plate_case(str(tmp_dir), *dims,
                            matrix_sweeps=matrix_sweeps)


def jax_solver(deck_path, workdir):
    """aither_tpu Solver with its sweep on the Pallas kernel (interpret)."""
    from aither_tpu.solver.driver import Solver
    solver = Solver(deck_path, workdir=str(workdir))
    solver.cfg["pallas_interpret"] = True
    return solver


def enable_jax_march(solver):
    """Put aither_tpu's fused viscous march (pallas_residual, interpret
    mode) on its residual path: prepack every block's statics as its
    Solver does at init when the march is on, and rebuild the geometry
    arguments its jitted iteration takes."""
    from aither_tpu.solver import pallas_residual as pres
    solver.cfg["pallas_interpret"] = True
    for b in solver.case.blocks:
        assert pres.use_march(solver.phys, solver.cfg, b, solver.case.dtype,
                              for_prepack=True)
        pres.ensure_static(solver.phys, solver.cfg, b, solver.case.dtype)
    solver._geo_args = solver._build_geo_args()
    return solver


def torch_solver(deck_path, workdir):
    from aither_tpu_torch.solver.driver import Solver
    return Solver(deck_path, device="cpu", workdir=str(workdir))


def perturbed_prims(blocks, seed=SEED):
    """{block: padded numpy prim}: prim0 times (1 + 0.01 U[0,1)) on the
    interior (ghosts untouched)."""
    rng = np.random.default_rng(seed)
    out = {}
    for b in blocks:
        prim = np.array(b.prim0, dtype=np.float64)
        g = b.g
        P = (slice(None), slice(g, g + b.ni), slice(g, g + b.nj),
             slice(g, g + b.nk))
        prim[P] *= 1.0 + 0.01 * rng.random(prim[P].shape)
        out[b.index] = prim
    return out


def np_(x):
    """numpy copy of a JAX array or torch tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, rtol, atol, what):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def rel_err(got, want):
    """max |got - want| / max |want| (scale-relative error)."""
    got, want = np_(got), np_(want)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))
