"""PyTorch port, FAS multigrid (``multigridLevels`` > 1, V and W cycles)
against aither_tpu on the generated plate (2 x 12x8x3 cells).

Host side: ``build_levels`` of three levels, on the plate and on the plate
decomposed for two processes: coarse dims, remapped surfaces and
connections equal, the integer fine->coarse maps exact, ``volfac``,
``prolong``, ``node_factor`` and each coarse block's volumes, centres and
face normals and areas within 1e-13.  Transfer operators
(``restrict_weighted``, ``restrict_sum``, ``prolong``) on random fields
within 1e-14 of the output's scale.

Solver level, laminar dplur at matrixSweeps 2 with a 2-level W cycle (no
sweep kernel in either package): one whole iteration (1e-10, matrix
residual 1e-9) and a 5-iteration raw L2 history (1e-8), the tolerances of
tests/test_torch_slice.py, and the cycle of one iteration stage by stage
(``torch_parity.check_cycle_stages``).  Decomposed for two processes the
plate stays two blocks, so the host checks run for one, two and four
processes; laminar bdplur with a 2-level V cycle runs decomposed for
four.  The scalar and block LU-SGS decks
are tests/test_torch_multigrid_lusgs.py (SST, 3-level W cycle) and
test_torch_multigrid_blusgs.py (SST, 2-level V cycle): each deck's JAX
iteration takes its own 1.5-3.5 minute compile, so they are files of their
own, spread over the test workers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (check_cycle_stages,  # noqa: E402
                                check_history, check_one_iteration,
                                mg_solver_pair, rel_err, write_case)

GEOM_KEYS = ("vol", "center", "n_i", "n_j", "n_k", "mag_i", "mag_j",
             "mag_k")


@pytest.fixture(scope="module", params=[1, 2, 4],
                ids=["nproc1", "nproc2", "nproc4"])
def levels(request, tmp_path_factory):
    """(JAX levels, JAX maps, port levels, port maps) of three levels"""
    from aither_tpu.solver import case as jcase
    from aither_tpu.solver import multigrid as jmg
    from aither_tpu_torch.solver import case as tcase
    from aither_tpu_torch.solver import multigrid as tmg
    nproc = request.param
    wd = tmp_path_factory.mktemp(f"levels{nproc}")
    path = write_case(wd, multigrid_levels=3)
    jl, jm = jmg.build_levels(jcase.build_case(path, nproc=nproc), 3)
    tl, tm = tmg.build_levels(tcase.build_case(path, "cpu", nproc=nproc), 3)
    return jl, jm, tl, tm


def _surfaces(bc):
    return (bc.num_i, bc.num_j, bc.num_k,
            [dataclasses.astuple(s) for s in bc.surfaces])


def test_coarse_cases(levels):
    """the coarse levels' dims, surfaces, connections and geometry"""
    jl, _, tl, _ = levels
    assert len(jl) == len(tl) == 3
    for lvl, (jc, tc) in enumerate(zip(jl, tl)):
        assert len(jc.blocks) == len(tc.blocks)
        assert jc.total_cells == tc.total_cells
        assert len(jc.connections) == len(tc.connections)
        for jb, tb in zip(jc.blocks, tc.blocks):
            assert (jb.ni, jb.nj, jb.nk) == (tb.ni, tb.nj, tb.nk)
            assert _surfaces(jc.bcs[jb.index]) == _surfaces(tc.bcs[tb.index])
            np.testing.assert_array_equal(jc.grids[jb.index],
                                          tc.grids[tb.index])
            if lvl == 0:
                continue
            for key in GEOM_KEYS:
                want = np.asarray(jb.geom_host[key])
                got = tb.geom_host[key]
                assert got.shape == want.shape, key
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-13,
                                           err_msg=f"level {lvl} {key}")


def test_level_maps(levels):
    """fine->coarse cell maps exact, the weights within 1e-13"""
    _, jm, _, tm = levels
    for jmaps, tmaps in zip(jm, tm):
        assert len(jmaps) == len(tmaps)
        for j, t in zip(jmaps, tmaps):
            shape = t.volfac.shape
            for key, m, axes in (("ci", t.mi, (1, 2)), ("cj", t.mj, (0, 2)),
                                 ("ck", t.mk, (0, 1))):
                np.testing.assert_array_equal(
                    np.broadcast_to(np.expand_dims(m, axes), shape),
                    getattr(j, key), err_msg=key)
            for key in ("volfac", "prolong", "node_factor"):
                want, got = np.asarray(getattr(j, key)), getattr(t, key)
                assert got.shape == want.shape, key
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-13,
                                           err_msg=key)


@pytest.mark.parametrize("op", ["restrict_weighted", "restrict_sum",
                                "prolong"])
def test_transfer_operators(levels, op):
    """each operator on random fields at both transitions and blocks,
    within 1e-14 of the output's scale"""
    from aither_tpu.solver import multigrid as jmg
    from aither_tpu_torch.solver import multigrid as tmg
    jl, jm, tl, tm = levels
    rng = np.random.default_rng(11)
    for lvl, (jmaps, tmaps) in enumerate(zip(jm, tm)):
        for jb, cb, j, t in zip(jl[lvl].blocks, jl[lvl + 1].blocks, jmaps,
                                tmaps):
            cshape = (cb.ni, cb.nj, cb.nk)
            shape = (7,) + (cshape if op == "prolong"
                            else (jb.ni, jb.nj, jb.nk))
            x = rng.standard_normal(shape)
            if op == "prolong":
                want = jmg.prolong(jnp.asarray(x), j)
                got = tmg.prolong(torch.as_tensor(x), t)
            else:
                want = getattr(jmg, op)(jnp.asarray(x), j, cshape)
                got = getattr(tmg, op)(torch.as_tensor(x), t, cshape)
            assert tuple(got.shape) == tuple(want.shape)
            assert rel_err(got, want) < 1e-14, (lvl, jb.index,
                                                rel_err(got, want))


# ---------------------------------------------------------------------------
# solver level: laminar dplur with a 2-level W cycle (the scalar and block
# LU-SGS decks are in test_torch_multigrid_lusgs.py / _blusgs.py, one JAX
# compile each)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return mg_solver_pair(tmp_path_factory.mktemp("laminar_dplur_2W"),
                          matrix_solver="dplur", matrix_sweeps=2,
                          equation_set="navierStokes",
                          turbulence_model="none", multigrid_levels=2,
                          multigrid_cycle="W")


def test_one_iteration(pair):
    check_one_iteration(*pair)


def test_cycle_stages(pair):
    check_cycle_stages(*pair, forced=[1])


def test_history(pair):
    check_history(*pair)


def test_decomposed_bdplur_runs(tmp_path):
    """laminar bdplur with a 2-level V cycle on the plate decomposed for
    four processes (each block split in two along i: the coarse level
    coarsens the sub-blocks, joined by the decomposition's connections)
    runs on the CPU with finite residuals.  Its pieces are held to the
    JAX package above (the coarse levels of four processes, the block
    solvers' cycles in test_torch_multigrid_blusgs.py); a JAX Solver of
    the decomposed multigrid deck takes over three minutes to compile
    here."""
    from aither_tpu_torch.solver.driver import Solver
    path = write_case(tmp_path, matrix_solver="bdplur",
                      equation_set="navierStokes", turbulence_model="none",
                      multigrid_levels=2)
    ts = Solver(path, device="cpu", workdir=str(tmp_path), nproc=4)
    assert [len(c.blocks) for c in ts.mg_cases] == [4, 4]
    assert [len(c.swap_maps) for c in ts.mg_cases] == [3, 3]
    assert not ts.plans and ts.cfg["block_matrix"]
    ts.run(iterations=2)
    hist = np.asarray(ts.l2_history)
    assert hist.shape == (2, ts.phys.neq) and np.all(np.isfinite(hist))
    assert np.all(hist[1] > 0.0)
