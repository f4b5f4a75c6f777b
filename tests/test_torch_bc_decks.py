"""PyTorch port, the boundary conditions on a whole deck against
aither_tpu: the generated plate (``cases.write_plate_case``, SST k-omega
lusgs, 2 x 12x8x3 cells) with every new boundary of chip_smoke.py phase
13's SST decks at once: a stagnation inlet, a nonreflecting (LODI)
pressure outlet with the ``bc_aux`` carry, periodic k faces (a block
periodic with itself) and the wall law.  One deck, because each JAX
Solver compile costs about a minute here and the suite has a clock; the
inlet's LODI form, the other layouts and the wall law's other walls are
held at function level (tests/test_torch_boundaries.py), on the card by
phase 13, and cuda against cpu by phase 6.

Ghosts (1e-12, the same float64 formulas in the same order): the full
fill of the deck decomposed for four processes, from a random carry and
time-n state; the viscous ghost pass with its stored wall values (1e-10:
the Ridder iteration, tests/test_torch_boundaries.py).

Solver (the tolerances of tests/test_torch_slice.py; the JAX side on its
scan sweep path, one compile, ``quick_jax_compiles``): one iteration
(1e-10), after checking that every wall face takes the wall law (the
share of the wall faces at y+ >= 10, and of those whose root the Ridder
bracket [10, 1e4] holds, printed and asserted 1: the JAX package's wall
law cannot take its y+ < 10 low-Re switch, and a face whose root lies
below 10 is set to y+ = 1e4 and turns the run to NaN; see
``cases.WALL_LAW_CLUSTER``); then three steps from the JAX package's
carry after one step, handed across by ``Solver.set_state``: the raw L2
(1e-8) and the carried dt and pressure and velocity gradients (1e-8 of
their scale) after every step.

Decks: every default of ``write_plate_case`` writes the deck and grid of
before the boundary keywords byte for byte (their SHA-256); the command
line runs the deck and the Mach-2 plate (the supersonic pair) on the
CPU, for one, two and four processes; a deck with an unknown boundary
type raises the JAX package's ValueError; no refusal is left in the
port's sources.
"""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch.cases import (AIR5, N2O2, TEST_DIMS,  # noqa: E402
                                    TIME_INTEGRATORS, write_plate_case)
from tests.torch_parity import (check_one_iteration, jax_step,  # noqa: E402
                                np_, perturbed_prims, quick_jax_compiles,
                                rel_err, solver_pair, write_case)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

# one deck with every new boundary of chip_smoke.py phase 13's SST decks:
# a stagnation inlet, a nonreflecting (LODI) pressure outlet, periodic k
# faces and the wall law (each of those decks compiles for about a minute
# in the JAX package; one deck keeps the file inside its clock)
DECK = dict(inflow="stagnationInlet", outflow="pressureOutlet",
            nonreflecting=True, span="periodic", wall_treatment="wallLaw")
SUPERSONIC = dict(inflow="supersonicInflow", outflow="supersonicOutflow",
                  velocity=680.0, equation_set="euler",
                  turbulence_model="none")


@pytest.fixture(scope="module", autouse=True)
def _quick_compiles():
    with quick_jax_compiles():
        yield


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX Solver, port Solver) of DECK from one perturbed state"""
    return solver_pair(tmp_path_factory.mktemp("deck"), scan=True, **DECK)


def _close(got, want, tol, what):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(want)), what
    for e in range(want.shape[0]):
        assert rel_err(got[e], want[e]) < tol, (what, e, rel_err(got[e],
                                                               want[e]))


def _cases(tmp_path, nproc=1, **deck):
    from aither_tpu.solver import case as jcase
    from aither_tpu_torch.solver import case as tcase
    path = write_case(tmp_path, **deck)
    return (jcase.build_case(path, nproc=nproc),
            tcase.build_case(path, "cpu", nproc=nproc))


def test_ghosts_with_carry(tmp_path):
    """the full ghost fill of DECK decomposed for four processes (each
    block and its periodic connection split in two along i), its LODI
    outlet from a random carry and time-n state"""
    from aither_tpu.solver import step as jstep
    from aither_tpu_torch.solver import state as tst
    from aither_tpu_torch.solver import step as tstep
    jc, tc = _cases(tmp_path, 4, **DECK)
    assert len(jc.blocks) == len(tc.blocks) == 4
    assert sum(not c.is_interblock for c in tc.connections) == 4
    rng = np.random.default_rng(21)
    carry, cons_n = {}, {}
    for b in tc.blocks:
        shp = (b.ni, b.nj, b.nk)
        carry[b.index] = dict(dt=0.01 + 0.1 * rng.random(shp),
                              pgrad=0.1 * rng.standard_normal((3,) + shp),
                              vgrad=rng.standard_normal((3, 3) + shp))
        cons = tst.cons_from_prim(tc.phys, b.prim0[b.interior]).numpy()
        cons_n[b.index] = cons * (1.0 + 0.01 * rng.random(cons.shape))
    prims = perturbed_prims(jc.blocks)
    want = jax.jit(lambda p: jstep.apply_all_bcs(
        jc.phys, jc, p,
        bc_aux={b: {k: jnp.asarray(v) for k, v in a.items()}
                for b, a in carry.items()},
        cons_n={b: jnp.asarray(v) for b, v in cons_n.items()}))(
        {b: jnp.asarray(v) for b, v in prims.items()})
    got = tstep.apply_all_bcs(
        tc.phys, tc, {b: torch.as_tensor(v) for b, v in prims.items()},
        bc_aux={b: {k: torch.as_tensor(v) for k, v in a.items()}
                for b, a in carry.items()},
        cons_n={b: torch.as_tensor(v) for b, v in cons_n.items()})
    for b in prims:
        _close(got[b], want[b], 1e-12, f"block {b}")


def test_ghosts_wall_law(pair):
    """the viscous ghost pass after the full fill, and the wall values it
    stores"""
    from aither_tpu.solver import step as jstep
    from aither_tpu_torch.solver import step as tstep
    js, ts = pair
    filled = tstep.apply_all_bcs(ts.phys, ts.case, dict(ts.prims))
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        def fill(p, jb=jb):
            wall = {}
            p = jstep.apply_boundary_ghosts(js.phys, jb, p, viscous_pass=True,
                                            cfg=js.cfg, wall_data=wall)
            return p, list(wall.values())
        jp, jw = jax.jit(fill)(jnp.asarray(filled[tb.index].numpy()))
        tw = {}
        tp = tstep.apply_boundary_ghosts(ts.phys, tb, filled[tb.index],
                                         viscous_pass=True, cfg=ts.cfg,
                                         wall_data=tw)
        _close(tp, jp, 1e-10, f"viscous ghosts block {tb.index}")
        assert len(jw) == len(tw) == 1
        (tw,) = tw.values()
        for key, w in jw[0].items():
            w, g = np_(w), np_(tw[key])
            if key == "low_re":
                np.testing.assert_array_equal(g, w)
            else:
                _close(g.reshape((-1,) + g.shape[-2:]),
                       w.reshape((-1,) + w.shape[-2:]), 1e-10, key)


def wall_law_shares(ts):
    """(share of the wall faces at y+ >= 10, share whose wall-law root is
    bracketed in [10, 1e4)) of the port solver's state"""
    from aither_tpu_torch.solver import step as tstep
    from aither_tpu_torch.solver import wall_law
    prims = tstep.apply_all_bcs(ts.phys, ts.case, dict(ts.prims))
    yplus = []
    for b in ts.case.blocks:
        wall = {}
        tstep.apply_boundary_ghosts(ts.phys, b, prims[b.index],
                                    viscous_pass=True, cfg=ts.cfg,
                                    wall_data=wall)
        yplus += [v["yplus"].reshape(-1) for v in wall.values()]
    y = torch.cat(yplus)
    return (float((y >= 10.0).double().mean()),
            float((y < wall_law.YPLUS_HI).double().mean()))


def test_one_iteration(pair):
    js, ts = pair
    assert ts.cfg["need_pgrad"] and js.cfg["need_pgrad"]
    at_10, bracketed = wall_law_shares(ts)
    print(f"wall faces at y+ >= 10 {at_10:.3f}, root bracketed "
          f"{bracketed:.3f}")
    # every face takes the wall law (cases.WALL_LAW_CLUSTER)
    assert at_10 == bracketed == 1.0
    check_one_iteration(js, ts)


def test_history_with_carry(pair):
    """three steps from the JAX carry after one step, handed across"""
    js, ts = pair
    js.bc_aux = js._zero_bc_aux()
    jax_step(js, 0)                           # the carry of one step
    assert float(jnp.abs(js.bc_aux[0]["pgrad"]).max()) > 0.0
    ts.set_state({b: np_(v) for b, v in js.prims.items()},
                 {b: np_(v) for b, v in js.cons_n.items()},
                 bc_aux={b: {k: np_(v) for k, v in a.items()}
                         for b, a in js.bc_aux.items()})
    for step in range(3):
        # a run of one step takes the CFL of step 0: the JAX side too
        js.cons_n = js.store_old_solution()
        js.prims, l2, _ = jax_step(js, 0)
        ts.run(iterations=1)
        got = ts.l2_history[-1]
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, np.sqrt(l2), rtol=1e-8)
        for b in ts.bc_aux:
            for key in ("dt", "pgrad", "vgrad"):
                g, w = np_(ts.bc_aux[b][key]), np_(js.bc_aux[b][key])
                assert rel_err(g, w) < 1e-8, (step, b, key)
        print(f"step {step}: wall faces at y+ >= 10, root bracketed "
              f"{wall_law_shares(ts)}")


# ---------------------------------------------------------------------------
# the decks and the command line


# SHA-256 of plate.inp and plate.xyz (2 x 12x8x3) as the deck writer gave
# them before the boundary keywords
DEFAULT_HASHES = {
    "sst": "810459b31a3dbb7e4209bfa4d8409e96c3f18b14c7a085a3498dfdfb8cdb2e8d",
    "euler": ("76a5084b4527e60dce87f9c0b65db11cfbeb9ecd0fe16b94b7c6b50a9a04"
              "5fef"),
    "n2o2": "30e883426fd013a2d9fed90ae3eeb97b68fedf220e88a4770b2abe47c4195c74",
    "air5": "4c2fd2457d54b11fc96aa990bf27b103214fa8931fcc3947375793feeeae7b6a",
    "blusgs_mg2": ("babc5cee7cd45964734c330bc84ca7936522c9156b7e31497cb9e63968"
                   "7bd4b2"),
}
GRID_HASH = "c496ce523c726a1ffb22195a5a7fe66ae26c31d420119e2b747e49437d2141ce"
DEFAULT_DECKS = {"sst": {},
                 "euler": dict(equation_set="euler", turbulence_model="none"),
                 "n2o2": N2O2, "air5": AIR5,
                 "blusgs_mg2": dict(matrix_solver="blusgs",
                                    multigrid_levels=2)}


@pytest.mark.parametrize("name", sorted(DEFAULT_DECKS))
def test_default_decks_unchanged(tmp_path, name):
    path = write_plate_case(str(tmp_path), *TEST_DIMS, **DEFAULT_DECKS[name])
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == DEFAULT_HASHES[name]
    with open(os.path.join(str(tmp_path), "plate.xyz"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == GRID_HASH


@pytest.mark.parametrize("layout", ["deck", "supersonic"])
def test_cli_runs_each_layout(tmp_path, monkeypatch, layout):
    """DECK and the Mach-2 plate, for one, two and four processes (four
    split each block)"""
    from aither_tpu_torch.main import main
    path = write_plate_case(str(tmp_path), 8, 6, 2,
                            **(SUPERSONIC if layout == "supersonic"
                               else DECK))
    monkeypatch.chdir(tmp_path)
    for nproc in ("1", "2", "4"):
        assert main([path, "--device", "cpu", "--iterations", "2",
                     "--no-files", "--nproc", nproc]) == 0
        with open(tmp_path / "plate.resid") as f:
            rows = [ln.split() for ln in f if ln.strip()][1:]
        assert len(rows) == 2
        assert all(np.isfinite(float(v)) for v in rows[-1][3:8])


def test_unknown_boundary_type_raises(tmp_path):
    """as the JAX package: a ValueError from the ghost pass"""
    from aither_tpu.solver import bc as jbc
    from aither_tpu_torch.solver.driver import Solver
    path = write_plate_case(str(tmp_path), 4, 3, 2,
                            **TIME_INTEGRATORS["implicitEuler"])
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("characteristic  0 0 0", "fooWall  0 0 0"))
    ts = Solver(path, device="cpu", workdir=str(tmp_path))
    with pytest.raises(ValueError, match="unsupported BC type 'fooWall'"):
        ts.run(iterations=1)
    with pytest.raises(ValueError, match="unsupported BC type 'fooWall'"):
        jbc.ghost_state(None, "fooWall", None, None, None, 1)


def test_boundary_refusals_are_gone():
    """the boundaries, and every other deck setting of the JAX package,
    run: the port has no refusal module left (its last two items, the
    card's thermally perfect approximateRoe sweeps and species counts
    above 5, have libraries of their own), and no raise in its sources is
    a NotImplementedError or names a ROADMAP.md item"""
    import importlib.util
    from tests.torch_parity import port_refusals
    assert importlib.util.find_spec("aither_tpu_torch.unsupported") is None
    assert port_refusals() == []