"""PyTorch port, restart files and point-cloud initial conditions: the
port reads the JAX package's .rst into the JAX package's ``_load_restart``
state and writes the same bytes from the same state, which the JAX
package reads back; a run resumed from its own .rst continues the
uninterrupted run (implicit Euler, and BDF2 with its time n-1 solution
from the file), also across process counts; and a point-cloud initial
condition gives the JAX package's initial state.  No JAX iteration runs:
the JAX side builds its Solver or case only.

Tolerances: the state a restart loads and the cloud initial states are
compared bit for bit (the same host code on the same bytes); a resumed
run's raw residual L2 is held to 1e-8 relative of the uninterrupted
run's, the history bound of the parity tests: the .rst stores the state
dimensional, and its round trip changes the last bits of the state the
resumed run starts from.  The decks keep their CFL constant: a resumed
run starts the CFL ramp again at its first step, as in the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aither_tpu_torch.cases import TIME_INTEGRATORS  # noqa: E402
from tests.torch_parity import np_, perturbed_prims, write_case  # noqa: E402

CFL = (50.0, 0.0, 50.0)
L2_FIRST = np.array([3.5e-3, 2.0e-1, 4.0e-2, 1.0e-3, 6.0e2, 8.0e-3, 9.0e1])


def _tsolver(path, wd, **kw):
    from aither_tpu_torch.solver.driver import Solver
    return Solver(path, device="cpu", workdir=str(wd), **kw)


def _jsolver(path, wd, **kw):
    from aither_tpu.solver.driver import Solver
    return Solver(path, workdir=str(wd), **kw)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(deck, dir, JAX .rst, port .rst): the same perturbed state and
    l2_first written at iteration 3 by each package"""
    import jax.numpy as jnp
    wd = tmp_path_factory.mktemp("rst")
    path = write_case(wd)
    js = _jsolver(path, wd)
    prims = perturbed_prims(js.case.blocks)
    js.prims = {b: jnp.asarray(v) for b, v in prims.items()}
    js.l2_first = L2_FIRST.copy()
    js.sim_root = str(wd / "jax")
    js.write_restart(3)
    ts = _tsolver(path, wd)
    ts.set_state(prims)
    ts.l2_first = L2_FIRST.copy()
    ts.sim_root = str(wd / "port")
    ts.write_restart(3)
    return path, wd, wd / "jax_3.rst", wd / "port_3.rst"


def _loaded_state(js, ts):
    assert js.iteration_start == ts.iteration_start == 3
    np.testing.assert_array_equal(ts.l2_first, js.l2_first)
    for b in ts.case.blocks:
        np.testing.assert_array_equal(np_(ts.prims[b.index]),
                                      np_(js.prims[b.index]))


def test_same_bytes_from_the_same_state(written):
    _, _, jrst, trst = written
    assert jrst.read_bytes() == trst.read_bytes()


@pytest.mark.parametrize("which", ["jax", "port"])
def test_both_load_either_file(written, which):
    """each package's Solver resumes from the file either wrote, into the
    same padded state, iteration and residual normalisation"""
    from aither_tpu.io.restart import read_restart as jread
    path, wd, jrst, trst = written
    rst = str(jrst if which == "jax" else trst)
    rec = jread(rst)
    assert rec["iteration"] == 3 and len(rec["blocks"]) == 2
    _loaded_state(_jsolver(path, wd, restart_path=rst),
                  _tsolver(path, wd, restart_path=rst))


def test_port_resumes_the_jax_file_and_writes(written, tmp_path,
                                              monkeypatch):
    """the CLI resumes from the JAX package's file: steps 3 and 4 in the
    appended .resid, output at 3, 4 and 5"""
    import shutil
    from aither_tpu_torch.main import main
    _, _, jrst, _ = written
    write_case(tmp_path, output_frequency=1)
    shutil.copy(jrst, tmp_path / "jax_3.rst")
    monkeypatch.chdir(tmp_path)
    assert main(["plate.inp", "jax_3.rst", "--device", "cpu",
                 "--iterations", "2"]) == 0
    with open(tmp_path / "plate.resid") as f:
        steps = [int(ln.split()[0]) for ln in f
                 if ln.strip() and not ln.startswith("Step")]
    assert steps == [3, 4]
    for it in (3, 4, 5):
        assert (tmp_path / f"plate_{it}_center.fun").is_file()
    assert not (tmp_path / "plate_5.rst").exists()   # restartFrequency 0


def _resid_ints(path):
    """(step, nonlinear iteration, max equation, block, i, j, k) rows"""
    with open(path) as f:
        rows = [ln.split() for ln in f if ln.strip()
                and not ln.startswith("Step")]
    return [(r[0], r[1]) + tuple(r[-7:-2]) for r in rows]


@pytest.mark.parametrize("integrator", ["implicitEuler", "bdf2"])
def test_restart_continues_the_run(tmp_path, integrator):
    """4 steps against 2 steps, the .rst written at step 2, and 2 steps
    resumed from it: raw L2 within 1e-8, the .resid's integer columns of
    steps 2-3 equal, l2_first the file's; bdf2 takes its time n-1
    solution from the file"""
    deck = dict(TIME_INTEGRATORS[integrator], cfl=CFL)
    deck["restart_frequency"] = 2
    whole = _tsolver(write_case(tmp_path / "whole", **deck),
                     tmp_path / "whole")
    whole.set_state(perturbed_prims(whole.case.blocks))
    whole.run(iterations=4)
    first = _tsolver(write_case(tmp_path / "first", **deck),
                     tmp_path / "first")
    first.set_state(perturbed_prims(first.case.blocks))
    first.run(iterations=2, write_files=True)
    rst = str(tmp_path / "first" / "plate_2.rst")
    resumed = _tsolver(str(tmp_path / "first" / "plate.inp"),
                       tmp_path / "first", restart_path=rst)
    if integrator == "bdf2":
        assert resumed._nm1_carried
        for b in resumed.case.blocks:
            np.testing.assert_allclose(np_(resumed.cons_nm1[b.index]),
                                       np_(first.cons_nm1[b.index]),
                                       rtol=1e-14, atol=0)
    resumed.run(iterations=2)
    np.testing.assert_array_equal(resumed.l2_first, first.l2_first)
    nl = resumed.deck["nonlinearIterations"]
    np.testing.assert_allclose(np.asarray(resumed.l2_history),
                               np.asarray(whole.l2_history[2 * nl:]),
                               rtol=1e-8)
    got = _resid_ints(tmp_path / "first" / "plate.resid")
    want = _resid_ints(tmp_path / "whole" / "plate.resid")
    assert len(got) == 4 * nl and got == want


@pytest.mark.parametrize("nproc,then", [(2, 1), (4, 1), (1, 4)])
def test_restart_across_process_counts(tmp_path, nproc, then):
    """a .rst written by a run on ``nproc`` processes (4: each block split
    in two) loads under ``then`` into the same cells, bit for bit"""
    from aither_tpu_torch.parallel.decompose import join_cell_arrays
    path = write_case(tmp_path, cfl=CFL)
    s = _tsolver(path, tmp_path, nproc=nproc)
    s.set_state(perturbed_prims(s.case.blocks))
    s.run(iterations=1)
    s.write_restart(1)
    r = _tsolver(path, tmp_path, nproc=then,
                 restart_path=str(tmp_path / "plate_1.rst"))
    assert r.iteration_start == 1
    np.testing.assert_array_equal(r.l2_first, s.l2_first)

    def parent(solver):
        decomp = solver.case.decomp
        arrs = [np_(solver.prims[b.index][b.interior])
                for b in solver.case.blocks]
        return (join_cell_arrays(decomp.splits, arrs)
                if decomp is not None and decomp.splits else arrs)

    want = parent(s)
    got = parent(r)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        # the file's dimensional round trip: a few units in the last place
        np.testing.assert_allclose(g, w, rtol=1e-14, atol=0)


def test_cloud_initial_condition(tmp_path):
    """a point-cloud deck (cases.write_cloud: every point twice, so every
    cell's nearest points tie) gives the JAX package's padded initial
    state bit for bit, whole and decomposed into 4; then it runs"""
    from aither_tpu.solver.case import build_case as jbuild
    from aither_tpu_torch.cases import write_cloud
    from aither_tpu_torch.solver.case import build_case as tbuild
    write_cloud(str(tmp_path / "cloud.dat"))
    path = write_case(tmp_path, ic_file="cloud.dat")
    for nproc in (1, 4):
        want = jbuild(path, nproc=nproc)
        got = tbuild(path, "cpu", nproc=nproc)
        for jb, tb in zip(want.blocks, got.blocks):
            # contiguous: the card's kernels take the state as laid out
            assert tb.prim0.is_contiguous()
            np.testing.assert_array_equal(np_(tb.prim0), np.asarray(jb.prim0))
        states = np.concatenate([np_(b.prim0).reshape(7, -1)
                                 for b in got.blocks], axis=1)
        assert len(np.unique(states[0])) > 10       # many cloud states
    s = _tsolver(path, tmp_path)
    s.run(iterations=1)
    assert np.isfinite(s.l2_history).all()
