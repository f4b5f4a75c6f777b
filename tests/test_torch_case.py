"""PyTorch port, case and ghost parity with aither_tpu on the generated
two-block SST plate: geometry, wall distance, initial state, boundary and
edge ghosts, the connection swap, plus the port's import boundary (no
jax, no aither_tpu) and the deck settings it admits.

Tolerances: geometry comes from the same host code (exact); the wall
distance from a brute-force search in torch against the JAX package's
k-d tree (both exact nearest distances, rtol 1e-13 for the sqrt).  Ghost
states are the same float64 formulas in the same order (rtol 1e-12).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (assert_close, jax_solver,  # noqa: E402
                                perturbed_prims, torch_solver, write_case)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    wd = tmp_path_factory.mktemp("plate")
    path = write_case(wd)
    return jax_solver(path, wd), torch_solver(path, wd)


def test_geometry_and_wall_distance(pair):
    js, ts = pair
    assert len(js.case.blocks) == len(ts.case.blocks) == 2
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        assert (jb.ni, jb.nj, jb.nk, jb.g) == (tb.ni, tb.nj, tb.nk, tb.g)
        for key, want in jb.geom_host.items():
            got = tb.geom[key]
            assert got.device.type == "cpu" and got.dtype == torch.float64
            if key == "wall_dist":
                assert_close(got, want, 1e-13, 0.0, key)
            else:
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=key)
        assert_close(tb.prim0, jb.prim0, 1e-14, 0.0, "prim0")


def test_connection_swap(pair):
    """random fields through every connection: the host-built index maps
    against the JAX package's slab swap."""
    from aither_tpu.solver import step as jstep
    from aither_tpu_torch.solver import step as tstep
    js, ts = pair
    rng = np.random.default_rng(3)
    fields = {b.index: rng.random((3,) + b.shape) for b in js.case.blocks}
    want = {b: jnp.asarray(f) for b, f in fields.items()}
    for conn in js.case.connections:
        want = jstep.swap_connection_states(js.phys, js.case.blocks, want,
                                            conn, js.case.blocks[0].g)
    got = tstep.swap_connections(
        {b: torch.as_tensor(f) for b, f in fields.items()},
        ts.case.swap_maps)
    for b in fields:
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want[b]))


@pytest.mark.parametrize("what", ["boundary", "boundary_viscous", "edge",
                                  "edge_viscous", "all"])
def test_ghosts(pair, what):
    from aither_tpu.solver import step as jstep
    from aither_tpu_torch.solver import step as tstep
    js, ts = pair
    prims = perturbed_prims(js.case.blocks)
    if what == "all":
        want = jax.jit(lambda p: jstep.apply_all_bcs(js.phys, js.case, p))(
            {b: jnp.asarray(v) for b, v in prims.items()})
        got = tstep.apply_all_bcs(
            ts.phys, ts.case, {b: torch.as_tensor(v)
                               for b, v in prims.items()})
        for b in prims:
            assert_close(got[b], want[b], 1e-12, 0.0, what)
        return
    viscous = what.endswith("viscous")
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        jfn = (jstep.apply_boundary_ghosts if what.startswith("boundary")
               else jstep.apply_edge_ghosts)
        tfn = (tstep.apply_boundary_ghosts if what.startswith("boundary")
               else tstep.apply_edge_ghosts)
        kw = dict(cfg=js.cfg, wall_data={}) if (
            viscous and what.startswith("boundary")) else {}
        want = jax.jit(lambda p: jfn(js.phys, jb, p, viscous_pass=viscous,
                                     **kw))(jnp.asarray(prims[jb.index]))
        got = tfn(ts.phys, tb, torch.as_tensor(prims[tb.index]),
                  viscous_pass=viscous)
        assert_close(got, want, 1e-12, 0.0, f"{what} block {tb.index}")


@pytest.mark.parametrize("blocked", ["jax", "aither_tpu"])
def test_port_never_imports_jax(tmp_path, blocked):
    """The port builds and runs a case (decomposed, with matrixSweeps: 2)
    with jax, or the JAX package, unimportable, and loads neither."""
    code = (
        "import sys\n"
        f"sys.modules[{blocked!r}] = None\n"
        "from aither_tpu_torch.cases import write_plate_case\n"
        "from aither_tpu_torch.solver.driver import Solver\n"
        f"p = write_plate_case({str(tmp_path)!r}, 4, 3, 2,\n"
        "                     matrix_sweeps=2)\n"
        f"s = Solver(p, device='cpu', workdir={str(tmp_path)!r}, nproc=2)\n"
        "s.run(iterations=1)\n"
        "assert not any(m.split('.')[0] in ('jax', 'aither_tpu')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('NOJAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


def _patched_case(tmp_path, patch):
    """the generated deck with one setting replaced or added"""
    import re
    path = write_case(tmp_path, (4, 3, 2))
    key, val = patch
    with open(path) as f:
        text = f.read()
    line = f"{key}: {val}"
    if re.search(rf"(?m)^{key}:", text):
        text = re.sub(rf"(?m)^{key}:.*$", line, text)
    else:
        text = line + "\n" + text
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.mark.parametrize("patch", [
    pytest.param(("faceReconstruction", "weno"), id="patch4"),
    pytest.param(("inviscidFlux", "ausm"), id="patch5"),
    pytest.param(("viscousFaceReconstruction", "centralFourth"),
                 id="patch7"),
    pytest.param(("thermodynamicModel", "thermallyPerfect"), id="patch8")])
def test_admits_the_remaining_physics(tmp_path, patch):
    """WENO, AUSM, centralFourth and the thermally perfect gas, refused
    until the port covered them: the deck check admits each and the CPU
    solver builds (WENO with three ghost layers, centralFourth two)"""
    from aither_tpu_torch.io.deck import parse_deck
    from aither_tpu_torch.solver.driver import Solver, check_supported
    path = _patched_case(tmp_path, patch)
    check_supported(parse_deck(path).finalize())
    ts = Solver(path, device="cpu", workdir=str(tmp_path))
    key, val = patch
    assert str(ts.deck[key]) == val
    assert ts.case.blocks[0].g == (3 if val == "weno" else 2)


@pytest.mark.parametrize("patch", [
    ("matrixSolver", "bdplur"), ("matrixSolver", "dplur"),
    ("inviscidFluxJacobian", "approximateRoe"),
    ("timeIntegration", "bdf2"), ("multigridLevels", "2"),
    ("multigridCycle", "W")])
def test_admits_settings_of_the_slice(tmp_path, patch):
    """the linear solvers, time integrators and multigrid settings the
    port covers since they were refused: the deck check admits each and
    the CPU solver builds"""
    from aither_tpu_torch.io.deck import parse_deck
    from aither_tpu_torch.solver.driver import Solver, check_supported
    path = _patched_case(tmp_path, patch)
    check_supported(parse_deck(path).finalize())
    ts = Solver(path, device="cpu", workdir=str(tmp_path))
    key, val = patch
    assert str(ts.deck[key]) == val


def test_cli_requires_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    from aither_tpu_torch.main import main
    path = write_case(tmp_path, (4, 3, 2))
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main([path, "--iterations", "1"])
    assert main([path, "--device", "cpu", "--iterations", "2",
                 "--no-files"]) == 0
    with open(tmp_path / "plate.resid") as f:
        rows = [ln for ln in f if ln.strip()]
    assert len(rows) == 3          # header + one row per iteration


def test_decomposed_case_geometry_and_ghosts(tmp_path):
    """--nproc 4 splits the plate in j too (4 blocks, 4 connections meeting
    at corners): geometry and the full ghost fill match the JAX package's
    decomposed case."""
    from aither_tpu.solver import case as jcase
    from aither_tpu.solver import step as jstep
    from aither_tpu_torch.solver import step as tstep
    from aither_tpu_torch.solver.driver import Solver
    path = write_case(tmp_path, (6, 12, 4))
    jc = jcase.build_case(path, nproc=4)
    ts = Solver(path, device="cpu", workdir=str(tmp_path), nproc=4)
    assert len(jc.blocks) == len(ts.case.blocks) == 4
    assert len(jc.connections) == len(ts.case.connections) == 4
    for jb, tb in zip(jc.blocks, ts.case.blocks):
        assert (jb.ni, jb.nj, jb.nk, jb.parent) == (tb.ni, tb.nj, tb.nk,
                                                     tb.parent)
        for key, want in jb.geom_host.items():
            assert_close(tb.geom[key], want, 1e-13, 0.0, key)
    prims = perturbed_prims(jc.blocks)
    want = jax.jit(lambda p: jstep.apply_all_bcs(jc.phys, jc, p))(
        {b: jnp.asarray(v) for b, v in prims.items()})
    got = tstep.apply_all_bcs(ts.phys, ts.case,
                              {b: torch.as_tensor(v)
                               for b, v in prims.items()})
    for b in prims:
        assert_close(got[b], want[b], 1e-12, 0.0, f"block {b}")
