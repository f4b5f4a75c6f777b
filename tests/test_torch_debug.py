"""PyTorch port, debug mode and the command line: ``Solver.check_physicality``
(the port of the JAX package's debug-mode guard, tests/test_debug.py's
cases on the port's generated plate), the ``debug`` / ``AITHER_DEBUG``
switch, and the CLI's files, ``--no-files``, ``--debug`` and restart
argument.
No JAX solver is built: these are the port's own behaviours."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aither_tpu_torch.cases import write_plate_case  # noqa: E402

DIMS = (4, 3, 2)


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    return write_plate_case(str(tmp_path_factory.mktemp("debug")), *DIMS)


@pytest.fixture(scope="module")
def solver(plate):
    from aither_tpu_torch.solver.driver import Solver
    return Solver(plate, device="cpu", workdir=str(plate.rsplit("/", 1)[0]),
                  debug=True)


def _seeded(solver, index, value):
    """a copy of the solver's state with interior cell ``index`` (equation,
    i, j, k) of block 0 set to ``value``; returns the saved state"""
    saved = solver.prims
    g = solver.case.blocks[0].g
    e, i, j, k = index
    prim = saved[0].clone()
    prim[e, g + i, g + j, g + k] = value
    solver.prims = dict(saved)
    solver.prims[0] = prim
    return saved


def test_healthy_state_passes(solver):
    solver.check_physicality(0, 0, np.ones(solver.phys.neq))


def test_seeded_nan_aborts_with_location(solver):
    saved = _seeded(solver, (solver.phys.ie, 3, 1, 1), float("nan"))
    try:
        with pytest.raises(FloatingPointError,
                           match=r"pressure nan at iteration 7 "
                                 r"nonlinear-iter 0, block 0, "
                                 r"cell \(3, 1, 1\)"):
            solver.check_physicality(7, 0)
    finally:
        solver.prims = saved


def test_negative_density_aborts(solver):
    saved = _seeded(solver, (0, 0, 0, 0), -1.0)
    try:
        with pytest.raises(FloatingPointError,
                           match=r"non-physical density -1\.0+e\+00 .*"
                                 r"cell \(0, 0, 0\)"):
            solver.check_physicality(0, 0)
    finally:
        solver.prims = saved


def test_nonfinite_residual_aborts(solver):
    with pytest.raises(FloatingPointError, match="non-finite residual"):
        solver.check_physicality(0, 0, np.array([1.0, np.nan, 1.0]))


def test_run_checks_every_iteration_in_debug_mode(solver):
    """run() aborts on the iteration that leaves a non-physical state"""
    saved = _seeded(solver, (solver.phys.ie, 1, 2, 0), float("nan"))
    try:
        with pytest.raises(FloatingPointError,
                           match="at iteration 0 nonlinear-iter 0"):
            solver.run(iterations=2)
    finally:
        solver.prims = saved


@pytest.mark.parametrize("env,arg,want", [
    (None, None, False), ("1", None, True), ("0", None, False),
    ("1", False, False), (None, True, True)])
def test_debug_switch_defers_to_aither_debug(plate, monkeypatch, env, arg,
                                             want):
    from aither_tpu_torch.solver.driver import Solver
    if env is None:
        monkeypatch.delenv("AITHER_DEBUG", raising=False)
    else:
        monkeypatch.setenv("AITHER_DEBUG", env)
    s = Solver(plate, device="cpu", workdir=str(plate.rsplit("/", 1)[0]),
               debug=arg)
    assert s.debug is want


def test_cli_without_no_files_refuses(tmp_path, monkeypatch):
    """without --no-files the CLI writes the deck's files (the name is
    kept from when this surface refused): the cell centers and the
    function file and meta file at the start and at the deck's output
    frequency, and a restart at its restart frequency"""
    from aither_tpu_torch.main import main
    path = write_plate_case(str(tmp_path), *DIMS, output_frequency=2,
                            restart_frequency=2)
    monkeypatch.chdir(tmp_path)
    assert main([path, "--device", "cpu", "--iterations", "2"]) == 0
    for name in ("plate_center.xyz", "plate_center.p3d", "plate_0_center.fun",
                 "plate_2_center.fun", "plate_2.rst"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert not (tmp_path / "plate_1_center.fun").exists()


def test_cli_restart_argument_refuses(tmp_path, monkeypatch):
    """the positional restart argument resumes (the name is kept from
    when this surface refused): the resumed run's steps continue from
    the file's iteration in the appended .resid"""
    from aither_tpu_torch.main import main
    path = write_plate_case(str(tmp_path), *DIMS, restart_frequency=1)
    monkeypatch.chdir(tmp_path)
    assert main([path, "--device", "cpu", "--iterations", "1"]) == 0
    assert main([path, "plate_1.rst", "--device", "cpu", "--no-files",
                 "--iterations", "2"]) == 0
    with open(tmp_path / "plate.resid") as f:
        steps = [ln.split()[0] for ln in f if ln.strip()]
    assert steps == ["Step", "0", "Step", "1", "2"]


@pytest.mark.parametrize("debug", [False, True])
def test_cli_no_files_runs_on_the_cpu(tmp_path, monkeypatch, debug):
    """--no-files runs and writes .resid; --debug checks each iteration"""
    from aither_tpu_torch.main import main
    from aither_tpu_torch.solver.driver import Solver
    path = write_plate_case(str(tmp_path), *DIMS)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("AITHER_DEBUG", raising=False)
    checked = []
    monkeypatch.setattr(Solver, "check_physicality",
                        lambda self, nn, mm, l2=None: checked.append(nn))
    argv = [path, "--device", "cpu", "--iterations", "2", "--no-files"]
    assert main(argv + (["--debug"] if debug else [])) == 0
    with open(tmp_path / "plate.resid") as f:
        rows = [ln for ln in f if ln.strip()]
    assert len(rows) == 3          # header + one row per iteration
    assert checked == ([0, 1] if debug else [])


def test_file_refusals_are_gone():
    """output, restart and point-cloud initial conditions run, and so does
    every other deck setting: the port has no refusal module left, and no
    raise in its sources (its writers and readers under io/ among them)
    is a NotImplementedError or names a ROADMAP.md item"""
    import importlib.util
    from tests.torch_parity import port_refusals
    assert importlib.util.find_spec("aither_tpu_torch.unsupported") is None
    found = port_refusals()
    assert not [f for f in found if f[0].startswith("io")]
    assert found == []