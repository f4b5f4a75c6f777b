"""PyTorch port, function-file output and restart writing against the JAX
package: both command lines run the generated SST lusgs plate
(2 x 12x8x3 cells) on the CPU for 2 iterations with output and a restart
every step, the files variables of ``cases.FILES_OUTPUT_VARIABLES``, the
wall variables yplus, shearStress and heatFlux, and nodal files, each in a
directory of its own; plus port-only checks of a mixture deck's output
fields and of decomposed runs (``--nproc``).

Tolerances, per variable of every block: headers, dims and variable
counts are byte-equal; the meta files (.p3d), the cell-center grids and
the iteration-0 files are held to |port - jax| <= 1e-9 |jax| + 1e-12
max|jax| (their states are the same bits; the output evaluation differs
by roundoff); files after iterations to 1e-9 |jax| + 1e-8 max|jax|: the
two iterations' states already differ by roundoff, which on the plate's
near-zero fields (vel_z, pressGrad_z, about 1e-6 of their families'
scale) reaches 2.3e-9 of the field's own maximum after 2 iterations.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aither_tpu_torch.cases import (FILES_OUTPUT_VARIABLES,  # noqa: E402
                                    FILES_WALL_VARIABLES, N2O2)
from tests.torch_parity import (perturbed_prims,  # noqa: E402
                                quick_jax_compiles, write_case)

ITERATIONS = 2
FILES = dict(iterations=ITERATIONS, output_frequency=1, restart_frequency=1,
             output_variables=FILES_OUTPUT_VARIABLES,
             wall_output_variables=FILES_WALL_VARIABLES, output_nodal=True)
SAME_STATE_ATOL = 1e-12
ITERATED_ATOL = 1e-8


def _in_dir(path, fn):
    here = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(here)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": dir, "port": dir} after each package's CLI run without
    --no-files, each also holding its iteration-0 restart (plate_0.rst,
    written by a fresh Solver of the deck)"""
    from aither_tpu.main import main as jmain
    from aither_tpu.solver.driver import Solver as JSolver
    from aither_tpu_torch.main import main as tmain
    from aither_tpu_torch.solver.driver import Solver as TSolver
    out = {}
    for pkg in ("jax", "port"):
        wd = tmp_path_factory.mktemp(pkg)
        path = write_case(wd, **FILES)
        if pkg == "jax":
            with quick_jax_compiles():
                assert _in_dir(wd, lambda: jmain([path])) == 0
            JSolver(path, workdir=str(wd)).write_restart(0)
        else:
            assert _in_dir(wd, lambda: tmain([path, "--device", "cpu"])) == 0
            TSolver(path, device="cpu", workdir=str(wd)).write_restart(0)
        out[pkg] = wd
    return out


def _names(d):
    return sorted(n for n in os.listdir(d) if n != "plate.tme")


def test_same_files(runs):
    names = _names(runs["port"])
    assert names == _names(runs["jax"])
    for n in ("plate_center.xyz", "plate_center.p3d", "plate.p3d",
              "plate_wall_center.xyz", "plate_0.rst"):
        assert n in names
    for it in range(ITERATIONS + 1):
        for n in (f"plate_{it}_center.fun", f"plate_{it}.fun",
                  f"plate_{it}_wall_center.fun"):
            assert n in names
    for it in range(1, ITERATIONS + 1):
        assert f"plate_{it}.rst" in names


@pytest.mark.parametrize("name", ["plate_center.p3d", "plate.p3d",
                                  "plate_center.xyz", "plate_wall_center.xyz",
                                  "plate_0.rst", "plate.inp", "plate.xyz"])
def test_byte_identical(runs, name):
    """the meta files whole (they name only basenames), the cell-center
    and wall-face grids and the iteration-0 restart"""
    assert ((runs["port"] / name).read_bytes()
            == (runs["jax"] / name).read_bytes())


def _check_values(got, want, atol_scale, what):
    for b, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, b)
        assert np.isfinite(g).all(), (what, b)
        for v in range(w.shape[0]):
            bound = 1e-9 * np.abs(w[v]) + atol_scale * np.abs(w[v]).max()
            err = np.abs(g[v] - w[v])
            assert np.all(err <= bound), (what, b, v, float(err.max()),
                                          float(np.abs(w[v]).max()))


FUN_FILES = [f"plate_{it}{kind}.fun" for it in range(ITERATIONS + 1)
             for kind in ("_center", "", "_wall_center")]


@pytest.mark.parametrize("name", FUN_FILES)
def test_function_file(runs, name):
    """header bytes (block count, dims, variable counts) equal; values
    within the bound of the module docstring"""
    from aither_tpu_torch.io.output import read_fun_file
    raw = {pkg: (runs[pkg] / name).read_bytes() for pkg in runs}
    nblk = int(np.frombuffer(raw["jax"][:4], "<i4")[0])
    head = 4 + 16 * nblk
    assert nblk == 2 and raw["port"][:head] == raw["jax"][:head]
    assert len(raw["port"]) == len(raw["jax"])
    dims, got = read_fun_file(str(runs["port"] / name))
    nvars = len(FILES_WALL_VARIABLES if "wall" in name
                else FILES_OUTPUT_VARIABLES)
    assert all(g.shape[0] == nvars for g in got)
    _, want = read_fun_file(str(runs["jax"] / name))
    atol = SAME_STATE_ATOL if name.startswith("plate_0") else ITERATED_ATOL
    _check_values(got, want, atol, name)


@pytest.mark.parametrize("it", range(1, ITERATIONS + 1))
def test_restart_file(runs, it):
    """the header up to l2_first byte-equal, l2_first within 1e-8
    relative (the raw L2 history's bound), the block dims byte-equal and
    the records within the iterated bound"""
    from aither_tpu_torch.io.restart import read_restart
    name = f"plate_{it}.rst"
    raw = {pkg: (runs[pkg] / name).read_bytes() for pkg in runs}
    got = read_restart(str(runs["port"] / name))
    want = read_restart(str(runs["jax"] / name))
    assert got["iteration"] == want["iteration"] == it
    assert (got["num_sols"], got["neq"], got["species"]) == (
        want["num_sols"], want["neq"], want["species"])
    l2_at = 16 + sum(8 + len(s) for s in want["species"])
    assert raw["port"][:l2_at] == raw["jax"][:l2_at]
    np.testing.assert_allclose(got["l2_first"], want["l2_first"], rtol=1e-8)
    dims_at = l2_at + 8 * want["neq"]
    dims_end = dims_at + 4 + 16 * len(want["blocks"])
    assert raw["port"][dims_at:dims_end] == raw["jax"][dims_at:dims_end]
    assert len(raw["port"]) == len(raw["jax"])
    _check_values(got["blocks"], want["blocks"], ITERATED_ATOL, name)


def test_residual_log(runs):
    """the .resid of both runs: the same header and step, iteration,
    max-location columns"""
    rows = {}
    for pkg in runs:
        with open(runs[pkg] / "plate.resid") as f:
            rows[pkg] = [ln.split() for ln in f if ln.strip()]
    assert rows["port"][0] == rows["jax"][0]
    assert len(rows["port"]) == ITERATIONS + 1
    cols = [0, 1] + list(range(10, 15))
    for g, w in zip(rows["port"][1:], rows["jax"][1:]):
        assert [g[c] for c in cols] == [w[c] for c in cols]


# ---------------------------------------------------------------------------
# port-only checks


def test_mixture_output_fields(tmp_path):
    """an N2/O2 Schmidt deck, from a state whose composition varies
    (torch_parity.perturbed_prims: each species density perturbed on its
    own), writes its mass fractions and the gradient fields; its output
    evaluation forms the cell-average mass-fraction gradients, which sum
    to zero over the species"""
    from aither_tpu_torch.io.output import read_fun_file
    from aither_tpu_torch.solver import step as tstep
    from aither_tpu_torch.solver.driver import Solver
    names = ("mf_N2", "mf_O2", "densityGrad_y", "tempGrad_x", "velGrad_uy",
             "resid_mass", "dt")
    path = write_case(tmp_path, iterations=1, output_variables=names,
                      output_frequency=1, **N2O2)
    s = Solver(path, device="cpu", workdir=str(tmp_path))
    s.set_state(perturbed_prims(s.case.blocks))
    s.run(write_files=True)
    for it in (0, 1):
        _, blocks = read_fun_file(str(tmp_path / f"plate_{it}_center.fun"))
        for blk in blocks:
            assert blk.shape[0] == len(names) and np.isfinite(blk).all()
            # the columns are in sorted order, as the reference's set
            col = sorted(names).index
            np.testing.assert_allclose(blk[col("mf_N2")] + blk[col("mf_O2")],
                                       1.0, rtol=1e-14)
    prims = tstep.apply_all_bcs(s.phys, s.case, dict(s.prims))
    for b in s.case.blocks:
        ca = tstep.full_residual(s.phys, s.cfg, b, prims[b.index],
                                 need_aux=True)[5]
        mix = torch.stack(ca["mix"])
        assert mix.shape == (2, 3, b.ni, b.nj, b.nk)
        scale = mix.abs().max()
        assert scale > 1.0 and mix.sum(dim=0).abs().max() <= 1e-12 * scale
        assert {"temp", "rho", "press", "wall_out"} <= set(ca)


def _port_cli(wd, nproc, **deck):
    from aither_tpu_torch.main import main
    path = write_case(wd, **deck)
    argv = [path, "--device", "cpu", "--nproc", str(nproc)]
    assert _in_dir(wd, lambda: main(argv)) == 0
    return wd


def test_decomposed_files(tmp_path):
    """--nproc 2 (one block per process: no split) writes the files of
    --nproc 1 within the iterated bound, and its .resid whole; --nproc 4
    (each block split in two) writes the iteration-0 center and wall
    files and restart of --nproc 1: the output recombines into the
    grid's original blocks (its nodal files and later iterations differ
    by what a split changes: the sweeps, and the ghosts of the state
    before its first iteration)"""
    from aither_tpu_torch.io.output import read_fun_file
    runs = {n: _port_cli(tmp_path / f"p{n}", n, **FILES) for n in (1, 2)}
    for name in _names(runs[1]):
        if name.endswith(".fun"):
            _, got = read_fun_file(str(runs[2] / name))
            _, want = read_fun_file(str(runs[1] / name))
            _check_values(got, want, ITERATED_ATOL, name)
        elif name != "plate_0.rst":
            assert ((runs[2] / name).read_bytes()
                    == (runs[1] / name).read_bytes()), name
    split = _port_cli(tmp_path / "p4", 4, **dict(FILES, iterations=1,
                                                 restart_frequency=0))
    from aither_tpu_torch.solver.driver import Solver
    for wd, n in ((runs[1], 1), (split, 4)):
        s = Solver(str(wd / "plate.inp"), device="cpu", workdir=str(wd),
                   nproc=n)
        assert bool(s.case.decomp and s.case.decomp.splits) == (n == 4)
        s.write_restart(0)
    for name in ("plate_0_center.fun", "plate_0_wall_center.fun",
                 "plate_0.rst", "plate_center.xyz", "plate_wall_center.xyz"):
        assert (split / name).read_bytes() == (runs[1] / name).read_bytes(), \
            name
