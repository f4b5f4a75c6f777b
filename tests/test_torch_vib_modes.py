"""PyTorch port, a thermally perfect species of more vibrational modes
than any of the fluid database (eleven: the tracer ``CH4x``, methane's nine
and two more, ``cases.TRACERS``) in N2/O2 (``cases.MIXTURES["n2o2_ch4x"]``,
SST, Schmidt diffusion, 9 equations), against aither_tpu on the generated
two-block plate:

1. the CUDA sweeps' form and their species array take the deck: the mode
   counts and every species' vibrational temperatures one after another
   (csrc/thermo_tp.cuh: offsets into one table, no compiled bound on a
   species' modes; the sweeps refused more than nine before), up to
   ``lusgs_sweep.VIB_MODES`` in all, which the kernels' 4 KB of
   parameters bound;
2. one full lusgs iteration and one blusgs iteration against the JAX
   Solver's scan path (prims and L2 1e-10, matrix residual 1e-9, the
   bounds of ``test_torch_physics5b_tp.py``).

Both packages read the tracer's fluid file, which ``write_plate_case``
writes beside the deck, from the working directory.  Two JAX Solvers
compile, with ``quick_jax_compiles``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import check_one_iteration, solver_pair  # noqa: E402
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

DECK = dict(cases.MIXTURES["n2o2_ch4x"],
            thermodynamic_model="thermallyPerfect")


def test_tracer_has_eleven_modes(tmp_path, monkeypatch):
    """the tracer's fluid file lists methane's nine modes and two more"""
    from aither_tpu_torch.physics.fluid import load_fluid
    monkeypatch.chdir(tmp_path)
    cases.write_plate_case(str(tmp_path), 4, 3, 2, **DECK)
    tracer, ch4 = load_fluid("CH4x"), load_fluid("CH4", ())
    assert len(tracer.vib_temps) == 11
    assert tracer.vib_temps == ch4.vib_temps + cases.TRACERS["CH4x"][1]
    assert (tracer.molar_mass, tracer.n) == (ch4.molar_mass, ch4.n)


@pytest.mark.parametrize("block", [False, True])
def test_sweep_form_takes_eleven_modes(tmp_path, monkeypatch, block):
    """the thermally perfect sweeps of both solvers take the deck: its
    form, its species array (the constants, then each species' mode
    count) and the vibrational table on the device, species after
    species"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver.driver import Solver
    monkeypatch.chdir(tmp_path)
    path = cases.write_plate_case(
        str(tmp_path), 4, 3, 2, matrix_solver="blusgs" if block else "lusgs",
        **DECK)
    s = Solver(path, device="cpu", workdir=str(tmp_path))
    phys = s.phys
    assert [len(v) for v in phys.vib] == [1, 1, 11]
    assert ls.sweep_form(phys, s.cfg) == (3, 9, True, False, False, True)
    assert ls.form_library(phys, s.cfg) == ("blusgs_sweep_tp" if block
                                            else "lusgs_sweep_tp")
    species = ls.species_constants(phys, s.cfg, block)
    constants = 4 * 3 + (3 * 3 + 3 if block else 0)
    assert species.shape == (constants + 3 + 13,)
    assert list(species[constants:constants + 3]) == [1.0, 1.0, 11.0]
    assert list(species[constants + 3:]) == [t for v in phys.vib for t in v]


def test_sweep_form_bounds_the_modes_of_a_deck():
    """a thermally perfect deck may have up to ``VIB_MODES`` modes in all
    (the table the kernels take by value), however they fall on its
    species; one more raises"""
    import types
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    cfg = dict(viscous=True)

    def phys(modes):
        return types.SimpleNamespace(
            ns=len(modes), neq=len(modes) + 6, thermally_perfect=True,
            vib=[(1.0,) * m for m in modes], turb_model="sst2003")
    whole = ls.VIB_MODES
    assert ls.sweep_form(phys([whole]), cfg)[5]
    assert ls.sweep_form(phys([whole - 100, 60, 40]), cfg)[0] == 3
    with pytest.raises(ValueError, match="vibrational modes in all"):
        ls.sweep_form(phys([whole - 100, 60, 41]), cfg)


def test_one_iteration(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    js, ts = solver_pair(tmp_path, scan=True, **DECK)
    assert ts.phys.thermally_perfect and (ts.phys.ns, ts.phys.neq) == (3, 9)
    assert js.phys.thermo_model == "thermallyPerfect"
    check_one_iteration(js, ts)


def test_one_iteration_blusgs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    js, ts = solver_pair(tmp_path, scan=True, matrix_solver="blusgs", **DECK)
    assert ts.cfg["block_matrix"]
    check_one_iteration(js, ts)
