"""PyTorch port, the single-species physics family at function level: every
model-dependent function against its aither_tpu counterpart on random
points (no Solver compile), and the routing of the new decks.

Functions, per model (rtol 1e-12, atol 1e-14: the same float64 expressions
on both sides; libm and XLA's fusion round a few ulp apart):
``eddy_visc_and_blending`` (Wilcox, WALE, WALE at a zero gradient),
``wilcox_beta`` (3-D and an exactly 2-D gradient, where the guarded
invariant is exactly 0), ``turb_source`` (Wilcox, sstdes), ``sigma_k`` /
``sigma_w``, the viscous wall's omega ghost, ``offdiagonal_scalar`` and
``offdiagonal_block_channels`` (5 equations inviscid, 5 equations viscous
with mut > 0, Wilcox; both signs; each row against its own scale, as
test_torch_physics), ``diag_mult`` / ``diag_mult_channels`` without a
turbulence block, ``turb_src_jacobian`` (Wilcox, sstdes).

Routing: ``check_supported`` admits each new deck and the remaining
physics (WENO, AUSM); ``sweep_form`` gives every deck a form and
``library_name`` its library (the thermally perfect approximateRoe
sweeps ``*_roe_tp``, a species count above 5 ``*_ns<N>``), which
``utils.build.library_source`` resolves into its source and defines; the
bound of ``sweep_cost`` grows with the Roe and thermally perfect terms and
with the species count; the wrappers launch nothing on CPU tensors and
reject a meta tensor in every form; the generated deck's default text is
what it was before the physics became fields.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch.cases import write_plate_case  # noqa: E402
from tests.torch_parity import np_, rel_err  # noqa: E402

RTOL, ATOL = 1e-12, 1e-14
N = 48

DECKS = {
    "euler": ("euler", "none"),
    "laminar": ("navierStokes", "none"),
    "wale": ("largeEddySimulation", "wale"),
    "wilcox": ("rans", "kOmegaWilcox2006"),
    "sst": ("rans", "sst2003"),
    "sstdes": ("rans", "sstdes"),
}


@pytest.fixture(scope="module")
def physics(tmp_path_factory):
    """{deck name: (JAX Physics, port Physics, JAX cfg, port cfg)}, from
    the two Solvers of each deck on a 2 x 4x3x2 plate (nothing is run)"""
    from tests.torch_parity import jax_solver, torch_solver
    out = {}
    for name, (es, tm) in DECKS.items():
        wd = tmp_path_factory.mktemp(name)
        path = write_plate_case(str(wd), 4, 3, 2, equation_set=es,
                                turbulence_model=tm)
        js, ts = jax_solver(path, wd), torch_solver(path, wd)
        out[name] = (js.phys, ts.phys, js.cfg, ts.cfg)
    return out


def _close(got, want, what):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np_(w), rtol=RTOL, atol=ATOL,
                                   err_msg=what)


def _points(neq, seed):
    """numpy point inputs around the plate's freestream"""
    rng = np.random.default_rng(seed)
    q = np.empty((neq, N))
    q[0] = 1.0 + 0.2 * rng.random(N)
    q[1:4] = 0.2 * (rng.random((3, N)) - 0.3)
    q[4] = 0.714 * (1.0 + 0.2 * rng.random(N))
    if neq == 7:
        q[5] = 1e-4 * (1.0 + rng.random(N))
        q[6] = 10.0 * (1.0 + rng.random(N))
    n = rng.standard_normal((3, N))
    return dict(
        q=q, du=1e-3 * rng.standard_normal((neq, N)),
        n=n / np.linalg.norm(n, axis=0), mag=0.5 + rng.random(N),
        dist=0.01 + rng.random(N), mu=1.0 + rng.random(N),
        mut=10.0 * rng.random(N) + 0.1, f1=rng.random(N),
        vgrad=rng.standard_normal((3, 3, N)),
        kgrad=1e-3 * rng.standard_normal((3, N)),
        wgrad=10.0 * rng.standard_normal((3, N)),
        wd=1e-3 + rng.random(N), width=1e-2 + rng.random(N),
        length=1e-2 + rng.random(N), vol=0.5 + rng.random(N),
        beta=0.07 + 0.02 * rng.random(N))


def _j(a, *keys):
    return [jnp.asarray(a[k]) for k in keys]


def _t(a, *keys):
    return [torch.as_tensor(a[k]) for k in keys]


# ---------------------------------------------------------------------------
# the turbulence closures


def test_physics_from_deck(physics):
    want = {"euler": (5, "none"), "laminar": (5, "none"),
            "wale": (5, "wale"), "wilcox": (7, "kOmegaWilcox2006"),
            "sst": (7, "sst2003"), "sstdes": (7, "sstdes")}
    for name, (jp, tp, jc, tc) in physics.items():
        assert (tp.neq, tp.turb_model) == (jp.neq, jp.turb_model) \
            == want[name]
        assert tp.turb_prandtl() == jp.turb_prandtl()
        for key in ("viscous", "turbulent", "turb_model"):
            assert tc[key] == jc[key], (name, key)


@pytest.mark.parametrize("case", ["wilcox", "wale", "wale_zero_gradient",
                                  "sstdes"])
def test_eddy_visc_and_blending(physics, case):
    from aither_tpu.solver import viscous as jvi
    from aither_tpu_torch.solver import viscous as tvi
    jp, tp, _, _ = physics[case.split("_")[0]]
    a = _points(tp.neq, 1)
    if case == "wale_zero_gradient":
        a["vgrad"] = np.zeros_like(a["vgrad"])
    keys = ("q", "vgrad", "kgrad", "wgrad", "mu", "wd", "length")
    want = jvi.eddy_visc_and_blending(jp, jp.turb_model, *_j(a, *keys))
    got = tvi.eddy_visc_and_blending(tp, tp.turb_model, *_t(a, *keys))
    _close(got, want, case)
    if case == "wale_zero_gradient":
        assert not np_(got[0]).any()          # 0 / EPS, not NaN
    if case.startswith(("wale", "wilcox")):
        assert np.all(np_(got[1]) == 1.0) and not np_(got[2]).any()


@pytest.mark.parametrize("two_d", [False, True], ids=["3d", "2d"])
def test_wilcox_beta(physics, two_d):
    from aither_tpu.solver import viscous as jvi
    from aither_tpu_torch.solver import viscous as tvi
    jp, tp, _, _ = physics["wilcox"]
    a = _points(7, 2)
    if two_d:
        a["vgrad"][2] = 0.0
        a["vgrad"][:, 2] = 0.0
    want = jvi.wilcox_beta(jp, *_j(a, "q", "vgrad"))
    got = tvi.wilcox_beta(tp, *_t(a, "q", "vgrad"))
    _close(got, want, "wilcox_beta")
    if two_d:       # the invariant cancels exactly: FBeta = 1
        assert np.all(np_(got) == tvi.WILCOX["beta0"])
    else:
        assert np.all(np_(got) < tvi.WILCOX["beta0"])


@pytest.mark.parametrize("name", ["wilcox", "sstdes", "sst"])
def test_turb_source(physics, name):
    from aither_tpu.solver import viscous as jvi
    from aither_tpu_torch.solver import viscous as tvi
    jp, tp, _, _ = physics[name]
    a = _points(7, 3)
    a["f2"] = np.random.default_rng(4).random(N)
    keys = ("q", "vgrad", "kgrad", "wgrad", "mut", "f1", "f2", "width")
    want = jvi.turb_source(jp, jp.turb_model, *_j(a, *keys))
    got = tvi.turb_source(tp, tp.turb_model, *_t(a, *keys))
    for label, w, g in zip(("src_k", "src_w", "src_rad"), want, got):
        assert rel_err(g, w) < 1e-13, (name, label)
    with pytest.raises(ValueError, match="no source terms"):
        tvi.turb_source(tp, "wale", *_t(a, *keys))


@pytest.mark.parametrize("model", ["kOmegaWilcox2006", "sst2003", "sstdes"])
def test_sigmas_and_wall_beta(model):
    from aither_tpu.solver import viscous as jvi
    from aither_tpu_torch.solver import viscous as tvi
    f1 = np.random.default_rng(5).random(N)
    for fn in ("sigma_k", "sigma_w"):
        want = getattr(jvi, fn)(model, jnp.asarray(f1))
        got = getattr(tvi, fn)(model, torch.as_tensor(f1))
        _close(got if torch.is_tensor(got) else np.float64(got),
               want, f"{fn} {model}")
    assert tvi.wall_beta(model) == jvi.wall_beta(model)
    assert tvi.turb_prandtl(model) == jvi.turb_prandtl(model)
    for name in ("WILCOX", "SST", "DES", "WALE"):
        assert getattr(tvi, name) == getattr(jvi, name)


@pytest.mark.parametrize("name", ["wilcox", "sst", "laminar"])
@pytest.mark.parametrize("layer", [1, 2])
def test_viscous_wall_ghost(physics, name, layer):
    """the omega wall value takes the model's beta (beta0 for Wilcox)"""
    from aither_tpu.solver import bc as jbc
    from aither_tpu_torch.solver import bc as tbc
    jp, tp, _, _ = physics[name]
    a = _points(tp.neq, 6)
    a["nu"] = a["mu"] / a["q"][0]
    data = dict(velocity=(0.0, 0.0, 0.0), temperature=1.0,
                is_isothermal=True)
    want = jbc.viscous_wall(jp, *_j(a, "q", "n"), jbc.BCData(**data), layer,
                            wall_dist=jnp.asarray(a["wd"]),
                            nu_w=jnp.asarray(a["nu"]))
    got = tbc.viscous_wall(tp, *_t(a, "q", "n"), tbc.BCData(**data), layer,
                           wall_dist=torch.as_tensor(a["wd"]),
                           nu_w=torch.as_tensor(a["nu"]))
    assert got.shape[0] == tp.neq
    _close(got, want, f"viscous_wall {name}")


# ---------------------------------------------------------------------------
# the implicit pieces


FORMS = ["euler", "laminar", "wale", "wilcox", "sstdes"]


def _offdiag_kw(name, a, conv, block):
    if name == "euler":
        return {}
    kw = {k: conv(a[k]) for k in ("dist", "mu", "mut", "f1")}
    if name == "laminar":
        kw["mut"] = conv(np.zeros(N))
        kw["f1"] = conv(np.zeros(N))
    if block:
        kw["vgrad"] = conv(a["vgrad"])
    return kw


@pytest.mark.parametrize("positive", [True, False])
@pytest.mark.parametrize("name", FORMS)
def test_offdiagonal_scalar(physics, name, positive):
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import implicit as tim
    jp, tp, jc, tc = physics[name]
    a = _points(tp.neq, 7)
    want = jim.offdiagonal_scalar(jp, jc, *_j(a, "q", "du", "n", "mag"),
                                  positive,
                                  **_offdiag_kw(name, a, jnp.asarray, False))
    got = tim.offdiagonal_scalar(tp, tc, *_t(a, "q", "du", "n", "mag"),
                                 positive,
                                 **_offdiag_kw(name, a, torch.as_tensor,
                                               False))
    assert got.shape == (tp.neq, N)
    for e in range(tp.neq):
        assert rel_err(got[e], want[e]) < 1e-12, (name, e)


@pytest.mark.parametrize("positive", [True, False])
@pytest.mark.parametrize("name", FORMS)
def test_offdiagonal_block_channels(physics, name, positive):
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import implicit as tim
    jp, tp, jc, tc = physics[name]
    jc, tc = dict(jc, block_matrix=True), dict(tc, block_matrix=True)
    a = _points(tp.neq, 8)
    a["du"] = np.random.default_rng(9).standard_normal((tp.neq, N))
    want = jim.offdiagonal_block_channels(
        jp, jc, *_j(a, "q", "du", "n", "mag"), positive,
        **_offdiag_kw(name, a, jnp.asarray, True))
    got = tim.offdiagonal_block_channels(
        tp, tc, *_t(a, "q", "du", "n", "mag"), positive,
        **_offdiag_kw(name, a, torch.as_tensor, True))
    assert got.shape == (tp.neq, N)
    _close(got, want, f"offdiagonal_block_channels {name}")
    # the dispatch the sweeps call takes the same form
    _close(tim.offdiagonal(tp, tc, *_t(a, "q", "du", "n", "mag"), positive,
                           **_offdiag_kw(name, a, torch.as_tensor, True)),
           want, f"offdiagonal {name}")


def test_diag_mult_without_a_turbulence_block(physics):
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import implicit as tim
    jp, tp, _, _ = physics["laminar"]
    rng = np.random.default_rng(10)
    x, inv = rng.standard_normal((5, N)), 0.5 + rng.random(N)
    ch = rng.standard_normal((25, N))
    _close(tim.diag_mult(tp, torch.as_tensor(inv), None, torch.as_tensor(x)),
           jim.diag_mult(jp, jnp.asarray(inv), None, jnp.asarray(x)),
           "diag_mult")
    _close(tim.diag_mult_channels(tp, torch.as_tensor(ch), None,
                                  torch.as_tensor(x)),
           jim.diag_mult_channels(jp, jnp.asarray(ch), None, jnp.asarray(x)),
           "diag_mult_channels")


@pytest.mark.parametrize("name,phi", [("wilcox", 1.0), ("sstdes", 1.7),
                                      ("sst", 1.0)])
def test_turb_src_jacobian(physics, name, phi):
    from aither_tpu.solver import block_jac as jbj
    from aither_tpu_torch.solver import block_jac as tbj
    jp, tp, jc, tc = physics[name]
    a = _points(7, 11)
    want = jbj.turb_src_jacobian(jp, jc, *_j(a, "q", "vol", "beta"), phi)
    got = tbj.turb_src_jacobian(tp, tc, *_t(a, "q", "vol", "beta"), phi)
    _close(got, want, f"turb_src_jacobian {name}")


# ---------------------------------------------------------------------------
# routing


@pytest.mark.parametrize("name", sorted(DECKS))
@pytest.mark.parametrize("matrix_solver", ["lusgs", "blusgs"])
def test_check_supported_admits_the_deck(tmp_path, name, matrix_solver):
    from aither_tpu_torch.io.deck import parse_deck
    from aither_tpu_torch.solver.driver import check_supported
    es, tm = DECKS[name]
    path = write_plate_case(str(tmp_path), 4, 3, 2, equation_set=es,
                            turbulence_model=tm, matrix_solver=matrix_solver)
    check_supported(parse_deck(path).finalize())


@pytest.mark.parametrize("name", ["euler", "laminar", "wale", "wilcox",
                                  "sstdes"])
@pytest.mark.parametrize("matrix_solver", ["lusgs", "blusgs"])
def test_cli_runs_the_deck_on_the_cpu(tmp_path, monkeypatch, name,
                                      matrix_solver):
    from aither_tpu_torch.main import main
    es, tm = DECKS[name]
    path = write_plate_case(str(tmp_path), 4, 3, 2, equation_set=es,
                            turbulence_model=tm, matrix_solver=matrix_solver)
    monkeypatch.chdir(tmp_path)
    assert main([path, "--device", "cpu", "--iterations", "2",
                 "--no-files"]) == 0
    with open(tmp_path / "plate.resid") as f:
        rows = [ln.split() for ln in f if ln.strip()]
    assert len(rows) == 3          # header + one row per iteration
    nres = sum(c.startswith("Res-") for c in rows[0]) - 1   # less Res-Matrix
    assert nres == (7 if es == "rans" else 5)


def _patched_deck(tmp_path, name, patch):
    """the generated deck of physics ``name`` with one setting replaced"""
    import re
    es, tm = DECKS[name]
    path = write_plate_case(str(tmp_path), 4, 3, 2, equation_set=es,
                            turbulence_model=tm)
    with open(path) as f:
        text = f.read()
    key, val = patch
    text, n = re.subn(rf"^{key}: .*$", f"{key}: {val}", text, flags=re.M)
    assert n == 1
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.mark.parametrize("patch,item", [
    pytest.param(("faceReconstruction", "weno"), "item 5",
                 id="patch2-item 5"),
    pytest.param(("inviscidFlux", "ausm"), "item 5", id="patch3-item 5")])
@pytest.mark.parametrize("name", ["euler", "wilcox"])
def test_check_supported_admits_the_remaining_physics(tmp_path, name, patch,
                                                      item):
    """WENO and AUSM, refused until the port covered them (ROADMAP queue 1
    ``item``), pass the deck check, and the CPU solver builds"""
    from aither_tpu_torch.io.deck import parse_deck
    from aither_tpu_torch.solver.driver import Solver, check_supported
    path = _patched_deck(tmp_path, name, patch)
    check_supported(parse_deck(path).finalize())
    ts = Solver(path, device="cpu", workdir=str(tmp_path))
    key, val = patch
    assert ts.deck[key] == val


def test_check_supported_refuses_the_thermally_perfect_roe_sweeps(tmp_path):
    """named for the refusal it held until the thermally perfect
    approximateRoe sweep forms were built; it now holds that no refusal is
    left: a thermally perfect approximateRoe lusgs / blusgs deck passes
    the deck check and
    the CPU solver builds (its plain sweep); its sweep form is the Roe
    form of the thermally perfect gas, held by the ``*_roe_tp`` library
    of each solver; dplur takes no sweep kernel"""
    from aither_tpu_torch.io.deck import parse_deck
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver.driver import Solver, check_supported
    for solver_name in ("lusgs", "blusgs", "dplur"):
        path = write_plate_case(str(tmp_path), 4, 3, 2,
                                matrix_solver=solver_name,
                                inviscid_flux_jacobian="approximateRoe",
                                thermodynamic_model="thermallyPerfect")
        check_supported(parse_deck(path).finalize())
        ts = Solver(path, device="cpu", workdir=str(tmp_path))
        assert ts.sweeps == (solver_name != "dplur")
        if ts.sweeps:
            assert ls.sweep_form(ts.phys, ts.cfg) == (1, 7, True, False,
                                                      True, True)
            assert ls.form_library(ts.phys, ts.cfg) == (
                f"{solver_name}_sweep_roe_tp")


@pytest.mark.cuda
def test_thermally_perfect_roe_deck_runs_on_the_card(tmp_path):
    """the thermally perfect approximateRoe deck builds its library at
    Solver construction and runs 2 steps there, each launching the
    lusgs_sweep_roe_tp forms once per block and sweep"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver.driver import Solver
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = write_plate_case(str(tmp_path), 4, 3, 2,
                            inviscid_flux_jacobian="approximateRoe",
                            thermodynamic_model="thermallyPerfect")
    ts = Solver(path, device="cuda", workdir=str(tmp_path))
    assert ls.form_library(ts.phys, ts.cfg) == "lusgs_sweep_roe_tp"
    ls.LAUNCHES.reset()
    ts.run(iterations=2)
    assert ls.LAUNCHES.count == 2 * 2 * len(ts.case.blocks)
    assert np.isfinite(ts.l2_history).all()


def test_species_refusal_still_stands(physics):
    """named for the refusal it held until each species count above the
    base sweep libraries' had a library of its own; it now holds that no
    refusal is left: 6, 7 and 16 species give their forms
    and, in every build of both sweeps, a library ``*_ns<N>`` that
    ``utils.build`` resolves into the source with -DSWEEP_NS=N"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.utils import build
    _, tp, _, tc = physics["wilcox"]
    for ns in (6, 7, 16):
        _check_species_libraries(ls, build, tp, tc, ns)


def _check_species_libraries(ls, build, tp, tc, ns):
    import dataclasses
    assert ls.sweep_form(dataclasses.replace(tp, ns=ns, neq=ns + 6), tc) == (
        ns, ns + 6, True, True, False, False)
    for block in (False, True):
        for roe in (False, True):
            for thermo in (False, True):
                name = ls.library_name(block, roe, thermo, ns)
                source = "blusgs_sweep" if block else "lusgs_sweep"
                assert name == (source + ("_roe" if roe else "")
                                + ("_tp" if thermo else "") + f"_ns{ns}")
                assert build.library_source(name) == (source, (
                    *(("-DSWEEP_ROE=1",) if roe else ()),
                    *(("-DSWEEP_TP=1",) if thermo else ()),
                    f"-DSWEEP_NS={ns}"))


@pytest.mark.parametrize("patch", [("matrixSolver", "dplur"),
                                   ("inviscidFluxJacobian",
                                    "approximateRoe")])
@pytest.mark.parametrize("name", ["euler", "wilcox"])
def test_check_supported_admits_the_linear_solvers(tmp_path, name, patch):
    """dplur and approximateRoe, refused before the port covered them,
    pass the deck check, and the CPU solver builds"""
    from aither_tpu_torch.io.deck import parse_deck
    from aither_tpu_torch.solver.driver import Solver, check_supported
    path = _patched_deck(tmp_path, name, patch)
    check_supported(parse_deck(path).finalize())
    ts = Solver(path, device="cpu", workdir=str(tmp_path))
    key, val = patch
    assert ts.deck[key] == val


@pytest.mark.parametrize("matrix_solver", ["lusgs", "blusgs"])
@pytest.mark.parametrize("name", ["euler", "laminar", "wale", "wilcox"])
def test_cpu_launches_no_kernel_and_meta_is_refused(tmp_path, name,
                                                    matrix_solver):
    """one iteration on the CPU leaves every launch counter alone, and the
    sweep wrapper refuses the same operands as meta tensors"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.kernels import viscous_march as vm
    from aither_tpu_torch.solver.driver import Solver
    es, tm = DECKS[name]
    path = write_plate_case(str(tmp_path), 4, 3, 2, equation_set=es,
                            turbulence_model=tm, matrix_solver=matrix_solver)
    ts = Solver(path, device="cpu", workdir=str(tmp_path))
    counters = (ls.LAUNCHES, ls.BLOCK_LAUNCHES, vm.LAUNCHES)
    before = [c.count for c in counters]
    ts.run(iterations=1)
    assert [c.count for c in counters] == before
    assert np.isfinite(ts.l2_history).all()
    assert ls.sweep_form(ts.phys, ts.cfg) == (
        1, ts.phys.neq, name != "euler", name == "wilcox", False, False)

    prims, res, sr, dg, dts, auxs = ts._residuals(dict(ts.prims),
                                                  ts.deck.cfl(0))
    inv_diag, _, bs, dus = ts._setup_linear(prims, res, sr, dg, dts, auxs,
                                            ts.cons_n)

    def meta(t):
        return None if t is None else t.to("meta")

    aux = {k: meta(v) for k, v in (auxs[0] or {}).items()
           if torch.is_tensor(v)}
    for fn in (ls.forward, ls.backward):
        with pytest.raises(ValueError, match="meta"):
            fn(ts.phys, ts.cfg, ts.plans[0], meta(prims[0]), meta(dus[0]),
               meta(bs[0]), *(meta(m) for m in inv_diag[0]), aux)
    if name != "euler" and matrix_solver == "lusgs":
        b = ts.case.blocks[0]
        t_all = ts.phys.temperature(prims[0][ts.phys.ie],
                                    prims[0][:ts.phys.ns])
        with pytest.raises(ValueError, match="meta"):
            vm.viscous_residual(ts.phys, ts.cfg, b, meta(prims[0]),
                                meta(t_all), meta(t_all))
    assert [c.count for c in counters] == before


def test_wrappers_refuse_what_is_not_ported(physics):
    """a 7-equation inviscid form and equation counts no species count
    has (six species take a form: every count has a library), and for the
    fused viscous residual two species, centralFourth, a thermally perfect
    gas and the block solver"""
    import dataclasses
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.kernels import viscous_march as vm
    _, tp, _, tc = physics["wilcox"]
    assert ls.sweep_form(tp, tc) == (1, 7, True, True, False, False)
    with pytest.raises(ValueError, match="ns \\+ 4 equations"):
        ls.sweep_form(tp, dict(tc, viscous=False))
    two = dataclasses.replace(tp, ns=2)
    with pytest.raises(ValueError, match="ns \\+ 4 equations"):
        ls.sweep_form(two, tc)
    assert ls.sweep_form(dataclasses.replace(two, neq=8), tc) == (
        2, 8, True, True, False, False)
    assert ls.sweep_form(dataclasses.replace(tp, ns=6, neq=12), tc) == (
        6, 12, True, True, False, False)
    with pytest.raises(ValueError, match="viscous residual kernel"):
        vm._check_scope(dataclasses.replace(two, neq=8), tc)
    with pytest.raises(ValueError, match="viscous residual kernel"):
        vm._check_scope(dataclasses.replace(
            tp, thermo_model="thermallyPerfect"), tc)
    for key, val in (("viscous_recon", "centralFourth"),
                     ("block_matrix", True), ("viscous", False)):
        with pytest.raises(ValueError, match="viscous residual kernel"):
            vm._check_scope(tp, dict(tc, **{key: val}))
    assert vm._check_scope(tp, tc) == vm.MODELS["kOmegaWilcox2006"] == 1
    for name, branch in (("laminar", 3), ("wale", 2), ("sstdes", 0)):
        _, p, _, c = physics[name]
        assert vm._check_scope(p, c) == branch


@pytest.mark.parametrize("form", [(1, 5, False, False, False, False),
                                  (1, 5, True, False, False, False),
                                  (1, 7, True, False, False, False),
                                  (1, 7, True, True, False, False)])
@pytest.mark.parametrize("block", [False, True])
def test_sweep_cost_by_form(tmp_path, form, block):
    """the bound counts each form's own bytes and operations: fewer
    equations, no viscous fields or no f1 read less, and every form's
    operations per neighbour are its own"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver.driver import Solver
    path = write_plate_case(str(tmp_path), 4, 3, 2)
    plan = Solver(path, device="cpu", workdir=str(tmp_path)).plans[0]
    sst = ls.sweep_cost(plan, True, False, block)
    nbytes, ops = ls.sweep_cost(plan, True, False, block, form)
    if form == ls.SST_FORM:
        assert (nbytes, ops) == sst
    else:
        assert 0 < nbytes < sst[0] and 0 < ops < sst[1]
    extra = ls.sweep_cost(plan, True, True, block, form)
    ncell = int(plan.cells.numel())
    assert extra[0] - nbytes == 8 * form[1] * ncell
    assert extra[1] - ops == form[1] * ncell


@pytest.mark.parametrize("form", [(2, 8, True, False, False, False),
                                  (5, 9, True, False, False, False),
                                  (2, 6, False, False, False, False),
                                  (5, 11, True, True, False, False)])
@pytest.mark.parametrize("block", [False, True])
def test_sweep_cost_of_mixture_forms(tmp_path, form, block):
    """a mixture's bound, counted here value by value and operation by
    operation: the padded fields at the distinct neighbours (neq, mu and
    mut when viscous, f1 with SST, vgrad for the block sweep), the ghost
    du, the inverses ((ns + 4)^2 block channels), b, du written, the
    masks and face statics; per neighbour the mixture path's
    operations (with the block sweep's Schmidt diffusion rows) and per
    cell the right-hand side and the inverse product"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver.driver import Solver
    path = write_plate_case(str(tmp_path), 4, 3, 2)
    plan = Solver(path, device="cpu", workdir=str(tmp_path)).plans[0]
    ns, neq, viscous, wilcox = form[:4]
    N, turb = ns + 4, neq == ns + 6
    ncell = int(plan.cells.numel())
    nfaces = int(plan.mask["lower"].sum())
    nread, nghost = ls.neighbour_reads(plan, True)
    padded = neq + (2 + (turb and not wilcox) + 9 * block if viscous else 0)
    inverses = (N * N if block else 1) + ((4 if block else 1) if turb else 0)
    values = (padded * nread + neq * nghost + (inverses + 2 * neq) * ncell
              + (5 if viscous else 4) * nfaces)
    want_bytes = 8 * values + 3 * ncell
    if block:
        per_nb = 24 * ns + 148
        if viscous:
            per_nb += 12 * ns + 127 + 3 * turb + 14 * ns + 4
        per_nb += ({False: 30, True: 24}[wilcox] if turb else 0)
        per_cell = 2 * N * N + N + 8 * turb
    else:
        per_nb = (54 * ns + 119 + 16 * viscous
                  + ((12 + {False: 22, True: 20}[wilcox]) if turb else 0))
        per_cell = 2 * neq
    got = ls.sweep_cost(plan, True, False, block, form, diffusion=True)
    assert got == (want_bytes, per_nb * nfaces + per_cell * ncell)
    # the lagged term reads extra and adds one operation per equation
    extra = ls.sweep_cost(plan, True, True, block, form, diffusion=True)
    assert extra == (got[0] + 8 * neq * ncell, got[1] + neq * ncell)
    # without diffusion the block rows lose the species-diffusion work
    plain = ls.sweep_cost(plan, True, False, block, form)
    assert plain[0] == got[0]
    assert got[1] - plain[1] == ((14 * ns + 4) * nfaces
                                 if block and viscous else 0)


def test_viscous_cost_by_model(tmp_path):
    from aither_tpu_torch.kernels import viscous_march as vm
    from aither_tpu_torch.solver.driver import Solver
    costs = {}
    for name in ("laminar", "wale", "wilcox", "sst"):
        es, tm = DECKS[name]
        wd = str(tmp_path / name)
        path = write_plate_case(wd, 4, 3, 2, equation_set=es,
                                turbulence_model=tm)
        b = Solver(path, device="cpu", workdir=wd).case.blocks[0]
        costs[name] = vm.cost(b, tm)
    faces = 5 * 3 * 2 + 4 * 4 * 2 + 4 * 3 * 3
    ncell, npad = 4 * 3 * 2, int(np.prod(b.shape))
    # each branch's own bytes: the padded prim, T and mu; the face channels
    # it reads (the wall distance only in SST, the face length only in
    # WALE); 4 cell statics; its outputs
    for name, fields, channels, outputs in (("sst", 9, 26, 29),
                                            ("wilcox", 9, 25, 29),
                                            ("wale", 7, 26, 21),
                                            ("laminar", 7, 25, 21)):
        assert costs[name][0] == 8 * (fields * npad + channels * faces
                                      + (4 + outputs) * ncell), name
    assert costs["sst"][0] - costs["wilcox"][0] == 8 * faces
    assert costs["wale"][0] - costs["laminar"][0] == 8 * faces
    assert costs["sst"][0] > costs["wilcox"][0] > costs["wale"][0]
    assert costs["laminar"][1] < costs["wale"][1] < costs["wilcox"][1] \
        < costs["sst"][1]


TEMPLATE_BEFORE = """\
gridName: plate
iterations: 10
outputFrequency: 1000
referenceDensity: 1.2256
referenceTemperature: 288.0
referenceLength: 1.0
equationSet: rans
turbulenceModel: sst2003
timeIntegration: implicitEuler
matrixSolver: lusgs
matrixSweeps: 1
matrixRelaxation: 1.0
inviscidFlux: roe
inviscidFluxJacobian: rusanov
faceReconstruction: thirdOrder
limiter: vanAlbada
viscousFaceReconstruction: central
cflStart: 10.0
cflStep: 10.0
cflMax: 1000.0
fluids: <fluid(name=air; referenceMassFraction=1.0)>
initialConditions: <icState(tag=-1; pressure=101300.0; density=1.2256; velocity=[68.0, 0.0, 0.0]; turbulenceIntensity=0.01; eddyViscosityRatio=10.0)>
boundaryStates: <characteristic(tag=1; pressure=101300.0; density=1.2256; velocity=[68.0, 0.0, 0.0]; turbulenceIntensity=0.01; eddyViscosityRatio=10.0), viscousWall(tag=2; temperature=288.0)>
boundaryConditions: 2
2 2 2
  characteristic  0 0 0 3 0 2 1
  interblock  4 4 0 3 0 2 1001
  viscousWall  0 4 0 0 0 2 2
  characteristic  0 4 3 3 0 2 1
  slipWall  0 4 0 3 0 0 0
  slipWall  0 4 0 3 2 2 0
2 2 2
  interblock  0 0 0 3 0 2 2000
  characteristic  4 4 0 3 0 2 1
  viscousWall  0 4 0 0 0 2 2
  characteristic  0 4 3 3 0 2 1
  slipWall  0 4 0 3 0 0 0
  slipWall  0 4 0 3 2 2 0
"""


def test_default_deck_text_is_unchanged(tmp_path):
    with open(write_plate_case(str(tmp_path), 4, 3, 2)) as f:
        assert f.read() == TEMPLATE_BEFORE


def test_euler_deck_has_slip_walls_and_no_wall_state(tmp_path):
    with open(write_plate_case(str(tmp_path), 4, 3, 2, equation_set="euler",
                               turbulence_model="none")) as f:
        text = f.read()
    assert "viscousWall" not in text and "turbulenceIntensity" not in text
    assert text.count("slipWall  0 4 0 0 0 2 0") == 2
    with open(write_plate_case(str(tmp_path), 4, 3, 2,
                               equation_set="navierStokes",
                               turbulence_model="none")) as f:
        text = f.read()
    assert text.count("viscousWall  0 4 0 0 0 2 2") == 2
    assert "turbulenceIntensity" not in text


@pytest.mark.parametrize("block", [False, True])
def test_sweep_cost_of_thermally_perfect_forms(tmp_path, block):
    """a thermally perfect form's operations per neighbour are the mixture
    path's (every species count takes it) plus ``tp_extra_ops``.  The
    block form (redesigned: a pre-pass of the neighbour states'
    thermodynamics) evaluates ``tp_extra_ops`` once per distinct
    neighbour read, reads what its calorically perfect form reads, and
    its operations do not grow with the Ridder iterations (it inverts no
    energy); its pre-pass's own traffic (per physical cell and per
    unmasked face its ``cell_terms_read``) is ``prepass_bytes``, outside
    the bound.  The scalar form (redesigned: a pre-pass of the old-state
    terms, q + du inverted once per updated state) inverts q + du once per
    distinct neighbour read, its operations growing with the iterations
    (two energy evaluations each) per such state; its bytes are the
    function's, as the block form's, and the pre-pass's own traffic (per
    face its ``face_values``, per cell the old energy, per updated state
    q + du, each written once and read once) is ``prepass_bytes``, outside
    the bound"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver.driver import Solver
    path = write_plate_case(str(tmp_path), 4, 3, 2)
    plan = Solver(path, device="cpu", workdir=str(tmp_path)).plans[0]
    nfaces = int(plan.mask["lower"].sum())
    ncell = int(plan.cells.numel())
    nread, _ = ls.neighbour_reads(plan, True)
    tp = ls.SST_FORM[:5] + (True,)
    caloric = ls.sweep_cost(plan, True, False, block)
    costs = [ls.sweep_cost(plan, True, False, block, tp, modes=(1,),
                           ridder_iters=it) for it in (5.0, 10.0)]
    per_cell = 2 * 5 * 5 + 5 + 8 if block else 2 * 7
    per_nb = (ls.mixture_neighbour_ops(tp, block, False)
              + ls.tp_extra_ops(tp, (1,), block, False))
    if block:
        assert costs[0][0] == costs[1][0] == caloric[0]
        for _, ops in costs:
            assert ops == ((per_nb - ls.tp_extra_ops(tp, (1,), True, False))
                           * nfaces
                           + ls.tp_extra_ops(tp, (1,), True, False) * nread
                           + per_cell * ncell)
        assert costs[0][1] == costs[1][1]
        _, nghost = ls.neighbour_reads(plan, True)
        assert ls.prepass_bytes(plan, True, tp, True) == 8 * 4 * (
            ncell + nghost + nfaces)
    else:
        assert costs[0][0] == costs[1][0] == caloric[0]
        assert ls.prepass_bytes(plan, True, tp) == 8 * 2 * (
            ls.face_values(tp) * nfaces + ncell + 7 * nread)
        for (_, ops), it in zip(costs, (5.0, 10.0)):
            per_state = ls.state_ops(tp) + ls.tp_state_ops(tp, (1,), it)
            assert ops == ((per_nb - ls.state_ops(tp)) * nfaces
                           + per_state * nread + per_cell * ncell)
        # 10 more energy evaluations of 9 operations and 5 brackets of 19
        assert costs[1][1] - costs[0][1] == (10 * 9 + 5 * 19) * nread


@pytest.mark.parametrize("block", [False, True])
def test_sweep_cost_of_thermally_perfect_roe_forms(tmp_path, block):
    """a thermally perfect approximateRoe form's operations per neighbour
    are the mixture Roe path's (one species takes it) plus
    ``tp_roe_extra_ops``, the same for the scalar and the block sweep,
    which grow, when viscous, with the neighbour's cp and cv; q + du and
    its inversion (two energy evaluations of 4 + 5 operations and a
    bracket of 19 each Ridder iteration, for one mode) once per distinct
    neighbour read in both redesigned sweeps (the stage's one inversion
    per updated state), which read what the Roe form reads (the cell's
    own state with the neighbours') and whose pre-pass's traffic stays
    outside the bound (``test_sweep_cost_of_thermally_perfect_forms``)"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver.driver import Solver
    path = write_plate_case(str(tmp_path), 4, 3, 2)
    plan = Solver(path, device="cpu", workdir=str(tmp_path)).plans[0]
    nfaces = int(plan.mask["lower"].sum())
    ncell = int(plan.cells.numel())
    nread, _ = ls.neighbour_reads(plan, True)
    roe = ls.SST_FORM[:4] + (True, False)
    roe_tp = ls.SST_FORM[:4] + (True, True)
    caloric = ls.sweep_cost(plan, True, False, block, roe)
    costs = [ls.sweep_cost(plan, True, False, block, roe_tp, modes=(1,),
                           ridder_iters=it) for it in (5.0, 10.0)]
    assert caloric[1] < costs[0][1] < costs[1][1]
    assert costs[1][1] - costs[0][1] == (10 * 9 + 5 * 19) * nread
    per_cell = caloric[1] - ls.ROE_NEIGHBOUR_OPS_BY_FORM[(7, True, False)] \
        * nfaces
    per_nb = (ls.roe_mixture_neighbour_ops(roe_tp)
              + ls.tp_roe_extra_ops(roe_tp, (1,)))
    per_state = ls.tp_state_ops(roe_tp, (1,), 5.0)
    assert costs[0][0] == costs[1][0] == caloric[0] > 0
    assert ls.prepass_bytes(plan, True, roe_tp, block) == 8 * 2 * (
        ls.face_values(roe_tp) * nfaces + ncell + 7 * nread)
    assert costs[0][1] == ((per_nb - ls.state_ops(roe_tp)) * nfaces
                           + (ls.state_ops(roe_tp) + per_state) * nread
                           + per_cell)
    inviscid = (1, 5, False, False, True, True)
    assert (ls.tp_roe_extra_ops(roe_tp, (1,))
            - ls.tp_roe_extra_ops(inviscid, (1,))) == 3 + 6


@pytest.mark.parametrize("roe", [False, True])
@pytest.mark.parametrize("block", [False, True])
def test_sweep_cost_grows_with_the_species(tmp_path, block, roe):
    """every species count has a bound: the bytes and the operations grow
    from 5 to 7 to 16 species (the (ns + 4)^2 block inverse channels, N up
    to 20, among the bytes), with the Rusanov and the Roe off-diagonal"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver.driver import Solver
    path = write_plate_case(str(tmp_path), 4, 3, 2)
    plan = Solver(path, device="cpu", workdir=str(tmp_path)).plans[0]
    ncell = int(plan.cells.numel())
    costs = [ls.sweep_cost(plan, True, False, block,
                           (ns, ns + 6, True, False, roe, False),
                           diffusion=True) for ns in (5, 7, 16)]
    for (b0, o0), (b1, o1) in zip(costs, costs[1:]):
        assert 0 < b0 < b1 and 0 < o0 < o1
    if block:
        # the inverse channels of 16 species: 20 x 20 (+ 2 x 2) a cell
        assert costs[2][0] - costs[1][0] >= 8 * (20 * 20 - 11 * 11) * ncell


@pytest.mark.parametrize("ns", [1, 5, 6, 16])
def test_library_names_resolve(ns):
    """``utils.build.library_source`` resolves every library name into its
    source and defines without nvcc: each build of both sweeps for ``ns``
    species (no suffix up to the base libraries' 5), the viscous kernel
    and the host k-d tree by their own names; an _ns<N> name of a count the
    base libraries hold is refused"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.utils import build
    for block in (False, True):
        for roe in (False, True):
            for thermo in (False, True):
                name = ls.library_name(block, roe, thermo, ns)
                source, defines = build.library_source(name)
                assert source == ("blusgs_sweep" if block else "lusgs_sweep")
                assert ("-DSWEEP_ROE=1" in defines) == roe
                assert ("-DSWEEP_TP=1" in defines) == thermo
                assert (f"-DSWEEP_NS={ns}" in defines) == (
                    ns > ls.BASE_SPECIES)
                assert len(defines) == roe + thermo + (ns > ls.BASE_SPECIES)
                src, lib, flags = build._paths(name)
                assert os.path.isfile(src)
                assert os.path.basename(lib).startswith(f"lib{name}_")
                assert flags[-len(defines):] == defines or not defines
    for name in ("viscous_march", "kdtree"):
        assert build.library_source(name) == (name, ())
    with pytest.raises(ValueError, match="base build holds 1-5"):
        build.library_source("lusgs_sweep_roe_ns5")


def test_new_mixtures_and_the_tracer(tmp_path):
    """the seven-species hydrogen-air and the sixteen-species decks:
    mass fractions summing to 1, every species of the fluid database in
    the latter and the N2 tracer, whose fluid file, written beside the
    deck, loads as N2's properties under its own name; the CPU solver of
    each builds with its species count and its form's library"""
    import dataclasses
    from aither_tpu_torch import cases
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.physics import fluid
    from aither_tpu_torch.solver.driver import Solver
    assert set(cases.DATABASE_SPECIES) == set(fluid._DATABASE)
    for name, ns in (("h2air7_frozen", 7), ("db16_frozen", 16)):
        mix = cases.MIXTURES[name]
        assert len(mix["species"]) == len(mix["mass_fractions"]) == ns
        assert abs(sum(mix["mass_fractions"]) - 1.0) < 1e-15
        wd = tmp_path / name
        path = write_plate_case(str(wd), 4, 3, 2, **mix)
        here = os.getcwd()
        os.chdir(wd)       # a fluid file is read from the working directory
        try:
            ts = Solver(path, device="cpu", workdir=str(wd))
            tracer = fluid.load_fluid("N2t") if ns == 16 else None
        finally:
            os.chdir(here)
        assert ts.phys.ns == ns
        assert ls.form_library(ts.phys, ts.cfg) == f"lusgs_sweep_ns{ns}"
        assert (wd / "N2t.dat").is_file() == (ns == 16)
    n2 = fluid.load_fluid("N2")
    assert dataclasses.replace(tracer, name="N2") == n2
