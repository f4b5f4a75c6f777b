"""PyTorch port, calorically perfect mixtures against aither_tpu, function
by function: the Physics bundle at two species (N2/O2, cases.N2O2) and at
five (hot air N2, O2, NO, N, O, cases.AIR5), the state conversions, the
reacting chemistry of the inline air5 mechanism, the mixture's block
Jacobian rows, and the plain viscous residual with Schmidt diffusion; and
the routing of a mixture deck (no kernel launch on the CPU, the fused
viscous kernel refused, the .resid columns of the JAX driver).

Tolerances.  Function level rtol 1e-12: both sides evaluate the same
float64 formulas in the same operation order, and only libm and XLA's
fusion round differently (a few ulp).  The chemistry source Jacobian is
the reference's forward difference with the step h = 1e-10 rho
(chemistry.cpp:127-176): a one-ulp difference of the two packages' exp in
the sources becomes a difference of ~eps |w| / h in the quotient, so it is
held to |got - want| <= 1e-12 |want| + 64 eps max|w| / h per cell, eps
the float64 epsilon (the sources themselves to 1e-12).  Module level
(the viscous residual) 1e-10 of each output's scale.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import (SEED, assert_close, perturbed_prims,  # noqa
                                rel_err, resid_columns, solver_pair,
                                viscous_inputs, write_case)

RTOL = 1e-12
N = 64
MIXTURES = {"n2o2": dict(cases.N2O2),
            "air5": dict(cases.AIR5, equation_set="navierStokes",
                         turbulence_model="none")}


@pytest.fixture(scope="module")
def physics(tmp_path_factory):
    """{name: (JAX Physics, port Physics)} of each mixture's deck, read in
    the case directory (the mechanism is found in the working
    directory)"""
    from aither_tpu.io.deck import parse_deck as jparse
    from aither_tpu.physics.models import Physics as JPhysics
    from aither_tpu_torch.io.deck import parse_deck as tparse
    from aither_tpu_torch.physics.models import Physics as TPhysics
    out = {}
    for name, kw in MIXTURES.items():
        wd = tmp_path_factory.mktemp(name)
        path = write_case(wd, (4, 3, 2), **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(wd)
            out[name] = (JPhysics.from_deck(jparse(path).finalize()),
                         TPhysics.from_deck(tparse(path).finalize()))
    return out


def _states(phys, name, n=N, seed=SEED):
    """random primitive states (neq, n) around the mixture's freestream:
    each species density within 20%, |v| ~0.2, p within 20%, and k, omega
    > 0 with turbulence equations"""
    rng = np.random.default_rng(seed)
    kw = MIXTURES[name]
    rho = kw.get("density", 1.2256) / 1.2256
    q = np.empty((phys.neq, n))
    mf = np.asarray(kw["mass_fractions"])[:, None]
    q[:phys.ns] = rho * mf * (1.0 + 0.2 * rng.random((phys.ns, n)))
    q[phys.mx:phys.mx + 3] = 0.2 * (rng.random((3, n)) - 0.3)
    q[phys.ie] = 0.714 * (1.0 + 0.2 * rng.random(n))
    if phys.nturb:
        q[phys.it] = 1e-4 * (1.0 + rng.random(n))
        q[phys.it + 1] = 10.0 * (1.0 + rng.random(n))
    return q


def _tj(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(np.array(a)) for a in arrays])


@pytest.mark.parametrize("name", list(MIXTURES))
def test_physics_constants(physics, name):
    jp, tp = physics[name]
    ns = len(MIXTURES[name]["species"])
    assert (tp.ns, tp.neq, tp.nturb) == (jp.ns, jp.neq, jp.nturb)
    assert tp.ns == ns and tp.neq == ns + (6 if name == "n2o2" else 4)
    for key in ("n", "R", "hf", "s0", "visc_c1", "visc_s", "cond_c1",
                "cond_s", "molar_mass"):
        assert len(getattr(tp, key)) == ns, key
        assert getattr(tp, key) == pytest.approx(getattr(jp, key),
                                                 rel=1e-15), key
    for key in ("t_ref", "mu_mix_ref", "k_nondim", "nondim_scaling",
                "schmidt", "freezing_temperature"):
        assert getattr(tp, key) == pytest.approx(getattr(jp, key),
                                                 rel=1e-15), key
    assert (tp.diffusion_model, tp.chem_model) == (jp.diffusion_model,
                                                   jp.chem_model)
    assert (tp.chemistry is None) == (jp.chemistry is None) == (
        name != "air5")


@pytest.mark.parametrize("fn", ["gamma", "viscosity", "conductivity",
                                "effective_conductivity", "species_cv",
                                "species_cp", "species_energy",
                                "species_enthalpy", "species_viscosity",
                                "species_conductivity", "mole_fractions",
                                "temperature_from_energy", "density_tp"])
@pytest.mark.parametrize("name", list(MIXTURES))
def test_physics_functions(physics, name, fn):
    jp, tp = physics[name]
    q = _states(tp, name)
    t = q[tp.ie] / (np.asarray(tp.R)[:, None] * q[:tp.ns]).sum(axis=0)
    mf = q[:tp.ns] / q[:tp.ns].sum(axis=0)
    args = {"gamma": (t, mf), "viscosity": (t, mf),
            "conductivity": (t, mf), "effective_conductivity": (t, mf),
            "mole_fractions": (mf,), "temperature_from_energy": (
                0.5 + 2.0 * t, mf), "density_tp": (t, q[tp.ie], mf)
            }.get(fn, (t,))
    J, T = _tj(*args)
    assert_close(getattr(tp, fn)(*T), getattr(jp, fn)(*J), RTOL, 0.0, fn)


@pytest.mark.parametrize("fn", ["temperature", "sos", "enthalpy",
                                "mass_fractions", "cons_from_prim"])
@pytest.mark.parametrize("name", list(MIXTURES))
def test_state_functions(physics, name, fn):
    from aither_tpu.solver import state as jst
    from aither_tpu_torch.solver import state as tst
    jp, tp = physics[name]
    (qj,), (qt,) = _tj(_states(tp, name))
    assert_close(getattr(tst, fn)(tp, qt), getattr(jst, fn)(jp, qj), RTOL,
                 0.0, fn)


@pytest.mark.parametrize("name", list(MIXTURES))
def test_prim_cons_roundtrip_and_update(physics, name):
    """prim_from_cons and the implicit update, whose du moves some species
    densities below zero: the renormalisation clips and rescales them"""
    from aither_tpu.solver import state as jst
    from aither_tpu_torch.solver import state as tst
    jp, tp = physics[name]
    q = _states(tp, name)
    rng = np.random.default_rng(SEED + 2)
    cons = np.array(jst.cons_from_prim(jp, jnp.asarray(q)))
    du = 0.01 * (rng.random(cons.shape) - 0.5) * np.abs(cons)
    du[tp.ns - 1, :8] = -2.0 * cons[tp.ns - 1, :8]
    assert_close(tst.prim_from_cons(tp, torch.as_tensor(cons)),
                 jst.prim_from_cons(jp, jnp.asarray(cons)), RTOL, 0.0,
                 "prim_from_cons")
    got = tst.update_prim_with_cons(tp, torch.as_tensor(q),
                                    torch.as_tensor(du))
    assert_close(got, jst.update_prim_with_cons(jp, jnp.asarray(q),
                                                jnp.asarray(du)),
                 RTOL, 0.0, "update_prim_with_cons")
    assert float(got[tp.ns - 1, :8].abs().max()) == 0.0
    assert float(got[:tp.ns].min()) >= 0.0


def test_mechanism_parses_as_the_jax_package(physics):
    """the inline air5 mechanism: three reactions, nondimensionalized alike"""
    jp, tp = physics["air5"]
    jc, tc = jp.chemistry, tp.chemistry
    assert len(tc.reactions) == len(jc.reactions) == 3
    for a, b in zip(tc.reactions, jc.reactions):
        assert (a.stoich_react, a.stoich_prod, a.forward_only) == (
            b.stoich_react, b.stoich_prod, b.forward_only)
        for key in ("c", "eta", "theta"):
            assert getattr(a, key) == pytest.approx(getattr(b, key),
                                                    rel=1e-15)
    for key in ("molar_mass", "ref_p", "universal_r", "freezing_t"):
        assert getattr(tc, key) == pytest.approx(getattr(jc, key),
                                                 rel=1e-15), key


def _hot(tp, n=N, seed=SEED + 4):
    """seeded species densities and temperatures of 2000-6000 K"""
    rng = np.random.default_rng(seed)
    mf = np.asarray(cases.AIR5["mass_fractions"])[:, None]
    rho_s = (cases.AIR5["density"] / 1.2256) * mf * (
        0.5 + rng.random((tp.ns, n)))
    t = (2000.0 + 4000.0 * rng.random(n)) / tp.t_ref
    return rho_s, t


def test_source_terms(physics):
    from aither_tpu.physics import chemistry as jch
    from aither_tpu_torch.physics import chemistry as tch
    jp, tp = physics["air5"]
    rho_s, t = _hot(tp)
    (rj, tj), (rt, tt) = _tj(rho_s, t)
    want = jch.source_terms(jp, jp.chemistry, rj, tj)
    got = tch.source_terms(tp, tp.chemistry, rt, tt)
    assert_close(got[0], want[0], RTOL, 0.0, "species sources")
    assert_close(got[1], want[1], RTOL, 0.0, "spectral radius")
    assert_close(tch.gibbs_minimization(tp, tt),
                 jch.gibbs_minimization(jp, tj), RTOL, 0.0, "gibbs")
    # the mechanism moves the state: every species has a source
    assert np.all(np.abs(np.asarray(want[0])).max(axis=1) > 0.0)


def test_source_jacobian(physics):
    """the forward-difference Jacobian, held to its roundoff bound (module
    docstring); its momentum and energy rows and energy column are zero"""
    from aither_tpu.physics import chemistry as jch
    from aither_tpu_torch.physics import chemistry as tch
    jp, tp = physics["air5"]
    rho_s, t = _hot(tp)
    (rj, tj), (rt, tt) = _tj(rho_s, t)
    src = np.asarray(jch.source_terms(jp, jp.chemistry, rj, tj)[0])
    want = np.asarray(jch.source_jacobian(jp, jp.chemistry, rj, tj,
                                          jnp.asarray(src)))
    got = tch.source_jacobian(tp, tp.chemistry, rt, tt,
                              torch.as_tensor(src.copy())).numpy()
    assert got.shape == want.shape == (N, tp.ns + 4, tp.ns + 4)
    h = 1e-10 * rho_s.sum(axis=0)
    bound = (RTOL * np.abs(want) + 64 * np.finfo(float).eps
             * np.abs(src).max(axis=0)[:, None, None] / h[:, None, None])
    assert np.all(np.abs(got - want) <= bound)
    assert not got[:, tp.ns:].any() and not got[:, :, tp.ns:].any()


def _block_args(tp, name):
    rng = np.random.default_rng(SEED + 5)
    q = _states(tp, name)
    n = rng.standard_normal((3, N))
    n /= np.linalg.norm(n, axis=0)
    return dict(q=q, n=n, mag=0.5 + rng.random(N), mu=1.0 + rng.random(N),
                mut=rng.random(N), f1=rng.random(N),
                dist=0.1 + rng.random(N),
                vgrad=rng.standard_normal((3, 3, N)))


@pytest.mark.parametrize("rows", ["inv_flux", "tsl_left", "tsl_right",
                                  "del_prim_del_cons"])
@pytest.mark.parametrize("name", list(MIXTURES))
def test_block_jacobian_rows(physics, name, rows):
    """the mixture's rows, with Schmidt diffusion in the TSL species rows"""
    from aither_tpu.solver import block_jac as jbj
    from aither_tpu_torch.solver import block_jac as tbj
    jp, tp = physics[name]
    a = _block_args(tp, name)
    cfg = dict(turb_model=tp.turb_model, diffusion="schmidt",
               schmidt=tp.schmidt, turb_schmidt=0.7)
    keys = {"inv_flux": ("q", "n", "mag"),
            "del_prim_del_cons": ("q",)}.get(
        rows, ("q", "mu", "mut", "f1", "n", "mag", "dist", "vgrad"))
    J, T = _tj(*(a[k] for k in keys))
    if rows.startswith("tsl"):
        left = rows == "tsl_left"
        want = jbj._tsl_rows(jp, cfg, *J, left=left)
        got = tbj._tsl_rows(tp, cfg, *T, left=left)
        assert_close(got[1], want[1], RTOL, 0.0, "scale")
        if tp.nturb:
            for g, w in zip(got[2][:2], want[2][:2]):
                assert_close(g, w, RTOL, 0.0, "turbulence diagonal")
        got, want = got[0], want[0]
        # the species-diffusion block is there
        assert float(got[0][0].abs().min()) > 0.0
    else:
        fn = f"_{rows}_rows"
        got, want = getattr(tbj, fn)(tp, *T), getattr(jbj, fn)(jp, *J)
    assert len(got) == len(want) == tp.ns + 4
    for i, (gr, wr) in enumerate(zip(got, want)):
        for j, (g, w) in enumerate(zip(gr, wr)):
            assert_close(torch.broadcast_to(torch.as_tensor(g), (N,)),
                         np.broadcast_to(np.asarray(w), (N,)), RTOL,
                         1e-300, f"row {i} column {j}")


@pytest.fixture(scope="module")
def sst_pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("n2o2_sst"), **cases.N2O2)


def test_viscous_residual_with_schmidt_diffusion(sst_pair):
    """the plain viscous residual of the N2/O2 SST deck against the JAX
    package's viscous_residual (its per-iteration form), every output
    within 1e-10 of its scale: the species rows carry the diffusion
    fluxes, zero on the viscousWall faces"""
    from aither_tpu.solver import viscous as jvis
    from aither_tpu_torch.solver import viscous as tvis
    js, ts = sst_pair
    assert ts.cfg["diffusion"] == "schmidt" and ts.cfg["turb_schmidt"] == 0.7
    inputs = viscous_inputs(ts, perturbed_prims(ts.case.blocks))
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        prim, t_all, mu_all = inputs[tb.index]
        want = jvis.viscous_residual(
            js.phys, js.cfg, jb, jnp.asarray(prim.numpy()),
            jnp.asarray(t_all.numpy()), jnp.asarray(mu_all.numpy()),
            need_aux=False, need_pgrad=False)
        got = tvis.viscous_residual(ts.phys, ts.cfg, tb, prim, t_all,
                                    mu_all)
        for i in range(5):
            assert rel_err(got[i], want[i]) < 1e-10, (tb.index, i)
        for key in ("vel", "tke", "omega", "mut", "f1", "f2"):
            assert rel_err(got[5][key], want[5][key]) < 1e-10, key
        species = got[0][:ts.phys.ns]
        assert float(species.abs().max()) > 0.0


def test_diffusion_is_zero_on_viscous_walls(sst_pair):
    from aither_tpu_torch.solver import viscous as tvis
    _, ts = sst_pair
    for b in ts.case.blocks:
        mask = tvis._wall_face_mask(b, "j", b.nj + 1)
        assert mask.shape == (b.ni, b.nj + 1, b.nk)
        assert bool((mask[:, 0] == 1.0).all()) and not mask[:, 1:].any()
        assert not tvis._wall_face_mask(b, "i", b.ni + 1).any()


@pytest.mark.parametrize("matrix_solver", ["lusgs", "blusgs"])
@pytest.mark.parametrize("name", list(MIXTURES))
def test_cpu_mixture_iteration_launches_no_kernel(tmp_path, monkeypatch,
                                                  name, matrix_solver):
    """a mixture deck on the CPU: every launch counter stays, the L2 of
    every equation is finite, the sweep form names the species count, the
    fused viscous kernel refuses the deck and meta tensors are refused"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.kernels import viscous_march as vm
    from aither_tpu_torch.solver.driver import Solver
    monkeypatch.chdir(tmp_path)
    path = write_case(tmp_path, (4, 3, 2), matrix_solver=matrix_solver,
                      **MIXTURES[name])
    ts = Solver(path, device="cpu", workdir=str(tmp_path))
    counters = (ls.LAUNCHES, ls.BLOCK_LAUNCHES, vm.LAUNCHES)
    before = [c.count for c in counters]
    ts.run(iterations=2)
    assert [c.count for c in counters] == before
    assert np.isfinite(ts.l2_history).all()
    ns, neq = ts.phys.ns, ts.phys.neq
    assert ls.sweep_form(ts.phys, ts.cfg) == (ns, neq, True, False,
                                              False, False)
    b = ts.case.blocks[0]
    meta = torch.empty((neq,) + b.shape, dtype=torch.float64, device="meta")
    t_meta = torch.empty(b.shape, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="viscous residual kernel"):
        vm.viscous_residual(ts.phys, ts.cfg, b, meta, t_meta, t_meta)
    with pytest.raises(ValueError, match="viscous residual kernel"):
        vm.viscous_residual(ts.phys, ts.cfg, b, ts.prims[0],
                            ts.prims[0][0], ts.prims[0][0])
    assert [c.count for c in counters] == before


def test_resid_columns_match_the_jax_driver(sst_pair):
    """the .resid header of a mixture deck: the JAX driver's columns"""
    import io
    js, ts = sst_pair
    ts.run(iterations=1)
    buf = io.StringIO()
    js._print_headers(buf)
    want = [c for c in buf.getvalue().split() if c.startswith("Res-")]
    assert resid_columns(ts) == want
    with open(ts.sim_root + ".tme") as f:
        assert f.readline().split() == ["Step", "Iter-Time", "Sim-Time"]


def test_import_scan_covers_the_chemistry_module():
    from tests.test_torch_host import _port_sources
    names = [os.path.relpath(p) for p in _port_sources()]
    assert any(n.endswith(os.path.join("physics", "chemistry.py"))
               for n in names)
